"""Incremental content-tokenizer encode, as
`streamvoiceanon_tpu.models.tokenizer_stream`.

Carries an STFT sample tail, conv input tails for the ConvNeXt backbone and
the two stride-2 downsampling convs, and a KV ring for the window-limited
transformer.  With `TokenizerConfig.use_pallas_encoder` the conv tails are
one `PackedEncState` (ops/convnext_enc.py) and the whole ConvNeXt front runs
as one kernel call at batch 1; a packed state at batch > 1 is unpacked, run
on the dict path and repacked.  `convert_enc_layout` moves a live state
between the two layouts.  The ring has one of two layouts:

* rotated-frame (L, B, H, W, D): RoPE scores depend only on the query-key
  distance, so cached keys are kept rotated to a fixed query frame and
  every step rotates each cached key by one negative position step;
* with `WindowedTransformerConfig.use_pallas_stream`, flat circular
  (L, B, W, H*D) rows with absolute RoPE, read-only but for one fresh row
  per layer (ops/wt_stream.py): the ring-step kernel at batch 1, its plain
  batched form otherwise.  `convert_ring_layout` moves a live ring between
  the two.

With `WindowedTransformerConfig.dw_conv` the ring keeps the rotated frame
and carries the LConv1d branch's tail (`RingState.conv_tail`).  Either way
the stream equals offline encoding for any stream length.

Chunk unit: one 2048-sample frame -> 4 mel hops -> 1 content token.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.config import TokenizerConfig, WindowedTransformerConfig
from streamvoiceanon_tpu_torch.models import convnext, windowed_transformer
from streamvoiceanon_tpu_torch.ops import conv as convops
from streamvoiceanon_tpu_torch.ops import convnext_enc as encops
from streamvoiceanon_tpu_torch.ops import quantizers, stft
from streamvoiceanon_tpu_torch.ops import wt_stream as wts
from streamvoiceanon_tpu_torch.ops.norm import layer_norm, rms_norm


# ---------------------------------------------------------------------------
# Streaming mel
# ---------------------------------------------------------------------------


class MelState(NamedTuple):
    tail: torch.Tensor  # (B, win - hop) previous samples


def mel_init_state(cfg, batch: int = 1, device=None) -> MelState:
    return MelState(torch.zeros((batch, cfg.win_length - cfg.hop_length),
                                dtype=torch.float32, device=device))


def mel_consts(cfg, device=None) -> dict:
    """The DFT and mel-filter matrices, made once per session on its device."""
    return {
        "dft": torch.from_numpy(stft.dft_matrix(cfg.n_fft, cfg.win_length)).to(device),
        "fb": torch.from_numpy(stft.mel_matrix(cfg)).to(device),
    }


def mel_stream(state: MelState, wav_chunk: torch.Tensor, cfg,
               consts: dict) -> Tuple[MelState, torch.Tensor]:
    """(B, k*hop) samples -> (B, k, n_mels); equals the causal log-mel of the
    whole signal at the corresponding frames."""
    x = torch.cat([state.tail, wav_chunk.float()], dim=1)
    mel = stft.log_mel_frames(x, cfg, consts["dft"], consts["fb"])
    keep = cfg.win_length - cfg.hop_length
    return MelState(x[:, x.shape[1] - keep:]), mel


# ---------------------------------------------------------------------------
# Streaming ConvNeXt encoder
# ---------------------------------------------------------------------------


def convnext_encoder_init_stream(p: Dict, cfg, batch: int = 1, dtype=torch.float32,
                                 device=None) -> Dict:
    return {
        "stem": convops.causal_conv1d_init_state(
            batch, cfg.input_channels, p["stem_conv"]["w"].shape[-1],
            dtype=dtype, device=device),
        "stages": [
            [convnext.convnext_block_init_stream(b, batch, dtype, device)
             for b in p[f"stage_{i}"]]
            for i in range(len(cfg.depths))
        ],
    }


def convnext_encoder_apply_stream(p: Dict, cfg, state: Dict, x: torch.Tensor):
    new = {"stages": []}
    for i in range(len(cfg.depths)):
        if i == 0:
            new["stem"], x = convops.causal_conv1d_stream(
                state["stem"], x, p["stem_conv"]["w"], p["stem_conv"]["b"])
            x = layer_norm(x, p["stem_norm"]["w"], p["stem_norm"]["b"], eps=1e-6)
        else:
            x = layer_norm(x, p[f"mid_norm_{i-1}"]["w"], p[f"mid_norm_{i-1}"]["b"],
                           eps=1e-6)
            x = x @ p[f"mid_conv_{i-1}"]["w"] + p[f"mid_conv_{i-1}"]["b"]
        stage_states = []
        for blk, bst in zip(p[f"stage_{i}"], state["stages"][i]):
            bst, x = convnext.convnext_block_apply_stream(blk, bst, x)
            stage_states.append(bst)
        new["stages"].append(stage_states)
    x = layer_norm(x, p["final_norm"]["w"], p["final_norm"]["b"], eps=1e-6)
    return new, x


# ---------------------------------------------------------------------------
# KV ring for the window-limited transformer
# ---------------------------------------------------------------------------


class RingState(NamedTuple):
    # (L, B, H, W, D) keys rotated to the fixed query frame, or with
    # use_pallas_stream (L, B, W, H*D) circular rows with absolute RoPE
    k_ring: torch.Tensor
    v_ring: torch.Tensor  # same layout as k_ring
    count: int  # tokens seen so far (host counter: the trajectory is known)
    # with dw_conv, (L, B, K - 1, dim) the LConv1d branch's GLU outputs of
    # the last K - 1 tokens (zeros at first: the offline left zero pad)
    conv_tail: Optional[torch.Tensor] = None


@functools.lru_cache(maxsize=8)
def _unit_rotation(head_dim: int, rope_base: float) -> np.ndarray:
    """cos/sin of a -1 position step per rotary dim pair: (D//2, 2)."""
    freqs = 1.0 / (
        rope_base ** (np.arange(0, head_dim, 2)[: head_dim // 2] / head_dim)
    )
    return np.stack([np.cos(-freqs), np.sin(-freqs)], axis=-1).astype(np.float32)


def _rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    xs = x.float().reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x0, x1 = xs[..., 0], xs[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def ring_init(cfg: WindowedTransformerConfig, batch: int = 1, dtype=torch.float32,
              device=None) -> RingState:
    W = cfg.window_size
    if cfg.use_pallas_stream and not cfg.dw_conv:
        shape = (cfg.n_layer, batch, W, cfg.n_head * cfg.head_dim)
    else:  # dw_conv keeps the rotated frame: its branch runs there
        shape = (cfg.n_layer, batch, cfg.n_head, W, cfg.head_dim)
    conv_tail = (torch.zeros((cfg.n_layer, batch, cfg.conv_kernel_size - 1, cfg.dim),
                             dtype=dtype, device=device) if cfg.dw_conv else None)
    return RingState(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device), 0, conv_tail)


def _roll_w(r: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll the W axis (-2) right by `shift`."""
    return torch.roll(r, shift, dims=-2)


def convert_ring_layout(state: RingState, cfg: WindowedTransformerConfig) -> RingState:
    """Re-lay a RingState out to match cfg.use_pallas_stream.

    Rotated-frame (L, B, H, W, D) <-> circular absolute-RoPE (L, B, W, H*D).
    Rotated slot w holds token t = count - W + w at angle t - (count - 1);
    the circular store wants angle W + (t mod R) - R * (rebases since t);
    their difference is the constant W + ((count - 1) mod R) for every
    valid slot, so the two differ by one rotation plus a slot permutation
    (a roll by count mod W)."""
    want_flat = cfg.use_pallas_stream and not cfg.dw_conv
    kr, cnt = state.k_ring, state.count
    if want_flat == (kr.ndim == 4):
        return state
    W = cfg.window_size
    H, D = cfg.n_head, cfg.head_dim
    cos, sin = wts.table_tensors(cfg.rope_table_rows, D, H, cfg.rope_base, kr.device)
    delta = W + (cnt - 1) % (cfg.rope_table_rows - W)
    shift = cnt % W
    if want_flat:
        L, B = kr.shape[:2]
        to_flat = lambda r: r.transpose(2, 3).reshape(L, B, W, H * D)
        k = wts.rope_rows(to_flat(kr), cos[delta], sin[delta])
        return state._replace(k_ring=_roll_w(k, shift),
                              v_ring=_roll_w(to_flat(state.v_ring), shift))
    L, B = kr.shape[:2]
    to_headed = lambda r: r.reshape(L, B, W, H, D).transpose(2, 3).contiguous()
    # the inverse rotation: the conjugate row
    k = wts.rope_rows(_roll_w(kr, -shift), cos[delta], -sin[delta])
    return state._replace(k_ring=to_headed(k),
                          v_ring=to_headed(_roll_w(state.v_ring, -shift)))


def transformer_stream_step(params: Dict, cfg: WindowedTransformerConfig,
                            state: RingState,
                            x: torch.Tensor) -> Tuple[RingState, torch.Tensor]:
    """One new token (B, 1, dim) through all layers.

    Flat ring: re-base if due, then the ring-step kernel at batch 1 (its
    plain batched form otherwise), which writes the fresh rows in place.
    Rotated ring: the query sits at relative position 0; the cached key of
    age a carries rotation angle -a, applied one step per token."""
    layers = params["layers"]
    if state.k_ring.ndim == 4:
        kw = dict(n_head=cfg.n_head, head_dim=cfg.head_dim, rope_base=cfg.rope_base,
                  table_rows=cfg.rope_table_rows)
        k_in = wts.maybe_rebase_ring(state.k_ring, state.count, **kw)
        if x.shape[0] == 1 and cfg.n_head * cfg.head_dim == cfg.dim:
            h, k_ring, v_ring = wts.wt_stream_step(
                layers, x[0], k_in[:, 0], state.v_ring[:, 0], state.count,
                norm_eps=cfg.norm_eps, **kw)
            k_ring, v_ring, h = k_ring[:, None], v_ring[:, None], h[None]
        else:
            h, k_ring, v_ring = wts.circular_stream_step(
                layers, x, k_in, state.v_ring, state.count, norm_eps=cfg.norm_eps, **kw)
        h = rms_norm(h, params["final_norm"]["w"], cfg.norm_eps)
        return RingState(k_ring, v_ring, state.count + 1), h
    W, H, D = cfg.window_size, cfg.n_head, cfg.head_dim
    dev = x.device
    unit = torch.from_numpy(_unit_rotation(D, cfg.rope_base)).to(dev)
    cos, sin = unit[:, 0], unit[:, 1]
    age = W - 1 - torch.arange(W, device=dev)
    valid = age <= min(state.count, W - 1)
    k_new = torch.empty_like(state.k_ring)
    v_new = torch.empty_like(state.v_ring)
    ct_new = None if state.conv_tail is None else torch.empty_like(state.conv_tail)
    h = x
    B = h.shape[0]
    for l in range(cfg.n_layer):
        lp = windowed_transformer.layer(layers, l)
        hn = rms_norm(h, lp["attention_norm"]["w"], cfg.norm_eps)
        q, k, v = torch.chunk(hn @ lp["wqkv"]["w"], 3, dim=-1)
        # rotate every cached key one step into the past, then append the
        # new key at relative position 0 (slot W - 1)
        k_ring = torch.roll(_rotate_pairs(state.k_ring[l], cos, sin), -1, dims=2)
        v_ring = torch.roll(state.v_ring[l], -1, dims=2)
        k_ring[:, :, W - 1] = k.reshape(B, H, D).to(k_ring.dtype)
        v_ring[:, :, W - 1] = v.reshape(B, H, D).to(v_ring.dtype)
        k_new[l], v_new[l] = k_ring, v_ring
        qh = q.reshape(B, H, 1, D)
        scores = (qh.float() @ k_ring.to(h.dtype).float().transpose(-1, -2)) / np.sqrt(D)
        scores = torch.where(valid, scores, float("-inf"))
        w = torch.softmax(scores, dim=-1).to(h.dtype)
        out = (w @ v_ring.to(h.dtype)).reshape(B, 1, H * D)
        h = h + lp["attn_scale"] * (out @ lp["wo"]["w"])
        if cfg.dw_conv:
            # the LConv1d branch on one token: its causal depthwise conv
            # needs only the GLU outputs of the previous K - 1 tokens
            lc = lp["lconv"]
            a, b = torch.chunk(rms_norm(h, lc["pre_norm"]["w"], cfg.norm_eps)
                               @ lc["w_start"]["w"], 2, dim=-1)
            full = torch.cat([state.conv_tail[l].to(h.dtype), a * torch.sigmoid(b)], dim=1)
            yc = torch.einsum("bkc,kc->bc", full.float(),
                              lc["dw"]["w"][:, 0, :].float()).to(h.dtype)[:, None]
            yc = F.silu(rms_norm(yc, lc["conv_norm"]["w"], cfg.norm_eps)) @ lc["w_end"]["w"]
            h = h + lc["scale"] * yc
            ct_new[l] = full[:, 1:]
        f = rms_norm(h, lp["ffn_norm"]["w"], cfg.norm_eps)
        f = (F.silu(f @ lp["w1"]["w"]) * (f @ lp["w3"]["w"])) @ lp["w2"]["w"]
        h = h + lp["ffn_scale"] * f
    h = rms_norm(h, params["final_norm"]["w"], cfg.norm_eps)
    return RingState(k_new, v_new, state.count + 1, ct_new), h


# ---------------------------------------------------------------------------
# Full tokenizer stream
# ---------------------------------------------------------------------------


class TokenizerStreamState(NamedTuple):
    mel: MelState
    backbone: Union[Dict, encops.PackedEncState]
    down: Tuple  # () with a packed backbone
    ring: RingState


def _packed_eligible(cfg: TokenizerConfig, batch: int) -> bool:
    return cfg.use_pallas_encoder and cfg.backbone.gin_channels == 0 and batch == 1


def init_stream_state(params: Dict, cfg: TokenizerConfig, batch: int = 1,
                      dtype=torch.float32, device=None) -> TokenizerStreamState:
    if _packed_eligible(cfg, batch):
        return TokenizerStreamState(
            mel=mel_init_state(cfg.mel, batch, device),
            backbone=encops.init_packed_state(cfg, batch, dtype, device),
            down=(),
            ring=ring_init(cfg.transformer, batch, dtype, device),
        )
    dims = cfg.quantizer.input_dim
    down = tuple(
        {
            "conv": convops.causal_conv1d_init_state(
                batch, dims, stage["conv"]["w"].shape[-1], stride=f, dtype=dtype,
                device=device),
            "block": convnext.convnext_block_init_stream(stage["block"], batch,
                                                         dtype, device),
        }
        for stage, f in zip(params["downsample"], cfg.quantizer.downsample_factor)
    )
    return TokenizerStreamState(
        mel=mel_init_state(cfg.mel, batch, device),
        backbone=convnext_encoder_init_stream(params["backbone"], cfg.backbone,
                                              batch, dtype, device),
        down=down,
        ring=ring_init(cfg.transformer, batch, dtype, device),
    )


def convert_enc_layout(state: TokenizerStreamState, params: Dict, cfg: TokenizerConfig,
                       target_batch: int = 0) -> TokenizerStreamState:
    """Re-lay the ConvNeXt front's state out to match cfg.use_pallas_encoder:
    dict layout <-> `PackedEncState`.  `target_batch` overrides the state's
    own batch in the packed-eligibility check (a packed batch-1 state that
    is about to be tiled to a larger batch is unpacked first)."""
    is_packed = isinstance(state.backbone, encops.PackedEncState)
    batch = target_batch or (state.backbone.stem.shape[0] if is_packed
                             else state.backbone["stem"].tail.shape[0])
    want_packed = _packed_eligible(cfg, batch)
    if want_packed and not is_packed:
        return state._replace(backbone=encops.pack_enc_state(state.backbone, state.down, cfg),
                              down=())
    if is_packed and not want_packed:
        bb, dn = encops.unpack_enc_state(state.backbone, cfg)
        return state._replace(backbone=bb, down=dn)
    return state


def _encode_front_dict(params, cfg, state, mel):
    """mel -> pre-transformer features (ConvNeXt backbone + downsampling)."""
    bb_state, z = convnext_encoder_apply_stream(
        params["backbone"], cfg.backbone, state.backbone, mel)
    new_down = []
    for stage, st, f in zip(params["downsample"], state.down,
                            cfg.quantizer.downsample_factor):
        cs, z = convops.causal_conv1d_stream(
            st["conv"], z, stage["conv"]["w"], stage["conv"]["b"], stride=f)
        bs, z = convnext.convnext_block_apply_stream(stage["block"], st["block"], z)
        new_down.append({"conv": cs, "block": bs})
    return bb_state, z, tuple(new_down)


def encode_stream(params: Dict, cfg: TokenizerConfig, state: TokenizerStreamState,
                  wav_chunk: torch.Tensor,
                  consts: dict) -> Tuple[TokenizerStreamState, torch.Tensor]:
    """(state, (B, k*2048) samples) -> (state', (B, k) int32 content tokens).

    A packed front state needs the packed weights, `params["enc_packed"]`,
    and on the card their unit-packed matrices, `params["enc_units"]`
    (`params.Converter` packs both once)."""
    mel_state, mel = mel_stream(state.mel, wav_chunk, cfg.mel, consts)
    if not isinstance(state.backbone, encops.PackedEncState):
        bb_state, z, new_down = _encode_front_dict(params, cfg, state, mel)
    elif mel.shape[0] == 1:
        if "enc_packed" not in params:
            raise ValueError("encode_stream: a packed front state needs params['enc_packed'] "
                             "(ops/convnext_enc.packed_weights)")
        bb_state, z = encops.encoder_front_step(params["enc_packed"], state.backbone, mel, cfg,
                                                units=params.get("enc_units"))
        new_down = ()
    else:  # batched: unpack -> dict path -> repack
        bb, dn = encops.unpack_enc_state(state.backbone, cfg)
        bb2, z, nd = _encode_front_dict(params, cfg, state._replace(backbone=bb, down=dn), mel)
        bb_state, new_down = encops.pack_enc_state(bb2, nd, cfg), ()
    ring = state.ring
    outs = []
    for t in range(z.shape[1]):
        ring, h = transformer_stream_step(params["pre_module"], cfg.transformer,
                                          ring, z[:, t : t + 1])
        outs.append(h)
    tokens = quantizers.lfq_encode(params["lfq"], torch.cat(outs, dim=1),
                                   cfg.quantizer.codebook_bits)
    return TokenizerStreamState(mel_state, bb_state, new_down, ring), tokens
