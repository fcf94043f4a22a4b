"""Dual-autoregressive token LM: the training forward, prefill and the frame
decode step, on either KV-cache layout and at any batch.

As `streamvoiceanon_tpu.models.dual_ar`.  A slow transformer (12 x 768)
consumes the interleaved stream [speaker prefix (33) | (content_t,
audio_{t-delay}) pairs] and a fast transformer (4 x 768) autoregresses over
the 8 codec codebooks of each frame.  The cache layout follows the flags:
flat (L, B, S, n_local_heads * head_dim) rows with `use_pallas_slow_decode`,
per head (L, B, n_local_heads, S, head_dim) otherwise.  The JAX package
pads the per-head cache's head dim to 128 lanes for its TPU kernel; the
port keeps it unpadded.

`decode_frame` dispatches as the JAX package does:

* the slow step (layers, output head and the exact full-vocabulary
  sampler) runs on its kernel (ops/slow_decode.py) with
  `use_pallas_slow_decode` at batch 1, MHA, an untied output head without
  bias;
* otherwise the layer loop runs here, each layer's attention on the
  per-head decode kernel (ops/attention.py, over B x H heads) with
  `use_pallas_decode` (MHA only: GQA raises, as in the JAX package), plain
  on either layout without it; then the output head and the windowed
  sampler (ops/sampling.py), row by row;
* the 8-step fast codebook loop runs on its kernel (ops/fast_decode.py)
  with `use_pallas_fast_decode` at batch 1 and MHA, otherwise as the JAX
  package's XLA loop (`_fast_loop`): the fast layers over a fresh per-head
  cache, the windowed sampler row by row.

The windowed sampler's nucleus truncations add up in `DecodeState.trunc`.
Prefill writes the cache with plain PyTorch; `convert_cache_layout` moves
a live cache between the two layouts.

`forward_train` runs both stacks without caches (`run_layers`, each layer
recomputed in the backward pass under `remat`) in plain PyTorch, as the
JAX package runs its training forward outside any kernel.

Every program here also runs on a model-sharded tree (`parallel/mesh.py`):
a stack that is a `ShardedStack` holds this rank's H / n_model query heads,
n_local / n_model KV heads and its slice of the FFN, its KV cache holds
only those heads (`init_state(..., n_model=)`), and each block all-reduces
twice over the model group.  The batch-1 slow-step and fast-loop kernels
take a whole stack, so `slow_kernel_runs` and `fast_kernel_runs` say no on
a sharded one (the JAX package's XLA gathers the weights there instead) and
the layer loop runs, on the decode-attention kernel over the rank's B x H /
n_model heads under `use_pallas_decode`.  Every rank of a model group must
draw the same sampling noise (equally seeded generators), so that the
shards never part.

The cache position is a host integer: the position trajectory of a
stream is known in advance, so no device value is read back to schedule.
`prefill` returns new caches; `decode_frame` writes its two fresh rows
into the caches it is given, in place, as the JAX package does with its
donated buffers.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from streamvoiceanon_tpu_torch.config import DualARConfig, SamplingConfig
from streamvoiceanon_tpu_torch.ops.attention import decode_attention
from streamvoiceanon_tpu_torch.ops.decode_common import freqs_table
from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode
from streamvoiceanon_tpu_torch.ops.norm import compute_dtype, rms_norm
from streamvoiceanon_tpu_torch.ops.rope import apply_rope
from streamvoiceanon_tpu_torch.ops.sampling import sample_token
from streamvoiceanon_tpu_torch.ops.slow_decode import slow_decode_step
from streamvoiceanon_tpu_torch.parallel.mesh import (all_reduce_sum, copy_to_model,
                                                     model_group, model_shards,
                                                     reduce_from_model)


def embed_codes(params: Dict, cfg: DualARConfig, codes: torch.Tensor) -> torch.Tensor:
    """Sum of per-codebook embeddings: codes (B, nq, T) -> (B, T, dim)."""
    offsets = torch.arange(cfg.num_codebooks, device=codes.device) * cfg.codebook_size
    emb = params["codebook_embeddings"][codes.long() + offsets[None, :, None]]
    return torch.sum(emb, dim=1)


def embed_tokens(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """Semantic-token embedding (the `embeddings` table)."""
    return params["embeddings"][tokens.long()]


class DecodeState(NamedTuple):
    k_cache: torch.Tensor  # (L, B, S, nl * hd) flat rows, or (L, B, nl, S, hd) per head
    v_cache: torch.Tensor
    pos: int  # next cache slot to write
    # nucleus-truncation events of the windowed sampler so far (a device
    # int32 scalar once counted; the kernels' exact filters never truncate)
    trunc: Union[int, torch.Tensor] = 0


def init_state(cfg: DualARConfig, batch: int = 1, cache_dtype=torch.bfloat16,
               device=None, n_model: int = 1) -> DecodeState:
    """Zeroed caches in the layout cfg's flags ask for; bf16 by default, as
    the JAX package's `init_state`.  On a stack split `n_model` ways the
    cache holds the rank's n_local_heads / n_model heads."""
    nl = cfg.n_local_heads // n_model
    if cfg.use_pallas_slow_decode:
        shape = (cfg.n_layer, batch, cfg.max_seq_len, nl * cfg.head_dim)
    else:
        shape = (cfg.n_layer, batch, nl, cfg.max_seq_len, cfg.head_dim)
    return DecodeState(torch.zeros(shape, dtype=cache_dtype, device=device),
                       torch.zeros(shape, dtype=cache_dtype, device=device), 0,
                       torch.zeros((), dtype=torch.int32, device=device))


def convert_cache_layout(state: DecodeState, cfg: DualARConfig) -> DecodeState:
    """Re-lay the caches out to match cfg.use_pallas_slow_decode: per-head
    (L, B, H, S, D) <-> flat (L, B, S, H*D) rows."""
    kc = state.k_cache
    want_flat = cfg.use_pallas_slow_decode
    if want_flat and kc.ndim == 5:
        L, B, H, S, D = kc.shape
        to_flat = lambda c: c.transpose(2, 3).reshape(L, B, S, H * D)
        return state._replace(k_cache=to_flat(kc), v_cache=to_flat(state.v_cache))
    if not want_flat and kc.ndim == 4:
        L, B, S, _ = kc.shape
        H, D = cfg.n_local_heads, cfg.head_dim
        to_headed = lambda c: c.reshape(L, B, S, H, D).transpose(2, 3).contiguous()
        return state._replace(k_cache=to_headed(kc), v_cache=to_headed(state.v_cache))
    return state


def _attn_block(lp: Dict, l: int, x: torch.Tensor, freqs: torch.Tensor,
                k_cache: Optional[torch.Tensor], v_cache: Optional[torch.Tensor], pos: int,
                n_head: int, n_local: int, head_dim: int, norm_eps: float,
                kernel: bool = False) -> torch.Tensor:
    """Layer l of a stack on x (B, T, dim) at positions pos..pos+T-1:
    writes the T roped K/V rows into the layer's caches in place, flat (B,
    S, n_local*head_dim) or per head (B, n_local, S, head_dim), and attends
    causally over rows < pos + T.  Without caches (k_cache None, pos 0: the
    training forward) it attends causally over the T fresh rows alone and
    writes nothing, so autograd may save every tensor it uses.  `kernel`
    (per-head cache, MHA) runs the attention on the decode-attention kernel
    over the B x n_head heads of the cache viewed as (B * n_head, S,
    head_dim), with the JAX package's `use_pallas` rounding: q, k, v in the
    cache dtype, the output rounded to it.

    On a `ShardedStack` the head counts given are the whole stack's; the
    block runs the rank's share of them and all-reduces the outputs of wo
    and w2 over the model group."""
    B, T, dim = x.shape
    n, group = model_shards(lp), model_group(lp)
    H, nl, hd = n_head // n, n_local // n, head_dim
    h = copy_to_model(rms_norm(x, lp["attention_norm"]["w"][l], norm_eps), group)
    qkv = h @ lp["wqkv"]["w"][l]
    q, k, v = torch.split(qkv, [H * hd, nl * hd, nl * hd], dim=-1)
    q = apply_rope(q.reshape(B, T, H, hd), freqs)
    k = apply_rope(k.reshape(B, T, nl, hd), freqs)
    v = v.reshape(B, T, nl, hd)
    P = pos + T
    if kernel:
        if nl != H:
            raise NotImplementedError("the decode-attention kernel takes MHA (no GQA)")
        S, cd = k_cache.shape[-2], k_cache.dtype
        heads = lambda t: t.transpose(1, 2).reshape(B * H, T, hd).to(cd)
        out, _, _ = decode_attention(heads(q), heads(k), heads(v),
                                     k_cache.view(B * H, S, hd), v_cache.view(B * H, S, hd),
                                     pos)
        out = out.view(B, H, T, hd).transpose(1, 2).reshape(B, T, H * hd).to(x.dtype)
    else:
        if k_cache is None:
            k_all, v_all = k.transpose(1, 2), v.transpose(1, 2)
        elif k_cache.ndim == 3:  # flat rows
            cd = k_cache.dtype
            k_cache[:, pos:P] = k.reshape(B, T, nl * hd).to(cd)
            v_cache[:, pos:P] = v.reshape(B, T, nl * hd).to(cd)
            k_all = k_cache[:, :P].reshape(B, P, nl, hd).transpose(1, 2).to(x.dtype)
            v_all = v_cache[:, :P].reshape(B, P, nl, hd).transpose(1, 2).to(x.dtype)
        else:
            cd = k_cache.dtype
            k_cache[:, :, pos:P] = k.transpose(1, 2).to(cd)
            v_cache[:, :, pos:P] = v.transpose(1, 2).to(cd)
            k_all, v_all = k_cache[:, :, :P].to(x.dtype), v_cache[:, :, :P].to(x.dtype)
        if nl != H:
            k_all = torch.repeat_interleave(k_all, H // nl, dim=1)
            v_all = torch.repeat_interleave(v_all, H // nl, dim=1)
        acc = compute_dtype(x.dtype)
        scores = (q.transpose(1, 2).to(acc) @ k_all.to(acc).transpose(-1, -2)) / np.sqrt(hd)
        col = torch.arange(P, device=x.device)
        mask = col[None, :] <= (pos + torch.arange(T, device=x.device))[:, None]
        w = torch.softmax(torch.where(mask, scores, float("-inf")), dim=-1).to(x.dtype)
        out = (w @ v_all).transpose(1, 2).reshape(B, T, H * hd)
    x = x + reduce_from_model(out @ lp["wo"]["w"][l], group)
    f = copy_to_model(rms_norm(x, lp["ffn_norm"]["w"][l], norm_eps), group)
    f = (F.silu(f @ lp["w1"]["w"][l]) * (f @ lp["w3"]["w"][l])) @ lp["w2"]["w"][l]
    return x + reduce_from_model(f, group)


def run_layers(stacked: Dict, x: torch.Tensor, freqs: torch.Tensor, n_head: int,
               n_local: int, head_dim: int, norm_eps: float,
               remat: bool = False) -> torch.Tensor:
    """The cache-free layer loop of the training forward: every layer of a
    stack on x (B, T, dim), causal over its T rows.  `remat` recomputes
    each layer in the backward pass (`torch.utils.checkpoint`, as the JAX
    package's `jax.checkpoint` of the scanned body), so that only the
    layer inputs are kept, not every layer's attention matrix."""
    for l in range(stacked["wqkv"]["w"].shape[0]):
        args = (stacked, l, x, freqs, None, None, 0, n_head, n_local, head_dim, norm_eps)
        x = checkpoint(_attn_block, *args, use_reentrant=False) if remat else _attn_block(*args)
    return x


def _slow_heads(cfg: DualARConfig) -> Tuple[int, int, int, float]:
    return cfg.n_head, cfg.n_local_heads, cfg.head_dim, cfg.norm_eps


def _fast_heads(cfg: DualARConfig) -> Tuple[int, int, int, float]:
    return cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim, cfg.norm_eps


def prefill(params: Dict, cfg: DualARConfig, state: DecodeState,
            emb_seq: torch.Tensor) -> Tuple[DecodeState, torch.Tensor]:
    """Run `emb_seq` (B, T, dim) through the slow stack from state.pos,
    writing its rows into copies of the caches.  Returns (state', hidden of
    the last token (B, 1, dim))."""
    T = emb_seq.shape[1]
    start = state.pos
    if start + T > cfg.max_seq_len:
        raise ValueError(f"prefill of {T} rows at {start} overflows the "
                         f"{cfg.max_seq_len}-row cache")
    freqs = freqs_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base,
                        emb_seq.device)[start : start + T]
    kc, vc = state.k_cache.clone(), state.v_cache.clone()
    x = emb_seq
    for l in range(cfg.n_layer):
        x = _attn_block(params["layers"], l, x, freqs, kc[l], vc[l], start,
                        *_slow_heads(cfg))
    return DecodeState(kc, vc, start + T, state.trunc), x[:, -1:]


def _project_fast(params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    if "fast_project_in" in params:
        p = params["fast_project_in"]
        return hidden @ p["w"] + (p["b"] if "b" in p else 0.0)
    return hidden


def _token_logits(params: Dict, cfg: DualARConfig, hidden: torch.Tensor) -> torch.Tensor:
    h = rms_norm(hidden, params["norm"]["w"], cfg.norm_eps)
    if cfg.tie_word_embeddings:
        return h @ params["embeddings"].T
    out = h @ params["output"]["w"]
    return out + params["output"]["b"] if "b" in params["output"] else out


def forward_train(params: Dict, cfg: DualARConfig, condition: torch.Tensor,
                  spk_condition: torch.Tensor, base_target: torch.Tensor,
                  target: torch.Tensor, x_lens: torch.Tensor, wait4start: torch.Tensor,
                  wait4end: torch.Tensor, delay: int, remat: bool = True,
                  data_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training losses (codebook CE, semantic-token CE), as the JAX
    package's `forward_train`.

    condition (B, T, dim) embedded content, spk_condition (B, S, dim),
    base_target (B, T) semantic targets, target (B, nq, T) codebook
    targets, x_lens (B,) valid frames.  The stream is [spk | (cond_t,
    audio_{t-delay}) for t < T + delay]: the first `delay` audio slots are
    wait4start rows, the cond slots past a row's length wait4end rows
    (zeros at delay 0).  The slow stack runs causally over it with no
    padding mask; the semantic CE reads the frame positions S + 2 delay +
    2 t, gathered before the vocabulary projection; the fast stack is
    teacher-forced over the nq codebooks of every frame.  Both CEs are in
    float32 (float64 for a float64 tree) and masked by x_lens.  No dropout,
    as in the JAX package.

    With `data_group` (this rank holding its rows of a batch split over
    'data') the CEs are normalised by the valid frames of the whole batch,
    counted over the group, so that the ranks' losses and gradients sum to
    the whole batch's."""
    B, T, D = condition.shape
    S = spk_condition.shape[1]
    nq = cfg.num_codebooks
    Tm = T + delay
    dev = condition.device
    x_lens = x_lens.to(dev).long()
    t_idx = torch.arange(Tm, device=dev)
    if delay > 0:
        tail = wait4end[(t_idx[None, :] - x_lens[:, None]).clamp(0, delay - 1)]
    else:
        tail = torch.zeros((B, Tm, D), dtype=condition.dtype, device=dev)
    cond_stream = torch.where((t_idx[None, :] < x_lens[:, None])[..., None],
                              F.pad(condition, (0, 0, 0, delay)), tail)
    audio_stream = torch.cat([wait4start[None, :delay].expand(B, -1, -1),
                              embed_codes(params, cfg, target)], dim=1)
    inter = torch.stack([cond_stream, audio_stream], dim=2).reshape(B, 2 * Tm, D)
    emb_seq = torch.cat([spk_condition, inter], dim=1)
    x = run_layers(params["layers"], emb_seq,
                   freqs_table(emb_seq.shape[1], cfg.head_dim, cfg.rope_base, dev),
                   *_slow_heads(cfg), remat=remat)

    frame_pos = S + 2 * delay + 2 * torch.arange(T, device=dev)
    latents = x[:, frame_pos]  # (B, T, dim)
    valid = (torch.arange(T, device=dev)[None, :] < x_lens[:, None]).float()
    n_valid = all_reduce_sum(valid.sum(), data_group)

    def ce(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        logits = logits.to(compute_dtype(logits.dtype))
        return (torch.logsumexp(logits, dim=-1)
                - torch.gather(logits, -1, tgt.long()[..., None])[..., 0])

    token_loss = (ce(_token_logits(params, cfg, latents), base_target) * valid).sum() \
        / n_valid.clamp(min=1.0)

    cb = target.transpose(1, 2).long()  # (B, T, nq)
    fast_in = torch.cat([_project_fast(params, latents)[:, :, None],
                         params["fast_embeddings"][cb[..., :-1]]], dim=2)
    h = run_layers(params["fast_layers"], fast_in.reshape(B * T, nq, cfg.fast_dim),
                   freqs_table(nq, cfg.fast_head_dim, cfg.rope_base, dev),
                   *_fast_heads(cfg), remat=remat)
    h = rms_norm(h, params["fast_norm"]["w"], cfg.norm_eps)
    cb_logits = (h @ params["fast_output"]["w"]).reshape(B, T, nq, cfg.codebook_size)
    codebook_loss = (ce(cb_logits, cb) * valid[..., None]).sum() / (n_valid * nq).clamp(min=1.0)
    return codebook_loss, token_loss


def slow_kernel_runs(params: Dict, cfg: DualARConfig, batch: int) -> bool:
    """Whether `decode_frame` runs the slow step on its kernel: the JAX
    package's condition (flat cache, batch 1, MHA, untied head, no bias),
    on a whole stack (the kernel takes every layer's heads)."""
    return (cfg.use_pallas_slow_decode and batch == 1 and cfg.n_local_heads == cfg.n_head
            and not cfg.tie_word_embeddings and model_shards(params.get("layers")) == 1
            and "b" not in params.get("output", {"b": None}))


def fast_kernel_runs(cfg: DualARConfig, batch: int, n_model: int = 1) -> bool:
    """Whether `decode_frame` runs the codebook loop on its kernel: batch
    1, MHA, the fast stack whole (`n_model` 1)."""
    return (cfg.use_pallas_fast_decode and batch == 1 and n_model == 1
            and cfg.fast_n_local_heads == cfg.fast_n_head)


def _window(sampling: SamplingConfig, vocab: int) -> int:
    k = sampling.top_k_window
    return k if 0 < k < vocab else vocab


def frame_noise_shapes(params: Dict, cfg: DualARConfig, sampling: SamplingConfig,
                       batch: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The shapes of `decode_frame`'s Gumbel inputs (semantic, codebooks):
    a kernel's exact sampler takes a row over the whole vocabulary, the
    windowed sampler one over its window."""
    sem = cfg.vocab_size
    if not slow_kernel_runs(params, cfg, batch):
        sem = _window(sampling, sem)
    fast = cfg.codebook_size
    if not fast_kernel_runs(cfg, batch, model_shards(params.get("fast_layers"))):
        fast = _window(sampling, fast)
    return (batch, sem), (batch, cfg.num_codebooks, fast)


def _sampler_args(sampling: SamplingConfig) -> Dict:
    return dict(temperature=sampling.temperature, top_p=sampling.top_p,
                greedy=sampling.greedy)


def _fast_loop(params: Dict, cfg: DualARConfig, hidden: torch.Tensor,
               gumbel: Optional[torch.Tensor],
               sampling: SamplingConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codebook loop as the JAX package's XLA path (`_fast_decode`'s
    scan), at any batch and with GQA: a fresh zeroed per-head fast cache
    each frame, the fast layers on one token a step, the windowed sampler
    row by row on gumbel[:, step].  hidden (B, 1, fast_dim).  Returns
    (codes (B, nq) int32, the nucleus truncations of the loop, int32)."""
    B = hidden.shape[0]
    nq = cfg.num_codebooks
    heads = _fast_heads(cfg)
    shape = (B, cfg.fast_n_local_heads // model_shards(params["fast_layers"]), nq,
             cfg.fast_head_dim)
    kc = [torch.zeros(shape, dtype=hidden.dtype, device=hidden.device)
          for _ in range(cfg.n_fast_layer)]
    vc = [torch.zeros_like(c) for c in kc]
    freqs = freqs_table(nq, cfg.fast_head_dim, cfg.rope_base, hidden.device)
    x = hidden
    codes = []
    trunc = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for s in range(nq):
        y = x
        for l in range(cfg.n_fast_layer):
            y = _attn_block(params["fast_layers"], l, y, freqs[s : s + 1], kc[l], vc[l], s,
                            *heads)
        y = rms_norm(y, params["fast_norm"]["w"], cfg.norm_eps)
        logits = (y @ params["fast_output"]["w"])[:, -1]
        code, flag = sample_token(logits, None if gumbel is None else gumbel[:, s],
                                  top_k_window=sampling.top_k_window, with_flag=True,
                                  **_sampler_args(sampling))
        trunc = trunc + flag.sum(dtype=torch.int32)
        codes.append(code)
        x = params["fast_embeddings"][code.long()][:, None].to(x.dtype)
    return torch.stack(codes, dim=1), trunc


def decode_frame(
    params: Dict, cfg: DualARConfig, state: DecodeState, emb2: torch.Tensor,
    sampling: SamplingConfig, gumbel_sem: Optional[torch.Tensor] = None,
    gumbel_fast: Optional[torch.Tensor] = None,
) -> Tuple[DecodeState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One two-token slow step + the fast codebook loop, at batch B.

    emb2 (B, 2, dim) = [audio_emb, cond_emb].  Gumbel noise for the
    semantic token and for the codebooks is an input, unused when sampling
    is greedy, shaped as `frame_noise_shapes` says: a row over the whole
    vocabulary where a kernel's exact sampler runs, over the sampling
    window where the windowed sampler does.  Returns (state', semantic
    (B,), codes (B, nq), audio_emb (B, 1, dim)), audio_emb being the next
    frame's summed codebook embedding.  Writes the two fresh cache rows
    into state's caches in place."""
    B = emb2.shape[0]
    samp = _sampler_args(sampling)
    pos = state.pos
    trunc = state.trunc
    if slow_kernel_runs(params, cfg, B):
        x2, k_rows, v_rows, semantic = slow_decode_step(
            params["layers"], emb2[0], state.k_cache[:, 0], state.v_cache[:, 0], pos,
            params["norm"]["w"], params["output"]["w"], gumbel_sem,
            n_head=cfg.n_head, head_dim=cfg.head_dim, norm_eps=cfg.norm_eps,
            rope_base=cfg.rope_base, **samp)
        state.k_cache[:, 0, pos : pos + 2] = k_rows
        state.v_cache[:, 0, pos : pos + 2] = v_rows
        last = x2[None, -1:]
    else:
        freqs = freqs_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base,
                            emb2.device)[pos : pos + 2]
        x = emb2
        for l in range(cfg.n_layer):
            x = _attn_block(params["layers"], l, x, freqs, state.k_cache[l],
                            state.v_cache[l], pos, *_slow_heads(cfg),
                            kernel=cfg.use_pallas_decode)
        last = x[:, -1:]
        logits = _token_logits(params, cfg, last)[:, -1]
        semantic, flag = sample_token(logits, gumbel_sem, top_k_window=sampling.top_k_window,
                                      with_flag=True, **samp)
        trunc = trunc + flag.sum(dtype=torch.int32)
    codes, audio_emb, fast_trunc = fast_codes(params, cfg, _project_fast(params, last),
                                              gumbel_fast, sampling)
    return (DecodeState(state.k_cache, state.v_cache, pos + 2, trunc + fast_trunc), semantic,
            codes, audio_emb)


def fast_codes(params: Dict, cfg: DualARConfig, hidden: torch.Tensor,
               gumbel_fast: Optional[torch.Tensor], sampling: SamplingConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The codebook loop on the fast stack's input hidden (B, 1, fast_dim):
    the fast-loop kernel at batch 1 under its flag, the plain loop
    otherwise.  Returns (codes (B, nq), the next frame's summed codebook
    embedding (B, 1, dim), the loop's nucleus truncations)."""
    if fast_kernel_runs(cfg, hidden.shape[0], model_shards(params["fast_layers"])):
        codes, aemb = fast_decode(
            params["fast_layers"], params["fast_norm"]["w"], params["fast_output"]["w"],
            params["fast_embeddings"], params["codebook_embeddings"], hidden[:, 0],
            gumbel_fast, nq=cfg.num_codebooks, n_head=cfg.fast_n_head,
            head_dim=cfg.fast_head_dim, norm_eps=cfg.norm_eps, rope_base=cfg.rope_base,
            **_sampler_args(sampling))
        zero = torch.zeros((), dtype=torch.int32, device=hidden.device)
        return codes, aemb[:, None].to(params["codebook_embeddings"].dtype), zero
    codes, trunc = _fast_loop(params, cfg, hidden, gumbel_fast, sampling)
    return codes, embed_codes(params, cfg, codes[:, :, None]), trunc
