"""The ASR decoder head of the content encoder's training, as the JAX
package's models/asr_decoder.py: a decoder-only transformer (the dual-AR's
layer stack, `dual_ar.run_layers`, causal with RoPE) that reads the
tokenizer's latents as a prefix and Whisper-tokenized text after it.

`forward` packs each sample's [audio[:la] | bos text eos] into one causal
stream and returns the sequence-to-sequence cross-entropy over the text
span, averaged per sample and then over the batch.  `greedy_decode`
transcribes one utterance token by token, recomputing the whole prefix at
each step (the reference's loop has no cache).  Trees come from
`utils/randparams.asr_decoder_params_np` or from the JAX package's `init`
through `params.asr_decoder_params`: layers stacked on a leading axis,
linears (in, out).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from streamvoiceanon_tpu_torch.models.dual_ar import run_layers
from streamvoiceanon_tpu_torch.ops.decode_common import freqs_table
from streamvoiceanon_tpu_torch.ops.norm import rms_norm


@dataclass(frozen=True)
class ASRDecoderConfig:
    hidden_dim: int = 768
    num_heads: int = 12
    depth: int = 12
    block_size: int = 4096
    in_channels: int = 512
    n_vocab: int = 51866  # whisper vocab
    bos_id: int = 50528
    eos_id: int = 50527
    rope_base: float = 10000.0
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def intermediate_size(self) -> int:
        n_hidden = int(2 * (4 * self.hidden_dim) / 3)
        return n_hidden if n_hidden % 256 == 0 else n_hidden + 256 - n_hidden % 256


def _audio(params: Dict, audio_feats: torch.Tensor) -> torch.Tensor:
    if "audio_proj" in params:
        return audio_feats @ params["audio_proj"]["w"] + params["audio_proj"]["b"]
    return audio_feats


def _backbone(params: Dict, cfg: ASRDecoderConfig, x: torch.Tensor) -> torch.Tensor:
    freqs = freqs_table(x.shape[1], cfg.head_dim, cfg.rope_base, x.device)
    h = run_layers(params["layers"], x, freqs, cfg.num_heads, cfg.num_heads, cfg.head_dim,
                   cfg.norm_eps)
    return rms_norm(h, params["norm"]["w"], cfg.norm_eps)


@torch.no_grad()
def greedy_decode(params: Dict, cfg: ASRDecoderConfig, audio_feats: torch.Tensor,
                  max_len: int = 128) -> torch.Tensor:
    """audio_feats (1, Ta, in_channels) -> (max_len,) int32 token ids: at
    step t the stream [audio | bos tokens] (tokens eos-filled past t) runs
    whole, and the argmax of the logits at row Ta + t is token t."""
    audio = _audio(params, audio_feats)
    Ta, dev = audio.shape[1], audio.device
    tokens = torch.full((max_len,), cfg.eos_id, dtype=torch.long, device=dev)
    bos = torch.full((1,), cfg.bos_id, dtype=torch.long, device=dev)
    for t in range(max_len):
        emb = params["text_embedding"][torch.cat([bos, tokens])][None]
        h = _backbone(params, cfg, torch.cat([audio, emb], dim=1))
        logits = h[0, Ta + t] @ params["prediction_head"]["w"] + params["prediction_head"]["b"]
        tokens[t] = torch.argmax(logits)
    return tokens.to(torch.int32)


def forward(params: Dict, cfg: ASRDecoderConfig, audio_feats: torch.Tensor,
            audio_lens: torch.Tensor, text: torch.Tensor,
            text_lens: torch.Tensor) -> torch.Tensor:
    """The s2s CE of a batch: audio_feats (B, Ta, in_channels) tokenizer
    latents with audio_lens (B,) valid frames, text (B, Tt) right-padded
    token ids with text_lens (B,).  Row la + f of sample b predicts text
    token f + 1 of [bos text eos] for f < text_len + 1; the CE is in
    float32 (float64 for a float64 tree)."""
    B, Ta, _ = audio_feats.shape
    Tt = text.shape[1]
    dev = audio_feats.device
    text = text.to(dev).long()
    text_lens = text_lens.to(dev).long() + 2
    text = torch.cat([torch.full((B, 1), cfg.bos_id, dtype=torch.long, device=dev), text,
                      torch.zeros((B, 1), dtype=torch.long, device=dev)], dim=1)
    pos_t = torch.arange(Tt + 2, device=dev)[None, :]
    text = torch.where(pos_t >= text_lens[:, None] - 1, cfg.eos_id, text)

    audio = _audio(params, audio_feats)
    text_emb = params["text_embedding"][text]  # (B, Tt + 2, D)

    L = Ta + Tt + 2
    pos = torch.arange(L, device=dev)[None, :]
    la = audio_lens.to(dev).long()[:, None]
    audio_pad = torch.nn.functional.pad(audio, (0, 0, 0, L - Ta))
    t_idx = torch.clamp(pos - la, 0, Tt + 1)
    text_gath = torch.gather(text_emb, 1, t_idx[..., None].expand(-1, -1, text_emb.shape[-1]))
    x = torch.where((pos < la)[..., None], audio_pad, text_gath)

    h = _backbone(params, cfg, x)
    tgt = text[:, 1:]  # (B, Tt + 1)
    f_idx = torch.arange(Tt + 1, device=dev)[None, :]
    gather_pos = torch.clamp(la + f_idx, 0, L - 1)
    # the rows read, before the vocabulary projection (JAX projects every row
    # and gathers after: the same values)
    hs = torch.gather(h, 1, gather_pos[..., None].expand(-1, -1, h.shape[-1]))
    acc = torch.float64 if h.dtype == torch.float64 else torch.float32
    logits = (hs @ params["prediction_head"]["w"] + params["prediction_head"]["b"]).to(acc)
    valid = (f_idx < (text_lens - 1)[:, None]).to(acc)
    logz = torch.logsumexp(logits, dim=-1)
    sel = torch.gather(logits, -1, tgt[..., None])[..., 0]
    per_sample = torch.sum((logz - sel) * valid, dim=1) / torch.clamp(valid.sum(dim=1), min=1.0)
    return per_sample.mean()
