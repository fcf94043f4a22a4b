"""Plain PyTorch reference of the dual-AR voice-conversion LM, run over a
whole conversation at once: the slow stack causally over the interleaved
stream, then the fast stack teacher-forced over each frame's codebooks.

The stream layout (the published ARVC model's):

  [spk (33) | (cond_0, audio_0) (cond_1, audio_1) ... ]

with cond = the prompt's content tokens, then the source's (then the
wait4end rows, offline), and audio = `delay` wait4start rows, then the
prompt's codes, then the generated codes.  The hidden state at the row of
cond_{Tp + delay + f} predicts frame f's codebooks.

Written from the port's plain paths at commit b084fe3
(`streamvoiceanon_tpu_torch/models/arvc.py` `spk_condition`,
`embed_content`, `generate`'s layout; `models/dual_ar.py` `_attn_block`
without a cache, `forward_train`'s teacher-forced fast stack,
`_token_logits`).  Departures: no KV cache, no kernels, every row of a
segment in one causal pass; attention in float32 whatever the weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nn


def spk_condition(p: Dict, style, timbre):
    t = timbre @ p["context_in"]["w"] + p["context_in"]["b"]
    s = style @ p["style_in"]["w"] + p["style_in"]["b"]
    return torch.cat([t, s[:, None]], dim=1)


def embed_codes(m: Dict, d, codes):
    """codes (B, nq, T) -> summed codebook embeddings (B, T, dim)."""
    off = torch.arange(d.num_codebooks, device=codes.device) * d.codebook_size
    return m["codebook_embeddings"][codes.long() + off[None, :, None]].sum(dim=1)


def _stack(lay: Dict, x, n_head: int, n_local: int, head_dim: int, eps: float, rope_base):
    """Every layer of a stack, causal over the rows of x (B, T, dim)."""
    B, T, _ = x.shape
    freqs = torch.from_numpy(nn.freqs_cis(T, head_dim, rope_base)).to(x.device)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for l in range(lay["wqkv"]["w"].shape[0]):
        h = nn.rms_norm(x, lay["attention_norm"]["w"][l], eps)
        q, k, v = torch.split(h @ lay["wqkv"]["w"][l],
                              [n_head * head_dim, n_local * head_dim, n_local * head_dim], -1)
        q = nn.apply_rope(q.reshape(B, T, n_head, head_dim), freqs).transpose(1, 2)
        k = nn.apply_rope(k.reshape(B, T, n_local, head_dim), freqs).transpose(1, 2)
        v = v.reshape(B, T, n_local, head_dim).transpose(1, 2)
        if n_local != n_head:
            k = k.repeat_interleave(n_head // n_local, dim=1)
            v = v.repeat_interleave(n_head // n_local, dim=1)
        s = (q.float() @ k.float().transpose(-1, -2)) / np.sqrt(head_dim)
        w = torch.softmax(torch.where(mask, s, float("-inf")), dim=-1).to(x.dtype)
        a = (w @ v).transpose(1, 2).reshape(B, T, n_head * head_dim)
        x = x + a @ lay["wo"]["w"][l]
        f = nn.rms_norm(x, lay["ffn_norm"]["w"][l], eps)
        x = x + (F.silu(f @ lay["w1"]["w"][l]) * (f @ lay["w3"]["w"][l])) @ lay["w2"]["w"][l]
    return x


def _local(n_local: int, n_head: int) -> int:
    return n_local if n_local > 0 else n_head


def frame_hidden(p: Dict, d, style, timbre, cond_tokens, audio_codes, delay: int,
                 n_prompt: int, n_frames: int, wait4end: int = 0):
    """The slow stack's hidden state (1, n_frames, dim) at the cond rows that
    predict frames 0..n_frames-1 of a segment.

    cond_tokens (1, Tc) are the prompt's content tokens then the source's;
    `wait4end` wait4end rows follow them; audio_codes (1, nq, Ta) are the
    prompt's codes then the generated frames' (teacher forcing)."""
    m = p["model"]
    dt = p["embedding"].dtype
    cond = p["embedding"][cond_tokens.long()]
    if wait4end:
        cond = torch.cat([cond, p["wait4end"][None, :wait4end].to(dt)], dim=1)
    audio = torch.cat([p["wait4start"][None, :delay].to(dt), embed_codes(m, d, audio_codes)], 1)
    n_pairs = n_prompt + delay + n_frames  # the last pair's audio slot is never read
    cond, audio = cond[:, :n_pairs], audio[:, :n_pairs]
    if cond.shape[1] < n_pairs or audio.shape[1] < n_pairs - 1:
        raise ValueError("frame_hidden: too few cond tokens or codes for the frames")
    audio = F.pad(audio, (0, 0, 0, n_pairs - audio.shape[1]))
    inter = torch.stack([cond, audio], dim=2).reshape(1, 2 * n_pairs, -1)
    seq = torch.cat([spk_condition(p, style.to(dt), timbre.to(dt)), inter], dim=1)
    seq = seq[:, :-1]  # up to the last cond row
    x = _stack(m["layers"], seq, d.n_head, _local(d.n_local_heads, d.n_head), d.head_dim,
               d.norm_eps, d.rope_base)
    S = seq.shape[1] - 2 * n_pairs + 1  # the speaker prefix
    rows = S + 2 * (n_prompt + delay + torch.arange(n_frames, device=x.device))
    return x[:, rows]


def codebook_logits(p: Dict, d, hidden, codes):
    """The fast stack teacher-forced on the served codes: hidden (N, dim) of
    each frame's cond row, codes (N, nq) -> float32 logits (N, nq, V)."""
    m = p["model"]
    x = hidden
    if "fast_project_in" in m:
        x = x @ m["fast_project_in"]["w"] + m["fast_project_in"].get("b", 0.0)
    fin = torch.cat([x[:, None], m["fast_embeddings"][codes[:, :-1].long()]], dim=1)
    h = _stack(m["fast_layers"], fin, d.fast_n_head,
               _local(d.fast_n_local_heads, d.fast_n_head), d.fast_head_dim, d.norm_eps,
               d.rope_base)
    h = nn.rms_norm(h, m["fast_norm"]["w"], d.norm_eps)
    return (h @ m["fast_output"]["w"]).float()


def served_gap(logits, gumbel, served, temperature: float, top_p: float, slack: float):
    """How far each served token lies below the reference's best in the
    sampler's race, in logits: max over the nucleus of (logit + T * gumbel)
    less the served token's, at least 0.  The nucleus is the exact filter
    (the top tokens whose probability sums to at most top_p); the best is
    taken over the nucleus at top_p - slack, and a served token outside the
    nucleus at top_p + slack reads 100.  logits, gumbel (..., V); served (...)."""
    probs = torch.softmax(logits, dim=-1)
    sp, order = torch.sort(probs, dim=-1, descending=True)
    cum = torch.cumsum(sp, dim=-1)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(order.shape[-1], device=order.device).expand_as(order))
    cum_at = torch.gather(cum, -1, rank)  # each token's inclusive cumulative mass
    top = rank == 0
    strict = (cum_at <= top_p - slack) | top
    loose = (cum_at <= top_p + slack) | top
    race = logits + temperature * gumbel
    best = torch.where(strict, race, float("-inf")).amax(dim=-1)
    got = torch.gather(race, -1, served.long()[..., None])[..., 0]
    gap = torch.clamp(best - got, min=0.0)
    inside = torch.gather(loose, -1, served.long()[..., None])[..., 0]
    return torch.where(inside, gap, torch.full_like(gap, 100.0))


def race_winner(logits, gumbel, temperature: float, top_p: float):
    """The token the exact nucleus sampler picks from these logits and noise."""
    probs = torch.softmax(logits, dim=-1)
    sp, order = torch.sort(probs, dim=-1, descending=True)
    cum = torch.cumsum(sp, dim=-1)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(order.shape[-1], device=order.device).expand_as(order))
    keep = (torch.gather(cum, -1, rank) <= top_p) | (rank == 0)
    race = torch.where(keep, logits / temperature + gumbel, float("-inf"))
    return race.argmax(dim=-1)
