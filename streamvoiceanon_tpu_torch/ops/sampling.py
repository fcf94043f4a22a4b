"""Token sampling, as `streamvoiceanon_tpu.ops.sampling`: the repetition
penalty, temperature, the nucleus (top-p) filter and a Gumbel race; greedy
argmax.  The decode paths run no penalty (`SamplingConfig` has none; the
kernels' exact samplers have none either, as the JAX kernels).

The Gumbel noise is an input (the JAX package draws it from its key inside
`sample_token`), shaped like what it is added to: (B, top_k_window) on the
windowed path, (B, V) otherwise, so tests can feed the JAX package's draws.
Ties go to the lower index everywhere, as `lax.top_k` and `jnp.argmax`
break them: the window is a stable descending sort (the tie order of
`torch.topk` on CUDA is unspecified; with bf16 logits ties inside the
window are common).  No host synchronization.
"""

from __future__ import annotations

from typing import Optional

import torch


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B,) int64 index of the first maximum of each row."""
    col = torch.arange(x.shape[-1], device=x.device)
    hit = x == torch.amax(x, dim=-1, keepdim=True)
    return torch.amin(torch.where(hit, col, x.shape[-1]), dim=-1)


def apply_repetition_penalty(logits: torch.Tensor, previous_tokens: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """logits (..., V), previous_tokens (..., P) integer.  The scores of
    previously emitted tokens are divided by `penalty` where positive and
    multiplied by it where negative."""
    idx = previous_tokens.long()
    score = torch.gather(logits, -1, idx)
    score = torch.where(score < 0, score * penalty, score / penalty)
    return logits.scatter(-1, idx, score)


def window_covers_nucleus(logits: torch.Tensor, top_k_window: int,
                          top_p: float) -> torch.Tensor:
    """True where the top `top_k_window` logits hold at least `top_p` of the
    probability, i.e. where the windowed nucleus filter of `sample_token`
    is exact for these logits."""
    x = logits.float()
    vals = torch.topk(x, top_k_window, dim=-1).values
    logz = torch.logsumexp(x, dim=-1, keepdim=True)
    return torch.sum(torch.exp(vals - logz), dim=-1) >= top_p


def _temperature(temperature: float, device) -> torch.Tensor:
    return torch.full((), max(temperature, 1e-5), dtype=torch.float32, device=device)


def top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Set to -inf all but the smallest prefix of descending-probability
    tokens whose cumulative probability before them is <= top_p (the argmax
    is always kept)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    kth = torch.sum(cum - probs <= top_p, dim=-1, keepdim=True) - 1
    thresh = torch.gather(sorted_logits, -1, kth)
    return torch.where(logits < thresh, float("-inf"), logits)


def sample_token(logits: torch.Tensor, gumbel: Optional[torch.Tensor] = None, *,
                 temperature: float = 0.7, top_p: float = 0.7,
                 repetition_penalty: float = 1.0,
                 previous_tokens: Optional[torch.Tensor] = None, greedy: bool = False,
                 top_k_window: int = 0, with_flag: bool = False):
    """logits (B, V) -> tokens (B,) int32; with `with_flag` also (B,) int32
    flags, 1 where the windowed nucleus filter truncated the nucleus (the
    top `top_k_window` logits held less than top_p of the probability).

    `top_k_window` > 0 (and < V) filters over the top-k window only,
    normalized against the whole vocabulary; 0 is the exact full-vocabulary
    filter.  `previous_tokens` (B, P) are penalized first by
    `repetition_penalty` (`apply_repetition_penalty`).  `gumbel` is unused
    when greedy."""
    logits = logits.float()
    if previous_tokens is not None and repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, previous_tokens, repetition_penalty)
    flag = torch.zeros(logits.shape[:-1], dtype=torch.int32, device=logits.device)
    V = logits.shape[-1]
    if greedy:
        tok = _argmax_first(logits)
    elif top_k_window and top_k_window < V:
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :top_k_window], idx[..., :top_k_window]
        if top_p < 1.0:
            probs = torch.exp(vals - torch.logsumexp(logits, dim=-1, keepdim=True))
            cum = torch.cumsum(probs, dim=-1)
            vals = torch.where(cum - probs <= top_p, vals, float("-inf"))
            flag = (cum[..., -1] < top_p).to(torch.int32)
        j = _argmax_first(vals / _temperature(temperature, logits.device) + gumbel)
        tok = torch.gather(idx, -1, j[..., None])[..., 0]
    else:
        if top_p < 1.0:
            logits = top_p_mask(logits, top_p)
        tok = _argmax_first(logits / _temperature(temperature, logits.device) + gumbel)
    tok = tok.to(torch.int32)
    return (tok, flag) if with_flag else tok
