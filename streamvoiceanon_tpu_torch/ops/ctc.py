"""The CTC loss of `optax.ctc_loss`, which the JAX package's ASR_eval
recognisers train with.

The alpha recursion runs in log space over the frames with optax's
`log_epsilon` (-1e5) standing for log(0), so a label sequence longer than
its frames allow gives a large finite loss (and finite gradients), where
`torch.nn.functional.ctc_loss` gives inf.  Inputs are optax's: paddings
are 1.0 where a frame or a label is padding, labels right-padded.  Plain
PyTorch (the JAX package computes it outside any Pallas kernel); autograd
gives its gradient.
"""

from __future__ import annotations

import torch


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0,
             log_epsilon: float = -1e5) -> torch.Tensor:
    """logits (B, T, K), logit_paddings (B, T), labels (B, N) int,
    label_paddings (B, N) -> the (B,) negative log-likelihoods."""
    B, T, K = logits.shape
    N = labels.shape[1]
    dt = logits.dtype
    logprobs = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    labellens = N - label_paddings.sum(dim=1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(dt)
    repeat = torch.nn.functional.pad(repeat, (0, 1))  # (B, N)

    logprobs_phi = logprobs[:, :, blank_id : blank_id + 1].transpose(0, 1)  # (T, B, 1)
    logprobs_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(B, T, N))
    logprobs_emit = logprobs_emit.transpose(0, 1)  # (T, B, N)
    pads = logit_paddings.to(dt).transpose(0, 1)  # (T, B)

    phi = torch.full((B, N + 1), log_epsilon, dtype=dt, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((B, N), log_epsilon, dtype=dt, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=1)

    for t in range(T):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi, pad = logprobs_emit[t], logprobs_phi[t], pads[t][:, None]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi

    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]
