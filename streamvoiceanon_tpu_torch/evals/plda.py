"""Two-covariance PLDA for ASV scoring, as the JAX package's evals/plda.py
(the port's own copy).

The reference ASV supports cosine or PLDA backends (anon/evaluation/privacy/
asv/asv.py).  This is a numpy two-covariance PLDA: between-class covariance B
and within-class covariance W estimated by EM on length-normalized,
centered embeddings; verification score is the LLR of the two-sample
same-speaker hypothesis.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PLDA:
    mean: np.ndarray  # (D,)
    B: np.ndarray  # between-class covariance (D, D)
    W: np.ndarray  # within-class covariance (D, D)

    def score(self, enroll: np.ndarray, test: np.ndarray) -> np.ndarray:
        """LLR score matrix (N, M) for enroll (N, D) vs test (M, D)
        (two-covariance model, Brümmer & de Villiers 2010)."""
        e = _lnorm(enroll - self.mean)
        t = _lnorm(test - self.mean)
        B, W = self.B, self.W
        tot = B + W
        # same-speaker: x1, x2 ~ N(y, W), y ~ N(0, B)
        # joint covariances
        S_same = np.block([[tot, B], [B, tot]])
        S_diff = np.block([[tot, np.zeros_like(B)], [np.zeros_like(B), tot]])
        P_same = np.linalg.inv(S_same)
        P_diff = np.linalg.inv(S_diff)
        _, ld_same = np.linalg.slogdet(S_same)
        _, ld_diff = np.linalg.slogdet(S_diff)
        D = B.shape[0]
        # quadratic form decomposition: score(i,j) = -0.5 [z' (P_same-P_diff) z] + c
        A11 = P_same[:D, :D] - P_diff[:D, :D]
        A12 = P_same[:D, D:]  # P_diff cross-block is zero
        A22 = P_same[D:, D:] - P_diff[D:, D:]
        q_e = -0.5 * np.einsum("nd,de,ne->n", e, A11, e)
        q_t = -0.5 * np.einsum("md,de,me->m", t, A22, t)
        cross = -(e @ A12 @ t.T)
        const = -0.5 * (ld_same - ld_diff)
        return q_e[:, None] + q_t[None, :] + cross + const


def _lnorm(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def train_plda(
    embeddings: np.ndarray, labels: np.ndarray, n_iter: int = 10,
    reg: float = 1e-4,
) -> PLDA:
    """EM for the two-covariance model on (N, D) embeddings with speaker
    labels.  Length-normalizes and centers first."""
    mean = embeddings.mean(axis=0)
    x = _lnorm(embeddings - mean)
    D = x.shape[1]
    spk = {}
    for i, l in enumerate(labels):
        spk.setdefault(l, []).append(i)
    groups = [np.asarray(idx) for idx in spk.values()]

    # init from scatter matrices
    mu_s = np.stack([x[g].mean(axis=0) for g in groups])
    B = np.cov(mu_s.T) + reg * np.eye(D)
    W = np.zeros((D, D))
    for g, mu in zip(groups, mu_s):
        d = x[g] - mu
        W += d.T @ d
    W = W / len(x) + reg * np.eye(D)

    for _ in range(n_iter):
        B_acc = np.zeros((D, D))
        W_acc = np.zeros((D, D))
        B_inv = np.linalg.inv(B)
        W_inv = np.linalg.inv(W)
        for g in groups:
            n = len(g)
            # posterior of speaker factor y given the n observations
            prec = B_inv + n * W_inv
            cov_y = np.linalg.inv(prec)
            mu_y = cov_y @ (W_inv @ x[g].sum(axis=0))
            B_acc += cov_y + np.outer(mu_y, mu_y)
            d = x[g] - mu_y
            W_acc += d.T @ d + n * cov_y
        B = B_acc / len(groups) + reg * np.eye(D)
        W = W_acc / len(x) + reg * np.eye(D)
    return PLDA(mean=mean, B=B, W=W)
