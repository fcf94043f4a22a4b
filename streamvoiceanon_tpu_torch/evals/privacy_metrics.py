"""Privacy / utility metrics for anonymization evaluation (VPC2024 kit), as
the JAX package's evals/privacy_metrics.py (the port's own copy).

Numpy re-implementations of the metrics the reference evaluation harness
computes (anon/evaluation/privacy/asv/metrics/{cllr,linkability,zebra}.py and
helpers.py): EER, Cllr/minCllr (PAV-calibrated), ROCCH-EER, linkability Dsys,
and the ZEBRA framework (expected privacy disclosure DECE + worst-case
strength of evidence with ENFSI-style categorical tags).

All functions take mated (target) and non-mated (non-target) score arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.special import expit, logit

# numpy 2 renamed trapz to trapezoid; the same rule under either name
_trapezoid = getattr(np, "trapezoid", None) or getattr(np, "trapz")


# ---------------------------------------------------------------------------
# EER
# ---------------------------------------------------------------------------


def eer(tar: np.ndarray, non: np.ndarray) -> Tuple[float, float]:
    """Equal error rate via ROC sweep.  Returns (eer, threshold)."""
    tar = np.sort(np.asarray(tar, np.float64))
    non = np.sort(np.asarray(non, np.float64))
    all_scores = np.concatenate([tar, non])
    thresholds = np.unique(all_scores)
    pmiss = np.searchsorted(tar, thresholds, side="left") / len(tar)
    pfa = 1.0 - np.searchsorted(non, thresholds, side="right") / len(non)
    i = np.argmin(np.abs(pmiss - pfa))
    return float((pmiss[i] + pfa[i]) / 2), float(thresholds[i])


# ---------------------------------------------------------------------------
# PAV calibration / Cllr
# ---------------------------------------------------------------------------


def pav(y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pool-adjacent-violators: least-squares non-decreasing fit.

    Returns (fitted values, block widths)."""
    y = np.asarray(y, np.float64)
    n = len(y)
    # stack of (value, weight) blocks
    vals = np.empty(n)
    wts = np.empty(n, dtype=np.int64)
    top = 0
    for v in y:
        vals[top] = v
        wts[top] = 1
        top += 1
        while top > 1 and vals[top - 2] >= vals[top - 1]:
            w = wts[top - 2] + wts[top - 1]
            vals[top - 2] += (wts[top - 1] / w) * (vals[top - 1] - vals[top - 2])
            wts[top - 2] = w
            top -= 1
    out = np.repeat(vals[:top], wts[:top])
    return out, wts[:top].copy()


def optimal_llr(
    tar: np.ndarray, non: np.ndarray, monotonicity_epsilon: float = 1e-6,
    compute_eer: bool = False,
):
    """PAV-optimal calibration of scores to LLRs (helpers.py:124-215)."""
    tar = np.asarray(tar, np.float64)
    non = np.asarray(non, np.float64)
    scores = np.concatenate([non, tar])
    ideal = np.concatenate([np.zeros(len(non)), np.ones(len(tar))])
    order = np.argsort(scores, kind="mergesort")
    popt, widths = pav(ideal[order])

    log_prior_odds = np.log(len(tar) / len(non))
    with np.errstate(divide="ignore"):
        llrs = logit(popt) - log_prior_odds
    n = len(scores)
    llrs = llrs + np.arange(n) * monotonicity_epsilon / n

    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    tar_llrs = llrs[inv][len(non):]
    non_llrs = llrs[inv][: len(non)]
    if not compute_eer:
        return tar_llrs, non_llrs

    # ROCCH-EER from PAV blocks: each block is a vertex of the ROC convex
    # hull; EER is where pmiss == pfa on the hull
    sorted_ideal = ideal[order]
    edges = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
    miss = np.concatenate([[0], np.cumsum(sorted_ideal)])  # targets below idx
    pmiss = miss[edges] / len(tar)
    pfa = (edges - miss[edges]) / len(non)
    pfa = 1.0 - pfa  # accept side
    # hull vertices: (pmiss[i], pfa[i]); find segment crossing pmiss == pfa
    rocch_eer = 0.0
    for i in range(len(edges) - 1):
        x1, y1 = pmiss[i], pfa[i]
        x2, y2 = pmiss[i + 1], pfa[i + 1]
        # segment param t where x == y
        denom = (x2 - x1) - (y2 - y1)
        if abs(denom) < 1e-12:
            continue
        t = (y1 - x1) / denom
        if 0.0 <= t <= 1.0:
            rocch_eer = max(rocch_eer, x1 + t * (x2 - x1))
    return tar_llrs, non_llrs, float(rocch_eer)


def cllr(tar_llrs: np.ndarray, non_llrs: np.ndarray) -> float:
    """Application-independent cost of LLRs (cllr.py:25-67)."""
    tp = expit(np.asarray(tar_llrs, np.float64))
    np_ = expit(-np.asarray(non_llrs, np.float64))
    if np.any(tp == 0) or np.any(np_ == 0):
        return float("inf")
    c1 = float(np.mean(-np.log(tp))) / np.log(2)
    c2 = float(np.mean(-np.log(np_))) / np.log(2)
    return (c1 + c2) / 2


def min_cllr(tar: np.ndarray, non: np.ndarray) -> float:
    t, n = optimal_llr(tar, non)
    return cllr(t, n)


# ---------------------------------------------------------------------------
# Linkability
# ---------------------------------------------------------------------------


def linkability(mated: np.ndarray, non_mated: np.ndarray, omega: float = 1.0) -> float:
    """Global linkability Dsys (linkability.py:28-95, Gomez-Barrero et al.)."""
    mated = np.asarray(mated, np.float64)
    non_mated = np.asarray(non_mated, np.float64)
    n_bins = min(len(mated) // 10, 100)
    edges = np.linspace(
        min(mated.min(), non_mated.min()), max(mated.max(), non_mated.max()),
        n_bins + 1,
    )
    centers = (edges[1:] + edges[:-1]) / 2
    y1 = np.histogram(mated, bins=edges, density=True)[0]
    y2 = np.histogram(non_mated, bins=edges, density=True)[0]
    lr = np.divide(y1, y2, out=np.ones_like(y1), where=y2 != 0)
    d = 2 * (omega * lr / (1 + omega * lr)) - 1
    d[omega * lr <= 1] = 0
    d[(y2 == 0) & (y1 != 0)] = 1
    return float(_trapezoid(d * y1, x=centers))


# ---------------------------------------------------------------------------
# ZEBRA (zero-evidence biometric recognition assessment)
# ---------------------------------------------------------------------------


def _int_ece(x: np.ndarray, epsilon: float = 1e-6) -> float:
    """Integrated ECE contribution (zebra.py:23-38)."""
    x = np.asarray(x, np.float64)
    contrib = np.zeros(len(x))
    idx = (~np.isinf(x)) & (np.abs(x) > epsilon)
    xx = x[idx]
    lrm1 = np.exp(xx) - 1.0
    contrib[idx] = (xx - lrm1) / lrm1**2
    contrib[np.abs(x) < epsilon] = -0.5
    return 0.25 + float(contrib.mean()) / 2


ZEBRA_CATEGORIES = (
    ("0", 0.0), ("A", np.finfo(float).eps), ("B", 1.0), ("C", 2.0),
    ("D", 4.0), ("E", 5.0), ("F", 6.0),
)


def zebra(tar: np.ndarray, non: np.ndarray):
    """Returns (dece, max_abs_llr_base10, category_tag) (zebra.py:41-73)."""
    tar_llr, non_llr = optimal_llr(tar, non)
    dece = (_int_ece(tar_llr) + _int_ece(-non_llr)) / np.log(2)
    max_abs = float(np.abs(np.concatenate([tar_llr, non_llr])).max() / np.log(10))
    tag = "0"
    for name, lo in ZEBRA_CATEGORIES:
        if max_abs >= lo:
            tag = name
    return float(dece), max_abs, tag


# ---------------------------------------------------------------------------
# ASV cosine scoring
# ---------------------------------------------------------------------------


def cosine_scores(enroll: np.ndarray, trial: np.ndarray) -> np.ndarray:
    """Cosine similarity matrix between (N, D) enrollment and (M, D) trial
    embeddings (asv.py cosine backend)."""
    e = enroll / np.linalg.norm(enroll, axis=-1, keepdims=True)
    t = trial / np.linalg.norm(trial, axis=-1, keepdims=True)
    return e @ t.T


def asv_eer_from_embeddings(
    enroll: np.ndarray, trial: np.ndarray, labels_enroll: np.ndarray,
    labels_trial: np.ndarray,
) -> float:
    """EER of cosine ASV over all enroll x trial pairs."""
    s = cosine_scores(enroll, trial)
    same = labels_enroll[:, None] == labels_trial[None, :]
    return eer(s[same], s[~same])[0]
