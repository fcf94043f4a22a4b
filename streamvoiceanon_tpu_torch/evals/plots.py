"""Score-distribution / privacy-profile plots, as the JAX package's
evals/plots.py (the port's own copy).  Matplotlib is imported inside each
function, so the module imports where matplotlib is missing.

Framework equivalent of the reference plotting utilities
(`anon/evaluation/privacy/asv/metrics/utils/{plo_plots,zebra_plots,
visualization}.py`, SURVEY.md §2.3): mated/non-mated score histograms with
the linkability D<=>(s) overlay, the ZEBRA ECE profile over the prior
log-odds range, and a DET-style miss/false-alarm curve.  Matplotlib Agg
backend (headless), one PNG per call.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from streamvoiceanon_tpu_torch.evals import privacy_metrics as pm


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_score_distribution(tar: np.ndarray, non: np.ndarray, path,
                            title: str = "score distributions") -> None:
    """Mated / non-mated histograms + linkability D<=>(s) curve
    (linkability.py draw_scores / plo_plots equivalent)."""
    plt = _pyplot()
    tar = np.asarray(tar, np.float64)
    non = np.asarray(non, np.float64)
    n_bins = max(min(len(tar) // 10, 100), 5)
    edges = np.linspace(min(tar.min(), non.min()), max(tar.max(), non.max()),
                        n_bins + 1)
    centers = (edges[1:] + edges[:-1]) / 2
    y1 = np.histogram(tar, bins=edges, density=True)[0]
    y2 = np.histogram(non, bins=edges, density=True)[0]
    lr = np.divide(y1, y2, out=np.ones_like(y1), where=y2 != 0)
    d = 2 * (lr / (1 + lr)) - 1
    d[lr <= 1] = 0
    d[(y2 == 0) & (y1 != 0)] = 1

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(centers, y1, label="mated", color="tab:blue")
    ax.plot(centers, y2, label="non-mated", color="tab:orange")
    ax.set_xlabel("score")
    ax.set_ylabel("density")
    ax2 = ax.twinx()
    ax2.plot(centers, d, label="D(s)", color="tab:red", linestyle="--")
    ax2.set_ylabel("local linkability D(s)")
    ax2.set_ylim(0, 1.05)
    dsys = pm.linkability(tar, non)
    ax.set_title(f"{title}  (Dsys={dsys:.3f})")
    ax.legend(loc="upper left")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_zebra_profile(tar: np.ndarray, non: np.ndarray, path,
                       title: str = "ZEBRA profile") -> None:
    """ECE vs prior log-odds curve with the flat-prior reference
    (zebra_plots equivalent): the area between the curves is the expected
    privacy disclosure (DECE)."""
    plt = _pyplot()
    tar_llr, non_llr = pm.optimal_llr(np.asarray(tar), np.asarray(non))
    prior_log_odds = np.linspace(-10, 10, 201)

    def ece(llr_tar, llr_non, plo):
        p = 1 / (1 + np.exp(-plo))
        e_tar = np.mean(np.log1p(np.exp(-(llr_tar + plo)))) / np.log(2)
        e_non = np.mean(np.log1p(np.exp(llr_non + plo))) / np.log(2)
        return p * e_tar + (1 - p) * e_non

    curve = np.array([ece(tar_llr, non_llr, plo) for plo in prior_log_odds])
    p = 1 / (1 + np.exp(-prior_log_odds))
    ref = -(p * np.log2(p) + (1 - p) * np.log2(1 - p))

    dece, max_llr, tag = pm.zebra(np.asarray(tar), np.asarray(non))
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(prior_log_odds, ref, label="no evidence (prior)", color="gray")
    ax.plot(prior_log_odds, curve, label="after observation", color="tab:red")
    ax.fill_between(prior_log_odds, curve, ref, alpha=0.2, color="tab:red")
    ax.set_xlabel("prior log-odds")
    ax.set_ylabel("ECE [bits]")
    ax.set_title(f"{title}  (DECE={dece:.4f}, max|LLR|={max_llr:.2f}, cat {tag})")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_det(tar: np.ndarray, non: np.ndarray, path,
             title: str = "DET") -> None:
    """Miss vs false-alarm trade-off with the EER point (visualization.py
    equivalent; plotted on probit-like log axes)."""
    plt = _pyplot()
    tar = np.sort(np.asarray(tar, np.float64))
    non = np.sort(np.asarray(non, np.float64))
    thr = np.unique(np.concatenate([tar, non]))
    pmiss = np.searchsorted(tar, thr, side="left") / len(tar)
    pfa = 1.0 - np.searchsorted(non, thr, side="right") / len(non)
    eer_val = pm.eer(tar, non)[0]

    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(pfa * 100, pmiss * 100, color="tab:blue")
    ax.plot([eer_val * 100], [eer_val * 100], "o", color="tab:red",
            label=f"EER={eer_val*100:.2f}%")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlim(0.1, 100)
    ax.set_ylim(0.1, 100)
    ax.set_xlabel("false alarm rate [%]")
    ax.set_ylabel("miss rate [%]")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_all(tar: np.ndarray, non: np.ndarray, out_dir, prefix: str = "asv") -> list:
    """All three plots into `out_dir`; returns written paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = [
        out / f"{prefix}_scores.png",
        out / f"{prefix}_zebra.png",
        out / f"{prefix}_det.png",
    ]
    plot_score_distribution(tar, non, paths[0])
    plot_zebra_profile(tar, non, paths[1])
    plot_det(tar, non, paths[2])
    return paths
