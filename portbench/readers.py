"""Shared arithmetic of the per-layer metric readers (`metrics/<name>.py`).

A reader takes the readings of a traced run and returns its metric, or
None where the run holds nothing to read (the harness then leaves the
metric out of the line).  A share of a roofline or of a peak is never
made up: with no device time measured it is None, not 0."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from portbench.core import kernel_seconds

# the CUDA kernels each of the port's kernel wrappers launches, by name
KERNELS = {
    "slow_decode": ("matvec_kernel", "slow_attn_kernel", "sample_kernel"),
    "fast_decode": ("fast_loop_kernel",),
}


def span_median(r: Dict, name: str) -> Optional[float]:
    ms = (r.get("spans") or {}).get(name)
    return statistics.median(ms) if ms else None


def span_share(r: Dict, name: str) -> Optional[float]:
    """A span's total over the window's seconds, in %."""
    ms = (r.get("spans") or {}).get(name)
    w = r.get("span_window_s")
    return 100.0 * sum(ms) / 1e3 / w if ms and w else None


def roofline(r: Dict, kernel: str) -> Optional[float]:
    """The least time of the profiled calls of a kernel over their device time, in %."""
    least = (r.get("kernel_least_s") or {}).get(kernel)
    prof = r.get("profile")
    if not least or not prof:
        return None
    sec, n = kernel_seconds(prof["kernels"], KERNELS[kernel])
    return 100.0 * least / sec if sec > 0 and n > 0 else None


def idle(r: Dict) -> Optional[float]:
    prof = r.get("profile")
    if not prof or prof["busy_s"] <= 0 or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu(r: Dict) -> Optional[float]:
    """The least time of the measured work at the card's peaks over the time it took, in %."""
    least, took = r.get("least_unsync_s"), r.get("time_unsync_s")
    return 100.0 * least / took if least and took else None
