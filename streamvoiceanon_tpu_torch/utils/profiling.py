"""Per-stage timing and profiler tracing, as the JAX package's
utils/profiling.py.

`StageTimers` accumulates wall-time samples per stage name and reports
percentiles; `timed` fences the device work of a stage by synchronizing the
card of every CUDA tensor among its outputs (the counterpart of
`jax.block_until_ready`; CPU tensors need no fence).  `trace()` wraps
`torch.profiler` and writes a Chrome trace, viewable in Perfetto or
chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors of a nested tuple/list/dict tree."""
    if torch.is_tensor(tree):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block_until_ready(tree):
    """Waits for the device work that produces `tree`'s CUDA tensors;
    returns `tree`."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


class StageTimers:
    """Accumulates wall-time samples per stage name.

    `stage()` is a plain host-side timer (asynchronous device work only
    counts its enqueue); use `timed()` for device stages, which waits for
    the outputs so that the sample includes the device's execution::

        timers = StageTimers()
        with timers.stage("host_refill"):
            schedule_refill(...)
        tokens = timers.timed("encode", encode_fn, wav_chunk)
    """

    def __init__(self):
        self.samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs):
        """Runs `fn`, waits for its outputs (device fence), records the
        wall time, returns the outputs."""
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        self.samples[name].append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{stage: {n, p50_ms, p95_ms, mean_ms, total_s}}."""
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "n": len(a),
                "p50_ms": float(np.median(a) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "mean_ms": float(a.mean() * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:24s} n={s['n']:5d} p50={s['p50_ms']:8.2f}ms "
                f"p95={s['p95_ms']:8.2f}ms total={s['total_s']:7.2f}s"
            )
        return "\n".join(lines)

    def audio_seconds_per_second(self, stage: str, seconds_per_call: float) -> float:
        """Throughput: seconds of audio a stage processes per second."""
        s = self.summary().get(stage)
        if not s or s["total_s"] == 0:
            return 0.0
        return s["n"] * seconds_per_call / s["total_s"]


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """`torch.profiler` trace of the block, CPU activity and, with a card,
    CUDA activity, written as a Chrome trace `trace.json` under `log_dir`;
    nothing when `log_dir` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
