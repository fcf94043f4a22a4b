"""Per-stage timing, the program's own spans and profiler tracing, as the
JAX package's utils/profiling.py plus the spans.

`StageTimers` accumulates wall-time samples per stage name and reports
percentiles; `timed` fences the device work of a stage by synchronizing the
card of every CUDA tensor among its outputs (the counterpart of
`jax.block_until_ready`; CPU tensors need no fence).

Spans mark the program's stages where they run (`span(name)` around a
block) and are off by default: `span` then checks one module-level flag
and returns a shared null context, which records nothing and allocates
nothing.  `tracing()` turns the recorder on for a block and yields it.
While it is on, a span records its name, its id, its parent (the span open
on the same thread when it began) and the request id of its outermost
span, the host clock at its start and end and, once the process has used
the card, a start and an end `torch.cuda.Event` on the current stream
(from a pool reused across traced stretches); it is also a host range
named `sva.<name>` in the profiler's records, so a profiler running at
the same time shows the spans in its timeline over the operations and
launches they enclose.  `Recorder.export()`, after the block, resolves the
events (one synchronize) and returns plain data: each span's name, ids,
host ms and device ms (None without events), each kernel wrapper's
launches over the block, the hits and misses of `VoiceConverter.infer`'s
prompt cache over it, and the rows, frames run (padding included) and
valid frames of the content encoder's teacher over it
(`models/w2v_bert.W2vBertTeacher.counts`).

`trace()` wraps `torch.profiler` with the recorder on and writes a Chrome
trace `trace.json`, viewable in Perfetto or chrome://tracing, and the
export `spans.json` beside it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

PREFIX = "sva."  # the profiler's name of a span is PREFIX + its name


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


def summarize(samples: Dict[str, list]) -> Dict[str, Dict[str, float]]:
    """{name: {n, p50_ms, p95_ms, mean_ms, total_s}} of samples in seconds."""
    out = {}
    for name, xs in samples.items():
        a = np.asarray(xs)
        out[name] = {
            "n": len(a),
            "p50_ms": float(np.median(a) * 1e3),
            "p95_ms": float(np.percentile(a, 95) * 1e3),
            "mean_ms": float(a.mean() * 1e3),
            "total_s": float(a.sum()),
        }
    return out


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
        return summarize(self.samples)

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:24s} n={s['n']:5d} p50={s['p50_ms']:8.2f}ms "
                f"p95={s['p95_ms']:8.2f}ms total={s['total_s']:7.2f}s"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

_recorder: Optional["Recorder"] = None  # the recorder that is on; None: spans cost one check
# A host range in C++: about 0.5 us a span against 11 for `torch.profiler.record_function`,
# whose ranges the profiler also draws on the card's timeline from their first kernel to
# their last (gpu_user_annotation), over the idle gaps a busy time is read from.
_range = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
_EVENTS: List = []  # the CUDA events of resolved spans, for the next spans


def span(name: str):
    """A context that records the block as the span `name` while the
    recorder is on, else the shared null context."""
    rec = _recorder
    if rec is None:
        return _NULL
    return _Span(rec, name)


def _kernel_launches() -> Dict[str, int]:
    """The launches each kernel wrapper has counted so far."""
    from streamvoiceanon_tpu_torch.ops import kernel_wrappers

    return {w.__name__: w.launches for w in kernel_wrappers().values()}


def _prompt_cache_counts() -> Dict[str, int]:
    """The prompt cache's lookups so far (`runtime/pipeline.PromptCache`)."""
    from streamvoiceanon_tpu_torch.runtime.pipeline import PromptCache

    return {"hits": PromptCache.hits, "misses": PromptCache.misses}


def _teacher_counts() -> Dict[str, int]:
    """The w2v-BERT teacher's rows, frames and valid frames so far."""
    from streamvoiceanon_tpu_torch.models.w2v_bert import W2vBertTeacher

    return dict(W2vBertTeacher.counts)


def _event() -> "torch.cuda.Event":
    try:
        return _EVENTS.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "request", "t0", "t1", "ev0", "ev1", "rf",
                 "device_ms")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name
        self.t1 = self.ev0 = self.ev1 = self.device_ms = None

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        top = stack[-1] if stack else None
        self.id = next(rec._ids)
        self.parent = top.id if top is not None else None
        self.request = top.request if top is not None else self.id
        stack.append(self)
        rec.spans.append(self)
        self.rf = _range(PREFIX + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        if torch.cuda.is_initialized():  # a process that never used the card times no events
            self.ev0, self.ev1 = _event(), _event()
            self.ev0.record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.ev1 is not None:
            self.ev1.record()
        self.t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.rec._stack().pop()
        return False


class Recorder:
    """The spans of one traced stretch (`tracing()`), the kernels' launches,
    the prompt cache's lookups and the teacher's frames in it."""

    def __init__(self):
        self.spans: List[_Span] = []
        self.launches: Dict[str, int] = {}
        self.prompt_cache: Dict[str, int] = {}
        self.teacher: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._launches0 = _kernel_launches()
        self._prompt0 = _prompt_cache_counts()
        self._teacher0 = _teacher_counts()
        self._resolved = False

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _stop(self) -> None:
        self.launches = {k: n - self._launches0[k] for k, n in _kernel_launches().items()}
        self.prompt_cache = {k: n - self._prompt0[k] for k, n in _prompt_cache_counts().items()}
        self.teacher = {k: n - self._teacher0[k] for k, n in _teacher_counts().items()}

    def _resolve(self) -> None:
        """Device ms of every finished span, after one synchronize; the
        events go back to the pool."""
        if any(s.ev0 is not None for s in self.spans):
            torch.cuda.synchronize()
        for s in self.spans:
            if s.ev0 is not None:
                if s.t1 is not None:
                    s.device_ms = s.ev0.elapsed_time(s.ev1)
                _EVENTS.extend((s.ev0, s.ev1))
                s.ev0 = s.ev1 = None
        self._resolved = True

    def export(self) -> Dict:
        """{"spans": [{name, id, parent, request, host_ms, device_ms}],
        "launches": {kernel wrapper: n}, "prompt_cache": {"hits": n,
        "misses": n}, "teacher": {"rows": n, "frames": n, "valid_frames":
        n}} of the finished spans, once the traced stretch has ended."""
        if _recorder is self:
            raise RuntimeError("export() while the recorder is on")
        if not self._resolved:
            self._resolve()
        return {"spans": [{"name": s.name, "id": s.id, "parent": s.parent,
                           "request": s.request, "host_ms": (s.t1 - s.t0) * 1e-6,
                           "device_ms": s.device_ms}
                          for s in self.spans if s.t1 is not None],
                "launches": dict(self.launches), "prompt_cache": dict(self.prompt_cache),
                "teacher": dict(self.teacher)}

    def summary(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """{span name: {"host": summarize's fields, "device": the same
        (absent without events)}}."""
        host, dev = defaultdict(list), defaultdict(list)
        for s in self.export()["spans"]:
            host[s["name"]].append(s["host_ms"] * 1e-3)
            if s["device_ms"] is not None:
                dev[s["name"]].append(s["device_ms"] * 1e-3)
        h, d = summarize(host), summarize(dev)
        return {k: {"host": v, **({"device": d[k]} if k in d else {})} for k, v in h.items()}


@contextlib.contextmanager
def tracing() -> Iterator[Recorder]:
    """Turns the recorder on for the block and yields it; read it with
    `export()` after the block."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("the recorder is already on")
    rec = _recorder = Recorder()
    try:
        yield rec
    finally:
        _recorder = None
        rec._stop()


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """`torch.profiler` trace of the block, CPU activity and, with a card,
    CUDA activity, with the recorder on: a Chrome trace `trace.json` and
    the spans `spans.json` (`Recorder.export()`) under `log_dir`; nothing
    when `log_dir` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with tracing() as rec:
            yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(rec.export(), f)
