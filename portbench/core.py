"""The harness's shared parts: the registry of cells, configurations, traffic
mixes and metric readers (all found by name under `portbench/`), the port's
configuration from a configuration file, the span timer, the profiler
window and the result line.

Nothing here imports the JAX package or JAX; the port is imported only to
drive it (`port_config`, the drivers).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import time
import types
from pathlib import Path
from typing import Callable, Dict, Iterator, List

import torch

ROOT = Path(__file__).resolve().parent  # portbench/
FORBIDDEN = ("jax", "jaxlib", "flax", "streamvoiceanon_tpu")

# H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def cache_dirs(checkout: Path) -> None:
    """Every build and kernel cache the program may write, at fixed paths
    inside the checkout (the port's own nvcc builds go to its fixed
    `streamvoiceanon_tpu_torch/_build/`)."""
    base = checkout / "portbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def keep_libraries_from_jax() -> None:
    """Keep libraries the port uses from loading JAX: `transformers` through
    `USE_FLAX=0`, and tensorboard (the trainer's `SummaryWriter`), which
    imports TensorFlow where it is installed, and TensorFlow JAX, unless
    its `notf` marker module is importable (then it uses its stub)."""
    os.environ.setdefault("USE_FLAX", "0")
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict  # the configuration file
    traffic: Dict  # the traffic mix's file
    end_to_end: List[Dict]
    per_layer: List[Dict]


def cell(bench: Dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of a BENCHMARK.json object, with its configuration
    (`configs/<config>.json`), its traffic mix (`traffic/<traffic>.json`)
    and the metrics it reports."""
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = load_json(root.parent / cfg_entry["file"])
    traffic = load_json(root / "traffic" / f"{wl['traffic']}.json")
    mine = lambda m: "workloads" not in m or name in m["workloads"]
    return Cell(name, wl, config, traffic, [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def load_module(path: Path) -> types.ModuleType:
    """The Python file at `path`, executed once as a module and kept in
    `sys.modules` under a name made from its resolved path, so that every
    caller, and a test that patches it, gets the same object."""
    path = Path(path).resolve()
    name = f"portbench_file_{hashlib.sha1(str(path).encode()).hexdigest()[:16]}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def driver(traffic: Dict, root: Path = ROOT):
    """The driver module that runs a traffic mix's kind, `drivers/<driver>.py` under `root`."""
    return load_module(root / "drivers" / f"{traffic['driver']}.py")


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The reader of a per-layer metric, `metrics/<name>.py`'s `read`."""
    return load_module(root / "metrics" / f"{metric}.py").read


def port_config(d: Dict):
    """The port's `PipelineConfig` from a configuration file's `pipeline`
    object (every field named; lists become tuples)."""
    from streamvoiceanon_tpu_torch import config as C

    def build(cls, v):
        if dataclasses.is_dataclass(cls):
            names = {f.name for f in dataclasses.fields(cls)}
            kw = {}
            for k, x in v.items():
                if k not in names:
                    raise KeyError(f"{cls.__name__} has no field {k!r}")
                default = getattr(cls(), k)
                kw[k] = build(type(default), x) if dataclasses.is_dataclass(default) else tup(x)
            return cls(**kw)
        return v

    def tup(x):
        return tuple(tup(y) for y in x) if isinstance(x, list) else x

    return build(C.PipelineConfig, d)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Spans:
    """Per-name host-clock durations (ms) of calls into the port, each
    synchronized with the card before and after where `sync` is set."""

    def __init__(self, device, sync: bool = True):
        self.ms: Dict[str, List[float]] = {}
        self.sync = sync and torch.device(device).type == "cuda"

    def timed(self, name: str, fn, *args, **kwargs):
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.sync:
            torch.cuda.synchronize()
        self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out


@contextlib.contextmanager
def wrapped(module, attr: str, wrapper_of: Callable) -> Iterator[None]:
    """Replace `module.attr` by `wrapper_of(original)` for the duration."""
    orig = getattr(module, attr)
    setattr(module, attr, wrapper_of(orig))
    try:
        yield
    finally:
        setattr(module, attr, orig)


# ---------------------------------------------------------------------------
# the profiler window
# ---------------------------------------------------------------------------


def _union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile(fn: Callable[[], None]) -> Dict:
    """Run fn under torch.profiler and read the device's work: busy seconds
    (the union of kernel and copy intervals), the traced window's seconds,
    device seconds and launches by kernel name, and the ten longest idle
    gaps by the host operation running when the gap began."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, cpu = [], []
    for ev in prof.events():
        tr = ev.time_range
        if str(ev.device_type).endswith("CUDA"):
            dev.append((tr.start, tr.end, ev.name))
        elif tr.end > tr.start:
            cpu.append((tr.start, tr.end, ev.name))
    kernels: Dict[str, List[float]] = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) * 1e-6
        k[1] += 1
    busy_s = _union([(s, e) for s, e, _ in dev]) * 1e-6
    gaps = []
    dev.sort()
    end = None
    for s, e, _ in dev:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    cpu.sort()
    starts = [c[0] for c in cpu]
    by_host: Dict[str, float] = {}
    for gs, ge in gaps:
        host = "no host op"
        i = bisect.bisect_right(starts, gs) - 1
        for s, e, name in reversed(cpu[max(0, i - 256):i + 1]):
            if e >= gs:  # the innermost host op open when the gap began
                host = name
                break
        by_host[host] = by_host.get(host, 0.0) + (ge - gs) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": {k: (v[0], v[1]) for k, v in kernels.items()},
        "device_ops": [[k, v[0]] for k, v in top[:10]],
        "idle_gaps": sorted(([k, v] for k, v in by_host.items()), key=lambda kv: -kv[1])[:10],
    }


def kernel_seconds(kernels: Dict, needles) -> tuple:
    """(device seconds, launches) of the kernels whose names hold any needle."""
    s, n = 0.0, 0
    for name, (sec, cnt) in kernels.items():
        if any(x in name for x in needles):
            s += sec
            n += cnt
    return s, n


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(device, chips: int) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}
