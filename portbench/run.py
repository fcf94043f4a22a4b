"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics come from
`BENCHMARK.json` at the root of the checkout, each found by name under
`portbench/`: `configs/<config>.json`, `traffic/<traffic>.json` (whose
`driver` names `drivers/<driver>.py`), `limits/<cell>.json` (the limits of
the comparison that decides `correct`) and `metrics/<metric>.py` (the
reader of each per-layer metric).  The harness's own CPU tests find what
they know of a kind of cell, by the traffic's `driver`, in
`tests/kinds/<driver>.py`.

A cell of a new kind is added as new files and `BENCHMARK.json` entries
only.  Beside its entries it brings:

- `drivers/<driver>.py`, whose `run(ctx)` drives the port through the
  window and returns its readings, and which with `ctx.control` also puts
  the reference one precision down in the program's place and returns its
  numbers under `control_<name>` (`tests/test_portbench_control.py`);
- `tests/kinds/<driver>.py`: `tiny_config` and `tiny_traffic`, which cut
  a configuration and a traffic mix of the kind to a CPU test's size,
  `FAULTS`, each `fault(monkeypatch, root)` breaking the timed path
  underneath, and `check_config(config, root)`, which holds a
  configuration file against what the program builds from it;
- `configs/<config>.json` and its entry;
- `traffic/<traffic>.json`, with `driver`;
- `limits/<cell>.json`;
- `metrics/<metric>.py` for each per-layer metric;
- the plain reference under `reference/`, which imports nothing of the
  program.

With --trace 0 the line carries the cell's end-to-end metrics and
`setup_s`; with --trace 1 its per-layer metrics, the card's busy and
window seconds and the profiler's breakdown.  Every run compares what its
window produced with the plain float32 reference and prints each number
compared beside its limit, last on standard error and last in the line
(`checks`).  The run refuses to start without as many CUDA cards as the
cell asks for, and refuses to print a result if the JAX package or JAX was
loaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import core  # noqa: E402


@dataclasses.dataclass
class Context:
    cell: core.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    control: bool = False


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device: str,
             root: Path = core.ROOT, control: bool = False) -> dict:
    """Run one cell once on `device`; the result object (without printing)."""
    import torch

    core.keep_libraries_from_jax()
    cell = core.cell(bench, name, root)
    limits = core.load_json(root / "limits" / f"{name}.json")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv = core.driver(cell.traffic, root)
    out = drv.run(Context(cell, seed, seconds, trace, device, control))
    from portbench.drivers import common

    checks = common.judge(out["numbers"], limits)
    dev = core.device_info(device, cell.workload["chips"])
    dev["memory_peak_bytes"] = int(out["peak_bytes"])
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        for m in cell.end_to_end:
            v = out["setup_s"] if m["name"] == "setup_s" else out["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
    else:
        r = out["readings"]
        for m in cell.per_layer:
            v = core.reader(m["name"], root)(r)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
        prof = r.get("profile") or {}
        dev["busy_s"] = float(prof.get("busy_s", 0.0))
        dev["window_s"] = float(prof.get("window_s", 0.0))
    result = {"correct": all(c["ok"] for c in checks), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace and out["readings"].get("profile"):
        p = out["readings"]["profile"]
        result["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    if control:
        result["control_numbers"] = out["numbers"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = core.load_json(CHECKOUT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    core.cache_dirs(CHECKOUT)
    t0 = time.perf_counter()
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = core.forbidden_modules()
    if bad:
        print(f"refused: the JAX package or JAX was loaded: {bad}", file=sys.stderr)
        return 4
    print(f"run took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
