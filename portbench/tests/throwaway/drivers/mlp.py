"""A throwaway kind of cell for the harness's own tests: a two-layer
perceptron's forward in plain PyTorch, in the configuration's dtype, over
batches of rows drawn from the seed.

End-to-end: `rows_per_s`, the rows of the window's forwards over the
window's seconds.  With `trace`: a profiled stretch of forwards, then the
rest of the window, a quarter of it at least, with each forward timed
(`forward` span).

`correct` holds the last output of every batch against the same forward
in float64 on the same weights and rows (`rel_err`, the worst batch).
With `ctx.control` the reference with its weights rounded through float8
e4m3 stands in the program's place (`control_rel_err`)."""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench import core
from portbench.drivers import common


def weights(cfg: Dict, seed: int, device) -> List[torch.Tensor]:
    """The layers' float32 weights, from one draw of a seeded generator on the device."""
    dims = cfg["dims"]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(a * b for a, b in zip(dims, dims[1:])), generator=g, device=device)
    ws, at = [], 0
    for a, b in zip(dims, dims[1:]):
        ws.append(flat[at:at + a * b].view(a, b) / a ** 0.5)
        at += a * b
    return ws


def forward(ws: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The program: the timed path."""
    for i, w in enumerate(ws):
        x = x @ w
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def reference(ws: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The plain reference, apart from the program so that a fault planted
    in the program leaves it as it is."""
    for w in ws[:-1]:
        x = torch.clamp(x @ w, min=0)
    return x @ ws[-1]


def run(ctx) -> Dict:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    t_setup = time.perf_counter()
    ws = [w.to(core.DTYPES[cfg["dtype"]]) for w in weights(cfg, ctx.seed, dev)]
    g = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    xs = torch.randn(tr["batches"], tr["batch"], cfg["dims"][0], generator=g,
                     device=dev).to(ws[0].dtype)
    forward(ws, xs[0])
    setup_s = time.perf_counter() - t_setup

    outs: Dict[int, torch.Tensor] = {}
    readings: Dict = {}
    calls = {"n": 0}

    def step(fwd=forward):
        i = calls["n"] % len(xs)
        outs[i] = fwd(ws, xs[i])
        calls["n"] += 1

    t0 = time.perf_counter()
    if not ctx.trace:
        while time.perf_counter() - t0 < ctx.seconds or len(outs) < len(xs):
            step()
    else:
        def profiled():
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < tr["profile_s"]:
                step()
        readings["profile"] = core.profile(profiled)
        spans = core.Spans(dev)
        t2 = time.perf_counter()
        rest = max(ctx.seconds - (t2 - t0), 0.25 * ctx.seconds)
        while time.perf_counter() - t2 < rest or len(outs) < len(xs):
            step(lambda *a: spans.timed("forward", forward, *a))
        readings["spans"] = spans.ms
    window_s = time.perf_counter() - t0
    e2e = {} if ctx.trace else {"rows_per_s": calls["n"] * tr["batch"] / window_s}
    peak = common.peak_bytes(dev)

    w64 = [w.double() for w in ws]
    refs = [reference(w64, x.double()) for x in xs]
    numbers = {"rel_err": max(common.rel_rms(outs[i], r) for i, r in enumerate(refs))}
    if ctx.control:
        wc = common.fp8_round([w.float() for w in ws])
        numbers["control_rel_err"] = max(common.rel_rms(reference(wc, x.float()), r)
                                         for x, r in zip(xs, refs))
    return {"attempted": calls["n"], "failed": 0, "e2e": e2e, "setup_s": setup_s,
            "readings": readings, "numbers": numbers, "peak_bytes": peak, "window_s": window_s}
