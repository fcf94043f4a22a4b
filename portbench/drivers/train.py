"""Training the voice-conversion LM: `ARVCTrainer.train_step` back to back
on padded batches of synthetic speech.

The batches have the lengths of the traffic file's law (the same for every
seed: the law's quantiles, sorted and cut into batches of `batch_size`
as a length-sorting loader makes them, in an interleaved order); the audio
comes from the seed.  Set-up builds the trainer and drives it through its
first `check_steps` steps on batches whose rows all differ; the window
then runs the same trainer on the following batches, cycling.

End-to-end: `train_frames_per_s`, the 46.44 ms frames of the window's
batches' sources over the window's seconds.

With `trace`: 40 % of the window unsynchronized (the step's least time
against the time taken), a profiled stretch of whole steps, then the rest
with the card synchronized around the features, the loss with its
gradients and the optimizer update.

`correct` follows the first `check_steps` steps with the plain float32
reference (`reference/train.py`) on the same weights and batches: each
step's loss, the first gradient as the optimizer got it (worked out from
its state after one step) and the parameters' change over the steps, both
by the worst leaf, and the frozen features (content tokens, codes, style,
timbre).  It also follows the window's last step on its longest batch
from the program's state before that step (the parameters, copied before
the step, and the optimizer's moments): that step's loss, gradient (worked
out from the moments before and after) and parameters' change, and the
batch's features.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import core, counts, voice
from portbench.drivers import common
from portbench.reference import nn as rnn, train as rtrain


def dataset_wave(seconds: float, seed: int, sample_rate: int = 44100) -> np.ndarray:
    """A copy of the port's `train/data.synthetic_dataset` waveform at commit
    b084fe3: a sine of a random f0 times clipped Gaussian noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    f0 = rng.uniform(80, 300)
    return (0.1 * np.sin(2 * np.pi * f0 * t) * rng.standard_normal(n).clip(-3, 3)).astype(
        np.float32)


def collate(waves: List[np.ndarray], spf: int = 2048) -> Dict:
    """A copy of `train/data.collate`: length-sorted, frame-aligned, padded."""
    waves = sorted(waves, key=len, reverse=True)
    lens = [len(w) // spf * spf for w in waves]
    out = np.zeros((len(waves), max(lens)), np.float32)
    for i, w in enumerate(waves):
        out[i, :lens[i]] = w[:lens[i]]
    return {"waves": out, "frame_lens": np.asarray(lens, np.int64) // spf}


def batches(tr: Dict, seed: int) -> List[Dict]:
    lens = sorted(voice.lengths(tr["lengths"]))
    B = tr["batch_size"]
    groups = [lens[i:i + B] for i in range(0, len(lens), B)]
    order = voice._interleaved(len(groups))
    out, k = [], 0
    for gi in order:
        ws = []
        for s in groups[gi]:
            ws.append(dataset_wave(s, voice.sub_seed(seed, 3, k)))
            k += 1
        out.append(collate(ws))
    return out


def run(ctx) -> Dict:
    from streamvoiceanon_tpu_torch.train import muon as muon_mod
    from streamvoiceanon_tpu_torch.train import step as step_mod
    from streamvoiceanon_tpu_torch.train.arvc_trainer import ARVCTrainer, TrainerConfig

    cellc, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    pcfg = cellc.config["pipeline"]
    t_setup = time.perf_counter()
    trees = common.draw_trees(cellc.config, ctx.seed, dev)
    tseed = voice.sub_seed(ctx.seed, 5) % (2 ** 31)
    tcfg = TrainerConfig(**cellc.config["trainer"], seed=tseed,
                         log_dir=str(core.ROOT / ".cache" / "train-runs"))
    trainer = ARVCTrainer(core.port_config(pcfg), tcfg, trees["arvc"], trees["tokenizer"],
                          trees["vocoder"], trees["campplus"], trees["speaker"], device=dev)
    data = batches(tr, ctx.seed)
    n_check = tr["check_steps"]
    flat0 = {k: v.detach().clone() for k, v in rtrain.flatten(trees["arvc"]).items()}
    aux_check, feats_check = [], []
    orig_features = trainer._features

    def keep_features(*a, **k):
        f = orig_features(*a, **k)
        feats_check.append({k2: v.detach().clone() for k2, v in f.items()})
        return f
    trainer._features = keep_features
    opt1 = None
    for s in range(n_check):
        aux_check.append(trainer.train_step(data[s]))
        if s == 0:
            st = trainer.state.opt_state[1]
            opt1 = ({k: v.detach().clone() for k, v in st["muon"]["momentum"].items()},
                    {k: v.detach().clone() for k, v in st["adamw"]["mu"].items()})
    trainer._features = orig_features
    prog_params = {k: v.detach().clone() for k, v in
                   rtrain.flatten(trainer.state.params).items()}
    for b in data[n_check:]:  # the window's batch shapes through the frozen extractors once
        orig_features(b["waves"], b["frame_lens"])
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup

    frames = []
    readings: Dict = {}
    # the window's checked step: its last step on the longest batch, with the
    # state before it (the parameters copied, the optimizer's state, which a
    # step replaces, kept), the parameters after it and its features
    n_win = len(data) - n_check
    longest = max(range(n_win), key=lambda i: data[n_check + i]["waves"].size)
    live = rtrain.flatten(trainer.state.params)
    before = {k: torch.empty_like(v) for k, v in live.items()}
    after = {k: torch.empty_like(v) for k, v in live.items()}
    held: Dict = {}

    def capture(fn):
        def f(*a, **k):
            out = fn(*a, **k)
            if held.get("open"):
                held["feats"] = {k2: v.detach().clone() for k2, v in out.items()}
            return out
        return f

    def step(j: int):
        i = j % n_win
        b = data[n_check + i]
        if i == longest:
            with torch.no_grad():
                torch._foreach_copy_(list(before.values()), list(live.values()))
            held.update(open=True, opt=trainer.state.opt_state)
        t0 = time.perf_counter()
        aux = trainer.train_step(b)
        frames.append((b["frame_lens"], time.perf_counter() - t0, n_check + j))
        if i == longest:
            with torch.no_grad():
                torch._foreach_copy_(list(after.values()), list(live.values()))
            held.update(open=False, step=n_check + j, batch=b, loss=aux["loss"],
                        opt_after=trainer.state.opt_state)

    capturing = contextlib.ExitStack()
    capturing.enter_context(core.wrapped(trainer, "_features", capture))
    j = 0
    t0 = time.perf_counter()
    if not ctx.trace:
        while time.perf_counter() - t0 < ctx.seconds:
            step(j)
            j += 1
        window_s = time.perf_counter() - t0
        e2e = {"train_frames_per_s": sum(int(f[0].sum()) for f in frames) / window_s}
    else:
        while time.perf_counter() - t0 < 0.4 * ctx.seconds:
            step(j)
            j += 1
        unsync = list(frames)
        box = {"j": j}

        def profiled():
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < tr["profile_s"]:
                step(box["j"])
                box["j"] += 1
        readings["profile"] = core.profile(profiled)
        j = box["j"]
        spans = core.Spans(dev)
        opt = trainer.optimizer
        timed_opt = muon_mod.GradientTransformation(
            opt.init, lambda *a, **k: spans.timed("optim", opt.update, *a, **k))
        wraps = [(trainer, "_features",
                  lambda fn: lambda *a, **k: spans.timed("features", fn, *a, **k)),
                 (step_mod, "loss_fn", lambda fn: lambda *a, **k: spans.timed("fwd_bwd", fn, *a, **k)),
                 (step_mod, "grads_of", lambda fn: lambda *a, **k: spans.timed("fwd_bwd", fn, *a, **k)),
                 (muon_mod, "apply_updates",
                  lambda fn: lambda *a, **k: spans.timed("optim", fn, *a, **k))]
        with contextlib.ExitStack() as stack:
            for mod, attr, w in wraps:
                stack.enter_context(core.wrapped(mod, attr, w))
            trainer.optimizer = timed_opt
            t2 = time.perf_counter()
            rest = max(ctx.seconds - (t2 - t0), 0.25 * ctx.seconds)
            n0 = len(frames)
            while time.perf_counter() - t2 < rest or len(frames) - n0 < 2:
                step(j)
                j += 1
            trainer.optimizer = opt
        window_s = time.perf_counter() - t0
        steps = len(frames) - n0
        readings.update(spans={k: _per_step(v, steps) for k, v in spans.ms.items()},
                        unsync=unsync)
        readings.update(least(cellc.config, tseed, unsync))
        e2e = {}
    attempted = len(frames)
    # the window's steps may end before the longest batch's first turn: then
    # steps on, unmeasured, until it has run once
    while "step" not in held:
        step(j)
        j += 1
    capturing.close()
    peak = common.peak_bytes(dev)
    win = {"step": held["step"], "batch": held["batch"], "loss": held["loss"],
           "feats": held["feats"], "before": before, "delta": {
               k: after[k] - before[k] for k in before},
           "opt": held["opt"][1], "opt_after": held["opt_after"][1]}
    del trainer, held, after, live
    common.free_cuda()

    common.no_tf32()
    cfg = rnn.ns(pcfg)
    rt = common.reference_trees(trees)
    del trees
    numbers = check(rt, cfg, cellc.config["trainer"], tseed, data[:n_check], flat0, aux_check,
                    feats_check, opt1, prog_params, win, dev, ctx.control)
    return {"attempted": attempted, "failed": 0, "e2e": e2e, "setup_s": setup_s,
            "readings": readings, "numbers": numbers, "peak_bytes": peak, "window_s": window_s}


def _per_step(ms: List[float], steps: int) -> List[float]:
    """Spans that a step calls twice (loss and gradients; update and apply)
    summed to one value a step."""
    if len(ms) == steps:
        return ms
    per = len(ms) // steps
    return [sum(ms[i * per:(i + 1) * per]) for i in range(steps)]


def step_count(config: Dict, frame_lens, delay: int) -> Dict[str, counts.Count]:
    """Operations of one step, each row of the batch at its own frames (the
    padding is not counted): the LM's forward and backward (3 x the
    forward, no recompute) at the step's delay and the features' forward
    (content encode and codec encode; the speaker encoders are not
    counted)."""
    p = config["pipeline"]
    d = p["arvc"]["decoder"]
    fast = counts.fast_loop(d, 4)[0]
    fwd = feats = 0.0
    for T in (int(t) for t in frame_lens):
        rows = 33 + 2 * (T + delay)
        fwd += (counts.slow_rows(d, 0, rows, 4, 4, head=False)[0]
                + T * (fast + 2 * d["dim"] * d["vocab_size"]))
        feats += (counts.tokenizer_encode(p["tokenizer"], T, 4)[0]
                  + counts.codec_encode(p["vocoder"], T, 4)[0])
    return {"lm": (3 * fwd, 0.0), "features": (feats, 0.0)}


def least(config: Dict, tseed: int, steps: List) -> Dict:
    """Least seconds of the steps' counted work at float32's peak, against their time."""
    ds = rtrain.delays(tseed, list(config["pipeline"]["arvc"]["decoder"]["delay"]),
                       max(s[2] for s in steps) + 1)
    tot = 0.0
    for frame_lens, _, k in steps:
        c = step_count(config, frame_lens, ds[k])
        tot += sum(counts.least_s(v, "float32") for v in c.values())
    return {"least_unsync_s": tot, "time_unsync_s": sum(s[1] for s in steps)}


def _leaf_gap(prog: Dict, ref: Dict, keep) -> float:
    """max over kept leaves of | |prog| - |ref| | / max(|ref|, the median leaf's |ref|)."""
    norms = {k: float(torch.linalg.norm(ref[k].double())) for k in keep}
    med = statistics.median(norms.values())
    return max(abs(float(torch.linalg.norm(prog[k].double().to(ref[k].device))) - norms[k])
               / max(norms[k], med) for k in keep)


def _loss_grads(params: Dict, d, fi: Dict, delay: int):
    """The reference's loss and gradients at `params` on a feature batch."""
    tree = rtrain.unflatten({k: v.requires_grad_(True) for k, v in params.items()})
    cb, tok = rtrain.losses(tree, d, fi, delay)
    loss = cb + tok
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: (torch.zeros_like(p) if g is None else g)
             for (k, p), g in zip(params.items(), grads)}
    for v in params.values():
        v.requires_grad_(False)
    return float(loss.detach()), grads


def _clipped(grads: Dict, clip: float) -> Dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = 1.0 if bool(norm < clip) else float(clip / norm)
    return {k: g * scale for k, g in grads.items()}


def _fed(fp: Dict, fl) -> Dict:
    """A step's input: the program's features, which are judged on their own."""
    return {"content": fp["content"], "target": fp["target"], "x_lens": fl,
            "style": fp["style"].float(), "timbre": fp["timbre"].float()}


def follow(rt: Dict, cfg, tcfg: Dict, tseed: int, data: List[Dict], flat0: Dict,
           feats_prog: List[Dict], dev) -> Dict:
    """The reference's first steps from the same weights on the same
    batches: losses, the first gradient as the optimizer gets it (clipped),
    the parameters after the steps, and the frozen features."""
    d = cfg.arvc.decoder
    ds = rtrain.delays(tseed, list(d.delay), len(data))
    params = {k: v.detach().clone().to(dev).float() for k, v in flat0.items()}
    opt = rtrain.Optimizer(params, tcfg)
    losses, feats, g1 = [], [], None
    for s, (b, delay) in enumerate(zip(data, ds)):
        fl = torch.from_numpy(b["frame_lens"]).to(dev)
        with torch.no_grad():
            feats.append(rtrain.features(rt, cfg, torch.from_numpy(b["waves"]).to(dev), fl))
        loss, grads = _loss_grads(params, d, _fed(feats_prog[s], fl), delay)
        losses.append(loss)
        if s == 0:
            g1 = _clipped(grads, tcfg["clip"])
        opt.step(params, grads)
    return {"losses": losses, "g1": g1, "params": params, "feats": feats}


def follow_window(rt: Dict, cfg, tcfg: Dict, tseed: int, win: Dict, dev) -> Dict:
    """The reference's step from the program's state before the window's
    checked step (its parameters and optimizer moments; the step count
    and the delay the reference works out), on the same batch, fed the
    program's features of it: the loss, the gradient as the optimizer gets
    it, the parameters' change, and the reference's features."""
    d = cfg.arvc.decoder
    s, b = win["step"], win["batch"]
    delay = rtrain.delays(tseed, list(d.delay), s + 1)[-1]
    params = {k: v.detach().clone().float() for k, v in win["before"].items()}
    opt = rtrain.Optimizer.resume(params, tcfg, s, win["opt"])
    fl = torch.from_numpy(b["frame_lens"]).to(dev)
    with torch.no_grad():
        feats = rtrain.features(rt, cfg, torch.from_numpy(b["waves"]).to(dev), fl)
    loss, grads = _loss_grads(params, d, _fed(win["feats"], fl), delay)
    g = _clipped(grads, tcfg["clip"])
    opt.step(params, grads)
    return {"loss": loss, "g": g, "delta": {k: params[k] - win["before"][k] for k in params},
            "feats": feats}


def _features_gaps(got: List[Dict], ref: List[Dict]) -> Dict:
    return {"tokens_mismatch": max(common.mismatch(a["content"], b["content"])
                                   for a, b in zip(got, ref)),
            "codes_mismatch": max(common.mismatch(a["target"], b["target"])
                                  for a, b in zip(got, ref)),
            "embedding_rel_err": max(max(common.rel_rms(a["style"], b["style"]),
                                         common.rel_rms(a["timbre"], b["timbre"]))
                                     for a, b in zip(got, ref))}


def _kept(grads: Dict) -> List:
    """Leaves whose reference gradient is at least a thousandth of the median leaf's."""
    gnorm = {k: float(torch.linalg.norm(g.double())) for k, g in grads.items()}
    med = statistics.median(gnorm.values())
    return [k for k, v in gnorm.items() if v >= 1e-3 * med]


def compare(got: Dict, ref: Dict, flat0: Dict, dev) -> Dict:
    """The numbers of the set-up's steps of one side (program or control)
    against the reference."""
    keep = _kept(ref["g1"])
    dgot = {k: got["params"][k].to(dev) - flat0[k].to(dev) for k in keep}
    dref = {k: ref["params"][k] - flat0[k].to(dev) for k in keep}
    out = {"loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
           "grad1_leaf_gap": _leaf_gap(got["g1"], ref["g1"], keep),
           "update_leaf_gap": _leaf_gap(dgot, dref, keep)}
    out.update(_features_gaps(got["feats"], ref["feats"]))
    return out, len(ref["g1"]) - len(keep)


def compare_window(got: Dict, ref: Dict) -> Dict:
    """The numbers of the window's checked step of one side against the reference."""
    keep = _kept(ref["g"])
    return {"window_loss_rel_err": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "window_grad_leaf_gap": _leaf_gap(got["g"], ref["g"], keep),
            "window_update_leaf_gap": _leaf_gap(got["delta"], ref["delta"], keep)}


def window_grads(win: Dict) -> Dict:
    """The window step's gradient as the program's optimizer got it, worked
    out from its moments before and after the step (Muon's momentum
    m' = 0.95 m + 0.05 g, AdamW's first moment m' = 0.9 m + 0.1 g)."""
    a, b = win["opt"], win["opt_after"]
    out = {}
    for k, m1 in b["muon"]["momentum"].items():
        out[k] = (m1.double() - 0.95 * a["muon"]["momentum"][k].double()) / 0.05
    for k, m1 in b["adamw"]["mu"].items():
        out[k] = (m1.double() - 0.9 * a["adamw"]["mu"][k].double()) / 0.1
    return out


def check(rt: Dict, cfg, tcfg: Dict, tseed: int, data: List[Dict], flat0: Dict, aux: List,
          feats_prog: List[Dict], opt1, prog_params: Dict, win: Dict, dev,
          control: bool) -> Dict:
    ref = follow(rt, cfg, tcfg, tseed, data, flat0, feats_prog, dev)
    ref_w = follow_window(rt, cfg, tcfg, tseed, win, dev)
    mom, mu = opt1
    prog = {"losses": [a["loss"] for a in aux], "params": prog_params, "feats": feats_prog,
            "g1": {k: (mom[k] / 0.05) if k in mom else (mu[k] / 0.1) for k in ref["g1"]}}
    out, left_out = compare(prog, ref, flat0, dev)
    prog_w = {"loss": win["loss"], "g": window_grads(win), "delta": win["delta"]}
    out.update(compare_window(prog_w, ref_w))
    for k, v in _features_gaps([win["feats"]], [ref_w["feats"]]).items():
        out[k] = max(out[k], v)
    out["leaves_left_out"] = float(left_out)
    if control:  # the reference with TF32 matrix products and convolutions in its place
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            ctl = follow(rt, cfg, tcfg, tseed, data, flat0, feats_prog, dev)
            ctl_w = follow_window(rt, cfg, tcfg, tseed, win, dev)
        finally:
            common.no_tf32()
        nums = compare(ctl, ref, flat0, dev)[0]
        nums.update(compare_window(ctl_w, ref_w))
        for k, v in _features_gaps([ctl_w["feats"]], [ref_w["feats"]]).items():
            nums[k] = max(nums[k], v)
        out.update({"control_" + k: v for k, v in nums.items()})
    return out
