"""Training the content encoder: `ASRTrainer.train_step` back to back on
batches in `train.data.batches`' form (44.1 kHz `waves`, `wave_lens`,
`frame_lens`, Whisper `text`, `text_lens`), the trainer computing the
frozen w2v-BERT teacher's features (float16, truncated at the
configuration's `teacher_layers`) and the CAM++ style itself, as the
upstream's `trainers/asr_trainer.py` step does.

The batches have the lengths of the traffic file's law (its quantiles,
sorted and cut into batches of `batch_size` as a length-sorting loader
makes them, in an interleaved order); the audio (`train.dataset_wave`)
and the text's ids (`text_tokens_per_s` a second of audio, at least
`min_text_tokens`, drawn among the 50,257 ordinary Whisper ids) come from
the seed.  Set-up draws the weights on the card, stages the batches' audio
and text there (as a loader that pins and prefetches has them ready; the
lengths stay host integers), builds the trainer and drives it through its
first `check_steps` steps; the window then runs the same trainer on the
following batches, cycling, each batch's frozen features run once in
set-up.

End-to-end: `train_frames_per_s`, the 46.44 ms frames of the window's
batches' sources over the window's seconds.

With `trace`: 40 % of the window unsynchronized (the step's least time
against the time taken), a profiled stretch of whole steps, then the rest
with the port's recorder on (`utils/profiling.tracing`): its export,
`readings["program"]`, holds each step's spans (`train_step`, `features`,
`teacher`, `style`, `fwd_bwd`, `optim`, `sync`) with their device ms, and
the teacher's counter of rows and frames.

`correct` judges each stage on its own against the plain float32
reference (`reference/content.py`, `reference/conformer.py`) on the same
weights and batches: the teacher's features over each row's valid frames
(`teacher_rel_err`) and the style (`style_rel_err`) of the checked steps'
batches and the window's checked batch; the program's content tokens
against the reference's (`tokens_mismatch`); then the reference's steps
fed the program's teacher features, style and tokens: each of the
`check_steps` steps' L1 and s2s terms, the first gradient as AdamW got it
(its first moment after one step over 0.1) and the parameters' change over
the steps, both by the worst leaf; and the window's last step on its
longest batch from the program's state before it (parameters and AdamW's
moments), as in the `train` kind.  With `ctx.control` the reference one
precision down stands in the program's place: the teacher in bfloat16 and
the student and CAM++ under TF32.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import core, counts_content, voice, weights, weights_content
from portbench.drivers import common
from portbench.drivers import train as train_drv
from portbench.reference import content as rc
from portbench.reference import nn as rnn

ORDINARY_IDS = 50257  # Whisper's ids below its special tokens


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batches(tr: Dict, seed: int) -> List[Dict]:
    lens = sorted(voice.lengths(tr["lengths"]))
    B = tr["batch_size"]
    groups = [lens[i:i + B] for i in range(0, len(lens), B)]
    out, k = [], 0
    for gi in voice._interleaved(len(groups)):
        rows = []
        for s in groups[gi]:
            wav = train_drv.dataset_wave(s, voice.sub_seed(seed, 3, k))
            n = max(tr["min_text_tokens"], int(round(tr["text_tokens_per_s"] * s)))
            ids = np.random.default_rng(voice.sub_seed(seed, 7, k)).integers(0, ORDINARY_IDS, n)
            rows.append((wav, ids))
            k += 1
        out.append(collate(rows))
    return out


def collate(rows) -> Dict:
    """As `train/data.collate`: length-sorted, frame-aligned, padded; the
    text padded with Whisper's end of text."""
    rows = sorted(rows, key=lambda r: len(r[0]), reverse=True)
    lens = [len(w) // 2048 * 2048 for w, _ in rows]
    waves = np.zeros((len(rows), max(lens)), np.float32)
    for i, (w, _) in enumerate(rows):
        waves[i, :lens[i]] = w[:lens[i]]
    tl = [len(t) for _, t in rows]
    text = np.full((len(rows), max(tl)), ORDINARY_IDS, np.int64)
    for i, (_, t) in enumerate(rows):
        text[i, :tl[i]] = t
    return {"waves": waves, "wave_lens": np.asarray(lens, np.int64),
            "frame_lens": np.asarray(lens, np.int64) // 2048, "text": text,
            "text_lens": np.asarray(tl, np.int64)}


def staged(b: Dict, device) -> Dict:
    """A batch as the program is given it: audio and text on the device."""
    return dict(b, waves=torch.from_numpy(b["waves"]).to(device),
                text=torch.from_numpy(b["text"]).to(device))


def namespace(config: Dict):
    """The configuration's groups as attribute namespaces, for the reference."""
    return rnn.ns({k: config[k] for k in ("sample_rate", "resample_rate", "tokenizer",
                                          "campplus", "asr_decoder", "teacher")})


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def trainer(config: Dict, trees: Dict, device):
    """The port's trainer over the benchmark's trees (its public constructors)."""
    from streamvoiceanon_tpu_torch.models.asr_decoder import ASRDecoderConfig
    from streamvoiceanon_tpu_torch.models.w2v_bert import W2vBertTeacher
    from streamvoiceanon_tpu_torch.models.w2v_bert_native import W2VBertConfig
    from streamvoiceanon_tpu_torch.train.asr_trainer import ASRTrainer, ASRTrainerConfig

    pcfg = core.port_config({k: config[k] for k in ("sample_rate", "resample_rate",
                                                    "tokenizer", "campplus")})
    teacher = W2vBertTeacher(layer=config["teacher_layers"], native_params=trees["teacher"],
                             native_cfg=W2VBertConfig(**config["teacher"]), device=device,
                             dtype=core.DTYPES[config["dtypes"]["teacher"]])
    return ASRTrainer(pcfg, ASRDecoderConfig(**config["asr_decoder"]),
                      ASRTrainerConfig(**config["trainer"]), trees["tokenizer"], trees["asr"],
                      device=device, teacher=teacher, campplus_params=trees["campplus"])


class Capture:
    """While `on`, the frozen features and the content tokens of the
    program's step (the outputs of `frozen_features` and of
    `tokenizer.quantized_latents`), copied."""

    def __init__(self, tr):
        from streamvoiceanon_tpu_torch.models import tokenizer

        self.on, self.got = False, {}
        self.stack = contextlib.ExitStack()
        self.stack.enter_context(core.wrapped(tr, "frozen_features", self._keep))
        self.stack.enter_context(core.wrapped(tokenizer, "quantized_latents", self._keep_idx))

    def _keep(self, fn):
        def f(*a, **k):
            out = fn(*a, **k)
            if self.on:
                self.got.update({n: v.detach().clone() for n, v in out.items()})
            return out
        return f

    def _keep_idx(self, fn):
        def f(*a, **k):
            zq, idx = fn(*a, **k)
            if self.on:
                self.got["idx"] = idx.detach().clone()
            return zq, idx
        return f

    def take(self) -> Dict:
        got, self.got = self.got, {}
        return got


def run(ctx) -> Dict:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    t_setup = time.perf_counter()
    trees = weights_content.draw(cfg, ctx.seed, dev)
    prog = trainer(cfg, trees, dev)
    data = batches(tr, ctx.seed)
    feed = [staged(b, dev) for b in data]
    n_check = tr["check_steps"]
    cap = Capture(prog)
    checked, aux_check, mu1 = [], [], None
    for s in range(n_check):
        cap.on = True
        aux_check.append(prog.train_step(feed[s]))
        cap.on = False
        checked.append(cap.take())
        if s == 0:
            mu1 = {k: v.detach().clone() for k, v in prog.opt_state[1]["mu"].items()}
    prog_params = {k: v.detach().clone() for k, v in rc.flatten(prog.params).items()}
    for b in feed[n_check:]:  # the window's batch shapes through the frozen models once
        prog.frozen_features(b["waves"], b["wave_lens"])
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup

    frames: List = []
    readings: Dict = {}
    n_win = len(data) - n_check
    longest = max(range(n_win), key=lambda i: data[n_check + i]["waves"].size)
    live = rc.flatten(prog.params)
    before = {k: torch.empty_like(v) for k, v in live.items()}
    after = {k: torch.empty_like(v) for k, v in live.items()}
    held: Dict = {}

    def step(j: int):
        i = j % n_win
        b = data[n_check + i]
        if i == longest:
            with torch.no_grad():
                torch._foreach_copy_(list(before.values()), list(live.values()))
            held["opt"] = prog.opt_state
            cap.on = True
        t0 = time.perf_counter()
        aux = prog.train_step(feed[n_check + i])
        frames.append((b, time.perf_counter() - t0))
        if i == longest:
            cap.on = False
            with torch.no_grad():
                torch._foreach_copy_(list(after.values()), list(live.values()))
            held.update(step=n_check + j, batch=b, aux=aux, fed=cap.take(),
                        opt_after=prog.opt_state)

    j = 0
    t0 = time.perf_counter()
    if not ctx.trace:
        while time.perf_counter() - t0 < ctx.seconds:
            step(j)
            j += 1
        window_s = time.perf_counter() - t0
        e2e = {"train_frames_per_s": sum(int(b["frame_lens"].sum()) for b, _ in frames)
               / window_s}
    else:
        from streamvoiceanon_tpu_torch.utils import profiling

        while time.perf_counter() - t0 < 0.4 * ctx.seconds:
            step(j)
            j += 1
        readings.update(least(cfg, frames))
        box = {"j": j}

        def profiled():
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < tr["profile_s"]:
                step(box["j"])
                box["j"] += 1
        readings["profile"] = core.profile(profiled)
        j = box["j"]
        t2 = time.perf_counter()
        rest = max(ctx.seconds - (t2 - t0), 0.25 * ctx.seconds)
        n0 = len(frames)
        with profiling.tracing() as rec:
            while time.perf_counter() - t2 < rest or len(frames) - n0 < 2:
                step(j)
                j += 1
        readings["program"] = rec.export()
        readings["teacher_least_s"] = teacher_least_s(cfg, readings["program"])
        window_s = time.perf_counter() - t0
        e2e = {}
    attempted = len(frames)
    # the window may end before the longest batch's first turn: then steps
    # on, unmeasured, until it has run once
    while "step" not in held:
        step(j)
        j += 1
    cap.stack.close()
    peak = common.peak_bytes(dev)
    win = {"step": held["step"], "batch": held["batch"], "aux": held["aux"], "fed": held["fed"],
           "before": before, "delta": {k: after[k] - before[k] for k in before},
           "opt": held["opt"][1], "opt_after": held["opt_after"][1]}
    del prog, held, after, live
    common.free_cuda()

    common.no_tf32()
    numbers = check(cfg, trees, data[:n_check], checked, aux_check, mu1, prog_params, win, dev,
                    ctx.control)
    return {"attempted": attempted, "failed": 0, "e2e": e2e, "setup_s": setup_s,
            "readings": readings, "numbers": numbers, "peak_bytes": peak, "window_s": window_s}


def _teacher_frames(cfg: Dict, b: Dict) -> List[int]:
    return list(rc.teacher_lens(b["wave_lens"], cfg["sample_rate"], cfg["resample_rate"]))


def least(cfg: Dict, steps: List) -> Dict:
    """Least seconds of the unsynchronized steps' counted work, against their time."""
    tot = sum(counts_content.least_s(
        counts_content.step(cfg, list(b["frame_lens"]), list(b["text_lens"]),
                            _teacher_frames(cfg, b)), cfg["dtypes"]["teacher"])
        for b, _ in steps)
    return {"least_unsync_s": tot, "time_unsync_s": sum(t for _, t in steps)}


def teacher_least_s(cfg: Dict, export: Dict):
    """The least seconds of the teacher's counted operations over the traced
    stretch: its rows at their mean valid frames (the counter's; a lower
    bound of the rows' attention, which grows with the square of a row's
    frames), at the configured dtype's peak."""
    c = export.get("teacher") or {}
    rows, valid = c.get("rows", 0), c.get("valid_frames", 0)
    if not rows:
        return None
    ops = rows * counts_content.conformer(cfg["teacher"], cfg["teacher_layers"],
                                          valid / rows, 2)[0]
    return ops / core.PEAK_FLOPS[cfg["dtypes"]["teacher"]]


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def _masked_rel(got, ref, lens) -> float:
    """||got - ref|| / ||ref|| over each row's first `lens` frames (common frames only)."""
    T = min(got.shape[1], ref.shape[1])
    got, ref = got[:, :T].to(ref.device).double(), ref[:, :T].double()
    valid = (torch.arange(T, device=ref.device)[None, :]
             < torch.as_tensor(lens, device=ref.device)[:, None])[..., None]
    return float(torch.linalg.norm((got - ref) * valid)
                 / torch.linalg.norm(ref * valid).clamp(min=1e-300))


def _fed(cfg: Dict, b: Dict, fed: Dict, idx, dev) -> Dict:
    """A step's input for the reference: the batch, and the program's teacher
    features, style and tokens (each judged on its own)."""
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return {"idx": idx, "teacher_feats": fed["teacher_feats"].float(),
            "teacher_lens": t(_teacher_frames(cfg, b)), "style": fed["style"][:, 0].float(),
            "frame_lens": t(b["frame_lens"]), "text": t(b["text"]),
            "text_lens": t(b["text_lens"])}


def _stage(cfg: Dict, rtrees: Dict, c, b: Dict, fed: Dict, dev) -> Dict:
    """The reference's frozen features of a batch, and its numbers for the
    program's (`fed`)."""
    with torch.no_grad():
        ref = rc.frozen(rtrees, c, torch.from_numpy(b["waves"]).to(dev), cfg["teacher_layers"])
    return {"ref": ref,
            "teacher_rel_err": _masked_rel(fed["teacher_feats"], ref["teacher_feats"],
                                           _teacher_frames(cfg, b)),
            "style_rel_err": common.rel_rms(fed["style"][:, 0], ref["style"])}


def _step(params: Dict, c, tcfg: Dict, cfg: Dict, b: Dict, fed: Dict, dev):
    """One reference step's input side and terms at `params`: its own content
    tokens of the batch from the tokenizer as it stands at that step (AdamW's
    decay moves even the leaves no loss reaches), then (L1, s2s) and the
    gradients fed the program's frozen features and tokens (the reference's
    where the program's do not cover the batch: such a program fails
    `tokens_mismatch` by itself)."""
    with torch.no_grad():
        tok = rc.tokens({"tokenizer": rc.unflatten(params)["tokenizer"]}, c,
                        torch.from_numpy(b["waves"]).to(dev))
    idx = fed["idx"] if fed["idx"].shape == tok.shape else tok
    t, grads = rc.loss_grads(params, c, tcfg, _fed(cfg, b, fed, idx, dev))
    return tok, t, grads


def follow(cfg: Dict, c, flat0: Dict, data: List[Dict], checked: List[Dict], dev) -> Dict:
    """The reference's first steps from the same weights on the same batches,
    fed the program's frozen features and tokens: each step's own tokens and
    (L1, s2s), the first gradient as AdamW gets it (clipped), the parameters
    after."""
    tcfg = cfg["trainer"]
    params = {k: v.detach().clone().to(dev).float() for k, v in flat0.items()}
    opt = rc.AdamW(params, tcfg)
    toks, terms, g1 = [], [], None
    for s, (b, fed) in enumerate(zip(data, checked)):
        tok, t, grads = _step(params, c, tcfg, cfg, b, fed, dev)
        toks.append(tok)
        terms.append(t)
        if s == 0:
            g1 = rc.clipped(grads, tcfg["clip"])
        opt.step(params, grads)
    return {"toks": toks, "terms": terms, "g1": g1, "params": params}


def follow_window(cfg: Dict, c, win: Dict, dev) -> Dict:
    """The reference's step from the program's state before the window's
    checked step (its parameters and AdamW's moments and count), on the
    same batch, fed the program's frozen features and tokens."""
    tcfg = cfg["trainer"]
    params = {k: v.detach().clone().float() for k, v in win["before"].items()}
    a = win["opt"]
    opt = rc.AdamW(params, tcfg, a["count"], a["mu"], a["nu"])
    tok, t, grads = _step(params, c, tcfg, cfg, win["batch"], win["fed"], dev)
    g = rc.clipped(grads, tcfg["clip"])
    opt.step(params, grads)
    return {"tok": tok, "terms": t, "g": g,
            "delta": {k: params[k] - win["before"][k] for k in params}}


def _tokens_mismatch(fed: List[Dict], ref: Dict, ref_w: Dict) -> float:
    return max(common.mismatch(f["idx"], t) for f, t in zip(fed, ref["toks"] + [ref_w["tok"]]))


def _terms_err(got, ref) -> Dict:
    return {"l1_rel_err": max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref)),
            "s2s_rel_err": max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref))}


def _kept(grads: Dict) -> List:
    """Leaves whose reference gradient is at least a thousandth of the
    median nonzero leaf's (the quantizer's input side, which no loss
    reaches, has exact zeros and is left out)."""
    gnorm = {k: float(torch.linalg.norm(g.double())) for k, g in grads.items()}
    med = statistics.median(v for v in gnorm.values() if v > 0)
    return [k for k, v in gnorm.items() if v >= 1e-3 * med]


def compare(got: Dict, ref: Dict, flat0: Dict, dev) -> Dict:
    keep = _kept(ref["g1"])
    dgot = {k: got["params"][k].to(dev) - flat0[k].to(dev) for k in keep}
    dref = {k: ref["params"][k] - flat0[k].to(dev) for k in keep}
    out = _terms_err(got["terms"], ref["terms"])
    out.update(grad1_leaf_gap=train_drv._leaf_gap(got["g1"], ref["g1"], keep),
               update_leaf_gap=train_drv._leaf_gap(dgot, dref, keep))
    return out


def compare_window(got: Dict, ref: Dict) -> Dict:
    keep = _kept(ref["g"])
    out = {"window_" + k: v for k, v in _terms_err([got["terms"]], [ref["terms"]]).items()}
    out.update(window_grad_leaf_gap=train_drv._leaf_gap(got["g"], ref["g"], keep),
               window_update_leaf_gap=train_drv._leaf_gap(got["delta"], ref["delta"], keep))
    return out


def window_grads(win: Dict) -> Dict:
    """The window step's gradient as AdamW got it, from its first moment
    before and after the step (m' = 0.9 m + 0.1 g)."""
    a, b = win["opt"]["mu"], win["opt_after"]["mu"]
    return {k: (b[k].double() - 0.9 * a[k].double()) / 0.1 for k in b}


def _worst(stages: List[Dict]) -> Dict:
    return {k: max(s[k] for s in stages) for k in ("teacher_rel_err", "style_rel_err")}


def check(cfg: Dict, trees: Dict, data: List[Dict], checked: List[Dict], aux: List[Dict],
          mu1: Dict, prog_params: Dict, win: Dict, dev, control: bool) -> Dict:
    c = namespace(cfg)
    rtrees = common.reference_trees(trees)
    flat0 = rc.flatten({"tokenizer": rtrees["tokenizer"], "asr": rtrees["asr"]})
    fed_all = list(zip(data, checked)) + [(win["batch"], win["fed"])]
    st = [_stage(cfg, rtrees, c, b, fed, dev) for b, fed in fed_all]
    ref = follow(cfg, c, flat0, data, checked, dev)
    ref_w = follow_window(cfg, c, win, dev)
    prog = {"terms": [(a["l1_loss"], a["s2s_loss"]) for a in aux], "params": prog_params,
            "g1": {k: mu1[k] / 0.1 for k in ref["g1"]}}
    out = _worst(st)
    out["tokens_mismatch"] = _tokens_mismatch([f for _, f in fed_all], ref, ref_w)
    out.update(compare(prog, ref, flat0, dev))
    prog_w = {"terms": (win["aux"]["l1_loss"], win["aux"]["s2s_loss"]), "g": window_grads(win),
              "delta": win["delta"]}
    out.update(compare_window(prog_w, ref_w))
    out["leaves_left_out"] = float(len(ref["g1"]) - len(_kept(ref["g1"])))
    if control:
        out.update({"control_" + k: v for k, v in
                    controls(cfg, rtrees, c, flat0, data, checked, win, st, ref, ref_w,
                             dev).items()})
    return out


def controls(cfg, rtrees, c, flat0, data, checked, win, st, ref, ref_w, dev) -> Dict:
    """The reference one precision down in the program's place: the teacher
    in bfloat16 (weights and compute), the student and CAM++ under TF32;
    each against the float32 reference."""
    bf = weights.cast(rtrees["teacher"], torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        batches = data + [win["batch"]]
        with torch.no_grad():
            low = [rc.frozen(rtrees, c, torch.from_numpy(b["waves"]).to(dev),
                             cfg["teacher_layers"], bf) for b in batches]
        nums = {"teacher_rel_err": max(
                    _masked_rel(lo["teacher_feats"], s["ref"]["teacher_feats"],
                                _teacher_frames(cfg, b)) for lo, s, b in zip(low, st, batches)),
                "style_rel_err": max(common.rel_rms(lo["style"], s["ref"]["style"])
                                     for lo, s in zip(low, st))}
        # the student fed what the float32 reference was fed; its tokens its own
        ctl = follow(cfg, c, flat0, data, checked, dev)
        ctl_w = follow_window(cfg, c, win, dev)
    finally:
        common.no_tf32()
    nums["tokens_mismatch"] = max(common.mismatch(a, b) for a, b in
                                  zip(ctl["toks"] + [ctl_w["tok"]], ref["toks"] + [ref_w["tok"]]))
    nums.update(compare({"terms": ctl["terms"], "params": ctl["params"], "g1": ctl["g1"]}, ref,
                        flat0, dev))
    nums.update(compare_window(ctl_w, ref_w))
    return nums
