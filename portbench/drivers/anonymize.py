"""Dataset anonymization as `cli anonymize` runs it: `evals/anonymize.
anonymize_dataset` over utterances, each through `VoiceConverter.infer`
(prompt side of the speaker's target reference, content tokens of the
source, `arvc.generate`, the codec's decode), closed loop.

The utterances have the lengths of the traffic file's law (the same list
for every seed, in an order that spreads any prefix over the law), their
audio is seeded synthetic voice, and they are grouped by speaker,
`utts_per_speaker` to a speaker.  Each speaker is anonymized with its own
seed (`voice.sub_seed`), so its target reference, drawn from a pool of
`ref_pool` synthetic references, and its noise are its own.  The call
converts one utterance at a time, so the window ends on a finished one.

End-to-end: `audio_s_per_s`, the seconds of source audio converted over
the window's seconds.

With `trace`: 40 % of the window unsynchronized (the whole-call least time
against the time taken), a profiled stretch of at least `profile_s`
(whole utterances), then the rest with the card synchronized around the
prompt side, the source's content tokens, `generate` and the decode.

`correct` compares, once the window has closed, a sample of the finished
utterances drawn from the seed, the longest among them, with the plain
float32 reference: the style and timbre of the target reference in the
LM's type, as `infer` hands them to the LM; the content tokens of the
target reference and of the source; every served code against the
reference LM's race over the program's prompt and the served codes; and
the output audio against the reference codec's decode of the served codes.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import core, counts, voice
from portbench.drivers import common
from portbench.reference import codec, lm, nn as rnn, speaker


def utterances(tr: Dict):
    """(lengths in s, speaker of each) of a cycle of utterances, the same for every seed."""
    lens = voice.lengths(tr["lengths"])
    return lens, [i // tr["utts_per_speaker"] for i in range(len(lens))]


def run(ctx) -> Dict:
    from streamvoiceanon_tpu_torch.evals.anonymize import Utterance, anonymize_dataset
    from streamvoiceanon_tpu_torch.models import arvc, vocoder
    from streamvoiceanon_tpu_torch.runtime import pipeline

    cellc, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    pcfg = cellc.config["pipeline"]
    sr = pcfg["sample_rate"]
    t_setup = time.perf_counter()
    trees = common.draw_trees(cellc.config, ctx.seed, dev)
    cv = common.converter(cellc.config, trees, dev)
    vc = pipeline.VoiceConverter(cv)
    pool = [voice.voice(tr["ref_seconds"], ctx.seed, 10 ** 5 + k) for k in range(tr["ref_pool"])]
    lens, spk_of = utterances(tr)
    wavs = [voice.voice(s, ctx.seed, 1 + j) for j, s in enumerate(lens)]
    rec: List[Dict] = []

    def recording(fn):
        def gen(*a, **k):
            codes = fn(*a, **k)
            rec.append({"ref_tokens": a[2], "ref_codes": a[3], "src_tokens": a[4],
                        "style": a[5], "timbre": a[6], "codes": codes})
            return codes
        return gen

    done: List[Dict] = []

    def convert(j: int):
        k = j % len(lens)
        spk = spk_of[k] + len(lens) * (j // len(lens))
        sseed = voice.sub_seed(ctx.seed, 7, spk)
        t0 = time.perf_counter()
        out = anonymize_dataset(vc, [Utterance(f"u{j}", f"s{spk}", wavs[k])], pool,
                                alpha=tr["alpha"], delay=tr["delay"], seed=sseed)
        done.append({"j": j, "k": k, "sseed": sseed, "wav": out[0].wav, "s": len(wavs[k]) / sr,
                     "ms": (time.perf_counter() - t0) * 1e3})

    with core.wrapped(arvc, "generate", recording):
        for s in tr["warmup_seconds"]:
            anonymize_dataset(vc, [Utterance("w", "w", voice.voice(s, ctx.seed, 10 ** 6))], pool,
                              alpha=tr["alpha"], delay=tr["delay"], seed=ctx.seed)
        # every source length of the traffic once through the content encoder
        # and the decode, so that no convolution meets a new shape in the window
        f32 = cv.float32_trees["vocoder_params"]
        nq = pcfg["vocoder"]["quantizer"]["n_groups"] * pcfg["vocoder"]["quantizer"]["n_codebooks"]
        for w in wavs:
            frames = -(-(len(w) // 2048) // 16) * 16
            vc.content_tokens(w[None])
            vocoder.decode(f32, cv.cfg.vocoder, torch.zeros((1, nq, frames), dtype=torch.int32,
                                                          device=cv.device))
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup
        rec.clear()
        readings: Dict = {}
        j = 0
        t0 = time.perf_counter()
        if not ctx.trace:
            while time.perf_counter() - t0 < ctx.seconds:
                convert(j)
                j += 1
            window_s = time.perf_counter() - t0
            e2e = {"audio_s_per_s": sum(u["s"] for u in done) / window_s}
        else:
            while time.perf_counter() - t0 < 0.4 * ctx.seconds:
                convert(j)
                j += 1
            unsync = (0, j, sum(u["ms"] for u in done) / 1e3)
            box = {"j": j}

            def profiled():
                t1 = time.perf_counter()
                while time.perf_counter() - t1 < tr["profile_s"]:
                    convert(box["j"])
                    box["j"] += 1
            readings["profile"] = core.profile(profiled)
            prof = (j, box["j"])
            j = box["j"]
            spans = core.Spans(dev)
            state = {"n": 0}

            def content(fn):
                def f(self, wav):
                    state["n"] += 1  # infer encodes the reference first, then the source
                    return spans.timed("prompt" if state["n"] % 2 else "encode", fn, self, wav)
                return f
            wraps = [(pipeline.VoiceConverter, "speaker_embeddings",
                      lambda fn: lambda *a, **k: spans.timed("prompt", fn, *a, **k)),
                     (pipeline.VoiceConverter, "audio_codes",
                      lambda fn: lambda *a, **k: spans.timed("prompt", fn, *a, **k)),
                     (pipeline.VoiceConverter, "content_tokens", content),
                     (arvc, "generate", lambda fn: lambda *a, **k: spans.timed("generate", fn, *a, **k)),
                     (vocoder, "decode", lambda fn: lambda *a, **k: spans.timed("vocode", fn, *a, **k))]
            with contextlib.ExitStack() as stack:
                for mod, attr, w in wraps:
                    stack.enter_context(core.wrapped(mod, attr, w))
                t2 = time.perf_counter()
                rest = max(ctx.seconds - (t2 - t0), 0.25 * ctx.seconds)
                while time.perf_counter() - t2 < rest:
                    convert(j)
                    j += 1
                readings["span_window_s"] = time.perf_counter() - t2
            window_s = time.perf_counter() - t0
            readings.update(spans=spans.ms, unsync=unsync, prof=prof)
            e2e = {}
    peak = common.peak_bytes(dev)
    for u, r in zip(done, rec):
        u.update({k: (v.cpu() if torch.is_tensor(v) else v) for k, v in r.items()})
    del cv, vc, rec
    common.free_cuda()
    if ctx.trace:
        readings.update(rooflines(cellc.config, readings, done))

    common.no_tf32()
    rt = common.reference_trees(trees)
    del trees
    cfg = rnn.ns(pcfg)
    rng = np.random.default_rng(voice.sub_seed(ctx.seed, 11))
    longest = max(range(len(done)), key=lambda i: done[i]["s"])
    others = [i for i in range(len(done)) if i != longest]
    pick = [longest] + sorted(rng.choice(others, size=min(len(others), tr["check_utts"] - 1),
                                         replace=False).tolist())
    numbers = check(rt, cfg, tr, pool, wavs, [done[i] for i in pick], dev, ctx.control,
                    core.DTYPES[cellc.config["dtypes"]["lm"]])
    return {"attempted": len(done), "failed": 0, "e2e": e2e, "setup_s": setup_s,
            "readings": readings, "numbers": numbers, "peak_bytes": peak,
            "window_s": window_s}


def _lm_layout(u: Dict, delay: int):
    Tr = u["ref_tokens"].shape[1]
    Ts = u["src_tokens"].shape[1]
    return Tr, Ts, 33 + 2 * (Tr + delay) + 1  # the prefill's rows


def utterance_least(config: Dict, u: Dict, delay: int) -> Dict[str, float]:
    """Least seconds of one conversion's counted work: the reference's and
    the source's content encode, the reference's codec encode, the LM's
    prefill, slow steps and fast loops, the codec's decode (the speaker
    encoders are not counted)."""
    p, dt = config["pipeline"], config["dtypes"]
    d = p["arvc"]["decoder"]
    wb_lm, wb_dsp = counts.BYTES[dt["lm"]], counts.BYTES[dt["dsp"]]
    cb = 4  # `generate`'s KV cache is float32
    Tr, Ts, L = _lm_layout(u, delay)
    n_ref = Tr  # the reference's frames encoded (cropped after encoding)
    out = {
        "prompt": counts.least_s(counts.add(counts.tokenizer_encode(p["tokenizer"], n_ref, wb_dsp),
                                            counts.codec_encode(p["vocoder"], n_ref, wb_dsp)),
                                 dt["dsp"]),
        "encode": counts.least_s(counts.tokenizer_encode(p["tokenizer"], Ts, wb_dsp), dt["dsp"]),
        "prefill": counts.least_s(counts.slow_rows(d, 0, L, wb_lm, cb, head=False), dt["lm"]),
        "slow_decode": sum(counts.least_s(counts.slow_step(d, L + 2 * (f - 1), wb_lm, cb),
                                          dt["lm"]) for f in range(1, Ts)),
        "fast_decode": Ts * counts.least_s(counts.fast_loop(d, wb_lm), dt["lm"]),
        "vocode": counts.least_s(counts.vocoder_decode(p["vocoder"], Ts, wb_dsp), dt["dsp"]),
    }
    return out


def rooflines(config: Dict, r: Dict, done: List[Dict]) -> Dict:
    delay = 2
    a, b, took = r["unsync"]
    least_unsync = sum(sum(utterance_least(config, u, delay).values()) for u in done[a:b])
    kern = {}
    pa, pb = r["prof"]
    for u in done[pa:pb]:
        for k, v in utterance_least(config, u, delay).items():
            kern[k] = kern.get(k, 0.0) + v
    return {"least_unsync_s": least_unsync, "time_unsync_s": took, "kernel_least_s": kern}


def check(rt: Dict, cfg, tr: Dict, pool, wavs, utts: List[Dict], dev, control: bool,
          lm_dtype: torch.dtype) -> Dict:
    from streamvoiceanon_tpu_torch.evals.anonymize import speaker_seed

    d = cfg.arvc.decoder
    samp = cfg.sampling
    delay, alpha = tr["delay"], tr["alpha"]
    trees = {"": rt}
    if control:
        trees["control_"] = {"tokenizer": common.weights.cast(rt["tokenizer"], torch.bfloat16),
                             "vocoder": common.weights.cast(rt["vocoder"], torch.bfloat16),
                             "arvc": common.fp8_round(rt["arvc"]),
                             "campplus": common.weights.cast(rt["campplus"], torch.bfloat16),
                             "speaker": common.weights.cast(rt["speaker"], torch.bfloat16)}
    out: Dict[str, float] = {}
    acc: Dict[str, list] = {}
    with torch.no_grad():
        for u in utts:
            target = pool[int(np.random.default_rng(u["sseed"]).integers(len(pool)))]
            gen = torch.Generator(device=dev).manual_seed(speaker_seed(u["sseed"], 0))
            noise = (torch.randn((1, cfg.campplus.embedding_size), generator=gen, device=dev),
                     torch.randn((1, cfg.speaker.token_num, cfg.speaker.latent_dim),
                                 generator=gen, device=dev))
            spf = 2048
            n_ref, n_src = len(target) // spf, len(wavs[u["k"]]) // spf
            Tr = max(n_ref // 8 * 8, min(8, n_ref))  # `infer`'s prompt crop and source pad
            Ts = -(-n_src // 16) * 16
            acc.setdefault("layout_mismatch", []).append(
                (float(_lm_layout(u, delay)[:2] != (Tr, Ts)), 1))
            g = []
            for _ in range(Ts):
                common.gumbel(gen, (1, d.vocab_size), dev)
                g.append(common.gumbel(gen, (1, d.num_codebooks, d.codebook_size), dev))
            g = torch.cat(g)
            ref = torch.from_numpy(target).to(dev)
            src = torch.from_numpy(wavs[u["k"]]).to(dev)
            pc = u["codes"].to(dev)
            ref_logits = None
            for pre, t in trees.items():
                style, tim = speaker.speaker_embeddings(t["campplus"], t["speaker"], cfg, ref,
                                                        alpha, noise)
                rtok, _ = codec.content_tokens(t["tokenizer"], cfg.tokenizer,
                                               ref[None, : ref.shape[0] // spf * spf])
                rcodes = codec.codec_encode(t["vocoder"], cfg.vocoder,
                                            ref[None, : ref.shape[0] // spf * spf])
                stok, _ = codec.content_tokens(t["tokenizer"], cfg.tokenizer,
                                               src[None, : n_src * spf])
                rtok, rcodes = rtok[:, :Tr], rcodes[:, :, :Tr]
                ptoks = torch.cat([u["ref_tokens"], u["src_tokens"][:, :n_src]], 1).to(dev)
                acc.setdefault(pre + "tokens_mismatch", []).append(
                    (common.mismatch(ptoks, torch.cat([rtok, stok], 1)), ptoks.numel()))
                if pre == "":
                    style_ref, tim_ref = style.to(lm_dtype), tim.to(lm_dtype)
                    rtok_ref, rcodes_ref = rtok, rcodes
                    style, tim = u["style"], u["timbre"]
                # as `infer` hands them to the LM: in the LM's type
                for key, x, want in (("style_rel_err", style, style_ref),
                                     ("timbre_rel_err", tim, tim_ref)):
                    acc.setdefault(pre + key, []).append(
                        (common.rel_rms(x.to(dev).to(lm_dtype), want), 1))
                # every LM is fed the program's style, timbre and source tokens (each
                # judged on its own) and the reference's prompt tokens and codes (the
                # codes are not compared alone: a wrong one shows in lm_gap)
                cond = torch.cat([rtok_ref, u["src_tokens"].to(dev)], dim=1)
                aud = torch.cat([rcodes_ref, pc], dim=-1)
                hid = lm.frame_hidden(t["arvc"], d, u["style"].to(dev).float(),
                                      u["timbre"].to(dev).float(), cond, aud, delay, Tr, Ts,
                                      wait4end=delay)
                logits = lm.codebook_logits(t["arvc"], d, hid[0], pc[0].t())
                if pre == "":
                    ref_logits, served = logits, pc[0].t()
                else:
                    served = lm.race_winner(logits, g, samp.temperature, samp.top_p)
                gap = lm.served_gap(ref_logits, g, served, samp.temperature, samp.top_p,
                                    SLACK)
                acc.setdefault(pre + "lm_gap", []).append((float(gap.max()), 1))
                wav = codec.codec_decode(t["vocoder"], cfg.vocoder, pc)[0, : n_src * spf].float()
                if pre == "":
                    wav_ref = wav
                    got = torch.from_numpy(np.asarray(u["wav"], np.float32)).to(dev)
                    acc.setdefault("wav_rel_err", []).append((common.rel_rms(got, wav_ref), 1))
                else:
                    acc.setdefault(pre + "wav_rel_err", []).append(
                        (common.rel_rms(wav, wav_ref), 1))
    for k, v in acc.items():
        if k.startswith("_"):
            continue
        if k.endswith("mismatch"):
            out[k] = sum(a * n for a, n in v) / max(1, sum(n for _, n in v))
        else:
            out[k] = max(a for a, _ in v)
    return out


SLACK = 0.02
