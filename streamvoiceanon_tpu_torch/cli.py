"""Command-line interface of the PyTorch port, as the JAX package's cli.py:

    python -m streamvoiceanon_tpu_torch.cli convert --src S.wav --ref R.wav [R2.wav ...]
        [--out out.wav] [--delay 2] [--alpha 1.0] [--simulate-streaming]
        [--window-mode] [--preset balanced] [--seed 0] [--device cpu]
    python -m streamvoiceanon_tpu_torch.cli batch --meta meta.lst --out-dir DIR
    python -m streamvoiceanon_tpu_torch.cli live --ref R.wav [--src noise]
        [--duration 10] [--switch-preset low_latency@5]
    python -m streamvoiceanon_tpu_torch.cli anonymize --data-dir D --out-dir O
        --target-refs T1.wav [T2.wav ...] [--alpha 0.7] [--delay 2]
    python -m streamvoiceanon_tpu_torch.cli evaluate --data-dir D --results-dir R
        [--asv-enrolls E --asv-trials T [--train-asv-on-anon --train-dirs X]]
        [--ser-datasets S] [--asr-datasets A]

Every command runs on the CUDA card unless given `--device cpu`, under the
`tpu_optimized` program set on the card (the JAX package takes it on a
TPU).  `--ckpt-dir` holds the five published state_dicts (`CHECKPOINTS`),
loaded with strict key coverage (`--lenient-ckpt` reports the keys no
converter consumed instead of raising); without it the weights are random,
from `--seed`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import resolve_device


# the published state_dicts, by the part each one holds
CHECKPOINTS = {
    "tokenizer": "asr_s2s_bsq_8192_causal_down_whisper.pth",
    "vocoder": "firefly-gan-vq-fsq-8x1024-21hz-generator.pth",
    "arvc": "dual_ar_delay_0_8.pth",
    "campplus": "campplus_cn_common.bin",
    "speaker": "spark_speaker_encoder.pth",
}


def load_state_dict(path: str, device=None) -> dict:
    """A published state_dict on `device`: its `net` entry where it has one,
    every key's `module.` prefix stripped."""
    sd = torch.load(path, map_location=device, weights_only=True)
    if "net" in sd:
        sd = sd["net"]
    return {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}


def checkpoint_trees(ckpt_dir: str, cfg, device=None, lenient: bool = False) -> dict:
    """The five published state_dicts of `ckpt_dir` as the JAX package's numpy
    trees, by part (`CHECKPOINTS`; the ARVC tree with stacked layers).  A key
    that no converter consumes raises `KeyError` listing them, or with
    `lenient` is reported on stderr."""
    from streamvoiceanon_tpu_torch.models import arvc, campplus, speaker_encoder
    from streamvoiceanon_tpu_torch.runtime import convert

    def strict(part, fn, ccfg):
        name = CHECKPOINTS[part]
        tree, leftover = convert.convert_with_coverage(
            fn, load_state_dict(os.path.join(ckpt_dir, name), device), ccfg)
        if leftover:
            msg = (f"[ckpt] {name}: {len(leftover)} unconsumed key(s): "
                   f"{', '.join(leftover[:12])}{' ...' if len(leftover) > 12 else ''}")
            if not lenient:
                raise KeyError(msg + "  (pass --lenient-ckpt to load anyway)")
            print(msg, file=sys.stderr)
        return tree

    return {"tokenizer": strict("tokenizer", convert.tokenizer, cfg.tokenizer),
            "vocoder": strict("vocoder", convert.vocoder, cfg.vocoder),
            "arvc": arvc.prepare_params(strict("arvc", convert.arvc, cfg.arvc)),
            "campplus": strict("campplus", campplus.convert, cfg.campplus),
            "speaker": strict("speaker", speaker_encoder.convert, cfg.speaker)}


def build_converter(ckpt_dir: str | None, seed: int = 0, device=None, lenient: bool = False):
    """A converter of the published geometry on `device` (the card unless
    given): the published checkpoints of `ckpt_dir` (`checkpoint_trees`), or
    without one seeded random weights."""
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.utils import randparams as rp

    dev = resolve_device(device)
    cfg = C.PipelineConfig()
    if dev.type == "cuda":
        cfg = C.tpu_optimized(cfg)
    if ckpt_dir is not None:
        t = checkpoint_trees(ckpt_dir, cfg, dev, lenient)
    else:
        print("[warn] no --ckpt-dir: running with RANDOM weights", file=sys.stderr)
        t = {"tokenizer": rp.tokenizer_params_np(cfg.tokenizer, seed),
             "vocoder": rp.vocoder_params_np(cfg.vocoder, seed + 1),
             "arvc": rp.arvc_params_np(cfg.arvc, seed + 2),
             "campplus": rp.campplus_params_np(cfg.campplus, seed + 3),
             "speaker": rp.speaker_encoder_params_np(cfg.speaker, seed + 4)}
    return P.converter_from_numpy(cfg, t["tokenizer"], t["vocoder"], t["arvc"], device=dev,
                                  campplus_np=t["campplus"], speaker_np=t["speaker"])


def cmd_convert(args):
    from streamvoiceanon_tpu_torch.audio.io import read_wav, write_wav
    from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter
    from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession

    cv = build_converter(args.ckpt_dir, args.seed, args.device, args.lenient_ckpt)
    sr = cv.cfg.sample_rate
    src, _ = read_wav(args.src, target_sr=sr)
    refs = [read_wav(p, target_sr=sr)[0] for p in args.ref]
    sampling = C.SamplingConfig(temperature=args.temperature, top_p=args.top_p)
    scfg = C.preset(args.preset) if args.preset else cv.cfg.stream
    delay = args.delay if args.delay is not None else scfg.delay
    alpha = args.alpha if args.alpha is not None else scfg.alpha

    t0 = time.time()
    if args.simulate_streaming:
        scfg = C.replace(scfg, delay=delay, alpha=alpha,
                         decode_chunk_frames=args.decode_chunk_frames)
        sess = StreamSession(cv, scfg, refs, sampling=sampling, seed=args.seed,
                             incremental=not args.window_mode)
        out = sess.stream_file(src)
    else:
        gen = torch.Generator(device=cv.device).manual_seed(args.seed)
        out = VoiceConverter(cv).infer(src, refs, delay=delay, alpha=alpha, generator=gen,
                                       sampling=sampling,
                                       ref_crop_lengths=args.ref_crop_lengths)
    dur = len(out) / sr
    wall = time.time() - t0
    print(f"converted {dur:.1f}s of audio in {wall:.1f}s (RTF {wall / max(dur, 1e-9):.2f})")
    out_path = args.out or "converted.wav"
    write_wav(out_path, out, sr)
    print(f"wrote {out_path}")


def cmd_batch(args):
    """SeedTTS-style test-set runner: meta.lst lines
    `name|prompt_wav|source_wav` -> converted wavs in the output directory."""
    from streamvoiceanon_tpu_torch.audio.io import read_wav, write_wav
    from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter

    cv = build_converter(args.ckpt_dir, args.seed, args.device, args.lenient_ckpt)
    vc = VoiceConverter(cv)
    sr = cv.cfg.sample_rate
    sampling = C.SamplingConfig(temperature=args.temperature, top_p=args.top_p)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.meta) as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 3:
                continue
            name, prompt_path, src_path = parts[0], parts[1], parts[2]
            src, _ = read_wav(src_path, target_sr=sr)
            ref, _ = read_wav(prompt_path, target_sr=sr)
            gen = torch.Generator(device=cv.device).manual_seed(args.seed)
            out = vc.infer(src, [ref], delay=args.delay, alpha=args.alpha, generator=gen,
                           sampling=sampling)
            write_wav(os.path.join(args.out_dir, f"{name}.wav"), out, sr)
            print(f"wrote {name}.wav")


def cmd_anonymize(args):
    """Dataset anonymization: every utterance of a Kaldi directory converted
    against per-speaker target references with noise-mixed embeddings,
    written to `--out-dir` with its Kaldi tables."""
    from streamvoiceanon_tpu_torch.audio.io import read_wav
    from streamvoiceanon_tpu_torch.evals.anonymize import anonymize_kaldi_dir
    from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter

    cv = build_converter(args.ckpt_dir, args.seed, args.device, args.lenient_ckpt)
    sr = cv.cfg.sample_rate
    targets = [read_wav(p, target_sr=sr)[0] for p in args.target_refs]
    anonymize_kaldi_dir(VoiceConverter(cv), args.data_dir, args.out_dir, targets,
                        alpha=args.alpha, delay=args.delay, seed=args.seed, sample_rate=sr)
    print(f"anonymized {args.data_dir} -> {args.out_dir}")


def cmd_evaluate(args):
    """Privacy and utility evaluation over Kaldi directories laid out as
    `<name>` and `<name><anon-suffix>`.  The WER step scores hypotheses
    cached under `<results-dir>/asr/<set>/text`."""
    from pathlib import Path

    from streamvoiceanon_tpu_torch.evals import tables
    from streamvoiceanon_tpu_torch.evals.harness import (ASRStep, ASVStep, EvalConfig,
                                                         SERStep, run_evaluation)

    if args.asr_datasets:
        sets = list(args.asr_datasets) + [d + args.anon_suffix for d in args.asr_datasets]
        cached = all((Path(args.results_dir) / "asr" / s / "text").exists() for s in sets)
        if not cached and not args.asr_train_dirs:
            sys.exit("evaluate: --asr-datasets given but hypotheses are not cached under "
                     "results-dir/asr and no --asr-train-dirs to fit an ASR_eval recognizer")
        if not cached:
            raise NotImplementedError(
                "evaluate --asr-train-dirs: training the ASR_eval recognizer "
                f"(--asr-model {args.asr_model}) waits for the port of "
                "evals/asr_eval_train.py and evals/asr_eval_w2v.py (slice 16); "
                "cache the hypotheses under results-dir/asr/<set>/text instead")
    if args.ckpt_dir:
        cv = build_converter(args.ckpt_dir, args.seed, args.device, args.lenient_ckpt)
        cp_params, cp_cfg = cv.campplus_params, cv.cfg.campplus
    else:
        from streamvoiceanon_tpu_torch import params as P
        from streamvoiceanon_tpu_torch.utils import randparams as rp

        cp_cfg = C.PipelineConfig().campplus
        cp_params = P.campplus_params(rp.campplus_params_np(cp_cfg, args.seed),
                                      resolve_device(args.device))
        print("[warn] no --ckpt-dir: ASV scoring with RANDOM weights", file=sys.stderr)
    cfg = EvalConfig(
        data_dir=Path(args.data_dir), results_dir=Path(args.results_dir),
        anon_data_suffix=args.anon_suffix,
        asv=ASVStep(enrolls=args.asv_enrolls, trials=args.asv_trials,
                    train_asv_on_anon=args.train_asv_on_anon,
                    train_dirs=args.train_dirs or (), distance=args.asv_distance,
                    anon_backbone=args.asv_anon_backbone) if args.asv_enrolls else None,
        asr=ASRStep(datasets=args.asr_datasets) if args.asr_datasets else None,
        ser=SERStep(datasets=args.ser_datasets, emotions=tuple(args.ser_emotions))
        if args.ser_datasets else None,
        sample_rate=args.sample_rate,
    )
    results = run_evaluation(cfg, campplus_params=cp_params, cp_cfg=cp_cfg)
    for name, rows in results.items():
        print(f"== {name} ==")
        print(tables.to_string(rows))
    print(f"summary: {Path(args.results_dir) / 'results_summary.txt'}")
    return results


def cmd_live(args):
    """The operator live app headless: duplex stream and status monitor,
    preset hot-switches on a schedule."""
    from streamvoiceanon_tpu_torch.audio.io import read_wav
    from streamvoiceanon_tpu_torch.runtime import live as live_mod

    if args.list_devices:
        devs = live_mod.list_audio_devices(args.hostapi)
        if not devs:
            print("sounddevice not installed — no hardware devices (synthetic duplex only)")
        else:
            print(f"hostapis: {devs['hostapis']}")
            print(f"inputs ({devs['hostapi']}): {devs['inputs']}")
            print(f"outputs ({devs['hostapi']}): {devs['outputs']}")
        return
    if not args.ref:
        raise SystemExit("live: --ref is required (unless --list-devices)")
    cv = build_converter(args.ckpt_dir, args.seed, args.device, args.lenient_ckpt)
    app = live_mod.LiveApp(cv, args.preset, seed=args.seed)
    sr = cv.cfg.sample_rate
    refs = [read_wav(p, target_sr=sr)[0] for p in args.ref]
    print(f"prefilling reference {args.ref[0]} ...", file=sys.stderr)
    app.set_reference(refs, args.ref[0])
    app.warm_up(progress=lambda i, n: print(f"\rwarming chunk phase {i}/{n}", end="",
                                            file=sys.stderr, flush=True))
    print(file=sys.stderr)
    if args.src == "noise":
        rng = np.random.default_rng(args.seed)
        src = (rng.standard_normal(sr * 8) * 0.05).astype(np.float32)
    else:
        src, _ = read_wav(args.src, target_sr=sr)

    def duplex_for(engine):
        if args.use_device and live_mod.have_sounddevice():
            return live_mod.SoundDeviceDuplex(engine, block_frames=args.block,
                                              input_device=args.device_in,
                                              output_device=args.device_out)
        return live_mod.SyntheticDuplex(engine, src, block_frames=args.block, sink=False)

    switches = sorted((float(t), name) for name, t in
                      (spec.rsplit("@", 1) for spec in args.switch_preset or []))
    duplex = duplex_for(app.engine)
    app.start()
    duplex.start()
    t0 = time.perf_counter()
    try:
        elapsed = 0.0
        while elapsed < args.duration:
            step = min(0.5, args.duration - elapsed)
            live_mod.monitor(app, step, interval_s=step, out=sys.stderr)
            elapsed = time.perf_counter() - t0
            while switches and elapsed >= switches[0][0]:
                _, name = switches.pop(0)
                print(f"\n[switch] preset -> {name}", file=sys.stderr)
                duplex.stop()
                app.set_preset(name)
                duplex = duplex_for(app.engine)
                duplex.start()
    finally:
        duplex.stop()
        app.stop()
    print(app.status().line())


def main(argv=None):
    p = argparse.ArgumentParser(prog="streamvoiceanon_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--ckpt-dir", help="directory of the five published checkpoints")
        sp.add_argument("--lenient-ckpt", action="store_true",
                        help="warn (instead of error) on checkpoint keys the converters "
                             "did not consume")
        sp.add_argument("--device", help="torch device (default: the CUDA card)")
        sp.add_argument("--seed", type=int, default=0)

    b = sub.add_parser("batch", help="meta.lst testset conversion (SeedTTS style)")
    b.add_argument("--meta", required=True)
    b.add_argument("--out-dir", default="audio_outputs")
    b.add_argument("--delay", type=int, default=2)
    b.add_argument("--alpha", type=float, default=1.0)
    b.add_argument("--temperature", type=float, default=0.7)
    b.add_argument("--top-p", type=float, default=0.7)
    common(b)
    b.set_defaults(fn=cmd_batch)

    c = sub.add_parser("convert", help="voice conversion / anonymization")
    c.add_argument("--src", required=True)
    c.add_argument("--ref", required=True, nargs="+")
    c.add_argument("--out")
    c.add_argument("--delay", type=int, default=None)
    c.add_argument("--alpha", type=float, default=None)
    c.add_argument("--preset", choices=list(C.PRESETS))
    c.add_argument("--temperature", type=float, default=0.7)
    c.add_argument("--top-p", type=float, default=0.7)
    c.add_argument("--simulate-streaming", action="store_true")
    c.add_argument("--window-mode", action="store_true",
                   help="reference-faithful window-recompute streaming")
    c.add_argument("--decode-chunk-frames", type=int, default=1)
    c.add_argument("--ref-crop-lengths", type=float, nargs="+", default=None)
    common(c)
    c.set_defaults(fn=cmd_convert)

    a = sub.add_parser("anonymize", help="anonymize a kaldi-format dataset dir")
    a.add_argument("--data-dir", required=True)
    a.add_argument("--out-dir", required=True)
    a.add_argument("--target-refs", required=True, nargs="+",
                   help="target-speaker reference wavs (pseudo-speaker pool)")
    a.add_argument("--delay", type=int, default=2)
    a.add_argument("--alpha", type=float, default=0.7)
    common(a)
    a.set_defaults(fn=cmd_anonymize)

    e = sub.add_parser("evaluate", help="privacy/utility evaluation over kaldi dirs")
    e.add_argument("--data-dir", required=True)
    e.add_argument("--results-dir", required=True)
    e.add_argument("--anon-suffix", default="_anon")
    e.add_argument("--asv-enrolls", nargs="*", default=[])
    e.add_argument("--asv-trials", nargs="*", default=[])
    e.add_argument("--train-asv-on-anon", action="store_true",
                   help="eval_post: retrain ASV on anonymized --train-dirs")
    e.add_argument("--train-dirs", nargs="*", default=[])
    e.add_argument("--asv-distance", choices=["cosine", "plda"], default="cosine")
    e.add_argument("--asv-anon-backbone", choices=["campplus", "ecapa"], default="campplus",
                   help="ASV_eval^anon attacker: a head fine-tuned on CAM++ or an "
                        "ECAPA-TDNN trained from random init (VPC protocol)")
    e.add_argument("--asr-datasets", nargs="*", default=[],
                   help="WER sets (hypotheses cached under results-dir/asr)")
    e.add_argument("--asr-train-dirs", nargs="*", default=[],
                   help="kaldi dirs (wav.scp+text) to fit an ASR_eval recognizer when "
                        "hypotheses are not cached (not ported yet: raises)")
    e.add_argument("--asr-model", choices=["w2v", "compact"], default="w2v",
                   help="ASR_eval family: w2v-BERT conformer CTC or the compact "
                        "char-CTC transformer")
    e.add_argument("--ser-datasets", nargs="*", default=[],
                   help="SER sets (fold heads trained in place on originals)")
    e.add_argument("--ser-emotions", nargs="*", default=["neu", "hap", "sad", "ang"])
    e.add_argument("--sample-rate", type=int, default=44100)
    common(e)
    e.set_defaults(fn=cmd_evaluate)

    lv = sub.add_parser("live", help="real-time operator app (headless GUI)")
    lv.add_argument("--ref", nargs="+", default=[], help="reference wav(s) for the target voice")
    lv.add_argument("--src", default="noise", help="synthetic capture source: wav path or 'noise'")
    lv.add_argument("--preset", default="balanced", choices=list(C.PRESETS))
    lv.add_argument("--duration", type=float, default=10.0)
    lv.add_argument("--block", type=int, default=1536, help="capture block size in samples")
    lv.add_argument("--switch-preset", nargs="*", metavar="NAME@SECONDS",
                    help="hot-switch preset at a time, e.g. low_latency@5")
    lv.add_argument("--use-device", action="store_true",
                    help="use sounddevice hardware duplex when installed")
    lv.add_argument("--device-in")
    lv.add_argument("--device-out")
    lv.add_argument("--hostapi")
    lv.add_argument("--list-devices", action="store_true")
    common(lv)
    lv.set_defaults(fn=cmd_live)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
