"""Command-line interface of the PyTorch port, as the JAX package's cli.py:

    python -m streamvoiceanon_tpu_torch.cli convert --src S.wav --ref R.wav [R2.wav ...]
        [--out out.wav] [--delay 2] [--alpha 1.0] [--simulate-streaming]
        [--window-mode] [--preset balanced] [--seed 0] [--device cpu]
    python -m streamvoiceanon_tpu_torch.cli batch --meta meta.lst --out-dir DIR
    python -m streamvoiceanon_tpu_torch.cli live --ref R.wav [--src noise]
        [--duration 10] [--switch-preset low_latency@5]

Every command runs on the CUDA card unless given `--device cpu`, under the
`tpu_optimized` program set on the card (the JAX package takes it on a
TPU).  The weights are random, from `--seed`: loading the reference
checkpoints (`--ckpt-dir`) waits for the port of runtime/convert.py.
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


def build_converter(ckpt_dir: str | None, seed: int = 0, device=None):
    """A converter of the published geometry on `device` (the card unless
    given), with seeded random weights."""
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.utils import randparams as rp

    if ckpt_dir is not None:
        raise NotImplementedError("--ckpt-dir: loading the reference checkpoints waits for "
                                  "the port of runtime/convert.py")
    dev = resolve_device(device)
    cfg = C.PipelineConfig()
    if dev.type == "cuda":
        cfg = C.tpu_optimized(cfg)
    print("[warn] no --ckpt-dir: running with RANDOM weights", file=sys.stderr)
    return P.converter_from_numpy(
        cfg, rp.tokenizer_params_np(cfg.tokenizer, seed),
        rp.vocoder_params_np(cfg.vocoder, seed + 1), rp.arvc_params_np(cfg.arvc, seed + 2),
        device=dev, campplus_np=rp.campplus_params_np(cfg.campplus, seed + 3),
        speaker_np=rp.speaker_encoder_params_np(cfg.speaker, seed + 4))


def cmd_convert(args):
    from streamvoiceanon_tpu_torch.audio.io import read_wav, write_wav
    from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter
    from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession

    cv = build_converter(args.ckpt_dir, args.seed, args.device)
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

    cv = build_converter(args.ckpt_dir, args.seed, args.device)
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
    cv = build_converter(args.ckpt_dir, args.seed, args.device)
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
        sp.add_argument("--ckpt-dir", help="reference checkpoints (not ported yet)")
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
    args.fn(args)


if __name__ == "__main__":
    main()
