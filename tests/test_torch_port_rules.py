"""Rules of the PyTorch port that hold without a card: it imports nothing of
JAX or the JAX package, its entry points refuse to guess a device, its six
kernel wrappers never fall back for a tensor that is not on the CPU, and
the ctypes signatures match the CUDA sources' C entry points."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process has both frameworks; the port must not)
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch import resolve_device
from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops import convnext_enc as encops
from streamvoiceanon_tpu_torch.ops import hifigan as headops
from streamvoiceanon_tpu_torch.ops.attention import decode_attention
from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode
from streamvoiceanon_tpu_torch.ops.slow_decode import slow_decode_step
from streamvoiceanon_tpu_torch.ops.wt_stream import wt_stream_step
from streamvoiceanon_tpu_torch.runtime import checkpoints
from streamvoiceanon_tpu_torch.train.arvc_trainer import ARVCTrainer, TrainerConfig
from streamvoiceanon_tpu_torch.utils import randparams as rp

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "streamvoiceanon_tpu_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "streamvoiceanon_tpu" or name.startswith("streamvoiceanon_tpu."))


def test_port_sources_import_nothing_of_jax():
    sources = {str(p.relative_to(PORT)) for p in _port_sources() if PORT in p.parents}
    assert {"audio/resample.py", "audio/fbank.py", "audio/io.py", "models/campplus.py",
            "models/speaker_encoder.py", "models/windowed_transformer.py",
            "models/tokenizer.py", "runtime/pipeline.py", "runtime/checkpoints.py",
            "train/muon.py", "train/step.py", "train/data.py", "train/arvc_trainer.py",
            "train/text.py", "utils/text.py", "utils/cn_norm.py", "runtime/convert.py",
            "cli.py", "evals/kaldi.py", "evals/privacy_metrics.py", "evals/plda.py",
            "evals/anonymize.py", "evals/asv_train.py", "evals/ecapa_asv.py", "evals/ser.py",
            "evals/wer.py", "evals/plots.py", "evals/harness.py", "evals/tables.py",
            "models/w2v_bert_native.py", "models/w2v_bert.py", "models/asr_decoder.py",
            "train/asr_trainer.py", "ops/ctc.py", "evals/asr_eval_train.py",
            "evals/asr_eval_w2v.py", "parallel/mesh.py", "utils/profiling.py",
            "utils/roofline.py"} <= sources
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import streamvoiceanon_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'streamvoiceanon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert {'streamvoiceanon_tpu_torch.audio.fbank',\n"
        "        'streamvoiceanon_tpu_torch.models.speaker_encoder',\n"
        "        'streamvoiceanon_tpu_torch.runtime.pipeline',\n"
        "        'streamvoiceanon_tpu_torch.runtime.checkpoints',\n"
        "        'streamvoiceanon_tpu_torch.train.arvc_trainer',\n"
        "        'streamvoiceanon_tpu_torch.runtime.convert',\n"
        "        'streamvoiceanon_tpu_torch.evals.harness',\n"
        "        'streamvoiceanon_tpu_torch.evals.plots',\n"
        "        'streamvoiceanon_tpu_torch.parallel.mesh',\n"
        "        'streamvoiceanon_tpu_torch.utils.profiling',\n"
        "        'streamvoiceanon_tpu_torch.utils.roofline'} <= set(sys.modules)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'streamvoiceanon_tpu']\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg = C.PipelineConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.converter_from_numpy(cfg, {}, {}, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoints.load(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ARVCTrainer(cfg, TrainerConfig(log_dir=str(tmp_path)), {}, {}, {})
    from streamvoiceanon_tpu_torch import cli
    from streamvoiceanon_tpu_torch.evals import ecapa_asv, ser
    from streamvoiceanon_tpu_torch.parallel import mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.initialize_multihost("127.0.0.1:1", 2, 0)

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.build_converter(str(tmp_path))
    for argv in (["anonymize", "--data-dir", str(tmp_path), "--out-dir", str(tmp_path),
                  "--target-refs", "t.wav"],
                 ["evaluate", "--data-dir", str(tmp_path), "--results-dir", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ecapa_asv.train_ecapa_asv([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ser.train_fold_classifiers(0, ser.SERHeadConfig(), {}, {}, {}, {}, [])
    from streamvoiceanon_tpu_torch.evals import asr_eval_train, asr_eval_w2v
    from streamvoiceanon_tpu_torch.models import asr_decoder
    from streamvoiceanon_tpu_torch.models.w2v_bert import W2vBertTeacher
    from streamvoiceanon_tpu_torch.train.asr_trainer import ASRTrainer, ASRTrainerConfig

    for make in (lambda: asr_eval_train.train_asr_eval([], {}),
                 lambda: asr_eval_w2v.train_asr_eval_w2v([], {}),
                 lambda: ASRTrainer(cfg, asr_decoder.ASRDecoderConfig(), ASRTrainerConfig(),
                                    {}, {}),
                 lambda: W2vBertTeacher(native=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card gets an error,
    never the plain version."""
    d = C.DualARConfig(vocab_size=64, n_layer=1, n_head=2, dim=16, intermediate_size=32,
                       head_dim=8, max_seq_len=16, codebook_size=64, n_fast_layer=1,
                       fast_dim=16, fast_n_head=2, fast_head_dim=8,
                       fast_intermediate_size=32)
    p = P.dual_ar_params(rp.dual_ar_params_np(d), "meta")
    kc = torch.zeros((1, 16, 16), device="meta")
    x2 = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        slow_decode_step(p["layers"], x2, kc, kc, 2, p["norm"]["w"], p["output"]["w"],
                         None, n_head=2, head_dim=8, greedy=True)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fast_decode(p["fast_layers"], p["fast_norm"]["w"], p["fast_output"]["w"],
                    p["fast_embeddings"], p["codebook_embeddings"], x2[:1], None, nq=8,
                    n_head=2, head_dim=8, greedy=True)
    tok = C.TokenizerConfig(transformer=C.WindowedTransformerConfig(
        n_layer=1, n_head=2, dim=16, intermediate_size=32, head_dim=8, window_size=8))
    wt = P.windowed_transformer_params(rp.tokenizer_params_np(tok)["pre_module"], "meta")
    ring = torch.zeros((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wt_stream_step(wt["layers"], x2[:1], ring, ring, 3, n_head=2, head_dim=8)
    hcfg = C.HiFiGANConfig(num_mels=8, upsample_initial_channel=8, upsample_rates=(2,),
                           upsample_kernel_sizes=(4,), pre_conv_kernel_size=3,
                           post_conv_kernel_size=3, use_pallas_stream=True)
    voc = C.VocoderConfig(head=hcfg)
    head = P.hifigan_params(rp.vocoder_params_np(voc)["head"], "meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        headops.head_stream_step(headops.packed_weights(head, hcfg),
                                 headops.init_packed_state(hcfg, device="meta"),
                                 torch.zeros((1, 4, 8), device="meta"), hcfg)
    front = C.replace(tok, backbone=C.ConvNeXtConfig(input_channels=8, depths=(1, 1),
                                                     dims=(8, 16)),
                      quantizer=C.BSQConfig(input_dim=16), use_pallas_encoder=True)
    tp = P.tokenizer_params(rp.tokenizer_params_np(front), "meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        encops.encoder_front_step(encops.packed_weights(tp, front),
                                  encops.init_packed_state(front, device="meta"),
                                  torch.zeros((1, 4, 8), device="meta"), front)
    kc = torch.zeros((1, 16, 8), device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        decode_attention(x2[None, :, :8], x2[None, :, :8], x2[None, :, :8], kc, kc, 3)
    assert slow_decode_step.launches == 0 and fast_decode.launches == 0
    assert wt_stream_step.launches == 0 and headops.head_stream_step.launches == 0
    assert encops.encoder_front_step.launches == 0 and decode_attention.launches == 0


def test_unported_program_sets_are_refused():
    """Every program set of the JAX package's kernels builds its stream
    states: `tpu_optimized` (flat ring, packed head), `all_five` (also the
    packed encoder state) and `per_head_decode` (the unpadded per-head KV
    cache).  With the windowed transformer's LConv1d branch (`dw_conv`)
    the ring keeps the rotated frame, under `tpu_optimized` too, and
    carries the branch's conv tail."""
    from streamvoiceanon_tpu_torch.models import dual_ar, hifigan, tokenizer_stream

    cfg = C.tpu_optimized(C.PipelineConfig())
    ring = tokenizer_stream.ring_init(cfg.tokenizer.transformer, device="meta")
    assert ring.k_ring.shape == (8, 1, 512, 512)
    head = hifigan.hifigan_init_stream({}, cfg.vocoder.head, device="meta")
    assert isinstance(head, headops.PackedHeadState) and head.res[0].shape == (1, 400, 256)
    enc = C.all_five(C.PipelineConfig()).tokenizer
    st = tokenizer_stream.init_stream_state({}, enc, device="meta")
    assert isinstance(st.backbone, encops.PackedEncState) and st.down == ()
    assert [t.shape[1] for t in st.backbone.stages] == [24, 24, 72, 24]
    assert st.backbone.stem.shape == (1, 8, 160) and st.backbone.down.shape == (1, 16, 512)
    ph = C.per_head_decode(C.PipelineConfig()).arvc.decoder
    d = dual_ar.init_state(ph, device="meta")
    assert d.k_cache.shape == (12, 1, 12, 2048, 64) and d.pos == 0
    assert dual_ar.init_state(cfg.arvc.decoder, device="meta").k_cache.shape == (12, 1, 2048,
                                                                                 768)
    dw = C.replace(cfg.tokenizer.transformer, dw_conv=True)
    ring = tokenizer_stream.ring_init(dw, device="meta")
    assert ring.k_ring.shape == (8, 1, 8, 512, 64)
    assert ring.conv_tail.shape == (8, 1, dw.conv_kernel_size - 1, 512)


_CTYPE = {"int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES) + sorted(_build.EXTRA_ENTRY_POINTS))
def test_ctypes_signature_matches_cuda_entry_point(name):
    if name in _build.EXTRA_ENTRY_POINTS:
        fn, (source, argtypes) = name, _build.EXTRA_ENTRY_POINTS[name]
    else:
        source, (fn, argtypes) = name, _build.SIGNATURES[name]
    src = (PORT / "csrc" / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", src, re.S)
    assert m, f"{fn} not found in csrc/{source}.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    want = ["c_void_p" if "*" in p else _CTYPE[p.split()[0]] for p in params]
    assert [t.__name__ for t in argtypes] == want


_HOST_CTYPE = {"void*": "c_void_p", "uint64_t": "c_ulong", "float*": "LP_c_float",
               "void": None}


@pytest.mark.parametrize("fn", sorted(_build.HOST_SIGNATURES["ringbuffer"]))
def test_ctypes_signature_matches_ring_entry_point(fn):
    """The SPSC ring's C entry points (csrc/ringbuffer.cpp, built by the
    host compiler) against the ctypes types `_build.load_host` gives them."""
    src = (PORT / "csrc" / "ringbuffer.cpp").read_text()
    m = re.search(r"^([\w\*]+)\s+" + fn + r"\((.*?)\)\s*\{", src, re.S | re.M)
    assert m, f"{fn} not found in csrc/ringbuffer.cpp"
    kind = lambda decl: decl.replace("const ", "").rsplit(" ", 1)[0].replace(" ", "")
    restype, argtypes = _build.HOST_SIGNATURES["ringbuffer"][fn]
    assert (None if restype is None else restype.__name__) == _HOST_CTYPE[kind(m.group(1) + " x")]
    params = [" ".join(p.split()) for p in m.group(2).split(",")]
    assert [t.__name__ for t in argtypes] == [_HOST_CTYPE[kind(p)] for p in params]


def test_build_goes_to_an_ignored_directory():
    lib = _build.library_path("slow_decode")
    assert lib.parent == PORT / "_build" and lib.suffix == ".so"
    assert "streamvoiceanon_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
