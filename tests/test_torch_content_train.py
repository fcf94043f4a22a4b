"""The content encoder's training on the port's normal path, on the CPU at a
tiny size, against the benchmark's plain reference (`portbench/reference/
content.py` and `conformer.py`, plain PyTorch written from the published
description, importing nothing of the port):

* the w2v-BERT teacher (`models/w2v_bert.W2vBertTeacher`, a 3-layer,
  64-wide conformer with the published clamp ranges and kernel) against
  the reference conformer over its stacked fbank, in float32 and in
  float16, on a padded batch, truncated at layer 1 and 2; the masked path
  (`stacked_features` with lengths, `apply` with a mask) on a padded batch
  against each row run alone;
* `ASRTrainer.train_step` on a `train.data.batches` batch, computing the
  teacher's features and lengths and the CAM++ style itself, against the
  reference's step: the first L1 and s2s terms, the first gradient (AdamW's
  first moment after one step over 0.1) and the parameters after three
  steps;
* the step's spans and the teacher's counter with the recorder on, and
  nothing recorded with it off; a prepared batch still runs without a
  teacher.

The trees are drawn by the benchmark's `weights_content.specs` and handed
to the port's public constructors.
"""

import copy

import numpy as np
import pytest
import torch

from portbench import core, weights, weights_content
from portbench.reference import conformer, content as rc
from portbench.reference import nn as rnn
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch.models.asr_decoder import ASRDecoderConfig
from streamvoiceanon_tpu_torch.models import w2v_bert_native as wn
from streamvoiceanon_tpu_torch.models.w2v_bert import W2vBertTeacher, feature_lens
from streamvoiceanon_tpu_torch.train import data
from streamvoiceanon_tpu_torch.train.asr_trainer import ASRTrainer, ASRTrainerConfig
from streamvoiceanon_tpu_torch.train.text import TextTokenizer
from streamvoiceanon_tpu_torch.utils import profiling
from streamvoiceanon_tpu_torch.utils.tree import flatten

LAYERS = 2
# float32 against float32 computed in another order (an FFT for the DFT
# product, `F.layer_norm` for the hand-written norm): rounding, a few
# float32 ulps (6e-8) carried through two layers
F32 = 1e-5
# float16 keeps 11 bits (a rounding of 2^-12 relative), taken tens of times
# deep through two layers: about 1e-3 over the features; bfloat16 (8 bits)
# reads eight times that, and fails it
F16 = 4e-3


def _config() -> dict:
    cfg = copy.deepcopy(core.load_json(core.ROOT / "configs" / "sva-content-train.json"))
    t = cfg["tokenizer"]
    t["backbone"].update(depths=[1, 1, 1, 1], dims=[16, 16, 16, 32])
    t["quantizer"]["input_dim"] = 32
    t["transformer"].update(n_layer=2, n_head=2, dim=32, intermediate_size=64, head_dim=16,
                            window_size=16)
    t["head"].update(input_channels=32, depths=[1, 1], dims=[16, 64])
    cfg["campplus"].update(block_layers=[1, 1, 1], init_channels=32)
    cfg["teacher"].update(hidden=64, n_layers=3, n_heads=4, intermediate=128)
    cfg["teacher_layers"] = LAYERS
    cfg["asr_decoder"].update(hidden_dim=32, num_heads=2, depth=1, in_channels=32)
    return cfg


CFG = _config()
NS = rnn.ns({k: CFG[k] for k in ("sample_rate", "resample_rate", "tokenizer", "campplus",
                                 "asr_decoder", "teacher")})
PCFG = core.port_config({k: CFG[k] for k in ("sample_rate", "resample_rate", "tokenizer",
                                             "campplus")})
WCFG = wn.W2VBertConfig(**CFG["teacher"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    return weights.draw(weights_content.specs(CFG), 2 ** 33 + 7, "cpu", {})


def _wav16(lens, seed=3):
    g = torch.Generator().manual_seed(seed)
    wav = torch.zeros(len(lens), max(lens))
    for i, n in enumerate(lens):
        t = torch.arange(n) / 16000.0
        wav[i, :n] = 0.1 * torch.sin(2 * np.pi * (120 + 40 * i) * t) * torch.randn(n, generator=g)
    return wav


def _rel(got, want, lens):
    T = min(got.shape[1], want.shape[1])
    mask = (torch.arange(T)[None, :] < torch.as_tensor(lens)[:, None])[..., None]
    got, want = got[:, :T].double() * mask, want[:, :T].double() * mask
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


@pytest.mark.parametrize("layers", [1, LAYERS])
def test_teacher_matches_the_reference_in_float32(trees, layers):
    """A padded batch of two rows, each row's valid frames: the port's
    features and lengths against the reference's."""
    lens16 = [16000, 11200]
    wav = _wav16(lens16)
    feats, lens = W2vBertTeacher(layer=layers, native_params=trees["teacher"], native_cfg=WCFG,
                                 device="cpu", dtype=torch.float32)(wav, lens16)
    ref = conformer.teacher(trees["teacher"], NS.teacher, wav, layers)
    assert feats.dtype == torch.float32 and feats.shape[-1] == WCFG.hidden
    assert lens.tolist() == [50, 35] == list(feature_lens(lens16))
    assert list(rc.teacher_lens([44100, 30870], 44100, 16000)) == [50, 35]
    assert _rel(feats, ref, lens) < F32


def test_teacher_in_float16_within_its_rounding(trees):
    """The float16 teacher (the default: weights held and computed in
    float16, LayerNorm statistics in float32) returns float32 within
    float16's rounding of the float32 reference; bfloat16 does not."""
    lens16 = [16000, 11200]
    wav = _wav16(lens16)
    ref = conformer.teacher(trees["teacher"], NS.teacher, wav, LAYERS)

    def run(dtype):
        t = W2vBertTeacher(layer=LAYERS, native_params=trees["teacher"], native_cfg=WCFG,
                           device="cpu", **({} if dtype is None else {"dtype": dtype}))
        return t, t(wav, lens16)

    t16, (f16, lens) = run(None)
    assert t16.dtype == torch.float16 and f16.dtype == torch.float32
    assert t16._native_params["proj"]["w"].dtype == torch.float16
    assert t16._native_params["layers"]["attn"]["q"]["w"].shape[0] == LAYERS  # truncated
    err16 = _rel(f16, ref, lens)
    errbf = _rel(run(torch.bfloat16)[1][0], ref, lens)
    assert err16 < F16 < errbf, (err16, errbf)


def test_masked_rows_equal_each_row_alone(trees):
    """`stacked_features` with lengths and `apply` with its mask on a padded
    batch give each row's valid frames as the reference gives the row
    alone (normalisation over its own frames, no attention to padding)."""
    lens16 = [16000, 11200]
    wav = torch.nn.functional.pad(_wav16(lens16), (160, 160))
    x_lens = torch.tensor(lens16) + 320
    for i, n in enumerate(lens16):
        wav[i, n + 320:] = 0.0
    f, m = wn.stacked_features(wav, x_lens)
    got = wn.apply(trees["teacher"], WCFG, f, mask=m, num_layers=LAYERS)
    for i, n in enumerate(lens16):
        alone = conformer.hidden_states(
            trees["teacher"], NS.teacher, conformer.stacked_fbank(wav[i:i + 1, :n + 320]), LAYERS)
        v = int(m[i].sum())
        assert v == alone.shape[1]
        assert _rel(got[i:i + 1, :v], alone, [v]) < F32


def _trainer(trees, teacher_dtype=torch.float32):
    """The port's trainer from its public constructors: the teacher to
    layer `LAYERS` in `teacher_dtype`, CAM++ for the style."""
    teacher = W2vBertTeacher(layer=LAYERS, native_params=trees["teacher"], native_cfg=WCFG,
                             device="cpu", dtype=teacher_dtype)
    return ASRTrainer(PCFG, ASRDecoderConfig(**CFG["asr_decoder"]),
                      ASRTrainerConfig(**CFG["trainer"]), trees["tokenizer"], trees["asr"],
                      device="cpu", teacher=teacher, campplus_params=trees["campplus"])


def _batches(n=3):
    it = data.batches(data.attach_text_ids(
        data.synthetic_dataset(data.DataConfig(batch_size=2), seed=5, frames=(8, 14)),
        TextTokenizer(bos_id=50528, eos_id=50527)), data.DataConfig(batch_size=2))
    return [next(it) for _ in range(n)]


def test_train_step_matches_the_reference(trees):
    """Three steps from dataloader batches (waves, wave_lens, frame_lens,
    text, text_lens only): the trainer computes the teacher's features and
    lengths and the style itself.  The first terms within 1e-5 relative,
    the first gradient within 1e-4 of each live leaf's norm, and the
    parameters' change over three steps within 1e-3 of each live leaf's
    (AdamW divides by the root of the second moment, so an element whose
    gradient is rounding moves by lr either way)."""
    from streamvoiceanon_tpu_torch.models import tokenizer

    batches = _batches()
    tr = _trainer(trees)
    assert tr.teacher.dtype == torch.float32
    flat0 = rc.flatten({"tokenizer": trees["tokenizer"], "asr": trees["asr"]})
    flat0 = {k: v.clone() for k, v in flat0.items()}
    seen, mu1 = [], None
    for s, b in enumerate(batches):
        assert set(b) == {"waves", "wave_lens", "frame_lens", "text", "text_lens"}
        ff = tr.frozen_features(b["waves"], b["wave_lens"])
        _, idx = tokenizer.quantized_latents(tr.params["tokenizer"], tr.cfg.tokenizer,
                                             torch.from_numpy(b["waves"]))
        seen.append((tr.train_step(b), ff, idx))
        if s == 0:
            mu1 = {k: v.clone() for k, v in tr.opt_state[1]["mu"].items()}
    tcfg = CFG["trainer"]
    params = {k: v.clone() for k, v in flat0.items()}
    opt = rc.AdamW(params, tcfg)
    for s, (b, (aux, ff, idx)) in enumerate(zip(batches, seen)):
        waves = torch.from_numpy(b["waves"])
        with torch.no_grad():
            fr = rc.frozen(trees, NS, waves, LAYERS)
            here = {"tokenizer": rc.unflatten(params)["tokenizer"]}  # AdamW's decay moves it
            assert torch.equal(rc.tokens(here, NS, waves), idx)
        assert _rel(ff["teacher_feats"], fr["teacher_feats"], ff["teacher_lens"]) < F32
        assert torch.allclose(ff["style"][:, 0], fr["style"], rtol=1e-4, atol=1e-5)
        fed = {"idx": idx, "teacher_feats": fr["teacher_feats"], "style": fr["style"],
               "teacher_lens": torch.as_tensor(rc.teacher_lens(b["wave_lens"], 44100, 16000)),
               **{k: torch.as_tensor(b[k]) for k in ("frame_lens", "text", "text_lens")}}
        (l1, s2s), grads = rc.loss_grads(params, NS, tcfg, fed)
        assert aux["l1_loss"] == pytest.approx(l1, rel=1e-5)
        assert aux["s2s_loss"] == pytest.approx(s2s, rel=1e-5)
        if s == 0:
            g1 = rc.clipped(grads, tcfg["clip"])
        opt.step(params, grads)
    live = [k for k, g in g1.items() if float(g.norm()) > 0]
    assert len(live) < len(g1)  # the quantizer's input side has none
    for k in live:
        assert float((mu1[k] / 0.1 - g1[k]).norm()) <= 1e-4 * float(g1[k].norm()), k
    got = flatten(tr.params)
    for k in live:
        want = params[k] - flat0[k]
        assert float((got[k].detach() - flat0[k] - want).norm()) <= 1e-3 * float(want.norm()), k


def test_spans_and_the_teacher_counter(trees, monkeypatch):
    """With the recorder on, a step is `train_step` over `features` (over
    `teacher` and `style`), `fwd_bwd`, `optim` and `sync`, and the export
    counts the teacher's rows, frames run and valid frames; with it off
    no span is made."""
    tr = _trainer(trees, torch.float16)
    b = _batches(1)[0]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with profiling.tracing() as rec:
        tr.train_step(b)
    out = rec.export()
    by_id = {s["id"]: s for s in out["spans"]}
    parent = {s["name"]: by_id[s["parent"]]["name"] if s["parent"] else None
              for s in out["spans"]}
    assert parent == {"train_step": None, "features": "train_step", "teacher": "features",
                      "style": "features", "fwd_bwd": "train_step", "optim": "train_step",
                      "sync": "train_step"}
    lens16 = -(-b["wave_lens"] * 16000 // 44100)
    frames = (1 + (-(-b["waves"].shape[1] * 16000 // 44100) + 320 - 400) // 160 + 1) // 2
    assert out["teacher"] == {"rows": 2, "frames": 2 * frames,
                              "valid_frames": int(feature_lens(lens16).sum())}

    def no_span(*a, **k):
        raise AssertionError("a span was made with the recorder off")
    monkeypatch.setattr(profiling, "_Span", no_span)
    tr.train_step(b)


def test_a_prepared_batch_needs_no_teacher(trees):
    """A batch that already holds the teacher's features runs as before,
    on a trainer given neither a teacher nor CAM++."""
    b = _batches(1)[0]
    tr = ASRTrainer(PCFG, ASRDecoderConfig(**CFG["asr_decoder"]), ASRTrainerConfig(),
                    trees["tokenizer"], trees["asr"], device="cpu")
    T = b["waves"].shape[1] // 512
    aux = tr.train_step(dict(b, teacher_feats=np.zeros((2, T, 64), np.float32),
                             teacher_lens=np.full(2, T)))
    assert np.isfinite(aux["loss"])
    with pytest.raises(ValueError, match="teacher"):
        tr.train_step(b)
    assert C.PipelineConfig().tokenizer.head.gin_channels == CFG["campplus"]["embedding_size"]
