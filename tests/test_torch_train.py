"""The port's ARVC training stack against the JAX package's, on the CPU at the
tiny size with two slow and two fast layers (so that the stacked (L, dim)
norm weights show the Muon routing in both stacks):

* `newton_schulz5` on (3, 16, 24) and (24, 16), atol 1e-5;
* the Muon/AdamW labels, leaf for leaf;
* one update of the trainer's chain (clip -> MuonAdamW -> schedule) against
  optax's, with the clip above the gradients' norm and at 0.1: the
  updated parameters within 1e-6 of each leaf's largest magnitude, the
  updates within 1e-5 of each leaf's largest update (Newton-Schulz in
  float32 on two BLAS libraries);
* the AdamW fallback (`step.make_optimizer`) against the JAX package's;
* `exp_decay_schedule` at steps 0, 1, 10^6 and on its floor;
* `forward_train` of `dual_ar` and `arvc` at delay 0 and 3 with ragged
  lengths: losses within 1e-5, every leaf's gradient within 1e-4 of its
  largest magnitude; `remat` on and off give equal gradients; all-zero
  timbre rows explode the input bias's gradient in both packages alike;
* three trainer `_step`s at explicit delays against `value_and_grad` and
  the optax chain, with and without clipping: losses within 1e-5,
  parameters within 1e-4 relative;
* the trainer's `_features` against the JAX `ARVCTrainer._features`:
  tokens and codes exact, style and timbre within `torch_pairs.TOL`;
* checkpoints, the trainer's rotation, `resume_latest`, `train` and the
  audio sample; the data pipeline's outputs against the JAX module's;
* `n_model_shards=2` in two gloo processes against the one-process
  trainer, three steps.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.models import arvc as jarvc
from streamvoiceanon_tpu.models import dual_ar as jdual
from streamvoiceanon_tpu.train import data as jdata
from streamvoiceanon_tpu.train import muon as jmuon
from streamvoiceanon_tpu.train.arvc_trainer import ARVCTrainer as JaxTrainer
from streamvoiceanon_tpu.train.arvc_trainer import TrainerConfig as JaxTrainerConfig
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import arvc, dual_ar
from streamvoiceanon_tpu_torch.runtime import checkpoints
from streamvoiceanon_tpu_torch.train import data, muon
from streamvoiceanon_tpu_torch.train import step as step_mod
from streamvoiceanon_tpu_torch.train.arvc_trainer import ARVCTrainer, TrainerConfig
from streamvoiceanon_tpu_torch.utils import randparams as rp
from streamvoiceanon_tpu_torch.utils.tree import flatten
from torch_pairs import JCFG, TOL, trees

JCFG2 = JC.replace(JCFG, arvc=JC.replace(JCFG.arvc, decoder=JC.replace(
    JCFG.arvc.decoder, n_layer=2, n_fast_layer=2)))
TCFG2 = C.from_fields(JCFG2)
EXCLUDE = ("embedding", "lm_head", "output", "to_logits")
B, T = 3, 7
X_LENS = np.array([7, 5, 3])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def arvc_np():
    return rp.arvc_params_np(TCFG2.arvc, 3)


def jax_params():
    return jax.tree.map(jnp.asarray, arvc_np())


def port_params():
    return step_mod.trainable(P.arvc_params(arvc_np(), "cpu"))


@functools.lru_cache(maxsize=1)
def batch_np():
    d = TCFG2.arvc.decoder
    rng = np.random.default_rng(0)
    return {"content": rng.integers(0, d.vocab_size, (B, T)).astype(np.int32),
            "base_target": rng.integers(0, d.vocab_size, (B, T)).astype(np.int32),
            "target": rng.integers(0, d.codebook_size, (B, d.num_codebooks, T)).astype(np.int32),
            "x_lens": X_LENS.astype(np.int32),
            "style": rng.standard_normal((B, 192)).astype(np.float32),
            "timbre": rng.standard_normal((B, 32, 128)).astype(np.float32)}


def port_batch():
    return {k: torch.from_numpy(v) for k, v in batch_np().items()}


def jax_args():
    b = {k: jnp.asarray(v) for k, v in batch_np().items()}
    return (b["content"], b["base_target"], b["target"], b["x_lens"], b["style"], b["timbre"])


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(delay: int):
    def loss(p):
        cb, tok = jarvc.forward_train(p, JCFG2.arvc, *jax_args(), delay)
        return cb + tok, (cb, tok)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def leaf_close(got: dict, want, rel: float, what: str):
    """Every leaf of the JAX tree `want` against the flat port dict `got`,
    within rel of the leaf's largest magnitude."""
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        k = tuple(p.key for p in path)
        w = np.asarray(w)
        g = got[k].detach().numpy()
        scale = max(float(np.max(np.abs(w))), 1e-30)
        err = float(np.max(np.abs(g - w)))
        assert err <= rel * scale, f"{what} {k}: {err:.3e} > {rel} x {scale:.3e}"


def jax_chain(clip: float, lr: float, gamma: float, min_lr: float):
    return optax.chain(optax.clip_by_global_norm(clip), jmuon.muon_adamw(lr=lr),
                       optax.scale_by_schedule(jmuon.exp_decay_schedule(lr, gamma, min_lr)))


def port_chain(clip: float, lr: float, gamma: float, min_lr: float):
    return muon.chain(muon.clip_by_global_norm(clip), muon.muon_adamw(lr=lr),
                      muon.scale_by_schedule(muon.exp_decay_schedule(lr, gamma, min_lr)))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 16, 24), (24, 16)])
def test_newton_schulz5_matches_jax(shape):
    g = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jmuon.newton_schulz5(jnp.asarray(g)))
    got = muon.newton_schulz5(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_muon_routing_matches_jax_label_for_label():
    jp = jax_params()
    want = jax.tree_util.tree_map_with_path(
        lambda p, leaf: "muon" if jmuon._is_muon_param(p, leaf, EXCLUDE) else "adamw", jp)
    got = muon.labels(flatten(port_params()))
    flat_want = {tuple(p.key for p in path): v
                 for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert got == flat_want
    # the stacked norms (L, dim) go to Muon at L = 2 in both stacks, as in JAX
    for stack in ("layers", "fast_layers"):
        for norm in ("attention_norm", "ffn_norm"):
            assert got[("model", stack, norm, "w")] == "muon"
    assert got[("model", "norm", "w")] == got[("model", "output", "w")] == "adamw"
    assert got[("wait4start",)] == got[("context_in", "w")] == "muon"
    # and to AdamW at L = 1, label for label with JAX
    for shape in ((1, 32), (1, 32, 96), (8, 32), (32,)):
        path = (jax.tree_util.DictKey("model"), jax.tree_util.DictKey("layers"))
        assert muon.is_muon_param(("model", "layers"), shape) == jmuon._is_muon_param(
            path, np.zeros(shape), EXCLUDE)
    assert not muon.is_muon_param(("model", "layers", "attention_norm", "w"), (1, 32))


@pytest.mark.parametrize("clip", [1000.0, 0.1])
def test_one_update_matches_optax_chain(clip):
    rng = np.random.default_rng(2)
    g_np = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.01).astype(np.float32),
                        arvc_np())
    jg = jax.tree.map(jnp.asarray, g_np)
    norm = float(optax.global_norm(jg))
    assert (norm > clip) == (clip < 1.0)  # clipping triggers at 0.1 only
    jp = jax_params()
    jtx = jax_chain(clip, 1e-3, 0.99, 1e-5)
    ju, _ = jtx.update(jg, jtx.init(jp), jp)
    tp = {k: v.detach().clone() for k, v in flatten(port_params()).items()}
    ttx = port_chain(clip, 1e-3, 0.99, 1e-5)
    tu, _ = ttx.update(flatten(P.arvc_params(g_np, "cpu")), ttx.init(tp), tp)
    leaf_close(tu, ju, 1e-5, "update")
    muon.apply_updates(tp, tu)
    leaf_close(tp, optax.apply_updates(jp, ju), 1e-6, "updated parameter")


def test_adamw_fallback_matches_jax():
    from streamvoiceanon_tpu.train.step import make_optimizer as jax_make_optimizer

    rng = np.random.default_rng(3)
    g_np = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.01).astype(np.float32),
                        arvc_np())
    jp, jg = jax_params(), jax.tree.map(jnp.asarray, g_np)
    jtx = jax_make_optimizer(lr=1e-3, clip=0.1)
    ju, _ = jtx.update(jg, jtx.init(jp), jp)
    tp = {k: v.detach().clone() for k, v in flatten(port_params()).items()}
    ttx = step_mod.make_optimizer(lr=1e-3, clip=0.1)
    tu, _ = ttx.update(flatten(P.arvc_params(g_np, "cpu")), ttx.init(tp), tp)
    leaf_close(tu, ju, 1e-5, "update")


def test_exp_decay_schedule_matches_jax():
    js = jmuon.exp_decay_schedule(1e-4)
    ts = muon.exp_decay_schedule(1e-4)
    floor = 10 ** 7  # 1e-4 * gamma^step < 1e-5 from about 767,500 steps on
    for s in (0, 1, 10 ** 6, floor):
        np.testing.assert_allclose(ts(s), float(js(jnp.int32(s))), rtol=1e-6)
    assert ts(0) == 1.0 and ts(floor) == pytest.approx(0.1, rel=1e-6)


# ---------------------------------------------------------------------------
# forward_train
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delay", [0, 3])
def test_forward_train_matches_jax(delay):
    (_, (jcb, jtok)), jg = jax_value_and_grad(delay)(jax_params())
    # dual_ar.forward_train on the same embedded conditions
    jp, tp = jax_params(), port_params()
    b = port_batch()
    cond = np.array(jarvc.embed_content(jp, jnp.asarray(batch_np()["content"])))
    spk = np.array(jarvc.spk_condition(jp, *jax_args()[4:]))
    dcb, dtok = jdual.forward_train(jp["model"], JCFG2.arvc.decoder, jnp.asarray(cond),
                                    jnp.asarray(spk), *jax_args()[1:4], jp["wait4start"],
                                    jp["wait4end"], delay)
    with torch.no_grad():
        pcb, ptok = dual_ar.forward_train(
            tp["model"], TCFG2.arvc.decoder, torch.from_numpy(cond), torch.from_numpy(spk),
            b["base_target"], b["target"], b["x_lens"], tp["wait4start"], tp["wait4end"],
            delay)
    np.testing.assert_allclose([float(pcb), float(ptok)], [float(dcb), float(dtok)],
                               rtol=1e-5)
    cb, tok = arvc.forward_train(tp, TCFG2.arvc, b["content"], b["base_target"], b["target"],
                                 b["x_lens"], b["style"], b["timbre"], delay)
    np.testing.assert_allclose([cb.item(), tok.item()], [float(jcb), float(jtok)], rtol=1e-5)
    leaf_close(step_mod.grads_of(cb + tok, tp), jg, 1e-4, "gradient")


def test_remat_gives_identical_gradients():
    b = port_batch()
    grads = []
    for remat in (True, False):
        tp = port_params()
        cb, tok = arvc.forward_train(tp, TCFG2.arvc, b["content"], b["base_target"],
                                     b["target"], b["x_lens"], b["style"], b["timbre"], 2,
                                     remat=remat)
        grads.append(step_mod.grads_of(cb + tok, tp))
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_zero_speaker_rows_explode_the_bias_gradient_as_in_jax():
    """Timbre rows that are all zero (a random speaker encoder's FSQ gives
    them) with randparams' zero `context_in.b` enter the LM as zero leading
    rows that stay zero through every layer; each RMSNorm multiplies their
    input gradient by about 1/sqrt(eps).  At 8 slow layers the gradient
    norm is over 1e4 in both packages, equal within 1e-4."""
    jcfg = JC.replace(JCFG2, arvc=JC.replace(JCFG2.arvc, decoder=JC.replace(
        JCFG2.arvc.decoder, n_layer=8)))
    tcfg = C.from_fields(jcfg)
    tree = rp.arvc_params_np(tcfg.arvc, 3)
    b = dict(batch_np(), timbre=np.zeros((B, 32, 128), np.float32))
    args = [b[k] for k in ("content", "base_target", "target", "x_lens", "style", "timbre")]
    jg = jax.grad(lambda p: sum(jarvc.forward_train(p, jcfg.arvc, *map(jnp.asarray, args), 2)))(
        jax.tree.map(jnp.asarray, tree))
    tp = step_mod.trainable(P.arvc_params(tree, "cpu"))
    tg = step_mod.grads_of(sum(arvc.forward_train(tp, tcfg.arvc, *map(torch.from_numpy, args),
                                                  2)), tp)
    want = float(optax.global_norm(jg))
    assert want > 1e4
    np.testing.assert_allclose(float(muon.global_norm(tg)), want, rtol=1e-4)
    leaf_close(tg, jg, 1e-4, "gradient")
    # the same model on the batch's random normal timbre
    args[-1] = batch_np()["timbre"]
    tp = step_mod.trainable(P.arvc_params(tree, "cpu"))
    tg = step_mod.grads_of(sum(arvc.forward_train(tp, tcfg.arvc, *map(torch.from_numpy, args),
                                                  2)), tp)
    assert float(muon.global_norm(tg)) < 1e3


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def port_trainer(tmp_path, **kw) -> ARVCTrainer:
    t = trees()
    return ARVCTrainer(TCFG2, TrainerConfig(log_dir=str(tmp_path), **kw),
                       P.arvc_params(arvc_np(), "cpu"),
                       P.tokenizer_params(t["tokenizer_params"], "cpu"),
                       P.vocoder_params(t["vocoder_params"], "cpu"),
                       P.campplus_params(t["campplus_params"], "cpu"),
                       P.speaker_params(t["speaker_params"], "cpu"), device="cpu")


@pytest.mark.parametrize("clip", [1000.0, 0.1])
def test_three_steps_match_the_jax_chain(tmp_path, clip):
    lr, gamma, min_lr = 3e-3, 0.9, 1e-5
    trainer = port_trainer(tmp_path, lr=lr, gamma=gamma, min_lr=min_lr, clip=clip)
    jp = jax_params()
    jtx = jax_chain(clip, lr, gamma, min_lr)
    js = jtx.init(jp)
    feats = port_batch()
    for delay in (0, 3, 0):
        (jloss, (jcb, jtok)), jg = jax_value_and_grad(delay)(jp)
        ju, js = jtx.update(jg, js, jp)
        jp = optax.apply_updates(jp, ju)
        aux = trainer._step(feats, delay)
        np.testing.assert_allclose(
            [float(aux["loss"]), float(aux["codebook_loss"]), float(aux["token_loss"])],
            [float(jloss), float(jcb), float(jtok)], rtol=1e-5)
        np.testing.assert_allclose(float(aux["grad_norm"]), float(optax.global_norm(jg)),
                                   rtol=1e-5)
        assert (float(aux["grad_norm"]) > clip) == (clip < 1.0)
    assert trainer.state.step == 3
    got = flatten(trainer.state.params)
    for path, w in jax.tree_util.tree_flatten_with_path(jp)[0]:
        k = tuple(p.key for p in path)
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(np.max(np.abs(w))), err_msg=str(k))


def test_features_match_the_jax_trainer(tmp_path):
    t = trees()
    jt = JaxTrainer(JCFG2, JaxTrainerConfig(log_dir=str(tmp_path / "jax")),
                    *(jax.tree.map(jnp.asarray, x) for x in (
                        arvc_np(), t["tokenizer_params"], t["vocoder_params"],
                        t["campplus_params"], t["speaker_params"])))
    trainer = port_trainer(tmp_path / "port")
    src = data.synthetic_dataset(data.DataConfig(), seed=4, frames=(4, 7), with_text=False)
    batch = data.collate([next(src) for _ in range(2)])
    # jitted: one compile in place of eager dispatch of every op (same math)
    want = jax.jit(jt._features)(jnp.asarray(batch["waves"]), jnp.asarray(batch["frame_lens"]))
    got = trainer._features(batch["waves"], batch["frame_lens"])
    for k in ("content", "base_target", "target", "x_lens"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("style", "timbre"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    # without CAM++ and the speaker encoder, zeros of the JAX shapes
    bare = ARVCTrainer(TCFG2, TrainerConfig(log_dir=str(tmp_path / "bare")),
                       P.arvc_params(arvc_np(), "cpu"),
                       P.tokenizer_params(t["tokenizer_params"], "cpu"),
                       P.vocoder_params(t["vocoder_params"], "cpu"), device="cpu")
    f = bare._features(batch["waves"], batch["frame_lens"])
    assert f["style"].shape == (2, 192) and f["timbre"].shape == (2, 32, 128)
    assert not f["style"].any() and not f["timbre"].any()


def test_checkpoints_rotation_resume_and_train(tmp_path):
    from torch_pairs import pair

    _, tcv = pair(JCFG2)
    path = checkpoints.save(tcv, str(tmp_path / "cv"))
    assert sorted(os.listdir(path)) == ["arvc.pt", "campplus.pt", "speaker.pt",
                                        "tokenizer.pt", "vocoder.pt"]
    back = checkpoints.load(path, TCFG2, device="cpu")
    for name in ("arvc", "tokenizer", "vocoder", "campplus", "speaker"):
        a, b = (flatten_any(getattr(c, f"{name}_params")) for c in (tcv, back))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name
    bare = checkpoints.load(checkpoints.save(
        P.Converter(TCFG2, tcv.tokenizer_params, tcv.vocoder_params, tcv.arvc_params,
                    tcv.device), str(tmp_path / "bare")), TCFG2, device="cpu")
    assert bare.campplus_params is None and bare.speaker_params is None

    trainer = port_trainer(tmp_path / "run", log_interval=1, save_interval=2)
    dcfg = data.DataConfig(batch_size=2)
    trainer.train(data.batches(data.synthetic_dataset(dcfg, frames=(4, 6)), dcfg),
                  max_steps=3)
    assert trainer.state.step == 3
    recs = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in recs)
    assert os.path.isdir(tmp_path / "run" / "ckpt_2")
    trainer.save_checkpoint()  # ckpt_3; keep_last=1 rotates ckpt_2 out
    assert sorted(d for d in os.listdir(tmp_path / "run") if d.startswith("ckpt_")) == [
        "ckpt_3"]
    trainer.log_audio_sample(next(data.batches(data.synthetic_dataset(dcfg, seed=9,
                                                                      frames=(4, 6)), dcfg)))

    fresh = port_trainer(tmp_path / "run")
    assert fresh.state.step == 0
    assert fresh.resume_latest() == str(tmp_path / "run" / "ckpt_3")
    assert fresh.state.step == 3
    a, b = flatten(trainer.state.params), flatten(fresh.state.params)
    assert all(torch.equal(a[k], b[k]) for k in a)
    fresh.load_checkpoint(trainer.save_checkpoint(str(tmp_path / "run" / "ckpt_x"), 0))
    assert fresh.state.step == 0  # no step in the name


def flatten_any(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_any(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_any(v, prefix + (i,)))
        return out
    return {prefix: tree}


def test_model_shards_raise(tmp_path):
    """`n_model_shards=2` no longer raises: in two gloo processes (a 1 x 2
    mesh, tests/torch_mesh.py) three steps match the one-process trainer's
    (losses and norms within 1e-5, the gathered checkpoint within 1e-5 of
    each leaf's largest magnitude); one process without a process group
    cannot split the LM and says so."""
    from torch_mesh import run_ranks

    t = trees()
    delays = [0, 3, 0]
    inputs = {"trainer_step": {
        "cfg": TCFG2, "trees": {"arvc_params": arvc_np(), "tokenizer_params":
                                t["tokenizer_params"], "vocoder_params": t["vocoder_params"]},
        "batch": batch_np(), "delays": delays, "tcfg": {}, "log_dir": str(tmp_path / "mesh")}}
    ranks = run_ranks(["trainer_step"], 2, inputs, tmp_path / "ranks")
    trainer = port_trainer(tmp_path / "one")
    want = [{k: float(v) for k, v in trainer._step(port_batch(), d).items()} for d in delays]
    for r, res in enumerate(ranks):
        out = res["trainer_step"]
        assert out["mesh"] == (1, 2, r)
        for got, w in zip(out["aux"], want):
            for k in w:
                np.testing.assert_allclose(got[k], w[k], rtol=1e-5, err_msg=k)
    saved = flatten(torch.load(f"{ranks[0]['trainer_step']['ckpt']}/arvc.pt",
                               weights_only=True))
    for k, p in flatten(trainer.state.params).items():
        w = p.detach()
        torch.testing.assert_close(saved[k], w, rtol=0, atol=1e-5 * float(w.abs().max()),
                                   msg=str(k))
    with pytest.raises(ValueError, match="initialized process group"):
        port_trainer(tmp_path / "alone", n_model_shards=2)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_data_pipeline_matches_jax():
    cfg, jcfg = data.DataConfig(batch_size=3), jdata.DataConfig(batch_size=3)
    got = list(zip(range(7), data.synthetic_dataset(cfg, seed=5)))
    want = list(zip(range(7), jdata.synthetic_dataset(jcfg, seed=5)))
    for (_, g), (_, w) in zip(got, want):
        _same(g, w)
    for n in (2, 3):
        _same(data.collate([g for _, g in got[:n]]), jdata.collate([w for _, w in want[:n]]))
    gb = list(zip(range(2), data.batches(data.synthetic_dataset(cfg, seed=6), cfg)))
    wb = list(zip(range(2), jdata.batches(jdata.synthetic_dataset(jcfg, seed=6), jcfg)))
    for (_, g), (_, w) in zip(gb, wb):
        _same(g, w)
    srcs = lambda: [range(0, 5), range(100, 103), range(200, 209)]
    assert list(data.mix_corpora(srcs(), [0.5, 0.2, 0.3], seed=3)) == list(
        jdata.mix_corpora(srcs(), [0.5, 0.2, 0.3], seed=3))

    bad = lambda: iter(_Raising([1, "err", 2, "err", "err", 3]))
    assert list(data.skip_errors(bad())) == list(jdata.skip_errors(bad())) == [1, 2, 3]
    with pytest.raises(ZeroDivisionError):
        list(data.skip_errors(iter(_Raising(["err"] * 3)), max_consecutive=2))


class _Raising:
    """An iterator whose "err" items raise instead of being returned."""

    def __init__(self, items):
        self.items = list(items)

    def __iter__(self):
        return self

    def __next__(self):
        if not self.items:
            raise StopIteration
        x = self.items.pop(0)
        if x == "err":
            raise ZeroDivisionError
        return x


def test_attach_text_ids_matches_jax():
    samples = [{"wave": np.zeros(4, np.float32), "text": " Hello, ‘world’ 😀!! ",
                "language": "en"},
               {"wave": np.zeros(4, np.float32), "text": "今天是2024年5月3日，气温25%",
                "language": "zh"},
               {"wave": np.zeros(4, np.float32), "text": "la " * 40, "language": "en-us"},
               {"wave": np.zeros(4, np.float32)}]
    from streamvoiceanon_tpu.train.text import TextTokenizer as JTok

    from streamvoiceanon_tpu_torch.train.text import TextTokenizer

    got = list(data.attach_text_ids(iter([dict(s) for s in samples]), TextTokenizer()))
    want = list(jdata.attach_text_ids(iter([dict(s) for s in samples]), JTok()))
    assert len(got) == len(want) == 3  # the looping transcript is skipped
    for g, w in zip(got, want):
        _same(g, w)
    _same(data.collate(got[:2]), jdata.collate(want[:2]))
