"""The port's content-encoder trainer (`train/asr_trainer.py`) against the
JAX package's, on the CPU at the tiny geometry of
`tests/test_asr_trainer.py` (the recognisers are in
`tests/test_torch_asr_eval.py`).

Both sides start from JAX's initial draws (carried over by
`streamvoiceanon_tpu_torch.params`) and read the same numpy batches.
Losses per step within 1e-4 relative; gradients of the quantizer's input
side exactly zero in both packages, and those leaves equal to their start
times (1 - lr wd)^steps, AdamW's decoupled decay alone; every trained leaf
within 1e-4 of max(its largest value, 1) (`_close_trained`).
The port's step is eager autograd, JAX's one jitted `value_and_grad`:
they agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.models import asr_decoder as jad
from streamvoiceanon_tpu.models import tokenizer as jtok
from streamvoiceanon_tpu.train.asr_trainer import ASRTrainer as JTrainer
from streamvoiceanon_tpu.train.asr_trainer import ASRTrainerConfig as JTrainerConfig
from streamvoiceanon_tpu.utils.tiny import tiny_config
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import asr_decoder as tad
from streamvoiceanon_tpu_torch.train.asr_trainer import ASRTrainer, ASRTrainerConfig
from streamvoiceanon_tpu_torch.utils.tree import flatten

REL = 1e-4
NOISE = 1e-6  # a gradient below this share of its leaf's largest is rounding
SPF = 2048
ACFG = dict(hidden_dim=32, num_heads=2, depth=1, block_size=128, in_channels=32, n_vocab=60,
            bos_id=50, eos_id=49)
# the quantizer's input side: no loss reaches it (no straight-through sign)
NO_GRADIENT = ("backbone", "downsample", "pre_module")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_trained(got, want, grads, lr, steps, what="", rounding=(), init=None):
    """The port's trained leaves `got` against JAX's `want` (flat, by path):
    each within REL of max(max|w|, 1), as `_close_tree` in
    tests/test_torch_evals.py.

    AdamW moves an element by about lr a step whatever the size of its
    gradient, so where JAX's gradient of an element at a step is rounding
    (below NOISE of the largest of its leaf at that step), the sign of that
    step's move is rounding's, in either package: such an element may
    differ by a further 2 lr for each such step.  `grads` are JAX's
    gradients step by step (flat, in the port's layout, from
    `recorded_jax_grads`), `lr(path)` the learning rate of a leaf.  The
    leaves named in `rounding` (softmax key biases: the softmax ignores a
    shift shared by every key) have a gradient that is zero but for
    rounding at every step: JAX's is checked to be below NOISE of the
    model's largest, and both packages' moves from `init` are held within
    lr a step."""
    assert got.keys() == want.keys(), what
    top = [max(float(np.abs(g).max()) for g in step.values()) for step in grads]
    for k, w in want.items():
        w, g, rate = np.asarray(w), got[k].detach().numpy(), lr(k)
        noisy = np.zeros(w.shape, np.int64)
        for step, m in zip(grads, top):
            gk = np.abs(step[k])
            if k in rounding:
                assert gk.max() <= NOISE * m, (what, k, gk.max(), m)
                noisy += 1
            elif gk.max() > 0:  # an exact zero moves by the decay alone
                noisy += gk <= NOISE * gk.max()
        assert len(grads) == steps and (k not in rounding or noisy.min() == steps), (what, k)
        bound = REL * max(np.abs(w).max(), 1.0) + 2 * rate * noisy
        assert (np.abs(g - w) <= bound).all(), (
            f"{what} {k}: largest error {np.abs(g - w).max():.3e}, "
            f"{int((np.abs(g - w) > bound).sum())} of {w.size} elements past the bound")
        if k in rounding:
            for t in (g, w):
                assert np.abs(t - init[k].numpy()).max() <= rate * steps * 1.01, (what, k)


def recorded_jax_grads(monkeypatch):
    """Record the gradients that reach every `optax.adamw` built from now
    on, as numpy trees in the order they arrive (one a step, or one a
    group and step under `multi_transform`)."""
    import optax

    real, out = optax.adamw, []

    def adamw(*a, **kw):
        inner = real(*a, **kw)

        def update(g, state, params=None):
            jax.debug.callback(lambda t: out.append(jax.tree.map(np.asarray, t)), g)
            return inner.update(g, state, params)

        return optax.GradientTransformation(inner.init, update)

    monkeypatch.setattr(optax, "adamw", adamw)
    return out


def grads_by_step(records, like, per_step, bridge):
    """`recorded_jax_grads`'s records -> JAX's gradients step by step, flat
    in the port's layout: the `per_step` records of a step (the groups of a
    `multi_transform`, each holding its own leaves) joined into a tree
    shaped as `like`, then through `bridge`, the parameters' own."""
    out = []
    for i in range(0, len(records), per_step):
        leaves = {}
        for r in records[i : i + per_step]:
            for path, leaf in jax.tree_util.tree_flatten_with_path(r)[0]:
                leaves[jax.tree_util.keystr(path)] = leaf
        paths, tdef = jax.tree_util.tree_flatten_with_path(like)
        tree = jax.tree_util.tree_unflatten(
            tdef, [leaves[jax.tree_util.keystr(p)] for p, _ in paths])
        out.append({k: v.numpy() for k, v in flatten(bridge(tree)).items()})
    return out


def _no_gradient(path) -> bool:
    return path[0] == "tokenizer" and (path[1] in NO_GRADIENT or path[1:3] == ("lfq", "project_in"))


# ---------------------------------------------------------------------------
# the content-encoder trainer
# ---------------------------------------------------------------------------


def _setup(gin: int = 0):
    cfg = tiny_config()
    tok_cfg = JC.replace(cfg.tokenizer, head=JC.ConvNeXtConfig(
        input_channels=32, depths=(1, 1), dims=(24, 40), gin_channels=gin))
    cfg = JC.replace(cfg, tokenizer=tok_cfg)
    acfg = jad.ASRDecoderConfig(**ACFG)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tok = _np(jtok.init(k1, tok_cfg, with_head=True))
    asr = _np(jad.init(k2, acfg))
    return cfg, acfg, tok, asr


def _batch(gin: int = 0, B=2, frames=6):
    rng = np.random.default_rng(0)
    teacher_T = frames * 4
    out = {
        "waves": rng.standard_normal((B, frames * SPF)).astype(np.float32) * 0.1,
        "teacher_feats": np.random.default_rng(1).standard_normal(
            (B, teacher_T, 40)).astype(np.float32),
        "teacher_lens": np.array([teacher_T, teacher_T - 4]),
        "latent_lens": np.array([frames, frames - 1]),
        "text": np.random.default_rng(2).integers(0, 40, (B, 5)),
        "text_lens": np.array([5, 4]),
    }
    if gin:
        out["style"] = np.random.default_rng(3).standard_normal((B, 1, gin)).astype(np.float32)
    return out


def _port_trainer(cfg, acfg, tok, asr, tcfg=None, **kw):
    return ASRTrainer(C.from_fields(cfg), tad.ASRDecoderConfig(**ACFG),
                      tcfg or ASRTrainerConfig(),
                      P.tokenizer_params(tok, "cpu", with_head=True),
                      P.asr_decoder_params(asr, "cpu"), device="cpu", **kw)


@pytest.mark.parametrize("gin", [0, 8])
def test_asr_trainer_three_steps_match_jax(gin, monkeypatch):
    """Three steps on one batch (with a style vector where the head takes
    one): the losses per step, then every trained leaf; the quantizer's
    input side, which no loss reaches, decayed by AdamW alone."""
    cfg, acfg, tok, asr = _setup(gin)
    batch = _batch(gin)
    lr, wd, steps = 1e-3, 0.01, 3
    records = recorded_jax_grads(monkeypatch)
    jt = JTrainer(cfg, acfg, JTrainerConfig(lr=lr), jax.tree.map(jnp.asarray, tok),
                  jax.tree.map(jnp.asarray, asr))
    tt = _port_trainer(cfg, acfg, tok, asr, ASRTrainerConfig(lr=lr))
    for step in range(steps):
        want, got = jt.train_step(batch), tt.train_step(batch)
        for k in ("loss", "s2s_loss", "l1_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=f"step {step} {k}")

    def port(tree):
        return {"tokenizer": P.tokenizer_params(tree["tokenizer"], "cpu", with_head=True),
                "asr": P.asr_decoder_params(tree["asr"], "cpu")}

    grads = grads_by_step(records, {"tokenizer": tok, "asr": asr}, 1, port)
    want_p = flatten(port(_np(jt.params)))
    got_p = flatten(tt.params)
    _close_trained(got_p, want_p, grads, lambda k: lr, steps, "trainer")
    init = flatten(port({"tokenizer": tok, "asr": asr}))
    zero = [k for k in init if _no_gradient(k)]
    assert len(zero) > 20
    for k in zero:
        decayed = init[k].numpy() * np.float32(1 - lr * wd) ** steps
        for name, t in (("port", got_p[k]), ("jax", want_p[k])):
            t = np.asarray(t.detach() if torch.is_tensor(t) else t)
            np.testing.assert_allclose(t, decayed, rtol=1e-6, atol=0, err_msg=f"{name} {k}")


def test_quantizer_input_side_has_exactly_zero_gradient_in_both_packages():
    """No straight-through estimator: the backbone, the downsample,
    pre_module and lfq.project_in get gradients that are exactly zero in
    JAX and in the port, while the post-quantization side and the decoder
    get gradients."""
    cfg, acfg, tok, asr = _setup()
    batch = _batch()
    tt = _port_trainer(cfg, acfg, tok, asr)
    grads = tt.step(tt.prepare(batch))["grads"]
    from streamvoiceanon_tpu.models import tokenizer as jtok_mod

    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        pred, vq = jtok_mod.forward(p["tokenizer"], cfg.tokenizer, jb["waves"],
                                    target_len=jb["teacher_feats"].shape[1])
        return jnp.mean(jnp.abs(pred - jb["teacher_feats"])) + jad.forward(
            p["asr"], acfg, vq["latents"], jb["latent_lens"], jb["text"], jb["text_lens"])

    jg = flatten(_torch(jax.jit(jax.grad(jloss))(jax.tree.map(
        jnp.asarray, {"tokenizer": tok, "asr": asr}))))
    zero = [k for k in grads if _no_gradient(k)]
    assert len(zero) > 20
    for k in zero:
        assert not grads[k].any(), k
    for k in (k for k in jg if _no_gradient(k)):
        assert not jg[k].any(), k
    live = [k for k in grads if not _no_gradient(k)]
    assert all(grads[k].abs().max() > 0 for k in live if k[1] in ("head", "post_module"))
    assert grads[("tokenizer", "lfq", "project_out", "w")].abs().max() > 0


def test_asr_trainer_from_the_dataloader():
    """A batch straight from the port's `train.data.batches` (transcripts
    tokenized in the pipeline, no hand-built text) with teacher features
    from `teacher_fn`, as JAX's `test_asr_trainer_from_dataloader`: the
    same batch through JAX's trainer gives the same losses."""
    from streamvoiceanon_tpu.train import data as jdata
    from streamvoiceanon_tpu.train.text import TextTokenizer as JText
    from streamvoiceanon_tpu_torch.train import data as tdata
    from streamvoiceanon_tpu_torch.train.text import TextTokenizer as TText

    cfg, acfg, tok, asr = _setup()
    ids = dict(bos_id=50528, eos_id=50527)
    big = dict(ACFG, block_size=2048, n_vocab=51866, **ids)
    acfg = jad.ASRDecoderConfig(**big)
    asr = _np(jad.init(jax.random.PRNGKey(4), acfg))

    def teacher_fn(waves, wave_lens):
        B, T = waves.shape
        n = T // SPF * 4
        feats = np.asarray(waves).reshape(B, T // 512, 512)[:, :n].mean(-1)
        return (np.repeat(feats[:, :n, None], 40, axis=-1).astype(np.float32),
                np.asarray(wave_lens) // 512)

    tb = next(tdata.batches(tdata.attach_text_ids(
        tdata.synthetic_dataset(tdata.DataConfig(batch_size=2), seed=0, frames=(4, 8)),
        TText(**ids)), tdata.DataConfig(batch_size=2)))
    jb = next(jdata.batches(jdata.attach_text_ids(
        jdata.synthetic_dataset(jdata.DataConfig(batch_size=2), seed=0, frames=(4, 8)),
        JText(**ids)), jdata.DataConfig(batch_size=2)))
    for k in ("waves", "wave_lens", "frame_lens", "text", "text_lens"):
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)
    tt = ASRTrainer(C.from_fields(cfg), tad.ASRDecoderConfig(**big), ASRTrainerConfig(),
                    P.tokenizer_params(tok, "cpu", with_head=True),
                    P.asr_decoder_params(asr, "cpu"), teacher_fn=teacher_fn, device="cpu")
    jt = JTrainer(cfg, acfg, JTrainerConfig(), jax.tree.map(jnp.asarray, tok),
                  jax.tree.map(jnp.asarray, asr), teacher_fn=teacher_fn)
    got, want = tt.train_step(tb), jt.train_step(jb)
    assert np.isfinite(got["loss"])
    for k in ("loss", "s2s_loss", "l1_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)
    with pytest.raises(ValueError, match="teacher_fn"):
        _port_trainer(cfg, jad.ASRDecoderConfig(**ACFG), tok, _setup()[3]).train_step(
            {k: v for k, v in _batch().items() if k != "teacher_feats"})
