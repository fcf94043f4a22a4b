"""The port's dual-AR frame decode at batch 2 against the JAX package, on
the CPU, on every dispatch path of `decode_frame`.

Both packages decode 3 frames after a 12-token prefill on the same weights
(the JAX package's `random_params`), float32 caches:

* flags off (`PipelineConfig()`'s decoder): the plain layer loop, the
  windowed sampler and the plain codebook loop;
* GQA in both stacks (4 query heads on 2 key/value heads), plain;
* a tied output head, and an output head with a bias;
* `use_pallas_slow_decode` at batch 2: the slow kernel does not run, the
  plain layer loop runs on the flat rows (JAX likewise);
* `per_head_decode`'s flags at batch 2: the decode attention over 2 x H
  heads, JAX's Pallas kernel in interpret mode on its 128-lane padded
  cache against the port's plain version; the codebook loop plain (the
  fast kernel runs at batch 1 only, in both packages).

Sampled cases feed the port the Gumbel noise JAX draws: the semantic row
of batch row b from `split(k_sem, B)[b]`, the codebook row of step s and
batch row b from `split(split(k_fast, nq)[s], B)[b]`.  Semantic tokens,
codes and truncation counts are exact; audio embeddings and caches agree
to atol = rtol = 1e-4 (XLA on the CPU and ATen sum in different orders).
"""

from dataclasses import replace as drep

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.models import arvc as jarvc
from streamvoiceanon_tpu.models import dual_ar as jdar
from streamvoiceanon_tpu.utils import tiny as tiny_util
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import arvc as tarvc
from streamvoiceanon_tpu_torch.models import dual_ar as tdar

B = 2
FRAMES = 3
TOL = dict(atol=1e-4, rtol=1e-4)
GREEDY = JC.SamplingConfig(greedy=True)
SAMPLED = JC.SamplingConfig(temperature=0.9, top_p=0.7, greedy=False, top_k_window=64)
BASE = tiny_util.tiny_config().arvc.decoder
GQA = dict(n_head=4, n_local_heads=2, head_dim=8, fast_n_head=4, fast_n_local_heads=2,
           fast_head_dim=8)
CASES = {
    "flags_off": BASE,
    "gqa": drep(BASE, **GQA),
    "tied": drep(BASE, tie_word_embeddings=True),
    "biased": BASE,
    "flat_b2": drep(BASE, use_pallas_slow_decode=True, use_pallas_fast_decode=True),
    "per_head_b2": drep(BASE, use_pallas_decode=True, use_pallas_fast_decode=True),
}


def _np(x):
    return np.asarray(x)


def _params(jcfg, seed: int = 0, bias: bool = False):
    raw = jdar.random_params(jax.random.PRNGKey(seed), jcfg)
    if bias:
        raw["output"]["b"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                               (jcfg.vocab_size,)) * 0.5
    return jdar.prepare_params(raw), P.dual_ar_params(jax.tree.map(np.asarray, raw), "cpu")


def _gumbel(key, n: int) -> np.ndarray:
    return _np(jax.random.gumbel(key, (n,), jnp.float32))


def frame_noise(key, sem_shape, fast_shape):
    """The Gumbel rows JAX's `decode_frame` draws from `key` at batch B on
    its windowed (vmapped) samplers, in the port's input shapes."""
    (b, n_sem), (_, nq, n_fast) = sem_shape, fast_shape
    k_sem, k_fast = jax.random.split(key)
    gs = np.stack([_gumbel(k, n_sem) for k in jax.random.split(k_sem, b)])
    gf = np.stack([np.stack([_gumbel(k, n_fast) for k in jax.random.split(ks, b)])
                   for ks in jax.random.split(k_fast, nq)], axis=1)
    return torch.from_numpy(gs), torch.from_numpy(gf)


def _check_caches(ts, js, hd):
    jk, jv = _np(js.k_cache), _np(js.v_cache)
    if jk.ndim == 5:  # JAX pads the per-head cache for its kernel
        assert not np.any(jk[..., hd:]) and not np.any(jv[..., hd:])
        jk, jv = jk[..., :hd], jv[..., :hd]
    assert ts.k_cache.shape == jk.shape
    np.testing.assert_allclose(ts.k_cache.numpy(), jk, **TOL)
    np.testing.assert_allclose(ts.v_cache.numpy(), jv, **TOL)


def _prefill(jcfg, jp, tcfg, tp, rng, n=12):
    emb = rng.standard_normal((B, n, jcfg.dim)).astype(np.float32)
    js, jh = jdar.prefill(jp, jcfg, jdar.init_state(jcfg, B, jnp.float32), jnp.asarray(emb),
                          jnp.int32(n))
    ts, th = tdar.prefill(tp, tcfg, tdar.init_state(tcfg, B, torch.float32),
                          torch.from_numpy(emb))
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    return js, ts


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_frame_batch2_matches_jax(case, sampling):
    jcfg = CASES[case]
    tcfg = C.from_fields(jcfg)
    jp, tp = _params(jcfg, bias=case == "biased")
    assert ("b" in tp.get("output", {})) == (case == "biased")
    assert ("output" in tp) != (case == "tied")
    rng = np.random.default_rng(40)
    js, ts = _prefill(jcfg, jp, tcfg, tp, rng)
    tsamp = C.from_fields(sampling)
    sem_shape, fast_shape = tdar.frame_noise_shapes(tp, tcfg, tsamp, B)
    assert sem_shape == (B, 64) and fast_shape == (B, jcfg.num_codebooks, 64)
    assert not tdar.slow_kernel_runs(tp, tcfg, B) and not tdar.fast_kernel_runs(tcfg, B)
    step = jax.jit(jdar.decode_frame, static_argnums=(1, 5))
    for f in range(FRAMES):
        emb2 = rng.standard_normal((B, 2, jcfg.dim)).astype(np.float32)
        key = jax.random.PRNGKey(70 + f)
        js, jsem, jcodes, jemb = step(jp, jcfg, js, jnp.asarray(emb2), key, sampling)
        gs = gf = None
        if not sampling.greedy:
            gs, gf = frame_noise(key, sem_shape, fast_shape)
        ts, tsem, tcodes, temb = tdar.decode_frame(tp, tcfg, ts, torch.from_numpy(emb2),
                                                   tsamp, gs, gf)
        assert tsem.dtype == torch.int32 and tcodes.dtype == torch.int32
        np.testing.assert_array_equal(tsem.numpy(), _np(jsem))
        np.testing.assert_array_equal(tcodes.numpy(), _np(jcodes))
        assert temb.shape == (B, 1, jcfg.dim)
        np.testing.assert_allclose(temb.numpy(), _np(jemb), **TOL)
        assert int(ts.trunc) == int(js.trunc)
    assert ts.pos == int(js.pos) == 12 + 2 * FRAMES
    if not sampling.greedy:
        assert int(ts.trunc) > 0  # the random LM's window holds < top_p
    _check_caches(ts, js, jcfg.head_dim)


def test_per_head_kernel_path_with_gqa_raises_as_jax_does():
    """`use_pallas_decode` with GQA: the JAX package refuses it while
    tracing, the port when the layer loop starts."""
    jcfg = drep(BASE, use_pallas_decode=True, **GQA)
    tcfg = C.from_fields(jcfg)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(41)
    js, ts = _prefill(jcfg, jp, tcfg, tp, rng)
    emb2 = rng.standard_normal((B, 2, jcfg.dim)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="GQA"):
        jdar.decode_frame(jp, jcfg, js, jnp.asarray(emb2), jax.random.PRNGKey(0), GREEDY)
    with pytest.raises(NotImplementedError, match="GQA"):
        tdar.decode_frame(tp, tcfg, ts, torch.from_numpy(emb2), C.from_fields(GREEDY))


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "per_head"])
def test_init_state_and_convert_cache_layout_batch2(flat):
    """init_state at batch 2 in either layout, and the conversion each way
    equal to JAX's (its per-head cache padded when the kernel owns it)."""
    jcfg = drep(BASE, use_pallas_slow_decode=flat, use_pallas_decode=not flat)
    tcfg = C.from_fields(jcfg)
    jp, tp = _params(jcfg)
    js, ts = _prefill(jcfg, jp, tcfg, tp, np.random.default_rng(42))
    assert ts.k_cache.shape[1] == B and ts.k_cache.ndim == (4 if flat else 5)
    other_j = drep(jcfg, use_pallas_slow_decode=not flat, use_pallas_decode=flat)
    other_t = C.from_fields(other_j)
    jo, to = jdar.convert_cache_layout(js, other_j), tdar.convert_cache_layout(ts, other_t)
    assert to.pos == ts.pos and to.k_cache.shape[1] == B
    _check_caches(to, jo, jcfg.head_dim)
    back = tdar.convert_cache_layout(to, tcfg)
    assert torch.equal(back.k_cache, ts.k_cache) and torch.equal(back.v_cache, ts.v_cache)


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("flags", ["flags_off", "per_head_b2"])
def test_decode_one_batch2_after_prompt_and_delay_prefill(flags, sampling):
    """arvc at batch 2: prefill_prompt -> prefill_src_condition4delay ->
    3 x decode_one, codes exact, caches and audio slot close."""
    cfg = tiny_util.tiny_config()
    jparams = tiny_util._random_arvc(jax.random.split(jax.random.PRNGKey(0), 3)[2], cfg.arvc)
    jcfg = drep(cfg.arvc, decoder=CASES[flags])
    tcfg = C.from_fields(jcfg)
    tp = P.arvc_params(jax.tree.map(np.asarray, jparams), "cpu")
    d = jcfg.decoder
    rng = np.random.default_rng(43)
    delay, Tp = 2, 6
    ref_tok = rng.integers(0, d.vocab_size, (B, Tp)).astype(np.int32)
    ref_codes = rng.integers(0, d.codebook_size, (B, d.num_codebooks, Tp)).astype(np.int32)
    src = rng.integers(0, d.vocab_size, (B, delay + FRAMES)).astype(np.int32)
    style = rng.standard_normal((B, 192)).astype(np.float32)
    timbre = rng.standard_normal((B, 32, 128)).astype(np.float32)
    js = jarvc.prefill_prompt(jparams, jcfg, jnp.asarray(ref_tok), jnp.asarray(ref_codes),
                              jnp.asarray(style), jnp.asarray(timbre), delay)
    ts = tarvc.prefill_prompt(tp, tcfg, torch.from_numpy(ref_tok),
                              torch.from_numpy(ref_codes), torch.from_numpy(style),
                              torch.from_numpy(timbre), delay)
    js = jarvc.prefill_src_condition4delay(jparams, jcfg, js, jnp.asarray(src[:, :delay]),
                                           delay)
    ts = tarvc.prefill_src_condition4delay(tp, tcfg, ts, torch.from_numpy(src[:, :delay]),
                                           delay)
    tsamp = C.from_fields(sampling)
    shapes = tdar.frame_noise_shapes(tp["model"], tcfg.decoder, tsamp, B)
    for f in range(FRAMES):
        key = jax.random.PRNGKey(90 + f)
        tok = src[:, delay + f : delay + f + 1]
        js, jcodes = jarvc.decode_one(jparams, jcfg, js, jnp.asarray(tok), key, sampling)
        gs = gf = None
        if not sampling.greedy:
            gs, gf = frame_noise(key, *shapes)
        ts, tcodes = tarvc.decode_one(tp, tcfg, ts, torch.from_numpy(tok), tsamp, gs, gf)
        assert tcodes.shape == (B, d.num_codebooks)
        np.testing.assert_array_equal(tcodes.numpy(), _np(jcodes))
    assert ts.decode.pos == int(js.decode.pos)
    assert int(ts.decode.trunc) == int(js.decode.trunc)
    _check_caches(ts.decode, js.decode, d.head_dim)
    np.testing.assert_allclose(ts.audio_emb.numpy(), _np(js.audio_emb), **TOL)


def test_frame_noise_shapes_follow_the_samplers_that_run():
    """Full rows where a kernel's exact sampler runs (batch 1 with its
    flag), window rows where the windowed one does."""
    d = C.DualARConfig()
    samp = C.SamplingConfig(top_k_window=64)
    untied = {"output": {"w": None}}
    kernels = C.replace(d, use_pallas_slow_decode=True, use_pallas_fast_decode=True)
    assert tdar.frame_noise_shapes(untied, kernels, samp, 1) == ((1, 8192), (1, 8, 1000))
    assert tdar.frame_noise_shapes(untied, kernels, samp, 3) == ((3, 64), (3, 8, 64))
    assert tdar.frame_noise_shapes({"output": {"w": None, "b": None}}, kernels, samp,
                                   1) == ((1, 64), (1, 8, 1000))
    assert tdar.frame_noise_shapes(untied, d, samp, 1) == ((1, 64), (1, 8, 64))
    full = C.SamplingConfig(top_k_window=0)
    assert tdar.frame_noise_shapes(untied, d, full, 2) == ((2, 8192), (2, 8, 1000))
