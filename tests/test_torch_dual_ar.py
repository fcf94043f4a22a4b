"""The port's dual-AR LM and its two decode kernels' plain versions against
the JAX package, on the CPU.

JAX runs with use_pallas_slow_decode and use_pallas_fast_decode on, its
Pallas kernels interpreted on the CPU (as tests/test_pallas_slow_decode.py
runs them); the port runs the plain versions its wrappers take for CPU
tensors.  Sampled cases feed the port the Gumbel noise the JAX kernels draw
from their keys.  Tokens and codes must be exact; float32 tensors agree to
atol = rtol = 1e-4 (XLA on the CPU and ATen sum in different orders).
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
from streamvoiceanon_tpu.ops.pallas_fast_decode import fast_decode as j_fast
from streamvoiceanon_tpu.ops.pallas_slow_decode import slow_decode_step as j_slow
from streamvoiceanon_tpu.utils import tiny as tiny_util
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import arvc as tarvc
from streamvoiceanon_tpu_torch.models import dual_ar as tdar
from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode
from streamvoiceanon_tpu_torch.ops.slow_decode import slow_decode_step
from streamvoiceanon_tpu_torch.utils import randparams as rp

TOL = dict(atol=1e-4, rtol=1e-4)
GREEDY = JC.SamplingConfig(greedy=True)
SAMPLED = JC.SamplingConfig(temperature=0.9, top_p=0.7, greedy=False, top_k_window=0)


@pytest.fixture(scope="module")
def tiny():
    """The ARVC weights of tiny_converter(seed=0), built without its
    tokenizer and vocoder (which these tests do not use)."""
    cfg = tiny_util.tiny_config()
    jparams = tiny_util._random_arvc(jax.random.split(jax.random.PRNGKey(0), 3)[2], cfg.arvc)
    jcfg = drep(cfg.arvc, decoder=drep(cfg.arvc.decoder, use_pallas_slow_decode=True,
                                       use_pallas_fast_decode=True))
    tparams = P.arvc_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, C.from_fields(jcfg), tparams


def _np(x):
    return np.asarray(x)


def _slow_gumbel(key, vocab):
    """The Gumbel row slow_decode_step draws from `key`."""
    return np.array(jax.random.gumbel(jax.random.split(key, 1)[0], (1, vocab), jnp.float32))


def _fast_gumbel(key, nq, vocab):
    """The (1, nq, vocab) Gumbel block fast_decode draws from `key` at batch 1."""
    ks = jax.random.split(key, nq)
    return np.stack([_np(jax.random.gumbel(jax.random.split(k, 1)[0], (vocab,),
                                           jnp.float32)) for k in ks])[None]


def _prefilled(jcfg, jp, tcfg, tp, rng, n=12):
    emb = rng.standard_normal((1, n, jcfg.decoder.dim)).astype(np.float32)
    js, _ = jdar.prefill(jp["model"], jcfg.decoder,
                         jdar.init_state(jcfg.decoder, 1, jnp.float32),
                         jnp.asarray(emb), jnp.int32(n))
    ts, _ = tdar.prefill(tp["model"], tcfg.decoder,
                         tdar.init_state(tcfg.decoder, 1, torch.float32), torch.from_numpy(emb))
    return js, ts


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "per_head"])
def test_init_state_default_cache_dtype_matches_jax(tiny, flat):
    """Both packages default the KV cache to bf16, on either layout."""
    jcfg, _, tcfg, _ = tiny
    jd = drep(jcfg.decoder, use_pallas_slow_decode=flat)
    td = drep(tcfg.decoder, use_pallas_slow_decode=flat)
    js, ts = jdar.init_state(jd, 1), tdar.init_state(td, 1, device="meta")
    assert js.k_cache.dtype == jnp.bfloat16 and js.v_cache.dtype == jnp.bfloat16
    assert ts.k_cache.dtype == ts.v_cache.dtype == torch.bfloat16
    assert ts.k_cache.shape == js.k_cache.shape or not flat


def test_prefill_flat_layout_matches(tiny, rng):
    """Two chained prefills: flat caches, position and last hidden."""
    jcfg, jp, tcfg, tp = tiny
    d = jcfg.decoder
    js, ts = _prefilled(jcfg, jp, tcfg, tp, rng)
    emb = rng.standard_normal((1, 7, d.dim)).astype(np.float32)
    js, jh = jdar.prefill(jp["model"], d, js, jnp.asarray(emb), jnp.int32(7))
    ts, th = tdar.prefill(tp["model"], tcfg.decoder, ts, torch.from_numpy(emb))
    assert ts.pos == int(js.pos) == 19
    np.testing.assert_allclose(ts.k_cache.numpy(), _np(js.k_cache), **TOL)
    np.testing.assert_allclose(ts.v_cache.numpy(), _np(js.v_cache), **TOL)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_slow_step_matches_jax_kernel(tiny, rng, sampling):
    jcfg, jp, tcfg, tp = tiny
    d = jcfg.decoder
    js, ts = _prefilled(jcfg, jp, tcfg, tp, rng)
    m = jp["model"]
    for i in range(3):
        x2 = rng.standard_normal((2, d.dim)).astype(np.float32)
        key = jax.random.PRNGKey(40 + i)
        pos = 12 + 2 * i
        jx, jk, jv, jtok = j_slow(
            m["layers"], jnp.asarray(x2), js.k_cache[:, 0], js.v_cache[:, 0],
            jnp.int32(pos), m["norm"]["w"], m["output"]["w"], key, n_head=d.n_head,
            head_dim=d.head_dim, max_seq_len=d.max_seq_len, rope_base=d.rope_base,
            norm_eps=d.norm_eps, temperature=sampling.temperature, top_p=sampling.top_p,
            greedy=sampling.greedy, interpret=True)
        gum = None if sampling.greedy else torch.from_numpy(_slow_gumbel(key, d.vocab_size))
        tx, tk, tv, ttok = slow_decode_step(
            tp["model"]["layers"], torch.from_numpy(x2), ts.k_cache[:, 0],
            ts.v_cache[:, 0], pos, tp["model"]["norm"]["w"], tp["model"]["output"]["w"],
            gum, n_head=d.n_head, head_dim=d.head_dim, rope_base=d.rope_base,
            norm_eps=d.norm_eps, temperature=sampling.temperature, top_p=sampling.top_p,
            greedy=sampling.greedy)
        assert ttok.dtype == torch.int32 and int(ttok[0]) == int(jtok[0])
        np.testing.assert_allclose(tx.numpy(), _np(jx), **TOL)
        np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)
        # fold the fresh rows in, as decode_frame does
        js = js._replace(k_cache=js.k_cache.at[:, 0, pos : pos + 2].set(jk),
                         v_cache=js.v_cache.at[:, 0, pos : pos + 2].set(jv))
        ts.k_cache[:, 0, pos : pos + 2] = tk
        ts.v_cache[:, 0, pos : pos + 2] = tv


def test_slow_step_ignores_stale_cache_rows(tiny, rng):
    """Slots at and beyond pos are never attended: poisoning them changes
    nothing, and the clean result still equals JAX's."""
    jcfg, jp, tcfg, tp = tiny
    d = jcfg.decoder
    js, ts = _prefilled(jcfg, jp, tcfg, tp, rng, n=10)
    x2 = rng.standard_normal((2, d.dim)).astype(np.float32)
    m = tp["model"]

    def run(kc, vc):
        return slow_decode_step(m["layers"], torch.from_numpy(x2), kc, vc, 10,
                                m["norm"]["w"], m["output"]["w"], None, n_head=d.n_head,
                                head_dim=d.head_dim, greedy=True)

    clean = run(ts.k_cache[:, 0], ts.v_cache[:, 0])
    kp, vp = ts.k_cache[:, 0].clone(), ts.v_cache[:, 0].clone()
    kp[:, 10:], vp[:, 10:] = 37.0, -54.0
    poisoned = run(kp, vp)
    for a, b in zip(clean, poisoned):
        assert torch.equal(a, b)
    jx, _, _, jtok = j_slow(
        jp["model"]["layers"], jnp.asarray(x2), js.k_cache[:, 0], js.v_cache[:, 0],
        jnp.int32(10), jp["model"]["norm"]["w"], jp["model"]["output"]["w"],
        jax.random.PRNGKey(0), n_head=d.n_head, head_dim=d.head_dim,
        max_seq_len=d.max_seq_len, greedy=True, interpret=True)
    assert int(clean[3][0]) == int(jtok[0])
    np.testing.assert_allclose(clean[0].numpy(), _np(jx), **TOL)


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_fast_loop_matches_jax_kernel(tiny, rng, sampling):
    jcfg, jp, tcfg, tp = tiny
    d = jcfg.decoder
    m, tm = jp["model"], tp["model"]
    for i in range(3):
        hidden = rng.standard_normal((1, d.fast_dim)).astype(np.float32)
        key = jax.random.PRNGKey(70 + i)
        jcodes, jaemb = j_fast(
            m["fast_layers"], m["fast_norm"]["w"], m["fast_output"]["w"],
            m["fast_embeddings"], m["codebook_embeddings"], jnp.asarray(hidden), key,
            nq=d.num_codebooks, n_head=d.fast_n_head, head_dim=d.fast_head_dim,
            vocab=d.codebook_size, rope_base=d.rope_base, norm_eps=d.norm_eps,
            temperature=sampling.temperature, top_p=sampling.top_p,
            greedy=sampling.greedy, interpret=True)
        gum = None if sampling.greedy else torch.from_numpy(
            _fast_gumbel(key, d.num_codebooks, d.codebook_size))
        tcodes, taemb = fast_decode(
            tm["fast_layers"], tm["fast_norm"]["w"], tm["fast_output"]["w"],
            tm["fast_embeddings"], tm["codebook_embeddings"], torch.from_numpy(hidden),
            gum, nq=d.num_codebooks, n_head=d.fast_n_head, head_dim=d.fast_head_dim,
            rope_base=d.rope_base, norm_eps=d.norm_eps,
            temperature=sampling.temperature, top_p=sampling.top_p,
            greedy=sampling.greedy)
        np.testing.assert_array_equal(tcodes.numpy(), _np(jcodes))
        np.testing.assert_allclose(taemb.numpy(), _np(jaemb), **TOL)


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_decode_one_after_prompt_and_delay_prefill(tiny, rng, sampling):
    """prefill_prompt -> prefill_src_condition4delay -> 4 x decode_one."""
    jcfg, jp, tcfg, tp = tiny
    d = jcfg.decoder
    delay, Tp = 2, 6
    ref_tok = rng.integers(0, d.vocab_size, (1, Tp)).astype(np.int32)
    ref_codes = rng.integers(0, d.codebook_size, (1, d.num_codebooks, Tp)).astype(np.int32)
    src = rng.integers(0, d.vocab_size, (1, delay + 4)).astype(np.int32)
    style = rng.standard_normal((1, 192)).astype(np.float32)
    timbre = rng.standard_normal((1, 32, 128)).astype(np.float32)
    js = jarvc.prefill_prompt(jp, jcfg, jnp.asarray(ref_tok), jnp.asarray(ref_codes),
                              jnp.asarray(style), jnp.asarray(timbre), delay)
    ts = tarvc.prefill_prompt(tp, tcfg, torch.from_numpy(ref_tok),
                              torch.from_numpy(ref_codes), torch.from_numpy(style),
                              torch.from_numpy(timbre), delay)
    js = jarvc.prefill_src_condition4delay(jp, jcfg, js, jnp.asarray(src[:, :delay]), delay)
    ts = tarvc.prefill_src_condition4delay(tp, tcfg, ts, torch.from_numpy(src[:, :delay]),
                                           delay)
    assert ts.decode.pos == int(js.decode.pos)
    tsamp = C.from_fields(sampling)
    for f in range(4):
        key = jax.random.PRNGKey(90 + f)
        tok = src[:, delay + f : delay + f + 1]
        js, jcodes = jarvc.decode_one(jp, jcfg, js, jnp.asarray(tok), key, sampling)
        gs = gf = None
        if not sampling.greedy:
            k_sem, k_fast = jax.random.split(key)
            gs = torch.from_numpy(_slow_gumbel(k_sem, d.vocab_size))
            gf = torch.from_numpy(_fast_gumbel(k_fast, d.num_codebooks, d.codebook_size))
        ts, tcodes = tarvc.decode_one(tp, tcfg, ts, torch.from_numpy(tok), tsamp, gs, gf)
        np.testing.assert_array_equal(tcodes.numpy(), _np(jcodes))
    assert ts.decode.pos == int(js.decode.pos)
    np.testing.assert_allclose(ts.decode.k_cache.numpy(), _np(js.decode.k_cache), **TOL)
    np.testing.assert_allclose(ts.audio_emb.numpy(), _np(js.audio_emb), **TOL)


def test_published_width_greedy_decode_matches_jax():
    """The published dual-AR width (12 x 768, fast 4 x 768, vocab 8192),
    cache cut to 128 rows: JAX's plain XLA path (per-head cache, flags off)
    against the port's plain path, greedy, after a 40-token prompt."""
    d = JC.DualARConfig(max_seq_len=128)
    raw = rp.dual_ar_params_np(C.from_fields(d), seed=4)
    jp = jax.tree.map(jnp.asarray, raw)
    tcfg = C.from_fields(drep(d, use_pallas_slow_decode=True, use_pallas_fast_decode=True))
    tp = P.dual_ar_params(raw, "cpu")
    rng = np.random.default_rng(2)
    prompt = rng.standard_normal((1, 40, d.dim)).astype(np.float32)
    js, _ = jdar.prefill(jp, d, jdar.init_state(d, 1, jnp.float32), jnp.asarray(prompt),
                         jnp.int32(40))
    ts, _ = tdar.prefill(tp, tcfg, tdar.init_state(tcfg, 1, torch.float32),
                         torch.from_numpy(prompt))
    step = jax.jit(jdar.decode_frame, static_argnums=(1, 5))
    for f in range(3):
        emb2 = rng.standard_normal((1, 2, d.dim)).astype(np.float32)
        js, jsem, jcodes, _ = step(jp, d, js, jnp.asarray(emb2), jax.random.PRNGKey(f),
                                   GREEDY)
        ts, tsem, tcodes, _ = tdar.decode_frame(tp, tcfg, ts, torch.from_numpy(emb2),
                                                C.SamplingConfig(greedy=True))
        assert int(tsem[0]) == int(jsem[0])
        np.testing.assert_array_equal(tcodes.numpy(), _np(jcodes))
