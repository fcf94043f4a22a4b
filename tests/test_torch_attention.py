"""The port's per-head decode attention (ops/attention.py), the per-head KV
cache path of the dual-AR LM and the windowed sampler (ops/sampling.py)
against the JAX package, on the CPU.

JAX runs its Pallas `decode_attention` kernels with interpret=True (as
tests/test_pallas_attention.py does) and, inside `decode_frame` with
`use_pallas_decode`, on its 128-lane padded per-head cache; the port runs
its kernels' plain versions and keeps the cache unpadded, so caches are
compared on the true head dims and JAX's padding lanes must be zero.
Sampled cases feed the port the Gumbel noise JAX draws from its keys.
Tokens, codes and truncation counts are exact; attention outputs agree to
atol = rtol = 1e-5, new cache rows exactly; the LM's float32 states to
atol = rtol = 1e-4 (XLA on the CPU and ATen sum in different orders).
"""

from dataclasses import replace as drep

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.models import dual_ar as jdar
from streamvoiceanon_tpu.ops import pallas_attention as jatt
from streamvoiceanon_tpu.ops.sampling import sample_token as j_sample
from streamvoiceanon_tpu.utils import tiny as tiny_util
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import dual_ar as tdar
from streamvoiceanon_tpu_torch.ops.attention import decode_attention
from streamvoiceanon_tpu_torch.ops.sampling import sample_token
from test_torch_dual_ar import _fast_gumbel

TOL = dict(atol=1e-4, rtol=1e-4)
ATOL = dict(atol=1e-5, rtol=1e-5)
GREEDY = JC.SamplingConfig(greedy=True)
SAMPLED = JC.SamplingConfig(temperature=0.9, top_p=0.7, greedy=False, top_k_window=64)


def _np(x):
    return np.asarray(x)


def _attn_inputs(rng, H=4, T=2, D=64, S=256):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((H, T, D), (H, T, D), (H, T, D), (H, S, D), (H, S, D))]


@pytest.mark.parametrize("pos", [0, 37, 254])
@pytest.mark.parametrize("jax_fn", ["decode_attention", "decode_attention_prepadded"])
def test_plain_decode_attention_matches_jax(jax_fn, pos):
    q, kn, vn, kc, vc = _attn_inputs(np.random.default_rng(pos))
    D = q.shape[-1]
    if jax_fn == "decode_attention":
        jo, jk, jv = jatt.decode_attention(*map(jnp.asarray, (q, kn, vn, kc, vc)), pos,
                                           interpret=True)
    else:
        pad = lambda c: jnp.pad(jnp.asarray(c), ((0, 0), (0, 0), (0, 128 - D)))
        jo, jk, jv = jatt.decode_attention_prepadded(
            *map(jnp.asarray, (q, kn, vn)), pad(kc), pad(vc), pos, true_head_dim=D,
            interpret=True)
        assert not np.any(_np(jk)[..., D:]) and not np.any(_np(jv)[..., D:])
        jk, jv = jk[..., :D], jv[..., :D]
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, tk, tv = decode_attention(*map(torch.from_numpy, (q, kn, vn)), tkc, tvc, pos)
    assert tk is tkc and tv is tvc  # updated in place
    np.testing.assert_allclose(to.numpy(), _np(jo), **ATOL)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))


def test_stale_rows_never_read():
    """Rows >= pos + T poisoned with NaN leave the output finite and equal."""
    q, kn, vn, kc, vc = map(torch.from_numpy, _attn_inputs(np.random.default_rng(3)))
    pos = 100
    clean, _, _ = decode_attention(q, kn, vn, kc.clone(), vc.clone(), pos)
    kp, vp = kc.clone(), vc.clone()
    kp[:, pos + 2 :], vp[:, pos + 2 :] = float("nan"), float("nan")
    poisoned, _, _ = decode_attention(q, kn, vn, kp, vp, pos)
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, clean)


@pytest.fixture(scope="module")
def tiny():
    """The tiny converter's ARVC weights; JAX on the per-head padded cache
    with the decode-attention and fast-loop kernels, the port likewise."""
    cfg = tiny_util.tiny_config()
    jparams = tiny_util._random_arvc(jax.random.split(jax.random.PRNGKey(0), 3)[2], cfg.arvc)
    jd = drep(cfg.arvc.decoder, use_pallas_decode=True, use_pallas_fast_decode=True)
    tparams = P.arvc_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jd, jparams["model"], C.from_fields(jd), tparams["model"]


def _check_cache(tstate, jstate, hd):
    jk, jv = _np(jstate.k_cache), _np(jstate.v_cache)
    assert jk.shape[-1] == 128 and not np.any(jk[..., hd:]) and not np.any(jv[..., hd:])
    assert tstate.k_cache.shape == jk.shape[:-1] + (hd,)
    np.testing.assert_allclose(tstate.k_cache.numpy(), jk[..., :hd], **TOL)
    np.testing.assert_allclose(tstate.v_cache.numpy(), jv[..., :hd], **TOL)


def _prefilled(tiny, rng, n=12):
    jd, jm, td, tm = tiny
    emb = rng.standard_normal((1, n, jd.dim)).astype(np.float32)
    js, jh = jdar.prefill(jm, jd, jdar.init_state(jd, 1, jnp.float32), jnp.asarray(emb),
                          jnp.int32(n))
    ts, th = tdar.prefill(tm, td, tdar.init_state(td, 1, torch.float32),
                          torch.from_numpy(emb))
    return js, jh, ts, th


def test_per_head_prefill_matches_jax(tiny):
    """Two chained prefills on the per-head layout: caches, position, last
    hidden."""
    jd, jm, td, tm = tiny
    rng = np.random.default_rng(11)
    js, _, ts, _ = _prefilled(tiny, rng)
    emb = rng.standard_normal((1, 7, jd.dim)).astype(np.float32)
    js, jh = jdar.prefill(jm, jd, js, jnp.asarray(emb), jnp.int32(7))
    ts, th = tdar.prefill(tm, td, ts, torch.from_numpy(emb))
    assert ts.k_cache.ndim == 5 and ts.pos == int(js.pos) == 19
    _check_cache(ts, js, jd.head_dim)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)


def _window_gumbel(key, k):
    """The (1, k) Gumbel row JAX's windowed sample_token draws at batch 1."""
    return np.array(jax.random.gumbel(jax.random.split(key, 1)[0], (k,), jnp.float32))[None]


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_decode_frame_matches_jax(tiny, sampling):
    """Four frames of the per-head path: semantic tokens, codes and the
    truncation count exact, caches and audio embedding close."""
    jd, jm, td, tm = tiny
    rng = np.random.default_rng(12)
    js, _, ts, _ = _prefilled(tiny, rng)
    step = jax.jit(jdar.decode_frame, static_argnums=(1, 5))
    tsamp = C.from_fields(sampling)
    for f in range(4):
        emb2 = rng.standard_normal((1, 2, jd.dim)).astype(np.float32)
        key = jax.random.PRNGKey(60 + f)
        js, jsem, jcodes, jemb = step(jm, jd, js, jnp.asarray(emb2), key, sampling)
        gs = gf = None
        if not sampling.greedy:
            k_sem, k_fast = jax.random.split(key)
            gs = torch.from_numpy(_window_gumbel(k_sem, sampling.top_k_window))
            gf = torch.from_numpy(_fast_gumbel(k_fast, jd.num_codebooks, jd.codebook_size))
        ts, tsem, tcodes, temb = tdar.decode_frame(tm, td, ts, torch.from_numpy(emb2), tsamp,
                                                   gs, gf)
        assert tsem.dtype == torch.int32 and int(tsem[0]) == int(jsem[0])
        np.testing.assert_array_equal(tcodes.numpy(), _np(jcodes))
        np.testing.assert_allclose(temb.numpy(), _np(jemb), **TOL)
        assert int(ts.trunc) == int(js.trunc)
    assert ts.pos == int(js.pos) == 20
    if not sampling.greedy:
        assert int(ts.trunc) > 0  # the tiny random LM's window holds < top_p
    _check_cache(ts, js, jd.head_dim)


def test_convert_cache_layout_both_ways(tiny):
    """flat <-> per head, each equal to JAX's conversion (its per-head cache
    padded), positions and truncation counts kept."""
    jd, jm, td, tm = tiny
    js, _, ts, _ = _prefilled(tiny, np.random.default_rng(13))
    ts = ts._replace(trunc=torch.tensor(3, dtype=torch.int32))
    flat_j = drep(jd, use_pallas_decode=False, use_pallas_slow_decode=True)
    flat_t = C.from_fields(flat_j)
    jf = jdar.convert_cache_layout(js, flat_j)
    tf = tdar.convert_cache_layout(ts, flat_t)
    assert tf.k_cache.ndim == 4 and tf.pos == ts.pos and int(tf.trunc) == 3
    np.testing.assert_allclose(tf.k_cache.numpy(), _np(jf.k_cache), **TOL)
    np.testing.assert_allclose(tf.v_cache.numpy(), _np(jf.v_cache), **TOL)
    assert tdar.convert_cache_layout(tf, flat_t) is tf
    back = tdar.convert_cache_layout(tf, td)
    assert torch.equal(back.k_cache, ts.k_cache) and torch.equal(back.v_cache, ts.v_cache)
    _check_cache(back, jdar.convert_cache_layout(jf, jd), jd.head_dim)


@pytest.mark.parametrize("window", [16, 0], ids=["window16", "full"])
def test_sample_token_ties_and_truncation(window):
    """Logits on a coarse grid (many ties in and around the window), with a
    few peaks or none: the port's tokens and flags equal JAX's for the same
    Gumbel draws, greedy ties go to the lower index."""
    rng = np.random.default_rng(14)
    V, B = 200, 6
    logits = np.round(rng.standard_normal((B, V)) * 2) / 2
    logits[:3, rng.integers(0, V, 3)] += 6.0  # peaked rows: the nucleus fits
    logits = logits.astype(np.float32)
    flags = []
    for top_p in (0.7, 1.0):
        keys = jax.random.split(jax.random.PRNGKey(window + int(10 * top_p)), B)
        kw = dict(temperature=0.8, top_p=top_p, top_k_window=window, with_flag=True)
        jt, jf = jax.vmap(lambda k, lg: j_sample(k, lg, **kw))(keys, jnp.asarray(logits))
        n = window if window else V
        g = np.stack([_np(jax.random.gumbel(k, (n,), jnp.float32)) for k in keys])
        tt, tf = sample_token(torch.from_numpy(logits), torch.from_numpy(g), **kw)
        np.testing.assert_array_equal(tt.numpy(), _np(jt))
        np.testing.assert_array_equal(tf.numpy(), _np(jf))
        flags.append(tf.numpy())
    if window:
        assert flags[0][3:].all() and not flags[0][:3].any() and not flags[1].any()
    tied = np.zeros((1, V), np.float32)
    tied[0, [7, 3, 150]] = 2.0
    tok, flag = sample_token(torch.from_numpy(tied), greedy=True, with_flag=True)
    assert int(tok[0]) == 3 == int(j_sample(None, jnp.asarray(tied[0]), greedy=True))
    assert int(flag[0]) == 0
