"""The port's windowed-transformer ring step (ops/wt_stream.py and the flat
branch of models/tokenizer_stream.py) against the JAX package on the CPU,
with the tiny ring of tests/test_pallas_wt_stream.py.

JAX runs its ring-step Pallas kernel in interpret mode; the port runs the
kernel's plain version.  Float32 outputs and rings agree to atol = rtol =
1e-4 (XLA on the CPU and ATen sum in different orders).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu.config import WindowedTransformerConfig
from streamvoiceanon_tpu.models import tokenizer_stream as jts
from streamvoiceanon_tpu.models import windowed_transformer
from streamvoiceanon_tpu.models.dual_ar import stack_layers
from streamvoiceanon_tpu.ops import pallas_wt_stream as pwt
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import tokenizer_stream as tts
from streamvoiceanon_tpu_torch.ops import wt_stream as wts

TOL = dict(atol=1e-4, rtol=1e-4)


def _wt_cfg(**kw):
    return WindowedTransformerConfig(
        n_layer=3, n_head=2, dim=32, intermediate_size=64, head_dim=16,
        window_size=8, **kw)


def _params(seed):
    """JAX params with non-trivial norms and LayerScales, and the port's."""
    p = windowed_transformer.init(jax.random.PRNGKey(seed), _wt_cfg())
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed + 100)
    for lp in p["layers"]:
        for k in ("attention_norm", "ffn_norm"):
            lp[k]["w"] = rng.uniform(0.5, 1.5, lp[k]["w"].shape).astype(np.float32)
        for k in ("attn_scale", "ffn_scale"):
            lp[k] = rng.uniform(0.2, 1.0, lp[k].shape).astype(np.float32)
    return p, P.windowed_transformer_params(p, "cpu")


def _stream(params_j, params_t, cfg, xs):
    """Both packages token by token; returns outputs and final states."""
    js, ts = jts.ring_init(cfg, 1), tts.ring_init(C.from_fields(cfg), 1)
    tcfg = C.from_fields(cfg)
    outs = []
    for t in range(xs.shape[0]):
        js, hj = jts.transformer_stream_step(params_j, cfg, js, jnp.asarray(xs[t]))
        ts, ht = tts.transformer_stream_step(params_t, tcfg, ts, torch.from_numpy(xs[t]))
        outs.append((np.asarray(hj), ht.numpy()))
    return outs, js, ts


@pytest.mark.parametrize("n_tok,table_rows", [(12, 4096), (30, 16)])
def test_flat_step_matches_jax_kernel(rng, n_tok, table_rows):
    """Past the window (12 tokens), and with a 16-row table (W = R = 8: a
    rebase every 8 tokens, three in 30 tokens): every output and the final
    flat rings equal JAX's."""
    cfg = _wt_cfg(use_pallas_stream=True, rope_table_rows=table_rows)
    pj, pt = _params(0)
    xs = rng.standard_normal((n_tok, 1, 1, cfg.dim)).astype(np.float32)
    outs, js, ts = _stream(pj, pt, cfg, xs)
    for t, (a, b) in enumerate(outs):
        np.testing.assert_allclose(b, a, **TOL, err_msg=f"token {t}")
    assert ts.k_ring.ndim == 4 and ts.count == int(js.count) == n_tok
    np.testing.assert_allclose(ts.k_ring.numpy(), np.asarray(js.k_ring), **TOL)
    np.testing.assert_allclose(ts.v_ring.numpy(), np.asarray(js.v_ring), **TOL)


def test_convert_ring_layout_both_ways(rng):
    """Flat -> rotated and rotated -> flat equal JAX's conversions, and the
    rotated result equals the rotated-frame stream's own ring."""
    flat_cfg = _wt_cfg(use_pallas_stream=True)
    rot_cfg = _wt_cfg()
    pj, pt = _params(1)
    xs = rng.standard_normal((11, 1, 1, flat_cfg.dim)).astype(np.float32)
    _, js_flat, ts_flat = _stream(pj, pt, flat_cfg, xs)
    _, js_rot, ts_rot = _stream(pj, pt, rot_cfg, xs)

    back = tts.convert_ring_layout(ts_flat, C.from_fields(rot_cfg))
    jback = jts.convert_ring_layout(js_flat, rot_cfg)
    assert back.k_ring.ndim == 5
    np.testing.assert_allclose(back.k_ring.numpy(), np.asarray(jback.k_ring), **TOL)
    np.testing.assert_allclose(back.v_ring.numpy(), np.asarray(jback.v_ring), **TOL)
    np.testing.assert_allclose(back.k_ring.numpy(), ts_rot.k_ring.numpy(), **TOL)

    fwd = tts.convert_ring_layout(ts_rot, C.from_fields(flat_cfg))
    jfwd = jts.convert_ring_layout(js_rot, flat_cfg)
    assert fwd.k_ring.ndim == 4
    np.testing.assert_allclose(fwd.k_ring.numpy(), np.asarray(jfwd.k_ring), **TOL)
    np.testing.assert_allclose(fwd.v_ring.numpy(), np.asarray(jfwd.v_ring), **TOL)
    # a layout that already matches comes back unchanged
    assert tts.convert_ring_layout(fwd, C.from_fields(flat_cfg)) is fwd


def test_batched_circular_step_matches_jax(rng):
    """B = 3 through `circular_stream_step` against JAX's
    `circular_stream_step_xla`, the rebase applied by both callers."""
    cfg = _wt_cfg(use_pallas_stream=True, rope_table_rows=16)
    pj, pt = _params(2)
    jl = stack_layers(pj["layers"])
    L, W, dim = cfg.n_layer, cfg.window_size, cfg.dim
    jk = jv = jnp.zeros((L, 3, W, dim))
    tk, tv = torch.zeros((L, 3, W, dim)), torch.zeros((L, 3, W, dim))
    kw = dict(n_head=cfg.n_head, head_dim=cfg.head_dim, table_rows=16)
    for count in range(11):
        x = rng.standard_normal((3, 1, dim)).astype(np.float32)
        jk = pwt.maybe_rebase_ring(jk, jnp.int32(count), **kw)
        hj, jk, jv = pwt.circular_stream_step_xla(jl, jnp.asarray(x), jk, jv,
                                                  jnp.int32(count), **kw)
        tk = wts.maybe_rebase_ring(tk, count, **kw)
        ht, tk, tv = wts.circular_stream_step(pt["layers"], torch.from_numpy(x), tk, tv,
                                              count, **kw)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL,
                                   err_msg=f"count {count}")
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_kernel_plain_version_matches_batched_form(rng):
    """`wt_stream_step_plain` (the kernel's arithmetic) equals
    `circular_stream_step` at B = 1 across a rebase, rings included."""
    cfg = _wt_cfg(rope_table_rows=16)
    _, pt = _params(3)
    L, W, dim = cfg.n_layer, cfg.window_size, cfg.dim
    kw = dict(n_head=cfg.n_head, head_dim=cfg.head_dim, table_rows=16)
    ka = torch.zeros((L, W, dim))
    va = torch.zeros((L, W, dim))
    kb, vb = ka[:, None].clone(), va[:, None].clone()
    for count in range(20):
        x = torch.from_numpy(rng.standard_normal((1, 1, dim)).astype(np.float32))
        ka = wts.maybe_rebase_ring(ka, count, **kw)
        kb = wts.maybe_rebase_ring(kb, count, **kw)
        ha, ka, va = wts.wt_stream_step_plain(pt["layers"], x[0], ka, va, count, **kw)
        hb, kb, vb = wts.circular_stream_step(pt["layers"], x, kb, vb, count, **kw)
        np.testing.assert_allclose(ha.numpy(), hb[0].numpy(), **TOL,
                                   err_msg=f"count {count}")
    np.testing.assert_allclose(ka.numpy(), kb[:, 0].numpy(), **TOL)
    np.testing.assert_allclose(va.numpy(), vb[:, 0].numpy(), **TOL)


def test_signed_tables_match_jax():
    for args in ((16, 16, 2, 10000.0), (4096, 64, 8, 10000.0)):
        for a, b in zip(wts.signed_tables(*args), pwt._signed_tables(*args)):
            np.testing.assert_array_equal(a, b)
