"""The port's kernel caps against the JAX kernels' own limits, on the CPU.

Each wrapper's geometry check (`check_geometry` of ops/fast_decode.py,
ops/slow_decode.py and ops/wt_stream.py) is held at each of its caps and
one row past it (one 16-byte unit of a weight row where the cap is a
width).  The JAX kernels have no caps of their own: they stop where their
VMEM blocks no longer fit under `vmem_limit_bytes=128 MiB`.  `jax_vmem`
models that footprint from the kernels' BlockSpecs (every block
double-buffered, as Pallas pipelines a grid, its last two dims padded to
the (8 x 4 / itemsize, 128) tile; the kernels' own temporaries left out,
so JAX stops at or before the limit found); `jax_limit` walks one dim up
with the others at the published geometry.  Every geometry that a
configuration of either package reaches (the published one and the tiny
test one) is within the port's caps, so the gaps that the audit finds are
no fault; ROADMAP.md section 3 lists them.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import pytest
import torch

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.utils.tiny import tiny_config
from streamvoiceanon_tpu_torch.ops import fast_decode, slow_decode, wt_stream

ROOT = Path(__file__).resolve().parent.parent
VMEM = 128 * 1024 * 1024  # vmem_limit_bytes of the three JAX kernels
B16, F32 = 2, 4


def _tile(shape, item):
    *lead, r, c = (1,) * (2 - len(shape)) + tuple(shape)
    sub = 8 * 4 // item
    return math.prod(lead) * (-(-r // sub) * sub) * (-(-c // 128) * 128) * item


def jax_vmem(kind: str, g: dict) -> int:
    """Bytes of VMEM the JAX kernel's blocks take at geometry `g`
    (pallas_fast_decode.py:331-360, pallas_slow_decode.py:309-335,
    pallas_wt_stream.py:263-283), weights and caches in bf16 (the serving
    point): inputs and outputs twice, scratch once."""
    w, c = B16, B16
    if kind == "fast":
        L, d, i, V, nq, m = g["L"], g["dim"], g["inter"], g["V"], g["nq"], g["mdim"]
        vp = -(-V // 128) * 128
        blocks = [((1, d), w), ((1, nq, vp), F32), ((L, d, 3 * d), w), ((L, d, d), w),
                  ((L, d, i), w), ((L, d, i), w), ((L, i, d), w), ((L, d), w), ((L, d), w),
                  ((1, d), w), ((d, vp), w), ((vp, d), w), ((nq, d), F32), ((nq, d), F32),
                  ((1, m), w)]
        scratch = [((L, nq, d), w), ((L, nq, d), w), ((8, m), w)]
    elif kind == "slow":
        L, d, i, V, S = g["L"], g["dim"], g["inter"], g["V"], g["S"]
        blocks = [((2, d), w), ((2, d), F32), ((2, d), F32), ((1, d, 3 * d), w),
                  ((1, d, d), w), ((1, d, i), w), ((1, d, i), w), ((1, i, d), w),
                  ((L, d), w), ((L, d), w), ((1, S, d), c), ((1, S, d), c), ((1, d), w),
                  ((d, V), w), ((1, V), F32), ((2, d), w), ((1, 2, d), c), ((1, 2, d), c),
                  ((1, 1), 4)]
        scratch = [((2, d), w)]
    else:  # the ring step
        L, d, i, W = g["L"], g["dim"], g["inter"], g["W"]
        blocks = [((1, d), w), ((1, d), F32), ((1, d), F32), ((1, d, 3 * d), w),
                  ((1, d, d), w), ((1, d, i), w), ((1, d, i), w), ((1, i, d), w)] + [
            ((L, d), w)] * 4 + [((1, W, d), c), ((1, W, d), c), ((1, d), w), ((1, 1, d), c),
                                ((1, 1, d), c)]
        scratch = [((1, d), w)]
    return 2 * sum(_tile(s, it) for s, it in blocks) + sum(_tile(s, it) for s, it in scratch)


def published():
    d = JC.PipelineConfig().arvc.decoder
    t = JC.PipelineConfig().tokenizer.transformer
    return {
        "fast": dict(L=d.n_fast_layer, dim=d.fast_dim, inter=d.fast_intermediate_size,
                     V=d.codebook_size, nq=d.num_codebooks, mdim=d.dim, n_head=d.fast_n_head,
                     head_dim=d.fast_head_dim),
        "slow": dict(L=d.n_layer, dim=d.dim, inter=d.intermediate_size, V=d.vocab_size,
                     S=d.max_seq_len, n_head=d.n_head, head_dim=d.head_dim),
        "ring": dict(L=t.n_layer, dim=t.dim, inter=t.intermediate_size, W=t.window_size,
                     n_head=t.n_head, head_dim=t.head_dim),
    }


def jax_limit(kind: str, key: str, step: int = 8):
    """The largest value of `key` (a multiple of `step`) at which the JAX
    kernel's blocks still fit, the other dims published."""
    g = dict(published()[kind])
    lo = g[key]
    assert jax_vmem(kind, g) <= VMEM
    hi = lo
    while jax_vmem(kind, {**g, key: hi}) <= VMEM:
        lo, hi = hi, hi * 2
    while hi - lo > step:
        mid = (lo + hi) // 2 // step * step
        lo, hi = (mid, hi) if jax_vmem(kind, {**g, key: mid}) <= VMEM else (lo, mid)
    return lo


def _fast(**kw):
    g = {**published()["fast"], **kw}
    fast_decode.check_geometry(g["L"], g["dim"], g["n_head"], g["head_dim"], g["inter"],
                               g["V"], g["nq"], g["mdim"], torch.bfloat16)


def _slow(**kw):
    g = {**published()["slow"], **kw}
    slow_decode.check_geometry(g["dim"], g["n_head"], g["head_dim"], g["inter"], g["V"],
                               torch.bfloat16)


def _ring(**kw):
    g = {**published()["ring"], **kw}
    g["n_head"] = g["dim"] // g["head_dim"]
    wt_stream.check_geometry(g["L"], g["dim"], g["n_head"], g["head_dim"], g["inter"], g["W"],
                             torch.float32)


# (checker, dim, the port's cap, one row past it)
CAPS = {
    "fast vocab": (_fast, "V", fast_decode.MAX_VOCAB, fast_decode.MAX_VOCAB + 8),
    "fast layers": (_fast, "L", fast_decode.MAX_LAYERS, fast_decode.MAX_LAYERS + 1),
    "fast codebooks": (_fast, "nq", fast_decode.MAX_NQ, fast_decode.MAX_NQ + 1),
    "fast rows": (_fast, "inter", fast_decode.MAX_ROW, fast_decode.MAX_ROW + 8),
    "slow vocab": (_slow, "V", slow_decode.MAX_VOCAB, slow_decode.MAX_VOCAB + 8),
    "ring head_dim": (_ring, "head_dim", wt_stream.MAX_HEAD_DIM, 2 * wt_stream.MAX_HEAD_DIM),
    "ring rows": (_ring, "inter", wt_stream.MAX_ROW, wt_stream.MAX_ROW + 4),
}


@pytest.mark.parametrize("name", sorted(CAPS))
def test_wrapper_check_at_the_cap_and_one_row_past_it(name):
    check, key, at, past = CAPS[name]
    check(**{key: at})
    with pytest.raises(ValueError, match="unsupported geometry"):
        check(**{key: past})


@pytest.mark.parametrize("name", sorted(CAPS))
def test_no_configuration_reaches_a_cap(name):
    """Where JAX's limit lies past the port's cap the port refuses a
    geometry that JAX computes: a gap, and a fault only if a configuration
    of either package reached it.  Neither the published nor the tiny
    configuration goes past any cap."""
    _, key, at, past = CAPS[name]
    kind = name.split()[0]
    if key == "head_dim":  # the footprint does not depend on it: up to dim
        assert jax_vmem(kind, {**published()[kind], "head_dim": past}) == jax_vmem(
            kind, published()[kind])
    tiny = tiny_config()
    reached = {
        "fast vocab": [JC.PipelineConfig().arvc.decoder.codebook_size,
                       tiny.arvc.decoder.codebook_size],
        "fast layers": [JC.PipelineConfig().arvc.decoder.n_fast_layer,
                        tiny.arvc.decoder.n_fast_layer],
        "fast codebooks": [JC.PipelineConfig().arvc.decoder.num_codebooks,
                           tiny.arvc.decoder.num_codebooks],
        "fast rows": [max(c.fast_dim, c.fast_intermediate_size, c.dim)
                      for c in (JC.PipelineConfig().arvc.decoder, tiny.arvc.decoder)],
        "slow vocab": [JC.PipelineConfig().arvc.decoder.vocab_size, tiny.arvc.decoder.vocab_size],
        "ring head_dim": [JC.PipelineConfig().tokenizer.transformer.head_dim,
                          tiny.tokenizer.transformer.head_dim],
        "ring rows": [max(t.dim, t.intermediate_size) for t in (
            JC.PipelineConfig().tokenizer.transformer, tiny.tokenizer.transformer)],
    }[name]
    assert max(reached) <= at


def test_caps_mirror_the_cuda_sources():
    common = (ROOT / "streamvoiceanon_tpu_torch" / "csrc" / "decode_common.cuh").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", common))
    assert slow_decode.MAX_VOCAB == int(const["SM_THREADS"]) * int(const["SM_VPT"])


def test_jax_limits_at_the_published_geometry():
    """The numbers of ROADMAP.md section 3's table: the blocks' footprint at
    the published geometry, and each dim's limit.  JAX's fast loop holds its
    whole layer stack in VMEM, double-buffered: 123.6 MiB of the 128 at the
    published geometry, so JAX stops before the port's caps on layers (8)
    and rows (2560); the other caps stop the port before JAX."""
    mib = {k: jax_vmem(k, published()[k]) / 2 ** 20 for k in ("fast", "slow", "ring")}
    assert {k: round(v, 1) for k, v in mib.items()} == {"fast": 123.6, "slow": 66.2,
                                                        "ring": 15.3}
    limits = {n: jax_limit(n.split()[0], CAPS[n][1], 1 if CAPS[n][1] in ("L", "nq") else 8)
              for n in CAPS if CAPS[n][1] != "head_dim"}
    assert limits == {"fast vocab": 1664, "fast layers": 4, "fast codebooks": 144,
                      "fast rows": 2416, "slow vocab": 28800, "ring rows": 20736}
    gaps = sorted(n for n, lim in limits.items() if lim > CAPS[n][2]) + ["ring head_dim"]
    assert gaps == ["fast codebooks", "fast vocab", "ring rows", "slow vocab",
                    "ring head_dim"]
