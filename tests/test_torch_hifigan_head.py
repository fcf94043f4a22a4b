"""The port's fused HiFiGAN head (ops/hifigan.py and the packed branch of
models/hifigan.py) against the JAX package on the CPU.

JAX runs its head Pallas kernel in interpret mode; the port runs the
kernel's plain version.  Two geometries: the tiny head of
tests/test_pallas_hifigan.py, and the tiny converter's head, whose last
stage narrows to one channel.  Biases are random, so the bias path is
checked too.  Waveforms and tails agree to atol = rtol = 1e-4 and to 1e-4
of the largest sample; weight packing and the state round trip are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from streamvoiceanon_tpu.config import HiFiGANConfig
from streamvoiceanon_tpu.models import hifigan as jhg
from streamvoiceanon_tpu.ops import pallas_hifigan as ph
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import hifigan as thg
from streamvoiceanon_tpu_torch.ops import hifigan as headops

TOL = dict(atol=1e-4, rtol=1e-4)

GEOMETRIES = {
    # tests/test_pallas_hifigan.py
    "pallas_tiny": dict(
        num_mels=16, upsample_initial_channel=16, upsample_rates=(2, 2),
        upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
        resblock_dilation_sizes=((1, 2), (1, 2)), pre_conv_kernel_size=5,
        post_conv_kernel_size=5, hop_length=4),
    # utils/tiny.py: 32 -> 16 -> 8 -> 4 -> 2 -> 1 channels
    "converter_tiny": dict(
        num_mels=32, upsample_initial_channel=32, pre_conv_kernel_size=7,
        post_conv_kernel_size=7),
}


def _cfgs(name, **kw):
    jcfg = HiFiGANConfig(**GEOMETRIES[name], **kw)
    return jcfg, C.from_fields(jcfg)


def _params(cfg, seed):
    """JAX head params (numpy, with random biases) and the port's."""
    p = jax.tree.map(np.asarray, jhg.hifigan_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 50)

    def bias(cp):
        cp["b"] = (rng.standard_normal(cp["b"].shape) * 0.1).astype(np.float32)

    bias(p["conv_pre"])
    bias(p["conv_post"])
    for up, stage in zip(p["ups"], p["resblocks"]):
        bias(up)
        for blk in stage:
            for cp in blk["convs1"] + blk["convs2"]:
                bias(cp)
    return p, P.hifigan_params(p, "cpu")


def _leaves(state):
    """The tails of a packed state of either package."""
    return [state.pre, *state.ups, *state.res, state.post]


def _close(got, ref):
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.max(np.abs(got - ref)) <= 1e-4 * max(np.max(np.abs(ref)), 1e-30)


@pytest.mark.parametrize("name,chunks", [("pallas_tiny", 5), ("converter_tiny", 3)])
def test_packed_head_matches_jax_kernel(name, chunks):
    """Chunk by chunk: the waveform and every packed tail equal JAX's."""
    jcfg, tcfg = _cfgs(name, use_pallas_stream=True)
    pj, pt = _params(jcfg, 0)
    pw = ph.packed_weights(jax.tree.map(jnp.asarray, pj), jcfg)
    tw = headops.packed_weights(pt, tcfg)
    js = jhg.hifigan_init_stream(pj, jcfg, 1)
    ts = thg.hifigan_init_stream(pt, tcfg, 1)
    assert isinstance(ts, headops.PackedHeadState)
    rng = np.random.default_rng(1)
    for c in range(chunks):
        x = rng.standard_normal((1, 4, jcfg.num_mels)).astype(np.float32)
        js, a = jhg.hifigan_apply_stream(pj, jcfg, js, jnp.asarray(x), packed_w=pw)
        ts, b = thg.hifigan_apply_stream(pt, tcfg, ts, torch.from_numpy(x), packed_w=tw)
        assert b.shape == (1, 4 * int(np.prod(jcfg.upsample_rates)))
        _close(b.numpy(), np.asarray(a))
        for lt, lj in zip(_leaves(ts), _leaves(js)):
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                       err_msg=f"chunk {c}")


def test_pack_unpack_roundtrip():
    """packed -> dict -> packed is exact, after tails have filled."""
    jcfg, tcfg = _cfgs("pallas_tiny", use_pallas_stream=True)
    _, pt = _params(jcfg, 1)
    tw = headops.packed_weights(pt, tcfg)
    st = thg.hifigan_init_stream(pt, tcfg, 1)
    rng = np.random.default_rng(2)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
        st, _ = thg.hifigan_apply_stream(pt, tcfg, st, x, packed_w=tw)
    back = headops.pack_head_state(headops.unpack_head_state(st, tcfg), tcfg)
    for a, b in zip(_leaves(back), _leaves(st)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_packed_weights_equal_jax(name):
    jcfg, tcfg = _cfgs(name, use_pallas_stream=True)
    pj, pt = _params(jcfg, 2)
    jw = jax.tree.map(np.asarray, ph.packed_weights(jax.tree.map(jnp.asarray, pj), jcfg))
    tw = headops.packed_weights(pt, tcfg)
    jl, jdef = jax.tree.flatten(jw)
    tl, tdef = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), tw))
    assert jdef == tdef
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)
    assert headops.res_slots(tcfg) == ph._res_slots(jcfg)
    assert headops.res_rows(tcfg) == ph._res_rows(jcfg)


def test_batched_packed_state_falls_back():
    """A packed state at B = 3 runs the dict path and is repacked; it matches
    JAX's dict path chunk by chunk."""
    jcfg, tcfg = _cfgs("pallas_tiny", use_pallas_stream=True)
    pj, pt = _params(jcfg, 3)
    js = jhg.hifigan_init_stream(pj, jcfg, 3)  # the dict layout at B > 1
    ts = headops.pack_head_state(thg.hifigan_init_stream(pt, tcfg, 3), tcfg)
    rng = np.random.default_rng(4)
    for _ in range(3):
        x = rng.standard_normal((3, 4, 16)).astype(np.float32)
        js, a = jhg.hifigan_apply_stream(pj, jcfg, js, jnp.asarray(x))
        ts, b = thg.hifigan_apply_stream(pt, tcfg, ts, torch.from_numpy(x))
        assert isinstance(ts, headops.PackedHeadState) and ts.pre.shape[0] == 3
        _close(b.numpy(), np.asarray(a))


def test_convert_head_layout_both_ways():
    """dict -> packed for a batch-1 state under the flag, back to the dict
    layout when the target batch is larger, unchanged when already right."""
    from streamvoiceanon_tpu_torch.models import vocoder as tvoc

    jcfg, tcfg = _cfgs("pallas_tiny", use_pallas_stream=True)
    _, pt = _params(jcfg, 4)
    plain = C.replace(tcfg, use_pallas_stream=False)
    d = {"upsample": [], "head": thg.hifigan_init_stream(pt, plain, 1)}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    d["head"], _ = thg.hifigan_apply_stream(pt, plain, d["head"], x)
    packed = tvoc.convert_head_layout(d, tcfg)
    assert isinstance(packed["head"], headops.PackedHeadState)
    assert tvoc.convert_head_layout(packed, tcfg) is packed
    back = tvoc.convert_head_layout(packed, tcfg, target_batch=3)
    for a, b in zip(jax.tree.leaves(back["head"]), jax.tree.leaves(d["head"])):
        assert torch.equal(a, b)


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp (8 significant bits) at the largest magnitude of x."""
    top = float(np.max(np.abs(x)))
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("wd,sd", [(torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32)])
def test_plain_head_bf16_matches_jax_kernel(name, wd, sd):
    """bf16 weights with bf16 tails (the serving point) and with float32
    tails (the mixed case JAX's kernel takes; float32 weights with bf16
    tails it refuses), five chunks from zero tails.  The waveform comes out
    in the weights' dtype and the tails in the state's.  Every output
    within 2 bf16 ulps of its largest value: both sides round at the same
    points (each conv after its bias, the residual sums, the branch mean,
    SiLU), but XLA and ATen sum a conv's products in other orders, so a
    sum can land on the other side of a rounding boundary; such a one-ulp
    flip reaches the later convs through weights of norm below one, and
    measured at most one ulp."""
    jcfg, tcfg = _cfgs(name, use_pallas_stream=True)
    pj, pt = _params(jcfg, 0)
    jd, js_d = (jnp.dtype(str(t).split(".")[1]) for t in (wd, sd))
    pw = jax.tree.map(lambda a: a.astype(jd),
                      ph.packed_weights(jax.tree.map(jnp.asarray, pj), jcfg))
    tw = jax.tree.map(lambda t: t.to(wd), headops.packed_weights(pt, tcfg))
    js = ph.init_packed_state(jcfg, 1, js_d)
    ts = headops.init_packed_state(tcfg, 1, sd)
    rng = np.random.default_rng(1)
    f32 = lambda x: np.asarray(x.float()) if isinstance(x, torch.Tensor) else \
        np.asarray(x.astype(jnp.float32))
    for c in range(5):
        x = rng.standard_normal((1, 4, jcfg.num_mels)).astype(np.float32)
        js, a = ph.head_stream_step(pw, js, jnp.asarray(x), jcfg, interpret=True)
        ts, b = headops.head_stream_step(tw, ts, torch.from_numpy(x), tcfg)
        assert b.dtype == wd and all(t.dtype == sd for t in _leaves(ts))
        for got, ref in zip([b, *_leaves(ts)], [a, *_leaves(js)]):
            got, ref = f32(got), f32(ref)
            assert np.max(np.abs(got - ref)) <= 2 * _bf16_ulp(ref), f"chunk {c}"


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_head_bf16_rounds_where_jax_kernel_rounds(name):
    """The ulp bound above cannot tell a head that rounds where JAX's
    kernel rounds from one that leaves the rounding out.  Where the rounding
    points match, most bf16 values agree bit for bit, so the share that
    differs (`chip_smoke.flip_share` over the tails and the wave, the
    largest of five chunks) stays within HEAD_FLIP_SHARE; the control,
    the plain head with every activation in float32
    (`chip_smoke.unrounded`), must exceed it."""
    jcfg, tcfg = _cfgs(name, use_pallas_stream=True)
    pj, pt = _params(jcfg, 0)
    pw = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      ph.packed_weights(jax.tree.map(jnp.asarray, pj), jcfg))
    tw = jax.tree.map(lambda t: t.to(torch.bfloat16), headops.packed_weights(pt, tcfg))
    control = chip_smoke.unrounded(headops.head_stream_step_plain)
    js = ph.init_packed_state(jcfg, 1, jnp.bfloat16)
    ts = tc = headops.init_packed_state(tcfg, 1, torch.bfloat16)
    rng = np.random.default_rng(1)
    f32 = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32)))
    share, share_c = 0.0, 0.0
    for _ in range(5):
        x = rng.standard_normal((1, 4, jcfg.num_mels)).astype(np.float32)
        js, a = ph.head_stream_step(pw, js, jnp.asarray(x), jcfg, interpret=True)
        ts, b = headops.head_stream_step_plain(tw, ts, torch.from_numpy(x), tcfg)
        tc, c = control(tw, tc, torch.from_numpy(x), tcfg)
        want = [f32(a), *map(f32, _leaves(js))]
        share = max(share, chip_smoke.flip_share([b, *_leaves(ts)], want))
        share_c = max(share_c, chip_smoke.flip_share([c, *_leaves(tc)], want))
    assert share <= chip_smoke.HEAD_FLIP_SHARE < share_c, (share, share_c)
