"""The port's fused ConvNeXt front (ops/convnext_enc.py) and its packed
encoder state against the JAX package, on the CPU.

JAX runs its Pallas kernel `encoder_front_step` with interpret=True, as
tests/test_pallas_convnext_enc.py does; the port runs the plain version its
wrapper takes for CPU tensors.  The front has depths (2, 1, 3, 1), so
stages hold several 8-row tail slots, and seeded weights with random
biases, norm weights near 1 and LayerScales of 0.1 to 0.5
(`chip_smoke.front_tree_np`), so every term of a block shows.  Packed
weights, packed states and layout conversions must be exact; float outputs
of a step agree to atol = rtol = 1e-5 (the TPU kernel's polynomial erf is
within 1.5e-7 of the exact one, and XLA and ATen sum in other orders);
tokens are exact.
"""

from dataclasses import replace as drep

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from streamvoiceanon_tpu.config import ConvNeXtConfig
from streamvoiceanon_tpu.models import tokenizer as jtok
from streamvoiceanon_tpu.models import tokenizer_stream as jts
from streamvoiceanon_tpu.ops import pallas_convnext_enc as pce
from streamvoiceanon_tpu.ops.conv import ConvState as JConvState
from streamvoiceanon_tpu.utils.tiny import tiny_config
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import tokenizer_stream as tts
from streamvoiceanon_tpu_torch.ops import convnext_enc as enc
from streamvoiceanon_tpu_torch.ops.conv import ConvState

TOL = dict(atol=1e-5, rtol=1e-5)
SPF = 2048
J_DICT = drep(tiny_config().tokenizer, backbone=ConvNeXtConfig(
    input_channels=160, depths=(2, 1, 3, 1), dims=(16, 24, 28, 32)))
J_PACKED = drep(J_DICT, use_pallas_encoder=True)


@pytest.fixture(scope="module")
def front():
    """(JAX params, port params with enc_packed) of the seeded front."""
    tree = chip_smoke.front_tree_np(C.from_fields(J_DICT))
    tp = P.tokenizer_params(tree, "cpu")
    tp["enc_packed"] = enc.packed_weights(tp, C.from_fields(J_PACKED))
    return jax.tree.map(jnp.asarray, tree), tp


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [np.asarray(x)]


def _packed_leaves(st):
    return [np.asarray(st.stem), *map(np.asarray, st.stages), np.asarray(st.down)]


def _dict_states(rng, B):
    """The same random dict-layout front state for JAX and the port."""
    bb, q = J_DICT.backbone, J_DICT.quantizer
    k = bb.kernel_size
    t = lambda c: rng.standard_normal((B, k - 1, c)).astype(np.float32)
    stem = t(bb.input_channels)
    stages = [[t(c) for _ in range(d)] for d, c in zip(bb.depths, bb.dims)]
    down = [t(q.input_dim) for _ in q.downsample_factor]
    empty = np.zeros((B, 0, q.input_dim), np.float32)

    def build(conv, arr):
        return ({"stem": conv(arr(stem)), "stages": [[conv(arr(a)) for a in s] for s in stages]},
                tuple({"conv": conv(arr(empty)), "block": conv(arr(a))} for a in down))

    return build(JConvState, jnp.asarray), build(ConvState, torch.from_numpy)


def test_packed_weights_equal_jax(front):
    jp, tp = front
    want = _leaves(pce.packed_weights(jp, J_PACKED))
    got = _leaves(tp["enc_packed"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pack_unpack_round_trip_equals_jax():
    (jbb, jdown), (tbb, tdown) = _dict_states(np.random.default_rng(4), 1)
    cfg = C.from_fields(J_PACKED)
    packed = enc.pack_enc_state(tbb, tdown, cfg)
    for a, b in zip(_packed_leaves(packed), _packed_leaves(pce.pack_enc_state(jbb, jdown,
                                                                              J_PACKED))):
        np.testing.assert_array_equal(a, b)
    bb, dn = enc.unpack_enc_state(packed, cfg)
    for a, b in zip(_leaves([bb, [d["block"] for d in dn]]),
                    _leaves([tbb, [d["block"] for d in tdown]])):
        np.testing.assert_array_equal(a, b)
    assert all(d["conv"].tail.shape == (1, 0, cfg.quantizer.input_dim) for d in dn)


def test_plain_front_step_matches_jax_kernel(front):
    """Six chunks, each side carrying its own packed state from random
    tails: z and every packed buffer after every chunk."""
    jp, tp = front
    cfg = C.from_fields(J_PACKED)
    rng = np.random.default_rng(5)
    (jbb, jdown), (tbb, tdown) = _dict_states(rng, 1)
    js, ts = pce.pack_enc_state(jbb, jdown, J_PACKED), enc.pack_enc_state(tbb, tdown, cfg)
    jpw = pce.packed_weights(jp, J_PACKED)
    for _ in range(6):
        mel = rng.standard_normal((1, 4, 160)).astype(np.float32)
        js, jz = pce.encoder_front_step(jpw, js, jnp.asarray(mel), J_PACKED, interpret=True)
        ts, tz = enc.encoder_front_step(tp["enc_packed"], ts, torch.from_numpy(mel), cfg)
        assert tz.shape == (1, 1, cfg.quantizer.input_dim)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
        for a, b in zip(_packed_leaves(ts), _packed_leaves(js)):
            np.testing.assert_allclose(a, b, **TOL)


def test_encode_stream_tokens_exact(front):
    """The packed stream's tokens equal JAX's packed stream, chunk by chunk,
    and the offline tokenizer's."""
    jp, tp = front
    cfg = C.from_fields(J_PACKED)
    n = 6
    wav = (np.random.default_rng(6).standard_normal((1, n * SPF)) * 0.2).astype(np.float32)
    offline = np.asarray(jtok.encode(jp, J_DICT, jnp.asarray(wav)))
    jparams = dict(jp, enc_packed=pce.packed_weights(jp, J_PACKED))
    js = jts.init_stream_state(jparams, J_PACKED)
    ts = tts.init_stream_state(tp, cfg)
    assert isinstance(ts.backbone, enc.PackedEncState) and ts.down == ()
    jc, tc = jts.mel_consts(J_PACKED.mel), tts.mel_consts(cfg.mel)
    toks = []
    for i in range(n):
        chunk = wav[:, i * SPF : (i + 1) * SPF]
        js, a = jts.encode_stream(jparams, J_PACKED, js, jnp.asarray(chunk), jc)
        ts, b = tts.encode_stream(tp, cfg, ts, torch.from_numpy(chunk), tc)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        toks.append(b.numpy())
    np.testing.assert_array_equal(np.concatenate(toks, 1), offline)


def test_batch2_packed_layout_equals_dict_layout(front):
    """Batch 2 on a packed state unpacks, runs the dict path and repacks:
    the same tokens and tails as the dict layout."""
    _, tp = front
    cfg_p, cfg_d = C.from_fields(J_PACKED), C.from_fields(J_DICT)
    wav = (np.random.default_rng(7).standard_normal((2, 3 * SPF)) * 0.2).astype(np.float32)
    sd = tts.init_stream_state(tp, cfg_d, batch=2)
    sp = sd._replace(backbone=enc.pack_enc_state(sd.backbone, sd.down, cfg_p), down=())
    consts = tts.mel_consts(cfg_d.mel)
    for i in range(3):
        chunk = torch.from_numpy(wav[:, i * SPF : (i + 1) * SPF])
        sd, a = tts.encode_stream(tp, cfg_d, sd, chunk, consts)
        sp, b = tts.encode_stream(tp, cfg_p, sp, chunk, consts)
        np.testing.assert_array_equal(b.numpy(), a.numpy())
        assert isinstance(sp.backbone, enc.PackedEncState)
    want = enc.pack_enc_state(sd.backbone, sd.down, cfg_p)
    for a, b in zip(_packed_leaves(sp.backbone), _packed_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_convert_enc_layout_both_ways(front):
    """dict -> packed -> dict, each as JAX's convert_enc_layout does, and a
    packed state bound for batch 2 (`target_batch`) is unpacked."""
    jp, tp = front
    cfg_p, cfg_d = C.from_fields(J_PACKED), C.from_fields(J_DICT)
    (jbb, jdown), (tbb, tdown) = _dict_states(np.random.default_rng(8), 1)
    jstate = jts.init_stream_state(jp, J_DICT)._replace(backbone=jbb, down=jdown)
    tstate = tts.init_stream_state(tp, cfg_d)._replace(backbone=tbb, down=tdown)
    tpk = tts.convert_enc_layout(tstate, tp, cfg_p)
    jpk = jts.convert_enc_layout(jstate, jp, J_PACKED)
    assert tpk.down == () and isinstance(tpk.backbone, enc.PackedEncState)
    for a, b in zip(_packed_leaves(tpk.backbone), _packed_leaves(jpk.backbone)):
        np.testing.assert_array_equal(a, b)
    assert tts.convert_enc_layout(tpk, tp, cfg_p) is tpk
    back = tts.convert_enc_layout(tpk, tp, cfg_d)
    jback = jts.convert_enc_layout(jpk, jp, J_DICT)
    got = _leaves([back.backbone, [d["block"] for d in back.down]])
    for a, b in zip(got, _leaves([jback.backbone, [d["block"] for d in jback.down]])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, _leaves([tbb, [d["block"] for d in tdown]])):
        np.testing.assert_array_equal(a, b)
    fan = tts.convert_enc_layout(tpk, tp, cfg_p, target_batch=2)
    assert isinstance(fan.backbone, dict) and len(fan.down) == 2


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp (8 significant bits) at the largest magnitude of x."""
    top = float(np.max(np.abs(x)))
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("wd,sd", [(torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32)])
def test_plain_front_step_bf16_matches_jax_kernel(front, wd, sd):
    """bf16 weights with bf16 tails (the serving point) and with float32
    tails (the mixed case JAX's kernel takes; float32 weights with bf16
    tails it refuses), four chunks from zero tails.  z and every packed
    buffer within 4 bf16 ulps of its largest value: both sides round to
    bf16 at the same points, but XLA and ATen sum the products, the
    depthwise taps and the LayerNorm statistics in other orders, so a sum
    can land on the other side of a rounding boundary; such a one-ulp flip
    passes through the later blocks' LayerNorms, which measured up to 2.5
    ulps (two bf16 runs are as far apart as either is from the float32 one)."""
    jp, tp = front
    cfg = C.from_fields(J_PACKED)
    jd = jnp.dtype(str(wd).split(".")[1])
    jpw = jax.tree.map(lambda a: a.astype(jd), pce.packed_weights(jp, J_PACKED))
    tpw = jax.tree.map(lambda t: t.to(wd), tp["enc_packed"])
    js = pce.init_packed_state(J_PACKED, 1, jnp.dtype(str(sd).split(".")[1]))
    ts = enc.init_packed_state(cfg, 1, sd)
    rng = np.random.default_rng(9)
    f32 = lambda x: np.asarray(x.float()) if isinstance(x, torch.Tensor) else \
        np.asarray(x.astype(jnp.float32))
    for c in range(4):
        mel = rng.standard_normal((1, 4, 160)).astype(np.float32)
        js, jz = pce.encoder_front_step(jpw, js, jnp.asarray(mel), J_PACKED, interpret=True)
        ts, tz = enc.encoder_front_step(tpw, ts, torch.from_numpy(mel), cfg)
        assert tz.dtype == wd and ts.stem.dtype == sd and ts.down.dtype == sd
        for a, b in zip([tz, ts.stem, *ts.stages, ts.down], [jz, js.stem, *js.stages, js.down]):
            a, b = f32(a), f32(b)
            assert np.max(np.abs(a - b)) <= 4 * _bf16_ulp(b), f"chunk {c}"


def test_plain_front_step_bf16_rounds_where_jax_kernel_rounds(front):
    """The ulp bound above cannot tell a front that rounds where JAX's
    kernel rounds from one that leaves the rounding out: a one-ulp flip
    spreads through the LayerNorms to most values either way.  Over the
    first stage's tails (the stem conv and LN and the first block) most
    bf16 values still agree bit for bit where the rounding points match,
    so the share that differs (`chip_smoke.flip_share`, the largest of four
    chunks) stays within FRONT_FLIP_SHARE; the control, the plain front
    with every activation in float32 (`chip_smoke.unrounded`), must exceed
    it."""
    jp, tp = front
    cfg = C.from_fields(J_PACKED)
    jpw = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pce.packed_weights(jp, J_PACKED))
    tpw = jax.tree.map(lambda t: t.to(torch.bfloat16), tp["enc_packed"])
    control = chip_smoke.unrounded(enc.encoder_front_step_plain)
    js = pce.init_packed_state(J_PACKED, 1, jnp.bfloat16)
    ts = tc = enc.init_packed_state(cfg, 1, torch.bfloat16)
    rng = np.random.default_rng(9)
    share, share_c = 0.0, 0.0
    for _ in range(4):
        mel = rng.standard_normal((1, 4, 160)).astype(np.float32)
        js, _ = pce.encoder_front_step(jpw, js, jnp.asarray(mel), J_PACKED, interpret=True)
        ts, _ = enc.encoder_front_step_plain(tpw, ts, torch.from_numpy(mel), cfg)
        tc, _ = control(tpw, tc, torch.from_numpy(mel), cfg)
        want = [torch.from_numpy(np.array(js.stages[0].astype(jnp.float32)))]
        share = max(share, chip_smoke.flip_share(ts.stages[:1], want))
        share_c = max(share_c, chip_smoke.flip_share(tc.stages[:1], want))
    assert share <= chip_smoke.FRONT_FLIP_SHARE < share_c, (share, share_c)


# wider than the kernel's 512 threads, and a downsample product of 8
WIDER = {
    "wide": drep(J_DICT, backbone=ConvNeXtConfig(input_channels=160, depths=(1, 1, 1, 1),
                                                  dims=(192, 384, 768, 1024)),
                 quantizer=drep(J_DICT.quantizer, input_dim=1024), use_pallas_encoder=True),
    "down8": drep(J_PACKED, quantizer=drep(J_DICT.quantizer, downsample_factor=(2, 2, 2))),
}


@pytest.mark.parametrize("name", sorted(WIDER))
def test_plain_front_step_matches_jax_kernel_at_wider_geometries(name):
    """Geometries the kernel took only after its rows followed the plan:
    the plain front against JAX's interpreted kernel in float32, two
    launches' worth of frames from random tails."""
    jcfg = WIDER[name]
    cfg = C.from_fields(jcfg)
    tree = chip_smoke.front_tree_np(cfg)
    tp = P.tokenizer_params(tree, "cpu")
    tpw = enc.packed_weights(tp, cfg)
    jpw = pce.packed_weights(jax.tree.map(jnp.asarray, tree), jcfg)
    rng = np.random.default_rng(12)
    z = enc.init_packed_state(cfg, 1)
    r = lambda t: rng.standard_normal(t.shape).astype(np.float32)
    leaves = [r(z.stem), *map(r, z.stages), r(z.down)]
    ts = enc.PackedEncState(*[torch.from_numpy(leaves[0]),
                              tuple(map(torch.from_numpy, leaves[1:-1])),
                              torch.from_numpy(leaves[-1])])
    js = pce.PackedEncState(jnp.asarray(leaves[0]), tuple(map(jnp.asarray, leaves[1:-1])),
                            jnp.asarray(leaves[-1]))
    T = enc.launch_frames(cfg)
    for _ in range(2):
        mel = rng.standard_normal((1, T, 160)).astype(np.float32)
        js, jz = pce.encoder_front_step(jpw, js, jnp.asarray(mel), jcfg, interpret=True)
        ts, tz = enc.encoder_front_step(tpw, ts, torch.from_numpy(mel), cfg)
        assert tz.shape == jz.shape
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
        for a, b in zip(_packed_leaves(ts), _packed_leaves(js)):
            np.testing.assert_allclose(a, b, **TOL)
