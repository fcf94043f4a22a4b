"""The port's checkpoint loading (runtime/convert.py, the `convert` functions
of models/campplus.py and models/speaker_encoder.py, cli.build_converter)
against the JAX package's, on state_dicts in the reference's key layout.

With no published checkpoint in the repository, the state_dicts are built
from the tiny geometry's seeded random trees (tests/torch_pairs.py) by
`chip_smoke.state_dicts`, the inverse of the converters.  JAX's strict
converters must give those very trees back (exactly; within 1e-6 relative
where the HiFiGAN head's convs are weight-norm parametrizations, which
the converters resolve by a division), and the port's converted trees,
carried over by the weight bridge, must equal the bridge of JAX's
converted trees exactly.  Then `cli.build_converter` on .pth files of
those state_dicts must convert audio as JAX's CLI converter from the same
files (atol = rtol = 1e-4, `test_torch_offline.test_infer_matches_jax`'s).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from streamvoiceanon_tpu import cli as jcli
from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.models import arvc as jarvc
from streamvoiceanon_tpu.models import campplus as jcampplus
from streamvoiceanon_tpu.models import speaker_encoder as jspk
from streamvoiceanon_tpu.runtime import convert as jconvert
from streamvoiceanon_tpu_torch import cli
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import arvc, campplus, speaker_encoder
from streamvoiceanon_tpu_torch.runtime import convert
from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter
from tests.torch_pairs import JCFG, close_wave, trees

PARTS = ("tokenizer", "vocoder", "arvc", "campplus", "speaker")
TCFG = C.from_fields(JCFG)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and for numpy's BLAS: with several test
    workers on the machine, eight threads a worker oversubscribe the cores
    and every small op (and each small linear solve of the PLDA) waits for
    threads that are not running."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _random_trees():
    t = trees()
    return {"tokenizer": t["tokenizer_params"], "vocoder": t["vocoder_params"],
            "arvc": t["arvc_params"], "campplus": t["campplus_params"],
            "speaker": t["speaker_params"]}


def _converters(part):
    """(JAX converter, port converter, the JAX config, the port config)."""
    return {
        "tokenizer": (jconvert.tokenizer, convert.tokenizer, JCFG.tokenizer, TCFG.tokenizer),
        "vocoder": (jconvert.vocoder, convert.vocoder, JCFG.vocoder, TCFG.vocoder),
        "arvc": (jconvert.arvc, convert.arvc, JCFG.arvc, TCFG.arvc),
        "campplus": (jcampplus.convert, campplus.convert, JCFG.campplus, TCFG.campplus),
        "speaker": (jspk.convert, speaker_encoder.convert, JCFG.speaker, TCFG.speaker),
    }[part]


def _bridge(part, tree):
    return {"tokenizer": P.tokenizer_params, "vocoder": P.vocoder_params,
            "arvc": P.arvc_params, "campplus": P.campplus_params,
            "speaker": P.speaker_params}[part](tree, "cpu")


def _leaves(x, path=()):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], path + (k,))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, path + (i,))
    else:
        yield path, x


def _assert_trees(got, want, exact=True):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=str(k))
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=str(k))


def _jax_tree(part, sd):
    jfn, _, jcfg, _ = _converters(part)
    tree = jconvert.convert_strict(jfn, sd, jcfg)
    if part == "arvc":  # stacked layers, as randparams draws them
        tree = jarvc.prepare_params(tree)
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("part", PARTS)
def test_state_dicts_invert_jax_convert(part):
    """JAX's strict converter reads `chip_smoke.state_dicts` back into the
    very same random tree: the inverse is right by JAX's own reading."""
    tree = _random_trees()[part]
    sd = chip_smoke.state_dicts({part: tree})[part]
    _assert_trees(_jax_tree(part, sd), tree)


@pytest.mark.parametrize("part", PARTS)
def test_port_convert_equals_jax_convert(part):
    """The port's numpy tree equals JAX's leaf for leaf, and the bridge of
    each is the same tensors, exactly."""
    tree = _random_trees()[part]
    sd = chip_smoke.state_dicts({part: tree})[part]
    _, tfn, _, tcfg = _converters(part)
    torch_sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    got = convert.convert_strict(tfn, torch_sd, tcfg)
    if part == "arvc":
        got = arvc.prepare_params(got)
    want = _jax_tree(part, sd)
    _assert_trees(got, want)
    gb, wb = _bridge(part, got), _bridge(part, want)
    for (k, a), (k2, b) in zip(_leaves(gb), _leaves(wb)):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k


def test_weight_norm_is_resolved_as_jax_resolves_it():
    """The HiFiGAN head's convs as weight-norm parametrizations: the port's
    resolution equals JAX's exactly, and both give the plain weights back
    within 1e-6 relative."""
    tree = _random_trees()["vocoder"]
    sd = chip_smoke.state_dicts({"vocoder": tree}, weight_norm=True)["vocoder"]
    assert any(k.endswith("parametrizations.weight.original0") for k in sd)
    got = convert.convert_strict(convert.vocoder, sd, TCFG.vocoder)
    want = jconvert.convert_strict(jconvert.vocoder, sd, JCFG.vocoder)
    _assert_trees(got, want)
    _assert_trees(got, tree, exact=False)


def test_square_layouts_are_told_apart():
    """A transposed square weight passes a shape check, so the layouts are
    checked by value: a linear (out, in) and a ConvTranspose1d (in, out, k)
    that are square land on the bridge's layouts."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    assert np.array_equal(convert.linear({"l.weight": w}, "l")["w"], w.T)
    wt = rng.standard_normal((3, 3, 5)).astype(np.float32)  # (in, out, k)
    tree = convert.conv_transpose1d({"c.weight": wt}, "c")
    np.testing.assert_array_equal(P.trans_conv_weight(tree["w"]), wt)
    wc = rng.standard_normal((3, 3, 5)).astype(np.float32)  # (out, in, k)
    np.testing.assert_array_equal(P.conv_weight(convert.conv1d({"c.weight": wc}, "c")["w"]), wc)


def test_extra_key_raises_and_lenient_reports(tmp_path, capsys, monkeypatch):
    tree = _random_trees()["campplus"]
    sd = chip_smoke.state_dicts({"campplus": tree})["campplus"]
    sd["xvector.orphan.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="xvector.orphan.weight"):
        convert.convert_strict(campplus.convert, sd, TCFG.campplus)
    with pytest.raises(KeyError, match="xvector.orphan.weight"):
        jconvert.convert_strict(jcampplus.convert, sd, JCFG.campplus)
    params, leftover = convert.convert_with_coverage(campplus.convert, sd, TCFG.campplus)
    assert leftover == ["xvector.orphan.weight"]
    _assert_trees(params, tree)
    chip_smoke.write_checkpoints(tmp_path, chip_smoke.state_dicts(_random_trees()))
    bad = torch.load(tmp_path / cli.CHECKPOINTS["campplus"], weights_only=True)
    bad["xvector.orphan.weight"] = torch.zeros(3)
    torch.save(bad, tmp_path / cli.CHECKPOINTS["campplus"])
    monkeypatch.setattr(C, "PipelineConfig", lambda: TCFG)
    with pytest.raises(KeyError, match="1 unconsumed key.*xvector.orphan.weight"):
        cli.build_converter(str(tmp_path), device="cpu")
    cv = cli.build_converter(str(tmp_path), device="cpu", lenient=True)
    assert "xvector.orphan.weight" in capsys.readouterr().err
    assert cv.campplus_params is not None


def test_build_converter_matches_jax_cli(tmp_path, monkeypatch):
    """`cli.build_converter(dir, device="cpu")` on the five published file
    names equals `converter_from_numpy` of the random trees leaf for leaf,
    and converts a source as the JAX CLI's converter from the same files."""
    t = _random_trees()
    chip_smoke.write_checkpoints(tmp_path, chip_smoke.state_dicts(t))
    monkeypatch.setattr(C, "PipelineConfig", lambda: TCFG)
    monkeypatch.setattr(JC, "PipelineConfig", lambda: JCFG)
    tcv = cli.build_converter(str(tmp_path), device="cpu")
    ref = P.converter_from_numpy(TCFG, t["tokenizer"], t["vocoder"], t["arvc"],
                                 device="cpu", campplus_np=t["campplus"],
                                 speaker_np=t["speaker"])
    for name in ("tokenizer_params", "vocoder_params", "arvc_params", "campplus_params",
                 "speaker_params"):
        for (k, a), (k2, b) in zip(_leaves(getattr(tcv, name)), _leaves(getattr(ref, name))):
            assert k == k2 and torch.equal(a, b), (name, k)
    jcv = jcli.build_converter_from_ckpts(str(tmp_path))
    rng = np.random.default_rng(3)
    src = (rng.standard_normal(4 * 2048 + 300) * 0.1).astype(np.float32)
    refw = (rng.standard_normal(8 * 2048) * 0.1).astype(np.float32)
    a = jcv.infer(src, [refw], delay=2, key=jax.random.PRNGKey(0))
    b = VoiceConverter(tcv).infer(src, [refw], delay=2)
    assert a.shape == b.shape == (4 * 2048,)
    close_wave(b, a)


def test_x_vector_matches_jax():
    """The speaker encoder's x-vector head (off the timbre path) on the
    converted trees, within 1e-4."""
    import jax.numpy as jnp

    tree = _random_trees()["speaker"]
    sd = chip_smoke.state_dicts({"speaker": tree})["speaker"]
    jtree = jconvert.convert_strict(jspk.convert, sd, JCFG.speaker)
    ptree = P.speaker_params(convert.convert_strict(speaker_encoder.convert, sd,
                                                    TCFG.speaker), "cpu")
    mel = np.random.default_rng(4).standard_normal((2, 40, TCFG.speaker.input_dim)) \
        .astype(np.float32)
    a = np.asarray(jspk.x_vector(jtree, jnp.asarray(mel)))
    b = speaker_encoder.x_vector(ptree, torch.from_numpy(mel)).numpy()
    assert b.shape == a.shape == (2, TCFG.speaker.out_dim)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * np.abs(a).max())
