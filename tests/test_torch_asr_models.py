"""The port's ASR-side models against the JAX package's, on the CPU at tiny
sizes: the ConvNeXt encoder's global conditioning, the tokenizer's
training forward, the w2v-BERT conformer, its featurisation and its
checkpoint converter, the ASR decoder, the CTC loss and the compact
recogniser's SAME-padded convs.

Weights are drawn once (numpy, or JAX's own init) and carried to the port
by `streamvoiceanon_tpu_torch.params`; inputs come from numpy seeds.

Tolerances: content-token indices and greedy decoder tokens exactly; float
outputs within 1e-5 (1e-4 of the largest value where a long reduction
feeds them: the conformer, the features after the DFT and the log,
gradients); the converter bit-equal to JAX's, and within 1e-4 of the
Hugging Face model's hidden states; the CTC loss equal to
`optax.ctc_loss` within 1e-5 relative, on a label longer than its frames
allow as well, its gradient within 1e-5 of the largest (within 1e-2 on
the infeasible sample in float32, and everything within 1e-9 in float64:
see the test).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.evals import asr_eval_train as jaet
from streamvoiceanon_tpu.models import asr_decoder as jad
from streamvoiceanon_tpu.models import convnext as jconvnext
from streamvoiceanon_tpu.models import tokenizer as jtok
from streamvoiceanon_tpu.models import w2v_bert_native as jwn
from streamvoiceanon_tpu.utils.tiny import tiny_config
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.evals import asr_eval_train as taet
from streamvoiceanon_tpu_torch.models import asr_decoder as tad
from streamvoiceanon_tpu_torch.models import convnext as tconvnext
from streamvoiceanon_tpu_torch.models import tokenizer as ttok
from streamvoiceanon_tpu_torch.models import w2v_bert_native as twn
from streamvoiceanon_tpu_torch.ops.ctc import ctc_loss
from streamvoiceanon_tpu_torch.utils import randparams as trp
from streamvoiceanon_tpu_torch.utils.tree import flatten

SPF = 2048
TINY_W2V = dict(feat_dim=160, hidden=32, n_layers=3, n_heads=4, intermediate=64,
                conv_kernel=7, left_max_pos=4, right_max_pos=2)
TINY_DEC = dict(hidden_dim=32, num_heads=2, depth=2, block_size=128, in_channels=32,
                n_vocab=60, bos_id=50, eos_id=49)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    machine's cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _close(got, want, tol=1e-5, rel=False):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = tol * max(np.abs(want).max(), 1e-30) if rel else tol
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _tok_cfg(gin: int = 8):
    jcfg = tiny_config()
    head = JC.ConvNeXtConfig(input_channels=32, depths=(1, 1), dims=(24, 40), gin_channels=gin)
    return JC.replace(jcfg.tokenizer, head=head)


@pytest.fixture(scope="module")
def tok():
    """The tiny tokenizer with a conditioned head: (JAX config, port config,
    JAX tree, port tree)."""
    jt = _tok_cfg()
    tt = C.from_fields(jt)
    tree = trp.tokenizer_params_np(tt, 5, with_head=True)
    return jt, tt, jax.tree.map(jnp.asarray, tree), P.tokenizer_params(tree, "cpu",
                                                                       with_head=True)


@pytest.mark.parametrize("with_g", [False, True])
def test_convnext_encoder_with_and_without_global_conditioning(tok, with_g):
    jt, tt, jp, tp = tok
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    g = rng.standard_normal((2, 1, 8)).astype(np.float32) if with_g else None
    want = jconvnext.convnext_encoder_apply(jp["head"], jt.head, jnp.asarray(x),
                                            g=None if g is None else jnp.asarray(g))
    got = tconvnext.convnext_encoder_apply(tp["head"], tt.head, torch.from_numpy(x),
                                           g=None if g is None else torch.from_numpy(g))
    _close(got, want)
    if with_g:  # the conditioning reaches the output
        plain = tconvnext.convnext_encoder_apply(tp["head"], tt.head, torch.from_numpy(x))
        assert not torch.allclose(plain, got)


def _waves(B=2, frames=6, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, frames * SPF)) * 0.1).astype(
        np.float32)


def test_quantized_latents_match_jax(tok):
    jt, tt, jp, tp = tok
    w = _waves()
    zq_j, idx_j = jtok.quantized_latents(jp, jt, jnp.asarray(w))
    zq_t, idx_t = ttok.quantized_latents(tp, tt, torch.from_numpy(w))
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(zq_t, zq_j)


@pytest.mark.parametrize("target_len", [4, 6, 23])
def test_training_forward_matches_jax(tok, target_len):
    """Below, at and above the latents' length (nearest-neighbour resample),
    with the global conditioning."""
    jt, tt, jp, tp = tok
    w = _waves(seed=2)
    g = np.random.default_rng(3).standard_normal((2, 1, 8)).astype(np.float32)
    pj, vj = jtok.forward(jp, jt, jnp.asarray(w), target_len=target_len, g=jnp.asarray(g))
    pt, vt = ttok.forward(tp, tt, torch.from_numpy(w), target_len=target_len,
                          g=torch.from_numpy(g))
    assert pt.shape == (2, target_len, 40)
    np.testing.assert_array_equal(vt["codes"].numpy(), np.asarray(vj["codes"]))
    _close(vt["latents"], vj["latents"])
    _close(pt, pj)


# ---------------------------------------------------------------------------
# the conformer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conformer():
    cfg = jwn.W2VBertConfig(**TINY_W2V)
    tree = _np(jwn.init_params(jax.random.PRNGKey(3), cfg))
    return cfg, twn.W2VBertConfig(**TINY_W2V), tree, P.w2v_bert_params(tree, "cpu")


@pytest.mark.parametrize("masked,layers", [(False, None), (True, None), (True, 2)])
def test_conformer_matches_jax(conformer, masked, layers):
    jcfg, tcfg, tree, tp = conformer
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 19, 160)).astype(np.float32)
    mask = np.ones((2, 19), np.int32)
    mask[1, 12:] = 0
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = jwn.apply(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(feats), jm, layers)
    got = twn.apply(tp, tcfg, torch.from_numpy(feats), tm, layers)
    _close(got, want, 1e-4, rel=True)


def _speechlike(seconds, f0, seed, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    w = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6)) * env * 0.2
    return (w + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def test_stacked_features_match_jax():
    """Two utterances padded into one batch, the shorter one's valid length
    given (an odd frame count: its half-valid last row masked out)."""
    a, b = _speechlike(1.0, 140.0, 0), _speechlike(0.71, 210.0, 1)
    wav = np.zeros((2, len(a)), np.float32)
    wav[0], wav[1, : len(b)] = a, b
    lens = np.array([len(a), len(b)], np.int32)
    fj, mj = jwn.stacked_features(jnp.asarray(wav), jnp.asarray(lens))
    ft, mt = twn.stacked_features(torch.from_numpy(wav), torch.from_numpy(lens))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.dtype == torch.int32 and int(mt[1].sum()) < int(mt[0].sum())
    _close(ft, fj, 1e-4, rel=True)


def _hf_pair():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Wav2Vec2BertConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=4, intermediate_size=64,
        feature_projection_input_dim=16, conv_depthwise_kernel_size=7,
        left_max_position_embeddings=4, right_max_position_embeddings=2,
        position_embeddings_type="relative_key", hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, conformer_conv_dropout=0.0,
        layerdrop=0.0, mask_time_prob=0.0, mask_feature_prob=0.0)
    torch.manual_seed(0)
    ref = transformers.Wav2Vec2BertModel(hf_cfg).eval()
    kw = dict(feat_dim=16, hidden=32, n_layers=3, n_heads=4, intermediate=64, conv_kernel=7,
              left_max_pos=4, right_max_pos=2)
    return ref, jwn.W2VBertConfig(**kw), twn.W2VBertConfig(**kw)


def test_convert_matches_jax_and_hugging_face():
    ref, jcfg, tcfg = _hf_pair()
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    want = jwn.convert(sd, jcfg)
    got = twn.convert(ref.state_dict(), tcfg)  # tensors are taken as well
    fw, fg = flatten(want), flatten(got)
    assert fw.keys() == fg.keys()
    for k in fw:
        assert fg[k].dtype == np.float32 and np.array_equal(fg[k], fw[k]), k
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 17, 16)).astype(np.float32)
    mask = np.ones((2, 17), np.int64)
    mask[1, 12:] = 0
    with torch.no_grad():
        hf = ref(input_features=torch.from_numpy(feats),
                 attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    out = twn.apply(P.w2v_bert_params(got, "cpu"), tcfg, torch.from_numpy(feats),
                    torch.from_numpy(mask))
    _close(out[0], hf[0], 1e-4, rel=True)
    _close(out[1, :12], hf[1, :12], 1e-4, rel=True)  # HF leaves padded rows unmasked


# ---------------------------------------------------------------------------
# the ASR decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoder():
    jcfg = jad.ASRDecoderConfig(**TINY_DEC)
    tree = _np(jad.init(jax.random.PRNGKey(5), jcfg))
    return jcfg, tad.ASRDecoderConfig(**TINY_DEC), tree


def test_asr_decoder_loss_and_gradients_match_jax(decoder):
    jcfg, tcfg, tree = decoder
    rng = np.random.default_rng(6)
    audio = rng.standard_normal((3, 7, 32)).astype(np.float32)
    alens = np.array([7, 5, 3], np.int32)
    text = rng.integers(0, 48, (3, 6)).astype(np.int32)
    tlens = np.array([6, 2, 4], np.int32)

    def jloss(p):
        return jad.forward(p, jcfg, jnp.asarray(audio), jnp.asarray(alens), jnp.asarray(text),
                           jnp.asarray(tlens))

    want, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree))
    tp = {k: v.requires_grad_(True) for k, v in flatten(P.asr_decoder_params(tree, "cpu")).items()}
    from streamvoiceanon_tpu_torch.train.step import grads_of

    def unflat(flat):
        out = {}
        for path, v in flat.items():
            d = out
            for key in path[:-1]:
                d = d.setdefault(key, {})
            d[path[-1]] = v
        return out

    params = unflat(tp)
    got = tad.forward(params, tcfg, torch.from_numpy(audio), torch.from_numpy(alens),
                      torch.from_numpy(text), torch.from_numpy(tlens))
    _close(got, want, 1e-5)
    grads = grads_of(got, params)
    for k, g in flatten(_np(jg)).items():
        _close(grads[k], g, 1e-4, rel=True)


def test_greedy_decode_tokens_match_jax(decoder):
    jcfg, tcfg, tree = decoder
    audio = np.random.default_rng(7).standard_normal((1, 5, 32)).astype(np.float32)
    want = jad.greedy_decode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(audio),
                             max_len=12)
    got = tad.greedy_decode(P.asr_decoder_params(tree, "cpu"), tcfg, torch.from_numpy(audio),
                            max_len=12)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the CTC loss and the compact recogniser's convs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ctc_loss_and_gradient_match_optax_on_feasible_and_infeasible_labels(dtype):
    """Sample 2 holds 5 labels in 3 frames: optax's loss is large and
    finite (log 0 stands as -1e5), torch's own ctc_loss would be inf.  In
    float32 that sample's alphas lie near -1e5, where float32's spacing is
    0.0078, so either implementation's gradient there carries rounding of
    about 1 % (a flip of one rounding moves exp(a - b) by 0.8 %): it is held
    within 1e-2 in float32, and with every other value within 1e-9 in
    float64 (JAX under `enable_x64`)."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 12, 6)).astype(dtype)
    lpad = np.zeros((3, 12), dtype)
    lpad[1, 9:] = 1.0
    lpad[2, 3:] = 1.0
    labels = np.array([[1, 2, 2, 3, 0], [4, 4, 1, 0, 0], [1, 2, 3, 4, 5]], np.int32)
    ypad = np.array([[0, 0, 0, 0, 1], [0, 0, 0, 1, 1], [0, 0, 0, 0, 0]], dtype)

    with jax.enable_x64(dtype == np.float64):
        def jl(lg):
            return optax.ctc_loss(lg, jnp.asarray(lpad), jnp.asarray(labels), jnp.asarray(ypad))

        want = np.asarray(jl(jnp.asarray(logits)))
        wgrad = np.asarray(jax.grad(lambda lg: jnp.sum(jl(lg)))(jnp.asarray(logits)))
    assert want.dtype == dtype
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_loss(lg, torch.from_numpy(lpad), torch.from_numpy(labels), torch.from_numpy(ypad))
    assert want[2] > 1e4 and np.isfinite(want[2])
    tol = 1e-5 if dtype == np.float32 else 1e-9
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol)
    (ggrad,) = torch.autograd.grad(got.sum(), lg)
    _close(ggrad[:2], wgrad[:2], tol, rel=True)
    _close(ggrad[2], wgrad[2], 1e-2 if dtype == np.float32 else tol, rel=True)


@pytest.mark.parametrize("T", [16, 17])
def test_same_padded_stride_2_conv_matches_jax(T):
    """XLA's SAME at stride 2, kernel 3: (0, 1) padding on an even length
    (where a symmetric padding of 1 is wrong), (1, 1) on an odd one."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), window_strides=(2,),
                                        padding="SAME",
                                        dimension_numbers=("NTC", "TIO", "NTC")) + b
    wt = torch.from_numpy(P.conv_weight(w))
    got = taet.same_conv(torch.from_numpy(x), wt, torch.from_numpy(b), 2)
    _close(got, want, 1e-5)
    symmetric = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2), wt,
                                           torch.from_numpy(b), stride=2, padding=1)
    assert (T % 2 == 1) == np.allclose(symmetric.transpose(1, 2).numpy(), np.asarray(want),
                                       atol=1e-5)


def test_compact_recogniser_forward_matches_jax():
    cfg = jaet.ASREvalConfig(dim=32, n_heads=4, n_layers=2)
    tree = _np(jaet.init_params(jax.random.PRNGKey(9), cfg, 7))
    rng = np.random.default_rng(10)
    feat = rng.standard_normal((2, 30, 80)).astype(np.float32)
    mask = np.ones((2, 30), bool)
    mask[1, 21:] = False
    lj, mj = jaet.forward(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(feat),
                          jnp.asarray(mask))
    lt, mt = taet.forward(P.asr_eval_params(tree, "cpu"), taet.ASREvalConfig(**vars(cfg)),
                          torch.from_numpy(feat), torch.from_numpy(mask))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    _close(lt, lj, 1e-4, rel=True)
