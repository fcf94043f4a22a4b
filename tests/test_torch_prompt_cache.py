"""`VoiceConverter.infer`'s prompt cache (`runtime/pipeline.PromptCache`)
on the CPU at the tiny geometry of tests/torch_pairs.py:

* a warm call (a hit) gives the cold call's output bit for bit, under
  `concat_mel` and `avg`, with and without `ref_crop_lengths`, with the
  noise drawn from the generator or given as `spk_noise`; both hand
  `arvc.generate` the style, timbre, reference tokens and codes, and the
  generator in the state, that the uncached path gives
  (`speaker_embeddings`, `audio_codes`, `content_tokens`);
* a stored entry is not written by the calls that read it;
* one changed sample, another crop or another `collate` misses;
* past PROMPT_CACHE_ENTRIES the least recently used entry goes;
* the counters, and `Recorder.export()["prompt_cache"]` over a traced
  stretch;
* on a card (marked `gpu`), a reference given as a CUDA tensor takes the
  uncached path and is not stored.

The module imports no JAX, so the `gpu` case also runs where JAX is not
installed: `python -m pytest --noconftest -m gpu tests/test_torch_prompt_cache.py`.
"""

import numpy as np
import pytest
import torch

from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import arvc
from streamvoiceanon_tpu_torch.runtime import pipeline
from streamvoiceanon_tpu_torch.runtime.pipeline import (PROMPT_CACHE_ENTRIES, PromptCache,
                                                        VoiceConverter)
from streamvoiceanon_tpu_torch.utils import randparams as trp
from streamvoiceanon_tpu_torch.utils.profiling import tracing

SPF = 2048
SR = 44100
ALPHA = 0.7
SAMPLED = C.SamplingConfig(temperature=0.9, top_p=0.7, greedy=False, top_k_window=64)


def _wav(seed: int, frames: int) -> np.ndarray:
    """Seeded noise at 0.1, frames * 2048 samples."""
    return (np.random.default_rng(seed).standard_normal(frames * SPF) * 0.1).astype(np.float32)


SRC = _wav(1, 5)  # padded to 16 frames for the LM
REFS = [_wav(2, 6), _wav(3, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def converter():
    from torch_pairs import JCFG, trees

    t = trees()
    return P.converter_from_numpy(
        C.from_fields(JCFG), t["tokenizer_params"], t["vocoder_params"], t["arvc_params"],
        device="cpu", campplus_np=t["campplus_params"], speaker_np=t["speaker_params"])


def _gen(device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(7)


def _counts():
    return PromptCache.hits, PromptCache.misses


def _infer(vc, refs, **kw):
    kw.setdefault("sampling", SAMPLED)
    return vc.infer(SRC, refs, delay=2, alpha=ALPHA, generator=_gen(vc.device), **kw)


@pytest.fixture
def generate_calls(monkeypatch):
    """The arguments of each `arvc.generate` call and its generator's state
    on entry."""
    calls = []
    real = arvc.generate

    def recording(*a, **k):
        calls.append((a, k["generator"].get_state()))
        return real(*a, **k)

    monkeypatch.setattr(arvc, "generate", recording)
    return calls


@pytest.mark.parametrize("spk_noise", [False, True], ids=["drawn", "given"])
@pytest.mark.parametrize("crop", [None, 0.2], ids=["whole", "cropped"])
@pytest.mark.parametrize("collate", ["concat_mel", "avg"])
def test_warm_equals_cold_and_the_uncached_path(converter, generate_calls, collate, crop,
                                                spk_noise):
    vc = VoiceConverter(converter)
    noise = None
    if spk_noise:
        g = torch.Generator().manual_seed(11)
        noise = (torch.randn((1, 192), generator=g), torch.randn((1, 32, 128), generator=g))
    kw = dict(collate=collate, ref_crop_lengths=crop, spk_noise=noise)
    h0, m0 = _counts()
    cold = _infer(vc, REFS, **kw)
    assert _counts() == (h0, m0 + 1)
    (entry,) = vc.prompt_cache.entries.values()
    stored = [t.clone() for t in entry]
    warm = _infer(vc, REFS, **kw)
    assert _counts() == (h0 + 1, m0 + 1)
    assert np.array_equal(cold, warm)
    assert all(torch.equal(t, s) for t, s in zip(entry, stored))  # nothing wrote into it

    # the uncached path, as `infer` ran it before the cache
    g = _gen()
    refs = [w[: int(crop * SR)] for w in REFS] if crop is not None else REFS
    style, timbre = vc.speaker_embeddings(refs, ALPHA, g, collate, noise)
    ref_cat = torch.cat([torch.from_numpy(w) for w in refs])[None]
    codes, tokens = vc.audio_codes(ref_cat), vc.content_tokens(ref_cat)
    Tr = max(tokens.shape[1] // 8 * 8, min(8, tokens.shape[1]))
    dtype = converter.arvc_params["embedding"].dtype
    want = (tokens[:, :Tr], codes[:, :, :Tr], style.to(dtype), timbre.to(dtype))
    assert len(generate_calls) == 2
    for a, state in generate_calls:
        for got, w in zip((a[2], a[3], a[5], a[6]), want):
            assert got.dtype == w.dtype and torch.equal(got, w)
        assert torch.equal(state, g.get_state())


def test_a_changed_reference_crop_or_collate_misses(converter):
    vc = VoiceConverter(converter)
    changed = [REFS[0].copy(), REFS[1]]
    changed[0][1000] += 1e-3
    h0, m0 = _counts()
    calls = [dict(), dict(), dict(refs=changed), dict(ref_crop_lengths=0.2),
             dict(ref_crop_lengths=0.25), dict(collate="avg"), dict()]
    for kw in calls:
        _infer(vc, kw.pop("refs", REFS), sampling=C.SamplingConfig(greedy=True), **kw)
    assert _counts() == (h0 + 2, m0 + 5)
    assert len(vc.prompt_cache.entries) == 5


def test_a_host_tensor_reference_shares_the_arrays_entry(converter):
    vc = VoiceConverter(converter)
    greedy = C.SamplingConfig(greedy=True)
    h0, m0 = _counts()
    a = _infer(vc, REFS, sampling=greedy)
    b = _infer(vc, [torch.from_numpy(w) for w in REFS], sampling=greedy)
    assert _counts() == (h0 + 1, m0 + 1)
    assert np.array_equal(a, b)


def test_least_recently_used_entry_goes_past_the_bound():
    cache = PromptCache()
    h0, m0 = _counts()
    for i in range(PROMPT_CACHE_ENTRIES):
        cache.put(i, (torch.tensor(i),))
    assert cache.get(0) is not None  # 0 is now the most recent, 1 the oldest
    cache.put("new", (torch.tensor(-1),))
    assert len(cache.entries) == PROMPT_CACHE_ENTRIES
    assert 1 not in cache.entries and 0 in cache.entries and "new" in cache.entries
    assert cache.get(1) is None and cache.get(None) is None
    assert _counts() == (h0 + 1, m0 + 2)


def test_eviction_in_infer(converter, monkeypatch):
    monkeypatch.setattr(pipeline, "PROMPT_CACHE_ENTRIES", 1)
    vc = VoiceConverter(converter)
    greedy = C.SamplingConfig(greedy=True)
    h0, m0 = _counts()
    for refs in ([REFS[0]], [REFS[1]], [REFS[0]], [REFS[0]]):
        _infer(vc, refs, sampling=greedy)
    assert _counts() == (h0 + 1, m0 + 3)
    assert len(vc.prompt_cache.entries) == 1


def test_recorder_exports_the_lookups_of_its_stretch(converter, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    vc = VoiceConverter(converter)
    greedy = C.SamplingConfig(greedy=True)
    _infer(vc, REFS, sampling=greedy)  # before the stretch: not counted in it
    with tracing() as rec:
        for refs in (REFS, REFS, [REFS[1]]):
            _infer(vc, refs, sampling=greedy)
    _infer(vc, REFS, sampling=greedy)  # after it: not counted either
    assert rec.export()["prompt_cache"] == {"hits": 2, "misses": 1}
    with tracing() as rec:
        pass
    assert rec.export()["prompt_cache"] == {"hits": 0, "misses": 0}


@pytest.mark.gpu
def test_a_cuda_tensor_reference_takes_the_uncached_path():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = C.PipelineConfig()
    cv = P.converter_from_numpy(
        cfg, trp.tokenizer_params_np(cfg.tokenizer, 1), trp.vocoder_params_np(cfg.vocoder, 2),
        trp.arvc_params_np(cfg.arvc, 3), device="cuda",
        campplus_np=trp.campplus_params_np(cfg.campplus, 5),
        speaker_np=trp.speaker_encoder_params_np(cfg.speaker, 6))
    vc = VoiceConverter(cv)
    ref = _wav(2, 40)
    h0, m0 = _counts()
    a = _infer(vc, [torch.from_numpy(ref).cuda()])
    assert _counts() == (h0, m0 + 1) and not vc.prompt_cache.entries
    b = _infer(vc, [ref])
    c = _infer(vc, [ref])
    assert _counts() == (h0 + 1, m0 + 2) and len(vc.prompt_cache.entries) == 1
    assert a.shape == b.shape == c.shape and np.array_equal(b, c)
