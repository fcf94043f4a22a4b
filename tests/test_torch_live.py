"""The port's operator layer on the CPU: `LiveApp` (against JAX's: the
reference set from audio and from precomputed embeddings, the preset hot
switch, the reference hot swap), the app live on the synthetic duplex
loop, the streaming resampler, the presets, and `cli convert` (offline,
simulated streaming, window mode; against JAX's CLI) and `cli live` end to
end on the tiny converter.

Waveforms within atol = rtol = 1e-4 and 1e-4 of the largest sample; the
CLI's written 16-bit wavs within two steps of 1/32767 more.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from streamvoiceanon_tpu import cli as jcli
from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.runtime import presets as jpresets
from streamvoiceanon_tpu.runtime.live import LiveApp as JaxLiveApp
from streamvoiceanon_tpu_torch import cli
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch.audio.io import write_wav
from streamvoiceanon_tpu_torch.runtime import presets
from streamvoiceanon_tpu_torch.runtime.live import (LiveApp, StreamingResampler,
                                                    SyntheticDuplex, list_audio_devices,
                                                    monitor)
from torch_pairs import SPF, chunk, close_wave, pair, prompt, source


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here: with several test
    workers on the machine, eight threads a worker oversubscribe the cores
    and every small op waits for threads that are not running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return pair()


def _voice(seed: int, seconds: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 44100)) / 44100.0
    wav = sum(np.sin(2 * np.pi * 180.0 * h * t + rng.uniform(0, 6.28)) / h for h in range(1, 6))
    return (0.1 * wav + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _same_chunks(japp, tapp, src, n):
    for i in range(n):
        close_wave(tapp.engine.session.process_chunk(chunk(src, i)),
                   np.asarray(japp.engine.session.process_chunk(chunk(src, i))))


def test_live_app_matches_jax_across_switches(tiny):
    """Both apps: a reference from audio (max_quality: alpha 1, no noise),
    then the preset hot switch (a new delay; the stored reference carries
    no new noise), then a hot swap to a precomputed reference; after each,
    warm-up and the same chunks."""
    jcv, tcv = tiny
    japp, tapp = JaxLiveApp(jcv, "max_quality"), LiveApp(tcv, "max_quality")
    ref = _voice(1, 1.0)
    japp.set_reference([ref], "spk_a")
    tapp.set_reference([ref], "spk_a")
    src = source(2, 5)
    for app in (japp, tapp):
        app.warm_up()
    _same_chunks(japp, tapp, src, 5)
    for app in (japp, tapp):
        app.set_preset("balanced")
        app.warm_up()
    assert tapp.engine.session.delay == 2 and tapp.preset_name == "balanced"
    _same_chunks(japp, tapp, src, 5)
    # a prompt of the reference's 21 frames: JAX compiles no new shapes
    style, timbre, tokens, codes = prompt(jcv, seed=3, frames=21)
    japp.set_reference_artifacts(*(jnp.asarray(a) for a in (style, timbre, tokens, codes)),
                                 name="spk_b")
    tapp.set_reference_artifacts(style, timbre, tokens, codes, name="spk_b")
    for app in (japp, tapp):
        app.warm_up()
    assert tapp.reference_name == "spk_b"
    _same_chunks(japp, tapp, src, 5)
    with pytest.raises(KeyError):
        tapp.set_preset("nope")
    assert tapp.presets() == sorted(C.PRESETS)


def test_live_synthetic_duplex_and_hot_switch(tiny):
    """The app live: warm-up with progress, the synthetic duplex loop at
    blocks that are no chunk multiple, the status line; then a preset
    switch while streaming restarts the engine on the new session."""
    jcv, tcv = tiny
    app = LiveApp(tcv, "balanced")
    app.set_reference_artifacts(*prompt(jcv, seed=4), name="spk_a")
    progress = []
    app.warm_up(progress=lambda i, n: progress.append((i, n)))
    assert progress and progress[-1][0] == progress[-1][1] == app.engine.session.delay + 3
    src = source(5, 90)
    duplex = SyntheticDuplex(app.engine, src, block_frames=1536)
    app.start()
    duplex.start()
    with open(os.devnull, "w") as null:
        st = monitor(app, 1.5, interval_s=0.25, out=null)
        duplex.stop()
        assert st.state == "streaming" and st.chunks_processed > 5, st
        assert "preset=balanced" in st.line() and "spk_a" in st.line()
        out = duplex.output()
        assert len(out) > 0 and np.isfinite(out).all() and np.any(out != 0)
        app.set_preset("low_latency")
        assert app.engine.session.delay == 1
        duplex = SyntheticDuplex(app.engine, src, block_frames=2048)
        duplex.start()
        st = monitor(app, 0.8, interval_s=0.2, out=null)
        duplex.stop()
    app.stop()
    assert st.chunks_processed > 0 and "preset=low_latency" in st.line()


def test_streaming_resampler_matches_offline():
    sr_in, sr_out = 48000, 44100
    x = np.sin(2 * np.pi * 440 * np.arange(sr_in) / sr_in).astype(np.float32)
    rs = StreamingResampler(sr_in, sr_out)
    y = np.concatenate([rs(x[i : i + 1000]) for i in range(0, len(x), 1000)])
    assert abs(len(y) - sr_out) <= 2
    ref = np.interp(np.arange(len(y)) * sr_in / sr_out, np.arange(len(x)), x)
    np.testing.assert_allclose(y, ref[: len(y)], atol=5e-3)


def test_list_audio_devices_without_sounddevice():
    assert list_audio_devices() == {}


def test_presets_match_jax(tmp_path):
    assert presets.list_presets() == jpresets.list_presets()
    path = presets.save_inuse(C.preset("low_latency"), str(tmp_path / "inuse" / "c.json"))
    assert presets.load_inuse(path) == C.preset("low_latency")
    assert jpresets.load_inuse(path) == JC.preset("low_latency")


def _greedy(monkeypatch):
    """Both CLIs sample from SamplingConfig(temperature, top_p); torch's
    generators never equal threefry, so the comparison decodes greedily."""
    for mod in (C, JC):
        cls = mod.SamplingConfig
        monkeypatch.setattr(mod, "SamplingConfig", lambda _c=cls, **kw: _c(greedy=True))


@pytest.mark.parametrize("mode", [[], ["--simulate-streaming"],
                                  ["--simulate-streaming", "--window-mode"]],
                         ids=["offline", "streaming", "window"])
def test_cli_convert_matches_jax(tiny, tmp_path, monkeypatch, mode):
    """Both CLIs convert the same files; the waves they write are compared
    as written (the tiny random vocoder's output is far below one 16-bit
    step, so also as the float arrays handed to the writer)."""
    from streamvoiceanon_tpu.audio import io as jio
    from streamvoiceanon_tpu_torch.audio import io as tio

    jcv, tcv = tiny
    monkeypatch.setattr(jcli, "build_converter_from_ckpts", lambda *a, **k: jcv)
    monkeypatch.setattr(cli, "build_converter", lambda *a, **k: tcv)
    _greedy(monkeypatch)
    written = {}
    for mod in (jio, tio):
        def spy(path, wav, sr, _w=mod.write_wav):
            written[os.path.basename(path)] = np.asarray(wav)
            _w(path, wav, sr)
        monkeypatch.setattr(mod, "write_wav", spy)
    src, ref = tmp_path / "src.wav", tmp_path / "ref.wav"
    write_wav(str(src), _voice(6, 0.6), 44100)
    write_wav(str(ref), _voice(7, 1.0), 44100)
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        main(["convert", "--src", str(src), "--ref", str(ref),
              "--out", str(tmp_path / f"{name}.wav")] + mode)
    a, b = written["jax.wav"], written["port.wav"]
    assert b.shape == a.shape and len(b) >= 12 * SPF and np.abs(a).max() > 0
    close_wave(b, a)
    (sr_a, wa), (sr_b, wb) = (wavfile.read(str(tmp_path / f"{k}.wav")) for k in ("jax", "port"))
    assert sr_a == sr_b == 44100 and wb.shape == b.shape
    assert np.abs(wb.astype(np.int32) - wa).max() <= 2


def test_cli_live_end_to_end(tiny, tmp_path, monkeypatch, capsys):
    """`cli live` against the synthetic duplex loop with a scheduled preset
    hot switch, the reference set from audio."""
    _, tcv = tiny
    monkeypatch.setattr(cli, "build_converter", lambda *a, **k: tcv)
    ref = tmp_path / "ref.wav"
    write_wav(str(ref), _voice(8, 1.0), 44100)
    cli.main(["live", "--ref", str(ref), "--src", "noise", "--duration", "1.2",
              "--block", "1536", "--switch-preset", "low_latency@0.6"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert "preset=low_latency" in last and "chunks=" in last


def test_cli_refuses_checkpoints_and_runs_on_the_cpu_when_asked(monkeypatch):
    """A checkpoint directory without the published files is refused (the
    loading itself is held against JAX's in tests/test_torch_convert.py)."""
    with pytest.raises(FileNotFoundError, match="asr_s2s_bsq_8192_causal_down_whisper.pth"):
        cli.build_converter("/some/dir", device="cpu")
    cli.main(["live", "--list-devices", "--device", "cpu"])
