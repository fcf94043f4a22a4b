"""Operator-facing live runtime, as the JAX package's runtime/live.py (the
reference GUI's control surface without tkinter):

* reference hot-swap with prompt re-prefill and stream-state rebuild,
* runtime preset switching (`config.PRESETS`, `runtime/presets.py`),
* warm-up with progress reporting,
* the status-bar numbers (sample rate, inference ms, real-time factor) plus
  the rings' xrun counters, rendered as a one-line terminal monitor,
* audio device enumeration, selection and sample-rate adaptation through
  a sounddevice adapter that activates when the library is installed; a
  synthetic duplex loop stands in for the hardware stream.

The compute core (SPSC rings, compute and fetch threads) is
runtime/realtime.py; this module is the operator layer around it.
Random draws (the anonymisation noise of a reference, each session's
sampling generator) come from seeds drawn from the app's `seed`.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from streamvoiceanon_tpu_torch.config import PRESETS, SamplingConfig, StreamConfig, preset
from streamvoiceanon_tpu_torch.params import Converter
from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter
from streamvoiceanon_tpu_torch.runtime.realtime import RealtimeEngine
from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession


# ---------------------------------------------------------------------------
# status
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LiveStatus:
    """One snapshot of the status bar."""

    state: str  # "idle" | "warming" | "streaming"
    preset: str
    reference: str
    sample_rate: int
    chunks_processed: int
    infer_ms: float  # last chunk's read -> delivery time
    throughput_rtf: float  # wall time over the audio time of the chunks since the last status
    in_overruns: int
    out_underruns: int
    # nucleus-truncation events of the windowed top-p sampler
    # (StreamSession.truncation_count); nonzero: distributions were clipped,
    # set top_k_window=0 for the exact filter
    nucleus_truncations: int = 0

    def line(self) -> str:
        trunc = (f" | TRUNC={self.nucleus_truncations}"
                 if self.nucleus_truncations else "")
        return (
            f"[{self.state:9s}] preset={self.preset} ref={self.reference or '-'} "
            f"{self.sample_rate} Hz | chunks={self.chunks_processed} "
            f"infer={self.infer_ms:6.1f} ms | RTF={self.throughput_rtf:5.2f} | "
            f"xruns in={self.in_overruns} out={self.out_underruns}{trunc}"
        )


# ---------------------------------------------------------------------------
# the operator app
# ---------------------------------------------------------------------------


class LiveApp:
    """Owns a converter, a StreamSession and a RealtimeEngine, and exposes
    the GUI's operations: set_reference (hot-swap re-prefill), set_preset
    (runtime operating-point switch), warm_up, start/stop, status."""

    def __init__(
        self,
        converter: Converter,
        preset_name: str = "balanced",
        *,
        sampling: Optional[SamplingConfig] = None,
        ring_seconds: float = 2.0,
        seed: int = 0,
    ):
        self.cv = converter
        self.scfg: StreamConfig = preset(preset_name)
        self.preset_name = preset_name
        self.sampling = sampling or converter.cfg.sampling
        self.ring_seconds = ring_seconds
        self._seeds = np.random.default_rng(seed)
        self.reference_name = ""
        self._ref_artifacts = None  # (style, timbre, ref_tokens, ref_codes)
        self.engine: Optional[RealtimeEngine] = None
        self._lock = threading.Lock()
        self._state = "idle"
        self._warmed = False
        # throughput window for status()
        self._win_t = time.perf_counter()
        self._win_chunks = 0

    def _seed(self) -> int:
        return int(self._seeds.integers(1 << 62))

    # ---- reference management ---------------------------------------------

    def set_reference(self, ref_wavs: Sequence[np.ndarray], name: str) -> None:
        """Speaker embeddings and prompt tokens and codes of a new reference,
        then the prompt re-prefilled.  The encoders here are plain PyTorch
        (none of the kernels that keep scratch), so they may run beside a
        live engine."""
        vc = VoiceConverter(self.cv)
        wavs = list(ref_wavs) if isinstance(ref_wavs, (list, tuple)) else [ref_wavs]
        gen = torch.Generator(device=self.cv.device).manual_seed(self._seed())
        style, timbre = vc.speaker_embeddings(wavs, self.scfg.alpha, gen)
        cat = torch.cat([vc._tensor(w) for w in wavs])[None]
        ref_tokens = vc.content_tokens(cat)
        ref_codes = vc.audio_codes(cat)
        with self._lock:
            self._ref_artifacts = (style, timbre, ref_tokens, ref_codes)
            self.reference_name = name
            self._rebuild_session_locked()

    def set_reference_artifacts(self, style, timbre, ref_tokens, ref_codes,
                                name: str = "precomputed") -> None:
        """Reference hot-swap from precomputed embeddings and prompt tokens
        (e.g. an anonymisation pseudo-speaker pool entry): no speaker
        encoder, the same re-prefill."""
        with self._lock:
            self._ref_artifacts = (style, timbre, ref_tokens, ref_codes)
            self.reference_name = name
            self._rebuild_session_locked()

    def set_preset(self, name: str) -> None:
        """Switch the operating point at run time; keeps the current
        reference and re-prefills."""
        scfg = preset(name)  # raises on an unknown name
        with self._lock:
            self.scfg = scfg
            self.preset_name = name
            if self._ref_artifacts is not None:
                self._rebuild_session_locked()

    @staticmethod
    def presets() -> list:
        return sorted(PRESETS)

    def _rebuild_session_locked(self) -> None:
        """(Re)create the StreamSession from the stored reference and swap
        it into the engine.  A running engine is stopped first: building
        and warming the new session launches kernels, which must not run on
        two threads at once (their wrappers keep scratch across calls)."""
        was_running = self.engine is not None and self._state == "streaming"
        if was_running:
            self.engine.stop()
        style, timbre, ref_tokens, ref_codes = self._ref_artifacts
        sess = StreamSession(self.cv, self.scfg, sampling=self.sampling, seed=self._seed(),
                             style=style, timbre=timbre, ref_tokens=ref_tokens,
                             ref_codes=ref_codes)
        self.engine = RealtimeEngine(sess, ring_seconds=self.ring_seconds)
        self._warmed = False
        if was_running:
            self.warm_up()
            self.engine.start()

    # ---- lifecycle ---------------------------------------------------------

    def warm_up(self, progress: Optional[Callable[[int, int], None]] = None) -> None:
        """Run every chunk phase on silent input before going live (the
        GUI's warm-up bar); on the card the kernel libraries build and load
        here."""
        if self.engine is None:
            raise RuntimeError("no reference set — call set_reference first")
        self._state = "warming"
        n = self.engine.session.delay + 3
        for i in range(n):
            self.engine.session.process_chunk(np.zeros(self.engine.chunk, np.float32))
            if progress is not None:
                progress(i + 1, n)
        self._warmed = True
        self._state = "idle"

    def start(self) -> None:
        if self.engine is None:
            raise RuntimeError("no reference set — call set_reference first")
        if not self._warmed:
            self.warm_up()
        self.engine.start()
        self._state = "streaming"
        self._win_t = time.perf_counter()
        self._win_chunks = self.engine.chunks_processed

    def stop(self) -> None:
        if self.engine is not None:
            self.engine.stop()
        self._state = "idle"

    # ---- status ------------------------------------------------------------

    def status(self) -> LiveStatus:
        eng = self.engine
        now = time.perf_counter()
        chunks = eng.chunks_processed if eng else 0
        frame_s = eng.chunk / self.cv.cfg.sample_rate if eng is not None else 0.0
        dt, dc = now - self._win_t, chunks - self._win_chunks
        rtf = (dt / (dc * frame_s)) if (dc > 0 and frame_s > 0) else 0.0
        self._win_t, self._win_chunks = now, chunks
        return LiveStatus(
            state=self._state,
            preset=self.preset_name,
            reference=self.reference_name,
            sample_rate=self.cv.cfg.sample_rate,
            chunks_processed=chunks,
            infer_ms=eng.last_latency_ms if eng else 0.0,
            throughput_rtf=rtf,
            in_overruns=eng.in_ring.overruns() if eng else 0,
            out_underruns=eng.out_ring.underruns() if eng else 0,
            # one scalar read from the device a status tick, off the chunk path
            nucleus_truncations=eng.session.truncation_count if eng is not None else 0,
        )


# ---------------------------------------------------------------------------
# audio device adapter (sounddevice, optional)
# ---------------------------------------------------------------------------


def have_sounddevice() -> bool:
    try:
        import sounddevice  # noqa: F401

        return True
    except Exception:
        return False


def list_audio_devices(hostapi_name: Optional[str] = None) -> dict:
    """Hostapi + input/output device enumeration
    (real-time-gui.py:1362-1393).  Returns {} when sounddevice is absent."""
    if not have_sounddevice():
        return {}
    import sounddevice as sd

    hostapis = list(sd.query_hostapis())
    names = [h["name"] for h in hostapis]
    if hostapi_name not in names:
        hostapi_name = names[0] if names else ""
    devices = list(sd.query_devices())
    for h in hostapis:
        for idx in h["devices"]:
            devices[idx]["hostapi_name"] = h["name"]
    sel = [d for d in devices if d.get("hostapi_name") == hostapi_name]
    return {
        "hostapis": names,
        "hostapi": hostapi_name,
        "inputs": [d["name"] for d in sel if d["max_input_channels"] > 0],
        "outputs": [d["name"] for d in sel if d["max_output_channels"] > 0],
    }


class StreamingResampler:
    """Stateful linear-interpolation resampler for the device adapter
    (sample-rate adaptation; reference uses torchaudio Resample objects,
    real-time-gui.py:1212-1233).  Good enough for operator monitoring; the
    model-facing path resamples with the windowed-sinc kernel in
    audio/resample.py."""

    def __init__(self, sr_in: int, sr_out: int):
        self.ratio = sr_out / sr_in
        self._tail = np.zeros(1, np.float32)  # last input sample
        self._pos = 1.0  # fractional read position into [tail, block]

    def __call__(self, block: np.ndarray) -> np.ndarray:
        x = np.concatenate([self._tail, np.asarray(block, np.float32)])
        n_out = int(np.floor((len(x) - 1 - self._pos) / (1.0 / self.ratio))) + 1
        if n_out <= 0:
            self._pos -= len(block)
            self._tail = x[-1:]
            return np.zeros(0, np.float32)
        idx = self._pos + np.arange(n_out) / self.ratio
        i0 = np.floor(idx).astype(np.int64)
        frac = (idx - i0).astype(np.float32)
        y = x[i0] * (1 - frac) + x[np.minimum(i0 + 1, len(x) - 1)] * frac
        self._pos = idx[-1] + 1.0 / self.ratio - len(block)
        self._tail = x[-1:]
        return y


class SoundDeviceDuplex:
    """Full-duplex hardware stream feeding a RealtimeEngine.  Activates only
    when sounddevice is importable; mirrors the reference stream setup at
    real-time-gui.py:1290-1320."""

    def __init__(
        self,
        engine: RealtimeEngine,
        *,
        samplerate: Optional[int] = None,
        block_frames: int = 2048,
        input_device=None,
        output_device=None,
    ):
        import sounddevice as sd

        self.engine = engine
        if input_device is not None:
            sd.default.device = (input_device, output_device)
        dev_sr = samplerate or int(
            sd.query_devices(sd.default.device[0])["default_samplerate"])
        model_sr = engine.session.cfg.sample_rate
        self.samplerate = dev_sr
        self._rs_in = (
            StreamingResampler(dev_sr, model_sr) if dev_sr != model_sr else None)
        self._rs_out = (
            StreamingResampler(model_sr, dev_sr) if dev_sr != model_sr else None)
        self._block = block_frames

        def callback(indata, outdata, frames, t, status):
            mono = np.mean(indata, axis=1) if indata.ndim > 1 else indata
            engine.push_input(self._rs_in(mono) if self._rs_in else mono)
            need = (int(frames / self.samplerate * model_sr)
                    if self._rs_out else frames)
            out = engine.pull_output(need)
            if self._rs_out:
                out = self._rs_out(out)
            out = np.resize(out, frames)
            outdata[:] = out[:, None].repeat(outdata.shape[1], 1)

        self.stream = sd.Stream(
            callback=callback, blocksize=block_frames,
            samplerate=self.samplerate, dtype="float32",
        )

    def start(self):
        self.stream.start()

    def stop(self):
        self.stream.abort()
        self.stream.close()


class SyntheticDuplex:
    """A stand-in for the hardware duplex stream: a capture thread
    pushes `block_frames`-sample blocks from a source signal at real-time
    pace (or flat out when pace=False) and a playback thread drains the
    output ring at the same cadence."""

    def __init__(
        self,
        engine: RealtimeEngine,
        source: np.ndarray,
        *,
        block_frames: int = 1536,  # deliberately not a chunk multiple
        pace: bool = True,
        sink: bool = True,
    ):
        self.engine = engine
        self.source = np.asarray(source, np.float32)
        self.block = block_frames
        self.pace = pace
        self.sink = sink
        self.captured: list = []
        self._stop = threading.Event()
        self._threads: list = []

    def _capture(self):
        sr = self.engine.session.cfg.sample_rate
        period = self.block / sr
        i, t_next = 0, time.perf_counter()
        while not self._stop.is_set():
            lo = (i * self.block) % max(len(self.source), 1)
            block = np.resize(self.source[lo:lo + self.block], self.block)
            self.engine.push_input(block)
            i += 1
            if self.pace:
                t_next += period
                dt = t_next - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)

    def _playback(self):
        sr = self.engine.session.cfg.sample_rate
        period = self.block / sr
        t_next = time.perf_counter()
        while not self._stop.is_set():
            out = self.engine.pull_output(self.block)
            if self.sink:
                self.captured.append(out)
            if self.pace:
                t_next += period
                dt = t_next - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)

    def start(self):
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._capture, daemon=True),
            threading.Thread(target=self._playback, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)

    def output(self) -> np.ndarray:
        return (np.concatenate(self.captured)
                if self.captured else np.zeros(0, np.float32))


# ---------------------------------------------------------------------------
# terminal monitor
# ---------------------------------------------------------------------------


def monitor(
    app: LiveApp,
    duration_s: float,
    *,
    interval_s: float = 0.5,
    out=sys.stderr,
    on_tick: Optional[Callable[[LiveStatus], None]] = None,
) -> LiveStatus:
    """Single-line repaint status monitor (the GUI status bar as a TUI).
    Returns the final status snapshot."""
    t_end = time.perf_counter() + duration_s
    st = app.status()
    while time.perf_counter() < t_end:
        time.sleep(min(interval_s, max(t_end - time.perf_counter(), 0)))
        st = app.status()
        print("\r" + st.line(), end="", file=out, flush=True)
        if on_tick is not None:
            on_tick(st)
    print(file=out)
    return st
