"""The port's real-time transport and engines, and its batched offline
server, on the CPU:

* the SPSC ring (`streamvoiceanon_tpu_torch.native.RingBuffer`, built from
  csrc/ringbuffer.cpp by the host compiler) in tests/test_native_ring.py's
  six cases, and a failed build raising;
* `RealtimeEngine` (ordered delivery through the fetcher pool, the
  adaptive batched fetch) and `MultiStreamEngine` (per-stream output equal
  to the batched sequential session; a late stream getting silence),
  mirroring tests/test_live.py, the sequential sessions held against the
  JAX package's;
* `bucket_by_frames` and `BatchServer.convert` against JAX's `BatchServer`
  on one CPU device, and `BatchServer(n_model=2)` in two gloo processes
  against the one-process server.

Waveforms within atol = rtol = 1e-4 and 1e-4 of the largest sample of
JAX's; engine against sequential session within 1e-5 of the largest
sample.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.parallel import mesh as jmesh
from streamvoiceanon_tpu.parallel.serving import BatchServer as JaxServer
from streamvoiceanon_tpu.runtime.streaming import StreamSession as JaxSession
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch.native import RingBuffer
from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.parallel.serving import BatchServer, bucket_by_frames
from streamvoiceanon_tpu_torch.runtime.realtime import MultiStreamEngine, RealtimeEngine
from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession
from torch_pairs import GREEDY, SPF, TGREEDY, chunk, close_wave, pair, prompt, source

SCFG = JC.StreamConfig(max_prompt_frames=8, max_seq_frames=40, buffer_frames=4, delay=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here: with several test
    workers on the machine, eight threads a worker oversubscribe the cores
    and every small op waits for threads that are not running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def test_ring_builds_native():
    r = RingBuffer(1024)
    assert r.capacity() == 1024
    assert _build.host_library_path("ringbuffer").exists()
    assert _build.host_library_path("ringbuffer").parent == _build.BUILD_DIR


def test_ring_write_read_roundtrip():
    r = RingBuffer(1024)
    x = np.arange(300, dtype=np.float32)
    r.write(x)
    assert r.available() == 300
    np.testing.assert_array_equal(r.read(300), x)
    assert r.available() == 0


def test_ring_underrun_pads_zeros():
    r = RingBuffer(64)
    r.write(np.ones(10, np.float32))
    out = r.read(20)
    np.testing.assert_array_equal(out[:10], 1.0)
    np.testing.assert_array_equal(out[10:], 0.0)
    assert r.underruns() == 10


def test_ring_overrun_drops_oldest():
    r = RingBuffer(64)
    r.write(np.arange(64, dtype=np.float32))
    r.write(np.arange(64, 80, dtype=np.float32))  # overruns by 16
    assert r.overruns() == 16
    np.testing.assert_array_equal(r.read(64), np.arange(16, 80, dtype=np.float32))


def test_ring_threaded_spsc():
    """Producer and consumer on two threads: all data arrives in order."""
    cap, total = 1 << 14, 1 << 16
    r = RingBuffer(cap)
    src = np.arange(total, dtype=np.float32)
    got = []

    def producer():
        for i in range(0, total, 997):
            n = len(src[i : i + 997])
            while cap - r.available() < n:  # wait for space (no drops wanted)
                pass
            r.write(src[i : i + 997])

    def consumer():
        read = 0
        while read < total:
            n = min(1024, total - read)
            if r.available() >= n:
                got.append(r.read(n))
                read += n

    tp, tc = threading.Thread(target=producer), threading.Thread(target=consumer)
    tc.start()
    tp.start()
    tp.join(timeout=30)
    tc.join(timeout=30)
    assert not tp.is_alive() and not tc.is_alive()
    out = np.concatenate(got)
    assert len(out) == total and r.overruns() == 0
    np.testing.assert_array_equal(out, src)


def test_ring_overrun_race_consumer_resync():
    """A producer floods the ring while the consumer reads: every read is a
    coherent window (increasing values, never more than the capacity
    behind the freshest write) and available() never exceeds the
    capacity."""
    cap, total = 1 << 10, 1 << 18
    r = RingBuffer(cap)
    stop = threading.Event()
    errors = []

    def producer():
        i = 0
        while i < total and not stop.is_set():
            r.write(np.arange(i, i + 512, dtype=np.float32))
            i += 512

    def consumer():
        last = -1.0
        while not stop.is_set():
            if r.available() > cap:
                errors.append(f"available {r.available()} > capacity {cap}")
                return
            vals = r.read(256)
            vals = vals[vals > 0]  # zero fill from underruns is allowed
            if len(vals):
                if np.any(np.diff(vals) <= 0):
                    errors.append("non-monotone window (torn read)")
                    return
                if vals[-1] <= last:
                    errors.append("window went backwards across reads")
                    return
                last = float(vals[-1])

    tp, tc = threading.Thread(target=producer), threading.Thread(target=consumer)
    tc.start()
    tp.start()
    tp.join(timeout=30)
    stop.set()
    tc.join(timeout=10)
    assert not errors, errors
    if r.overruns() == 0:  # a starved producer: force the overrun path
        r.write(np.arange(float(total), float(total) + 2 * cap, dtype=np.float32))
        vals = r.read(cap)
        assert np.all(np.diff(vals[vals > 0]) > 0), "torn window after forced overrun"
    assert r.overruns() > 0


def test_a_failed_ring_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "host_library_path", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        RingBuffer(64)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcv, tcv = pair()
    return jcv, tcv, prompt(jcv, seed=0, batch=3)


def _port(tcv, art, B=1):
    style, timbre, tokens, codes = (a[:B] for a in art)
    return StreamSession(tcv, C.from_fields(SCFG), style=style, timbre=timbre,
                         ref_tokens=tokens, ref_codes=codes, sampling=TGREEDY, batch=B)


def _sequential(sess, src, n):
    return np.concatenate([sess.process_chunk(chunk(src, i)) for i in range(n)], axis=-1)


def _jax_sequential(jcv, art, src, n, B=1):
    style, timbre, tokens, codes = (jnp.asarray(a[:B]) for a in art)
    js = JaxSession(jcv, SCFG, key=jax.random.PRNGKey(1), sampling=GREEDY, style=style,
                    timbre=timbre, ref_tokens=tokens, ref_codes=codes, batch=B)
    return np.concatenate([np.asarray(js.process_chunk(chunk(src, i))) for i in range(n)],
                          axis=-1)


def _wait(cond, seconds=60):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.01)


def _in_order(eng):
    t0s = [a for a, _ in eng.latency_log]
    t1s = [b for _, b in eng.latency_log]
    assert t0s == sorted(t0s) and t1s == sorted(t1s)


@pytest.mark.parametrize("slow_fetch", [False, True])
def test_engine_delivers_in_order(tiny, slow_fetch):
    """RealtimeEngine with a pool of fetchers delivers the chunks in
    sequence, equal to the sequential session (itself equal to JAX's).
    With a slow fetch (250 ms, any size; one fetcher) the backlog of chunks
    is fetched in batches."""
    jcv, tcv, art = tiny
    n = 16 if slow_fetch else 20
    src = source(7 if not slow_fetch else 11, n)
    want = _sequential(_port(tcv, art), src, n)
    scale = float(np.abs(want).max())
    assert scale > 0, "the sequential session produced no signal"
    if not slow_fetch:
        close_wave(want, _jax_sequential(jcv, art, src, n))

    class SlowFetchEngine(RealtimeEngine):
        def _materialize(self, items):
            time.sleep(0.25)
            return super()._materialize(items)

    eng = (SlowFetchEngine if slow_fetch else RealtimeEngine)(
        _port(tcv, art), ring_seconds=4.0, num_fetchers=1 if slow_fetch else 4)
    eng.start()
    try:
        for i in range(n):
            eng.push_input(chunk(src, i))
        _wait(lambda: eng.chunks_processed >= n)
        assert eng.chunks_processed == n
        got = eng.pull_output(n * SPF)
    finally:
        eng.stop()
    np.testing.assert_allclose(got, want, atol=scale * 1e-5, rtol=0)
    _in_order(eng)
    if slow_fetch:
        assert eng.max_fetch_batch > 1


def test_multistream_engine_matches_batched_sequential(tiny):
    jcv, tcv, art = tiny
    B, n = 3, 16
    src = source(5, n, batch=B)
    want = _sequential(_port(tcv, art, B), src, n)
    assert float(np.abs(want).max()) > 0
    close_wave(want, _jax_sequential(jcv, art, src, n, B))
    eng = MultiStreamEngine(_port(tcv, art, B), ring_seconds=4.0, num_fetchers=3)
    for i in range(n):  # all input first: no stream can be late for a tick
        for s in range(B):
            eng.push_input(s, chunk(src[s], i))
    eng.start()
    try:
        _wait(lambda: eng.ticks_processed >= n)
        assert eng.ticks_processed == n
        got = np.stack([eng.pull_output(s, n * SPF) for s in range(B)])
    finally:
        eng.stop()
    np.testing.assert_allclose(got, want, atol=float(np.abs(want).max()) * 1e-5, rtol=0)
    assert eng.missed == [0] * B
    _in_order(eng)


def test_multistream_engine_late_stream_gets_silence(tiny):
    """A stream that stops delivering must not stall the others: ticks keep
    firing on the frame clock with silence standing in, counted in its
    `missed`."""
    _, tcv, art = tiny
    B, n = 2, 8
    src = source(6, n, batch=B)
    ref_src = src.copy()
    ref_src[1] = 0.0
    want = _sequential(_port(tcv, art, B), ref_src, n)
    eng = MultiStreamEngine(_port(tcv, art, B), ring_seconds=4.0, num_fetchers=2, slack=0.6)
    for i in range(n):  # only stream 0 is fed
        eng.push_input(0, chunk(src[0], i))
    eng.start()
    try:
        _wait(lambda: eng.ticks_processed >= n)
        assert eng.ticks_processed >= n
        got0 = eng.pull_output(0, n * SPF)
    finally:
        eng.stop()
    np.testing.assert_allclose(got0, want[0], atol=float(np.abs(want).max()) * 1e-5, rtol=0)
    assert eng.missed[0] == 0 and eng.missed[1] >= n


# ---------------------------------------------------------------------------
# BatchServer
# ---------------------------------------------------------------------------


def test_bucketing():
    assert bucket_by_frames([5, 12, 30, 7, 64], [8, 32, 64]) == {8: [0, 3], 32: [1, 2],
                                                                  64: [4]}
    with pytest.raises(ValueError):
        bucket_by_frames([100], [8, 32, 64])


def test_batch_server_matches_jax(tiny, tmp_path):
    jcv, tcv, art = tiny
    B, Ts = 3, 6
    src = source(61, Ts, batch=B)
    style, timbre, tokens, codes = art
    jserver = JaxServer(jcv, mesh=jmesh.make_mesh(n_data=1, devices=jax.devices()[:1]))
    want = jserver.convert(src, tokens, codes, style, timbre, sampling=GREEDY, delay=2)
    server = BatchServer(tcv)
    got = server.convert(src, tokens, codes, style, timbre, sampling=TGREEDY, delay=2)
    assert got.shape == (B, Ts * SPF) and np.isfinite(got).all()
    close_wave(got, want)
    single = server.convert(src[:1], tokens[:1], codes[:1], style[:1], timbre[:1],
                            sampling=TGREEDY, delay=2)
    np.testing.assert_allclose(single[0], got[0], atol=2e-4)
    # n_model=2 runs: two gloo processes (a 1 x 2 mesh) serve the same wav
    from torch_mesh import run_ranks
    from torch_pairs import trees

    inputs = {"batch_server": {
        "trees": {k: v for k, v in trees().items() if k in ("tokenizer_params",
                                                             "vocoder_params", "arvc_params")},
        "sampling": TGREEDY, "cfgs": {"plain": tcv.cfg}, "batches": (B,),
        "args": (src, tokens, codes, style, timbre)}}
    for res in run_ranks(["batch_server"], 2, inputs, tmp_path):
        np.testing.assert_allclose(res["batch_server"]["plain", B]["wav"], got, atol=1e-4,
                                   rtol=1e-4)
    with pytest.raises(ValueError, match="initialized process group"):
        BatchServer(tcv, n_model=2)
