"""Headless real-time conversion engines, as the JAX package's
runtime/realtime.py: an audio producer (a device callback or a test
harness) pushes capture blocks of any size into an SPSC ring
(`native.RingBuffer`); a compute thread assembles fixed 2048 * k-sample
chunks, runs the `StreamSession`, and the converted audio goes into an
output ring that the playback callback drains.  Warm-up runs delay + 3
silent chunks before going live, so that every chunk phase (and on the card
every kernel library) is ready.

* `RealtimeEngine`: one live stream.
* `MultiStreamEngine`: B live streams through one batched `StreamSession`;
  every chunk step serves all B.

The compute thread only enqueues work: `process_chunk_async` returns the
output on the device, the thread records a CUDA event after the chunk's
last launch, and a pool of fetch threads copies each output to pinned host
memory on a stream of their own once that event has passed, delivering in
order.  All kernel launches of a session run on the engine's compute
thread: the kernel wrappers keep scratch buffers across calls, which two
threads launching one kernel at once would share.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from streamvoiceanon_tpu_torch.native import RingBuffer


def _event_after(wav: torch.Tensor) -> Optional[torch.cuda.Event]:
    """A CUDA event recorded on the current stream after `wav`'s last
    launch (None off the card)."""
    if not wav.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(wav.device))
    return ev


def _fetch(items, axis: int) -> List[np.ndarray]:
    """Copy a run of (device output, event) items to the host: joined
    along `axis` on the device, then one copy into pinned memory on a
    stream of this thread's own, started once the last event has passed
    (the chunks run in order on one stream, so the last event covers them
    all).  Each output's memory is marked as used by that stream
    (`record_stream`), so the caching allocator does not hand it out
    before the copy ends."""
    wavs = [w for w, _ in items]
    if not wavs[0].is_cuda:
        cat = torch.cat(wavs, dim=axis).numpy()
    else:
        dev = wavs[0].device
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            stream.wait_event(items[-1][1])
            joined = torch.cat(wavs, dim=axis) if len(wavs) > 1 else wavs[0]
            host = torch.empty(joined.shape, dtype=joined.dtype, pin_memory=True)
            host.copy_(joined, non_blocking=True)
            for w in wavs:
                w.record_stream(stream)
        stream.synchronize()
        cat = host.numpy()
    return np.split(cat, np.cumsum([w.shape[axis] for w in wavs[:-1]]), axis=axis)


class _FetchPool:
    """Ordered adaptive-batch fetcher pool shared by both engines.

    Workers pull (seq, t0, item) entries; each drains the whole pending
    backlog (a contiguous run of seq, up to `max_batch`; the drain holds a
    lock), fetches it with one joined copy (`materialize`), then passes an
    ordered-writeback turnstile so that `deliver` runs strictly in
    sequence.  When fetches fall behind, the batch grows and one copy
    serves the backlog."""

    def __init__(self, materialize, deliver, num_fetchers, max_batch, stop_event):
        self._materialize = materialize
        self._deliver = deliver
        self.max_batch = max_batch
        self._stop = stop_event
        self.q: "queue.Queue" = queue.Queue(maxsize=64)
        self._turnstile = threading.Condition()
        self._drain = threading.Lock()
        self._next = 0
        self.max_fetch_batch = 0  # largest adaptive fetch batch seen
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, int(num_fetchers)))]
        for t in self._threads:
            t.start()

    def submit(self, seq, t0, item) -> None:
        self.q.put((seq, t0, item))

    def _worker(self):
        while True:
            with self._drain:
                item = self.q.get()
                if item is None:
                    return
                batch = [item]
                while len(batch) < self.max_batch:
                    try:
                        nxt = self.q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        self.q.put(None)  # hand shutdown to another worker
                        break
                    batch.append(nxt)
            arrs = self._materialize([b[2] for b in batch])
            with self._turnstile:
                while self._next != batch[0][0] and not self._stop.is_set():
                    self._turnstile.wait(timeout=0.5)
                t1 = time.perf_counter()
                # updated under the turnstile: fetch threads would otherwise
                # race the read-modify-write
                self.max_fetch_batch = max(self.max_fetch_batch, len(batch))
                for (seq, t0, _), arr in zip(batch, arrs):
                    self._deliver(seq, t0, t1, arr)
                self._next = batch[-1][0] + 1
                self._turnstile.notify_all()

    def close(self):
        with self._turnstile:
            self._turnstile.notify_all()
        for _ in self._threads:
            self.q.put(None)
        for t in self._threads:
            t.join(timeout=5.0)


class RealtimeEngine:
    MAX_BATCH = 16  # adaptive-fetch drain limit

    def __init__(self, session, ring_seconds: float = 2.0, num_fetchers: int = 4):
        """num_fetchers: the size of the output-fetch thread pool
        (`_FetchPool`); 1 gives one fetcher."""
        self.session = session
        self.chunk = session.scfg.decode_chunk_frames * session.spf
        cap = int(ring_seconds * session.cfg.sample_rate)
        self.in_ring = RingBuffer(cap)
        self.out_ring = RingBuffer(cap)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[_FetchPool] = None
        self.num_fetchers = max(1, int(num_fetchers))
        self.chunks_processed = 0
        self.last_latency_ms = 0.0
        # per-chunk (t_read, t_delivered) perf_counter pairs in sequence order
        self.latency_log: list = []

    # ---- audio-thread side -------------------------------------------------

    def push_input(self, block: np.ndarray) -> None:
        """Call from the capture callback (any block size, mono float32)."""
        self.in_ring.write(block)

    def pull_output(self, n: int) -> np.ndarray:
        """Call from the playback callback; returns n samples (zeros on
        underrun)."""
        return self.out_ring.read(n)

    def _materialize(self, items) -> list:
        return _fetch(items, axis=0)

    # ---- compute side ------------------------------------------------------

    def warm_up(self) -> None:
        """Run every chunk phase on silent input before going live (on the
        card this also builds and loads the kernel libraries)."""
        for _ in range(self.session.delay + 3):
            self.session.process_chunk(np.zeros(self.chunk, np.float32))

    @property
    def max_fetch_batch(self) -> int:
        """Largest adaptive fetch batch seen (readable mid-run)."""
        return self._pool.max_fetch_batch if self._pool else 0

    def _deliver(self, seq, t0, t1, arr):
        self.out_ring.write(arr)
        self.last_latency_ms = (t1 - t0) * 1e3
        self.latency_log.append((t0, t1))
        self.chunks_processed += 1

    def _loop(self):
        """Compute thread: enqueue only; the fetcher pool waits for the
        device and overlaps the next chunks."""
        pool = _FetchPool(self._materialize, self._deliver, self.num_fetchers,
                          self.MAX_BATCH, self._stop)
        self._pool = pool
        use_async = self.session.incremental
        seq = 0
        try:
            while not self._stop.is_set():
                if self.in_ring.available() < self.chunk:
                    time.sleep(0.002)
                    continue
                block = self.in_ring.read(self.chunk)
                t0 = time.perf_counter()
                if use_async:
                    wav = self.session.process_chunk_async(block)
                    pool.submit(seq, t0, (wav, _event_after(wav)))
                    seq += 1
                else:
                    out = self.session.process_chunk(block)
                    self.out_ring.write(np.asarray(out))
                    self.last_latency_ms = (time.perf_counter() - t0) * 1e3
                    self.chunks_processed += 1
        finally:
            pool.close()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class MultiStreamEngine:
    """B concurrent live streams served by one batched `StreamSession`.

    Each stream has its own capture and playback ring; the compute thread
    assembles one (B, 2048 * k) block a tick and runs the batched session,
    and the ordered fetcher pool splits the fetched (B, n) output back into
    the per-stream output rings.

    Tick discipline (frame clock): a tick fires as soon as every stream has
    a full chunk buffered, or, once `slack` frame periods have passed since
    the previous tick, with silence standing in for any stream that is
    late (counted in `missed[i]`; its partial input stays buffered for the
    next tick).  A late stream so degrades only itself and cannot stall
    the other B - 1.
    """

    MAX_BATCH = 16

    def __init__(self, session, ring_seconds: float = 2.0, num_fetchers: int = 4,
                 slack: float = 1.5):
        if not session.incremental:
            raise ValueError("MultiStreamEngine needs an incremental-mode session")
        self.session = session
        self.B = int(session.batch)
        self.chunk = session.scfg.decode_chunk_frames * session.spf
        self.period = self.chunk / session.cfg.sample_rate
        self.slack = float(slack)
        cap = int(ring_seconds * session.cfg.sample_rate)
        self.in_rings = [RingBuffer(cap) for _ in range(self.B)]
        self.out_rings = [RingBuffer(cap) for _ in range(self.B)]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[_FetchPool] = None
        self.num_fetchers = max(1, int(num_fetchers))
        self.ticks_processed = 0
        self.missed = [0] * self.B  # silence-padded (late) chunks per stream
        self.last_latency_ms = 0.0
        self.latency_log: list = []  # (t_assembled, t_delivered) per tick

    # ---- audio-thread side -------------------------------------------------

    def push_input(self, i: int, block: np.ndarray) -> None:
        """Capture callback for stream i (any block size, mono float32)."""
        self.in_rings[i].write(block)

    def pull_output(self, i: int, n: int) -> np.ndarray:
        """Playback callback for stream i (zeros on underrun)."""
        return self.out_rings[i].read(n)

    # ---- compute side ------------------------------------------------------

    def warm_up(self) -> None:
        """Run every chunk phase at batch B on silent input."""
        for _ in range(self.session.delay + 3):
            self.session.process_chunk(np.zeros((self.B, self.chunk), np.float32))

    def _materialize(self, items) -> list:
        return _fetch(items, axis=-1)  # k outputs (B, n) -> k x (B, n)

    def _deliver(self, seq, t0, t1, arr):
        for i in range(self.B):
            self.out_rings[i].write(arr[i])
        self.last_latency_ms = (t1 - t0) * 1e3
        self.latency_log.append((t0, t1))
        self.ticks_processed += 1

    def _assemble(self) -> np.ndarray:
        """Read one chunk a ready stream; silence for late ones (their
        partial input is left in place for the next tick)."""
        block = np.zeros((self.B, self.chunk), np.float32)
        for i, r in enumerate(self.in_rings):
            if r.available() >= self.chunk:
                block[i] = r.read(self.chunk)
            else:
                self.missed[i] += 1
        return block

    @property
    def max_fetch_batch(self) -> int:
        """Largest adaptive fetch batch seen (readable mid-run)."""
        return self._pool.max_fetch_batch if self._pool else 0

    def _loop(self):
        pool = _FetchPool(self._materialize, self._deliver, self.num_fetchers,
                          self.MAX_BATCH, self._stop)
        self._pool = pool
        seq = 0
        deadline = time.perf_counter() + self.slack * self.period
        try:
            while not self._stop.is_set():
                now = time.perf_counter()
                ready = sum(r.available() >= self.chunk for r in self.in_rings)
                if ready == self.B or (ready > 0 and now >= deadline):
                    block = self._assemble()
                    t0 = time.perf_counter()
                    wav = self.session.process_chunk_async(block)
                    pool.submit(seq, t0, (wav, _event_after(wav)))
                    seq += 1
                    deadline = t0 + self.slack * self.period
                else:
                    time.sleep(0.001)
        finally:
            pool.close()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
