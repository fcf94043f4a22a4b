// Real-time audio transport for the streaming voice converter.
//
// The reference's live path is a Python sounddevice duplex callback that
// rolls numpy arrays inside the audio thread (evaluations/real-time-gui.py:
// 1316-1359) — allocation and GIL hazards in a hard-real-time context.  This
// native layer provides the serving equivalent: wait-free SPSC ring
// buffers (audio thread <-> compute thread) and a frame chunker, so the
// audio callback never blocks on Python and the compute thread consumes
// fixed 2048*k-sample chunks.
//
// Built with the host compiler (g++ -O2 -shared -fPIC) at first use by
// streamvoiceanon_tpu_torch/ops/_build.py `build_host`; bindings in
// streamvoiceanon_tpu_torch/native/__init__.py.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct Ring {
  float* data;
  uint64_t capacity;  // power of two
  alignas(64) std::atomic<uint64_t> head;  // written by producer
  alignas(64) std::atomic<uint64_t> tail;  // written by consumer
  // running totals for diagnostics
  alignas(64) std::atomic<uint64_t> overruns;
  std::atomic<uint64_t> underruns;
};

uint64_t next_pow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Creates a ring holding at least `min_capacity` float samples.
void* svan_ring_create(uint64_t min_capacity) {
  Ring* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  r->capacity = next_pow2(min_capacity);
  r->data = new (std::nothrow) float[r->capacity];
  if (!r->data) {
    delete r;
    return nullptr;
  }
  std::memset(r->data, 0, r->capacity * sizeof(float));
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  r->overruns.store(0, std::memory_order_relaxed);
  r->underruns.store(0, std::memory_order_relaxed);
  return r;
}

void svan_ring_destroy(void* h) {
  Ring* r = static_cast<Ring*>(h);
  if (!r) return;
  delete[] r->data;
  delete r;
}

uint64_t svan_ring_capacity(void* h) { return static_cast<Ring*>(h)->capacity; }

// Samples available to read (clamped to capacity: after an overrun the
// producer may be ahead of the consumer's not-yet-resynced tail).
uint64_t svan_ring_available(void* h) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t d = r->head.load(std::memory_order_acquire) -
               r->tail.load(std::memory_order_acquire);
  return d > r->capacity ? r->capacity : d;
}

// Free space for writing.
uint64_t svan_ring_space(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return r->capacity - svan_ring_available(h);
}

// Producer side (audio callback): copies n samples in.  If the ring is full
// the OLDEST samples are overwritten (real-time semantics: latest audio
// wins) and the overrun counter is bumped.  The producer NEVER touches
// `tail` — it is consumer-owned; a producer store would race the consumer's
// `tail += take` and lose drops (head - tail could exceed capacity forever).
// Instead the consumer detects the overrun from `head - tail > capacity`
// and resyncs its own index (svan_ring_read/peek below).
uint64_t svan_ring_write(void* h, const float* src, uint64_t n) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  uint64_t space = r->capacity - (head - tail);
  if (n > r->capacity) {
    src += n - r->capacity;
    head += n - r->capacity;  // keep sample indexing continuous
    n = r->capacity;
  }
  if (n > space)
    r->overruns.fetch_add(n - space, std::memory_order_relaxed);
  uint64_t mask = r->capacity - 1;
  for (uint64_t i = 0; i < n; ++i) r->data[(head + i) & mask] = src[i];
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Consumer side: copies exactly n samples out if available; otherwise fills
// with zeros (underrun) and returns the number of real samples delivered.
// If the producer lapped us (head - tail > capacity), resync tail to the
// oldest still-valid sample.  After copying, re-check head: the producer may
// have overwritten the copied region mid-copy — bounded retry, since the
// producer normally advances at audio rate while the copy is microseconds.
// If a flooding producer defeats every retry, FAIL SAFE: deliver zeros,
// skip the consumer to the freshest write, and count the dropped span as
// overruns — torn samples must never escape to the audio path.
uint64_t svan_ring_read(void* h, float* dst, uint64_t n) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t mask = r->capacity - 1;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t take = 0;
  bool coherent = false;
  for (int attempt = 0; attempt < 4; ++attempt) {
    uint64_t head = r->head.load(std::memory_order_acquire);
    if (head - tail > r->capacity) tail = head - r->capacity;  // resync
    uint64_t avail = head - tail;
    take = avail < n ? avail : n;
    for (uint64_t i = 0; i < take; ++i) dst[i] = r->data[(tail + i) & mask];
    // validate: did the producer wrap over [tail, tail+take) during the copy?
    uint64_t head2 = r->head.load(std::memory_order_acquire);
    if (head2 - tail <= r->capacity) {
      coherent = true;
      break;
    }
    tail = head2 - r->capacity;  // torn copy — resync and retry
  }
  if (!coherent) {
    // retries exhausted: the window in dst may be torn — discard it,
    // resync to "now" and deliver silence for this call
    uint64_t head = r->head.load(std::memory_order_acquire);
    r->overruns.fetch_add(head - tail, std::memory_order_relaxed);
    tail = head;
    take = 0;
  }
  for (uint64_t i = take; i < n; ++i) dst[i] = 0.0f;
  if (take < n) r->underruns.fetch_add(n - take, std::memory_order_relaxed);
  r->tail.store(tail + take, std::memory_order_release);
  return take;
}

// Peek without consuming (for rolling-window style access).  Delivers the
// most recent `take` samples right-aligned in dst; same torn-copy retry as
// svan_ring_read.
uint64_t svan_ring_peek(void* h, float* dst, uint64_t n) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t mask = r->capacity - 1;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t take = 0;
  bool coherent = false;
  for (int attempt = 0; attempt < 4; ++attempt) {
    uint64_t head = r->head.load(std::memory_order_acquire);
    if (head - tail > r->capacity) tail = head - r->capacity;
    uint64_t avail = head - tail;
    take = avail < n ? avail : n;
    uint64_t start = head - take;
    for (uint64_t i = 0; i < n - take; ++i) dst[i] = 0.0f;
    for (uint64_t i = 0; i < take; ++i)
      dst[n - take + i] = r->data[(start + i) & mask];
    uint64_t head2 = r->head.load(std::memory_order_acquire);
    if (head2 - start <= r->capacity) {  // copied window still valid
      coherent = true;
      break;
    }
  }
  if (!coherent) {
    // fail safe (matches svan_ring_read): a torn window never escapes —
    // deliver silence; peek consumes nothing, so counters stay untouched
    for (uint64_t i = 0; i < n; ++i) dst[i] = 0.0f;
    take = 0;
  }
  return take;
}

uint64_t svan_ring_overruns(void* h) {
  return static_cast<Ring*>(h)->overruns.load(std::memory_order_relaxed);
}

uint64_t svan_ring_underruns(void* h) {
  return static_cast<Ring*>(h)->underruns.load(std::memory_order_relaxed);
}

}  // extern "C"
