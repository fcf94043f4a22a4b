// The dual-AR fast codebook loop at batch 1: nq autoregressive steps through
// the L fast layers with a fresh nq-slot KV scratch, each step sampling one
// code and feeding its fast embedding back in, plus the next frame's audio
// embedding (the sum of the sampled codes' codebook rows).  The port of
// `fast_decode` in ops/pallas_fast_decode.py of the JAX package; see
// streamvoiceanon_tpu_torch/ops/fast_decode.py for the design note.
//
// One cooperative launch a frame, one block per SM.  The TPU kernel runs the
// loop in program order on one core; here the grid runs it together and
// waits at a grid-wide barrier where the next phase reads what the last one
// wrote: four a layer (A qkv, B attention + wo, C w1/w3, D w2) and one after
// the head.  Each block owns a fixed run of 16-byte column units of every
// phase (the plan, ops/fast_decode.py `work_plan`) and sums each of its
// columns over the whole K in a fixed order.  The weights come packed, each
// unit's K x 16-byte slice (a task) contiguous (`packed`).  What bounds the
// loop is bytes (61 MB of fast layers, above the 50 MB L2, re-read in each
// of the 8 steps) and latency (136 dependent phases): each block keeps the
// first tasks of its slices in shared memory from step 0 on (the plan's
// resident counts, `resident_plan`: about 40 % of the weights), and before
// each barrier bulk-copies (TMA) the next phase's other tasks into a ring,
// so that they arrive while the grid waits.  Data that other blocks wrote
// during the launch is read with ld.global.cg (L2), never through L1.  The
// grid barrier, those L2 reads, the column-owner matvec and the bulk-copy
// helpers live in decode_common.cuh, shared with the ring step.
// Every row a thread needs is loaded before its first use; the attention
// is one warp a head with no block barrier, and the sampler runs across
// the block, two bisection steps a round.  Rounding follows the TPU kernel:
// qkv rounded to W; q roped in float32, unrounded; k roped, then rounded to
// W; scores and softmax in float32; the value mix rounded to W before wo;
// residual adds rounded to W; SiLU in float32; the audio embedding summed
// in W.
//
// Plain C interface for ctypes.  Every pointer is a device pointer; the
// caller allocates outputs and scratch; `hidden` is the projected frame
// latent in the weight type and is only read.  Returns a CUDA error code: 0
// when the launch was accepted, cudaErrorCooperativeLaunchTooLarge when the
// grid cannot be resident at once (it is never shrunk).

#include "decode_common.cuh"

using namespace svd;

namespace {

constexpr int FD_THREADS = PK_THREADS;  // 512 (decode_common.cuh)
constexpr int FD_WARPS = PK_WARPS;
constexpr int FD_NPH = 5;     // plan columns: qkv, wo, w1/w3, w2, head (ops/fast_decode.py)
constexpr int FD_MAXQ = 16;   // attention slots (MAX_NQ)
constexpr int FD_MAXR = 4;    // attention rounds of 32 / (hd / VEC) slots (MAX_ROUNDS)
constexpr int FD_MAXL = 8;    // layers: one mbarrier each for the resident weights (MAX_LAYERS)
constexpr int FD_RING = 36864;  // bytes of the ring: a phase's streamed weights (RING_BYTES)
constexpr int FD_ROW = PK_ROW;  // row values a thread: K <= 2560 (MAX_ROW)
constexpr int FD_VOC = 2;     // vocabulary values a thread: V <= 1024 (MAX_VOCAB)
enum { PH_QKV = 0, PH_WO = 1, PH_W13 = 2, PH_W2 = 3, PH_HEAD = 4 };

template <typename W>
struct FastArgs {
  const W* hidden;      // (dim) the projected frame latent
  W* h;                 // (dim) running hidden row
  const float* gumbel;  // (nq, V), null when greedy
  const W* wqkv;        // packed (L, 3 dim / VEC, dim, VEC)
  const W* wo;          // packed (L, dim / VEC, dim, VEC)
  const W* w1;          // packed (L, inter / VEC, dim, VEC)
  const W* w3;
  const W* w2;          // packed (L, dim / VEC, inter, VEC)
  const W* anorm;       // (L, dim)
  const W* fnorm;       // (L, dim)
  const W* onorm;       // (dim)
  const W* wout;        // packed (V / VEC, dim, VEC)
  const W* emb;         // (V, dim)
  const W* cbemb;       // (nq * V, mdim)
  const float* freqs;   // (nq, head_dim / 2, 2)
  const int* plan;      // (grid, plan_stride): FD_NPH (first unit, units), resident tasks
  int* codes;           // (nq)
  W* aemb;              // (mdim)
  W* kc;                // (L, nq, dim) scratch
  W* vc;
  float* q;             // (dim) roped query
  W* gate;              // (inter)
  float* logits;        // (nq, V)
  unsigned long long* stamps;  // (nq (4 L + 1) + 2, grid, 2) global ns, or null
  unsigned long long* bar_count;  // count_barrier's arrivals
  int plan_stride, res_bytes;  // the plan's row; the largest block's resident bytes
  int L, nq, dim, n_head, head_dim, inter, V, mdim;
  float eps, scale, temperature, top_p;
  int greedy;
};

// One weight slice of a codebook step: phase p of layer l (p = PH_HEAD for
// the head).  Its tasks 0 .. res - 1 stay in shared memory from step 0 on
// (at `resident`), the next `ring` are brought into the ring before each
// barrier that precedes the phase, the rest are read from global memory.
template <typename W>
struct Slice {
  int p, l, u0, ntask, K, res, ring;
  const uint4* resident;
  __device__ const uint4* global(const FastArgs<W>& a, int t) const {
    constexpr int VEC = Vec<W>::N;
    const W* m;
    int u = u0 + t;
    const size_t dim = a.dim, inter = a.inter;
    if (p == PH_QKV) m = a.wqkv + l * dim * 3 * dim;
    else if (p == PH_WO) m = a.wo + l * dim * dim;
    else if (p == PH_W13) { m = ((t & 1) ? a.w3 : a.w1) + l * dim * inter; u = u0 + t / 2; }
    else if (p == PH_W2) m = a.w2 + l * inter * dim;
    else m = a.wout;
    return reinterpret_cast<const uint4*>(m + (size_t)u * K * VEC);
  }
  __device__ const uint4* col(const FastArgs<W>& a, const uint4* ring_buf, int t) const {
    if (t < res) return resident + (size_t)t * K;
    if (t < res + ring) return ring_buf + (size_t)(t - res) * K;
    return global(a, t);
  }
};

// Attention of the fresh query over slots 0 .. s of layer l's scratch into
// xs, rounded to W: one warp a head, a lane a (slot, 16-byte chunk) pair,
// with the head's hd / VEC chunks of a slot in neighbouring lanes and
// 32 / (hd / VEC) slots a round.  A lane issues its query chunk and the key
// and value chunks of two rounds at once; the scores, the softmax over the
// slots and the value mix are sums over lanes (shuffles), so the warp needs
// no __syncthreads.  Float32 scores and weights, normalized before the mix.
template <typename W>
__device__ void attention(const FastArgs<W>& a, int l, int s, float* xs) {
  constexpr int VEC = Vec<W>::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dim = a.dim, cph = a.head_dim / VEC, nc = dim / VEC, G = 32 / cph;
  const int g = lane / cph, c = lane % cph;  // slot in the round, chunk of the head
  const int rounds = s / G + 1;
  const uint4* kr = reinterpret_cast<const uint4*>(a.kc + (size_t)l * a.nq * dim);
  const uint4* vr = reinterpret_cast<const uint4*>(a.vc + (size_t)l * a.nq * dim);
  for (int h = warp; h < a.n_head; h += FD_WARPS) {
    const int chunk = h * cph + c;
    float q[VEC];
    const float4* q4 = reinterpret_cast<const float4*>(a.q + chunk * VEC);
#pragma unroll
    for (int v4 = 0; v4 < VEC / 4; ++v4) {
      const float4 x = __ldcg(q4 + v4);
      q[4 * v4] = x.x;
      q[4 * v4 + 1] = x.y;
      q[4 * v4 + 2] = x.z;
      q[4 * v4 + 3] = x.w;
    }
    float sc[FD_MAXR];  // this lane's slot's score in each round
    uint4 vraw[FD_MAXR];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int r0 = 0; r0 < FD_MAXR; r0 += 2) {
      if (r0 >= rounds) break;
      uint4 kraw[2];
#pragma unroll
      for (int r = r0; r < r0 + 2; ++r) {
        const int j = r * G + g;
        if (r < rounds && j <= s) {
          kraw[r - r0] = __ldcg(kr + (size_t)j * nc + chunk);
          vraw[r] = __ldcg(vr + (size_t)j * nc + chunk);
        }
      }
#pragma unroll
      for (int r = r0; r < r0 + 2; ++r) {
        const int j = r * G + g;
        float p = 0.f;
        if (r < rounds && j <= s) {
          float kv[VEC];
          unpack_vec<W>(kraw[r - r0], kv);
#pragma unroll
          for (int v = 0; v < VEC; ++v) p += q[v] * kv[v];
        }
        for (int o = cph / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        sc[r] = r < rounds && j <= s ? p * a.scale : -CUDART_INF_F;
        mx = fmaxf(mx, sc[r]);
      }
    }
    for (int o = cph; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < FD_MAXR; ++r) {
      if (r >= rounds) break;
      sc[r] = r * G + g <= s ? expf(sc[r] - mx) : 0.f;
      den += sc[r];
    }
    for (int o = cph; o < 32; o <<= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
#pragma unroll
    for (int r = 0; r < FD_MAXR; ++r) {
      if (r >= rounds) break;
      if (r * G + g <= s) {
        const float wj = sc[r] / den;
        float vv[VEC];
        unpack_vec<W>(vraw[r], vv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wj, vv[v], acc[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      for (int o = cph; o < 32; o <<= 1) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
    if (g == 0) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) xs[chunk * VEC + v] = rnd<W>(acc[v]);
    }
  }
  __syncthreads();
}

// The exact sampler across the block, value i in thread i % FD_THREADS
// (FD_VOC a thread): softmax, the 40-step bisection for the nucleus
// threshold, the Gumbel race (`gv`, this thread's noise), argmax with the
// lowest index on ties.  The bisection decides two of its steps a round:
// the mass above the midpoint and above both midpoints the next step could
// take, each summed over the warp by shuffles and over the warps in warp
// order from `part` (double-buffered, so one __syncthreads a round); the
// thresholds and sums are those of the one-step loop, so the result is the
// same.  Steps whose midpoint is at or above the largest probability are
// taken without sums (the mass above is 0), and the loop stops early,
// exactly, once (lo, hi] holds one probability: the kept set {p > lo} can
// no longer change.  Returns the code in every thread.
__device__ int sample_block(const float* logits, const float (&gv)[FD_VOC], int V, int greedy,
                            float temperature, float top_p, float* scal, float* part,
                            float* bv, int* bi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float lg[FD_VOC], pr[FD_VOC];
#pragma unroll
  for (int r = 0; r < FD_VOC; ++r) {
    const int i = tid + r * FD_THREADS;
    lg[r] = i < V ? __ldcg(logits + i) : -CUDART_INF_F;
  }
  const bool nucleus = !greedy && top_p < 1.f;
  float lo = 0.f;
  if (nucleus) {
    // max and sum over the block, one __syncthreads each (scal's two halves)
    float m = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < FD_VOC; ++r) m = fmaxf(m, lg[r]);
    m = warp_max(m);
    if (lane == 0) scal[warp] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) m = fmaxf(m, scal[w]);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < FD_VOC; ++r) {
      pr[r] = tid + r * FD_THREADS < V ? expf(lg[r] - m) : 0.f;
      s += pr[r];
    }
    s = warp_sum(s);
    if (lane == 0) scal[FD_WARPS + warp] = s;
    __syncthreads();
    s = 0.f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) s += scal[FD_WARPS + w];
#pragma unroll
    for (int r = 0; r < FD_VOC; ++r) pr[r] = pr[r] / s;
    // steps whose midpoint is at or above the largest probability (1 / s, as
    // the division above gives it) find no mass above it: kept, no sums
    const float pmax = 1.f / s;
    float hi = 1.f;
    int step = 0;
    while (step < 40 && (lo + hi) * 0.5f >= pmax) {
      hi = (lo + hi) * 0.5f;
      ++step;
    }
    for (int it = 0; step < 40; ++it, step += 2) {
      const float mid = (lo + hi) * 0.5f;
      const float mlo = (lo + mid) * 0.5f, mhi = (mid + hi) * 0.5f;
      float m0 = 0.f, m1 = 0.f, m2 = 0.f, left = 0.f;
#pragma unroll
      for (int r = 0; r < FD_VOC; ++r) {
        m0 += pr[r] > mid ? pr[r] : 0.f;
        m1 += pr[r] > mlo ? pr[r] : 0.f;
        m2 += pr[r] > mhi ? pr[r] : 0.f;
        left += pr[r] > lo && pr[r] <= hi ? 1.f : 0.f;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m0 += __shfl_xor_sync(0xffffffffu, m0, o);
        m1 += __shfl_xor_sync(0xffffffffu, m1, o);
        m2 += __shfl_xor_sync(0xffffffffu, m2, o);
        left += __shfl_xor_sync(0xffffffffu, left, o);
      }
      float* buf = part + (it & 1) * 4 * FD_WARPS;
      if (lane == 0) {
        buf[warp] = m0;
        buf[FD_WARPS + warp] = m1;
        buf[2 * FD_WARPS + warp] = m2;
        buf[3 * FD_WARPS + warp] = left;
      }
      __syncthreads();
      m0 = m1 = m2 = left = 0.f;
#pragma unroll
      for (int w = 0; w < FD_WARPS; ++w) {
        m0 += buf[w];
        m1 += buf[FD_WARPS + w];
        m2 += buf[2 * FD_WARPS + w];
        left += buf[3 * FD_WARPS + w];
      }
      // (lo, hi] holds the crossing probability p* (mass above lo > top_p >=
      // mass above hi); if it holds no other, every later lo lies in
      // [lo, p*) and keeps the same {p > lo}
      if (left <= 1.f) break;
      if (step + 1 == 40) {  // one step left
        if (m0 <= top_p) hi = mid; else lo = mid;
      } else if (m0 <= top_p) {
        if (m1 <= top_p) hi = mlo; else { lo = mlo; hi = mid; }
      } else {
        if (m2 <= top_p) { lo = mid; hi = mhi; } else lo = mhi;
      }
    }
  }
  float best = -CUDART_INF_F;
  int besti = 0x7fffffff;
#pragma unroll
  for (int r = 0; r < FD_VOC; ++r) {
    const int i = tid + r * FD_THREADS;
    float x = lg[r];
    if (!greedy) x = nucleus && !(pr[r] > lo) ? -CUDART_INF_F : x / temperature + gv[r];
    if (i < V && (x > best || besti == 0x7fffffff)) { best = x; besti = i; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, besti, o);
    if (ov > best || (ov == best && oi < besti)) { best = ov; besti = oi; }
  }
  if (lane == 0) { bv[warp] = best; bi[warp] = besti; }
  __syncthreads();
  best = bv[0];
  besti = bi[0];
  for (int w = 1; w < FD_WARPS; ++w)
    if (bv[w] > best || (bv[w] == best && bi[w] < besti)) { best = bv[w]; besti = bi[w]; }
  return besti;
}

template <typename W>
__global__ void __launch_bounds__(FD_THREADS, 1) fast_loop_kernel(const FastArgs<W> a) {
  constexpr int VEC = Vec<W>::N;
  const int tid = threadIdx.x;
  const int dim = a.dim, hd = a.head_dim, nq = a.nq, inter = a.inter, L = a.L;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // (max(dim, inter)): a phase's input row
  float* fr = xs + max(dim, inter);               // (nq, hd / 2, 2) the RoPE table
  // then, 16-byte aligned, the ring and the resident weights
  uint4* ring = reinterpret_cast<uint4*>(smem4) + (max(dim, inter) + nq * hd + 3) / 4;
  uint4* resident = ring + FD_RING / 16;
  __shared__ float red[FD_WARPS * 8];
  __shared__ float scal[32];
  __shared__ float part[2 * 4 * FD_WARPS];
  __shared__ float bv[FD_WARPS];
  __shared__ int bi[FD_WARPS];
  __shared__ int res_off[4 * FD_MAXL + 1];  // each slice's first resident uint4
  __shared__ unsigned long long mbar_ring;
  __shared__ unsigned long long mbar_res[FD_MAXL + 1];  // a layer's, the head's
  // with `stamps`: each block's global time where it reaches and where it
  // leaves every grid barrier (sync point 0 is the start, the last the end)
  int sp = 0;
  auto stamp = [&]() {
    if (a.stamps != nullptr && tid == 0) {
      a.stamps[((size_t)sp * gridDim.x + blockIdx.x) * 2] = global_ns();
      a.stamps[((size_t)sp * gridDim.x + blockIdx.x) * 2 + 1] = global_ns();
    }
    ++sp;
  };
  const int* my = a.plan + blockIdx.x * a.plan_stride;
  const int* my_res = my + 2 * FD_NPH;  // resident tasks of each slice
  const int u_qkv = my[2 * PH_QKV], n_qkv = my[2 * PH_QKV + 1];
  const int u_wo = my[2 * PH_WO], n_wo = my[2 * PH_WO + 1];
  const int u_13 = my[2 * PH_W13], n_13 = my[2 * PH_W13 + 1];
  const int u_w2 = my[2 * PH_W2], n_w2 = my[2 * PH_W2 + 1];
  const int u_hd = my[2 * PH_HEAD], n_hd = my[2 * PH_HEAD + 1];
  const int nslice = 4 * L + 1;  // layer by layer A, B, C, D, then the head
  auto slice_k = [&](int i) { return i < 4 * L && i % 4 == PH_W2 ? inter : dim; };
  auto slice = [&](int i) {
    Slice<W> sl;
    sl.p = i == 4 * L ? (int)PH_HEAD : i % 4;
    sl.l = i == 4 * L ? 0 : i / 4;
    sl.u0 = my[2 * sl.p];
    sl.ntask = my[2 * sl.p + 1] * (sl.p == PH_W13 ? 2 : 1);
    sl.K = slice_k(i);
    sl.res = my_res[i];
    sl.ring = min(sl.ntask - sl.res, FD_RING / (sl.K * 16));
    sl.resident = resident + res_off[i];
    return sl;
  };
  // the ring's bulk copies for slice i (none for i < 0), on thread 0
  auto issue_ring = [&](int i) {
    if (i < 0) return;
    const Slice<W> sl = slice(i);
    if (sl.ring == 0) return;
    mbar_expect(&mbar_ring, (unsigned)(sl.ring * sl.K * 16));
    if (sl.p != PH_W13) {  // consecutive units of one matrix: one copy
      bulk_load(ring, sl.global(a, sl.res), sl.ring * sl.K * 16, &mbar_ring);
      return;
    }
    for (int t = sl.res; t < sl.res + sl.ring; ++t)  // w1 and w3 alternate
      bulk_load(ring + (size_t)(t - sl.res) * sl.K, sl.global(a, t), sl.K * 16, &mbar_ring);
  };
  unsigned ring_parity = 0;
  auto await_slice = [&](const Slice<W>& sl, int s) {  // every thread, before the slice's reads
    if (s == 0 && sl.res > 0) mbar_wait(&mbar_res[sl.p == PH_HEAD ? L : sl.l], 0);
    if (sl.ring > 0) {
      mbar_wait(&mbar_ring, ring_parity);
      ring_parity ^= 1;
    }
  };

  // a grid barrier; before it, the ring's copies for slice `next` (the
  // block's reads of the ring ended at its phase's last __syncthreads)
  auto barrier = [&](int next) {
    if (tid == 0) issue_ring(next);
    if (a.stamps != nullptr && tid == 0)
      a.stamps[((size_t)sp * gridDim.x + blockIdx.x) * 2] = global_ns();
    count_barrier(a.bar_count);
    if (a.stamps != nullptr && tid == 0)
      a.stamps[((size_t)sp * gridDim.x + blockIdx.x) * 2 + 1] = global_ns();
    ++sp;
  };

  stamp();
  if (tid == 0) {
    int off = 0;
    for (int i = 0; i < nslice; ++i) {
      res_off[i] = off;
      off += my_res[i] * slice_k(i);
    }
    mbar_init(&mbar_ring);
    for (int l = 0; l <= L; ++l) mbar_init(&mbar_res[l]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the resident weights, once, a layer's on its own mbarrier (the head's
  // last); then the ring for the first phase
  if (tid == 0) {
    for (int l = 0; l <= L; ++l) {
      const int i0 = 4 * l, i1 = l < L ? i0 + 4 : i0 + 1;
      unsigned bytes = 0;
      for (int i = i0; i < i1; ++i) bytes += my_res[i] * slice_k(i) * 16;
      if (bytes == 0) continue;
      mbar_expect(&mbar_res[l], bytes);
      for (int i = i0; i < i1; ++i) {
        const Slice<W> sl = slice(i);
        for (int t = 0; t < sl.res; ++t)
          bulk_load(sl.resident + (size_t)t * sl.K, sl.global(a, t), sl.K * 16, &mbar_res[l]);
      }
    }
  }
  if (tid == 0) issue_ring(0);
  for (int i = tid; i < nq * hd; i += FD_THREADS) fr[i] = a.freqs[i];
  // h <- hidden in the columns this block adds wo into (read back by this
  // block only until barrier B); phase A of step 0 reads `hidden` itself
  for (int c = u_wo * VEC + tid; c < (u_wo + n_wo) * VEC; c += FD_THREADS)
    a.h[c] = a.hidden[c];
  float aacc[FD_ROW];  // block 0: the audio embedding summed so far

  // h += product, rounded to W, in the columns of a unit run from u0; `hv`
  // is this thread's column of h, loaded when the phase began
  auto resid = [&](int u0, float hv) {
    return [&, u0, hv](int u, int v, auto sm) {
      const int c = (u0 + u) * VEC + v;
      a.h[c] = from_f<W>((u * VEC + v == tid ? hv : ld_cg(a.h + c)) + rnd<W>(sm(0, v)));
    };
  };

  int code = 0;  // the last step's code, the same in every thread of the grid
  for (int s = 0; s < nq; ++s) {
    for (int l = 0; l < L; ++l) {
      const size_t ld = (size_t)l * dim;
      // A: RMSNorm, qkv; q roped into a.q, k roped and v into slot s.  At
      // layer 0 of a later step the input is the sampled code's embedding,
      // read from the table (h's owners write it, but not before barrier A);
      // at step 0 it is `hidden`.
      if (n_qkv > 0) {
        const Slice<W> sl = slice(4 * l + PH_QKV);
        if (l == 0)
          norm_row<W>(s == 0 ? a.hidden : a.emb + (size_t)code * dim, false, a.anorm, dim,
                      a.eps, xs, scal);
        else
          norm_row<W>(a.h, true, a.anorm + ld, dim, a.eps, xs, scal);
        W* kslot = a.kc + ((size_t)(l * nq + s)) * dim;
        W* vslot = a.vc + ((size_t)(l * nq + s)) * dim;
        await_slice(sl, s);
        matvec_tasks<W, 1>(xs, dim, n_qkv, red,
                           [&](int t) { return sl.col(a, ring, t); },
                           [&](int u, int v, auto sm) {
          const int c = (u_qkv + u) * VEC + v;
          const float val = rnd<W>(sm(0, v));
          if (c >= 2 * dim) {
            vslot[c - 2 * dim] = from_f<W>(val);
            return;
          }
          const int d = (c % dim) % hd;
          const float other = rnd<W>(sm(0, v ^ 1));
          const float x0 = (d & 1) ? other : val, x1 = (d & 1) ? val : other;
          const float* f = fr + ((size_t)s * (hd / 2) + (d >> 1)) * 2;
          const float r = (d & 1) ? x1 * f[0] + x0 * f[1] : x0 * f[0] - x1 * f[1];
          if (c < dim) a.q[c] = r;
          else kslot[c - dim] = from_f<W>(rnd<W>(r));
        });
      }
      barrier(4 * l + PH_WO);
      // B: attention (every block that owns wo columns), then wo + residual
      if (n_wo > 0) {
        const Slice<W> sl = slice(4 * l + PH_WO);
        const float hv = tid < n_wo * VEC ? ld_cg(a.h + u_wo * VEC + tid) : 0.f;
        attention<W>(a, l, s, xs);
        await_slice(sl, s);
        matvec_tasks<W, 1>(xs, dim, n_wo, red, [&](int t) { return sl.col(a, ring, t); },
                           resid(u_wo, hv));
      }
      barrier(4 * l + PH_W13);
      // C: RMSNorm, w1 and w3 with the SwiGLU gate
      if (n_13 > 0) {
        const Slice<W> sl = slice(4 * l + PH_W13);
        norm_row<W>(a.h, true, a.fnorm + ld, dim, a.eps, xs, scal);
        await_slice(sl, s);
        matvec_tasks<W, 2>(xs, dim, n_13, red, [&](int t) { return sl.col(a, ring, t); },
                           [&](int u, int v, auto sm) {
          const float x = rnd<W>(sm(0, v));
          const float silu = x / (1.f + expf(-x));
          a.gate[(u_13 + u) * VEC + v] = from_f<W>(rnd<W>(silu) * rnd<W>(sm(1, v)));
        });
      }
      barrier(4 * l + PH_W2);
      // D: w2 + residual
      if (n_w2 > 0) {
        const Slice<W> sl = slice(4 * l + PH_W2);
        const float hv = tid < n_w2 * VEC ? ld_cg(a.h + u_w2 * VEC + tid) : 0.f;
        float gv[FD_ROW];
        load_row<W>(a.gate, true, inter, gv);
#pragma unroll
        for (int r = 0; r < FD_ROW; ++r)
          if (tid + r * FD_THREADS < inter) xs[tid + r * FD_THREADS] = gv[r];
        __syncthreads();
        await_slice(sl, s);
        matvec_tasks<W, 1>(xs, inter, n_w2, red, [&](int t) { return sl.col(a, ring, t); },
                           resid(u_w2, hv));
      }
      barrier(l + 1 < L ? 4 * (l + 1) + PH_QKV : 4 * L);
    }
    // head: RMSNorm, the float32 logits (rounded to W, as the TPU kernel's
    // product), then the sampler in every block
    float* lrow = a.logits + (size_t)s * a.V;
    if (n_hd > 0) {
      const Slice<W> sl = slice(4 * L);
      norm_row<W>(a.h, true, a.onorm, dim, a.eps, xs, scal);
      await_slice(sl, s);
      matvec_tasks<W, 1>(xs, dim, n_hd, red, [&](int t) { return sl.col(a, ring, t); },
                         [&](int u, int v, auto sm) {
        lrow[(u_hd + u) * VEC + v] = rnd<W>(sm(0, v));
      });
    }
    float gv[FD_VOC];  // this thread's Gumbel noise of the step (an input)
#pragma unroll
    for (int r = 0; r < FD_VOC; ++r) {
      const int i = tid + r * FD_THREADS;
      gv[r] = !a.greedy && i < a.V ? __ldg(a.gumbel + (size_t)s * a.V + i) : 0.f;
    }
    barrier(s + 1 < nq ? PH_QKV : -1);
    code = sample_block(lrow, gv, a.V, a.greedy, a.temperature, a.top_p, scal, part, bv, bi);
    // h <- fast_embeddings[code] in the columns this block adds wo into next
    if (s + 1 < nq)
      for (int c = u_wo * VEC + tid; c < (u_wo + n_wo) * VEC; c += FD_THREADS)
        a.h[c] = a.emb[(size_t)code * dim + c];
    if (blockIdx.x == 0) {  // the codebook row, summed in W
      if (tid == 0) a.codes[s] = code;
      float cv[FD_ROW];
      load_row<W>(a.cbemb + ((size_t)s * a.V + code) * a.mdim, false, a.mdim, cv);
#pragma unroll
      for (int r = 0; r < FD_ROW; ++r) aacc[r] = s == 0 ? cv[r] : rnd<W>(aacc[r] + cv[r]);
    }
  }
  if (blockIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < FD_ROW; ++r)
      if (tid + r * FD_THREADS < a.mdim) a.aemb[tid + r * FD_THREADS] = from_f<W>(aacc[r]);
  }
  __syncthreads();
  stamp();
}

template <typename W>
cudaError_t launch(const FastArgs<W>& a, int grid, cudaStream_t st) {
  auto kern = fast_loop_kernel<W>;
  // a phase's input row and the RoPE table, the ring, the resident weights
  const size_t smem = 16 * (size_t)((max(a.dim, a.inter) + a.nq * a.head_dim + 3) / 4) +
                      FD_RING + (size_t)a.res_bytes;
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, FD_THREADS, smem)) !=
      cudaSuccess)
    return e;
  // one block per SM, all resident at once, or no launch
  if (grid != sms || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<FastArgs<W>*>(&a)};
  if ((e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(FD_THREADS), args,
                                       smem, st)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

template <typename W>
int run(const void* hidden, void* h, const void* gumbel, const void* wqkv, const void* wo,
        const void* w1, const void* w3, const void* w2, const void* anorm, const void* fnorm,
        const void* onorm, const void* wout, const void* emb, const void* cbemb,
        const void* freqs, const void* plan, void* codes, void* aemb, void* kc, void* vc,
        void* q, void* gate, void* logits, void* stamps, void* bar_count, int grid,
        int res_bytes, int L, int nq, int dim, int n_head,
        int head_dim, int inter, int V, int mdim, float eps, float scale, float temperature,
        float top_p, int greedy, void* stream) {
  FastArgs<W> a;
  a.hidden = (const W*)hidden;
  a.h = (W*)h;
  a.gumbel = (const float*)gumbel;
  a.wqkv = (const W*)wqkv;
  a.wo = (const W*)wo;
  a.w1 = (const W*)w1;
  a.w3 = (const W*)w3;
  a.w2 = (const W*)w2;
  a.anorm = (const W*)anorm;
  a.fnorm = (const W*)fnorm;
  a.onorm = (const W*)onorm;
  a.wout = (const W*)wout;
  a.emb = (const W*)emb;
  a.cbemb = (const W*)cbemb;
  a.freqs = (const float*)freqs;
  a.plan = (const int*)plan;
  a.codes = (int*)codes;
  a.aemb = (W*)aemb;
  a.kc = (W*)kc;
  a.vc = (W*)vc;
  a.q = (float*)q;
  a.gate = (W*)gate;
  a.logits = (float*)logits;
  a.stamps = (unsigned long long*)stamps;
  a.bar_count = (unsigned long long*)bar_count;
  a.plan_stride = 2 * FD_NPH + 4 * L + 1;
  a.res_bytes = res_bytes;
  a.L = L;
  a.nq = nq;
  a.dim = dim;
  a.n_head = n_head;
  a.head_dim = head_dim;
  a.inter = inter;
  a.V = V;
  a.mdim = mdim;
  a.eps = eps;
  a.scale = scale;
  a.temperature = temperature;
  a.top_p = top_p;
  a.greedy = greedy;
  const int cph = head_dim / Vec<W>::N;  // 16-byte chunks a head: 1, 2, 4, .. 32
  if (nq < 1 || nq > FD_MAXQ || (nq - 1) / (32 / max(cph, 1)) >= FD_MAXR ||
      V > FD_VOC * FD_THREADS || L < 1 ||
      L > FD_MAXL || res_bytes % 16 ||
      max(max(dim, inter), mdim) > FD_ROW * FD_THREADS ||
      head_dim % Vec<W>::N || cph > 32 || (cph & (cph - 1)))
    return (int)cudaErrorInvalidValue;
  return (int)launch<W>(a, grid, (cudaStream_t)stream);
}

}  // namespace

// wdtype: 0 = float32, 1 = bfloat16
extern "C" int svd_fast_decode(
    int wdtype, const void* hidden, void* h, const void* gumbel, const void* wqkv,
    const void* wo, const void* w1, const void* w3, const void* w2, const void* anorm,
    const void* fnorm, const void* onorm, const void* wout, const void* emb,
    const void* cbemb, const void* freqs, const void* plan, void* codes, void* aemb,
    void* kc, void* vc, void* q, void* gate, void* logits, void* stamps, void* bar_count,
    int grid, int res_bytes, int L, int nq,
    int dim, int n_head, int head_dim, int inter, int V, int mdim, float eps, float scale,
    float temperature, float top_p, int greedy, void* stream) {
#define SVD_RUN(W)                                                                     \
  return run<W>(hidden, h, gumbel, wqkv, wo, w1, w3, w2, anorm, fnorm, onorm, wout, emb, \
                cbemb, freqs, plan, codes, aemb, kc, vc, q, gate, logits, stamps,       \
                bar_count, grid, res_bytes,                                             \
                L, nq, dim, n_head, head_dim, inter, V, mdim, eps, scale, temperature,  \
                top_p, greedy, stream)
  if (wdtype == 0) SVD_RUN(float);
  if (wdtype == 1) SVD_RUN(bf16);
#undef SVD_RUN
  return (int)cudaErrorInvalidValue;
}
