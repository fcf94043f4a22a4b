// Device kernels shared by the dual-AR slow step (slow_decode.cu, which uses
// the matvec and the sampler with its own split-row attention).  The fast
// codebook loop (fast_decode.cu), the windowed-transformer ring step
// (wt_stream.cu) and the ConvNeXt encoder front (convnext_enc.cu) are
// persistent kernels of their own; they share the pieces of the "persistent
// kernels" section below: the grid barrier, reads through L2 of what other
// blocks wrote, the column-owner matvec over packed weights (the front has
// its own of four rows, on the same task map), and the mbarrier and
// bulk-copy (TMA) helpers.
//
// Two kernels, launched in sequence by the host entry points:
//
//   matvec_kernel   y = x @ W for R (1 or 2) input rows, W (K, N) row-major
//                   in float32 or bf16, float32 accumulation.  Optional fused
//                   RMSNorm of the input, and one of four epilogues: store,
//                   store as float32 logits, residual add, SwiGLU gate (two
//                   weight matrices in one launch).  Split over K across
//                   blocks; the last block of a column tile to finish sums
//                   the K-chunks in a fixed order and applies the epilogue,
//                   so every weight byte is read once per call, serves both
//                   rows, and the result does not depend on block timing.
//   sample_kernel   one block over the vocabulary: softmax, 40-step
//                   bisection for the nucleus threshold, Gumbel race, argmax
//                   with the lowest index on ties.
//
// Rounding follows the TPU kernels (ops/pallas_slow_decode.py and
// ops/pallas_fast_decode.py of the JAX package): activations are rounded
// to the weight type W wherever those kernels cast to it.  `rnd<T>` is the
// identity for float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace svd {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// round a float through T (round to nearest even)
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// elements per 16-byte load
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 16 raw bytes as VEC floats
template <typename T>
__device__ __forceinline__ void unpack_vec(const uint4& raw, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  } else {
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
  }
}

// Programmatic dependent launch (Hopper): a kernel launched with
// launch_pdl may start while the previous launch on its stream finishes.
// `pdl_launch_dependents` lets the next launch start; `pdl_wait` returns
// once the previous launch has completed and its writes are visible.  Both
// are no-ops in a kernel launched without the attribute.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

template <typename... Params, typename... Args>
inline cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                              cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  if constexpr (std::is_same<T, float>::value) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  } else {
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max over `nthreads` threads (a multiple of 32) with
// linear index `tid`; every thread gets the result.  `red` holds 32 floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red, int tid, int nthreads) {
  const int lane = tid & 31, wid = tid >> 5, nw = nthreads >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // `red` may still be read by a previous reduction
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float r = lane < nw ? red[lane] : (MAX ? -CUDART_INF_F : 0.f);
  return MAX ? warp_max(r) : warp_sum(r);
}

// ---------------------------------------------------------------------------
// matvec
// ---------------------------------------------------------------------------

constexpr int MV_TX = 8;    // threads across columns (VEC columns each)
constexpr int MV_TY = 32;   // threads across the K-chunk
constexpr int MV_KC = 128;  // K rows per block

enum Epilogue { EPI_STORE = 0, EPI_STORE_F32 = 1, EPI_RESID = 2, EPI_SWIGLU = 3 };

// PDL (the slow step only): the block loads its weights, lets the next
// launch start, then waits for the previous launch before it reads x, so
// the weight stream overlaps the previous launch's tail.
template <typename W, int R, int EPI, bool PDL = false>
__global__ void __launch_bounds__(MV_TX * MV_TY)
matvec_kernel(const W* __restrict__ x, const W* __restrict__ norm_w, float eps,
              const W* __restrict__ wa, const W* __restrict__ wb, int K, int N,
              float* __restrict__ partials, int* __restrict__ counters, void* out) {
  constexpr int VEC = Vec<W>::N;
  constexpr int TCOLS = MV_TX * VEC;
  constexpr int NMAT = EPI == EPI_SWIGLU ? 2 : 1;
  constexpr int NT = MV_TX * MV_TY;
  __shared__ float xs[R][MV_KC];
  __shared__ float red[MV_TY][R][TCOLS];
  __shared__ float scal[32];
  __shared__ float inv_rms[R];
  __shared__ bool am_last;

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * MV_TX + tx;
  const int tile = blockIdx.x, ky = blockIdx.y, z = blockIdx.z;
  const int ksplit = gridDim.y;
  const int k0 = ky * MV_KC, k1 = min(K, k0 + MV_KC);
  const W* wm = z == 0 ? wa : wb;
  const int col0 = tile * TCOLS + tx * VEC;
  constexpr int KPT = MV_KC / MV_TY;  // K rows per thread
  uint4 wraw[PDL ? KPT : 1];
  if constexpr (PDL) {
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int k = k0 + ty + i * MV_TY;
      wraw[i] = col0 < N && k < k1
                    ? __ldg(reinterpret_cast<const uint4*>(wm + (size_t)k * N + col0))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    pdl_launch_dependents();
    pdl_wait();
  }

  // 1. this block's K-chunk of the input rows, RMS-normalized if asked
  if (norm_w != nullptr) {
    for (int r = 0; r < R; ++r) {
      float ss = 0.f;
      for (int k = tid; k < K; k += NT) {
        const float v = to_f<W>(x[r * K + k]);
        ss += v * v;
      }
      ss = block_reduce<false>(ss, scal, tid, NT);
      if (tid == 0) inv_rms[r] = rsqrtf(ss / (float)K + eps);
    }
    __syncthreads();
  }
  for (int i = tid; i < R * MV_KC; i += NT) {
    const int r = i / MV_KC, kk = i % MV_KC, k = k0 + kk;
    float v = 0.f;
    if (k < k1) {
      v = to_f<W>(x[r * K + k]);
      if (norm_w != nullptr) v = rnd<W>(rnd<W>(v * inv_rms[r]) * to_f<W>(norm_w[k]));
    }
    xs[r][kk] = v;
  }
  __syncthreads();

  // 2. partial products over the K-chunk, VEC columns per thread
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
  if (col0 < N) {
    if constexpr (PDL) {
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int k = k0 + ty + i * MV_TY;
        if (k >= k1) break;
        float wv[VEC];
        unpack_vec<W>(wraw[i], wv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = xs[r][k - k0];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
        }
      }
    } else {
      for (int k = k0 + ty; k < k1; k += MV_TY) {
        float wv[VEC];
        load_vec<W>(wm + (size_t)k * N + col0, wv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = xs[r][k - k0];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[ty][r][tx * VEC + v] = acc[r][v];
  __syncthreads();
  for (int i = tid; i < R * TCOLS; i += NT) {
    const int r = i / TCOLS, c = i % TCOLS, n = tile * TCOLS + c;
    float s = 0.f;
    for (int t = 0; t < MV_TY; ++t) s += red[t][r][c];
    if (n < N) partials[((size_t)(z * ksplit + ky) * R + r) * N + n] = s;
  }

  // 3. the last block of this column tile sums the K-chunks in order
  __threadfence();
  __syncthreads();
  if (tid == 0) am_last = atomicAdd(&counters[tile], 1) == NMAT * ksplit - 1;
  __syncthreads();
  if (!am_last) return;
  for (int i = tid; i < R * TCOLS; i += NT) {
    const int r = i / TCOLS, c = i % TCOLS, n = tile * TCOLS + c;
    if (n >= N) continue;
    float s[NMAT];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      s[m] = 0.f;
      for (int kk = 0; kk < ksplit; ++kk)
        s[m] += __ldcg(&partials[((size_t)(m * ksplit + kk) * R + r) * N + n]);
    }
    const size_t o = (size_t)r * N + n;
    if constexpr (EPI == EPI_STORE) {
      static_cast<W*>(out)[o] = from_f<W>(s[0]);
    } else if constexpr (EPI == EPI_STORE_F32) {
      static_cast<float*>(out)[o] = rnd<W>(s[0]);
    } else if constexpr (EPI == EPI_RESID) {
      W* h = static_cast<W*>(out);
      h[o] = from_f<W>(to_f<W>(h[o]) + rnd<W>(s[0]));
    } else {
      const float a = rnd<W>(s[0]);
      const float silu = a / (1.f + expf(-a));
      static_cast<W*>(out)[o] = from_f<W>(rnd<W>(silu) * rnd<W>(s[NMAT - 1]));
    }
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch
}

// Scratch this launch needs: partials floats and counter ints.
template <typename W>
inline size_t matvec_tiles(int N) {
  constexpr int TCOLS = MV_TX * Vec<W>::N;
  return (size_t)((N + TCOLS - 1) / TCOLS);
}

template <typename W, int R, int EPI, bool PDL = false>
inline cudaError_t launch_matvec(const W* x, const W* norm_w, float eps, const W* wa,
                                 const W* wb, int K, int N, float* partials,
                                 int* counters, void* out, cudaStream_t st) {
  dim3 grid((unsigned)matvec_tiles<W>(N), (unsigned)((K + MV_KC - 1) / MV_KC),
            EPI == EPI_SWIGLU ? 2 : 1);
  dim3 block(MV_TX, MV_TY);
  if constexpr (PDL) {
    const cudaError_t e = launch_pdl(matvec_kernel<W, R, EPI, true>, grid, block, st, x,
                                     norm_w, eps, wa, wb, K, N, partials, counters, out);
    if (e != cudaSuccess) return e;
  } else {
    matvec_kernel<W, R, EPI><<<grid, block, 0, st>>>(x, norm_w, eps, wa, wb, K, N,
                                                     partials, counters, out);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// persistent kernels (fast_decode.cu, wt_stream.cu, convnext_enc.cu): one
// cooperative launch, one block of PK_THREADS per SM, phases separated by
// grid barriers; a block owns whole output columns (16-byte units of packed
// weights) of each phase
// ---------------------------------------------------------------------------

constexpr int PK_THREADS = 512;
constexpr int PK_WARPS = PK_THREADS / 32;
constexpr int PK_DEPTH = 8;  // 16-byte weight loads in flight a lane
constexpr int PK_ROW = 5;    // row values a thread: K <= 2560

// a value another block wrote during this launch: through L2, not L1
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const bf16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// The K <= PK_ROW * PK_THREADS values of a row, value tid + r * PK_THREADS
// in v[r] (0 past K), every load issued before the first is used (a loop
// whose trips the compiler cannot count waits out each load in turn).
// Read through L2 when `shared_row` (written by other blocks).
template <typename W>
__device__ __forceinline__ void load_row(const W* row, bool shared_row, int K,
                                         float (&v)[PK_ROW]) {
#pragma unroll
  for (int r = 0; r < PK_ROW; ++r) {
    const int k = threadIdx.x + r * PK_THREADS;
    v[r] = k < K ? (shared_row ? ld_cg(row + k) : to_f<W>(__ldg(row + k))) : 0.f;
  }
}

// xs <- RMSNorm(row) * norm_w, rounded as the TPU kernel rounds (the input
// rounded to W after the scale, then the product rounded to W).
template <typename W>
__device__ void norm_row(const W* row, bool shared_row, const W* norm_w, int K, float eps,
                         float* xs, float* scal) {
  const int tid = threadIdx.x;
  float v[PK_ROW], nw[PK_ROW];
  load_row<W>(row, shared_row, K, v);
  load_row<W>(norm_w, false, K, nw);
  float ss = 0.f;
#pragma unroll
  for (int r = 0; r < PK_ROW; ++r) ss += v[r] * v[r];
  ss = warp_sum(ss);
  if ((tid & 31) == 0) scal[tid >> 5] = ss;  // free: the last reader passed a barrier
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < PK_WARPS; ++w) ss += scal[w];
  const float inv = rsqrtf(ss / (float)K + eps);
#pragma unroll
  for (int r = 0; r < PK_ROW; ++r) {
    const int k = tid + r * PK_THREADS;
    if (k < K) xs[k] = rnd<W>(rnd<W>(v[r] * inv) * nw[r]);
  }
  __syncthreads();
}

// Sums each of the VEC values v[] over the warp: the values are halved at
// each exchange (the lane whose offset bit is set keeps the upper half), so
// a lane ends with the total of value (lane / (32 / VEC)) % VEC after
// log2(VEC) + log2(32 / VEC) exchanges, not VEC * 5.
template <int VEC>
__device__ __forceinline__ float warp_sum_vec(float* v, int lane) {
#pragma unroll
  for (int n = VEC / 2, o = 16; n >= 1; n /= 2, o /= 2) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? v[i] : v[i + n];
      const float keep = up ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float r = v[0];
#pragma unroll
  for (int o = 16 / VEC; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

// How a block's warps split a phase's tasks, (unit, matrix) pairs unit-major
// from task t0: each of the first min(16, tasks - t0) tasks gets
// PK_WARPS / that many warps, whose lanes walk the unit's K rows at a stride
// of 32 x warps a task.
struct TaskMap {
  int nt, wpt, ti, wi, stride;
  __device__ TaskMap(int ntask, int t0, int warp) {
    nt = min(PK_WARPS, ntask - t0);
    wpt = PK_WARPS / max(nt, 1);
    ti = warp / wpt;
    wi = warp % wpt;
    stride = wpt * 32;
  }
};

// The block's columns of xs (K floats in shared memory) times a phase's
// tasks: `col(task)` is the task's K x 16-byte weight slice, in shared
// memory (resident, or in the ring) or in global memory, VEC columns of
// one matrix.  Every column is summed over the whole K in a fixed order,
// PK_DEPTH 16-byte loads in flight a lane.  Then `epi(unit, v, sum)` runs
// once per column (units counted from the phase's first), on thread
// unit * VEC + v for the first 16 tasks, `sum(m, v')` being column v' of the
// unit's matrix m summed over the task's warps in warp order.
template <typename W, int NMAT, typename Col, typename Epi>
__device__ void matvec_tasks(const float* __restrict__ xs, int K, int nu, float* red, Col col,
                             Epi epi) {
  constexpr int VEC = Vec<W>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntask = nu * NMAT;
  for (int t0 = 0; t0 < ntask; t0 += PK_WARPS) {
    const TaskMap tm(ntask, t0, warp);
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    if (tm.ti < tm.nt) {
      const uint4* w = col(t0 + tm.ti);
      for (int k0 = tm.wi * 32 + lane; k0 < K; k0 += PK_DEPTH * tm.stride) {
        uint4 raw[PK_DEPTH];
#pragma unroll
        for (int j = 0; j < PK_DEPTH; ++j) {
          const int k = k0 + j * tm.stride;
          raw[j] = k < K ? w[k] : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < PK_DEPTH; ++j) {
          const int k = k0 + j * tm.stride;
          if (k < K) {
            float wv[VEC];
            unpack_vec<W>(raw[j], wv);
            const float xv = xs[k];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xv, wv[v], acc[v]);
          }
        }
      }
    }
    const float tot = warp_sum_vec<VEC>(acc, lane);
    if (lane % (32 / VEC) == 0) red[warp * VEC + (lane / (32 / VEC)) % VEC] = tot;
    __syncthreads();
    // the sum of column v' of task t over its warps, in warp order
    auto sum = [&](int t, int v) {
      float x = 0.f;
      for (int w = 0; w < tm.wpt; ++w) x += red[(t * tm.wpt + w) * VEC + v];
      return x;
    };
    for (int i = tid; i < tm.nt / NMAT * VEC; i += PK_THREADS) {
      const int ul = i / VEC;
      epi(t0 / NMAT + ul, i % VEC, [&](int m, int v) { return sum(ul * NMAT + m, v); });
    }
    __syncthreads();
  }
}

// mbarriers and bulk copies (TMA) into shared memory
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(1));
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_load(const void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A grid-wide barrier on a 64-bit arrival count that only grows: each
// block's thread 0 adds one with release semantics and waits, reading with
// acquire semantics, until the count reaches the next multiple of the grid
// (so nothing is reset, and a launch leaves it at a multiple).
__device__ __forceinline__ void count_barrier(unsigned long long* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long old, now;
    asm volatile("atom.release.gpu.global.add.u64 %0, [%1], %2;"
                 : "=l"(old) : "l"(count), "l"(1ull) : "memory");
    const unsigned long long target = (old / gridDim.x + 1) * gridDim.x;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(now) : "l"(count) : "memory");
    } while (now < target);
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---------------------------------------------------------------------------
// sampling
// ---------------------------------------------------------------------------

constexpr int SM_THREADS = 1024;
constexpr int SM_VPT = 16;  // vocab <= 16384

// PDL: launched after the slow step's output-head matvec, it waits for it
// before reading the logits.
template <bool PDL = false>
__global__ void __launch_bounds__(SM_THREADS)
sample_kernel(const float* __restrict__ logits, int V, const float* __restrict__ gumbel,
              int greedy, float temperature, float top_p, int* __restrict__ token) {
  __shared__ float red[32];
  __shared__ float bv[32];
  __shared__ int bi[32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  if constexpr (PDL) pdl_wait();
  float lg[SM_VPT], race[SM_VPT];
#pragma unroll
  for (int i = 0; i < SM_VPT; ++i) {
    const int idx = tid + i * SM_THREADS;
    lg[i] = idx < V ? logits[idx] : -CUDART_INF_F;
  }
  if (greedy) {
#pragma unroll
    for (int i = 0; i < SM_VPT; ++i) race[i] = lg[i];
  } else {
    if (top_p < 1.f) {
      // exact nucleus filter: keep {i : p_i > lo}, lo the 40-step bisection
      // threshold of "mass strictly above <= top_p"
      float m = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < SM_VPT; ++i) m = fmaxf(m, lg[i]);
      m = block_reduce<true>(m, red, tid, SM_THREADS);
      float pr[SM_VPT], s = 0.f;
#pragma unroll
      for (int i = 0; i < SM_VPT; ++i) {
        pr[i] = tid + i * SM_THREADS < V ? expf(lg[i] - m) : 0.f;
        s += pr[i];
      }
      s = block_reduce<false>(s, red, tid, SM_THREADS);
#pragma unroll
      for (int i = 0; i < SM_VPT; ++i) pr[i] = pr[i] / s;
      float lo = 0.f, hi = 1.f;
      for (int it = 0; it < 40; ++it) {
        const float mid = (lo + hi) * 0.5f;
        float mass = 0.f;
#pragma unroll
        for (int i = 0; i < SM_VPT; ++i) mass += pr[i] > mid ? pr[i] : 0.f;
        mass = block_reduce<false>(mass, red, tid, SM_THREADS);
        if (mass <= top_p) hi = mid; else lo = mid;
      }
#pragma unroll
      for (int i = 0; i < SM_VPT; ++i) lg[i] = pr[i] > lo ? lg[i] : -CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < SM_VPT; ++i) {
      const int idx = tid + i * SM_THREADS;
      race[i] = idx < V ? lg[i] / temperature + gumbel[idx] : -CUDART_INF_F;
    }
  }
  // argmax, lowest index on ties
  float best = -CUDART_INF_F;
  int besti = 0x7fffffff;
#pragma unroll
  for (int i = 0; i < SM_VPT; ++i) {
    const int idx = tid + i * SM_THREADS;
    if (idx < V && (race[i] > best || besti == 0x7fffffff)) { best = race[i]; besti = idx; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, besti, o);
    if (ov > best || (ov == best && oi < besti)) { best = ov; besti = oi; }
  }
  if (lane == 0) { bv[wid] = best; bi[wid] = besti; }
  __syncthreads();
  if (wid == 0) {
    best = bv[lane];
    besti = bi[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, besti, o);
      if (ov > best || (ov == best && oi < besti)) { best = ov; besti = oi; }
    }
    if (lane == 0) *token = besti;
  }
}

}  // namespace svd
