// Per-head decode attention against a per-head KV cache: for each head h,
// write the T new key and value rows at rows pos .. pos+T-1 of the (S, D)
// caches in place, then attend each query t over the cache rows
// <= pos + t.  The port of `decode_attention` / `decode_attention_prepadded`
// in ops/pallas_attention.py of the JAX package; see
// streamvoiceanon_tpu_torch/ops/attention.py for the design note.
//
// Arithmetic as the TPU kernel: the query is divided by sqrt(D) in float32
// and rounded to the cache type C; scores are float32 products; one max and
// one denominator per query over the old and the fresh rows; the weights
// are normalized before the value mix; the output is rounded to C.  Only
// rows < pos + T are read, and the fresh rows are read from the new-row
// inputs, so the in-place write of rows pos .. pos+T-1 races with no read.
//
// One block per head.  A row is read by LPR lanes with one 16-byte load
// each (D = LPR * 16 / sizeof(C)); each lane group keeps DA_UNROLL rows in
// flight; the scores of a head stay in shared memory between the passes.
//
// Plain C interface for ctypes.  q, k_new, v_new and out are (H, T, D),
// the caches (H, S, D), all of the cache type and contiguous, device
// pointers.  Returns the launch's CUDA error (0 when it was accepted).

#include "decode_common.cuh"

using namespace svd;

namespace {

constexpr int DA_THREADS = 512;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_UNROLL = 4;

// 16 bytes of row `p` as floats, through the coherent path: this kernel
// writes other rows of the same caches
template <typename C>
__device__ __forceinline__ void load_row16(const C* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<C, float>::value) {
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

template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename C, int LPR, int T>
__global__ void __launch_bounds__(DA_THREADS)
decode_attn_kernel(const C* __restrict__ q, const C* __restrict__ kn,
                   const C* __restrict__ vn, C* kc, C* vc, C* __restrict__ out, int S,
                   int pos, float div) {
  constexpr int VEC = Vec<C>::N;
  constexpr int D = LPR * VEC;
  constexpr int GPW = 32 / LPR;          // lane groups per warp
  constexpr int NG = DA_WARPS * GPW;     // lane groups per block
  extern __shared__ float sm[];
  __shared__ float red[32];
  __shared__ float denom[T];
  const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp walks rows from a warp-uniform base (the group sums shuffle
  // across the whole warp); each lane group takes DA_UNROLL rows from there
  const int base0 = warp * GPW * DA_UNROLL, gro = (lane / LPR) * DA_UNROLL, sub = lane % LPR;
  const int P = pos + T;
  float* sc = sm;           // (T, P) scores, then weights
  float* wred = sc + T * P; // (DA_WARPS, T, D) per-warp value sums
  const C* qh = q + (size_t)h * T * D;
  const C* knh = kn + (size_t)h * T * D;
  const C* vnh = vn + (size_t)h * T * D;
  C* kch = kc + (size_t)h * S * D;
  C* vch = vc + (size_t)h * S * D;

  // 1. the fresh rows into the caches (no block reads them from there)
  for (int i = tid; i < T * D; i += DA_THREADS) {
    kch[(size_t)pos * D + i] = knh[i];
    vch[(size_t)pos * D + i] = vnh[i];
  }

  // 2. this lane's query slices, divided by sqrt(D) in float32, rounded to C
  float qv[T][VEC];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    load_row16<C>(qh + t * D + sub * VEC, qv[t]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[t][e] = rnd<C>(qv[t][e] / div);
  }

  // 3. scores of rows < P; row j >= pos is fresh row j - pos
  for (int base = base0; base < P; base += NG * DA_UNROLL) {
    const int j0 = base + gro;
    float kv[DA_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int j = j0 + u;
      if (j < P) {
        const C* row = j < pos ? kch + (size_t)j * D : knh + (size_t)(j - pos) * D;
        load_row16<C>(row + sub * VEC, kv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) p = fmaf(qv[t][e], kv[u][e], p);
        p = group_sum<LPR>(p);
        if (sub == 0 && j < P) sc[t * P + j] = j <= pos + t ? p : -CUDART_INF_F;
      }
    }
  }
  __syncthreads();

  // 4. softmax per query: one max, one denominator, weights normalized
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int nv = pos + t + 1;
    float m = -CUDART_INF_F;
    for (int j = tid; j < nv; j += DA_THREADS) m = fmaxf(m, sc[t * P + j]);
    m = block_reduce<true>(m, red, tid, DA_THREADS);
    float s = 0.f;
    for (int j = tid; j < P; j += DA_THREADS) {
      const float e = j < nv ? expf(sc[t * P + j] - m) : 0.f;
      sc[t * P + j] = e;
      s += e;
    }
    s = block_reduce<false>(s, red, tid, DA_THREADS);
    if (tid == 0) denom[t] = s;
  }
  __syncthreads();
  for (int i = tid; i < T * P; i += DA_THREADS) sc[i] = sc[i] / denom[i / P];
  __syncthreads();

  // 5. value mix: lane groups over rows, lanes over dims
  float acc[T][VEC];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[t][e] = 0.f;
  for (int base = base0; base < P; base += NG * DA_UNROLL) {
    const int j0 = base + gro;
    float vv[DA_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int j = j0 + u;
      if (j < P) {
        const C* row = j < pos ? vch + (size_t)j * D : vnh + (size_t)(j - pos) * D;
        load_row16<C>(row + sub * VEC, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int j = j0 + u;
      if (j >= P) continue;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float w = sc[t * P + j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[t][e] = fmaf(w, vv[u][e], acc[t][e]);
      }
    }
  }
  // sum the lane groups of a warp, then the warps
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) acc[t][e] += __shfl_xor_sync(0xffffffffu, acc[t][e], o);
  if (lane < LPR)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int e = 0; e < VEC; ++e) wred[(warp * T + t) * D + sub * VEC + e] = acc[t][e];
  __syncthreads();
  for (int i = tid; i < T * D; i += DA_THREADS) {
    const int t = i / D, d = i % D;
    float a = 0.f;
    for (int w = 0; w < DA_WARPS; ++w) a += wred[(w * T + t) * D + d];
    out[(size_t)h * T * D + i] = from_f<C>(a);
  }
}

template <typename C, int LPR, int T>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kc, void* vc,
                   void* out, int H, int S, int pos, float div, cudaStream_t st) {
  constexpr int D = LPR * Vec<C>::N;
  const size_t smem = sizeof(float) * ((size_t)T * (pos + T) + (size_t)DA_WARPS * T * D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<C, LPR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_attn_kernel<C, LPR, T><<<H, DA_THREADS, smem, st>>>(
      (const C*)q, (const C*)kn, (const C*)vn, (C*)kc, (C*)vc, (C*)out, S, pos, div);
  return cudaGetLastError();
}

template <typename C, int T>
cudaError_t by_lanes(int lpr, const void* q, const void* kn, const void* vn, void* kc,
                     void* vc, void* out, int H, int S, int pos, float div, cudaStream_t st) {
  switch (lpr) {
    case 2: return launch<C, 2, T>(q, kn, vn, kc, vc, out, H, S, pos, div, st);
    case 4: return launch<C, 4, T>(q, kn, vn, kc, vc, out, H, S, pos, div, st);
    case 8: return launch<C, 8, T>(q, kn, vn, kc, vc, out, H, S, pos, div, st);
    case 16: return launch<C, 16, T>(q, kn, vn, kc, vc, out, H, S, pos, div, st);
    case 32: return launch<C, 32, T>(q, kn, vn, kc, vc, out, H, S, pos, div, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// cdtype: 0 = float32, 1 = bfloat16.  T is 1 or 2; D * sizeof(C) is 16
// bytes times 2, 4, 8, 16 or 32.
extern "C" int svd_decode_attention(int cdtype, const void* q, const void* k_new,
                                    const void* v_new, void* k_cache, void* v_cache,
                                    void* out, int H, int T, int S, int D, int pos,
                                    float div, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int esize = cdtype == 0 ? 4 : 2;
  if ((D * esize) % 16 != 0 || pos < 0 || pos + T > S) return (int)cudaErrorInvalidValue;
  const int lpr = D * esize / 16;
#define SVD_RUN(C, TT) \
  return (int)by_lanes<C, TT>(lpr, q, k_new, v_new, k_cache, v_cache, out, H, S, pos, div, st)
  if (cdtype == 0 && T == 1) SVD_RUN(float, 1);
  if (cdtype == 0 && T == 2) SVD_RUN(float, 2);
  if (cdtype == 1 && T == 1) SVD_RUN(bf16, 1);
  if (cdtype == 1 && T == 2) SVD_RUN(bf16, 2);
#undef SVD_RUN
  return (int)cudaErrorInvalidValue;
}
