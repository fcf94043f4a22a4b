// Per-head decode attention against a per-head KV cache: for each head h,
// write the T new key and value rows at rows pos .. pos+T-1 of the (S, D)
// caches in place, then attend each query t over the cache rows
// <= pos + t.  The port of `decode_attention` / `decode_attention_prepadded`
// in ops/pallas_attention.py of the JAX package; see
// streamvoiceanon_tpu_torch/ops/attention.py for the design note.
//
// Arithmetic as the TPU kernel where it can be: the query is divided by
// sqrt(D) in float32 and rounded to the cache type C; scores are float32
// products; the output is rounded to C.  The softmax is taken in pieces:
// each block keeps, per query, the max m of its scores, the sum l of
// exp(s - m) and the unnormalized value sums acc, and the merge divides
// sum_s e^(m_s - M) acc_s by sum_s e^(m_s - M) l_s.  The TPU kernel
// normalizes its weights before the value mix; the two differ only in
// float32 summation order (tolerance in ops/attention.py).
//
// Grid (heads, nsplit).  Block (h, s) takes rows s * R .. s * R + R - 1 of
// the pos + T rows (R, the rows a split, a multiple of the lane groups a
// block, chosen by the wrapper from the heads and pos).  A row is read by
// LPR lanes with one 16-byte load each (D = LPR * 16 / sizeof(C)); each lane
// group loads DA_U rows of both caches at once and folds them into its own
// running max, sum and value sums, so a split's scores never leave
// registers.  Rows >= pos are read from the new-row inputs, never from the
// cache, so the in-place write of rows pos .. pos+T-1 (by the one block
// whose split holds row pos) races with no read; rows >= pos + T are never
// read.  Each block writes its partial (per query: m, l, acc[D], float32)
// to kept scratch, and the last block of a head to take a ticket merges the
// partials in split order, so the result does not depend on which block
// ran first, then writes the output and leaves the ticket at zero.
//
// Programmatic dependent launch: the block waits for the previous launch
// on the stream before it reads anything (that launch may have written the
// query, the new rows or, at the previous position, cache rows this one
// reads) and lets the next launch start once its partial is written.
//
// Plain C interface for ctypes.  q, k_new, v_new and out are (heads, T, D),
// the caches (heads, S, D), all of the cache type and contiguous; part holds
// heads * nsplit * T * (D + 2) floats, tickets heads zeroed ints; device
// pointers.  Returns the launch's CUDA error (0 when it was accepted).

#include "decode_common.cuh"

using namespace svd;

namespace {

constexpr int DA_THREADS = 128;  // ops/attention.py mirrors DA_THREADS and DA_U
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_U = 8;  // rows a lane group loads at once, from each cache

template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// e^(m - M), 0 where m holds no score (a split or lane group whose rows
// were all masked for this query)
__device__ __forceinline__ float rescale(float m, float M) {
  return m == -CUDART_INF_F ? 0.f : expf(m - M);
}

template <typename C, int LPR, int T>
__global__ void __launch_bounds__(DA_THREADS)
decode_attn_kernel(const C* __restrict__ q, const C* __restrict__ kn,
                   const C* __restrict__ vn, C* kc, C* vc, C* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ tickets, int S, int pos,
                   int R, float div) {
  constexpr int VEC = Vec<C>::N;
  constexpr int D = LPR * VEC;
  constexpr int GPW = 32 / LPR;       // lane groups per warp
  constexpr int NG = DA_WARPS * GPW;  // lane groups per block
  constexpr int PW = D + 2;           // partial of one query: m, l, acc[D]
  __shared__ float wm[DA_WARPS][T], wl[DA_WARPS][T];
  __shared__ float wacc[DA_WARPS][T][D];
  __shared__ bool am_last;
  const int h = blockIdx.x, sp = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = warp * GPW + lane / LPR, sub = lane % LPR;
  const int P = pos + T;
  const int r0 = sp * R, r1 = min(r0 + R, P);
  const int used = (P + R - 1) / R;  // splits that hold rows < P
  if (sp >= used) return;
  pdl_wait();

  const C* qh = q + (size_t)h * T * D;
  const C* knh = kn + (size_t)h * T * D;
  const C* vnh = vn + (size_t)h * T * D;
  C* kch = kc + (size_t)h * S * D;
  C* vch = vc + (size_t)h * S * D;

  // 1. the block whose split holds row pos writes the fresh rows
  if (sp == pos / R)
    for (int i = tid; i < T * D; i += DA_THREADS) {
      kch[(size_t)pos * D + i] = knh[i];
      vch[(size_t)pos * D + i] = vnh[i];
    }

  // 2. this lane's query slices, divided by sqrt(D) in float32, rounded to C
  float qv[T][VEC];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    unpack_vec<C>(*reinterpret_cast<const uint4*>(qh + t * D + sub * VEC), qv[t]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[t][e] = rnd<C>(qv[t][e] / div);
  }

  // 3. passes of NG * DA_U rows: lane group gi takes rows
  //    base + u * NG + gi, both caches' loads in flight at once, and folds
  //    them into its running max m, sum l and value sums acc
  float m[T], l[T], acc[T][VEC];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    m[t] = -CUDART_INF_F;
    l[t] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[t][e] = 0.f;
  }
  for (int base = r0; base < r1; base += NG * DA_U) {
    uint4 kraw[DA_U], vraw[DA_U];
#pragma unroll
    for (int u = 0; u < DA_U; ++u) {
      const int j = base + u * NG + gi;
      if (j < r1) {
        const size_t o = j < pos ? (size_t)j * D : (size_t)(j - pos) * D;
        const C* krow = (j < pos ? kch : knh) + o + sub * VEC;
        const C* vrow = (j < pos ? vch : vnh) + o + sub * VEC;
        kraw[u] = *reinterpret_cast<const uint4*>(krow);
        vraw[u] = *reinterpret_cast<const uint4*>(vrow);
      } else {
        kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float s[DA_U];
      float mx = m[t];
#pragma unroll
      for (int u = 0; u < DA_U; ++u) {
        const int j = base + u * NG + gi;
        float kf[VEC];
        unpack_vec<C>(kraw[u], kf);
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) p = fmaf(qv[t][e], kf[e], p);
        p = group_sum<LPR>(p);
        s[u] = j < r1 && j <= pos + t ? p : -CUDART_INF_F;
        mx = fmaxf(mx, s[u]);
      }
      if (mx == -CUDART_INF_F) continue;  // no row of this pass for query t yet
      const float c = rescale(m[t], mx);
      m[t] = mx;
      l[t] *= c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[t][e] *= c;
#pragma unroll
      for (int u = 0; u < DA_U; ++u) {
        const float w = s[u] == -CUDART_INF_F ? 0.f : expf(s[u] - mx);
        float vf[VEC];
        unpack_vec<C>(vraw[u], vf);
        l[t] += w;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[t][e] = fmaf(w, vf[e], acc[t][e]);
      }
    }
  }

  // 4. merge the lane groups of a warp (a group's lanes share m and l, and
  //    hold different dims of acc), then the warps in order
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float M = warp_max(m[t]);
    const float c = rescale(m[t], M);
    float lt = l[t] * c;
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float a = acc[t][e] * c;
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane < LPR) wacc[warp][t][sub * VEC + e] = a;
    }
    if (lane == 0) {
      wm[warp][t] = M;
      wl[warp][t] = lt;
    }
  }
  __syncthreads();
  float* pb = part + (size_t)(h * gridDim.y + sp) * T * PW;
  for (int i = tid; i < T * D; i += DA_THREADS) {
    const int t = i / D, d = i % D;
    float M = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) M = fmaxf(M, wm[w][t]);
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float c = rescale(wm[w][t], M);
      a = fmaf(c, wacc[w][t][d], a);
      s = fmaf(c, wl[w][t], s);
    }
    pb[t * PW + 2 + d] = a;
    if (d == 0) {
      pb[t * PW] = M;
      pb[t * PW + 1] = s;
    }
  }

  // 5. the last block of this head merges the partials in split order:
  //    M = max m_s, out = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s
  __threadfence();
  __syncthreads();
  pdl_launch_dependents();
  if (tid == 0) am_last = atomicAdd(&tickets[h], 1) == used - 1;
  __syncthreads();
  if (!am_last) return;
  const float* ph = part + (size_t)h * gridDim.y * T * PW;
  for (int i = tid; i < T * D; i += DA_THREADS) {
    const int t = i / D, d = i % D;
    float M = -CUDART_INF_F;
    for (int s = 0; s < used; ++s) M = fmaxf(M, __ldcg(ph + (s * T + t) * PW));
    float num = 0.f, den = 0.f;
    for (int s = 0; s < used; ++s) {
      const float* pp = ph + (s * T + t) * PW;
      const float c = rescale(__ldcg(pp), M);
      num = fmaf(c, __ldcg(pp + 2 + d), num);
      den = fmaf(c, __ldcg(pp + 1), den);
    }
    out[(size_t)h * T * D + i] = from_f<C>(num / den);
  }
  if (tid == 0) tickets[h] = 0;  // ready for the next launch
}

template <typename C, int LPR, int T>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kc, void* vc,
                   void* out, float* part, int* tickets, int H, int S, int pos, int R,
                   int nsplit, float div, cudaStream_t st) {
  return launch_pdl(decode_attn_kernel<C, LPR, T>, dim3((unsigned)H, (unsigned)nsplit),
                    dim3(DA_THREADS), st, (const C*)q, (const C*)kn, (const C*)vn, (C*)kc,
                    (C*)vc, (C*)out, part, tickets, S, pos, R, div);
}

template <typename C, int T>
cudaError_t by_lanes(int lpr, const void* q, const void* kn, const void* vn, void* kc,
                     void* vc, void* out, float* part, int* tickets, int H, int S, int pos,
                     int R, int nsplit, float div, cudaStream_t st) {
#define SVD_LANES(L) \
  launch<C, L, T>(q, kn, vn, kc, vc, out, part, tickets, H, S, pos, R, nsplit, div, st)
  switch (lpr) {
    case 2: return SVD_LANES(2);
    case 4: return SVD_LANES(4);
    case 8: return SVD_LANES(8);
    case 16: return SVD_LANES(16);
    case 32: return SVD_LANES(32);
    default: return cudaErrorInvalidValue;
  }
#undef SVD_LANES
}

}  // namespace

// cdtype: 0 = float32, 1 = bfloat16.  T is 1 or 2; D * sizeof(C) is 16
// bytes times 2, 4, 8, 16 or 32; R a multiple of the block's lane groups
// (DA_THREADS * 16 / (D * sizeof(C))); nsplit = ceil((pos + T) / R).
extern "C" int svd_decode_attention(int cdtype, const void* q, const void* k_new,
                                    const void* v_new, void* k_cache, void* v_cache,
                                    void* out, void* part, void* tickets, int H, int T,
                                    int S, int D, int pos, int R, int nsplit, float div,
                                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int esize = cdtype == 0 ? 4 : 2;
  if ((D * esize) % 16 != 0 || pos < 0 || pos + T > S || R <= 0 ||
      (DA_THREADS * 16 / (D * esize)) <= 0 || R % (DA_THREADS * 16 / (D * esize)) != 0 ||
      nsplit != (pos + T + R - 1) / R)
    return (int)cudaErrorInvalidValue;
  const int lpr = D * esize / 16;
  float* pt = (float*)part;
  int* tk = (int*)tickets;
#define SVD_RUN(C, TT)                                                                  \
  return (int)by_lanes<C, TT>(lpr, q, k_new, v_new, k_cache, v_cache, out, pt, tk, H, S, \
                              pos, R, nsplit, div, st)
  if (cdtype == 0 && T == 1) SVD_RUN(float, 1);
  if (cdtype == 0 && T == 2) SVD_RUN(float, 2);
  if (cdtype == 1 && T == 1) SVD_RUN(bf16, 1);
  if (cdtype == 1 && T == 2) SVD_RUN(bf16, 2);
#undef SVD_RUN
  return (int)cudaErrorInvalidValue;
}
