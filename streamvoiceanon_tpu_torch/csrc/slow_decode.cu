// The dual-AR slow step at batch 1: L transformer layers on the frame's two
// tokens [audio_emb, cond_emb] against the flat KV cache, then the final
// norm, the output head and the semantic-token sampler.  The port of
// `slow_decode_step` in ops/pallas_slow_decode.py of the JAX package; see
// streamvoiceanon_tpu_torch/ops/slow_decode.py for the design note.
//
// Per layer, four split-K matvecs (decode_common.cuh) and one attention
// launch, then the output-head matvec and the sampler: 62 launches.  What
// bounds the step is bytes (the weights, then 2 * L * pos cache rows), and
// what held it back was the attention: one block per head, 12 blocks on
// 132 SMs, each walking its pos rows as dependent load chains (81 % of the
// step's device time at pos 1000).  `slow_attn_kernel` below splits the
// cache rows of each head across a fixed number of blocks, taken from the
// cache length S (16 at S = 2048 in bf16: 192 blocks), so the grid does
// not change with pos.  Each block reads its rows with 16-byte loads, all
// of them in flight at once, and writes one partial (per query: max, sum
// of exp, unnormalized value sums); the last block of a head to finish
// merges the partials in split order, so the result does not depend on
// block timing.  Every launch of the step goes out by programmatic dependent
// launch (Hopper): it starts while the previous launch drains, streams what
// no launch of the step writes (a matvec's weights, the attention's cache
// rows), then waits for the previous launch before it reads its output.
//
// Plain C interface for ctypes.  Every pointer is a device pointer; the
// caller allocates outputs and scratch, and `h` holds the two input rows in
// the weight type on entry and the two output rows on return.  Returns the
// first CUDA error of a launch (0 when all launches were accepted).

#include "decode_common.cuh"

using namespace svd;

namespace {

// ---------------------------------------------------------------------------
// split-row attention
// ---------------------------------------------------------------------------

constexpr int SA_THREADS = 128;  // ops/slow_decode.py mirrors SA_THREADS and SA_U
constexpr int SA_WARPS = SA_THREADS / 32;
constexpr int SA_U = 8;  // rows per lane group, all loaded at once

template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (n_head, nsplit).  Block (h, s) takes rows s * RPS .. s * RPS + RPS - 1
// of the pos + 2 rows (cache rows < pos, then the two fresh rows, which it
// takes from qkv and never from the cache); a row is read by LPR lanes,
// one 16-byte load each (head dim HD = LPR * 16 / sizeof(C)).  Rounding as
// the TPU kernel: q and k roped in float32 and rounded to W, q then to C;
// each score product rounded to C before the float32 head sum; the value
// mix divided by the denominator after it.  Splits with no rows return at
// once and take no ticket.  Split 0 writes the fresh roped K and V rows.
// Launched by programmatic dependent launch: the block loads its cache rows
// (which no launch of the step writes), lets the next launch start, then
// waits for the previous one before it reads qkv or writes anything.
template <typename W, typename C, int LPR>
__global__ void __launch_bounds__(SA_THREADS)
slow_attn_kernel(const W* __restrict__ qkv, int dim, const C* __restrict__ kc,
                 const C* __restrict__ vc, int pos, const float* __restrict__ freqs,
                 C* __restrict__ k_new, C* __restrict__ v_new, float* __restrict__ part,
                 int* __restrict__ tickets, W* __restrict__ out, float scale) {
  constexpr int VEC = Vec<C>::N;
  constexpr int HD = LPR * VEC;
  constexpr int GPW = 32 / LPR;       // lane groups per warp
  constexpr int NG = SA_WARPS * GPW;  // lane groups per block
  constexpr int RPS = NG * SA_U;      // rows per split
  constexpr int PW = HD + 2;          // partial of one query: max, sum, value sums
  __shared__ float qs[2][HD], kn[2][HD], vn[2][HD];
  __shared__ float wmax[SA_WARPS][2], wsum[SA_WARPS][2];
  __shared__ float wacc[SA_WARPS][2][HD];
  __shared__ bool am_last;
  const int h = blockIdx.x, sp = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = warp * GPW + lane / LPR, sub = lane % LPR;
  const int P = pos + 2;
  const int r0 = sp * RPS;
  const int used = (P + RPS - 1) / RPS;  // splits that hold rows < P
  if (sp >= used) return;

  // 1. this lane group's rows j = r0 + u * NG + gi: both caches' loads at once
  uint4 kraw[SA_U], vraw[SA_U];
#pragma unroll
  for (int u = 0; u < SA_U; ++u) {
    const int j = r0 + u * NG + gi;
    if (j < pos) {
      const size_t o = (size_t)j * dim + h * HD + sub * VEC;
      kraw[u] = __ldg(reinterpret_cast<const uint4*>(kc + o));
      vraw[u] = __ldg(reinterpret_cast<const uint4*>(vc + o));
    } else {
      kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  pdl_launch_dependents();
  pdl_wait();

  // 2. RoPE (interleaved pairs) of the fresh tokens at positions pos + t
  for (int i = tid; i < 2 * HD; i += SA_THREADS) {
    const int t = i / HD, d = i % HD;
    const W* row = qkv + (size_t)t * 3 * dim;
    const int base = h * HD + (d & ~1);
    const float* f = freqs + ((size_t)(pos + t) * (HD / 2) + (d >> 1)) * 2;
    const float c = f[0], sn = f[1];
    const float q0 = to_f<W>(row[base]), q1 = to_f<W>(row[base + 1]);
    const float k0 = to_f<W>(row[dim + base]), k1 = to_f<W>(row[dim + base + 1]);
    const float qr = (d & 1) ? q1 * c + q0 * sn : q0 * c - q1 * sn;
    const float kr = rnd<W>((d & 1) ? k1 * c + k0 * sn : k0 * c - k1 * sn);
    const float v = to_f<W>(row[2 * dim + h * HD + d]);
    qs[t][d] = rnd<C>(rnd<W>(qr));
    kn[t][d] = rnd<C>(kr);
    vn[t][d] = v;
    if (sp == 0) {
      k_new[(size_t)t * dim + h * HD + d] = from_f<C>(kr);
      v_new[(size_t)t * dim + h * HD + d] = from_f<C>(v);
    }
  }
  __syncthreads();
  float qv[2][VEC];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[t][e] = qs[t][sub * VEC + e];

  // 3. scores; row j is valid for query t when j <= pos + t
  float sc[2][SA_U];
#pragma unroll
  for (int u = 0; u < SA_U; ++u) {
    const int j = r0 + u * NG + gi;
    float kf[VEC];
    if (j < pos) {
      unpack_vec<C>(kraw[u], kf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = j < P ? kn[j - pos][sub * VEC + e] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) p += rnd<C>(qv[t][e] * kf[e]);
      p = group_sum<LPR>(p);
      sc[t][u] = j <= pos + t ? p * scale : -CUDART_INF_F;
    }
  }

  // 4. the block's max per query, the weights exp(s - max) and their sum
  float m[2], l[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float v = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < SA_U; ++u) v = fmaxf(v, sc[t][u]);
    v = warp_max(v);
    if (lane == 0) wmax[warp][t] = v;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    m[t] = wmax[0][t];
#pragma unroll
    for (int w = 1; w < SA_WARPS; ++w) m[t] = fmaxf(m[t], wmax[w][t]);
    l[t] = 0.f;
#pragma unroll
    for (int u = 0; u < SA_U; ++u) {
      sc[t][u] = sc[t][u] == -CUDART_INF_F ? 0.f : expf(sc[t][u] - m[t]);
      l[t] += sc[t][u];
    }
  }

  // 5. unnormalized value sums over the block's rows
  float acc[2][VEC];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int u = 0; u < SA_U; ++u) {
    const int j = r0 + u * NG + gi;
    float vf[VEC];
    if (j < pos) {
      unpack_vec<C>(vraw[u], vf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vf[e] = j < P ? vn[j - pos][sub * VEC + e] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[t][e] = fmaf(sc[t][u], vf[e], acc[t][e]);
  }
  // sum the lane groups of a warp (each group's lanes share its weights, so
  // one lane a group counts the sum), then the warps in order
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) acc[t][e] += __shfl_xor_sync(0xffffffffu, acc[t][e], o);
    l[t] = warp_sum(sub == 0 ? l[t] : 0.f);
  }
  if (lane < LPR)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < VEC; ++e) wacc[warp][t][sub * VEC + e] = acc[t][e];
  if (lane == 0)
#pragma unroll
    for (int t = 0; t < 2; ++t) wsum[warp][t] = l[t];
  __syncthreads();
  float* pb = part + (size_t)(h * gridDim.y + sp) * 2 * PW;
  for (int i = tid; i < 2 * HD; i += SA_THREADS) {
    const int t = i / HD, d = i % HD;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < SA_WARPS; ++w) a += wacc[w][t][d];
    pb[t * PW + 2 + d] = a;
  }
  if (tid == 0)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < SA_WARPS; ++w) s += wsum[w][t];
      pb[t * PW] = m[t];
      pb[t * PW + 1] = s;
    }

  // 6. the last block of this head merges the partials in split order:
  //    M = max m_s, out = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s
  __threadfence();
  __syncthreads();
  if (tid == 0) am_last = atomicAdd(&tickets[h], 1) == used - 1;
  __syncthreads();
  if (!am_last) return;
  const float* ph = part + (size_t)h * gridDim.y * 2 * PW;
  for (int i = tid; i < 2 * HD; i += SA_THREADS) {
    const int t = i / HD, d = i % HD;
    float M = -CUDART_INF_F;
    for (int s = 0; s < used; ++s) M = fmaxf(M, __ldcg(ph + (s * 2 + t) * PW));
    float num = 0.f, den = 0.f;
    for (int s = 0; s < used; ++s) {
      const float* q = ph + (s * 2 + t) * PW;
      const float w = expf(__ldcg(q) - M);  // 0 for a split with no valid row
      num += w * __ldcg(q + 2 + d);
      den += w * __ldcg(q + 1);
    }
    out[(size_t)t * dim + h * HD + d] = from_f<W>(num / den);
  }
  if (tid == 0) tickets[h] = 0;  // ready for the next launch
}

template <typename W, typename C, int LPR>
cudaError_t launch_split(const W* qkv, int n_head, const C* kc, const C* vc, int pos,
                         const float* freqs, C* k_new, C* v_new, float* part, int* tickets,
                         W* out, int S, cudaStream_t st) {
  constexpr int HD = LPR * Vec<C>::N;
  constexpr int RPS = SA_THREADS / LPR * SA_U;
  const dim3 grid((unsigned)n_head, (unsigned)((S + RPS - 1) / RPS));
  return launch_pdl(slow_attn_kernel<W, C, LPR>, grid, dim3(SA_THREADS), st, qkv,
                    n_head * HD, kc, vc, pos, freqs, k_new, v_new, part, tickets, out,
                    1.0f / sqrtf((float)HD));
}

// The step's attention launch for one layer.  part holds n_head * nsplit *
// 2 * (hd + 2) floats, tickets n_head zeroed ints (left zeroed).
template <typename W, typename C>
cudaError_t launch_slow_attn(const W* qkv, int n_head, int hd, const C* kc, const C* vc,
                             int pos, const float* freqs, C* k_new, C* v_new, float* part,
                             int* tickets, W* out, int S, cudaStream_t st) {
  const int bytes = hd * (int)sizeof(C);
#define SVD_SPLIT(LPR)                                                                  \
  launch_split<W, C, LPR>(qkv, n_head, kc, vc, pos, freqs, k_new, v_new, part, tickets, \
                          out, S, st)
  switch (bytes % 16 == 0 ? bytes / 16 : 0) {
    case 1: return SVD_SPLIT(1);
    case 2: return SVD_SPLIT(2);
    case 4: return SVD_SPLIT(4);
    case 8: return SVD_SPLIT(8);
    case 16: return SVD_SPLIT(16);
    case 32: return SVD_SPLIT(32);
    default: return cudaErrorInvalidValue;
  }
#undef SVD_SPLIT
}

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

template <typename W, typename C>
cudaError_t slow_step(W* h, const W* wqkv, const W* wo, const W* w1, const W* w3,
                      const W* w2, const W* anorm, const W* fnorm, const C* kc,
                      const C* vc, const float* freqs, int pos, const W* onorm,
                      const W* wout, const float* gumbel, C* k_rows, C* v_rows,
                      int* token, W* qkv, W* attn, W* gate, float* logits,
                      float* partials, int* counters, float* attn_part, int* tickets,
                      int L, int dim, int n_head, int head_dim, int inter, int S, int V,
                      float eps, float temperature, float top_p, int greedy,
                      cudaStream_t st) {
  cudaError_t e;
#define SVD_TRY(call) \
  if ((e = (call)) != cudaSuccess) return e
  // every launch by programmatic dependent launch: each may start while the
  // previous one finishes, loads what no launch of the step writes (weights,
  // cache rows), then waits for the previous launch
  constexpr bool P = true;
  for (int l = 0; l < L; ++l) {
    const size_t ld = (size_t)l * dim;
    SVD_TRY((launch_matvec<W, 2, EPI_STORE, P>(h, anorm + ld, eps, wqkv + ld * 3 * dim,
                                               nullptr, dim, 3 * dim, partials, counters,
                                               qkv, st)));
    SVD_TRY((launch_slow_attn<W, C>(qkv, n_head, head_dim, kc + (size_t)l * S * dim,
                                       vc + (size_t)l * S * dim, pos, freqs,
                                       k_rows + ld * 2, v_rows + ld * 2, attn_part, tickets,
                                       attn, S, st)));
    SVD_TRY((launch_matvec<W, 2, EPI_RESID, P>(attn, nullptr, eps, wo + ld * dim, nullptr,
                                               dim, dim, partials, counters, h, st)));
    SVD_TRY((launch_matvec<W, 2, EPI_SWIGLU, P>(h, fnorm + ld, eps, w1 + ld * inter,
                                                w3 + ld * inter, dim, inter, partials,
                                                counters, gate, st)));
    SVD_TRY((launch_matvec<W, 2, EPI_RESID, P>(gate, nullptr, eps,
                                               w2 + (size_t)l * inter * dim, nullptr,
                                               inter, dim, partials, counters, h, st)));
  }
  // the semantic token reads the second (cond) row only
  SVD_TRY((launch_matvec<W, 1, EPI_STORE_F32, P>(h + dim, onorm, eps, wout, nullptr, dim,
                                                 V, partials, counters, logits, st)));
  SVD_TRY(launch_pdl(sample_kernel<true>, dim3(1), dim3(SM_THREADS), st,
                     (const float*)logits, V, gumbel, greedy, temperature, top_p, token));
#undef SVD_TRY
  return cudaGetLastError();
}

template <typename W, typename C>
int run(void* h, const void* wqkv, const void* wo, const void* w1, const void* w3,
        const void* w2, const void* anorm, const void* fnorm, const void* kc,
        const void* vc, const void* freqs, int pos, const void* onorm,
        const void* wout, const void* gumbel, void* k_rows, void* v_rows, void* token,
        void* qkv, void* attn, void* gate, void* logits, void* partials,
        void* counters, void* attn_part, void* tickets, int L, int dim, int n_head,
        int head_dim, int inter, int S, int V, float eps, float temperature, float top_p,
        int greedy, void* stream) {
  return (int)slow_step<W, C>(
      (W*)h, (const W*)wqkv, (const W*)wo, (const W*)w1, (const W*)w3, (const W*)w2,
      (const W*)anorm, (const W*)fnorm, (const C*)kc, (const C*)vc,
      (const float*)freqs, pos, (const W*)onorm, (const W*)wout, (const float*)gumbel,
      (C*)k_rows, (C*)v_rows, (int*)token, (W*)qkv, (W*)attn, (W*)gate,
      (float*)logits, (float*)partials, (int*)counters, (float*)attn_part, (int*)tickets,
      L, dim, n_head, head_dim, inter, S, V, eps, temperature, top_p, greedy,
      (cudaStream_t)stream);
}

template <typename W, typename C>
int attn_only(const void* qkv, const void* kc, const void* vc, const void* freqs, int pos,
              void* k_rows, void* v_rows, void* attn, void* attn_part, void* tickets,
              int n_head, int head_dim, int S, int reps, cudaStream_t st) {
  for (int r = 0; r < reps; ++r) {
    const cudaError_t e = launch_slow_attn<W, C>(
        (const W*)qkv, n_head, head_dim, (const C*)kc, (const C*)vc, pos,
        (const float*)freqs, (C*)k_rows, (C*)v_rows, (float*)attn_part, (int*)tickets,
        (W*)attn, S, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// One layer's attention alone, launched `reps` times in a row as the step
// launches it: for timing it without the host between launches and for
// checking it at many positions.  The step never calls this.
extern "C" int svd_slow_attention(int wdtype, int cdtype, const void* qkv, const void* kc,
                                  const void* vc, const void* freqs, int pos, void* k_rows,
                                  void* v_rows, void* attn, void* attn_part, void* tickets,
                                  int n_head, int head_dim, int S, int reps, void* stream) {
#define SVD_RUN(W, C)                                                                   \
  return attn_only<W, C>(qkv, kc, vc, freqs, pos, k_rows, v_rows, attn, attn_part,     \
                         tickets, n_head, head_dim, S, reps, (cudaStream_t)stream)
  if (wdtype == 0 && cdtype == 0) SVD_RUN(float, float);
  if (wdtype == 0 && cdtype == 1) SVD_RUN(float, bf16);
  if (wdtype == 1 && cdtype == 0) SVD_RUN(bf16, float);
  if (wdtype == 1 && cdtype == 1) SVD_RUN(bf16, bf16);
#undef SVD_RUN
  return (int)cudaErrorInvalidValue;
}

// wdtype / cdtype: 0 = float32, 1 = bfloat16
extern "C" int svd_slow_decode_step(
    int wdtype, int cdtype, void* h, const void* wqkv, const void* wo, const void* w1,
    const void* w3, const void* w2, const void* anorm, const void* fnorm,
    const void* kc, const void* vc, const void* freqs, int pos, const void* onorm,
    const void* wout, const void* gumbel, void* k_rows, void* v_rows, void* token,
    void* qkv, void* attn, void* gate, void* logits, void* partials, void* counters,
    void* attn_part, void* tickets, int L, int dim, int n_head, int head_dim, int inter,
    int S, int V, float eps, float temperature, float top_p, int greedy, void* stream) {
#define SVD_RUN(W, C)                                                               \
  return run<W, C>(h, wqkv, wo, w1, w3, w2, anorm, fnorm, kc, vc, freqs, pos, onorm, \
                   wout, gumbel, k_rows, v_rows, token, qkv, attn, gate, logits,     \
                   partials, counters, attn_part, tickets, L, dim, n_head, head_dim, \
                   inter, S, V, eps, temperature, top_p, greedy, stream)
  if (wdtype == 0 && cdtype == 0) SVD_RUN(float, float);
  if (wdtype == 0 && cdtype == 1) SVD_RUN(float, bf16);
  if (wdtype == 1 && cdtype == 0) SVD_RUN(bf16, float);
  if (wdtype == 1 && cdtype == 1) SVD_RUN(bf16, bf16);
#undef SVD_RUN
  return (int)cudaErrorInvalidValue;
}
