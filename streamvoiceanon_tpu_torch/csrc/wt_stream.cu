// The windowed-transformer ring step at batch 1: one new token through the
// L layers (RMSNorm -> QKV -> RoPE -> attention over the circular ring ->
// wo with LayerScale -> RMSNorm -> SwiGLU -> w2 with LayerScale) against a
// flat (L, W, dim) KV ring whose keys carry absolute RoPE.  The port of
// `wt_stream_step` in ops/pallas_wt_stream.py of the JAX package; see
// streamvoiceanon_tpu_torch/ops/wt_stream.py for the design note.
//
// Plain C interface for ctypes.  Every pointer is a device pointer; the
// caller allocates outputs and scratch.  `h` holds the input row in the
// weight type on entry and the output row (final norm not applied) on
// return; the fresh K/V rows are written into the rings in place at slot
// count % W.  `ctab`/`stab` are the signed (n_rows, dim) cos/sin RoPE
// tables; the step uses row p.  Returns the first CUDA error of a launch
// (0 when all launches were accepted).

#include "decode_common.cuh"

using namespace svd;

namespace {

constexpr int RA_THREADS = 512;
constexpr int RA_WARPS = RA_THREADS / 32;
constexpr int RA_ROWS = 4;  // slots a warp has in flight at once

// One block per head, RA_ROWS slots in flight per warp.  Arithmetic as the TPU kernel: q and k roped in
// float32 from the signed row (x * cos + partner(x) * sin) and rounded to W;
// the query then rounded to the ring type C; score products rounded to C and
// summed in float32; the written old slots (< min(count, W), not the current
// one) and the fresh row under one max and one denominator; the value mix
// divided by the denominator after.  The fresh row is written at `slot`,
// which no block reads, so the in-place write needs no second pass.
template <typename W, typename C>
__global__ void __launch_bounds__(RA_THREADS)
ring_attn_kernel(const W* __restrict__ qkv, int dim, int hd, C* kr, C* vr, int Wn,
                 int count, const float* __restrict__ cosr, const float* __restrict__ sinr,
                 W* __restrict__ out, float scale) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  __shared__ float s_new, denom;
  const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = count % Wn, nv = min(count, Wn);
  float* qs = sm;           // (hd) query as the score path sees it
  float* kn = qs + hd;      // (hd) fresh key as the score path sees it
  float* vn = kn + hd;      // (hd) fresh value
  float* sc = vn + hd;      // (Wn) scores, then weights
  float* wred = sc + Wn;    // (RA_WARPS, hd) per-warp value sums

  // 1. RoPE of the fresh query and key; write the fresh K/V row
  for (int d = tid; d < hd; d += RA_THREADS) {
    const int c = h * hd + d, pc = c ^ 1;  // rotate partner lane
    const float cs = cosr[c], sn = sinr[c];
    const float q = to_f<W>(qkv[c]), qp = to_f<W>(qkv[pc]);
    const float k = to_f<W>(qkv[dim + c]), kp = to_f<W>(qkv[dim + pc]);
    const float qr = rnd<W>(q * cs + qp * sn);
    const float krot = rnd<W>(k * cs + kp * sn);
    const float v = to_f<W>(qkv[2 * dim + c]);
    qs[d] = rnd<C>(qr);
    kn[d] = rnd<C>(krot);
    vn[d] = v;
    kr[(size_t)slot * dim + c] = from_f<C>(krot);
    vr[(size_t)slot * dim + c] = from_f<C>(v);
  }
  __syncthreads();

  // 2. scores: each warp takes RA_ROWS slots at a time, lanes across the
  //    head dims (the current slot's score is never used)
  for (int j0 = warp * RA_ROWS; j0 < nv; j0 += RA_WARPS * RA_ROWS) {
    float p[RA_ROWS];
#pragma unroll
    for (int r = 0; r < RA_ROWS; ++r) {
      const int j = j0 + r;
      p[r] = 0.f;
      if (j < nv && j != slot) {
        const C* krow = kr + (size_t)j * dim + h * hd;
        for (int d = lane; d < hd; d += 32) p[r] += rnd<C>(qs[d] * to_f<C>(krow[d]));
      }
    }
#pragma unroll
    for (int r = 0; r < RA_ROWS; ++r) {
      const float sum = warp_sum(p[r]);
      if (lane == 0 && j0 + r < nv) sc[j0 + r] = sum * scale;
    }
  }
  if (warp == 0) {
    float p = 0.f;
    for (int d = lane; d < hd; d += 32) p += rnd<C>(qs[d] * kn[d]);
    p = warp_sum(p);
    if (lane == 0) s_new = p * scale;
  }
  __syncthreads();

  // 3. one max and one denominator over the old slots and the fresh row
  float m = -CUDART_INF_F;
  for (int j = tid; j < nv; j += RA_THREADS)
    if (j != slot) m = fmaxf(m, sc[j]);
  m = fmaxf(block_reduce<true>(m, red, tid, RA_THREADS), s_new);
  float s = 0.f;
  for (int j = tid; j < nv; j += RA_THREADS) {
    const float e = j != slot ? expf(sc[j] - m) : 0.f;
    sc[j] = e;
    s += e;
  }
  s = block_reduce<false>(s, red, tid, RA_THREADS);
  const float en = expf(s_new - m);
  if (tid == 0) denom = s + en;
  __syncthreads();

  // 4. value mix: warps over old slots (the current slot's weight is 0)
  float acc[AT_MAXD];
#pragma unroll
  for (int i = 0; i < AT_MAXD; ++i) acc[i] = 0.f;
  for (int j0 = warp * RA_ROWS; j0 < nv; j0 += RA_WARPS * RA_ROWS) {
#pragma unroll
    for (int r = 0; r < RA_ROWS; ++r) {
      const int j = j0 + r;
      if (j >= nv || j == slot) continue;
      const C* vrow = vr + (size_t)j * dim + h * hd;
      const float wj = sc[j];
#pragma unroll
      for (int i = 0; i < AT_MAXD; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) acc[i] = fmaf(wj, to_f<C>(vrow[d]), acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < AT_MAXD; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) wred[warp * hd + d] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < hd; d += RA_THREADS) {
    float a = 0.f;
    for (int w = 0; w < RA_WARPS; ++w) a += wred[w * hd + d];
    a += en * vn[d];
    out[h * hd + d] = from_f<W>(a / denom);
  }
}

template <typename W, typename C>
cudaError_t launch_ring_attn(const W* qkv, int n_head, int hd, C* kr, C* vr, int Wn,
                             int count, const float* cosr, const float* sinr, W* out,
                             cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)(3 + RA_WARPS) * hd + Wn);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_attn_kernel<W, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ring_attn_kernel<W, C><<<n_head, RA_THREADS, smem, st>>>(
      qkv, n_head * hd, hd, kr, vr, Wn, count, cosr, sinr, out, 1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename W, typename C>
cudaError_t wt_step(W* h, const W* wqkv, const W* wo, const W* w1, const W* w3,
                    const W* w2, const W* anorm, const W* fnorm, const W* ascale,
                    const W* fscale, C* k_ring, C* v_ring, const float* ctab,
                    const float* stab, int p, int count, W* qkv, W* attn, W* gate,
                    float* partials, int* counters, int L, int dim, int n_head,
                    int head_dim, int inter, int Wn, float eps, cudaStream_t st) {
  cudaError_t e;
#define SVD_TRY(call) \
  if ((e = (call)) != cudaSuccess) return e
  const float* cosr = ctab + (size_t)p * dim;
  const float* sinr = stab + (size_t)p * dim;
  for (int l = 0; l < L; ++l) {
    const size_t ld = (size_t)l * dim;
    SVD_TRY((launch_matvec<W, 1, EPI_STORE>(h, anorm + ld, eps, wqkv + ld * 3 * dim,
                                            nullptr, dim, 3 * dim, partials, counters,
                                            qkv, st)));
    SVD_TRY((launch_ring_attn<W, C>(qkv, n_head, head_dim, k_ring + ld * Wn,
                                    v_ring + ld * Wn, Wn, count, cosr, sinr, attn, st)));
    SVD_TRY((launch_matvec<W, 1, EPI_SCALED_RESID>(attn, nullptr, eps, wo + ld * dim,
                                                   nullptr, dim, dim, partials, counters,
                                                   h, st, ascale + ld)));
    SVD_TRY((launch_matvec<W, 1, EPI_SWIGLU>(h, fnorm + ld, eps, w1 + ld * inter,
                                             w3 + ld * inter, dim, inter, partials,
                                             counters, gate, st)));
    SVD_TRY((launch_matvec<W, 1, EPI_SCALED_RESID>(gate, nullptr, eps,
                                                   w2 + (size_t)l * inter * dim, nullptr,
                                                   inter, dim, partials, counters, h, st,
                                                   fscale + ld)));
  }
#undef SVD_TRY
  return cudaSuccess;
}

template <typename W, typename C>
int run(void* h, const void* wqkv, const void* wo, const void* w1, const void* w3,
        const void* w2, const void* anorm, const void* fnorm, const void* ascale,
        const void* fscale, void* k_ring, void* v_ring, const void* ctab, const void* stab,
        int p, int count, void* qkv, void* attn, void* gate, void* partials,
        void* counters, int L, int dim, int n_head, int head_dim, int inter, int Wn,
        float eps, void* stream) {
  return (int)wt_step<W, C>(
      (W*)h, (const W*)wqkv, (const W*)wo, (const W*)w1, (const W*)w3, (const W*)w2,
      (const W*)anorm, (const W*)fnorm, (const W*)ascale, (const W*)fscale, (C*)k_ring,
      (C*)v_ring, (const float*)ctab, (const float*)stab, p, count, (W*)qkv, (W*)attn,
      (W*)gate, (float*)partials, (int*)counters, L, dim, n_head, head_dim, inter, Wn,
      eps, (cudaStream_t)stream);
}

}  // namespace

// wdtype / rdtype: 0 = float32, 1 = bfloat16
extern "C" int svd_wt_stream_step(
    int wdtype, int rdtype, void* h, const void* wqkv, const void* wo, const void* w1,
    const void* w3, const void* w2, const void* anorm, const void* fnorm,
    const void* ascale, const void* fscale, void* k_ring, void* v_ring,
    const void* ctab, const void* stab, int p, int count, void* qkv, void* attn,
    void* gate, void* partials, void* counters, int L, int dim, int n_head,
    int head_dim, int inter, int Wn, float eps, void* stream) {
  if (head_dim > 32 * AT_MAXD || (head_dim & 1)) return (int)cudaErrorInvalidValue;
#define SVD_RUN(W, C)                                                                   \
  return run<W, C>(h, wqkv, wo, w1, w3, w2, anorm, fnorm, ascale, fscale, k_ring, v_ring, \
                   ctab, stab, p, count, qkv, attn, gate, partials, counters, L, dim,       \
                   n_head, head_dim, inter, Wn, eps, stream)
  if (wdtype == 0 && rdtype == 0) SVD_RUN(float, float);
  if (wdtype == 0 && rdtype == 1) SVD_RUN(float, bf16);
  if (wdtype == 1 && rdtype == 0) SVD_RUN(bf16, float);
  if (wdtype == 1 && rdtype == 1) SVD_RUN(bf16, bf16);
#undef SVD_RUN
  return (int)cudaErrorInvalidValue;
}
