// The tokenizer's ConvNeXt front at batch 1, float32: stem conv (k over
// [tail; mel]) -> LayerNorm -> per stage [LN -> 1x1 transition (stages > 0)
// -> ConvNeXt blocks] -> final LN -> per downsample [stride-f conv (kernel
// f) -> one block].  A block is causal depthwise conv k -> LN -> pointwise
// C->4C -> exact GELU -> pointwise 4C->C -> LayerScale -> residual.  The port
// of `encoder_front_step` in ops/pallas_convnext_enc.py of the JAX package;
// see streamvoiceanon_tpu_torch/ops/convnext_enc.py for the design note.
//
// Launches, in order on one stream:
//   stem_kernel     the stem's im2col rows of [tail; mel] and its new tail
//   row_kernel      one block per row: LayerNorm, or the depthwise conv of
//                   [tail; x] + bias then LayerNorm (block 0 also writes the
//                   block's new tail slot); in place for a plain LayerNorm
//   matvec_kernel   (decode_common.cuh) the stem, transition, pointwise and
//                   downsample products with their bias epilogues.  The
//                   downsample y[t] = sum_j x[f*t + j] @ W_j is one product of
//                   the rows viewed as (T/f, f*C) against the tap-major (f*C,
//                   C_q) weight: no gather.
// Every tail is read from the input state and written to the separate
// output state, so no launch overwrites a tail it still reads.
//
// Plain C interface for ctypes.  `geo` is a HOST int array (layout written
// by ops/convnext_enc.py `_geometry`); `w`, `st_in` and `st_out` are HOST
// arrays of DEVICE pointers:
//   w      : stem_w, stem_b, stem_ln_w, stem_ln_b,
//            per stage (dw_w, dw_b, ln_w, ln_b, pw1, pw1_b, pw2, pw2_b, gamma),
//            per transition (ln_w, ln_b, w, b), final_ln_w, final_ln_b,
//            per downsample (w, b, dw_w, dw_b, ln_w, ln_b, pw1, pw1_b, pw2,
//            pw2_b, gamma)
//   st_in  : stem (8, C_in), per stage (depth*8, C_i), down (n_down*8, C_q)
//   st_out : the same layout, written in full
// `mel` (T0, C_in) and `z` (T0 / prod(f), C_q) are device pointers;
// `scratch` holds two activation buffers of x_elems floats, one hidden
// buffer of g_elems floats and the stem's im2col rows (T0 * k * C_in);
// `partials` and `counters` are the matvec's split-K scratch (counters
// zeroed).  Returns the first CUDA error of a launch (0 when all were
// accepted).

#include "decode_common.cuh"

using namespace svd;

namespace {

constexpr int RT = 256;        // threads of the row kernels
constexpr int SLOT = 8;        // rows of one packed tail slot
constexpr int HDR = 8;         // header ints of `geo`
constexpr float LN_EPS = 1e-6f;

// row r of [tail (rows); x], column c
__device__ __forceinline__ float full_at(const float* tail, const float* x, int rows, int C,
                                         int r, int c) {
  return r < rows ? tail[(size_t)r * C + c] : x[(size_t)(r - rows) * C + c];
}

// col[t, j*C + c] = full[t + j][c] for the stem; the new stem slot (rows T ..
// T+rows of full, then the slot's kept rows) after it
__global__ void __launch_bounds__(RT)
stem_kernel(const float* __restrict__ tail, const float* __restrict__ mel,
            float* __restrict__ col, float* __restrict__ new_tail, int T, int C, int k) {
  const int rows = k - 1, kc = k * C, n_col = T * kc;
  for (int i = blockIdx.x * RT + threadIdx.x; i < n_col + SLOT * C; i += gridDim.x * RT) {
    if (i < n_col) {
      const int t = i / kc, rem = i - t * kc, j = rem / C, c = rem - j * C;
      col[i] = full_at(tail, mel, rows, C, t + j, c);
    } else {
      const int e = i - n_col, r = e / C, c = e - r * C;
      new_tail[e] = r < rows ? full_at(tail, mel, rows, C, T + r, c) : tail[e];
    }
  }
}

// Block t: h = x[t] (dw_w null) or h = sum_j full[t + j] * dw_w[j] + dw_b
// with full = [tail (k-1 rows); x]; then y[t] = LN(h) * ln_w + ln_b.  With
// dw_w null, y may be x (each thread reads only what it writes, before the
// reductions).  Block 0 of a depthwise launch writes the new tail slot.
__global__ void __launch_bounds__(RT)
row_kernel(const float* x, int C, const float* __restrict__ tail,
           float* __restrict__ new_tail, int k, const float* __restrict__ dw_w,
           const float* __restrict__ dw_b, const float* __restrict__ ln_w,
           const float* __restrict__ ln_b, float* y, int T) {
  extern __shared__ float hs[];  // (C) the row before the norm
  __shared__ float red[32];
  const int t = blockIdx.x, tid = threadIdx.x, rows = k - 1;
  float s = 0.f;
  for (int c = tid; c < C; c += RT) {
    float v;
    if (dw_w != nullptr) {
      float acc = 0.f;
      for (int j = 0; j < k; ++j) acc += full_at(tail, x, rows, C, t + j, c) * dw_w[j * C + c];
      v = acc + dw_b[c];
    } else {
      v = x[(size_t)t * C + c];
    }
    hs[c] = v;
    s += v;
  }
  const float mu = block_reduce<false>(s, red, tid, RT) / (float)C;
  float q = 0.f;
  for (int c = tid; c < C; c += RT) {
    const float d = hs[c] - mu;
    q += d * d;
  }
  const float inv = rsqrtf(block_reduce<false>(q, red, tid, RT) / (float)C + LN_EPS);
  for (int c = tid; c < C; c += RT) y[(size_t)t * C + c] = (hs[c] - mu) * inv * ln_w[c] + ln_b[c];
  if (dw_w != nullptr && t == 0)
    for (int i = tid; i < SLOT * C; i += RT) {
      const int r = i / C, c = i - r * C;
      new_tail[i] = r < rows ? full_at(tail, x, rows, C, T + r, c) : tail[i];
    }
}

struct Ctx {
  float* partials;
  int* counters;
  cudaStream_t st;
};

// y = x @ w with epilogue EPI over T rows, in launches of up to 4 rows
template <int EPI>
cudaError_t mv(const Ctx& cx, const float* x, const float* w, int K, int N, float* out,
               const float* bias, const float* scale, int T) {
  for (int r0 = 0; r0 < T; r0 += 4) {
    const int n = T - r0 < 4 ? T - r0 : 4;
    const float* xr = x + (size_t)r0 * K;
    float* o = out + (size_t)r0 * N;
    cudaError_t e;
#define SVD_MV(R)                                                                         \
  e = launch_matvec<float, R, EPI>(xr, nullptr, 0.f, w, nullptr, K, N, cx.partials,       \
                                   cx.counters, o, cx.st, scale, bias)
    if (n == 1) SVD_MV(1);
    else if (n == 2) SVD_MV(2);
    else if (n == 3) SVD_MV(3);
    else SVD_MV(4);
#undef SVD_MV
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

cudaError_t launch_row(const Ctx& cx, const float* x, int C, const float* tail,
                       float* new_tail, int k, const float* dw_w, const float* dw_b,
                       const float* ln_w, const float* ln_b, float* y, int T) {
  const size_t smem = sizeof(float) * (size_t)C;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  row_kernel<<<T, RT, smem, cx.st>>>(x, C, tail, new_tail, k, dw_w, dw_b, ln_w, ln_b, y, T);
  return cudaGetLastError();
}

// One ConvNeXt block on the residual stream `cur` (T, C), `tmp` (T, C) and
// `g` (T, 4C) as scratch; w points at the block's 9 weight arrays (stacked
// over the stage's blocks: row bi).
cudaError_t block(const Ctx& cx, float* cur, float* tmp, float* g, int T, int C, int k,
                  const void* const* w, int bi, const float* tail, float* new_tail) {
  auto W = [&](int i) { return (const float*)w[i]; };
  const int hid = 4 * C;
  cudaError_t e;
  if ((e = launch_row(cx, cur, C, tail, new_tail, k, W(0) + (size_t)bi * k * C,
                      W(1) + (size_t)bi * C, W(2) + (size_t)bi * C, W(3) + (size_t)bi * C,
                      tmp, T)) != cudaSuccess)
    return e;
  if ((e = mv<EPI_BIAS_GELU>(cx, tmp, W(4) + (size_t)bi * C * hid, C, hid, g,
                             W(5) + (size_t)bi * hid, nullptr, T)) != cudaSuccess)
    return e;
  return mv<EPI_BIAS_SCALED_RESID>(cx, g, W(6) + (size_t)bi * hid * C, hid, C, cur,
                                   W(7) + (size_t)bi * C, W(8) + (size_t)bi * C, T);
}

}  // namespace

extern "C" int svd_convnext_enc_step(const int* geo, const void* const* w,
                                     const void* const* st_in, void* const* st_out,
                                     const void* mel, void* z, int n_geo, void* scratch,
                                     void* partials, void* counters, void* stream) {
  if (n_geo < HDR) return (int)cudaErrorInvalidValue;
  const int T0 = geo[0], Cin = geo[1], k = geo[2], n_stage = geo[3], n_down = geo[4];
  const int Cq = geo[5], x_elems = geo[6], g_elems = geo[7];
  if (n_geo != HDR + 2 * n_stage + n_down || k > SLOT + 1) return (int)cudaErrorInvalidValue;
  const int* stg = geo + HDR;
  const int* fac = stg + 2 * n_stage;
  const Ctx cx{(float*)partials, (int*)counters, (cudaStream_t)stream};
  float* cur = (float*)scratch;
  float* tmp = cur + x_elems;
  float* g = tmp + x_elems;
  float* col = g + g_elems;
  auto W = [&](int i) { return (const float*)w[i]; };
  cudaError_t e;
#define SVD_TRY(call) \
  if ((e = (call)) != cudaSuccess) return (int)e

  // stem: im2col of [tail; mel] -> conv + bias -> LN (in place)
  const int C0 = stg[1];
  {
    const int total = T0 * k * Cin + SLOT * Cin;
    stem_kernel<<<(total + RT - 1) / RT, RT, 0, cx.st>>>(
        (const float*)st_in[0], (const float*)mel, col, (float*)st_out[0], T0, Cin, k);
    SVD_TRY(cudaGetLastError());
  }
  SVD_TRY(mv<EPI_BIAS>(cx, col, W(0), k * Cin, C0, cur, W(1), nullptr, T0));
  SVD_TRY(launch_row(cx, cur, C0, nullptr, nullptr, 1, nullptr, nullptr, W(2), W(3), cur, T0));

  // stages, with LN + 1x1 transitions between them
  const int w_stage = 4, w_mid = w_stage + 9 * n_stage;
  const int w_final = w_mid + 4 * (n_stage - 1), w_down = w_final + 2;
  int T = T0, C = C0;
  for (int i = 0; i < n_stage; ++i) {
    const int depth = stg[2 * i], Ci = stg[2 * i + 1];
    if (i > 0) {
      const int m = w_mid + 4 * (i - 1);
      SVD_TRY(launch_row(cx, cur, C, nullptr, nullptr, 1, nullptr, nullptr, W(m), W(m + 1),
                         tmp, T));
      SVD_TRY(mv<EPI_BIAS>(cx, tmp, W(m + 2), C, Ci, cur, W(m + 3), nullptr, T));
      C = Ci;
    }
    const float* tin = (const float*)st_in[1 + i];
    float* tout = (float*)st_out[1 + i];
    for (int bi = 0; bi < depth; ++bi)
      SVD_TRY(block(cx, cur, tmp, g, T, C, k, w + w_stage + 9 * i, bi,
                    tin + (size_t)bi * SLOT * C, tout + (size_t)bi * SLOT * C));
  }
  SVD_TRY(launch_row(cx, cur, C, nullptr, nullptr, 1, nullptr, nullptr, W(w_final),
                     W(w_final + 1), cur, T));

  // downsample convs (stride f == kernel f, no tail), each with one block
  const float* dtin = (const float*)st_in[1 + n_stage];
  float* dtout = (float*)st_out[1 + n_stage];
  for (int i = 0; i < n_down; ++i) {
    const int f = fac[i], d = w_down + 11 * i;
    SVD_TRY(mv<EPI_BIAS>(cx, cur, W(d), f * C, Cq, tmp, W(d + 1), nullptr, T / f));
    float* sw = cur;
    cur = tmp;
    tmp = sw;
    T /= f;
    C = Cq;
    SVD_TRY(block(cx, cur, tmp, g, T, C, k, w + d + 2, 0, dtin + (size_t)i * SLOT * Cq,
                  dtout + (size_t)i * SLOT * Cq));
  }
  SVD_TRY(cudaMemcpyAsync(z, cur, sizeof(float) * (size_t)T * Cq, cudaMemcpyDeviceToDevice,
                          cx.st));
#undef SVD_TRY
  return 0;
}
