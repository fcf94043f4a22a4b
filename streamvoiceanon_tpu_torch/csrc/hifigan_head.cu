// The streaming HiFiGAN head at batch 1, float32: conv_pre -> per stage
// [SiLU -> transposed upsample (k = 2 * stride) -> mean of the ResBlock
// branches, each dilations x (SiLU -> causal dilated conv -> SiLU -> causal
// dilated conv) with residual] -> SiLU -> conv_post -> tanh.  The port of
// `head_stream_step` in ops/pallas_hifigan.py of the JAX package; see
// streamvoiceanon_tpu_torch/ops/hifigan.py for the design note.
//
// One kernel, `conv_kernel`, does every launch: an implicit-GEMM causal
// dilated conv on the CUDA cores in full float32 (no TF32).  Output row t
// reads rows t + j*d (j < k) of [old tail; x], so the im2col matrix is never
// built; SiLU of x is applied as it is loaded; bias, residual add, the
// running branch sum (and the mean, at the last branch) and tanh are fused
// into the epilogue.  The transposed upsample is the same kernel with k = 2,
// d = 1 and a one-row tail: out[t*s + p] = in[t] . W[s+p] + in[t+1] . W[p]
// is a (T, s*C_out) product against [wa; wb] whose row-major result IS the
// de-interleaved (T*s, C_out) output, so no shuffle is needed.  Every launch
// also writes its conv's new input tail (the last `rows` rows of [old tail;
// x], which may span both) into the separate output state, so no launch
// overwrites a tail it still reads.  The next K-chunk's loads are in flight
// while the current one is multiplied.  Launches with few output tiles
// split K across blocks; a second launch then sums the partial tiles, one
// thread per output in a fixed order, so the result does not depend on
// block timing.
//
// Plain C interface for ctypes.  `geo` is a HOST int array (the layout is
// written by ops/hifigan.py `_geometry`); `w`, `st_in` and `st_out` are HOST
// arrays of DEVICE pointers:
//   w      : pre_w, pre_b, per stage (wa, wb, ub, rw, rb), post_w, post_b
//   st_in  : pre, per stage (ups, res), post      (PackedHeadState tails)
//   st_out : the same layout, written in full
// `x` (T0, num_mels) and `wav` (T0 * prod(rates)) are device pointers;
// `scratch` holds 4 activation buffers of buf_elems floats and part_cap
// floats of split-K partials.
// Returns the first CUDA error of a launch (0 when all were accepted).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;   // output rows per block   (mirrored in ops/hifigan.py)
constexpr int TN = 64;   // output columns per block (mirrored in ops/hifigan.py)
constexpr int KC = 16;   // K rows per shared-memory chunk
constexpr int NT = 256;  // threads: 16 x 16, each 4 x 4 outputs
constexpr int TARGET_BLOCKS = 528;  // four blocks per SM on 132 SMs
constexpr int MIN_CHUNKS = 4;  // K-chunks per split at least
constexpr int HDR = 13;  // header ints of `geo`

struct Conv {
  const float* tail;      // (rows_pad, Cin) old input tail; rows >= `rows` are kept
  float* new_tail;        // (rows_pad, Cin)
  int rows, rows_pad;
  const float* x;         // (T, Cin) new input rows
  int silu;               // SiLU of x as it is read (a tail holds SiLU'd rows)
  int T, Cin, k, d;
  const float* w;         // (k*Cin, N) tap-major rows; with w2, tap 0 only
  const float* w2;        // (Cin, N) tap-1 rows of the upsample, or null
  const float* b;         // bias, b[n % bias_mod]
  int bias_mod, N;
  const float* resid;     // y += resid[t, n], or null
  float* out;             // y stored, or null
  float* acc;             // branch sum: 1 acc = y, 2 acc += y, 3 acc = (acc + y) / n_branch
  int acc_mode, n_branch;
  int tanh_out;
  float* partials;        // (ksplit, T, N) when K is split
  int ksplit, per;        // K-chunk splits, chunks per split
};

__device__ __forceinline__ float silu_f(float v) { return v / (1.f + expf(-v)); }

// row r of [old tail; x], column c
__device__ __forceinline__ float full_at(const Conv& a, int r, int c) {
  if (r < a.rows) return a.tail[(size_t)r * a.Cin + c];
  const float v = a.x[(size_t)(r - a.rows) * a.Cin + c];
  return a.silu ? silu_f(v) : v;
}

__device__ __forceinline__ void epilogue(const Conv& a, int t, int n, float s) {
  float y = s + a.b[n % a.bias_mod];
  const size_t o = (size_t)t * a.N + n;
  if (a.resid != nullptr) y += a.resid[o];
  if (a.acc_mode == 1) a.acc[o] = y;
  else if (a.acc_mode == 2) a.acc[o] = a.acc[o] + y;
  else if (a.acc_mode == 3) a.acc[o] = (a.acc[o] + y) / (float)a.n_branch;
  if (a.tanh_out) y = tanhf(y);
  if (a.out != nullptr) a.out[o] = y;
}

// Gather this thread's 4 A elements (rows of [tail; x] at the taps) and 4 B
// elements (weight rows) of K-chunk `ch` into registers.
__device__ __forceinline__ void load_chunk(const Conv& a, int ch, int m0, int n0, int K,
                                           int tid, float* ra, float* rb) {
  const int k0 = ch * KC;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tid + u * NT;
    const int t = i / KC, kk = i % KC, k = k0 + kk, gt = m0 + t;
    float v = 0.f;
    if (k < K && gt < a.T) {
      const int j = k / a.Cin, c = k - j * a.Cin;
      v = full_at(a, gt + j * a.d, c);
    }
    ra[u] = v;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tid + u * NT;
    const int kk = i / TN, nn = i % TN, k = k0 + kk, n = n0 + nn;
    float v = 0.f;
    if (k < K && n < a.N) {
      const float* row = (a.w2 != nullptr && k >= a.Cin)
                             ? a.w2 + (size_t)(k - a.Cin) * a.N
                             : a.w + (size_t)k * a.N;
      v = __ldg(row + n);
    }
    rb[u] = v;
  }
}

__global__ void __launch_bounds__(NT) conv_kernel(const Conv a) {
  static_assert(TM * KC == 4 * NT && KC * TN == 4 * NT, "4 loads per thread per tile");
  __shared__ float As[KC][TM];
  __shared__ float Bs[KC][TN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM, ks = blockIdx.z;
  const int K = a.k * a.Cin;
  const int nch = (K + KC - 1) / KC;
  const int c0 = ks * a.per, c1 = min(nch, c0 + a.per);

  // the new tail: rows T .. T+rows of [old tail; x], then the kept rows
  {
    const int nb = gridDim.x * gridDim.y * gridDim.z;
    const int bid = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    const int total = a.rows_pad * a.Cin;
    for (int i = bid * NT + tid; i < total; i += nb * NT) {
      const int r = i / a.Cin, c = i - r * a.Cin;
      a.new_tail[i] = r < a.rows ? full_at(a, a.T + r, c) : a.tail[i];
    }
  }

  // partial products over this block's K-chunks, the next chunk's loads in
  // flight while the current one is multiplied; thread (ty, tx) owns rows
  // ty + 16 i and columns tx + 16 j of the tile
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float ra[4], rb[4];
  if (c0 < c1) load_chunk(a, c0, m0, n0, K, tid, ra, rb);
  for (int ch = c0; ch < c1; ++ch) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * NT;
      As[i % KC][i / KC] = ra[u];
      Bs[i / TN][i % TN] = rb[u];
    }
    __syncthreads();
    if (ch + 1 < c1) load_chunk(a, ch + 1, m0, n0, K, tid, ra, rb);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty + 16 * i];
        bv[i] = Bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (t >= a.T || n >= a.N) continue;
      if (a.ksplit == 1) epilogue(a, t, n, acc[i][j]);
      else a.partials[((size_t)ks * a.T + t) * a.N + n] = acc[i][j];
    }
}

// With K split across blocks: one thread per output sums the splits in
// order (so the result does not depend on block timing), then the epilogue.
__global__ void __launch_bounds__(NT) reduce_kernel(const Conv a) {
  const int o = blockIdx.x * NT + threadIdx.x;
  if (o >= a.T * a.N) return;
  const size_t plane = (size_t)a.T * a.N;
  float s = 0.f;
  for (int q = 0; q < a.ksplit; ++q) s += a.partials[q * plane + o];
  epilogue(a, o / a.N, o % a.N, s);
}

cudaError_t launch_conv(Conv a, float* partials, long part_cap, cudaStream_t st) {
  const int tn = (a.N + TN - 1) / TN, tm = (a.T + TM - 1) / TM, tiles = tn * tm;
  const int nch = (a.k * a.Cin + KC - 1) / KC;
  long ks = (TARGET_BLOCKS + tiles - 1) / tiles;
  const long most = (nch + MIN_CHUNKS - 1) / MIN_CHUNKS;
  const long cap = part_cap / ((long)a.T * a.N);
  ks = ks < most ? ks : most;
  ks = ks < cap ? ks : cap;
  if (ks < 1) ks = 1;
  a.per = (int)((nch + ks - 1) / ks);
  a.ksplit = (nch + a.per - 1) / a.per;
  a.partials = partials;
  conv_kernel<<<dim3(tn, tm, a.ksplit), NT, 0, st>>>(a);
  if (a.ksplit > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int nout = a.T * a.N;
    reduce_kernel<<<(nout + NT - 1) / NT, NT, 0, st>>>(a);
  }
  return cudaGetLastError();
}

inline int pad8(int n) { return (n + 7) / 8 * 8; }

}  // namespace

extern "C" int svd_hifigan_head_step(const int* geo, const void* const* w,
                                     const void* const* st_in, void* const* st_out,
                                     const void* x, void* wav, int n_geo, void* scratch,
                                     void* stream) {
  if (n_geo < HDR) return (int)cudaErrorInvalidValue;
  const int T0 = geo[0], num_mels = geo[1], C0 = geo[2], n_stage = geo[3];
  const int k_pre = geo[4], pre_pad = geo[5], k_post = geo[6], post_pad = geo[7];
  const int n_branch = geo[8], n_dil = geo[9];
  const int buf_elems = geo[11], part_cap = geo[12];
  const int n_slot = n_branch * n_dil * 2;
  if (n_geo != HDR + 3 * n_stage + 4 * n_slot) return (int)cudaErrorInvalidValue;
  const int* stg = geo + HDR;
  const int* slots = stg + 3 * n_stage;
  const cudaStream_t st = (cudaStream_t)stream;
  float* A = (float*)scratch;  // stage input, then the branch sum (next input)
  float* B = A + buf_elems;    // the upsample's output (every branch's input)
  float* C = B + buf_elems;    // the first conv's output
  float* D = C + buf_elems;    // a branch's running residual
  float* part = D + buf_elems;
  auto W = [&](int i) { return (const float*)w[i]; };
  auto IN = [&](int i) { return (const float*)st_in[i]; };
  auto OUT = [&](int i) { return (float*)st_out[i]; };
  cudaError_t e;
#define SVD_TRY(call) \
  if ((e = (call)) != cudaSuccess) return (int)e

  // conv_pre: x (T0, num_mels) -> A (T0, C0)
  Conv a = {};
  a.tail = IN(0); a.new_tail = OUT(0); a.rows = k_pre - 1; a.rows_pad = pre_pad;
  a.x = (const float*)x; a.T = T0; a.Cin = num_mels; a.k = k_pre; a.d = 1;
  a.w = W(0); a.b = W(1); a.bias_mod = C0; a.N = C0; a.out = A;
  SVD_TRY(launch_conv(a, part, part_cap, st));

  int T = T0, c_last = C0;
  for (int i = 0; i < n_stage; ++i) {
    const int s = stg[3 * i], ci = stg[3 * i + 1], co = stg[3 * i + 2];
    const float* rw = W(5 + 5 * i);
    const float* rb = W(6 + 5 * i);
    const float* res_in = IN(2 + 2 * i);
    float* res_out = OUT(2 + 2 * i);
    // SiLU -> upsample: A (T, ci) -> B (T*s, co)
    a = Conv{};
    a.tail = IN(1 + 2 * i); a.new_tail = OUT(1 + 2 * i); a.rows = 1; a.rows_pad = 8;
    a.x = A; a.silu = 1; a.T = T; a.Cin = ci; a.k = 2; a.d = 1;
    a.w = W(2 + 5 * i); a.w2 = W(3 + 5 * i); a.b = W(4 + 5 * i); a.bias_mod = co;
    a.N = s * co; a.out = B;
    SVD_TRY(launch_conv(a, part, part_cap, st));
    T *= s;
    c_last = co;
    int si = 0;
    size_t wrow = 0;
    for (int br = 0; br < n_branch; ++br) {
      for (int di = 0; di < n_dil; ++di) {
        const float* xr = di == 0 ? B : D;
        for (int cv = 0; cv < 2; ++cv, ++si) {
          const int k = slots[4 * si], d = slots[4 * si + 1];
          const int rows = slots[4 * si + 2], off = slots[4 * si + 3];
          a = Conv{};
          a.tail = res_in + (size_t)off * co; a.new_tail = res_out + (size_t)off * co;
          a.rows = rows; a.rows_pad = pad8(rows); a.silu = 1; a.T = T; a.Cin = co;
          a.k = k; a.d = d; a.w = rw + wrow * co; a.b = rb + (size_t)si * co;
          a.bias_mod = co; a.N = co;
          if (cv == 0) {
            a.x = xr; a.out = C;
          } else {
            a.x = C; a.resid = xr;
            if (di == n_dil - 1) {
              a.acc = A; a.n_branch = n_branch;
              a.acc_mode = br == 0 ? 1 : (br == n_branch - 1 ? 3 : 2);
            } else {
              a.out = D;
            }
          }
          wrow += (size_t)k * co;
          SVD_TRY(launch_conv(a, part, part_cap, st));
        }
      }
    }
  }
  // SiLU -> conv_post -> tanh: A (T, c_last) -> wav (T)
  a = Conv{};
  a.tail = IN(1 + 2 * n_stage); a.new_tail = OUT(1 + 2 * n_stage);
  a.rows = k_post - 1; a.rows_pad = post_pad; a.x = A; a.silu = 1; a.T = T;
  a.Cin = c_last; a.k = k_post; a.d = 1; a.w = W(2 + 5 * n_stage);
  a.b = W(3 + 5 * n_stage); a.bias_mod = 1; a.N = 1; a.tanh_out = 1; a.out = (float*)wav;
  SVD_TRY(launch_conv(a, part, part_cap, st));
#undef SVD_TRY
  return 0;
}
