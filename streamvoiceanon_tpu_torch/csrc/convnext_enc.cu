// The tokenizer's ConvNeXt front at batch 1, float32: stem conv (k over
// [tail; mel]) -> LayerNorm -> per stage [LN -> 1x1 transition (stages > 0)
// -> ConvNeXt blocks] -> final LN -> per downsample [stride-f conv (kernel
// f) -> one block].  A block is causal depthwise conv k -> LN -> pointwise
// C->4C -> exact GELU -> pointwise 4C->C -> LayerScale -> residual.  The port
// of `encoder_front_step` in ops/pallas_convnext_enc.py of the JAX package;
// see streamvoiceanon_tpu_torch/ops/convnext_enc.py for the design note.
//
// One cooperative launch a call, one block per SM.  The TPU kernel runs the
// front in program order on one core; here the grid runs each matrix
// product together and waits at a grid barrier (decode_common.cuh
// `count_barrier`) wherever a phase reads what another block wrote.  Every
// block reads the whole input rows of a phase (at most 4 rows of at most
// 2048 floats) and recomputes each cheap row-wise step of them itself,
// thread c holding column c of every row in registers (the im2col, the
// depthwise conv, LayerNorms by block reductions), then computes only its
// own columns of the phase's product from the rows in shared memory.  The
// phases, in the order of ops/convnext_enc.py `phases` (46 at the
// published geometry; the host lists them, `fill_phases`, and the kernel
// runs each kind's code from one place, so that it stays in the
// instruction cache after the kind's first phase):
//
//   stem  im2col rows of [stem tail; mel] (K = k C_in), the block's columns
//         of the stem product + bias into buffer A; block 0 writes the new
//         stem tail slot
//   P     one ConvNeXt block, first half: the block's input rows (for the
//         first block of stage 0, the stem rows normed first, which block 0
//         also writes to the other buffer as x), the causal depthwise conv
//         over [tail; x] + bias and the LN, then the block's columns of pw1
//         + bias and exact GELU into g (T x 4C); block 0 writes the block's
//         new tail slot
//   Q     second half: the block's columns of g @ pw2 + bias, times gamma,
//         plus x, written in place into those columns of x (the last Q of a
//         call writes z instead)
//   M     a transition: the LN of the whole rows, the block's columns of the
//         1x1 product + bias into the other buffer
//   D     a downsample: (the first one applies the final LN) the rows viewed
//         as (T/f, f C), the block's columns of the tap-major product + bias
//         into the other buffer
//
// What each barrier guards (all are needed; the model in
// tests/test_torch_front_plan.py reads only a snapshot taken at each):
//   stem -> P   P reads the whole stem rows the stem's owners wrote;
//   P -> Q      Q reads the whole g rows P's owners wrote (and the x block 0
//               wrote after the stem LN); P's reads of x are done before Q
//               writes x in place;
//   Q -> P, M, D  the next phase reads the whole x rows Q's owners wrote;
//               Q's reads of g are done before the next P writes g;
//   M -> P, D -> P  P reads the whole rows the product's owners wrote into
//               the other buffer.
// A phase that writes a product into the other buffer does so because
// other blocks still read x in that phase; the buffer it overwrites was
// last read two phases or more before.  The input tails, mel and the
// weights are never written in a call (new tails go to the output state).
// Data that other blocks wrote during the launch is read with ld.global.cg
// (L2).
//
// Each block owns fixed runs of 16-byte column units of every phase
// (ops/convnext_enc.py `work_plan`, per phase: first unit, units) and sums
// each column of each row over the whole K in a fixed order (`matvec4`, on
// the task map of decode_common.cuh `matvec_tasks`, every weight load
// serving all rows): no split-K partials, and no result depends on block
// timing.  The matrices come unit-packed (ops/convnext_enc.py
// `unit_weights`), each unit's K x 16-byte slice contiguous.  A phase's
// epilogue inputs (bias, LayerScale, residual) are loaded with its rows.
//
// Tried on the H100 and left out, each no faster or slower (PERF.md §6):
// the first weight loads issued before the rows' work (registers spilled),
// the block's weight slice bulk-copied into shared memory when the phase
// starts or before the barrier (the barriers doubled), an L2 prefetch of
// the next phase's weights or of every vector and tail, and a lane tree in
// place of the warp-ordered epilogue sum.
//
// Rounding follows the plain version (float32 throughout): the depthwise
// conv sums its k taps in order then adds the bias; LayerNorms are two-pass
// (mean, then the mean of squared deviations), eps 1e-6, each row's sums
// taken over warps and then over the warps in a fixed tree; GELU is exact
// erf.
//
// Plain C interface for ctypes.  `geo` is a HOST int array (layout written
// by ops/convnext_enc.py `_geometry`); `w`, `st_in` and `st_out` are HOST
// arrays of DEVICE pointers:
//   w      : stem_w (unit-packed), stem_b, stem_ln_w, stem_ln_b,
//            per stage (dw_w, dw_b, ln_w, ln_b, pw1 (unit-packed), pw1_b,
//            pw2 (unit-packed), pw2_b, gamma),
//            per transition (ln_w, ln_b, w (unit-packed), b), final_ln_w,
//            final_ln_b,
//            per downsample (w (unit-packed), b, dw_w, dw_b, ln_w, ln_b,
//            pw1 (unit-packed), pw1_b, pw2 (unit-packed), pw2_b, gamma)
//   st_in  : stem (8, C_in), per stage (depth*8, C_i), down (n_down*8, C_q)
//   st_out : the same layout, written in full
// `mel` (T, C_in) and `z` (T / prod(f), C_q) are device pointers; `xa`, `xb`
// (4 x widest floats each) and `g` (4 x 4 widest) are the kept activation
// buffers, `plan` the (grid, phases, 2) int work plan, `stamps` (phases,
// grid, 3) global ns or null, `bar_count` the grid barrier's count.
// Returns a CUDA error code: 0 when the launch was accepted,
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident at
// once (it is never shrunk).

#include "decode_common.cuh"

using namespace svd;

namespace {

constexpr int FT = PK_THREADS;
constexpr int FW = PK_WARPS;
constexpr int SLOT = 8;       // rows of one packed tail slot
constexpr int HDR = 8;        // header ints of `geo`
constexpr int ROWS = 4;       // rows of a launch, at most (the matvec's R)
constexpr int MAX_STAGE = 8;
constexpr int MAX_DOWN = 4;
constexpr int MAX_W = 4 + 9 * MAX_STAGE + 4 * (MAX_STAGE - 1) + 2 + 11 * MAX_DOWN;
constexpr int MAX_ST = MAX_STAGE + 2;
constexpr int MAX_PH = 96;
constexpr int EPV = 2 + ROWS;  // a column's epilogue inputs: bias, gamma, residual rows
enum PhaseKind { PH_STEM = 0, PH_P = 1, PH_Q = 2, PH_M = 3, PH_D = 4 };
constexpr float LN_EPS = 1e-6f;
constexpr float SQRT1_2 = 0.70710678118654752f;

struct FrontArgs {
  const float* w[MAX_W];
  const float* st_in[MAX_ST];
  float* st_out[MAX_ST];
  const float* ph_w[MAX_PH];      // per phase: its unit-packed matrix (N / 4, K, 4),
  int ph_k[MAX_PH];               // its K,
  int desc[MAX_PH];               // and kind | stage or downsample << 3 | down << 7 | block << 8
  const float* mel;
  float* z;
  float* xa;                      // (ROWS, widest) activation buffers
  float* xb;
  float* g;                       // (ROWS, 4 widest) the hidden rows
  const int* plan;                // (grid, n_ph, 2): per phase (first unit, units)
  unsigned long long* stamps;     // (n_ph, grid, 3) global ns, or null
  unsigned long long* bar_count;  // count_barrier's arrivals
  int T, Cin, k, n_stage, n_down, Cq, n_ph, max_k;
  int depth[MAX_STAGE], dims[MAX_STAGE], fac[MAX_DOWN];
};

// unit u of a unit-packed matrix: K x 16 bytes at wp + u K 4
__device__ __forceinline__ const uint4* unit_col(const float* wp, int K, int u) {
  return reinterpret_cast<const uint4*>(wp + (size_t)u * K * 4);
}

// The block's columns of ROWS rows of xs (K floats each, at a stride of K)
// times its nu units of the unit-packed matrix wp, on the task map of
// decode_common.cuh `matvec_tasks` (which sums one row): every column of
// every row over the whole K in a fixed order, PK_DEPTH 16-byte loads in
// flight a lane, each serving all rows.  Then epi(unit, v, row, sum) once
// per column and row, the sum over the task's warps in warp order.
template <typename Epi>
__device__ void matvec4(const float* __restrict__ xs, const float* wp, int K, int nu,
                        float* red, Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t0 = 0; t0 < nu; t0 += PK_WARPS) {
    const TaskMap tm(nu, t0, warp);
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[r][v] = 0.f;
    if (tm.ti < tm.nt) {
      const uint4* w = unit_col(wp, K, t0 + tm.ti);
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
            float wv[4];
            unpack_vec<float>(raw[j], wv);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              const float xv = xs[r * K + k];
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float tot = warp_sum_vec<4>(acc[r], lane);
      if (lane % 8 == 0) red[(r * PK_WARPS + warp) * 4 + (lane / 8) % 4] = tot;
    }
    __syncthreads();
    const int ncol = tm.nt * 4;
    for (int i = tid; i < ncol * ROWS; i += PK_THREADS) {
      const int r = i / ncol, j = i - r * ncol, ul = j / 4, v = j % 4;
      float x = 0.f;  // the task's warps in warp order
      for (int q = 0; q < tm.wpt; ++q) x += red[(r * PK_WARPS + ul * tm.wpt + q) * 4 + v];
      epi(t0 + ul, v, r, x);
    }
    __syncthreads();
  }
}

// every thread's v[t] summed over the block, for each row t: every thread
// gets the sums (warp sums, then the warps' in a fixed order).  `red` (ROWS
// FW floats) may be written again only after the block's next barrier.
__device__ __forceinline__ void block_rows_sum(float (&v)[ROWS], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    const float s = warp_sum(v[t]);
    if (lane == 0) red[t * FW + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < ROWS; ++t) v[t] = warp_sum(lane < FW ? red[t * FW + lane] : 0.f);
}

// LayerNorm of T rows of C, this thread holding column c of each row in
// h[t] (`on`: c < C): h[t] <- (h[t] - mean_t) * rsqrt(var_t + eps) * lw + lb,
// the variance the mean of squared deviations.  The two sums take the two
// halves of `red` (2 ROWS FW floats), so that each needs one block barrier.
__device__ __forceinline__ void ln_cols(float (&h)[ROWS], int T, int C, bool on, float lw,
                                        float lb, float* red) {
  float s[ROWS], d[ROWS];
#pragma unroll
  for (int t = 0; t < ROWS; ++t) s[t] = on && t < T ? h[t] : 0.f;
  block_rows_sum(s, red);
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    s[t] /= (float)C;
    const float e = h[t] - s[t];
    d[t] = on && t < T ? e * e : 0.f;
  }
  block_rows_sum(d, red + ROWS * FW);
#pragma unroll
  for (int t = 0; t < ROWS; ++t)
    h[t] = (h[t] - s[t]) * rsqrtf(d[t] / (float)C + LN_EPS) * lw + lb;
}

__global__ void __launch_bounds__(FT, 1) front_kernel(const FrontArgs a) {
  const int tid = threadIdx.x;
  const int k = a.k, tr = k - 1, T0 = a.T;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // (ROWS max_k) a phase's input rows
  float* ep = xs + ROWS * a.max_k;              // (EPV FT) the block's columns' epilogue inputs
  __shared__ float red[ROWS * FW * 4];
  const bool lead = blockIdx.x == 0;

  // with `stamps`: each block's global time where it enters every phase,
  // where its product starts (its rows ready; a block without columns
  // leaves it 0) and where it leaves the phase
  int ph = 0;
  auto stamp = [&](int e) {
    if (a.stamps != nullptr && tid == 0)
      a.stamps[((size_t)ph * gridDim.x + blockIdx.x) * 3 + e] = global_ns();
  };
  const int* my = a.plan + (size_t)blockIdx.x * a.n_ph * 2;
  auto end_phase = [&](bool barrier) {
    __syncthreads();
    stamp(2);
    ++ph;
    if (barrier) {
      count_barrier(a.bar_count);
      stamp(0);
    }
  };
  auto owns = [&]() { return my[2 * ph + 1] > 0; };

  // the epilogue's inputs of the block's columns (column u0 * 4 + j on
  // thread j): loaded into registers with the phase's other loads, stored
  // to `ep` once they are needed
  float epv[EPV];
  auto ep_load = [&](const float* b, const float* gm, const float* xr, int T, int C) {
    const int n = my[2 * ph] * 4 + tid;
    if (tid < 4 * my[2 * ph + 1]) {
      epv[0] = __ldg(b + n);
      if (gm != nullptr) epv[1] = __ldg(gm + n);
      if (xr != nullptr)
#pragma unroll
        for (int t = 0; t < ROWS; ++t)
          if (t < T) epv[2 + t] = __ldcg(xr + t * C + n);
    }
  };
  auto ep_store = [&]() {
    if (tid < 4 * my[2 * ph + 1])
#pragma unroll
      for (int e = 0; e < EPV; ++e) ep[e * FT + tid] = epv[e];
  };
  // the block's columns of `nrows` rows of xs (stride K) times the phase's
  // unit-packed matrix; epi(row, column, sum, j) with j the column's index
  // among the block's
  auto product = [&](int nrows, auto epi) {
    const int u0 = my[2 * ph], nu = my[2 * ph + 1], K = a.ph_k[ph];
    ep_store();
    if (nu > 0) stamp(1);
    matvec4(xs, a.ph_w[ph] + (size_t)u0 * K * 4, K, nu, red,
            [&](int u, int v, int r, float s) {
              if (r < nrows) epi(r, (u0 + u) * 4 + v, s, u * 4 + v);
            });
  };

  // P: one block (its stack's 9 weights from a.w[wb], block bi of it) on
  // rows x (T, C) with its tail slots tin -> tout; with stem_ln the rows
  // are the stem's, normed here, and block 0 writes them to x_out.  Thread
  // c holds column c: the tail rows, the input rows and the taps, all
  // loaded at once.
  auto phase_p = [&](const float* x, int wb, int bi, int T, int C, const float* tin,
                     float* tout, bool stem_ln, float* x_out) {
    if (!owns() && !lead) return;
    const int hid = 4 * C, c = tid;
    const bool on = c < C;
    const float* dw = a.w[wb] + (size_t)bi * k * C;
    float tv[SLOT], xv[ROWS], wk[SLOT + 1], pad[SLOT];
    float db = 0.f, lw = 0.f, lb = 0.f, slw = 0.f, slb = 0.f;
#pragma unroll
    for (int i = 0; i < SLOT; ++i) {
      tv[i] = on && i < tr ? __ldg(tin + i * C + c) : 0.f;
      pad[i] = on && lead && i >= tr ? __ldg(tin + i * C + c) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < ROWS; ++t) xv[t] = on && t < T ? __ldcg(x + t * C + c) : 0.f;
#pragma unroll
    for (int j = 0; j < SLOT + 1; ++j) wk[j] = on && j < k ? __ldg(dw + j * C + c) : 0.f;
    if (on) {
      db = __ldg(a.w[wb + 1] + (size_t)bi * C + c);
      lw = __ldg(a.w[wb + 2] + (size_t)bi * C + c);
      lb = __ldg(a.w[wb + 3] + (size_t)bi * C + c);
      if (stem_ln) {
        slw = __ldg(a.w[2] + c);
        slb = __ldg(a.w[3] + c);
      }
    }
    ep_load(a.w[wb + 5] + (size_t)bi * hid, nullptr, nullptr, T, C);
    if (stem_ln) {
      ln_cols(xv, T, C, on, slw, slb, red);
      if (lead && on)
#pragma unroll
        for (int t = 0; t < ROWS; ++t)
          if (t < T) x_out[t * C + c] = xv[t];
    }
    // full row i of [tail; x]
    float full[SLOT + ROWS];
#pragma unroll
    for (int i = 0; i < SLOT + ROWS; ++i) {
      float v = i < SLOT ? tv[i] : 0.f;
#pragma unroll
      for (int t = 0; t < ROWS; ++t)
        if (i == tr + t) v = xv[t];
      full[i] = v;
    }
    float h[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SLOT + 1; ++j)
        if (j < k && t + j < SLOT + ROWS) acc += full[t + j] * wk[j];
      h[t] = acc + db;
    }
    if (lead && on) {
#pragma unroll
      for (int i = 0; i < SLOT + ROWS; ++i) {
        const int r = i - T;
        if (r >= 0 && r < tr) tout[r * C + c] = full[i];
      }
#pragma unroll
      for (int i = 0; i < SLOT; ++i)
        if (i >= tr) tout[i * C + c] = pad[i];
    }
    ln_cols(h, T, C, on, lw, lb, red);
    if (on)
#pragma unroll
      for (int t = 0; t < ROWS; ++t)
        if (t < T) xs[t * C + c] = h[t];
    __syncthreads();
    float* g = a.g;
    product(T, [&](int r, int n, float s, int j) {
      const float v = s + ep[j];
      g[r * hid + n] = v * 0.5f * (1.f + erff(v * SQRT1_2));
    });
  };

  // Q: g @ pw2 + bias, times gamma, plus x, into out (x itself, or z)
  auto phase_q = [&](const float* x, float* out, int wb, int bi, int T, int C) {
    if (!owns()) return;
    const int n4 = T * C;  // float4s of the T hidden rows
    const float4* src = reinterpret_cast<const float4*>(a.g);
    float4* dst = reinterpret_cast<float4*>(xs);
#pragma unroll 4
    for (int i = tid; i < n4; i += FT) dst[i] = __ldcg(src + i);
    ep_load(a.w[wb + 7] + (size_t)bi * C, a.w[wb + 8] + (size_t)bi * C, x, T, C);
    __syncthreads();
    product(T, [&](int r, int n, float s, int j) {
      out[r * C + n] = ep[(2 + r) * FT + j] + ep[FT + j] * (s + ep[j]);
    });
  };

  // M and D: the rows (T, C), normed by (lw, lb) when lw is given, viewed
  // as (T / f, f C), times the phase's matrix + bias b into out (N wide)
  auto phase_lin = [&](const float* x, float* out, int T, int C, int f, const float* lw,
                       const float* lb, const float* b, int N) {
    if (!owns()) return;
    const int c = tid;
    const bool on = c < C;
    float xv[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) xv[t] = on && t < T ? __ldcg(x + t * C + c) : 0.f;
    const float w_ = on && lw != nullptr ? __ldg(lw + c) : 0.f;
    const float b_ = on && lw != nullptr ? __ldg(lb + c) : 0.f;
    ep_load(b, nullptr, nullptr, T, C);
    if (lw != nullptr) ln_cols(xv, T, C, on, w_, b_, red);
    if (on)
#pragma unroll
      for (int t = 0; t < ROWS; ++t)
        if (t < T) xs[t * C + c] = xv[t];
    __syncthreads();
    product(T / f, [&](int r, int n, float s, int j) { out[r * N + n] = s + ep[j]; });
  };

  stamp(0);
  // stem: im2col rows of [tail; mel] (thread c: input column c), the
  // product + bias into xa
  const int Cin = a.Cin, kc = k * Cin, C0 = a.dims[0];
  if (owns() || lead) {
    const int c = tid;
    const bool on = c < Cin;
    const float* tin = a.st_in[0];
    float tv[SLOT], mv[ROWS], pad[SLOT];
#pragma unroll
    for (int i = 0; i < SLOT; ++i) {
      tv[i] = on && i < tr ? __ldg(tin + i * Cin + c) : 0.f;
      pad[i] = on && lead && i >= tr ? __ldg(tin + i * Cin + c) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < ROWS; ++t) mv[t] = on && t < T0 ? __ldg(a.mel + t * Cin + c) : 0.f;
    ep_load(a.w[1], nullptr, nullptr, T0, C0);
    float full[SLOT + ROWS];
#pragma unroll
    for (int i = 0; i < SLOT + ROWS; ++i) {
      float v = i < SLOT ? tv[i] : 0.f;
#pragma unroll
      for (int t = 0; t < ROWS; ++t)
        if (i == tr + t) v = mv[t];
      full[i] = v;
    }
    if (on) {
#pragma unroll
      for (int t = 0; t < ROWS; ++t)
#pragma unroll
        for (int j = 0; j < SLOT + 1; ++j)
          if (t < T0 && j < k) xs[t * kc + j * Cin + c] = full[t + j];
      if (lead) {
        float* tout = a.st_out[0];
#pragma unroll
        for (int i = 0; i < SLOT + ROWS; ++i) {
          const int r = i - T0;
          if (r >= 0 && r < tr) tout[r * Cin + c] = full[i];
        }
#pragma unroll
        for (int i = 0; i < SLOT; ++i)
          if (i >= tr) tout[i * Cin + c] = pad[i];
      }
    }
    __syncthreads();
    float* out = a.xa;
    product(T0, [&](int r, int n, float s, int j) { out[r * C0 + n] = s + ep[j]; });
  }
  end_phase(true);

  // every later phase from its descriptor: one copy of each kind's code,
  // warm in the instruction cache after the kind's first phase
  const int w_stage = 4, w_mid = w_stage + 9 * a.n_stage;
  const int w_final = w_mid + 4 * (a.n_stage - 1), w_down = w_final + 2;
  float* cur = a.xa;
  float* oth = a.xb;
  auto swap_bufs = [&]() {
    float* s = cur;
    cur = oth;
    oth = s;
  };
  int T = T0, C = C0;
  for (int p = 1; p < a.n_ph; ++p) {
    const int d = a.desc[p], kind = d & 7, i = (d >> 3) & 15, bi = d >> 8;
    const bool down = (d >> 7) & 1;
    if (kind == PH_M) {
      const int m = w_mid + 4 * (i - 1);
      phase_lin(cur, oth, T, C, 1, a.w[m], a.w[m + 1], a.w[m + 3], a.dims[i]);
      swap_bufs();
      C = a.dims[i];
    } else if (kind == PH_D) {
      phase_lin(cur, oth, T, C, a.fac[i], i == 0 ? a.w[w_final] : nullptr, a.w[w_final + 1],
                a.w[w_down + 11 * i + 1], a.Cq);
      swap_bufs();
      T /= a.fac[i];
      C = a.Cq;
    } else {
      // a block of stage i, or the block of downsample i
      const int wb = down ? w_down + 11 * i + 2 : w_stage + 9 * i;
      const size_t slot = (size_t)(down ? i : bi) * SLOT * C;
      const int sb = down ? 1 + a.n_stage : 1 + i;
      if (kind == PH_P) {
        const bool stem_ln = !down && i == 0 && bi == 0;
        phase_p(cur, wb, bi, T, C, a.st_in[sb] + slot, a.st_out[sb] + slot, stem_ln, oth);
        if (stem_ln) swap_bufs();
      } else {
        phase_q(cur, p + 1 == a.n_ph ? a.z : cur, wb, bi, T, C);
      }
    }
    end_phase(p + 1 < a.n_ph);
  }
}

// The phases a call runs, in the kernel's order (ops/convnext_enc.py
// `phases`): each one's matrix (the block's slice of a stack) and K.
// Returns how many, or -1 past MAX_PH.
inline int fill_phases(FrontArgs& a) {
  int n = 0;
  auto add = [&](int kind, int i, int bi, bool down, const float* w, int K) {
    if (n < MAX_PH) {
      a.desc[n] = kind | i << 3 | (int)down << 7 | bi << 8;
      a.ph_w[n] = w;
      a.ph_k[n] = K;
    }
    ++n;
  };
  add(PH_STEM, 0, 0, false, a.w[0], a.k * a.Cin);
  const int w_stage = 4, w_mid = w_stage + 9 * a.n_stage;
  const int w_down = w_mid + 4 * (a.n_stage - 1) + 2;
  for (int i = 0; i < a.n_stage; ++i) {
    const int C = a.dims[i], wb = w_stage + 9 * i;
    if (i > 0) add(PH_M, i, 0, false, a.w[w_mid + 4 * (i - 1) + 2], a.dims[i - 1]);
    for (int bi = 0; bi < a.depth[i]; ++bi) {
      add(PH_P, i, bi, false, a.w[wb + 4] + (size_t)bi * 4 * C * C, C);
      add(PH_Q, i, bi, false, a.w[wb + 6] + (size_t)bi * 4 * C * C, 4 * C);
    }
  }
  int C = a.dims[a.n_stage - 1];
  for (int i = 0; i < a.n_down; ++i) {
    const int d = w_down + 11 * i;
    add(PH_D, i, 0, false, a.w[d], a.fac[i] * C);
    C = a.Cq;
    add(PH_P, i, 0, true, a.w[d + 6], C);
    add(PH_Q, i, 0, true, a.w[d + 8], 4 * C);
  }
  return n <= MAX_PH ? n : -1;
}

}  // namespace

extern "C" int svd_convnext_enc_step(const int* geo, int n_geo, const void* const* w,
                                     int n_w, const void* const* st_in, void* const* st_out,
                                     const void* mel, void* z, void* xa, void* xb, void* g,
                                     const void* plan, void* stamps, void* bar_count,
                                     int grid, void* stream) {
  if (n_geo < HDR) return (int)cudaErrorInvalidValue;
  FrontArgs a;
  a.T = geo[0];
  a.Cin = geo[1];
  a.k = geo[2];
  a.n_stage = geo[3];
  a.n_down = geo[4];
  a.Cq = geo[5];
  a.n_ph = geo[6];
  const int widest = geo[7];
  // one column a thread in the row-wise steps
  if (a.n_stage < 1 || a.n_stage > MAX_STAGE || a.n_down < 1 || a.n_down > MAX_DOWN ||
      n_geo != HDR + 2 * a.n_stage + a.n_down || a.k < 1 || a.k > SLOT + 1 || a.T < 1 ||
      a.T > ROWS || a.Cin > FT || widest > FT ||
      n_w != 4 + 9 * a.n_stage + 4 * (a.n_stage - 1) + 2 + 11 * a.n_down)
    return (int)cudaErrorInvalidValue;
  int prod = 1, max_n = 0;
  for (int i = 0; i < a.n_stage; ++i) {
    a.depth[i] = geo[HDR + 2 * i];
    a.dims[i] = geo[HDR + 2 * i + 1];
    if (a.depth[i] < 1 || a.dims[i] % 4 || a.dims[i] > widest) return (int)cudaErrorInvalidValue;
    max_n = max(max_n, 4 * a.dims[i]);
  }
  for (int i = 0; i < a.n_down; ++i) {
    a.fac[i] = geo[HDR + 2 * a.n_stage + i];
    prod *= a.fac[i];
  }
  max_n = max(max_n, 4 * a.Cq);
  for (int i = 0; i < n_w; ++i) a.w[i] = (const float*)w[i];
  a.max_k = 0;
  if (fill_phases(a) != a.n_ph || a.T % prod || a.Cq % 4 || a.Cq > widest ||
      // the epilogue's inputs: at most FT columns a block a phase
      (max_n / 4 + grid - 1) / grid * 4 > FT)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < a.n_ph; ++p) a.max_k = max(a.max_k, a.ph_k[p]);
  for (int i = 0; i < a.n_stage + 2; ++i) {
    a.st_in[i] = (const float*)st_in[i];
    a.st_out[i] = (float*)st_out[i];
  }
  a.mel = (const float*)mel;
  a.z = (float*)z;
  a.xa = (float*)xa;
  a.xb = (float*)xb;
  a.g = (float*)g;
  a.plan = (const int*)plan;
  a.stamps = (unsigned long long*)stamps;
  a.bar_count = (unsigned long long*)bar_count;
  // shared memory (ops/convnext_enc.py `smem_bytes`): ROWS rows of the
  // longest K, then the epilogue's inputs
  const size_t smem = sizeof(float) * ((size_t)ROWS * a.max_k + (size_t)EPV * FT);
  auto kern = front_kernel;
  cudaError_t e;
  // the dynamic shared memory the kernel may take, raised once to the
  // largest a call has needed (with the static part, even a size under
  // 48 KB may need it)
  static size_t smem_allowed = 0;
  if (smem > smem_allowed) {
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
    smem_allowed = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, FT, smem)) !=
      cudaSuccess)
    return (int)e;
  // one block per SM, all resident at once, or no launch
  if (grid != sms || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  if ((e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(FT), args, smem,
                                       (cudaStream_t)stream)) != cudaSuccess)
    return (int)e;
  return (int)cudaGetLastError();
}
