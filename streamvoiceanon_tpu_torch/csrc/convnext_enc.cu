// The tokenizer's ConvNeXt front at batch 1: stem conv (k over [tail; mel])
// -> LayerNorm -> per stage [LN -> 1x1 transition (stages > 0) -> ConvNeXt
// blocks] -> final LN -> per downsample [stride-f conv (kernel f) -> one
// block].  A block is causal depthwise conv k -> LN -> pointwise C->4C ->
// exact GELU -> pointwise 4C->C -> LayerScale -> residual.  The port of
// `encoder_front_step` in ops/pallas_convnext_enc.py of the JAX package;
// see streamvoiceanon_tpu_torch/ops/convnext_enc.py for the design note.
//
// One cooperative launch a call, one block per SM.  The TPU kernel runs the
// front in program order on one core; here the grid runs each matrix
// product together and waits at a grid barrier (decode_common.cuh
// `count_barrier`) wherever a phase reads what another block wrote.  Every
// block reads the whole input rows of a phase and recomputes each cheap
// row-wise step of them itself (the im2col, the depthwise conv, LayerNorms
// by block reductions), then computes only its own columns of the phase's
// product from the rows in shared memory.  Two builds of the kernel: the
// narrow one (rows at most 512 wide, at most 4 of them, at most 512
// columns a block: the published geometry) holds column c of every row in
// thread c's registers; the wide one (`WIDE`, any other geometry) passes
// the rows through shared memory, thread c taking columns c, c + 512, ...,
// in passes of 4 rows.  The narrow build carries none of the wide code: the
// kernel runs from the instruction cache, phase kind after phase kind, and
// a build with both paths was 10 % slower at the published geometry on the
// H100 (PERF.md §6).  The phases, in the order
// of ops/convnext_enc.py `phases` (46 at the published geometry), come as
// records of a table the host writes once per weight tree and geometry
// (`_table`), copied to shared memory when the launch starts, the narrow
// build taking each record's integer fields from its launch parameters
// (`PH_PARAMS`); the kernel runs each kind's code from one place, so that it
// stays in the instruction cache after the kind's first phase:
//
//   stem  im2col rows of [stem tail; mel] (K = k C_in), the block's columns
//         of the stem product + bias into buffer A; block 0 writes the new
//         stem tail slot
//   P     one ConvNeXt block, first half: the block's input rows (for the
//         phase after the stem, the stem rows normed first, which block 0
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
//   L     only where there is no downsample: the final LN, the block's
//         columns of it into z
//
// What each barrier guards (all are needed; the model in
// tests/test_torch_front_plan.py reads only a snapshot taken at each):
//   stem -> P   P reads the whole stem rows the stem's owners wrote;
//   P -> Q      Q reads the whole g rows P's owners wrote (and the x block 0
//               wrote after the stem LN); P's reads of x are done before Q
//               writes x in place;
//   Q -> P, M, D, L  the next phase reads the whole x rows Q's owners
//               wrote; Q's reads of g are done before the next P writes g;
//   M -> P, D -> P  P reads the whole rows the product's owners wrote into
//               the other buffer.
// A phase that writes a product into the other buffer does so because
// other blocks still read x in that phase; the buffer it overwrites was
// last read two phases or more before.  The input tails, mel and the
// weights are never written in a call (new tails go to the output state).
// Data that other blocks wrote during the launch is read with ld.global.cg
// (L2).
//
// Each block owns fixed runs of 4-column units of every phase
// (ops/convnext_enc.py `work_plan`, per phase: first unit, units) and sums
// each column of each row over the whole K in a fixed order (`matvec4`, on
// the task map of decode_common.cuh `matvec_tasks`, every weight load
// serving four rows; more rows take more passes): no split-K partials, and
// no result depends on block timing.  The matrices come unit-packed
// (ops/convnext_enc.py `unit_weights`), each unit's K x 4-column slice
// contiguous, the last unit zero-padded where a width is not a multiple of
// 4.  A phase's epilogue inputs (bias, LayerScale, residual) are loaded
// with its rows: those of the first 4 rows and 512 columns into registers,
// any others (only at geometries with a downsample product above 4 or more
// than 512 output columns a block) straight into shared memory.
//
// Tried on the H100 and left out, each no faster or slower (PERF.md §6):
// the first weight loads issued before the rows' work (registers spilled),
// the block's weight slice bulk-copied into shared memory when the phase
// starts or before the barrier (the barriers doubled), an L2 prefetch of
// the next phase's weights or of every vector and tail, a lane tree in
// place of the warp-ordered epilogue sum, and the records read from the
// card's memory in place of shared memory.
//
// Element types: the weights W and the tails S, each float32 or bf16, as
// the JAX kernel takes them as given.  Every product, the depthwise conv
// and the LayerNorm statistics run in float32; the activations (buffers A,
// B and g, float32) hold values of W, rounded where the plain version
// rounds (`act`): after the depthwise conv + bias, after each LN's
// normalisation, its weight product and its bias, after each product +
// bias, after GELU, after the LayerScale product and the residual sum.  z
// is stored as W, tails as S; mel comes rounded to W from the wrapper.  In
// float32 `act` is the identity, so the float32 path is the design's: the
// depthwise conv sums its k taps in order then adds the bias; LayerNorms
// are two-pass (mean, then the mean of squared deviations), eps 1e-6, each
// row's sums taken over a thread's columns, then warps, then the warps in a
// fixed tree; GELU is exact erf.
//
// Plain C interface for ctypes.  `tab` is a DEVICE int64 table of n_w
// pointers (the stem LayerNorm's weight and bias, read by the phase after
// the stem) then n_ph phase records of PH_FIELDS (`PhaseField`); `ints` a
// HOST int32 (n_ph, PH_INTS) copy of each record's fields K .. flags, which
// the narrow build takes as launch parameters.  `st_in` and `st_out` are
// the flat packed states (stem slot, each stage's slots, the downsample
// blocks' slots, in that order; S); `mel` (T, C_in) float32, `z` (T / prod
// f, C_q) W; `xa`, `xb` (rows x widest floats each) and `g` (rows x 4
// widest) the kept activation buffers; `plan` the (grid, phases, 2) int
// work plan; `stamps` (phases, grid, 3) global ns or null; `bar_count` the
// grid barrier's count.  `rows` is the rows buffer's size (a multiple of
// 4), `max_k` the floats of a row in it, `pre_c` the widest tail row the
// wide build stages (0 in the narrow one), `ep_cols` the stride of the
// epilogue inputs (the most columns a block owns in a phase; 512 in the
// narrow build), `wide` which build runs.  Returns a CUDA error
// code: 0 when the launch was accepted, cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be resident at once (it is never shrunk).

#include <cstring>

#include "decode_common.cuh"

using namespace svd;

namespace {

constexpr int FT = PK_THREADS;
constexpr int FW = PK_WARPS;
constexpr int SLOT = 8;        // rows of one packed tail slot
constexpr int RG = 4;          // rows of one pass of the matvec and the row statistics
constexpr int EPR = 2 + RG;    // a column's epilogue inputs held in registers
constexpr int PH_FIELDS = 13;  // int64 of a phase record (mirrored as PHASE_FIELDS)
// a phase record, in order (mirrored in ops/convnext_enc.py `_table`): the
// matrix, K, N, the input rows' width, kind, tail slot, factor, flags, then
// the phase's vectors (P: depthwise taps, their bias, LN weight and bias,
// pw1's bias; Q: pw2's bias, gamma; M, D and L: the LN weight and bias
// (null for a downsample after the first), the product's bias (null for
// L); the stem: its bias)
enum PhaseField { PF_W, PF_K, PF_N, PF_C, PF_KIND, PF_SLOT, PF_F, PF_FLAGS,
                  PF_V0, PF_V1, PF_V2, PF_V3, PF_V4 };
enum PhaseKind { PH_STEM = 0, PH_P = 1, PH_Q = 2, PH_M = 3, PH_D = 4, PH_L = 5 };
// The narrow build reads each record's integer fields (K .. flags) from its
// launch parameters, for up to PH_PARAMS phases (mirrored as NARROW_PHASES;
// a geometry with more takes the wide build).  Read from the parameter bank
// at the phase index, the kind is warp-uniform to ptxas, so the dispatch on
// it does not make ptxas guard the shuffles after it with a divergence
// check and a collective slow path, as it does for fields read from memory
// (the block sums of every P, Q and M/D phase).
constexpr int PH_PARAMS = 96;
constexpr int PH_INTS = PF_FLAGS - PF_K + 1;
// flags: the stem LN first (the first phase after the stem), the final LN,
// the output into z
enum PhaseFlag { FL_STEM_LN = 1, FL_FINAL_LN = 2, FL_TO_Z = 4 };
constexpr float LN_EPS = 1e-6f;
constexpr float SQRT1_2 = 0.70710678118654752f;

struct FrontArgs {
  const long long* tab;           // device: the stem LN's vectors, then the phase records
  const void* st_in;              // flat input state (S)
  void* st_out;                   // flat output state (S)
  const float* mel;
  void* z;                        // (T / prod f, C_q) of W
  float* xa;                      // (rows, widest) activation buffers
  float* xb;
  float* g;                       // (rows, 4 widest) the hidden rows
  const int* plan;                // (grid, n_ph, 2): per phase (first unit, units)
  unsigned long long* stamps;     // (n_ph, grid, 3) global ns, or null
  unsigned long long* bar_count;  // count_barrier's arrivals
  int T, k, n_w, n_ph, rows, max_k, pre_c, ep_cols;
  int ints[PH_PARAMS][PH_INTS];   // the narrow build's integer fields of each record
};

// four columns of one K row of a unit-packed matrix: 16 bytes of float32,
// 8 of bf16
template <typename W> struct Raw4;
template <> struct Raw4<float> { using T = uint4; };
template <> struct Raw4<bf16> { using T = uint2; };

__device__ __forceinline__ void unpack4(const uint4& r, float (&o)[4]) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack4(const uint2& r, float (&o)[4]) {
  const bf16* h = reinterpret_cast<const bf16*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __bfloat162float(h[i]);
}

// The block's columns of RG rows of xs (K floats each, at a stride of K)
// times its nu units of the unit-packed matrix wp, on the task map of
// decode_common.cuh `matvec_tasks` (which sums one row): every column of
// every row over the whole K in a fixed order, PK_DEPTH loads in flight a
// lane, each serving all rows.  Then epi(unit, v, row, sum) once per column
// and row, the sum over the task's warps in warp order.
template <typename W, typename Epi>
__device__ void matvec4(const float* __restrict__ xs, const W* wp, int K, int nu, float* red,
                        Epi epi) {
  using R4 = typename Raw4<W>::T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t0 = 0; t0 < nu; t0 += PK_WARPS) {
    const TaskMap tm(nu, t0, warp);
    float acc[RG][4];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[r][v] = 0.f;
    if (tm.ti < tm.nt) {
      const R4* w = reinterpret_cast<const R4*>(wp + (size_t)(t0 + tm.ti) * K * 4);
      for (int k0 = tm.wi * 32 + lane; k0 < K; k0 += PK_DEPTH * tm.stride) {
        R4 raw[PK_DEPTH];
#pragma unroll
        for (int j = 0; j < PK_DEPTH; ++j) {
          const int k = k0 + j * tm.stride;
          raw[j] = k < K ? __ldg(w + k) : R4{};
        }
#pragma unroll
        for (int j = 0; j < PK_DEPTH; ++j) {
          const int k = k0 + j * tm.stride;
          if (k < K) {
            float wv[4];
            unpack4(raw[j], wv);
#pragma unroll
            for (int r = 0; r < RG; ++r) {
              const float xv = xs[r * K + k];
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const float tot = warp_sum_vec<4>(acc[r], lane);
      if (lane % 8 == 0) red[(r * PK_WARPS + warp) * 4 + (lane / 8) % 4] = tot;
    }
    __syncthreads();
    const int ncol = tm.nt * 4;
    // at most one pass (ncol RG <= 4 PK_WARPS RG < PK_THREADS): unrolled,
    // the loop doubled the hot code between two barriers
#pragma unroll 1
    for (int i = tid; i < ncol * RG; i += PK_THREADS) {
      const int r = i / ncol, j = i - r * ncol, ul = j / 4, v = j % 4;
      float x = 0.f;  // the task's warps in warp order
      for (int q = 0; q < tm.wpt; ++q) x += red[(r * PK_WARPS + ul * tm.wpt + q) * 4 + v];
      epi(t0 + ul, v, r, x);
    }
    __syncthreads();
  }
}

// every thread's v[t] summed over the block, for each row t: every thread
// gets the sums (warp sums, then the warps' in a fixed order).  `red` (RG
// FW floats) may be written again only after the block's next barrier.
__device__ __forceinline__ void block_rows_sum(float (&v)[RG], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < RG; ++t) {
    const float s = warp_sum(v[t]);
    if (lane == 0) red[t * FW + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < RG; ++t) v[t] = warp_sum(lane < FW ? red[t * FW + lane] : 0.f);
}

template <typename W>
__device__ __forceinline__ float act(float v) {
  return rnd<W>(v);
}

// The epilogue inputs `ep_load` leaves out (columns past the first FT,
// residual rows past the first RG), straight into `ep` (ec columns a row):
// only at geometries with more than 512 output columns a block or a
// downsample product above 4.  Out of line, so that the hot path's code
// stays small.
template <typename W>
__device__ __noinline__ void ep_rest(float* ep, int ec, int nc, int ne, int n0, int N,
                                     const W* b, const W* g, const float* x, int C) {
  for (int j = threadIdx.x; j < nc; j += FT) {
    const int n = n0 + j;
    for (int e = j < FT ? EPR : 0; e < ne; ++e) {
      float v = 0.f;
      if (n < N)
        v = e == 0   ? to_f(b[n])
            : e == 1 ? (g != nullptr ? to_f(g[n]) : 0.f)
                     : __ldcg(x + (size_t)(e - 2) * C + n);
      ep[e * ec + j] = v;
    }
  }
}

// LayerNorm in place of the T rows of C floats at xs, thread c taking
// columns c, c + FT, ...: (x - mean) * rsqrt(var + eps), rounded to W, times
// lw plus lb, each rounded to W, the variance the mean of squared
// deviations; rows RG at a time, each sum over the thread's columns, then
// the block (`block_rows_sum`, on the two halves of `red`, 2 RG FW floats).
// (w0, b0) are lw and lb at the thread's first column, loaded by the caller
// with the phase's first loads, so that no load waits behind the sums.
// With `copy`, the normed rows also go there.
// Out of line: one copy of its code for its four call sites.
template <typename W>
__device__ __noinline__ void ln_rows(float* xs, int T, int C, const W* lw, const W* lb,
                                     float w0, float b0, float* red, float* copy) {
  const int tid = threadIdx.x;
  for (int t0 = 0; t0 < T; t0 += RG) {
    float s[RG], d[RG];
#pragma unroll
    for (int t = 0; t < RG; ++t) s[t] = 0.f;
    for (int c = tid; c < C; c += FT)
#pragma unroll
      for (int t = 0; t < RG; ++t)
        if (t0 + t < T) s[t] += xs[(t0 + t) * C + c];
    block_rows_sum(s, red);
#pragma unroll
    for (int t = 0; t < RG; ++t) {
      s[t] /= (float)C;
      d[t] = 0.f;
    }
    for (int c = tid; c < C; c += FT)
#pragma unroll
      for (int t = 0; t < RG; ++t)
        if (t0 + t < T) {
          const float e = xs[(t0 + t) * C + c] - s[t];
          d[t] += e * e;
        }
    block_rows_sum(d, red + RG * FW);
    for (int c = tid; c < C; c += FT) {
      const float w = c == tid ? w0 : to_f(__ldg(lw + c));
      const float b = c == tid ? b0 : to_f(__ldg(lb + c));
#pragma unroll
      for (int t = 0; t < RG; ++t)
        if (t0 + t < T) {
          float* x = xs + (t0 + t) * C + c;
          const float n = act<W>((*x - s[t]) * rsqrtf(d[t] / (float)C + LN_EPS));
          *x = act<W>(act<W>(n * w) + b);
          if (copy != nullptr) copy[(t0 + t) * C + c] = *x;
        }
    }
  }
}

// lw[c] and lb[c] for the thread's first column c = threadIdx.x (0 past C)
template <typename W>
__device__ __forceinline__ void first_col(const W* lw, const W* lb, int C, float& w,
                                          float& b) {
  const int c = threadIdx.x;
  w = lw != nullptr && c < C ? to_f(__ldg(lw + c)) : 0.f;
  b = lb != nullptr && c < C ? to_f(__ldg(lb + c)) : 0.f;
}

// LayerNorm of T <= RG rows of C <= FT, this thread holding column c of
// each row in h[t] (`on`: c < C), rounded as `ln_rows`: the narrow
// geometries' register path.  The two sums take the two halves of `red`
// (2 RG FW floats), so that each needs one block barrier.
template <typename W>
__device__ __forceinline__ void ln_cols(float (&h)[RG], int T, int C, bool on, float lw,
                                        float lb, float* red) {
  float s[RG], d[RG];
#pragma unroll
  for (int t = 0; t < RG; ++t) s[t] = on && t < T ? h[t] : 0.f;
  block_rows_sum(s, red);
#pragma unroll
  for (int t = 0; t < RG; ++t) {
    s[t] /= (float)C;
    const float e = h[t] - s[t];
    d[t] = on && t < T ? e * e : 0.f;
  }
  block_rows_sum(d, red + RG * FW);
#pragma unroll
  for (int t = 0; t < RG; ++t)
    h[t] = act<W>(act<W>(act<W>((h[t] - s[t]) * rsqrtf(d[t] / (float)C + LN_EPS)) * lw) + lb);
}

template <typename W, typename S, bool WIDE>
__global__ void __launch_bounds__(FT, 1) front_kernel(const FrontArgs a) {
  const int tid = threadIdx.x;
  const int k = a.k, tr = k - 1, T0 = a.T;
  extern __shared__ float4 smem4[];
  long long* tab = reinterpret_cast<long long*>(smem4);           // the table
  const int n_tab = a.n_w + PH_FIELDS * a.n_ph;
  float* pre = reinterpret_cast<float*>(tab + ((n_tab + 1) & ~1));  // (SLOT, pre_c) tail rows
  float* xs = pre + SLOT * a.pre_c;                // (rows, max_k) a phase's input rows
  float* ep = xs + (size_t)a.rows * a.max_k;       // (2 + rows, ep_cols) epilogue inputs
  __shared__ float red[RG * FW * 4];
  const bool lead = blockIdx.x == 0;
  const S* st_in = reinterpret_cast<const S*>(a.st_in);
  S* st_out = reinterpret_cast<S*>(a.st_out);

  // the table to shared memory; the narrow stem reads its own record from
  // the card's memory, and its barrier (or end_phase's) completes the copy
  for (int i = tid; i < n_tab; i += FT) tab[i] = a.tab[i];
  if constexpr (WIDE) __syncthreads();
  auto wptr = [&](int i) { return reinterpret_cast<const W*>(tab[i]); };

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
  auto rec = [&](int f) -> long long {
    if constexpr (!WIDE)
      if (f >= PF_K && f <= PF_FLAGS) return a.ints[ph][f - PF_K];
    return tab[a.n_w + PH_FIELDS * ph + f];
  };
  auto vec = [&](int f) { return reinterpret_cast<const W*>(rec(f)); };

  // the epilogue's inputs of the block's columns (column u0 * 4 + j): bias,
  // gamma and residual rows.  Those of the first RG rows and FT columns go
  // into registers with the phase's other loads and are stored to `ep` once
  // they are needed; the rest go to `ep` at that point.
  float epv[EPR];
  const W* ep_b = nullptr;
  const W* ep_g = nullptr;
  const float* ep_x = nullptr;
  int ep_T = 0, ep_C = 0;
  auto ncols = [&]() { return 4 * my[2 * ph + 1]; };
  auto ep_load = [&](const W* b, const W* gm, const float* xr, int T, int C) {
    ep_b = b;
    ep_g = gm;
    ep_x = xr;
    ep_T = T;
    ep_C = C;
    const int n = my[2 * ph] * 4 + tid;
    // (a narrow geometry's widths are multiples of 4: no ragged unit)
    if (tid < ncols() && (!WIDE || n < (int)rec(PF_N))) {
      epv[0] = to_f(__ldg(b + n));
      if (gm != nullptr) epv[1] = to_f(__ldg(gm + n));
      if (xr != nullptr)
#pragma unroll
        for (int t = 0; t < RG; ++t)
          if (t < T) epv[2 + t] = __ldcg(xr + (size_t)t * C + n);
    }
  };
  const int ec = WIDE ? a.ep_cols : FT;  // floats between two epilogue inputs' rows
  auto ep_store = [&]() {
    const int nc = ncols(), ne = 2 + (ep_x != nullptr ? ep_T : 0);
    if (tid < nc)
#pragma unroll
      for (int e = 0; e < EPR; ++e)
        if (e < ne) ep[e * ec + tid] = epv[e];
    if (WIDE && (nc > FT || ne > EPR))
      ep_rest<W>(ep, ec, nc, ne, my[2 * ph] * 4, (int)rec(PF_N), ep_b, ep_g, ep_x, ep_C);
  };
  // the block's columns of `nrows` rows of xs (stride K) times the phase's
  // unit-packed matrix; epi(row, column, sum, j) with j the column's index
  // among the block's
  auto product = [&](int nrows, auto epi) {
    const int u0 = my[2 * ph], nu = my[2 * ph + 1], K = (int)rec(PF_K);
    ep_store();
    if (nu > 0) stamp(1);
    const W* wp = reinterpret_cast<const W*>(rec(PF_W)) + (size_t)u0 * K * 4;
    if constexpr (WIDE) {  // passes of RG rows; a last unit may be ragged
      const int N = (int)rec(PF_N);
      for (int r0 = 0; r0 < nrows; r0 += RG)
        matvec4<W>(xs + (size_t)r0 * K, wp, K, nu, red, [&](int u, int v, int r, float s) {
          const int j = u * 4 + v, n = (u0 + u) * 4 + v;
          if (r0 + r < nrows && n < N) epi(r0 + r, n, s, j);
        });
    } else {  // one pass; widths are multiples of 4
      matvec4<W>(xs, wp, K, nu, red, [&](int u, int v, int r, float s) {
        if (r < nrows) epi(r, (u0 + u) * 4 + v, s, u * 4 + v);
      });
    }
  };
  // x rows (T, C) of an activation buffer into xs, RG loads in flight a
  // thread before any is stored
  auto load_rows = [&](const float* x, int T, int C) {
    const int n = T * C;
    for (int i0 = tid; i0 < n; i0 += RG * FT) {
      float v[RG];
#pragma unroll
      for (int q = 0; q < RG; ++q) v[q] = i0 + q * FT < n ? __ldcg(x + i0 + q * FT) : 0.f;
#pragma unroll
      for (int q = 0; q < RG; ++q)
        if (i0 + q * FT < n) xs[i0 + q * FT] = v[q];
    }
  };

  // P's rows at a narrow geometry (C <= FT, T <= RG): thread c holds column
  // c of the tail rows, the input rows and the taps in registers, all loaded
  // at once; the depthwise conv + bias and the LN (the stem LN first with
  // stem_ln, its rows to x_out from block 0) leave the rows in xs.
  auto rows_p_narrow = [&](const float* x, int T, int C, long long slot, bool stem_ln,
                           float* x_out) {
    const int c = tid;
    const bool on = c < C;
    const W* dw = vec(PF_V0);
    float tv[SLOT], xv[RG], wk[SLOT + 1];
    float db = 0.f, lw = 0.f, lb = 0.f, slw = 0.f, slb = 0.f;
#pragma unroll
    for (int i = 0; i < SLOT; ++i)
      tv[i] = on && (i < tr || lead) ? to_f(st_in[slot + (size_t)i * C + c]) : 0.f;
#pragma unroll
    for (int t = 0; t < RG; ++t) xv[t] = on && t < T ? __ldcg(x + t * C + c) : 0.f;
#pragma unroll
    for (int j = 0; j < SLOT + 1; ++j) wk[j] = on && j < k ? to_f(__ldg(dw + j * C + c)) : 0.f;
    if (on) {
      db = to_f(__ldg(vec(PF_V1) + c));
      lw = to_f(__ldg(vec(PF_V2) + c));
      lb = to_f(__ldg(vec(PF_V3) + c));
      if (stem_ln) {
        slw = to_f(__ldg(wptr(0) + c));
        slb = to_f(__ldg(wptr(1) + c));
      }
    }
    ep_load(vec(PF_V4), nullptr, nullptr, T, C);
    if (stem_ln) {
      ln_cols<W>(xv, T, C, on, slw, slb, red);
      if (lead && on)
#pragma unroll
        for (int t = 0; t < RG; ++t)
          if (t < T) x_out[t * C + c] = xv[t];
    }
    // full row i of [tail; x]
    float full[SLOT + RG];
#pragma unroll
    for (int i = 0; i < SLOT + RG; ++i) {
      float v = i < tr ? tv[i] : 0.f;
#pragma unroll
      for (int t = 0; t < RG; ++t)
        if (i == tr + t) v = xv[t];
      full[i] = v;
    }
    float h[RG];
#pragma unroll
    for (int t = 0; t < RG; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SLOT + 1; ++j)
        if (j < k && t + j < SLOT + RG) acc += full[t + j] * wk[j];
      h[t] = act<W>(acc + db);
    }
    if (lead && on) {
#pragma unroll
      for (int i = 0; i < SLOT + RG; ++i) {
        const int r = i - T;
        if (r >= 0 && r < tr) st_out[slot + (size_t)r * C + c] = from_f<S>(full[i]);
      }
#pragma unroll
      for (int i = 0; i < SLOT; ++i)
        if (i >= tr) st_out[slot + (size_t)i * C + c] = from_f<S>(tv[i]);
    }
    ln_cols<W>(h, T, C, on, lw, lb, red);
    if (on)
#pragma unroll
      for (int t = 0; t < RG; ++t)
        if (t < T) xs[t * C + c] = h[t];
  };

  // P's rows at any geometry: the rows through shared memory, thread c
  // taking columns c, c + FT, ...; the tail rows go to `pre`, just before
  // xs, so that row i of [tail; x] is at xs + (i - tr) C.
  auto rows_p_wide = [&](const float* x, int T, int C, long long slot, bool stem_ln,
                         float* x_out) {
    const W* dw = vec(PF_V0);
    const W* db = vec(PF_V1);
    const W* lw = vec(PF_V2);
    const W* lb = vec(PF_V3);
    float lw0, lb0, sw0 = 0.f, sb0 = 0.f;
    first_col<W>(lw, lb, C, lw0, lb0);
    if (stem_ln) first_col<W>(wptr(0), wptr(1), C, sw0, sb0);
    ep_load(vec(PF_V4), nullptr, nullptr, T, C);
    load_rows(x, T, C);
    // the tail rows to `pre`; block 0 copies the slot's kept rows
    float* full = xs - tr * C;
    for (int c = tid; c < C; c += FT)
      for (int i = 0; i < SLOT; ++i) {
        if (i < tr)
          full[i * C + c] = to_f(st_in[slot + (size_t)i * C + c]);
        else if (lead)
          st_out[slot + (size_t)i * C + c] = st_in[slot + (size_t)i * C + c];
      }
    __syncthreads();
    if (stem_ln) ln_rows<W>(xs, T, C, wptr(0), wptr(1), sw0, sb0, red, lead ? x_out : nullptr);
    for (int c = tid; c < C; c += FT) {
      float wk[SLOT + 1];
#pragma unroll
      for (int j = 0; j < SLOT + 1; ++j) wk[j] = j < k ? to_f(__ldg(dw + j * C + c)) : 0.f;
      const float bias = to_f(__ldg(db + c));
      // block 0: the new tail rows, rows T .. T + tr - 1 of [tail; x]
      if (lead)
        for (int r = 0; r < tr; ++r)
          st_out[slot + (size_t)r * C + c] = from_f<S>(full[(T + r) * C + c]);
      // the depthwise conv in place, last row first: row t reads rows
      // t .. t + tr of [tail; x], none of them a row already replaced
      for (int t = T - 1; t >= 0; --t) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < SLOT + 1; ++j)
          if (j < k) acc += full[(t + j) * C + c] * wk[j];
        xs[t * C + c] = act<W>(acc + bias);
      }
    }
    ln_rows<W>(xs, T, C, lw, lb, lw0, lb0, red, nullptr);
  };

  // P: one block on rows x (T, C) with its tail slot at `slot` of the flat
  // states, its rows by the narrow or the wide path, then pw1 + bias and
  // exact GELU into g
  auto phase_p = [&](const float* x, int T, int C, long long slot, bool stem_ln,
                     float* x_out) {
    if (!owns() && !lead) return;
    if constexpr (WIDE)
      rows_p_wide(x, T, C, slot, stem_ln, x_out);
    else
      rows_p_narrow(x, T, C, slot, stem_ln, x_out);
    __syncthreads();
    const int hid = 4 * C;
    float* g = a.g;
    product(T, [&](int r, int n, float s, int j) {
      const float v = act<W>(s + ep[j]);
      g[r * hid + n] = act<W>(v * 0.5f * (1.f + erff(v * SQRT1_2)));
    });
  };

  // Q: g @ pw2 + bias, times gamma, plus x, into out (x itself, or z)
  auto phase_q = [&](const float* x, float* out, W* zout, int T, int C) {
    if (!owns()) return;
    const int n4 = T * C;  // float4s of the T hidden rows
    const float4* src = reinterpret_cast<const float4*>(a.g);
    float4* dst = reinterpret_cast<float4*>(xs);
#pragma unroll 4
    for (int i = tid; i < n4; i += FT) dst[i] = __ldcg(src + i);
    ep_load(vec(PF_V0), vec(PF_V1), x, T, C);
    __syncthreads();
    // a float32 z takes x's store: one epilogue, not two
    constexpr bool f32 = std::is_same<W, float>::value;
    float* to = f32 && zout != nullptr ? reinterpret_cast<float*>(zout) : out;
    W* zto = f32 ? nullptr : zout;
    product(T, [&](int r, int n, float s, int j) {
      const float v = act<W>(ep[(2 + r) * ec + j] + act<W>(ep[ec + j] * act<W>(s + ep[j])));
      if (zto != nullptr)
        zto[r * C + n] = from_f<W>(v);
      else
        to[r * C + n] = v;
    });
  };

  // M, D and L: the rows (T, C), normed by the stem LN and then by the
  // phase's LN (lw, lb) where given (at a narrow geometry in registers,
  // else through shared memory), viewed as (T / f, f C), times the phase's
  // matrix + bias b into out (N wide); L has no product and writes the
  // block's columns of the normed rows to z
  auto phase_lin = [&](const float* x, float* out, int T, int C, int f, bool stem_ln,
                       const W* lw, const W* lb, const W* b, int N, W* zout) {
    if (!owns()) return;
    float sw0 = 0.f, sb0 = 0.f, lw0, lb0;
    if (stem_ln) first_col<W>(wptr(0), wptr(1), C, sw0, sb0);
    first_col<W>(lw, lb, C, lw0, lb0);
    if constexpr (!WIDE) {
      const int c = tid;
      const bool on = c < C;
      float xv[RG];
#pragma unroll
      for (int t = 0; t < RG; ++t) xv[t] = on && t < T ? __ldcg(x + t * C + c) : 0.f;
      if (b != nullptr) ep_load(b, nullptr, nullptr, T, C);
      if (stem_ln) ln_cols<W>(xv, T, C, on, sw0, sb0, red);
      if (lw != nullptr) ln_cols<W>(xv, T, C, on, lw0, lb0, red);
      if (on)
#pragma unroll
        for (int t = 0; t < RG; ++t)
          if (t < T) xs[t * C + c] = xv[t];
    } else {
      if (b != nullptr) ep_load(b, nullptr, nullptr, T, C);
      load_rows(x, T, C);
      __syncthreads();
      if (stem_ln) ln_rows<W>(xs, T, C, wptr(0), wptr(1), sw0, sb0, red, nullptr);
      if (lw != nullptr) ln_rows<W>(xs, T, C, lw, lb, lw0, lb0, red, nullptr);
    }
    __syncthreads();
    if (zout != nullptr) {
      const int n0 = my[2 * ph] * 4, nc = ncols();
      for (int i = tid; i < T * nc; i += FT) {
        const int t = i / nc, n = n0 + i % nc;
        if (n < C) zout[t * C + n] = from_f<W>(xs[t * C + n]);
      }
      return;
    }
    product(T / f, [&](int r, int n, float s, int j) { out[r * N + n] = act<W>(s + ep[j]); });
  };

  stamp(0);
  // stem: im2col rows of [tail; mel] (thread c: input column c, ...), the
  // product + bias into xa.  Up to RG frames (every geometry whose
  // downsample product is at most 4) from registers, every load issued
  // before the first store; more frames load each further row as needed.
  {
    const long long* srec = a.tab + a.n_w;  // phase 0's record
    const int Cin = (int)srec[PF_C], kc = k * Cin, C0 = (int)srec[PF_N];
    if (owns() || lead) {
      ep_load(reinterpret_cast<const W*>(srec[PF_V0]), nullptr, nullptr, T0, C0);
      // row i of [tail; mel], read from the card's memory
      auto row_at = [&](int i, int c) {
        return i < tr ? to_f(st_in[(size_t)i * Cin + c]) : a.mel[(i - tr) * Cin + c];
      };
      for (int c = tid; c < Cin; c += FT) {
        float tv[SLOT], mv[RG], full[SLOT + RG];
#pragma unroll
        for (int i = 0; i < SLOT; ++i)
          tv[i] = i < tr || lead ? to_f(st_in[(size_t)i * Cin + c]) : 0.f;
#pragma unroll
        for (int t = 0; t < RG; ++t) mv[t] = t < T0 ? a.mel[t * Cin + c] : 0.f;
#pragma unroll
        for (int i = 0; i < SLOT + RG; ++i) {
          float v = i < SLOT ? tv[i] : 0.f;
#pragma unroll
          for (int t = 0; t < RG; ++t)
            if (i == tr + t) v = mv[t];
          full[i] = v;
        }
#pragma unroll
        for (int t = 0; t < RG; ++t)
#pragma unroll
          for (int j = 0; j < SLOT + 1; ++j)
            if (t < T0 && j < k) xs[t * kc + j * Cin + c] = full[t + j];
        if constexpr (WIDE)
          for (int t = RG; t < T0; ++t)
            for (int j = 0; j < k; ++j) xs[t * kc + j * Cin + c] = row_at(t + j, c);
        if (lead) {
          // the new tail slot: rows T0 .. T0 + tr - 1, then the kept rows
          if (!WIDE || T0 <= RG) {
#pragma unroll
            for (int i = 0; i < SLOT + RG; ++i) {
              const int r = i - T0;
              if (r >= 0 && r < tr) st_out[(size_t)r * Cin + c] = from_f<S>(full[i]);
            }
          } else {
            for (int r = 0; r < tr; ++r)
              st_out[(size_t)r * Cin + c] = from_f<S>(row_at(T0 + r, c));
          }
#pragma unroll
          for (int i = 0; i < SLOT; ++i)
            if (i >= tr) st_out[(size_t)i * Cin + c] = from_f<S>(tv[i]);
        }
      }
      __syncthreads();
      float* out = a.xa;
      product(T0, [&](int r, int n, float s, int j) { out[r * C0 + n] = act<W>(s + ep[j]); });
    }
  }
  end_phase(a.n_ph > 1);

  // every later phase from its record: one copy of each kind's code, warm
  // in the instruction cache after the kind's first phase
  float* cur = a.xa;
  float* oth = a.xb;
  auto swap_bufs = [&]() {
    float* s = cur;
    cur = oth;
    oth = s;
  };
  W* z = reinterpret_cast<W*>(a.z);
  int T = T0;
  for (int p = 1; p < a.n_ph; ++p) {
    const int kind = (int)rec(PF_KIND), C = (int)rec(PF_C), N = (int)rec(PF_N);
    const int flags = (int)rec(PF_FLAGS);
    const bool stem_ln = flags & FL_STEM_LN;
    if (kind == PH_P) {
      phase_p(cur, T, C, rec(PF_SLOT), stem_ln, oth);
      if (stem_ln) swap_bufs();
    } else if (kind == PH_Q) {
      phase_q(cur, cur, flags & FL_TO_Z ? z : nullptr, T, C);
    } else {  // M, D and L from one call site (one copy of the code)
      const bool last = kind == PH_L;
      const int f = (int)rec(PF_F);
      phase_lin(cur, oth, T, C, f, stem_ln, vec(PF_V0), vec(PF_V1), vec(PF_V2), N,
                last ? z : nullptr);
      if (!last) swap_bufs();
      T /= f;
    }
    end_phase(p + 1 < a.n_ph);
  }
}

template <typename W, typename S, bool WIDE>
int launch(const FrontArgs& a, int grid, cudaStream_t stream) {
  // shared memory (ops/convnext_enc.py `smem_bytes`): the table, the tail
  // rows, the rows, then the epilogue's inputs
  const size_t smem = 8 * (size_t)((a.n_w + PH_FIELDS * a.n_ph + 1) & ~1) +
                      sizeof(float) * ((size_t)SLOT * a.pre_c + (size_t)a.rows * a.max_k +
                                       (size_t)(2 + a.rows) * a.ep_cols);
  auto kern = front_kernel<W, S, WIDE>;
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
  void* args[] = {const_cast<FrontArgs*>(&a)};
  if ((e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(FT), args, smem,
                                       stream)) != cudaSuccess)
    return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int svd_convnext_enc_step(const void* tab, const int* ints, int n_w, int n_ph,
                                     const void* st_in, void* st_out, const void* mel, void* z,
                                     void* xa, void* xb, void* g, const void* plan, void* stamps,
                                     void* bar_count, int T, int k, int rows, int max_k,
                                     int pre_c, int ep_cols,
                                     int w_bf16, int s_bf16, int wide, int grid, void* stream) {
  if (n_w < 1 || n_ph < 1 || T < 1 || T > rows || rows % RG || k < 1 || k > SLOT + 1 ||
      max_k < 1 || pre_c < (wide ? 1 : 0) || ep_cols < 1)
    return (int)cudaErrorInvalidValue;
  FrontArgs a;
  a.tab = (const long long*)tab;
  a.st_in = st_in;
  a.st_out = st_out;
  a.mel = (const float*)mel;
  a.z = z;
  a.xa = (float*)xa;
  a.xb = (float*)xb;
  a.g = (float*)g;
  a.plan = (const int*)plan;
  a.stamps = (unsigned long long*)stamps;
  a.bar_count = (unsigned long long*)bar_count;
  a.T = T;
  a.k = k;
  a.n_w = n_w;
  a.n_ph = n_ph;
  a.rows = rows;
  a.max_k = max_k;
  a.pre_c = pre_c;
  a.ep_cols = ep_cols;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide) {
    if (w_bf16 && s_bf16) return launch<bf16, bf16, true>(a, grid, st);
    if (w_bf16) return launch<bf16, float, true>(a, grid, st);
    if (s_bf16) return launch<float, bf16, true>(a, grid, st);
    return launch<float, float, true>(a, grid, st);
  }
  if (rows != RG || pre_c > FT || ep_cols > FT || n_ph > PH_PARAMS)
    return (int)cudaErrorInvalidValue;
  memcpy(a.ints, ints, sizeof(int) * PH_INTS * n_ph);
  if (w_bf16 && s_bf16) return launch<bf16, bf16, false>(a, grid, st);
  if (w_bf16) return launch<bf16, float, false>(a, grid, st);
  if (s_bf16) return launch<float, bf16, false>(a, grid, st);
  return launch<float, float, false>(a, grid, st);
}
