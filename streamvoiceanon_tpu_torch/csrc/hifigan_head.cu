// The streaming HiFiGAN head at batch 1: conv_pre -> per stage
// [SiLU -> transposed upsample (k = 2 * stride) -> mean of the ResBlock
// branches, each dilations x (SiLU -> causal dilated conv -> SiLU -> causal
// dilated conv) with residual] -> SiLU -> conv_post -> tanh.  The port of
// `head_stream_step` in ops/pallas_hifigan.py of the JAX package; see
// streamvoiceanon_tpu_torch/ops/hifigan.py for the design note.
//
// One launch per dependency level, not per conv.  The level plan comes from
// ops/hifigan.py `_geometry` as plain integers: conv_pre; per stage the
// upsample, then 2 x dilations rounds, round r running conv r % 2 of
// dilation r / 2 of every ResBlock branch side by side; conv_post.  At the
// published geometry that is 37 launches for 97 convs.  Each branch keeps
// its own first-conv buffer C_b and running residual D_b, and its last conv
// leaves the branch's output in D_b; the next consumer (the next stage's
// upsample, or conv_post) averages the branches as it loads a row,
// ((D_0 + D_1) + D_2) / 3 in the plain version's order, then applies SiLU.
// A launch runs at most MAX_CONV convs: the plan gives a round of more
// branches several launches.  The raw loads of the first MAX_CONV D_b are
// in flight ahead of their chunk; a further D_b is read as its row is
// stored to shared memory.  That read is compiled only into the WIDE
// instantiations, launched for a level that averages more than MAX_CONV
// buffers, so the other levels (every level of the published three
// branches) run the same code as without it.
//
// `level_kernel<TM, TN, W, S, WIDE>` is an implicit-GEMM causal dilated conv on
// the CUDA cores in full float32 (no TF32).  Its blocks walk the level's work list:
// per conv, per TM x TN output tile, per K split (a tile's splits on
// consecutive blocks).  The plan gives each level the tile with the least
// padding: 16 x 64 at conv_pre and the first upsample (4 rows), 32 x 64 at
// the 32-row stage, 64 x 32 at the 16- and 32-channel stages, 64 x 64
// elsewhere.  Output row t reads rows t + j*d (j < k) of [old tail; x], so
// the im2col matrix is never built; the next K-chunk's raw loads are in
// flight while the current one is multiplied, and SiLU (and the branch
// mean) of x is applied as they are stored to shared memory; bias,
// residual add and tanh are fused into the epilogue, its loads issued
// before its stores.  The transposed upsample is the same conv with k = 2,
// d = 1 and a one-row tail: out[t*s + p] = in[t] . W[s+p] + in[t+1] . W[p]
// is a (T, s*C_out) product against [wa; wb] whose row-major result IS the
// de-interleaved (T*s, C_out) output.  Every conv also writes its new input
// tail (the last `rows` rows of [old tail; x]) into the separate output
// state, so no launch overwrites a tail it still reads.  Where a tile's K
// is split, each block stores its partial tile (element e of thread tid at
// e * NT + tid, so that a warp's accesses are contiguous), fences and takes
// a ticket on the tile; the last to arrive sums the partials in split
// order (so the result does not depend on block timing), runs the epilogue
// and sets the ticket back to zero for the next launch.  Splits aim at one
// wave of blocks a level: MIN_BLOCKS resident blocks a SM, 396 on 132 SMs.
//
// Levels are chained by programmatic dependent launch (PDL).  Before
// `pdl_wait` a block only loads its first K-chunk's weights, which no
// launch writes.  Everything else waits, because consecutive levels share
// it: the activations (a round reads C_b or D_b that the previous round
// wrote; a round rewrites D_b that the previous round read; an upsample
// rewrites B that the last rounds read), the split partials and the
// tickets (every level reuses them), and the state tails (the first level
// of a call reads the tails the previous call wrote).  Every block waits
// once, so a level ends only after the level before it has ended, and the
// wait also orders it after every earlier level and call.
//
// Element types.  The weights (and biases) are W and the state tails S,
// each float32 or bf16, as the JAX kernel takes them as given; every
// product accumulates in float32.  The activation buffers stay float32, but
// hold values of the JAX kernel's working type promote(W, S): where both
// are bf16 each rounding point of the plain version rounds to bf16 (`act`:
// a conv's output after the bias, the residual sum, the branch mean, SiLU),
// and tails are stored as S.  The input rows come rounded to W and the
// waveform is rounded to W by the wrapper (ops/hifigan.py).
//
// Plain C interface for ctypes.  `geo` is a HOST int array (written by
// ops/hifigan.py `_geometry`): a header of HDR ints, then per level LVL
// ints (conv count, tile rows, tile columns) and one record of NF ints per
// conv (the Field enum below).
// `w`, `st_in` and `st_out` are HOST arrays of DEVICE pointers:
//   w      : pre_w, pre_b, per stage (wa, wb, ub, rw, rb), post_w, post_b
//   st_in  : pre, per stage (ups, res), post      (PackedHeadState tails)
//   st_out : the same layout, written in full
// `x` (T0, num_mels) and `wav` (T0 * prod(rates)) are device pointers;
// `scratch` holds n_buf activation buffers of buf_elems floats, part_elems
// floats of split partials, then n_ticket ints that are zero between calls.
// `stamps` is null, or (levels, part_elems / PART, 4) device int64 that
// take each block's global times (`stamp`).
// Buffer ids in a record: 0 is x, 1 is wav, 2 + i scratch buffer i.
// `w_bf16` and `s_bf16` say whether W and S are bf16.
// Returns the first CUDA error of a launch (0 when all were accepted).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_common.cuh"

namespace {

using svd::bf16;
using svd::launch_pdl;
using svd::rnd;
using svd::to_f;
using svd::from_f;
using svd::pdl_launch_dependents;
using svd::pdl_wait;

constexpr int KC = 16;         // K rows per shared-memory chunk (mirrored in ops/hifigan.py)
constexpr int NT = 256;        // threads: 16 x 16, each (TM / 16) x (TN / 16) outputs
constexpr int MIN_BLOCKS = 3;  // resident blocks a SM: the register cap (TARGET_BLOCKS)
constexpr int PART = 4096;     // floats of split partial a block: the largest tile
constexpr int MAX_CONV = 4;    // convs in one launch, and D_b loaded ahead (mirrored)
constexpr int HDR = 5;         // header ints of `geo`: n_level, n_buf, buf_elems, part_elems, n_ticket
constexpr int LVL = 3;         // ints before a level's records: n_conv, TM, TN
// the tiles (TM, TN) a level may take, each for every (W, S): 16 x 64,
// 32 x 64, 64 x 64 and 64 x 32 (mirrored as TILES)

// one conv's record in `geo`, in order (mirrored as CONV_FIELDS)
enum Field {
  F_X, F_X_N, F_SILU, F_T, F_CIN, F_K, F_D, F_N, F_W, F_W_OFF, F_W2, F_B, F_B_OFF,
  F_BIAS_MOD, F_RESID, F_OUT, F_TANH, F_TAIL, F_TAIL_OFF, F_ROWS, F_ROWS_PAD,
  F_TILES_M, F_TILES_N, F_KSPLIT, F_PER, NF
};

template <typename W, typename S>
struct Conv {
  // promote(W, S) is bf16: the activations round to bf16
  static constexpr bool RB = std::is_same<W, bf16>::value && std::is_same<S, bf16>::value;
  static __device__ __forceinline__ float act(float v) { return RB ? rnd<bf16>(v) : v; }
  const S* tail;          // (rows_pad, Cin) old input tail; rows >= `rows` are kept
  S* new_tail;            // (rows_pad, Cin)
  int rows, rows_pad;
  const float* x;         // (T, Cin) new input rows: the mean of x_n buffers
  long x_stride;          // elements from one of those buffers to the next
  int x_n, silu;          // SiLU of x as it is read (a tail holds SiLU'd rows)
  int T, Cin, k, d, N;
  const W* w;             // (k*Cin, N) tap-major rows; with w2, tap 0 only
  const W* w2;            // (Cin, N) tap-1 rows of the upsample, or null
  const W* b;             // bias, b[n % bias_mod]
  int bias_mod;
  const float* resid;     // y += resid[t, n], or null
  float* out;             // (T, N)
  int tanh_out;
  int tiles_m, tiles_n, ksplit, per;  // output tiles; K-chunk splits, chunks per split
};

template <typename W, typename S>
struct Level {
  Conv<W, S> c[MAX_CONV];
  int n_conv;
  float* part;   // PART floats per block
  int* tickets;  // one per output tile of the level, zero between launches
  unsigned long long* stamps;  // (blocks, 4) global ns of this level, or null
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// with `stamps`: the card's global time where the block starts (point 0),
// starts its K loop after the wait and the tail (1), ends it (2) and exits (3)
template <typename Lv>
__device__ __forceinline__ void stamp(const Lv& L, int point) {
  if (L.stamps == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) L.stamps[blockIdx.x * 4 + point] = global_ns();
}

__device__ __forceinline__ float silu_f(float v) { return v / (1.f + expf(-v)); }

// An element of x from its raw loads v[m] (m < min(x_n, MAX_CONV)), with
// WIDE the buffers past MAX_CONV read here at element `o`: the branches'
// mean, summed in branch order and then divided as the plain version does,
// then SiLU, each rounded to the working type.
template <bool WIDE, typename Cv>
__device__ __forceinline__ float x_value(const Cv& a, const float (&v)[MAX_CONV], size_t o) {
  float s = v[0];
  if (a.x_n > 1) {
#pragma unroll
    for (int m = 1; m < MAX_CONV; ++m)
      if (m < a.x_n) s += v[m];
    if constexpr (WIDE)
      for (int m = MAX_CONV; m < a.x_n; ++m) s += a.x[m * a.x_stride + o];
    s = Cv::act(s / (float)a.x_n);
  }
  return a.silu ? Cv::act(silu_f(s)) : s;
}

template <typename Cv>
__device__ __forceinline__ void load_x(const Cv& a, size_t o, float (&v)[MAX_CONV]) {
#pragma unroll
  for (int m = 0; m < MAX_CONV; ++m)
    if (m < a.x_n) v[m] = a.x[m * a.x_stride + o];
}

// row r of [old tail; x], column c
template <bool WIDE, typename Cv>
__device__ __forceinline__ float full_at(const Cv& a, int r, int c) {
  if (r < a.rows) return to_f(a.tail[(size_t)r * a.Cin + c]);
  float v[MAX_CONV];
  const size_t o = (size_t)(r - a.rows) * a.Cin + c;
  load_x(a, o, v);
  return x_value<WIDE>(a, v, o);
}

template <int TM, int TN, typename W, typename S, bool WIDE>
struct Tile {
  using Cv = Conv<W, S>;
  using Lv = Level<W, S>;
  static constexpr int MI = TM / 16, NJ = TN / 16;  // outputs a thread: rows, columns
  static constexpr int AP = TM + 2;  // A tile row pitch: the stores hit 32 banks
  static_assert(TM * TN <= PART && TM % 16 == 0 && TN % 16 == 0, "tile");

  // The raw loads of this thread's MI A elements of K-chunk `ch`, rows of
  // [tail; x] at the taps: a tail value in ra[u][0], or the branch values
  // of an x row (bit u of `xrow`).  Nothing waits on them before they
  // are stored to shared memory, so all are in flight together.
  static __device__ __forceinline__ void load_a(const Cv& a, int ch, int m0, int K,
                                                int tid, float (&ra)[MI][MAX_CONV],
                                                unsigned& xrow) {
    const int k0 = ch * KC;
    xrow = 0;
#pragma unroll
    for (int u = 0; u < MI; ++u) {
      const int i = tid + u * NT;
      const int t = i / KC, kk = i % KC, k = k0 + kk, gt = m0 + t;
      ra[u][0] = 0.f;
      if (k < K && gt < a.T) {
        const int j = k / a.Cin, c = k - j * a.Cin, r = gt + j * a.d;
        if (r < a.rows) {
          ra[u][0] = to_f(a.tail[(size_t)r * a.Cin + c]);
        } else {
          xrow |= 1u << u;
          load_x(a, (size_t)(r - a.rows) * a.Cin + c, ra[u]);
        }
      }
    }
  }

  // The element of x that A element i (= tid + u * NT) of K-chunk `ch`
  // reads, for an x row (WIDE only).
  static __device__ __forceinline__ size_t x_off(const Cv& a, int ch, int m0, int i) {
    const int k = ch * KC + i % KC, j = k / a.Cin;
    return (size_t)(m0 + i / KC + j * a.d - a.rows) * a.Cin + (k - j * a.Cin);
  }

  // This thread's NJ B elements of K-chunk `ch`: weight rows.
  static __device__ __forceinline__ void load_b(const Cv& a, int ch, int n0, int K,
                                                int tid, float (&rb)[NJ]) {
    const int k0 = ch * KC;
#pragma unroll
    for (int u = 0; u < NJ; ++u) {
      const int i = tid + u * NT;
      const int kk = i / TN, nn = i % TN, k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < K && n < a.N) {
        const W* row = (a.w2 != nullptr && k >= a.Cin)
                           ? a.w2 + (size_t)(k - a.Cin) * a.N
                           : a.w + (size_t)k * a.N;
        v = to_f(__ldg(row + n));
      }
      rb[u] = v;
    }
  }

  // One block's work item of conv `a`: output tile `tile` (the level's tile
  // tile0 + tile), K split q.  Inlined once per conv slot of the level, so
  // that every field of `a` is a fixed offset in the launch's parameters.
  static __device__ __forceinline__ void conv_block(const Cv& a, const Lv& L, int b,
                                                    int tile0, float (&As)[KC][AP],
                                                    float (&Bs)[KC][TN], int& am_last) {
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q = b % a.ksplit, tile = b / a.ksplit;
    const int m0 = (tile / a.tiles_n) * TM, n0 = (tile % a.tiles_n) * TN;
    const int K = a.k * a.Cin;
    const int nch = (K + KC - 1) / KC;
    const int c0 = q * a.per, c1 = min(nch, c0 + a.per);

    stamp(L, 0);
    float ra[MI][MAX_CONV], rb[NJ];
    unsigned xrow;
    load_b(a, c0, n0, K, tid, rb);  // weights: no launch writes them
    pdl_wait();
    pdl_launch_dependents();
    load_a(a, c0, m0, K, tid, ra, xrow);

    // the new tail: rows T .. T+rows of [old tail; x], then the kept rows;
    // shared by the conv's blocks
    {
      const int nb = a.tiles_m * a.tiles_n * a.ksplit;
      const int total = a.rows_pad * a.Cin;
      for (int i = b * NT + tid; i < total; i += nb * NT) {
        const int r = i / a.Cin, c = i - r * a.Cin;
        a.new_tail[i] = r < a.rows ? from_f<S>(full_at<WIDE>(a, a.T + r, c)) : a.tail[i];
      }
    }

    stamp(L, 1);
    // partial products over this block's K-chunks, the next chunk's loads
    // in flight while the current one is multiplied; thread (ty, tx) owns
    // rows ty + 16 i and columns tx + 16 j of the tile
    float acc[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    for (int ch = c0; ch < c1; ++ch) {
#pragma unroll
      for (int u = 0; u < MI; ++u) {
        const int i = tid + u * NT;
        As[i % KC][i / KC] =
            xrow >> u & 1 ? x_value<WIDE>(a, ra[u], WIDE ? x_off(a, ch, m0, i) : 0) : ra[u][0];
      }
#pragma unroll
      for (int u = 0; u < NJ; ++u) {
        const int i = tid + u * NT;
        Bs[i / TN][i % TN] = rb[u];
      }
      __syncthreads();
      if (ch + 1 < c1) {
        load_a(a, ch + 1, m0, K, tid, ra, xrow);
        load_b(a, ch + 1, n0, K, tid, rb);
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float av[MI], bv[NJ];
#pragma unroll
        for (int i = 0; i < MI; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    stamp(L, 2);
    if (a.ksplit > 1) {
      // K split: store the partial (element e of every thread at e * NT +
      // tid, so that a warp's stores and loads are contiguous; the rows past
      // T left out), then the last block of the tile to arrive sums the
      // splits in order, two splits' loads in flight at a time
      float* pb = L.part + (size_t)blockIdx.x * PART + tid;
#pragma unroll
      for (int i = 0; i < MI; ++i)
        if (m0 + ty + 16 * i < a.T)
#pragma unroll
          for (int j = 0; j < NJ; ++j) pb[(i * NJ + j) * NT] = acc[i][j];
      __threadfence();
      __syncthreads();
      if (tid == 0) am_last = atomicAdd(&L.tickets[tile0 + tile], 1) == a.ksplit - 1;
      __syncthreads();
      if (!am_last) {
        stamp(L, 3);
        return;
      }
      const float* p0 = L.part + (size_t)(blockIdx.x - q) * PART + tid;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < a.ksplit; s += 2) {
        const bool two = s + 1 < a.ksplit;
        const float* ps = p0 + (size_t)s * PART;
        float v[2][MI][NJ];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          if (m0 + ty + 16 * i < a.T)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              v[0][i][j] = __ldcg(ps + (i * NJ + j) * NT);
              if (two) v[1][i][j] = __ldcg(ps + PART + (i * NJ + j) * NT);
            }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < MI; ++i)
            if (m0 + ty + 16 * i < a.T && (h == 0 || two))
#pragma unroll
              for (int j = 0; j < NJ; ++j) acc[i][j] += v[h][i][j];
      }
      if (tid == 0) L.tickets[tile0 + tile] = 0;  // ready for the next launch
    }

    // epilogue: bias, residual and tanh; every load first, so that none
    // waits behind a store
    float bias[NJ], res[MI][NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + tx + 16 * j;
      bias[j] = n < a.N ? to_f(a.b[n % a.bias_mod]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int t = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        res[i][j] =
            a.resid != nullptr && t < a.T && n < a.N ? a.resid[(size_t)t * a.N + n] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int t = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        if (t >= a.T || n >= a.N) continue;
        float y = Cv::act(acc[i][j] + bias[j]);
        if (a.resid != nullptr) y = Cv::act(y + res[i][j]);
        if (a.tanh_out) y = tanhf(y);
        a.out[(size_t)t * a.N + n] = y;
      }
    stamp(L, 3);
  }
};

template <int TM, int TN, typename W, typename S, bool WIDE>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    level_kernel(const __grid_constant__ Level<W, S> L) {
  using Tl = Tile<TM, TN, W, S, WIDE>;
  static_assert(TM * KC % NT == 0 && KC * TN % NT == 0, "whole loads per thread");
  __shared__ float As[KC][Tl::AP];
  __shared__ float Bs[KC][TN];
  __shared__ int am_last;
  // this block's work item: the level's convs in order, each its tiles,
  // each tile its K splits
  int b = blockIdx.x, tile0 = 0;
#pragma unroll
  for (int ci = 0; ci < MAX_CONV; ++ci) {
    const Conv<W, S>& c = L.c[ci];
    const int nb = c.tiles_m * c.tiles_n * c.ksplit;
    if (ci == L.n_conv - 1 || b < nb) {
      Tl::conv_block(c, L, b, tile0, As, Bs, am_last);
      return;
    }
    b -= nb;
    tile0 += c.tiles_m * c.tiles_n;
  }
}

template <typename W, typename S, bool WIDE>
cudaError_t launch_tile(int tm, int tn, int blocks, cudaStream_t st, const Level<W, S>& L) {
  const dim3 g(blocks), t(NT);
  if (tm == 16 && tn == 64) return launch_pdl(level_kernel<16, 64, W, S, WIDE>, g, t, st, L);
  if (tm == 32 && tn == 64) return launch_pdl(level_kernel<32, 64, W, S, WIDE>, g, t, st, L);
  if (tm == 64 && tn == 64) return launch_pdl(level_kernel<64, 64, W, S, WIDE>, g, t, st, L);
  if (tm == 64 && tn == 32) return launch_pdl(level_kernel<64, 32, W, S, WIDE>, g, t, st, L);
  return cudaErrorInvalidValue;
}

// the WIDE instantiation where a conv of the level averages more than
// MAX_CONV buffers
template <typename W, typename S>
cudaError_t launch_level(int tm, int tn, int blocks, bool wide, cudaStream_t st,
                         const Level<W, S>& L) {
  return wide ? launch_tile<W, S, true>(tm, tn, blocks, st, L)
              : launch_tile<W, S, false>(tm, tn, blocks, st, L);
}

template <typename W, typename S>
int run(const int* geo, const void* const* w, const void* const* st_in, void* const* st_out,
        const void* x, void* wav, void* scratch, void* stamps, cudaStream_t st) {
  const int n_level = geo[0], n_buf = geo[1];
  const long buf_elems = geo[2], part_elems = geo[3];
  float* bufs = (float*)scratch;
  float* part = bufs + n_buf * buf_elems;
  int* tickets = (int*)(part + part_elems);
  auto buf = [&](int id) -> float* {
    if (id < 0) return nullptr;
    if (id == 0) return (float*)x;
    if (id == 1) return (float*)wav;
    return bufs + (id - 2) * buf_elems;
  };
  int p = HDR;
  for (int l = 0; l < n_level; ++l) {
    Level<W, S> L = {};
    L.n_conv = geo[p];
    const int tm = geo[p + 1], tn = geo[p + 2];
    p += LVL;
    L.part = part;
    L.tickets = tickets;
    if (stamps != nullptr)
      L.stamps = (unsigned long long*)stamps + (size_t)l * (part_elems / PART) * 4;
    int blocks = 0;
    bool wide = false;
    for (int i = 0; i < L.n_conv; ++i, p += NF) {
      const int* f = geo + p;
      Conv<W, S>& a = L.c[i];
      a.tail = (const S*)st_in[f[F_TAIL]] + f[F_TAIL_OFF];
      a.new_tail = (S*)st_out[f[F_TAIL]] + f[F_TAIL_OFF];
      a.rows = f[F_ROWS];
      a.rows_pad = f[F_ROWS_PAD];
      a.x = buf(f[F_X]);
      a.x_stride = buf_elems;
      a.x_n = f[F_X_N];
      wide |= a.x_n > MAX_CONV;
      a.silu = f[F_SILU];
      a.T = f[F_T];
      a.Cin = f[F_CIN];
      a.k = f[F_K];
      a.d = f[F_D];
      a.N = f[F_N];
      a.w = (const W*)w[f[F_W]] + f[F_W_OFF];
      a.w2 = f[F_W2] < 0 ? nullptr : (const W*)w[f[F_W2]];
      a.b = (const W*)w[f[F_B]] + f[F_B_OFF];
      a.bias_mod = f[F_BIAS_MOD];
      a.resid = buf(f[F_RESID]);
      a.out = buf(f[F_OUT]);
      a.tanh_out = f[F_TANH];
      a.tiles_m = f[F_TILES_M];
      a.tiles_n = f[F_TILES_N];
      a.ksplit = f[F_KSPLIT];
      a.per = f[F_PER];
      blocks += a.tiles_m * a.tiles_n * a.ksplit;
    }
    const cudaError_t e = launch_level<W, S>(tm, tn, blocks, wide, st, L);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int svd_hifigan_head_step(const int* geo, const void* const* w,
                                     const void* const* st_in, void* const* st_out,
                                     const void* x, void* wav, int n_geo, void* scratch,
                                     void* stamps, int w_bf16, int s_bf16, void* stream) {
  if (n_geo < HDR) return (int)cudaErrorInvalidValue;
  // the level records must fill `geo` exactly
  int p = HDR;
  for (int l = 0; l < geo[0]; ++l) {
    if (p + LVL > n_geo || geo[p] < 1 || geo[p] > MAX_CONV) return (int)cudaErrorInvalidValue;
    p += LVL + geo[p] * NF;
  }
  if (p != n_geo) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (w_bf16 && s_bf16) return run<bf16, bf16>(geo, w, st_in, st_out, x, wav, scratch, stamps, st);
  if (w_bf16) return run<bf16, float>(geo, w, st_in, st_out, x, wav, scratch, stamps, st);
  if (s_bf16) return run<float, bf16>(geo, w, st_in, st_out, x, wav, scratch, stamps, st);
  return run<float, float>(geo, w, st_in, st_out, x, wav, scratch, stamps, st);
}
