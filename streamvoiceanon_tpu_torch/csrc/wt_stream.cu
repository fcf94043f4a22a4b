// The windowed-transformer ring step at batch 1: one new token through the
// L layers (RMSNorm -> QKV -> RoPE -> attention over the circular ring ->
// wo with LayerScale -> RMSNorm -> SwiGLU -> w2 with LayerScale) against a
// flat (L, W, dim) KV ring whose keys carry absolute RoPE.  The port of
// `wt_stream_step` in ops/pallas_wt_stream.py of the JAX package; see
// streamvoiceanon_tpu_torch/ops/wt_stream.py for the design note.
//
// One cooperative launch a token, one block per SM.  The TPU kernel runs the
// layers in program order on one core; here the grid runs them together and
// waits at a grid barrier (decode_common.cuh `count_barrier`) wherever a
// phase reads what another block wrote.  Five phases a layer, 5 L - 1
// barriers a call:
//
//   A  RMSNorm(h) (each block from the whole row), qkv for the block's
//      columns; q and k roped in float32 and rounded to W; the fresh k and
//      v rows written into the ring at slot = count % W
//   B  attention, one work item (head, split of W / n_split old slots) at a
//      time, items dealt round robin over the blocks: each writes its max,
//      its sum of exp and its unnormalised value sums (split 0 also the
//      fresh row's score) to `part`
//   C  every block that owns wo columns merges all items of every head in
//      split order, then the fresh row, into the attention row (rounded to
//      W), then wo for its columns and the LayerScale residual into h
//   D  RMSNorm(h), w1 and w3 for the block's columns, the SwiGLU gate
//   E  w2 for the block's columns and the LayerScale residual into h
//
// Each block owns fixed runs of 16-byte column units of every matvec phase
// (ops/wt_stream.py `work_plan`) and sums each column over the whole K in a
// fixed order (decode_common.cuh `matvec_tasks`): no split-K partials, and
// no result depends on block timing.  The weights come packed, each unit's
// K x 16-byte slice contiguous.
//
// What each barrier guards (all are needed; the model in
// tests/test_torch_ring_plan.py reads only a snapshot taken at each):
//   A -> B  B reads q and the fresh k (qkv) that A's owners wrote;
//   B -> C  C reads every item's partial; A's reads of h (the norm) are done
//           before C's owners overwrite h;
//   C -> D  D's norm reads the whole h that C's owners wrote;
//   D -> E  E reads the whole gate; D's reads of h are done before E writes;
//   E -> A  the next layer's norm reads the whole h that E's owners wrote.
// The old ring rows that B reads are never written in a call (the one row
// written is at `slot`, which B skips), and the weights never are.  Data
// that other blocks wrote during the launch is read with ld.global.cg (L2).
//
// A phase loads its weights and ring rows after the barrier before it,
// 16 bytes a lane, PK_DEPTH loads in flight.  Copying them earlier was
// measured slower or no faster on the H100 (PERF.md §6): bulk copies (TMA)
// into shared memory one phase ahead slowed the phases they ran beside,
// and loads issued before a barrier made the barrier's release and acquire
// wait for them.
//
// Rounding follows the TPU kernel: qkv rounded to W; q and k roped in
// float32 from the signed row (x * cos + partner(x) * sin) and rounded to
// W; the query then rounded to the ring type C; score products rounded to C
// and summed in float32; the written old slots (< min(count, W), not the
// current one) and the fresh row under one max and one denominator (split
// maxima rescaled to the common one); the value mix divided by the
// denominator after and rounded to W; residual adds rounded to W; SiLU in
// float32.
//
// Plain C interface for ctypes.  Every pointer is a device pointer; the
// caller allocates outputs and scratch.  `x` is the input row (only read),
// `h` the output row (final norm not applied); the fresh K/V rows are
// written into the rings in place.  `cosr`/`sinr` are row p of the signed
// RoPE tables.  Returns a CUDA error code: 0 when the launch was accepted,
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident at
// once (it is never shrunk).

#include "decode_common.cuh"

using namespace svd;

namespace {

constexpr int RS_THREADS = PK_THREADS;
constexpr int RS_WARPS = PK_WARPS;
constexpr int RS_NPH = 4;    // plan columns: qkv, wo, w1/w3, w2 (ops/wt_stream.py PHASES)
constexpr int RS_PART = 4;   // an item's partial: max, sum of exp, fresh score, 0, value sums
constexpr int RS_MAXD = 128; // head_dim
constexpr int RS_ROWS = 2;   // slots a warp scores at once

template <typename W, typename C>
struct RingArgs {
  const W* x;           // (dim) the input row
  W* h;                 // (dim) the running row, the output
  const W* wqkv;        // packed (L, 3 dim / VEC, dim, VEC)
  const W* wo;          // packed (L, dim / VEC, dim, VEC)
  const W* w1;          // packed (L, inter / VEC, dim, VEC)
  const W* w3;
  const W* w2;          // packed (L, dim / VEC, inter, VEC)
  const W* anorm;       // (L, dim)
  const W* fnorm;
  const W* ascale;      // (L, dim) LayerScales
  const W* fscale;
  C* kr;                // (L, Wn, dim) rings
  C* vr;
  const float* cosr;    // (dim) row p of the signed RoPE tables
  const float* sinr;
  const int* plan;      // (grid, 2 RS_NPH): per phase (first unit, units)
  W* qkv;               // (3 dim) roped q, roped k, v
  W* gate;              // (inter)
  float* part;          // (n_head n_split, ps) the attention items' partials
  unsigned long long* stamps;     // (5 L, grid, 2) global ns, or null
  unsigned long long* bar_count;  // count_barrier's arrivals
  int L, dim, n_head, head_dim, inter, Wn, count, n_split, span, ps;
  float eps, scale;
};

template <typename W, typename C>
__global__ void __launch_bounds__(RS_THREADS, 1) ring_step_kernel(const RingArgs<W, C> a) {
  constexpr int VEC = Vec<W>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dim = a.dim, hd = a.head_dim, inter = a.inter, Wn = a.Wn, ps = a.ps;
  const int slot = a.count % Wn, nv = min(a.count, Wn);
  const int n_item = a.n_head * a.n_split;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // (max(dim, inter)) a phase's input row
  float* mp = xs + max(dim, inter);              // (n_item ps) the partials, in C
  float* hs = mp + n_item * ps;                  // (dim) the block's columns of h, old
  float* qn = hs + dim;                          // (2 hd) an item's query and fresh key
  float* sc = qn + 2 * hd;                       // (span) an item's scores, then weights
  float* vred = sc + a.span;                     // (RS_THREADS) value sums by slot group
  __shared__ float red[RS_WARPS * 8];
  __shared__ float scal[32];

  // with `stamps`: each block's global time where it enters and leaves
  // every phase
  int ph = 0;
  auto stamp = [&](int k) {
    if (a.stamps != nullptr && tid == 0)
      a.stamps[((size_t)ph * gridDim.x + blockIdx.x) * 2 + k] = global_ns();
  };
  auto end_phase = [&](bool barrier) {
    __syncthreads();
    stamp(1);
    ++ph;
    if (barrier) {
      count_barrier(a.bar_count);
      stamp(0);
    }
  };
  const int* my = a.plan + blockIdx.x * 2 * RS_NPH;
  const int u_qkv = my[0], n_qkv = my[1], u_wo = my[2], n_wo = my[3];
  const int u_13 = my[4], n_13 = my[5], u_w2 = my[6], n_w2 = my[7];

  // h += LayerScale * product, rounded to W, in the columns of a unit run
  // from u0; hs holds those columns of h as the phase found them
  auto resid = [&](int u0, const W* scale) {
    return [&, u0, scale](int u, int v, auto sm) {
      const int c = (u0 + u) * VEC + v;
      a.h[c] = from_f<W>(hs[u * VEC + v] + rnd<W>(to_f<W>(__ldg(scale + c)) * rnd<W>(sm(0, v))));
    };
  };

  stamp(0);
  for (int l = 0; l < a.L; ++l) {
    const size_t ld = (size_t)l * dim;
    C* krl = a.kr + (size_t)l * Wn * dim;
    C* vrl = a.vr + (size_t)l * Wn * dim;

    // A: RMSNorm, qkv; q and k roped, the fresh k and v into the ring
    if (n_qkv > 0) {
      norm_row<W>(l == 0 ? a.x : a.h, l > 0, a.anorm + ld, dim, a.eps, xs, scal);
      const W* wl = a.wqkv + ld * 3 * dim;
      matvec_tasks<W, 1>(xs, dim, n_qkv, red, [&](int t) {
        return reinterpret_cast<const uint4*>(wl + (size_t)(u_qkv + t) * dim * VEC);
      }, [&](int u, int v, auto sm) {
        const int c = (u_qkv + u) * VEC + v;
        const float val = rnd<W>(sm(0, v));
        if (c >= 2 * dim) {
          a.qkv[c] = from_f<W>(val);
          vrl[(size_t)slot * dim + c - 2 * dim] = from_f<C>(val);
          return;
        }
        const int cc = c < dim ? c : c - dim;  // the partner is column cc ^ 1
        const float r =
            rnd<W>(val * __ldg(a.cosr + cc) + rnd<W>(sm(0, v ^ 1)) * __ldg(a.sinr + cc));
        a.qkv[c] = from_f<W>(r);
        if (c >= dim) krl[(size_t)slot * dim + cc] = from_f<C>(r);
      });
    }
    end_phase(true);

    // B: attention items (head, split); the old slots of a split that are
    // written and not the current one
    for (int it = blockIdx.x; it < n_item; it += gridDim.x) {
      const int hh = it / a.n_split, j0 = (it % a.n_split) * a.span;
      const int j1 = min(Wn, j0 + a.span);
      for (int d = tid; d < hd; d += RS_THREADS) {
        qn[d] = rnd<C>(ld_cg(a.qkv + hh * hd + d));
        qn[hd + d] = rnd<C>(ld_cg(a.qkv + dim + hh * hd + d));
      }
      __syncthreads();
      // scores: a warp a slot, RS_ROWS slots at once, lanes across the head
      for (int jb = j0 + warp; jb < j1; jb += RS_ROWS * RS_WARPS) {
        float p[RS_ROWS];
#pragma unroll
        for (int r = 0; r < RS_ROWS; ++r) {
          const int j = jb + r * RS_WARPS;
          p[r] = 0.f;
          if (j < j1 && j < nv && j != slot) {
            const C* krow = krl + (size_t)j * dim + hh * hd;
#pragma unroll
            for (int i = 0; i < RS_MAXD / 32; ++i) {
              const int d = lane + 32 * i;
              if (d < hd) p[r] += rnd<C>(qn[d] * to_f<C>(krow[d]));
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RS_ROWS; ++r) {
          const int j = jb + r * RS_WARPS;
          const float sum = warp_sum(p[r]);
          if (lane == 0 && j < j1)
            sc[j - j0] = j < nv && j != slot ? sum * a.scale : -CUDART_INF_F;
        }
      }
      float s_new = 0.f;  // the fresh row's score, in the last warp
      if (warp == RS_WARPS - 1) {
        for (int d = lane; d < hd; d += 32) s_new += rnd<C>(qn[d] * qn[hd + d]);
        s_new = warp_sum(s_new) * a.scale;
      }
      __syncthreads();
      // the split's max (-inf when no slot is valid), exp and sum
      float m = -CUDART_INF_F;
      for (int j = tid; j < j1 - j0; j += RS_THREADS) m = fmaxf(m, sc[j]);
      m = block_reduce<true>(m, scal, tid, RS_THREADS);
      float s = 0.f;
      for (int j = tid; j < j1 - j0; j += RS_THREADS) {
        const float e = sc[j] == -CUDART_INF_F ? 0.f : expf(sc[j] - m);
        sc[j] = e;
        s += e;
      }
      s = block_reduce<false>(s, scal, tid, RS_THREADS);
      // value sums: thread (group g, dim d), slots j0 + g, j0 + g + ng, ..;
      // then the groups in order
      const int ng = RS_THREADS / hd, g = tid / hd, d = tid % hd;
      if (g < ng) {
        float acc = 0.f;
        for (int jb = j0 + g; jb < j1; jb += 4 * ng) {
          float vv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = jb + r * ng;
            vv[r] = j < j1 && j < nv && j != slot
                        ? to_f<C>(vrl[(size_t)j * dim + hh * hd + d]) : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (jb + r * ng < j1) acc = fmaf(sc[jb + r * ng - j0], vv[r], acc);
        }
        vred[g * hd + d] = acc;
      }
      __syncthreads();
      float* pt = a.part + (size_t)it * ps;
      for (int dd = tid; dd < hd; dd += RS_THREADS) {
        float x = 0.f;
        for (int gg = 0; gg < ng; ++gg) x += vred[gg * hd + dd];
        pt[RS_PART + dd] = x;
      }
      if (tid == 0) {
        pt[0] = m;
        pt[1] = s;
        pt[3] = 0.f;
      }
      if (tid == (RS_WARPS - 1) * 32) pt[2] = s_new;
      __syncthreads();  // before the next item reuses qn, sc and vred
    }
    end_phase(true);

    // C: merge every head's items in split order, then the fresh row; wo
    if (n_wo > 0) {
      const float4* src = reinterpret_cast<const float4*>(a.part);
      float4* dst = reinterpret_cast<float4*>(mp);
      for (int i = tid; i < n_item * ps / 4; i += RS_THREADS) dst[i] = __ldcg(src + i);
      for (int i = tid; i < n_wo * VEC; i += RS_THREADS)
        hs[i] = l == 0 ? to_f<W>(__ldg(a.x + u_wo * VEC + i)) : ld_cg(a.h + u_wo * VEC + i);
      float vn[PK_ROW];
      load_row<W>(a.qkv + 2 * dim, true, dim, vn);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < PK_ROW; ++r) {
        const int c = tid + r * RS_THREADS;
        if (c >= dim) break;
        const int hh = c / hd, d = c % hd;
        const float* pp = mp + (size_t)hh * a.n_split * ps;
        const float s_new = pp[2];
        float mx = s_new;
        for (int i = 0; i < a.n_split; ++i) mx = fmaxf(mx, pp[i * ps]);
        float den = 0.f, acc = 0.f;
        for (int i = 0; i < a.n_split; ++i) {
          const float mi = pp[i * ps];
          if (mi == -CUDART_INF_F) continue;  // no valid slot: nothing to add
          const float w = expf(mi - mx);
          den += pp[i * ps + 1] * w;
          acc += pp[i * ps + RS_PART + d] * w;
        }
        const float en = expf(s_new - mx);
        den += en;
        acc += en * vn[r];
        xs[c] = rnd<W>(acc / den);
      }
      __syncthreads();
      const W* wl = a.wo + ld * dim;
      matvec_tasks<W, 1>(xs, dim, n_wo, red, [&](int t) {
        return reinterpret_cast<const uint4*>(wl + (size_t)(u_wo + t) * dim * VEC);
      }, resid(u_wo, a.ascale + ld));
    }
    end_phase(true);

    // D: RMSNorm, w1 and w3, the SwiGLU gate
    if (n_13 > 0) {
      norm_row<W>(a.h, true, a.fnorm + ld, dim, a.eps, xs, scal);
      const W* w1l = a.w1 + ld * inter;
      const W* w3l = a.w3 + ld * inter;
      matvec_tasks<W, 2>(xs, dim, n_13, red, [&](int t) {
        return reinterpret_cast<const uint4*>(((t & 1) ? w3l : w1l) +
                                              (size_t)(u_13 + t / 2) * dim * VEC);
      }, [&](int u, int v, auto sm) {
        const float x = rnd<W>(sm(0, v));
        const float silu = x / (1.f + expf(-x));
        a.gate[(u_13 + u) * VEC + v] = from_f<W>(rnd<W>(silu) * rnd<W>(sm(1, v)));
      });
    }
    end_phase(true);

    // E: w2 and the residual
    if (n_w2 > 0) {
      for (int i = tid; i < n_w2 * VEC; i += RS_THREADS) hs[i] = ld_cg(a.h + u_w2 * VEC + i);
      float gv[PK_ROW];
      load_row<W>(a.gate, true, inter, gv);
#pragma unroll
      for (int r = 0; r < PK_ROW; ++r)
        if (tid + r * RS_THREADS < inter) xs[tid + r * RS_THREADS] = gv[r];
      __syncthreads();
      const W* wl = a.w2 + (size_t)l * inter * dim;
      matvec_tasks<W, 1>(xs, inter, n_w2, red, [&](int t) {
        return reinterpret_cast<const uint4*>(wl + (size_t)(u_w2 + t) * inter * VEC);
      }, resid(u_w2, a.fscale + ld));
    }
    end_phase(l + 1 < a.L);
  }
}

// shared memory of a block, floats (ops/wt_stream.py `smem_bytes`)
inline size_t smem_floats(int dim, int inter, int hd, int n_item, int ps, int span) {
  return (size_t)max(dim, inter) + (size_t)n_item * ps + dim + 2 * hd + span + RS_THREADS;
}

template <typename W, typename C>
cudaError_t launch(const RingArgs<W, C>& a, int grid, cudaStream_t st) {
  auto kern = ring_step_kernel<W, C>;
  const size_t smem = 4 * smem_floats(a.dim, a.inter, a.head_dim, a.n_head * a.n_split,
                                      a.ps, a.span);
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, RS_THREADS, smem)) !=
      cudaSuccess)
    return e;
  // one block per SM, all resident at once, or no launch
  if (grid != sms || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<RingArgs<W, C>*>(&a)};
  if ((e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(RS_THREADS), args,
                                       smem, st)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

template <typename W, typename C>
int run(const void* x, void* h, const void* wqkv, const void* wo, const void* w1,
        const void* w3, const void* w2, const void* anorm, const void* fnorm,
        const void* ascale, const void* fscale, void* k_ring, void* v_ring,
        const void* cosr, const void* sinr, const void* plan, void* qkv, void* gate,
        void* part, void* stamps, void* bar_count, int grid, int count, int L, int dim,
        int n_head, int head_dim, int inter, int Wn, int n_split, int span, float eps,
        float scale, void* stream) {
  constexpr int VEC = Vec<W>::N;
  RingArgs<W, C> a;
  a.x = (const W*)x;
  a.h = (W*)h;
  a.wqkv = (const W*)wqkv;
  a.wo = (const W*)wo;
  a.w1 = (const W*)w1;
  a.w3 = (const W*)w3;
  a.w2 = (const W*)w2;
  a.anorm = (const W*)anorm;
  a.fnorm = (const W*)fnorm;
  a.ascale = (const W*)ascale;
  a.fscale = (const W*)fscale;
  a.kr = (C*)k_ring;
  a.vr = (C*)v_ring;
  a.cosr = (const float*)cosr;
  a.sinr = (const float*)sinr;
  a.plan = (const int*)plan;
  a.qkv = (W*)qkv;
  a.gate = (W*)gate;
  a.part = (float*)part;
  a.stamps = (unsigned long long*)stamps;
  a.bar_count = (unsigned long long*)bar_count;
  a.L = L;
  a.dim = dim;
  a.n_head = n_head;
  a.head_dim = head_dim;
  a.inter = inter;
  a.Wn = Wn;
  a.count = count;
  a.n_split = n_split;
  a.span = span;
  a.ps = (head_dim + RS_PART + 3) / 4 * 4;
  a.eps = eps;
  a.scale = scale;
  if (L < 1 || head_dim > RS_MAXD || (head_dim & 1) || n_head * head_dim != dim ||
      dim % VEC || inter % VEC || max(dim, inter) > PK_ROW * PK_THREADS || Wn < 1 ||
      n_split < 1 || span < 1 || n_split * span < Wn || count < 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch<W, C>(a, grid, (cudaStream_t)stream);
}

}  // namespace

// wdtype / rdtype: 0 = float32, 1 = bfloat16
extern "C" int svd_wt_stream_step(
    int wdtype, int rdtype, const void* x, void* h, const void* wqkv, const void* wo,
    const void* w1, const void* w3, const void* w2, const void* anorm, const void* fnorm,
    const void* ascale, const void* fscale, void* k_ring, void* v_ring, const void* cosr,
    const void* sinr, const void* plan, void* qkv, void* gate, void* part, void* stamps,
    void* bar_count, int grid, int count, int L, int dim, int n_head, int head_dim,
    int inter, int Wn, int n_split, int span, float eps, float scale, void* stream) {
#define SVD_RUN(W, C)                                                                    \
  return run<W, C>(x, h, wqkv, wo, w1, w3, w2, anorm, fnorm, ascale, fscale, k_ring,      \
                   v_ring, cosr, sinr, plan, qkv, gate, part, stamps, bar_count, grid,    \
                   count, L, dim, n_head, head_dim, inter, Wn, n_split, span, eps, scale, \
                   stream)
  if (wdtype == 0 && rdtype == 0) SVD_RUN(float, float);
  if (wdtype == 0 && rdtype == 1) SVD_RUN(float, bf16);
  if (wdtype == 1 && rdtype == 0) SVD_RUN(bf16, float);
  if (wdtype == 1 && rdtype == 1) SVD_RUN(bf16, bf16);
#undef SVD_RUN
  return (int)cudaErrorInvalidValue;
}
