// The dual-AR fast codebook loop at batch 1: nq autoregressive steps through
// the L fast layers with a fresh nq-slot KV scratch, each step sampling one
// code and feeding its fast embedding back in, plus the next frame's audio
// embedding (the sum of the sampled codes' codebook rows).  The port of
// `fast_decode` in ops/pallas_fast_decode.py of the JAX package; see
// streamvoiceanon_tpu_torch/ops/fast_decode.py for the design note.
//
// Plain C interface for ctypes.  Every pointer is a device pointer; the
// caller allocates outputs and scratch, and `h` holds the projected frame
// latent in the weight type on entry.  Returns the first CUDA error of a
// launch (0 when all launches were accepted).

#include "decode_common.cuh"

using namespace svd;

namespace {

template <typename W>
cudaError_t fast_loop(W* h, const float* gumbel, const W* wqkv, const W* wo,
                      const W* w1, const W* w3, const W* w2, const W* anorm,
                      const W* fnorm, const W* onorm, const W* wout, const W* emb,
                      const W* cbemb, const float* freqs, int* codes, W* aemb, W* kc,
                      W* vc, W* qkv, W* attn, W* gate, float* logits, float* partials,
                      int* counters, int L, int nq, int dim, int n_head, int head_dim,
                      int inter, int V, int mdim, float eps, float temperature,
                      float top_p, int greedy, cudaStream_t st) {
  cudaError_t e;
#define SVD_TRY(call) \
  if ((e = (call)) != cudaSuccess) return e
  for (int s = 0; s < nq; ++s) {
    for (int l = 0; l < L; ++l) {
      const size_t ld = (size_t)l * dim;
      W* kl = kc + (size_t)l * nq * dim;
      W* vl = vc + (size_t)l * nq * dim;
      SVD_TRY((launch_matvec<W, 1, EPI_STORE>(h, anorm + ld, eps, wqkv + ld * 3 * dim,
                                              nullptr, dim, 3 * dim, partials,
                                              counters, qkv, st)));
      // slots < s hold this frame's earlier steps; slot s is written here
      SVD_TRY((launch_attn<W, W>(qkv, n_head, head_dim, kl, vl, s, freqs,
                                 kl + (size_t)s * dim, vl + (size_t)s * dim, attn, st)));
      SVD_TRY((launch_matvec<W, 1, EPI_RESID>(attn, nullptr, eps, wo + ld * dim,
                                              nullptr, dim, dim, partials, counters,
                                              h, st)));
      SVD_TRY((launch_matvec<W, 1, EPI_SWIGLU>(h, fnorm + ld, eps, w1 + ld * inter,
                                               w3 + ld * inter, dim, inter, partials,
                                               counters, gate, st)));
      SVD_TRY((launch_matvec<W, 1, EPI_RESID>(gate, nullptr, eps,
                                              w2 + (size_t)l * inter * dim, nullptr,
                                              inter, dim, partials, counters, h, st)));
    }
    SVD_TRY((launch_matvec<W, 1, EPI_STORE_F32>(h, onorm, eps, wout, nullptr, dim, V,
                                                partials, counters, logits, st)));
    // sample code s; h <- fast_embeddings[code]; aemb += codebook row
    sample_kernel<W><<<1, SM_THREADS, 0, st>>>(
        logits, V, gumbel + (size_t)s * V, greedy, temperature, top_p, codes + s, emb,
        h, dim, cbemb + (size_t)s * V * mdim, aemb, mdim, s == 0);
    SVD_TRY(cudaGetLastError());
  }
#undef SVD_TRY
  return cudaSuccess;
}

template <typename W>
int run(void* h, const void* gumbel, const void* wqkv, const void* wo, const void* w1,
        const void* w3, const void* w2, const void* anorm, const void* fnorm,
        const void* onorm, const void* wout, const void* emb, const void* cbemb,
        const void* freqs, void* codes, void* aemb, void* kc, void* vc, void* qkv,
        void* attn, void* gate, void* logits, void* partials, void* counters, int L,
        int nq, int dim, int n_head, int head_dim, int inter, int V, int mdim,
        float eps, float temperature, float top_p, int greedy, void* stream) {
  return (int)fast_loop<W>(
      (W*)h, (const float*)gumbel, (const W*)wqkv, (const W*)wo, (const W*)w1,
      (const W*)w3, (const W*)w2, (const W*)anorm, (const W*)fnorm, (const W*)onorm,
      (const W*)wout, (const W*)emb, (const W*)cbemb, (const float*)freqs, (int*)codes,
      (W*)aemb, (W*)kc, (W*)vc, (W*)qkv, (W*)attn, (W*)gate, (float*)logits,
      (float*)partials, (int*)counters, L, nq, dim, n_head, head_dim, inter, V, mdim,
      eps, temperature, top_p, greedy, (cudaStream_t)stream);
}

}  // namespace

// wdtype: 0 = float32, 1 = bfloat16
extern "C" int svd_fast_decode(
    int wdtype, void* h, const void* gumbel, const void* wqkv, const void* wo,
    const void* w1, const void* w3, const void* w2, const void* anorm,
    const void* fnorm, const void* onorm, const void* wout, const void* emb,
    const void* cbemb, const void* freqs, void* codes, void* aemb, void* kc, void* vc,
    void* qkv, void* attn, void* gate, void* logits, void* partials, void* counters,
    int L, int nq, int dim, int n_head, int head_dim, int inter, int V, int mdim,
    float eps, float temperature, float top_p, int greedy, void* stream) {
#define SVD_RUN(W)                                                                    \
  return run<W>(h, gumbel, wqkv, wo, w1, w3, w2, anorm, fnorm, onorm, wout, emb, cbemb, \
                freqs, codes, aemb, kc, vc, qkv, attn, gate, logits, partials,          \
                counters, L, nq, dim, n_head, head_dim, inter, V, mdim, eps,            \
                temperature, top_p, greedy, stream)
  if (wdtype == 0) SVD_RUN(float);
  if (wdtype == 1) SVD_RUN(bf16);
#undef SVD_RUN
  return (int)cudaErrorInvalidValue;
}
