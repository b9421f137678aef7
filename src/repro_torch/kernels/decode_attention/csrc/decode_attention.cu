// Split-KV decode attention over a dense per-slot KV cache (one new token
// per sequence) for Hopper, sm_90a: the dense instantiation of the split
// body in split_attend.cuh.
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// (`decode_attention_kernel`, body `_decode_kernel`; the cross-split merge
// of its wrapper, ops.py `_merge_splits`): for each sequence b and KV head
// h, the G = H/Hkv query heads of that group attend over the first
// lengths[b] rows of k_cache/v_cache [B,Smax,Hkv,dh]. Each CTA covers one
// split of T consecutive cache rows (32 to 64, from ``ops.split_tokens``)
// and writes fp32 online-softmax partials; ``split_merge_kernel``
// (split_merge.cuh) merges the splits on the same stream and writes bf16.
//
// What bounds it, and the design, are the split body's (split_attend.cuh):
// HBM bytes (8 FLOPs per byte at G = 8; ~4.5 MB, 1.35 us at 3.35 TB/s at
// the dense engine's decode step of 8 slots x 544 live rows); cp.async
// staging of K then V, both products on mma.sync. The first version
// walked fixed 128-row splits on 80 CTAs, scores on the CUDA cores and
// p*v one thread per output element, one 2-byte load per row: 0.0373 ms of
// device time at that step, twice SDPA's (chip_smoke.py, H100 80GB HBM3 at
// 700 W). What is the dense layout's own:
//   - row t of a split lies at a fixed stride, Hkv*DH elements, from the
//     split's first row: no table, nothing to stage before the rows;
//   - Smax need not be a multiple of the split (the engine's capacity is
//     isl + osl + 8, e.g. 584): lengths are clamped to Smax, so the last
//     split stops at Smax, where the TPU kernel asserts Smax % block_kv ==
//     0;
//   - rows at or past lengths[b] are never read (dead splits return at
//     once, the boundary split zeroes its rows up to the next 16 in shared
//     memory), so a stale or poisoned row cannot leak into the output.
// Head dim 64 or 128 (the body's template parameter): no engine of this
// repo decodes granite-moe-1b-a400m on the dense layout by default, but
// the body is shared with the paged kernel, so dh = 64 comes with it; at
// granite's heads (16/8, G = 2) a live row is 2 KB of K and V per layer,
// 2 FLOPs per byte, bound by HBM bytes as at 128.
#include "split_attend.cuh"

using namespace split_kv;

namespace {

// row t of a split: `base` is the split's first row of head h
struct DenseRows {
  size_t base, stride;
  __device__ __forceinline__ size_t operator()(int t) const {
    return base + size_t(t) * stride;
  }
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,   // [B,Hkv,G,DH]
                    const __nv_bfloat16* __restrict__ k,   // [B,Smax,Hkv,DH]
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ lengths,       // [B]
                    float* __restrict__ o_part,            // [B,Hkv,S,G,DH]
                    float* __restrict__ m_part,            // [B,Hkv,S,G]
                    float* __restrict__ l_part,
                    int Smax, int Hkv, int G, int T, int n_splits,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int start = sp * T;
  const int n_live = min(max(min(lengths[b], Smax) - start, 0), T);
  const size_t part = (size_t(b) * Hkv + h) * n_splits + sp;
  float* op = o_part + part * G * DH;
  float* mp = m_part + part * G;
  float* lp = l_part + part * G;
  if (n_live == 0) {   // dead split (uniform across the CTA)
    dead_split<DH>(op, mp, lp, G);
    return;
  }
  const size_t stride = size_t(Hkv) * DH;
  split_attend<DH>(
      DenseRows{(size_t(b) * Smax + start) * stride + size_t(h) * DH, stride},
      q + (size_t(b) * Hkv + h) * G * DH, k, v, op, mp, lp, smem, T, n_live,
      G, scale);
}

template <int DH>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* lengths, void* o_part, void* m_part, void* l_part,
           void* out, int B, int Smax, int Hkv, int G, int split_tokens,
           int n_splits, float scale, cudaStream_t stream) {
  static bool configured = false;
  return launch_split_and_merge<DH>(
      dense_decode_kernel<DH>, &configured, split_tokens, B, Hkv, G,
      n_splits, static_cast<const float*>(o_part),
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<__nv_bfloat16*>(out), stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int*>(lengths), static_cast<float*>(o_part),
      static_cast<float*>(m_part), static_cast<float*>(l_part), Smax, Hkv, G,
      split_tokens, n_splits, scale);
}

}  // namespace

// q [B,Hkv,G,dh] bf16; k/v caches [B,Smax,Hkv,dh] bf16; lengths [B]
// int32 (clamped to Smax); split_tokens <= 128 rows per split; scratch
// partials o [B,Hkv,S,G,dh], m and l [B,Hkv,S,G] fp32 with S = n_splits
// = ceil(Smax / split_tokens); out [B,Hkv,G,dh] bf16; dh = 64 or 128.
// Launches the split kernel and the merge kernel on `stream`; returns
// cudaGetLastError() after both.
extern "C" int dense_decode_fwd(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* o_part, void* m_part, void* l_part,
                                void* out, int B, int Smax, int Hkv, int G,
                                int dh, int split_tokens, int n_splits,
                                float scale, void* stream) {
  if (split_tokens < 1 || (dh != 64 && dh != 128) ||
      n_splits != (Smax + split_tokens - 1) / split_tokens)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dh == 128
             ? launch<128>(q, k_cache, v_cache, lengths, o_part, m_part,
                           l_part, out, B, Smax, Hkv, G, split_tokens,
                           n_splits, scale, st)
             : launch<64>(q, k_cache, v_cache, lengths, o_part, m_part,
                          l_part, out, B, Smax, Hkv, G, split_tokens,
                          n_splits, scale, st);
}
