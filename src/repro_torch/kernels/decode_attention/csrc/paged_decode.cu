// Paged split-KV decode attention (one new token per sequence) for Hopper,
// sm_90a: the paged instantiation of the split body in split_attend.cuh.
//
// Replaces the TPU kernel repro/kernels/decode_attention/paged_decode.py
// (`paged_decode_attention_kernel`, body `_paged_kernel`): for each
// sequence b and KV head h, the G = H/Hkv query heads of that group attend
// over the first lengths[b] tokens of the K/V block pool [N,Bs,Hkv,dh],
// read through the block table tables[b, :]. Each CTA covers one split of
// `pages_per_split` consecutive table entries (whole pages, 32 to 64
// tokens, from ``ops.pages_per_split``) and writes fp32 online-softmax
// partials; ``split_merge_kernel`` (split_merge.cuh) merges the splits on
// the same stream and writes the bf16 output (the TPU wrapper merges in
// jnp; here the merge is one launch instead of a dozen small PyTorch ops).
//
// What bounds it, and the design, are the split body's (split_attend.cuh):
// HBM bytes; splits chosen from the shape, cp.async staging of K then V,
// both products on mma.sync. What is the paged layout's own: the CTA reads
// its table entries into shared memory first, so each row's address is
// one lookup, and the trash block and the tail of the last page past
// lengths[b] are never read (rows up to the next 16 are zeroed in shared
// memory). The first version walked a split's 128 tokens one after
// another on 80 CTAs: 0.0984 ms of device time at the main path's shape,
// against 0.0105 ms now (chip_smoke.py, H100 80GB HBM3 at 700 W).
#include "split_attend.cuh"

using namespace split_kv;

namespace {

// row t of a split: page t / Bs of the split's table entries (in shared
// memory), row t % Bs of that block, head h
struct PagedRows {
  const int* blocks;
  int Bs, Hkv, h;
  __device__ __forceinline__ size_t operator()(int t) const {
    const int page = t / Bs;
    return ((size_t(blocks[page]) * Bs + (t - page * Bs)) * Hkv + h) * DH;
  }
};

__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,       // [B,Hkv,G,DH]
                    const __nv_bfloat16* __restrict__ pool_k,  // [N,Bs,Hkv,DH]
                    const __nv_bfloat16* __restrict__ pool_v,
                    const int* __restrict__ tables,            // [B,nb]
                    const int* __restrict__ lengths,           // [B]
                    float* __restrict__ o_part,                // [B,Hkv,S,G,DH]
                    float* __restrict__ m_part,                // [B,Hkv,S,G]
                    float* __restrict__ l_part,
                    int Hkv, int G, int Bs, int nb, int pages_per_split,
                    int n_splits, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = pages_per_split * Bs;
  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int start = sp * T;
  const int n_live = min(max(lengths[b] - start, 0), T);
  const size_t part = (size_t(b) * Hkv + h) * n_splits + sp;
  float* op = o_part + part * G * DH;
  float* mp = m_part + part * G;
  float* lp = l_part + part * G;
  if (n_live == 0) {   // dead split (uniform across the CTA)
    dead_split(op, mp, lp, G);
    return;
  }

  int* sblk = reinterpret_cast<int*>(smem + extra_offset((T + 15) & ~15));
  const int n_pages = (n_live + Bs - 1) / Bs;
  for (int i = threadIdx.x; i < n_pages; i += NTHREADS)
    sblk[i] = tables[size_t(b) * nb + size_t(sp) * pages_per_split + i];
  __syncthreads();
  split_attend(PagedRows{sblk, Bs, Hkv, h},
               q + (size_t(b) * Hkv + h) * G * DH, pool_k, pool_v, op, mp,
               lp, smem, T, n_live, G, scale);
}

}  // namespace

// q [B,Hkv,G,128] bf16; pools [N,Bs,Hkv,128] bf16; tables [B,nb] int32;
// lengths [B] int32 with lengths[b] <= nb*Bs; pages_per_split*Bs <= 128;
// scratch partials o [B,Hkv,S,G,128], m and l [B,Hkv,S,G] fp32 with S =
// n_splits; out [B,Hkv,G,128] bf16. Launches the split kernel and the
// merge kernel on `stream`; returns cudaGetLastError() after both.
extern "C" int paged_decode_fwd(const void* q, const void* pool_k,
                                const void* pool_v, const void* tables,
                                const void* lengths, void* o_part,
                                void* m_part, void* l_part, void* out, int B,
                                int Hkv, int G, int Bs, int nb,
                                int pages_per_split, int n_splits,
                                float scale, void* stream) {
  static bool configured = false;
  if (pages_per_split < 1 || Bs < 1) return int(cudaErrorInvalidValue);
  return launch_split_and_merge(
      paged_decode_kernel, &configured, pages_per_split * Bs, B, Hkv, G,
      n_splits, static_cast<const float*>(o_part),
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<__nv_bfloat16*>(out), static_cast<cudaStream_t>(stream),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), Hkv, G, Bs, nb, pages_per_split,
      n_splits, scale);
}
