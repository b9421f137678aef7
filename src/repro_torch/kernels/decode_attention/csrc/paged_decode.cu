// Paged split-KV decode attention (one new token per sequence) for Hopper,
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/decode_attention/paged_decode.py
// (`paged_decode_attention_kernel`, body `_paged_kernel`): for each
// sequence b and KV head h, the G = H/Hkv query heads of that group attend
// over the first lengths[b] tokens of the K/V block pool [N,Bs,Hkv,dh],
// read through the block table tables[b, :]. Each CTA covers one split of
// `pages_per_split` consecutive table entries and writes fp32 online-
// softmax partials (o unnormalised, m, l); a second, tiny kernel on the
// same stream (``split_merge_kernel`` of split_merge.cuh, shared with the
// dense kernel) merges the splits and writes the bf16 output (the TPU
// wrapper merges in jnp; here the merge is one launch instead of a dozen
// small PyTorch ops, which the host could not issue as fast as the card
// runs them).
//
// What bounds it: every K/V element of the live context is read once and
// used for 2*G FLOPs (G = 8 for qwen2.5-3b: 8 FLOPs per byte), far below
// the card's ~295 FLOP/byte ridge, so it is bound by HBM bytes. Design:
//   - the G query heads of one KV head are packed into one CTA, so each
//     K/V row is read from HBM once for all G heads;
//   - the CTA reads its own table entries and length (no scalar prefetch
//     on the card) and loads only live tokens: dead splits write
//     (0, NEG_INF, 0) and return, and a split's boundary block is cut at
//     lengths[b] before any score or p*v is formed, so the trash block and
//     the tail of the last block are never read;
//   - splits along the context give the card parallelism when the batch
//     is small; the engine's block_size of 8 is tiny, so one CTA walks
//     several pages (up to 128 tokens);
//   - scores: 8 lanes share one K row (16-byte vector loads, coalesced),
//     each lane dotting 16 of its 128 elements against all G heads, then a
//     3-step shuffle reduction; p*v: one thread per output element d.
//   - finite NEG_INF (-1e30), as in the TPU kernel, so the merge of a dead
//     split never forms -inf - -inf.
// Not done yet (a later PR): tensor cores, bf16x2 loads in the p*v loop.
#include "split_merge.cuh"

using namespace split_kv;

namespace {

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
  __shared__ __align__(16) float sq[GMAX][DH];
  __shared__ float ss[GMAX][TMAX];
  __shared__ int sblk[TMAX];

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int T = pages_per_split * Bs;
  const int start = sp * T;
  const int n_live = min(max(lengths[b] - start, 0), T);
  const size_t part = (size_t(b) * Hkv + h) * n_splits + sp;
  float* op = o_part + part * G * DH;
  float* mp = m_part + part * G;
  float* lp = l_part + part * G;

  if (n_live == 0) {   // dead split (uniform across the CTA)
    for (int i = tid; i < G * DH; i += NTHREADS) op[i] = 0.f;
    if (tid < G) {
      mp[tid] = NEG_INF;
      lp[tid] = 0.f;
    }
    return;
  }

  const __nv_bfloat16* qp = q + (size_t(b) * Hkv + h) * G * DH;
  for (int i = tid; i < G * DH; i += NTHREADS)
    sq[i / DH][i % DH] = __bfloat162float(qp[i]);
  const int n_pages = (n_live + Bs - 1) / Bs;
  for (int i = tid; i < n_pages; i += NTHREADS)
    sblk[i] = tables[size_t(b) * nb + size_t(sp) * pages_per_split + i];
  __syncthreads();

  // scores: 4 tokens per warp per pass, 8 lanes per token
  const int grp = lane >> 3;
  const int sub = lane & 7;
  for (int t0 = warp * 4; t0 < n_live; t0 += NTHREADS / 8) {
    const int t = t0 + grp;
    const bool ok = t < n_live;
    float kf[16];
    if (ok) {
      const __nv_bfloat16* kr =
          pool_k + ((size_t(sblk[t / Bs]) * Bs + t % Bs) * Hkv + h) * DH;
      unpack8(*reinterpret_cast<const uint4*>(kr + sub * 8), kf);
      unpack8(*reinterpret_cast<const uint4*>(kr + 64 + sub * 8), kf + 8);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) kf[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {   // G is uniform: every lane takes the same branches
        const float* qg = sq[g];
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc += qg[sub * 8 + e] * kf[e] + qg[64 + sub * 8 + e] * kf[8 + e];
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (ok && sub == 0) ss[g][t] = acc * scale;
      }
    }
  }
  __syncthreads();

  // softmax per head over the live tokens (n_live > 0: every score finite)
  for (int g = warp; g < G; g += NTHREADS / 32) {
    float mx = NEG_INF;
    for (int t = lane; t < n_live; t += 32) mx = fmaxf(mx, ss[g][t]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    float sum = 0.f;
    for (int t = lane; t < n_live; t += 32) {
      const float p = __expf(ss[g][t] - mx);
      ss[g][t] = p;
      sum += p;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
    if (lane == 0) {
      mp[g] = mx;
      lp[g] = sum;
    }
  }
  __syncthreads();

  // o[g][d] = sum_t p[g][t] * v[t][d], one thread per d
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
  const int d = tid;
  for (int t = 0; t < n_live; ++t) {
    const float vv = __bfloat162float(
        pool_v[((size_t(sblk[t / Bs]) * Bs + t % Bs) * Hkv + h) * DH + d]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) acc[g] += ss[g][t] * vv;
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) op[g * DH + d] = acc[g];
}

}  // namespace

// q [B,Hkv,G,128] bf16; pools [N,Bs,Hkv,128] bf16; tables [B,nb] int32;
// lengths [B] int32 with lengths[b] <= nb*Bs; scratch partials o
// [B,Hkv,S,G,128], m and l [B,Hkv,S,G] fp32 with S = n_splits; out
// [B,Hkv,G,128] bf16. Launches the split kernel and the merge kernel on
// `stream`; returns cudaGetLastError() after both.
extern "C" int paged_decode_fwd(const void* q, const void* pool_k,
                                const void* pool_v, const void* tables,
                                const void* lengths, void* o_part,
                                void* m_part, void* l_part, void* out, int B,
                                int Hkv, int G, int Bs, int nb,
                                int pages_per_split, int n_splits,
                                float scale, void* stream) {
  if (G < 1 || G > GMAX || pages_per_split * Bs > TMAX)
    return int(cudaErrorInvalidValue);
  if (B <= 0 || n_splits <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  paged_decode_kernel<<<dim3(n_splits, Hkv, B), NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), Hkv, G, Bs, nb, pages_per_split, n_splits,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  split_merge_kernel<<<dim3(Hkv, B), NTHREADS, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<__nv_bfloat16*>(out), G,
      n_splits);
  return int(cudaGetLastError());
}
