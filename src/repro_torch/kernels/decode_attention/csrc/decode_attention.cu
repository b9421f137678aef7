// Split-KV decode attention over a dense per-slot KV cache (one new token
// per sequence) for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// (`decode_attention_kernel`, body `_decode_kernel`; the cross-split merge
// of its wrapper, ops.py `_merge_splits`): for each sequence b and KV head
// h, the G = H/Hkv query heads of that group attend over the first
// lengths[b] rows of k_cache/v_cache [B,Smax,Hkv,dh]. Each CTA covers one
// split of SPLIT = 128 consecutive cache rows and writes fp32 online-softmax
// partials (o unnormalised, m, l); the shared merge kernel of
// split_merge.cuh reduces the splits on the same stream and writes bf16.
//
// What bounds it: each live K/V element is read once and used for 2*G
// FLOPs (G = 8 for qwen2.5-3b), far below the card's ~295 FLOP/byte
// ridge, so it is bound by HBM bytes. At the dense engine's decode step
// (8 slots x ~544 live tokens x 2 KV heads x 128 x 2 B x 2 for K and V)
// that is ~4.5 MB, ~1.3 us at 3.35 TB/s. Design:
//   - the G query heads of one KV head are packed into one CTA, so each
//     K/V row is read from HBM once for all G heads;
//   - only live rows are read: splits wholly at or past lengths[b] write
//     (0, NEG_INF, 0) and return, and the boundary split stops at
//     lengths[b], so no score or p*v is ever formed for a dead column and
//     the rows past a length (stale or garbage) cannot leak;
//   - Smax need not be a multiple of the split (the engine's capacity is
//     isl + osl + 8, e.g. 584): lengths are clamped to Smax and the last
//     split is cut there, where the TPU kernel asserts Smax % block_kv == 0;
//   - splits along the context give the card parallelism at small batch:
//     B x Hkv x ceil(Smax / 128) CTAs (80 at the engine's shape);
//   - scores: 8 lanes share one K row (16-byte vector loads, coalesced),
//     each lane dotting 16 of its 128 elements against all G heads, then a
//     3-step shuffle reduction; p*v: one thread per output element d;
//   - finite NEG_INF (-1e30) and the m > 0.5*NEG_INF guard, as in the TPU
//     kernel, so a dead split never forms -inf - -inf in the merge.
// Not done yet (a later PR): tensor cores, bf16x2 loads in the p*v loop,
// splits sized to the live length rather than to Smax.
#include "split_merge.cuh"

using namespace split_kv;

namespace {

constexpr int SPLIT = TMAX;   // cache rows per split

__global__ void __launch_bounds__(NTHREADS)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,   // [B,Hkv,G,DH]
                    const __nv_bfloat16* __restrict__ k,   // [B,Smax,Hkv,DH]
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ lengths,       // [B]
                    float* __restrict__ o_part,            // [B,Hkv,S,G,DH]
                    float* __restrict__ m_part,            // [B,Hkv,S,G]
                    float* __restrict__ l_part,
                    int Smax, int Hkv, int G, int n_splits, float scale) {
  __shared__ __align__(16) float sq[GMAX][DH];
  __shared__ float ss[GMAX][SPLIT];

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int start = sp * SPLIT;
  const int len = min(lengths[b], Smax);
  const int n_live = min(max(len - start, 0), SPLIT);
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
  __syncthreads();

  // row t of this split: k[b, start + t, h, :]
  const size_t row_stride = size_t(Hkv) * DH;
  const __nv_bfloat16* kb = k + (size_t(b) * Smax + start) * row_stride +
                            size_t(h) * DH;
  const __nv_bfloat16* vb = v + (size_t(b) * Smax + start) * row_stride +
                            size_t(h) * DH;

  // scores: 4 tokens per warp per pass, 8 lanes per token
  const int grp = lane >> 3;
  const int sub = lane & 7;
  for (int t0 = warp * 4; t0 < n_live; t0 += NTHREADS / 8) {
    const int t = t0 + grp;
    const bool ok = t < n_live;
    float kf[16];
    if (ok) {
      const __nv_bfloat16* kr = kb + size_t(t) * row_stride;
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

  // softmax per head over the live rows (n_live > 0: every score finite)
  for (int g = warp; g < G; g += NTHREADS / 32) {
    float mx = NEG_INF;
    for (int t = lane; t < n_live; t += 32) mx = fmaxf(mx, ss[g][t]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    float sum = 0.f;
    for (int t = lane; t < n_live; t += 32) {
      const float p = mx > 0.5f * NEG_INF ? __expf(ss[g][t] - mx) : 0.f;
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
    const float vv = __bfloat162float(vb[size_t(t) * row_stride + d]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) acc[g] += ss[g][t] * vv;
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) op[g * DH + d] = acc[g];
}

}  // namespace

// q [B,Hkv,G,128] bf16; k/v caches [B,Smax,Hkv,128] bf16; lengths [B]
// int32 (clamped to Smax); scratch partials o [B,Hkv,S,G,128], m and l
// [B,Hkv,S,G] fp32 with S = n_splits = ceil(Smax / 128); out [B,Hkv,G,128]
// bf16. Launches the split kernel and the merge kernel on `stream`;
// returns cudaGetLastError() after both.
extern "C" int dense_decode_fwd(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* o_part, void* m_part, void* l_part,
                                void* out, int B, int Smax, int Hkv, int G,
                                int n_splits, float scale, void* stream) {
  if (G < 1 || G > GMAX || n_splits != (Smax + SPLIT - 1) / SPLIT)
    return int(cudaErrorInvalidValue);
  if (B <= 0 || n_splits <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dense_decode_kernel<<<dim3(n_splits, Hkv, B), NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int*>(lengths), static_cast<float*>(o_part),
      static_cast<float*>(m_part), static_cast<float*>(l_part), Smax, Hkv, G,
      n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  split_merge_kernel<<<dim3(G, Hkv, B), NTHREADS, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<__nv_bfloat16*>(out),
      n_splits);
  return int(cudaGetLastError());
}
