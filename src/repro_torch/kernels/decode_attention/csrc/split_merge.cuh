// Shared by the two split-KV decode kernels of this directory (paged and
// dense): constants and the cross-split merge.
//
// Each split kernel writes fp32 online-softmax partials per (sequence, KV
// head, split): o unnormalised [G, DH], m and l [G]. A dead split writes
// (0, NEG_INF, 0). The merge reduces the splits and writes the bf16
// output [B, Hkv, G, DH]; it is one launch instead of the dozen small
// PyTorch ops of the plain merge (``ops._merge_splits``), which the host
// could not issue as fast as the card runs them.
//
// The head dim DH is a template parameter of everything here, with two
// instantiations: 128 (qwen2.5-3b, the 14B models) and 64
// (granite-moe-1b-a400m); the wrappers check it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split_kv {

constexpr int GMAX = 16;      // most query heads per KV head
constexpr int TMAX = 128;     // most tokens per split (K/V rows staged)
constexpr int NTHREADS = 128; // a split kernel's CTA: 4 warps
constexpr float NEG_INF = -1e30f;

// max (or sum) over the CTA's NT threads; every thread gets it
template <int NT, bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, d);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  __syncthreads();                       // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w)
    x = MAX ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Cross-split online-softmax merge: one CTA per (query head g, KV head,
// sequence) — grid (G, Hkv, B) — one thread per output element d, so DH
// threads. The splits' maxima and weights exp(m_s - m_all) are formed in
// parallel, one split per thread, DH splits at a time, so each thread's
// own loop over the splits only sums o (independent loads). A dead split
// (m = NEG_INF, l = 0, o = 0) weighs exp(NEG_INF - m_all) = 0; a sequence
// with no live split gives 0 / 1e-30 = 0, as the plain merge does.
//
// At DH = 64 the CTA is 64 threads, one per element as at 128, rather than
// two query heads in one 128-thread CTA: G can be odd (5 at qwen3-14b's
// 40/8 heads), so a pairing would need a tail case, and the merge reads
// only the partials (B*Hkv*S*G*DH*4 bytes, 0.33 MB at granite's serve
// step), which 2*8*8 = 128 CTAs of 64 threads still spread over the card.
template <int DH>
__global__ void __launch_bounds__(DH)
split_merge_kernel(const float* __restrict__ o_part,   // [B,Hkv,S,G,DH]
                   const float* __restrict__ m_part,   // [B,Hkv,S,G]
                   const float* __restrict__ l_part,
                   __nv_bfloat16* __restrict__ out,    // [B,Hkv,G,DH]
                   int n_splits) {
  constexpr int NT = DH;                 // threads: one per element
  __shared__ float w[NT];
  __shared__ float red[NT / 32];
  const int g = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = gridDim.x;
  const int t = threadIdx.x;
  const size_t bh = size_t(b) * gridDim.y + h;
  const size_t part = bh * n_splits;
  float m_all = NEG_INF;
  for (int s = t; s < n_splits; s += NT)
    m_all = fmaxf(m_all, m_part[(part + s) * G + g]);
  m_all = block_reduce<NT, true>(m_all, red);
  float l_sum = 0.f, acc = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += NT) {
    const int n = min(NT, n_splits - s0);
    __syncthreads();                     // the previous chunk's w is read
    if (t < n) {
      const size_t i = (part + s0 + t) * G + g;
      const float a = __expf(m_part[i] - m_all);
      w[t] = a;
      l_sum += l_part[i] * a;
    }
    __syncthreads();
    const float* op = o_part + ((part + s0) * G + g) * DH + t;
#pragma unroll 16
    for (int s = 0; s < n; ++s) acc += op[size_t(s) * G * DH] * w[s];
  }
  const float l_all = block_reduce<NT, false>(l_sum, red);
  out[(bh * G + g) * DH + t] = __float2bfloat16(acc / fmaxf(l_all, 1e-30f));
}

}  // namespace split_kv
