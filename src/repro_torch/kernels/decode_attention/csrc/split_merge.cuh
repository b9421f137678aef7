// Shared by the two split-KV decode kernels of this directory (paged and
// dense): constants, a bf16 unpack helper, and the cross-split merge.
//
// Each split kernel writes fp32 online-softmax partials per (sequence, KV
// head, split): o unnormalised [G, DH], m and l [G]. A dead split writes
// (0, NEG_INF, 0). The merge reduces the splits and writes the bf16
// output [B, Hkv, G, DH]; it is one launch instead of the dozen small
// PyTorch ops of the plain merge (``ops._merge_splits``), which the host
// could not issue as fast as the card runs them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split_kv {

constexpr int DH = 128;       // head dim (the wrappers check it)
constexpr int GMAX = 16;      // most query heads per KV head
constexpr int TMAX = 128;     // most tokens per split
constexpr int NTHREADS = 128; // == DH: one thread per output element
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Cross-split online-softmax merge: one CTA per (KV head, sequence), one
// thread per output element d, looping over the G heads and the splits.
// A dead split (m = NEG_INF, l = 0, o = 0) weighs exp(NEG_INF - m_all) = 0;
// a sequence with no live split gives 0 / 1e-30 = 0, as the plain merge
// does.
__global__ void __launch_bounds__(NTHREADS)
split_merge_kernel(const float* __restrict__ o_part,   // [B,Hkv,S,G,DH]
                   const float* __restrict__ m_part,   // [B,Hkv,S,G]
                   const float* __restrict__ l_part,
                   __nv_bfloat16* __restrict__ out,    // [B,Hkv,G,DH]
                   int G, int n_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const size_t part = (size_t(b) * gridDim.x + h) * n_splits;
  for (int g = 0; g < G; ++g) {
    float m_all = NEG_INF;
    for (int s = 0; s < n_splits; ++s)
      m_all = fmaxf(m_all, m_part[(part + s) * G + g]);
    float l_all = 0.f, acc = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const size_t i = (part + s) * G + g;
      const float a = __expf(m_part[i] - m_all);
      l_all += l_part[i] * a;
      acc += o_part[i * DH + d] * a;
    }
    out[((size_t(b) * gridDim.x + h) * G + g) * DH + d] =
        __float2bfloat16(acc / fmaxf(l_all, 1e-30f));
  }
}

}  // namespace split_kv
