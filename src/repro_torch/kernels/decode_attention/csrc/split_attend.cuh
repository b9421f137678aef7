// The split body shared by the two split-KV decode kernels of this
// directory (paged_decode.cu, decode_attention.cu): one CTA attends the G
// query heads of one (sequence, KV head) over one split of up to TMAX
// consecutive cache rows and writes fp32 online-softmax partials (o
// unnormalised [G, DH], m and l [G]); split_merge.cuh reduces the splits.
// The two kernels differ only in how row t of a split is found, which the
// body takes as a functor: through the block table for the paged pool, at
// a fixed stride for the dense cache.
//
// What bounds it: every live K/V element is read once and used for 2*G
// FLOPs (G = 8 for qwen2.5-3b: 8 FLOPs per byte), far below the card's
// ~295 FLOP/byte ridge, so it is bound by HBM bytes and the design is
// about keeping bytes in flight and few instructions per byte:
//   - the split is a function of the shape (``ops.pages_per_split`` and
//     ``ops.split_tokens``): 32 to 64 rows, the longest that keeps
//     B*Hkv*n_splits at 264 CTAs (2 per SM) or more, so the grid fills
//     the card at small batch and each CTA's serial walk stays short;
//   - the CTA issues 16-byte cp.async.cg copies of every live K row of its
//     split as one commit group and every V row as a second before it
//     waits on either: the split's bytes are in flight at once, and V's
//     arrive while the scores are formed. Rows are stored with a
//     16-byte-chunk XOR swizzle so ldmatrix reads them without bank
//     conflicts. The fp32 scores and bf16 P take over the K tile's space
//     once S is formed, so a 64-row split needs 32.5 KB and six CTAs fit
//     on an SM;
//   - rows at or past the split's live length are never read from global
//     memory: dead splits write (0, NEG_INF, 0) and return, and rows from
//     n_live up to the next multiple of 16 are zeroed in shared memory, so
//     a stale or poisoned row cannot reach the output;
//   - S^T = K Q^T and O^T = V^T P^T on mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate), the G query heads on the n = 8 side so no row of the
//     MMA is padding at G = 8 (G = 16 is two n-tiles; a G that is no
//     multiple of 8 pads with zero rows of Q): tokens are the M side of
//     S^T with dh the k side; dh is the M side of O^T (8 tiles of 16, two
//     per warp) with tokens the k side. K and V^T reach the MMAs through
//     ldmatrix (.trans for V^T), Q^T from global memory straight into
//     registers; the softmax between the two runs per head in fp32 over
//     shared memory and hands P to the second product in bf16;
//   - finite NEG_INF (-1e30), as in the TPU kernels, so the merge of a
//     dead split never forms -inf - -inf.
// The head dim DH is a template parameter, 128 or 64 (granite-moe-1b-a400m:
// its 8 KV heads of 64 hold Hkv*dh = 512 elements per token and layer
// against qwen2.5-3b's 256, so the same HBM-bound design reads twice the
// bytes per token). Re-derived at DH = 64 rather than halved:
//   - a row is 128 bytes, 8 chunks of 16: the staging loop puts 8 threads
//     on a row, so a pass of 128 threads covers 16 rows (8 at DH = 128);
//   - the swizzle swz(t, c) = t*ROW + ((c ^ (t & 7)) << 4) still keeps
//     ldmatrix free of bank conflicts: a 128-byte row spans the 32 banks
//     once, and the 8 rows of one 8x8 matrix put chunk c at 8 different
//     chunk slots (c ^ 0 .. c ^ 7, all within the row's 8);
//   - S^T takes DH/16 = 4 k-steps, K's ldmatrix column 2*kk + (lane >> 4)
//     stays within the 8 chunks;
//   - O^T = V^T P^T has DH/16 = 4 dh tiles of 16: one per warp (two at
//     DH = 128), each warp walking every token k-step of the split.
// Not done yet: the merge is a second launch and a second pass over the
// partials (16% of paged decode at B=32 x 4096); the last CTA of each
// (b, h) could merge instead.
#pragma once

#include "split_merge.cuh"

namespace split_kv {

constexpr int NT_MAX = GMAX / 8;    // n-tiles of query heads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bytes of one K/V row
template <int DH>
__host__ __device__ constexpr int row_bytes() {
  static_assert(DH == 64 || DH == 128, "head dim 64 or 128");
  return DH * 2;
}

// byte offset of 16-byte chunk c of row t in a staged K or V tile
template <int DH>
__device__ __forceinline__ int swz(int t, int c) {
  return t * row_bytes<DH>() + ((c ^ (t & 7)) << 4);
}

// shared memory for splits of up to t16 rows (a multiple of 16): the K
// tile, whose space the fp32 scores [GMAX][t16 + 4] and bf16 p
// [GMAX][t16 + 8] take over once S is formed; the V tile; TMAX ints for a
// kernel's own use (the paged kernel's table entries)
template <int DH>
__host__ __device__ inline size_t region_a(int t16) {
  const size_t k = size_t(t16) * row_bytes<DH>();
  const size_t sp = size_t(GMAX) * (t16 + 4) * 4 + size_t(GMAX) * (t16 + 8) * 2;
  return k > sp ? k : sp;
}

template <int DH>
__host__ __device__ inline size_t extra_offset(int t16) {
  return region_a<DH>(t16) + size_t(t16) * row_bytes<DH>();
}

template <int DH>
inline size_t smem_bytes(int t16) {
  return extra_offset<DH>(t16) + size_t(TMAX) * 4;
}

// a split with no live row: (0, NEG_INF, 0), which the merge weighs 0
template <int DH>
__device__ __forceinline__ void dead_split(float* op, float* mp, float* lp,
                                           int G) {
  for (int i = threadIdx.x; i < G * DH; i += NTHREADS) op[i] = 0.f;
  if (threadIdx.x < G) {
    mp[threadIdx.x] = NEG_INF;
    lp[threadIdx.x] = 0.f;
  }
}

// One split: the n_live (>= 1) live rows of a split of T rows. q points at
// this (b, h)'s G query rows [G, DH]; rows(t) is the element offset of row
// t's DH values of head h in k and in v (the same in both); op, mp, lp are
// this split's partials. Every thread of the CTA calls it.
template <int DH, class Rows>
__device__ __forceinline__ void split_attend(
    const Rows& rows, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    float* __restrict__ op, float* __restrict__ mp, float* __restrict__ lp,
    unsigned char* smem, int T, int n_live, int G, float scale) {
  const int t16 = (T + 15) & ~15;
  unsigned char* sK = smem;
  float* ss = reinterpret_cast<float*>(smem);   // over K, once S is formed
  const int srow = t16 + 4;
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(ss + GMAX * srow);
  const int prow = t16 + 8;
  unsigned char* sV = smem + region_a<DH>(t16);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;          // fragment row within 8
  const int c2 = 2 * (lane & 3);     // fragment column pair

  // stage the live rows: K as one commit group, V as a second; rows from
  // n_live up to n16 are zeroed (never read from global memory)
  constexpr int CHUNKS = DH / 8;      // 16-byte chunks per row
  const int n16 = (n_live + 15) & ~15;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int c = tid % CHUNKS;         // this thread's 16-byte chunk
  for (int pass = 0; pass < 2; ++pass) {
    const __nv_bfloat16* src = pass ? v : k;
    unsigned char* dst = pass ? sV : sK;
    for (int t = tid / CHUNKS; t < n16; t += NTHREADS / CHUNKS) {
      if (t < n_live)
        cp_async16(smem_u32(dst + swz<DH>(t, c)), src + rows(t) + c * 8);
      else
        *reinterpret_cast<uint4*>(dst + swz<DH>(t, c)) = zero;
    }
    cp_async_commit();
  }

  // Q^T as the B operand of S^T = K Q^T, straight from global memory:
  // b0 = q[head][16kk + c2, +1], b1 = the same 8 columns on; heads past G
  // are zero
  const int NT = (G + 7) >> 3;
  uint32_t qf[NT_MAX][DH / 16][2];
#pragma unroll
  for (int nt = 0; nt < NT_MAX; ++nt) {
    const int head = nt * 8 + g8;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bool ok = nt < NT && head < G;
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(q + head * DH + kk * 16 + c2);
      qf[nt][kk][0] = ok ? src[0] : 0u;
      qf[nt][kk][1] = ok ? src[4] : 0u;
    }
  }

  cp_async_wait<1>();                 // this thread's K rows are in
  __syncthreads();

  // S^T: warp w forms token tiles w and w + 4 (16 tokens each), held in
  // registers until every warp is done reading K
  const uint32_t k_base = smem_u32(sK);
  float sacc[TMAX / 64][NT_MAX][4] = {};
#pragma unroll
  for (int mi = 0; mi < TMAX / 64; ++mi) {
    const int mt = warp + mi * (NTHREADS / 32);
    if (mt * 16 < n16) {
      const int t = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, k_base + swz<DH>(t, 2 * kk + (lane >> 4)));
#pragma unroll
        for (int nt = 0; nt < NT_MAX; ++nt)
          if (nt < NT) mma_16816(sacc[mi][nt], a, qf[nt][kk]);
      }
    }
  }
  __syncthreads();                    // K is free: scores take its place
#pragma unroll
  for (int mi = 0; mi < TMAX / 64; ++mi) {
#pragma unroll
    for (int nt = 0; nt < NT_MAX; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int head = nt * 8 + c2 + (e & 1);
        const int tok = (warp + mi * (NTHREADS / 32)) * 16 + g8 + (e >> 1) * 8;
        if (nt < NT && head < G && tok < n_live)
          ss[head * srow + tok] = sacc[mi][nt][e] * scale;
      }
    }
  }
  __syncthreads();

  // softmax per head over the live tokens (n_live > 0: every score
  // finite); p to bf16 for the second product, zero past n_live
  for (int g = warp; g < G; g += NTHREADS / 32) {
    float mx = NEG_INF;
    for (int t = lane; t < n_live; t += 32) mx = fmaxf(mx, ss[g * srow + t]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    float sum = 0.f;
    for (int t = lane; t < n16; t += 32) {
      const float p = t < n_live ? __expf(ss[g * srow + t] - mx) : 0.f;
      sP[g * prow + t] = __float2bfloat16(p);
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
  cp_async_wait<0>();                 // this thread's V rows are in
  __syncthreads();

  // O^T = V^T P^T: warp w owns dh tiles MPW*w .. MPW*w + MPW - 1 (two at
  // DH = 128, one at 64: the 4 warps cover DH/16 tiles); tokens are the
  // k side
  constexpr int MPW = DH / 64;
  float acc[MPW][NT_MAX][4] = {};
  const uint32_t v_base = smem_u32(sV);
  for (int ks = 0; ks * 16 < n16; ++ks) {
    uint32_t pb[NT_MAX][2];
#pragma unroll
    for (int nt = 0; nt < NT_MAX; ++nt) {
      const __nv_bfloat16* pr = sP + (nt * 8 + g8) * prow + ks * 16 + c2;
      pb[nt][0] = nt < NT ? *reinterpret_cast<const uint32_t*>(pr) : 0u;
      pb[nt][1] = nt < NT ? *reinterpret_cast<const uint32_t*>(pr + 8) : 0u;
    }
    const int t = ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
#pragma unroll
    for (int mi = 0; mi < MPW; ++mi) {
      uint32_t a[4];
      ldmatrix_x4_trans(
          a, v_base + swz<DH>(t, (warp * MPW + mi) * 2 + ((lane >> 3) & 1)));
#pragma unroll
      for (int nt = 0; nt < NT_MAX; ++nt)
        if (nt < NT) mma_16816(acc[mi][nt], a, pb[nt]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < MPW; ++mi) {
#pragma unroll
    for (int nt = 0; nt < NT_MAX; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int head = nt * 8 + c2 + (e & 1);
        const int d = (warp * MPW + mi) * 16 + g8 + (e >> 1) * 8;
        if (nt < NT && head < G) op[head * DH + d] = acc[mi][nt][e];
      }
    }
  }
}

// Launch a split kernel and the merge kernel on `stream` with the dynamic
// shared memory a split of T rows needs (the kernel's limit raised once to
// TMAX rows' worth); returns cudaGetLastError() after both.
template <int DH, class Kernel, class... Args>
int launch_split_and_merge(Kernel kernel, bool* configured, int T, int B,
                           int Hkv, int G, int n_splits, const float* o_part,
                           const float* m_part, const float* l_part,
                           __nv_bfloat16* out, cudaStream_t stream,
                           Args... args) {
  if (!*configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem_bytes<DH>(TMAX)));
    if (err != cudaSuccess) return int(err);
    *configured = true;
  }
  if (G < 1 || G > GMAX || T < 1 || T > TMAX)
    return int(cudaErrorInvalidValue);
  if (B <= 0 || n_splits <= 0) return 0;
  kernel<<<dim3(n_splits, Hkv, B), NTHREADS,
           smem_bytes<DH>((T + 15) & ~15), stream>>>(args...);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  split_merge_kernel<DH><<<dim3(G, Hkv, B), DH, 0, stream>>>(
      o_part, m_part, l_part, out, n_splits);
  return int(cudaGetLastError());
}

}  // namespace split_kv
