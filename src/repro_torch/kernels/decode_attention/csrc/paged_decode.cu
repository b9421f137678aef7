// Paged split-KV decode attention (one new token per sequence) for Hopper,
// sm_90a: a grid that fills the card, each split staged in shared memory
// by cp.async, both products on the tensor cores (mma.sync).
//
// Replaces the TPU kernel repro/kernels/decode_attention/paged_decode.py
// (`paged_decode_attention_kernel`, body `_paged_kernel`): for each
// sequence b and KV head h, the G = H/Hkv query heads of that group attend
// over the first lengths[b] tokens of the K/V block pool [N,Bs,Hkv,dh],
// read through the block table tables[b, :]. Each CTA covers one split of
// `pages_per_split` consecutive table entries and writes fp32 online-
// softmax partials (o unnormalised, m, l); a second, small kernel on the
// same stream (``split_merge_kernel`` of split_merge.cuh, shared with the
// dense kernel) merges the splits and writes the bf16 output (the TPU
// wrapper merges in jnp; here the merge is one launch instead of a dozen
// small PyTorch ops).
//
// What bounds it: every K/V element of the live context is read once and
// used for 2*G FLOPs (G = 8 for qwen2.5-3b: 8 FLOPs per byte), far below
// the card's ~295 FLOP/byte ridge, so it is bound by HBM bytes. The first
// version walked a split's 128 tokens one after another (one 2-byte load
// per thread per token in p*v, a table lookup and a division each), on a
// grid of 80 CTAs at the main path's shape: 0.1036 ms by CUDA events,
// 0.0984 ms of device time, 73x its bound (chip_smoke.py, H100 80GB
// HBM3 at 700 W). Design:
//   - the split is a function of the shape (``ops.pages_per_split``):
//     whole pages, 32 to 64 tokens, the longest that keeps B*Hkv*n_splits
//     at 264 CTAs (2 per SM) or more; 32-token splits at the main shape
//     give 304 CTAs, 17 of each (b, h)'s 19 live;
//   - the CTA reads its table entries and its length, then issues 16-byte
//     cp.async.cg copies of every live K row of its split for head h as
//     one commit group and every V row as a second, before it waits on
//     either: the split's bytes are in flight at once, and V's arrive
//     while the scores are formed. Rows are stored with a 16-byte-chunk
//     XOR swizzle so ldmatrix reads them without bank conflicts. The fp32
//     scores and bf16 P take over the K tile's space once S is formed, so
//     a 64-token split needs 32.5 KB and six CTAs fit on an SM;
//   - the trash block and the tail past lengths[b] are never read: dead
//     splits write (0, NEG_INF, 0) and return, and rows from lengths[b]
//     up to the next multiple of 16 are zeroed in shared memory;
//   - S^T = K Q^T and O^T = V^T P^T on mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate), the G query heads on the n = 8 side so no row of the
//     MMA is padding at G = 8 (G = 16 is two n-tiles; a G that is no
//     multiple of 8 pads with zero rows of Q): tokens are the M side of
//     S^T with dh the k side; dh is the M side of O^T (8 tiles of 16, two
//     per warp) with tokens the k side. K and V^T reach the MMAs through
//     ldmatrix (.trans for V^T), Q^T from global memory straight into
//     registers; the softmax between the two runs per head in fp32 over
//     shared memory and hands P to the second product in bf16;
//   - finite NEG_INF (-1e30), as in the TPU kernel, so the merge of a dead
//     split never forms -inf - -inf.
#include "split_merge.cuh"

using namespace split_kv;

namespace {

constexpr int ROW = DH * 2;         // bytes of one K/V row
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

// byte offset of 16-byte chunk c of row t in a staged K or V tile
__device__ __forceinline__ int swz(int t, int c) {
  return t * ROW + ((c ^ (t & 7)) << 4);
}

}  // namespace

// shared memory for splits of up to t16 rows (a multiple of 16): the K
// tile, whose space the fp32 scores [GMAX][t16 + 4] and bf16 p
// [GMAX][t16 + 8] take over once S is formed; the V tile; table entries
__host__ __device__ inline size_t region_a(int t16) {
  const size_t k = size_t(t16) * ROW;
  const size_t sp = size_t(GMAX) * (t16 + 4) * 4 + size_t(GMAX) * (t16 + 8) * 2;
  return k > sp ? k : sp;
}

static size_t smem_bytes(int t16) {
  return region_a(t16) + size_t(t16) * ROW + size_t(TMAX) * 4;
}

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
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = pages_per_split * Bs;
  const int t16 = (T + 15) & ~15;
  unsigned char* sK = smem;
  float* ss = reinterpret_cast<float*>(smem);   // over K, once S is formed
  const int srow = t16 + 4;
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(ss + GMAX * srow);
  const int prow = t16 + 8;
  unsigned char* sV = smem + region_a(t16);
  int* sblk = reinterpret_cast<int*>(sV + size_t(t16) * ROW);

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;          // fragment row within 8
  const int c2 = 2 * (lane & 3);     // fragment column pair

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

  const int n_pages = (n_live + Bs - 1) / Bs;
  for (int i = tid; i < n_pages; i += NTHREADS)
    sblk[i] = tables[size_t(b) * nb + size_t(sp) * pages_per_split + i];
  __syncthreads();

  // stage the live rows: K as one commit group, V as a second; rows from
  // n_live up to n16 are zeroed (never read from the pool)
  const int n16 = (n_live + 15) & ~15;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int c = tid & 15;             // this thread's 16-byte chunk
  for (int pass = 0; pass < 2; ++pass) {
    const __nv_bfloat16* pool = pass ? pool_v : pool_k;
    unsigned char* dst = pass ? sV : sK;
    for (int t = tid >> 4; t < n16; t += NTHREADS / 16) {
      if (t < n_live) {
        const int page = t / Bs;
        const __nv_bfloat16* src =
            pool + ((size_t(sblk[page]) * Bs + (t - page * Bs)) * Hkv + h) *
                       DH + c * 8;
        cp_async16(smem_u32(dst + swz(t, c)), src);
      } else {
        *reinterpret_cast<uint4*>(dst + swz(t, c)) = zero;
      }
    }
    cp_async_commit();
  }

  // Q^T as the B operand of S^T = K Q^T, straight from global memory:
  // b0 = q[head][16kk + c2, +1], b1 = the same 8 columns on; heads past G
  // are zero
  const int NT = (G + 7) >> 3;
  const __nv_bfloat16* qp = q + (size_t(b) * Hkv + h) * G * DH;
  uint32_t qf[NT_MAX][DH / 16][2];
#pragma unroll
  for (int nt = 0; nt < NT_MAX; ++nt) {
    const int head = nt * 8 + g8;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bool ok = nt < NT && head < G;
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(qp + head * DH + kk * 16 + c2);
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
        ldmatrix_x4(a, k_base + swz(t, 2 * kk + (lane >> 4)));
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

  // O^T = V^T P^T: warp w owns dh tiles 2w, 2w + 1; tokens are the k side
  float acc[2][NT_MAX][4] = {};
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
    for (int mi = 0; mi < 2; ++mi) {
      uint32_t a[4];
      ldmatrix_x4_trans(
          a, v_base + swz(t, (warp * 2 + mi) * 2 + ((lane >> 3) & 1)));
#pragma unroll
      for (int nt = 0; nt < NT_MAX; ++nt)
        if (nt < NT) mma_16816(acc[mi][nt], a, pb[nt]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nt = 0; nt < NT_MAX; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int head = nt * 8 + c2 + (e & 1);
        const int d = (warp * 2 + mi) * 16 + g8 + (e >> 1) * 8;
        if (nt < NT && head < G) op[head * DH + d] = acc[mi][nt][e];
      }
    }
  }
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
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem_bytes(TMAX)));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const int T = pages_per_split * Bs;
  if (G < 1 || G > GMAX || pages_per_split < 1 || Bs < 1 || T > TMAX)
    return int(cudaErrorInvalidValue);
  if (B <= 0 || n_splits <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  paged_decode_kernel<<<dim3(n_splits, Hkv, B), NTHREADS,
                        smem_bytes((T + 15) & ~15), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), Hkv, G, Bs, nb, pages_per_split, n_splits,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  split_merge_kernel<<<dim3(G, Hkv, B), NTHREADS, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<__nv_bfloat16*>(out),
      n_splits);
  return int(cudaGetLastError());
}
