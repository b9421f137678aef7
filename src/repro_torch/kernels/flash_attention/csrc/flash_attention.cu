// Causal GQA flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (`flash_attention_kernel`, body `_flash_kernel`): o = softmax(q k^T *
// scale, causal with q_offset) v, q [B,Sq,H,dh], k/v [B,Skv,Hkv,dh], query
// head h reading KV head h / (H/Hkv), bf16 in and out, fp32 online-softmax
// state.
//
// What bounds it: at prefill lengths the work is ~4*S^2/2*H*dh FLOPs over
// ~4*S*H*dh bytes, so it is bound by tensor-core throughput, not by HBM.
// Design, kept simple first:
//   - one CTA per (q tile of 64 rows, q head, batch); 4 warps, each owning
//     16 query rows, so the online softmax needs no CTA-wide reduction;
//   - the CTA loops over 64-key K/V tiles staged in shared memory (16-byte
//     vector loads, zero-filled past Skv) and stops at the last tile the
//     causal mask can reach, so tiles wholly in the future are skipped;
//   - Q K^T and P V run on the tensor cores through WMMA 16x16x16 bf16
//     fragments with fp32 accumulation; the score tile goes through shared
//     memory, where each pair of lanes owns one row for the masked,
//     exp2-based online softmax (m, l in fp32 registers, finite NEG_INF
//     and the m > 0.5*NEG_INF guard as in the TPU kernel);
//   - the output accumulator lives in shared memory in fp32 and is
//     rescaled by each tile's alpha before P V is added;
//   - the ragged edge (Sq or Skv not a multiple of 64) is masked here, so
//     prompts of any length run without padding.
// Not done yet (a later PR): cp.async/TMA double buffering, wgmma, keeping
// the accumulator in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int DH = 128;          // head dim (the wrapper checks it)
constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per K/V tile
constexpr int NWARPS = BQ / 16;  // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDH = DH + 8;      // bf16 row stride of the Q/K/V tiles
constexpr int LDS = BK + 4;      // fp32 row stride of the score tile
constexpr int LDP = BK + 8;      // bf16 row stride of the probability tile
constexpr int LDO = DH + 4;      // fp32 row stride of the output tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t SMEM_Q = size_t(BQ) * LDH * 2;
constexpr size_t SMEM_KV = size_t(BK) * LDH * 2;
constexpr size_t SMEM_S = size_t(BQ) * LDS * 4;
constexpr size_t SMEM_P = size_t(BQ) * LDP * 2;
constexpr size_t SMEM_O = size_t(BQ) * LDO * 4;
constexpr size_t OFF_K = SMEM_Q;
constexpr size_t OFF_V = OFF_K + SMEM_KV;
constexpr size_t OFF_S = OFF_V + SMEM_KV;
constexpr size_t OFF_P = OFF_S + SMEM_S;
constexpr size_t OFF_O = OFF_P + SMEM_P;
constexpr size_t SMEM_BYTES = OFF_O + SMEM_O;   // 112,640 bytes
static_assert(OFF_K % 32 == 0 && OFF_V % 32 == 0 && OFF_S % 32 == 0 &&
              OFF_P % 32 == 0 && OFF_O % 32 == 0,
              "WMMA tiles need 32-byte aligned bases");

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int Sq, int Skv, int H, int Hkv, int q_offset, int causal,
                 float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + OFF_K);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + OFF_V);
  float* sS = reinterpret_cast<float*>(smem + OFF_S);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + OFF_P);
  float* sO = reinterpret_cast<float*>(smem + OFF_O);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const size_t q_stride = size_t(H) * DH;    // between query positions
  const size_t kv_stride = size_t(Hkv) * DH;
  const __nv_bfloat16* qb = q + (size_t(b) * Sq * H + h) * DH;
  const __nv_bfloat16* kb = k + (size_t(b) * Skv * Hkv + hk) * DH;
  const __nv_bfloat16* vb = v + (size_t(b) * Skv * Hkv + hk) * DH;
  __nv_bfloat16* ob = o + (size_t(b) * Sq * H + h) * DH;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BQ * (DH / 8); i += NTHREADS) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    uint4 val = zero;
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qb + size_t(q0 + r) * q_stride + c);
    *reinterpret_cast<uint4*>(sQ + r * LDH + c) = val;
  }
  for (int i = tid; i < BQ * LDO; i += NTHREADS) sO[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * LDH + kk * 16, LDH);

  // lanes 2r and 2r+1 own row r of this warp's 16 rows; the pair splits
  // the row's columns (and output columns) between them, interleaved
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row_pos = q_offset + q0 + warp * 16 + r;   // absolute position
  float m_i = NEG_INF;
  float l_i = 0.f;
  float* sSw = sS + warp * 16 * LDS;
  __nv_bfloat16* sPw = sP + warp * 16 * LDP;
  float* sOw = sO + warp * 16 * LDO;

  const int q_last = min(Sq, q0 + BQ) - 1;
  const int kv_end = causal ? min(Skv, q_offset + q_last + 1) : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * (DH / 8); i += NTHREADS) {
      const int rr = i / (DH / 8);
      const int c = (i % (DH / 8)) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + rr < Skv) {
        const size_t off = size_t(k0 + rr) * kv_stride + c;
        kv = *reinterpret_cast<const uint4*>(kb + off);
        vv = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(sK + rr * LDH + c) = kv;
      *reinterpret_cast<uint4*>(sV + rr * LDH + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(sSw + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile (log2 domain)
    float sv[BK / 2];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = half + 2 * j;
      const int col = k0 + c;
      const bool ok = col < Skv && (!causal || col <= row_pos);
      const float s = ok ? sSw[r * LDS + c] * scale_log2 : NEG_INF;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = exp2f(m_i - m_new);
    const bool live = m_new > 0.5f * NEG_INF;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = live ? exp2f(sv[j] - m_new) : 0.f;
      rs += p;
      sPw[r * LDP + half + 2 * j] = __float2bfloat16(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_i = l_i * alpha + rs;
    m_i = m_new;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      float4* po = reinterpret_cast<float4*>(sOw + r * LDO + (half + 2 * j) * 8);
      float4 a = po[0], c = po[1];
      a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
      c.x *= alpha; c.y *= alpha; c.z *= alpha; c.w *= alpha;
      po[0] = a;
      po[1] = c;
    }
    __syncwarp();

    // O += P V
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sOw + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sPw + kk * 16, LDP);
        wmma::load_matrix_sync(vf, sV + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(sOw + n * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int qrow = q0 + warp * 16 + r;
  if (qrow < Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      const int c = (half + 2 * j) * 8;
      const float4 a = *reinterpret_cast<const float4*>(sOw + r * LDO + c);
      const float4 d = *reinterpret_cast<const float4*>(sOw + r * LDO + c + 4);
      __align__(16) __nv_bfloat162 outv[4];
      outv[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
      outv[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
      outv[2] = __floats2bfloat162_rn(d.x * inv, d.y * inv);
      outv[3] = __floats2bfloat162_rn(d.z * inv, d.w * inv);
      *reinterpret_cast<uint4*>(ob + size_t(qrow) * q_stride + c) =
          *reinterpret_cast<const uint4*>(outv);
    }
  }
}

}  // namespace

// q [B,Sq,H,128], k/v [B,Skv,Hkv,128], o [B,Sq,H,128]: contiguous bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Skv, int H, int Hkv, int q_offset,
                                   int causal, float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  if (Sq <= 0 || B <= 0) return 0;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Skv, H, Hkv, q_offset, causal, scale * LOG2E);
  return int(cudaGetLastError());
}
