// RWKV-6 WKV recurrence for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/rwkv6/rwkv6.py (`wkv_kernel`, body
// `_wkv_kernel`): for every sequence b and head h, with the fp32 state S
// [N,N] starting at state0,
//
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,     w_t = exp(logw_t) <= 1
//
// returning y [B,S,H,N] fp32 for every token and the final state. r, k, v
// are bf16 (the model) or fp32 (tests); logw, u and the state are fp32.
// Inputs stay in the model's [B,S,H,N] layout: the kernel computes its own
// offsets, so the wrapper makes no transposed copy.
//
// What bounds it: per token and head it reads 3N bf16 + N fp32 values and
// writes N fp32, and does ~5N^2 fp32 operations on the state. At the
// prefill shape (B=1, S=512, H=32, N=64) that is ~16 MB and ~340 MFLOP:
// ~5 us either way (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores). At the
// decode shape (B=8, S=1) it is the state, read and written once: 8.4 MB,
// ~2.5 us.
//
// Design (simple first):
//   - one CTA per (b, h); the TPU kernel's sequential chunk axis becomes a
//     loop over tokens inside the CTA, and the state never leaves
//     registers between tokens (the TPU kernel keeps it in VMEM scratch);
//   - N*P threads: thread (j, p) holds rows i = p, p+P, ... of column j of
//     S (N/P fp32 registers); its partial y_j is summed over the P lanes
//     of column j with two warp shuffles;
//   - tokens are staged TILE at a time in shared memory with coalesced
//     loads (a token's N values of one head are contiguous), with
//     w = exp(logw) computed once per element (exp of a value <= 0 only);
//     y is staged the same way and written coalesced;
//   - the token loop is the sequential recurrence itself, so a ragged S
//     runs to its end unpadded (the TPU wrapper pads with k = 0, logw = 0);
//   - each CTA reads its whole state before it writes any of it, so the
//     final state may overwrite state0 in place (the decode step updates
//     the engine's cache without a copy).
// Not done yet (a later PR): only B*H CTAs (32 for one prompt) walk the
// tokens one by one; the chunked matrix form on tensor cores would spread
// a prompt over the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int P = 4;        // threads per state column
constexpr int TILE = 32;    // tokens staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N, typename Tin>
__global__ void __launch_bounds__(N * P)
wkv_kernel(const Tin* __restrict__ r,        // [B,S,H,N]
           const Tin* __restrict__ k,
           const Tin* __restrict__ v,
           const float* __restrict__ logw,   // [B,S,H,N]
           const float* __restrict__ u,      // [H,N]
           const float* s0,                  // [B,H,N,N] (may alias s_out)
           float* __restrict__ y,            // [B,S,H,N]
           float* s_out,                     // [B,H,N,N]
           int S, int H) {
  constexpr int R = N / P;                   // state rows per thread
  constexpr int NT = N * P;
  __shared__ float rs[TILE][N], ks[TILE][N], ws[TILE][N], vs[TILE][N];
  __shared__ float ys[TILE][N];
  __shared__ float us[N];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int j = tid / P;                     // state column
  const int p = tid % P;                     // row phase

  if (tid < N) us[tid] = u[h * N + tid];
  const size_t sbase = size_t(bh) * N * N;
  float st[R];
#pragma unroll
  for (int q = 0; q < R; ++q) st[q] = s0[sbase + size_t(p + P * q) * N + j];

  const size_t tok_stride = size_t(H) * N;   // between tokens of one head
  const size_t base = size_t(b) * S * tok_stride + size_t(h) * N;
  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int n = min(TILE, S - t0);
    for (int e = tid; e < n * N; e += NT) {
      const int t = e / N, i = e - (e / N) * N;
      const size_t g = base + size_t(t0 + t) * tok_stride + i;
      rs[t][i] = to_f32(r[g]);
      ks[t][i] = to_f32(k[g]);
      vs[t][i] = to_f32(v[g]);
      ws[t][i] = expf(logw[g]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = p + P * q;
        const float kv = ks[t][i] * vj;
        acc += rs[t][i] * (st[q] + us[i] * kv);
        st[q] = ws[t][i] * st[q] + kv;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (p == 0) ys[t][j] = acc;
    }
    __syncthreads();
    for (int e = tid; e < n * N; e += NT) {
      const int t = e / N, i = e - (e / N) * N;
      y[base + size_t(t0 + t) * tok_stride + i] = ys[t][i];
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) s_out[sbase + size_t(p + P * q) * N + j] = st[q];
}

template <int N, typename Tin>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* s0,
                   float* y, float* s_out, int B, int S, int H,
                   cudaStream_t stream) {
  wkv_kernel<N, Tin><<<B * H, N * P, 0, stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), logw, u, s0, y, s_out, S, H);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// a head size or input type the kernel is not built for.
extern "C" int wkv_fwd(const void* r, const void* k, const void* v,
                       const void* logw, const void* u, const void* s0,
                       void* y, void* s_out, int B, int S, int H, int N,
                       int inputs_bf16, void* stream) {
  auto lw = static_cast<const float*>(logw);
  auto uu = static_cast<const float*>(u);
  auto st0 = static_cast<const float*>(s0);
  auto yy = static_cast<float*>(y);
  auto so = static_cast<float*>(s_out);
  auto cs = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S < 0) return int(cudaErrorInvalidValue);
  if (N == 64)
    return int(inputs_bf16
                   ? launch<64, __nv_bfloat16>(r, k, v, lw, uu, st0, yy, so,
                                               B, S, H, cs)
                   : launch<64, float>(r, k, v, lw, uu, st0, yy, so, B, S,
                                       H, cs));
  if (N == 32)
    return int(inputs_bf16
                   ? launch<32, __nv_bfloat16>(r, k, v, lw, uu, st0, yy, so,
                                               B, S, H, cs)
                   : launch<32, float>(r, k, v, lw, uu, st0, yy, so, B, S,
                                       H, cs));
  return int(cudaErrorInvalidValue);
}
