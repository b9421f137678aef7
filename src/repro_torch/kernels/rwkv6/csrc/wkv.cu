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
// ~2.5 us. In practice the token loop is bound by shared-memory loads and
// instruction issue: every state element needs its row's r, k and w and
// its column's v each token, and on the card a warp's shared load cost
// time in proportion to the bytes each thread receives, whether or not
// the threads share one address. The first
// version (one CTA per (b, h), 32 CTAs for one prompt, four scalar shared
// loads per state row per token, a warp reduction on every token's serial
// chain, staging that stopped the CTA) took 0.1947 ms at the prefill
// shape (chip_smoke.py, H100 80GB HBM3 at 700 W). Design:
//   - the state's columns are spread over the card. Column j of S, and
//     y_j, depend only on column j of S, on v_j and on r, k, w, u, so the
//     grid is (B*H, N/CB) column blocks of CB = 16 (128 CTAs of 128
//     threads for one prompt at rwkv6-1.6b's heads). Each CTA reads its
//     head's r, k and logw (a small stream that L2 serves to the N/CB CTAs
//     of a head) and only its own columns of v and of the state, which
//     stays in registers across the tokens;
//   - thread (jc, p) holds an R x C = 4 x 2 block of the state: rows
//     4p .. 4p+3, columns jc, jc+1. Per token it makes four shared loads —
//     its 4 r and 4 k straight from the staged bf16 (8 bytes each), 4 w
//     (16 bytes) and 2 v (4 bytes) — for 8 state elements, where a 4 x 1
//     block needs as many loads for half the elements. r and k are used
//     in the bf16 they arrive in; only w = exp(logw) (exp of a value <= 0)
//     is formed, once per element and in place, before the tile runs;
//   - the u term, v_j (r_t . (u * k_t)), is folded into each thread's
//     partial from the r and k it has loaded (u of its rows sits in
//     registers), so no pass forms it;
//   - no reduction inside the token loop: each row-phase writes its
//     partial y of the token to shared memory (its token stride padded so
//     the write-out is free of bank conflicts), and the tile's write-out
//     sums the N/R partials and stores y as float4;
//   - the token loop is unrolled by 4 with the next token's loads issued
//     before the current token's arithmetic, so the one warp of each SM
//     sub-partition has independent work while its loads are in flight;
//   - tiles of TILE = 64 tokens of r, k, v (bf16 or fp32) and fp32 logw are
//     copied by 16-byte cp.async into two buffers: the next tile is in
//     flight while the current one runs;
//   - the token loop is the sequential recurrence itself, so a ragged S
//     runs to its end unpadded (the TPU wrapper pads with k = 0, logw = 0);
//   - each CTA reads its columns of the state before it writes them and
//     no other CTA touches them, so the final state may overwrite state0
//     in place (the decode step updates the engine's cache without a
//     copy).
// Not done yet: the loop still runs ~7x its bound at the prefill shape.
// The chunked matrix form (the TPU kernel's) would reuse each loaded value
// across a register block of products; on the tensor cores TF32 or bf16
// products of the fp32 state miss the 1e-4 tolerance against the
// sequential oracle, where only a 3xTF32 split could meet it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 4;        // state rows per thread
constexpr int C = 2;        // state columns per thread
constexpr int CB = 16;      // state columns per CTA
constexpr int TILE = 64;    // tokens staged per pass

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
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

// R = 4 and C = 2 values of the input type as one shared load each (8 and
// 4 bytes in bf16), kept packed until they are used
template <typename Tin> struct Packed;
template <> struct Packed<float> {
  using x4 = float4;
  using x2 = float2;
  __device__ static float4 f4(const float4& a) { return a; }
  __device__ static float2 f2(const float2& a) { return a; }
};
template <> struct Packed<__nv_bfloat16> {
  using x4 = uint2;
  using x2 = __nv_bfloat162;
  __device__ static float4 f4(const uint2& a) {
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&a.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&a.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  __device__ static float2 f2(const __nv_bfloat162& a) {
    return __bfloat1622float2(a);
  }
};

// The partial y of a token: N/R row-phases of CB columns, padded by 16
// floats so that two neighbouring tokens of the write-out fall in the two
// halves of the 32 banks.
template <int N>
__host__ __device__ constexpr int yp_stride() { return (N / R) * CB + 16; }

// Shared memory of a CTA for tiles of `tile` tokens, byte offsets: the
// row-phases' partial y [tile][yp_stride] fp32, then two buffers of inputs
// as cp.async lands them: r, k [tile][N] in Tin, logw [tile][N] fp32
// (turned into w in place), v [tile][CB] in Tin (this CTA's columns).
template <int N, typename Tin>
struct Layout {
  int tile;
  __host__ __device__ size_t raw_r() const {
    return size_t(tile) * yp_stride<N>() * 4;
  }
  __host__ __device__ size_t raw_k() const {
    return raw_r() + size_t(tile) * N * sizeof(Tin);
  }
  __host__ __device__ size_t raw_w() const {
    return raw_k() + size_t(tile) * N * sizeof(Tin);
  }
  __host__ __device__ size_t raw_v() const {
    return raw_w() + size_t(tile) * N * 4;
  }
  __host__ __device__ size_t raw_bytes() const {
    return raw_v() + size_t(tile) * CB * sizeof(Tin) - raw_r();
  }
  __host__ __device__ size_t bytes() const { return raw_r() + 2 * raw_bytes(); }
};

template <int N, typename Tin>
__global__ void __launch_bounds__(CB / C * (N / R))
wkv_kernel(const Tin* __restrict__ r,        // [B,S,H,N]
           const Tin* __restrict__ k,
           const Tin* __restrict__ v,
           const float* __restrict__ logw,   // [B,S,H,N]
           const float* __restrict__ u,      // [H,N]
           const float* s0,                  // [B,H,N,N] (may alias s_out)
           float* __restrict__ y,            // [B,S,H,N]
           float* s_out,                     // [B,H,N,N]
           int S, int H, int tile) {
  using Pk = Packed<Tin>;
  constexpr int P = N / R;                   // row-phases
  constexpr int NT = CB / C * P;
  constexpr int YT = yp_stride<N>();
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<N, Tin> L{tile};
  float* yp = reinterpret_cast<float*>(smem);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j0 = blockIdx.y * CB;            // this CTA's first column
  const int tid = threadIdx.x;
  const int jc = (tid % (CB / C)) * C;       // columns j0 + jc, + 1
  const int p = tid / (CB / C);              // rows p*R .. p*R + R-1

  const size_t tok = size_t(H) * N;          // between tokens of one head
  const size_t base = size_t(b) * S * tok + size_t(h) * N;
  const int n_tiles = (S + tile - 1) / tile;

  // cp.async of tile n's inputs into buffer `buf`, one commit group
  auto stage = [&](int n, int buf) {
    unsigned char* raw = smem + size_t(buf) * L.raw_bytes();
    const int t0 = n * tile;
    const int cnt = min(tile, S - t0);
    constexpr int CR = N * int(sizeof(Tin)) / 16;   // chunks of r or k
    constexpr int CW = N * 4 / 16;                  // of logw
    constexpr int CV = CB * int(sizeof(Tin)) / 16;  // of this CTA's v
    for (int e = tid; e < cnt * CR; e += NT) {
      const int t = e / CR, c = e % CR;
      const size_t g = base + size_t(t0 + t) * tok;
      const size_t o = size_t(t) * N * sizeof(Tin) + c * 16;
      cp_async16(raw + L.raw_r() + o,
                 reinterpret_cast<const char*>(r + g) + c * 16);
      cp_async16(raw + L.raw_k() + o,
                 reinterpret_cast<const char*>(k + g) + c * 16);
    }
    for (int e = tid; e < cnt * CW; e += NT) {
      const int t = e / CW, c = e % CW;
      const size_t g = base + size_t(t0 + t) * tok;
      cp_async16(raw + L.raw_w() + size_t(t) * N * 4 + c * 16,
                 reinterpret_cast<const char*>(logw + g) + c * 16);
    }
    for (int e = tid; e < cnt * CV; e += NT) {
      const int t = e / CV, c = e % CV;
      const size_t g = base + size_t(t0 + t) * tok + j0;
      cp_async16(raw + L.raw_v() + size_t(t) * CB * sizeof(Tin) + c * 16,
                 reinterpret_cast<const char*>(v + g) + c * 16);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) stage(0, 0);
  const float4 uq = *reinterpret_cast<const float4*>(u + h * N + p * R);
  // this thread's R x C block of the state
  const size_t sbase = size_t(bh) * N * N + size_t(p) * R * N + j0 + jc;
  float2 st[R];
#pragma unroll
  for (int q = 0; q < R; ++q)
    st[q] = *reinterpret_cast<const float2*>(s0 + sbase + size_t(q) * N);

  for (int n = 0; n < n_tiles; ++n) {
    const int cnt = min(tile, S - n * tile);
    if (n + 1 < n_tiles) {
      stage(n + 1, (n + 1) & 1);
      cp_async_wait<1>();                    // tile n's copies are in
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // ... everyone's; and tile
                                             // n-1's write-out is done
    unsigned char* raw = smem + size_t(n & 1) * L.raw_bytes();
    const Tin* rr = reinterpret_cast<const Tin*>(raw + L.raw_r());
    const Tin* kr = reinterpret_cast<const Tin*>(raw + L.raw_k());
    float* wr = reinterpret_cast<float*>(raw + L.raw_w());
    const Tin* vr = reinterpret_cast<const Tin*>(raw + L.raw_v());
    for (int e = tid; e < cnt * (N / 4); e += NT) {   // w = exp(logw <= 0)
      float4 w = reinterpret_cast<float4*>(wr)[e];
      w = make_float4(expf(w.x), expf(w.y), expf(w.z), expf(w.w));
      reinterpret_cast<float4*>(wr)[e] = w;
    }
    __syncthreads();

    // the recurrence over the tile's tokens. Per token a thread loads r, k
    // and w of its R rows and v of its C columns (four shared loads) and
    // writes its C partial y; token t+1's loads are issued before token t
    // is run, so their latency hides behind its arithmetic.
    typename Pk::x4 rn, kn;
    typename Pk::x2 vn;
    float4 wn;
    auto fetch = [&](int t) {
      const int i = t * N + p * R;
      rn = *reinterpret_cast<const typename Pk::x4*>(rr + i);
      kn = *reinterpret_cast<const typename Pk::x4*>(kr + i);
      wn = *reinterpret_cast<const float4*>(wr + i);
      vn = *reinterpret_cast<const typename Pk::x2*>(vr + t * CB + jc);
    };
    fetch(0);
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const float4 r4 = Pk::f4(rn), k4 = Pk::f4(kn), w4 = wn;
      const float2 v2 = Pk::f2(vn);
      if (t + 1 < cnt) fetch(t + 1);
      const float rq[R] = {r4.x, r4.y, r4.z, r4.w};
      const float kq[R] = {k4.x, k4.y, k4.z, k4.w};
      const float wq[R] = {w4.x, w4.y, w4.z, w4.w};
      const float ukq[R] = {uq.x * k4.x, uq.y * k4.y, uq.z * k4.z,
                            uq.w * k4.w};
      // y_j += sum over the rows of r_i (S_ij + u_i k_i v_j)
      float ruk = 0.f;
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        ruk = fmaf(rq[q], ukq[q], ruk);
        acc.x = fmaf(rq[q], st[q].x, acc.x);
        acc.y = fmaf(rq[q], st[q].y, acc.y);
        st[q].x = fmaf(wq[q], st[q].x, kq[q] * v2.x);
        st[q].y = fmaf(wq[q], st[q].y, kq[q] * v2.y);
      }
      acc.x = fmaf(ruk, v2.x, acc.x);
      acc.y = fmaf(ruk, v2.y, acc.y);
      *reinterpret_cast<float2*>(yp + t * YT + p * CB + jc) = acc;
    }
    __syncthreads();

    // y = the sum of the row-phases' partials, float4 stores
    for (int e = tid; e < cnt * (CB / 4); e += NT) {
      const int t = e / (CB / 4), c4 = (e % (CB / 4)) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float4 x =
            *reinterpret_cast<const float4*>(yp + t * YT + q * CB + c4);
        a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
      }
      *reinterpret_cast<float4*>(
          y + base + size_t(n * tile + t) * tok + j0 + c4) = a;
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q)
    *reinterpret_cast<float2*>(s_out + sbase + size_t(q) * N) = st[q];
}

template <int N, typename Tin>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* s0,
                   float* y, float* s_out, int B, int S, int H,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<N, Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(Layout<N, Tin>{TILE}.bytes()));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tile = S < 1 ? 1 : (S < TILE ? S : TILE);
  wkv_kernel<N, Tin><<<dim3(B * H, N / CB), CB / C * (N / R),
                       Layout<N, Tin>{tile}.bytes(), stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), logw, u, s0, y, s_out, S, H, tile);
  return cudaGetLastError();
}

}  // namespace

// Every pointer 16-byte aligned (the wrapper checks them);
// returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// head size or input type the kernel is not built for.
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
