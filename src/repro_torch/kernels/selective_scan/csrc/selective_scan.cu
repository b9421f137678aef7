// Selective scan for Hopper, sm_90a: a prompt's SSM recurrence, one launch
// a layer (Jamba's Mamba-1 mixer and hymba's SSM branch).
//
// It replaces no TPU kernel. The JAX package runs this recurrence with
// XLA's associative_scan (repro/models/ssm.py) and has no Pallas kernel
// for it. The port's plain version, repro_torch/models/ssm.py `_scan`,
// builds [B, 256, di, ds] fp32 chunks and composes them by a doubling
// scan whose products and concatenations move ~17 GB of device memory a
// 256-position chunk at Jamba's width (di 8,192, ds 16): on an H100, ~20
// ms a layer at S = 1,024, 87% of a Jamba prefill's device time. That is
// why it was added. For every sequence b, channel c and state n, from h0:
//
//     h_t[c,n] = exp(delta_t[c] A[c,n]) h_{t-1}[c,n] + delta_t[c] x_t[c] B_t[n]
//     y_t[c]   = sum_n C_t[n] h_t[c,n]
//
// returning y [B,S,di] and the last h [B,di,ds], all fp32. delta is one
// value per channel, [B,S,di] (Jamba), or one shared channel, [B,S]
// (hymba), read with channel stride 0.
//
// What bounds it: bytes. It reads x and delta (S di fp32 each), B and C
// (S ds each), A and h0, and writes y and the last h: ~98 MB at B = 1,
// S = 1,024, di = 8,192, ds = 16, 0.029 ms at 3.35 TB/s. The S di ds =
// 134 M state updates of ~9 operations take 0.018 ms at 67 TFLOP/s; their
// exponentials run on the special-function units (16 a clock an SM),
// 0.035 ms for one per update. Design:
//   - time is split as well as channels. One thread per channel gives only
//     8,192 threads at B = 1 (two warps an SM), each walking 1-2k
//     dependent steps. Here a CTA of 256 threads takes 32 channels of one
//     sequence; thread (c, j) holds channel c's 16 states in registers and
//     runs segment j, 16 consecutive positions, of each 128-position tile;
//   - per tile, pass 1 composes each segment from the zero state: its
//     (prod a, h) per state, prod a as exp2 of the summed delta times A.
//     An inclusive scan of the (a, b) operator over the 8 lanes that hold
//     one channel (shuffles, 3 steps) gives each segment its state on entry
//     from the carry, the state before the tile. Pass 2 runs the segment
//     again from that state, summing C.h over the 16 states in registers
//     for each position's y, so y needs no reduction across threads. The
//     last segment's final state, shuffled to the others, carries the
//     channel into the next tile. The cost is a second exponential per
//     update, which makes the special-function units, not the bytes, the
//     bound (~0.07 ms at S = 1,024);
//   - x, delta, B and C of a tile are copied into shared memory by cp.async
//     (16 bytes a copy; 4 for a shared delta), double-buffered: tile n+1 is
//     in flight while tile n runs. Each segment's rows are padded so that
//     the 8 lanes of a channel, which read rows 16 positions apart, fall in
//     different banks;
//   - y is written over the tile's x in shared memory (each thread
//     overwrites only the x it has read) and stored from there as float4
//     rows: no [.., ds]-wide tensor touches device memory, only y and the
//     last h are written;
//   - exp is exp2f of delta times A log2(e), in fp32; no value is ever
//     held in half precision;
//   - any S >= 1 runs unpadded: positions past S are not run, and a
//     segment with none passes the state through.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPB = 32;                 // channels per CTA
constexpr int NSEG = 8;                 // segments per tile: lanes a channel
constexpr int ITEMS = 16;               // positions per segment
constexpr int TILE = NSEG * ITEMS;      // positions per tile
constexpr int NT = CPB * NSEG;          // threads per CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One buffer of shared memory, in floats: x (then y) and a per-channel
// delta as [NSEG][ITEMS][CPB], B and C as [NSEG][ITEMS][DS], a shared delta
// as [NSEG][ITEMS]; each segment padded (SX, SB: 4 floats, 16 bytes, so
// rows stay 16-byte aligned; SD: 1) so that the 8 segments' rows fall in
// different banks.
template <int DS, bool SHARED_DT>
struct Layout {
  static constexpr int SX = ITEMS * CPB + 4;
  static constexpr int SD = SHARED_DT ? ITEMS + 1 : SX;
  static constexpr int SB = ITEMS * DS + 4;
  static constexpr int X = 0;
  static constexpr int D = X + NSEG * SX;
  static constexpr int B = D + (NSEG * SD + 3) / 4 * 4;
  static constexpr int C = B + NSEG * SB;
  static constexpr int BUF = C + NSEG * SB;
  static constexpr size_t bytes = 2 * size_t(BUF) * sizeof(float);
};

template <int DS, bool SHARED_DT>
__global__ void __launch_bounds__(NT, 2)
selective_scan_kernel(const float* __restrict__ x,      // [B,S,di]
                      const float* __restrict__ delta,  // [B,S,di] or [B,S]
                      const float* __restrict__ A,      // [di,DS]
                      const float* __restrict__ Bm,     // [B,S,DS]
                      const float* __restrict__ Cm,     // [B,S,DS]
                      const float* __restrict__ h0,     // [B,di,DS]
                      float* __restrict__ y,            // [B,S,di]
                      float* __restrict__ h_out,        // [B,di,DS]
                      int S, int di) {
  using L = Layout<DS, SHARED_DT>;
  constexpr int DSTEP = SHARED_DT ? 1 : CPB;     // delta between positions
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int tid = threadIdx.x;
  const int j = tid % NSEG;                      // segment
  const int cl = tid / NSEG;                     // channel in the CTA
  const int c = c0 + cl;
  const bool live = c < di;
  const size_t row0 = size_t(b) * S;             // the sequence's first row
  const int n_tiles = (S + TILE - 1) / TILE;

  // cp.async of tile n's x, delta, B and C into buffer `buf`, one group
  auto stage = [&](int n, int buf) {
    float* base = smem + buf * L::BUF;
    const int t0 = n * TILE;
    const int cnt = min(TILE, S - t0);
    for (int e = tid; e < cnt * (CPB / 4); e += NT) {
      const int t = e / (CPB / 4), q = (e % (CPB / 4)) * 4;
      if (c0 + q >= di) continue;
      const size_t g = (row0 + t0 + t) * size_t(di) + c0 + q;
      const int o = (t / ITEMS) * L::SX + (t % ITEMS) * CPB + q;
      cp_async16(base + L::X + o, x + g);
      if (!SHARED_DT) cp_async16(base + L::D + o, delta + g);
    }
    if (SHARED_DT)
      for (int t = tid; t < cnt; t += NT)
        cp_async4(base + L::D + (t / ITEMS) * L::SD + t % ITEMS,
                  delta + row0 + t0 + t);
    for (int e = tid; e < cnt * (DS / 4); e += NT) {
      const int t = e / (DS / 4), q = (e % (DS / 4)) * 4;
      const size_t g = (row0 + t0 + t) * DS + q;
      const int o = (t / ITEMS) * L::SB + (t % ITEMS) * DS + q;
      cp_async16(base + L::B + o, Bm + g);
      cp_async16(base + L::C + o, Cm + g);
    }
    cp_async_commit();
  };

  stage(0, 0);
  // A in log2 units and the state carried between tiles, in registers
  float a2[DS], carry[DS];
#pragma unroll
  for (int q = 0; q < DS; q += 4) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), hv = av;
    if (live) {
      av = *reinterpret_cast<const float4*>(A + size_t(c) * DS + q);
      hv = *reinterpret_cast<const float4*>(
          h0 + (size_t(b) * di + c) * DS + q);
    }
    a2[q] = av.x * LOG2E, a2[q + 1] = av.y * LOG2E;
    a2[q + 2] = av.z * LOG2E, a2[q + 3] = av.w * LOG2E;
    carry[q] = hv.x, carry[q + 1] = hv.y;
    carry[q + 2] = hv.z, carry[q + 3] = hv.w;
  }

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait_all();
    __syncthreads();          // tile n is in for all; tile n-1 is written
    if (n + 1 < n_tiles) stage(n + 1, (n + 1) & 1);
    float* base = smem + (n & 1) * L::BUF;
    float* xs = base + L::X + j * L::SX + cl;    // position i at i * CPB
    const float* dl = base + L::D + j * L::SD + (SHARED_DT ? 0 : cl);
    const float* bs = base + L::B + j * L::SB;   // position i at i * DS
    const float* cs = base + L::C + j * L::SB;
    const int m = max(0, min(ITEMS, S - n * TILE - j * ITEMS));

    // pass 1: the segment from the zero state
    float h[DS], p[DS];
#pragma unroll
    for (int k = 0; k < DS; ++k) h[k] = 0.f;
    float dsum = 0.f;
    for (int i = 0; i < m; ++i) {
      const float d = dl[i * DSTEP];
      const float dx = d * xs[i * CPB];
      dsum += d;
#pragma unroll
      for (int q = 0; q < DS; q += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + i * DS + q);
        const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
          h[q + r] = fmaf(exp2f(d * a2[q + r]), h[q + r], dx * bq[r]);
      }
    }
#pragma unroll
    for (int k = 0; k < DS; ++k) p[k] = exp2f(dsum * a2[k]);

    // the segments' (prod a, h) composed over the channel's 8 lanes: an
    // inclusive scan of (p1, h1) then (p2, h2) -> (p1 p2, p2 h1 + h2)
#pragma unroll
    for (int off = 1; off < NSEG; off *= 2) {
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        const float pl = __shfl_up_sync(FULL, p[k], off, NSEG);
        const float hl = __shfl_up_sync(FULL, h[k], off, NSEG);
        if (j >= off) {
          h[k] = fmaf(p[k], hl, h[k]);
          p[k] *= pl;
        }
      }
    }
    // the state on entry to this segment: the carry through the
    // segments before it
#pragma unroll
    for (int k = 0; k < DS; ++k) {
      const float pe = __shfl_up_sync(FULL, p[k], 1, NSEG);
      const float he = __shfl_up_sync(FULL, h[k], 1, NSEG);
      h[k] = j == 0 ? carry[k] : fmaf(pe, carry[k], he);
    }

    // pass 2: the segment from that state; y over the states in registers,
    // written over the x it was computed from
    for (int i = 0; i < m; ++i) {
      const float d = dl[i * DSTEP];
      const float dx = d * xs[i * CPB];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < DS; q += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + i * DS + q);
        const float4 cv = *reinterpret_cast<const float4*>(cs + i * DS + q);
        const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          h[q + r] = fmaf(exp2f(d * a2[q + r]), h[q + r], dx * bq[r]);
          acc = fmaf(cq[r], h[q + r], acc);
        }
      }
      xs[i * CPB] = acc;
    }
    // the last segment ends the tile: its state is the next tile's carry
#pragma unroll
    for (int k = 0; k < DS; ++k)
      carry[k] = __shfl_sync(FULL, h[k], NSEG - 1, NSEG);
    __syncthreads();

    // y of the tile, as float4 rows of the CTA's channels
    const int t0 = n * TILE;
    const int cnt = min(TILE, S - t0);
    for (int e = tid; e < cnt * (CPB / 4); e += NT) {
      const int t = e / (CPB / 4), q = (e % (CPB / 4)) * 4;
      if (c0 + q >= di) continue;
      const float4 v = *reinterpret_cast<const float4*>(
          base + L::X + (t / ITEMS) * L::SX + (t % ITEMS) * CPB + q);
      *reinterpret_cast<float4*>(
          y + (row0 + t0 + t) * size_t(di) + c0 + q) = v;
    }
  }
  if (live && j == 0) {
#pragma unroll
    for (int q = 0; q < DS; q += 4)
      *reinterpret_cast<float4*>(h_out + (size_t(b) * di + c) * DS + q) =
          make_float4(carry[q], carry[q + 1], carry[q + 2], carry[q + 3]);
  }
}

template <int DS, bool SHARED_DT>
cudaError_t launch(const float* x, const float* delta, const float* A,
                   const float* Bm, const float* Cm, const float* h0,
                   float* y, float* h_out, int B, int S, int di,
                   cudaStream_t stream) {
  using L = Layout<DS, SHARED_DT>;
  const cudaError_t err = cudaFuncSetAttribute(
      selective_scan_kernel<DS, SHARED_DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (err != cudaSuccess) return err;
  selective_scan_kernel<DS, SHARED_DT>
      <<<dim3((di + CPB - 1) / CPB, B), NT, L::bytes, stream>>>(
          x, delta, A, Bm, Cm, h0, y, h_out, S, di);
  return cudaGetLastError();
}

}  // namespace

// Every pointer 16-byte aligned and every tensor contiguous, di a multiple
// of 4 (the wrapper checks them); returns cudaGetLastError() after the
// launch; cudaErrorInvalidValue for a state size the kernel is not built
// for or an empty shape.
extern "C" int selective_scan_fwd(const void* x, const void* delta,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* h0, void* y,
                                  void* h_out, int B, int S, int di, int ds,
                                  int shared_delta, void* stream) {
  auto xx = static_cast<const float*>(x);
  auto dd = static_cast<const float*>(delta);
  auto aa = static_cast<const float*>(A);
  auto bb = static_cast<const float*>(Bm);
  auto cc = static_cast<const float*>(Cm);
  auto hh = static_cast<const float*>(h0);
  auto yy = static_cast<float*>(y);
  auto ho = static_cast<float*>(h_out);
  auto cs = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || di <= 0 || di % 4) return int(cudaErrorInvalidValue);
  if (ds == 16)
    return int(shared_delta
                   ? launch<16, true>(xx, dd, aa, bb, cc, hh, yy, ho, B, S,
                                      di, cs)
                   : launch<16, false>(xx, dd, aa, bb, cc, hh, yy, ho, B, S,
                                       di, cs));
  return int(cudaErrorInvalidValue);
}
