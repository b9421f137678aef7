// Causal GQA flash attention (prefill) for Hopper, sm_90a: wgmma, TMA and
// GQA row packing.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (`flash_attention_kernel`, body `_flash_kernel`): o = softmax(q k^T *
// scale, causal with q_offset) v, q [B,Sq,H,dh], k/v [B,Skv,Hkv,dh], query
// head h reading KV head h / G (G = H/Hkv), bf16 in and out, fp32
// online-softmax state.
//
// What bounds it: at prefill lengths the work is ~4*S^2/2*H*dh FLOPs over
// ~4*S*H*dh bytes, so it is bound by tensor-core throughput (989 TFLOP/s
// bf16), not by HBM. The version it replaces (WMMA 16x16x16, one query
// head per CTA, the score tile and the fp32 output tile through shared
// memory on every K/V tile, synchronous K/V loads) took 0.0556 ms of
// device time at S=512 and 1.2602 ms at S=4096 (CUDA events), 16/2 heads,
// against 0.0695 ms of tensor-core bound at S=4096 (chip_smoke.py, H100
// 80GB HBM3 at 700 W).
// Design:
//   - GQA row packing: a CTA serves one (batch, KV head) pair and 64
//     packed query rows; row r is position p0 + r/G of query head
//     hk*G + r%G. The G heads of one position are contiguous in q, so the
//     Q tile is P = floor(64/G) contiguous [G,dh] blocks (one TMA box),
//     each K/V tile is read once for all G heads, and a 16-row chunk at
//     G = 8 fills 128 rows instead of 16 of 64;
//   - any G from 1 to 16 (H % Hkv == 0): where G does not divide 64 the
//     box fills G*P < 64 rows (60 at G = 5, qwen3-14b's 40/8 heads) and
//     the rows past it are dead. They are zeroed in shared memory once,
//     before the Q box lands (the box never writes them), so their scores
//     are finite and touch no live row; their outputs are never stored;
//     and bar_q expects the box's own (dh/64)*G*P*128 bytes. Padding each
//     position's heads to the next power of two instead would waste 3 of
//     every 8 rows at G = 5 (40 positions of 64 rows against 12 of 60)
//     and launch half as many CTAs again;
//   - one consumer warpgroup (4 warps, 16 rows each) runs both products
//     on wgmma with the accumulators in registers: S = Q K^T as dh/16
//     m64n64k16 (Q and K K-major from shared memory), then O += P V as 4
//     m64n{dh}k16 with P, converted to bf16 in registers, as the register
//     A operand and V [keys,dh] the MN-major (transposed) B operand. O
//     stays in fp32 registers from the first K/V tile to the epilogue;
//   - the online softmax runs on the score fragment: row max and row sum
//     over the quad that shares a row, exp2 with the scale folded into one
//     FMA, the finite NEG_INF and the m > 0.5*NEG_INF guard of the TPU
//     kernel, and no rescale pass once a row's max has settled. Only a
//     tile that crosses Skv or the causal diagonal is masked (key column
//     <= q_offset + position, per packed row);
//   - software pipelining inside the warpgroup: S for tile j is issued
//     together with P V for tile j-1, so the softmax of tile j runs while
//     P V of tile j-1 is on the tensor cores; two CTAs per SM (80 KB of
//     shared memory, 160 threads, no spills) fill each other's gaps;
//   - a producer warp keeps K and V tiles in flight by TMA into a ring of 2
//     stages, with full/empty mbarriers for K and V apart (K is released
//     as soon as S is formed). The tensor maps are 4-D over [B,S,Hkv,128]
//     (and [B,Sq,H,128] for Q), so rows past Skv (or Sq) are zero-filled
//     by the hardware instead of read from the next sequence; each row
//     tile is dh/64 64-column boxes with SWIZZLE_128B, the layout wgmma's
//     descriptors read. The maps are encoded on the host per call, reached
//     through cudaGetDriverEntryPoint (no -lcuda), and passed as
//     __grid_constant__ parameters;
//   - the causal K/V loop ends at the tile's last position, and the
//     heaviest tiles (the last positions) are launched first;
//   - the epilogue stages O in bf16 through the Q tile's shared memory
//     (an XOR swizzle keeps it free of bank conflicts) and writes 16-byte
//     rows, skipping positions past Sq.
//   - the head dim is a template parameter with two instantiations, 128
//     (qwen2.5-3b, the 14B models) and 64 (granite-moe-1b-a400m, 16/8
//     heads, G = 2). At dh = 64 a row tile is one box: Q K^T takes 4
//     k-steps, P V runs on m64n64k16 (RS), O is 32 fp32 registers a thread
//     instead of 64, a K or V stage is 8 KB, and the epilogue's rows are
//     128 bytes (8 chunks, the XOR swizzle within them). The dh = 128
//     instantiation keeps its 144 registers and its time (PERF.md).
// What holds it back now (PERF.md): the softmax is only partly hidden —
// without it the loop runs at ~66% of the tensor-core peak, with it ~45%.
// At dh = 64 the products per score halve while the softmax's work per
// score stays, so the softmax weighs twice as much against them; at
// granite's prefill (S = 512, 16/8 heads: 128 CTAs of 32 positions, up to
// 8 K/V tiles each) the bound is bytes (~1 us) and the time is the CTAs'
// serial walk and the launch. The halved shared memory (40 KB) and
// registers would allow a deeper ring or a second consumer warpgroup:
// not taken, one instantiation of the same design first.
#include <cuda.h>          // CUtensorMap and its enums only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;              // keys per K/V tile
constexpr uint32_t KV_HALF = 64 * 64 * 2;   // one 64x64 bf16 box
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int BM = 64;              // packed query rows per CTA
constexpr int STAGES = 2;           // K/V ring depth
constexpr int NCONSUMER = 128;      // one warpgroup
constexpr int NTHREADS = NCONSUMER + 32;    // + the producer warp
constexpr uint32_t Q_HALF = BM * 128;       // a 64-column box of Q

// The shared-memory layout of the head-dim-DH instantiation (DH = 64 or
// 128, the wrapper checks it): each row tile is NH 64-column SW128 boxes,
// Q at 0, then the K ring, the V ring and the mbarriers
template <int DH>
struct Layout {
  static_assert(DH == 64 || DH == 128, "head dim 64 or 128");
  static constexpr int NH = DH / 64;                 // 64-column boxes
  static constexpr uint32_t KV_BYTES = NH * KV_HALF; // a 64 x DH K or V tile
  static constexpr uint32_t OFF_K = NH * Q_HALF;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr size_t SMEM_BYTES = OFF_BAR + (1 + 4 * STAGES) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spins on the phase; a wait that lasts seconds (a pipeline fault) traps,
// so it surfaces as a launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a SWIZZLE_128B tile (1024-byte
// aligned atoms of 8 rows x 128 bytes). K-major: lbo unused, sbo = 1024
// (the next 8 rows). MN-major: lbo = the next 64-element chunk along MN,
// sbo = the next 8 rows along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin registers that an asynchronous wgmma reads or writes, so the
// compiler does not move their uses across the issue or the wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void consumer_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONSUMER) : "memory");
}

// D[64x64] (+)= A[64x16] * B[16x64], A and B from shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64x64] (+)= A[64x16] * B[16x64], A from registers (bf16 pairs in the
// accumulator's layout), B from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64x128] (+)= A[64x16] * B[16x128], A from registers (bf16 pairs in the
// accumulator's layout), B from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a,
                                                    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}


// S = Q K^T over DH: DH/16 k-steps, 4 in each 64-column box of Q and K
template <int DH>
__device__ __forceinline__ void issue_qk(float* s, uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_m64n64k16_ss(s, sw128_desc(sq + (kk / 4) * Q_HALF + col, 16, 1024),
                       sw128_desc(sk + (kk / 4) * KV_HALF + col, 16, 1024),
                       kk > 0);
  }
}

// O += P V over 64 keys: 4 k-steps of 16 keys (two 8-row atoms each); at
// DH = 128 the two 64-column boxes of V are the MN chunks, KV_HALF apart
// (m64n128k16), at DH = 64 the one box is the whole N side (m64n64k16)
template <int DH>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* p,
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = sw128_desc(sv + kk * 2048, KV_HALF, 1024);
    if constexpr (DH == 128)
      wgmma_m64n128k16_rs(o, p + 4 * kk, db, 1);
    else
      wgmma_m64n64k16_rs(o, p + 4 * kk, db, 1);
  }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                 int G, int q_offset, int causal, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  using Lay = Layout<DH>;
  constexpr int NH = Lay::NH;
  constexpr uint32_t KV_BYTES = Lay::KV_BYTES;
  const uint32_t sQ = base, sK = base + Lay::OFF_K, sV = base + Lay::OFF_V;
  const uint32_t bar_q = base + Lay::OFF_BAR;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto k_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bar_q + 8u * (1 + 3 * STAGES + s); };

  const int P = BM / G;                   // query positions per CTA
  const int live_rows = G * P;            // packed rows the Q box fills
  const int n_qt = (Sq + P - 1) / P;
  const int p0 = (n_qt - 1 - int(blockIdx.x)) * P;   // heaviest first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int p_last = min(Sq, p0 + P) - 1;
  const int kv_end = causal ? min(Skv, q_offset + p_last + 1) : Skv;
  const int n_kv = (kv_end + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), NCONSUMER / 32);   // one arrival per warp
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), NCONSUMER / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows the Q box does not fill (64 % G != 0): zeros, made visible
  // to the async proxy (wgmma reads them) before any thread goes on
  for (int i = live_rows * 8 + tid; i < BM * 8; i += NTHREADS) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
      *reinterpret_cast<uint4*>(smem + h * Q_HALF + i * 16) =
          make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= NCONSUMER) {                 // the producer warp
    if (tid == NCONSUMER) {
      mbar_expect_tx(bar_q, uint32_t(NH) * live_rows * 128u);
      for (int h = 0; h < NH; ++h)
        tma_load(sQ + h * Q_HALF, &map_q, bar_q, 64 * h, hk * G, p0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        const uint32_t free_parity = ((j / STAGES) & 1) ^ 1;
        const uint32_t kst = sK + s * KV_BYTES, vst = sV + s * KV_BYTES;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), KV_BYTES);
        for (int h = 0; h < NH; ++h)
          tma_load(kst + h * KV_HALF, &map_k, k_full(s), 64 * h, hk, j * BN,
                   b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), KV_BYTES);
        for (int h = 0; h < NH; ++h)
          tma_load(vst + h * KV_HALF, &map_v, v_full(s), 64 * h, hk, j * BN,
                   b);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: warp w owns packed rows 16w .. 16w+15 ----
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rA = warp * 16 + (lane >> 2);    // this thread's rows: rA, rA+8
  const int posA = q_offset + p0 + rA / G;
  const int posB = q_offset + p0 + (rA + 8) / G;
  const int cq = 2 * (lane & 3);             // first of its column pairs
  const int pos_min = q_offset + p0;
  // a masked score, raw: scaled it is NEG_INF (up to rounding)
  const float neg_raw = NEG_INF / scale_log2;

  float acc_o[DH / 2];                       // O: DH/8 8-column groups
  float acc_s[32];
  uint32_t pf[16];                           // P in bf16 pairs, 4 k-steps
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_o[i] = 0.f;
  float mA = NEG_INF, mB = NEG_INF;          // running row max (log2 units)
  float lA = 0.f, lB = 0.f;                  // this thread's part of l

  // scores of tile j -> probabilities in place (masked where the tile
  // crosses Skv or the diagonal); returns the running rows' rescale
  // factors
  auto softmax = [&](int j, float& alphaA, float& alphaB) {
    const int k0 = j * BN;
    if (k0 + BN > Skv || (causal && k0 + BN - 1 > pos_min)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * i + cq + (e & 1);
          const int pos = e < 2 ? posA : posB;
          if (col >= Skv || (causal && col > pos)) acc_s[4 * i + e] = neg_raw;
        }
      }
    }
    float mxA = neg_raw, mxB = neg_raw;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mxA = fmaxf(mxA, fmaxf(acc_s[4 * i], acc_s[4 * i + 1]));
      mxB = fmaxf(mxB, fmaxf(acc_s[4 * i + 2], acc_s[4 * i + 3]));
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, d));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, d));
    }
    const float nA = fmaxf(mA, mxA * scale_log2);
    const float nB = fmaxf(mB, mxB * scale_log2);
    alphaA = ex2(mA - nA);
    alphaB = ex2(mB - nB);
    // a row with no live column yet subtracts 0: its masked scores scale
    // to ~NEG_INF and give p = 0
    const float subA = nA > 0.5f * NEG_INF ? nA : 0.f;
    const float subB = nB > 0.5f * NEG_INF ? nB : 0.f;
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pa = ex2(fmaf(acc_s[4 * i + e], scale_log2, -subA));
        const float pb = ex2(fmaf(acc_s[4 * i + 2 + e], scale_log2, -subB));
        acc_s[4 * i + e] = pa;
        acc_s[4 * i + 2 + e] = pb;
        sumA += pa;
        sumB += pb;
      }
    }
    lA = lA * alphaA + sumA;
    lB = lB * alphaB + sumB;
    mA = nA;
    mB = nB;
  };

  // the score fragment's layout is the A operand's: P for k-step kk is
  // columns 16kk..16kk+15, i.e. acc_s[8kk .. 8kk+7]
  auto pack_p = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      pf[i] = pack_bf16(acc_s[2 * i], acc_s[2 * i + 1]);
  };

  // once a row's max has settled its alpha is exactly 1: skip the pass
  auto rescale_o = [&](float alphaA, float alphaB) {
    if (__any_sync(0xffffffffu, alphaA != 1.f || alphaB != 1.f)) {
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        acc_o[4 * i] *= alphaA;
        acc_o[4 * i + 1] *= alphaA;
        acc_o[4 * i + 2] *= alphaB;
        acc_o[4 * i + 3] *= alphaB;
      }
    }
  };

  mbar_wait(bar_q, 0);
  if (n_kv > 0) {
    float aA, aB;
    mbar_wait(k_full(0), 0);
    fence_regs<32>(acc_s);
    wgmma_fence();
    issue_qk<DH>(acc_s, sQ, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(acc_s);
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax(0, aA, aB);
    pack_p();
  }
  for (int j = 1; j < n_kv; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;
    float aA, aB;
    mbar_wait(k_full(s), (j / STAGES) & 1);
    mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);
    fence_regs<32>(acc_s);
    fence_regs<DH / 2>(acc_o);
    fence_regs<16>(pf);
    wgmma_fence();
    issue_qk<DH>(acc_s, sQ, sK + s * KV_BYTES);
    wgmma_commit();
    issue_pv<DH>(acc_o, pf, sV + sp * KV_BYTES);
    wgmma_commit();
    wgmma_wait<1>();                         // S of tile j is in
    fence_regs<32>(acc_s);
    if (lane == 0) mbar_arrive(k_empty(s));
    softmax(j, aA, aB);                      // overlaps P V of tile j-1
    wgmma_wait<0>();
    fence_regs<DH / 2>(acc_o);
    fence_regs<16>(pf);
    if (lane == 0) mbar_arrive(v_empty(sp));
    rescale_o(aA, aB);
    pack_p();
  }
  if (n_kv > 0) {
    const int sp = (n_kv - 1) % STAGES;
    mbar_wait(v_full(sp), ((n_kv - 1) / STAGES) & 1);
    fence_regs<DH / 2>(acc_o);
    fence_regs<16>(pf);
    wgmma_fence();
    issue_pv<DH>(acc_o, pf, sV + sp * KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DH / 2>(acc_o);
  }

  // epilogue: normalise, stage bf16 rows in the Q tile's memory (16-byte
  // chunk c of row r at chunk c ^ (r & 7)), then 16-byte global stores
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, d);
    lB += __shfl_xor_sync(0xffffffffu, lB, d);
  }
  const float invA = 1.f / fmaxf(lA, 1e-30f);
  const float invB = 1.f / fmaxf(lB, 1e-30f);
  consumer_bar();                 // every wgmma is done with Q
  // (a row is DH/8 chunks, so at DH = 64 the XOR stays within its 8)
  constexpr int ROW_BYTES = DH * 2;
  constexpr int CHUNKS = DH / 8;             // 16-byte chunks per row
  constexpr int RSTEP = NCONSUMER / CHUNKS;  // rows stored per pass
  unsigned char* stage = smem;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int off = ((i ^ (rA & 7)) << 4) + cq * 2;
    *reinterpret_cast<uint32_t*>(stage + rA * ROW_BYTES + off) =
        pack_bf16(acc_o[4 * i] * invA, acc_o[4 * i + 1] * invA);
    *reinterpret_cast<uint32_t*>(stage + (rA + 8) * ROW_BYTES + off) =
        pack_bf16(acc_o[4 * i + 2] * invB, acc_o[4 * i + 3] * invB);
  }
  consumer_bar();
  // thread t stores 16-byte chunk t % CHUNKS of rows t / CHUNKS, +RSTEP,
  // ...: row r's position p0 + r / G and head r % G advance by RSTEP / G
  // and RSTEP % G (with a carry) from one of its rows to the next; dead
  // rows are skipped
  const int c = tid % CHUNKS;
  int r = tid / CHUNKS;
  int pos = p0 + r / G, head = r % G;
  const int pos_step = RSTEP / G;
  const int head_step = RSTEP % G;
  for (; r < live_rows; r += RSTEP) {
    if (pos < Sq) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          stage + r * ROW_BYTES + ((c ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(
          o + ((size_t(b) * Sq + pos) * H + hk * G + head) * DH + c * 8) =
          val;
    }
    pos += pos_step;
    head += head_step;
    if (head >= G) {
      head -= G;
      ++pos;
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 4-D map over a contiguous [B, S, Hh, dh] bf16 tensor, box {64 columns,
// box_h heads, box_s positions, 1}, 128-byte swizzle; out-of-range rows
// read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int Hh,
              int dh, int box_h, int box_s) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(Hh), cuuint64_t(S),
                        cuuint64_t(B)};
  cuuint64_t strides[3] = {cuuint64_t(dh) * 2, cuuint64_t(Hh) * dh * 2,
                           cuuint64_t(S) * Hh * dh * 2};
  cuuint32_t box[4] = {64, cuuint32_t(box_h), cuuint32_t(box_s), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the head-dim-DH instantiation's launch (its shared-memory limit raised
// once); G and the shapes are checked by the caller
template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int Hkv, int q_offset, int causal,
           float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(Layout<DH>::SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const int G = H / Hkv;
  const int P = BM / G;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, Sq, H, DH, G, P) ||
      !make_map(&mk, k, B, Skv, Hkv, DH, 1, BN) ||
      !make_map(&mv, v, B, Skv, Hkv, DH, 1, BN))
    return int(cudaErrorInvalidValue);
  dim3 grid((Sq + P - 1) / P, Hkv, B);
  flash_fwd_kernel<DH><<<grid, NTHREADS, Layout<DH>::SMEM_BYTES, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, G, q_offset,
      causal, scale * LOG2E);
  return int(cudaGetLastError());
}

}  // namespace

// q [B,Sq,H,dh], k/v [B,Skv,Hkv,dh], o [B,Sq,H,dh]: contiguous bf16,
// 16-byte aligned; dh = 64 or 128; G = H/Hkv from 1 to 16. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes
// it does not take).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Skv, int H, int Hkv, int dh,
                                   int q_offset, int causal, float scale,
                                   void* stream) {
  if (Hkv <= 0 || H % Hkv || Skv <= 0 || q_offset < 0)
    return int(cudaErrorInvalidValue);
  if (H / Hkv > 16 || (dh != 64 && dh != 128))
    return int(cudaErrorInvalidValue);
  if (Sq <= 0 || B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dh == 128 ? launch<128>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                                 causal, scale, st)
                   : launch<64>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                                causal, scale, st);
}
