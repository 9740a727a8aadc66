// Splat probes for NVIDIA Hopper (sm_90a): the windowed tent-matrix splat
// (P1) and the input-streaming floors (P2) that K1's redesign is measured
// against.
//
// Replaces the TPU probe kernels
//   P1  scripts/profile_splat.py    (run, kernel at :49): one plane of the
//       splat as a dense product per point block,
//           out[b, oy0:oy0+WY, ox0*C:(ox0+WX)*C] += oy^T[WY x P] @ Z[P x WX*C],
//       Z = zx * tile(g), oy and zx the bilinear tents of the points
//       relative to the block's window, in seven ablation stages;
//   P2  scripts/profile_splat_io.py (run, five probe kernels): a zeroed
//       [B, H, W*C] f32 output plus, per variant, 1.0 per block added into
//       a 64 x 2048 corner (`empty`), or the sum of g, of iy + ix, or of
//       the y tents of the points into out[b, 0, 0:C].
//
// What bounds P1: the function moves 0.34 GB at P=1024, WY=WX=64 (0.100 ms
// at 3.35 TB/s, the bytes bound); its dense formulation, which is what the
// probe prices, is 2*WY*P*WX*C flops per block, 1.10 TFLOP per call, 1.11 ms
// at 989 TFLOP/s bf16 (dottile adds the 0/1 tile product: 1.67 ms). Then
// the flush, 4*WY*WX*C bytes of reductions into L2 per block (2.1 GB; 0.85
// ms when P2's `empty` still flushed its corner once per block, a reading
// kept in PERF.md section 6). The tents are mostly zero (a point touches 2
// rows and 2 x-positions), but every k-step is computed all the same:
// skipping the zero chunks would measure how sparse the random inputs are,
// not the dense formulation.
//
// P1 design. The TPU kept the [H, W*C] plane of one batch element in VMEM
// and ran the grid in order; here blocks run unordered and the plane does
// not fit in shared memory, so windows are added into device memory with
// reductions that land in L2 (which holds the 33.5 MB output) and the f32
// sums are reordered from run to run (tolerance 1e-4 of max |out|).
//   - Unit of work: one CTA per (point block, column slab). A warp holds
//     all WY rows of its columns in registers (WY/16 row fragments x 64
//     columns up to WY = 64, x 32 above: at most 128 f32 accumulators a
//     thread; the row fragments are a template parameter), and the slab is
//     the CTA's warps side by side. The tents and coordinates are built once
//     per slab, not once per 128 columns as in P1's earlier kernel (whose 16
//     CTAs per block each rebuilt the same y tents through shared memory).
//   - Loads: the block's points stream through a ring of 4 stages of 128
//     points (iy, ix f32 and g bf16; 9 KB a stage) in dynamic shared
//     memory, filled by one thread with 1-D bulk copies (cp.async.bulk)
//     that complete on an mbarrier per stage; the warps release a stage
//     on a second mbarrier. No __syncthreads in the loop: a warp waits
//     only for the stage it is about to read, converts its points once
//     (a lane per point) into its own copy, and reads 4 of them a k-step.
//     g's rows are 64 bytes, so ldmatrix.trans on the unswizzled stage
//     meets 4-way bank conflicts (2 instructions a k-step); their cost was
//     not measured, and no swizzle was tried.
//   - Tensor cores: mma.sync m16n8k16 (bf16 in, f32 sums), both operands
//     built in registers, none through shared memory. A = oy^T: each thread
//     evaluates the y tents of its fragment's (row, point) pairs from the
//     staged coordinates, in the plain version's op order, rounded once to
//     bf16. B = Z: g's fragment comes from ldmatrix.trans once per k-step
//     for all 32 channels and is reused for every x-position of the warp's
//     columns, times that position's x tent with a bf16x2 multiply (the
//     product of two bf16 values is exact in f32, so this rounds as
//     bf16(zx * g)). no_tile: B is the x tents; bf16build: the x tents in
//     the bf16 op chain; oy_only: B is the y tents; z_only: A is all ones,
//     so row 0 holds the f32 column sums of Z; dottile: the tile of g is
//     the product tilemat^T @ g^T on the tensor cores, whose accumulator
//     layout is the B fragment's.
//   - Flush straight from the accumulators: lane pairs swap halves with a
//     shuffle and each lane adds 4 consecutive columns with one
//     red.global.add.v4.f32. No shared-memory staging.
//   - The launch plan (warps, columns per slab, ring stages, shared memory)
//     is computed in kernels/splat_probes.py::window_launch_plan and checked
//     here.
//
// What bounds P2: bytes. Its inputs are read once and the 33.5 MB output
// written once: 0.010 ms (`empty`, no input) to 0.020 ms (the coordinate
// readers) at 3.35 TB/s, 0.090 ms for `read_g`'s 268 MB of g. `empty`'s
// additions, one per block and corner element (0.54 G at P=1024), take
// ~0.016 ms at one f32 add per lane and clock (half the 67 TFLOP/s peak,
// which counts an FMA as two operations): more than its bytes.
//
// P2 design: one persistent launch of about two CTAs per SM, in place of
// one CTA per point block with the output zeroed by a separate memset.
//   - The kernel writes every output element itself: each CTA zeroes a
//     contiguous range of the output with 16-byte streaming stores, so a
//     call is one launch and no memset. A thread's stores are spread over
//     its load steps (readers) or between chunks of additions (empty), so
//     that they drain while the other work runs; issued first, they held
//     the loads back.
//   - Readers: each CTA walks a contiguous range of point blocks (the TPU
//     grid's sequential k axis), 16-byte streaming loads with kIoUnroll of
//     each input in flight per thread, sums in registers, one CTA
//     reduction per batch element it touches, written to a compact
//     scratch partial. No float atomics: the last CTA (an integer ticket
//     after a fence) stages every partial in shared memory with all loads
//     in flight, then adds them in CTA order, so every call gives the same
//     bits. transpose_2P evaluates only the two lanes where a point's tent
//     can be nonzero.
//   - `empty`: as the TPU kept the output block resident in VMEM across the
//     k axis, each CTA holds its tile of the corner in registers while
//     every block adds 1.0, then stores it once.
//   - The launch plan (CTAs, blocks and quads per CTA, scratch) is computed
//     in kernels/splat_probes.py::io_launch_plan; the entry checks only
//     what keeps the kernel inside its buffers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;          // plane channels
constexpr int kIoThreads = 256;  // P2: 8 warps a CTA, two CTAs an SM
constexpr int kIoUnroll = 8;     // P2: 16-byte loads in flight a thread, per input
constexpr int kEmptyChunk = 32;  // P2 `empty`: blocks between two rounds of zero stores
// P2: shared memory the last CTA may stage the partials in (227 KB less
// the kernel's static arrays).
constexpr int kMaxIoStaged = 232448 - 2048;
constexpr int kMaxWarps = 8;    // P1: warps per CTA, at most
constexpr int kRingHeader = 128;  // P1: the ring's mbarriers, then the stages
constexpr int kRingPointBytes = 2 * 4 + kC * 2;  // P1: iy, ix f32 and g bf16
constexpr int kPointBytes = 16;  // P1: a warp's copy of a point, 4 floats

// P1: column tiles of 8 a warp holds for `mt` row fragments (<= 128
// accumulators a thread; a multiple of 4, so a warp takes whole x-positions).
__host__ __device__ constexpr int warp_tiles(int mt) { return mt <= 4 ? 8 : 4; }

// Stage numbers, as in kernels/splat_probes.py::STAGES.
enum Stage {
  kFull = 0,
  kStaticStore = 1,
  kNoTile = 2,
  kZOnly = 3,
  kOyOnly = 4,
  kBf16Build = 5,
  kDotTile = 6,
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float tent(float d) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
}

// One reduction of four consecutive floats into device memory (sm_90).
__device__ __forceinline__ void red_add_v4(float* addr, const float* v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(addr),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// ---- P1 -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices of each 16x16 tile, transposed: the B fragments
// (k = 2*tig, 2*tig + 1 and k + 8; n = gid) of 16 channels of g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A point's offsets from the window origin and fractional position in its
// cell, with the plain version's op order: min(floor(i), W - 2).
struct Axis {
  float l0, w1;
};

__device__ __forceinline__ Axis axis(float v, int limit, int origin) {
  const float f = fminf(floorf(v), static_cast<float>(limit - 2));
  return {__fsub_rn(f, static_cast<float>(origin)), __fsub_rn(v, f)};
}

// 1 - |d| for a point at window lane `lane`, d in the plain version's op
// order; pack_tents clamps it at 0 and rounds it once to bf16.
__device__ __forceinline__ float rise(Axis a, int lane) {
  return __fsub_rn(1.0f, fabsf(__fsub_rn(__fsub_rn(static_cast<float>(lane), a.l0), a.w1)));
}

// bf16build's x tent before the clamp: every op rounded to bf16, as the
// bf16 build does.
__device__ __forceinline__ float bf16_chain_rise(Axis a, int lane) {
  const float xc = __bfloat162float(__float2bfloat16_rn(__fadd_rn(a.l0, a.w1)));
  const float d = __bfloat162float(
      __float2bfloat16_rn(__fsub_rn(static_cast<float>(lane), xc)));
  return __bfloat162float(__float2bfloat16_rn(__fsub_rn(1.0f, fabsf(d))));
}

// bf16(max(0, lo)), bf16(max(0, hi)) in one instruction: the clamp after
// the rounding gives the same bits, as rounding keeps the sign.
__device__ __forceinline__ uint32_t pack_tents(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// P1, every stage. MT row fragments of 16 (WY = 16 * MT; z_only: MT = 1)
// and NT column tiles of 8 per warp, so that a thread holds at most 128
// accumulators. Grid: one CTA per (point block, column slab), slab
// fastest; blockDim.x = 32 * warps. Nothing in the k-step is predicated on
// run-time values: a predicated mma.sync needs a warp-level convergence
// barrier per instruction, which serialises the products (`full` at
// P=1024, WY=WX=64 on an H100: 7.7 ms with such guards, 4.8 without).
// Tiles of a warp past the window's last column are computed all the same
// and left out of the flush.
template <int STAGE, int MT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
window_product_kernel(const int32_t* __restrict__ oy0s,
                      const int32_t* __restrict__ ox0s,
                      const float* __restrict__ iy,  // [B*nblocks, P]
                      const float* __restrict__ ix,  // [B*nblocks, P]
                      const bf16* __restrict__ g,    // [B*nblocks, P, kC]
                      float* __restrict__ out,       // [B, H, W*kC]
                      int nblocks, int P, int H, int W, int WY, int WX,
                      int nslabs, int chunk, int ring) {
  constexpr int NT = warp_tiles(MT);
  constexpr int kWarpCols = NT * 8;
  constexpr int NX = kWarpCols / kC;  // x-positions of a warp
  constexpr bool kUsesG = STAGE != kOyOnly && STAGE != kNoTile;
  constexpr bool kUsesX = STAGE != kOyOnly;
  constexpr bool kUsesY = STAGE != kZOnly;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + ring;
  const int stage_bytes = chunk * kRingPointBytes;

  const int ncols = (STAGE == kOyOnly) ? WY : WX * kC;
  const int blk = blockIdx.x / nslabs;
  const int slab = blockIdx.x % nslabs;
  const int b = blk / nblocks;
  const int oy0 = oy0s[blk];
  const int ox0 = ox0s[blk];
  const bool at_origin = (STAGE == kStaticStore || STAGE == kOyOnly);
  const int row0 = (STAGE == kZOnly || at_origin) ? 0 : oy0;
  const int col0 = at_origin || STAGE == kZOnly ? 0 : ox0 * kC;
  const int rows = (STAGE == kZOnly) ? 1 : WY;
  const int64_t WC = static_cast<int64_t>(W) * kC;
  // A window outside the plane would address outside `out`: drop it.
  if (row0 < 0 || row0 + rows > H || col0 < 0 || col0 + ncols > WC) return;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nwarps = blockDim.x >> 5;
  // The warp's first column in the window. A warp wholly past the last
  // column (a partial slab) only keeps the ring going.
  const int wcol0 = (slab * nwarps + warp) * kWarpCols;
  const bool active = wcol0 < ncols;

  const int nchunks = (P + chunk - 1) / chunk;
  const int64_t blk_first = static_cast<int64_t>(blk) * P;
  auto stage_ptr = [&](int s) { return smem + kRingHeader + s * stage_bytes; };
  // This warp's copy of the chunk's points as (yl0, wy1, xl0, wx1).
  float4* pts = reinterpret_cast<float4*>(smem + kRingHeader + ring * stage_bytes) +
                warp * chunk;
  auto fill = [&](int c) {  // one thread: chunk c into its ring stage
    const int s = c % ring, n = min(chunk, P - c * chunk);
    const int64_t first = blk_first + static_cast<int64_t>(c) * chunk;
    unsigned char* dst = stage_ptr(s);
    const uint32_t bytes = n * 4 * (kUsesX ? 2 : 1) + (kUsesG ? n * kC * 2 : 0);
    mbar_expect_tx(&full[s], bytes);
    bulk_load(dst, iy + first, n * 4, &full[s]);
    if (kUsesX) bulk_load(dst + chunk * 4, ix + first, n * 4, &full[s]);
    if (kUsesG) bulk_load(dst + chunk * 8, g + first * kC, n * kC * 2, &full[s]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nwarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int c = 0; c < min(ring, nchunks); ++c) fill(c);
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // z_only's A: all ones (bf16 1.0 twice).
  const uint32_t kOnes = 0x3F803F80u;
  // dottile's A: tilemat^T's 16 x 16 block where column and channel phase
  // agree (the identity), else zero; its nonzero registers are 0 and 3.
  const uint32_t ident_lo = (gid == 2 * tig) ? 0x3F80u : 0u;
  const uint32_t ident_hi = (gid == 2 * tig + 1) ? 0x3F80u : 0u;
  const uint32_t ident = ident_lo | (ident_hi << 16);

  for (int c = 0; c < nchunks; ++c) {
    const int s = c % ring;
    const uint32_t parity = (c / ring) & 1;
    mbar_wait(&full[s], parity);
    const float* s_iy = reinterpret_cast<const float*>(stage_ptr(s));
    const float* s_ix = s_iy + chunk;
    const bf16* s_g = reinterpret_cast<const bf16*>(stage_ptr(s) + chunk * 8);
    const int n = min(chunk, P - c * chunk);

    if (active) {
      // The chunk's points, once per warp (a lane per point), in the plain
      // version's op order; every lane of the k-steps reads 4 of them.
      for (int k = lane; k < n; k += 32) {
        const Axis y = kUsesY ? axis(s_iy[k], H, oy0) : Axis{0.0f, 0.0f};
        const Axis x = kUsesX ? axis(s_ix[k], W, ox0) : Axis{0.0f, 0.0f};
        pts[k] = make_float4(y.l0, y.w1, x.l0, x.w1);
      }
      __syncwarp();

#pragma unroll 1
      for (int k0 = 0; k0 < n; k0 += 16) {
        // This thread's 4 points of the k-step: A columns and B rows
        // 2*tig, 2*tig + 1, 2*tig + 8, 2*tig + 9.
        Axis ya[4], xa[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = pts[k0 + 2 * tig + (q & 1) + (q >> 1) * 8];
          ya[q] = {v.x, v.y};
          xa[q] = {v.z, v.w};
        }
        // A fragments: rows gid and gid + 8 of each row fragment.
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (STAGE == kZOnly) {
            a[i][0] = a[i][1] = a[i][2] = a[i][3] = kOnes;
          } else {
            const int r = i * 16 + gid;
            a[i][0] = pack_tents(rise(ya[0], r), rise(ya[1], r));
            a[i][1] = pack_tents(rise(ya[0], r + 8), rise(ya[1], r + 8));
            a[i][2] = pack_tents(rise(ya[2], r), rise(ya[3], r));
            a[i][3] = pack_tents(rise(ya[2], r + 8), rise(ya[3], r + 8));
          }
        }
        // x tents of the warp's x-positions, as bf16 pairs (points 0/1, 2/3).
        uint32_t zx[NX][2];
        if (kUsesX) {
#pragma unroll
          for (int xi = 0; xi < NX; ++xi) {
            const int x = wcol0 / kC + xi;
            if (STAGE == kBf16Build) {
              zx[xi][0] = pack_tents(bf16_chain_rise(xa[0], x), bf16_chain_rise(xa[1], x));
              zx[xi][1] = pack_tents(bf16_chain_rise(xa[2], x), bf16_chain_rise(xa[3], x));
            } else {
              zx[xi][0] = pack_tents(rise(xa[0], x), rise(xa[1], x));
              zx[xi][1] = pack_tents(rise(xa[2], x), rise(xa[3], x));
            }
          }
        }
        // g's B fragments for the 4 groups of 8 channels: [group][2].
        uint32_t gf[4][2];
        if (STAGE != kOyOnly && STAGE != kNoTile && STAGE != kDotTile) {
          const int mat = lane >> 3;
          const bf16* row = s_g + (k0 + (lane & 7) + (mat & 1) * 8) * kC + (mat >> 1) * 8;
          uint32_t r[4];
          ldmatrix_x4_trans(r, row);
          gf[0][0] = r[0], gf[0][1] = r[1], gf[1][0] = r[2], gf[1][1] = r[3];
          ldmatrix_x4_trans(r, row + 16);
          gf[2][0] = r[0], gf[2][1] = r[1], gf[3][0] = r[2], gf[3][1] = r[3];
        }
        // dottile: g^T's B fragments, [point half][channel half][2]: points
        // k0 + 8*h + gid, channels 16*c + 2*tig (+1) and + 8 (+9).
        uint32_t gt[2][2][2];
        if (STAGE == kDotTile) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const bf16* p = s_g + (k0 + 8 * h + gid) * kC + 16 * cc + 2 * tig;
              gt[h][cc][0] = *reinterpret_cast<const uint32_t*>(p);
              gt[h][cc][1] = *reinterpret_cast<const uint32_t*>(p + 8);
            }
        }

        // B fragments of every tile first, then the products.
        uint32_t bf[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // kWarpCols is a multiple of kC: the tile's x-position and channel
          // group are known at compile time.
          const int col = wcol0 + j * 8;  // the tile's first window column
          const int xi = j * 8 / kC;
          const int group = j % (kC / 8);
          if (STAGE == kOyOnly) {
            bf[j][0] = pack_tents(rise(ya[0], col + gid), rise(ya[1], col + gid));
            bf[j][1] = pack_tents(rise(ya[2], col + gid), rise(ya[3], col + gid));
          } else if (STAGE == kNoTile) {
            bf[j][0] = zx[xi][0];
            bf[j][1] = zx[xi][1];
          } else if (STAGE == kDotTile) {
            // tile(g) for columns col .. col + 15 (j even) as the product
            // tilemat^T[16 x 32] @ g^T[32 x 8] per 8 points; the tile j + 1
            // takes the accumulators' rows gid + 8.
            if (j % 2 == 0) {
              float t[2][4];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                t[h][0] = t[h][1] = t[h][2] = t[h][3] = 0.0f;
#pragma unroll
                for (int cc = 0; cc < 2; ++cc) {
                  const bool on = (j * 8) % kC == 16 * cc;
                  const uint32_t ta[4] = {on ? ident : 0u, 0u, 0u, on ? ident : 0u};
                  mma_bf16(t[h], ta, gt[h][cc][0], gt[h][cc][1]);
                }
              }
              gf[0][0] = pack_bf16(t[0][0], t[0][1]);
              gf[0][1] = pack_bf16(t[1][0], t[1][1]);
              gf[1][0] = pack_bf16(t[0][2], t[0][3]);
              gf[1][1] = pack_bf16(t[1][2], t[1][3]);
            }
            bf[j][0] = mul_bf16x2(gf[j % 2][0], zx[xi][0]);
            bf[j][1] = mul_bf16x2(gf[j % 2][1], zx[xi][1]);
          } else {
            bf[j][0] = mul_bf16x2(gf[group][0], zx[xi][0]);
            bf[j][1] = mul_bf16x2(gf[group][1], zx[xi][1]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[i][j], a[i], bf[j][0], bf[j][1]);
          }
        }
      }
    }

    // Release the stage; thread 0 refills it once every warp has.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && c + ring < nchunks) {
      mbar_wait(&empty[s], parity);
      fill(c + ring);
    }
    __syncwarp();
  }

  // Flush: lane pairs swap halves, so that each lane holds 4 consecutive
  // columns of one row (even tig: row gid; odd tig: row gid + 8).
  float* plane = out + static_cast<int64_t>(b) * H * WC;
  const bool odd = tig & 1;
  const int frow = gid + (odd ? 8 : 0);
  const int fcol = 2 * (tig & ~1);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wcol0 + j * 8;
      if (col >= ncols) continue;
      const float* d = acc[i][j];
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
      const float v[4] = {odd ? s0 : d[0], odd ? s1 : d[1], odd ? d[2] : s0,
                          odd ? d[3] : s1};
      if (STAGE == kZOnly && frow != 0) continue;
      red_add_v4(plane + static_cast<int64_t>(row0 + i * 16 + frow) * WC + col0 +
                     col + fcol,
                 v);
    }
  }
}

template <int STAGE, int MT>
int launch_product(int blocks, int warps, int nslabs, int chunk, int ring,
                   int smem_bytes, cudaStream_t s, const int32_t* oy0,
                   const int32_t* ox0, const float* iy, const float* ix,
                   const bf16* g, float* out, int nblocks, int P, int H, int W,
                   int WY, int WX) {
  auto kernel = window_product_kernel<STAGE, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks * nslabs, warps * 32, smem_bytes, s>>>(
      oy0, ox0, iy, ix, g, out, nblocks, P, H, W, WY, WX, nslabs, chunk, ring);
  return static_cast<int>(cudaGetLastError());
}

// The stage's kernel for `mt` row fragments (z_only takes one).
template <int STAGE>
int launch_stage(int mt, int blocks, int warps, int nslabs, int chunk, int ring,
                 int smem_bytes, cudaStream_t s, const int32_t* oy0,
                 const int32_t* ox0, const float* iy, const float* ix,
                 const bf16* g, float* out, int nblocks, int P, int H, int W,
                 int WY, int WX) {
#define P1_MT(M)                                                                \
  case M:                                                                       \
    return launch_product<STAGE, (STAGE == kZOnly ? 1 : M)>(                    \
        blocks, warps, nslabs, chunk, ring, smem_bytes, s, oy0, ox0, iy, ix, g, \
        out, nblocks, P, H, W, WY, WX)
  switch (mt) {
    P1_MT(1); P1_MT(2); P1_MT(3); P1_MT(4);
    P1_MT(5); P1_MT(6); P1_MT(7); P1_MT(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef P1_MT
}

// ---- P2 -------------------------------------------------------------------

// Variants, as in kernels/splat_probes.py::IO_VARIANTS.
enum IoVariant {
  kEmpty = 0,
  kReadG = 1,
  kReadIxyP1 = 2,
  kReadIxy2P = 3,
  kTranspose2P = 4,
};

// Zeros, or a corner tile, with 16-byte streaming stores: the output is
// written once and not read back by the kernel.
__device__ __forceinline__ void store_cs_v4(float* p, float a, float b, float c,
                                            float d) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(a),
               "f"(b), "f"(c), "f"(d)
               : "memory");
}

// A 16-byte streaming load of data read once.
__device__ __forceinline__ float4 load_cs_v4(const void* p) {
  return __ldcs(static_cast<const float4*>(p));
}

// `empty`'s per-block addition. Volatile, so that the compiler keeps one
// add per block and element: every element of a tile takes the same
// additions, and nothing else stops them being merged.
__device__ __forceinline__ void add_one(float& x) {
  asm volatile("add.rn.f32 %0, %0, 0f3F800000;" : "+f"(x));
}

// The two-lane tent sum of one point, in the plain version's op order:
// lanes floor(y) and floor(y) + 1, where they lie in [0, 64), each
// max(0, 1 - |lane - y|) + 0 * x; every other lane adds exactly +0.
__device__ __forceinline__ float tent_pair(float y, float x) {
  const float zero_x = __fmul_rn(0.0f, x);
  const float f = floorf(y);
  float s = 0.0f;
  if (f >= 0.0f && f < 64.0f) s = __fadd_rn(tent(__fsub_rn(f, y)), zero_x);
  const float f1 = __fadd_rn(f, 1.0f);
  if (f1 >= 0.0f && f1 < 64.0f) s = __fadd_rn(s, __fadd_rn(tent(__fsub_rn(f1, y)), zero_x));
  return s;
}

// The sum of v over the CTA in a fixed order: a shuffle tree per warp,
// then the warps in order. Valid in thread 0.
__device__ __forceinline__ float cta_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kIoThreads / 32; ++w) s += red[w];
  }
  __syncthreads();
  return s;
}

// A thread's share of the zeros: quads q0 + t, + kIoThreads, ... below q1
// of out viewed as [B * H * WC / 4] quads, but for those that another
// store owns (empty: the corner; readers: out[b, 0, 0 .. 4 *
// epilogue_quads)). The quad's row and column within its batch element
// follow it without divisions. store(n) writes the next n, so that the
// stores can be spread over the loads or additions.
template <int V>
struct ZeroFill {
  float* out;
  int64_t q, q1;
  int row, col;  // q's row of H and quad of wq
  int H, wq, corner_rows, corner_wq, epilogue_quads;

  __device__ int remaining() const {
    return q < q1 ? static_cast<int>((q1 - q + kIoThreads - 1) / kIoThreads) : 0;
  }
  __device__ void store(int n) {
    for (; n > 0 && q < q1; q += kIoThreads) {
      const bool owned = V == kEmpty ? (row < corner_rows && col < corner_wq)
                                     : (row == 0 && col < epilogue_quads);
      if (!owned) {
        store_cs_v4(out + 4 * q, 0.f, 0.f, 0.f, 0.f);
        --n;
      }
      col += kIoThreads;
      while (col >= wq) {
        col -= wq;
        if (++row == H) row = 0;
      }
    }
  }
};

// One batch element's segment [s0, s1) of the CTA's point blocks, summed
// by the CTA: `width` floats (read_g: the 32 channel sums; otherwise one),
// written to part[0 .. width) in shared memory. 16-byte loads, kIoUnroll
// of each input in flight per thread, and `zeros_per_step` of the
// thread's zero stores issued while they land.
template <int V>
__device__ __forceinline__ void segment_sum(const float* __restrict__ iy,
                                            const float* __restrict__ ix,
                                            const float* __restrict__ ixy,
                                            const bf16* __restrict__ g, int64_t s0,
                                            int64_t s1, int P, ZeroFill<V>& zeros,
                                            int zeros_per_step, float* red,
                                            float* part) {
  const int t = threadIdx.x;
  const float4 nil = make_float4(0.f, 0.f, 0.f, 0.f);
  if (V == kReadG) {
    // Vector v holds channels 8 * (v % 4) .. + 7 of one point; the stride
    // is a multiple of 4, so a thread keeps one channel group.
    const int64_t v0 = s0 * P * 4, v1 = s1 * P * 4;
    const float4* src = reinterpret_cast<const float4*>(g);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int64_t v = v0 + t; v < v1; v += kIoThreads * kIoUnroll) {
      float4 r[kIoUnroll];
#pragma unroll
      for (int u = 0; u < kIoUnroll; ++u)
        r[u] = v + u * kIoThreads < v1 ? load_cs_v4(src + v + u * kIoThreads) : nil;
      zeros.store(zeros_per_step);
#pragma unroll
      for (int u = 0; u < kIoUnroll; ++u) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r[u]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          acc[2 * j] += f.x;
          acc[2 * j + 1] += f.y;
        }
      }
    }
    // Lanes with equal lane % 4 hold the same channels: a shuffle tree
    // over the other lane bits, then the warps in order.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int o = 16; o >= 4; o >>= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    }
    const int lane = t & 31, warp = t >> 5;
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp * kC + lane * 8 + j] = acc[j];
    }
    __syncthreads();
    if (t < kC) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kIoThreads / 32; ++w) s += red[w * kC + t];
      part[t] = s;
    }
    __syncthreads();
    return;
  }
  float s = 0.0f;
  if (V == kReadIxyP1) {
    const int64_t v0 = s0 * P / 4, v1 = s1 * P / 4;
    for (int64_t v = v0 + t; v < v1; v += kIoThreads * kIoUnroll) {
      float4 a[kIoUnroll], c[kIoUnroll];
#pragma unroll
      for (int u = 0; u < kIoUnroll; ++u) {
        const bool in = v + u * kIoThreads < v1;
        a[u] = in ? load_cs_v4(iy + 4 * (v + u * kIoThreads)) : nil;
        c[u] = in ? load_cs_v4(ix + 4 * (v + u * kIoThreads)) : nil;
      }
      zeros.store(zeros_per_step);
#pragma unroll
      for (int u = 0; u < kIoUnroll; ++u)
        s += ((a[u].x + c[u].x) + (a[u].y + c[u].y)) + ((a[u].z + c[u].z) + (a[u].w + c[u].w));
    }
  } else if (V == kReadIxy2P) {
    const int64_t v0 = s0 * P / 2, v1 = s1 * P / 2;
    for (int64_t v = v0 + t; v < v1; v += kIoThreads * kIoUnroll) {
      float4 a[kIoUnroll];
#pragma unroll
      for (int u = 0; u < kIoUnroll; ++u)
        a[u] = v + u * kIoThreads < v1 ? load_cs_v4(ixy + 4 * (v + u * kIoThreads)) : nil;
      zeros.store(zeros_per_step);
#pragma unroll
      for (int u = 0; u < kIoUnroll; ++u) s += (a[u].x + a[u].y) + (a[u].z + a[u].w);
    }
  } else {  // kTranspose2P: block k's iy at ixy[k, 0, :], its ix at ixy[k, 1, :]
    const int q = P / 4;  // float4s of one coordinate row
    const int64_t n = (s1 - s0) * q;
    for (int64_t v = t; v < n; v += kIoThreads * kIoUnroll) {
      float4 a[kIoUnroll], c[kIoUnroll];
#pragma unroll
      for (int u = 0; u < kIoUnroll; ++u) {
        const int64_t w = v + u * kIoThreads;
        const float* row = ixy + (s0 + w / q) * 2 * P + 4 * (w % q);
        a[u] = w < n ? load_cs_v4(row) : nil;
        c[u] = w < n ? load_cs_v4(row + P) : nil;
      }
      zeros.store(zeros_per_step);
#pragma unroll
      for (int u = 0; u < kIoUnroll; ++u) {
        if (v + u * kIoThreads < n) {
          s += tent_pair(a[u].x, c[u].x);
          s += tent_pair(a[u].y, c[u].y);
          s += tent_pair(a[u].z, c[u].z);
          s += tent_pair(a[u].w, c[u].w);
        }
      }
    }
  }
  s = cta_sum(s, red);
  if (t == 0) part[0] = s;
  __syncthreads();
}

// P2, every variant: one persistent launch that writes every element of
// out [B, H, WC] once. The plan (kernels/splat_probes.py::io_launch_plan)
// gives each CTA
//   - a contiguous range of `zero_quads` 16-byte output quads to zero,
//     spread over its loads (readers) or additions (empty);
//   - empty: `corner_quads` quads of the corner [B, rows, cols], flattened
//     batch, row, then quad, held in registers (2 a thread) while each of
//     the `nblocks` blocks adds 1.0, then stored once;
//   - readers: `blocks_per_cta` consecutive point blocks of the B *
//     nblocks, summed per batch element b into the partial at
//     scratch[(cta + b) * width ..] (the (CTA, b) pairs touched, in
//     order: CTA ranges are consecutive). The last CTA to finish (an
//     integer ticket after a fence) stages every partial in shared memory
//     at once, adds each batch element's in CTA order, writes out[b, 0,
//     0 .. 4 * epilogue_quads) (the sums, then zeros) and resets the
//     ticket: no float atomics, the same bits on every call.
template <int V>
__global__ void __launch_bounds__(kIoThreads, 2)
io_probe_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                const float* __restrict__ ixy, const bf16* __restrict__ g,
                float* __restrict__ out, float* __restrict__ scratch,
                unsigned int* __restrict__ ticket, int B, int nblocks, int P, int H,
                int WC, int blocks_per_cta, int64_t zero_quads, int corner_rows,
                int corner_cols, int corner_quads, int width, int epilogue_quads,
                int scratch_floats) {
  extern __shared__ float4 staged4[];  // the last CTA's copy of scratch
  __shared__ float red[(kIoThreads / 32) * kC];
  __shared__ float part[kC];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int cta = blockIdx.x;

  ZeroFill<V> zeros;
  {
    const int wq = WC / 4;
    const int64_t total = static_cast<int64_t>(B) * H * wq;
    const int64_t q0 = cta * zero_quads;
    const int64_t q1 = q0 + zero_quads < total ? q0 + zero_quads : total;
    const int in_plane = static_cast<int>((q0 + t) % (static_cast<int64_t>(H) * wq));
    zeros = {out, q0 + t, q1, in_plane / wq, in_plane % wq, H, wq, corner_rows,
             corner_cols / 4, epilogue_quads};
  }

  if (V == kEmpty) {
    const int corner_wq = corner_cols / 4;
    const int64_t corner_total = static_cast<int64_t>(B) * corner_rows * corner_wq;
    const int64_t first = static_cast<int64_t>(cta) * corner_quads;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (first < corner_total) {
      // The additions in chunks of kEmptyChunk blocks, unrolled, with the
      // thread's zero stores spread over the chunks so that they drain
      // while the additions run.
      const int chunks = nblocks / kEmptyChunk;
      const int per_chunk = chunks > 0 ? (zeros.remaining() + chunks - 1) / chunks : 0;
      for (int k = 0; k < chunks; ++k) {
#pragma unroll
        for (int j = 0; j < kEmptyChunk; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) add_one(acc[i][e]);
        }
        zeros.store(per_chunk);
      }
      for (int k = chunks * kEmptyChunk; k < nblocks; ++k) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) add_one(acc[i][e]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int local = t + i * kIoThreads;
        const int64_t quad = first + local;
        if (local >= corner_quads || quad >= corner_total) continue;
        const int64_t row = quad / corner_wq;  // b * corner_rows + r
        const int64_t b = row / corner_rows, r = row % corner_rows;
        store_cs_v4(out + (b * H + r) * WC + 4 * (quad % corner_wq), acc[i][0],
                    acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    zeros.store(zeros.remaining());
    return;
  }

  // Readers: the CTA's blocks, one segment per batch element they touch,
  // with the zero stores spread over the load steps.
  const int64_t nb_total = static_cast<int64_t>(B) * nblocks;
  const int64_t k0 = static_cast<int64_t>(cta) * blocks_per_cta;
  const int64_t k1 = k0 + blocks_per_cta < nb_total ? k0 + blocks_per_cta : nb_total;
  {
    const int64_t vectors = (k1 - k0) * (V == kReadG ? 4 * P : V == kReadIxy2P ? P / 2 : P / 4);
    const int64_t steps = vectors > 0 ? (vectors + kIoThreads * kIoUnroll - 1) / (kIoThreads * kIoUnroll) : 1;
    const int zeros_per_step = static_cast<int>((zeros.remaining() + steps - 1) / steps);
    for (int64_t b = k0 / nblocks; b <= (k1 - 1) / nblocks; ++b) {
      const int64_t s0 = k0 > b * nblocks ? k0 : b * nblocks;
      const int64_t s1 = k1 < (b + 1) * nblocks ? k1 : (b + 1) * nblocks;
      segment_sum<V>(iy, ix, ixy, g, s0, s1, P, zeros, zeros_per_step, red, part);
      if (t < width) scratch[(cta + b) * width + t] = part[t];
    }
  }
  zeros.store(zeros.remaining());

  // The last CTA adds the partials; its reads see every CTA's writes.
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  {
    const float4* src = reinterpret_cast<const float4*>(scratch);
    const int n4 = scratch_floats / 4;
    for (int i = t; i < n4; i += kIoThreads * 8) {
      float4 r[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        r[u] = i + u * kIoThreads < n4 ? __ldcg(src + i + u * kIoThreads)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i + u * kIoThreads < n4) staged4[i + u * kIoThreads] = r[u];
    }
  }
  __syncthreads();
  const float* staged = reinterpret_cast<const float*>(staged4);
  // `parts` neighbouring lanes share one output (b, c): each adds every
  // parts-th CTA of those that touched b, then a shuffle tree adds the
  // lanes. Fixed order throughout.
  const int n_out = B * width;
  int parts = 32;
  while (parts > 1 && parts * n_out > kIoThreads) parts >>= 1;
  const int per_round = kIoThreads / parts;
  for (int base = 0; base < n_out; base += per_round) {
    const int o = base + t / parts, lane_part = t % parts;
    float s = 0.0f;
    int64_t b = 0;
    int c = 0;
    if (o < n_out) {
      b = o / width;
      c = o % width;
      const int64_t lo = b * nblocks / blocks_per_cta;
      const int64_t hi = ((b + 1) * nblocks - 1) / blocks_per_cta;
      for (int64_t k = lo + lane_part; k <= hi; k += parts) s += staged[(k + b) * width + c];
    }
    for (int off = parts >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (o < n_out && lane_part == 0) out[b * H * static_cast<int64_t>(WC) + c] = s;
  }
  // The epilogue quads' other elements are zeros.
  const int pad = 4 * epilogue_quads;
  for (int i = t; i < B * pad; i += kIoThreads) {
    if (i % pad >= width) out[static_cast<int64_t>(i / pad) * H * WC + i % pad] = 0.0f;
  }
  if (t == 0) *ticket = 0u;
}

}  // namespace

// P1. Shapes: oy0, ox0 [B*nblocks] i32; iy, ix [B*nblocks, P] f32; g
// [B*nblocks, P, 32] bf16, each 16-byte aligned; out [B, H, W*32] f32,
// zeroed by the caller. The launch plan (mt, warps, slab_cols, chunk,
// ring, smem_bytes) comes from kernels/splat_probes.py::window_launch_plan;
// the wrapper checks shapes and types, and this returns
// cudaErrorInvalidValue for a shape or plan the kernels do not take.
extern "C" int splat_window_probe(const int32_t* oy0, const int32_t* ox0,
                                  const float* iy, const float* ix,
                                  const void* g, float* out, int B, int nblocks,
                                  int P, int H, int W, int WY, int WX, int stage,
                                  int mt, int warps, int slab_cols, int chunk,
                                  int ring, int smem_bytes, void* stream) {
  const int blocks = B * nblocks;
  const int ncols = (stage == kOyOnly) ? WY : WX * kC;
  if (blocks <= 0 || P % 64 != 0 || WY % 16 != 0 || WY < 16 || WY > 128 ||
      (WX * kC) % 128 != 0 || WX <= 0 || H < 2 || W < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mt != (stage == kZOnly ? 1 : WY / 16) || warps < 1 || warps > kMaxWarps ||
      slab_cols != warps * warp_tiles(mt) * 8 || chunk % 64 != 0 || chunk < 64 ||
      chunk > 256 || ring < 2 || ring * 16 > kRingHeader ||
      smem_bytes != kRingHeader + ring * chunk * kRingPointBytes +
                        warps * chunk * kPointBytes ||
      smem_bytes > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nslabs = (ncols + slab_cols - 1) / slab_cols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gb = static_cast<const bf16*>(g);
#define P1_LAUNCH(STAGE)                                                       \
  return launch_stage<STAGE>(mt, blocks, warps, nslabs, chunk, ring, smem_bytes, \
                             s, oy0, ox0, iy, ix, gb, out, nblocks, P, H, W,   \
                             WY, WX)
  switch (stage) {
    case kFull: P1_LAUNCH(kFull);
    case kStaticStore: P1_LAUNCH(kStaticStore);
    case kNoTile: P1_LAUNCH(kNoTile);
    case kZOnly: P1_LAUNCH(kZOnly);
    case kOyOnly: P1_LAUNCH(kOyOnly);
    case kBf16Build: P1_LAUNCH(kBf16Build);
    case kDotTile: P1_LAUNCH(kDotTile);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef P1_LAUNCH
}

// P2. variant: as in IoVariant (kernels/splat_probes.py::IO_VARIANTS). iy,
// ix [B*nblocks, P] f32; ixy [B*nblocks, 2, P] f32; g [B*nblocks, P, 32]
// bf16, each 16-byte aligned; out [B, H, W*32] f32, which the kernel
// writes whole (the caller need not zero it); scratch of scratch_floats
// f32 (a multiple of 4; staged whole in the last CTA's shared memory);
// ticket one u32, zero before the call and left zero after it. The
// launch plan (ctas .. epilogue_quads) comes from
// kernels/splat_probes.py::io_launch_plan; this checks only what keeps the
// kernel's accesses inside its buffers and returns cudaErrorInvalidValue
// otherwise.
extern "C" int splat_io_probe(int variant, const float* iy, const float* ix,
                              const float* ixy, const void* g, float* out,
                              float* scratch, unsigned int* ticket, int B,
                              int nblocks, int P, int H, int W, int ctas,
                              int blocks_per_cta, long long zero_quads,
                              int corner_rows, int corner_cols, int corner_quads,
                              int width, int epilogue_quads,
                              long long scratch_floats, void* stream) {
  const int WC = W * kC;
  if (B <= 0 || nblocks <= 0 || P <= 0 || P % 4 != 0 || H <= 0 || W <= 0 ||
      ctas <= 0 || zero_quads < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kEmpty) {
    if (scratch_floats != 0 || corner_rows < 0 || corner_rows > H || corner_cols < 0 ||
        corner_cols > WC || corner_cols % 4 != 0 || corner_quads < 0 ||
        corner_quads > 2 * kIoThreads)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (blocks_per_cta <= 0 || width <= 0 || width > kC ||
             epilogue_quads * 4 < width || epilogue_quads * 4 > WC ||
             scratch_floats < (static_cast<long long>(ctas) + B - 1) * width ||
             scratch_floats % 4 != 0 || scratch_floats * 4 > kMaxIoStaged ||
             ticket == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gb = static_cast<const bf16*>(g);
  const int smem = static_cast<int>(scratch_floats) * 4;
#define P2_LAUNCH(V)                                                                \
  if (smem > 48 * 1024) {                                                           \
    cudaError_t e = cudaFuncSetAttribute(                                           \
        io_probe_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);     \
    if (e != cudaSuccess) return static_cast<int>(e);                               \
  }                                                                                 \
  io_probe_kernel<V><<<ctas, kIoThreads, smem, s>>>(                                \
      iy, ix, ixy, gb, out, scratch, ticket, B, nblocks, P, H, WC, blocks_per_cta,  \
      zero_quads, corner_rows, corner_cols, corner_quads, width, epilogue_quads,    \
      static_cast<int>(scratch_floats));                                            \
  break
  switch (variant) {
    case kEmpty: P2_LAUNCH(kEmpty);
    case kReadG: P2_LAUNCH(kReadG);
    case kReadIxyP1: P2_LAUNCH(kReadIxyP1);
    case kReadIxy2P: P2_LAUNCH(kReadIxy2P);
    case kTranspose2P: P2_LAUNCH(kTranspose2P);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef P2_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
