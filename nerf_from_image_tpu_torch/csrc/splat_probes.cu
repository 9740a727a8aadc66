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
//   P2  scripts/profile_splat_io.py (run, five probe kernels): launch and
//       per-block overhead, g streaming and coordinate streaming.
//
// P1 design. The TPU kept the [H, W*C] plane of one batch element in VMEM
// and ran the grid in order, so each block's window was a read-add-write of
// fast memory. Here blocks run unordered and the plane (8 MB per batch
// element at full width) does not fit in shared memory. One CTA computes
// one 128-column tile (4 x-positions of 32 channels) of one block's window
// for all WY rows: it walks the block's P points in chunks of 64, builds
// the bf16 tents oy [64 x WY] and the bf16 operand Z [64 x 128] in shared
// memory with the same op order (and the same roundings) as the plain
// version, and multiplies them on the tensor cores (wmma m16n16k16, bf16 in,
// f32 accumulate; warp w owns output columns w*16..w*16+15 for every row
// fragment). The finished window tile is added to device memory with
// red.global.add.v4.f32: windows of one batch element overlap and their
// blocks run in no fixed order, so the alternative, a per-b ordering, would
// serialize the 1024 blocks of a batch element; reductions land in L2,
// which holds the whole 33.5 MB output. The sums are therefore reordered
// from run to run (f32, tolerance 1e-4 of max |out|).
//
// What bounds P1: the dense product, 2*WY*P*WX*C flops per block (1.10
// TFLOP at P=1024, WY=WX=64: ~1.1 ms at 989 TFLOP/s bf16), then the flush,
// 4*WY*WX*C bytes of reductions per block (2.1 GB per launch). The function
// itself moves 0.34 GB (~0.10 ms at 3.35 TB/s). The tents are mostly zero
// (each point touches 2 rows and 2 x-positions), which is the point of the
// probe: it prices the dense tensor-core formulation of the splat.
//
// P2 design: one CTA per point block. The readers take a block reduction
// in registers and shared memory and one atomic per block; they are bound
// by the bytes they read. `empty` reads nothing and adds 1.0 into a 64 x
// 2048 corner of the output per block (red.global.add.v4.f32, 512 KB per
// block), so it measures launch, per-block overhead and P1's flush alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kC = 32;                // plane channels
constexpr int kThreads = 256;         // 8 warps
constexpr int kBK = 64;               // points per chunk
constexpr int kBN = 128;              // output columns per CTA: 8 warps x 16
constexpr int kMaxMT = 8;             // WY <= 128: at most 8 row fragments
constexpr int kLdO = kMaxMT * 16 + 8; // oy chunk [kBK][kLdO] (padded)
constexpr int kLdZ = kBN + 8;         // Z chunk [kBK][kLdZ] (padded)
constexpr int kLdG = kC + 8;          // g chunk [kBK][kLdG] (padded)
constexpr int kXPerTile = kBN / kC;   // 4 x-positions per column tile

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

// Per point of the chunk: the offsets of its base cell from the window
// origin (yl0, xl0) and its fractional position in the cell (wy1, wx1),
// with the op order of the plain version: min(floor(i), W - 2).
struct ChunkPoints {
  float yl0[kBK], wy1[kBK], xl0[kBK], wx1[kBK];
};

__device__ __forceinline__ void load_points(ChunkPoints& pts, const float* iy,
                                            const float* ix, int64_t first,
                                            int oy0, int ox0, int H, int W) {
  const int t = threadIdx.x;
  if (t < kBK) {
    const float vy = iy[first + t];
    const float vx = ix[first + t];
    const float y0f = fminf(floorf(vy), static_cast<float>(H - 2));
    const float x0f = fminf(floorf(vx), static_cast<float>(W - 2));
    pts.wy1[t] = __fsub_rn(vy, y0f);
    pts.wx1[t] = __fsub_rn(vx, x0f);
    pts.yl0[t] = __fsub_rn(y0f, static_cast<float>(oy0));
    pts.xl0[t] = __fsub_rn(x0f, static_cast<float>(ox0));
  }
}

// The x tent of point k at window column x: f32 arithmetic rounded once to
// bf16, or (bf16build) every op rounded to bf16 as the bf16 build does.
template <int STAGE>
__device__ __forceinline__ bf16 x_tent(const ChunkPoints& pts, int k, int x) {
  if (STAGE == kBf16Build) {
    const float xc = __bfloat162float(
        __float2bfloat16_rn(__fadd_rn(pts.xl0[k], pts.wx1[k])));
    const float d = __bfloat162float(
        __float2bfloat16_rn(__fsub_rn(static_cast<float>(x), xc)));
    const float t = __bfloat162float(__float2bfloat16_rn(__fsub_rn(1.0f, fabsf(d))));
    return __float2bfloat16_rn(fmaxf(0.0f, t));
  }
  return __float2bfloat16_rn(
      tent(__fsub_rn(__fsub_rn(static_cast<float>(x), pts.xl0[k]), pts.wx1[k])));
}

__device__ __forceinline__ bf16 bf16_mul(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}

// P1, every stage that multiplies: full, static_store, no_tile, bf16build,
// dottile (Z = zx * tile(g)) and oy_only (oy^T @ oy). Grid: one CTA per
// (point block, 128-column tile of the window), column tile fastest.
template <int STAGE>
__global__ void __launch_bounds__(kThreads)
window_product_kernel(const int32_t* __restrict__ oy0s,
                      const int32_t* __restrict__ ox0s,
                      const float* __restrict__ iy,  // [B*nblocks, P]
                      const float* __restrict__ ix,  // [B*nblocks, P]
                      const bf16* __restrict__ g,    // [B*nblocks, P, kC]
                      float* __restrict__ out,       // [B, H, W*kC]
                      int nblocks, int P, int H, int W, int WY, int WX) {
  __shared__ __align__(128) bf16 s_oy[kBK * kLdO];
  __shared__ __align__(128) bf16 s_z[kBK * kLdZ];
  __shared__ __align__(128) bf16 s_g[kBK * kLdG];
  __shared__ __align__(128) bf16 s_ident[16 * 16];
  __shared__ bf16 s_zx[kBK][kXPerTile];
  __shared__ ChunkPoints pts;

  const int ncols = (STAGE == kOyOnly) ? WY : WX * kC;
  const int ntiles = (ncols + kBN - 1) / kBN;
  const int blk = blockIdx.x / ntiles;
  const int n0 = (blockIdx.x % ntiles) * kBN;
  const int b = blk / nblocks;
  const int oy0 = oy0s[blk];
  const int ox0 = ox0s[blk];
  const bool at_origin = (STAGE == kStaticStore || STAGE == kOyOnly);
  const int row0 = at_origin ? 0 : oy0;
  const int col0 = at_origin ? 0 : ox0 * kC;
  const int64_t WC = static_cast<int64_t>(W) * kC;
  // A window outside the plane would address outside `out`: drop it.
  if (row0 < 0 || row0 + WY > H || col0 < 0 || col0 + ncols > WC) return;

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int mt = WY / 16;
  const bool warp_has_cols = n0 + warp * 16 < ncols;

  if (STAGE == kDotTile) {
    for (int e = t; e < 256; e += kThreads)
      s_ident[e] = __float2bfloat16_rn((e / 16 == e % 16) ? 1.0f : 0.0f);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxMT];
#pragma unroll
  for (int i = 0; i < kMaxMT; ++i) wmma::fill_fragment(acc[i], 0.0f);

  const int64_t blk_first = static_cast<int64_t>(blk) * P;
  for (int p0 = 0; p0 < P; p0 += kBK) {
    load_points(pts, iy, ix, blk_first + p0, oy0, ox0, H, W);
    if (STAGE != kOyOnly && STAGE != kNoTile) {
      // g chunk [kBK, kC] bf16: 4 KB, 16 bytes per thread.
      const uint4* src = reinterpret_cast<const uint4*>(g + (blk_first + p0) * kC);
      const int k = t >> 2, q = t & 3;
      *reinterpret_cast<uint4*>(&s_g[k * kLdG + q * 8]) = __ldg(src + t);
    }
    __syncthreads();

    if (STAGE != kOyOnly) {
      // x tents of the tile's 4 x-positions: one per thread.
      const int k = t / kXPerTile, xi = t % kXPerTile;
      s_zx[k][xi] = x_tent<STAGE>(pts, k, n0 / kC + xi);
    }
    __syncthreads();

    if (STAGE == kDotTile) {
      // tile(g) as the product g[kBK x kC] @ tilemat[kC x kBN], tilemat[c, n]
      // = (n % kC == c): its 16x16 blocks are the identity where the column
      // block and the k-step agree mod 2, else zero. The f32 result is g
      // exactly; each warp rounds its 4 fragments to bf16 and multiplies by
      // the tents, staging through the (not yet built) oy buffer.
      float* stage = reinterpret_cast<float*>(s_oy) + warp * 256;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = warp * 4 + j, rt = f / 8, ct = f % 8;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> gt;
        wmma::fill_fragment(gt, 0.0f);
#pragma unroll
        for (int ks = 0; ks < kC / 16; ++ks) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, s_g + rt * 16 * kLdG + ks * 16, kLdG);
          if (ct % 2 == ks) {
            wmma::load_matrix_sync(bm, s_ident, 16);
          } else {
            wmma::fill_fragment(bm, __float2bfloat16_rn(0.0f));
          }
          wmma::mma_sync(gt, a, bm, gt);
        }
        wmma::store_matrix_sync(stage, gt, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int k = rt * 16 + e / 16, n = ct * 16 + e % 16;
          s_z[k * kLdZ + n] =
              bf16_mul(s_zx[k][n / kC], __float2bfloat16_rn(stage[e]));
        }
        __syncwarp();
      }
    } else if (STAGE != kOyOnly) {
      for (int e = t; e < kBK * kBN; e += kThreads) {
        const int k = e / kBN, n = e % kBN;
        const bf16 zx = s_zx[k][n / kC];
        s_z[k * kLdZ + n] =
            (STAGE == kNoTile) ? zx : bf16_mul(zx, s_g[k * kLdG + n % kC]);
      }
    }
    __syncthreads();

    // y tents oy[k, m], stored [k][m]: column-major A = oy^T [WY x kBK].
    for (int e = t; e < kBK * WY; e += kThreads) {
      const int k = e / WY, m = e % WY;
      s_oy[k * kLdO + m] = __float2bfloat16_rn(tent(__fsub_rn(
          __fsub_rn(static_cast<float>(m), pts.yl0[k]), pts.wy1[k])));
    }
    __syncthreads();

    if (warp_has_cols) {
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        if (STAGE == kOyOnly) {
          wmma::load_matrix_sync(bm, s_oy + ks * 16 * kLdO + n0 + warp * 16, kLdO);
        } else {
          wmma::load_matrix_sync(bm, s_z + ks * 16 * kLdZ + warp * 16, kLdZ);
        }
#pragma unroll
        for (int i = 0; i < kMaxMT; ++i) {
          if (i < mt) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
            wmma::load_matrix_sync(a, s_oy + ks * 16 * kLdO + i * 16, kLdO);
            wmma::mma_sync(acc[i], a, bm, acc[i]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!warp_has_cols) return;
  // Flush: each fragment goes through a per-warp 16x16 f32 staging tile
  // (the Z buffer is free now), then two v4 reductions per lane.
  float* stage = reinterpret_cast<float*>(s_z) + warp * 256;
  const int r = lane >> 1, half = (lane & 1) * 8;
  float* plane = out + static_cast<int64_t>(b) * H * WC;
#pragma unroll
  for (int i = 0; i < kMaxMT; ++i) {
    if (i < mt) {
      wmma::store_matrix_sync(stage, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      float* dst = plane + static_cast<int64_t>(row0 + i * 16 + r) * WC +
                   col0 + n0 + warp * 16 + half;
      red_add_v4(dst, stage + r * 16 + half);
      red_add_v4(dst + 4, stage + r * 16 + half + 4);
      __syncwarp();
    }
  }
}

// P1 z_only: the column sums of Z over the block's points, out[b, 0, n] +=
// sum_p Z[p, n] in f32. One thread per column, 128 columns per CTA.
__global__ void __launch_bounds__(kBN)
z_only_kernel(const int32_t* __restrict__ ox0s, const float* __restrict__ iy,
              const float* __restrict__ ix, const bf16* __restrict__ g,
              float* __restrict__ out, int nblocks, int P, int H, int W,
              int WX) {
  __shared__ __align__(16) bf16 s_g[kBK * kLdG];
  __shared__ bf16 s_zx[kBK][kXPerTile];
  __shared__ ChunkPoints pts;

  const int ntiles = WX * kC / kBN;
  const int blk = blockIdx.x / ntiles;
  const int n0 = (blockIdx.x % ntiles) * kBN;
  const int b = blk / nblocks;
  const int t = threadIdx.x;
  const int64_t blk_first = static_cast<int64_t>(blk) * P;
  float acc = 0.0f;
  for (int p0 = 0; p0 < P; p0 += kBK) {
    load_points(pts, iy, ix, blk_first + p0, 0, ox0s[blk], H, W);
    const uint4* src = reinterpret_cast<const uint4*>(g + (blk_first + p0) * kC);
    for (int e = t; e < kBK * kC / 8; e += kBN) {
      *reinterpret_cast<uint4*>(&s_g[(e >> 2) * kLdG + (e & 3) * 8]) = __ldg(src + e);
    }
    __syncthreads();
    for (int e = t; e < kBK * kXPerTile; e += kBN) {
      s_zx[e / kXPerTile][e % kXPerTile] =
          x_tent<kZOnly>(pts, e / kXPerTile, n0 / kC + e % kXPerTile);
    }
    __syncthreads();
    for (int k = 0; k < kBK; ++k) {
      acc += __bfloat162float(bf16_mul(s_zx[k][t / kC], s_g[k * kLdG + t % kC]));
    }
    __syncthreads();
  }
  atomicAdd(out + static_cast<int64_t>(b) * H * W * kC + n0 + t, acc);
}

// ---- P2 -------------------------------------------------------------------

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += partial[w];
  }
  return s;  // valid in thread 0
}

// empty: each block adds 1.0 into out[b, :rows, :cols] with v4 reductions,
// as each TPU grid step adds 1.0 into that corner of the plane: P1's
// window flush (a 64 x 2048 f32 window) without tents or product.
__global__ void __launch_bounds__(kThreads)
io_empty_kernel(float* __restrict__ out, int nblocks, int H, int WC, int rows,
                int cols) {
  float* plane = out + static_cast<int64_t>(blockIdx.x / nblocks) * H * WC;
  const float ones[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  const int quads = cols / 4;
  for (int e = threadIdx.x; e < rows * quads; e += kThreads)
    red_add_v4(plane + static_cast<int64_t>(e / quads) * WC + (e % quads) * 4, ones);
}

// read_g: out[b, 0, c] += sum_p g[blk, p, c]. Thread = (point lane of 64,
// 8-channel group of 4): one 16-byte load per point per thread.
__global__ void __launch_bounds__(kThreads)
io_read_g_kernel(const bf16* __restrict__ g, float* __restrict__ out,
                 int nblocks, int P, int H, int WC) {
  __shared__ float part[kThreads / 4][kC + 1];
  const int t = threadIdx.x, q = t & 3, pl = t >> 2;
  const uint4* src = reinterpret_cast<const uint4*>(
      g + static_cast<int64_t>(blockIdx.x) * P * kC);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = pl; p < P; p += kThreads / 4) {
    uint4 v = __ldg(src + p * 4 + q);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      acc[2 * j] += f.x;
      acc[2 * j + 1] += f.y;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) part[pl][q * 8 + j] = acc[j];
  __syncthreads();
  if (t < kC) {
    float s = 0.0f;
    for (int i = 0; i < kThreads / 4; ++i) s += part[i][t];
    atomicAdd(out + static_cast<int64_t>(blockIdx.x / nblocks) * H * WC + t, s);
  }
}

// read_ixy_P1: out[b, 0, 0] += sum_p (iy + ix), from two [NB, P] arrays.
__global__ void __launch_bounds__(kThreads)
io_read_ixy_p1_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                      float* __restrict__ out, int nblocks, int P, int H, int WC) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * P;
  const float4* a = reinterpret_cast<const float4*>(iy + first);
  const float4* c = reinterpret_cast<const float4*>(ix + first);
  float s = 0.0f;
  for (int i = threadIdx.x; i < P / 4; i += kThreads) {
    const float4 u = __ldg(a + i), v = __ldg(c + i);
    s += (u.x + v.x) + (u.y + v.y) + (u.z + v.z) + (u.w + v.w);
  }
  s = block_sum(s);
  if (threadIdx.x == 0)
    atomicAdd(out + static_cast<int64_t>(blockIdx.x / nblocks) * H * WC, s);
}

// read_ixy_2P: out[b, 0, 0] += sum of the block's [2, P] array.
__global__ void __launch_bounds__(kThreads)
io_read_ixy_2p_kernel(const float* __restrict__ ixy, float* __restrict__ out,
                      int nblocks, int P, int H, int WC) {
  const float4* a = reinterpret_cast<const float4*>(
      ixy + static_cast<int64_t>(blockIdx.x) * 2 * P);
  float s = 0.0f;
  for (int i = threadIdx.x; i < P / 2; i += kThreads) {
    const float4 u = __ldg(a + i);
    s += (u.x + u.y) + (u.z + u.w);
  }
  s = block_sum(s);
  if (threadIdx.x == 0)
    atomicAdd(out + static_cast<int64_t>(blockIdx.x / nblocks) * H * WC, s);
}

// transpose_2P: out[b, 0, 0] += sum_p sum_{y<64} (max(0, 1-|y-iy|) + 0*ix),
// reading iy and ix from the block's [2, P] array.
__global__ void __launch_bounds__(kThreads)
io_transpose_2p_kernel(const float* __restrict__ ixy, float* __restrict__ out,
                       int nblocks, int P, int H, int WC) {
  const float* v = ixy + static_cast<int64_t>(blockIdx.x) * 2 * P;
  float s = 0.0f;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float y = __ldg(v + p), x = __ldg(v + P + p);
    const float zero_x = __fmul_rn(0.0f, x);
    for (int lane = 0; lane < 64; ++lane) {
      s += __fadd_rn(tent(__fsub_rn(static_cast<float>(lane), y)), zero_x);
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0)
    atomicAdd(out + static_cast<int64_t>(blockIdx.x / nblocks) * H * WC, s);
}

template <int STAGE>
void launch_product(int blocks, int ntiles, cudaStream_t s, const int32_t* oy0,
                    const int32_t* ox0, const float* iy, const float* ix,
                    const bf16* g, float* out, int nblocks, int P, int H, int W,
                    int WY, int WX) {
  window_product_kernel<STAGE><<<blocks * ntiles, kThreads, 0, s>>>(
      oy0, ox0, iy, ix, g, out, nblocks, P, H, W, WY, WX);
}

}  // namespace

// P1. Shapes: oy0, ox0 [B*nblocks] i32; iy, ix [B*nblocks, P] f32; g
// [B*nblocks, P, 32] bf16; out [B, H, W*32] f32, zeroed by the caller. The
// wrapper (kernels/splat_probes.py) checks shapes and types; this returns
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int splat_window_probe(const int32_t* oy0, const int32_t* ox0,
                                  const float* iy, const float* ix,
                                  const void* g, float* out, int B, int nblocks,
                                  int P, int H, int W, int WY, int WX, int stage,
                                  void* stream) {
  const int blocks = B * nblocks;
  if (blocks <= 0 || P % kBK != 0 || WY % 16 != 0 || WY > kMaxMT * 16 ||
      (WX * kC) % kBN != 0 || H < 2 || W < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gb = static_cast<const bf16*>(g);
  const int ntiles = WX * kC / kBN;
  switch (stage) {
    case kFull:
      launch_product<kFull>(blocks, ntiles, s, oy0, ox0, iy, ix, gb, out, nblocks, P, H, W, WY, WX);
      break;
    case kStaticStore:
      launch_product<kStaticStore>(blocks, ntiles, s, oy0, ox0, iy, ix, gb, out, nblocks, P, H, W, WY, WX);
      break;
    case kNoTile:
      launch_product<kNoTile>(blocks, ntiles, s, oy0, ox0, iy, ix, gb, out, nblocks, P, H, W, WY, WX);
      break;
    case kBf16Build:
      launch_product<kBf16Build>(blocks, ntiles, s, oy0, ox0, iy, ix, gb, out, nblocks, P, H, W, WY, WX);
      break;
    case kDotTile:
      launch_product<kDotTile>(blocks, ntiles, s, oy0, ox0, iy, ix, gb, out, nblocks, P, H, W, WY, WX);
      break;
    case kOyOnly:
      launch_product<kOyOnly>(blocks, 1, s, oy0, ox0, iy, ix, gb, out, nblocks, P, H, W, WY, WX);
      break;
    case kZOnly:
      z_only_kernel<<<blocks * ntiles, kBN, 0, s>>>(ox0, iy, ix, gb, out, nblocks, P, H, W, WX);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// P2. variant: 0 empty, 1 read_g, 2 read_ixy_P1, 3 read_ixy_2P,
// 4 transpose_2P (kernels/splat_probes.py::IO_VARIANTS). iy, ix [B*nblocks,
// P] f32; ixy [B*nblocks, 2, P] f32; g [B*nblocks, P, 32] bf16; out [B, H,
// W*32] f32, zeroed by the caller.
extern "C" int splat_io_probe(int variant, const float* iy, const float* ix,
                              const float* ixy, const void* g, float* out,
                              int B, int nblocks, int P, int H, int W,
                              void* stream) {
  const int blocks = B * nblocks;
  if (blocks <= 0 || P % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int WC = W * kC;
  switch (variant) {
    case 0: {
      const int rows = H < 64 ? H : 64, cols = WC < 2048 ? WC : 2048;
      io_empty_kernel<<<blocks, kThreads, 0, s>>>(out, nblocks, H, WC, rows, cols);
      break;
    }
    case 1:
      io_read_g_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const bf16*>(g), out,
                                                   nblocks, P, H, WC);
      break;
    case 2:
      io_read_ixy_p1_kernel<<<blocks, kThreads, 0, s>>>(iy, ix, out, nblocks, P, H, WC);
      break;
    case 3:
      io_read_ixy_2p_kernel<<<blocks, kThreads, 0, s>>>(ixy, out, nblocks, P, H, WC);
      break;
    case 4:
      io_transpose_2p_kernel<<<blocks, kThreads, 0, s>>>(ixy, out, nblocks, P, H, WC);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
