// Triplane-splat backward: the plane gradient of the mean of three bilinear
// plane samples, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nerf_from_image_tpu/ops/pallas/splat.py
// (_splat3_kernel, launched by splat3_blocks inside triplane_splat_grads,
// the backward of triplane_sample_mean). It computes, for all three planes
// in one launch,
//
//     dPlane_p[b, y, x, c] += sum_n w_p(n, y, x) * g[b, n, c]
//
// where w_p are the bilinear corner weights of point n projected onto
// plane p (xy, xz, yz). Pixel coordinates are recomputed here with the
// same op order as ops/triplane.py: clip((c + 1) * 0.5 * (W - 1), 0, W-1),
// floor, then min(floor, W - 2) for the base cell; an integer clamp keeps a
// NaN coordinate inside the plane.
//
// What bounds it. The bytes floor at the bench shape (B=4, N=128^2*64,
// 256^2 x 32 planes) is ~0.69 GB (g 537 MB, coordinates 50 MB, plane
// gradients 101 MB): 0.205 ms at 3.35 TB/s. The first port (one warp per
// point, 12 scalar f32 atomics per point and channel) reduced 6.44 GB into
// L2 per launch and ran at the card's L2 reduction rate, ~3 TB/s. So the
// lever is fewer bytes reduced into L2.
//
// Design. The points keep their [B, Hi, Wi, S] ray-grid layout (rows of
// S samples per ray, as the render makes them). One CTA of 512 threads
// takes one ray-coherent block, an image tile of th x tw rays by a slab of
// ts samples (the TPU kernel's block, 16 x 16 x 4 by default), for all
// channels up to 32. A block's bilinear footprint on a plane is a small
// box, and at the bench geometry each touched texel is hit ~7 times, so
// summing the block's corners on chip and reducing each touched texel into
// L2 once cuts the L2 bytes ~7x (0.93 GB instead of 6.44 at the bench
// shape, counted by the kernel).
//
//  - The CTA loads the block's coordinates and then its g rows with
//    cp.async; the first plane sorts while g lands, and g serves all
//    three planes. A block of 1024 points takes ~176 KB of shared memory
//    and one CTA per SM; blocks small enough for two CTAs per SM get two,
//    and one CTA's loads then overlap the other's sums.
//  - Per plane, a block reduction gives the footprint's bounding box, and
//    the corners are sorted by texel of the box with a counting sort: a
//    shared-memory integer atomic per corner counts and ranks it, a block
//    scan turns the counts into offsets, and the (point, weight) entries
//    are scattered into texel order. Thread = (texel, 4 channels) then
//    sums its entries' w * g in registers and adds the sum into the plane
//    with one red.global.add.v4.f32 where it is not 0, so only touched
//    texels are reduced into L2. The sort is shared by all channels.
//  - Why a sort and not a window of f32 sums: Hopper has no native
//    shared-memory f32 atomic add (atomicAdd compiles to a
//    compare-and-swap loop, ATOMS.CAST.SPIN), and ~4,000 corner updates
//    per channel land on ~600 texels, so such a window retries under
//    contention: that version reduced 0.97 GB into L2 but took 4.57 ms
//    per launch at the bench shape, 2x the first port (chip_smoke.py
//    phase 2). The sort needs 4 B of shared memory per box texel instead
//    of 4 per texel and channel, so boxes of ~14,000 texels fit.
//  - What bounds it now: the per-texel sums, a chain of two shared loads
//    and four FMAs per entry and 4 channels, then the exposed load of g
//    with one CTA per SM, then the sort; the reductions into L2 are no
//    longer the limit.
//  - A (block, plane) whose box does not fit (grazing rays, scattered
//    points, the contiguous order of a bare query) sends its corners
//    straight to device memory with red.global.add.v4.f32, one thread per
//    (point, 4 channels): exact for any geometry inside the one launch.
//
// The sums are reordered from run to run (atomics), so results agree with
// the plain version to f32 rounding, not bit for bit. When `stats` is not
// null the kernel adds, per launch, the (block, plane) pairs whose box did
// not fit, all (block, plane) pairs, and the bytes it reduced into device
// memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPointsPerThread = 2;  // blocks of up to 1024 points
constexpr int kBboxInts = 12;        // per plane: xmin, xmax, ymin, ymax
// Ints at the head of shared memory: the three boxes, then the scan's
// warp totals (16-byte aligned for what follows).
constexpr int kHeadInts = 32;
// Channels per CTA: all of them up to this many.
constexpr int kMaxChannelGroup = 32;
// Two CTAs share an SM when each still holds boxes of this many texels.
constexpr int kMinBoxTexels = 4096;

struct Geometry {
  int64_t N;          // points per batch element, Hi * Wi * S
  int Hi, Wi, S;      // ray grid
  int th, tw, ts;     // block: image tile x depth slab
  int nty, ntx, nts;  // blocks along each grid axis (ragged edges masked)
  int cg_width, ncg;  // channel groups: C = ncg * cg_width
  int64_t items;      // B * nty * ntx * nts * ncg
  int H, W, C;        // planes
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void red_add_v4(float* addr, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Plane p samples (axis_x, axis_y) = (x, y), (x, z), (y, z).
__device__ __forceinline__ int axis_x(int p) { return p == 2 ? 1 : 0; }
__device__ __forceinline__ int axis_y(int p) { return p == 0 ? 1 : 2; }

// Base cell (x0, y0) and upper weights (wx1, wy1) of one point on one plane.
__device__ __forceinline__ void base_cell(float cx, float cy, int H, int W, int& x0,
                                          int& y0, float& wx1, float& wy1) {
  const float wm1 = static_cast<float>(W - 1);
  const float hm1 = static_cast<float>(H - 1);
  const float ix = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(cx, 1.0f), 0.5f), wm1), 0.0f), wm1);
  const float iy = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(cy, 1.0f), 0.5f), hm1), 0.0f), hm1);
  const float x0f = fminf(floorf(ix), static_cast<float>(W - 2));
  const float y0f = fminf(floorf(iy), static_cast<float>(H - 2));
  wx1 = __fsub_rn(ix, x0f);
  wy1 = __fsub_rn(iy, y0f);
  x0 = min(max(static_cast<int>(x0f), 0), W - 2);
  y0 = min(max(static_cast<int>(y0f), 0), H - 2);
}

// A work item's batch element, block origin in the grid and channel group.
struct Item {
  int64_t b;
  int y0, x0, s0, cg;
};

__device__ __forceinline__ Item decode(const Geometry& geo, int64_t item) {
  Item it;
  it.cg = static_cast<int>(item % geo.ncg);
  item /= geo.ncg;
  it.s0 = static_cast<int>(item % geo.nts) * geo.ts;
  item /= geo.nts;
  it.x0 = static_cast<int>(item % geo.ntx) * geo.tw;
  item /= geo.ntx;
  it.y0 = static_cast<int>(item % geo.nty) * geo.th;
  it.b = item / geo.nty;
  return it;
}

// Point q of a block (q = (ly * tw + lx) * ts + ls): its index in [0, N),
// or -1 where the block overhangs the grid.
__device__ __forceinline__ int64_t point_of(const Geometry& geo, const Item& it, int q) {
  const int ls = q % geo.ts;
  const int r = q / geo.ts;
  const int y = it.y0 + r / geo.tw;
  const int x = it.x0 + r % geo.tw;
  const int s = it.s0 + ls;
  if (y >= geo.Hi || x >= geo.Wi || s >= geo.S) return -1;
  return (static_cast<int64_t>(y) * geo.Wi + x) * geo.S + s;
}

// Copies a block's coordinates [P, 3] and its g slice [P, CG] (channels
// cg*CG .. cg*CG+CG-1) into shared memory as two cp.async groups.
__device__ __forceinline__ void load_block(const Geometry& geo, const Item& it,
                                           const float* __restrict__ coords,
                                           const float* __restrict__ g, int P, int CG,
                                           float* cdst, float* gdst) {
  const int64_t row0 = it.b * geo.N;
  for (int e = threadIdx.x; e < P * 3; e += kThreads) {
    const int64_t n = point_of(geo, it, e / 3);
    if (n >= 0) cp_async4(cdst + e, coords + (row0 + n) * 3 + e % 3);
  }
  cp_async_commit();
  const int quads = CG / 4;
  for (int e = threadIdx.x; e < P * quads; e += kThreads) {
    const int64_t n = point_of(geo, it, e / quads);
    if (n >= 0) cp_async16(gdst + e * 4, g + (row0 + n) * geo.C + it.cg * CG + (e % quads) * 4);
  }
  cp_async_commit();
}

// Exclusive scan of counts[0, n) in place, with counts[n] = the total.
// Every thread of the CTA calls it; it ends with the CTA synchronised.
__device__ void block_exclusive_scan(int* counts, int n, int* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? warp_tot[lane] : 0;
    int vi = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, vi, o);
      if (lane >= o) vi += u;
    }
    if (lane < kWarps) warp_tot[lane] = vi - v;
  }
  __syncthreads();
  int run = warp_tot[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (t == kThreads - 1) counts[n] = run;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
splat3_blocks_kernel(const float* __restrict__ coords,  // [B, N, 3]
                     const float* __restrict__ g,       // [B, N, C]
                     float* __restrict__ out,           // [B, 3, H, W, C]
                     Geometry geo, int max_texels,
                     unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  const int P = geo.th * geo.tw * geo.ts;
  const int CG = geo.cg_width, quads = CG / 4;
  int* bbox = reinterpret_cast<int*>(smem);
  int* warp_tot = bbox + kBboxInts;
  float* gs = smem + kHeadInts;                                      // [P, CG]
  float* cs = gs + P * CG;                                           // [P, 3]
  int2* entries = reinterpret_cast<int2*>(cs + ((P * 3 + 3) & ~3));  // [4P] (point, w)
  int* offsets = reinterpret_cast<int*>(entries + 4 * P);            // [max_texels + 1]
  const float4* gs4 = reinterpret_cast<const float4*>(gs);

  const int t = threadIdx.x;
  const int H = geo.H, W = geo.W, C = geo.C;
  const Item it = decode(geo, blockIdx.x);
  float* const out_b = out + it.b * 3 * (static_cast<int64_t>(H) * W * C) + it.cg * CG;

  // The coordinates land first; g streams in while the first plane sorts.
  load_block(geo, it, coords, g, P, CG, cs, gs);
  if (t < kBboxInts) bbox[t] = (t & 1) ? INT_MIN : INT_MAX;
  cp_async_wait<1>();
  __syncthreads();

  // This thread's points t and t + kThreads, the same in every plane;
  // -1 where the block has no such point or it overhangs the grid.
  int qs[kPointsPerThread];
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k) {
    const int q = t + k * kThreads;
    qs[k] = (q < P && point_of(geo, it, q) >= 0) ? q : -1;
  }

  // Bounding box of the block's base cells on each plane.
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    int x0 = INT_MAX, y0 = INT_MAX, x1 = INT_MIN, y1 = INT_MIN;
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
      if (qs[k] < 0) continue;
      int cx, cy;
      float wx1, wy1;
      base_cell(cs[qs[k] * 3 + axis_x(p)], cs[qs[k] * 3 + axis_y(p)], H, W, cx, cy, wx1, wy1);
      x0 = min(x0, cx);
      x1 = max(x1, cx);
      y0 = min(y0, cy);
      y1 = max(y1, cy);
    }
    x0 = __reduce_min_sync(0xffffffffu, x0);
    x1 = __reduce_max_sync(0xffffffffu, x1);
    y0 = __reduce_min_sync(0xffffffffu, y0);
    y1 = __reduce_max_sync(0xffffffffu, y1);
    if ((t & 31) == 0) {
      atomicMin(&bbox[4 * p + 0], x0);
      atomicMax(&bbox[4 * p + 1], x1);
      atomicMin(&bbox[4 * p + 2], y0);
      atomicMax(&bbox[4 * p + 3], y1);
    }
  }
  __syncthreads();

  unsigned long long reduced_bytes = 0;
  unsigned long long misfits = 0, pairs = 0;
  for (int p = 0; p < 3; ++p) {
    const int xmin = bbox[4 * p + 0], xmax = bbox[4 * p + 1];
    const int ymin = bbox[4 * p + 2], ymax = bbox[4 * p + 3];
    if (xmin > xmax) continue;  // no point of the block lies in the grid
    const int bw = xmax - xmin + 2;
    const int bh = ymax - ymin + 2;
    const int64_t ntex64 = static_cast<int64_t>(bw) * bh;
    const bool fits = ntex64 <= max_texels;
    float* const plane = out_b + p * (static_cast<int64_t>(H) * W * C);
    const int ax = axis_x(p), ay = axis_y(p);
    if (t == 0) {
      ++pairs;
      misfits += fits ? 0 : 1;
    }
    if (!fits) {
      cp_async_wait<0>();
      __syncthreads();  // g has landed
      for (int i = t; i < P * quads; i += kThreads) {
        const int q = i / quads, quad = i % quads;
        if (point_of(geo, it, q) < 0) continue;
        int x0, y0;
        float wx1, wy1;
        base_cell(cs[q * 3 + ax], cs[q * 3 + ay], H, W, x0, y0, wx1, wy1);
        const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
        const float4 gv = gs4[i];
        float* base = plane + (static_cast<int64_t>(y0) * W + x0) * C + quad * 4;
        const int64_t row = static_cast<int64_t>(W) * C;
        const float w[4] = {wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1};
        float* const dst[4] = {base, base + C, base + row, base + row + C};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          red_add_v4(dst[k], make_float4(gv.x * w[k], gv.y * w[k], gv.z * w[k], gv.w * w[k]));
        }
        reduced_bytes += 64;
      }
      continue;
    }

    // Counting sort of the block's corners by texel of the box: count and
    // rank each corner, scan the counts into offsets, scatter the entries.
    const int ntex = static_cast<int>(ntex64);
    for (int i = t; i <= ntex; i += kThreads) offsets[i] = 0;
    __syncthreads();
    int key[kPointsPerThread], slot[kPointsPerThread][4];
    float fx[kPointsPerThread], fy[kPointsPerThread];
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
      if (qs[k] < 0) continue;
      int x0, y0;
      base_cell(cs[qs[k] * 3 + ax], cs[qs[k] * 3 + ay], H, W, x0, y0, fx[k], fy[k]);
      // The box was taken over these same cells; the clamp only keeps the
      // keys inside the box whatever the arithmetic does.
      const int lx = min(max(x0 - xmin, 0), bw - 2);
      const int ly = min(max(y0 - ymin, 0), bh - 2);
      key[k] = ly * bw + lx;
      slot[k][0] = atomicAdd(&offsets[key[k]], 1);
      slot[k][1] = atomicAdd(&offsets[key[k] + 1], 1);
      slot[k][2] = atomicAdd(&offsets[key[k] + bw], 1);
      slot[k][3] = atomicAdd(&offsets[key[k] + bw + 1], 1);
    }
    __syncthreads();
    block_exclusive_scan(offsets, ntex, warp_tot);
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
      if (qs[k] < 0) continue;
      const float wx0 = 1.0f - fx[k], wy0 = 1.0f - fy[k];
      entries[offsets[key[k]] + slot[k][0]] = make_int2(qs[k], __float_as_int(wy0 * wx0));
      entries[offsets[key[k] + 1] + slot[k][1]] = make_int2(qs[k], __float_as_int(wy0 * fx[k]));
      entries[offsets[key[k] + bw] + slot[k][2]] = make_int2(qs[k], __float_as_int(fy[k] * wx0));
      entries[offsets[key[k] + bw + 1] + slot[k][3]] =
          make_int2(qs[k], __float_as_int(fy[k] * fx[k]));
    }
    cp_async_wait<0>();
    __syncthreads();  // entries written; g has landed

    // Thread = (texel, 4 channels): sum the texel's entries in registers,
    // one reduction to L2 where the sum is not 0.
    for (int i = t; i < ntex * quads; i += kThreads) {
      const int texel = i / quads, quad = i % quads;
      const int beg = offsets[texel], end = offsets[texel + 1];
      if (beg == end) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int e = beg; e < end; ++e) {
        const int2 en = entries[e];
        const float w = __int_as_float(en.y);
        const float4 gv = gs4[en.x * quads + quad];
        acc.x += gv.x * w;
        acc.y += gv.y * w;
        acc.z += gv.z * w;
        acc.w += gv.w * w;
      }
      if (acc.x == 0.0f && acc.y == 0.0f && acc.z == 0.0f && acc.w == 0.0f) continue;
      const int ly = texel / bw, lx = texel % bw;
      red_add_v4(plane + (static_cast<int64_t>(ymin + ly) * W + xmin + lx) * C + quad * 4, acc);
      reduced_bytes += 16;
    }
    __syncthreads();  // the next plane reuses the offsets and entries
  }
  cp_async_wait<0>();

  if (stats != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      reduced_bytes += __shfl_xor_sync(0xffffffffu, reduced_bytes, o);
    }
    if ((t & 31) == 0 && reduced_bytes) atomicAdd(stats + 2, reduced_bytes);
    if (t == 0 && it.cg == 0 && pairs) {
      atomicAdd(stats + 0, misfits);
      atomicAdd(stats + 1, pairs);
    }
  }
}

int launch(const float* coords, const float* g, float* out, const Geometry& geo,
           unsigned long long* stats, cudaStream_t stream) {
  int dev = 0, smem_block = 0, smem_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = geo.th * geo.tw * geo.ts;
  if (P > kPointsPerThread * kThreads || geo.items > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // What the head, g, the coordinates and the entries leave of the shared
  // memory holds the box's offsets. Two CTAs share an SM where that still
  // leaves room for boxes of kMinBoxTexels; else one CTA takes it all.
  const int64_t fixed = 4 * (kHeadInts + static_cast<int64_t>(P) * geo.cg_width +
                             ((P * 3 + 3) & ~3) + 8 * P + 1);
  int bytes = (smem_sm / 2 - reserved) & ~15;
  if (bytes - fixed < 4 * kMinBoxTexels) bytes = smem_block;
  const int64_t max_texels = (bytes - fixed) / 4;
  if (max_texels < 4) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(splat3_blocks_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(splat3_blocks_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  splat3_blocks_kernel<<<static_cast<unsigned int>(geo.items), kThreads, bytes, stream>>>(
      coords, g, out, geo, static_cast<int>(max_texels), stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coords [B, N, 3], g [B, N, C] f32 contiguous, out [B, 3, H, W, C] f32
// zeroed by the caller; the points form the ray grid [B, Hi, Wi, S]
// (N = Hi * Wi * S) and are taken in blocks of th x tw x ts <= 1024
// points. C must be a multiple of 4, and of 32 above 32; g 16-byte
// aligned. Returns a cudaError_t.
extern "C" int splat3_backward(const float* coords, const float* g, float* out,
                               int64_t B, int64_t N, int H, int W, int C,
                               int Hi, int Wi, int S, int th, int tw, int ts,
                               unsigned long long* stats, void* stream) {
  if (B * N == 0) return static_cast<int>(cudaSuccess);
  const int cg_width = C < kMaxChannelGroup ? C : kMaxChannelGroup;
  if (static_cast<int64_t>(Hi) * Wi * S != N || C % 4 != 0 || C % cg_width != 0 ||
      H < 2 || W < 2 || th < 1 || tw < 1 || ts < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry geo;
  geo.N = N;
  geo.Hi = Hi;
  geo.Wi = Wi;
  geo.S = S;
  geo.th = th;
  geo.tw = tw;
  geo.ts = ts;
  geo.nty = (Hi + th - 1) / th;
  geo.ntx = (Wi + tw - 1) / tw;
  geo.nts = (S + ts - 1) / ts;
  geo.cg_width = cg_width;
  geo.ncg = C / cg_width;
  geo.items = B * geo.nty * geo.ntx * geo.nts * geo.ncg;
  geo.H = H;
  geo.W = W;
  geo.C = C;
  return launch(coords, g, out, geo, stats, static_cast<cudaStream_t>(stream));
}
