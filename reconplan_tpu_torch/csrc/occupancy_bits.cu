// The occupancy mip of the brick mask pipeline: per mip cell of each frame,
// which of 64 depth bins over the chunk's valid-depth range its pixels
// fill, as two 32-bit planes OR-dilated over a wrap-around box, in three
// launches.
//
// Replaces no TPU kernel: the JAX occupancy is plain XLA,
// `_build_depth_occupancy` (reconplan_tpu/ops/tsdf_brick.py:215), and its
// PyTorch port (`ops/tsdf_brick._build_depth_occupancy`) stays the plain
// version for CPU tensors. Run eagerly on the card that chain is a min and a
// max over the chunk, the bins, a `scatter_reduce` of bin presence per
// cell, the packing into two i32 planes and 4 rounds x 2 axes x 2 planes of
// rolls and ORs: 122 launches a chunk of 8 frames, each costing the host
// about 13 us while the card idles, where the card's own work is a few
// microseconds.
//
// Semantics, for depths (F, Hd, Wd), cell C and R rounds:
//   d      = depth / scale (an IEEE divide); valid = 0 < d < depth_max
//   gmin   = min of the valid d, gmax = max (a non-finite one reads 0)
//   bs     = max((gmax - gmin) / 62, 0.002), b0 = gmin - bs
//   bin    = clamp(trunc((d - b0) / bs), 0, 63) of a valid pixel
//   und[p] = for plane p in {0, 1}: bit k set where a valid pixel of the
//            C x C cell has bin 32 p + k (bit 31 is the i32 sign)
//   out[p] = OR of und[p] over the (2R + 1)^2 box around each cell, rows
//            and columns taken modulo Hm = Hd / C and Wm = Wd / C: the
//            plain version's R rounds of wrap-around rolls, also where a
//            plane is smaller than the box
//   binp   = (b0, bs)
// Every float operation follows the plain version's; the library is built
// with -fmad=false, so the planes and binp equal the plain version's bits.
//
// What bounds it. It must read the chunk's depths twice (once for the
// range, once for the bins: 2 x 9.8 MB at 8 frames of 640 x 480, 5.9 us at
// 3.35 TB/s) and write the planes (307 KB). Against that bound stand the
// three launches' fixed costs (about 1.5 us each on the card), the
// dependence between them (the bins need the whole chunk's range, the box
// every cell of a frame) and three IEEE divides a pixel over the two
// passes, each a few tens of instructions, which the plain version's bits
// require. On an H100 at 700 W the profiler read about 7 us for the range,
// 11 us for the cells and 5 us for the box a call at that chunk; about
// 23 us for the three in a CUDA graph, against 343-387 us for the eager
// chain.
//
// Design. No sort, no scatter, no atomics: each output word has one writer.
// (1) `occupancy_range_kernel`, kPartials blocks over the chunk in 16-byte
// loads: each block writes its partial min and max of the valid depths.
// (2) `occupancy_cells_kernel<C>`: one warp a strip of 32 pixels across
// and C rows, 32 / C cells: lane l loads column l of the C rows (C loads in
// flight, each row of the warp one 128-byte line) before its block folds
// the partials to gmin, gmax, bs and b0 (block 0 writes binp); then each
// lane sets its pixels' bin bits, and the C lanes of a cell OR their words
// together with shuffles. (3) `occupancy_dilate_kernel`: a block holds
// kTileRows output rows of one frame's plane plus R rows above and below
// (modulo Hm) in shared memory, ORs each row over its 2R + 1 columns
// (modulo Wm), then each column over its 2R + 1 rows. The partials and the
// undilated planes are scratch the caller allocates uninitialised; nothing
// needs zeroing, so the stage is exactly the three kernel launches.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPartials = 512;  // blocks of the range pass
constexpr int kRangeThreads = 256;
constexpr int kCellThreads = 256;
constexpr int kCellWarps = kCellThreads / 32;
constexpr int kStrip = 32;     // pixels across a warp of the cell pass
constexpr int kTileRows = 8;   // output rows a block of the dilation
constexpr int kDilateThreads = 256;
// `_occupancy_cell` keeps Wm at 128 or under; with R <= 16 a block's two
// row buffers stay under the 48 KB of static shared memory
constexpr int kMaxWidth = 128;
constexpr int kMaxRounds = 16;
constexpr int kBins = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void take(float raw, float scale, float depth_max,
                                     float& lo, float& hi) {
  const float d = raw / scale;
  if (d > 0.0f && d < depth_max) {
    lo = fminf(lo, d);
    hi = fmaxf(hi, d);
  }
}

// the block's min of lo and max of hi, in every thread
template <int kThreads>
__device__ __forceinline__ void block_range(float& lo, float& hi) {
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kRangeThreads) occupancy_range_kernel(
    const float* __restrict__ depths,  // (n,) raw depth
    float* __restrict__ partials,      // (2, kPartials) out: mins, maxes
    long long n, long long n4, float scale, float depth_max) {
  float lo = INFINITY, hi = -INFINITY;
  const long long stride = (long long)gridDim.x * kRangeThreads;
  const long long tid = (long long)blockIdx.x * kRangeThreads + threadIdx.x;
  // the first 4 * n4 depths in 16-byte loads, four in flight a thread
  const float4* d4 = reinterpret_cast<const float4*>(depths);
  long long i = tid;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(d4 + i + k * stride);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      take(v[k].x, scale, depth_max, lo, hi);
      take(v[k].y, scale, depth_max, lo, hi);
      take(v[k].z, scale, depth_max, lo, hi);
      take(v[k].w, scale, depth_max, lo, hi);
    }
  }
  for (; i < n4; i += stride) {
    const float4 v = __ldg(d4 + i);
    take(v.x, scale, depth_max, lo, hi);
    take(v.y, scale, depth_max, lo, hi);
    take(v.z, scale, depth_max, lo, hi);
    take(v.w, scale, depth_max, lo, hi);
  }
  for (long long j = 4 * n4 + tid; j < n; j += stride) {
    take(__ldg(depths + j), scale, depth_max, lo, hi);
  }
  block_range<kRangeThreads>(lo, hi);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = lo;
    partials[kPartials + blockIdx.x] = hi;
  }
}

template <int kCell>
__global__ void __launch_bounds__(kCellThreads) occupancy_cells_kernel(
    const float* __restrict__ depths,    // (F, Hd, Wd) raw depth
    const float* __restrict__ partials,  // (2, kPartials)
    int32_t* __restrict__ und,           // (2, F, Hm, Wm) out: undilated
    float* __restrict__ binp,            // (2,) out: b0, bs
    int n_strips, int strips, int wd, int wm, int n_cells, float scale,
    float depth_max) {
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kCellWarps + (threadIdx.x >> 5);
  // the strip: cell row fy = f * Hm + my, pixels s * kStrip + lane across
  const int fy = unit / strips;
  const int x = (unit - fy * strips) * kStrip + lane;
  const bool in = unit < n_strips && x < wd;
  float raw[kCell];
  const float* col = depths + (long long)fy * kCell * wd + x;
#pragma unroll
  for (int k = 0; k < kCell; ++k) {
    raw[k] = in ? __ldg(col + (long long)k * wd) : 0.0f;
  }
  float gmin = INFINITY, gmax = -INFINITY;
  for (int i = threadIdx.x; i < kPartials; i += kCellThreads) {
    gmin = fminf(gmin, partials[i]);
    gmax = fmaxf(gmax, partials[kPartials + i]);
  }
  block_range<kCellThreads>(gmin, gmax);
  if (!isfinite(gmin)) gmin = 0.0f;
  if (!isfinite(gmax)) gmax = 0.0f;
  // torch.clamp(x, min=0.002) of a finite x
  const float bs = fmaxf((gmax - gmin) / 62.0f, 0.002f);
  const float b0 = gmin - bs;  // bin 1 starts at gmin; 0 and 63 are margin
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    binp[0] = b0;
    binp[1] = bs;
  }
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int k = 0; k < kCell; ++k) {
    const float d = raw[k] / scale;
    if (d > 0.0f && d < depth_max) {
      // the int cast truncates toward zero, as .to(torch.int32)
      const int bin = min(max((int)((d - b0) / bs), 0), kBins - 1);
      if (bin < 32) {
        lo |= 1u << bin;
      } else {
        hi |= 1u << (bin - 32);
      }
    }
  }
  // the kCell lanes of a cell: an aligned group of the warp
#pragma unroll
  for (int o = 1; o < kCell; o <<= 1) {
    lo |= __shfl_xor_sync(kFull, lo, o);
    hi |= __shfl_xor_sync(kFull, hi, o);
  }
  if (in && (lane & (kCell - 1)) == 0) {
    const int cell = fy * wm + x / kCell;
    und[cell] = (int32_t)lo;
    und[n_cells + cell] = (int32_t)hi;
  }
}

__global__ void __launch_bounds__(kDilateThreads) occupancy_dilate_kernel(
    const int32_t* __restrict__ und,  // (2, F, Hm, Wm) undilated
    int32_t* __restrict__ out,        // (2, F, Hm, Wm) out: dilated
    int n_cells, int hm, int wm, int rounds, int tiles) {
  __shared__ int32_t s_rows[(kTileRows + 2 * kMaxRounds) * kMaxWidth];
  __shared__ int32_t s_wide[(kTileRows + 2 * kMaxRounds) * kMaxWidth];
  const int f = blockIdx.x / tiles;
  const int y0 = (blockIdx.x - f * tiles) * kTileRows;
  const long long at = (long long)blockIdx.y * n_cells + (long long)f * hm * wm;
  const int32_t* src = und + at;
  int32_t* dst = out + at;
  const int rows = kTileRows + 2 * rounds;
  // rows y0 - R .. y0 + kTileRows + R - 1 of the plane, modulo Hm
  for (int i = threadIdx.x; i < rows * wm; i += kDilateThreads) {
    const int r = i / wm;
    const int x = i - r * wm;
    s_rows[i] = src[wrap(y0 - rounds + r, hm) * wm + x];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * wm; i += kDilateThreads) {
    const int r = i / wm;
    const int32_t* row = s_rows + r * wm;
    int xx = wrap(i - r * wm - rounds, wm);
    int32_t acc = 0;
    for (int dx = -rounds; dx <= rounds; ++dx) {
      acc |= row[xx];
      if (++xx == wm) xx = 0;
    }
    s_wide[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileRows * wm; i += kDilateThreads) {
    const int j = i / wm;
    const int x = i - j * wm;
    if (y0 + j >= hm) break;
    int32_t acc = 0;
    for (int dy = 0; dy <= 2 * rounds; ++dy) acc |= s_wide[(j + dy) * wm + x];
    dst[(y0 + j) * wm + x] = acc;
  }
}

}  // namespace

extern "C" int occupancy_bits_launch(
    const float* depths, float* partials, int32_t* und, int32_t* out,
    float* binp, int n_frames, int hd, int wd, int cell, int rounds,
    float scale, float depth_max, cudaStream_t stream) {
  if (n_frames <= 0 || hd <= 0 || wd <= 0 || rounds < 0 ||
      rounds > kMaxRounds || (cell != 8 && cell != 16 && cell != 32) ||
      hd % cell != 0 || wd % cell != 0 || wd / cell > kMaxWidth) {
    return (int)cudaErrorInvalidValue;
  }
  const int hm = hd / cell;
  const int wm = wd / cell;
  const long long n = (long long)n_frames * hd * wd;
  const long long cells = (long long)n_frames * hm * wm;
  const int tiles = (hm + kTileRows - 1) / kTileRows;
  if (cells > INT_MAX / 2 || (long long)n_frames * tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_cells = (int)cells;
  // 16-byte loads where the depths start on a 16-byte boundary
  const long long n4 = ((uintptr_t)depths & 15u) == 0 ? n / 4 : 0;
  occupancy_range_kernel<<<kPartials, kRangeThreads, 0, stream>>>(
      depths, partials, n, n4, scale, depth_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int strips = (wd + kStrip - 1) / kStrip;
  const long long units = (long long)n_frames * hm * strips;
  if (units > INT_MAX - kCellWarps) return (int)cudaErrorInvalidValue;
  const int n_strips = (int)units;
  const int blocks = (n_strips + kCellWarps - 1) / kCellWarps;
  switch (cell) {
    case 8:
      occupancy_cells_kernel<8><<<blocks, kCellThreads, 0, stream>>>(
          depths, partials, und, binp, n_strips, strips, wd, wm, n_cells,
          scale, depth_max);
      break;
    case 16:
      occupancy_cells_kernel<16><<<blocks, kCellThreads, 0, stream>>>(
          depths, partials, und, binp, n_strips, strips, wd, wm, n_cells,
          scale, depth_max);
      break;
    default:
      occupancy_cells_kernel<32><<<blocks, kCellThreads, 0, stream>>>(
          depths, partials, und, binp, n_strips, strips, wd, wm, n_cells,
          scale, depth_max);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  occupancy_dilate_kernel<<<dim3(n_frames * tiles, 2), kDilateThreads, 0,
                            stream>>>(und, out, n_cells, hm, wm, rounds,
                                      tiles);
  return (int)cudaGetLastError();
}
