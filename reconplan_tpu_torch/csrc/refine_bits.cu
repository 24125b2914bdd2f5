// The refine of the brick mask pipeline: the exact centre-sample test of
// K2's candidate bricks, dilated one brick with wrap-around and ANDed with
// K2's bits, in three launches.
//
// Replaces no TPU kernel: the JAX refine is plain XLA,
// `_exact_frame_bits_dilated` (reconplan_tpu/ops/tsdf_brick.py:431), and
// its PyTorch port (`ops/tsdf_brick._exact_frame_bits_dilated`) stays the
// plain version for CPU tensors. Run eagerly on the card that chain is a
// stable argsort over every brick, about 60 scalar-tensor operations a
// frame, a cumsum, a scatter and six rolls: 538 launches a chunk of 8
// frames, each costing the host about 13 us while the card idles, where
// the card's own work is a few microseconds.
//
// Semantics, per brick b of NB (bits = K2's frame bits, cap <= NB):
//   rank(b)  = the number of bricks before b with bits != 0
//   dense[b] = 0                        where bits[b] == 0
//            = bits[b]                  where rank(b) >= cap (not examined)
//            = the exact test's bits    where rank(b) < cap
//   out[b]   = bits[b] & OR of dense over the 3x3x3 wrap-around
//              neighbourhood of b (the three separable rolls of `_dilate`)
// The exact test of frame f projects the brick centre, rounds to the
// nearest pixel (half to even, `torch.round`), and sets bit f when the
// centre is in the image, z > 1e-4, the depth is valid and
// |depth - z| < band. Every float operation follows the plain version's
// order one for one; the library is built with -fmad=false, so no
// multiply-add is contracted and the bits equal the plain version's.
//
// What bounds it. At 512^3 (NB = 131,072) it must read K2's bits and write
// the result, 1 MB, and gather at most cap x F = 32,768 depth pixels of 4
// bytes: about 0.35 us at 3.35 TB/s; the tests' f32 operations (38 a
// brick-frame) take 0.019 us at 67 TFLOP/s. Against that bound stand the
// three launches' fixed costs (about 1.5 us each on the card) and the
// dependent chain of a tested brick: its F pose rows, two IEEE divides and
// one gather a frame.
//
// Design. No sort and no scatter: every brick writes only its own entry.
// (1) `refine_count_kernel`, one thread a brick, tiles of 1024: each tile
// writes its number of candidates (`__syncthreads_count`). (2)
// `refine_test_kernel`, the same tiles: a tile sums the counts of the
// tiles before it; a tile whose prefix is already >= cap copies its bits
// and ends; else a warp ballot and the warps' popcounts give each brick its
// rank, and the bricks with rank < cap run the exact test, 8 frames at a
// time with every gather of the 8 issued before any is used. (3)
// `refine_dilate_kernel`, one thread a brick: a brick with bits == 0
// writes 0 and reads nothing; others OR their 27 neighbours' dense words
// (from L2) and AND their own bits. The counts and dense words are scratch
// the caller allocates uninitialised; nothing needs zeroing, so the stage
// is exactly the three kernel launches.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBrickY = 8;
constexpr int kBrickX = 16;
constexpr int kBrickZ = 8;
constexpr int kTile = 1024;  // bricks a block of the count and test kernels
constexpr int kWarps = kTile / 32;
constexpr int kDilateThreads = 256;
// bit 31 is the sign of the i32 word: the plain version's max-scatter
// would drop it, and the JAX function cannot form it
constexpr int kMaxFrames = 31;
constexpr int kGroup = 8;  // frames whose gathers are issued together
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kTile) refine_count_kernel(
    const int32_t* __restrict__ bits, int32_t* __restrict__ counts, int nb) {
  const int b = blockIdx.x * kTile + threadIdx.x;
  const int n = __syncthreads_count(b < nb && bits[b] != 0);
  if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

__global__ void __launch_bounds__(kTile) refine_test_kernel(
    const int32_t* __restrict__ bits,    // (NB,) K2's frame bits
    const int32_t* __restrict__ counts,  // (tiles,) candidates a tile
    const float* __restrict__ depths,    // (F, Hd, Wd) raw depth
    const float* __restrict__ poses,     // (F, 16) row-major w2c
    const float* __restrict__ origin,    // (3,)
    int32_t* __restrict__ dense,         // (NB,) out: the undilated bits
    int nb, int bh, int bw, int n_frames, int hd, int wd, int cap,
    float voxel, float band, float fx, float fy, float cx, float cy,
    float scale, float depth_max) {
  __shared__ int s_prefix;
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_prefix = 0;
  __syncthreads();
  // candidates in the tiles before this one
  int part = 0;
  for (int i = tid; i < (int)blockIdx.x; i += kTile) part += counts[i];
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
  if (lane == 0 && part != 0) atomicAdd(&s_prefix, part);
  __syncthreads();
  const int prefix = s_prefix;
  const int b = blockIdx.x * kTile + tid;
  const int32_t own = b < nb ? bits[b] : 0;
  if (prefix >= cap) {  // the same for the whole block: no test here
    if (b < nb) dense[b] = own;
    return;
  }
  const unsigned ballot = __ballot_sync(kFull, own != 0);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int rank = prefix + __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += s_warp[w];
  if (b >= nb) return;
  if (own == 0 || rank >= cap) {
    dense[b] = own;
    return;
  }
  const int bz = b / (bh * bw);
  const int by = (b / bw) % bh;
  const int bx = b % bw;
  const float ccx = origin[0] + ((float)bx * kBrickX + kBrickX / 2.0f) * voxel;
  const float ccy = origin[1] + ((float)by * kBrickY + kBrickY / 2.0f) * voxel;
  const float ccz = origin[2] + ((float)bz * kBrickZ + kBrickZ / 2.0f) * voxel;
  uint32_t hit = 0u;
  for (int f0 = 0; f0 < n_frames; f0 += kGroup) {
    float zz[kGroup], dd[kGroup];
    bool in[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int f = f0 + i;
      zz[i] = 0.0f;
      dd[i] = 0.0f;
      in[i] = false;
      if (f < n_frames) {
        const float* p = poses + 16 * f;
        const float x = __ldg(p) * ccx + __ldg(p + 1) * ccy +
                        __ldg(p + 2) * ccz + __ldg(p + 3);
        const float y = __ldg(p + 4) * ccx + __ldg(p + 5) * ccy +
                        __ldg(p + 6) * ccz + __ldg(p + 7);
        const float z = __ldg(p + 8) * ccx + __ldg(p + 9) * ccy +
                        __ldg(p + 10) * ccz + __ldg(p + 11);
        // torch.clamp(z, min=1e-6): a NaN stays NaN
        const float zs = z < 1e-6f ? 1e-6f : z;
        const float uf = x / zs * fx + cx;
        const float vf = y / zs * fy + cy;
        in[i] = z > 1e-4f && uf >= 0.0f && uf < (float)wd && vf >= 0.0f &&
                vf < (float)hd;
        if (in[i]) {
          // rintf rounds half to even, as torch.round
          const int ui = min(max((int)rintf(uf), 0), wd - 1);
          const int vi = min(max((int)rintf(vf), 0), hd - 1);
          dd[i] = __ldg(depths + ((long long)f * hd + vi) * wd + ui);
        }
        zz[i] = z;
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float d = dd[i] / scale;
      if (in[i] && d > 0.0f && d < depth_max && fabsf(d - zz[i]) < band) {
        hit |= 1u << (f0 + i);
      }
    }
  }
  dense[b] = (int32_t)hit;
}

__global__ void __launch_bounds__(kDilateThreads) refine_dilate_kernel(
    const int32_t* __restrict__ bits, const int32_t* __restrict__ dense,
    int32_t* __restrict__ out, int nb, int bd, int bh, int bw) {
  const int b = blockIdx.x * kDilateThreads + threadIdx.x;
  if (b >= nb) return;
  const int32_t own = bits[b];
  if (own == 0) {
    out[b] = 0;
    return;
  }
  const int bz = b / (bh * bw);
  const int by = (b / bw) % bh;
  const int bx = b % bw;
  int32_t acc = 0;
  for (int dz = -1; dz <= 1; ++dz) {
    const int z = (bz + dz + bd) % bd;
    for (int dy = -1; dy <= 1; ++dy) {
      const int row = (z * bh + (by + dy + bh) % bh) * bw;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        acc |= dense[row + (bx + dx + bw) % bw];
      }
    }
  }
  out[b] = own & acc;
}

}  // namespace

extern "C" int refine_bits_launch(
    const int32_t* bits, const float* depths, const float* poses,
    const float* origin, int32_t* counts, int32_t* dense, int32_t* out,
    int bd, int bh, int bw, int n_frames, int hd, int wd, int cap,
    float voxel, float band, float fx, float fy, float cx, float cy,
    float scale, float depth_max, cudaStream_t stream) {
  if (n_frames < 0 || n_frames > kMaxFrames) return (int)cudaErrorInvalidValue;
  const long long nbl = (long long)bd * bh * bw;
  if (bd <= 0 || bh <= 0 || bw <= 0 || nbl > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = (int)nbl;
  const int tiles = (nb + kTile - 1) / kTile;
  refine_count_kernel<<<tiles, kTile, 0, stream>>>(bits, counts, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  refine_test_kernel<<<tiles, kTile, 0, stream>>>(
      bits, counts, depths, poses, origin, dense, nb, bh, bw, n_frames, hd,
      wd, cap, voxel, band, fx, fy, cx, cy, scale, depth_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  refine_dilate_kernel<<<(nb + kDilateThreads - 1) / kDilateThreads,
                         kDilateThreads, 0, stream>>>(bits, dense, out, nb,
                                                      bd, bh, bw);
  return (int)cudaGetLastError();
}
