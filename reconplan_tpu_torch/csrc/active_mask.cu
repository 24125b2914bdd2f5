// K2: per-(brick, frame) conservative occupancy test of the brick TSDF path.
//
// Replaces the TPU kernel `_active_mask_kernel`
// (reconplan_tpu/ops/tsdf_brick.py:278), dispatched by
// `active_brick_bits_pallas`. For every brick and every frame f of a chunk
// it projects the brick centre into the frame's 64-bin depth-occupancy mip
// (two i32 planes, bins 0-31 and 32-63, built by `_build_depth_occupancy`)
// and sets bit f when an occupied bin overlaps [z - band, z + band],
// band = trunc + brick radius + 2 mm, with z > 1e-4.
//
// What bounds it on the card, by its shapes: at 512^3 it runs 131,072
// threads of ~40 flops and two 4-byte loads per (brick, frame) from mip
// planes of 8 x 60 x 80 i32 (150 KB each, resident in L2), and writes
// 0.5 MB. Neither bytes nor operations come near the card's rates: it is
// bound by launch and load latency.
//
// Design: one thread per brick, a loop over the F <= 32 frames, one direct
// global load of occ0 and of occ1 at [f, vci, uci]. The TPU kernel's
// Hm-row select loop was its substitute for a gather and is not carried
// over. The float operations follow the TPU kernel's order one for one;
// the library is built with -fmad=false so no multiply-add is contracted
// and the bits equal the plain PyTorch version's. Bit work is in uint32_t
// with the TPU kernel's clamps, so no shift reaches 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBrickY = 8;
constexpr int kBrickX = 16;
constexpr int kBrickZ = 8;

// Bits [0..n] inclusive; n < 0 -> 0, n >= 31 -> all ones (`_lowmask`).
__device__ __forceinline__ uint32_t lowmask(int n) {
  if (n < 0) return 0u;
  if (n >= 31) return 0xFFFFFFFFu;
  return (1u << (n + 1)) - 1u;
}

// Python's floor division for a positive divisor.
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void active_mask_kernel(
    const int32_t* __restrict__ occ0,  // (F, Hm, Wm) bins 0-31
    const int32_t* __restrict__ occ1,  // (F, Hm, Wm) bins 32-63
    const float* __restrict__ poses,   // (F, 16) row-major w2c
    const float* __restrict__ origin,  // (3,)
    const float* __restrict__ binp,    // (2,) bin origin b0, bin size bs
    int32_t* __restrict__ out,         // (NB,) frame bits
    int nb, int bh, int bw, int n_frames, int hm, int wm, int mip_cell,
    float voxel, float band, float fx, float fy, float cx, float cy) {
  const int bid = blockIdx.x * blockDim.x + threadIdx.x;
  if (bid >= nb) return;
  const int bz = bid / (bh * bw);
  const int by = (bid / bw) % bh;
  const int bx = bid % bw;
  const float ccx = origin[0] + ((float)bx * kBrickX + kBrickX / 2.0f) * voxel;
  const float ccy = origin[1] + ((float)by * kBrickY + kBrickY / 2.0f) * voxel;
  const float ccz = origin[2] + ((float)bz * kBrickZ + kBrickZ / 2.0f) * voxel;
  const float b0 = binp[0];
  const float inv_bs = 1.0f / binp[1];

  uint32_t active = 0u;
  for (int f = 0; f < n_frames; ++f) {
    const float* p = poses + 16 * f;
    const float x = p[0] * ccx + p[1] * ccy + p[2] * ccz + p[3];
    const float y = p[4] * ccx + p[5] * ccy + p[6] * ccz + p[7];
    const float z = p[8] * ccx + p[9] * ccy + p[10] * ccz + p[11];
    const float zs = fmaxf(z, 1e-6f);
    // (int) truncates toward zero before the floor division, as the TPU
    // kernel's astype(int32) does
    int uci = floordiv((int)(x / zs * fx + cx), mip_cell);
    int vci = floordiv((int)(y / zs * fy + cy), mip_cell);
    uci = min(max(uci, 0), wm - 1);
    vci = min(max(vci, 0), hm - 1);
    const int cell = (f * hm + vci) * wm + uci;
    const uint32_t g0 = (uint32_t)occ0[cell];
    const uint32_t g1 = (uint32_t)occ1[cell];
    // bins overlapping [z - band, z + band], floor-extended by one below
    const int b_lo = (int)floorf((z - band - b0) * inv_bs) - 1;
    const int b_hi = (int)floorf((z + band - b0) * inv_bs);
    const uint32_t m0 = lowmask(min(b_hi, 31)) & ~lowmask(min(b_lo, 32) - 1);
    const uint32_t m1 = lowmask(b_hi - 32) & ~lowmask(b_lo - 33);
    if (z > 1e-4f && ((g0 & m0) | (g1 & m1)) != 0u) active |= 1u << f;
  }
  out[bid] = (int32_t)active;
}

}  // namespace

extern "C" int active_mask_launch(
    const int32_t* occ0, const int32_t* occ1, const float* poses,
    const float* origin, const float* binp, int32_t* out,
    int nb, int bh, int bw, int n_frames, int hm, int wm, int mip_cell,
    float voxel, float band, float fx, float fy, float cx, float cy,
    cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (nb + threads - 1) / threads;
  active_mask_kernel<<<blocks, threads, 0, stream>>>(
      occ0, occ1, poses, origin, binp, out, nb, bh, bw, n_frames, hm, wm,
      mip_cell, voxel, band, fx, fy, cx, cy);
  return (int)cudaGetLastError();
}
