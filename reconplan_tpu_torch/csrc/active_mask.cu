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
// What bounds it on the card. At 512^3, 8 frames, it makes 1.05 M
// (brick, frame) tests of 34 f32 operations and two 4-byte loads each from
// mip planes of 8 x 60 x 80 i32 (150 KB each, resident in L2), and writes
// 0.5 MB: a bound of 0.53 us, set by the operations (the bytes take 0.24
// us). Neither is near what it takes. Each test is a projection with two
// IEEE divides and a bin test: the 8-frame kernel is 1,480 SASS
// instructions with 26 MUFU and 16 FCHK, about 180 a frame with the
// divides' cold paths (chip_smoke.py phase 2 counts them). Per thread
// come the brick decode (divisions by run-time brick dims) and the pose
// loads, and per call the launch (chip_smoke.py times a tiny torch op in
// a CUDA graph beside it: about 1.5 us).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; device time per launch from a
// CUDA graph of 20 launches, in one run of chip_smoke.py): 8.37 us, from
// 11.3 us for the first design (one thread per brick, a run-time loop over
// the frames with two dependent L2 gathers and two integer divisions by
// the run-time cell each; 131,072 threads, less than half of the card's
// thread slots). One thread per (brick, frame) test, the brick's tests on
// neighbouring lanes and OR-ed by shuffles, took 12.96 us; 2 frames a
// thread 11.88 us; 4 frames 10.31 us (the same run). Fewer threads, each
// with the per-thread work spread over more tests and more loads in
// flight, won.
//
// Design: 8 frames a thread (kGroup). A thread computes its frames' cells
// and issues all their loads before it uses any. A brick's ceil(F / 8)
// groups, padded to a power of two, sit on neighbouring lanes of one warp
// and are OR-ed together by xor shuffles, and the first lane stores. The
// mip cell is a template parameter over {8, 16, 32}, the only cells
// `_occupancy_cell` picks, so the floor division is an arithmetic right
// shift of the truncated int (it floors negative pixel coordinates too, as
// Python's // does). Each pose row is one float4 load through the
// read-only cache, with no shared-memory stage and no barrier. The float
// operations follow the TPU kernel's order one for one; the library is
// built with -fmad=false so no multiply-add is contracted and the bits
// equal the plain PyTorch version's. Bit work is in uint32_t with the TPU
// kernel's clamps, so no shift reaches 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBrickY = 8;
constexpr int kBrickX = 16;
constexpr int kBrickZ = 8;
constexpr int kThreads = 256;
constexpr int kMaxFrames = 32;
constexpr int kGroup = 8;  // frames a thread

// Bits [0..n] inclusive; n < 0 -> 0, n >= 31 -> all ones (`_lowmask`).
__device__ __forceinline__ uint32_t lowmask(int n) {
  if (n < 0) return 0u;
  if (n >= 31) return 0xFFFFFFFFu;
  return (1u << (n + 1)) - 1u;
}

// kShift = log2(mip_cell). A brick's ceil(F / kGroup) frame groups, padded
// to a power of two 1 << log2_lanes, sit on neighbouring lanes of one warp.
template <int kShift>
__global__ void __launch_bounds__(kThreads) active_mask_kernel(
    const int32_t* __restrict__ occ0,  // (F, Hm, Wm) bins 0-31
    const int32_t* __restrict__ occ1,  // (F, Hm, Wm) bins 32-63
    const float* __restrict__ poses,   // (F, 16) row-major w2c, 16-B aligned
    const float* __restrict__ origin,  // (3,)
    const float* __restrict__ binp,    // (2,) bin origin b0, bin size bs
    int32_t* __restrict__ out,         // (NB,) frame bits
    int nb, int bh, int bw, int n_frames, int log2_lanes, int hm, int wm,
    float voxel, float band, float fx, float fy, float cx, float cy) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int bid = t >> log2_lanes;
  const int f0 = (t & ((1 << log2_lanes) - 1)) * kGroup;
  uint32_t active = 0u;
  if (bid < nb) {
    const int bz = bid / (bh * bw);
    const int by = (bid / bw) % bh;
    const int bx = bid % bw;
    const float ccx = origin[0] + ((float)bx * kBrickX + kBrickX / 2.0f) * voxel;
    const float ccy = origin[1] + ((float)by * kBrickY + kBrickY / 2.0f) * voxel;
    const float ccz = origin[2] + ((float)bz * kBrickZ + kBrickZ / 2.0f) * voxel;
    // every cell load of the group is issued before any is used
    float zz[kGroup];
    uint32_t g0[kGroup], g1[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int f = f0 + i;
      zz[i] = 0.0f;
      g0[i] = g1[i] = 0u;
      if (f < n_frames) {
        const float4* p4 = reinterpret_cast<const float4*>(poses) + 4 * f;
        const float4 a = __ldg(p4), b = __ldg(p4 + 1), c = __ldg(p4 + 2);
        const float x = a.x * ccx + a.y * ccy + a.z * ccz + a.w;
        const float y = b.x * ccx + b.y * ccy + b.z * ccz + b.w;
        const float z = c.x * ccx + c.y * ccy + c.z * ccz + c.w;
        const float zs = fmaxf(z, 1e-6f);
        // (int) truncates toward zero, as the TPU kernel's astype(int32);
        // the arithmetic shift then floors, as its // by the cell does
        int uci = (int)(x / zs * fx + cx) >> kShift;
        int vci = (int)(y / zs * fy + cy) >> kShift;
        uci = min(max(uci, 0), wm - 1);
        vci = min(max(vci, 0), hm - 1);
        const int cell = (f * hm + vci) * wm + uci;
        zz[i] = z;
        g0[i] = (uint32_t)occ0[cell];
        g1[i] = (uint32_t)occ1[cell];
      }
    }
    const float b0 = binp[0];
    const float inv_bs = 1.0f / binp[1];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float z = zz[i];
      // bins overlapping [z - band, z + band], floor-extended by one below
      const int b_lo = (int)floorf((z - band - b0) * inv_bs) - 1;
      const int b_hi = (int)floorf((z + band - b0) * inv_bs);
      const uint32_t m0 =
          lowmask(min(b_hi, 31)) & ~lowmask(min(b_lo, 32) - 1);
      const uint32_t m1 = lowmask(b_hi - 32) & ~lowmask(b_lo - 33);
      if (f0 + i < n_frames && z > 1e-4f &&
          ((g0[i] & m0) | (g1[i] & m1)) != 0u) {
        active |= 1u << (f0 + i);
      }
    }
  }
  // OR the brick's lanes together; every lane of the warp takes part
  for (int o = 1; o < (1 << log2_lanes); o <<= 1) {
    active |= __shfl_xor_sync(0xFFFFFFFFu, active, o);
  }
  if (bid < nb && f0 == 0) out[bid] = (int32_t)active;
}

template <int kShift>
cudaError_t launch(const int32_t* occ0, const int32_t* occ1,
                   const float* poses, const float* origin,
                   const float* binp, int32_t* out, int nb, int bh, int bw,
                   int n_frames, int hm, int wm, float voxel, float band,
                   float fx, float fy, float cx, float cy,
                   cudaStream_t stream) {
  int log2_lanes = 0;
  while ((kGroup << log2_lanes) < n_frames) ++log2_lanes;
  const long long threads = (long long)nb << log2_lanes;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  active_mask_kernel<kShift><<<blocks, kThreads, 0, stream>>>(
      occ0, occ1, poses, origin, binp, out, nb, bh, bw, n_frames,
      log2_lanes, hm, wm, voxel, band, fx, fy, cx, cy);
  return cudaGetLastError();
}

}  // namespace

extern "C" int active_mask_launch(
    const int32_t* occ0, const int32_t* occ1, const float* poses,
    const float* origin, const float* binp, int32_t* out,
    int nb, int bh, int bw, int n_frames, int hm, int wm, int mip_cell,
    float voxel, float band, float fx, float fy, float cx, float cy,
    cudaStream_t stream) {
  if (n_frames < 0 || n_frames > kMaxFrames) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return (int)cudaSuccess;
#define MASK_ARGS                                                         \
  occ0, occ1, poses, origin, binp, out, nb, bh, bw, n_frames, hm, wm,     \
      voxel, band, fx, fy, cx, cy, stream
  switch (mip_cell) {
    case 8: return (int)launch<3>(MASK_ARGS);
    case 16: return (int)launch<4>(MASK_ARGS);
    case 32: return (int)launch<5>(MASK_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MASK_ARGS
}
