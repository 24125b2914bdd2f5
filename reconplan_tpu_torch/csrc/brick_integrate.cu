// K1: fold a chunk of depth (+ packed color) frames into the live bricks of
// the brick TSDF.
//
// Replaces the TPU kernel `_integrate_kernel_dyn`
// (reconplan_tpu/ops/tsdf_brick.py:682), dispatched by
// `_integrate_bricks_dyn`. For each of the n live compacted brick ids, and
// each frame f whose bit is set in fbits[k]: project the brick's 1024 voxel
// centres (8z x 8y x 16x) through the w2c pose and fx, fy, cx, cy, round
// half-to-even to a pixel, sample depth / depth_scale, keep voxels in the
// image with z > 1e-4, 0 < d < depth_max and d - z > -trunc, and update
// the running-average sdf (weight + 1, clamped at max_weight); with color,
// average packed-u8 RGB with the same weights, then round +0.5, clip and
// repack. The sdf / weight / rgb planes are updated in place.
//
// What bounds it on the card. At the bench chunk (512^3, 8 frames, 1,953
// live bricks, 9,882 brick-frames, 10.1 M voxel-frames) it reads and
// writes 32 MB of brick rows and samples 3.4 MB of depth: 10.6 us at
// 3.35 TB/s, against 4.4 us of f32 operations, so its bound is the bytes.
// It takes several times that. The likeliest limit, not yet measured, is
// its instructions: the depth kernel is about 1,080 SASS instructions with
// 29 MUFU and 16 FCHK (chip_smoke.py phase 2 counts them from
// cuobjdump -sass), about 110 a voxel-frame in its frame loop. Five a
// voxel-frame are IEEE divides (x / zs, y / zs, d / depth_scale,
// sdf_obs / trunc, 1 / max(w, 1)), each a MUFU.RCP, five FFMAs, an FCHK
// and a branch region, and -fmad=false keeps every multiply and add
// apart. The divides and their order make the result equal the plain
// version and the JAX package bit for bit, so they stay.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; device time per launch from a
// CUDA graph of 20 launches, in one run of chip_smoke.py): 60.3 us, against
// 67.4-68.3 us for the first design (`brick_ablate` arm `full`) in turns in
// the same call; 39.1-39.4 us with color (4 frames, 1,536 bricks). The
// first design launched len(ids) blocks of 256 threads, one brick a block:
// about 6,200 of its 8,192 blocks found k >= n and exited, and the ~1,950
// live ones ran in 3.7 waves of 528.
//
// Design. The grid is persistent: blocks-per-SM x SMs from the occupancy
// query (at most len(ids)). A work counter in device memory hands each
// block its next live brick (bricks carry 0-8 set frames, so a static
// stride leaves blocks idle); the last block to finish resets the counter,
// so it is zero again on the stream with no host write. There is one
// counter a slot, and the wrapper gives each stream its own slot, so
// launches on different streams never share one. The live count is read
// on the device and bounded by len(ids). The pose rows and the grid origin
// are staged in shared memory once per block. A thread's 4 voxels share
// their x and y within the brick (v = tid + j * 256), so their world x and
// y are one value each. The frame loop walks the set bits only. Three
// divides are skipped where their result is known exactly (see fold).
// Color is a template parameter, so depth-only runs no color code. The
// float operations that run are the first design's, in its order, and the
// library is built with -fmad=false, so results equal the plain PyTorch
// version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBrickVoxels = 1024;  // 8 x 8 x 16
constexpr int kVoxels = 4;          // voxels a thread
constexpr int kThreads = kBrickVoxels / kVoxels;
constexpr int kMaxFrames = 32;
constexpr int kPoseFloats = 12;  // the three rows of the w2c pose
// work-counter slots, WORK_SLOTS in ops/kernels/brick_integrate.py
constexpr int kWorkSlots = 1024;
// blocks of kThreads an SM the launch bounds ask for (color: its registers)
constexpr int kDepthBlocks = 4;
constexpr int kColorBlocks = 3;

// (next brick, blocks done) of each slot; zero between launches
__device__ int g_work[kWorkSlots][2];

struct Params {
  float* sdf_b;           // (NB + 1, 8, 128)
  float* weight_b;        // (NB + 1, 8, 128)
  int32_t* rgb_b;         // (NB + 1, 8, 128) or null
  const int32_t* ids;     // (M,) compacted brick ids
  const int32_t* fbits;   // (M,) frame bits per brick
  const int32_t* n_live;  // (1,) live count; bricks past M are not read
  int m, slot;
  const float* poses;     // (F, 16) row-major w2c
  const float* origin;    // (3,)
  const float* depths;    // (F, Hd, Wd) raw depth
  const int32_t* colors;  // (F, Hd, Wd) packed or null
  int n_frames, hd, wd, bh, bw;
  float voxel, trunc, fx, fy, cx, cy, depth_scale, depth_max, max_weight;
};

// Fold frame f (its pose in shared memory) into a thread's voxels: project
// them, round to a pixel and sample depth (and packed color), then update
// the running averages. Three divides are skipped where their result is
// known exactly: a raw depth of +-0 divided by depth_scale > 0 is itself;
// tsdf_obs * w_obs for w_obs = 0 is a zero with the sign of sdf_obs
// (trunc > 0 and the clip keep that sign), or -0 when sdf_obs is NaN (the
// clip makes it -1); and 1 / max(w_new, 1) is 1 unless w_new > 1.
template <bool kColor>
__device__ __forceinline__ void fold(const Params& P, const float* pose,
                                     int f, float wx, float wy,
                                     const float (&wz)[kVoxels],
                                     float (&sdf)[kVoxels],
                                     float (&w)[kVoxels],
                                     float (&cr)[kVoxels],
                                     float (&cg)[kVoxels],
                                     float (&cb)[kVoxels]) {
  const float r00 = pose[0], r01 = pose[1], r02 = pose[2], t0 = pose[3];
  const float r10 = pose[4], r11 = pose[5], r12 = pose[6], t1 = pose[7];
  const float r20 = pose[8], r21 = pose[9], r22 = pose[10], t2 = pose[11];
  const size_t plane = (size_t)P.hd * P.wd;
  const float* dframe = P.depths + f * plane;
  const int32_t* cframe = kColor ? P.colors + f * plane : nullptr;
  // every voxel's samples are loaded before any is folded
  float zv[kVoxels], dv[kVoxels];
  int32_t cv[kVoxels];
  bool in[kVoxels];
#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const float x = r00 * wx + r01 * wy + r02 * wz[j] + t0;
    const float y = r10 * wx + r11 * wy + r12 * wz[j] + t1;
    const float z = r20 * wx + r21 * wy + r22 * wz[j] + t2;
    const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
    const float u = x / zs * P.fx + P.cx;
    const float vv = y / zs * P.fy + P.cy;
    const int ui = __float2int_rn(u);  // half-to-even, as jnp.round
    const int vi = __float2int_rn(vv);
    in[j] = ui >= 0 && ui < P.wd && vi >= 0 && vi < P.hd && z > 1e-4f;
    zv[j] = z;
    dv[j] = 0.0f;
    cv[j] = 0;
    if (in[j]) {
      const size_t pix = (size_t)vi * P.wd + ui;
      dv[j] = dframe[pix];
      if (kColor) cv[j] = cframe[pix];
    }
  }
#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const float z = zv[j];
    const int32_t cpk = cv[j];
    float d = dv[j];
    if (d != 0.0f) d = d / P.depth_scale;
    const float sdf_obs = d - z;
    const bool ok =
        in[j] && d > 0.0f && d < P.depth_max && sdf_obs > -P.trunc;
    const float w_obs = ok ? 1.0f : 0.0f;
    float obs;  // tsdf_obs * w_obs
    if (ok) {
      obs = fminf(fmaxf(sdf_obs / P.trunc, -1.0f), 1.0f) * w_obs;
    } else {
      obs = sdf_obs != sdf_obs ? -0.0f : copysignf(0.0f, sdf_obs);
    }
    const float w_new = w[j] + w_obs;
    float inv = 1.0f;  // 1 / max(w_new, 1) is 1 unless w_new > 1
    if (w_new > 1.0f) inv = 1.0f / fmaxf(w_new, 1.0f);
    const float sdf_n = (sdf[j] * w[j] + obs) * inv;
    if (kColor) {
      cr[j] = (cr[j] * w[j] + (float)(cpk & 255) * w_obs) * inv;
      cg[j] = (cg[j] * w[j] + (float)((cpk >> 8) & 255) * w_obs) * inv;
      cb[j] = (cb[j] * w[j] + (float)((cpk >> 16) & 255) * w_obs) * inv;
    }
    sdf[j] = w_new > 0.0f ? sdf_n : 1.0f;
    w[j] = fminf(w_new, P.max_weight);
  }
}

template <bool kColor, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    brick_integrate_kernel(const Params P) {
  __shared__ float s_pose[kMaxFrames * kPoseFloats];
  __shared__ float s_origin[3];
  __shared__ int s_k[2];
  const int tid = threadIdx.x;
  for (int i = tid; i < P.n_frames * kPoseFloats; i += kThreads) {
    s_pose[i] = P.poses[(i / kPoseFloats) * 16 + i % kPoseFloats];
  }
  if (tid < 3) s_origin[tid] = P.origin[tid];
  int* work = g_work[P.slot];
  const int n = min(*P.n_live, P.m);
  const uint32_t fmask =
      P.n_frames >= 32 ? 0xFFFFFFFFu : (1u << P.n_frames) - 1u;
  // a thread's voxels v = tid + j * kThreads share lane v % 128, so x and y
  const int lane = tid & 127;
  const int lx = lane & 15;
  const int ly = lane >> 4;

  if (tid == 0) s_k[0] = atomicAdd(work, 1);
  __syncthreads();  // the pose, origin and first brick index
  int k = s_k[0];
  for (int it = 0; k < n; ++it) {
    if (tid == 0) s_k[(it + 1) & 1] = atomicAdd(work, 1);
    __syncthreads();  // also: every thread has read the other slot
    const int kn = s_k[(it + 1) & 1];

    const int bid = P.ids[k];
    const uint32_t fb = (uint32_t)P.fbits[k] & fmask;
    const int bz = bid / (P.bh * P.bw);
    const int by = (bid / P.bw) % P.bh;
    const int bx = bid % P.bw;
    const size_t row = (size_t)bid * kBrickVoxels;
    const float wx = s_origin[0] + ((float)bx * 16.0f + (float)lx) * P.voxel;
    const float wy = s_origin[1] + ((float)by * 8.0f + (float)ly) * P.voxel;
    float wz[kVoxels], sdf[kVoxels], w[kVoxels];
    float cr[kVoxels], cg[kVoxels], cb[kVoxels];
#pragma unroll
    for (int j = 0; j < kVoxels; ++j) {
      const int v = tid + j * kThreads;  // sublane v / 128, lane v % 128
      wz[j] = s_origin[2] + ((float)bz * 8.0f + (float)(v >> 7)) * P.voxel;
      sdf[j] = P.sdf_b[row + v];
      w[j] = P.weight_b[row + v];
      const int32_t p = kColor ? P.rgb_b[row + v] : 0;
      cr[j] = (float)(p & 255);
      cg[j] = (float)((p >> 8) & 255);
      cb[j] = (float)((p >> 16) & 255);
    }

    for (uint32_t m = fb; m != 0u; m &= m - 1u) {  // uniform in the block
      const int f = __ffs(m) - 1;
      fold<kColor>(P, s_pose + kPoseFloats * f, f, wx, wy, wz, sdf, w, cr,
                   cg, cb);
    }

#pragma unroll
    for (int j = 0; j < kVoxels; ++j) {
      const int v = tid + j * kThreads;
      P.sdf_b[row + v] = sdf[j];
      P.weight_b[row + v] = w[j];
      if (kColor) {
        const int rq = (int)fminf(fmaxf(cr[j] + 0.5f, 0.0f), 255.0f);
        const int gq = (int)fminf(fmaxf(cg[j] + 0.5f, 0.0f), 255.0f);
        const int bq = (int)fminf(fmaxf(cb[j] + 0.5f, 0.0f), 255.0f);
        P.rgb_b[row + v] = rq | (gq << 8) | (bq << 16);
      }
    }
    k = kn;
  }

  // the last block out puts the counter back to zero for the next launch
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(work + 1, 1) == (int)gridDim.x - 1) {
      atomicExch(work, 0);
      atomicExch(work + 1, 0);
    }
  }
}

}  // namespace

extern "C" int brick_integrate_occupancy(int with_color, int* blocks_per_sm,
                                         int* threads) {
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm,
      with_color ? brick_integrate_kernel<true, kColorBlocks>
                 : brick_integrate_kernel<false, kDepthBlocks>,
      kThreads, 0);
}

extern "C" int brick_integrate_launch(
    float* sdf_b, float* weight_b, int32_t* rgb_b, const int32_t* ids,
    const int32_t* fbits, const int32_t* n_live, int m, int slot, int grid,
    const float* poses, const float* origin, const float* depths,
    const int32_t* colors, int n_frames, int hd, int wd, int bh, int bw,
    float voxel, float trunc, float fx, float fy, float cx, float cy,
    float depth_scale, float depth_max, float max_weight,
    cudaStream_t stream) {
  if (grid <= 0 || m <= 0) return (int)cudaSuccess;
  if (n_frames > kMaxFrames || slot < 0 || slot >= kWorkSlots) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{sdf_b,  weight_b, rgb_b,       ids,       fbits,
                 n_live, m,        slot,        poses,     origin,
                 depths, colors,   n_frames,    hd,        wd,
                 bh,     bw,       voxel,       trunc,     fx,
                 fy,     cx,       cy,          depth_scale, depth_max,
                 max_weight};
  if (rgb_b != nullptr) {
    brick_integrate_kernel<true, kColorBlocks>
        <<<grid, kThreads, 0, stream>>>(p);
  } else {
    brick_integrate_kernel<false, kDepthBlocks>
        <<<grid, kThreads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}
