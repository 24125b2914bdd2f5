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
// What bounds it on the card, by its shapes: one brick-frame is 1024
// projections (three divides each) and 1024 data-dependent gathers. A
// chunk's frames (8 x 480 x 640 f32 depth, or 4 frames of depth + packed
// color: 9.8 MB either way) fit the 50 MB L2, so the gathers hit L2; the
// brick rows (4 KB per plane) are read and written once. So it is bound
// by gather latency and divides, not by HBM bandwidth.
//
// Design: the grid is max_active blocks of 256 threads, 4 voxels a thread.
// Block k reads the live count n from device memory and returns if k >= n,
// so the host never syncs on the count. Each block loads its brick's
// sdf / weight (and rgb) into registers once, loops over the frames with a
// branch on bit f that is uniform across the block, and writes once at
// the end. Depth and color are read straight from global memory, and every
// in-image voxel is sampled, exactly as the dense engine does. The TPU
// kernel's VMEM windows (which drop the outer voxels of footprints taller
// than 57 rows or wider than 256 lanes), its sampling-branch ladder, rolls
// and DMA ring are not carried over. The float operations follow the TPU
// kernel's order (zs clamp, x / zs * fx + cx, the reciprocal update), and
// the library is built with -fmad=false, so results equal the plain
// PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBrickVoxels = 1024;  // 8 x 8 x 16
constexpr int kThreads = 256;
constexpr int kPerThread = kBrickVoxels / kThreads;

__global__ void __launch_bounds__(kThreads) brick_integrate_kernel(
    float* __restrict__ sdf_b,          // (NB + 1, 8, 128)
    float* __restrict__ weight_b,       // (NB + 1, 8, 128)
    int32_t* __restrict__ rgb_b,        // (NB + 1, 8, 128) or null
    const int32_t* __restrict__ ids,    // (M,) compacted brick ids
    const int32_t* __restrict__ fbits,  // (M,) frame bits per brick
    const int32_t* __restrict__ n_live, // (1,) live count n <= M
    const float* __restrict__ poses,    // (F, 16) row-major w2c
    const float* __restrict__ origin,   // (3,)
    const float* __restrict__ depths,   // (F, Hd, Wd) raw depth
    const int32_t* __restrict__ colors, // (F, Hd, Wd) packed or null
    int n_frames, int hd, int wd, int bh, int bw,
    float voxel, float trunc, float fx, float fy, float cx, float cy,
    float depth_scale, float depth_max, float max_weight) {
  const int k = blockIdx.x;
  if (k >= *n_live) return;
  const int bid = ids[k];
  const int fb = fbits[k];
  const int bz = bid / (bh * bw);
  const int by = (bid / bw) % bh;
  const int bx = bid % bw;
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const bool with_color = rgb_b != nullptr;
  const size_t row = (size_t)bid * kBrickVoxels;

  float wx[kPerThread], wy[kPerThread], wz[kPerThread];
  float sdf[kPerThread], w[kPerThread];
  float cr[kPerThread], cg[kPerThread], cb[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int v = threadIdx.x + j * kThreads;  // sublane v / 128, lane v % 128
    const int lz = v >> 7;
    const int lane = v & 127;
    const int ly = lane >> 4;
    const int lx = lane & 15;
    wx[j] = ox + ((float)bx * 16.0f + (float)lx) * voxel;
    wy[j] = oy + ((float)by * 8.0f + (float)ly) * voxel;
    wz[j] = oz + ((float)bz * 8.0f + (float)lz) * voxel;
    sdf[j] = sdf_b[row + v];
    w[j] = weight_b[row + v];
    if (with_color) {
      const int p = rgb_b[row + v];
      cr[j] = (float)(p & 255);
      cg[j] = (float)((p >> 8) & 255);
      cb[j] = (float)((p >> 16) & 255);
    }
  }

  const size_t plane = (size_t)hd * wd;
  for (int f = 0; f < n_frames; ++f) {
    if (((fb >> f) & 1) == 0) continue;  // uniform across the block
    const float* p = poses + 16 * f;
    const float r00 = p[0], r01 = p[1], r02 = p[2], t0 = p[3];
    const float r10 = p[4], r11 = p[5], r12 = p[6], t1 = p[7];
    const float r20 = p[8], r21 = p[9], r22 = p[10], t2 = p[11];
    const float* dframe = depths + f * plane;
    const int32_t* cframe = with_color ? colors + f * plane : nullptr;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const float x = r00 * wx[j] + r01 * wy[j] + r02 * wz[j] + t0;
      const float y = r10 * wx[j] + r11 * wy[j] + r12 * wz[j] + t1;
      const float z = r20 * wx[j] + r21 * wy[j] + r22 * wz[j] + t2;
      const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
      const float u = x / zs * fx + cx;
      const float vv = y / zs * fy + cy;
      const int ui = __float2int_rn(u);  // half-to-even, as jnp.round
      const int vi = __float2int_rn(vv);
      const bool in_img =
          ui >= 0 && ui < wd && vi >= 0 && vi < hd && z > 1e-4f;
      float d = 0.0f;
      int cpk = 0;
      if (in_img) {
        const size_t pix = (size_t)vi * wd + ui;
        d = dframe[pix];
        if (with_color) cpk = cframe[pix];
      }
      d = d / depth_scale;
      const float sdf_obs = d - z;
      const bool ok = in_img && d > 0.0f && d < depth_max && sdf_obs > -trunc;
      const float tsdf_obs = fminf(fmaxf(sdf_obs / trunc, -1.0f), 1.0f);
      const float w_obs = ok ? 1.0f : 0.0f;
      const float w_new = w[j] + w_obs;
      const float inv = 1.0f / fmaxf(w_new, 1.0f);
      const float sdf_n = (sdf[j] * w[j] + tsdf_obs * w_obs) * inv;
      if (with_color) {
        cr[j] = (cr[j] * w[j] + (float)(cpk & 255) * w_obs) * inv;
        cg[j] = (cg[j] * w[j] + (float)((cpk >> 8) & 255) * w_obs) * inv;
        cb[j] = (cb[j] * w[j] + (float)((cpk >> 16) & 255) * w_obs) * inv;
      }
      sdf[j] = w_new > 0.0f ? sdf_n : 1.0f;
      w[j] = fminf(w_new, max_weight);
    }
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int v = threadIdx.x + j * kThreads;
    sdf_b[row + v] = sdf[j];
    weight_b[row + v] = w[j];
    if (with_color) {
      const int rq = (int)fminf(fmaxf(cr[j] + 0.5f, 0.0f), 255.0f);
      const int gq = (int)fminf(fmaxf(cg[j] + 0.5f, 0.0f), 255.0f);
      const int bq = (int)fminf(fmaxf(cb[j] + 0.5f, 0.0f), 255.0f);
      rgb_b[row + v] = rq | (gq << 8) | (bq << 16);
    }
  }
}

}  // namespace

extern "C" int brick_integrate_launch(
    float* sdf_b, float* weight_b, int32_t* rgb_b, const int32_t* ids,
    const int32_t* fbits, const int32_t* n_live, int max_active,
    const float* poses, const float* origin, const float* depths,
    const int32_t* colors, int n_frames, int hd, int wd, int bh, int bw,
    float voxel, float trunc, float fx, float fy, float cx, float cy,
    float depth_scale, float depth_max, float max_weight,
    cudaStream_t stream) {
  if (max_active <= 0) return (int)cudaSuccess;
  brick_integrate_kernel<<<max_active, kThreads, 0, stream>>>(
      sdf_b, weight_b, rgb_b, ids, fbits, n_live, poses, origin, depths,
      colors, n_frames, hd, wd, bh, bw, voxel, trunc, fx, fy, cx, cy,
      depth_scale, depth_max, max_weight);
  return (int)cudaGetLastError();
}
