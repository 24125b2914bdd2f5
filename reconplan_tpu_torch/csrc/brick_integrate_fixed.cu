// K3: fold every frame of a dispatch into a padded list of brick ids — the
// fixed-grid form of the brick integration, used by the host-compacted path
// (integrate_frames_bricked) and by the brick-sharded path.
//
// Replaces the TPU kernel `_integrate_kernel`
// (reconplan_tpu/ops/tsdf_brick.py:503), dispatched by `_integrate_bricks`.
// Block i reads the local brick id ids[i]. Ids at or past n_real_local are
// padding (they all point at the shard's scratch row) and the block returns
// at once, so no two blocks ever write the same row. A real id is a row of
// this shard's planes; its voxel coordinates come from the global id
// bid_local + id_base. For each of the F frames: project the brick's 1024
// voxel centres (8z x 8y x 16x) through the w2c pose and fx, fy, cx, cy,
// round half-to-even to a pixel, sample depth / depth_scale, keep voxels in
// the image with z > 1e-4, 0 < d < depth_max and d - z > -trunc, and update
// the running-average sdf (weight + 1, clamped at max_weight). There are no
// per-frame bits and no color: every frame is folded into every real brick.
//
// What bounds it on the card, by its shapes: one brick-frame is 1024
// projections (three divides each, and the average's divide) and 1024
// data-dependent depth gathers. A chunk of 8 frames of 480 x 640 f32 depth
// (9.8 MB) fits the 50 MB L2, so the gathers hit L2; the brick rows (4 KB
// per plane) are read and written once. It is bound by gather latency and
// divides, not by HBM bandwidth.
//
// Design: M blocks of 256 threads, 4 voxels a thread; M is the padded id
// count, known on the host on both callers. Each block loads its brick's
// sdf / weight into registers once, loops over the frames, and writes once
// at the end. Depth is read straight from global memory, and every
// in-image voxel is sampled, exactly as the dense engine does: the TPU
// kernel's VMEM windows (which drop the outer voxels of footprints taller
// than the row ladder or wider than 256 lanes) are not carried over. The
// float operations follow the TPU kernel's order (|z| clamp, x / zs * fx +
// cx, the running average as one divide by max(w_new, 1)), and the library
// is built with -fmad=false, so results equal the plain PyTorch version's
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBrickVoxels = 1024;  // 8 x 8 x 16
constexpr int kThreads = 256;
constexpr int kPerThread = kBrickVoxels / kThreads;

__global__ void __launch_bounds__(kThreads) brick_integrate_fixed_kernel(
    float* __restrict__ sdf_b,        // (NB_local + 1, 8, 128)
    float* __restrict__ weight_b,     // (NB_local + 1, 8, 128)
    const int32_t* __restrict__ ids,  // (M,) local brick ids, padded
    int id_base, int n_real_local,
    const float* __restrict__ poses,  // (F, 16) row-major w2c
    const float* __restrict__ origin, // (3,)
    const float* __restrict__ depths, // (F, Hd, Wd) raw depth
    int n_frames, int hd, int wd, int bh, int bw,
    float voxel, float trunc, float fx, float fy, float cx, float cy,
    float depth_scale, float depth_max, float max_weight) {
  const int bid_local = ids[blockIdx.x];
  if (bid_local >= n_real_local) return;  // padding: the scratch row
  const int bid = bid_local + id_base;
  const int bz = bid / (bh * bw);
  const int by = (bid / bw) % bh;
  const int bx = bid % bw;
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const size_t row = (size_t)bid_local * kBrickVoxels;

  float wx[kPerThread], wy[kPerThread], wz[kPerThread];
  float sdf[kPerThread], w[kPerThread];
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
  }

  const size_t plane = (size_t)hd * wd;
  for (int f = 0; f < n_frames; ++f) {
    const float* p = poses + 16 * f;
    const float r00 = p[0], r01 = p[1], r02 = p[2], t0 = p[3];
    const float r10 = p[4], r11 = p[5], r12 = p[6], t1 = p[7];
    const float r20 = p[8], r21 = p[9], r22 = p[10], t2 = p[11];
    const float* dframe = depths + f * plane;
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
      float d = in_img ? dframe[(size_t)vi * wd + ui] : 0.0f;
      d = d / depth_scale;
      const float sdf_obs = d - z;
      const bool ok = in_img && d > 0.0f && d < depth_max && sdf_obs > -trunc;
      const float tsdf_obs = fminf(fmaxf(sdf_obs / trunc, -1.0f), 1.0f);
      const float w_obs = ok ? 1.0f : 0.0f;
      const float w_new = w[j] + w_obs;
      const float sdf_n =
          (sdf[j] * w[j] + tsdf_obs * w_obs) / fmaxf(w_new, 1.0f);
      sdf[j] = w_new > 0.0f ? sdf_n : 1.0f;
      w[j] = fminf(w_new, max_weight);
    }
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int v = threadIdx.x + j * kThreads;
    sdf_b[row + v] = sdf[j];
    weight_b[row + v] = w[j];
  }
}

}  // namespace

extern "C" int brick_integrate_fixed_launch(
    float* sdf_b, float* weight_b, const int32_t* ids, int n_ids,
    int id_base, int n_real_local, const float* poses, const float* origin,
    const float* depths, int n_frames, int hd, int wd, int bh, int bw,
    float voxel, float trunc, float fx, float fy, float cx, float cy,
    float depth_scale, float depth_max, float max_weight,
    cudaStream_t stream) {
  if (n_ids <= 0) return (int)cudaSuccess;
  brick_integrate_fixed_kernel<<<n_ids, kThreads, 0, stream>>>(
      sdf_b, weight_b, ids, id_base, n_real_local, poses, origin, depths,
      n_frames, hd, wd, bh, bw, voxel, trunc, fx, fy, cx, cy, depth_scale,
      depth_max, max_weight);
  return (int)cudaGetLastError();
}
