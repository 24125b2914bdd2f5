// K3: fold every frame of a dispatch into a padded list of brick ids — the
// fixed-grid form of the brick integration, used by the host-compacted path
// (integrate_frames_bricked) and by the brick-sharded path.
//
// Replaces the TPU kernel `_integrate_kernel`
// (reconplan_tpu/ops/tsdf_brick.py:503), dispatched by `_integrate_bricks`.
// `ids` holds M local brick ids. An id below n_real_local is a row of this
// shard's planes; an id at or past it is padding (the callers pad with the
// shard's scratch row, n_real_local) and is neither read nor written,
// wherever it stands in the list (nor is a negative id). A real id's voxel
// coordinates come from the global id bid_local + id_base. For each of the
// F frames: project the brick's 1024
// voxel centres (8z x 8y x 16x) through the w2c pose and fx, fy, cx, cy,
// round half-to-even to a pixel, sample depth / depth_scale, keep voxels in
// the image with z > 1e-4, 0 < d < depth_max and d - z > -trunc, and update
// the running-average sdf (weight + 1, clamped at max_weight). There are no
// per-frame bits and no color: every frame is folded into every real brick.
//
// What bounds it on the card. At the bench chunk (512^3, 8 frames, 1,494
// real bricks padded to 1,536) it reads and writes 24 MB of brick rows and
// samples 3 MB of depth: 8.3 us at 3.35 TB/s, against 7.7 us of f32
// operations, so its bound is the bytes. It takes several times that, as K1
// does (csrc/brick_integrate.cu): each voxel-frame runs about 110
// instructions, among them the IEEE divides x / zs, y / zs,
// d / depth_scale, sdf_obs / trunc and the average's divide by
// max(w_new, 1), and -fmad=false keeps every multiply and add apart. The
// divides and their order make the result equal the plain version and the
// JAX package bit for bit, so they stay where their result is not known.
//
// Design: one block of 256 threads a position of `ids`, 4 voxels a thread;
// M is known on the host on both callers. A block whose id is padding
// returns before it does anything else. K1's persistent grid and device
// work counter were built for K3 and measured against this grid in the
// same call (NVIDIA H100 80GB HBM3, 700 W, CUDA graphs of 20 launches):
// with the same fold they took 62.9-63.5 us against 57.0-57.4 us at the
// bench chunk, 67 us against 57 us with the ids padded to 8,192, and
// 97 us against 45 us for a shard with 56 real ids among 8,192. K3's
// bricks all fold every frame, so they cost about the same and the
// hardware's block scheduler levels them; each claim from a counter costs
// a round trip to L2 and a barrier, and a tail of padding costs a
// persistent block a claim an id where an idle block costs almost nothing.
//
// What the redesign keeps of K1's: the pose rows and the grid origin are
// staged in shared memory once a block, behind the loads of the brick's
// rows. A thread's 4 voxels share their x and y within the brick
// (v = tid + j * 256), so their world x and y are one value each. Every
// voxel's depth sample is loaded before any is folded. Three divides are
// skipped where their result is known exactly (see fold): they took the
// kernel from 83.3-84.0 us to 57.0-57.4 us, because K3 folds every frame
// into every brick and many voxel-frames observe nothing. A frame that
// observes none of a brick's voxels is still folded: (sdf * w + +-0) / w
// need not equal sdf, and the plain version and the TPU kernel round the
// same way. The float operations that run are the first design's, in its
// order, and the library is built with -fmad=false, so results equal the
// plain PyTorch version's bit for bit.
//
// A launch takes at most kMaxFrames frames (their poses' shared memory);
// the wrapper splits longer dispatches into launches in frame order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBrickVoxels = 1024;  // 8 x 8 x 16
constexpr int kVoxels = 4;          // voxels a thread
constexpr int kThreads = kBrickVoxels / kVoxels;
// frames a launch, MAX_FRAMES in ops/kernels/brick_integrate_fixed.py
constexpr int kMaxFrames = 32;
constexpr int kPoseFloats = 12;  // the three rows of the w2c pose
// blocks of kThreads an SM the launch bounds ask for
constexpr int kMinBlocks = 4;

struct Params {
  float* sdf_b;        // (NB_local + 1, 8, 128)
  float* weight_b;     // (NB_local + 1, 8, 128)
  const int32_t* ids;  // (M,) local brick ids, padding anywhere
  int id_base, n_real;
  const float* poses;   // (F, 16) row-major w2c
  const float* origin;  // (3,)
  const float* depths;  // (F, Hd, Wd) raw depth
  int n_frames, hd, wd, bh, bw;
  float voxel, trunc, fx, fy, cx, cy, depth_scale, depth_max, max_weight;
};

// Fold frame f (its pose in shared memory) into a thread's voxels: project
// them, round to a pixel and sample depth, then update the running average.
// Three divides are skipped where their result is known exactly: a raw depth
// of +-0 divided by depth_scale > 0 is itself; tsdf_obs * w_obs for
// w_obs = 0 is a zero with the sign of sdf_obs (trunc > 0 and the clip keep
// that sign), or -0 when sdf_obs is NaN (the clip makes it -1), so
// sdf_obs / trunc is not needed; and the quotient by max(w_new, 1) is its
// dividend unless w_new > 1. The average stays one divide where it runs: it
// is not K1's multiplication by a reciprocal, which rounds twice.
__device__ __forceinline__ void fold(const Params& P, const float* pose,
                                     int f, float wx, float wy,
                                     const float (&wz)[kVoxels],
                                     float (&sdf)[kVoxels],
                                     float (&w)[kVoxels]) {
  const float r00 = pose[0], r01 = pose[1], r02 = pose[2], t0 = pose[3];
  const float r10 = pose[4], r11 = pose[5], r12 = pose[6], t1 = pose[7];
  const float r20 = pose[8], r21 = pose[9], r22 = pose[10], t2 = pose[11];
  const float* dframe = P.depths + f * ((size_t)P.hd * P.wd);
  // every voxel's sample is loaded before any is folded
  float zv[kVoxels], dv[kVoxels];
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
    if (in[j]) dv[j] = dframe[(size_t)vi * P.wd + ui];
  }
#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const float z = zv[j];
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
    float sdf_n = sdf[j] * w[j] + obs;
    if (w_new > 1.0f) sdf_n = sdf_n / fmaxf(w_new, 1.0f);
    sdf[j] = w_new > 0.0f ? sdf_n : 1.0f;
    w[j] = fminf(w_new, P.max_weight);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    brick_integrate_fixed_kernel(const Params P) {
  const int bid_local = P.ids[blockIdx.x];
  // padding: the scratch row, or any id that is no row of this shard
  if ((unsigned)bid_local >= (unsigned)P.n_real) return;
  __shared__ float s_pose[kMaxFrames * kPoseFloats];
  __shared__ float s_origin[3];
  const int tid = threadIdx.x;
  const size_t row = (size_t)bid_local * kBrickVoxels;
  float sdf[kVoxels], w[kVoxels];
#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const int v = tid + j * kThreads;  // sublane v / 128, lane v % 128
    sdf[j] = P.sdf_b[row + v];
    w[j] = P.weight_b[row + v];
  }
  for (int i = tid; i < P.n_frames * kPoseFloats; i += kThreads) {
    s_pose[i] = P.poses[(i / kPoseFloats) * 16 + i % kPoseFloats];
  }
  if (tid < 3) s_origin[tid] = P.origin[tid];
  __syncthreads();

  const int bid = bid_local + P.id_base;
  const int bz = bid / (P.bh * P.bw);
  const int by = (bid / P.bw) % P.bh;
  const int bx = bid % P.bw;
  // a thread's voxels v = tid + j * kThreads share lane v % 128, so x and y
  const int lane = tid & 127;
  const int lx = lane & 15;
  const int ly = lane >> 4;
  const float wx = s_origin[0] + ((float)bx * 16.0f + (float)lx) * P.voxel;
  const float wy = s_origin[1] + ((float)by * 8.0f + (float)ly) * P.voxel;
  float wz[kVoxels];
#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const int v = tid + j * kThreads;
    wz[j] = s_origin[2] + ((float)bz * 8.0f + (float)(v >> 7)) * P.voxel;
  }

  for (int f = 0; f < P.n_frames; ++f) {
    fold(P, s_pose + kPoseFloats * f, f, wx, wy, wz, sdf, w);
  }

#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const int v = tid + j * kThreads;
    P.sdf_b[row + v] = sdf[j];
    P.weight_b[row + v] = w[j];
  }
}

}  // namespace

extern "C" int brick_integrate_fixed_occupancy(int* blocks_per_sm,
                                               int* threads) {
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, brick_integrate_fixed_kernel, kThreads, 0);
}

extern "C" int brick_integrate_fixed_launch(
    float* sdf_b, float* weight_b, const int32_t* ids, int n_ids,
    int id_base, int n_real_local, const float* poses, const float* origin,
    const float* depths, int n_frames, int hd, int wd, int bh, int bw,
    float voxel, float trunc, float fx, float fy, float cx, float cy,
    float depth_scale, float depth_max, float max_weight,
    cudaStream_t stream) {
  if (n_ids <= 0 || n_frames <= 0) return (int)cudaSuccess;
  if (n_frames > kMaxFrames) return (int)cudaErrorInvalidValue;
  const Params p{sdf_b,  weight_b, ids,         id_base,   n_real_local,
                 poses,  origin,   depths,      n_frames,  hd,
                 wd,     bh,       bw,          voxel,     trunc,
                 fx,     fy,       cx,          cy,        depth_scale,
                 depth_max, max_weight};
  brick_integrate_fixed_kernel<<<n_ids, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
