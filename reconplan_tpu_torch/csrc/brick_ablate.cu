// Ablation arms of K1, depth only: the CUDA K1 (brick_integrate.cu) with
// one of its pieces switched off or swapped, timed against the whole by
// `python -m reconplan_tpu_torch.benchmarks.profile_brick`.
//
// Replaces the TPU kernels `_ablate_kernel` (benchmarks/profile_brick.py:75,
// the arms of its docstring, :20-40) and `_ablate_kernel2`
// (benchmarks/profile_brick.py:320, the arms of :300-318). Both are
// depth-only copies of the TPU K1 with pieces removed. Most of their arms
// remove what only the TPU kernel has (lane / sublane rolls, the
// SAMPLE_BRANCHES cond ladder, the straddle cond, VMEM windows); the arms
// here remove what the CUDA K1 is made of. The arm is a template
// parameter, so each arm compiles to its own kernel with no run-time
// branch on it:
//
//   full         K1 depth-only, the same operations in the same order:
//                bit-identical to brick_integrate(rgb_b=None).
//   no_fbits     every frame for each live brick, the frame bits ignored.
//   no_gather    no depth load: d = (z * depth_scale) / depth_scale, the
//                TPU arm `no_window`'s round trip.
//   one_row      the 8-corner footprint prologue, then d = depth[f, vmin,
//                ui]: one image row per brick-frame (timing only, as the
//                TPU arm `no_rowloop`).
//   rw_only      the frame loop skipped: each live brick row is read and
//                written back unchanged (the TPU arm `dma_only`).
//   smem_window  the footprint from the 8-corner prologue (clamped as at
//                profile_brick.py:439-442), its rows copied into a shared
//                tile of at most 64 rows x 128 columns (32 KB) with
//                cp.async, Hopper's counterpart of the TPU arm `dmahbm2`'s
//                async DMA of a window. Voxels inside the tile read shared
//                memory; the rest read global memory, so no voxel is
//                dropped and the result is bit-identical to `full`.
//
// What bounds it: as K1, gather latency and divides (the chunk's frames
// sit in the 50 MB L2). The tile bounds smem_window: a footprint taller
// than 64 rows or wider than 128 columns reads its rest from global
// memory. At the bench scene (512^3, 1.566 mm voxels seen from about
// 0.38-0.5 m with fx 615.67) the 39,839 brick-frames of the 4 chunks have
// footprints of median 25 rows x 38 columns and at most 38 x 49, padding
// included, so the tile holds every one whole there.
//
// The grid is max_active blocks of 256 threads, 4 voxels a thread, and
// each block reads the live count from device memory, as in K1. The
// prologue is computed by every thread of the block (the same eight
// corners, so the result is uniform) and the frame-bit branch is uniform
// across the block, so the tile's __syncthreads are reached by all
// threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBrickVoxels = 1024;  // 8 x 8 x 16
constexpr int kThreads = 256;
constexpr int kPerThread = kBrickVoxels / kThreads;
constexpr int kTileRows = 64;
constexpr int kTileCols = 128;

enum Arm : int {
  kFull = 0,
  kNoFbits = 1,
  kNoGather = 2,
  kOneRow = 3,
  kRwOnly = 4,
  kSmemWindow = 5,
};

struct Footprint {
  int umin, umax, vmin, vmax;
};

// The pixel bounding box of the brick's 8 corner voxels, padded by one
// pixel and clamped to the image (profile_brick.py:414-442).
__device__ __forceinline__ Footprint corner_footprint(
    const float* p, float ox, float oy, float oz, int bx, int by, int bz,
    float voxel, float fx, float fy, float cx, float cy, int hd, int wd) {
  float umn = 0.0f, umx = 0.0f, vmn = 0.0f, vmx = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float lx = (c & 4) ? 15.0f : 0.0f;
    const float ly = (c & 2) ? 7.0f : 0.0f;
    const float lz = (c & 1) ? 7.0f : 0.0f;
    const float px = ox + ((float)bx * 16.0f + lx) * voxel;
    const float py = oy + ((float)by * 8.0f + ly) * voxel;
    const float pz = oz + ((float)bz * 8.0f + lz) * voxel;
    const float xc = p[0] * px + p[1] * py + p[2] * pz + p[3];
    const float yc = p[4] * px + p[5] * py + p[6] * pz + p[7];
    const float zc = fmaxf(p[8] * px + p[9] * py + p[10] * pz + p[11], 1e-3f);
    const float cu = xc / zc * fx + cx;
    const float cv = yc / zc * fy + cy;
    umn = c == 0 ? cu : fminf(umn, cu);
    umx = c == 0 ? cu : fmaxf(umx, cu);
    vmn = c == 0 ? cv : fminf(vmn, cv);
    vmx = c == 0 ? cv : fmaxf(vmx, cv);
  }
  Footprint fp;
  fp.umin = min(max((int)floorf(umn) - 1, 0), wd - 1);
  fp.umax = min(max((int)ceilf(umx) + 1, 0), wd - 1);
  fp.vmin = min(max((int)floorf(vmn) - 1, 0), hd - 1);
  fp.vmax = min(max((int)ceilf(vmx) + 1, 0), hd - 1);
  return fp;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int A>
__global__ void __launch_bounds__(kThreads) brick_ablate_kernel(
    float* __restrict__ sdf_b,          // (NB + 1, 8, 128)
    float* __restrict__ weight_b,       // (NB + 1, 8, 128)
    const int32_t* __restrict__ ids,    // (M,) compacted brick ids
    const int32_t* __restrict__ fbits,  // (M,) frame bits per brick
    const int32_t* __restrict__ n_live, // (1,) live count n <= M
    const float* __restrict__ poses,    // (F, 16) row-major w2c
    const float* __restrict__ origin,   // (3,)
    const float* __restrict__ depths,   // (F, Hd, Wd) raw depth
    int n_frames, int hd, int wd, int bh, int bw,
    float voxel, float trunc, float fx, float fy, float cx, float cy,
    float depth_scale, float depth_max, float max_weight) {
  extern __shared__ float tile[];  // kTileRows x kTileCols, smem_window only
  const int k = blockIdx.x;
  if (k >= *n_live) return;
  const int bid = ids[k];
  const int fb = fbits[k];
  const int bz = bid / (bh * bw);
  const int by = (bid / bw) % bh;
  const int bx = bid % bw;
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const size_t row = (size_t)bid * kBrickVoxels;

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
  for (int f = 0; f < n_frames && A != kRwOnly; ++f) {
    if (A != kNoFbits && ((fb >> f) & 1) == 0) continue;  // block-uniform
    const float* p = poses + 16 * f;
    const float r00 = p[0], r01 = p[1], r02 = p[2], t0 = p[3];
    const float r10 = p[4], r11 = p[5], r12 = p[6], t1 = p[7];
    const float r20 = p[8], r21 = p[9], r22 = p[10], t2 = p[11];
    const float* dframe = depths + f * plane;
    int vmin = 0, umin = 0, th = 0, tw = 0;
    if constexpr (A == kOneRow || A == kSmemWindow) {
      const Footprint fp = corner_footprint(p, ox, oy, oz, bx, by, bz, voxel,
                                            fx, fy, cx, cy, hd, wd);
      vmin = fp.vmin;
      umin = fp.umin;
      th = min(fp.vmax - fp.vmin + 1, kTileRows);
      tw = min(fp.umax - fp.umin + 1, kTileCols);
    }
    if constexpr (A == kSmemWindow) {
      __syncthreads();  // the previous frame's reads of the tile are done
      const int c = threadIdx.x & (kTileCols - 1);
      if (c < tw) {
        for (int r = threadIdx.x / kTileCols; r < th;
             r += kThreads / kTileCols) {
          cp_async4(&tile[r * kTileCols + c],
                    dframe + (size_t)(vmin + r) * wd + umin + c);
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
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
      if constexpr (A == kNoGather) {
        d = z * depth_scale;
      } else if (in_img) {
        if constexpr (A == kOneRow) {
          d = dframe[(size_t)vmin * wd + ui];
        } else if constexpr (A == kSmemWindow) {
          const int r = vi - vmin;
          const int c = ui - umin;
          d = (r >= 0 && r < th && c >= 0 && c < tw)
                  ? tile[r * kTileCols + c]
                  : dframe[(size_t)vi * wd + ui];
        } else {
          d = dframe[(size_t)vi * wd + ui];
        }
      }
      d = d / depth_scale;
      const float sdf_obs = d - z;
      const bool ok = in_img && d > 0.0f && d < depth_max && sdf_obs > -trunc;
      const float tsdf_obs = fminf(fmaxf(sdf_obs / trunc, -1.0f), 1.0f);
      const float w_obs = ok ? 1.0f : 0.0f;
      const float w_new = w[j] + w_obs;
      const float inv = 1.0f / fmaxf(w_new, 1.0f);
      const float sdf_n = (sdf[j] * w[j] + tsdf_obs * w_obs) * inv;
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

template <int A>
cudaError_t launch(int max_active, size_t smem, cudaStream_t stream,
                   float* sdf_b, float* weight_b, const int32_t* ids,
                   const int32_t* fbits, const int32_t* n_live,
                   const float* poses, const float* origin,
                   const float* depths, int n_frames, int hd, int wd, int bh,
                   int bw, float voxel, float trunc, float fx, float fy,
                   float cx, float cy, float depth_scale, float depth_max,
                   float max_weight) {
  brick_ablate_kernel<A><<<max_active, kThreads, smem, stream>>>(
      sdf_b, weight_b, ids, fbits, n_live, poses, origin, depths, n_frames,
      hd, wd, bh, bw, voxel, trunc, fx, fy, cx, cy, depth_scale, depth_max,
      max_weight);
  return cudaGetLastError();
}

}  // namespace

extern "C" int brick_ablate_launch(
    int arm, float* sdf_b, float* weight_b, const int32_t* ids,
    const int32_t* fbits, const int32_t* n_live, int max_active,
    const float* poses, const float* origin, const float* depths,
    int n_frames, int hd, int wd, int bh, int bw, float voxel, float trunc,
    float fx, float fy, float cx, float cy, float depth_scale,
    float depth_max, float max_weight, cudaStream_t stream) {
  if (max_active <= 0) return (int)cudaSuccess;
#define ABLATE_ARGS                                                          \
  stream, sdf_b, weight_b, ids, fbits, n_live, poses, origin, depths,        \
      n_frames, hd, wd, bh, bw, voxel, trunc, fx, fy, cx, cy, depth_scale,   \
      depth_max, max_weight
  const size_t tile = kTileRows * kTileCols * sizeof(float);
  switch (arm) {
    case kFull: return (int)launch<kFull>(max_active, 0, ABLATE_ARGS);
    case kNoFbits: return (int)launch<kNoFbits>(max_active, 0, ABLATE_ARGS);
    case kNoGather: return (int)launch<kNoGather>(max_active, 0, ABLATE_ARGS);
    case kOneRow: return (int)launch<kOneRow>(max_active, 0, ABLATE_ARGS);
    case kRwOnly: return (int)launch<kRwOnly>(max_active, 0, ABLATE_ARGS);
    case kSmemWindow:
      return (int)launch<kSmemWindow>(max_active, tile, ABLATE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ABLATE_ARGS
}
