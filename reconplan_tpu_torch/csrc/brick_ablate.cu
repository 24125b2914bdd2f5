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
// here remove what the CUDA K1 is made of. This file holds a copy of K1's
// persistent loop and fold (brick_integrate.cu: the work counter, the
// poses in shared memory, the set-bit frame loop, the three exact skips)
// without its color code and with the arm as a template parameter: each
// arm is that code with one `if constexpr` taken the other way, compiled
// to its own kernel with no run-time branch on the arm. The copy is kept
// in step with K1 by the arm `full`, which must equal K1 bit for bit (the
// card tests, chip_smoke.py and profile_brick's parity gate hold it to
// that). It is the same arithmetic, not the same machine code: without
// the color code ptxas gives `full` 58 registers and 1,096 SASS
// instructions where K1's depth kernel has 60 and 1,080, and it ran
// 62.2-63.4 us beside K1's 59.9-60.7 in the same calls (NVIDIA H100 80GB
// HBM3, 700 W). So an arm is read against `full`, and `full` against K1
// timed in the same call (chip_smoke.py phase 3 prints both). K1 does not share
// this code through a header for the like reason: built from a shared
// template, its color kernel came out at 76 registers where its own
// source gives 80.
//
//   full           nothing off: K1 depth-only, bit-identical to
//                  brick_integrate(rgb_b=None).
//   no_fbits       every frame for each live brick, the frame bits ignored.
//   no_gather      no depth load: d = z * depth_scale (the TPU arm
//                  `no_window`'s round trip). Every voxel is then observed,
//                  so none of the three skips fires either.
//   one_row        the 8-corner footprint prologue, then d = depth[f, vmin,
//                  ui]: one image row per brick-frame (timing only, as the
//                  TPU arm `no_rowloop`).
//   rw_only        the frame loop skipped: each live brick row is read and
//                  written back unchanged (the TPU arm `dma_only`).
//   smem_window    the footprint from the 8-corner prologue (clamped as at
//                  profile_brick.py:439-442), its rows copied into a shared
//                  tile of at most 64 rows x 128 columns (32 KB) with
//                  cp.async, Hopper's counterpart of the TPU arm `dmahbm2`'s
//                  async DMA of a window. Voxels inside the tile read shared
//                  memory; the rest read global memory, so no voxel is
//                  dropped and the result is bit-identical to `full`.
//   no_skips       every IEEE divide taken, none of K1's three exact skips.
//                  Bit-identical to `full`: that equality on the card is
//                  the proof that the skips are exact.
//   static_stride  the persistent grid with k += gridDim.x and no work
//                  counter. Bit-identical to `full`.
//   pr1_full       the first design of K1 (what brick_integrate.cu's note
//                  calls the arm `full` of its day), kept whole as the
//                  yardstick K1 is timed against: len(ids) blocks, one
//                  brick a block (blocks past the live count exit), every
//                  frame's bit tested, the pose read from global memory a
//                  frame, x and y computed per voxel, every divide taken.
//                  Bit-identical to `full`.
//
// What bounds it: as K1 (see brick_integrate.cu): the bytes of the live
// rows set its bound, and its instructions, the divides among them, keep
// it several times above. The tile bounds smem_window: a footprint taller
// than 64 rows or wider than 128 columns reads its rest from global
// memory. At the bench scene (512^3, 1.566 mm voxels seen from about
// 0.38-0.5 m with fx 615.67) the 39,839 brick-frames of the 4 chunks have
// footprints of median 25 rows x 38 columns and at most 38 x 49, padding
// included, so the tile holds every one whole there.
//
// The windowed arms (one_row, smem_window) compute the prologue in one
// warp, a corner a lane, and broadcast it through shared memory; the
// frame loop is uniform across the block, so their barriers are reached
// by all threads. The work counters are this file's own: K1 and an arm on
// two streams never share one.

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
// blocks of kThreads an SM the launch bounds ask for
constexpr int kDepthBlocks = 4;
// the shared depth tile of the arm smem_window (32 KB, dynamic)
constexpr int kTileRows = 64;
constexpr int kTileCols = 128;

// What is switched off or swapped against K1; ARMS in
// ops/kernels/brick_ablate.py keeps this order. kPr1Full is not an arm of
// the template: it is the first design, a kernel of its own below.
enum Arm : int {
  kFull = 0,          // nothing: K1
  kNoFbits = 1,       // every frame of each live brick, the bits ignored
  kNoGather = 2,      // d = z * depth_scale in place of the depth load
  kOneRow = 3,        // footprint prologue, d = depth[f, vmin, ui]
  kRwOnly = 4,        // no frame loop: rows read and written back
  kSmemWindow = 5,    // footprint rows staged in a shared tile by cp.async
  kNoSkips = 6,       // every divide taken
  kStaticStride = 7,  // k += gridDim.x in place of the work counter
  kPr1Full = 8,
};

struct Params {
  float* sdf_b;           // (NB + 1, 8, 128)
  float* weight_b;        // (NB + 1, 8, 128)
  const int32_t* ids;     // (M,) compacted brick ids
  const int32_t* fbits;   // (M,) frame bits per brick
  const int32_t* n_live;  // (1,) live count; bricks past M are not read
  int m, slot;
  const float* poses;     // (F, 16) row-major w2c
  const float* origin;    // (3,)
  const float* depths;    // (F, Hd, Wd) raw depth
  int n_frames, hd, wd, bh, bw;
  float voxel, trunc, fx, fy, cx, cy, depth_scale, depth_max, max_weight;
};

// A brick-frame's depth window, for the arms that stage or replace the
// sampled rows (kOneRow, kSmemWindow): its first row and column, and the
// rows x columns of it that the tile holds.
struct Window {
  int vmin, umin, th, tw;
  const float* tile;  // kTileRows x kTileCols, kSmemWindow only
};

// The pixel bounding box (umin, umax, vmin, vmax) of a brick's 8 corner
// voxels under pose p, padded by one pixel and clamped to the image
// (benchmarks/profile_brick.py:414-442). Called by one whole warp: lane
// & 7 projects a corner, and shuffles reduce the eight.
__device__ __forceinline__ void corner_footprint(const Params& P,
                                                 const float* p,
                                                 const float* origin, int bx,
                                                 int by, int bz, int* out) {
  const int c = threadIdx.x & 7;
  const float lx = (c & 4) ? 15.0f : 0.0f;
  const float ly = (c & 2) ? 7.0f : 0.0f;
  const float lz = (c & 1) ? 7.0f : 0.0f;
  const float px = origin[0] + ((float)bx * 16.0f + lx) * P.voxel;
  const float py = origin[1] + ((float)by * 8.0f + ly) * P.voxel;
  const float pz = origin[2] + ((float)bz * 8.0f + lz) * P.voxel;
  const float xc = p[0] * px + p[1] * py + p[2] * pz + p[3];
  const float yc = p[4] * px + p[5] * py + p[6] * pz + p[7];
  const float zc = fmaxf(p[8] * px + p[9] * py + p[10] * pz + p[11], 1e-3f);
  const float cu = xc / zc * P.fx + P.cx;
  const float cv = yc / zc * P.fy + P.cy;
  float umn = cu, umx = cu, vmn = cv, vmx = cv;
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    umn = fminf(umn, __shfl_xor_sync(0xFFFFFFFFu, umn, o));
    umx = fmaxf(umx, __shfl_xor_sync(0xFFFFFFFFu, umx, o));
    vmn = fminf(vmn, __shfl_xor_sync(0xFFFFFFFFu, vmn, o));
    vmx = fmaxf(vmx, __shfl_xor_sync(0xFFFFFFFFu, vmx, o));
  }
  if ((threadIdx.x & 31) == 0) {
    out[0] = min(max((int)floorf(umn) - 1, 0), P.wd - 1);
    out[1] = min(max((int)ceilf(umx) + 1, 0), P.wd - 1);
    out[2] = min(max((int)floorf(vmn) - 1, 0), P.hd - 1);
    out[3] = min(max((int)ceilf(vmx) + 1, 0), P.hd - 1);
  }
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

// Fold frame f (its pose in shared memory) into a thread's voxels: project
// them, round to a pixel and sample depth, then update the running
// averages. Three divides are skipped where their result is
// known exactly: a raw depth of +-0 divided by depth_scale > 0 is itself;
// tsdf_obs * w_obs for w_obs = 0 is a zero with the sign of sdf_obs
// (trunc > 0 and the clip keep that sign), or -0 when sdf_obs is NaN (the
// clip makes it -1); and 1 / max(w_new, 1) is 1 unless w_new > 1. The arm
// kNoSkips takes all three divides always, and must give the same bits.
template <int kArm>
__device__ __forceinline__ void fold(const Params& P, const float* pose,
                                     int f, const Window& win, float wx,
                                     float wy, const float (&wz)[kVoxels],
                                     float (&sdf)[kVoxels],
                                     float (&w)[kVoxels]) {
  const float r00 = pose[0], r01 = pose[1], r02 = pose[2], t0 = pose[3];
  const float r10 = pose[4], r11 = pose[5], r12 = pose[6], t1 = pose[7];
  const float r20 = pose[8], r21 = pose[9], r22 = pose[10], t2 = pose[11];
  const size_t plane = (size_t)P.hd * P.wd;
  const float* dframe = P.depths + f * plane;
  // every voxel's samples are loaded before any is folded
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
    if constexpr (kArm == kNoGather) {
      dv[j] = z * P.depth_scale;
    } else if (in[j]) {
      const size_t pix = (size_t)vi * P.wd + ui;
      if constexpr (kArm == kOneRow) {
        dv[j] = dframe[(size_t)win.vmin * P.wd + ui];
      } else if constexpr (kArm == kSmemWindow) {
        const int r = vi - win.vmin;
        const int c = ui - win.umin;
        dv[j] = (r >= 0 && r < win.th && c >= 0 && c < win.tw)
                    ? win.tile[r * kTileCols + c]
                    : dframe[pix];
      } else {
        dv[j] = dframe[pix];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const float z = zv[j];
    float d = dv[j];
    if (kArm == kNoSkips || d != 0.0f) d = d / P.depth_scale;
    const float sdf_obs = d - z;
    const bool ok =
        in[j] && d > 0.0f && d < P.depth_max && sdf_obs > -P.trunc;
    const float w_obs = ok ? 1.0f : 0.0f;
    float obs;  // tsdf_obs * w_obs
    if (kArm == kNoSkips || ok) {
      obs = fminf(fmaxf(sdf_obs / P.trunc, -1.0f), 1.0f) * w_obs;
    } else {
      obs = sdf_obs != sdf_obs ? -0.0f : copysignf(0.0f, sdf_obs);
    }
    const float w_new = w[j] + w_obs;
    float inv = 1.0f;  // 1 / max(w_new, 1) is 1 unless w_new > 1
    if (kArm == kNoSkips || w_new > 1.0f) inv = 1.0f / fmaxf(w_new, 1.0f);
    const float sdf_n = (sdf[j] * w[j] + obs) * inv;
    sdf[j] = w_new > 0.0f ? sdf_n : 1.0f;
    w[j] = fminf(w_new, P.max_weight);
  }
}

// Brick k of the compacted list: load its rows, fold its frames, store.
// `nth` counts the block's brick-frames so far (uniform in the block): the
// windowed arms alternate two footprint slots on its parity.
template <int kArm>
__device__ __forceinline__ void fold_brick(const Params& P, int k,
                                           uint32_t fmask,
                                           const float* s_pose,
                                           const float* s_origin,
                                           int (*s_fp)[4], float* tile,
                                           int lx, int ly, int& nth) {
  constexpr bool kWindowed = kArm == kOneRow || kArm == kSmemWindow;
  const int tid = threadIdx.x;
  const int bid = P.ids[k];
  const uint32_t fb =
      kArm == kNoFbits ? fmask : (uint32_t)P.fbits[k] & fmask;
  const int bz = bid / (P.bh * P.bw);
  const int by = (bid / P.bw) % P.bh;
  const int bx = bid % P.bw;
  const size_t row = (size_t)bid * kBrickVoxels;
  const float wx = s_origin[0] + ((float)bx * 16.0f + (float)lx) * P.voxel;
  const float wy = s_origin[1] + ((float)by * 8.0f + (float)ly) * P.voxel;
  float wz[kVoxels], sdf[kVoxels], w[kVoxels];
#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const int v = tid + j * kThreads;  // sublane v / 128, lane v % 128
    wz[j] = s_origin[2] + ((float)bz * 8.0f + (float)(v >> 7)) * P.voxel;
    sdf[j] = P.sdf_b[row + v];
    w[j] = P.weight_b[row + v];
  }

  if constexpr (kArm != kRwOnly) {
    for (uint32_t m = fb; m != 0u; m &= m - 1u) {  // uniform in the block
      const int f = __ffs(m) - 1;
      const float* pose = s_pose + kPoseFloats * f;
      Window win{0, 0, 0, 0, tile};
      if constexpr (kWindowed) {
        // One warp computes the footprint into the slot of this
        // brick-frame's parity; the barrier publishes it and, for the
        // tile, also ends the reads of the brick-frame before. The other
        // slot is written next, a barrier after every thread read it.
        int* fp = s_fp[nth & 1];
        ++nth;
        if (tid < 32) corner_footprint(P, pose, s_origin, bx, by, bz, fp);
        __syncthreads();
        win.umin = fp[0];
        win.vmin = fp[2];
        win.th = min(fp[3] - fp[2] + 1, kTileRows);
        win.tw = min(fp[1] - fp[0] + 1, kTileCols);
      }
      if constexpr (kArm == kSmemWindow) {
        const float* dframe = P.depths + f * (size_t)P.hd * P.wd;
        const int c = tid & (kTileCols - 1);
        if (c < win.tw) {
          for (int r = tid / kTileCols; r < win.th;
               r += kThreads / kTileCols) {
            cp_async4(&tile[r * kTileCols + c],
                      dframe + (size_t)(win.vmin + r) * P.wd + win.umin + c);
          }
        }
        cp_async_wait_all();
        __syncthreads();
      }
      fold<kArm>(P, pose, f, win, wx, wy, wz, sdf, w);
    }
  }

#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const int v = tid + j * kThreads;
    P.sdf_b[row + v] = sdf[j];
    P.weight_b[row + v] = w[j];
  }
}

// The body of a persistent block: `work` is the (next brick, blocks done)
// counter pair of the launch's slot, zero between launches. The arm
// kSmemWindow must be launched with kTileRows * kTileCols floats of
// dynamic shared memory.
template <int kArm>
__device__ __forceinline__ void brick_loop(const Params& P, int* work) {
  __shared__ float s_pose[kMaxFrames * kPoseFloats];
  __shared__ float s_origin[3];
  __shared__ int s_k[2];
  __shared__ int s_fp[2][4];  // the windowed arms' footprints
  extern __shared__ float tile[];
  const int tid = threadIdx.x;
  for (int i = tid; i < P.n_frames * kPoseFloats; i += kThreads) {
    s_pose[i] = P.poses[(i / kPoseFloats) * 16 + i % kPoseFloats];
  }
  if (tid < 3) s_origin[tid] = P.origin[tid];
  const int n = min(*P.n_live, P.m);
  const uint32_t fmask =
      P.n_frames >= 32 ? 0xFFFFFFFFu : (1u << P.n_frames) - 1u;
  // a thread's voxels v = tid + j * kThreads share lane v % 128, so x and y
  const int lane = tid & 127;
  const int lx = lane & 15;
  const int ly = lane >> 4;
  int nth = 0;

  if constexpr (kArm == kStaticStride) {
    __syncthreads();  // the pose and origin
    for (int k = blockIdx.x; k < n; k += gridDim.x) {
      fold_brick<kArm>(P, k, fmask, s_pose, s_origin, s_fp, tile, lx, ly,
                       nth);
    }
  } else {
    if (tid == 0) s_k[0] = atomicAdd(work, 1);
    __syncthreads();  // the pose, origin and first brick index
    int k = s_k[0];
    for (int it = 0; k < n; ++it) {
      if (tid == 0) s_k[(it + 1) & 1] = atomicAdd(work, 1);
      __syncthreads();  // also: every thread has read the other slot
      const int kn = s_k[(it + 1) & 1];
      fold_brick<kArm>(P, k, fmask, s_pose, s_origin, s_fp, tile, lx, ly,
                       nth);
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
}

// (next brick, blocks done) of each slot; zero between launches
__device__ int g_work[kWorkSlots][2];

constexpr size_t kTileBytes = kTileRows * kTileCols * sizeof(float);

template <int kArm>
__global__ void __launch_bounds__(kThreads, kDepthBlocks)
    brick_ablate_kernel(const Params P) {
  brick_loop<kArm>(P, g_work[P.slot]);
}

// The first design of K1, depth only.
__global__ void __launch_bounds__(kThreads) brick_ablate_pr1_kernel(
    const Params P) {
  const int k = blockIdx.x;
  if (k >= *P.n_live) return;
  const int bid = P.ids[k];
  const int fb = P.fbits[k];
  const int bz = bid / (P.bh * P.bw);
  const int by = (bid / P.bw) % P.bh;
  const int bx = bid % P.bw;
  const float ox = P.origin[0], oy = P.origin[1], oz = P.origin[2];
  const size_t row = (size_t)bid * kBrickVoxels;

  float wx[kVoxels], wy[kVoxels], wz[kVoxels];
  float sdf[kVoxels], w[kVoxels];
#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const int v = threadIdx.x + j * kThreads;  // sublane v / 128, lane v % 128
    const int lz = v >> 7;
    const int lane = v & 127;
    const int ly = lane >> 4;
    const int lx = lane & 15;
    wx[j] = ox + ((float)bx * 16.0f + (float)lx) * P.voxel;
    wy[j] = oy + ((float)by * 8.0f + (float)ly) * P.voxel;
    wz[j] = oz + ((float)bz * 8.0f + (float)lz) * P.voxel;
    sdf[j] = P.sdf_b[row + v];
    w[j] = P.weight_b[row + v];
  }

  const size_t plane = (size_t)P.hd * P.wd;
  for (int f = 0; f < P.n_frames; ++f) {
    if (((fb >> f) & 1) == 0) continue;  // block-uniform
    const float* p = P.poses + 16 * f;
    const float r00 = p[0], r01 = p[1], r02 = p[2], t0 = p[3];
    const float r10 = p[4], r11 = p[5], r12 = p[6], t1 = p[7];
    const float r20 = p[8], r21 = p[9], r22 = p[10], t2 = p[11];
    const float* dframe = P.depths + f * plane;
#pragma unroll
    for (int j = 0; j < kVoxels; ++j) {
      const float x = r00 * wx[j] + r01 * wy[j] + r02 * wz[j] + t0;
      const float y = r10 * wx[j] + r11 * wy[j] + r12 * wz[j] + t1;
      const float z = r20 * wx[j] + r21 * wy[j] + r22 * wz[j] + t2;
      const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
      const float u = x / zs * P.fx + P.cx;
      const float vv = y / zs * P.fy + P.cy;
      const int ui = __float2int_rn(u);  // half-to-even, as jnp.round
      const int vi = __float2int_rn(vv);
      const bool in_img =
          ui >= 0 && ui < P.wd && vi >= 0 && vi < P.hd && z > 1e-4f;
      float d = 0.0f;
      if (in_img) d = dframe[(size_t)vi * P.wd + ui];
      d = d / P.depth_scale;
      const float sdf_obs = d - z;
      const bool ok =
          in_img && d > 0.0f && d < P.depth_max && sdf_obs > -P.trunc;
      const float tsdf_obs = fminf(fmaxf(sdf_obs / P.trunc, -1.0f), 1.0f);
      const float w_obs = ok ? 1.0f : 0.0f;
      const float w_new = w[j] + w_obs;
      const float inv = 1.0f / fmaxf(w_new, 1.0f);
      const float sdf_n = (sdf[j] * w[j] + tsdf_obs * w_obs) * inv;
      sdf[j] = w_new > 0.0f ? sdf_n : 1.0f;
      w[j] = fminf(w_new, P.max_weight);
    }
  }

#pragma unroll
  for (int j = 0; j < kVoxels; ++j) {
    const int v = threadIdx.x + j * kThreads;
    P.sdf_b[row + v] = sdf[j];
    P.weight_b[row + v] = w[j];
  }
}

template <int kArm>
cudaError_t occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, brick_ablate_kernel<kArm>, kThreads,
      kArm == kSmemWindow ? kTileBytes : 0);
}

template <int kArm>
cudaError_t launch(const Params& p, int grid, cudaStream_t stream) {
  brick_ablate_kernel<kArm>
      <<<grid, kThreads, kArm == kSmemWindow ? kTileBytes : 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Blocks of `threads` an SM that arm's kernel can hold (with its dynamic
// shared memory): the wrapper sizes the persistent grid from it.
extern "C" int brick_ablate_occupancy(int arm, int* blocks_per_sm,
                                      int* threads) {
  *threads = kThreads;
  switch (arm) {
    case kFull: return (int)occupancy<kFull>(blocks_per_sm);
    case kNoFbits: return (int)occupancy<kNoFbits>(blocks_per_sm);
    case kNoGather: return (int)occupancy<kNoGather>(blocks_per_sm);
    case kOneRow: return (int)occupancy<kOneRow>(blocks_per_sm);
    case kRwOnly: return (int)occupancy<kRwOnly>(blocks_per_sm);
    case kSmemWindow: return (int)occupancy<kSmemWindow>(blocks_per_sm);
    case kNoSkips: return (int)occupancy<kNoSkips>(blocks_per_sm);
    case kStaticStride: return (int)occupancy<kStaticStride>(blocks_per_sm);
    case kPr1Full:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, brick_ablate_pr1_kernel, kThreads, 0);
    default: return (int)cudaErrorInvalidValue;
  }
}

// `grid` is the persistent grid of the arm (pr1_full: m blocks, whatever
// `grid` says); `slot` the stream's work-counter slot.
extern "C" int brick_ablate_launch(
    int arm, float* sdf_b, float* weight_b, const int32_t* ids,
    const int32_t* fbits, const int32_t* n_live, int m, int slot, int grid,
    const float* poses, const float* origin, const float* depths,
    int n_frames, int hd, int wd, int bh, int bw, float voxel, float trunc,
    float fx, float fy, float cx, float cy, float depth_scale,
    float depth_max, float max_weight, cudaStream_t stream) {
  if (grid <= 0 || m <= 0) return (int)cudaSuccess;
  if (n_frames > kMaxFrames || slot < 0 || slot >= kWorkSlots) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{sdf_b,    weight_b, ids,   fbits, n_live,      m,
                 slot,     poses,    origin, depths, n_frames,   hd,
                 wd,       bh,       bw,    voxel, trunc,       fx,
                 fy,       cx,       cy,    depth_scale, depth_max,
                 max_weight};
  switch (arm) {
    case kFull: return (int)launch<kFull>(p, grid, stream);
    case kNoFbits: return (int)launch<kNoFbits>(p, grid, stream);
    case kNoGather: return (int)launch<kNoGather>(p, grid, stream);
    case kOneRow: return (int)launch<kOneRow>(p, grid, stream);
    case kRwOnly: return (int)launch<kRwOnly>(p, grid, stream);
    case kSmemWindow: return (int)launch<kSmemWindow>(p, grid, stream);
    case kNoSkips: return (int)launch<kNoSkips>(p, grid, stream);
    case kStaticStride: return (int)launch<kStaticStride>(p, grid, stream);
    case kPr1Full:
      brick_ablate_pr1_kernel<<<m, kThreads, 0, stream>>>(p);
      return (int)cudaGetLastError();
    default: return (int)cudaErrorInvalidValue;
  }
}
