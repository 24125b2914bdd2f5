// One Gauss-Newton step of point-to-plane and of colored ICP (Park, Zhou,
// Koltun 2017), in two launches with no host read between them, and the
// solve's pack and result around them.
//
// Replaces no TPU kernel: the JAX solves are plain XLA,
// `icp_point_to_plane` and `colored_icp` (reconplan_tpu/ops/icp.py), and
// their PyTorch port's step (`ops/icp`, `_point_to_plane_step` and
// `_colored_step`, with `ops/kernels/icp_step.icp_step_reference`'s update)
// stays the plain version for CPU tensors. Run eagerly on the card a step
// is about 214 launches: the moved points, four 2,048 x 8,192 distance
// tiles in matmul form (mean-centring, norms, a GEMM, add, subtract, clamp,
// mask, argmin, the winner's exact distance), the gathers, crosses and
// concatenations of the rows, the normal equations' sums, a 6 x 6 solve,
// the quaternion exponential and the update's three `where`s. Each launch
// costs the host about 13 us while the card idles; the card's own work is
// a few microseconds and six 64 MB tiles through device memory.
//
// Semantics, for a solve with source slots N (points p, validity), target
// slots M (points q, normals n, validity; colored: colors and intensity
// gradients g), the state (T, rmse, prev, iters, live) and max_dist:
//   pack   : the valid targets, in slot order, as (x, y, z, slot) float4s;
//            the valid source slots in order; their counts; the state's
//            start: T = T0, rmse = 1e30, prev = 0, iters = 0, live = the
//            stop test of that start.
//   step   : nothing while !live. Else each valid source slot s is moved,
//            p' = R p + t (T's rows), and matched to the valid target j of
//            least |p' - q_j|^2 (direct subtraction in f32; ties to the
//            lowest slot; slot 0 when no valid target lies at a finite
//            distance, as the plain version's argmin over an all-inf row).
//            d = |p' - q_j|. An inlier, d < max_dist, adds the rows that
//            the plain version forms:
//              point-to-plane: A = [p' x n, n], r = n . (p' - q)
//              colored: [p' x n, n] sqrt(l) with r_g sqrt(l), and
//                [p' x (-M), -M] sqrt(1 - l) with r_c sqrt(1 - l), where
//                M = g - (g . n) n, proj = p' - ((p' - q) . n) n and
//                r_c = c_p - (c_q + g . (proj - q)), c the colors' mean
//            to the 21 distinct entries of J^T J, the 6 of J^T r, the
//            inliers' count and sum r^2 (colored: r_g^2 and r_c^2 apart).
//            Then xi = solve(J^T J + 1e-6 I, -J^T r) (in double),
//            T' = exp(xi) T (quaternion exponential, `maths.rotvec_to_quat`
//            with its angle < 1e-8 branch and `quat_to_matrix`, in f32),
//            rmse' = sqrt(sum r^2 / max(inliers, 1)) (colored: sqrt((sum
//            r_g^2 l + sum r_c^2 (1 - l)) / max(inliers, 1))) at T; the
//            state takes T = T', prev = rmse, rmse = rmse', iters + 1, and
//            live = |prev - rmse| > rel max(rmse, 1e-12).
//   result : the same match at T (whatever live says): fitness = inliers /
//            max(valid sources, 1), inlier rmse = sqrt(sum d^2 /
//            max(inliers, 1)).
// The sums are taken in a fixed order (a warp's shuffle tree, then the
// blocks in turn): two runs give the same bits. The neighbour is the exact
// nearest, where the plain version's matmul form can pick another of two
// nearly equidistant targets; the sums' order differs from the plain
// version's, so the two agree within rounding, not bit for bit.
//
// What bounds it. At the stitch cell's shapes (8,192 source and 8,192
// target slots, about 1,500 valid in each) a step must compare every valid
// source with every valid target, 9 f32 operations a pair: about 20
// MFLOP, 0.3 us at 67 TFLOP/s; its bytes (the packed targets, the valid
// sources) are tens of KB. Against that stand the two launches' fixed
// costs, about 1.5 us each on the card, and the second launch's solve,
// one thread's dependent chain.
//
// Design. No distance tile in device memory and no float atomics.
// (0) `icp_pack_kernel`, one block, once a solve: ballots and the warps'
// popcounts compact the valid targets and sources, so a step touches
// neither an invalid target nor an invalid source. (1)
// `icp_match_kernel<kind>`: a block holds kSourcesPerBlock valid sources,
// one a lane, in each of its kWarps warps; the packed targets pass through
// shared memory kTile at a time, and warp w scans targets w, w + kWarps, ...
// of each tile for its lane's source (every lane reads the same target: a
// broadcast). The warps' winners meet in shared memory, warp 0 forms its
// lanes' rows and sums them by shuffles, and lane 0 writes the block's
// partial sums. Blocks past the valid sources return at once, so the grid
// of N / kSourcesPerBlock blocks needs no count from the host. (2)
// `icp_update_kernel<kind>`, one block: sums the partials in a fixed
// order, in double, then one thread solves, exponentiates and updates the
// state.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPointToPlane = 0;
constexpr int kColored = 1;
constexpr int kResult = 2;

constexpr int kSourcesPerBlock = 32;  // one a lane
constexpr int kWarps = 16;
constexpr int kMatchThreads = kWarps * 32;
constexpr int kTile = 2048;  // packed targets a pass through shared memory
constexpr int kPackThreads = 1024;
constexpr int kUpdateThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// the state's words (f32, or i32 where named so) at the buffer's start
constexpr int kStateWords = 32;
constexpr int kT = 0;         // 16: T, row-major
constexpr int kRmse = 16;
constexpr int kPrev = 17;
constexpr int kIters = 18;    // i32
constexpr int kLive = 19;     // i32, 0 or 1
constexpr int kTargets = 20;  // i32: valid targets
constexpr int kSources = 21;  // i32: valid sources
constexpr int kFitness = 22;
constexpr int kInlierRmse = 23;

// a block's partial sums: J^T J's upper triangle row by row (21), J^T r
// (6), the inliers, sum r^2 (colored: r_g^2), colored: sum r_c^2; the
// result: the inliers at 27 and sum d^2 at 28
constexpr int kPartialWords = 32;
constexpr int kJtr = 21;
constexpr int kCount = 27;
constexpr int kSq = 28;
constexpr int kSqColor = 29;
constexpr int kSums = 30;

// the solve's buffer, in f32 words: the state, the packed targets (4 a
// target slot), the valid sources (1 a source slot) and the match's
// partial sums (kPartialWords a block of N / kSourcesPerBlock)
struct Layout {
  float* state;
  float4* targets;  // (M,) packed: x, y, z, slot bits
  int* sources;     // (N,) valid source slots
  float* partials;  // (N / kSourcesPerBlock, kPartialWords)
};

__device__ __forceinline__ Layout layout(float* buf, int n_src, int n_tgt) {
  Layout l;
  l.state = buf;
  l.targets = reinterpret_cast<float4*>(buf + kStateWords);
  l.sources = reinterpret_cast<int*>(buf + kStateWords + 4LL * n_tgt);
  l.partials = buf + kStateWords + 4LL * n_tgt + n_src;
  return l;
}

__device__ __forceinline__ bool still_live(float prev, float rmse,
                                           float rel) {
  return fabsf(prev - rmse) > rel * fmaxf(rmse, 1e-12f);
}

// the block's valid entries of `valid` (n bytes), in order: emit(k, j)
// for the k-th valid slot j; returns the count, in every thread
template <typename Emit>
__device__ int compact(const uint8_t* __restrict__ valid, int n, Emit emit) {
  __shared__ int s_warp[kPackThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int start = 0; start < n; start += kPackThreads) {
    const int j = start + threadIdx.x;
    const bool v = j < n && valid[j] != 0;
    const unsigned m = __ballot_sync(kFull, v);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int before = base, total = 0;
    for (int w = 0; w < kPackThreads / 32; ++w) {
      if (w < warp) before += s_warp[w];
      total += s_warp[w];
    }
    if (v) emit(before + __popc(m & ((1u << lane) - 1u)), j);
    __syncthreads();  // s_warp is rewritten by the next round
    base += total;
  }
  return base;
}

__global__ void __launch_bounds__(kPackThreads) icp_pack_kernel(
    float* __restrict__ buf, const uint8_t* __restrict__ src_valid,
    const float* __restrict__ tgt_points, const uint8_t* __restrict__ tgt_valid,
    const float* __restrict__ T0, int n_src, int n_tgt, float rel) {
  const Layout l = layout(buf, n_src, n_tgt);
  const int n_targets = compact(tgt_valid, n_tgt, [&](int k, int j) {
    l.targets[k] = make_float4(tgt_points[3 * j], tgt_points[3 * j + 1],
                               tgt_points[3 * j + 2], __int_as_float(j));
  });
  const int n_sources = compact(src_valid, n_src, [&](int k, int j) {
    l.sources[k] = j;
  });
  if (threadIdx.x < 16) l.state[kT + threadIdx.x] = T0[threadIdx.x];
  if (threadIdx.x == 0) {
    int* istate = reinterpret_cast<int*>(l.state);
    // the plain version's finite sentinels: with inf the first stop test
    // would read inf > inf and the solve would never start
    l.state[kRmse] = 1e30f;
    l.state[kPrev] = 0.0f;
    istate[kIters] = 0;
    istate[kLive] = still_live(0.0f, 1e30f, rel) ? 1 : 0;
    istate[kTargets] = n_targets;
    istate[kSources] = n_sources;
  }
}

__device__ __forceinline__ float3 load3(const float* __restrict__ a, int i) {
  return make_float3(a[3 * i], a[3 * i + 1], a[3 * i + 2]);
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ float3 scale3(float3 a, float s) {
  return make_float3(a.x * s, a.y * s, a.z * s);
}

__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float mean3(float3 c) {
  return ((c.x + c.y) + c.z) / 3.0f;
}

// the row a (6) with residual r, once: J^T J's triangle and J^T r
__device__ __forceinline__ void add_row(float (&c)[kSums], const float (&a)[6],
                                        float r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) c[k++] += a[i] * a[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) c[kJtr + i] += a[i] * r;
}

__device__ __forceinline__ void set_row(float (&a)[6], float3 u, float3 v,
                                        float s) {
  a[0] = u.x * s;
  a[1] = u.y * s;
  a[2] = u.z * s;
  a[3] = v.x * s;
  a[4] = v.y * s;
  a[5] = v.z * s;
}

template <int kKind>
__global__ void __launch_bounds__(kMatchThreads) icp_match_kernel(
    float* __restrict__ buf, const float* __restrict__ src_points,
    const float* __restrict__ src_colors, const float* __restrict__ tgt_points,
    const float* __restrict__ tgt_normals, const float* __restrict__ tgt_colors,
    const float* __restrict__ tgt_grads, int n_src, int n_tgt, float max_dist,
    float lambda) {
  const Layout l = layout(buf, n_src, n_tgt);
  const int* istate = reinterpret_cast<const int*>(l.state);
  if (kKind != kResult && istate[kLive] == 0) return;
  const int n_sources = istate[kSources];
  const int first = blockIdx.x * kSourcesPerBlock;
  if (first >= n_sources) return;
  const int n_targets = istate[kTargets];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = first + lane;
  const bool has = k < n_sources;
  const int s = has ? l.sources[k] : 0;

  // p' = R p + t, each row's products summed in order, then t
  const float* T = l.state + kT;
  const float3 p = load3(src_points, s);
  const float3 m = make_float3(
      (p.x * T[0] + p.y * T[1]) + p.z * T[2] + T[3],
      (p.x * T[4] + p.y * T[5]) + p.z * T[6] + T[7],
      (p.x * T[8] + p.y * T[9]) + p.z * T[10] + T[11]);

  __shared__ float4 s_tgt[kTile];
  __shared__ float s_best[kWarps][32];
  __shared__ int s_at[kWarps][32];
  float best = INFINITY;
  int at = -1;  // packed position of the winner; increasing with the slot
  for (int base = 0; base < n_targets; base += kTile) {
    const int n = min(kTile, n_targets - base);
    __syncthreads();  // the last tile is read by every warp
    for (int i = threadIdx.x; i < n; i += kMatchThreads) {
      s_tgt[i] = l.targets[base + i];
    }
    __syncthreads();
    if (has) {
#pragma unroll 4
      for (int e = warp; e < n; e += kWarps) {
        const float4 t = s_tgt[e];
        const float dx = m.x - t.x, dy = m.y - t.y, dz = m.z - t.z;
        const float d2 = (dx * dx + dy * dy) + dz * dz;
        if (d2 < best) {
          best = d2;
          at = base + e;
        }
      }
    }
  }
  s_best[warp][lane] = best;
  s_at[warp][lane] = at;
  __syncthreads();
  if (warp != 0) return;
  // the least distance over the warps' winners, ties to the lowest slot
  for (int w = 1; w < kWarps; ++w) {
    const float b = s_best[w][lane];
    const int e = s_at[w][lane];
    if (e >= 0 && (at < 0 || b < best || (b == best && e < at))) {
      best = b;
      at = e;
    }
  }

  float c[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) c[i] = 0.0f;
  if (has) {
    const int j = at >= 0 ? __float_as_int(l.targets[at].w) : 0;
    const float3 q = load3(tgt_points, j);
    const float3 dq = sub3(m, q);
    const float d = sqrtf(dot3(dq, dq));
    if (d < max_dist) {
      c[kCount] = 1.0f;
      if (kKind == kResult) {
        c[kSq] = d * d;
      } else {
        const float3 nq = load3(tgt_normals, j);
        const float r_g = dot3(nq, dq);
        float a[6];
        if (kKind == kPointToPlane) {
          set_row(a, cross3(m, nq), nq, 1.0f);
          add_row(c, a, r_g);
          c[kSq] = r_g * r_g;
        } else {
          const float sqrt_lg = sqrtf(lambda);
          const float sqrt_lc = sqrtf(1.0f - lambda);
          set_row(a, cross3(m, nq), nq, sqrt_lg);
          add_row(c, a, r_g * sqrt_lg);
          const float3 g = load3(tgt_grads, j);
          // p' projected onto the tangent plane at q
          const float3 proj = sub3(m, scale3(nq, dot3(dq, nq)));
          const float c_proj = mean3(load3(tgt_colors, j)) +
                               dot3(g, sub3(proj, q));
          const float r_c = mean3(load3(src_colors, s)) - c_proj;
          // d r_c / d p' = -(g's tangential part)
          const float3 M = sub3(g, scale3(nq, dot3(g, nq)));
          const float3 neg = make_float3(-M.x, -M.y, -M.z);
          set_row(a, cross3(m, neg), neg, sqrt_lc);
          add_row(c, a, r_c * sqrt_lc);
          c[kSq] = r_g * r_g;
          c[kSqColor] = r_c * r_c;
        }
      }
    }
  }
  // the warp's sums by a fixed shuffle tree; lane 0 writes the block's
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    float v = c[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    c[i] = v;
  }
  if (lane == 0) {
    float* out = l.partials + (long long)blockIdx.x * kPartialWords;
#pragma unroll
    for (int i = 0; i < kSums; ++i) out[i] = c[i];
  }
}

// x = A^-1 b for the 6 x 6 A (row-major), by elimination with partial
// pivoting; A and b are overwritten
__device__ void solve6(double (&A)[36], double (&b)[6], double (&x)[6]) {
  for (int col = 0; col < 6; ++col) {
    int piv = col;
    for (int r = col + 1; r < 6; ++r) {
      if (fabs(A[6 * r + col]) > fabs(A[6 * piv + col])) piv = r;
    }
    if (piv != col) {
      for (int c = 0; c < 6; ++c) {
        const double t = A[6 * col + c];
        A[6 * col + c] = A[6 * piv + c];
        A[6 * piv + c] = t;
      }
      const double t = b[col];
      b[col] = b[piv];
      b[piv] = t;
    }
    for (int r = col + 1; r < 6; ++r) {
      const double f = A[6 * r + col] / A[6 * col + col];
      for (int c = col; c < 6; ++c) A[6 * r + c] -= f * A[6 * col + c];
      b[r] -= f * b[col];
    }
  }
  for (int r = 5; r >= 0; --r) {
    double v = b[r];
    for (int c = r + 1; c < 6; ++c) v -= A[6 * r + c] * x[c];
    x[r] = v / A[6 * r + r];
  }
}

template <int kKind>
__global__ void __launch_bounds__(kUpdateThreads) icp_update_kernel(
    float* __restrict__ buf, int n_src, int n_tgt, float lambda, float rel) {
  const Layout l = layout(buf, n_src, n_tgt);
  int* istate = reinterpret_cast<int*>(l.state);
  if (kKind != kResult && istate[kLive] == 0) return;
  const int n_sources = istate[kSources];
  const int blocks = (n_sources + kSourcesPerBlock - 1) / kSourcesPerBlock;
  constexpr int kGroups = kUpdateThreads / 32;
  __shared__ double s_part[kGroups][32];
  const int i = threadIdx.x & 31, g = threadIdx.x >> 5;
  // word i of the partials: group g sums blocks g, g + kGroups, ... in
  // turn, then thread i sums the groups in turn
  double acc = 0.0;
  if (i < kSums) {
    for (int b = g; b < blocks; b += kGroups) {
      acc += (double)l.partials[(long long)b * kPartialWords + i];
    }
  }
  s_part[g][i] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  double sum[kSums];
  for (int w = 0; w < kSums; ++w) {
    double v = 0.0;
    for (int h = 0; h < kGroups; ++h) v += s_part[h][w];
    sum[w] = v;
  }
  const float inliers = (float)sum[kCount];
  const float n_in = fmaxf(inliers, 1.0f);
  if (kKind == kResult) {
    l.state[kFitness] = inliers / fmaxf((float)n_sources, 1.0f);
    l.state[kInlierRmse] = sqrtf((float)sum[kSq] / n_in);
    return;
  }
  // the damped normal equations (J^T J + 1e-6 I) xi = -J^T r
  double A[36], b[6], xd[6];
  int k = 0;
  for (int r = 0; r < 6; ++r) {
    for (int c = r; c < 6; ++c) {
      A[6 * r + c] = A[6 * c + r] = sum[k++];
    }
    A[6 * r + r] += 1e-6;
    b[r] = -sum[kJtr + r];
  }
  solve6(A, b, xd);
  float xi[6];
  for (int r = 0; r < 6; ++r) xi[r] = (float)xd[r];
  // exp(xi): the rotation vector's quaternion, its matrix, and v
  const float angle = sqrtf((xi[0] * xi[0] + xi[1] * xi[1]) + xi[2] * xi[2]);
  const float half = 0.5f * angle;
  const float scale = angle < 1e-8f ? 0.5f + angle * angle / 48.0f
                                    : sinf(half) / fmaxf(angle, 1e-30f);
  const float x = xi[0] * scale, y = xi[1] * scale, z = xi[2] * scale;
  const float w = cosf(half);
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float E[12] = {
      1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy), xi[3],
      2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx), xi[4],
      2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy), xi[5]};
  float* T = l.state + kT;
  float Tn[12];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 4; ++c) {
      Tn[4 * r + c] = ((E[4 * r] * T[c] + E[4 * r + 1] * T[4 + c]) +
                       E[4 * r + 2] * T[8 + c]) + E[4 * r + 3] * T[12 + c];
    }
  }
  float rmse;
  if (kKind == kPointToPlane) {
    rmse = sqrtf((float)sum[kSq] / n_in);
  } else {
    rmse = sqrtf(((float)sum[kSq] * lambda +
                  (float)sum[kSqColor] * (1.0f - lambda)) / n_in);
  }
  // live holds here: the step is taken, and the stop test looks at it
  for (int r = 0; r < 12; ++r) T[r] = Tn[r];
  const float prev = l.state[kRmse];
  l.state[kPrev] = prev;
  l.state[kRmse] = rmse;
  istate[kIters] += 1;
  istate[kLive] = still_live(prev, rmse, rel) ? 1 : 0;
}

template <int kKind>
cudaError_t step(float* buf, const float* src_points, const float* src_colors,
                 const float* tgt_points, const float* tgt_normals,
                 const float* tgt_colors, const float* tgt_grads, int n_src,
                 int n_tgt, float max_dist, float lambda, float rel,
                 cudaStream_t stream) {
  const int blocks = (n_src + kSourcesPerBlock - 1) / kSourcesPerBlock;
  icp_match_kernel<kKind><<<blocks, kMatchThreads, 0, stream>>>(
      buf, src_points, src_colors, tgt_points, tgt_normals, tgt_colors,
      tgt_grads, n_src, n_tgt, max_dist, lambda);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  icp_update_kernel<kKind><<<1, kUpdateThreads, 0, stream>>>(
      buf, n_src, n_tgt, lambda, rel);
  return cudaGetLastError();
}

}  // namespace

extern "C" int icp_pack_launch(float* buf, const uint8_t* src_valid,
                               const float* tgt_points,
                               const uint8_t* tgt_valid, const float* T0,
                               int n_src, int n_tgt, float rel,
                               cudaStream_t stream) {
  if (n_src < 1 || n_tgt < 1) return (int)cudaErrorInvalidValue;
  icp_pack_kernel<<<1, kPackThreads, 0, stream>>>(
      buf, src_valid, tgt_points, tgt_valid, T0, n_src, n_tgt, rel);
  return (int)cudaGetLastError();
}

// kind 0: a point-to-plane step; 1: a colored step; 2: the result
extern "C" int icp_step_launch(int kind, float* buf, const float* src_points,
                               const float* src_colors,
                               const float* tgt_points,
                               const float* tgt_normals,
                               const float* tgt_colors,
                               const float* tgt_grads, int n_src, int n_tgt,
                               float max_dist, float lambda, float rel,
                               cudaStream_t stream) {
  if (n_src < 1 || n_tgt < 1) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case kPointToPlane:
      return (int)step<kPointToPlane>(
          buf, src_points, src_colors, tgt_points, tgt_normals, tgt_colors,
          tgt_grads, n_src, n_tgt, max_dist, lambda, rel, stream);
    case kColored:
      return (int)step<kColored>(
          buf, src_points, src_colors, tgt_points, tgt_normals, tgt_colors,
          tgt_grads, n_src, n_tgt, max_dist, lambda, rel, stream);
    case kResult:
      return (int)step<kResult>(
          buf, src_points, src_colors, tgt_points, tgt_normals, tgt_colors,
          tgt_grads, n_src, n_tgt, max_dist, lambda, rel, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
