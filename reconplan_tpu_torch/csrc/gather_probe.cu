// Depth-sampling microprobe: sum LOOP rows of a small f32 window, shifted
// by s0, reading the rows in four ways, `steps` times over.
//
// Replaces the TPU microprobe kernel of `_mk(kind)`
// (benchmarks/probe_sublane_ops.py:35), which asked which dynamic sublane
// alignment (roll, dynamic slice or per-row load) Mosaic prefers for K1's
// sampling window. The CUDA K1 has no window: it reads depth by address,
// from L2. The question on this card is whether a window staged in shared
// memory is faster to read than the same rows read from global memory
// through L1. Every arm computes, in each step, out[i, c] = sum over r < L,
// in order, of x[row(r), c], for the 8 rows i and the 128 columns c:
//
//   baseline    L = H rows 0..H-1, from global memory
//   smem_roll   the H x 128 window staged in shared memory, rows
//               (s0 + r) mod H, L = LOOP (the TPU's `roll`)
//   smem_slice  the window staged, rows min(s0, H - LOOP) + r, L = LOOP
//               (the clamp of `lax.dynamic_slice`, the TPU's `dynslice`)
//   rowload     each row straight from global memory at s0 + r, L = LOOP
//
// What bounds it: latency. The window is 16 KB and one step is L loads and
// L dependent adds on 128 columns, so the whole probe is less than one wave
// of work for the card; its time is the launch, the first touch of the
// window, each block's chain of steps (90-130 ns a step on an H100, below)
// and the stores of the output.
//
// Design. The TPU probe holds x and the output in VMEM across its 2,048
// grid steps, which run one after another: the window comes in once and
// the output goes back once. Here a block of 128 threads (one column a
// thread) walks its share of the steps, block b the steps b, b + blocks,
// ...; the grid is the card's SMs times kBlocksPerSM (at most what the
// occupancy query allows, at most `steps`). The staged arms copy the window
// to shared memory once a block with 16-byte cp.async copies; the other
// arms read global memory, which misses L1 in a block's first step and
// hits it from then on. H, W and LOOP are template parameters, so the row
// loop is fully unrolled: a step issues its L loads, then adds them in
// order, one at a time (the order is the result).
//
// The output is stored once a block, after its last step. Every block
// holds the same (8, 128) values, and block b stores one of the 8 rows,
// row b mod 8 (with fewer than 8 blocks, every row i with i mod blocks =
// b). Stores by many blocks to one address queue up in L2: with each block
// storing all 8 rows the time grew by 5-7 ns a block (14 us at 2,048
// blocks, 4.6-4.9 us at the best grid, 132-198 blocks), and with one row
// a block the best grid is 4 blocks an SM at 3.2-3.7 us (NVIDIA H100 80GB
// HBM3, 700 W; CUDA graphs of 20 launches).
//
// Every step really runs. A step's loads take their address from the step
// before: the address offset is the bits of the last sum AND-ed with
// `zero`, a kernel argument that is 0 at run time and unknown at compile
// time. So the compiler can neither hoist the loads out of the step loop
// nor drop a step whose sum is not stored, the loads of step n + 1 wait
// for the sum of step n, and the value is unchanged. chip_smoke.py shows
// it: the SASS of each kernel holds the L loads and L adds, and the device
// time grows with the step count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;
// blocks of kCols threads an SM: the probe is shorter than one wave, so
// more blocks mean fewer steps each, but more copies of the window and
// more stores to the same rows of the output
constexpr int kBlocksPerSM = 4;

enum Arm : int { kBaseline = 0, kSmemRoll = 1, kSmemSlice = 2, kRowload = 3 };

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(gmem));
}

template <int A, int kH, int kW, int kLoop>
__global__ void __launch_bounds__(kCols) gather_probe_kernel(
    const float* __restrict__ x,  // (kH, kW), 16-byte aligned
    float* __restrict__ out,      // (8, 128)
    int s0, int steps, int zero) {
  constexpr bool kStaged = A == kSmemRoll || A == kSmemSlice;
  constexpr int kL = A == kBaseline ? kH : kLoop;
  // the staged arms' window, kH x 128
  __shared__ __align__(16) float win[kStaged ? kH * kCols : 4];
  const int c = threadIdx.x;
  if constexpr (kStaged) {
    // 16 bytes a thread: 32 threads a row, kCols / 32 rows a pass
    constexpr int kRowsPerPass = kCols / 32;
    const int r0 = c >> 5;
    const int c4 = (c & 31) * 4;
#pragma unroll
    for (int r = 0; r < kH; r += kRowsPerPass) {
      cp_async16(win + (r + r0) * kCols + c4, x + (size_t)(r + r0) * kW + c4);
    }
    asm volatile("cp.async.commit_group;" ::);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }

  // this thread's column of the arm's row 0
  const float* base;
  int first = 0;  // smem_roll: the first row
  if constexpr (A == kBaseline) {
    base = x + c;
  } else if constexpr (A == kSmemRoll) {
    base = win + c;
    first = s0;
  } else if constexpr (A == kSmemSlice) {
    base = win + min(s0, kH - kLoop) * kCols + c;
  } else {
    base = x + (size_t)s0 * kW + c;
  }
  constexpr int kStride = kStaged ? kCols : kW;

  float acc = 0.0f;
  int off = 0;  // always 0: the bits of the last sum & zero
  for (int step = blockIdx.x; step < steps; step += gridDim.x) {
    const float* p = base + off;
    float v[kL];
#pragma unroll
    for (int r = 0; r < kL; ++r) {
      if constexpr (A == kSmemRoll) {
        v[r] = p[((first + r) & (kH - 1)) * kStride];
      } else {
        v[r] = p[r * kStride];
      }
    }
    acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kL; ++r) acc = acc + v[r];
    off = __float_as_int(acc) & zero;
  }
  // this block's rows of the output: i mod min(blocks, 8) = b mod the same
  const int sharers = min((int)gridDim.x, 8);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i % sharers == (int)blockIdx.x % sharers) out[i * kCols + c] = acc;
  }
}

// the probe's one shape (H, W, LOOP of ops/kernels/gather_probe.py)
constexpr int kProbeH = 32, kProbeW = 256, kProbeLoop = 24;
static_assert((kProbeH & (kProbeH - 1)) == 0,
              "smem_roll wraps rows with a mask");

template <int A>
cudaError_t occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, gather_probe_kernel<A, kProbeH, kProbeW, kProbeLoop>,
      kCols, 0);
}

template <int A>
cudaError_t launch(const float* x, float* out, int s0, int steps, int blocks,
                   cudaStream_t stream) {
  gather_probe_kernel<A, kProbeH, kProbeW, kProbeLoop>
      <<<blocks, kCols, 0, stream>>>(x, out, s0, steps, /*zero=*/0);
  return cudaGetLastError();
}

}  // namespace

// The most blocks an SM holds of the arm's kernel, and the blocks an SM
// the probe's grid takes (the smaller of that and kBlocksPerSM).
extern "C" int gather_probe_occupancy(int arm, int* max_blocks_per_sm,
                                      int* blocks_per_sm) {
  cudaError_t err;
  switch (arm) {
    case kBaseline: err = occupancy<kBaseline>(max_blocks_per_sm); break;
    case kSmemRoll: err = occupancy<kSmemRoll>(max_blocks_per_sm); break;
    case kSmemSlice: err = occupancy<kSmemSlice>(max_blocks_per_sm); break;
    case kRowload: err = occupancy<kRowload>(max_blocks_per_sm); break;
    default: return (int)cudaErrorInvalidValue;
  }
  *blocks_per_sm =
      *max_blocks_per_sm < kBlocksPerSM ? *max_blocks_per_sm : kBlocksPerSM;
  return (int)err;
}

// `steps` is the probe's step count (the TPU probe's grid); `blocks` the
// CUDA grid that shares them out.
extern "C" int gather_probe_launch(int arm, const float* x, float* out,
                                   int h, int w, int loop, int s0, int steps,
                                   int blocks, cudaStream_t stream) {
  if (h != kProbeH || w != kProbeW || loop != kProbeLoop || steps <= 0 ||
      blocks <= 0 || blocks > steps || ((uintptr_t)x & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (arm) {
    case kBaseline:
      return (int)launch<kBaseline>(x, out, s0, steps, blocks, stream);
    case kSmemRoll:
      return (int)launch<kSmemRoll>(x, out, s0, steps, blocks, stream);
    case kSmemSlice:
      return (int)launch<kSmemSlice>(x, out, s0, steps, blocks, stream);
    case kRowload:
      return (int)launch<kRowload>(x, out, s0, steps, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
