// Depth-sampling microprobe: sum LOOP rows of a small f32 window, shifted
// by s0, reading the rows in four ways.
//
// Replaces the TPU microprobe kernel of `_mk(kind)`
// (benchmarks/probe_sublane_ops.py:35), which asked which dynamic sublane
// alignment (roll, dynamic slice or per-row load) Mosaic prefers for K1's
// sampling window. The CUDA K1 has no window: it reads depth by address,
// from L2. The question on this card is whether staging the window in
// shared memory first pays, against reading each row from global memory.
// Every arm computes out[i, c] = sum over r < L, in order, of
// x[row(r), c], for the 8 rows i and the 128 columns c:
//
//   baseline    L = H rows 0..H-1, from global memory
//   smem_roll   the H x 128 window staged in shared memory, rows
//               (s0 + r) mod H, L = LOOP (the TPU's `roll`)
//   smem_slice  the window staged, rows min(s0, H - LOOP) + r, L = LOOP
//               (the clamp of `lax.dynamic_slice`, the TPU's `dynslice`)
//   rowload     each row straight from global memory at s0 + r, L = LOOP
//
// The grid is `grid` blocks of 128 threads, one column a thread, and every
// block writes the same output, as the TPU grid revisits one block. What
// bounds it: the 32 KB window stays in L1/L2, so each block is a chain of
// LOOP dependent loads and adds; the probe measures load latency from
// shared memory against global memory (L1/L2 hits).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;

enum Arm : int { kBaseline = 0, kSmemRoll = 1, kSmemSlice = 2, kRowload = 3 };

template <int A>
__global__ void __launch_bounds__(kCols) gather_probe_kernel(
    const float* __restrict__ x,  // (h, w)
    float* __restrict__ out,      // (8, 128)
    int h, int w, int loop, int s0) {
  extern __shared__ float win[];  // h x 128, the staged arms only
  const int c = threadIdx.x;
  if constexpr (A == kSmemRoll || A == kSmemSlice) {
    for (int r = 0; r < h; ++r) win[r * kCols + c] = x[(size_t)r * w + c];
    __syncthreads();
  }
  float acc = 0.0f;
  if constexpr (A == kBaseline) {
    for (int r = 0; r < h; ++r) acc = acc + x[(size_t)r * w + c];
  } else if constexpr (A == kSmemRoll) {
    for (int r = 0; r < loop; ++r) acc = acc + win[((s0 + r) % h) * kCols + c];
  } else if constexpr (A == kSmemSlice) {
    const int base = min(s0, h - loop);
    for (int r = 0; r < loop; ++r) acc = acc + win[(base + r) * kCols + c];
  } else {
    for (int r = 0; r < loop; ++r) acc = acc + x[(size_t)(s0 + r) * w + c];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i * kCols + c] = acc;
}

template <int A>
cudaError_t launch(const float* x, float* out, int h, int w, int loop,
                   int s0, int grid, size_t smem, cudaStream_t stream) {
  gather_probe_kernel<A><<<grid, kCols, smem, stream>>>(x, out, h, w, loop,
                                                        s0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gather_probe_launch(int arm, const float* x, float* out,
                                   int h, int w, int loop, int s0, int grid,
                                   cudaStream_t stream) {
  const size_t win = (size_t)h * kCols * sizeof(float);
  switch (arm) {
    case kBaseline:
      return (int)launch<kBaseline>(x, out, h, w, loop, s0, grid, 0, stream);
    case kSmemRoll:
      return (int)launch<kSmemRoll>(x, out, h, w, loop, s0, grid, win, stream);
    case kSmemSlice:
      return (int)launch<kSmemSlice>(x, out, h, w, loop, s0, grid, win,
                                     stream);
    case kRowload:
      return (int)launch<kRowload>(x, out, h, w, loop, s0, grid, 0, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
