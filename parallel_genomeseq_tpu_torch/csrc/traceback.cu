// K3: batched greedy traceback walk over the (D, M, B) move codes of K2.
//
// Not a Pallas kernel. It replaces the JAX `lax.fori_loop` of per-step
// gathers in parallel_genomeseq_tpu/ops/traceback.py `walk_moves` (:31), which
// in eager PyTorch would be about fifteen small launches per step and
// max_steps (~330 at 125 bp) steps per batch. Here one thread walks one lane
// from its argmax cell (i0, j0) with the same per-step rule:
//   code = moves[i + j - 2, i - 1, b]; stop if bit 4 is set (emit the cell's
//   read and reference chars, pos = j); else NW emits both chars and steps
//   (i-1, j-1), W emits ('-', y) and steps j-1, N emits (x, '-') and steps i-1.
// Iteration `it` writes row `it` of cx/cy (max_steps, B), NUL once the lane is
// done, so the buffers need no clearing and a warp's row stores coalesce.
// Lanes with i0 == 0 (all-zero matrix) stay inactive: pos = steps = 0.
//
// What bounds it on the H100: one dependent gather from the moves plane per
// step and lane (a latency chain, not bandwidth); the whole walk is a few
// hundred steps, microseconds beside the K2 sweep that feeds it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr uint8_t kGap = '-';

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void walk_moves_kernel(const uint8_t* __restrict__ moves,
                                  const uint8_t* __restrict__ x_mb,
                                  const uint8_t* __restrict__ y_bn,
                                  const int32_t* __restrict__ i0,
                                  const int32_t* __restrict__ j0,
                                  int D, int M, int N, int B, int max_steps,
                                  int32_t* __restrict__ pos,
                                  uint8_t* __restrict__ cx,
                                  uint8_t* __restrict__ cy,
                                  int32_t* __restrict__ steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = i0[b];
  int j = j0[b];
  bool active = i > 0;
  int p = 0;
  int count = 0;
  for (int it = 0; it < max_steps; ++it) {
    uint8_t ex = 0, ey = 0;
    if (active) {
      // Same clipping as the JAX walk; a walk inside its lane's matrix never
      // needs it, since it stops at the first cell with a zero neighbour,
      // and it keeps every read in bounds whatever i0 and j0 the caller
      // passes.
      const int d = clampi(i + j - 2, 0, D - 1);
      const int r = clampi(i - 1, 0, M - 1);
      const uint8_t mv = moves[((size_t)d * M + r) * B + b];
      const bool stop = (mv & 4) != 0;
      const int code = mv & 3;
      const bool go_w = code == 1 && !stop;
      const bool go_n = code == 2 && !stop;
      ex = go_w ? kGap : x_mb[(size_t)r * B + b];
      ey = go_n ? kGap : y_bn[(size_t)b * N + clampi(j - 1, 0, N - 1)];
      ++count;
      if (stop) {
        p = j;
        active = false;
      } else {
        i -= go_w ? 0 : 1;
        j -= go_n ? 0 : 1;
      }
    }
    cx[(size_t)it * B + b] = ex;
    cy[(size_t)it * B + b] = ey;
  }
  pos[b] = p;
  steps[b] = count;
}

}  // namespace

// Plain C entry point, bound with ctypes. Device pointers to contiguous
// tensors: moves (D, M, B) uint8, x_mb (M, B) uint8, y_bn (B, N) uint8, i0/j0
// (B,) int32; outputs pos/steps (B,) int32 and cx/cy (max_steps, B) uint8.
// Returns cudaGetLastError() after the launch.
extern "C" int pgs_walk_moves(const void* moves, const void* x_mb,
                              const void* y_bn, const void* i0, const void* j0,
                              int D, int M, int N, int B, int max_steps,
                              void* pos, void* cx, void* cy, void* steps,
                              void* stream) {
  if (B > 0) {
    walk_moves_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(moves), static_cast<const uint8_t*>(x_mb),
        static_cast<const uint8_t*>(y_bn), static_cast<const int32_t*>(i0),
        static_cast<const int32_t*>(j0), D, M, N, B, max_steps,
        static_cast<int32_t*>(pos), static_cast<uint8_t*>(cx),
        static_cast<uint8_t*>(cy), static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
