// K3: batched greedy traceback walk over the (D, M, B) move codes of K2/K5.
// K10: the affine (Gotoh) walk over the move bytes of K7/K9.
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
// K10 replaces `walk_moves_affine` (parallel_genomeseq_tpu/ops/traceback.py
// :93-164), a `lax.fori_loop` too, with the same one-thread-per-lane design
// and the same per-step rule. Each lane carries a state, 0 = H, 1 = in an E
// (west gap) run, 2 = in an F (north gap) run. In H the op is the cell's H
// source (bits 0-1); in a run the op is the run and the H source is ignored.
// The walk stops only in the H state, on H_ZERO (3) or at i <= 0 or j <= 0,
// and the stopping cell emits nothing. NW emits (x, y), steps (i-1, j-1) and
// sets pos = j: pos is the j of the LAST NW emission, not where the walk
// stops. E emits ('-', y) and steps j-1, staying in the run while the cell's
// E-extend bit 3 is set; F emits (x, '-') and steps i-1 while bit 4 is set.
// Entering a run from H emits its first gap column in the same step, so
// every active step emits one column and row `it` of cx/cy is still the
// step's slot.
//
// What bounds both walks on the H100: one dependent gather from the moves
// plane per step and lane (a latency chain, not bandwidth); a walk is a few
// hundred steps, microseconds beside the sweep that feeds it.

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

__global__ void walk_moves_affine_kernel(const uint8_t* __restrict__ moves,
                                         const uint8_t* __restrict__ x_mb,
                                         const uint8_t* __restrict__ y_bn,
                                         const int32_t* __restrict__ i0,
                                         const int32_t* __restrict__ j0,
                                         int D, int M, int N, int B,
                                         int max_steps,
                                         int32_t* __restrict__ pos,
                                         uint8_t* __restrict__ cx,
                                         uint8_t* __restrict__ cy,
                                         int32_t* __restrict__ steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = i0[b];
  int j = j0[b];
  bool active = i > 0;
  int state = 0;  // 0 = H, 1 = E run, 2 = F run
  int p = 0;
  int count = 0;
  for (int it = 0; it < max_steps; ++it) {
    uint8_t ex = 0, ey = 0;
    if (active) {
      // Clipped as the JAX walk clips, so every read stays in bounds.
      const int d = clampi(i + j - 2, 0, D - 1);
      const int r = clampi(i - 1, 0, M - 1);
      const uint8_t mv = moves[((size_t)d * M + r) * B + b];
      const int hsrc = mv & 3;
      const int op = state == 0 ? hsrc : state;
      if (state == 0 && (hsrc == 3 || i <= 0 || j <= 0)) {
        active = false;
      } else {
        ex = op == 1 ? kGap : x_mb[(size_t)r * B + b];
        ey = op == 2 ? kGap : y_bn[(size_t)b * N + clampi(j - 1, 0, N - 1)];
        ++count;
        if (op == 0) {
          p = j;
          state = 0;
          --i;
          --j;
        } else if (op == 1) {
          state = (mv & 8) ? 1 : 0;
          --j;
        } else {
          state = (mv & 16) ? 2 : 0;
          --i;
        }
      }
    }
    cx[(size_t)it * B + b] = ex;
    cy[(size_t)it * B + b] = ey;
  }
  pos[b] = p;
  steps[b] = count;
}

}  // namespace

// Plain C entry points, bound with ctypes, one per walk (K3, K10). Device
// pointers to contiguous tensors: moves (D, M, B) uint8, x_mb (M, B) uint8,
// y_bn (B, N) uint8, i0/j0 (B,) int32; outputs pos/steps (B,) int32 and
// cx/cy (max_steps, B) uint8. Each returns cudaGetLastError() after the
// launch.
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

extern "C" int pgs_walk_moves_affine(const void* moves, const void* x_mb,
                                     const void* y_bn, const void* i0,
                                     const void* j0, int D, int M, int N,
                                     int B, int max_steps, void* pos, void* cx,
                                     void* cy, void* steps, void* stream) {
  if (B > 0) {
    walk_moves_affine_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(moves), static_cast<const uint8_t*>(x_mb),
        static_cast<const uint8_t*>(y_bn), static_cast<const int32_t*>(i0),
        static_cast<const int32_t*>(j0), D, M, N, B, max_steps,
        static_cast<int32_t*>(pos), static_cast<uint8_t*>(cx),
        static_cast<uint8_t*>(cy), static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
