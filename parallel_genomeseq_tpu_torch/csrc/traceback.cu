// K3: batched greedy traceback walk over the (D, M, B) move codes of K2/K5.
// K10: the affine (Gotoh) walk over the move bytes of K7/K9.
// K14: the walk through one row-strip of a long read (K13's moves).
// K18: the affine walk through one row-strip (K17's moves).
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
// K14 replaces `walk_strip_level` (parallel_genomeseq_tpu/ops/traceback.py
// :167-218), the JAX `fori_loop` that advances the walk through one row-strip
// of a long read's matrix: K3's rule, one thread per lane, over the moves of
// one strip (K13's (B, N, 256) layout, moves[b][j - 1][i - 1 - base]), with
// the lane's state (i, j, pos, active, steps, cx, cy) read and written back
// in place so that it carries from one strip to the next, top strip first.
// A lane walks while it is active and its row lies in the strip; the slot of
// an emission is the lane's step count (lanes progress unevenly), and an
// emission past max_steps is dropped while the count goes on, as
// traceback.py:206-209 does. The JAX loop's fixed trip count (S + west_slack)
// and the rerun loop around it (wavefront_pallas.py:2746-2756) are TPU
// artefacts: this loop ends when the lane leaves the strip or stops. It is
// capped at S + N steps per strip, more than any walk inside the matrix takes
// there, so that a walk started outside a lane's matrix still ends.
//
// K18 replaces `walk_strip_level_affine` (parallel_genomeseq_tpu/ops/
// traceback.py:221-286), the affine form of that loop: K14's shape (one
// thread per lane over one strip's (B, N, 256) bytes, the state read and
// written back in place, no fixed trip count, capped at S + N steps) with
// K10's state machine. The gap state (0 = H, 1 = E run, 2 = F run) is a
// (B,) int32 plane of the carried state, so a run that crosses a strip edge
// -- an F run always does -- resumes in the next strip. A lane stops only in
// the H state, on H_ZERO or at j <= 0, and the stopping cell emits nothing;
// pos is the j of the last NW emission.
//
// What bounds the walks on the H100: one dependent gather from the moves
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

constexpr int kStrip = 256;  // strip height of K13's moves

__global__ void walk_strip_kernel(const uint8_t* __restrict__ moves,
                                  const uint8_t* __restrict__ x_mb,
                                  const uint8_t* __restrict__ y_bn, int M,
                                  int N, int B, int base, int max_steps,
                                  int32_t* __restrict__ I,
                                  int32_t* __restrict__ J,
                                  int32_t* __restrict__ pos,
                                  uint8_t* __restrict__ active,
                                  int32_t* __restrict__ steps,
                                  uint8_t* __restrict__ cx,
                                  uint8_t* __restrict__ cy) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = I[b];
  int j = J[b];
  int p = pos[b];
  int count = steps[b];
  bool act = active[b] != 0;
  const uint8_t* mvl = moves + (size_t)b * N * kStrip;
  for (int it = 0; act && i - 1 >= base && it < kStrip + N; ++it) {
    const int r = clampi(i - 1 - base, 0, kStrip - 1);
    const int c = clampi(j - 1, 0, N - 1);
    const uint8_t mv = mvl[(size_t)c * kStrip + r];
    const bool stop = (mv & 4) != 0;
    const int code = mv & 3;
    const bool go_w = code == 1 && !stop;
    const bool go_n = code == 2 && !stop;
    if (count < max_steps) {
      cx[(size_t)count * B + b] = go_w ? kGap : x_mb[(size_t)clampi(i - 1, 0, M - 1) * B + b];
      cy[(size_t)count * B + b] = go_n ? kGap : y_bn[(size_t)b * N + c];
    }
    ++count;
    if (stop) {
      p = j;
      act = false;
    } else {
      i -= go_w ? 0 : 1;
      j -= go_n ? 0 : 1;
    }
  }
  I[b] = i;
  J[b] = j;
  pos[b] = p;
  steps[b] = count;
  active[b] = act ? 1 : 0;
}

__global__ void walk_strip_affine_kernel(const uint8_t* __restrict__ moves,
                                         const uint8_t* __restrict__ x_mb,
                                         const uint8_t* __restrict__ y_bn,
                                         int M, int N, int B, int base,
                                         int max_steps, int32_t* __restrict__ I,
                                         int32_t* __restrict__ J,
                                         int32_t* __restrict__ pos,
                                         uint8_t* __restrict__ active,
                                         int32_t* __restrict__ steps,
                                         int32_t* __restrict__ gstate,
                                         uint8_t* __restrict__ cx,
                                         uint8_t* __restrict__ cy) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = I[b];
  int j = J[b];
  int p = pos[b];
  int count = steps[b];
  int state = gstate[b];  // 0 = H, 1 = E run, 2 = F run
  bool act = active[b] != 0;
  const uint8_t* mvl = moves + (size_t)b * N * kStrip;
  for (int it = 0; act && i - 1 >= base && it < kStrip + N; ++it) {
    const int c = clampi(j - 1, 0, N - 1);
    const uint8_t mv = mvl[(size_t)c * kStrip + clampi(i - 1 - base, 0, kStrip - 1)];
    const int hsrc = mv & 3;
    if (state == 0 && (hsrc == 3 || j <= 0)) {
      act = false;
      break;
    }
    const int op = state == 0 ? hsrc : state;  // in a run the op is the run
    if (count < max_steps) {
      cx[(size_t)count * B + b] = op == 1 ? kGap : x_mb[(size_t)clampi(i - 1, 0, M - 1) * B + b];
      cy[(size_t)count * B + b] = op == 2 ? kGap : y_bn[(size_t)b * N + c];
    }
    ++count;
    if (op == 0) {
      p = j;
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
  I[b] = i;
  J[b] = j;
  pos[b] = p;
  steps[b] = count;
  gstate[b] = state;
  active[b] = act ? 1 : 0;
}

}  // namespace

// K18's entry point: K14's arguments and the gap state gstate (B,) int32,
// also updated in place. Returns cudaGetLastError() after the launch.
extern "C" int pgs_walk_strip_affine(const void* moves, const void* x_mb,
                                     const void* y_bn, int M, int N, int B,
                                     int base, int max_steps, void* i, void* j,
                                     void* pos, void* active, void* steps,
                                     void* gstate, void* cx, void* cy,
                                     void* stream) {
  if (B > 0) {
    walk_strip_affine_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(moves), static_cast<const uint8_t*>(x_mb),
        static_cast<const uint8_t*>(y_bn), M, N, B, base, max_steps,
        static_cast<int32_t*>(i), static_cast<int32_t*>(j),
        static_cast<int32_t*>(pos), static_cast<uint8_t*>(active),
        static_cast<int32_t*>(steps), static_cast<int32_t*>(gstate),
        static_cast<uint8_t*>(cx), static_cast<uint8_t*>(cy));
  }
  return static_cast<int>(cudaGetLastError());
}

// K14's entry point: moves (B, N, 256) uint8, x_mb (M, B), y_bn (B, N) uint8,
// base the strip's first row; the state i, j, pos, steps (B,) int32, active
// (B,) bool and cx, cy (max_steps, B) uint8 are updated in place. Returns
// cudaGetLastError() after the launch.
extern "C" int pgs_walk_strip(const void* moves, const void* x_mb,
                              const void* y_bn, int M, int N, int B, int base,
                              int max_steps, void* i, void* j, void* pos,
                              void* active, void* steps, void* cx, void* cy,
                              void* stream) {
  if (B > 0) {
    walk_strip_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(moves), static_cast<const uint8_t*>(x_mb),
        static_cast<const uint8_t*>(y_bn), M, N, B, base, max_steps,
        static_cast<int32_t*>(i), static_cast<int32_t*>(j),
        static_cast<int32_t*>(pos), static_cast<uint8_t*>(active),
        static_cast<int32_t*>(steps), static_cast<uint8_t*>(cx),
        static_cast<uint8_t*>(cy));
  }
  return static_cast<int>(cudaGetLastError());
}

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
