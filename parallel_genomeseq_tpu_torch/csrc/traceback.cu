// K3: batched greedy traceback walk over the (D, M, B) move codes of K2/K5.
// K10: the affine (Gotoh) walk over the move bytes of K7/K9.
// K14: the walk through one row-strip of a long read (K13's moves).
// K18: the affine walk through one row-strip (K17's moves).
//
// Not a Pallas kernel. K3 replaces the JAX `lax.fori_loop` of per-step
// gathers in parallel_genomeseq_tpu/ops/traceback.py `walk_moves` (:31), which
// in eager PyTorch would be about fifteen small launches per step and
// max_steps (~330 at 125 bp) steps per batch. Each lane walks from its argmax
// cell (i0, j0) with the same per-step rule:
//   code = moves[i + j - 2, i - 1, b]; stop if bit 4 is set (emit the cell's
//   read and reference chars, pos = j); else NW emits both chars and steps
//   (i-1, j-1), W emits ('-', y) and steps j-1, N emits (x, '-') and steps i-1.
// Step `it` writes row `it` of cx/cy (max_steps, B), NUL once the lane is
// done, so the buffers need no clearing. Lanes with i0 == 0 (all-zero
// matrix) stay inactive: pos = steps = 0.
//
// K10 replaces `walk_moves_affine` (parallel_genomeseq_tpu/ops/traceback.py
// :93-164), a `lax.fori_loop` too, with the same per-step rule. Each lane
// carries a state, 0 = H, 1 = in an E (west gap) run, 2 = in an F (north gap)
// run. In H the op is the cell's H source (bits 0-1); in a run the op is the
// run and the H source is ignored. The walk stops only in the H state, on
// H_ZERO (3) or at i <= 0 or j <= 0, and the stopping cell emits nothing. NW
// emits (x, y), steps (i-1, j-1) and sets pos = j: pos is the j of the LAST
// NW emission, not where the walk stops. E emits ('-', y) and steps j-1,
// staying in the run while the cell's E-extend bit 3 is set; F emits (x, '-')
// and steps i-1 while bit 4 is set. Entering a run from H emits its first
// gap column in the same step, so every active step emits one column and row
// `it` of cx/cy is still the step's slot.
//
// K3 and K10 are one template, walk_band_kernel<kAffine>. What bounds them
// on the H100 is latency: a step's cell depends on the move byte read the
// step before, and a lane's bytes lie B apart in the (D, M, B) layout (lane
// innermost, as K2/K7/K5/K9 write it), so no tile of one lane is contiguous.
// A warp serves one lane. Each step lowers i, j or both, so the walk from a
// cell (i, j) only reaches cells (i - A, j - C) with A, C >= 0, and a read
// that matches walks near the diagonal A = C. The warp gathers the band
// |C - A| <= kBand of that diagonal, kSegRows rows (A) a segment: its move
// bytes (each its own sector), read and reference bytes, every index
// clamped as the JAX walk clamps it and every load issued before any is
// stored, into shared memory. Every thread of the warp then runs the same
// steps on the same bytes (walk_step, shared with K14/K18). While the walk
// is in one segment the next segment's loads are in flight, so a walk along
// the diagonal pays one round trip, at its start; where it leaves the band
// sideways (a net gap of more than kBand columns) the band is anchored anew
// at its cell, one round trip more. Emissions are kept in registers, step t
// of each 32 by thread t, and stored 32 at a time; once the lane is done the
// warp fills the rest of its cx/cy column with NUL, 32 rows at a time, so
// the kernel's time follows the lane's own walk and not max_steps. Lanes a
// block follow walk_lanes_per_block.
//
// K14 replaces `walk_strip_level` (parallel_genomeseq_tpu/ops/traceback.py
// :167-218), the JAX `fori_loop` that advances the walk through one row-strip
// of a long read's matrix: K3's rule over the moves of one strip (K13's
// layout, moves[b][j - 1][i - 1 - base]), with the lane's state (i, j, pos,
// active, steps, cx, cy) read and written back in place so that it carries
// from one strip to the next, top strip first. A lane walks while it is
// active and its row lies in the strip; the slot of an emission is the
// lane's step count (lanes progress unevenly), and an emission past
// max_steps is dropped while the count goes on, as traceback.py:206-209
// does. The JAX loop's fixed trip count (S + west_slack) and the rerun loop
// around it (wavefront_pallas.py:2746-2756) are TPU artefacts: this loop
// ends when the lane leaves the strip or stops. It is capped at S + N steps
// per strip, more than any walk inside the matrix takes there, so that a
// walk started outside a lane's matrix still ends.
//
// K18 replaces `walk_strip_level_affine` (parallel_genomeseq_tpu/ops/
// traceback.py:221-286), the affine form of that loop, with K10's state
// machine. The gap state (0 = H, 1 = E run, 2 = F run) is a (B,) int32
// plane of the carried state, so a run that crosses a strip edge -- an F
// run always does -- resumes in the next strip. A lane stops only in the H
// state, on H_ZERO or at j <= 0, and the stopping cell emits nothing; pos
// is the j of the last NW emission.
//
// K14 and K18 are one template, walk_strip_kernel<kAffine>, that walks a
// replay group: the G strips of K13/K17/K21/K24's (G, B, N, 256) buffer in
// one launch, strip G - 1 down to strip 0, each with its own S + N cap, so
// that the result equals G per-strip walks; the state is read once and
// written once. What bounds a walk on the H100 is latency: each step's cell
// depends on the move byte read the step before. A thread a lane paid a
// DRAM round trip for that byte (and its read and reference bytes) every
// step. Here a warp serves one lane: it stages a tile of kTileRows x
// kTileCols move bytes whose bottom-right corner is the walk's cell -- a
// tile column is 64 contiguous bytes of the (..., N, 256) layout, so the
// warp's 32 threads load the tile with 16-byte loads, every load issued
// before any is stored (one round trip), with the tile's reference bytes
// (contiguous) and read bytes (a strided gather) -- and the walk then reads
// its moves from shared memory, every thread of the warp running the same
// step on the same bytes and storing the same emission byte, so that no
// branch depends on the thread. Each step moves i or j or both, so a walk
// stays at least 49 steps in a tile (its rows start on a 16-byte boundary)
// and at most 127; the tile's emissions are staged in shared memory and
// stored at the tile's end. Of the shapes tools/walk_tiles.py times (32 x
// 32 to 128 x 128), 64 x 64 was the fastest for K14 and 6% behind 128 x
// 128 for K18, whose loads take twice the registers. The
// group replay writes only cells the walk can still reach: a tile holds
// stale bytes of earlier groups off the walk's path, never read, and no
// load leaves the strip's columns 0 .. N - 1 and rows 0 .. 255. Lanes a
// block follow walk_lanes_per_block; a walk outside the strip's rows, the
// read or the reference (one started outside its lane's matrix) steps from
// device memory, clamped as the per-strip walk clamps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint8_t kGap = '-';

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

constexpr int kStrip = 256;  // strip height of K13's moves
// K14/K18's staged tile: kTileRows x kTileCols move bytes whose bottom-right
// corner is the walk's cell, with the tile's read and reference bytes and
// its emissions (at most kTileRows + kTileCols - 1 steps stay in a tile).
// The shape is set here; tools/walk_tiles.py builds other shapes to time
// them (rows a multiple of kVec, at most kStrip).
#ifndef PGS_WALK_TILE_ROWS
#define PGS_WALK_TILE_ROWS 64
#endif
#ifndef PGS_WALK_TILE_COLS
#define PGS_WALK_TILE_COLS 64
#endif
constexpr int kTileRows = PGS_WALK_TILE_ROWS;
constexpr int kTileCols = PGS_WALK_TILE_COLS;
constexpr int kVec = 16;  // bytes of one vector load of a tile column
constexpr int kParts = kTileRows / kVec;           // vector loads a tile column
constexpr int kLoads = kTileCols * kParts / 32;   // vector loads a thread
static_assert(kTileRows % 32 == 0 && kTileRows <= kStrip && kTileCols % 32 == 0,
              "a tile's rows and columns are whole warps");
constexpr int kMaxLanesPerBlock = 4;

// The rule for lanes (warps) a block: one until every SM holds a lane, then
// up to kMaxLanesPerBlock, so that few lanes spread over as many SMs as
// there are lanes.
__host__ __device__ inline int walk_lanes_per_block(int B, int sms) {
  return max(1, min(kMaxLanesPerBlock, B / max(1, sms)));
}

struct __align__(16) WalkTile {
  uint8_t mv[kTileCols * kTileRows];  // mv[c * kTileRows + r], as K13 lays a column
  uint8_t x[kTileRows];               // the read byte of each tile row
  uint8_t y[kTileCols];               // the reference byte of each tile column
  uint8_t ex[kTileRows + kTileCols];  // staged emissions, one a step
  uint8_t ey[kTileRows + kTileCols];
};

// One step of the walks' rule on the move byte mv of the lane's cell, whose
// read and reference bytes are xb and yb (edge: the cell lies where the
// affine walk stops in the H state, K18's j <= 0, K10's i <= 0 or j <= 0).
// Returns false where the lane stops without emitting (K10/K18 in the H
// state, on H_ZERO or edge); else sets the step's emission (ex, ey), the
// rows and columns it moves (di, dj), whether the walk ends after it (K3/
// K14's stop bit: the stopping cell emits) and whether pos takes the cell's
// j (K3/K14's stop, K10/K18's NW).
template <bool kAffine>
__device__ __forceinline__ bool walk_step(int mv, uint8_t xb, uint8_t yb, bool edge,
                                          int& state, uint8_t& ex, uint8_t& ey, int& di,
                                          int& dj, bool& ends, bool& sets_pos) {
  if (kAffine) {
    const int hsrc = mv & 3;
    if (state == 0 && (hsrc == 3 || edge)) return false;
    const int op = state == 0 ? hsrc : state;  // in a run the op is the run
    ex = op == 1 ? kGap : xb;
    ey = op == 2 ? kGap : yb;
    di = op != 1;
    dj = op != 2;
    ends = false;
    sets_pos = op == 0;
    state = op == 0 ? 0 : op == 1 ? ((mv & 8) ? 1 : 0) : ((mv & 16) ? 2 : 0);
  } else {
    const bool stop = (mv & 4) != 0;
    const int code = mv & 3;
    ex = code == 1 && !stop ? kGap : xb;
    ey = code == 2 && !stop ? kGap : yb;
    di = !stop && code != 1;
    dj = !stop && code != 2;
    ends = sets_pos = stop;
  }
  return true;
}

// One warp walks one lane through strips base0 + (G - 1) * kStrip down to
// base0, top first, strip g's moves at moves + (g * B + b) * N * kStrip.
// Every thread of the warp runs the same serial walk on the same shared
// bytes (a broadcast read); the warp's 32 threads load a tile together and
// store its emissions together.
template <bool kAffine>
__global__ void walk_strip_kernel(const uint8_t* __restrict__ moves,
                                  const uint8_t* __restrict__ x_mb,
                                  const uint8_t* __restrict__ y_bn, int M,
                                  int N, int B, int G, int base0,
                                  int max_steps, int32_t* __restrict__ I,
                                  int32_t* __restrict__ J,
                                  int32_t* __restrict__ pos,
                                  uint8_t* __restrict__ active,
                                  int32_t* __restrict__ steps,
                                  int32_t* __restrict__ gstate,
                                  uint8_t* __restrict__ cx,
                                  uint8_t* __restrict__ cy) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  WalkTile& w = reinterpret_cast<WalkTile*>(smem)[warp];
  int i = I[b];
  int j = J[b];
  int p = pos[b];
  int count = steps[b];
  int state = kAffine ? gstate[b] : 0;  // 0 = H, 1 = E run, 2 = F run
  bool act = active[b] != 0;
  const int cap = kStrip + N;  // steps a strip, as the per-strip walk caps it
  for (int g = G - 1; g >= 0 && act; --g) {
    const int base = base0 + g * kStrip;
    const uint8_t* mvl = moves + ((size_t)g * B + b) * N * kStrip;
    int it = 0;
    while (act && i - 1 >= base && it < cap) {
      const int r = i - 1 - base;
      const int c = j - 1;
      // Inside the strip's rows, the read and the reference the walk reads
      // a staged tile; elsewhere (a walk started outside its lane's matrix)
      // it takes one step at a time from device memory, clamped as the
      // per-strip walk clamps.
      const bool fast = r < kStrip && i - 1 < M && c >= 0 && c < N;
      int r0 = 0, c0 = 0;  // the tile's first row and column in the strip
      if (fast) {
        r0 = max(0, (r - kTileRows + kVec) & ~(kVec - 1));
        c0 = max(0, c - kTileCols + 1);
        // Columns c0 .. c, rows r0 .. r0 + kTileRows - 1 (inside the
        // strip's 256; r0 is the first multiple of kVec past r -
        // kTileRows), with the tile's read and reference bytes: every load
        // issued before any is stored, so that the tile costs one round
        // trip. Bytes off the walk's path may be stale; it never reads them.
        uint4 mv[kLoads];
        uint8_t xv[kTileRows / 32], yv[kTileCols / 32];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int q = t + 32 * u;
          if (c0 + q / kParts <= c) {
            mv[u] = *reinterpret_cast<const uint4*>(
                mvl + (size_t)(c0 + q / kParts) * kStrip + r0 + (q % kParts) * kVec);
          }
        }
#pragma unroll
        for (int u = 0; u < kTileRows / 32; ++u) {
          if (base + r0 + t + 32 * u < M) xv[u] = x_mb[(size_t)(base + r0 + t + 32 * u) * B + b];
        }
#pragma unroll
        for (int u = 0; u < kTileCols / 32; ++u) {
          if (c0 + t + 32 * u <= c) yv[u] = y_bn[(size_t)b * N + c0 + t + 32 * u];
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (c0 + (t + 32 * u) / kParts <= c) reinterpret_cast<uint4*>(w.mv)[t + 32 * u] = mv[u];
        }
#pragma unroll
        for (int u = 0; u < kTileRows / 32; ++u) {
          if (base + r0 + t + 32 * u < M) w.x[t + 32 * u] = xv[u];
        }
#pragma unroll
        for (int u = 0; u < kTileCols / 32; ++u) {
          if (c0 + t + 32 * u <= c) w.y[t + 32 * u] = yv[u];
        }
        __syncwarp();
      }
      int k = 0;  // emissions staged in this tile
      uint8_t ex, ey;
      int di, dj;
      bool ends, sets_pos;
      if (fast) {
        // dr, dc: the cell's row and column in the tile; the walk stays
        // while both are >= 0, and at most the strip's cap.
        int dr = r - r0;
        int dc = c - c0;
        const int room = cap - it;
        for (;;) {
          if (!walk_step<kAffine>(w.mv[dc * kTileRows + dr], w.x[dr], w.y[dc], false, state,
                                  ex, ey, di, dj, ends, sets_pos)) {
            act = false;
            break;
          }
          if (sets_pos) p = c0 + dc + 1;
          // Every thread stores the same byte: no branch on the thread.
          w.ex[k] = ex;
          w.ey[k] = ey;
          ++k;
          dr -= di;
          dc -= dj;
          if (ends) act = false;
          if (ends || k == room || (dr | dc) < 0) break;
        }
        i = base + r0 + dr + 1;
        j = c0 + dc + 1;
      } else {
        const int cl = clampi(c, 0, N - 1);
        if (!walk_step<kAffine>(mvl[(size_t)cl * kStrip + clampi(r, 0, kStrip - 1)],
                                x_mb[(size_t)clampi(i - 1, 0, M - 1) * B + b],
                                y_bn[(size_t)b * N + cl], j <= 0, state, ex, ey, di, dj, ends,
                                sets_pos)) {
          act = false;
        } else {
          if (sets_pos) p = j;
          w.ex[0] = ex;
          w.ey[0] = ey;
          k = 1;
          i -= di;
          j -= dj;
          if (ends) act = false;
        }
      }
      const int count0 = count;
      count += k;
      it += k;
      // The tile's emissions to slots count0 .. count0 + k - 1 of cx/cy,
      // those past max_steps dropped.
      __syncwarp();
      for (int q = t; q < k; q += 32) {
        if (count0 + q < max_steps) {
          cx[(size_t)(count0 + q) * B + b] = w.ex[q];
          cy[(size_t)(count0 + q) * B + b] = w.ey[q];
        }
      }
      __syncwarp();  // before the next tile overwrites what was read
    }
  }
  if (t == 0) {
    I[b] = i;
    J[b] = j;
    pos[b] = p;
    steps[b] = count;
    if (kAffine) gstate[b] = state;
    active[b] = act ? 1 : 0;
  }
}

// K3/K10's band segment: the cells within kBand columns of the diagonal
// through the walk's anchor cell, kSegRows rows of it a segment. Set here;
// tools/walk_tiles.py builds other shapes to time them. Of 4-128 rows and
// bands of 1-3 (and a K x K box a round, no prefetch), 16 rows and a band
// of 1 took the least time at the short-read path's 512 lanes and the top
// 10 together.
#ifndef PGS_WALK_SEG_ROWS
#define PGS_WALK_SEG_ROWS 16
#endif
#ifndef PGS_WALK_BAND
#define PGS_WALK_BAND 1
#endif
constexpr int kSegRows = PGS_WALK_SEG_ROWS;
constexpr int kBand = PGS_WALK_BAND;
constexpr int kRowCells = 2 * kBand + 1;
constexpr int kSegCells = kSegRows * kRowCells;
constexpr int kSegCols = kSegRows + 2 * kBand;      // reference columns a segment spans
constexpr int kCellLoads = (kSegCells + 31) / 32;  // gathered move bytes a thread
constexpr int kRowLoads = (kSegRows + 31) / 32;    // read bytes a thread
constexpr int kColLoads = (kSegCols + 31) / 32;    // reference bytes a thread
static_assert(kSegRows >= 2 && kBand >= 1 && kCellLoads <= 32, "a segment is 32 loads a thread");

struct WalkSeg {
  uint8_t mv[kSegCells];  // mv[a * kRowCells + e + kBand]: cell (A0 + a, A0 + a + e)
  uint8_t x[kSegRows];    // the read byte of row a
  uint8_t y[kSegCols];    // the reference byte of column A0 + c - kBand
};

// A segment's bytes in flight: loaded into registers, stored to shared
// memory once the walk needs them.
struct SegLoads {
  uint8_t mv[kCellLoads], x[kRowLoads], y[kColLoads];
};

// Issue the loads of segment n of the band anchored at (I, J): cells (I - A,
// J - C) with A = n kSegRows + a, C = A + e, 0 <= a < kSegRows, |e| <=
// kBand, each index clamped as the JAX walk clamps it (so a walk started
// outside its lane's matrix reads what it always read).
__device__ __forceinline__ void seg_load(SegLoads& l, const uint8_t* __restrict__ moves,
                                         const uint8_t* __restrict__ x_mb,
                                         const uint8_t* __restrict__ y_bn, int D, int M,
                                         int N, int B, int b, int t, int I, int J, int n) {
  const int A0 = n * kSegRows;
#pragma unroll
  for (int u = 0; u < kCellLoads; ++u) {
    const int q = t + 32 * u;
    const int A = A0 + q / kRowCells;
    const int C = A + q % kRowCells - kBand;
    if (q < kSegCells) {
      const int d = clampi(I - A + J - C - 2, 0, D - 1);
      l.mv[u] = moves[((size_t)d * M + clampi(I - A - 1, 0, M - 1)) * B + b];
    }
  }
#pragma unroll
  for (int u = 0; u < kRowLoads; ++u) {
    const int a = t + 32 * u;
    if (a < kSegRows) l.x[u] = x_mb[(size_t)clampi(I - A0 - a - 1, 0, M - 1) * B + b];
  }
#pragma unroll
  for (int u = 0; u < kColLoads; ++u) {
    const int c = t + 32 * u;
    if (c < kSegCols) l.y[u] = y_bn[(size_t)b * N + clampi(J - A0 - c + kBand - 1, 0, N - 1)];
  }
}

__device__ __forceinline__ void seg_store(WalkSeg& s, const SegLoads& l, int t) {
#pragma unroll
  for (int u = 0; u < kCellLoads; ++u) {
    if (t + 32 * u < kSegCells) s.mv[t + 32 * u] = l.mv[u];
  }
#pragma unroll
  for (int u = 0; u < kRowLoads; ++u) {
    if (t + 32 * u < kSegRows) s.x[t + 32 * u] = l.x[u];
  }
#pragma unroll
  for (int u = 0; u < kColLoads; ++u) {
    if (t + 32 * u < kSegCols) s.y[t + 32 * u] = l.y[u];
  }
}

// One warp walks lane b of the (D, M, B) moves from (i0[b], j0[b]) (the
// file's header). The band is anchored at the walk's start cell, and
// again wherever the walk leaves it sideways (a gap run longer than kBand
// columns net). While the walk is in segment n, segment n + 1's loads are
// in flight, so that a walk along the diagonal waits for one round trip at
// each anchor only. Every thread runs the same serial walk on the same
// shared bytes and keeps step t's emission (of the 32 between stores) in
// registers; the warp's 32 threads store them together.
template <bool kAffine>
__global__ void walk_band_kernel(const uint8_t* __restrict__ moves,
                                 const uint8_t* __restrict__ x_mb,
                                 const uint8_t* __restrict__ y_bn,
                                 const int32_t* __restrict__ i0,
                                 const int32_t* __restrict__ j0, int D, int M, int N, int B,
                                 int max_steps, int32_t* __restrict__ pos,
                                 uint8_t* __restrict__ cx, uint8_t* __restrict__ cy,
                                 int32_t* __restrict__ steps) {
  __shared__ WalkSeg segs[kMaxLanesPerBlock][2];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  int i = i0[b];
  int j = j0[b];
  bool act = i > 0;
  int state = 0;  // 0 = H, 1 = E run, 2 = F run
  int p = 0;
  int count = 0;
  // (a, e): the walk's cell in the current segment, (I - A0 - a, J - A0 -
  // a - e) with A0 = n kSegRows; the walk stays in the segment while 0 <= a
  // < kSegRows and |e| <= kBand (a never falls, since no step raises i).
  int a = 0, e = 0, buf = 0;
  int I = i, J = j, n = 0;
  SegLoads next;
  bool anchor = true;
  while (act && count < max_steps) {
    if (anchor) {  // segment 0 at the walk's cell, one round trip; then segment 1
      I = i;
      J = j;
      n = a = e = 0;
      SegLoads first;
      seg_load(first, moves, x_mb, y_bn, D, M, N, B, b, t, I, J, 0);
      seg_load(next, moves, x_mb, y_bn, D, M, N, B, b, t, I, J, 1);
      seg_store(segs[warp][buf], first, t);
      __syncwarp();
      anchor = false;
    } else if (a == kSegRows) {  // on into segment n + 1, already loaded
      buf ^= 1;
      seg_store(segs[warp][buf], next, t);
      __syncwarp();
      ++n;
      a = 0;
      seg_load(next, moves, x_mb, y_bn, D, M, N, B, b, t, I, J, n + 1);
    }
    const WalkSeg& s = segs[warp][buf];
    // Up to 32 steps (one emission a thread) inside the segment.
    int k = 0;
    uint8_t ex_t = 0, ey_t = 0;
    const int room = min(32, max_steps - count);
    for (;;) {
      uint8_t ex, ey;
      int di, dj;
      bool ends, sets_pos;
      if (!walk_step<kAffine>(s.mv[a * kRowCells + e + kBand], s.x[a], s.y[a + e + kBand],
                              i <= 0 || j <= 0, state, ex, ey, di, dj, ends, sets_pos)) {
        act = false;
        break;
      }
      if (sets_pos) p = j;
      if (k == t) {
        ex_t = ex;
        ey_t = ey;
      }
      ++k;
      i -= di;
      j -= dj;
      a += di;
      e += dj - di;
      if (ends) act = false;
      if (ends || k == room || a == kSegRows || e > kBand || e < -kBand) break;
    }
    if (t < k) {
      cx[(size_t)(count + t) * B + b] = ex_t;
      cy[(size_t)(count + t) * B + b] = ey_t;
    }
    count += k;
    anchor = e > kBand || e < -kBand;
    __syncwarp();  // before a segment overwrites what was read
  }
  // The rest of the lane's column: NUL, 32 rows at a time.
  for (int r = count + t; r < max_steps; r += 32) {
    cx[(size_t)r * B + b] = 0;
    cy[(size_t)r * B + b] = 0;
  }
  if (t == 0) {
    pos[b] = p;
    steps[b] = count;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// The walks' launch shape for B lanes: out = (K14/K18's tile rows, tile
// columns, lanes a block, blocks, K14/K18's shared bytes a block, K3/K10's
// segment rows and band). Lanes a block and blocks are both templates'.
// Returns cudaGetLastError().
extern "C" int pgs_walk_shape(int B, int* out) {
  const int lanes = walk_lanes_per_block(B, sm_count());
  out[0] = kTileRows;
  out[1] = kTileCols;
  out[2] = lanes;
  out[3] = (B + lanes - 1) / lanes;
  out[4] = lanes * static_cast<int>(sizeof(WalkTile));
  out[5] = kSegRows;
  out[6] = kBand;
  return static_cast<int>(cudaGetLastError());
}

// K14's (gstate null) and K18's entry point: moves (G, B, N, 256) uint8,
// 16-byte aligned, strip g of the group starting at row base0 + g * 256;
// x_mb (M, B), y_bn (B, N) uint8; the state i, j, pos, steps (B,) int32,
// active (B,) bool, K18's gap state gstate (B,) int32 and cx, cy
// (max_steps, B) uint8, all updated in place, each lane walking strip G - 1
// down to strip 0. Returns cudaGetLastError() after the launch.
extern "C" int pgs_walk_strip_group(const void* moves, const void* x_mb,
                                    const void* y_bn, int M, int N, int B,
                                    int G, int base0, int max_steps, void* i,
                                    void* j, void* pos, void* active,
                                    void* steps, void* gstate, void* cx,
                                    void* cy, void* stream) {
  if (B > 0 && G > 0) {
    const int lanes = walk_lanes_per_block(B, sm_count());
    const int blocks = (B + lanes - 1) / lanes;
    const size_t smem = lanes * sizeof(WalkTile);
    auto kernel = gstate ? walk_strip_kernel<true> : walk_strip_kernel<false>;
    kernel<<<blocks, lanes * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(moves), static_cast<const uint8_t*>(x_mb),
        static_cast<const uint8_t*>(y_bn), M, N, B, G, base0, max_steps,
        static_cast<int32_t*>(i), static_cast<int32_t*>(j),
        static_cast<int32_t*>(pos), static_cast<uint8_t*>(active),
        static_cast<int32_t*>(steps), static_cast<int32_t*>(gstate),
        static_cast<uint8_t*>(cx), static_cast<uint8_t*>(cy));
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <bool kAffine>
int launch_walk_band(const void* moves, const void* x_mb, const void* y_bn, const void* i0,
                    const void* j0, int D, int M, int N, int B, int max_steps, void* pos,
                    void* cx, void* cy, void* steps, void* stream) {
  if (B > 0) {
    const int lanes = walk_lanes_per_block(B, sm_count());
    walk_band_kernel<kAffine><<<(B + lanes - 1) / lanes, lanes * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(moves), static_cast<const uint8_t*>(x_mb),
        static_cast<const uint8_t*>(y_bn), static_cast<const int32_t*>(i0),
        static_cast<const int32_t*>(j0), D, M, N, B, max_steps, static_cast<int32_t*>(pos),
        static_cast<uint8_t*>(cx), static_cast<uint8_t*>(cy), static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch_walk_band<false>(moves, x_mb, y_bn, i0, j0, D, M, N, B, max_steps, pos, cx, cy,
                                steps, stream);
}

extern "C" int pgs_walk_moves_affine(const void* moves, const void* x_mb,
                                     const void* y_bn, const void* i0,
                                     const void* j0, int D, int M, int N,
                                     int B, int max_steps, void* pos, void* cx,
                                     void* cy, void* steps, void* stream) {
  return launch_walk_band<true>(moves, x_mb, y_bn, i0, j0, D, M, N, B, max_steps, pos, cx, cy,
                               steps, stream);
}
