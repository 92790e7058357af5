// Long-read (strip) Smith-Waterman kernels for Hopper (sm_90a): uniform
// match/mismatch scoring, linear gaps, exact int32 values, reads of any
// length.
//
// K11 `strip_sweep_kernel<false>` replaces the Pallas TPU kernel B9,
//     parallel_genomeseq_tpu/ops/wavefront_pallas.py `_kernel_strips`
//     (:1073, body `_strips_body` :1197) via `_call_strips` (:1347): per-lane
//     best score and its cell, the column-major tie-break of
//     `_reduce_best_strips` (:2188-2207).
// K12 `strip_sweep_kernel<true>` replaces B13, `_kernel_strips_ckpt` (:1134)
//     via `_call_strips_ckpt` (:1550): K11 plus the H values of every strip's
//     last row (rows kS - 1, S = 256), the checkpoints the strip traceback
//     replays from.
// K13 `strip_moves_kernel` replaces B17, `_kernel_strip_moves` (:1792) via
//     `_call_strip_moves` (:1840): one strip's S rows recomputed from its
//     incoming checkpoint row, emitting the linear move byte of :1825-1831
//     for every cell.
//
// Design of K11/K12. One thread block per lane. Its T threads split the
// lane's rows into bands of kBand = 32 consecutive rows, one band per thread,
// and sweep the reference as a pipeline: at step s, thread t works on column
// j = s - t + 1, so band t + 1 takes column j one step after band t has
// finished it. The band's last-row H reaches the next thread through a
// double-buffered word in shared memory, with one __syncthreads per step.
// This is B9's strip and `lastrow` structure run in parallel instead of in
// sequence. The band's column of H lives in registers (32 int32, and the 32
// read bytes), not in shared or device memory: nothing but the 4-byte hand-off
// leaves the thread per column. A block takes at most kMaxThreads x kBand =
// 16,384 rows at once; longer reads run in passes, the last band of a pass
// leaving its row in a device-memory row (B, N + 1) that the first band of
// the next pass reads, in place (a read of column j always precedes the
// write of column j).
//
// Exactness: rows past the lane's m_b hold H = 0 and columns past n_b are not
// swept, so every value equals the plain full-matrix sweep's. Ties: each
// thread keeps the first maximum of its own cells in (j, i) order (a later
// pass takes a strictly smaller j only), and the block reduces the threads'
// bests by max score, then min j, then min i. An all-zero lane gives
// (0, 0, 0).
//
// Design of K13. One warp per lane: 32 threads x 8 rows cover the strip's
// 256 rows, pipelined along the reference as above, the hand-off by
// __shfl_up_sync (no barrier). Row 0's north and north-west come from the
// checkpoint row (zeros for strip 0). A thread packs its 8 move bytes of a
// column into one 8-byte store into the lane-major (B, N, S) moves layout
// (moves[b][j - 1][r]) that the strip walk reads.
//
// What bounds them on the H100: the integer ALU (about 7 operations per cell
// for K11/K12, 14 for K13) and, per column and thread, one barrier (K11/K12)
// or shuffle (K13) and one read of the reference byte. K13 at the winner
// re-run's shape is one warp per lane, so it is latency-bound: the north
// chain down the 8 rows of a band.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 32;         // rows per thread, K11/K12
constexpr int kMaxThreads = 512;  // threads per block, K11/K12
constexpr int kStrip = 256;       // strip height S (checkpoints, K13)
constexpr int kReplayBand = kStrip / 32;  // rows per thread, K13

// (v1, j1, i1) before (v2, j2, i2): higher score, then smaller j, then i.
__device__ __forceinline__ bool better(int v1, int j1, int i1, int v2, int j2,
                                       int i2) {
  return v1 > v2 || (v1 == v2 && (j1 < j2 || (j1 == j2 && i1 < i2)));
}

// One column of a band: H(i, j) for its rows, north-west `nw` = H(row0, j-1)
// and north `north` = H(row0, j) (1-based row0 = the row above the band);
// h holds H(., j - 1) on entry and H(., j) on return. Rows k >= nvalid are
// outside the lane's matrix and hold 0 (kFull: all rows valid).
template <bool kFull, int kRows>
__device__ __forceinline__ int band_column(int (&h)[kRows],
                                           const uint8_t (&xb)[kRows],
                                           uint8_t yc, int match, int mismatch,
                                           int gap, int nvalid, int nw,
                                           int north) {
  int diag = nw;
  int colmax = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int west = h[k];
    int v = max(max(diag + (xb[k] == yc ? match : mismatch),
                    max(west, north) - gap), 0);
    if (!kFull) v = k < nvalid ? v : 0;
    diag = west;
    h[k] = v;
    north = v;
    colmax = max(colmax, v);
  }
  return colmax;
}

// K11 (kCkpt = false) and K12 (kCkpt = true). x (B, M) and y (B, N) uint8
// lane-major; bound (B, N + 1) int32 scratch, used when passes > 1; ck
// (B, nck, N) int32 zero-filled by the caller, ck[b][c][j - 1] = H((c + 1) *
// kStrip, j) (1-based rows).
template <bool kCkpt>
__global__ void __launch_bounds__(kMaxThreads)
strip_sweep_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                   const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                   int M, int N, int match, int mismatch, int gap, int passes,
                   int32_t* __restrict__ bound, int32_t* __restrict__ ck,
                   int nck, int32_t* __restrict__ score,
                   int32_t* __restrict__ best_i, int32_t* __restrict__ best_j) {
  __shared__ int xfer[2][kMaxThreads];
  __shared__ int red[3][kMaxThreads / 32];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int mb = min(m[b], M);
  const int nb = min(n[b], N);
  const uint8_t* xl = x + (size_t)b * M;
  const uint8_t* yl = y + (size_t)b * N;
  int32_t* bl = bound ? bound + (size_t)b * (N + 1) : nullptr;
  int best = 0, bi = 0, bj = 0;
  for (int p = 0; p < passes; ++p) {
    const int row0 = (p * T + t) * kBand;  // 0-based first row of the band
    const int nvalid = min(max(mb - row0, 0), kBand);
    uint8_t xb[kBand];
    int h[kBand];
#pragma unroll
    for (int k = 0; k < kBand; ++k) {
      xb[k] = row0 + k < M ? xl[row0 + k] : 0;
      h[k] = 0;
    }
    // The band's last row closes strip c when (row0 + kBand) % kStrip == 0.
    const int c = (row0 + kBand) / kStrip - 1;
    const bool writes_ck = kCkpt && (row0 + kBand) % kStrip == 0 && c < nck;
    const bool writes_bound = p + 1 < passes && t == T - 1;
    int nw = 0;  // H(row0, j - 1): the previous column's north input
    __syncthreads();  // the previous pass's bound row is complete
    for (int s = 0; s < nb + T - 1; ++s) {
      const int j = s - t + 1;
      if (j >= 1 && j <= nb) {
        const int north = t > 0 ? xfer[(s - 1) & 1][t - 1] : (p > 0 ? bl[j] : 0);
        const uint8_t yc = yl[j - 1];
        int colmax = 0;
        if (nvalid == kBand) {
          colmax = band_column<true>(h, xb, yc, match, mismatch, gap, kBand, nw, north);
        } else if (nvalid > 0) {
          colmax = band_column<false>(h, xb, yc, match, mismatch, gap, nvalid, nw, north);
        }
        if (colmax > best || (colmax == best && colmax > 0 && j < bj)) {
          int kk = 0;
#pragma unroll
          for (int k = kBand - 1; k >= 0; --k) kk = h[k] == colmax ? k : kk;
          best = colmax;
          bj = j;
          bi = row0 + kk + 1;
        }
        const int last = h[kBand - 1];
        xfer[s & 1][t] = last;
        if (writes_ck) ck[((size_t)b * nck + c) * N + (j - 1)] = last;
        if (writes_bound) bl[j] = last;
        nw = north;
      }
      __syncthreads();
    }
  }
  // Block reduction of (best, bj, bi): a warp by shuffles, then the warps.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int v2 = __shfl_down_sync(0xffffffffu, best, off);
    const int j2 = __shfl_down_sync(0xffffffffu, bj, off);
    const int i2 = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(v2, j2, i2, best, bj, bi)) {
      best = v2;
      bj = j2;
      bi = i2;
    }
  }
  if ((t & 31) == 0) {
    red[0][t >> 5] = best;
    red[1][t >> 5] = bj;
    red[2][t >> 5] = bi;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < (T + 31) / 32; ++w) {
      if (better(red[0][w], red[1][w], red[2][w], best, bj, bi)) {
        best = red[0][w];
        bj = red[1][w];
        bi = red[2][w];
      }
    }
    score[b] = best;
    best_i[b] = best > 0 ? bi : 0;
    best_j[b] = best > 0 ? bj : 0;
  }
}

// K13: one warp per lane. x (B, M) uint8 with the strip at rows [base, base +
// kStrip); rowin (B, .) int32 with lane stride ld_row, rowin[b][j - 1] = H(base,
// j), or null for strip 0; moves (B, N, kStrip) uint8.
__global__ void __launch_bounds__(32)
strip_moves_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                   const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                   int M, int N, int base, const int32_t* __restrict__ rowin,
                   long long ld_row, int match, int mismatch, int gap,
                   uint8_t* __restrict__ moves) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nb = min(n[b], N);
  const int row0 = t * kReplayBand;  // strip-local first row of the band
  const int nvalid = min(max(min(m[b], M) - base - row0, 0), kReplayBand);
  const uint8_t* xl = x + (size_t)b * M;
  const int32_t* rl = rowin ? rowin + (size_t)b * ld_row : nullptr;
  uint8_t xb[kReplayBand];
  int h[kReplayBand];
#pragma unroll
  for (int k = 0; k < kReplayBand; ++k) {
    const int r = base + row0 + k;
    xb[k] = r < M ? xl[r] : 1;  // X_PAD past the read
    h[k] = 0;
  }
  uint8_t* out = moves + (size_t)b * N * kStrip + row0;
  int nw = 0;     // H(row0, j - 1)
  int carry = 0;  // this band's last-row H of the column it finished last
  for (int s = 0; s < nb + 31; ++s) {
    const int up = __shfl_up_sync(0xffffffffu, carry, 1);
    const int j = s - t + 1;
    if (j >= 1 && j <= nb) {
      const int north_in = t > 0 ? up : (rl ? rl[j - 1] : 0);
      const uint8_t yc = y[(size_t)b * N + j - 1];
      int diag = nw, north = north_in;
      uint32_t code[2] = {0u, 0u};
#pragma unroll
      for (int k = 0; k < kReplayBand; ++k) {
        const int west = h[k];
        // Move code over the neighbours (nw, west, north): NW if nw >= west
        // and nw >= north, else W if west >= both, else N; bit 2 (stop) when
        // any of them is 0.
        uint32_t mv = (diag >= west && diag >= north) ? 0u
                      : (west >= diag && west >= north) ? 1u : 2u;
        if (diag == 0 || west == 0 || north == 0) mv |= 4u;
        int v = max(max(diag + (xb[k] == yc ? match : mismatch),
                        max(west, north) - gap), 0);
        v = k < nvalid ? v : 0;
        code[k >> 2] |= mv << (8 * (k & 3));
        diag = west;
        h[k] = v;
        north = v;
      }
      *reinterpret_cast<uint2*>(out + (size_t)(j - 1) * kStrip) =
          make_uint2(code[0], code[1]);
      carry = h[kReplayBand - 1];
      nw = north_in;
    }
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. Device pointers to contiguous
// tensors. pgs_strip_sweep: x (B, M), y (B, N) uint8, m, n (B,) int32, bound
// (B, N + 1) int32 scratch, or null when one pass covers M (M <= kMaxThreads x
// kBand = 16,384, ROWS_PER_PASS in ops/strips_cuda.py), ck (B, nck, N)
// int32 zero-filled or null (K11), score/best_i/best_j (B,) int32. Returns
// cudaGetLastError() after the launch.
extern "C" int pgs_strip_sweep(const void* x, const void* y, const void* m,
                               const void* n, int M, int N, int B, int match,
                               int mismatch, int gap, void* bound, void* ck,
                               int nck, void* score, void* best_i, void* best_j,
                               void* stream) {
  if (B > 0) {
    const int bands = (M + kBand - 1) / kBand;
    const int threads = min(kMaxThreads, max(32, (bands + 31) / 32 * 32));
    const int passes = (bands + threads - 1) / threads;
    auto kernel = ck ? &strip_sweep_kernel<true> : &strip_sweep_kernel<false>;
    kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y),
        static_cast<const int32_t*>(m), static_cast<const int32_t*>(n), M, N,
        match, mismatch, gap, passes, static_cast<int32_t*>(bound),
        static_cast<int32_t*>(ck), nck, static_cast<int32_t*>(score),
        static_cast<int32_t*>(best_i), static_cast<int32_t*>(best_j));
  }
  return static_cast<int>(cudaGetLastError());
}

// pgs_strip_moves: x (B, M), y (B, N) uint8, m, n (B,) int32, base the
// strip's first row (a multiple of 256), rowin with lane stride ld_row or
// null, moves (B, N, 256) uint8 (columns past a lane's n_b not written).
extern "C" int pgs_strip_moves(const void* x, const void* y, const void* m,
                               const void* n, int M, int N, int B, int base,
                               const void* rowin, long long ld_row, int match,
                               int mismatch, int gap, void* moves,
                               void* stream) {
  if (B > 0) {
    strip_moves_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y),
        static_cast<const int32_t*>(m), static_cast<const int32_t*>(n), M, N,
        base, static_cast<const int32_t*>(rowin), ld_row, match, mismatch, gap,
        static_cast<uint8_t*>(moves));
  }
  return static_cast<int>(cudaGetLastError());
}
