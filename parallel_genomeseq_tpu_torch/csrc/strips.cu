// Long-read (strip) Smith-Waterman kernels for Hopper (sm_90a): uniform
// match/mismatch scoring or a substitution matrix, each with linear or
// affine (Gotoh) gaps; exact int32 values, reads of any length.
//
// K11 `strip_sweep_kernel<false, false, false>` replaces the Pallas TPU kernel B9,
//     parallel_genomeseq_tpu/ops/wavefront_pallas.py `_kernel_strips`
//     (:1073, body `_strips_body` :1197) via `_call_strips` (:1347): per-lane
//     best score and its cell, the column-major tie-break of
//     `_reduce_best_strips` (:2188-2207).
// K12 `strip_sweep_kernel<true, false, false>` replaces B13, `_kernel_strips_ckpt`
//     (:1134) via `_call_strips_ckpt` (:1550): K11 plus the H values of every
//     strip's last row (rows kS - 1, S = 256), the checkpoints the strip
//     traceback replays from.
// K13 `strip_moves_kernel<false, false>` replaces B17, `_kernel_strip_moves` (:1792)
//     via `_call_strip_moves` (:1840): one strip's S rows recomputed from its
//     incoming checkpoint row, emitting the linear move byte of :1825-1831
//     for every cell.
// K15 `strip_sweep_kernel<false, true, false>` replaces B10, `_kernel_strips_affine`
//     (:1102, the affine branch of `_strips_body` :1226, :1268-1276) via
//     `_call_strips_affine` (:1389): K11 under the Gotoh recurrence
//     E = max(H_west - open, E_west) - extend, F = max(H_north - open,
//     F_north) - extend, H = max(diag + s, E, F, 0).
// K16 `strip_sweep_kernel<true, true, false>` replaces B14,
//     `_kernel_strips_affine_ckpt` (:1147) via `_call_strips_affine_ckpt`
//     (:1595): K15 plus the H and the F of every strip's last row.
// K17 `strip_moves_kernel<true, false>` replaces B18, `_kernel_strip_affine_moves`
//     (:1870-1947) via `_call_strip_affine_moves` (:1953): one strip replayed
//     from its incoming H and F rows, emitting the affine byte (H source
//     ZERO > NW > E > F in bits 0-1, E extend bit 3, F extend bit 4).
// K19 `strip_sweep_kernel<false, false, true>` replaces B11,
//     `_kernel_strips_profile` (:1081, body `_strips_body` :1197) via
//     `_call_strips_profile` (:1434): K11 with the cell score read from an
//     (ncodes, ncodes) int32 table over compact codes, in two forms: per-lane
//     x (B, M) and y (B, N), or B11's `shared=True` slab scan -- one query
//     shared by every lane (x lane stride 0), each lane's entry read from a
//     flat resident slab through its 64-bit offset (the protein database
//     scan for queries over 2,048 aa, `score_db_slab_strips_jit` :2344).
// K20 `strip_sweep_kernel<true, false, true>` replaces B15,
//     `_kernel_strips_profile_ckpt` (:1642) via `_call_strips_profile_ckpt`
//     (:1679): K19 plus each strip's last-row H, K12's int32 checkpoints (the
//     TPU's int16 hi/lo row pairs are not ported).
// K21 `strip_moves_kernel<false, true>` replaces B19,
//     `_kernel_strip_profile_moves` (:1986) via `_call_strip_profile_moves`
//     (:2036): K13's replay and move byte with the table's cell score.
// K22 `strip_sweep_kernel<false, true, true>` replaces B12,
//     `_kernel_strips_profile_affine` (:1116) via `_call_strips_profile_affine`
//     (:1493): K15's Gotoh sweep with the table's cell score, in K19's two
//     forms -- per lane, or B12's `shared=True` slab scan (the protein
//     database scan for queries over 2,048 aa under affine gaps,
//     `score_db_slab_strips_jit` :2363-2367). B12 sweeps 128-row strips
//     (STRIP_S_PA); no result here depends on the strip height.
// K23 `strip_sweep_kernel<true, true, true>` replaces B16,
//     `_kernel_strips_profile_affine_ckpt` (:1657) via
//     `_call_strips_profile_affine_ckpt` (:1734): K22 plus each 256-row
//     strip's last-row H and F, K16's int32 planes (not B16's four int16
//     hi/lo planes of 128-row strips).
// K24 `strip_moves_kernel<true, true>` replaces B20,
//     `_kernel_strip_profile_affine_moves` (:2070) via
//     `_call_strip_profile_affine_moves` (:2149): K17's replay and affine
//     byte with the table's cell score.
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
// Design of K15/K16, the same pipeline: E runs along a row, so each thread
// keeps its band's E column in registers beside H (32 more int32) and E never
// leaves the thread; F runs down the rows like the north H, so the hand-off
// between bands, the between-pass bound row and the checkpoints carry the
// pair (H, F) -- an int2 in shared memory, (B, N + 1) int2 in device memory,
// and a second (B, K, N) int32 plane of F beside K16's H checkpoints. The
// extra 32 registers would spill under K11's 512-thread bound (128 registers
// a thread), so the affine blocks take at most kMaxThreadsAffine = 384
// threads (168 registers): 12,288 rows a pass, which still covers a 10,000-bp
// read in one. DPX folds E and F (`__viaddmax_s32`) and H with its zero
// (`__viaddmax_s32_relu`). Boundaries are the port's full sweep's
// (ops/scan_dp.wavefront_affine): E = -2^30 in column 0, F = 0 above row 1,
// and H = 0, E = F = -2^30 on rows past the lane's m_b, so every value,
// the F checkpoints included, equals the plain sweep's.
//
// Exactness: rows past the lane's m_b hold H = 0 and columns past n_b are not
// swept, so every value equals the plain full-matrix sweep's. Ties: each
// thread keeps the first maximum of its own cells in (j, i) order (a later
// pass takes a strictly smaller j only), and the block reduces the threads'
// bests by max score, then min j, then min i. An all-zero lane gives
// (0, 0, 0).
//
// Design of K13 and K17. One warp per lane: 32 threads x 8 rows cover the
// strip's 256 rows, pipelined along the reference as above, the hand-off by
// __shfl_up_sync (no barrier; K17 hands off H and F with two). Row 0's north
// and north-west come from the checkpoint row (zeros for strip 0; K17's F
// from the F row, 0 for strip 0). A thread packs its 8 move bytes of a
// column into one 8-byte store into the lane-major (B, N, S) moves layout
// (moves[b][j - 1][r]) that the strip walk reads. K17 keeps its 8 rows' E in
// registers, from -2^30 in column 0 as the full sweep does, so its bytes
// equal the full sweep's on every cell of the lane's matrix.
//
// Design of K19-K21, and of K22-K24 (the same over K15-K17): K11-K13 with
// the score of a cell read from the table, copied into shared memory
// transposed as K4 does (csrc/profile.cu, tab[yc * ncodes + xc]), so each
// column takes its row pointer tab + yc * ncodes once and each cell is one
// shared load at row[xb[k]]; a code >= ncodes reads as code 0, the matrix
// minimum. In the slab form a lane's
// length is clamped to the bytes the slab holds past its offset, as K4
// clamps it, and the between-pass bound row of lane b (queries over 16,384
// aa) starts at bound_off[b], an exclusive prefix sum of the lanes' n_b + 1
// that the wrapper computes, so the row takes one int32 per slab residue
// and lane, not the lanes times the longest entry (K22: an (H, F) int2 pair
// a residue, bound_off then counting int2 units).
//
// What bounds them on the H100: the integer ALU (about 7 operations per cell
// for K11/K12, 12 for K13, 10 for K15/K16, 20 for K17, 5 for K19/K20, 10 for
// K21, 8 for K22/K23, 18 for K24) and, per column and thread, one barrier
// (the sweeps) or shuffle (the replays) and one read of the reference byte.
// The replays at the winner re-run's shape are one warp per lane, so they
// are latency-bound: the north chain down the 8 rows of a band. K19 on the slab is one block
// per entry, so a block spends n_b + T - 1 steps, a barrier each, on n_b
// columns of work: the pipeline's fill and drain weigh on short entries.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 32;               // rows per thread, K11/K12/K15/K16
constexpr int kMaxThreads = 512;        // threads per block, K11/K12
constexpr int kMaxThreadsAffine = 384;  // threads per block, K15/K16/K22/K23
constexpr int kStrip = 256;             // strip height S (checkpoints, K13)
constexpr int kReplayBand = kStrip / 32;  // rows per thread, K13/K17
constexpr int kNeg = -(1 << 30);        // E and F where no gap run can reach

// The thread cap of a sweep: the affine forms keep E beside H in registers.
__host__ __device__ constexpr int max_threads(bool affine) {
  return affine ? kMaxThreadsAffine : kMaxThreads;
}

// (v1, j1, i1) before (v2, j2, i2): higher score, then smaller j, then i.
__device__ __forceinline__ bool better(int v1, int j1, int i1, int v2, int j2,
                                       int i2) {
  return v1 > v2 || (v1 == v2 && (j1 < j2 || (j1 == j2 && i1 < i2)));
}

// The score of cell (x byte or code xc, y byte or code yc): uniform
// match/mismatch, or (kProfile) the word xc of the column's table row.
template <bool kProfile>
__device__ __forceinline__ int cell_score(uint8_t xc, uint8_t yc, const int32_t* row,
                                          int match, int mismatch) {
  if constexpr (kProfile) {
    return row[xc];
  } else {
    return xc == yc ? match : mismatch;
  }
}

// A code >= ncodes reads as code 0 (the matrix minimum), as in K4.
__device__ __forceinline__ uint8_t clamp_code(uint8_t c, int ncodes) {
  return c < ncodes ? c : 0;
}

// Copy the (ncodes, ncodes) table into shared memory transposed:
// tab[yc * ncodes + xc] = table[xc][yc]. The caller synchronises.
__device__ __forceinline__ void load_table(int32_t* tab, const int32_t* __restrict__ table,
                                           int ncodes) {
  for (int k = threadIdx.x; k < ncodes * ncodes; k += blockDim.x) {
    tab[(k % ncodes) * ncodes + k / ncodes] = table[k];
  }
}

// One column of a band: H(i, j) for its rows, north-west `nw` = H(row0, j-1)
// and north `north` = H(row0, j) (1-based row0 = the row above the band);
// h holds H(., j - 1) on entry and H(., j) on return. Rows k >= nvalid are
// outside the lane's matrix and hold 0 (kFull: all rows valid). The cell
// score is cell_score<kProfile>(xb[k], yc, row, ...).
template <bool kFull, bool kProfile, int kRows>
__device__ __forceinline__ int band_column(int (&h)[kRows],
                                           const uint8_t (&xb)[kRows],
                                           uint8_t yc, const int32_t* row,
                                           int match, int mismatch,
                                           int gap, int nvalid, int nw,
                                           int north) {
  int diag = nw;
  int colmax = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int west = h[k];
    int v = max(max(diag + cell_score<kProfile>(xb[k], yc, row, match, mismatch),
                    max(west, north) - gap), 0);
    if (!kFull) v = k < nvalid ? v : 0;
    diag = west;
    h[k] = v;
    north = v;
    colmax = max(colmax, v);
  }
  return colmax;
}

// The affine form of band_column: h and e hold H(., j - 1) and E(., j - 1)
// on entry and H(., j), E(., j) on return; f is F(row0, j) on entry and F of
// the band's last row on return. Rows k >= nvalid hold H = 0, E = F = kNeg.
template <bool kFull, bool kProfile, int kRows>
__device__ __forceinline__ int band_column_affine(int (&h)[kRows], int (&e)[kRows],
                                                  const uint8_t (&xb)[kRows],
                                                  uint8_t yc, const int32_t* row,
                                                  int match, int mismatch,
                                                  int gap_open, int gap, int nvalid,
                                                  int nw, int north, int& f) {
  int diag = nw;
  int colmax = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int west = h[k];
    int ek = __viaddmax_s32(west, -gap_open, e[k]) - gap;
    f = __viaddmax_s32(north, -gap_open, f) - gap;
    int v = __viaddmax_s32_relu(diag, cell_score<kProfile>(xb[k], yc, row, match, mismatch),
                                max(ek, f));
    if (!kFull && k >= nvalid) {
      v = 0;
      ek = kNeg;
      f = kNeg;
    }
    diag = west;
    h[k] = v;
    e[k] = ek;
    north = v;
    colmax = max(colmax, v);
  }
  return colmax;
}

// K11 (kCkpt = false) and K12 (kCkpt = true), with kAffine K15 and K16,
// with kProfile K19 and K20, with both K22 and K23. x: lane b's read at x +
// b * x_lane, uint8 bytes (codes when kProfile; x_lane = 0 shares one query
// between lanes); y: lane b's reference at y + b * N, or at y + y_off[b]
// when y_off is given (a flat slab of y_len bytes; n_b is then clamped to
// the bytes past the offset).
// bound: scratch of the hand-off type (int32, or int2 (H, F) when affine),
// lane b's row at bound_off[b] if given, else b * (N + 1); used when passes
// > 1. ck (B, nck, N) int32 zero-filled by the caller, ck[b][c][j - 1] =
// H((c + 1) * kStrip, j) (1-based rows); fck the same shape, filled with
// kNeg by the caller, fck[b][c][j - 1] = F((c + 1) * kStrip, j) (K16 and
// K23 only). table (ncodes, ncodes) int32 over compact codes (kProfile
// only; dynamic shared memory of ncodes^2 int32).
template <bool kCkpt, bool kAffine, bool kProfile>
__global__ void __launch_bounds__(max_threads(kAffine))
strip_sweep_kernel(const uint8_t* __restrict__ x, long long x_lane,
                   const uint8_t* __restrict__ y, const int64_t* __restrict__ y_off,
                   long long y_len, const int32_t* __restrict__ m,
                   const int32_t* __restrict__ n, int M, int N,
                   const int32_t* __restrict__ table, int ncodes, int match,
                   int mismatch, int gap_open, int gap, int passes,
                   void* __restrict__ bound, const int64_t* __restrict__ bound_off,
                   int32_t* __restrict__ ck, int32_t* __restrict__ fck, int nck,
                   int32_t* __restrict__ score, int32_t* __restrict__ best_i,
                   int32_t* __restrict__ best_j) {
  using Carry = std::conditional_t<kAffine, int2, int>;  // hand-off: H, or (H, F)
  constexpr int kThreads = max_threads(kAffine);
  __shared__ Carry xfer[2][kThreads];
  __shared__ int red[3][kThreads / 32];
  extern __shared__ int32_t tab[];  // kProfile: tab[yc * ncodes + xc]
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  if constexpr (kProfile) load_table(tab, table, ncodes);
  const int mb = min(m[b], M);
  int nb = min(n[b], N);
  long long off = (long long)b * N;
  if (y_off) {
    off = y_off[b];
    if (off < 0 || off > y_len) {
      nb = 0;
    } else if ((long long)nb > y_len - off) {
      nb = (int)(y_len - off);
    }
  }
  const uint8_t* xl = x + (size_t)b * x_lane;
  const uint8_t* yl = y + off;
  Carry* bl = bound ? static_cast<Carry*>(bound) +
                          (bound_off ? (size_t)bound_off[b] : (size_t)b * (N + 1))
                    : nullptr;
  int best = 0, bi = 0, bj = 0;
  for (int p = 0; p < passes; ++p) {
    const int row0 = (p * T + t) * kBand;  // 0-based first row of the band
    const int nvalid = min(max(mb - row0, 0), kBand);
    uint8_t xb[kBand];
    int h[kBand];
    int e[kBand];  // affine only: E(., j - 1), kNeg in column 0
#pragma unroll
    for (int k = 0; k < kBand; ++k) {
      xb[k] = row0 + k < M ? xl[row0 + k] : 0;
      if (kProfile) xb[k] = clamp_code(xb[k], ncodes);
      h[k] = 0;
      e[k] = kNeg;
    }
    // The band's last row closes strip c when (row0 + kBand) % kStrip == 0.
    const int c = (row0 + kBand) / kStrip - 1;
    const bool writes_ck = kCkpt && (row0 + kBand) % kStrip == 0 && c < nck;
    const bool writes_bound = p + 1 < passes && t == T - 1;
    int nw = 0;  // H(row0, j - 1): the previous column's north input
    __syncthreads();  // the previous pass's bound row (and the table) is complete
    for (int s = 0; s < nb + T - 1; ++s) {
      const int j = s - t + 1;
      if (j >= 1 && j <= nb) {
        // Row 0's north: H = 0 and (affine) F = 0 above the first pass.
        const Carry in = t > 0 ? xfer[(s - 1) & 1][t - 1] : (p > 0 ? bl[j] : Carry{});
        uint8_t yc = yl[j - 1];
        const int32_t* row = nullptr;  // kProfile: the column's table row
        if constexpr (kProfile) {
          yc = clamp_code(yc, ncodes);
          row = tab + yc * ncodes;
        }
        int colmax = 0;
        int north;
        Carry last;
        if constexpr (kAffine) {
          north = in.x;
          int f = in.y;
          if (nvalid == kBand) {
            colmax = band_column_affine<true, kProfile>(h, e, xb, yc, row, match, mismatch,
                                                        gap_open, gap, kBand, nw, north, f);
          } else if (nvalid > 0) {
            colmax = band_column_affine<false, kProfile>(h, e, xb, yc, row, match, mismatch,
                                                         gap_open, gap, nvalid, nw, north, f);
          } else {
            f = kNeg;  // a band wholly past m_b
          }
          last = make_int2(h[kBand - 1], f);
        } else {
          north = in;
          if (nvalid == kBand) {
            colmax = band_column<true, kProfile>(h, xb, yc, row, match, mismatch, gap, kBand,
                                                 nw, north);
          } else if (nvalid > 0) {
            colmax = band_column<false, kProfile>(h, xb, yc, row, match, mismatch, gap,
                                                  nvalid, nw, north);
          }
          last = h[kBand - 1];
        }
        if (colmax > best || (colmax == best && colmax > 0 && j < bj)) {
          int kk = 0;
#pragma unroll
          for (int k = kBand - 1; k >= 0; --k) kk = h[k] == colmax ? k : kk;
          best = colmax;
          bj = j;
          bi = row0 + kk + 1;
        }
        xfer[s & 1][t] = last;
        if (writes_ck) {
          const size_t at = ((size_t)b * nck + c) * N + (j - 1);
          if constexpr (kAffine) {
            ck[at] = last.x;
            fck[at] = last.y;
          } else {
            ck[at] = last;
          }
        }
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

// K13 (kAffine = false) and K17 (kAffine = true), and with kProfile K21 and
// K24: one warp per lane. x (B, M) uint8 (codes when kProfile) with the strip at rows
// [base, base + kStrip); rowin (B, .) int32 with lane stride ld_row,
// rowin[b][j - 1] = H(base, j), or null for strip 0; frowin (K17) the same
// for F(base, j), beside rowin with its stride; moves (B, N, kStrip) uint8;
// table (ncodes, ncodes) int32 (K21 and K24; dynamic shared memory).
template <bool kAffine, bool kProfile>
__global__ void __launch_bounds__(32)
strip_moves_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                   const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                   int M, int N, int base, const int32_t* __restrict__ rowin,
                   const int32_t* __restrict__ frowin, long long ld_row,
                   const int32_t* __restrict__ table, int ncodes, int match,
                   int mismatch, int gap_open, int gap, uint8_t* __restrict__ moves) {
  extern __shared__ int32_t tab[];  // kProfile: tab[yc * ncodes + xc]
  if constexpr (kProfile) {
    load_table(tab, table, ncodes);
    __syncwarp();
  }
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nb = min(n[b], N);
  const int row0 = t * kReplayBand;  // strip-local first row of the band
  const int nvalid = min(max(min(m[b], M) - base - row0, 0), kReplayBand);
  const uint8_t* xl = x + (size_t)b * M;
  const int32_t* rl = rowin ? rowin + (size_t)b * ld_row : nullptr;
  const int32_t* fl = frowin ? frowin + (size_t)b * ld_row : nullptr;
  uint8_t xb[kReplayBand];
  int h[kReplayBand];
  int e[kReplayBand];  // affine: E(., j - 1), kNeg in column 0
#pragma unroll
  for (int k = 0; k < kReplayBand; ++k) {
    const int r = base + row0 + k;
    xb[k] = r < M ? xl[r] : (kProfile ? 0 : 1);  // code 0, or X_PAD, past the read
    if (kProfile) xb[k] = clamp_code(xb[k], ncodes);
    h[k] = 0;
    e[k] = kNeg;
  }
  uint8_t* out = moves + (size_t)b * N * kStrip + row0;
  int nw = 0;      // H(row0, j - 1)
  int carry = 0;   // this band's last-row H of the column it finished last
  int fcarry = 0;  // affine: the same row's F
  for (int s = 0; s < nb + 31; ++s) {
    const int up = __shfl_up_sync(0xffffffffu, carry, 1);
    const int fup = kAffine ? __shfl_up_sync(0xffffffffu, fcarry, 1) : 0;
    const int j = s - t + 1;
    if (j >= 1 && j <= nb) {
      const int north_in = t > 0 ? up : (rl ? rl[j - 1] : 0);
      uint8_t yc = y[(size_t)b * N + j - 1];
      const int32_t* row = nullptr;  // kProfile: the column's table row
      if constexpr (kProfile) {
        yc = clamp_code(yc, ncodes);
        row = tab + yc * ncodes;
      }
      int diag = nw, north = north_in;
      int f = t > 0 ? fup : (fl ? fl[j - 1] : 0);  // affine: F(row0, j), 0 above row 1
      uint32_t code[2] = {0u, 0u};
#pragma unroll
      for (int k = 0; k < kReplayBand; ++k) {
        const int west = h[k];
        const int s_xy = cell_score<kProfile>(xb[k], yc, row, match, mismatch);
        uint32_t mv;
        int v;
        if constexpr (kAffine) {
          // The byte of ops/scan_dp.wavefront_affine: H's source by equality
          // in the order ZERO, NW, E, F; the extend bits where the run's
          // value reaches the opening one.
          const int e_open = west - gap_open;
          const int f_open = north - gap_open;
          int ek = max(e_open, e[k]) - gap;
          const int fk = max(f_open, f) - gap;
          const int nwv = diag + s_xy;
          v = max(max(nwv, ek), max(fk, 0));
          mv = v == 0 ? 3u : v == nwv ? 0u : v == ek ? 1u : 2u;
          if (e[k] >= e_open) mv |= 8u;
          if (f >= f_open) mv |= 16u;
          f = fk;
          if (k >= nvalid) {
            v = 0;
            ek = kNeg;
            f = kNeg;
          }
          e[k] = ek;
        } else {
          // Move code over the neighbours (nw, west, north): NW if nw >= west
          // and nw >= north, else W if west >= both, else N; bit 2 (stop)
          // when any of them is 0.
          mv = (diag >= west && diag >= north) ? 0u
               : (west >= diag && west >= north) ? 1u : 2u;
          if (diag == 0 || west == 0 || north == 0) mv |= 4u;
          v = max(max(diag + s_xy, max(west, north) - gap), 0);
          v = k < nvalid ? v : 0;
        }
        code[k >> 2] |= mv << (8 * (k & 3));
        diag = west;
        h[k] = v;
        north = v;
      }
      *reinterpret_cast<uint2*>(out + (size_t)(j - 1) * kStrip) =
          make_uint2(code[0], code[1]);
      carry = h[kReplayBand - 1];
      fcarry = f;
      nw = north_in;
    }
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. Device pointers to contiguous
// tensors. pgs_strip_sweep: lane b's read at x + b * x_lane (x_lane = M for
// a (B, M) block, 0 for one query shared by every lane), uint8; y (B, N)
// uint8 with y_off null, or a flat slab of y_len bytes in which lane b reads
// from y_off[b] (int64; N is then only the bound on n_b); m, n (B,) int32;
// bound scratch -- (B, N + 1) int32, or (B, N + 1, 2) int32 when gap_open >
// 0, or lane b's row at bound_off[b] (int64) when bound_off is given -- or
// null when one pass covers M (M <= 512 x kBand = 16,384 rows, affine 384 x
// kBand = 12,288: ROWS_PER_PASS and ROWS_PER_PASS_AFFINE in
// ops/strips_cuda.py); ck (B, nck, N) int32 zero-filled or null
// (K11/K15/K19/K22); fck the same shape filled with -2^30, or null unless
// K16/K23; score/best_i/best_j (B,) int32. gap_open > 0 selects the affine
// kernels, a table ((ncodes, ncodes) int32, compact codes in x and y) the
// profile ones, both K22/K23. Returns cudaGetLastError() after the launch.
extern "C" int pgs_strip_sweep(const void* x, long long x_lane, const void* y,
                               const void* y_off, long long y_len, const void* m,
                               const void* n, int M, int N, int B, const void* table,
                               int ncodes, int match, int mismatch, int gap_open,
                               int gap, void* bound, const void* bound_off, void* ck,
                               void* fck, int nck, void* score, void* best_i,
                               void* best_j, void* stream) {
  const bool affine = gap_open > 0;
  if (B > 0) {
    const int bands = (M + kBand - 1) / kBand;
    const int threads = min(max_threads(affine), max(32, (bands + 31) / 32 * 32));
    const int passes = (bands + threads - 1) / threads;
    const size_t smem = table ? (size_t)ncodes * ncodes * sizeof(int32_t) : 0;
    // [kCkpt][kAffine][kProfile]
    static const decltype(&strip_sweep_kernel<false, false, false>) kernels[2][2][2] = {
        {{&strip_sweep_kernel<false, false, false>, &strip_sweep_kernel<false, false, true>},
         {&strip_sweep_kernel<false, true, false>, &strip_sweep_kernel<false, true, true>}},
        {{&strip_sweep_kernel<true, false, false>, &strip_sweep_kernel<true, false, true>},
         {&strip_sweep_kernel<true, true, false>, &strip_sweep_kernel<true, true, true>}}};
    auto kernel = kernels[ck != nullptr][affine][table != nullptr];
    kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), x_lane, static_cast<const uint8_t*>(y),
        static_cast<const int64_t*>(y_off), y_len, static_cast<const int32_t*>(m),
        static_cast<const int32_t*>(n), M, N, static_cast<const int32_t*>(table), ncodes,
        match, mismatch, gap_open, gap, passes, bound,
        static_cast<const int64_t*>(bound_off), static_cast<int32_t*>(ck),
        static_cast<int32_t*>(fck), nck, static_cast<int32_t*>(score),
        static_cast<int32_t*>(best_i), static_cast<int32_t*>(best_j));
  }
  return static_cast<int>(cudaGetLastError());
}

// pgs_strip_moves: x (B, M), y (B, N) uint8, m, n (B,) int32, base the
// strip's first row (a multiple of 256), rowin (and, when gap_open > 0,
// frowin) with lane stride ld_row or null, moves (B, N, 256) uint8 (columns
// past a lane's n_b not written). gap_open > 0 selects K17, a table
// ((ncodes, ncodes) int32 over compact codes) K21, both K24.
extern "C" int pgs_strip_moves(const void* x, const void* y, const void* m,
                               const void* n, int M, int N, int B, int base,
                               const void* rowin, const void* frowin,
                               long long ld_row, const void* table, int ncodes,
                               int match, int mismatch, int gap_open, int gap,
                               void* moves, void* stream) {
  const bool affine = gap_open > 0;
  if (B > 0) {
    const size_t smem = table ? (size_t)ncodes * ncodes * sizeof(int32_t) : 0;
    // [kAffine][kProfile]
    static const decltype(&strip_moves_kernel<false, false>) kernels[2][2] = {
        {&strip_moves_kernel<false, false>, &strip_moves_kernel<false, true>},
        {&strip_moves_kernel<true, false>, &strip_moves_kernel<true, true>}};
    auto kernel = kernels[affine][table != nullptr];
    kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y),
        static_cast<const int32_t*>(m), static_cast<const int32_t*>(n), M, N,
        base, static_cast<const int32_t*>(rowin), static_cast<const int32_t*>(frowin),
        ld_row, static_cast<const int32_t*>(table), ncodes, match, mismatch, gap_open,
        gap, static_cast<uint8_t*>(moves));
  }
  return static_cast<int>(cudaGetLastError());
}
