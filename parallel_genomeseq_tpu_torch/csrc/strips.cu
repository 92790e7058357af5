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
//     via `_call_strip_moves` (:1840): a strip's S rows recomputed from its
//     incoming checkpoint row, emitting the linear move byte of :1825-1831
//     for every cell the strip walk can read; G strips of every lane a
//     launch.
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
// K27 `strip_sweep_kernel<false, false, false, kBand, true, kPair>` (kParity)
//     replaces JAX device code with no Pallas call: the `lax.scan` wavefront
//     of parallel_genomeseq_tpu/ops/scan_dp.py (`_wavefront` :93, `_dp_step`
//     :58) at strip length under Semantics.SAT_UINT8 (`solve_big
//     --semantics sat_uint8`'s window sweep, 10,008 rows). K11 with each H
//     clamped at `cap` (255 under saturation, the operands clipped to [0,
//     255] by ops/scan_dp.sat_operands, which makes the saturating step the
//     exact one clamped) and, when `skewed` is set (csrc/parity.cuh's Tie),
//     the reference binary's skewed tie instead of the column-major one:
//     each thread keeps its cell of the maximum score of least raw key rj *
//     (M + 33) + ri, found at the wrap row (csrc/wavefront.cu's K26 says
//     how), then least row and column, and the block reduces in that order,
//     so passes and bands need no order between them. Its pair form (kPair,
//     the column-major tie under saturation with uniform scores; the
//     skewed tie runs the int32 form): a block sweeps lanes 2b and 2b + 1,
//     each thread word a row of both in signed 16-bit halves stepped by DPX
//     s16x2 instructions (parity.cuh's PairStep); the hand-off shuffles, the
//     rings and the between-pass bound row carry the packed word, one a
//     column for the two lanes; each half keeps its own best, masked past
//     its lane's m_b and n_b, and the block reduces the halves one after the
//     other.
//
// Design of K11/K12, a column step without a block barrier. One thread
// block per lane. Its T threads split the lane's rows into bands of kBand
// consecutive rows (16 or 32, below), one band per thread, so a warp holds
// 32 bands, and they sweep the reference as a pipeline: lane l of a warp
// works on column j = s - l + 1 at the warp's own step s. The band's column
// of H lives in registers (kBand int32 and the kBand read bytes).
//   - Inside a warp, band l + 1 takes band l's last-row H by __shfl_up_sync,
//     and the column's reference code travels down the warp with it: lane 0
//     takes column j's code from a 32-column word that the warp loads one
//     word ahead (one coalesced byte a lane), by one __shfl_sync. No thread
//     reads device memory inside the step.
//   - Between warps, lane 31 of warp w writes its output of column j into
//     ring[w][j % kRing] in shared memory and lane 0 of warp w + 1 reads it.
//     done[w] (columns written) and used[w + 1] (columns read) are published
//     every kGroup = 8 columns by block-scope release stores and read by
//     acquire loads (st.release.cta, ld.acquire.cta); a warp waits for them
//     only at the head of each group of 8 steps, so the step itself neither
//     waits nor tests. The warps drift up to kRing = 128 columns apart and a
//     slow warp delays only the warps below it; a warp that waits sleeps
//     (__nanosleep). There is no __syncthreads inside the column loop: the
//     one barrier per pass makes the previous pass's bound row complete and
//     resets the pass's counts.
//   - The cell: the north-independent part a = max(diag + s, west - gap, 0)
//     first (DPX __viaddmax_s32_relu), then one DPX a row carries the north
//     chain, H = max(north - gap, a) (__viaddmax_s32); the column maximum,
//     two rows a __vimax3_s32, and the first-best search stay off it.
//   - The band height, chosen at launch from two instantiations of the one
//     step: the one whose blocks keep more of the lanes' rows on an SM (the
//     CUDA occupancy calculator), narrow 16-row bands on a tie. At 10,008
//     rows (solve_big's windows) both keep 10,240 rows, and narrow bands give
//     a block of 640 threads, 20 warps of at most 96 registers a thread, one
//     block an SM: 11 waves of 132 blocks for the 1,400-lane launch, 96%
//     full. At 4,096 rows (a long query's slab scan) wide 32-row bands give
//     128-thread blocks, three or four an SM, whose pipeline fills and
//     drains in half the steps.
//   - Warps wholly past the lane's m_b do not run at all.
// A block takes at most kRowsPerPass = 10,240 rows at once with either band
// height; longer reads run in passes, the last band of a pass leaving its
// row in a device-memory row (B, N + 1) that the first warp of the next pass
// copies into a ring of its own a group ahead of its steps, in place (a read
// of column j always precedes the write of column j).
//
// Design of K15/K16, the same pipeline: E runs along a row, so each thread
// keeps its band's E column in registers beside H (kBand more int32) and E never
// leaves the thread; F runs down the rows like the north H, so the hand-off
// between bands (two shuffles), the ring, the between-pass bound row and the
// checkpoints carry the pair (H, F) -- an int2 in shared memory, (B, N + 1)
// int2 in device memory, and a second (B, K, N) int32 plane of F beside K16's
// H checkpoints. E and a = max(diag + s, E, 0) come first, off the chain;
// since H(k - 1) = max(a(k - 1), F(k - 1)) and open > 0, F's chain is one DPX
// a row, F(k) = max(F(k - 1) - extend, a(k - 1) - open - extend), and H(k) =
// max(a(k), F(k)). The E column keeps the affine blocks at 640 threads (96
// registers), and K15/K16 at narrow bands only. Boundaries are the port's
// full sweep's (ops/scan_dp.wavefront_affine): E = -2^30 in column 0, F = 0
// above row 1, so every value, the F checkpoints included, equals the plain
// sweep's.
//
// Exactness: columns past n_b are not swept, nor bands wholly past m_b. The
// band that holds m_b sweeps its rows past m_b like the others (no masking
// in the step); the DP runs down and right, so no row up to m_b reads them,
// and that band's column maximum and checkpoint count only its rows up to
// m_b (the caller's fill, H = 0 and F = -2^30, stands for the rows past it).
// So every value equals the plain full-matrix sweep's. Ties: each
// thread keeps the first maximum of its own cells in (j, i) order (a later
// pass takes a strictly smaller j only), and the block reduces the threads'
// bests by max score, then min j, then min i. An all-zero lane gives
// (0, 0, 0).
//
// Design of K13 and K17, the replay. One warp per (lane, strip) pair, G
// strips of every lane in one launch (the strips are independent: strip t
// starts from its own checkpoint row ck[:, t - 1]), four independent warps a
// block. The strip walk reads a strip's cells only from its current (i, j)
// up and left, so a warp first reads the walk's state on the device and
// returns at once when the lane is inactive or its i - 1 lies above the
// strip's first row, and otherwise replays only columns 1 .. min(n_b, j):
// every byte of a cell the walk can reach, stop bit included, depends only
// on columns up to j. 32 threads x 8 rows cover the strip's 256 rows,
// pipelined along the reference as the sweeps are, the hand-off by
// __shfl_up_sync (K17 hands off H and F). Nothing read from device memory
// is in the step's chain: the column's reference code, and row 0's incoming
// H (and F) -- zeros for strip 0, F = 0 above row 1 as the full sweep has
// it -- come from a 32-column word that the warp loads one word ahead, one
// coalesced element a lane, and lane 0 takes by __shfl_sync. A thread stages
// its 8 move bytes of a column in its own ring of kPiece slots in shared
// memory and stores them when the other kPiece - 1 threads of its piece have
// staged that column too, so that each warp store writes whole 128-byte runs
// of finished columns into the lane-major (B, N, S) layout the strip walk
// reads (moves[g][b][j - 1][r]), not 32 scattered 8-byte pieces. K17 keeps
// its 8 rows' E in registers, from -2^30 in column 0 as the full sweep does,
// so its bytes equal the full sweep's on every cell of the lane's matrix.
// The replays issue about 14 (K13) and 18 (K17) instructions a cell; with a
// whole strip a warp, a warp alone on its SM is latency-bound, which is why
// a launch replays as many strips as give every SM its resident warps.
//
// Design of K19-K21, and of K22-K24 (the same over K15-K17): K11-K13 with
// the score of a cell read from the table, copied into shared memory
// transposed as K4 does (csrc/profile.cu, tab[yc * ncodes + xc]), so each
// column takes its row pointer tab + yc * ncodes once and each cell is one
// shared load at row[xb[k]]; a code >= ncodes reads as code 0, the matrix
// minimum. In the slab form a lane's
// length is clamped to the bytes the slab holds past its offset, as K4
// clamps it, and the between-pass bound row of lane b (queries over 10,240
// aa) starts at bound_off[b], an exclusive prefix sum of the lanes' n_b + 1
// that the wrapper computes, so the row takes one int32 per slab residue
// and lane, not the lanes times the longest entry (K22: an (H, F) int2 pair
// a residue, bound_off then counting int2 units).
//
// What bounds them on the H100: the integer work (about 7 operations per cell
// for K11/K12, 12 for K13, 10 for K15/K16, 20 for K17, 5 for K19/K20, 10 for
// K21, 8 for K22/K23, 18 for K24), and for the sweeps at 20 warps an SM the
// issue of their instructions: the compiled column step of a 16-row band is
// about 16 instructions a row (K11) and 19 (K15), and the SM issues four
// warp-instructions a cycle, which the step nearly fills. Per column and
// thread the sweeps add three shuffles (affine four: the hand-off and the
// reference code), a ring access on lanes 0 and 31 and the running-best test,
// and per group of 8 columns one wait and one publish; the replays four
// shuffles (affine six: the hand-off, the code, row 0's inputs), a staged
// store and a store of the staged bytes. The sweep runs at the pace of
// its slowest warp, so work that one warp does and the others do not (a
// masked band, a divergent branch) costs the whole block: the band that
// holds m_b is swept unmasked for that reason. K19 on the slab is one block
// per entry: a warp starts about 40 steps after the warp above it and runs
// n_b + 31 steps, and a warp that waits or has finished sleeps
// (__nanosleep) and runs few instructions, so filling and draining the
// pipeline costs the block time but few instructions.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "parity.cuh"

namespace {

constexpr int kNarrow = 16;             // rows per thread of a sweep: narrow bands,
constexpr int kWide = 32;               // or wide ones (not K15/K16)
constexpr int kRowsPerPass = 10240;     // rows a sweep's block takes at once
constexpr int kMaxWarps = kRowsPerPass / kNarrow / 32;
constexpr int kRing = 128;              // columns a warp's hand-off ring holds
constexpr int kGroup = 8;               // columns a progress count covers
constexpr int kStrip = 256;             // strip height S (checkpoints, K13)
constexpr int kReplayBand = kStrip / 32;  // rows per thread, K13/K17
constexpr int kReplayWarps = 4;         // independent (lane, strip) warps a replay block holds
constexpr int kPiece = 16;              // threads whose staged codes leave as one run
constexpr int kNeg = -(1 << 30);        // E and F where no gap run can reach
constexpr unsigned kAll = 0xffffffffu;
static_assert(kStrip % kWide == 0 && kWide % kNarrow == 0 && kNarrow % 2 == 0,
              "bands tile the strips, in row pairs");
static_assert(kReplayBand == 8 && (kPiece & (kPiece - 1)) == 0 && 32 % kPiece == 0,
              "a replay thread packs its rows' codes in two words; pieces tile a warp");
static_assert(kRing % kGroup == 0 && (kRing & (kRing - 1)) == 0 &&
                  (kGroup & (kGroup - 1)) == 0, "the ring holds whole groups");

// The thread cap of a sweep with `rows`-row bands: 640 threads (96
// registers a thread) or 320 (168).
__host__ __device__ constexpr int max_threads(int rows) { return kRowsPerPass / rows; }

// Wide bands are built for every form but the uniform affine one (K15/K16),
// whose 32-row band needs more than the 168 registers a 320-thread block
// leaves a thread.
__host__ __device__ constexpr bool has_wide(bool affine, bool profile) {
  return !affine || profile;
}

// Bytes of the (ncodes, ncodes) int32 table at the head of a sweep's dynamic
// shared memory, rounded to 16 so that the ring after it is aligned.
__host__ __device__ inline size_t table_bytes(int ncodes) {
  return ((size_t)ncodes * ncodes * sizeof(int32_t) + 15) / 16 * 16;
}

// (v1, j1, i1) before (v2, j2, i2): higher score, then smaller j, then i.
__device__ __forceinline__ bool better(int v1, int j1, int i1, int v2, int j2,
                                       int i2) {
  return v1 > v2 || (v1 == v2 && (j1 < j2 || (j1 == j2 && i1 < i2)));
}

// The score of cell (x byte or code xc, y byte or code yc): uniform
// match/mismatch, or (kProfile) the word xc of the column's table row.
template <bool kProfile>
__device__ __forceinline__ int cell_score(int xc, int yc, const int32_t* row,
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
// h holds H(., j - 1) on entry and H(., j) on return. The cell score is
// cell_score<kProfile>(xb[k], yc, row, ...). Returns the column's maximum
// over the band. Rows past the lane's m_b are swept like the others: no row
// above them reads them (see the kernel). kParity (K27) clamps each H at
// cap.
template <bool kProfile, bool kParity, int kRows>
__device__ __forceinline__ int band_column(int (&h)[kRows],
                                           const uint8_t (&xb)[kRows],
                                           int yc, const int32_t* row,
                                           int match, int mismatch,
                                           int gap, int cap, int nw, int north) {
  // The north-independent part first: a = max(diag + s, west - gap, 0).
  int a[kRows];
  int diag = nw;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    a[k] = __viaddmax_s32_relu(diag, cell_score<kProfile>(xb[k], yc, row, match, mismatch),
                               h[k] - gap);
    diag = h[k];
  }
  // The north chain, one DPX a row: H = max(north - gap, a).
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    h[k] = __viaddmax_s32(north, -gap, a[k]);
    if constexpr (kParity) h[k] = min(h[k], cap);
    north = h[k];
  }
  int colmax = 0;
#pragma unroll
  for (int k = 0; k < kRows; k += 2) colmax = __vimax3_s32(colmax, h[k], h[k + 1]);
  return colmax;
}

// The pair form of band_column (K27 under saturation, kPair): h holds
// H(., j - 1) of the band's rows of two lanes, one a 16-bit half
// (parity.cuh's PairStep), on entry and H(., j) on return; xp the rows'
// read bytes and yp the column's reference bytes, one a half. Returns each
// half's maximum over the band.
template <int kRows>
__device__ __forceinline__ uint32_t band_column_pair(uint32_t (&h)[kRows],
                                                     const uint32_t (&xp)[kRows], uint32_t yp,
                                                     const PairStep& step, uint32_t nw,
                                                     uint32_t north) {
  uint32_t a[kRows];
  uint32_t diag = nw;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    a[k] = step.off_chain(xp[k], yp, diag, h[k]);
    diag = h[k];
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    h[k] = step.chain(north, a[k]);
    north = h[k];
  }
  uint32_t colmax = 0;
#pragma unroll
  for (int k = 0; k < kRows; k += 2) colmax = __vimax3_s16x2(colmax, h[k], h[k + 1]);
  return colmax;
}

// The affine form of band_column: h and e hold H(., j - 1) and E(., j - 1)
// on entry and H(., j), E(., j) on return; f is F(row0, j) on entry and F of
// the band's last row on return.
template <bool kProfile, int kRows>
__device__ __forceinline__ int band_column_affine(int (&h)[kRows], int (&e)[kRows],
                                                  const uint8_t (&xb)[kRows],
                                                  int yc, const int32_t* row,
                                                  int match, int mismatch,
                                                  int gap_open, int gap, int nw, int north,
                                                  int& f) {
  // Off the chain: E = max(west - open, E_west) - extend, a = max(diag + s, E, 0).
  int a[kRows];
  int diag = nw;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int west = h[k];
    e[k] = __viaddmax_s32(west, -gap_open, e[k]) - gap;
    a[k] = __viaddmax_s32_relu(diag, cell_score<kProfile>(xb[k], yc, row, match, mismatch),
                               e[k]);
    diag = west;
  }
  // The F chain, one DPX a row: with H(k - 1) = max(a(k - 1), F(k - 1)) and
  // open > 0, F(k) = max(F(k - 1) - extend, a(k - 1) - open - extend).
  const int open_extend = gap_open + gap;
  f = __viaddmax_s32(north, -gap_open, f) - gap;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k > 0) f = __viaddmax_s32(f, -gap, a[k - 1] - open_extend);
    h[k] = max(a[k], f);
  }
  int colmax = 0;
#pragma unroll
  for (int k = 0; k < kRows; k += 2) colmax = __vimax3_s32(colmax, h[k], h[k + 1]);
  return colmax;
}

// The hand-off between warps: a count in shared memory, read with a
// block-scope acquire load and published with a block-scope release store
// (32-bit shared addresses, so the counts cost no 64-bit registers).
__device__ __forceinline__ int load_acquire(const int* count) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(count)))
               : "memory");
  return v;
}

__device__ __forceinline__ void publish_count(int* count, int value) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;"
               :
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(count))), "r"(value)
               : "memory");
}

// Wait until a count published by another warp of the block reaches `need`.
// A count that has not come after 2^28 polls (over 8 s) is a fault in the
// pipeline: the kernel traps rather than hang the card.
__device__ __forceinline__ void wait_count(const int* count, int need) {
  for (unsigned polls = 0; load_acquire(count) < need; ++polls) {
    if (polls >= (1u << 28)) __trap();
    __nanosleep(32);
  }
}

__device__ __forceinline__ int shfl_up1(int v) { return __shfl_up_sync(kAll, v, 1); }
__device__ __forceinline__ int2 shfl_up1(int2 v) {
  return make_int2(__shfl_up_sync(kAll, v.x, 1), __shfl_up_sync(kAll, v.y, 1));
}
__device__ __forceinline__ int shfl_from(int v, int src) { return __shfl_sync(kAll, v, src); }
__device__ __forceinline__ int2 shfl_from(int2 v, int src) {
  return make_int2(__shfl_sync(kAll, v.x, src), __shfl_sync(kAll, v.y, src));
}

// Column k + 1's reference byte, or (kProfile) its clamped code.
template <bool kProfile>
__device__ __forceinline__ int y_code(const uint8_t* yl, int k, int ncodes) {
  const uint8_t c = yl[k];
  return kProfile ? clamp_code(c, ncodes) : c;
}

// K11 (kCkpt = false) and K12 (kCkpt = true), with kAffine K15 and K16,
// with kProfile K19 and K20, with both K22 and K23; with kParity alone K27
// (H clamped at cap, the tie `skewed` of parity.cuh), and with kPair too
// K27's pair form (cap 255, uniform scores, the column-major tie): block b
// sweeps lanes 2b and 2b + 1, each thread word holding a row of both, a
// 16-bit half each. x: lane
// b's read at x + b * x_lane, uint8 bytes (codes when kProfile; x_lane = 0
// shares one query between lanes); y: lane b's reference at y + b * N, or
// at y + y_off[b] when y_off is given (a flat slab of y_len bytes; n_b is
// then clamped to the bytes past the offset). B the lanes.
// bound: scratch of the hand-off type (int32, or int2 (H, F) when affine),
// lane b's row at bound_off[b] if given, else b * (N + 1) (kPair: lane pair
// b's, a packed word a column); used when passes > 1. ck (B, nck, N) int32
// zero-filled by the caller, ck[b][c][j - 1] = H((c + 1) * kStrip, j)
// (1-based rows); fck the same shape, filled with kNeg by the caller,
// fck[b][c][j - 1] = F((c + 1) * kStrip, j) (K16 and K23 only). table
// (ncodes, ncodes) int32 over compact codes (kProfile only). kBand: rows per
// thread, kNarrow or kWide. Dynamic shared memory: the table
// (table_bytes(ncodes), kProfile only), then each warp's ring of kRing
// hand-off words and one more for the bound row.
template <bool kCkpt, bool kAffine, bool kProfile, int kBand, bool kParity, bool kPair = false>
__global__ void __launch_bounds__(max_threads(kBand))
strip_sweep_kernel(const uint8_t* __restrict__ x, long long x_lane,
                   const uint8_t* __restrict__ y, const int64_t* __restrict__ y_off,
                   long long y_len, const int32_t* __restrict__ m,
                   const int32_t* __restrict__ n, int M, int N, int B,
                   const int32_t* __restrict__ table, int ncodes, int match,
                   int mismatch, int gap_open, int gap, int cap, int skewed, int passes,
                   void* __restrict__ bound, const int64_t* __restrict__ bound_off,
                   int32_t* __restrict__ ck, int32_t* __restrict__ fck, int nck,
                   int32_t* __restrict__ score, int32_t* __restrict__ best_i,
                   int32_t* __restrict__ best_j) {
  static_assert(!kParity || (!kCkpt && !kAffine && !kProfile), "K27 is K11's form only");
  static_assert(!kPair || kParity, "the pair form is K27's");
  constexpr int P = kPair ? 2 : 1;  // lanes a block
  using Carry = std::conditional_t<kAffine, int2, int>;  // hand-off: H (a pair's two), or (H, F)
  using Cell = std::conditional_t<kPair, uint32_t, int>;  // a row's H, or a pair's two
  // Per pass parity: done[.][w] counts the columns warp w has handed to warp
  // w + 1, used[.][w] those warp w has taken from warp w - 1.
  __shared__ int done[2][kMaxWarps];
  __shared__ int used[2][kMaxWarps];
  __shared__ int red[4][kMaxWarps];  // each warp's (best, j, i, key)
  extern __shared__ __align__(16) unsigned char dyn[];
  int32_t* const tab = reinterpret_cast<int32_t*>(dyn);  // kProfile: tab[yc * ncodes + xc]
  Carry* const ring = reinterpret_cast<Carry*>(dyn + (kProfile ? table_bytes(ncodes) : 0));
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int W = T >> 5;
  if constexpr (kProfile) load_table(tab, table, ncodes);
  if (lane == 0) {
    done[0][w] = 0;
    used[0][w] = 0;
  }
  int mbv[P], nbv[P];  // each lane's lengths
  const uint8_t* xl[P];
  const uint8_t* yl[P];
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int lb = kPair ? min(2 * b + v, B - 1) : b;  // an empty half reads lane 2b's bytes
    const bool has = !kPair || 2 * b + v < B;
    mbv[v] = has ? min(m[lb], M) : 0;
    nbv[v] = has ? min(n[lb], N) : 0;
    long long off = (long long)lb * N;
    if (y_off) {
      off = y_off[lb];
      if (off < 0 || off > y_len) {
        nbv[v] = 0;
      } else if ((long long)nbv[v] > y_len - off) {
        nbv[v] = (int)(y_len - off);
      }
    }
    if (kPair && (mbv[v] <= 0 || nbv[v] <= 0)) mbv[v] = nbv[v] = 0;  // an empty half
    xl[v] = x + (size_t)lb * x_lane;
    yl[v] = y + off;
  }
  const int mb = max(mbv[0], mbv[P - 1]);  // the block's rows and columns
  const int nb = max(nbv[0], nbv[P - 1]);
  Carry* bl = bound ? static_cast<Carry*>(bound) +
                          (bound_off ? (size_t)bound_off[b] : (size_t)b * (N + 1))
                    : nullptr;
  Cell best = 0;  // kPair: each half's best
  int bi[P], bj[P], bkey[P];  // K27, skewed: bkey the raw key of (bi, bj)
#pragma unroll
  for (int v = 0; v < P; ++v) {
    bi[v] = bj[v] = 0;
    bkey[v] = 0x7fffffff;
  }
  const bool by_key = kParity && !kPair && skewed != kColmajor;
  const PairStep pstep(match, mismatch, gap);
  // Column k + 1's reference byte, or (kProfile) its clamped code, or
  // (kPair) the two lanes' bytes, a half each.
  const auto y_at = [&](int k) -> int {
    if constexpr (kPair) {
      return yl[0][k] | yl[P - 1][k] << 16;
    } else {
      return y_code<kProfile>(yl[0], k, ncodes);
    }
  };
  for (int p = 0; p < passes; ++p) {
    // The previous pass is over (its bound row complete), this pass's counts
    // are 0 and the table is loaded.
    __syncthreads();
    if (lane == 0) {  // the next pass's counts, idle in this pass
      done[(p + 1) & 1][w] = 0;
      used[(p + 1) & 1][w] = 0;
    }
    const int wrow0 = (p * T + (w << 5)) * kBand;  // 0-based first row of the warp
    if (nb == 0 || wrow0 >= mb) continue;         // no row of the lane's matrix here
    const int q = p & 1;  // this pass's counts
    const bool takes = w > 0;  // row0's north from warp w - 1's ring
    const bool feeds = w + 1 < W && wrow0 + 32 * kBand < mb;  // warp w + 1 has rows
    const bool reads_bound = w == 0 && p > 0;  // row0's north from the bound row
    const bool writes_bound = w == W - 1 && lane == 31 && p + 1 < passes &&
                              (p + 1) * T * kBand < mb;
    // Rings in `ring`: warp w - 1's, or for warp 0 the bound row's (index W),
    // which warp 0 fills from device memory a group at a time; this warp's.
    const int ring_in = (takes ? w - 1 : W) * kRing;
    const int row0 = wrow0 + lane * kBand;  // 0-based first row of the band
    int nvalid[P];  // the band's rows up to each lane's m_b
#pragma unroll
    for (int v = 0; v < P; ++v) nvalid[v] = min(max(mbv[v] - row0, 0), kBand);
    const int nv = max(nvalid[0], nvalid[P - 1]);
    // The pair form: a half past its n_b, or a band wholly past its m_b,
    // counts nothing in the best; the band holding a lane's m_b masks its
    // rows past it.
    int ncount[P];
#pragma unroll
    for (int v = 0; v < P; ++v) ncount[v] = nvalid[v] > 0 ? nbv[v] : 0;
    const bool straddle = kPair && ((nvalid[0] > 0 && nvalid[0] < kBand) ||
                                    (nvalid[P - 1] > 0 && nvalid[P - 1] < kBand));
    uint32_t vbits[P];  // the skewed search's rows: bit k for each row up to m_b
#pragma unroll
    for (int v = 0; v < P; ++v) vbits[v] = nvalid[v] >= 32 ? ~0u : (1u << nvalid[v]) - 1u;
    std::conditional_t<kPair, uint32_t, uint8_t> xb[kBand];
    Cell h[kBand];
    int e[kBand];  // affine only: E(., j - 1), kNeg in column 0
#pragma unroll
    for (int k = 0; k < kBand; ++k) {
      if constexpr (kPair) {
        xb[k] = row0 + k < M ? xl[0][row0 + k] | static_cast<uint32_t>(xl[P - 1][row0 + k]) << 16
                             : 0u;
      } else {
        xb[k] = row0 + k < M ? xl[0][row0 + k] : 0;
        if (kProfile) xb[k] = clamp_code(xb[k], ncodes);
      }
      h[k] = 0;
      e[k] = kNeg;
    }
    // The band's last row closes strip c when (row0 + kBand) % kStrip == 0;
    // past the lane's m_b the caller's fill (H = 0, F = kNeg) stands.
    const int c = (row0 + kBand) / kStrip - 1;
    const bool writes_ck = kCkpt && (row0 + kBand) % kStrip == 0 && c < nck &&
                           nvalid[0] == kBand;
    Cell nw = 0;       // H(row0, j - 1): the previous column's north input
    int flast = kNeg;  // affine: F of the band's last row in the column it finished last
    int yc = 0;        // the code of this band's column
    // The reference 32 columns a word, one a lane, loaded one word ahead:
    // lane l of word k holds column 32k + l + 1's code.
    int ycur = 0;
    int ynext = lane < nb ? y_at(lane) : 0;
    // Steps in groups of kGroup: lane 0 takes columns s0 + 1 .. s0 + kGroup of
    // a group at step s0, lane 31 hands on columns s0 - 30 .. s0 - 23.
    for (int s0 = 0; s0 < nb + 31; s0 += kGroup) {
      if ((s0 & 31) == 0) {
        ycur = ynext;
        const int k = s0 + 32 + lane;
        ynext = k < nb ? y_at(k) : 0;
      }
      // Warp-uniform waits at the group's head: for warp w - 1's output of
      // the columns lane 0 takes, and for warp w + 1 to have taken the
      // columns whose ring slots lane 31 refills.
      if (takes && s0 < nb) wait_count(&done[q][w - 1], min(s0 + kGroup, nb));
      if (reads_bound) {
        if (lane < kGroup && s0 + lane < nb) {
          ring[ring_in + ((s0 + lane + 1) & (kRing - 1))] = bl[s0 + lane + 1];
        }
        __syncwarp();
      }
      if (feeds && s0 - 23 >= 1) wait_count(&used[q][w + 1], min(s0 - 23, nb) - kRing);
#pragma unroll 1
      for (int u = 0; u < kGroup; ++u) {
        const int s = s0 + u;
        const int j0 = s + 1;  // lane 0's column
        // The band's last-row output of the column it finished last.
        Carry in;
        if constexpr (kAffine) {
          in = shfl_up1(make_int2(h[kBand - 1], flast));
        } else {
          in = shfl_up1(static_cast<int>(h[kBand - 1]));
        }
        yc = shfl_up1(yc);
        const int yfirst = shfl_from(ycur, s & 31);
        if (lane == 0) {
          yc = yfirst;
          // Row 0's north: H = 0 and (affine) F = 0 above the first pass.
          in = (takes || reads_bound) && j0 <= nb ? ring[ring_in + (j0 & (kRing - 1))]
                                                  : Carry{};
        }
        const int j = s - lane + 1;
        if (j >= 1 && j <= nb) {
          const int32_t* row = nullptr;  // kProfile: the column's table row
          if constexpr (kProfile) row = tab + yc * ncodes;
          Cell colmax = 0;
          Cell north;
          Carry last;
          if constexpr (kAffine) {
            north = in.x;
            int f = in.y;
            if (nv > 0) {
              colmax = band_column_affine<kProfile>(h, e, xb, yc, row, match, mismatch, gap_open,
                                                    gap, nw, north, f);
            } else {
              f = kNeg;  // a band wholly past m_b
            }
            last = make_int2(h[kBand - 1], f);
          } else if constexpr (kPair) {
            north = static_cast<uint32_t>(in);
            if (nv > 0) {
              colmax = band_column_pair(h, xb, static_cast<uint32_t>(yc), pstep, nw, north);
            }
            last = static_cast<int>(h[kBand - 1]);
          } else {
            north = in;
            if (nv > 0) {
              colmax = band_column<kProfile, kParity>(h, xb, yc, row, match, mismatch, gap,
                                                      cap, nw, north);
            }
            last = h[kBand - 1];
          }
          if constexpr (kPair) {
            // Each half's best test, K11's: a higher score, or an equal one
            // (> 0) at a smaller j, from an earlier pass's band.
            const uint32_t cmask = (j <= ncount[0] ? 0xffffu : 0u) |
                                   (j <= ncount[P - 1] ? 0xffff0000u : 0u);
            colmax &= cmask;
            bool go_hi, go_lo;
            if (j < max(bj[0], bj[P - 1])) {  // colmax >= max(best, 1)
              __vibmax_s16x2(colmax, __vimax_s16x2_relu(best, 0x00010001u), &go_hi, &go_lo);
            } else {  // not best >= colmax: only a higher score wins past a half's best column
              __vibmax_s16x2(best, colmax, &go_hi, &go_lo);
              go_hi = !go_hi;
              go_lo = !go_lo;
            }
            if (go_lo || go_hi) {
              if (straddle) {  // each half's rows up to its m_b only
                colmax = 0;
#pragma unroll
                for (int k = 0; k < kBand; ++k) {
                  colmax = __vimax_s16x2_relu(
                      colmax, h[k] & ((k < nvalid[0] ? 0xffffu : 0u) |
                                      (k < nvalid[P - 1] ? 0xffff0000u : 0u)));
                }
                colmax &= cmask;
              }
#pragma unroll
              for (int hh = 0; hh < P; ++hh) {
                const int cv = half_of(colmax, hh);
                const int bv = half_of(best, hh);
                if (!(cv > bv || (cv == bv && cv > 0 && j < bj[hh]))) continue;
                int kk = 0;
#pragma unroll
                for (int k = kBand - 1; k >= 0; --k) kk = half_of(h[k], hh) == cv ? k : kk;
                best = hh ? (best & 0xffffu) | static_cast<uint32_t>(cv) << 16
                          : (best & 0xffff0000u) | static_cast<uint32_t>(cv);
                bi[hh] = row0 + kk + 1;
                bj[hh] = j;
              }
            }
          } else if (by_key) {
            // The column's cells of the maximum, if it reaches the best: the
            // least raw key, the least row on equal keys.
            if (colmax >= best && colmax > 0) {
              if (nv < kBand) {  // the band holding m_b: its rows up to m_b only
                colmax = 0;
#pragma unroll
                for (int k = 0; k < kBand; ++k) colmax = k < nv ? max(colmax, h[k]) : colmax;
              }
              if (colmax >= best && colmax > 0 &&
                  (colmax > best || skewed != kSkewedWrap ||
                   tie_may_win(mb, nb, M, row0, j, kBand, bkey[0]))) {
                // The rows of the maximum, then the candidate's key.
                uint32_t eq = 0;
#pragma unroll
                for (int k = 0; k < kBand; ++k) eq |= (h[k] == colmax ? 1u : 0u) << k;
                const RawKey raw_key(mb, nb, M);  // off the column loop's registers
                int key;
                const int kk = candidate(eq & vbits[0], raw_key, row0, j, skewed, key);
                if (better_skewed(colmax, key, row0 + kk + 1, j, best, bkey[0], bi[0], bj[0])) {
                  best = colmax;
                  bkey[0] = key;
                  bi[0] = row0 + kk + 1;
                  bj[0] = j;
                }
              }
            }
          } else if (colmax > best || (colmax == best && colmax > 0 && j < bj[0])) {
            if (nv < kBand) {  // the band holding m_b: its rows up to m_b only
              colmax = 0;
#pragma unroll
              for (int k = 0; k < kBand; ++k) colmax = k < nv ? max(colmax, h[k]) : colmax;
            }
            if (colmax > best || (colmax == best && colmax > 0 && j < bj[0])) {
              int kk = 0;
#pragma unroll
              for (int k = kBand - 1; k >= 0; --k) kk = h[k] == colmax ? k : kk;
              best = colmax;
              bj[0] = j;
              bi[0] = row0 + kk + 1;
            }
          }
          if constexpr (kAffine) flast = last.y;
          if (feeds && lane == 31) ring[w * kRing + (j & (kRing - 1))] = last;
          if (writes_ck) {
            const size_t at = ((size_t)blockIdx.x * nck + c) * N + (j - 1);
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
      }
      // Publish the group's columns: those lane 0 took, those lane 31 handed on.
      if (takes && lane == 0 && s0 < nb) publish_count(&used[q][w], min(s0 + kGroup, nb));
      if (feeds && lane == 31 && s0 - 23 >= 1) publish_count(&done[q][w], min(s0 - 23, nb));
    }
    if (feeds && lane == 31) publish_count(&done[q][w], nb);  // the last columns
  }
  // Block reduction of each lane's (best, bj, bi) (K27 skewed: and bkey, in
  // its order): a warp by shuffles, then the warps.
#pragma unroll
  for (int hh = 0; hh < P; ++hh) {
    int v = kPair ? half_of(best, hh) : static_cast<int>(best);
    int vj = bj[hh], vi = bi[hh], vk = bkey[hh];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int v2 = __shfl_down_sync(kAll, v, off);
      const int j2 = __shfl_down_sync(kAll, vj, off);
      const int i2 = __shfl_down_sync(kAll, vi, off);
      const int k2 = kParity ? __shfl_down_sync(kAll, vk, off) : 0;
      if (by_key ? better_skewed(v2, k2, i2, j2, v, vk, vi, vj) : better(v2, j2, i2, v, vj, vi)) {
        v = v2;
        vj = j2;
        vi = i2;
        vk = k2;
      }
    }
    if (hh > 0) __syncthreads();  // thread 0 has read the first lane's red
    if (lane == 0) {
      red[0][w] = v;
      red[1][w] = vj;
      red[2][w] = vi;
      red[3][w] = vk;
    }
    __syncthreads();
    const int lb = kPair ? 2 * b + hh : b;
    if (t == 0 && lb < B) {
      for (int u = 1; u < W; ++u) {
        const int k2 = red[3][u];
        if (by_key ? better_skewed(red[0][u], k2, red[2][u], red[1][u], v, vk, vi, vj)
                   : better(red[0][u], red[1][u], red[2][u], v, vj, vi)) {
          v = red[0][u];
          vj = red[1][u];
          vi = red[2][u];
          vk = k2;
        }
      }
      score[lb] = v;
      best_i[lb] = v > 0 ? vi : 0;
      best_j[lb] = v > 0 ? vj : 0;
    }
  }
}

// One column of a replay band's kReplayBand rows: h (and, affine, e) hold
// H(., j - 1) (E(., j - 1)) on entry and H(., j) (E(., j)) on return; diag
// = H(row0, j - 1) and north = H(row0, j) of the row above the band; f is
// F(row0, j) on entry and F of the band's last row on return (affine). Row
// k's move byte goes to byte k of code. kMasked: rows k >= nvalid (past the
// lane's m_b) hold H = 0 and, affine, E = F = kNeg, as the full sweep stores
// them.
template <bool kAffine, bool kProfile, bool kMasked>
__device__ __forceinline__ void replay_column(int (&h)[kReplayBand], int (&e)[kReplayBand],
                                              const uint8_t (&xb)[kReplayBand], int yc,
                                              const int32_t* row, int match, int mismatch,
                                              int gap_open, int gap, int diag, int north,
                                              int& f, int nvalid, uint32_t (&code)[2]) {
#pragma unroll
  for (int k = 0; k < kReplayBand; ++k) {
    const int west = h[k];
    const int s_xy = cell_score<kProfile>(xb[k], yc, row, match, mismatch);
    uint32_t mv;
    int v;
    if constexpr (kAffine) {
      // The byte of ops/scan_dp.wavefront_affine: H's source by equality in
      // the order ZERO, NW, E, F; the extend bits where the run's value
      // reaches the opening one.
      const int e_open = west - gap_open;
      const int f_open = north - gap_open;
      int ek = max(e_open, e[k]) - gap;
      const int fk = max(f_open, f) - gap;
      const int nwv = diag + s_xy;
      v = __vimax3_s32_relu(nwv, ek, fk);
      mv = v == 0 ? 3u : v == nwv ? 0u : v == ek ? 1u : 2u;
      if (e[k] >= e_open) mv |= 8u;
      if (f >= f_open) mv |= 16u;
      f = fk;
      if (kMasked && k >= nvalid) {
        v = 0;
        ek = kNeg;
        f = kNeg;
      }
      e[k] = ek;
    } else {
      // Move code over the neighbours (nw, west, north): NW if nw >= west
      // and nw >= north, else W if west >= north, else N; bit 2 (stop) when
      // any of them is 0 (H is never negative, so when their minimum is).
      const int wn = max(west, north);
      mv = diag >= wn ? 0u : west >= north ? 1u : 2u;
      if (__vimin3_s32(diag, west, north) == 0) mv |= 4u;
      v = __viaddmax_s32_relu(wn, -gap, diag + s_xy);  // max(wn - gap, diag + s, 0)
      if (kMasked && k >= nvalid) v = 0;
    }
    code[k >> 2] |= mv << (8 * (k & 3));
    diag = west;
    h[k] = v;
    north = v;
  }
}

// K13 (kAffine = false) and K17 (kAffine = true), and with kProfile K21 and
// K24: one warp per (lane, strip) pair, kReplayWarps independent warps a
// block; pair p = (blockIdx.x * kReplayWarps + warp) replays strip first + g
// of lane b, b = p / G, g = p % G, into moves[g][b] of the (G, B, N, kStrip)
// uint8 buffer (moves[g][b][j - 1][r] the byte of cell (base + r + 1, j)).
// x (B, M) uint8 (codes when kProfile), y (B, N); the incoming H row of
// strip t (its row base = t * kStrip, 1-based) for lane b at hrow + b *
// ld_lane + (t - row_first) * ld_strip when hrow is given and t >=
// row_first, else zeros; frow the same for F (affine; 0 above row 1). walk_i,
// walk_j, walk_active (the strip walk's state, or null for every column of
// every pair): a pair whose lane is inactive or whose i - 1 lies above the
// strip's base does nothing, the others replay columns 1 .. min(n_b, j).
// table (ncodes, ncodes) int32 (K21 and K24; dynamic shared memory, before
// each warp's staging ring).
template <bool kAffine, bool kProfile>
__global__ void __launch_bounds__(kReplayWarps * 32, kAffine ? 6 : 8)
strip_moves_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                   const int32_t* __restrict__ m, const int32_t* __restrict__ n, int M,
                   int N, int B, int G, int first, const int32_t* __restrict__ hrow,
                   const int32_t* __restrict__ frow, long long ld_lane, long long ld_strip,
                   int row_first, const int32_t* __restrict__ walk_i,
                   const int32_t* __restrict__ walk_j,
                   const uint8_t* __restrict__ walk_active,
                   const int32_t* __restrict__ table, int ncodes, int match, int mismatch,
                   int gap_open, int gap, uint8_t* __restrict__ moves) {
  extern __shared__ __align__(16) unsigned char dyn[];
  int32_t* const tab = reinterpret_cast<int32_t*>(dyn);  // kProfile: tab[yc * ncodes + xc]
  if constexpr (kProfile) {
    load_table(tab, table, ncodes);
    __syncthreads();  // the block's only barrier: its warps are independent
  }
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // This thread's ring of kPiece staged 8-byte codes, slot j % kPiece.
  uint2* const stage =
      reinterpret_cast<uint2*>(dyn + (kProfile ? table_bytes(ncodes) : 0)) + w * kPiece * 32 + t;
  const long long pair = (long long)blockIdx.x * kReplayWarps + w;
  if (pair >= (long long)B * G) return;
  const int b = (int)(pair / G);
  const int g = (int)(pair % G);
  const int strip = first + g;
  const int base = strip * kStrip;
  int nb = min(n[b], N);
  if (walk_i) {  // only what the walk can still read
    if (!walk_active[b] || walk_i[b] - 1 < base) return;
    nb = min(nb, walk_j[b]);
  }
  if (nb <= 0) return;
  const int row0 = t * kReplayBand;  // strip-local first row of the band
  const int nvalid = min(max(min(m[b], M) - base - row0, 0), kReplayBand);
  // The strip that holds m_b masks its rows past it in every thread, so
  // that the warp takes one path: masking a full band changes nothing.
  const bool masked = __any_sync(kAll, nvalid < kReplayBand);
  const uint8_t* xl = x + (size_t)b * M;
  const uint8_t* yl = y + (size_t)b * N;
  const bool has_row = hrow != nullptr && strip >= row_first;
  const size_t row_at = has_row ? (size_t)b * ld_lane + (size_t)(strip - row_first) * ld_strip : 0;
  const int32_t* rl = has_row ? hrow + row_at : nullptr;
  const int32_t* fl = kAffine && has_row ? frow + row_at : nullptr;
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
  // Row 0's inputs 32 columns a word, one a lane, loaded one word ahead:
  // lane l of word k holds column 32k + l + 1's reference code and incoming
  // H (and F); lane 0 takes them by __shfl_sync.
  int ycur = 0, hcur = 0, fcur = 0;
  int ynext = t < nb ? y_code<kProfile>(yl, t, ncodes) : 0;
  int hnext = rl && t < nb ? rl[t] : 0;
  int fnext = fl && t < nb ? fl[t] : 0;
  // Piece p = t / kPiece of column c leaves the warp at step c + lag, when
  // its last thread has staged it: one 8-byte store a thread, kPiece threads
  // writing one contiguous 8 * kPiece-byte run of the column.
  const int lag = (t / kPiece + 1) * kPiece - 2;
  uint8_t* const out = moves + ((size_t)g * B + b) * N * kStrip + row0;
  int yc = 0;      // this band's column's code
  int nw = 0;      // H(row0, j - 1)
  int carry = 0;   // this band's last-row H of the column it finished last
  int fcarry = 0;  // affine: the same row's F
  for (int s = 0; s < nb + 31; ++s) {
    if ((s & 31) == 0) {
      ycur = ynext;
      hcur = hnext;
      fcur = fnext;
      const int k = s + 32 + t;
      ynext = k < nb ? y_code<kProfile>(yl, k, ncodes) : 0;
      hnext = rl && k < nb ? rl[k] : 0;
      fnext = fl && k < nb ? fl[k] : 0;
    }
    const int up = shfl_up1(carry);
    const int fup = kAffine ? shfl_up1(fcarry) : 0;
    yc = shfl_up1(yc);
    const int hfirst = shfl_from(hcur, s & 31);
    const int ffirst = kAffine ? shfl_from(fcur, s & 31) : 0;
    const int yfirst = shfl_from(ycur, s & 31);
    if (t == 0) yc = yfirst;
    const int j = s - t + 1;
    if (j >= 1 && j <= nb) {
      const int north_in = t > 0 ? up : hfirst;
      int f = t > 0 ? fup : ffirst;  // affine: F(row0, j)
      const int32_t* row = kProfile ? tab + yc * ncodes : nullptr;
      uint32_t code[2] = {0u, 0u};
      if (!masked) {
        replay_column<kAffine, kProfile, false>(h, e, xb, yc, row, match, mismatch, gap_open,
                                                gap, nw, north_in, f, nvalid, code);
      } else {
        replay_column<kAffine, kProfile, true>(h, e, xb, yc, row, match, mismatch, gap_open,
                                               gap, nw, north_in, f, nvalid, code);
      }
      stage[(j & (kPiece - 1)) * 32] = make_uint2(code[0], code[1]);
      carry = h[kReplayBand - 1];
      fcarry = f;
      nw = north_in;
    }
    const int c = s - lag;
    if (c >= 1 && c <= nb) {
      *reinterpret_cast<uint2*>(out + (size_t)(c - 1) * kStrip) = stage[(c & (kPiece - 1)) * 32];
    }
  }
}

using SweepKernel = decltype(&strip_sweep_kernel<false, false, false, kNarrow, false>);

// The sweep kernel of a form with kBand = rows: [kCkpt][kAffine][kProfile],
// or with parity K27 (K11's form only; with pair its pair form); null where
// has_wide is false or there is no such form.
template <int kRows>
SweepKernel sweep_kernel(bool ckpt, bool affine, bool profile, bool parity, bool pair) {
  static const SweepKernel kernels[2][2][2] = {
      {{&strip_sweep_kernel<false, false, false, kRows, false>,
        &strip_sweep_kernel<false, false, true, kRows, false>},
       {kRows == kNarrow ? &strip_sweep_kernel<false, true, false, kNarrow, false> : nullptr,
        &strip_sweep_kernel<false, true, true, kRows, false>}},
      {{&strip_sweep_kernel<true, false, false, kRows, false>,
        &strip_sweep_kernel<true, false, true, kRows, false>},
       {kRows == kNarrow ? &strip_sweep_kernel<true, true, false, kNarrow, false> : nullptr,
        &strip_sweep_kernel<true, true, true, kRows, false>}}};
  if (parity) {
    return ckpt || affine || profile ? nullptr
           : pair                    ? &strip_sweep_kernel<false, false, false, kRows, true, true>
                                     : &strip_sweep_kernel<false, false, false, kRows, true>;
  }
  return pair ? nullptr : kernels[ckpt][affine][profile];
}

// A sweep's block shape for M rows with `rows`-row bands: a thread a band,
// whole warps, at most max_threads(rows) a block, passes of that many bands
// (both band heights give the same passes); dynamic shared memory for the
// table (profile forms), a ring per warp and one for the bound row; the
// blocks an SM holds (the CUDA occupancy calculator).
struct SweepShape {
  SweepKernel kernel;
  int rows;
  int threads;
  int passes;
  size_t smem;
  int blocks;
};

SweepShape shape_with(int rows, int M, bool ckpt, bool affine, bool profile, int ncodes,
                      bool parity, bool pair) {
  const int bands = (M + rows - 1) / rows;
  const int threads = min(max_threads(rows), max(32, (bands + 31) / 32 * 32));
  const size_t carry = affine ? sizeof(int2) : sizeof(int);
  SweepShape shape{rows == kNarrow ? sweep_kernel<kNarrow>(ckpt, affine, profile, parity, pair)
                                   : sweep_kernel<kWide>(ckpt, affine, profile, parity, pair),
                   rows, threads, (bands + threads - 1) / threads,
                   (profile ? table_bytes(ncodes) : 0) + (size_t)(threads / 32 + 1) * kRing * carry,
                   0};
  if (shape.kernel != nullptr) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&shape.blocks, shape.kernel, threads,
                                                  shape.smem);
  }
  return shape;
}

// The band height of a launch: the one whose blocks keep more rows of the
// lanes on an SM at once, narrow bands (twice the warps) on a tie. At 10,008
// rows both keep 10,240 and narrow bands run 20 warps an SM against 10; at
// 4,096 (a long query's slab scan) or 2,304 rows the wide bands' blocks are
// small enough to fit more rows, and spend half the steps filling and
// draining the pipeline.
SweepShape sweep_shape(int M, bool ckpt, bool affine, bool profile, int ncodes, bool parity,
                       bool pair) {
  const SweepShape narrow = shape_with(kNarrow, M, ckpt, affine, profile, ncodes, parity, pair);
  if (!has_wide(affine, profile) || narrow.kernel == nullptr) return narrow;
  const SweepShape wide = shape_with(kWide, M, ckpt, affine, profile, ncodes, parity, pair);
  return (long long)wide.blocks * wide.threads * kWide >
                 (long long)narrow.blocks * narrow.threads * kNarrow
             ? wide
             : narrow;
}

using ReplayKernel = decltype(&strip_moves_kernel<false, false>);

// The replay kernel of a form: K13, K17, K21 or K24.
ReplayKernel replay_kernel(bool affine, bool profile) {
  static const ReplayKernel kernels[2][2] = {
      {&strip_moves_kernel<false, false>, &strip_moves_kernel<false, true>},
      {&strip_moves_kernel<true, false>, &strip_moves_kernel<true, true>}};
  return kernels[affine][profile];
}

// A replay block's dynamic shared memory: the table (ncodes > 0), then each
// warp's staging ring, kPiece 8-byte slots a thread.
size_t replay_smem(int ncodes) {
  return (ncodes > 0 ? table_bytes(ncodes) : 0) +
         (size_t)kReplayWarps * kPiece * 32 * sizeof(uint2);
}

}  // namespace

// Plain C entry points, bound with ctypes. Device pointers to contiguous
// tensors. pgs_strip_sweep: lane b's read at x + b * x_lane (x_lane = M for
// a (B, M) block, 0 for one query shared by every lane), uint8; y (B, N)
// uint8 with y_off null, or a flat slab of y_len bytes in which lane b reads
// from y_off[b] (int64; N is then only the bound on n_b); m, n (B,) int32;
// bound scratch -- (B, N + 1) int32, or (B, N + 1, 2) int32 when gap_open >
// 0, or lane b's row at bound_off[b] (int64) when bound_off is given -- or
// null when one pass covers M (M <= kRowsPerPass = 10,240 rows:
// ROWS_PER_PASS and ROWS_PER_PASS_AFFINE in ops/strips_cuda.py); ck (B, nck,
// N) int32 zero-filled or null (K11/K15/K19/K22); fck the same shape filled
// with -2^30, or null unless K16/K23; score/best_i/best_j (B,) int32.
// gap_open > 0 selects the affine kernels, a table ((ncodes, ncodes) int32,
// compact codes in x and y) the profile ones, both K22/K23; sat (clamp every
// H at 255, the operands already clipped) or skewed (parity.cuh's Tie: 1 the
// raw-key tie with each column's key found at the wrap row, 2 with every
// cell's key) K27, which takes K11's arguments only, and with pair its pair
// form (sat, the column-major tie, the operands in [0, 255]; a block a lane
// pair, the bound row ((B + 1) / 2, N + 1) packed words); sweep_shape the
// band height. Returns
// cudaGetLastError() after the launch.
extern "C" int pgs_strip_sweep(const void* x, long long x_lane, const void* y,
                               const void* y_off, long long y_len, const void* m,
                               const void* n, int M, int N, int B, const void* table,
                               int ncodes, int match, int mismatch, int gap_open,
                               int gap, void* bound, const void* bound_off, void* ck,
                               void* fck, int nck, void* score, void* best_i,
                               void* best_j, int sat, int skewed, int pair, void* stream) {
  const bool affine = gap_open > 0;
  const bool parity = sat || skewed;
  if (skewed < kColmajor || skewed > kSkewedEveryCell ||
      (pair && (!sat || skewed != kColmajor || match < 0 || match > 255 || mismatch < -255 ||
                mismatch > 0 || gap < 0 || gap > 255))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B > 0) {
    const SweepShape shape =
        sweep_shape(M, ck != nullptr, affine, table != nullptr, ncodes, parity, pair != 0);
    if (shape.kernel == nullptr || (parity && y_off != nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    shape.kernel<<<pair ? (B + 1) / 2 : B, shape.threads, shape.smem,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), x_lane, static_cast<const uint8_t*>(y),
        static_cast<const int64_t*>(y_off), y_len, static_cast<const int32_t*>(m),
        static_cast<const int32_t*>(n), M, N, B, static_cast<const int32_t*>(table), ncodes,
        match, mismatch, gap_open, gap, sat ? 255 : 0x7fffffff, skewed, shape.passes, bound,
        static_cast<const int64_t*>(bound_off), static_cast<int32_t*>(ck),
        static_cast<int32_t*>(fck), nck, static_cast<int32_t*>(score),
        static_cast<int32_t*>(best_i), static_cast<int32_t*>(best_j));
  }
  return static_cast<int>(cudaGetLastError());
}

// pgs_strip_sweep_occupancy: the launch pgs_strip_sweep makes for M rows
// (ckpt, affine != 0 as its ck and gap_open select; ncodes > 0 a table of
// that size; parity != 0 K27, pair != 0 its pair form) on the current
// device: out[0] threads a block, out[1] passes, out[2] the blocks an SM
// holds at once, out[3] rows a thread. Returns cudaGetLastError().
extern "C" int pgs_strip_sweep_occupancy(int M, int ckpt, int affine, int ncodes, int parity,
                                         int pair, void* out) {
  const SweepShape shape = sweep_shape(M, ckpt != 0, affine != 0, ncodes > 0, ncodes,
                                       parity != 0, pair != 0);
  if (shape.kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(out);
  o[0] = shape.threads;
  o[1] = shape.passes;
  o[2] = shape.blocks;
  o[3] = shape.rows;
  return static_cast<int>(cudaGetLastError());
}

// pgs_strip_moves: G strips [first, first + G) of every lane replayed in
// one launch into moves (G, B, N, 256) uint8 (columns a pair does not
// replay left unwritten). x (B, M), y (B, N) uint8, m, n (B,) int32; hrow
// (and, when gap_open > 0, frow) the incoming rows, strip t's for lane b at
// b * ld_lane + (t - row_first) * ld_strip int32s in, for t >= row_first, or
// null (zeros): K12/K16's (B, nck, N) checkpoints with row_first 1, or one
// (B, N) row with row_first = first and G = 1; walk_i, walk_j (B,) int32 and
// walk_active (B,) bool, the strip walk's state, or null (every column of
// every pair). gap_open > 0 selects K17, a table ((ncodes, ncodes) int32
// over compact codes) K21, both K24.
extern "C" int pgs_strip_moves(const void* x, const void* y, const void* m, const void* n,
                               int M, int N, int B, int G, int first, const void* hrow,
                               const void* frow, long long ld_lane, long long ld_strip,
                               int row_first, const void* walk_i, const void* walk_j,
                               const void* walk_active, const void* table, int ncodes,
                               int match, int mismatch, int gap_open, int gap, void* moves,
                               void* stream) {
  if (B > 0 && G > 0) {
    const int nc = table ? ncodes : 0;
    const long long blocks = ((long long)B * G + kReplayWarps - 1) / kReplayWarps;
    const ReplayKernel kernel = replay_kernel(gap_open > 0, nc > 0);
    kernel<<<(unsigned)blocks, kReplayWarps * 32, replay_smem(nc),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y),
        static_cast<const int32_t*>(m), static_cast<const int32_t*>(n), M, N, B, G, first,
        static_cast<const int32_t*>(hrow), static_cast<const int32_t*>(frow), ld_lane,
        ld_strip, row_first, static_cast<const int32_t*>(walk_i),
        static_cast<const int32_t*>(walk_j), static_cast<const uint8_t*>(walk_active),
        static_cast<const int32_t*>(table), nc, match, mismatch, gap_open, gap,
        static_cast<uint8_t*>(moves));
  }
  return static_cast<int>(cudaGetLastError());
}

// pgs_strip_moves_occupancy: the replay launch of pgs_strip_moves (affine !=
// 0 as gap_open > 0 selects it; ncodes > 0 a table of that size) on the
// current device: out[0] warps a block, out[1] the blocks an SM holds at
// once (the CUDA occupancy calculator). Returns cudaGetLastError().
extern "C" int pgs_strip_moves_occupancy(int affine, int ncodes, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = kReplayWarps;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[1], replay_kernel(affine != 0, ncodes > 0),
                                                kReplayWarps * 32, replay_smem(ncodes));
  return static_cast<int>(cudaGetLastError());
}
