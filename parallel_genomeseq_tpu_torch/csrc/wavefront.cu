// Smith-Waterman kernels for Hopper (sm_90a) of a warp per lane: uniform
// match/mismatch scoring (K1/K2, K6/K7) or an (ncodes, ncodes) substitution
// table over compact codes (K5/K9), linear or affine (Gotoh) gaps, exact
// int32 values.
//
// K1 `sw_warp_kernel<track_pos, false, false, kRows, kWarps, false>` replaces
//    the Pallas TPU kernel B1, parallel_genomeseq_tpu/ops/wavefront_pallas.py
//    `_kernel_uniform` (:160) via `_call_uniform` (:924): per-lane best
//    score, plus the argmax cell when track_pos is set (score-only for the
//    chunked window sweep).
// K2 `sw_warp_kernel<true, true, false, kRows, kWarps, false>` replaces B2,
//    `_kernel_uniform_moves` (:535) via `_call_uniform_moves` (:596): K1's
//    argmax plus one uint8 move/stop code per DP cell, written in the JAX
//    package's (D, M, B) diagonal-major layout (d = i + j - 2, r = i - 1)
//    that the traceback walk reads.
// K6 `sw_warp_kernel<track_pos, false, true, kRows, kWarps, false>` replaces
//    B5, `_kernel_uniform_affine` (:208) via `_call_uniform_affine` (:280):
//    K1 under the Gotoh recurrence (a gap of length L costs gap_open + L *
//    gap), score-only or argmax.
// K7 `sw_warp_kernel<true, true, true, kRows, kWarps, false>` replaces B6,
//    `_kernel_uniform_affine_moves` (:710, body `_affine_moves_body` :630) via
//    `_call_uniform_affine_moves` (:740): K6's argmax plus the affine move byte
//    of the JAX scan (ops/scan_dp.py:273-290) per DP cell, same layout as K2.
// K5 `sw_warp_kernel<true, true, false, kRows, kWarps, true>` replaces B4,
//    `_kernel_profile_moves` (:815) via `_call_profile_moves` (:874): K2 with
//    each cell scored from the table (the protein top-K re-run, x = entry, y
//    = query), its codes K2's (:818-822).
// K9 `sw_warp_kernel<true, true, true, kRows, kWarps, true>` replaces B8,
//    `_kernel_profile_affine_moves` (:724, body `_affine_moves_body` :630) via
//    `_call_profile_affine_moves` (:779): K7 with the table's scores, the
//    bytes that K10 walks.
// K26 `sw_warp_kernel<kTrackPos, kMoves, false, kRows, kWarps, kTable, true, kPair>`
//    (kParity, the reference-parity forms, built by csrc/wavefront_parity.cu
//    from this file) replaces JAX device code with no Pallas call: the
//    `lax.scan` wavefront of parallel_genomeseq_tpu/ops/scan_dp.py
//    (`_wavefront` :93, `_dp_step` :58) under Semantics.SAT_UINT8 and/or its
//    skewed tie (raw key :144-166, `_reduce_best_skewed` :325). Linear gaps,
//    uniform scores (or a table, exact values only); score-only, argmax or
//    moves, as K1/K2 (and K5). Two runtime arguments: `cap`, 255 under
//    saturation (one min a cell: with the operands clipped to [0, 255],
//    ops/scan_dp.sat_operands, the saturating step is the exact one clamped
//    at 255) or INT_MAX; and `skewed`, the tie-break (csrc/parity.cuh's Tie).
//    Colmajor keeps K1/K2's (min j, min i). Skewed: each thread keeps, among
//    its cells of the maximum score (> 0), the least raw key rj * (M + 33) +
//    ri -- the cell's place in the reference binary's skewed storage -- then
//    the least row, then the least column, and the warp, then the lane's
//    warps, reduce by (max score, min key, min i, min j), an order in which
//    every cell has one place, so no result depends on which thread saw a
//    cell first. A column's candidate is found at the wrap row (parity.cuh's
//    wrap_row_pick: the least row of the maximum past i = max(m, n) - j,
//    else the least one), its key computed alone, and a column that only
//    ties the thread's best is searched only when its least key lies below
//    the best's; past the 2^31 key bound the launch takes the least of the
//    keys of the column's rows of the maximum instead
//    (ops/wavefront_cuda.key_rule).
//    The pair form (kPair, the score-only sweep under saturation with
//    uniform scores): a thread's word holds the same row of two lanes, b and
//    b + 1, in signed 16-bit halves, and each DPX s16x2 instruction steps
//    both (parity.cuh's PairStep: four DPX and three other instructions a
//    pair of cells, against the int32 step's seven a cell). A unit of two
//    lanes steps to the longer; each half keeps its own best, masked past
//    its lane's m_b and n_b, and the halves go through the reduction one
//    after the other. ops/wavefront_cuda.parity_form takes it for the
//    score-only launches, where it measured faster than the int32 form
//    (PERF.md section 6); the argmax and the moves run the int32 form.
//
// The last template flag, kTable, says how a cell is scored (`UniformScore`,
// `TableScore`): uniform, match if the read byte equals the reference byte,
// else mismatch; table, s = tab[yc * ncodes + xc] from the transposed table
// in shared memory, one shared load a cell off the north chain (the chain
// needs s only through a), as the strip sweeps score a cell. Compact codes:
// code c + 1 = alphabet[c], code 0 any other byte (ops/scan_dp.py); a code
// >= ncodes reads as code 0 on both sides, as the plain version reads it.
// The table form is built for the moves mode only (K5/K9); the database
// scan K4/K8 is csrc/profile.cu's.
//
// Design: a warp per lane (one independent (read, reference window)
// alignment), the pipeline of csrc/strips.cu's sweeps inside the warp.
//   - Thread l holds kRows consecutive rows of the lane's read, rows l * kRows
//     + 1 .. (l + 1) * kRows: their H (and, affine, E) of the last column in
//     registers, the read bytes (K5/K9: the entry's codes) packed four a
//     register. At warp step s thread l works on column j = s - l + 1. Thread
//     l + 1 takes thread l's last-row H (affine: H and F) of the previous step
//     by __shfl_up_sync, and the column's reference byte (K5/K9: the query's
//     code) travels down the warp with it: thread 0 takes column s + 1's byte
//     from a 32-column word that the warp loads one word ahead from the lane's
//     own row of ys (B, N), one coalesced byte a thread, by __shfl_sync.
//     Thread 0's north is the zero row (H = 0, F(0, j) = 0). No device
//     memory is read or written in the step (K5/K9's table lives in shared
//     memory, loaded once a block); the kernel reads xs (B, M) and ys (B, N)
//     as they are. A group of kGroup = 8 steps is unrolled (up to 8 rows a
//     thread), so that one step's move code, best test and stores overlap
//     the next step's chain.
//   - The cell: the north-independent part a = max(diag + s, west - gap, 0)
//     by DPX __viaddmax_s32_relu, then one __viaddmax_s32 a row on the north
//     chain, H = max(north - gap, a); affine, E = max(west - open, E_west) -
//     extend (one DPX and a subtract) and a = max(diag + s, E, 0) off the
//     chain, and the F chain in strips.cu's form, one DPX a row: with H(k - 1)
//     = max(a(k - 1), F(k - 1)) and open > 0, F(k) = max(F(k - 1) - extend,
//     a(k - 1) - open - extend), H(k) = max(a(k), F(k)). The F extend bit,
//     F(k - 1) >= H(k - 1) - open, is then F(k - 1) >= a(k - 1) - open.
//   - Rows a thread and warps a lane, at launch: one warp a lane and the
//     fewest of 1, 2, 4, 8, 16, 32 rows a thread that cover M, up to 1,024
//     rows (4 at the main path's M = 128); two warps a lane of 32 rows a
//     thread up to MAX_M = 2,048 (ops/engine.py; longer reads go to the
//     strips), so that no thread holds 64 rows. Warp q + 1 of a lane trails
//     warp q by kLag = 40 steps and takes its last row's (H, F) from a
//     kRing-column ring in shared memory, written kLag - 31 >= 8 steps before
//     it is read, so that the barrier every kGroup steps orders the two (no
//     counts to poll). A lane steps n_b + (the place of the thread holding
//     row m_b in its warp) + kLag for each warp before it. K5/K9 take two
//     warps a lane past 64 rows too when there are no more lanes than SMs
//     (the protein top 10 on 10 SMs): the kLag steps cost less than the
//     half of each step's rows they save.
//   - K1/K6 with one warp a lane: no barrier, kScoreLanes warps a block.
//   - K2/K7 (and K5/K9) store their move bytes in runs. A block holds L
//     consecutive lanes that step together. Each thread writes its rows'
//     bytes of a step into shared memory laid out [step][row][lane] (rows
//     ordered (k, warp, thread), each row's lane words swizzled by thread so
//     that a warp's byte stores hit 32 banks), kGroup steps a buffer, two
//     buffers. After each group's barrier the block stores that buffer: each
//     cell's L lanes leave together as an L-byte run of the (D, M, B) layout,
//     in 4-byte words when B and L allow (2 or 1 otherwise), only the bytes
//     of cells inside their lane's m_b x n_b, a thread's 8 steps of one row
//     loaded first, then stored. The next group fills the other buffer, so
//     one barrier a group suffices. L: the largest power of two up to max_warps(kRows) / W whose
//     busiest SM holds no more warps than with L = 1 -- 4 at 512 lanes on 132
//     SMs (one block of 4 warps on 128 SMs), where L = 8 would put 8 warps on
//     64 SMs; chip_smoke.py prints the L = 1..16 curve.
//
// Exactness. Columns past n_b are not computed, nor warps wholly past m_b;
// the rows of a thread past m_b are, unmasked (they lie below every row <=
// m_b, so no such row reads them), but they count neither in the best nor
// in the stored bytes; rows past M read byte 0 and are never stored. A
// length beyond the padded shape is clamped to it (m_b <= M, n_b <= N), as
// the plain version clamps it, so no lane reads or writes outside its
// tensors. Boundaries are the JAX scan's (scan_dp.py:245-264, the ones its
// CPU route and the CSVs follow): H = 0 outside the matrix, E(i, 0) =
// -2^30, F(0, j) = 0. The move byte, linear: NW if diag >= max(west, north),
// else W if west >= north, else N, plus the stop bit 4 when any of the three
// is 0 (wavefront_pallas.py:574-579); affine: bits 0-1 the source of H,
// tested by equality in the order ZERO (H = 0), NW (H = diag + s), E, F; bit
// 3 when E extends (E(i, j-1) >= H(i, j-1) - gap_open); bit 4 when F extends
// (F(i-1, j) >= H(i-1, j) - gap_open).
//
// Tie-break: each thread keeps the first maximum of its own cells in (j, i)
// order (a strict > in column order, the lowest row of the column), and the
// warp, then the lane's warps, reduce by max score, then min j, then min i
// -- the column-major rule of scan_dp._reduce_best (scan_dp.py:303-321). An
// all-zero lane keeps (0, 0, 0); score-only launches return i = j = 0.
//
// What bounds them on the H100. K1/K6 at the window sweep's 8,704 lanes put
// 48-64 warps on an SM, so the SMs' issue of the step's instructions bounds
// them: about 5 integer instructions a cell (K6 about 8), and per step the
// three or four shuffles, the column maximum and the best test (PERF.md §6
// gives the cycles a column step against the count). K2/K7 at 512 lanes put
// 4 warps on an SM, one a scheduler, so the step's latency bounds them: each
// of the (n_b + 31) steps is the hand-off shuffle, the 4-deep chain, the
// move code (about 8 more instructions a cell, 12 affine), a shared-memory
// byte a cell and, a group at a time, the barrier and the runs' stores.
// Neither more lanes a block nor two warps a lane (2 rows a thread) shortens
// the main path's windows (PERF.md §6). K5/K9 re-run the protein top 10: 10
// lanes of two warps (8 to 32 rows a thread), 20 warps on 10 SMs, so the
// latency of a step bounds them, about as long with the table's scores as
// with uniform ones (tools/warp_curves.py; chip_smoke.py prints the cycles
// a column step and the curves of lanes a block and warps a lane).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "parity.cuh"

namespace {

constexpr int kNeg = -(1 << 30);  // E and F where no gap run can reach
constexpr unsigned kAll = 0xffffffffu;
constexpr int kRowChoices[] = {1, 2, 4, 8, 16, 32};  // rows a thread
constexpr int kNumRowChoices = sizeof(kRowChoices) / sizeof(kRowChoices[0]);
constexpr int kScoreLanes = 4;  // K1/K6: lanes a block at most
constexpr int kGroup = 8;       // steps between two barriers (and a staged buffer's steps)
constexpr int kLag = 40;        // steps warp q + 1 of a lane trails warp q
constexpr int kRing = 32;       // columns a hand-off ring between two warps holds
static_assert(kLag % kGroup == 0 && kLag - 31 >= kGroup && kRing >= kLag - 31 + 2 * kGroup,
              "a column handed on is read a barrier after it is written, and its slot "
              "rewritten a barrier after it is read");

// Warps a block at most with kRows rows a thread: 128 registers a thread
// up to 8 rows, 255 beyond. It also keeps K2/K7's two staged buffers, 2 x
// kGroup x 32 * kRows x warps bytes, within 64 KB.
__host__ __device__ constexpr int max_warps(int rows) {
  return rows <= 8 ? 16 : 128 / rows;
}

// (v1, j1, i1) before (v2, j2, i2): higher score, then smaller j, then i.
__device__ __forceinline__ bool better(int v1, int j1, int i1, int v2, int j2, int i2) {
  return v1 > v2 || (v1 == v2 && (j1 < j2 || (j1 == j2 && i1 < i2)));
}

__device__ __forceinline__ uint32_t clamp_code(uint32_t c, int ncodes) {
  return c < static_cast<uint32_t>(ncodes) ? c : 0u;
}

// The score s of row k in the thread's column, xw the thread's read bytes
// (or codes) four a word. Uniform: ybc holds the column's byte in all four
// bytes. Table: row is the column's code's row of the transposed table.
struct UniformScore {
  static constexpr bool kLoads = false;
  uint32_t ybc;
  int match, mismatch;
  template <int kWords>
  __device__ __forceinline__ int operator()(const uint32_t (&xw)[kWords], int k) const {
    return ((xw[k >> 2] ^ ybc) & (0xffu << (8 * (k & 3)))) == 0 ? match : mismatch;
  }
};
struct TableScore {
  static constexpr bool kLoads = true;
  const int32_t* row;
  template <int kWords>
  __device__ __forceinline__ int operator()(const uint32_t (&xw)[kWords], int k) const {
    return row[(xw[k >> 2] >> (8 * (k & 3))) & 0xffu];
  }
};

// The scores of the thread's kRows rows in its column. A table's are all
// read before the column stores its first move byte: the table and the
// staged bytes share the dynamic shared memory, so a load after a byte
// store could not start before it. Uniform scores are left to the loop.
template <int kRows, int kWords, class Score>
__device__ __forceinline__ void column_scores(int (&s)[kRows], const uint32_t (&xw)[kWords],
                                              const Score& score) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) s[k] = Score::kLoads ? score(xw, k) : 0;
}

template <int kRows, int kWords, class Score>
__device__ __forceinline__ int row_score(const int (&s)[kRows], const uint32_t (&xw)[kWords],
                                         const Score& score, int k) {
  return Score::kLoads ? s[k] : score(xw, k);
}

// One column of a thread's kRows rows, linear gaps: h holds H(., j - 1) on
// entry and H(., j) on return; nw = H(row0, j - 1) and north = H(row0, j)
// of the row above the thread's first (row0, 1-based). With kMoves, row k's
// move code is written to out[k * stride]. kParity (K26) clamps each H at
// cap.
template <bool kMoves, bool kParity, int kRows, int kWords, class Score>
__device__ __forceinline__ void column_linear(int (&h)[kRows], const uint32_t (&xw)[kWords],
                                              const Score& score, int gap, int cap, int nw,
                                              int north, uint8_t* out, int stride) {
  int s[kRows];
  column_scores(s, xw, score);
  int diag = nw;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int west = h[k];
    const int sk = row_score(s, xw, score, k);
    const int a = __viaddmax_s32_relu(diag, sk, west - gap);  // off the chain
    int v = __viaddmax_s32(north, -gap, a);                  // the north chain
    if constexpr (kParity) v = min(v, cap);                  // saturation (K26)
    if constexpr (kMoves) {
      const int wn = max(west, north);
      uint32_t mv = diag >= wn ? 0u : west >= north ? 1u : 2u;
      if (__vimin3_s32(diag, west, north) == 0) mv |= 4u;  // H >= 0: any of them 0
      out[k * stride] = static_cast<uint8_t>(mv);
    }
    diag = west;
    h[k] = v;
    north = v;
  }
}

// The pair form's column (K26's score-only sweep under saturation, kPair):
// h holds H(., j - 1) of the thread's kRows rows of two lanes, one a 16-bit
// half (parity.cuh's PairStep), on entry and H(., j) on return; xp the rows'
// read bytes and yp the column's reference bytes, one a half; nw and north
// as in column_linear.
template <int kRows>
__device__ __forceinline__ void column_pair(uint32_t (&h)[kRows], const uint32_t (&xp)[kRows],
                                            uint32_t yp, const PairStep& step, uint32_t nw,
                                            uint32_t north) {
  uint32_t diag = nw;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const uint32_t west = h[k];
    const uint32_t a = step.off_chain(xp[k], yp, diag, west);  // off the chain
    const uint32_t v = step.chain(north, a);                    // the north chain
    diag = west;
    h[k] = v;
    north = v;
  }
}

// The affine form: h and e hold H(., j - 1) and E(., j - 1) on entry and
// H(., j), E(., j) on return; f is F(row0, j) on entry and F of the thread's
// last row on return.
template <bool kMoves, int kRows, int kWords, class Score>
__device__ __forceinline__ void column_affine(int (&h)[kRows], int (&e)[kRows],
                                              const uint32_t (&xw)[kWords], const Score& score,
                                              int gap_open, int gap, int nw, int north, int& f,
                                              uint8_t* out, int stride) {
  int s[kRows];
  column_scores(s, xw, score);
  const int open_extend = gap_open + gap;
  bool fext = f >= north - gap_open;              // row0 + 1's F extend bit
  f = __viaddmax_s32(north, -gap_open, f) - gap;  // F(row0 + 1, j)
  int diag = nw;
  int a_prev = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int west = h[k];
    const int ek = __viaddmax_s32(west, -gap_open, e[k]) - gap;
    const int sk = row_score(s, xw, score, k);
    const int a = __viaddmax_s32_relu(diag, sk, ek);
    if (k > 0) {
      fext = f >= a_prev - gap_open;
      f = __viaddmax_s32(f, -gap, a_prev - open_extend);  // the F chain
    }
    const int v = max(a, f);
    if constexpr (kMoves) {
      uint32_t mv = v == 0 ? 3u : v == diag + sk ? 0u : v == ek ? 1u : 2u;
      if (e[k] >= west - gap_open) mv |= 8u;
      if (fext) mv |= 16u;
      out[k * stride] = static_cast<uint8_t>(mv);
    }
    e[k] = ek;
    diag = west;
    h[k] = v;
    a_prev = a;
  }
}

// The byte offset of lane w in a staged row of L lane bytes written by
// thread l: for L >= 8 the row's 4-byte words are swizzled by l, so that the
// 32 threads of a warp (32 rows, one lane) write 32 banks.
__device__ __forceinline__ int lane_offset(int w, int l, int L) {
  if (L < 8) return w;
  const int g = (l * (L >> 2)) >> 5;  // 0 .. L/4 - 1, constant over 32 / (L/4) threads
  return (((w >> 2) ^ g) << 2) | (w & 3);
}

// The block's store of one staged group (K2/K7): the bytes of steps s0 ..
// s0 + kGroup - 1 from buf (rows ((u * kRows + k) * W + qq) * 32 + l of L
// lane bytes) to moves (D, M, B), V lanes a store (V | L, V | B). Thread t
// stores lanes c * V .. c * V + V - 1 (c = t % (L / V)) of the rows that
// thread l of warp qq holds at their k-th row, for idx = k * W + qq in
// {idx0, idx0 + V * W, ...}, every step of the group; a unit whose lanes do
// not all hold the cell is stored byte by byte. lane_m and lane_n hold the
// block's clamped lengths.
template <int V, int kRows, int W>
__device__ __forceinline__ void store_group(const uint8_t* buf, uint8_t* __restrict__ moves,
                                            const int* lane_m, const int* lane_n, int s0,
                                            int M, int B, int b0, int L) {
  using Word = typename std::conditional<
      V == 4, uint32_t, typename std::conditional<V == 2, uint16_t, uint8_t>::type>::type;
  const int per = L / V;
  const int rest = threadIdx.x / per;
  const int w0 = (threadIdx.x - rest * per) * V;
  const int l = rest & 31;
  int mlo = lane_m[w0], mhi = mlo, nlo = lane_n[w0], nhi = nlo;
#pragma unroll
  for (int v = 1; v < V; ++v) {
    mlo = min(mlo, lane_m[w0 + v]);
    mhi = max(mhi, lane_m[w0 + v]);
    nlo = min(nlo, lane_n[w0 + v]);
    nhi = max(nhi, lane_n[w0 + v]);
  }
  const long long MB = (long long)M * B;
  const int off = lane_offset(w0, l, L);
  const int step_bytes = kRows * W * 32 * L;  // staged step u to u + 1 of one row
  for (int idx = rest >> 5; idx < kRows * W; idx += V * W) {
    const int k = idx / W;
    const int qq = idx - k * W;
    const int r = (qq * 32 + l) * kRows + k;  // 0-based row
    if (r >= mhi) continue;
    const int j0 = s0 - l + 1 - qq * kLag;  // the column of step s0
    const long long at = ((long long)(r + j0 - 1) * M + r) * B + b0 + w0;
    const uint8_t* src = buf + (idx * 32 + l) * L + off;
    Word word[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) word[u] = *reinterpret_cast<const Word*>(src + u * step_bytes);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = j0 + u;
      if (j < 1 || j > nhi) continue;
      if (r < mlo && j <= nlo) {
        *reinterpret_cast<Word*>(moves + at + u * MB) = word[u];
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (r < lane_m[w0 + v] && j <= lane_n[w0 + v]) {
            moves[at + u * MB + v] = src[u * step_bytes + v];
          }
        }
      }
    }
  }
}

// The steps a lane of lengths (mm, nn) takes: n_b + the place of the thread
// holding row m_b in its warp + kLag a warp before it.
__device__ __forceinline__ int lane_steps(int mm, int nn, int rows) {
  if (mm <= 0 || nn <= 0) return 0;
  const int g = (mm - 1) / rows;  // that thread, counted over the lane's warps
  return nn + (g & 31) + (g >> 5) * kLag;
}

// The bytes of K5/K9's transposed (ncodes, ncodes) int32 table at the head
// of the dynamic shared memory, rounded up to 16 (0 for uniform scoring).
__host__ __device__ constexpr int table_bytes(int ncodes) {
  return (ncodes * ncodes * 4 + 15) & ~15;
}

// K1 (kMoves = false) and K2 (kMoves = true, which implies kTrackPos), and
// with kAffine K6 and K7; with kTable (moves only) K5 and K9; with kParity
// (linear gaps; kTable with or without moves) K26, whose H is clamped at
// cap and whose argmax takes the tie `skewed` (parity.cuh's Tie); with
// kPair too, K26's pair form (score-only, cap 255, uniform scores), whose
// words hold the same rows of two lanes, b and b + 1, a 16-bit half each.
// A unit is a
// lane (a lane pair with kPair): kRows rows a thread, W warps a unit (32 *
// W * kRows >= M). xs (B, M) and ys (B, N) uint8 (K5/K9: compact codes,
// table (ncodes, ncodes) int32), m and n (B,) int32; moves (M + N - 1, M,
// B) uint8 (K2/K7, K5/K9). A block holds blockDim.x / (32 W) consecutive
// units, unit w's W warps consecutive. Dynamic shared memory: (K5/K9) the
// transposed table, table_bytes(ncodes), then the hand-off rings, (W - 1) x
// units x kRing int2, then (moves) the two staged buffers, 2 x kGroup x W *
// 32 * kRows x lanes bytes.
template <bool kTrackPos, bool kMoves, bool kAffine, int kRows, int kWarps, bool kTable,
          bool kParity, bool kPair = false>
__global__ void __launch_bounds__(32 * max_warps(kRows))
sw_warp_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ ys,
               const int32_t* __restrict__ m, const int32_t* __restrict__ n, int M, int N,
               int B, int match, int mismatch, int gap_open, int gap,
               const int32_t* __restrict__ table, int ncodes, int cap, int skewed,
               int32_t* __restrict__ score, int32_t* __restrict__ best_i,
               int32_t* __restrict__ best_j, uint8_t* __restrict__ moves) {
  static_assert(kMoves || !kTable || kParity,
                "the table form is the moves mode's (K5/K9) or K26's");
  static_assert(!kParity || !kAffine, "K26 is linear-gap only");
  static_assert(!kPair || (kParity && !kTable && !kTrackPos && !kMoves),
                "the pair form is K26's score-only sweep, scored uniformly");
  constexpr int P = kPair ? 2 : 1;  // lanes a unit
  // The read bytes: four rows a word, or (kPair) a row's two lanes a word.
  constexpr int kWords = kPair ? kRows : (kRows + 3) / 4;
  constexpr int W = kWarps;
  // A group's steps unrolled, so that one step's moves, best and stores
  // overlap the next one's chain; not for the long reads' wide threads,
  // whose steps are long enough alone (and whose unrolled code is large).
  constexpr int kUnroll = kRows <= 8 ? kGroup : 1;
  using Cell = std::conditional_t<kPair, uint32_t, int>;  // a row's H, or a pair's two
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int lane_m[32];  // the block's clamped lengths (barrier launches)
  __shared__ int lane_n[32];
  __shared__ int red[4][kWarps > 1 ? 32 : 1];  // each warp's (best, j, i, key)
  const int wi = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const int L = (blockDim.x >> 5) / W;  // units a block
  const int LP = L * P;                 // lanes a block
  const int w = wi / W;       // the unit's place in the block
  const int q = wi - w * W;   // the warp's place in its unit
  const int b0 = blockIdx.x * LP;
  const int b = b0 + w * P;   // the unit's first lane
  // A barrier every kGroup steps (and after K26's table load).
  constexpr bool sync = kMoves || W > 1 || kTable;
  int32_t* const tab = reinterpret_cast<int32_t*>(dyn);  // kTable: tab[yc * ncodes + xc]
  const int tbytes = kTable ? table_bytes(ncodes) : 0;
  int2* const ring = reinterpret_cast<int2*>(dyn + tbytes);  // [W - 1][L][kRing]
  uint8_t* const stage = dyn + tbytes + (size_t)(W - 1) * L * kRing * sizeof(int2);
  if constexpr (kTable) {  // table[xc][yc], transposed; the barrier below orders it
    for (int k = threadIdx.x; k < ncodes * ncodes; k += blockDim.x) {
      tab[(k % ncodes) * ncodes + k / ncodes] = table[k];
    }
  }
  // A byte of the read or the reference (K5/K9: a code, clamped to the table).
  const auto code = [ncodes](uint32_t c) { return kTable ? clamp_code(c, ncodes) : c; };
  int mb[P], nb[P];  // the unit's lanes' clamped lengths
  int steps = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    mb[v] = b + v < B ? max(min(m[b + v], M), 0) : 0;
    nb[v] = b + v < B ? max(min(n[b + v], N), 0) : 0;
    if (kPair && (mb[v] == 0 || nb[v] == 0)) mb[v] = nb[v] = 0;  // an empty half
    steps = max(steps, lane_steps(mb[v], nb[v], kRows));
  }
  const int mmax = max(mb[0], mb[P - 1]);  // the unit's rows and columns
  const int nmax = max(nb[0], nb[P - 1]);
  int V = 1;
  if constexpr (sync) {
    // Every warp of the block takes the block's step count (its barriers).
    if (q == 0 && l == 0) {
#pragma unroll
      for (int v = 0; v < P; ++v) {
        lane_m[w * P + v] = mb[v];
        lane_n[w * P + v] = nb[v];
      }
    }
    __syncthreads();
    for (int v = 0; v < LP; ++v) steps = max(steps, lane_steps(lane_m[v], lane_n[v], kRows));
    V = (LP % 4 == 0 && B % 4 == 0) ? 4 : (LP % 2 == 0 && B % 2 == 0) ? 2 : 1;
  } else if (b >= B) {
    return;
  }
  const int row0 = (q * 32 + l) * kRows;  // 0-based first row of the thread
  const bool active = q * 32 * kRows < mmax;  // warp-uniform: the warp holds a row <= m_b
  int nvalid[P];          // the thread's rows up to each lane's m_b
  const uint8_t* yl[P];   // each lane's reference
  uint32_t xw[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) xw[i] = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    nvalid[v] = min(max(mb[v] - row0, 0), kRows);
    const int lane = b + v < B ? b + v : 0;
    const uint8_t* xl = xs + (size_t)lane * M;
    yl[v] = ys + (size_t)lane * N;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k >= nvalid[v]) continue;
      if constexpr (kPair) {
        xw[k] |= static_cast<uint32_t>(xl[row0 + k]) << (16 * v);
      } else {
        xw[k >> 2] |= code(xl[row0 + k]) << (8 * (k & 3));
      }
    }
  }
  // The pair form's per-thread masks: a half past its lane's n_b, or a
  // thread wholly past its m_b, counts nothing in the best; the thread that
  // holds a lane's m_b masks its rows past it.
  int ncount[P];
#pragma unroll
  for (int v = 0; v < P; ++v) ncount[v] = nvalid[v] > 0 ? nb[v] : 0;
  const bool straddle = kPair && ((nvalid[0] > 0 && nvalid[0] < kRows) ||
                                  (nvalid[P - 1] > 0 && nvalid[P - 1] < kRows));
  uint32_t vbits[P];  // the skewed search's rows: bit k for each row up to m_b
#pragma unroll
  for (int v = 0; v < P; ++v) vbits[v] = nvalid[v] >= 32 ? ~0u : (1u << nvalid[v]) - 1u;
  const PairStep pstep(match, mismatch, gap);
  Cell h[kRows];
  int e[kAffine ? kRows : 1];  // affine: E(., j - 1), kNeg in column 0
#pragma unroll
  for (int k = 0; k < kRows; ++k) h[k] = 0;
#pragma unroll
  for (int k = 0; k < (kAffine ? kRows : 1); ++k) e[k] = kNeg;
  Cell nw = 0;    // H(row0, j - 1): the previous column's north input
  int flast = 0;  // affine: F of the thread's last row in its last column
  int yc = 0;     // the byte of this thread's column (kPair: the two lanes', a half each)
  Cell best = 0;  // kPair: each half's best
  int bi[P], bj[P], bkey[P];  // K26, skewed: bkey the raw key of (bi, bj)
#pragma unroll
  for (int hh = 0; hh < P; ++hh) {
    bi[hh] = bj[hh] = 0;
    bkey[hh] = 0x7fffffff;
  }
  const bool by_key = kParity && kTrackPos && skewed != kColmajor;  // K26's skewed argmax
  // Column k + 1's byte (code), or with kPair the two lanes' bytes.
  const auto y_at = [&](int k) -> int {
    if constexpr (kPair) {
      return yl[0][k] | yl[P - 1][k] << 16;
    } else {
      return code(yl[0][k]);
    }
  };
  int ycur = 0;   // thread t of word k holds column 32k + t + 1's byte
  int ynext = l < nmax ? y_at(l) : 0;
  const int lag = q * kLag;
  const int stride = W * 32 * L;  // staged rows k and k + 1 of one thread
  int2* const ring_in = ring + (max(q - 1, 0) * L + w) * kRing;  // q > 0: warp q - 1's last row
  int2* const ring_out = ring + (q * L + w) * kRing;       // q + 1 < W: this warp's
  for (int s0 = 0; s0 < steps; s0 += kGroup) {
    const int sl0 = s0 - lag;  // the warp's own step count at the group's head
    if (sl0 >= 0 && (sl0 & 31) == 0) {
      ycur = ynext;
      const int k = sl0 + 32 + l;
      ynext = k < nmax ? y_at(k) : 0;
    }
    uint8_t* buf = stage + ((s0 / kGroup) & 1) * (kGroup * kRows * W * 32 * L);
#pragma unroll kUnroll
    for (int u = 0; u < kGroup; ++u) {
      const int sl = sl0 + u;
      Cell north = __shfl_up_sync(kAll, h[kRows - 1], 1);
      int f = kAffine ? __shfl_up_sync(kAll, flast, 1) : 0;
      yc = __shfl_up_sync(kAll, yc, 1);
      const int yfirst = __shfl_sync(kAll, ycur, sl & 31);
      const int j = sl - l + 1;
      const bool on = active && j >= 1 && j <= nmax;
      if (l == 0) {  // the row above the warp: zero above row 1, else warp q - 1's
        yc = yfirst;
        north = 0;
        f = 0;
        if constexpr (W > 1) {
          if (q > 0 && on) {
            const int2 v = ring_in[j & (kRing - 1)];
            north = static_cast<Cell>(v.x);
            f = v.y;
          }
        }
      }
      if (on) {
        uint8_t* out = kMoves ? buf + ((u * kRows * W + q) * 32 + l) * L + lane_offset(w, l, L)
                              : nullptr;
        if constexpr (kPair) {
          column_pair(h, xw, static_cast<uint32_t>(yc), pstep, nw, north);
        } else {
          const auto sc = [&] {
            if constexpr (kTable) {
              return TableScore{tab + yc * ncodes};
            } else {
              return UniformScore{static_cast<uint32_t>(yc) * 0x01010101u, match, mismatch};
            }
          }();
          if constexpr (kAffine) {
            column_affine<kMoves>(h, e, xw, sc, gap_open, gap, nw, north, f, out, stride);
            flast = f;
          } else {
            column_linear<kMoves, kParity>(h, xw, sc, gap, cap, nw, north, out, stride);
          }
        }
        if constexpr (W > 1) {
          if (l == 31 && q + 1 < W) {
            ring_out[j & (kRing - 1)] = make_int2(static_cast<int>(h[kRows - 1]), f);
          }
        }
        if constexpr (kPair) {
          // Each half's column maximum over its rows up to m_b and its
          // columns up to n_b, kept where it passes the half's best.
          uint32_t colmax = h[0];
#pragma unroll
          for (int k = 1; k + 1 < kRows; k += 2) colmax = __vimax3_s16x2(colmax, h[k], h[k + 1]);
          if (kRows % 2 == 0 && kRows > 1) colmax = __vimax_s16x2_relu(colmax, h[kRows - 1]);
          const uint32_t cmask = (j <= ncount[0] ? 0xffffu : 0u) |
                                 (j <= ncount[P - 1] ? 0xffff0000u : 0u);
          colmax &= cmask;
          bool keep_hi, keep_lo;  // best >= colmax, a half each
          __vibmax_s16x2(best, colmax, &keep_hi, &keep_lo);
          if (!keep_hi || !keep_lo) {
            if (straddle) {  // each half's rows up to its m_b only
              colmax = 0;
#pragma unroll
              for (int k = 0; k < kRows; ++k) {
                colmax = __vimax_s16x2_relu(
                    colmax, h[k] & ((k < nvalid[0] ? 0xffffu : 0u) |
                                    (k < nvalid[P - 1] ? 0xffff0000u : 0u)));
              }
              colmax &= cmask;
            }
            best = __vimax_s16x2_relu(best, colmax);
          }
        } else {
          int colmax = h[0];
#pragma unroll
          for (int k = 1; k + 1 < kRows; k += 2) colmax = __vimax3_s32(colmax, h[k], h[k + 1]);
          if (kRows % 2 == 0 && kRows > 1) colmax = max(colmax, h[kRows - 1]);
          if (by_key) {
            // The column's cells of the maximum, if it reaches the best: the
            // least raw key, the least row on equal keys.
            if (colmax >= best && colmax > 0) {
              if (nvalid[0] < kRows) {  // the thread holding m_b: its rows up to m_b only
                colmax = 0;
#pragma unroll
                for (int k = 0; k < kRows; ++k) colmax = k < nvalid[0] ? max(colmax, h[k]) : colmax;
              }
              if (colmax >= best && colmax > 0 &&
                  (colmax > best || skewed != kSkewedWrap ||
                   tie_may_win(mb[0], nb[0], M, row0, j, kRows, bkey[0]))) {
                // The rows of the maximum, then the candidate's key.
                uint32_t eq = 0;
#pragma unroll
                for (int k = 0; k < kRows; ++k) eq |= (h[k] == colmax ? 1u : 0u) << k;
                const RawKey raw_key(mb[0], nb[0], M);  // off the column loop's registers
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
          } else if (colmax > best) {
            if (nvalid[0] < kRows) {  // the thread holding m_b: its rows up to m_b only
              colmax = 0;
#pragma unroll
              for (int k = 0; k < kRows; ++k) colmax = k < nvalid[0] ? max(colmax, h[k]) : colmax;
            }
            if (colmax > best) {
              best = colmax;
              if (kTrackPos) {
                int kk = 0;
#pragma unroll
                for (int k = kRows - 1; k >= 0; --k) kk = h[k] == colmax ? k : kk;
                bi[0] = row0 + kk + 1;
                bj[0] = j;
              }
            }
          }
        }
        nw = north;
      }
    }
    if constexpr (sync) __syncthreads();  // the group's columns handed on, its buffer whole
    if constexpr (kMoves) {
      if (V == 4) {
        store_group<4, kRows, W>(buf, moves, lane_m, lane_n, s0, M, B, b0, L);
      } else if (V == 2) {
        store_group<2, kRows, W>(buf, moves, lane_m, lane_n, s0, M, B, b0, L);
      } else {
        store_group<1, kRows, W>(buf, moves, lane_m, lane_n, s0, M, B, b0, L);
      }
    }
  }
  // Each lane of the unit: a warp reduction of (best, bj, bi) (K26 skewed:
  // and bkey, in its order), then (W > 1) over the unit's warps.
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
    if constexpr (W > 1) {
      if (hh > 0) __syncthreads();  // the first lane's reduction has read red
      if (l == 0) {
        red[0][wi] = v;
        red[1][wi] = vj;
        red[2][wi] = vi;
        red[3][wi] = vk;
      }
      __syncthreads();
      if (l == 0 && q == 0) {
        for (int u = wi + 1; u < wi + W; ++u) {
          const int k2 = red[3][u];
          if (by_key ? better_skewed(red[0][u], k2, red[2][u], red[1][u], v, vk, vi, vj)
                     : better(red[0][u], red[1][u], red[2][u], v, vj, vi)) {
            v = red[0][u];
            vj = red[1][u];
            vi = red[2][u];
            vk = k2;
          }
        }
      }
    }
    if (l == 0 && q == 0 && b + hh < B) {
      score[b + hh] = v;
      best_i[b + hh] = v > 0 ? vi : 0;
      best_j[b + hh] = v > 0 ? vj : 0;
    }
  }
}

using SwKernel = void (*)(const uint8_t*, const uint8_t*, const int32_t*, const int32_t*, int,
                          int, int, int, int, int, int, const int32_t*, int, int, int, int32_t*,
                          int32_t*, int32_t*, uint8_t*);

// The kernels' forms: score-only, argmax and moves scored uniformly (K1/K6,
// K2/K7), moves scored from a table (K5/K9), and, K26 only, argmax scored
// from a table and the pair form's score-only sweep.
enum Form { kScoreOnly, kArgmax, kMovesMode, kTableMoves, kTableArgmax, kPairScore, kNumForms };

// This translation unit's forms: K1-K9 here; K26's when
// csrc/wavefront_parity.cu includes this file (a unit of its own, so that
// nvcc builds the two sets of instantiations in parallel).
#if defined(PGS_WAVEFRONT_PARITY)
constexpr bool kParityUnit = true;
#else
constexpr bool kParityUnit = false;
#endif

template <bool kAffine, int kWarps, int I = 0>
void fill_kernels(SwKernel (*out)[kNumRowChoices]) {
  if constexpr (I < kNumRowChoices) {
    constexpr int R = kRowChoices[I];
    if constexpr (kParityUnit) {
      if constexpr (!kAffine) {  // K26: linear gaps only
        out[kScoreOnly][I] = &sw_warp_kernel<false, false, false, R, kWarps, false, true>;
        out[kArgmax][I] = &sw_warp_kernel<true, false, false, R, kWarps, false, true>;
        out[kMovesMode][I] = &sw_warp_kernel<true, true, false, R, kWarps, false, true>;
        out[kTableMoves][I] = &sw_warp_kernel<true, true, false, R, kWarps, true, true>;
        out[kTableArgmax][I] = &sw_warp_kernel<true, false, false, R, kWarps, true, true>;
        out[kPairScore][I] = &sw_warp_kernel<false, false, false, R, kWarps, false, true, true>;
      }
    } else {
      out[kScoreOnly][I] = &sw_warp_kernel<false, false, kAffine, R, kWarps, false, false>;
      out[kArgmax][I] = &sw_warp_kernel<true, false, kAffine, R, kWarps, false, false>;
      out[kMovesMode][I] = &sw_warp_kernel<true, true, kAffine, R, kWarps, false, false>;
      out[kTableMoves][I] = &sw_warp_kernel<true, true, kAffine, R, kWarps, true, false>;
    }
    fill_kernels<kAffine, kWarps, I + 1>(out);
  }
}

// Every instantiation of this unit, [warps a lane - 1][affine][mode][rows a
// thread]; null where the unit has no such form.
struct SwKernels {
  SwKernel at[2][2][kNumForms][kNumRowChoices] = {};
  SwKernels() {
    fill_kernels<false, 1>(at[0][0]);
    fill_kernels<true, 1>(at[0][1]);
    fill_kernels<false, 2>(at[1][0]);
    fill_kernels<true, 2>(at[1][1]);
  }
};

struct SwLaunch {
  SwKernel kernel;
  int rows, lanes, warps, blocks;  // rows a thread, units a block, warps a unit, blocks an SM
  size_t smem;
};

// The warps on the busiest SM when B units of W warps run L to a block on
// `sms` SMs.
int busiest_sm(int B, int L, int W, int sms) {
  const int blocks = (B + L - 1) / L;
  return (blocks + sms - 1) / sms * L * W;
}

constexpr int kMaxCodes = 64;  // K5/K9's table: 64 x 64 int32, 16 KB of shared memory

// The launch for B lanes of M rows (mode 0 score-only, 1 argmax, 2 moves;
// ncodes > 0 the table form: K5/K9 with moves, K26 also argmax; pair
// K26's pair form, score-only), in units of a lane, or of two with pair.
// W, the warps a unit:
// `warps` if given (1 or 2), else 1 up to 1,024 rows and 2 beyond; the
// table form also takes 2 past 64 rows when there are no more lanes than
// SMs (the protein top 10: two warps of half the rows run faster there,
// tools/warp_curves.py, PERF.md §6). kRows: the least choice with 32 * W *
// kRows >= M. L, the units a block: `lanes` if given, else the
// largest power of two up to kScoreLanes (K1/K6) or max_warps(kRows) / W
// (the moves) whose busiest SM holds no more warps than with L = 1. The
// blocks an SM from the CUDA occupancy calculator.
cudaError_t sw_launch(int M, int B, bool affine, int mode, int ncodes, bool pair, int lanes,
                      int warps, SwLaunch* out) {
  if (M < 0 || B < 0 || mode < 0 || mode > 2 || lanes < 0 || warps < 0 || ncodes < 0 ||
      ncodes > kMaxCodes || (ncodes > 0 && mode == kScoreOnly) ||
      (pair && (mode != kScoreOnly || ncodes > 0 || affine))) {
    return cudaErrorInvalidValue;
  }
  const bool moves = mode == kMovesMode;
  const int U = pair ? (B + 1) / 2 : B;  // units
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int W = warps;
  if (W == 0) W = M > 32 * 32 || (ncodes > 0 && U <= sms && M > 32 * 2) ? 2 : 1;
  int i = 0;
  while (i < kNumRowChoices && 32 * W * kRowChoices[i] < M) ++i;
  if (i == kNumRowChoices || W > 2) return cudaErrorInvalidValue;
  const int rows = kRowChoices[i];
  const int lmax = moves ? max_warps(rows) / W : min(kScoreLanes, max_warps(rows) / W);
  int L = lanes;
  if (L == 0) {
    L = 1;
    for (int c = 2; c <= lmax; c *= 2) {
      if (busiest_sm(U, c, W, sms) <= busiest_sm(U, 1, W, sms)) L = c;
    }
  }
  if (L < 1 || L > lmax || (L & (L - 1)) != 0) return cudaErrorInvalidValue;
  static const SwKernels kernels;
  const size_t ring = (size_t)(W - 1) * L * kRing * 8;
  const int form = pair ? kPairScore : ncodes == 0 ? mode : moves ? kTableMoves : kTableArgmax;
  SwLaunch S{kernels.at[W - 1][affine][form][i], rows, L, W, 0,
             (ncodes > 0 ? table_bytes(ncodes) : 0) + ring +
                 (moves ? (size_t)2 * kGroup * W * 32 * rows * L : 0)};
  if (S.kernel == nullptr) return cudaErrorInvalidValue;  // not a form of this unit
  err = cudaFuncSetAttribute(S.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&S.blocks, S.kernel, 32 * L * W, S.smem);
  if (err != cudaSuccess) return err;
  *out = S;
  return cudaSuccess;
}

// Launch pgs_sw_score's kernel (below) with K26's cap, tie and form arguments.
int sw_run(const void* xs, const void* ys, const void* m, const void* n, int M, int N, int B,
           int match, int mismatch, int gap_open, int gap, const void* table, int ncodes,
           int track_pos, int cap, int skewed, bool pair, int lanes, int warps, void* score,
           void* best_i, void* best_j, void* moves, void* stream) {
  if ((table == nullptr) != (ncodes == 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    SwLaunch S;
    const int mode = moves ? kMovesMode : track_pos ? kArgmax : kScoreOnly;
    const cudaError_t err = sw_launch(M, B, gap_open > 0, mode, ncodes, pair, lanes, warps, &S);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int units = pair ? (B + 1) / 2 : B;
    S.kernel<<<(units + S.lanes - 1) / S.lanes, 32 * S.lanes * S.warps, S.smem,
               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(xs), static_cast<const uint8_t*>(ys),
        static_cast<const int32_t*>(m), static_cast<const int32_t*>(n), M, N, B, match,
        mismatch, gap_open, gap, static_cast<const int32_t*>(table), ncodes, cap, skewed,
        static_cast<int32_t*>(score), static_cast<int32_t*>(best_i),
        static_cast<int32_t*>(best_j), static_cast<uint8_t*>(moves));
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of sw_run's kernel into out[0..4] (see pgs_sw_score_shape).
int sw_shape(int M, int B, int affine, int mode, int ncodes, bool pair, int lanes, int warps,
             void* out) {
  SwLaunch S;
  const cudaError_t err = sw_launch(M, B, affine != 0, mode, ncodes, pair, lanes, warps, &S);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = S.rows;
  o[1] = S.lanes;
  o[2] = S.warps;
  o[3] = S.blocks;
  o[4] = static_cast<int>(S.smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if !defined(PGS_WAVEFRONT_PARITY)

// Plain C entry point, bound with ctypes. Every pointer is a device pointer to
// a contiguous tensor: xs (B, M) uint8, ys (B, N) uint8, m and n (B,) int32,
// score/best_i/best_j (B,) int32, and moves (M + N - 1, M, B) uint8 for
// K2/K7 and K5/K9 or null for K1/K6. table null and ncodes 0 score uniformly
// (match, mismatch); else table (ncodes, ncodes) int32 scores xs and ys as
// compact codes, moves only (K5/K9). gap_open > 0 selects the affine
// kernels; lanes (a block) and warps (a lane) are 0 for the rules of
// sw_launch. M may be at most 32 x 32 x the warps a lane (2,048 by the
// rule). Returns a cudaError_t: cudaGetLastError() after the launch.
extern "C" int pgs_sw_score(const void* xs, const void* ys, const void* m, const void* n,
                            int M, int N, int B, int match, int mismatch, int gap_open,
                            int gap, const void* table, int ncodes, int track_pos, int lanes,
                            int warps, void* score, void* best_i, void* best_j, void* moves,
                            void* stream) {
  return sw_run(xs, ys, m, n, M, N, B, match, mismatch, gap_open, gap, table, ncodes,
                track_pos, 0x7fffffff, 0, false, lanes, warps, score, best_i, best_j, moves,
                stream);
}

// pgs_sw_score_shape: the launch pgs_sw_score makes for B lanes of M rows
// (affine as gap_open > 0 selects it; mode 0 score-only, 1 argmax, 2 moves;
// ncodes > 0 the table form, moves only; lanes and warps as there) on the
// current device: out[0] rows a thread, out[1] lanes a block, out[2] warps a
// lane, out[3] blocks an SM (the occupancy calculator), out[4] dynamic
// shared bytes a block. Returns a cudaError_t.
extern "C" int pgs_sw_score_shape(int M, int B, int affine, int mode, int ncodes, int lanes,
                                  int warps, void* out) {
  return sw_shape(M, B, affine, mode, ncodes, false, lanes, warps, out);
}

// Message for a cudaError_t returned by an entry point above.
extern "C" const char* pgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#else

// K26's entry point (built from csrc/wavefront_parity.cu): pgs_sw_score's
// arguments, linear gaps only, plus sat (clamp every H at 255; the caller
// passes the clipped operands of ops/scan_dp.sat_operands), skewed (0 the
// column-major tie-break, 1 the reference binary's raw-key one with each
// column's key found at the wrap row, 2 the same with the key of every cell
// of a column's maximum: parity.cuh's Tie) and pair (the pair form: two
// lanes a thread's word, the score-only sweep under sat with uniform scores
// and the operands in [0, 255] only; lanes then counts lane pairs a block).
// A table (ncodes > 0) takes the argmax or the moves mode.
extern "C" int pgs_sw_score_parity(const void* xs, const void* ys, const void* m,
                                   const void* n, int M, int N, int B, int match, int mismatch,
                                   int gap, const void* table, int ncodes, int track_pos,
                                   int sat, int skewed, int pair, int lanes, int warps,
                                   void* score, void* best_i, void* best_j, void* moves,
                                   void* stream) {
  if (skewed < kColmajor || skewed > kSkewedEveryCell ||
      (pair && (!sat || table != nullptr || track_pos || moves != nullptr || match < 0 ||
                match > 255 || mismatch < -255 || mismatch > 0 || gap < 0 || gap > 255))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return sw_run(xs, ys, m, n, M, N, B, match, mismatch, 0, gap, table, ncodes, track_pos,
                sat ? 255 : 0x7fffffff, skewed, pair != 0, lanes, warps, score, best_i, best_j,
                moves, stream);
}

// pgs_sw_score_parity_shape: pgs_sw_score_shape for K26's launch (linear;
// mode 0-2; ncodes > 0 with mode 1 or 2; pair the pair form, mode 0 and
// ncodes 0, its out[1] the lane pairs a block).
extern "C" int pgs_sw_score_parity_shape(int M, int B, int mode, int ncodes, int pair,
                                         int lanes, int warps, void* out) {
  return sw_shape(M, B, 0, mode, ncodes, pair != 0, lanes, warps, out);
}

#endif
