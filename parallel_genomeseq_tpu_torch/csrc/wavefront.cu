// Smith-Waterman score kernels for Hopper (sm_90a), uniform match/mismatch
// scoring, linear or affine (Gotoh) gaps, exact int32 values.
//
// K1 `sw_kernel<track_pos, false, false>` replaces the Pallas TPU kernel B1,
//    parallel_genomeseq_tpu/ops/wavefront_pallas.py `_kernel_uniform` (:160)
//    via `_call_uniform` (:924): per-lane best score, plus the argmax cell
//    when track_pos is set (score-only for the chunked window sweep).
// K2 `sw_kernel<true, true, false>` replaces B2, `_kernel_uniform_moves` (:535) via
//    `_call_uniform_moves` (:596): K1's argmax plus one uint8 move/stop code
//    per DP cell, written in the JAX package's (D, M, B) diagonal-major layout
//    (d = i + j - 2, r = i - 1) that the traceback walk reads.
// K6 `sw_kernel<track_pos, false, true>` replaces B5, `_kernel_uniform_affine`
//    (:208) via `_call_uniform_affine` (:280): K1 under the Gotoh recurrence
//    (a gap of length L costs gap_open + L * gap), score-only or argmax.
// K7 `sw_kernel<true, true, true>` replaces B6, `_kernel_uniform_affine_moves`
//    (:710, body `_affine_moves_body` :630) via `_call_uniform_affine_moves`
//    (:740): K6's argmax plus the affine move byte of the JAX scan
//    (ops/scan_dp.py:273-290) per DP cell, same layout as K2.
//
// Design: one CUDA thread per lane (one independent (read, reference window)
// alignment). Each thread sweeps its own m_b x n_b matrix column by column
// (j outer, i inner), so its loops are bounded by the lane's true lengths and
// no pad byte is ever scored. A length beyond the padded shape is clamped to
// it (m_b <= M, n_b <= N), as the plain version clamps it, so no lane reads or
// writes outside its tensors whatever the caller passes. The previous column lives in a scratch plane
// hcol (M, B) int32 owned by the wrapper; every per-row access (hcol, the read
// bytes x (M, B), the moves plane) has the lane index fastest, so the 32
// threads of a warp touch 32 neighbouring words or bytes and each access is
// one coalesced transaction.
//
// Affine (K6/K7): the scratch plane holds (H, E)(i, j - 1) as one int2, so a
// cell costs one 8-byte load and one 8-byte store; F(i - 1, j) and the north
// H stay in registers down the column. The boundaries are the JAX scan's
// (scan_dp.py:245-264, the ones its CPU route and the CSVs follow):
// H = 0 outside the matrix, E(i, 0) = -2^30, F(0, j) = 0. The move byte: bits
// 0-1 the source of H, tested by equality in the order ZERO (H = 0), NW
// (H = diag + s), E, F; bit 3 when E extends (E(i, j-1) >= H(i, j-1) -
// gap_open); bit 4 when F extends (F(i-1, j) >= H(i-1, j) - gap_open).
//
// Tie-break: a strict `h > best` in column-major sweep order keeps the first
// maximum in (j, i) order -- max score, then smallest j, then smallest i --
// the column-major rule of scan_dp._reduce_best (scan_dp.py:303-321). An
// all-zero lane keeps (0, 0, 0).
//
// What bounds it on the H100: the integer ALU latency of each thread's serial
// chain (north -> h -> north, and F -> F) over m*n cells, with few warps per
// SM at the main path's lane counts; K2/K7 also store m*n move bytes per lane.
// The faster
// design, left to a later change, gives each lane a warp: the lanes of a warp
// hold consecutive read rows, pass the anti-diagonal carry with
// __shfl_up_sync, and fold the three-way max with the DPX intrinsic
// __vimax3_s32_relu.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // one warp per block spreads small batches over more SMs
constexpr int kNeg = -(1 << 30);  // E and F where no gap run can reach

// One body for K1 (kMoves = false) and K2 (kMoves = true, which implies
// kTrackPos), and with kAffine for K6 and K7. moves is (M + N - 1, M, B) and
// unused by K1/K6. hcol is (M, B) int32 for K1/K2 and (M, B) int2 (H, E) for
// K6/K7.
template <bool kTrackPos, bool kMoves, bool kAffine>
__global__ void sw_kernel(const uint8_t* __restrict__ x_mb,
                          const uint8_t* __restrict__ y_nb,
                          const int32_t* __restrict__ m,
                          const int32_t* __restrict__ n,
                          int32_t* __restrict__ hcol,
                          int M, int N, int B, int match, int mismatch,
                          int gap_open, int gap, int32_t* __restrict__ score,
                          int32_t* __restrict__ best_i,
                          int32_t* __restrict__ best_j,
                          uint8_t* __restrict__ moves) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int mb = min(m[b], M);
  const int nb = min(n[b], N);
  int32_t* h = hcol + b;
  int2* he = reinterpret_cast<int2*>(hcol) + b;
  const uint8_t* x = x_mb + b;
  for (int r = 0; r < mb; ++r) {  // column j = 0
    if (kAffine) {
      he[(size_t)r * B] = make_int2(0, kNeg);
    } else {
      h[(size_t)r * B] = 0;
    }
  }
  int best = 0, bi = 0, bj = 0;
  for (int j = 1; j <= nb; ++j) {
    const uint8_t yc = y_nb[(size_t)(j - 1) * B + b];
    int diag = 0;   // H(i-1, j-1); row 0 is the zero boundary
    int north = 0;  // H(i-1, j)
    int fn = 0;     // F(i-1, j); F(0, j) = 0, the scan's boundary
    for (int i = 1; i <= mb; ++i) {
      const size_t at = (size_t)(i - 1) * B;
      const int s = (x[at] == yc) ? match : mismatch;
      int v, west;
      if (kAffine) {
        const int2 w = he[at];  // (H, E)(i, j-1)
        west = w.x;
        const int e_open = west - gap_open;
        const int f_open = north - gap_open;
        const int e = max(e_open, w.y) - gap;
        const int f = max(f_open, fn) - gap;
        const int nw = diag + s;
        v = max(max(nw, e), max(f, 0));
        if (kMoves) {
          uint8_t mv = v == 0 ? 3 : v == nw ? 0 : v == e ? 1 : 2;
          if (w.y >= e_open) mv |= 8;
          if (fn >= f_open) mv |= 16;
          moves[((size_t)(i + j - 2) * M + (i - 1)) * B + b] = mv;
        }
        he[at] = make_int2(v, e);
        fn = f;
      } else {
        west = h[at];  // H(i, j-1)
        v = max(max(diag + s, max(west, north) - gap), 0);
        if (kMoves) {
          // Move code of wavefront_pallas.py:574-579 over the neighbours
          // (nw, west, north): NW if nw >= west and nw >= north, else W if
          // west >= both, else N; plus the stop bit 4 if any of them is 0.
          uint8_t mv = (diag >= west && diag >= north) ? 0
                       : (west >= diag && west >= north) ? 1 : 2;
          if (diag == 0 || west == 0 || north == 0) mv |= 4;
          moves[((size_t)(i + j - 2) * M + (i - 1)) * B + b] = mv;
        }
        h[at] = v;
      }
      if (kTrackPos) {
        if (v > best) { best = v; bi = i; bj = j; }
      } else {
        best = max(best, v);
      }
      diag = west;
      north = v;
    }
  }
  score[b] = best;
  best_i[b] = bi;
  best_j[b] = bj;
}

}  // namespace

// Plain C entry point, bound with ctypes. Every pointer is a device pointer to
// a contiguous tensor: x_mb (M, B) uint8, y_nb (N, B) uint8, m and n (B,)
// int32, hcol scratch ((M, B) int32, or (M, B, 2) int32 when gap_open > 0),
// score/best_i/best_j (B,) int32, and moves (M + N - 1, M, B) uint8 for K2/K7
// or null for K1/K6. gap_open > 0 selects the affine kernels. Returns
// cudaGetLastError() after the launch.
extern "C" int pgs_sw_score(const void* x_mb, const void* y_nb, const void* m,
                            const void* n, void* hcol, int M, int N, int B,
                            int match, int mismatch, int gap_open, int gap,
                            int track_pos, void* score, void* best_i,
                            void* best_j, void* moves, void* stream) {
  if (B > 0) {
    auto kernel = gap_open > 0
        ? (moves ? &sw_kernel<true, true, true>
           : track_pos ? &sw_kernel<true, false, true>
                       : &sw_kernel<false, false, true>)
        : (moves ? &sw_kernel<true, true, false>
           : track_pos ? &sw_kernel<true, false, false>
                       : &sw_kernel<false, false, false>);
    kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x_mb), static_cast<const uint8_t*>(y_nb),
        static_cast<const int32_t*>(m), static_cast<const int32_t*>(n),
        static_cast<int32_t*>(hcol), M, N, B, match, mismatch, gap_open, gap,
        static_cast<int32_t*>(score), static_cast<int32_t*>(best_i),
        static_cast<int32_t*>(best_j), static_cast<uint8_t*>(moves));
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a cudaError_t returned by an entry point above.
extern "C" const char* pgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
