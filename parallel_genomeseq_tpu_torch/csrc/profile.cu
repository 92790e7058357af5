// Linear-gap Smith-Waterman with substitution-matrix scoring for Hopper
// (sm_90a), exact int32 values.
//
// K4 `profile_kernel<false>` replaces the Pallas TPU kernel B3,
//    parallel_genomeseq_tpu/ops/wavefront_pallas.py `_kernel_profile` (:418)
//    via `_call_profile` (:984): per-lane best score and its (i, j). It runs
//    the protein database scan with one query shared by every lane (B3's
//    `shared=True`, :986-988) and each lane's entry read straight from a
//    flat resident slab through a 64-bit offset; it also takes per-lane
//    queries.
// K5 `profile_kernel<true>` replaces B4, `_kernel_profile_moves` (:815) via
//    `_call_profile_moves` (:874): K4's argmax plus one uint8 move/stop code
//    per DP cell in the (D, M, B) diagonal-major layout (d = i + j - 2,
//    r = i - 1) that K3 walks, with the codes of K2 (:818-822).
//
// Scores come from an (ncodes, ncodes) int32 table over compact codes (code
// c + 1 = alphabet[c], code 0 = any other byte; see ops/scan_dp.py), copied
// into shared memory transposed, so that one column j reads one row
// tab[y_j][.] and each cell one word of it: 25 x 25 x 4 B = 2.5 KB for the
// 24-letter protein alphabet. With a shared query every thread of a warp
// reads the same word (a broadcast). The TPU's packed-word select tree
// (_packed_sow, :365-415) is a vector-unit device with no use here.
//
// Design: K1/K2's one thread per lane (csrc/wavefront.cu). Each thread
// sweeps its own m_b x n_b matrix column by column (j outer over y, i inner
// over x), so its loops are bounded by the lane's true lengths and no pad
// cell is ever scored: the JAX slab path's per-batch slice and length mask
// (:2324-2329) have no counterpart. Lengths are clamped to the padded shape
// (m_b <= M, n_b <= N) and to the bytes y holds past the lane's offset, as
// the plain version clamps them. The previous column lives in a scratch
// plane hcol (M, B) int32 owned by the wrapper, lane index fastest, so a
// warp's accesses coalesce; x is either one shared column (lane stride 0)
// or an (M, B) block (lane stride 1, row stride B). A code >= ncodes reads
// as code 0. Tie-break as K1: a strict `h > best` in column-major order
// keeps max score, then smallest j, then smallest i; an all-zero lane keeps
// (0, 0, 0).
//
// What bounds it on the H100: each thread's serial chain (north -> h ->
// north) over m*n cells, plus one load and one store of the column scratch
// per cell. The least integer work a cell needs (chip_smoke.py counts it) is
// 5 ALU operations for K4 -- max(west, north), the gap subtract, one DPX
// __viaddmax_s32_relu, and a packed (score, row) key's build and max -- and 7
// more for K5's move code; this kernel spends about twice that (separate
// maxes, a compare and three selects for the argmax, the code clamps).
// The database scan launches one thread per entry, 561,356 of them at
// SwissProt scale, so it runs at full occupancy; the top-K traceback
// launches one thread per hit, which leaves most of the card idle.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool kMoves>
__global__ void profile_kernel(const uint8_t* __restrict__ x, int x_lane,
                               int x_row, const uint8_t* __restrict__ y,
                               const int64_t* __restrict__ y_off,
                               long long y_len,
                               const int32_t* __restrict__ m,
                               const int32_t* __restrict__ n,
                               const int32_t* __restrict__ table, int ncodes,
                               int32_t* __restrict__ hcol, int M, int N, int B,
                               int gap, int32_t* __restrict__ score,
                               int32_t* __restrict__ best_i,
                               int32_t* __restrict__ best_j,
                               uint8_t* __restrict__ moves) {
  extern __shared__ int32_t tab[];  // tab[yc * ncodes + xc] = table[xc][yc]
  for (int k = threadIdx.x; k < ncodes * ncodes; k += blockDim.x) {
    tab[(k % ncodes) * ncodes + k / ncodes] = table[k];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int mb = min(m[b], M);
  const long long off = y_off[b];
  int nb = min(n[b], N);
  if (off < 0 || off > y_len) {
    nb = 0;
  } else if ((long long)nb > y_len - off) {
    nb = (int)(y_len - off);
  }
  int32_t* h = hcol + b;
  const uint8_t* xb = x + (size_t)b * x_lane;
  const uint8_t* yb = y + off;
  for (int r = 0; r < mb; ++r) h[(size_t)r * B] = 0;  // column j = 0
  int best = 0, bi = 0, bj = 0;
  for (int j = 1; j <= nb; ++j) {
    int yc = yb[j - 1];
    if (yc >= ncodes) yc = 0;
    const int32_t* trow = tab + yc * ncodes;
    int diag = 0;   // H(i-1, j-1); row 0 is the zero boundary
    int north = 0;  // H(i-1, j)
    for (int i = 1; i <= mb; ++i) {
      const size_t at = (size_t)(i - 1) * B;
      const int west = h[at];  // H(i, j-1)
      int xc = xb[(size_t)(i - 1) * x_row];
      if (xc >= ncodes) xc = 0;
      const int v = max(max(diag + trow[xc], max(west, north) - gap), 0);
      if (kMoves) {
        // Move code of wavefront_pallas.py:850-855 over the neighbours
        // (nw, west, north): NW if nw >= west and nw >= north, else W if
        // west >= both, else N; plus the stop bit 4 if any of them is 0.
        uint8_t mv = (diag >= west && diag >= north) ? 0
                     : (west >= diag && west >= north) ? 1 : 2;
        if (diag == 0 || west == 0 || north == 0) mv |= 4;
        moves[((size_t)(i + j - 2) * M + (i - 1)) * B + b] = mv;
      }
      if (v > best) { best = v; bi = i; bj = j; }
      h[at] = v;
      diag = west;
      north = v;
    }
  }
  score[b] = best;
  best_i[b] = bi;
  best_j[b] = bj;
}

}  // namespace

// Plain C entry point, bound with ctypes. Every pointer is a device pointer
// to a contiguous tensor: x codes, read at x[b * x_lane + (i - 1) * x_row];
// y codes, lane b reading y[y_off[b] + j - 1] for j <= n_b, with y_len the
// number of bytes behind y; y_off (B,) int64; m, n (B,) int32; table
// (ncodes, ncodes) int32; hcol (M, B) int32 scratch; score/best_i/best_j
// (B,) int32; moves (M + N - 1, M, B) uint8 for K5 or null for K4. N is the
// padded y width, the bound on n_b. Returns cudaGetLastError() after the
// launch.
extern "C" int pgs_sw_profile(const void* x, int x_lane, int x_row,
                              const void* y, const void* y_off,
                              long long y_len, const void* m, const void* n,
                              const void* table, int ncodes, void* hcol, int M,
                              int N, int B, int gap, void* score, void* best_i,
                              void* best_j, void* moves, void* stream) {
  if (B > 0) {
    // One warp per block spreads a small batch over more SMs; a database
    // scan has enough lanes to fill every SM with 128-thread blocks.
    const int threads = B >= 65536 ? 128 : 32;
    const size_t smem = (size_t)ncodes * ncodes * sizeof(int32_t);
    auto kernel = moves ? &profile_kernel<true> : &profile_kernel<false>;
    kernel<<<(B + threads - 1) / threads, threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), x_lane, x_row,
        static_cast<const uint8_t*>(y), static_cast<const int64_t*>(y_off),
        y_len, static_cast<const int32_t*>(m), static_cast<const int32_t*>(n),
        static_cast<const int32_t*>(table), ncodes,
        static_cast<int32_t*>(hcol), M, N, B, gap,
        static_cast<int32_t*>(score), static_cast<int32_t*>(best_i),
        static_cast<int32_t*>(best_j), static_cast<uint8_t*>(moves));
  }
  return static_cast<int>(cudaGetLastError());
}
