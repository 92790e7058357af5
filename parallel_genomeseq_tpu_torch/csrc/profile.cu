// Smith-Waterman with substitution-matrix scoring for Hopper (sm_90a),
// linear or affine (Gotoh) gaps, exact int32 values.
//
// K4 `profile_kernel<false, false>` replaces the Pallas TPU kernel B3,
//    parallel_genomeseq_tpu/ops/wavefront_pallas.py `_kernel_profile` (:418)
//    via `_call_profile` (:984): per-lane best score and its (i, j). It runs
//    the protein database scan with one query shared by every lane (B3's
//    `shared=True`, :986-988) and each lane's entry read straight from a
//    flat resident slab through a 64-bit offset; it also takes per-lane
//    queries.
// K5 `profile_kernel<true, false>` replaces B4, `_kernel_profile_moves` (:815) via
//    `_call_profile_moves` (:874): K4's argmax plus one uint8 move/stop code
//    per DP cell in the (D, M, B) diagonal-major layout (d = i + j - 2,
//    r = i - 1) that K3 walks, with the codes of K2 (:818-822).
// K8 `profile_kernel<false, true>` replaces B7, `_kernel_profile_affine`
//    (:442) via `_call_profile_affine` (:500): K4 under the Gotoh recurrence,
//    the database scan with gap_open + L * gap gaps (B7's `shared` form).
// K9 `profile_kernel<true, true>` replaces B8, `_kernel_profile_affine_moves`
//    (:724, body `_affine_moves_body` :630) via `_call_profile_affine_moves`
//    (:779): K8's argmax plus the affine move byte of the JAX scan
//    (ops/scan_dp.py:273-290), the one that K10 walks.
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
// (0, 0, 0). Affine (K8/K9): as K6/K7 in csrc/wavefront.cu -- an int2
// (H, E) scratch plane, F and the north H in registers, the JAX scan's
// boundaries (E(i, 0) = -2^30, F(0, j) = 0, H = 0) and its move byte. K8's
// scratch is twice K4's: Mq x lanes x 8 B, 0.65 GB for a 145-aa query
// against 561,356 entries, allocated once per launch.
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

constexpr int kNeg = -(1 << 30);  // E and F where no gap run can reach

// hcol is (M, B) int32 for K4/K5 and (M, B) int2 (H, E) for K8/K9.
template <bool kMoves, bool kAffine>
__global__ void profile_kernel(const uint8_t* __restrict__ x, int x_lane,
                               int x_row, const uint8_t* __restrict__ y,
                               const int64_t* __restrict__ y_off,
                               long long y_len,
                               const int32_t* __restrict__ m,
                               const int32_t* __restrict__ n,
                               const int32_t* __restrict__ table, int ncodes,
                               int32_t* __restrict__ hcol, int M, int N, int B,
                               int gap_open, int gap,
                               int32_t* __restrict__ score,
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
  int2* he = reinterpret_cast<int2*>(hcol) + b;
  const uint8_t* xb = x + (size_t)b * x_lane;
  const uint8_t* yb = y + off;
  for (int r = 0; r < mb; ++r) {  // column j = 0
    if (kAffine) {
      he[(size_t)r * B] = make_int2(0, kNeg);
    } else {
      h[(size_t)r * B] = 0;
    }
  }
  int best = 0, bi = 0, bj = 0;
  for (int j = 1; j <= nb; ++j) {
    int yc = yb[j - 1];
    if (yc >= ncodes) yc = 0;
    const int32_t* trow = tab + yc * ncodes;
    int diag = 0;   // H(i-1, j-1); row 0 is the zero boundary
    int north = 0;  // H(i-1, j)
    int fn = 0;     // F(i-1, j); F(0, j) = 0, the scan's boundary
    for (int i = 1; i <= mb; ++i) {
      const size_t at = (size_t)(i - 1) * B;
      int xc = xb[(size_t)(i - 1) * x_row];
      if (xc >= ncodes) xc = 0;
      const int s = trow[xc];
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
          // The affine move byte of scan_dp.py:273-290: H's source by
          // equality, ZERO > NW > E > F; E and F extend bits, extend on ties.
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
          // Move code of wavefront_pallas.py:850-855 over the neighbours
          // (nw, west, north): NW if nw >= west and nw >= north, else W if
          // west >= both, else N; plus the stop bit 4 if any of them is 0.
          uint8_t mv = (diag >= west && diag >= north) ? 0
                       : (west >= diag && west >= north) ? 1 : 2;
          if (diag == 0 || west == 0 || north == 0) mv |= 4;
          moves[((size_t)(i + j - 2) * M + (i - 1)) * B + b] = mv;
        }
        h[at] = v;
      }
      if (v > best) { best = v; bi = i; bj = j; }
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
// (ncodes, ncodes) int32; hcol scratch ((M, B) int32, or (M, B, 2) int32
// when gap_open > 0); score/best_i/best_j (B,) int32; moves (M + N - 1, M, B)
// uint8 for K5/K9 or null for K4/K8. N is the padded y width, the bound on
// n_b. gap_open > 0 selects the affine kernels. Returns cudaGetLastError()
// after the launch.
extern "C" int pgs_sw_profile(const void* x, int x_lane, int x_row,
                              const void* y, const void* y_off,
                              long long y_len, const void* m, const void* n,
                              const void* table, int ncodes, void* hcol, int M,
                              int N, int B, int gap_open, int gap, void* score,
                              void* best_i, void* best_j, void* moves,
                              void* stream) {
  if (B > 0) {
    // One warp per block spreads a small batch over more SMs; a database
    // scan has enough lanes to fill every SM with 128-thread blocks.
    const int threads = B >= 65536 ? 128 : 32;
    const size_t smem = (size_t)ncodes * ncodes * sizeof(int32_t);
    auto kernel = gap_open > 0
        ? (moves ? &profile_kernel<true, true> : &profile_kernel<false, true>)
        : (moves ? &profile_kernel<true, false> : &profile_kernel<false, false>);
    kernel<<<(B + threads - 1) / threads, threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), x_lane, x_row,
        static_cast<const uint8_t*>(y), static_cast<const int64_t*>(y_off),
        y_len, static_cast<const int32_t*>(m), static_cast<const int32_t*>(n),
        static_cast<const int32_t*>(table), ncodes,
        static_cast<int32_t*>(hcol), M, N, B, gap_open, gap,
        static_cast<int32_t*>(score), static_cast<int32_t*>(best_i),
        static_cast<int32_t*>(best_j), static_cast<uint8_t*>(moves));
  }
  return static_cast<int>(cudaGetLastError());
}
