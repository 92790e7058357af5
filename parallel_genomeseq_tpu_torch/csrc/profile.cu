// Smith-Waterman with substitution-matrix scoring for Hopper (sm_90a),
// linear or affine (Gotoh) gaps, exact int32 values.
//
// K4 `scan_kernel<false, kG, kR, ·>` replaces the Pallas TPU kernel B3,
//    parallel_genomeseq_tpu/ops/wavefront_pallas.py `_kernel_profile` (:418)
//    via `_call_profile` (:984): per-lane best score and its (i, j). It runs
//    the protein database scan with one query shared by every lane (B3's
//    `shared=True`, :986-988) and each lane's entry read straight from a
//    flat resident slab through a 64-bit offset; it also takes per-lane
//    queries.
// K8 `scan_kernel<true, kG, kR, ·>` replaces B7, `_kernel_profile_affine`
//    (:442) via `_call_profile_affine` (:500): K4 under the Gotoh recurrence,
//    the database scan with gap_open + L * gap gaps (B7's `shared` form).
//
// The top-K re-runs with moves, K5 and K9 (B4, B8), are the table form of
// csrc/wavefront.cu's warp-a-lane template.
//
// Scores come from an (ncodes, ncodes) int32 table over compact codes (code
// c + 1 = alphabet[c], code 0 = any other byte; see ops/scan_dp.py); a code
// >= ncodes reads as code 0. The TPU's packed-word select tree (_packed_sow,
// :365-415) is a vector-unit device with no use here.
//
// Design of K4/K8, the score-only scan: a thread group per lane, the query in
// registers, swept along the entry as the strip sweep's warps sweep a read
// (csrc/strips.cu).
//   - kG threads (8, 16 or 32) take one lane. The query's M rows are split
//     into kG bands of kR rows, one band a thread; the thread keeps its
//     band's column of H in registers, and for K8 also its E, which runs
//     along the entry. Thread l of the group works on column j = s - l + 1 at
//     the group's step s and takes the last-row H of column j (K8: the pair
//     (H, F)) from thread l - 1 by __shfl_up_sync within the group; the
//     column's entry code travels down the group with it. Thread 0 takes the
//     code from a kG-column word that the group loads one word ahead (one
//     byte a thread) and the top boundary H(0, j) = 0, F(0, j) = 0 (the JAX
//     scan's). There is no per-cell scratch in device memory, no shared ring
//     and no __syncthreads in the loop: nothing but the per-lane results is
//     written.
//   - 32 / kG lanes share a warp. The slab is length-sorted
//     (models/protein_db.py), so their n_b are close; the warp steps to its
//     longest lane's n_b + kG - 1, and every thread takes part in every
//     shuffle: a group that has finished, or has no lane, steps along with
//     its columns predicated off.
//   - (kG, kR) by query length, from kShapes below: the entry with the fewest
//     rows kG x kR >= M, kR a multiple of 4 (the profile's 16-byte loads).
//     kG = 8 with kR = 4..32 covers M <= 256 (the 145-aa query: 8 x 20 = 160
//     rows, 91% used), kG = 16 with kR = 20..32 M <= 512, kG = 32 with kR =
//     20..64 M <= 2,048 (MAX_M in ops/engine.py; a longer query runs on the
//     strip sweeps K19/K22). One pass covers every query the kernels take, a
//     wide instantiation rather than passes through a per-residue bound row:
//     passes would only serve queries over 1,024 aa, would write and re-read
//     a row of (H, F) per residue of the database (1.6 GB for K8 at
//     SwissProt scale), and 64-row bands fit the registers (ptxas, PERF.md
//     section 6). Why every entry: a launch sweeps all kG x kR rows whatever
//     M is, so a shape's time is flat over the queries it takes, and without
//     it they run on the next, larger shape. tools/scan_shapes.py times each
//     shape over the 561,356-entry database at its shortest and longest
//     query (8 x 4 at 1 and 32 aa, 8 x 8 at 33 and 64, ..., 32 x 64 at 1,793
//     and 2,048): on the H100 the next shape is 10-54% slower for every
//     entry's queries, 10-37% at 97-1,024 aa (8 x 20 -> 8 x 24 at the 145-aa
//     query: 17-18%), so each entry earns its build time (PERF.md section 6).
//   - The cell, off the chain as in the strip sweep: a = max(diag + s,
//     west - gap, 0) first (DPX __viaddmax_s32_relu), then one DPX a row
//     carries the north chain, H = max(north - gap, a). K8: E = max(west -
//     open, E) - extend first, a = max(diag + s, E, 0); F's chain is one DPX
//     a row (F(k) = max(F(k - 1) - extend, a(k - 1) - open - extend), since
//     open > 0), and H = max(a, F).
//   - The score. With a shared query (the database scan, x lane stride 0)
//     each block first builds the query's profile in shared memory, one int32
//     score per (entry code, query row) -- int32, so any table fits, and no
//     instruction unpacks it -- laid out so that thread l of a group reads
//     its kR rows for the column's code as kR / 4 16-byte loads with constant
//     offsets, and the 8 threads of a quarter warp land on 8 different
//     4-bank groups whatever their codes (no bank conflict): word ((yc * kR /
//     4 + q) * kG + l) * 4 + c holds row l * kR + 4q + c. The 25-code protein
//     profile takes 16 KB at the 145-aa query, 200 KB at 2,048 aa; a profile
//     larger than a block's shared memory takes the table route. Per-lane
//     queries (and that case) read the transposed table, tab[yc * ncodes +
//     xc], one shared load a cell, the band's codes packed four to a
//     register.
//   - Exactness: columns past n_b are predicated off; rows past the lane's
//     m_b are swept unmasked (the DP runs down and right, so no row up to
//     m_b reads them) and count in no best. Ties: each thread keeps the first
//     maximum of its cells in (j, i) order (strict >, columns in order, rows
//     in order inside a column), and the group reduces its threads' bests by
//     max score, then min j, then min i. An all-zero lane gives (0, 0, 0).
//     Lengths are clamped to the padded shape (m_b <= M, n_b <= N) and to the
//     bytes y holds past the lane's offset (0 for an offset outside it), as
//     the plain version clamps them.
// What bounds K4/K8 on the H100: the issue of their instructions, at most
// four warp-instructions a cycle an SM. A cell needs about 3.75 (K4: the gap
// subtract, two DPX, half a __vimax3 for the column maximum, a quarter of a
// 16-byte profile load) or 6.75 (K8), and a thread adds per column the
// hand-off (two shuffles, K8 three), the code's shuffle, the running-best
// test and the loop. Fill and drain cost kG - 1 steps a lane, idle rows
// (kG x kR - M) / (kG x kR) of every step. chip_smoke.py's bound counts 5
// (K8 8) integer operations a cell, a running best costed per cell; it prints
// beside it the bound at the 3.5 (K8 6.5) integer instructions a cell that
// this body issues, without the profile load. The times, bounds and cycles a
// column step at the main path's shapes are in PERF.md section 6.
//
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);  // E and F where no gap run can reach
constexpr unsigned kAll = 0xffffffffu;

// The scan's (threads a lane, rows a thread), by rows kG x kR ascending.
struct Shape {
  int g, r;
};
constexpr Shape kShapes[] = {{8, 4},   {8, 8},   {8, 12},  {8, 16},  {8, 20},
                             {8, 24},  {8, 28},  {8, 32},  {16, 20}, {16, 24},
                             {16, 28}, {16, 32}, {32, 20}, {32, 24}, {32, 28},
                             {32, 32}, {32, 40}, {32, 48}, {32, 56}, {32, 64}};
constexpr int kNumShapes = sizeof(kShapes) / sizeof(kShapes[0]);

__device__ __forceinline__ uint8_t clamp_code(uint8_t c, int ncodes) {
  return c < ncodes ? c : 0;
}

// (v1, j1, i1) before (v2, j2, i2): higher score, then smaller j, then i.
__device__ __forceinline__ bool better(int v1, int j1, int i1, int v2, int j2,
                                       int i2) {
  return v1 > v2 || (v1 == v2 && (j1 < j2 || (j1 == j2 && i1 < i2)));
}

// tab[yc * ncodes + xc] = table[xc][yc]. The caller synchronises.
__device__ __forceinline__ void load_table(int32_t* tab, const int32_t* __restrict__ table,
                                           int ncodes) {
  for (int k = threadIdx.x; k < ncodes * ncodes; k += blockDim.x) {
    tab[(k % ncodes) * ncodes + k / ncodes] = table[k];
  }
}

// One column of a band under linear gaps: h holds H(., j - 1) on entry and
// H(., j) on return; nw = H(row0, j - 1), north = H(row0, j), row0 the row
// above the band. Returns the column's maximum over the band.
template <int kR>
__device__ __forceinline__ int band_column(int (&h)[kR], const int (&sc)[kR], int gap,
                                           int nw, int north) {
  int a[kR];
  int diag = nw;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    a[k] = __viaddmax_s32_relu(diag, sc[k], h[k] - gap);
    diag = h[k];
  }
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    h[k] = __viaddmax_s32(north, -gap, a[k]);
    north = h[k];
  }
  int colmax = 0;
#pragma unroll
  for (int k = 0; k < kR; k += 2) colmax = __vimax3_s32(colmax, h[k], h[k + 1]);
  return colmax;
}

// The affine form: h and e hold H(., j - 1), E(., j - 1) on entry and H(.,
// j), E(., j) on return; f is F(row0, j) on entry and F of the band's last
// row on return.
template <int kR>
__device__ __forceinline__ int band_column_affine(int (&h)[kR], int (&e)[kR],
                                                  const int (&sc)[kR], int gap_open,
                                                  int gap, int nw, int north, int& f) {
  int a[kR];
  int diag = nw;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int west = h[k];
    e[k] = __viaddmax_s32(west, -gap_open, e[k]) - gap;
    a[k] = __viaddmax_s32_relu(diag, sc[k], e[k]);
    diag = west;
  }
  const int open_extend = gap_open + gap;
  f = __viaddmax_s32(north, -gap_open, f) - gap;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    if (k > 0) f = __viaddmax_s32(f, -gap, a[k - 1] - open_extend);
    h[k] = max(a[k], f);
  }
  int colmax = 0;
#pragma unroll
  for (int k = 0; k < kR; k += 2) colmax = __vimax3_s32(colmax, h[k], h[k + 1]);
  return colmax;
}

// K4 (kAffine = false) and K8 (kAffine = true): kG threads a lane, kR rows a
// thread. x: lane b's query at x + b * x_lane (x_lane = 0: one query shared
// by every lane, which kProf requires); y: lane b's entry at y + y_off[b] in
// a buffer of y_len bytes; M <= kG * kR. Dynamic shared memory: the query
// profile (kProf, ncodes * kG * kR int32) or the transposed table.
template <bool kAffine, int kG, int kR, bool kProf>
__global__ void scan_kernel(const uint8_t* __restrict__ x, long long x_lane,
                            const uint8_t* __restrict__ y, const int64_t* __restrict__ y_off,
                            long long y_len, const int32_t* __restrict__ m,
                            const int32_t* __restrict__ n, const int32_t* __restrict__ table,
                            int ncodes, int M, int N, int B, int gap_open, int gap,
                            int32_t* __restrict__ score, int32_t* __restrict__ best_i,
                            int32_t* __restrict__ best_j) {
  static_assert(32 % kG == 0 && kR % 4 == 0, "groups tile a warp, bands hold whole quads");
  constexpr int kQ = kR / 4;
  extern __shared__ __align__(16) int32_t smem[];
  const int t = threadIdx.x;
  const int l = t & (kG - 1);  // the thread's band in its group
  if constexpr (kProf) {
    for (int k = t; k < ncodes * kG * kR; k += blockDim.x) {
      const int quad = k >> 2;  // (yc * kQ + q) * kG + band
      const int row = (quad % kG) * kR + 4 * (quad / kG % kQ) + (k & 3);
      const int xc = row < M ? clamp_code(x[row], ncodes) : 0;
      smem[k] = table[xc * ncodes + quad / (kG * kQ)];
    }
  } else {
    load_table(smem, table, ncodes);
  }
  __syncthreads();

  const int b = blockIdx.x * (blockDim.x / kG) + t / kG;
  int mb = 0, nb = 0;
  long long off = 0;
  if (b < B) {
    mb = min(m[b], M);
    nb = min(n[b], N);
    off = y_off[b];
    if (off < 0 || off > y_len) {
      nb = 0;
    } else if ((long long)nb > y_len - off) {
      nb = (int)(y_len - off);
    }
    nb = max(nb, 0);
  }
  const int steps = __reduce_max_sync(kAll, nb > 0 ? nb + kG - 1 : 0);
  const int row0 = l * kR;  // 0-based first row of the band
  const int nvalid = min(max(mb - row0, 0), kR);
  const uint8_t* yl = y + off;
  uint32_t xw[kProf ? 1 : kQ];  // table route: the band's codes, four a word
  if constexpr (!kProf) {
    const uint8_t* xl = x + (b < B ? (long long)b * x_lane : 0);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      xw[q] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row0 + 4 * q + c;
        const uint32_t xc = b < B && row < M ? clamp_code(xl[row], ncodes) : 0;
        xw[q] |= xc << (8 * c);
      }
    }
  }
  int h[kR];
  int e[kAffine ? kR : 1];  // affine: E(., j - 1), kNeg in column 0
#pragma unroll
  for (int k = 0; k < kR; ++k) h[k] = 0;
#pragma unroll
  for (int k = 0; k < (kAffine ? kR : 1); ++k) e[k] = kNeg;
  int best = 0, bi = 0, bj = 0;
  int nw = 0;     // H(row0, j - 1): the previous column's north input
  int hlast = 0;  // H of the band's last row in the column it finished last
  int flast = 0;  // affine: that row's F
  int yc = 0;     // the code of this thread's column
  // The entry kG columns a word, one a thread, loaded one word ahead: thread
  // l of word w holds column kG * w + l + 1's code.
  int ycur = l < nb ? clamp_code(yl[l], ncodes) : 0;
  int ynext = kG + l < nb ? clamp_code(yl[kG + l], ncodes) : 0;
  for (int s = 0; s < steps; ++s) {
    if (s > 0 && (s & (kG - 1)) == 0) {
      ycur = ynext;
      const int k = s + kG + l;
      ynext = k < nb ? clamp_code(yl[k], ncodes) : 0;
    }
    int hin = __shfl_up_sync(kAll, hlast, 1, kG);
    int fin = kAffine ? __shfl_up_sync(kAll, flast, 1, kG) : 0;
    yc = __shfl_up_sync(kAll, yc, 1, kG);
    const int yfirst = __shfl_sync(kAll, ycur, s & (kG - 1), kG);
    if (l == 0) {  // row 0: H = 0 and F = 0 above the query
      yc = yfirst;
      hin = 0;
      fin = 0;
    }
    const int j = s - l + 1;
    if (j >= 1 && j <= nb) {
      int sc[kR];
      if constexpr (kProf) {
        const int4* p = reinterpret_cast<const int4*>(smem) + yc * (kQ * kG) + l;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int4 v = p[q * kG];
          sc[4 * q] = v.x;
          sc[4 * q + 1] = v.y;
          sc[4 * q + 2] = v.z;
          sc[4 * q + 3] = v.w;
        }
      } else {
        const int32_t* row = smem + yc * ncodes;
#pragma unroll
        for (int k = 0; k < kR; ++k) sc[k] = row[(xw[k >> 2] >> (8 * (k & 3))) & 0xffu];
      }
      int colmax;
      if constexpr (kAffine) {
        colmax = band_column_affine(h, e, sc, gap_open, gap, nw, hin, fin);
        flast = fin;
      } else {
        colmax = band_column(h, sc, gap, nw, hin);
      }
      if (colmax > best) {
        if (nvalid < kR) {  // the band holding m_b: its rows up to m_b only
          colmax = 0;
#pragma unroll
          for (int k = 0; k < kR; ++k) colmax = k < nvalid ? max(colmax, h[k]) : colmax;
        }
        if (colmax > best) {
          int kk = 0;
#pragma unroll
          for (int k = kR - 1; k >= 0; --k) kk = h[k] == colmax ? k : kk;
          best = colmax;
          bi = row0 + kk + 1;
          bj = j;
        }
      }
      hlast = h[kR - 1];
      nw = hin;
    }
  }
  // The group's best: max score, then min j, then min i.
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) {
    const int v2 = __shfl_down_sync(kAll, best, o, kG);
    const int j2 = __shfl_down_sync(kAll, bj, o, kG);
    const int i2 = __shfl_down_sync(kAll, bi, o, kG);
    if (better(v2, j2, i2, best, bj, bi)) {
      best = v2;
      bj = j2;
      bi = i2;
    }
  }
  if (l == 0 && b < B) {
    score[b] = best;
    best_i[b] = bi;
    best_j[b] = bj;
  }
}

using ScanKernel = void (*)(const uint8_t*, long long, const uint8_t*, const int64_t*,
                            long long, const int32_t*, const int32_t*, const int32_t*, int,
                            int, int, int, int, int, int32_t*, int32_t*, int32_t*);

template <bool kAffine, bool kProf, int I = 0>
void fill_scan_kernels(ScanKernel* out) {
  if constexpr (I < kNumShapes) {
    out[I] = &scan_kernel<kAffine, kShapes[I].g, kShapes[I].r, kProf>;
    fill_scan_kernels<kAffine, kProf, I + 1>(out);
  }
}

// Every instantiation, [affine][profile][shape].
struct ScanKernels {
  ScanKernel at[2][2][kNumShapes];
  ScanKernels() {
    fill_scan_kernels<false, false>(at[0][0]);
    fill_scan_kernels<false, true>(at[0][1]);
    fill_scan_kernels<true, false>(at[1][0]);
    fill_scan_kernels<true, true>(at[1][1]);
  }
};

// A scan launch for M query rows: the shape with the fewest rows >= M; the
// profile route for a shared query whose profile fits a block's shared
// memory; of 256, 512, 128 and 1,024 threads a block, the first that keeps
// the most threads on an SM (the CUDA occupancy calculator).
struct ScanLaunch {
  ScanKernel kernel;
  int g, r, threads, blocks;
  size_t smem;
  bool prof;
};

cudaError_t scan_launch(int M, int ncodes, bool affine, bool shared, ScanLaunch* out) {
  int i = 0;
  while (i < kNumShapes && kShapes[i].g * kShapes[i].r < M) ++i;
  if (i == kNumShapes || ncodes < 1) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t prof_bytes = (size_t)ncodes * kShapes[i].g * kShapes[i].r * sizeof(int32_t);
  const bool prof = shared && prof_bytes <= (size_t)optin;
  static const ScanKernels kernels;
  ScanLaunch L{kernels.at[affine][prof][i], kShapes[i].g, kShapes[i].r, 0, 0,
               prof ? prof_bytes : (size_t)ncodes * ncodes * sizeof(int32_t), prof};
  cudaError_t err = cudaFuncSetAttribute(L.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.smem);
  if (err != cudaSuccess) return err;
  for (int threads : {256, 512, 128, 1024}) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, L.kernel, threads, L.smem);
    if (err != cudaSuccess) return err;
    if (blocks * threads > L.blocks * L.threads) {
      L.threads = threads;
      L.blocks = blocks;
    }
  }
  if (L.blocks == 0) return cudaErrorInvalidConfiguration;
  *out = L;
  return cudaSuccess;
}

}  // namespace

// Plain C entry points, bound with ctypes. Every pointer is a device pointer
// to a contiguous tensor.
//
// pgs_sw_profile_scan (K4; K8 when gap_open > 0): x codes, lane b's query at
// x + b * x_lane (x (B, M) with x_lane = M, or one (M,) query shared by every
// lane with x_lane = 0); y codes, lane b reading y[y_off[b] + j - 1] for j <=
// n_b, with y_len the number of bytes behind y; y_off (B,) int64; m, n (B,)
// int32; table (ncodes, ncodes) int32; score/best_i/best_j (B,) int32. N is
// the padded y width, the bound on n_b. M <= 2,048, the widest shape.
// Returns cudaErrorInvalidValue for a longer query, else cudaGetLastError()
// after the launch.
extern "C" int pgs_sw_profile_scan(const void* x, long long x_lane, const void* y,
                                   const void* y_off, long long y_len, const void* m,
                                   const void* n, const void* table, int ncodes, int M,
                                   int N, int B, int gap_open, int gap, void* score,
                                   void* best_i, void* best_j, void* stream) {
  if (B > 0) {
    ScanLaunch L;
    const cudaError_t err = scan_launch(M, ncodes, gap_open > 0, x_lane == 0, &L);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int lanes = L.threads / L.g;
    L.kernel<<<(B + lanes - 1) / lanes, L.threads, L.smem,
               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), x_lane, static_cast<const uint8_t*>(y),
        static_cast<const int64_t*>(y_off), y_len, static_cast<const int32_t*>(m),
        static_cast<const int32_t*>(n), static_cast<const int32_t*>(table), ncodes, M, N, B,
        gap_open, gap, static_cast<int32_t*>(score), static_cast<int32_t*>(best_i),
        static_cast<int32_t*>(best_j));
  }
  return static_cast<int>(cudaGetLastError());
}

// pgs_sw_profile_scan_shape: the launch pgs_sw_profile_scan makes for M query
// rows (affine and shared != 0 as gap_open > 0 and x_lane == 0 select) on the
// current device: out[0] threads a lane (g), out[1] rows a thread (r),
// out[2] threads a block, out[3] blocks an SM (the occupancy calculator),
// out[4] 1 for the profile route. Returns a cudaError_t.
extern "C" int pgs_sw_profile_scan_shape(int M, int ncodes, int affine, int shared,
                                         void* out) {
  ScanLaunch L;
  const cudaError_t err = scan_launch(M, ncodes, affine != 0, shared != 0, &L);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = L.g;
  o[1] = L.r;
  o[2] = L.threads;
  o[3] = L.blocks;
  o[4] = L.prof;
  return static_cast<int>(cudaGetLastError());
}
