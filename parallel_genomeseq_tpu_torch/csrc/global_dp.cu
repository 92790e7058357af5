// K25: the Needleman-Wunsch (global) last row for B ragged lanes.
//
// Not a Pallas kernel. K25 replaces the JAX `lax.scan` in
// parallel_genomeseq_tpu/ops/global_dp.py `_nw_lastrow_scan` (:33-71), the
// row sweep that Hirschberg's divide step runs (models/hirschberg.py) and
// `nw_score_batch` reads the corner of. For lane b, with x_b its m_b read
// bytes and y_b its n_b reference bytes:
//   H(0, j) = -gap * j,  H(i, 0) = -gap * i,
//   H(i, j) = max(H(i-1, j-1) + s(x_i, y_j), H(i-1, j) - gap, H(i, j-1) - gap)
// with no zero floor, s from a (256, 256) int32 table over raw bytes; the
// output row b holds H(m_b, j) for j = 0..n_b and 0 past n_b. The loops stop
// at each lane's true m_b and n_b: the JAX function's power-of-two buckets
// (global_dp.py:74) are a compile-cache device and not ported.
//
// The formulation is the JAX one, rows and not diagonals. A row's north and
// diagonal terms come from the row above: u(j) = max(H(i-1, j-1) + s,
// H(i-1, j) - gap), u(0) = -gap * i. The west chain H(i, j) = max(u(j),
// H(i, j-1) - gap) is a running maximum of u(j) + gap * j, less gap * j, so
// a row is one block-wide inclusive max-scan.
//
// One block a lane, kThreads threads, each holding a contiguous run of kRun
// columns in registers. A row is swept in tiles of kThreads * kRun columns,
// left to right, the scan's running maximum carried from tile to tile. In a
// tile a thread computes its run's u from the row above, chains it locally
// (one DPX __viaddmax_s32 a cell for each of the two maxima), and hands its
// run's maximum of H + gap * j to the block scan: a shuffle scan within the
// warp, each warp's total in shared memory, one barrier, then every warp
// scans the kWarps totals with shuffles. A row costs one barrier to stage
// the table's row s(x_i, .) (256 ints) and one a tile. The two rows (above
// and current) live in shared memory with the lane's reference bytes when
// they fit (n up to about 22,700), else in a global scratch the wrapper
// allocates, (B, 2, stride) int32.
//
// What bounds it on the H100: the function needs 3 integer operations a cell
// (two DPX maxima and the gap subtract; the score is a shared-memory load),
// so an (m x n) lane has m * n * 3 operations over the card's 33.5 T a
// second. A block a lane puts B lanes on B of the 132 SMs: Hirschberg's
// launches hold 2 lanes, so at most 2 SMs work, and each row is a chain of
// barriers. This first design is far from its bound where B is small; a
// multi-block split of the row (or of the lanes' rows by anti-diagonal) is
// later work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRun = 8;
constexpr int kTile = kThreads * kRun;
constexpr int kWarps = kThreads / 32;
// The dynamic shared memory the rows and the reference bytes may take; past
// it the wrapper passes a global scratch (pgs_nw_scratch_ints).
constexpr int kSharedBytes = 200 * 1024;
constexpr int kNeg = INT_MIN / 2;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline long long row_stride(int N) {
  return ((long long)N + 1 + kRun - 1) / kRun * kRun;
}

__host__ inline long long shared_bytes(int N) {
  return 2 * row_stride(N) * 4 + ((long long)N + 15) / 16 * 16;
}

// The inclusive max-scan of v over the block's threads: returns the maximum
// over the threads before this one (kNeg for thread 0) and sets *total to
// the maximum over all. ws holds one int a warp; one barrier.
__device__ inline int block_scan_excl(int v, int* ws, int lane, int warp, int* total) {
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = max(x, y);
  }
  int before = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) before = kNeg;
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  int w = lane < kWarps ? ws[lane] : kNeg;
#pragma unroll
  for (int o = 1; o < kWarps; o <<= 1) {
    const int y = __shfl_up_sync(kFull, w, o);
    if (lane >= o) w = max(w, y);
  }
  const int warps_before = __shfl_sync(kFull, w, warp > 0 ? warp - 1 : 0);
  *total = __shfl_sync(kFull, w, kWarps - 1);
  return warp > 0 ? max(before, warps_before) : before;
}

__global__ void __launch_bounds__(kThreads)
nw_lastrow_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                  const int* __restrict__ m, const int* __restrict__ n, int M, int N,
                  const int* __restrict__ table, int gap, int* __restrict__ scratch,
                  int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int srow[256];
  __shared__ int ws[2][kWarps];
  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int mb = min(max(m[b], 0), M);
  const int nb = min(max(n[b], 0), N);
  const long long stride = row_stride(N);
  const uint8_t* xb = x + (long long)b * M;
  int* rows;
  const uint8_t* yb;
  if (scratch != nullptr) {
    rows = scratch + (long long)b * 2 * stride;
    yb = y + (long long)b * N;
  } else {
    rows = reinterpret_cast<int*>(smem);
    uint8_t* ys = smem + 2 * stride * 4;
    for (int j = t; j < nb; j += kThreads) ys[j] = y[(long long)b * N + j];
    yb = ys;
  }
  int* outb = out + (long long)b * (N + 1);
  for (int j = nb + 1 + t; j <= N; j += kThreads) outb[j] = 0;
  for (int j = t; j <= nb; j += kThreads) {
    rows[j] = -gap * j;
    if (mb == 0) outb[j] = -gap * j;
  }
  int parity = 0;
  for (int i = 1; i <= mb; ++i) {
    const int* prev = rows + ((i - 1) & 1) * stride;
    int* cur = rows + (i & 1) * stride;
    if (t < 256) srow[t] = table[(int)xb[i - 1] * 256 + t];
    __syncthreads();  // the table's row staged, the row above complete
    int carry = kNeg;  // max over earlier tiles of H(i, j) + gap * j
    for (int j0 = 0; j0 <= nb; j0 += kTile) {
      const int c0 = j0 + t * kRun;
      int w[kRun];
      int run_max = kNeg;
      if (c0 <= nb) {
        int p[kRun];
        const int4* p4 = reinterpret_cast<const int4*>(prev + c0);
#pragma unroll
        for (int q = 0; q < kRun / 4; ++q) {
          const int4 v = p4[q];
          p[4 * q] = v.x;
          p[4 * q + 1] = v.y;
          p[4 * q + 2] = v.z;
          p[4 * q + 3] = v.w;
        }
        int diag = c0 > 0 ? prev[c0 - 1] : 0;
        int west = kNeg;
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          const int j = c0 + k;
          int u;
          if (j == 0) {
            u = -gap * i;
          } else if (j <= nb) {
            u = __viaddmax_s32(diag, srow[yb[j - 1]], p[k] - gap);
          } else {
            u = kNeg;
          }
          diag = p[k];
          west = __viaddmax_s32(west, -gap, u);  // max(u, west - gap)
          w[k] = west;
        }
        run_max = west + gap * (c0 + kRun - 1);
      }
      int total;
      const int before = block_scan_excl(run_max, ws[parity], lane, warp, &total);
      parity ^= 1;
      const int left = max(carry, before);
      carry = max(carry, total);
      if (c0 <= nb) {
        int h[kRun];
#pragma unroll
        for (int k = 0; k < kRun; ++k) h[k] = max(w[k], left - gap * (c0 + k));
        int4* c4 = reinterpret_cast<int4*>(cur + c0);
#pragma unroll
        for (int q = 0; q < kRun / 4; ++q)
          c4[q] = make_int4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        if (i == mb) {
#pragma unroll
          for (int k = 0; k < kRun; ++k)
            if (c0 + k <= nb) outb[c0 + k] = h[k];
        }
      }
    }
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. Every pointer is a device pointer
// to a contiguous tensor.
//
// pgs_nw_lastrow (K25): x (B, M) and y (B, N) uint8, m, n (B,) int32 (each
// clamped to [0, M] and [0, N]), table (256, 256) int32 over raw bytes, the
// linear gap, out (B, N + 1) int32. scratch is null when the rows fit in
// shared memory, else a buffer of pgs_nw_scratch_ints(N, B) int32. Returns
// cudaErrorInvalidValue for a null scratch past the shared limit, else
// cudaGetLastError() after the launch (no sync).
extern "C" int pgs_nw_lastrow(const void* x, const void* y, const void* m, const void* n,
                              int M, int N, int B, const void* table, int gap, void* scratch,
                              void* out, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (M < 0 || N < 0) return cudaErrorInvalidValue;
  const long long smem = scratch ? 0 : shared_bytes(N);
  if (smem > kSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(nw_lastrow_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  nw_lastrow_kernel<<<B, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y),
      static_cast<const int*>(m), static_cast<const int*>(n), M, N,
      static_cast<const int*>(table), gap, static_cast<int*>(scratch), static_cast<int*>(out));
  return cudaGetLastError();
}

// The int32 scratch K25 needs for B lanes of reference width N, written to
// *out (a host int64): 0 when a lane's two rows and reference bytes fit in
// kSharedBytes of shared memory, else B * 2 * stride (the (B, 2, stride)
// rows, stride = N + 1 rounded up to the run).
extern "C" int pgs_nw_scratch_ints(int N, int B, void* out) {
  if (N < 0 || B < 0) return cudaErrorInvalidValue;
  *static_cast<long long*>(out) =
      shared_bytes(N) <= kSharedBytes ? 0 : (long long)B * 2 * row_stride(N);
  return cudaSuccess;
}
