// K25: the Needleman-Wunsch (global) last row for B lanes.
//
// Not a Pallas kernel. K25 replaces the JAX `lax.scan` in
// parallel_genomeseq_tpu/ops/global_dp.py `_nw_lastrow_scan` (:33-71), the
// row sweep that Hirschberg's divide step runs (models/hirschberg.py) and
// `nw_score_batch` reads the corner of. For lane b, with x_b its m_b read
// bytes and y_b its n_b reference bytes:
//   H(0, j) = -gap * j,  H(i, 0) = -gap * i,
//   H(i, j) = max(H(i-1, j-1) + s(x_i, y_j), H(i-1, j) - gap, H(i, j-1) - gap)
// with no zero floor, s from a (256, 256) int32 table over raw bytes; the
// output holds H(m_b, j) for j = 0..n_b. The loops stop at each lane's true
// m_b and n_b: the JAX function's power-of-two buckets (global_dp.py:74) are
// a compile-cache device and not ported.
//
// Lanes are read in place: x_b = x[x_off : x_off + m_b] and y_b = y[y_off :
// y_off + n_b], each forward or reversed, so a Hirschberg level's halves
// need no packing; lane b's row goes to out[out_off + j].
//
// The arithmetic. With G(i, j) = H(i, j) + gap * (i + j) the recurrence is
//   G(i, j) = max(G(i-1, j-1) + s'(x_i, y_j), G(i-1, j), G(i, j-1)),
//   s' = s + 2 * gap,  G(0, j) = G(i, 0) = 0:
// one DPX __viaddmax_s32 for the diagonal and west terms, one max for the
// north chain, and every boundary is 0. A pad row, whose score is at most 0
// against every column, copies the row above: G(r, j) = max(G(r - 1, j),
// G(r, j - 1)) = G(r - 1, j), since G(r - 1, .) never falls along a row. So
// a band that holds row m_b sweeps its rows past m_b as pad rows, and its
// last row holds G(m_b, j): the output is that row less gap * (m_b + j).
//
// The sweep: anti-diagonals over bands of rows, no barrier per row or
// column. A lane's rows are cut into chunks of 32 * R rows, one warp a
// chunk; thread l of the warp holds rows l * R .. l * R + R - 1 of the chunk
// in registers (R of G and R score-row offsets) and works on column j = s -
// l + 1 at the warp's step s. Band l + 1 takes band l's last row by
// __shfl_up_sync, and the column's code travels down the warp with it:
// thread 0 takes it from a 32-column word the warp loads one word ahead.
// Between chunks of a lane the hand-off goes through device memory: the
// chunk's thread 31 writes its last row G(r0 + 32R, j) into the lane's
// boundary row, one 64-bit slot a column holding the value and a tag, so one
// single-copy-atomic store publishes it and no fence is needed (a count
// published by a release fence every 8 steps made the steps a quarter
// slower); the next chunk's warp reads the slots of the word after the
// current one at the head of each 32-step word, and polls until every
// slot's tag is its own. So a lane's chunks run as one pipeline over as many
// SMs as it has chunks, about 100 steps apart, and no warp waits inside a
// word.
//
// A lane has one boundary row, whatever its chunks: chunk c reads slot j
// when it holds tag c (chunk c - 1's value; the caller zeroes the row, tag
// 0 above chunk 1) and overwrites it with its own, tag c + 1, 55 steps or more
// after it read it. Chunk c's value at column j depends on what it read
// there, so slot j steps through tags 1, 2, ... in chunk order, and a chunk
// polling for tag c never sees a later one. The scratch is 8 (n_b + 1)
// bytes a lane of two chunks or more, however many chunks are in flight.
//
// Chains that cannot hang: warps are handed chunks by an atomic ticket in
// start order (a block takes `warps` consecutive chunks), and a lane's
// chunks are numbered in row order. A chunk's predecessor therefore holds
// an earlier ticket: its warp is resident or done, and the first chunk of a
// lane waits for nothing. Every wait is bounded: a slot that has not come in
// 10 s (the card's global timer) traps rather than hang the card.
//
// The score: the 256 x 256 byte table (256 KB) does not fit shared memory.
// Each block recodes the bytes its chunks read (their rows of x, their
// lanes' y) to compact codes at its start (the only barriers), and builds
// the table s' over those codes in shared memory, transposed and with one
// more column for the pad rows. With 4 codes or fewer (DNA) and every s'
// an int8, a thread keeps each of its rows' s' against all 4 codes packed
// in one register, and a cell's score is one prmt by the column's code: no
// shared load (a pad row's register is 0, and any s' <= 0 keeps the copy).
// Else a cell is one shared load at the column's table row plus the row's
// code. A block whose chunks read more than kMaxCodes distinct bytes reads
// the byte table from device memory instead (the same values, slower).
//
// The launch shape, chosen by the wrapper (ops/global_dp.launch_shape): R
// of 4, 8, 16 or 32 rows a thread and 1-4 warps a block, from the lanes'
// lengths -- 32 rows where many chunks fill the card, 4 where a handful of
// long lanes must be spread over many SMs and each step's latency sets the
// pace. At R <= 8 the step is built for latency: the chain after the north
// shuffle is one max (the a(k) are replaced by their prefix maxima, off the
// chain), and a word whose 32 steps are all in range runs a copy of the
// step that tests nothing. At R >= 16 those cost more issue than they save.
//
// What bounds it on the H100: in the G form a cell needs 3 integer
// operations (an add and two maxima), m * n * 3 over the card's 33.5 T a
// second. The step issues 3 instructions a cell with packed scores (a prmt,
// two maxima; 4 with the shared table) and about 40 a step besides (four
// shuffles, the hand-off, the output store, the loop). A warp alone on its
// scheduler issues in order at about a third of an instruction a cycle, so
// a step takes about 160-190 cycles at R = 4 and 480-510 at R = 32
// (tools/nw_shapes.py): a launch of a few long lanes is bounded by its
// chain of n_b + 100 x chunks steps, and a full card by issue, about 11
// scheduler cycles a row at R = 32.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCodes = 64;         // compact codes a block's table holds
constexpr int kMaxWarps = 4;          // warps (chunks) a block
constexpr int kNegBig = -(1 << 30);   // s' of a pad row
constexpr int kFields = 8;            // int64 fields of a lane's descriptor
constexpr unsigned long long kWaitNs = 10000000000ull;  // 10 s: a stalled chain
constexpr unsigned kAll = 0xffffffffu;

// A lane's descriptor, `lanes[b * kFields + f]`: the offsets of x_b, y_b,
// its output row and its boundary rows, m_b, n_b, the direction bits (1: x
// reversed, 2: y reversed) and the global index of its first chunk.
enum Field { kXOff, kYOff, kOutOff, kBoundOff, kM, kN, kFlags, kChunk0 };

// A boundary slot: the value in the low word, the writer's tag (its chunk
// index + 1) in the high word.
__device__ __forceinline__ void store_slot(unsigned long long* p, int v, unsigned tag) {
  const unsigned long long w = (static_cast<unsigned long long>(tag) << 32) | (unsigned)v;
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" : : "l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long load_slot(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// What a warp knows of its chunk.
struct Chunk {
  const uint8_t* x;  // x_b's first byte in memory
  const uint8_t* y;  // y_b's first byte in memory
  int* out;          // the lane's output row, column 0
  const unsigned long long* bound_in;  // the lane's boundary row (null for chunk 0)
  unsigned long long* bound_out;       // the same row (null for the lane's last chunk)
  int m, n, r0, nbands;
  unsigned ci;  // the chunk's index in its lane: it reads tag ci and writes ci + 1
  bool x_rev, y_rev;
};

// Column j's byte of y_b (1-based j <= n).
__device__ __forceinline__ int y_byte(const Chunk& c, int j) {
  return c.y[c.y_rev ? c.n - j : j - 1];
}

// Row r's byte of x_b (0-based r < m).
__device__ __forceinline__ int x_byte(const Chunk& c, int r) {
  return c.x[c.x_rev ? c.m - 1 - r : r];
}

// The slots of a boundary row's word as loaded: thread l's of column j
// (j <= n). Ready once every thread's slot holds tag `want`.
__device__ __forceinline__ bool word_ready(unsigned long long w, int j, int n, unsigned want) {
  return __all_sync(kAll, j > n || (w >> 32) == want);
}

// Load a word of a boundary row until every slot is written. A slot that
// has not come in kWaitNs is a fault in the chain: the kernel traps.
__device__ __forceinline__ unsigned long long poll_word(const unsigned long long* row, int j,
                                                        int n, unsigned want,
                                                        unsigned long long w) {
  if (word_ready(w, j, n, want)) return w;
  const unsigned long long t0 = global_ns();
  do {
    __nanosleep(32);
    if (global_ns() - t0 > kWaitNs) __trap();
    w = load_slot(row + min(j, n));
  } while (!word_ready(w, j, n, want));
  return w;
}

// Where a cell's score s' comes from: a register of the row's scores
// against every code, packed as int8 (4 codes or fewer, each s' in int8);
// the block's compact table in shared memory; or the byte table in device
// memory (more than kMaxCodes codes).
enum Score { kPackedRow, kSharedTable, kByteTable };

// The int8 byte `sel` selects from `packed`, sign-extended (prmt's default
// mode: a selector nibble with its top bit set replicates the byte's sign).
__device__ __forceinline__ int prmt(int packed, int sel) {
  int v;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(v) : "r"(packed), "r"(sel));
  return v;
}

// The prmt selector of byte b, sign-extended to 32 bits.
__host__ __device__ constexpr int byte_selector(int b) {
  return b | (b | 8) << 4 | (b | 8) << 8 | (b | 8) << 12;
}

// A 32-bit word of shared memory at a shared-window address. Not volatile:
// the table is read-only once built, so the loads may be scheduled freely.
__device__ __forceinline__ int lds(unsigned addr) {
  int v;
  asm("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// The sweep of one chunk by one warp, its scores by kScore: packed (each
// row's register from `packed`, the column's code a prmt selector; a pad
// row 0), the shared table ctab[yc * (C + 1) + xc] (a pad row's code C), or
// the byte table in device memory (codes are raw bytes, a pad row's offset
// -1). map: byte -> compact code.
//
// A warp issues in order, and a launch of a few long lanes has one warp on
// a scheduler, so every latency in a step is exposed unless the step is
// ordered around its chain -- the north shuffle and R maxima. The scores
// of a step are loaded during the step before it (the table's shared
// address computed once), the diagonal and west terms a(k) = max(G(i-1,
// j-1) + s', G(i, j-1)) need only the previous step, and the next step's
// column code and thread 0's north are shuffled beside this step's north.
// The next word's reference bytes and boundary slots are loaded without
// waiting at step kIssue of a word and used after its last step.
template <int R, Score kScore>
__device__ __forceinline__ void sweep_chunk(const Chunk& c, const int* __restrict__ table,
                                            const int* ctab, const int* packed,
                                            const uint8_t* map, int C, int gap) {
  constexpr bool kGlobal = kScore == kByteTable;
  constexpr bool kPacked = kScore == kPackedRow;
  constexpr int kIssue = 8;
  // Few rows a thread: the launch is a few long lanes, bound by each step's
  // latency (a warp alone on its scheduler) and not by issue.
  constexpr bool kLatency = R <= 8;
  const int lane = threadIdx.x & 31;
  const int n = c.n;
  const int stride = C + 1;
  const unsigned tab = static_cast<unsigned>(__cvta_generic_to_shared(ctab));
  // The band's rows: their packed scores (packed), the shared address of
  // their code's column (shared table), or byte * 256 (global, -1 for a pad
  // row).
  int xo[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = c.r0 + lane * R + k;
    if constexpr (kGlobal) {
      xo[k] = r < c.m ? x_byte(c, r) * 256 : -1;
    } else if constexpr (kPacked) {
      xo[k] = r < c.m ? packed[map[x_byte(c, r)]] : 0;  // a pad row scores 0 <= 0
    } else {
      xo[k] = static_cast<int>(tab) + 4 * (r < c.m ? map[x_byte(c, r)] : C);
    }
  }
  // A column from its byte: its code's prmt selector (packed), the byte
  // offset of code * (C + 1) (shared table), or the byte (global).
  auto row_of = [&](int b) -> int {
    return kGlobal ? b : kPacked ? byte_selector(map[b]) : 4 * map[b] * stride;
  };
  auto byte_at = [&](int j) -> int { return j <= n ? y_byte(c, j) : 0; };
  auto scores = [&](int yc, int (&sc)[R]) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if constexpr (kGlobal) {
        sc[k] = xo[k] < 0 ? kNegBig : __ldg(table + xo[k] + yc) + 2 * gap;
      } else if constexpr (kPacked) {
        sc[k] = prmt(xo[k], yc);
      } else {
        sc[k] = lds(static_cast<unsigned>(xo[k] + yc));
      }
    }
  };
  const bool takes = c.bound_in != nullptr;
  const bool feeds = c.bound_out != nullptr;
  const int out_lane = feeds ? -1 : c.nbands - 1;
  const int out_base = -gap * c.m;  // out[j] = G(m_b, j) - gap * (m_b + j)
  int g[R];
#pragma unroll
  for (int k = 0; k < R; ++k) g[k] = 0;  // G(i, 0) = 0
  int nw = 0;  // G(row above the band, j - 1)
  // Words of 32 columns: thread l holds column 32w + l + 1's table row and,
  // below the lane's first chunk, the row above's G there.
  int ynext = row_of(byte_at(lane + 1));
  unsigned long long bslot = 0;
  if (takes) {
    bslot = poll_word(c.bound_in, lane + 1, n, c.ci, load_slot(c.bound_in + min(lane + 1, n)));
  }
  int bnext = (int)(unsigned)bslot;
  // This step's column row, thread 0's north G(r0, j), and the step's scores.
  int yc = __shfl_sync(kAll, ynext, 0);
  int bin = __shfl_sync(kAll, bnext, 0);
  int sc[R];
  scores(yc, sc);
  const int steps = n + c.nbands - 1;
  for (int s0 = 0; s0 < steps; s0 += 32) {
    const int ycur = ynext;
    const int bcur = bnext;
    const int jn = s0 + 32 + lane + 1;  // this thread's column of the next word
    int ybyte = 0;
    // The word's 32 steps; kSteady: every thread's column is in range at
    // every step, so the step tests nothing.
    auto word = [&](auto steady) {
      constexpr bool kSteady = decltype(steady)::value;
#pragma unroll 1
      for (int u = 0; u < 32; ++u) {
        if (u == kIssue) {  // the next word's loads, not waited for here
          ybyte = byte_at(jn);
          if (takes) bslot = load_slot(c.bound_in + min(jn, n));
        }
        // Shuffles first: this step's north, the next step's code and
        // thread 0's north (after u = 31 the next word's, set below).
        int north = __shfl_up_sync(kAll, g[R - 1], 1);  // band l - 1's last row, column j
        const int ydown = __shfl_up_sync(kAll, yc, 1);
        const int yfirst = __shfl_sync(kAll, ycur, (u + 1) & 31);
        const int bfirst = __shfl_sync(kAll, bcur, (u + 1) & 31);
        // Off the chain: a(k) = max(G(i-1, j-1) + s', G(i, j-1)); where
        // latency rules, their prefix maxima too, so that the chain is one
        // max after the north shuffle.
        int a[R];
        int diag = nw;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          a[k] = __viaddmax_s32(diag, sc[k], g[k]);
          diag = g[k];
        }
        if constexpr (kLatency) {
#pragma unroll
          for (int k = 1; k < R; ++k) a[k] = max(a[k - 1], a[k]);
        }
        if (lane == 0) north = bin;  // 0 above the lane's first chunk
        yc = lane == 0 ? yfirst : ydown;
        bin = bfirst;
        scores(yc, sc);  // the next step's, in flight during this chain
        const int j = s0 + u - lane + 1;
        if (kSteady || (j >= 1 && j <= n && lane < c.nbands)) {
          nw = north;
#pragma unroll
          for (int k = 0; k < R; ++k) {
            g[k] = max(north, a[k]);
            if constexpr (!kLatency) north = g[k];
          }
          if (feeds && lane == 31) store_slot(c.bound_out + j, g[R - 1], c.ci + 1);
          if (lane == out_lane) c.out[j] = g[R - 1] + out_base - gap * j;
        }
      }
    };
    if (kLatency && c.nbands == 32 && s0 >= 31 && s0 + 32 <= n) {
      word(std::true_type{});
    } else {
      word(std::false_type{});
    }
    if (s0 + 32 >= steps) break;
    ynext = row_of(ybyte);
    if (takes) bslot = poll_word(c.bound_in, jn, n, c.ci, bslot);
    bnext = (int)(unsigned)bslot;
    const int y0 = __shfl_sync(kAll, ynext, 0);
    const int b0 = __shfl_sync(kAll, bnext, 0);
    if (lane == 0) {
      yc = y0;
      bin = b0;
      scores(yc, sc);
    }
  }
}

// Blocks an SM must hold: at R = 16 a full card's launch needs four (128
// registers a thread); at R = 32 two.
constexpr int min_blocks(int R) { return R == 16 ? 4 : R == 32 ? 2 : 1; }

template <int R>
__global__ void __launch_bounds__(32 * kMaxWarps, min_blocks(R))
nw_band_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
               const long long* __restrict__ lanes, const long long* __restrict__ chunk_lane,
               int chunks, const int* __restrict__ table, int gap,
               unsigned long long* __restrict__ bound, int* __restrict__ ticket_count,
               int* __restrict__ out, int* __restrict__ sm_of_block) {
  extern __shared__ int ctab[];  // (C x (C + 1)) compact s', transposed
  __shared__ int seen[256];
  __shared__ uint8_t map[256];
  __shared__ uint8_t inv[kMaxCodes];
  __shared__ int packed[4];  // per code, its s' against codes 0..3 as int8
  __shared__ int ticket, ncodes;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int W = blockDim.x >> 5;
  for (int k = t; k < 256; k += blockDim.x) seen[k] = 0;
  if (t == 0) {
    ticket = atomicAdd(ticket_count, W);
    if (sm_of_block != nullptr) {  // where the block ran, for the launch's record
      int sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      sm_of_block[blockIdx.x] = sm;
    }
  }
  __syncthreads();
  const int id = ticket + w;
  Chunk c{};
  const bool active = id < chunks;
  if (active) {
    const long long b = chunk_lane[id];
    const long long* d = lanes + b * kFields;
    const int ci = id - (int)d[kChunk0];
    c.m = (int)d[kM];
    c.n = (int)d[kN];
    c.x_rev = d[kFlags] & 1;
    c.y_rev = d[kFlags] & 2;
    c.x = x + d[kXOff];
    c.y = y + d[kYOff];
    c.out = out + d[kOutOff];
    c.ci = ci;
    c.r0 = ci * 32 * R;
    const int rows = min(c.m - c.r0, 32 * R);
    c.nbands = rows > 0 ? (rows + R - 1) / R : 0;
    const bool last = c.r0 + 32 * R >= c.m;
    c.bound_in = ci > 0 ? bound + d[kBoundOff] : nullptr;
    c.bound_out = last ? nullptr : bound + d[kBoundOff];
    // The bytes this chunk reads: its rows of x_b, all of y_b.
    const int lo = c.x_rev ? c.m - c.r0 - max(rows, 0) : c.r0;
    for (int r = lane; r < rows; r += 32) seen[c.x[lo + r]] = 1;
    for (int j = lane; j < c.n; j += 32) seen[c.y[j]] = 1;
  }
  __syncthreads();
  if (w == 0) {  // compact codes in byte order
    int have = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) have += seen[lane * 8 + k];
    int before = have;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kAll, before, o);
      if (lane >= o) before += v;
    }
    const int total = __shfl_sync(kAll, before, 31);
    before -= have;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int byte = lane * 8 + k;
      if (seen[byte]) {
        map[byte] = (uint8_t)min(before, 255);
        if (before < kMaxCodes) inv[before] = (uint8_t)byte;
        ++before;
      } else {
        map[byte] = 0;
      }
    }
    if (lane == 0) ncodes = total;
  }
  __syncthreads();
  const int C = ncodes;
  const bool compact = C <= kMaxCodes;
  bool fits = C <= 4;  // every s' an int8
  if (compact) {
    const int stride = C + 1;
    for (int k = t; k < C * stride; k += blockDim.x) {
      const int yc = k / stride, xc = k % stride;
      ctab[k] = xc == C ? kNegBig : table[inv[xc] * 256 + inv[yc]] + 2 * gap;
      if (xc < C) fits = fits && ctab[k] >= -128 && ctab[k] <= 127;
    }
  }
  fits = __syncthreads_and(fits);
  if (fits && t < C) {
    int p = 0;
    for (int yc = 0; yc < C; ++yc) p |= (ctab[yc * (C + 1) + t] & 0xff) << (8 * yc);
    packed[t] = p;
  }
  __syncthreads();
  if (!active) return;
  if (lane == 0 && c.bound_out == nullptr) c.out[0] = -gap * c.m;
  if (c.nbands == 0) {  // m_b = 0: row 0
    for (int j = lane + 1; j <= c.n; j += 32) c.out[j] = -gap * j;
    return;
  }
  if (c.n == 0) return;
  if (fits) {
    sweep_chunk<R, kPackedRow>(c, table, ctab, packed, map, C, gap);
  } else if (compact) {
    sweep_chunk<R, kSharedTable>(c, table, ctab, packed, map, C, gap);
  } else {
    sweep_chunk<R, kByteTable>(c, table, ctab, packed, map, C, gap);
  }
}

template <int R>
cudaError_t launch(const void* x, const void* y, const void* lanes, const void* chunk_lane,
                   int chunks, int warps, const void* table, int gap, void* bound, void* ticket,
                   void* out, void* sm_of_block, cudaStream_t stream) {
  const size_t smem = (size_t)kMaxCodes * (kMaxCodes + 1) * sizeof(int);
  const int blocks = (chunks + warps - 1) / warps;
  nw_band_kernel<R><<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y),
      static_cast<const long long*>(lanes), static_cast<const long long*>(chunk_lane), chunks,
      static_cast<const int*>(table), gap, static_cast<unsigned long long*>(bound),
      static_cast<int*>(ticket), static_cast<int*>(out), static_cast<int*>(sm_of_block));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Every pointer is a device pointer
// to a contiguous tensor.
//
// pgs_nw_lastrow (K25): x, y flat uint8 buffers; lanes (B, 8) int64 lane
// descriptors (x_off, y_off, out_off, bound_off, m_b, n_b, direction bits,
// first chunk) and chunk_lane (chunks,) int64, the lane of each chunk, in
// lane order then row order; rows R a thread (4, 8, 16 or 32), warps a block
// (1-4); table (256, 256) int32 over raw bytes; the linear gap; bound the
// lanes' boundary rows, int64 slots zeroed by the caller (lane b's one row
// of n_b + 1 slots at bound_off, for a lane of two chunks or more; null
// when no lane has two); ticket
// one int32 zeroed by the caller; out int32, lane b's H(m_b, j) at out_off
// + j for j = 0..n_b; sm_of_block, when not null, an int32 a block that
// receives the SM the block ran on. Returns cudaErrorInvalidValue for a
// shape it does not take, else cudaGetLastError() after the launch (no
// sync).
extern "C" int pgs_nw_lastrow(const void* x, const void* y, const void* lanes,
                              const void* chunk_lane, int chunks, int rows, int warps,
                              const void* table, int gap, void* bound, void* ticket, void* out,
                              void* sm_of_block, void* stream) {
  if (chunks < 0 || warps < 1 || warps > kMaxWarps) return cudaErrorInvalidValue;
  if (chunks == 0) return cudaSuccess;
  using Launch = decltype(&launch<4>);
  const Launch fn = rows == 4    ? &launch<4>
                    : rows == 8  ? &launch<8>
                    : rows == 16 ? &launch<16>
                    : rows == 32 ? &launch<32>
                                 : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(x, y, lanes, chunk_lane, chunks, warps, table, gap, bound, ticket, out, sm_of_block,
            static_cast<cudaStream_t>(stream));
}
