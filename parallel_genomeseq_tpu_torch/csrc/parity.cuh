// Device code shared by the reference-parity kernels, K26 (csrc/wavefront.cu,
// built by csrc/wavefront_parity.cu) and K27 (csrc/strips.cu): the skewed
// tie's raw key and order, the search for a column's candidate cell at the
// wrap row, and the pair form's cell.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The `skewed` argument of K26/K27: the column-major tie; the skewed tie
// with each column's key found at the wrap row; the skewed tie with the key
// computed for every cell of a column's maximum, which the wrappers take
// where keys could pass 2^31 (see wrap_row_pick).
enum Tie { kColmajor = 0, kSkewedWrap = 1, kSkewedEveryCell = 2 };

// The skewed order: higher score, then smaller raw key, then i, then j.
__device__ __forceinline__ bool better_skewed(int v1, int k1, int i1, int j1, int v2, int k2,
                                              int i2, int j2) {
  return v1 > v2 ||
         (v1 == v2 && (k1 < k2 || (k1 == k2 && (i1 < i2 || (i1 == i2 && j1 < j2)))));
}

// The raw key of cell (i, j) of a lane of lengths (mb, nb) under the skewed
// tie, as the JAX scan computes it (ops/scan_dp.py:144-160): s = i + j; rj =
// s up to max(mb, nb), s - max - 1 past it; ri = j unless nb > mb, where ri
// = j below min(mb, nb), j - (nb - mb) past the max and mb - i between; key
// = rj * (M + 33) + ri in 32-bit wrapping arithmetic, M the padded read
// length.
struct RawKey {
  int mb, minmn, maxmn, dnm, mult;
  bool ngtm;
  __device__ RawKey(int mb_, int nb_, int M)
      : mb(mb_), minmn(min(mb_, nb_)), maxmn(max(mb_, nb_)), dnm(nb_ - mb_), mult(M + 33),
        ngtm(nb_ > mb_) {}
  __device__ __forceinline__ int operator()(int i, int j) const {
    const int s = i + j;
    const int ri = !ngtm || s < minmn ? j : s > maxmn ? j - dnm : mb - i;
    const int rj = s <= maxmn ? s : s - maxmn - 1;
    return static_cast<int>(static_cast<unsigned>(rj) * static_cast<unsigned>(mult) +
                            static_cast<unsigned>(ri));
  }
};

// The place, among a thread's rows row0 + 1 .. row0 + R of column j, of the
// cell of least raw key among those of the column's maximum: eq has bit k
// set when row row0 + k + 1 holds it (some bit is set), kw = max(mb, nb) - j
// - row0. Within a column the key grows with i on each side of the wrap row
// i = max(mb, nb) - j (a row down, rj rises by 1 and ri stays or falls by
// 1), and every cell past it has a smaller key than every cell before it
// (rj <= j - 1 past it and >= j + 1 before, ri past it at most ri before
// it), so it is the least such row past the wrap (k >= kw), else the least
// such row. That holds while no key passes 2^31, for (M + N) (M + 33) + N <
// 2^31 (ops/wavefront_cuda.key_rule); a cell on the wrap row, i + j =
// max(mb, nb), lies before it.
__device__ __forceinline__ int wrap_row_pick(uint32_t eq, int kw) {
  const uint32_t past = kw <= 0 ? eq : kw >= 32 ? 0u : eq & (~0u << kw);
  return __ffs(past ? past : eq) - 1;
}

// A column's candidate among the rows set in eq (bit k: row row0 + k + 1 of
// column j holds the column's maximum; some bit is set): its place, and its
// raw key in `key`. Under kSkewedWrap the row wrap_row_pick finds, its key
// computed alone; else (kSkewedEveryCell: past the 2^31 key bound, where
// keys wrap and no longer follow the rows) the least key of every such row,
// the least row on equal keys, in a loop over the set bits.
__device__ __forceinline__ int candidate(uint32_t eq, const RawKey& raw_key, int row0, int j,
                                         int skewed, int& key) {
  int kk = skewed == kSkewedWrap ? wrap_row_pick(eq, raw_key.maxmn - j - row0) : __ffs(eq) - 1;
  key = raw_key(row0 + kk + 1, j);
  if (skewed != kSkewedWrap) {
#pragma unroll 1
    for (uint32_t rest = eq & (eq - 1); rest != 0; rest &= rest - 1) {
      const int k = __ffs(rest) - 1;
      const int c = raw_key(row0 + k + 1, j);
      if (c < key) {
        key = c;
        kk = k;
      }
    }
  }
  return kk;
}

// Whether column j of a thread's R rows (row0 + 1 .. row0 + R), which only
// ties the thread's best (of key bkey), can hold a cell of smaller key, by
// the column's least key: that of its first row past the wrap, else of its
// first row (see wrap_row_pick). With no row past the wrap (kw >= R), every
// cell's rj is at least row0 + 1 + j and its ri at least 0, which bounds
// the key without computing one; else the least key is computed. A tie
// that cannot win is passed over without its search.
__device__ __forceinline__ bool tie_may_win(int mb, int nb, int M, int row0, int j, int R,
                                            int bkey) {
  const int kw = max(mb, nb) - j - row0;
  if (kw >= R) return (row0 + 1 + j) * (M + 33) < bkey;
  return RawKey(mb, nb, M)(row0 + max(kw, 0) + 1, j) < bkey;
}

// The pair form (K26's score-only sweep and K27's column-major sweep, under
// saturation with uniform scores): a 32-bit
// word holds one row's cell of two lanes, lane b in the low signed 16-bit
// half and lane b + 1 in the high one, and each DPX s16x2 instruction steps
// both. With the clipped operands (ops/scan_dp.sat_operands) match in [0,
// 255], mismatch in [-255, 0] and gap in [0, 255], every H lies in [0, 255],
// and every value below in [-255, 766], so no half carries into or borrows
// from the other:
//   flag = min(x ^ y, 1), the half's mismatch bit (its bytes in [0, 255]);
//   sb   = (match + 256) - flag * (match - mismatch): s + 256, in [1, 511],
//          one IMAD: flag * d (d in [0, 510]) is at most 510 a half, and
//          match + 256 - d = mismatch + 256 >= 1 leaves no borrow;
//   t    = max(west + 256 - gap, 256) = max(west - gap, 0) + 256;
//   a    = min(max(diag + sb, t) - 256, 255), the clamp taken before the
//          north chain, which is exact because north <= 255;
//   H    = max(north - gap, a).
// Four DPX instructions and three others a pair of cells, against the int32
// step's seven a cell.
struct PairStep {
  uint32_t sbias, diff, wbias, ngap;
  __device__ PairStep(int match, int mismatch, int gap)
      : sbias(static_cast<uint32_t>(match + 256) * 0x10001u),
        diff(static_cast<uint32_t>(match - mismatch)),
        wbias(static_cast<uint32_t>(256 - gap) * 0x10001u),
        ngap((static_cast<uint32_t>(-gap) & 0xffffu) * 0x10001u) {}
  // The north-independent part a of a pair of cells, clamped; x and y the
  // two lanes' read and reference bytes, one a half.
  __device__ __forceinline__ uint32_t off_chain(uint32_t x, uint32_t y, uint32_t diag,
                                                uint32_t west) const {
    const uint32_t flag = __vimin_s16x2_relu(x ^ y, 0x00010001u);
    const uint32_t sb = sbias - flag * diff;
    const uint32_t t = __viaddmax_s16x2(west, wbias, 0x01000100u);
    return __viaddmin_s16x2(__viaddmax_s16x2(diag, sb, t), 0xff00ff00u, 0x00ff00ffu);
  }
  // The north chain, one DPX a row: H = max(north - gap, a).
  __device__ __forceinline__ uint32_t chain(uint32_t north, uint32_t a) const {
    return __viaddmax_s16x2(north, ngap, a);
  }
};

// Half h (0 low, 1 high) of a pair word whose halves lie in [0, 32767].
__device__ __forceinline__ int half_of(uint32_t v, int h) {
  return static_cast<int>(h ? v >> 16 : v & 0xffffu);
}

}  // namespace
