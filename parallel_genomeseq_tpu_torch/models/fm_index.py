"""BWT / FM-index exact-match seeding (copied from the JAX package's
``parallel_genomeseq_tpu/models/fm_index.py``; numpy only, behaviour
unchanged).

Prefix-doubling suffix array, BWT, C and the occurrence counts;
``backward_search`` -> (sp, ep) SA interval (empty when the pattern is
absent); ``locate`` -> sorted text positions; ``seeds`` / ``seeds_batch`` ->
exact k-mer (read offset, text position) anchors for seed-and-extend
(``models/seed_extend.py``). Host code by design: the probes are sequential
and data-dependent.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SENTINEL = 0  # '$' maps to 0, below every real character


class FMIndex:
    def __init__(self, text: str, occ_sample: int = 32):
        """Build over ``text`` (no '$'; appended internally)."""
        self.text = text
        data = np.frombuffer(text.encode("ascii"), np.uint8).astype(np.int32) + 1
        s = np.concatenate([data, [SENTINEL]])
        self.n = len(s)
        self.sa = _suffix_array(s)
        # BWT: char preceding each suffix (wraps to the sentinel's left).
        self.bwt = s[(self.sa - 1) % self.n]
        # Alphabet-compact mapping.
        self.alphabet = np.unique(s)
        amap = np.full(256 + 2, -1, np.int32)
        amap[self.alphabet] = np.arange(len(self.alphabet))
        self._amap = amap
        bwt_c = amap[self.bwt]
        counts = np.bincount(amap[s], minlength=len(self.alphabet))
        # C[c] = number of chars strictly smaller than c.
        self.C = np.concatenate([[0], np.cumsum(counts)[:-1]])
        # Sampled occurrence counts: occ[k, c] = #{bwt[:k*t] == c}.
        self.occ_sample = occ_sample
        onehot = bwt_c[:, None] == np.arange(len(self.alphabet))[None, :]
        cum = np.cumsum(onehot, axis=0)
        self._occ_full = np.concatenate(
            [np.zeros((1, len(self.alphabet)), np.int64), cum], axis=0
        )

    def _occ(self, k: int, c: int) -> int:
        """#occurrences of alphabet-index c in bwt[:k]."""
        return int(self._occ_full[k, c])

    def backward_search(self, pattern: str) -> Tuple[int, int]:
        """SA interval [sp, ep) of suffixes prefixed by pattern; empty
        interval (sp >= ep) when absent."""
        sp, ep = 0, self.n
        pat = np.frombuffer(pattern.encode("ascii"), np.uint8).astype(np.int32) + 1
        for ch in pat[::-1]:
            c = int(self._amap[ch])
            if c < 0:
                return 0, 0
            sp = int(self.C[c]) + self._occ(sp, c)
            ep = int(self.C[c]) + self._occ(ep, c)
            if sp >= ep:
                return 0, 0
        return sp, ep

    def count(self, pattern: str) -> int:
        sp, ep = self.backward_search(pattern)
        return ep - sp

    def locate(self, pattern: str) -> List[int]:
        """Sorted 0-based text positions of all occurrences."""
        sp, ep = self.backward_search(pattern)
        return sorted(int(self.sa[k]) for k in range(sp, ep))

    def seeds(self, read: str, k: int, step: int = 1) -> List[Tuple[int, int]]:
        """(read_offset, text_position) pairs for exact k-mer matches —
        seed-and-extend anchors for the wavefront aligner."""
        out = []
        for off in range(0, max(len(read) - k + 1, 0), step):
            for pos in self.locate(read[off : off + k]):
                out.append((off, pos))
        return out

    def seeds_batch(
        self, reads: List[str], k: int, step: int = 1
    ) -> List[List[Tuple[int, int]]]:
        """``seeds`` for a whole batch at once: every k-mer of every read is
        backward-searched SIMULTANEOUSLY as numpy lanes (k vectorized steps
        over Q = sum of per-read k-mer counts, instead of Q*k scalar python
        iterations). An empty interval stays empty under further updates
        (occ is monotone), so dead k-mers need no masking. Returns one
        (read_offset, text_position) list per read, same contents as
        per-read ``seeds``."""
        # Group reads by length so the k-mer windows of a whole group build
        # with ONE strided view (the round-3 per-read python loop — 1024
        # sliding_window_view calls per batch — was the measured host
        # bottleneck of the seeding stage).
        from collections import defaultdict

        by_len = defaultdict(list)
        for ri, read in enumerate(reads):
            if len(read) >= k:
                by_len[len(read)].append(ri)
        out: List[List[Tuple[int, int]]] = [[] for _ in reads]
        if not by_len:
            return out
        qread_l, qoffs_l, pats_l = [], [], []
        for L, idxs in by_len.items():
            nq = (L - k) // step + 1
            mat = np.frombuffer(
                "".join(reads[ri] for ri in idxs).encode("ascii"), np.uint8
            ).reshape(len(idxs), L)
            win = np.lib.stride_tricks.sliding_window_view(mat, k, axis=1)
            pats_l.append(win[:, ::step].reshape(-1, k))
            qoffs_l.append(
                np.tile(np.arange(nq, dtype=np.int64) * step, len(idxs))
            )
            qread_l.append(np.repeat(np.asarray(idxs, np.int64), nq))
        cls = self._amap[np.concatenate(pats_l).astype(np.int32) + 1]  # (Q, k)
        qoffs = np.concatenate(qoffs_l)
        qread = np.concatenate(qread_l)
        Q = cls.shape[0]
        sp = np.zeros(Q, np.int64)
        ep = np.full(Q, self.n, np.int64)
        for t in range(k - 1, -1, -1):
            c = cls[:, t]
            bad = c < 0
            c = np.where(bad, 0, c)
            sp = self.C[c] + self._occ_full[sp, c]
            ep = self.C[c] + self._occ_full[ep, c]
            ep = np.where(bad, sp, ep)  # unknown char: kill the interval
        lens = np.maximum(ep - sp, 0)
        if int(lens.sum()) == 0:
            return out
        # Expand each non-empty SA interval: sa[sp[q] : ep[q]] for every q,
        # without a python loop (repeat + cumulative-range trick).
        starts = np.repeat(sp, lens)
        within = np.arange(int(lens.sum())) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
        )
        pos = self.sa[starts + within]
        hit_q = np.repeat(np.arange(Q), lens)
        # Split hits per read with one stable sort instead of a per-hit
        # python append loop.
        rid = qread[hit_q]
        order = np.argsort(rid, kind="stable")
        rid_s = rid[order]
        roff_s = qoffs[hit_q][order].tolist()
        pos_s = pos[order].tolist()
        bounds = np.searchsorted(rid_s, np.arange(len(reads) + 1))
        for ri in range(len(reads)):
            a, b = int(bounds[ri]), int(bounds[ri + 1])
            if a < b:
                out[ri] = list(zip(roff_s[a:b], pos_s[a:b]))
        return out


def _suffix_array(s: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array (numpy; O(n log^2 n))."""
    n = len(s)
    rank = np.argsort(s, kind="stable")
    # initial ranks from char classes
    sorted_s = s[rank]
    cls = np.zeros(n, np.int64)
    cls[rank[1:]] = np.cumsum(sorted_s[1:] != sorted_s[:-1])
    k = 1
    idx = np.arange(n)
    while k < n:
        key2 = np.where(idx + k < n, cls[np.minimum(idx + k, n - 1)], -1)
        order = np.lexsort((key2, cls))
        new_cls = np.zeros(n, np.int64)
        a = cls[order]
        b = key2[order]
        diff = np.concatenate([[0], ((a[1:] != a[:-1]) | (b[1:] != b[:-1])).astype(np.int64)])
        new_cls[order] = np.cumsum(diff)
        cls = new_cls
        if cls[order[-1]] == n - 1:
            return order
        k *= 2
    return np.argsort(cls)
