"""Seed-and-extend alignment: FM-index exact seeds, then a windowed
extension: the port of the JAX package's ``models/seed_extend.py`` (:40-191).

1. ``FMIndex.seeds_batch`` anchors exact k-mers of every read of a batch on
   the reference (host numpy: sequential, data-dependent probes).
2. Seeds vote by diagonal (ref_pos - read_offset); diagonals within
   margin / 2 of each other cluster, and the cluster with the most distinct
   read offsets (ties: the smallest diagonal, the full-width engines'
   leftmost convention) gives a reference window of ``margin`` columns each
   side of its placement.
3. The port's ``BatchSWAligner`` extends each seeded read inside its window
   only (K2 and the K3 walk, K7 and K10 under affine gaps, K5 under a
   matrix): a banded Smith-Waterman whose band the seeds chose. Reads with no
   qualifying seed run full-width. Both batches are dispatched before either
   is collected, so the card works on the second while the host waits on
   neither. Window-local ``pos`` and ``max_j`` are offset back by the
   window's left edge, except that a 0 (an all-zero lane) stays 0, as
   ``collect`` does in JAX (:151-170).

Seeded reads are heuristic, as in every seed-and-extend aligner: a read
whose optimum has no exact k-mer can seed a decoy region and score below
full-width SW; unseeded reads never degrade.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..utils.config import ScoringConfig
from ..utils.result import AlignResult
from .fm_index import FMIndex
from .swaligner import BatchSWAligner


def cluster_diagonals(
    seeds: Sequence[Tuple[int, int]], slack: int
) -> List[Tuple[int, int, int]]:
    """Group seeds whose diagonals (pos - offset) lie within ``slack`` of the
    previous one. Returns [(votes, dmin, dmax)] per cluster, where votes
    counts *distinct read offsets* (a repetitive k-mer hitting many reference
    copies inflates seed count but not placement evidence)."""
    if not seeds:
        return []
    by_diag = sorted((pos - off, off) for off, pos in seeds)
    clusters = []
    offs = {by_diag[0][1]}
    dmin = dmax = by_diag[0][0]
    for d, off in by_diag[1:]:
        if d - dmax <= slack:
            dmax = d
            offs.add(off)
        else:
            clusters.append((len(offs), dmin, dmax))
            offs = {off}
            dmin = dmax = d
    clusters.append((len(offs), dmin, dmax))
    return clusters


class SeedExtendAligner:
    """FM-index seeded, window-extended batch aligner over one reference.

    ref: the reference string (indexed once here). k / step: the seed k-mer
    length and read-offset stride. margin: reference columns kept each side
    of the seeded placement. min_votes: clusters with fewer distinct-offset
    votes are ignored. aligner: the extension's ``BatchSWAligner`` (default:
    one over ``cfg`` on ``device``)."""

    def __init__(
        self,
        ref: str,
        cfg: ScoringConfig = ScoringConfig(),
        k: int = 24,
        step: int = 8,
        margin: int = 64,
        min_votes: int = 1,
        aligner: Optional[BatchSWAligner] = None,
        device=None,
    ):
        self.ref = ref
        self.fm = FMIndex(ref)
        self.k = k
        self.step = step
        self.margin = margin
        self.min_votes = min_votes
        self.aligner = aligner if aligner is not None else BatchSWAligner(cfg, device=device)
        self.engine = self.aligner.engine

    def _window_from_seeds(self, read: str, seeds) -> Optional[Tuple[int, int]]:
        clusters = cluster_diagonals(seeds, slack=self.margin // 2)
        if not clusters:
            return None
        # Vote ties prefer the smallest diagonal, the leftmost / min-j tie
        # convention of the full-width engines.
        votes, dmin, dmax = max(clusters, key=lambda c: (c[0], -c[1], -c[2]))
        if votes < self.min_votes:
            return None
        left = max(0, dmin - self.margin)
        right = min(len(self.ref), dmax + len(read) + self.margin)
        return (left, right) if right > left else None

    def window(self, read: str) -> Optional[Tuple[int, int]]:
        """Best-supported reference window [left, right) for ``read``, or
        None when seeding fails (the caller falls back to the reference)."""
        if len(read) < self.k:
            return None
        return self._window_from_seeds(read, self.fm.seeds(read, self.k, self.step))

    def windows_batch(self, reads: Sequence[str]) -> List[Optional[Tuple[int, int]]]:
        """``window`` for a whole batch through one vectorized FM probe."""
        seed_lists = self.fm.seeds_batch(list(reads), self.k, self.step)
        return [
            self._window_from_seeds(r, s) for r, s in zip(reads, seed_lists)
        ]

    def submit_batch(self, reads: Sequence[str], traceback: bool = True) -> dict:
        """Dispatch one batch without waiting: seeded reads extend inside
        their windows, the rest run full-width, both dispatched before
        either is collected. Pair with ``collect``."""
        windows = self.windows_batch(reads)
        seeded = [i for i, w in enumerate(windows) if w is not None]
        full = [i for i, w in enumerate(windows) if w is None]
        pend_s = pend_f = None
        if seeded:
            pend_s = self.aligner.submit_batch(
                [reads[i] for i in seeded],
                [self.ref[windows[i][0] : windows[i][1]] for i in seeded],
                traceback,
            )
        if full:
            pend_f = self.aligner.submit_batch(
                [reads[i] for i in full], [self.ref] * len(full), traceback
            )
        return {
            "n": len(reads), "windows": windows, "seeded": seeded,
            "full": full, "pend_s": pend_s, "pend_f": pend_f,
        }

    def collect(self, pending: dict) -> List[AlignResult]:
        """Results in read order, seeded ones in global coordinates."""
        windows = pending["windows"]
        out: List[Optional[AlignResult]] = [None] * pending["n"]
        if pending["pend_s"] is not None:
            for i, r in zip(pending["seeded"], self.aligner.collect(pending["pend_s"])):
                left = windows[i][0]
                out[i] = AlignResult(
                    score=r.score,
                    pos=(r.pos + left) if r.pos > 0 else 0,
                    consensus_x=r.consensus_x,
                    consensus_y=r.consensus_y,
                    max_i=r.max_i,
                    max_j=(r.max_j + left) if r.max_j > 0 else 0,
                    timings=r.timings,
                )
        if pending["pend_f"] is not None:
            for i, r in zip(pending["full"], self.aligner.collect(pending["pend_f"])):
                out[i] = r
        return out  # type: ignore[return-value]

    def align_batch(self, reads: Sequence[str], traceback: bool = True) -> List[AlignResult]:
        return self.collect(self.submit_batch(reads, traceback))

    def align_stream(self, batches, traceback: bool = True, depth: int = 4):
        """Pipelined streaming: the host's seeding of later batches overlaps
        the card's extension of earlier ones (up to ``depth`` ahead)."""
        from collections import deque

        q = deque()
        for batch in batches:
            q.append(self.submit_batch(batch, traceback))
            if len(q) > depth:
                yield self.collect(q.popleft())
        while q:
            yield self.collect(q.popleft())

    def align(self, read: str, traceback: bool = True) -> AlignResult:
        return self.align_batch([read], traceback)[0]
