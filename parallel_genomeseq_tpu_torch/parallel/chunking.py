"""Overlapping reference windows and the per-read argmax merge: the port of
the JAX package's ``parallel/chunking.py`` (:31-230).

Stage A scores every (read, window) pair as one lane of a score-only K1
sweep; the best window per read wins (first window on ties); stage B re-runs
the winners through ``BatchSWAligner`` (K2 + K3) and offsets positions back
to reference coordinates. Same lane order, window geometry, merge and
``align_stream`` depth as the JAX package. Unlike it there is no fallback to
another engine: a batch the kernels cannot run raises.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from parallel_genomeseq_tpu.utils.config import ChunkConfig, ScoringConfig
from parallel_genomeseq_tpu.utils.encoding import X_PAD, Y_PAD, batch_pad, to_bytes
from parallel_genomeseq_tpu.utils.result import AlignResult, Timings

from ..models.swaligner import PAD_M, PAD_N, BatchSWAligner, round_up
from ..ops.engine import CudaEngine
from ..utils.device import to_host


def make_string_ranges(
    npiece: int, short_len: int, long_len: int, overlap_ratio: float
) -> List[Tuple[int, int]]:
    """Overlapping [left, right) windows of the long sequence (copied from
    chunking.py:31-62, the reference's ``_make_string_range``): overlap =
    short_len * overlap_ratio, piece = (long_len + (npiece-1) * overlap) //
    npiece, each window starting overlap before the previous window's end;
    the last window absorbs the remainder."""
    overlap = int(short_len * overlap_ratio)
    if npiece == 1:
        return [(0, long_len)]
    piece = (long_len + (npiece - 1) * overlap) // npiece
    if overlap > piece:
        raise ValueError(
            f"overlap {overlap} > piece length {piece}: reduce npiece or overlap_ratio"
        )
    ranges = [(0, piece)]
    right = piece
    while len(ranges) < npiece - 1:
        left = max(0, right - overlap)
        right = min(left + piece, long_len)
        ranges.append((left, right))
    if right >= long_len:
        raise ValueError(
            f"npiece {npiece} too large for long_len {long_len}: windows exhausted"
        )
    ranges.append((max(0, right - overlap), long_len))
    return ranges


class ChunkedAligner:
    """Align reads against one long reference via overlapping windows:
    (R reads x P pieces) lanes -> one score-only sweep -> per-read argmax
    over pieces -> one R-lane traceback re-run on the winning windows."""

    def __init__(
        self,
        cfg: ScoringConfig = ScoringConfig(),
        chunk: ChunkConfig = ChunkConfig(npiece=4, overlap_ratio=2.0),
        device=None,
    ):
        self.cfg = cfg
        self.chunk = chunk
        self.engine = CudaEngine(cfg, device)
        self._winner_aligner = BatchSWAligner(cfg, device=self.engine.device)

    def align_batch(self, reads: Sequence[str], ref: str,
                    traceback: bool = True) -> List[AlignResult]:
        return self._collect_winner(
            self._submit_winner(self._submit_scores(reads, ref, traceback))
        )

    def align_stream(self, batches, ref: str, traceback: bool = True, depth: int = 2):
        """Pipelined alignment over an iterable of read batches: both stages
        dispatch up to ``depth`` batches ahead of the oldest blocking fetch.
        Yields List[AlignResult] per input batch, in order."""
        from collections import deque

        qa, qb = deque(), deque()
        for batch in batches:
            qa.append(self._submit_scores(batch, ref, traceback))
            if len(qa) > depth:
                qb.append(self._submit_winner(qa.popleft()))
            if len(qb) > depth:
                yield self._collect_winner(qb.popleft())
        while qa:
            qb.append(self._submit_winner(qa.popleft()))
            if len(qb) > depth:
                yield self._collect_winner(qb.popleft())
        while qb:
            yield self._collect_winner(qb.popleft())

    def window_lanes(self, reads: Sequence[str], ref: str):
        """Stage A lanes, read-major [r0p0, r0p1, ..., r1p0, ...]: returns
        (xs (R*P, M), ys (R*P, N) uint8, m, n (R*P,) int32, per-read window
        ranges), padded like the JAX package."""
        P = self.chunk.npiece
        ref_b = to_bytes(ref)
        xb = [to_bytes(r) for r in reads]
        all_ranges = [
            make_string_ranges(P, len(x), len(ref_b), self.chunk.overlap_ratio)
            for x in xb
        ]
        m = np.repeat([len(x) for x in xb], P).astype(np.int32)
        lane_ranges = [rg for ranges in all_ranges for rg in ranges]
        n = np.array([r - l for l, r in lane_ranges], np.int32)
        M = round_up(max(len(x) for x in xb), PAD_M)
        N = round_up(int(n.max()), PAD_N)
        xs = batch_pad([x for x in xb for _ in range(P)], M, X_PAD)
        ys = np.full((len(reads) * P, N), Y_PAD, np.uint8)
        for k, (l, r) in enumerate(lane_ranges):
            ys[k, : r - l] = ref_b[l:r]
        return xs, ys, m, n, all_ranges

    def _submit_scores(self, reads: Sequence[str], ref: str, traceback: bool):
        """Stage A dispatch: the (R x P)-lane score-only sweep. Returns a
        pending dict; the score fetch blocks in _submit_winner."""
        xs, ys, m, n, all_ranges = self.window_lanes(reads, ref)
        t0 = time.perf_counter()
        dev = self.engine.device
        res = self.engine.score_batch(
            torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev), m, n,
            need_pos=False,
        )
        return {
            "reads": list(reads), "ref": ref, "all_ranges": all_ranges,
            "score": res["score"], "R": len(reads), "traceback": traceback,
            "t0": t0,
        }

    def _submit_winner(self, pa):
        """Stage A fetch + stage B dispatch: wait for the window scores,
        argmax-merge per read, dispatch the winners' traceback re-run."""
        R = pa["R"]
        P = self.chunk.npiece
        all_ranges = pa["all_ranges"]
        (scores,) = to_host([pa["score"]])
        scores = scores.reshape(R, P)
        winner = np.argmax(scores, axis=1)  # first piece wins ties
        sweep_us = (time.perf_counter() - pa["t0"]) * 1e6
        lefts = np.array([all_ranges[r][winner[r]][0] for r in range(R)], np.int64)
        if not pa["traceback"]:
            t = Timings(sweep_us=sweep_us)
            return {
                "results": [
                    AlignResult(score=float(scores[r, winner[r]]), pos=0, timings=t)
                    for r in range(R)
                ]
            }
        ref = pa["ref"]
        win_refs = [
            ref[all_ranges[r][winner[r]][0] : all_ranges[r][winner[r]][1]]
            for r in range(R)
        ]
        pending = self._winner_aligner.submit_batch(pa["reads"], win_refs)
        return {"pending": pending, "lefts": lefts}

    def _collect_winner(self, pb) -> List[AlignResult]:
        if "results" in pb:
            return pb["results"]
        results = self._winner_aligner.collect(pb["pending"])
        lefts = pb["lefts"]
        return [
            AlignResult(
                score=res.score,
                pos=(res.pos + int(lefts[r])) if res.pos > 0 else 0,
                consensus_x=res.consensus_x,
                consensus_y=res.consensus_y,
                max_i=res.max_i,
                max_j=(res.max_j + int(lefts[r])) if res.max_j > 0 else 0,
                timings=res.timings,
            )
            for r, res in enumerate(results)
        ]
