"""Smith-Waterman aligner API, batch-first: the port of the JAX package's
``models/swaligner.py`` (:59-354) for the linear-gap, single-strip path.

Per batch: K2 (``CudaEngine.score_batch_moves``) computes score, argmax and
move codes in one pass, K3 (``walk_moves``) walks every lane, and ``collect``
copies all outputs to the host with one synchronisation before the host
string assembly. Dispatch is asynchronous: ``submit_batch`` returns while the
device works, so ``align_stream`` overlaps host preparation of later batches
with the device work of earlier ones.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from parallel_genomeseq_tpu.utils.config import ScoringConfig
from parallel_genomeseq_tpu.utils.encoding import X_PAD, Y_PAD, batch_pad, to_bytes
from parallel_genomeseq_tpu.utils.result import AlignResult, Timings

from ..ops.engine import CudaEngine, check_supported
from ..ops.traceback import decode_consensus, walk_moves
from ..utils.device import to_host


# Batch shapes are padded to multiples of these. They must equal the JAX
# package's defaults (swaligner.py:71-72, chunking.py:82-83): the padded M and
# N set the walk's max_steps, and so where a long consensus is truncated,
# which the byte-identical align_output.csv depends on. The kernels bound
# their loops by the true lengths, so padding sets nothing else.
PAD_M = 8
PAD_N = 128


def round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


class BatchSWAligner:
    """Aligns batches of reads against per-lane reference windows."""

    def __init__(
        self,
        cfg: ScoringConfig = ScoringConfig(),
        tie: str = "colmajor",
        device=None,
    ):
        check_supported(cfg, tie)
        self.cfg = cfg
        self.engine = CudaEngine(cfg, device)
        self.device = self.engine.device

    def align_batch(self, reads: Sequence[str], refs: Sequence[str],
                    traceback: bool = True) -> List[AlignResult]:
        """Align reads[k] against refs[k] (a length-1 refs list is shared)."""
        return self.collect(self.submit_batch(reads, refs, traceback))

    def align_stream(self, batches, refs, traceback: bool = True, depth: int = 4):
        """Pipelined alignment over an iterable of read batches: up to
        ``depth`` batches are dispatched ahead of the oldest uncollected one.
        Yields one List[AlignResult] per input batch, in order. ``depth``
        bounds device memory: each in-flight batch holds its moves tensor."""
        from collections import deque

        q = deque()
        for batch in batches:
            q.append(self.submit_batch(batch, refs, traceback))
            if len(q) > depth:
                yield self.collect(q.popleft())
        while q:
            yield self.collect(q.popleft())

    def pad_batch(self, reads, refs):
        """Reads/refs -> (xs (B, M), ys (B, N) uint8, m, n (B,) int32) on the
        host, padded like the JAX package."""
        if len(refs) == 1 and len(reads) > 1:
            refs = list(refs) * len(reads)
        if len(reads) != len(refs):
            raise ValueError("reads and refs length mismatch")
        xb = [to_bytes(r) for r in reads]
        yb = [to_bytes(r) for r in refs]
        m = np.array([len(v) for v in xb], np.int32)
        n = np.array([len(v) for v in yb], np.int32)
        M = round_up(max(1, int(m.max())), PAD_M)
        N = round_up(max(1, int(n.max())), PAD_N)
        return batch_pad(xb, M, X_PAD), batch_pad(yb, N, Y_PAD), m, n

    def max_steps(self, M: int, N: int) -> int:
        """Walk-length bound of swaligner.py:145-149: <= M diagonal/north
        moves plus at most score/gap west moves, capped by M + N + 1."""
        gapv = max(float(self.cfg.gap_penalty), 1e-9)
        matchv = max(float(self.cfg.match), 1.0)
        return min(int(M + matchv * M / gapv) + 8, M + N + 1)

    def submit_batch(self, reads, refs, traceback: bool = True) -> "_PendingBatch":
        """Dispatch one batch without waiting for its results; pair with
        ``collect``."""
        xs, ys, m, n = self.pad_batch(reads, refs)
        t0 = time.perf_counter()
        dev = self.device
        xs_d = torch.from_numpy(xs).to(dev)
        ys_d = torch.from_numpy(ys).to(dev)
        if traceback:
            res = self.engine.score_batch_moves(xs_d, ys_d, m, n)
            pos, cx, cy, steps = walk_moves(
                res["moves"], xs_d.T.contiguous(), ys_d, res["i"], res["j"],
                max_steps=self.max_steps(xs.shape[1], ys.shape[1]),
            )
            arrays = (res["score"], res["i"], res["j"], pos, cx, cy, steps)
        else:
            res = self.engine.score_batch(xs_d, ys_d, m, n)
            arrays = (res["score"], res["i"], res["j"])
        return _PendingBatch(len(reads), traceback, t0, arrays)

    def collect(self, pending: "_PendingBatch") -> List[AlignResult]:
        """Wait for a pending batch: one host copy of every output, one
        synchronisation, then host string assembly."""
        fetched = to_host(pending.arrays)
        sweep_us = (time.perf_counter() - pending.t0) * 1e6
        if pending.traceback:
            score, ii, jj, pos, cx, cy, steps = fetched
            t1 = time.perf_counter()
            consensus = decode_consensus(cx, cy, steps)
            walk_us = (time.perf_counter() - t1) * 1e6
        else:
            score, ii, jj = fetched
            pos = consensus = None
            walk_us = 0.0
        return _assemble(
            pending.nreads, pending.traceback, score, ii, jj, pos, consensus,
            Timings(sweep_us=sweep_us, walk_us=walk_us),
        )


class _PendingBatch:
    """An in-flight batch: dispatched device tensors awaiting one fetch
    (copied from swaligner.py:299-310, without the synchronous variant)."""

    __slots__ = ("nreads", "traceback", "t0", "arrays")

    def __init__(self, nreads, traceback, t0, arrays):
        self.nreads = nreads
        self.traceback = traceback
        self.t0 = t0
        self.arrays = arrays


def _assemble(nreads, traceback, score, ii, jj, pos, consensus, t: Timings):
    """Copied from swaligner.py:313-329."""
    out = []
    for k in range(nreads):
        if traceback:
            cxk, cyk = consensus[k]
            pk = int(pos[k])
        else:
            cxk = cyk = ""
            pk = 0
        out.append(
            AlignResult(
                score=float(score[k]), pos=pk, consensus_x=cxk,
                consensus_y=cyk, max_i=int(ii[k]), max_j=int(jj[k]),
                timings=t,
            )
        )
    return out


def merge_strand_pairs(fwd: List[AlignResult], rev: List[AlignResult]) -> List[AlignResult]:
    """Pairwise merge of forward / reverse-complement results (copied from
    swaligner.py:332-344): the reverse result wins only on a strictly better
    score and is tagged strand='-'."""
    return [
        dataclasses.replace(r, strand="-") if r.score > f.score else f
        for f, r in zip(fwd, rev)
    ]


class SWAligner:
    """Single-pair aligner with the reference's query surface."""

    def __init__(self, cfg: ScoringConfig = ScoringConfig(), device=None):
        self._batch = BatchSWAligner(cfg, device=device)

    def align(self, read: str, ref: str, traceback: bool = True) -> AlignResult:
        return self._batch.align_batch([read], [ref], traceback=traceback)[0]
