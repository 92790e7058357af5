"""Smith-Waterman aligner API, batch-first: the port of the JAX package's
``models/swaligner.py`` (:59-354).

Per batch: K2 (uniform scoring) or K5 (a substitution matrix), through
``CudaEngine.score_batch_moves``, computes score, argmax and move codes in
one pass for every read length up to 2,048, K3 (``walk_moves``) walks every
lane (``engine="plain"`` runs the plain versions of all three). A traceback
batch of longer reads takes the checkpointed strip traceback,
``score_batch_strip_moves`` (K12, then K13 and K14 a group of strips a
launch; under
affine gaps K16, then K17 and K18, the JAX package's
``score_batch_strip_affine_moves``; under a substitution matrix with linear
gaps K20, then K21 and K14, and with affine gaps K23, then K24 and K18), as
swaligner.py:175-192 does, its
per-strip times in ``Timings.levels_us`` (a group's on its first strip); a
score-only one takes K11 (K15, K19, K22).
Under affine gaps (``cfg.is_affine``) K7 or K9 emit the affine move bytes
and K10 (``walk_moves_affine``) walks them, as swaligner.py:241, 264 choose.
The reference-parity forms, a ``Semantics.SAT_UINT8`` config and/or
``tie="skewed"`` (``solve_small --parity-mode skewed``), score, take the
argmax and emit moves on K26 and walk on K3, score-only past 2,048 rows on
K27; the JAX aligner runs them on its scan engine (swaligner.py:89-92,
196-210), whose 2 GiB bound on the moves tensor is kept here, and moves
past 2,048 rows raise NotImplementedError (ROADMAP A2b).
The
JAX package's affine envelopes (``AFFINE_MOVES_MAX_M``,
``PROFILE_AFFINE_MOVES_MAX_M``) and the scan fallback they force are TPU
limits, not ported. ``collect``
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

from ..ops.engine import MAX_M, check_supported, make_score_engine
from ..ops.traceback import decode_consensus
from ..utils.config import ScoringConfig
from ..utils.device import to_host
from ..utils.encoding import X_PAD, Y_PAD, batch_pad, to_bytes
from ..utils.result import AlignResult, Timings


# Default batch padding: batch shapes are padded to multiples of these. They
# must equal the JAX package's defaults (swaligner.py:71-72, chunking.py:82-83),
# and a caller that passes others must pass the JAX caller's (solve_uniprot
# uses pad_m=128): the padded M and N set the walk's max_steps, and so where a
# long consensus is truncated, which the byte-identical CSVs depend on. The
# kernels bound their loops by the true lengths, so padding sets nothing else.
PAD_M = 8
PAD_N = 128


def round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


class BatchSWAligner:
    """Aligns batches of reads against per-lane reference windows."""

    def __init__(
        self,
        cfg: ScoringConfig = ScoringConfig(),
        pad_m: int = PAD_M,
        pad_n: int = PAD_N,
        tie: str = "colmajor",
        device=None,
        engine: str = "auto",
        detail_timing: bool = False,
    ):
        """``detail_timing=True`` (solve_batch's timing CSV) makes
        ``submit_batch`` synchronous, as swaligner.py:219-255 does: it
        fetches (score, i, j) with one synchronisation (``sweep_us``), then
        runs the walk, fetches its outputs and decodes them (``walk_us``).
        False keeps one fetch a batch for the pipelined path."""
        check_supported(cfg, tie)
        self.cfg = cfg
        self.pad_m = pad_m
        self.pad_n = pad_n
        self.detail_timing = detail_timing
        # One engine scores and emits moves under the tie, as the JAX
        # aligner's scorer is its scan engine for a skewed tie (:89-92).
        self.engine = make_score_engine(cfg, engine, device, tie=tie)
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
        M = round_up(max(1, int(m.max())), self.pad_m)
        N = round_up(max(1, int(n.max())), self.pad_n)
        return batch_pad(xb, M, X_PAD), batch_pad(yb, N, Y_PAD), m, n

    def max_steps(self, M: int, N: int) -> int:
        """Walk-length bound of swaligner.py:145-149: <= M diagonal/north
        moves plus at most score/gap west moves (score <= best cell score x
        M: the match score, or a matrix's maximum), capped by M + N + 1."""
        gapv = max(float(self.cfg.gap_penalty), 1e-9)
        if self.cfg.is_uniform:
            matchv = max(float(self.cfg.match), 1.0)
        else:
            matchv = float(np.asarray(self.cfg.matrix).max())
        return min(int(M + matchv * M / gapv) + 8, M + N + 1)

    def submit_batch(self, reads, refs, traceback: bool = True) -> "_PendingBatch":
        """Dispatch one batch without waiting for its results; pair with
        ``collect``. Under ``detail_timing`` the batch comes back already
        collected."""
        xs, ys, m, n = self.pad_batch(reads, refs)
        if traceback and self.engine.parity:
            # The JAX aligner's scan engine materialises (D, M, B) moves and
            # refuses past 2 GiB (swaligner.py:202-209); the same check first.
            M, N = xs.shape[1], ys.shape[1]
            est = (M + N) * M * len(reads)
            if est > 2 * 1024**3:
                raise ValueError(
                    f"traceback at this shape needs a ~{est/1e9:.1f} GB "
                    "move tensor (scan emit_moves); use a Pallas scorer "
                    "(checkpointed strip traceback), reduce the batch "
                    "size, or run with traceback=False"
                )
        t0 = time.perf_counter()
        dev = self.device
        xs_d = torch.from_numpy(xs).to(dev)
        ys_d = torch.from_numpy(ys).to(dev)
        levels_us = ()
        walk = None  # launches the walk (or reads the strip walk's outputs)
        max_steps = self.max_steps(xs.shape[1], ys.shape[1])
        if traceback and xs.shape[1] > MAX_M and not self.engine.parity:
            res = self.engine.score_batch_strip_moves(xs_d, ys_d, m, n, max_steps)
            levels_us = res["level_us"]
            walk = lambda: tuple(res[k] for k in ("pos", "cx", "cy", "steps"))
        elif traceback:
            res = self.engine.score_batch_moves(xs_d, ys_d, m, n)
            walk = lambda: self.engine.walk(
                res["moves"], xs_d.T.contiguous(), ys_d, res["i"], res["j"],
                max_steps=max_steps,
            )
        else:
            res = self.engine.score_batch(xs_d, ys_d, m, n)
        sweep = (res["score"], res["i"], res["j"])
        if not self.detail_timing:
            arrays = sweep + (tuple(walk()) if walk else ())
            return _PendingBatch(len(reads), traceback, t0, arrays, levels_us)
        score, ii, jj = to_host(sweep)
        sweep_us = (time.perf_counter() - t0) * 1e6
        pos = consensus = None
        walk_us = 0.0
        if walk:
            t1 = time.perf_counter()
            pos, cx, cy, steps = to_host(walk())
            consensus = decode_consensus(cx, cy, steps)
            walk_us = (time.perf_counter() - t1) * 1e6
        results = _assemble(
            len(reads), traceback, score, ii, jj, pos, consensus,
            Timings(sweep_us=sweep_us, walk_us=walk_us, levels_us=levels_us),
        )
        return _PendingBatch(len(reads), traceback, t0, results=results)

    def collect(self, pending: "_PendingBatch") -> List[AlignResult]:
        """Wait for a pending batch: one host copy of every output, one
        synchronisation, then host string assembly."""
        if pending.results is not None:
            return pending.results
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
            Timings(sweep_us=sweep_us, walk_us=walk_us, levels_us=pending.levels_us),
        )


class _PendingBatch:
    """An in-flight batch: dispatched device tensors awaiting one fetch and
    the strip traceback's per-strip times, or (``detail_timing``) results
    already collected (copied from swaligner.py:299-310)."""

    __slots__ = ("nreads", "traceback", "t0", "arrays", "levels_us", "results")

    def __init__(self, nreads, traceback, t0, arrays=None, levels_us=(), results=None):
        self.nreads = nreads
        self.traceback = traceback
        self.t0 = t0
        self.arrays = arrays
        self.levels_us = levels_us
        self.results = results


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

    def __init__(self, cfg: ScoringConfig = ScoringConfig(), tie: str = "colmajor",
                 device=None):
        self._batch = BatchSWAligner(cfg, tie=tie, device=device)

    def align(self, read: str, ref: str, traceback: bool = True) -> AlignResult:
        return self._batch.align_batch([read], [ref], traceback=traceback)[0]
