"""Alignment result and timing surfaces (copied from the JAX package's
``parallel_genomeseq_tpu/utils/result.py``; behaviour unchanged).

Mirrors the reference's LocalAligner query surface (getScore, getPos,
getConsensus_x, getConsensus_y, getTimings) as a plain dataclass.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Timings:
    """Microsecond timings: [0] the device pipeline (sweep and walk, synced
    at the batch's single fetch), [1] host consensus decode. 0 for levels a
    score-only call skips. ``levels_us`` holds per-strip-level times of the
    strip traceback, empty for single-strip calls."""

    sweep_us: float = 0.0
    walk_us: float = 0.0
    levels_us: tuple = ()

    def __getitem__(self, i: int) -> float:
        return (self.sweep_us, self.walk_us)[i]


@dataclasses.dataclass(frozen=True)
class AlignResult:
    """Result of one local alignment.

    pos is the 1-based position in the *reference* (sequence_y) where the
    traceback stopped. consensus_x / consensus_y are stored in reverse order
    with '-' for gaps, as the reference builds them during the walk.
    """

    score: float
    pos: int
    consensus_x: str = ""
    consensus_y: str = ""
    max_i: int = 0  # 1-based read index of the DP maximum
    max_j: int = 0  # 1-based reference index of the DP maximum
    strand: str = "+"  # "-" when the reverse complement aligned better
    timings: Timings = Timings()
