"""Scoring and chunking configuration (copied from the JAX package's
``parallel_genomeseq_tpu/utils/config.py``; behaviour unchanged).

Scoring is declarative data: uniform match/mismatch scores (DNA read
mapping, the reference's ``a == b ? +3 : -3`` with gap 2.0) or a
substitution matrix over a finite alphabet (protein scoring, e.g. BLOSUM50
for the UNIPROT workload), with a linear gap penalty and an optional affine
opening surcharge.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class Semantics(enum.Enum):
    """DP value semantics.

    EXACT_INT32: exact integer DP values (no clamping), the default; equal
        to the reference's float-matrix semantics whenever the scoring
        parameters are integers.
    FLOAT32: exact float32 DP (for non-integer scoring parameters).
    SAT_UINT8: saturating uint8 DP, the reference's skewed AVX2 path:
        scores clamp to [0, 255] and mismatch/gap use saturating subtraction.
    """

    EXACT_INT32 = "int32"
    FLOAT32 = "float32"
    SAT_UINT8 = "sat_uint8"


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    """Declarative scoring: uniform match/mismatch or a substitution matrix.

    Defaults mirror the reference defaults (+3 match, -3 mismatch, gap 2.0).

    If ``matrix`` is provided it is a ``(len(alphabet), len(alphabet))`` array
    and ``alphabet`` maps characters to matrix rows; match/mismatch are
    ignored.
    """

    match: float = 3.0
    mismatch: float = -3.0
    gap_penalty: float = 2.0
    gap_open: float = 0.0
    matrix: Optional[np.ndarray] = None
    alphabet: Optional[str] = None
    semantics: Semantics = Semantics.EXACT_INT32

    def __post_init__(self):
        if (self.matrix is None) != (self.alphabet is None):
            raise ValueError("matrix and alphabet must be provided together")
        if self.matrix is not None:
            m = np.asarray(self.matrix)
            if m.shape != (len(self.alphabet), len(self.alphabet)):
                raise ValueError(
                    f"matrix shape {m.shape} != ({len(self.alphabet)},) ** 2"
                )
        if float(self.gap_open) < 0:
            raise ValueError("gap_open must be >= 0 (it is a penalty magnitude)")
        if self.gap_open and self.semantics == Semantics.SAT_UINT8:
            raise ValueError("affine gaps are not supported in SAT_UINT8 semantics")

    @property
    def is_uniform(self) -> bool:
        return self.matrix is None

    @property
    def is_affine(self) -> bool:
        """Affine (Gotoh) gap model: a gap of length L costs
        ``gap_open + L * gap_penalty``; gap_open=0 is the linear model."""
        return float(self.gap_open) != 0.0

    @property
    def is_integral(self) -> bool:
        vals = [self.gap_penalty, self.gap_open]
        if self.is_uniform:
            vals += [self.match, self.mismatch]
        else:
            vals += list(np.asarray(self.matrix).ravel())
        return all(float(v) == int(v) for v in vals)

    def score(self, a: str, b: str) -> float:
        """Scalar scoring function."""
        if self.is_uniform:
            return self.match if a == b else self.mismatch
        ia = self.alphabet.find(a)
        ib = self.alphabet.find(b)
        if ia < 0 or ib < 0:
            # Unknown characters score as the worst entry in the table, which
            # can never create an alignment through them.
            return float(np.min(self.matrix))
        return float(self.matrix[ia, ib])

    def byte_table(self) -> np.ndarray:
        """(256, 256) float32 score lookup over raw byte values (config.py:117)."""
        tab = np.full((256, 256), self.mismatch if self.is_uniform else float(np.min(self.matrix)), np.float32)
        if self.is_uniform:
            np.fill_diagonal(tab, self.match)
        else:
            idx = np.frombuffer(self.alphabet.encode("ascii"), np.uint8)
            tab[np.ix_(idx, idx)] = np.asarray(self.matrix, np.float32)
        return tab

    def dp_dtype(self):
        """The DP value type (config.py:127-132): uint8 under SAT_UINT8,
        float32 for FLOAT32 or non-integral scoring, else int32."""
        if self.semantics == Semantics.SAT_UINT8:
            return np.uint8
        if self.semantics == Semantics.FLOAT32 or not self.is_integral:
            return np.float32
        return np.int32


@dataclasses.dataclass(frozen=True)
class ChunkConfig:
    """Coarse-grained decomposition of the long sequence into overlapping
    windows (the reference's OMPParallelLocalAligner geometry)."""

    npiece: int = 1
    overlap_ratio: float = 2.0
