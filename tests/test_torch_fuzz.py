"""Randomized differential campaign, on the CPU: the port's
``BatchSWAligner(device="cpu")`` (the plain PyTorch versions of the kernels)
against the JAX package's ``BatchSWAligner(score_engine="scan")``.

Each trial draws a random integral scoring config -- uniform or a random
symmetric substitution matrix (non-negative ones too), linear or affine --
and a ragged batch whose reads and references hold bytes outside the
alphabet, half of them with a mutated stretch of their reference planted,
and compares every AlignResult field with traceback. A few trials run by
default; PGS_TORCH_FUZZ_TRIALS sets the count and PGS_TORCH_FUZZ_SEED offsets
the trials' seeds (to shard a long campaign across processes).
"""

import os

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.models.swaligner import BatchSWAligner as JaxBatchAligner
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxScoringConfig
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TRIALS = int(os.environ.get("PGS_TORCH_FUZZ_TRIALS", 4))
SEED_OFFSET = int(os.environ.get("PGS_TORCH_FUZZ_SEED", 0))
MAX_M = 160  # the longest read
FIELDS = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")


def random_config(rng):
    """(scoring kwargs, alphabet): uniform or a random matrix, each linear or
    affine, integral."""
    affine = bool(rng.integers(0, 2))
    kw = dict(gap_penalty=float(rng.integers(1, 8)),
              gap_open=float(rng.integers(2, 12)) if affine else 0.0)
    if rng.integers(0, 2):
        return dict(match=float(rng.integers(1, 6)), mismatch=-float(rng.integers(1, 6)),
                    **kw), "ACGT"
    A = int(rng.integers(4, 24))
    alpha = "ARNDCQEGHILKMFPSTWYVBZX*"[:A]
    mat = rng.integers(-6, 13, size=(A, A))
    mat = (mat + mat.T) // 2
    np.fill_diagonal(mat, rng.integers(1, 13, size=A))
    if rng.integers(0, 4) == 0:  # a non-negative matrix now and then
        mat = np.abs(mat)
    return dict(matrix=mat.astype(np.float64), alphabet=alpha, **kw), alpha


def random_batch(rng, alpha: str):
    """A ragged batch: 1-12 lanes, reads of 1..MAX_M, references of
    1..2.2 x MAX_M, two bytes outside the alphabet among the letters."""
    letters = list(alpha + "#j")
    reads, refs = [], []
    for _ in range(int(rng.integers(1, 13))):
        m = int(rng.integers(1, MAX_M + 1))
        n = int(rng.integers(1, int(2.2 * MAX_M) + 2))
        x = "".join(rng.choice(letters, m))
        y = "".join(rng.choice(letters, n))
        if n > 24 and rng.integers(0, 2):
            s = int(rng.integers(0, n - 20))
            seg = list(y[s : s + min(m, 60)])
            for _ in range(int(rng.integers(0, 4))):
                seg[int(rng.integers(0, len(seg)))] = rng.choice(letters)
            x = ("".join(seg) + x)[:m]
        reads.append(x)
        refs.append(y)
    return reads, refs


@pytest.mark.parametrize("trial", range(TRIALS))
def test_fuzz_port_matches_jax_scan(trial):
    rng = np.random.default_rng(20_000 + trial + SEED_OFFSET)
    kw, alpha = random_config(rng)
    reads, refs = random_batch(rng, alpha)
    got = BatchSWAligner(ScoringConfig(**kw), device="cpu").align_batch(reads, refs)
    want = JaxBatchAligner(JaxScoringConfig(**kw), score_engine="scan").align_batch(reads, refs)
    assert len(got) == len(want) == len(reads)
    for k, (g, w) in enumerate(zip(got, want)):
        assert [getattr(g, f) for f in FIELDS] == [getattr(w, f) for f in FIELDS], \
            (trial, k, kw.get("alphabet"), kw["gap_open"])
