"""Seeded stand-in for the data_small workload: a random reference FASTA and
a ground-truth CSV (``index,QNAME,SEQ,POS``) of reads sampled from it and
mutated with substitutions and small indels.

The reference comes from the JAX package's jax-free
``seqio.datagen.gen_ref_custom``; its ``gen_reads_custom`` samples exact
substrings only, so the mutation step lives here. Used by the port's tests
and by ``chip_smoke.py``.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Tuple

import numpy as np

from parallel_genomeseq_tpu.seqio.datagen import gen_ref_custom
from parallel_genomeseq_tpu.utils.encoding import to_bytes

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def write_dataset(
    out_dir,
    ref_len: int = 4980,
    n_reads: int = 1170,
    read_len: Tuple[int, int] = (125, 125),
    seed: int = 0,
    sub_rate: float = 0.01,
    indel_rate: float = 0.5,
) -> Tuple[Path, Path]:
    """Write ``ref.fa`` and ``reads.csv`` into ``out_dir``; returns both paths.

    Each read has a length drawn from ``read_len`` (inclusive), starts at a
    uniform reference offset (1-based POS), has each base substituted with
    probability ``sub_rate``, and with probability ``indel_rate`` carries
    one 1-3 bp insertion or deletion at least 10 bp from either end.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ref_path = out_dir / "ref.fa"
    csv_path = out_dir / "reads.csv"
    ref = to_bytes(gen_ref_custom(ref_path, ref_len=ref_len, seed=seed))
    rng = np.random.default_rng(seed + 1)
    lo, hi = read_len
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "QNAME", "SEQ", "POS"])
        for k in range(n_reads):
            length = int(rng.integers(lo, hi + 1))
            start = int(rng.integers(0, len(ref) - length - 3 + 1))
            seg = ref[start : start + length + 3].copy()
            subs = rng.random(seg.shape[0]) < sub_rate
            seg[subs] = rng.choice(_ACGT, int(subs.sum()))
            if rng.random() < indel_rate:
                size = int(rng.integers(1, 4))
                at = int(rng.integers(10, length - 10))
                if rng.random() < 0.5:
                    seg = np.concatenate([seg[:at], rng.choice(_ACGT, size), seg[at:]])
                else:
                    seg = np.concatenate([seg[:at], seg[at + size :]])
            w.writerow([k, f"synth-{k}", seg[:length].tobytes().decode(), start + 1])
    return ref_path, csv_path
