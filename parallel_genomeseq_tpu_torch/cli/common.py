"""Shared CLI plumbing (copied from the JAX package's
``parallel_genomeseq_tpu/cli/common.py``; the same flags and defaults, with
``--device`` in place of ``--platform``, and the reference data set looked
for under the checkout's ``data/reference`` unless PGS_REFERENCE_DATA names
it): argparse flags mapped onto the dataclass configs.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from ..utils.config import ChunkConfig, ScoringConfig, Semantics

REPO_DATA = Path(__file__).resolve().parents[2] / "data"
# The reference implementation's data set (data_small, the UNIPROT query),
# where the default input paths point; PGS_REFERENCE_DATA overrides it.
REFERENCE_DATA = Path(os.environ.get("PGS_REFERENCE_DATA", REPO_DATA / "reference"))


def add_scoring_flags(p: argparse.ArgumentParser):
    p.add_argument("--match", type=float, default=3.0, help="match score")
    p.add_argument("--mismatch", type=float, default=-3.0, help="mismatch score")
    p.add_argument("--gap-penalty", type=float, default=2.0, help="per-residue gap penalty")
    p.add_argument(
        "--gap-open", type=float, default=0.0,
        help="affine gap-opening surcharge (Gotoh): a gap of length L costs "
        "gap_open + L * gap_penalty; 0 = the reference's linear model",
    )
    p.add_argument(
        "--semantics", choices=[s.value for s in Semantics],
        default=Semantics.EXACT_INT32.value,
        help="DP value semantics (sat_uint8 matches the reference AVX2 path)",
    )
    p.add_argument(
        "--matrix", default="uniform",
        choices=["uniform", "blosum50", "blosum62"],
        help="substitution-matrix scoring; uniform uses --match/--mismatch",
    )


def add_chunk_flags(p: argparse.ArgumentParser, npiece_default: int):
    p.add_argument(
        "--npiece", type=int, default=npiece_default,
        help="overlapping reference windows (1 = unchunked full-matrix)",
    )
    p.add_argument(
        "--overlap-ratio", type=float, default=2.0,
        help="window overlap as a multiple of read length",
    )


def add_device_flags(p: argparse.ArgumentParser):
    p.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain PyTorch route)",
    )
    p.add_argument("--batch-size", type=int, default=128, help="reads per device batch")


def scoring_from_args(args) -> ScoringConfig:
    mname = getattr(args, "matrix", "uniform")
    if mname and mname != "uniform":
        if Semantics(args.semantics) != Semantics.EXACT_INT32:
            # Don't silently drop the user's semantics request: sat_uint8
            # is the uniform-scoring reference-parity mode only.
            raise SystemExit(
                "--matrix supports exact_int32 semantics only "
                "(--semantics sat_uint8 is the uniform-scoring AVX2 "
                "parity mode)"
            )
        from ..ops.substitution import blosum_config

        return blosum_config(
            mname, gap_penalty=args.gap_penalty,
            gap_open=getattr(args, "gap_open", 0.0),
        )
    return ScoringConfig(
        match=args.match, mismatch=args.mismatch, gap_penalty=args.gap_penalty,
        gap_open=getattr(args, "gap_open", 0.0),
        semantics=Semantics(args.semantics),
    )


def chunk_from_args(args) -> ChunkConfig:
    return ChunkConfig(npiece=args.npiece, overlap_ratio=args.overlap_ratio)


def batched(seq, size):
    for k in range(0, len(seq), size):
        yield seq[k : k + size]
