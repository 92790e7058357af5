"""solve_big on PyTorch/CUDA: the GCUPS workload -- long reads against a
long reference.

The port of the JAX package's ``cli/solve_big.py``: n_reads long reads
(default 10,000 bp) against a custom reference (default 30,000 bp) in
2 x npiece overlapping windows with overlap ratio 2.0, the best time of
``nrepeat`` repetitions per batch, GCUPS (reads x read length x reference
length over that time), and the reference's overlap-efficiency model
(npiece x rate / (ref + 2 (npiece - 1) overlap) x ref / npiece,
src/sw_solve_big.cpp:71-74). Reads past 2,048 bp run through the strip
kernels: K11 for the window sweep and, with ``--traceback``, K12, K13 and
K14 for the winners' checkpointed strip traceback; under affine gaps
(``--gap-open``; BWA-MEM's scoring is ``--match 1 --mismatch -4 --gap-open 6
--gap-penalty 1``) K15, then K16, K17 and K18.

Unlike the JAX CLI, the efficiency model's kernel rate defaults to this
run's own: the cells of every (read, window) lane, m x n summed, over the
fastest batch's time. ``--kernel-gcups`` sets it. ``--device`` replaces
``--platform`` (default: the CUDA card; ``cpu`` runs the plain PyTorch
route). ``--matrix blosum50|blosum62`` scores with a substitution matrix
through K19, and with ``--traceback`` K20, K21 and K14; with ``--gap-open``
(swps3's protein gaps are ``--gap-open 10 --gap-penalty 2``) through K22,
and K23, K24 and K18. ``--semantics sat_uint8`` runs the saturating uint8
values through K27; with ``--traceback`` it fails as the JAX CLI fails at
this shape (the scan's 2 GiB move tensor), and past that bound moves over
2,048 rows are not ported (ROADMAP A2b). ``--semantics float32`` is
refused, naming ROADMAP A2b.

Generates its data when --ref/--reads are absent (``data/custom_ref_1.fa``,
``data/custom_reads_1.csv``).

Usage:
    python -m parallel_genomeseq_tpu_torch.cli.solve_big [npiece] [nrepeat] [flags]
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys
import time
from typing import List

import numpy as np

from ..parallel.chunking import ChunkedAligner, make_string_ranges
from ..seqio.datagen import gen_reads_custom, gen_ref_custom
from ..seqio.readers import read_fasta
from ..utils.config import ChunkConfig, Semantics
from ..utils.result import AlignResult
from . import common


@dataclasses.dataclass
class Run:
    """What one ``run`` did: its exit code, the last repetition's results in
    read order, and per batch the best seconds, GCUPS, the swept (read,
    window) cells and the strip traceback's per-level microseconds (top
    strip first; empty without --traceback)."""

    rc: int
    results: List[AlignResult]
    seconds: List[float]
    gcups: List[float]
    swept_cells: List[int]
    levels_us: List[tuple]


def run(argv=None) -> Run:
    """Parse ``argv``, generate or read the data, align and print the
    report."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("npiece", type=int, nargs="?", default=7)
    p.add_argument("nrepeat", type=int, nargs="?", default=3)
    p.add_argument("--ref", default=None, help="custom ref FASTA (generated if absent)")
    p.add_argument("--reads", default=None, help="reads CSV (generated if absent)")
    p.add_argument("--ref-len", type=int, default=30_000)
    p.add_argument("--read-len", type=int, default=10_000)
    p.add_argument("--n-reads", type=int, default=100)
    p.add_argument("--overlap-ratio", type=float, default=2.0)
    p.add_argument(
        "--kernel-gcups", type=float, default=None,
        help="kernel GCUPS for the efficiency model (default: this run's "
        "swept-cell rate over the fastest batch)",
    )
    p.add_argument(
        "--traceback", action="store_true",
        help="include the winners' traceback in the timed path",
    )
    common.add_scoring_flags(p)
    common.add_device_flags(p)
    args = p.parse_args(argv)
    if Semantics(args.semantics) == Semantics.FLOAT32:
        p.error(f"--semantics {args.semantics} is not ported yet (ROADMAP A2b)")

    os.makedirs(common.REPO_DATA, exist_ok=True)
    if args.ref:
        ref = read_fasta(args.ref)
    else:
        ref = gen_ref_custom(common.REPO_DATA / "custom_ref_1.fa", ref_len=args.ref_len)
    if args.reads:
        with open(args.reads, newline="") as f:
            reads = [r["SEQ"] for r in csv.DictReader(f)]
    else:
        pairs = gen_reads_custom(
            ref, common.REPO_DATA / "custom_reads_1.csv",
            n_reads=args.n_reads, read_len=min(args.read_len, len(ref)),
        )
        reads = [s for s, _ in pairs]

    npiece = args.npiece * 2  # the reference doubles the CLI arg (sw_solve_big.cpp:78)
    print(
        f"solve_big: {len(reads)} reads x {len(reads[0])} bp vs {len(ref)} bp, "
        f"npiece {npiece}, overlap {args.overlap_ratio}"
    )
    aligner = ChunkedAligner(
        cfg=common.scoring_from_args(args),
        chunk=ChunkConfig(npiece=npiece, overlap_ratio=args.overlap_ratio),
        device=args.device,
    )
    read_len = len(reads[0])
    overlap = args.overlap_ratio * read_len
    est = read_len * (len(ref) + (npiece - 1) * overlap) * 4 / 1e9
    print(f"Estimated peak DP cells per read: {est:.2f} G (not materialized; "
          "wavefront carries only)")

    results, seconds, gcups, swept, levels = [], [], [], [], []
    for bk, batch in enumerate(common.batched(reads, args.batch_size)):
        best_t = float("inf")
        for _ in range(args.nrepeat):
            t0 = time.perf_counter()
            res = aligner.align_batch(batch, ref, traceback=args.traceback)
            best_t = min(best_t, time.perf_counter() - t0)
        results.extend(res)
        seconds.append(best_t)
        cells = sum(len(r) for r in batch) * len(ref)
        gcups.append(cells / best_t / 1e9)
        swept.append(sum(
            len(r) * (hi - lo)
            for r in batch
            for lo, hi in make_string_ranges(npiece, len(r), len(ref), args.overlap_ratio)
        ))
        levels.append(res[0].timings.levels_us if args.traceback else ())
        print(f"batch {bk}: {best_t * 1e3:.1f} ms (min of {args.nrepeat}) -> "
              f"{gcups[-1]:.2f} GCUPS on {aligner.engine.device}")
        if levels[-1]:
            # Per-strip replay+walk times, top strip first: the strip path's
            # analogue of the reference's per-anti-diagonal timings.
            lv_ms = " ".join(f"{v / 1e3:.1f}" for v in levels[-1])
            print(f"  traceback strip levels (ms, top first): {lv_ms}")

    g = np.array(gcups)
    print(f"GCUPS mean {g.mean():.2f} std {g.std():.2f} (useful cells / wall time, "
          f"batches of {args.batch_size})")
    if args.kernel_gcups:
        percore, origin = args.kernel_gcups, "--kernel-gcups"
    else:
        fastest = int(np.argmin(seconds))
        percore = swept[fastest] / seconds[fastest] / 1e9
        origin = "this run's swept (read, window) cells over the fastest batch's time"
    model = npiece * percore / (len(ref) + 2 * (npiece - 1) * overlap) * len(ref) / npiece
    print(f"Overlap-efficiency model at {percore:.1f} GCUPS kernel rate ({origin}): "
          f"{model:.1f} GCUPS")
    return Run(0, results, seconds, gcups, swept, levels)


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
