"""solve_small on PyTorch/CUDA: reads vs one reference, chunked into
--npiece overlapping windows (or unchunked with --npiece 1), written to
align_output.csv with appended pos_pred,score columns.

The port of the JAX package's ``cli/solve_small.py``: same flags and the
same output file, byte for byte, with ``--device`` in place of
``--platform`` (default: the CUDA card; ``--device cpu`` runs the plain
PyTorch route). ``--gap-open`` > 0 runs affine (Gotoh) gaps: a gap of
length L costs gap_open + L * gap_penalty (BWA-MEM's scoring is ``--match 1
--mismatch -4 --gap-open 6 --gap-penalty 1``), through the affine kernels
K6, K7 and K10. ``--matrix blosum50|blosum62`` scores from a substitution
table: the window sweep runs K4 per lane (the table route), the winners K5
and the K3 walk, or with ``--gap-open`` K8, K9 and K10. ``--seed-extend``
seeds every read with the FM index on the host and extends it only inside
its seeded reference window (``models/seed_extend.py``: K2 and K3, or K7
and K10, at the window's width; no window sweep), unseeded reads at full
width; it reports full-matrix-equivalent GCUPS. With ``--seed-extend``,
``--engine plain`` runs the plain PyTorch version of every kernel of that
path. ``--parity-mode skewed`` reproduces the reference binary's serial
AVX2 build, as the JAX CLI does: every read against the whole reference
(``--npiece`` is not used) under saturating uint8 values and the skewed
raw-layout tie-break, scored, argmaxed and with moves on K26 and walked on
K3. ``--semantics sat_uint8`` alone keeps the window sweep (K26 score-only,
then K26 with moves on the winners, and K3).

Usage:
    python -m parallel_genomeseq_tpu_torch.cli.solve_small [--npiece 17] [--eval]
        [--match 1 --mismatch -4 --gap-open 6 --gap-penalty 1]
        [--matrix blosum50 [--gap-open 10 --gap-penalty 2]] [--seed-extend]
        [--parity-mode skewed] [--semantics sat_uint8]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
import time
from typing import List

from ..models.seed_extend import SeedExtendAligner
from ..models.swaligner import BatchSWAligner, merge_strand_pairs
from ..parallel.chunking import ChunkedAligner
from ..seqio.evaluate import check_parity
from ..seqio.readers import read_fasta, read_ground_truth
from ..seqio.writers import write_align_output
from ..utils.config import Semantics
from ..utils.encoding import revcomp
from ..utils.result import AlignResult
from . import common


@dataclasses.dataclass
class Run:
    """What one ``run`` did: its exit code, the results in read order (as
    written to the CSV), and the CLI timer's seconds and full-reference
    cells."""

    rc: int
    results: List[AlignResult]
    seconds: float
    cells: int


def run(argv=None) -> Run:
    """Parse ``argv``, align, write the CSV and print the report."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ref", default=str(common.REFERENCE_DATA / "data_small/genome.chr22.5K.fa"))
    p.add_argument("--input", default=str(common.REFERENCE_DATA / "data_small_ground_truth.csv"))
    p.add_argument("--output", default=str(common.REPO_DATA / "align_output.csv"))
    p.add_argument("--limit", type=int, default=0, help="align only the first N reads (0 = all)")
    p.add_argument("--eval", action="store_true", help="run position-parity check after writing")
    p.add_argument(
        "--parity-mode", choices=["exact", "skewed"], default="exact",
        help="skewed = bit-parity with the reference's serial AVX2 build "
        "(saturating uint8 + raw-layout argmax tie-break); exact = true "
        "int32 scores (default, strictly better on ground-truth parity)",
    )
    p.add_argument(
        "--seed-extend", action="store_true",
        help="FM-index exact-seed the reads and extend only inside the "
        "seeded reference window (banded SW); unseeded reads fall back to "
        "full-width",
    )
    p.add_argument(
        "--both-strands", action="store_true",
        help="also align the reverse complement of each read and keep the "
        "better score (forward wins ties)",
    )
    common.add_scoring_flags(p)
    common.add_chunk_flags(p, npiece_default=17)
    common.add_device_flags(p)
    p.add_argument(
        "--engine", default="auto", choices=["auto", "cuda", "plain"],
        help="the --seed-extend path's engine: plain runs the plain PyTorch "
        "version of every kernel on the chosen device",
    )
    args = p.parse_args(argv)

    if args.seed_extend and args.parity_mode == "skewed":
        p.error("--seed-extend implies exact int32 scoring; drop --parity-mode skewed")
    if args.engine != "auto" and not args.seed_extend:
        p.error("--engine applies to --seed-extend only")

    ref = read_fasta(args.ref)
    rows = read_ground_truth(args.input)
    if args.limit:
        rows = rows[: args.limit]
    reads = [r["SEQ"] for r in rows]
    print(f"solve_small: {len(reads)} reads vs {len(ref)}-bp reference")

    cfg = common.scoring_from_args(args)
    if args.seed_extend:
        aligner = SeedExtendAligner(ref, aligner=BatchSWAligner(
            cfg, device=args.device, engine=args.engine))
        stream = lambda batches: aligner.align_stream(batches)
    elif args.parity_mode == "skewed":
        cfg = dataclasses.replace(cfg, semantics=Semantics.SAT_UINT8)
        aligner = BatchSWAligner(cfg, tie="skewed", device=args.device)
        stream = lambda batches: aligner.align_stream(batches, [ref])
    elif args.npiece > 1:
        aligner = ChunkedAligner(
            cfg=cfg, chunk=common.chunk_from_args(args), device=args.device
        )
        stream = lambda batches: aligner.align_stream(batches, ref)
    else:
        aligner = BatchSWAligner(cfg, device=args.device)
        stream = lambda batches: aligner.align_stream(batches, [ref])

    if args.both_strands:
        # Each batch doubles with the reads' reverse complements; the
        # pairwise merge keeps the better strand per read. tee keeps only
        # the batches between dispatch and collect alive.
        inner = stream

        def stream(batches):  # noqa: F811 -- intentional wrap
            b1, b2 = itertools.tee(list(b) for b in batches)
            doubled = (b + [revcomp(r) for r in b] for b in b1)
            for b, res in zip(b2, inner(doubled)):
                yield merge_strand_pairs(res[: len(b)], res[len(b) :])

    results = []
    cells = sum(len(r) for r in reads) * len(ref) * (2 if args.both_strands else 1)
    t0 = time.perf_counter()
    for bk, batch_results in enumerate(stream(common.batched(reads, args.batch_size))):
        results.extend(batch_results)
        done = len(results)
        if bk == 0 or done % (args.batch_size * 4) == 0 or done == len(reads):
            print(f"progress: {done}/{len(reads)}")
    t_total = time.perf_counter() - t0

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    write_align_output(args.output, rows, results)
    # Under --seed-extend the DP work done is far smaller than the full
    # matrix; the figure is matrix-equivalent throughput, as in JAX.
    label = "full-matrix-equivalent GCUPS" if args.seed_extend else "GCUPS"
    print(
        f"Aligned {len(results)} reads in {t_total:.3f}s "
        f"({cells/1e9:.3f} Gcells): {cells / t_total / 1e9:.3f} {label} "
        f"(incl. traceback+host IO) on {aligner.engine.device}"
    )
    print(f"Done, output file see: {args.output}")

    rc = 0
    if args.eval:
        report = check_parity(args.output)
        print(report.summary())
        rc = 0 if report.diffs < len(results) * 0.02 else 1
    return Run(rc, results, t_total, cells)


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
