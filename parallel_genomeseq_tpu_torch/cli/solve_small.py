"""solve_small on PyTorch/CUDA: reads vs one reference, chunked into
--npiece overlapping windows (or unchunked with --npiece 1), written to
align_output.csv with appended pos_pred,score columns.

The port of the JAX package's ``cli/solve_small.py``: same flags and the
same output file, byte for byte, with ``--device`` in place of
``--platform`` (default: the CUDA card; ``--device cpu`` runs the plain
PyTorch route). ``--seed-extend`` and ``--parity-mode skewed`` are not
ported yet.

Usage:
    python -m parallel_genomeseq_tpu_torch.cli.solve_small [--npiece 17] [--eval]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
import time
from typing import List

from parallel_genomeseq_tpu.cli import common
from parallel_genomeseq_tpu.seqio.evaluate import check_parity
from parallel_genomeseq_tpu.seqio.native_io import read_fasta
from parallel_genomeseq_tpu.seqio.readers import read_ground_truth
from parallel_genomeseq_tpu.seqio.writers import write_align_output
from parallel_genomeseq_tpu.utils.encoding import revcomp
from parallel_genomeseq_tpu.utils.result import AlignResult

from ..models.swaligner import BatchSWAligner, merge_strand_pairs
from ..parallel.chunking import ChunkedAligner


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
        help="exact = true int32 scores (the only mode ported so far)",
    )
    p.add_argument("--seed-extend", action="store_true", help="not ported yet (ROADMAP A12)")
    p.add_argument(
        "--both-strands", action="store_true",
        help="also align the reverse complement of each read and keep the "
        "better score (forward wins ties)",
    )
    common.add_scoring_flags(p)
    common.add_chunk_flags(p, npiece_default=17)
    p.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain PyTorch route)",
    )
    p.add_argument("--batch-size", type=int, default=128, help="reads per device batch")
    args = p.parse_args(argv)

    if args.seed_extend:
        p.error("--seed-extend is not ported yet (ROADMAP A12)")
    if args.parity_mode == "skewed":
        p.error("--parity-mode skewed is not ported yet (ROADMAP A2)")
    if args.matrix != "uniform":
        p.error("--matrix is not ported yet (ROADMAP A8)")

    ref = read_fasta(args.ref)
    rows = read_ground_truth(args.input)
    if args.limit:
        rows = rows[: args.limit]
    reads = [r["SEQ"] for r in rows]
    print(f"solve_small: {len(reads)} reads vs {len(ref)}-bp reference")

    cfg = common.scoring_from_args(args)
    if args.npiece > 1:
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
    print(
        f"Aligned {len(results)} reads in {t_total:.3f}s "
        f"({cells/1e9:.3f} Gcells): {cells / t_total / 1e9:.3f} GCUPS "
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
