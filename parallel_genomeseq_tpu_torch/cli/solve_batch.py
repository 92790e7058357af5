"""solve_batch on PyTorch/CUDA: the many-read timing CLI (the reference's
fine-grain OMP benchmark, src/omp_sw_solve_small.cpp): aligns the first
n_reads reads against the whole reference and appends one CSV row of mean
timings.

The port of the JAX package's ``cli/solve_batch.py``: the same positional
``n_reads``, flags, CSV schema (n_reads, n_lanes, engine, avg_t_calcscore,
avg_t_sweep, avg_t_walk; the means in microseconds a read) and summary
lines, with ``--device`` in place of ``--platform`` and ``--engine
auto|cuda|plain`` (as ``solve_uniprot``'s) in place of ``auto|pallas|scan``;
the ``engine`` column records the value given. ``avg_t_calcscore`` is the
whole ``align_batch`` call, ``avg_t_sweep`` the score pass up to its
synchronised fetch (K1, or with ``--traceback`` K2; K6/K7 under
``--gap-open``; K4/K5, K8/K9 under ``--matrix``), ``avg_t_walk`` the walk
(K3, K10), its fetch and the host decode, 0 without ``--traceback``. One
warm-up batch runs first, untimed.

Usage:
    python -m parallel_genomeseq_tpu_torch.cli.solve_batch 5120 --traceback \\
        --batch-size 512 --timing-file data/timings.csv
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..models.swaligner import BatchSWAligner
from ..seqio.readers import read_fasta, read_ground_truth
from ..seqio.writers import append_timing_row
from . import common

TIMING_HEADER = ["n_reads", "n_lanes", "engine", "avg_t_calcscore", "avg_t_sweep",
                 "avg_t_walk"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("n_reads", type=int, nargs="?", default=10)
    p.add_argument("--engine", default="auto", choices=["auto", "cuda", "plain"])
    p.add_argument("--timing-file", default=str(common.REPO_DATA / "timing_batch.csv"))
    p.add_argument("--ref", default=str(common.REFERENCE_DATA / "data_small/genome.chr22.5K.fa"))
    p.add_argument("--reads", default=str(common.REFERENCE_DATA / "data_small_ground_truth.csv"))
    p.add_argument("--traceback", action="store_true", help="include traceback in the timed path")
    common.add_scoring_flags(p)
    common.add_device_flags(p)
    args = p.parse_args(argv)

    ref = read_fasta(args.ref)
    reads = [r["SEQ"] for r in read_ground_truth(args.reads)[: args.n_reads]]
    aligner = BatchSWAligner(common.scoring_from_args(args), device=args.device,
                             engine=args.engine, detail_timing=True)

    aligner.align_batch(reads[: args.batch_size], [ref], traceback=args.traceback)  # warm-up

    t_calc = t_sweep = t_walk = 0.0
    t0_all = time.perf_counter()
    for batch in common.batched(reads, args.batch_size):
        t0 = time.perf_counter()
        results = aligner.align_batch(batch, [ref], traceback=args.traceback)
        t_calc += time.perf_counter() - t0
        t_sweep += results[0].timings.sweep_us / 1e6
        t_walk += results[0].timings.walk_us / 1e6
    total = time.perf_counter() - t0_all

    n = len(reads)
    avg_calc, avg_sweep, avg_walk = (t / n * 1e6 for t in (t_calc, t_sweep, t_walk))
    os.makedirs(os.path.dirname(args.timing_file) or ".", exist_ok=True)
    append_timing_row(
        args.timing_file, TIMING_HEADER,
        [n, args.batch_size, args.engine, f"{avg_calc:.1f}", f"{avg_sweep:.1f}",
         f"{avg_walk:.1f}"],
    )
    cells = sum(len(r) for r in reads) * len(ref)
    print(
        f"solve_batch: {n} reads, engine {args.engine}, "
        f"avg calc {avg_calc:.0f} us/read, sweep {avg_sweep:.0f} us/read, "
        f"walk {avg_walk:.0f} us/read, "
        f"{cells/total/1e9:.2f} GCUPS end-to-end on {aligner.device}"
    )
    print(f"timing row appended to {args.timing_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
