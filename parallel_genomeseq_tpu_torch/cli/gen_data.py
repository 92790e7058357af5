"""gen_data: custom reference, read and database generation (the port of the
JAX package's ``cli/gen_data.py``, the reference's py/ompfg_data_prep.py
tool; the same subcommands, flags, defaults and output files):

    gen_ref        -- slice a source genome (or generate a random one) into a
                      custom reference FASTA (start 18,000,000, 30,000 bp)
    gen_reads      -- sample reads with ground-truth POS into a CSV and a txt
    gen_gt         -- SAM -> ground-truth CSV
    mpi_prep       -- FASTQ -> bare read lines for fixed-record IO
    uniprot        -- split uniprot_sprot.fasta per protein, or build one
                      line-per-protein database.fasta
    gen_protein_db -- a synthetic SwissProt-scale database

FASTA comes in through the port's own ``seqio.readers.read_fasta`` (the JAX
CLI reads it with its native library; both return the same string). A
host-only tool: it imports no kernel.

Usage:
    python -m parallel_genomeseq_tpu_torch.cli.gen_data gen_ref --ref-len 30000
    python -m parallel_genomeseq_tpu_torch.cli.gen_data gen_reads --n-reads 100
"""

from __future__ import annotations

import argparse
import os
import sys

from ..seqio.datagen import gen_protein_db, gen_reads_custom, gen_ref_custom
from ..seqio.readers import fastq_to_lines, gen_ground_truth, read_fasta
from ..seqio.uniprot import build_single_database, split_per_protein
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen_ref")
    g.add_argument("--source-fa", default=None, help="genome FASTA to slice (random if absent)")
    g.add_argument("--start-pos", type=int, default=18_000_000)
    g.add_argument("--ref-len", type=int, default=30_000)
    g.add_argument("--keep-n", action="store_true")
    g.add_argument("--out", default=str(common.REPO_DATA / "custom_ref_1.fa"))

    r = sub.add_parser("gen_reads")
    r.add_argument("--ref", default=str(common.REPO_DATA / "custom_ref_1.fa"))
    r.add_argument("--n-reads", type=int, default=100)
    r.add_argument("--read-len", type=int, default=10_000)
    r.add_argument("--seed", type=int, default=1)
    r.add_argument("--out-csv", default=str(common.REPO_DATA / "custom_reads_1.csv"))
    r.add_argument("--out-txt", default=str(common.REPO_DATA / "custom_reads_1.txt"))

    t = sub.add_parser("gen_gt")
    t.add_argument("--sam", default=str(common.REFERENCE_DATA / "data_small/output_tiny_30xCov.mod.sam"))
    t.add_argument("--out", default=str(common.REPO_DATA / "ground_truth.csv"))

    m = sub.add_parser("mpi_prep")
    m.add_argument("--fastq", default=str(common.REFERENCE_DATA / "data_small/output_tiny_30xCov1.fq"))
    m.add_argument("--out", default=str(common.REPO_DATA / "mpi_test_tiny.txt"))

    u = sub.add_parser("uniprot")
    u.add_argument("--sprot", required=True, help="uniprot_sprot.fasta")
    u.add_argument("--mode", choices=["split", "single"], default="single")
    u.add_argument("--out-dir", default=str(common.REPO_DATA / "uniprot"))

    s = sub.add_parser(
        "gen_protein_db",
        help="synthetic SwissProt-scale database (a stand-in for "
        "uniprot_sprot.fasta; the reference workload is 561,356 entries)",
    )
    s.add_argument("--n-entries", type=int, default=561_356)
    s.add_argument("--query", default=None,
                   help="query FASTA; mutated copies are planted for signal")
    s.add_argument("--max-len", type=int, default=2048)
    s.add_argument("--seed", type=int, default=7)
    s.add_argument("--out", default=str(common.REPO_DATA / "uniprot_syn" / "database.fasta"))

    args = p.parse_args(argv)
    os.makedirs(common.REPO_DATA, exist_ok=True)

    if args.cmd == "gen_ref":
        seq = gen_ref_custom(
            args.out, source_fa=args.source_fa, start_pos=args.start_pos,
            ref_len=args.ref_len, drop_n=not args.keep_n,
        )
        print(f"wrote {args.out} ({len(seq)} bp)")
    elif args.cmd == "gen_reads":
        ref = read_fasta(args.ref)
        pairs = gen_reads_custom(
            ref, args.out_csv, args.out_txt, n_reads=args.n_reads,
            read_len=args.read_len, seed=args.seed,
        )
        print(f"wrote {len(pairs)} reads -> {args.out_csv}, {args.out_txt}")
    elif args.cmd == "gen_gt":
        n = gen_ground_truth(args.sam, args.out)
        print(f"wrote {n} rows -> {args.out}")
    elif args.cmd == "mpi_prep":
        n = fastq_to_lines(args.fastq, args.out)
        print(f"wrote {n} reads -> {args.out}")
    elif args.cmd == "uniprot":
        os.makedirs(args.out_dir, exist_ok=True)
        if args.mode == "split":
            n = split_per_protein(args.sprot, args.out_dir)
        else:
            n = build_single_database(
                args.sprot, os.path.join(args.out_dir, "database.fasta"),
                os.path.join(args.out_dir, "stats.txt"),
            )
        print(f"prepared {n} proteins -> {args.out_dir}")
    elif args.cmd == "gen_protein_db":
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        q = read_fasta(args.query) if args.query else None
        n_planted = gen_protein_db(
            args.out, n_entries=args.n_entries, query=q, seed=args.seed,
            max_len=args.max_len,
            stats_path=os.path.join(os.path.dirname(args.out), "stats.txt"),
        )
        print(f"wrote {args.n_entries} synthetic proteins -> {args.out} "
              f"({n_planted} planted query mutants)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
