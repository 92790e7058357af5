"""solve_uniprot on PyTorch/CUDA: protein query vs a protein database (the
UNIPROT workload).

The port of the JAX package's ``cli/solve_uniprot.py``: same flags, the same
``uniprot_output.csv`` byte for byte (name,len,score,pos_end,pos_pred,
consensus_x,consensus_y in database order) and the same report lines, with
``--device`` in place of ``--platform`` (default: the CUDA card; ``--device
cpu`` runs the plain PyTorch route) and ``--engine auto|cuda|plain`` (``auto``
and ``cuda`` run the kernels; ``plain`` runs the plain version of every
kernel, scan and traceback, on the chosen device).

Main path (``--matrix blosum50|blosum62``): the database is packed once into
a resident slab on the card (``models/protein_db``), each query scores every
entry in one K4 launch, then the top-K entries (or every entry with
``--traceback-all``) are re-run with x = entry, y = query through
``BatchSWAligner`` (K5 then the K3 walk), so pos_pred is the position in the
QUERY where the greedy walk stops. ``--matrix uniform`` scores length-sorted
batches with K1 and walks with K2/K3. With ``--gap-open`` > 0 (affine gaps,
e.g. swps3's ``--gap-open 10 --gap-penalty 2``) the same steps run their
affine kernels: K8 for the scan, K9 and the K10 walk for the traceback, K6
and K7 under ``--matrix uniform``.

Long queries and entries (titin-class, over 2,048 aa): a query longer than
2,048 scans the same resident slab in one launch of the strip kernel K19,
and an entry longer than 2,048 is walked in strips (K20, then K21 and the
K14 walk, a group of strips a launch), as the JAX package does; with ``--gap-open`` the
affine profile strips take both (K22 for the scan; K23, then K24 and the
K18 walk); under ``--matrix uniform`` the strip kernels K11-K14 (K15-K18
with ``--gap-open``).

Not ported yet, and refused: ``--num-processes > 1`` (ROADMAP A13).

Usage:
    python -m parallel_genomeseq_tpu_torch.cli.solve_uniprot \\
        --query query.fasta --database database.fasta --matrix blosum50
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys
import time
from collections import deque
from typing import Dict, List

import numpy as np

from ..models.protein_db import ResidentProteinDB, write_uniprot_csv
from ..models.swaligner import BatchSWAligner, round_up
from ..ops.engine import make_score_engine
from ..ops.substitution import blosum_config
from ..seqio.readers import read_fasta
from ..seqio.uniprot import iter_database
from ..utils.config import ScoringConfig
from ..utils.device import to_host
from ..utils.encoding import Y_PAD, batch_pad, to_bytes
from . import common

MOVES_BUDGET = 3 * 2**29  # 1.5 GB of (D, M, B) uint8 moves per traceback batch
DEPTH = 3  # uniform batches dispatched ahead of the oldest fetch


@dataclasses.dataclass
class Run:
    """What one ``run`` did: its exit code, the database pack+upload seconds
    (0 off the resident path), and per query a dict of the scan seconds,
    the cells (query length x entry residues scored), the (score, pos_end)
    of every entry and the traceback rows {entry: (pos_pred, cx, cy)}."""

    rc: int
    prep_seconds: float
    scans: List[dict]


def _positive_int(v):
    iv = int(v)
    if iv < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return iv


def _parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--query", default=str(common.REFERENCE_DATA / "query/P02232.fasta"),
        help="query FASTA; a comma-separated list scans several queries "
        "against the same resident database",
    )
    p.add_argument("--database", required=True, help="FASTA or line-per-protein database")
    p.add_argument("--output", default=str(common.REPO_DATA / "uniprot_output.csv"))
    p.add_argument("--matrix", default="blosum50", choices=["blosum50", "blosum62", "uniform"])
    p.add_argument("--gap-penalty", type=float, default=12.0,
                   help="per-residue gap cost (the affine extend when --gap-open > 0)")
    p.add_argument("--gap-open", type=float, default=0.0,
                   help="affine opening surcharge: gap of length L costs "
                   "gap_open + L * gap_penalty (swps3's 12/2 affine default "
                   "is --gap-open 10 --gap-penalty 2)")
    p.add_argument("--top", type=int, default=10, help="print top-K hits")
    p.add_argument(
        "--traceback-top", type=int, default=-1, metavar="K",
        help="re-run the top-K hits with traceback (x=entry, y=query) for "
        "pos_pred and the consensus strings; default = --top, 0 disables",
    )
    p.add_argument("--traceback-all", action="store_true",
                   help="emit pos_pred/consensus for EVERY database row")
    p.add_argument("--limit", type=int, default=0, help="only first N proteins (0 = all)")
    p.add_argument("--engine", default="auto", choices=["auto", "cuda", "plain"])
    p.add_argument(
        "--checkpoint", default="",
        help="append per-protein results to this file "
        "(default <output>.ckpt when --resume is set)",
    )
    p.add_argument("--resume", action="store_true",
                   help="skip proteins already present in the checkpoint file")
    p.add_argument(
        "--pad-mult", type=_positive_int, default=128,
        help="round each uniform batch's padded length up to this multiple",
    )
    p.add_argument("--num-processes", type=int, default=1,
                   help="shard the database across N processes (not ported yet: ROADMAP A13)")
    p.add_argument("--process-id", type=int, default=0)
    common.add_device_flags(p)
    return p


def tb_chunks(tb_idx, entries, B: int, Nq: int):
    """Traceback batches, as solve_uniprot.py:419-451: lanes per batch capped
    by min(B, 1024) and by the moves budget for the batch's longest entry,
    the budget-bound tail rounded to a coarse granule."""
    TB_B = min(B, 1024)
    chunks = []
    s0 = 0
    while s0 < len(tb_idx):
        take = min(TB_B, len(tb_idx) - s0)
        while take > 1:
            Mb = round_up(max(len(entries[k][1]) for k in tb_idx[s0 : s0 + take]), 128)
            if (Mb + Nq) * Mb * take <= MOVES_BUDGET:
                break
            take = max(1, min(take - 1, MOVES_BUDGET // ((Mb + Nq) * Mb)))
            granule = 128 if take >= 128 else 32 if take >= 32 else 1
            take = max(1, take - take % granule)
        chunks.append(tb_idx[s0 : s0 + take])
        s0 += take
    return chunks


def _scan_uniform(engine, qb, entries, order, B: int, pad_mult: int, on_batch):
    """Length-sorted batches of K1 (x = query, y = entries) with up to DEPTH
    batches in flight; ``on_batch(idxs, score, pos_end)`` per batch, in
    order. Returns the cells scored."""
    pend = deque()
    cells = 0

    def collect():
        idxs, arrays = pend.popleft()
        on_batch(idxs, *to_host(arrays))

    for s in range(0, len(order), B):
        idxs = order[s : s + B]
        seqs = [to_bytes(entries[k][1]) for k in idxs]
        n = np.array([len(v) for v in seqs], np.int32)
        ys = batch_pad(seqs, round_up(int(n.max()), pad_mult), Y_PAD)
        xs = np.broadcast_to(qb[None, :], (len(idxs), len(qb))).copy()
        m = np.full(len(idxs), len(qb), np.int32)
        res = engine.score_batch(xs, ys, m, n)
        pend.append((idxs, (res["score"], res["j"])))
        cells += len(qb) * int(n.sum())
        if len(pend) > DEPTH:
            collect()
    while pend:
        collect()
    return cells


def run(argv=None) -> Run:
    """Parse ``argv``, scan, walk the hits, write the CSV(s) and print the
    report."""
    p = _parser()
    args = p.parse_args(argv)
    if args.num_processes > 1:
        p.error("--num-processes is not ported yet (ROADMAP A13)")

    qpaths = [q.strip() for q in args.query.split(",") if q.strip()]
    queries = [(os.path.splitext(os.path.basename(qp))[0], read_fasta(qp))
               for qp in qpaths]
    multi_q = len(queries) > 1
    if multi_q and (args.checkpoint or args.resume):
        p.error("--checkpoint/--resume require a single --query "
                "(checkpoint rows are keyed by protein name only)")
    longest = max(len(to_bytes(q)) for _, q in queries)
    query = queries[0][1]
    entries = list(iter_database(args.database))
    if args.limit:
        entries = entries[: args.limit]
    qdesc = f"{len(queries)} queries" if multi_q else f"query {len(query)}aa"
    print(f"solve_uniprot: {qdesc} vs {len(entries)} proteins"
          + (f" (query {len(query)}aa first)" if multi_q else ""))

    if args.matrix == "uniform":
        cfg = ScoringConfig(gap_penalty=args.gap_penalty, gap_open=args.gap_open)
        engine = make_score_engine(cfg, args.engine, args.device)
    else:
        cfg = blosum_config(args.matrix, gap_penalty=args.gap_penalty, gap_open=args.gap_open)
    B = args.batch_size
    order = sorted(range(len(entries)), key=lambda k: len(entries[k][1]))
    results: List = [None] * len(entries)

    # Checkpoint/resume: results are appended keyed by protein name.
    ckpt_path = args.checkpoint or (f"{args.output}.ckpt" if args.resume else "")
    ckpt_f = None
    if ckpt_path:
        if args.resume and os.path.exists(ckpt_path):
            by_name = {e[0]: k for k, e in enumerate(entries)}
            nres = 0
            with open(ckpt_path, newline="") as f:
                for row in csv.reader(f):
                    if len(row) == 3 and row[0] in by_name:
                        results[by_name[row[0]]] = (int(row[1]), int(row[2]))
                        nres += 1
            order = [k for k in order if results[k] is None]
            print(f"resume: {nres} proteins restored from {ckpt_path}, "
                  f"{len(order)} to go")
        os.makedirs(os.path.dirname(ckpt_path) or ".", exist_ok=True)
        ckpt_f = open(ckpt_path, "a", newline="")

    try:
        db = None
        prep = 0.0
        if args.matrix != "uniform" and order:
            # One resident slab of the entries still to score, packed and
            # uploaded once for every query; its scan order is `order`.
            db = ResidentProteinDB(
                [entries[k] for k in order], matrix=args.matrix,
                gap_penalty=args.gap_penalty, gap_open=args.gap_open,
                max_query_len=longest, device=args.device, engine=args.engine,
            )
            prep = db.prep_s
            print(f"resident DB: {db.slab_mb:.1f} MB slab ({len(order)} entries, "
                  f"one launch per query) packed+uploaded in {prep:.2f}s")
        scans = []
        grand_cells, grand_t = 0, 0.0
        for qi, (qname, qpro) in enumerate(queries):
            qb = to_bytes(qpro)
            out_path = args.output if not multi_q else f"{args.output}.{qname}"
            if qi > 0:
                results = [None] * len(entries)
                print(f"query {qi + 1}/{len(queries)}: {qname} ({len(qb)}aa)")
            done = [0]

            def on_batch(idxs, score, jj):
                for k, sc, j in zip(idxs, score.tolist(), jj.tolist()):
                    results[k] = (sc, j)
                if ckpt_f is not None:
                    w = csv.writer(ckpt_f)
                    for k in idxs:
                        w.writerow([entries[k][0], results[k][0], results[k][1]])
                    ckpt_f.flush()
                first = done[0] == 0
                done[0] += len(idxs)
                if first or done[0] % (B * 8) == 0 or done[0] == len(order):
                    print(f"progress: {done[0]}/{len(order)}")

            t_start = time.perf_counter()
            if db is not None:
                score, _, jj = db.scan_lanes(db.encode_query(qpro))
                on_batch(order, *to_host([score, jj]))
                cells = len(qb) * db.residues
            elif order:
                cells = _scan_uniform(engine, qb, entries, order, B, args.pad_mult, on_batch)
            else:
                cells = 0
            t_total = time.perf_counter() - t_start if order else 0.0

            ranked = sorted(range(len(entries)), key=lambda k: -results[k][0])
            tb_rows = _traceback(args, cfg, entries, results, ranked, qpro)
            write_uniprot_csv(
                out_path, entries, [r[0] for r in results],
                [r[1] for r in results], tb_rows,
            )
            gcups = cells / t_total / 1e9 if t_total else 0.0
            grand_cells += cells
            grand_t += t_total
            print(f"Scored {cells/1e9:.3f} Gcells in {t_total:.3f}s: {gcups:.2f} GCUPS"
                  + (f" [{qname}]" if multi_q else ""))
            print("top hits:")
            for k in ranked[: args.top]:
                name, seq = entries[k]
                extra = f"  pos_pred={tb_rows[k][0]}" if k in tb_rows else ""
                print(f"  {name}  len={len(seq)}  score={results[k][0]}  "
                      f"pos_end={results[k][1]}{extra}")
            print(f"Done, output file see: {out_path}")
            scans.append({"query": qname, "seconds": t_total, "cells": cells,
                          "results": results, "tb_rows": tb_rows})
    finally:
        if ckpt_f is not None:
            ckpt_f.close()

    if multi_q and grand_t:
        print(f"All queries: {grand_cells/1e9:.3f} Gcells in "
              f"{grand_t:.3f}s: {grand_cells/grand_t/1e9:.2f} GCUPS "
              f"({len(queries)} queries, one shared resident DB)")
    return Run(0, prep, scans)


def _traceback(args, cfg, entries, results, ranked, query) -> Dict[int, tuple]:
    """Re-run the top-K entries of ``ranked`` (every entry with
    --traceback-all) with x = entry, y = query and the JAX caller's
    pad_m=128, and check each re-run score against the scan's. Returns
    {entry: (pos, cx, cy)}."""
    tb_top = args.top if args.traceback_top < 0 else args.traceback_top
    if args.traceback_all and entries:
        tb_idx = sorted(range(len(entries)), key=lambda k: len(entries[k][1]))
    elif tb_top > 0 and entries:
        tb_idx = ranked[:tb_top]
    else:
        return {}
    bat = BatchSWAligner(cfg, pad_m=128, device=args.device, engine=args.engine)
    chunks = tb_chunks(tb_idx, entries, args.batch_size, round_up(len(to_bytes(query)), 128))
    batches = ([entries[k][1] for k in chunk] for chunk in chunks)
    tb_rows = {}
    for ci, (chunk, res_tb) in enumerate(zip(chunks, bat.align_stream(batches, [query]))):
        for k, r in zip(chunk, res_tb):
            if int(r.score) != results[k][0]:
                raise RuntimeError(
                    f"traceback rescore mismatch on {entries[k][0]}: "
                    f"{int(r.score)} != {results[k][0]}"
                )
            tb_rows[k] = (r.pos, r.consensus_x, r.consensus_y)
        if (ci + 1) % 32 == 0 or ci + 1 == len(chunks):
            print(f"traceback: {len(tb_rows)}/{len(tb_idx)}", flush=True)
    return tb_rows


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
