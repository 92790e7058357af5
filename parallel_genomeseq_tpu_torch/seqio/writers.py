"""Alignment output CSV in the reference's schema (copied from the JAX
package's ``parallel_genomeseq_tpu/seqio/writers.py``; behaviour unchanged):
each ground-truth row gains ``pos_pred`` and ``score`` columns; and
``solve_batch``'s timing rows.
"""

from __future__ import annotations

import csv
from typing import Sequence

from ..utils.result import AlignResult


def _fmt_score(score: float) -> str:
    # The reference streams a float through operator<< -- integral scores
    # print without a decimal point.
    return str(int(score)) if float(score) == int(score) else repr(score)


def write_align_output(
    out_path,
    gt_rows: Sequence[dict],
    results: Sequence[AlignResult],
    fieldnames: Sequence[str] = ("index", "QNAME", "SEQ", "POS"),
):
    """Ground-truth rows + results -> align_output.csv."""
    if len(gt_rows) != len(results):
        raise ValueError("row/result count mismatch")
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(fieldnames) + ["pos_pred", "score"])
        for row, res in zip(gt_rows, results):
            w.writerow(
                [row[k] for k in fieldnames] + [res.pos, _fmt_score(res.score)]
            )


def append_timing_row(path, header: Sequence[str], row: Sequence):
    """Append one CSV row, writing the header if the file is new or empty
    (copied from writers.py:42-52, the reference's CSVWriter pattern)."""
    import os

    new = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(header)
        w.writerow(row)
