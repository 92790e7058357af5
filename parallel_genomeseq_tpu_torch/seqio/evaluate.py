"""Position-parity evaluation (copied from the JAX package's
``parallel_genomeseq_tpu/seqio/evaluate.py``; behaviour unchanged): join the
alignment output with ground truth and count rows where pos_pred != POS.
Nonzero counts can be legitimate (greedy traceback and non-unique optima).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import List


@dataclass
class ParityReport:
    total: int
    diffs: int
    diff_rows: List[dict]

    @property
    def ok(self) -> bool:
        return self.diffs == 0

    def summary(self) -> str:
        if self.diffs == 0:
            return "No diffs"
        return (
            f"{self.diffs}/{self.total} alignments different from ground truth\n"
            "May be caused by cost function. There is often no unique correct solution."
        )


def check_parity(align_output_path) -> ParityReport:
    with open(align_output_path, newline="") as f:
        rows = list(csv.DictReader(f, skipinitialspace=True))
    diff_rows = [
        r for r in rows if int(r["pos_pred"]) != int(r["POS"])
    ]
    return ParityReport(total=len(rows), diffs=len(diff_rows), diff_rows=diff_rows)
