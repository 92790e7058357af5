"""Sequence file ingestion: FASTA and the ground-truth CSV (copied from the
JAX package's ``parallel_genomeseq_tpu/seqio/readers.py``; behaviour
unchanged). ``read_fasta`` is also what the JAX package's native reader
returns, so the port needs no native IO library.

- FASTA: skip header lines, concatenate the rest.
- ground-truth CSV: columns index,QNAME,SEQ,POS.
"""

from __future__ import annotations

import csv
from typing import Dict, List


def read_fasta(path) -> str:
    """Single-record FASTA -> one concatenated sequence string (all
    non-header lines joined, as the reference implementation reads it)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith(">"):
                out.append(line)
    return "".join(out)


def read_fasta_records(path) -> List[tuple]:
    """Multi-record FASTA -> list of (header, sequence)."""
    records = []
    header, seq = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if header is not None:
                    records.append((header, "".join(seq)))
                header, seq = line[1:], []
            elif line:
                seq.append(line)
    if header is not None:
        records.append((header, "".join(seq)))
    return records


def read_ground_truth(path) -> List[Dict[str, str]]:
    """index,QNAME,SEQ,POS rows as dicts (POS kept as string for round-trip)."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))
