"""Sequence file ingestion: FASTA, FASTQ, SAM and the ground-truth CSV
(copied from the JAX package's ``parallel_genomeseq_tpu/seqio/readers.py``;
behaviour unchanged). ``read_fasta`` is also what the JAX package's native
reader returns, so the port needs no native IO library.

- FASTA: skip header lines, concatenate the rest.
- FASTQ: 4-line records; the second line of each is the read.
- SAM: tab-separated fields QNAME..QUAL, '@' meta lines skipped.
- ground-truth CSV: columns index,QNAME,SEQ,POS.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List

SAM_FIELDS = (
    "QNAME", "FLAG", "RNAME", "POS", "MAPQ", "CIGAR",
    "RNEXT", "PNEXT", "TLEN", "SEQ", "QUAL",
)


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


def read_fastq(path) -> List[Dict[str, str]]:
    """FASTQ -> list of {'name', 'seq', 'qual'} dicts (readers.py:56-66)."""
    out = []
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f]
    lines = [l for l in lines if l != ""]
    for k in range(0, len(lines) - 3, 4):
        out.append({"name": lines[k][1:], "seq": lines[k + 1], "qual": lines[k + 3]})
    return out


@dataclasses.dataclass
class SamRecord:
    QNAME: str
    FLAG: str
    RNAME: str
    POS: int
    MAPQ: str
    CIGAR: str
    RNEXT: str
    PNEXT: str
    TLEN: str
    SEQ: str
    QUAL: str


def read_sam(path) -> List[SamRecord]:
    """SAM -> records, '@' meta lines and blank lines skipped
    (readers.py:84-103)."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("@"):
                continue
            vals = dict(zip(SAM_FIELDS, line.rstrip("\n").split("\t")))
            out.append(SamRecord(**{
                k: int(vals.get(k, 0)) if k == "POS" else vals.get(k, "") for k in SAM_FIELDS
            }))
    return out


def gen_ground_truth(sam_path, out_path) -> int:
    """SAM -> ground-truth CSV (index, QNAME, SEQ, POS; readers.py:112-121).
    Returns the row count."""
    records = read_sam(sam_path)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "QNAME", "SEQ", "POS"])
        for k, r in enumerate(records):
            w.writerow([k, r.QNAME, r.SEQ, r.POS])
    return len(records)


def fastq_to_lines(fq_path, out_path) -> int:
    """FASTQ -> bare read lines for fixed-record distributed IO
    (readers.py:124-131). Returns the read count."""
    reads = read_fastq(fq_path)
    with open(out_path, "w") as f:
        for r in reads:
            f.write(r["seq"] + "\n")
    return len(reads)
