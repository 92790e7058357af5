"""UNIPROT database preparation and reading (copied from the JAX package's
``parallel_genomeseq_tpu/seqio/uniprot.py``; behaviour unchanged):

- split_per_protein: a multi-record FASTA -> one FASTA per protein and a
  stats.txt count;
- build_single_database: a one-line-per-protein database.fasta and
  stats.txt;
- iter_database: (name, sequence) pairs from either form.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Tuple

from .readers import read_fasta_records


def split_per_protein(sprot_fasta, out_dir) -> int:
    """Split a multi-record FASTA into <i>.fasta files + stats.txt count
    (uniprot.py:19-36)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    count = 0
    cur: List[str] = []
    with open(sprot_fasta) as f:
        for line in f:
            if line.startswith(">") and cur:
                (out / f"{count}.fasta").write_text("".join(cur))
                count += 1
                cur = []
            cur.append(line)
    if cur:
        (out / f"{count}.fasta").write_text("".join(cur))
        count += 1
    (out / "stats.txt").write_text(str(count))
    return count


def build_single_database(sprot_fasta, out_path, stats_path=None) -> int:
    """One sequence per line, headers dropped (uniprot.py:39-48), the
    database form that fixed-record sharding reads."""
    records = read_fasta_records(sprot_fasta)
    with open(out_path, "w") as f:
        for _, seq in records:
            f.write(seq + "\n")
    if stats_path:
        Path(stats_path).write_text(str(len(records)))
    return len(records)


def iter_database(path) -> Iterator[Tuple[str, str]]:
    """(name, sequence) pairs from a FASTA or line-per-protein database."""
    path = str(path)
    with open(path) as f:
        first = f.readline()
    if first.startswith(">"):
        for header, seq in read_fasta_records(path):
            name = header.split()[0] if header else ""
            yield name, seq
    else:
        with open(path) as f:
            for k, line in enumerate(f):
                seq = line.strip()
                if seq:
                    yield str(k), seq
