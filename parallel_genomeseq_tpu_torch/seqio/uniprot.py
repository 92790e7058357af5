"""UNIPROT database reading (``iter_database`` copied from the JAX package's
``parallel_genomeseq_tpu/seqio/uniprot.py``; behaviour unchanged)."""

from __future__ import annotations

from typing import Iterator, Tuple

from .readers import read_fasta_records


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
