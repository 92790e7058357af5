"""Seeded synthetic data (copied from the JAX package's
``parallel_genomeseq_tpu/seqio/datagen.py``; behaviour and bytes unchanged
for the same seed):

- gen_ref_custom: a random reference FASTA, or a slice of a source genome;
- gen_reads_custom: reads sampled as exact substrings of a reference, with
  their 1-based positions, to a CSV and optionally a reads-only text file
  (datagen.py:45-70);
- gen_protein_db: a SwissProt-scale protein database, optionally with
  mutated copies of a query planted at known indices.
"""

from __future__ import annotations

import csv
from typing import Optional

import numpy as np

from .readers import read_fasta


def gen_ref_custom(
    out_fa,
    source_fa: Optional[str] = None,
    start_pos: int = 18_000_000,
    ref_len: int = 30_000,
    drop_n: bool = True,
    seed: int = 0,
) -> str:
    """Write a single-line reference FASTA; returns the sequence."""
    if source_fa:
        genome = read_fasta(source_fa).upper()
        seq = genome[start_pos : start_pos + ref_len]
        if drop_n:
            seq = seq.replace("N", "")
    else:
        rng = np.random.default_rng(seed)
        seq = "".join(rng.choice(list("ACGT"), size=ref_len))
    with open(out_fa, "w") as f:
        f.write(">custom_ref\n")
        f.write(seq + "\n")
    return seq


def gen_reads_custom(
    ref_seq: str,
    out_csv,
    out_txt=None,
    n_reads: int = 100,
    read_len: int = 10_000,
    seed: int = 1,
):
    """Sample reads with 1-based ground-truth POS to a CSV (index, QNAME,
    SEQ, POS), and with ``out_txt`` the reads alone, one a line; returns a
    list of (seq, pos)."""
    rng = np.random.default_rng(seed)
    if read_len > len(ref_seq):
        raise ValueError("read_len > reference length")
    out = []
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "QNAME", "SEQ", "POS"])
        for k in range(n_reads):
            start = int(rng.integers(0, len(ref_seq) - read_len + 1))
            seq = ref_seq[start : start + read_len]
            w.writerow([k, f"custom-{k}", seq, start + 1])
            out.append((seq, start + 1))
    if out_txt:
        with open(out_txt, "w") as f:
            for seq, _ in out:
                f.write(seq + "\n")
    return out


def gen_protein_db(
    out_path,
    n_entries: int = 561_356,
    query: Optional[str] = None,
    seed: int = 7,
    min_len: int = 60,
    max_len: int = 2048,
    stats_path=None,
) -> int:
    """Synthetic SwissProt-scale protein database (one FASTA record per
    entry, ``iter_database``-compatible). Defaults to the reference
    workload's entry count (561,356). Lengths follow a lognormal fit of
    SwissProt (median ~290 aa), clipped to [min_len, max_len]. When
    ``query`` is given, a mutated copy of it is planted at every index with
    ``k % max(1, n_entries // 8) == 3`` (8 or 9 copies once n_entries >=
    12). Returns the number planted."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    lens = np.clip(
        rng.lognormal(mean=np.log(290.0), sigma=0.65, size=n_entries),
        min_len, max_len,
    ).astype(np.int64)
    planted = []
    with open(out_path, "w") as f:
        for k in range(n_entries):
            if query and k % max(1, n_entries // 8) == 3:
                qb = np.frombuffer(query.encode(), np.uint8).copy()
                nmut = int(rng.integers(0, max(2, len(qb) // 20)))
                for _ in range(nmut):
                    qb[int(rng.integers(0, len(qb)))] = int(rng.choice(alpha))
                seq = qb.tobytes().decode()
                planted.append(k)
            else:
                seq = rng.choice(alpha, size=int(lens[k])).tobytes().decode()
            f.write(f">SYN{k:07d}\n{seq}\n")
    if stats_path:
        with open(stats_path, "w") as f:
            f.write(f"{n_entries}\n")
    return len(planted)
