"""Resident protein database: pack once, scan many queries -- the port of the
JAX package's ``models/protein_db.py`` (:36-274).

The whole database is length-sorted, encoded to compact codes on the host
(``ops/scan_dp.profile_tables``), concatenated into one flat slab with a
64-bit offset per entry, and uploaded ONCE to the card. Each scan then
uploads only the query's codes and runs one K4 launch (K8 under affine gaps,
the default 10/2) over every entry (a group of 8-32 threads per entry, each
thread holding a band of the query's rows in registers; a group stops at
its entry's true length, so the TPU's per-batch padding, ``pad_mult``
rounding, overrun rows and dispatch groups have no counterpart), and
fetches the per-entry (score, pos_end) with one synchronisation. A query longer than 2,048 aa (a
database built with ``max_query_len`` past it) runs one launch of the strip
kernel K19 (K22 under affine gaps) over the same slab instead (one block
per entry), as the JAX package's ``score_db_slab_strips_jit`` does.

Not ported: the first-scan oracle gate (a guard against TPU miscompiles;
``chip_smoke.py`` holds K4, K8, K19 and K22 against their plain versions
instead).
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.engine import MAX_M, make_score_engine
from ..ops.substitution import blosum_config
from ..utils.device import to_host
from ..utils.encoding import to_bytes

# The reference writer's per-row schema (mpi_sw_solve_uniprot.cpp:151-186):
# one row per database entry, traceback columns empty unless walked.
UNIPROT_CSV_HEADER = ["name", "len", "score", "pos_end", "pos_pred",
                      "consensus_x", "consensus_y"]


def write_uniprot_csv(path, entries, scores, pos, tb_rows=None):
    """Write the UNIPROT all-rows result CSV (copied from protein_db.py:42-57)."""
    tb_rows = tb_rows or {}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(UNIPROT_CSV_HEADER)
        for k, (name, seq) in enumerate(entries):
            pp, cx, cy = tb_rows.get(k, ("", "", ""))
            w.writerow([name, len(seq), int(scores[k]), int(pos[k]),
                        pp, cx, cy])


def pack_slab(seqs: Sequence[np.ndarray], order: Sequence[int], encode_lut: np.ndarray):
    """Host-side pack: the entries ``seqs[k]`` for k in ``order`` (the scan
    order), encoded to compact codes and concatenated. Returns (slab (R,)
    uint8, offsets (L,) int64, lengths (L,) int32), lane l of the scan being
    ``slab[offsets[l] : offsets[l] + lengths[l]]``."""
    lens = np.array([len(seqs[k]) for k in order], np.int32)
    offs = np.zeros(len(order), np.int64)
    if len(order) > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    flat = np.concatenate([seqs[k] for k in order]) if len(order) else np.zeros(0, np.uint8)
    return encode_lut[flat], offs, lens


class ResidentProteinDB:
    """One resident database, many query scans.

    Entries are (name, sequence) pairs; scans return each entry's DP score
    and pos_end (1-based entry index of the DP maximum), or the top-K hits.
    ``engine`` is 'auto'/'cuda' (K4, or K8 when gap_open > 0, or for a
    query longer than 2,048 aa K19, or K22, on a CUDA device, the plain
    version on the CPU) or 'plain'; ``device`` defaults to the card.
    """

    def __init__(self, entries: List[Tuple[str, str]], matrix="blosum50",
                 gap_penalty=2.0, gap_open=10.0, max_query_len=None,
                 device=None, engine="auto"):
        self.max_query_len = max_query_len or MAX_M
        self.cfg = blosum_config(matrix, gap_penalty=gap_penalty, gap_open=gap_open)
        self.engine = make_score_engine(self.cfg, engine, device)
        self.device = self.engine.device
        self.entries = entries
        t0 = time.perf_counter()
        self._seqs = [to_bytes(e[1]) for e in entries]
        self.order = sorted(range(len(entries)), key=lambda k: len(self._seqs[k]))
        self.residues = int(sum(len(s) for s in self._seqs))
        slab, offs, lens = pack_slab(self._seqs, self.order, self.engine.encode_lut)
        self._slab = torch.from_numpy(slab).to(self.device)
        self._offs = torch.from_numpy(offs).to(self.device)
        self._lens = torch.from_numpy(lens).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prep_s = time.perf_counter() - t0  # encode, sort, pack, upload
        self.slab_mb = slab.nbytes / 1e6

    def encode_query(self, query: str) -> torch.Tensor:
        """A query's compact codes, on the database's device."""
        qb = to_bytes(query)
        if len(qb) > self.max_query_len:
            raise ValueError(
                f"query {len(qb)}aa exceeds this DB's max_query_len "
                f"{self.max_query_len}"
            )
        return torch.from_numpy(self.engine.encode_lut[qb]).to(self.device)

    def scan_lanes(self, query_codes: torch.Tensor):
        """One K4 (K8; K19 or K22 for a long query) launch over every entry, in
        scan order: (score, i, j) tensors on the device, not synchronised."""
        return self.engine.score_slab(query_codes, self._slab, self._offs, self._lens)

    def scan_scores(self, query: str):
        """Score every entry: returns (scores, pos_end) int32 arrays in
        ENTRY order, plus the scan wall time (query upload, launch, fetch)."""
        t0 = time.perf_counter()
        score, _, jj = self.scan_lanes(self.encode_query(query))
        score, jj = to_host([score, jj])
        scores = np.zeros(len(self.entries), np.int32)
        pos = np.zeros(len(self.entries), np.int32)
        scores[self.order] = score
        pos[self.order] = jj
        wall = time.perf_counter() - t0
        return scores, pos, wall

    def scan(self, query: str, top: int = 10):
        """Top-K hits for one query: [(name, entry_len, score, pos_end)],
        plus (wall_s, gcups)."""
        scores, pos, wall = self.scan_scores(query)
        cells = len(query) * self.residues
        ranked = np.argsort(-scores, kind="stable")[: max(top, 0)]
        hits = [
            (self.entries[k][0], len(self._seqs[k]), int(scores[k]),
             int(pos[k]))
            for k in ranked
        ]
        return hits, wall, cells / wall / 1e9 if wall else 0.0
