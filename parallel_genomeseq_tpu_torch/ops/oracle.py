"""Numpy Needleman-Wunsch oracle (copied from the JAX package's
``parallel_genomeseq_tpu/ops/oracle.py``: ``_as_bytes`` :32, ``nw_matrix``
:199, ``nw_align`` :218; behaviour unchanged).

The textbook global-alignment DP and its greedy traceback: Hirschberg's
one-row base case (``models/hirschberg.py``) aligns with it, and it is the
trivially-correct yardstick of the NW row sweep (``ops/global_dp.py``).
"""

from __future__ import annotations

import numpy as np

from ..utils.config import ScoringConfig
from ..utils.encoding import to_bytes
from ..utils.result import AlignResult


def _as_bytes(seq) -> np.ndarray:
    if isinstance(seq, str):
        return to_bytes(seq)
    return np.asarray(seq, dtype=np.uint8)


def nw_matrix(x, y, cfg: ScoringConfig = ScoringConfig()) -> np.ndarray:
    """Needleman-Wunsch global-alignment DP matrix (no zero floor; gap-cost
    boundary). The SW/NW/Hirschberg method family shares one recurrence —
    global mode drops the max-with-zero and initializes the boundary to
    cumulative gap costs."""
    xb, yb = _as_bytes(x), _as_bytes(y)
    m, n = len(xb), len(yb)
    tab = cfg.byte_table().astype(np.float64)
    g = float(cfg.gap_penalty)
    H = np.zeros((m + 1, n + 1), np.float64)
    H[0, :] = -g * np.arange(n + 1)
    H[:, 0] = -g * np.arange(m + 1)
    for j in range(1, n + 1):
        for i in range(1, m + 1):
            s = tab[xb[i - 1], yb[j - 1]]
            H[i, j] = max(H[i - 1, j - 1] + s, H[i, j - 1] - g, H[i - 1, j] - g)
    return H


def nw_align(x, y, cfg: ScoringConfig = ScoringConfig()) -> AlignResult:
    """Global alignment: traceback from the (m, n) corner to (0, 0) with the
    same greedy NW >= W >= N preference as the local walk."""
    xb, yb = _as_bytes(x), _as_bytes(y)
    H = nw_matrix(x, y, cfg)
    g = float(cfg.gap_penalty)
    i, j = len(xb), len(yb)
    cx, cy = [], []
    tab = cfg.byte_table().astype(np.float64)
    while i > 0 or j > 0:
        if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + tab[xb[i - 1], yb[j - 1]]:
            cx.append(chr(xb[i - 1]))
            cy.append(chr(yb[j - 1]))
            i -= 1
            j -= 1
        elif j > 0 and H[i, j] == H[i, j - 1] - g:
            cx.append("-")
            cy.append(chr(yb[j - 1]))
            j -= 1
        else:
            cx.append(chr(xb[i - 1]))
            cy.append("-")
            i -= 1
    return AlignResult(
        score=float(H[len(xb), len(yb)]), pos=1,
        consensus_x="".join(cx), consensus_y="".join(cy),
        max_i=len(xb), max_j=len(yb),
    )
