"""Hirschberg linear-space global alignment: the port of the JAX package's
``models/hirschberg.py`` (:29-115).

Divide and conquer: the optimal global path through (mid, k*) is found from
a forward NW last row over x[:mid] and a backward one over the reversed
second half, then the two subproblems recurse. Memory is O(n) whatever the
lengths. A subproblem of at least ``device_cells`` cells runs its two row
sweeps as one 2-lane K25 launch (``ops/global_dp.nw_lastrow_batch``: the
forward and the backward half), a smaller one on the host in numpy, as the
JAX function splits them: the top levels hold almost all the cells. The
base case of one read byte aligns with the numpy oracle (``nw_align``).

Linear gaps only, as in JAX: an affine config raises ``ValueError``, a
non-integral one ``NotImplementedError`` (``global_dp.check_config``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops import global_dp
from ..ops.oracle import _as_bytes, nw_align
from ..utils.config import ScoringConfig
from ..utils.device import resolve_device
from ..utils.result import AlignResult


def _nw_lastrow(xb: np.ndarray, yb: np.ndarray, tab, g: float) -> np.ndarray:
    """Last row of the NW matrix of xb vs yb, O(len(yb)) space
    (hirschberg.py:29)."""
    n = len(yb)
    j_idx = np.arange(n + 1)
    prev = -g * j_idx.astype(np.float64)  # row 0 boundary
    for i in range(1, len(xb) + 1):
        s = tab[xb[i - 1], yb]  # (n,)
        u = np.empty(n + 1)
        u[0] = -g * i  # west-boundary start of the prefix chain
        u[1:] = np.maximum(prev[:-1] + s, prev[1:] - g)
        v = u + g * j_idx
        prev = np.maximum.accumulate(v) - g * j_idx
    return prev


# Subproblems with at least this many DP cells run their row sweeps on the
# device (one 2-lane K25 launch for the forward and backward halves); smaller
# ones stay on the host, where a launch and its fetch would cost more than
# the sweep (hirschberg.py:49).
DEVICE_CELLS = 1 << 21


def hirschberg_align(x, y, cfg: ScoringConfig = ScoringConfig(),
                     device_cells: int = DEVICE_CELLS, device=None) -> AlignResult:
    """Linear-space global alignment; the score and alignment of the JAX
    ``hirschberg_align``. ``device_cells=0`` sends every subproblem to the
    device, a huge value keeps them all on the host; ``device`` as
    ``utils.device.resolve_device`` (default the CUDA card)."""
    global_dp.check_config(cfg)
    dev = resolve_device(device)
    xb, yb = _as_bytes(x), _as_bytes(y)
    tab = cfg.byte_table().astype(np.float64)
    g = float(cfg.gap_penalty)
    table = None  # the device's score table, made at the first launch

    def on_device(cells: int) -> bool:
        return cells >= max(device_cells, 1)

    def device_table():
        nonlocal table
        if table is None:
            table = global_dp.byte_table(cfg, dev)
        return table

    def lastrows(xs: np.ndarray, ys: np.ndarray, mid: int):
        if on_device(len(xs) * len(ys)):
            fwd, bwd = global_dp.nw_lastrow_batch(
                [xs[:mid], xs[mid:][::-1]], [ys, ys[::-1]], cfg, dev, device_table()
            )
            return np.asarray(fwd, np.float64), np.asarray(bwd, np.float64)[::-1]
        return (
            _nw_lastrow(xs[:mid], ys, tab, g),
            _nw_lastrow(xs[mid:][::-1], ys[::-1], tab, g)[::-1],
        )

    def rec(xs: np.ndarray, ys: np.ndarray) -> Tuple[str, str]:
        if len(xs) == 0:
            return "-" * len(ys), ys.tobytes().decode("ascii")
        if len(ys) == 0:
            return xs.tobytes().decode("ascii"), "-" * len(xs)
        if len(xs) == 1:
            r = nw_align(xs, ys, cfg)
            # oracle consensus is reversed (reference convention); restore
            return r.consensus_x[::-1], r.consensus_y[::-1]
        mid = len(xs) // 2
        fwd, bwd = lastrows(xs, ys, mid)
        k = int(np.argmax(fwd + bwd))  # the first maximum, as in JAX
        lx, ly = rec(xs[:mid], ys[:k])
        rx, ry = rec(xs[mid:], ys[k:])
        return lx + rx, ly + ry

    cx, cy = rec(xb, yb)
    if on_device(len(xb) * len(yb)):
        score = float(global_dp.nw_score_batch([xb], [yb], cfg, dev, device_table())[0])
    else:
        score = float(_nw_lastrow(xb, yb, tab, g)[-1])
    # Store reversed, matching the reference's push_back-order convention.
    return AlignResult(
        score=score, pos=1, consensus_x=cx[::-1], consensus_y=cy[::-1],
        max_i=len(xb), max_j=len(yb),
    )


def alignment_score(cx: str, cy: str, cfg: ScoringConfig) -> float:
    """Score of an explicit alignment (consensus strings, forward order;
    hirschberg.py:105)."""
    tab = cfg.byte_table().astype(np.float64)
    g = float(cfg.gap_penalty)
    s = 0.0
    for a, b in zip(cx, cy):
        if a == "-" or b == "-":
            s -= g
        else:
            s += tab[ord(a), ord(b)]
    return s
