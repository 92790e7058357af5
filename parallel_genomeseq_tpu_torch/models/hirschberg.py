"""Hirschberg linear-space global alignment: the port of the JAX package's
``models/hirschberg.py`` (:29-115).

Divide and conquer: the optimal global path through (mid, k*) is found from
a forward NW last row over x[:mid] and a backward one over the reversed
second half, then the two subproblems recurse. Memory is O(m + n) whatever
the lengths: a level's subproblems cut y into disjoint pieces, so its rows
and, on the card, K25's boundary rows (one row a lane) hold O(m + n) values.

The recursion runs breadth first, a level at a time, with JAX's split rule:
every subproblem of a level with len(xs) >= 2 and len(ys) >= 1 becomes two
lanes of one row sweep -- x[:mid] against ys, and the reversed x[mid:]
against the reversed ys -- read in place from the whole sequences by offset
and direction (``ops/global_dp.nw_lastrow_lanes``). Subproblems of at least
``device_cells`` cells go to one K25 launch a level, smaller ones to one
call of the plain version on the CPU, as JAX splits them between its device
scan and the host. The split k = the first argmax over j of fwd[j] + bwd[n
- j] is a segmented reduction where the rows lie; only the ks come back.
The one-byte leaves are resolved together, vectorized, exactly as the
oracle's ``nw_align`` walks them. The score is the top level's maximum of
fwd + bwd, which is H(m, n).

Linear gaps only, as in JAX: an affine config raises ``ValueError``, a
non-integral one ``NotImplementedError`` (``global_dp.check_config``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import global_dp
from ..ops.oracle import _as_bytes
from ..utils.config import ScoringConfig
from ..utils.device import resolve_device, to_host
from ..utils.result import AlignResult

# Subproblems with at least this many DP cells run their row sweeps on the
# card (their lanes in the level's one K25 launch); smaller ones on the CPU
# in the level's one plain call (hirschberg.py:49). On an H100 every
# subproblem is cheaper on the card: two ~10-kb reads took 0.15-0.20 s at 0,
# 0.20-0.44 s at 2^12, 0.27-0.55 s at 2^16 and 1.0-4.0 s at JAX's 2^21
# (tools/nw_shapes.py), the launch and its fetch being paid once a level.
DEVICE_CELLS = 0


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


def split_points(x, y, table, gap: int, xo, xl, yo, yl):
    """The split of each subproblem (x[xo : xo + xl] against y[yo : yo +
    yl], xl >= 2) by one row sweep of its two lanes: (k, best) on x's
    device, k the first j maximising fwd[j] + bwd[yl - j] and best that
    maximum. x, y are the whole sequences as flat uint8 tensors."""
    S = len(xo)
    mid = xl // 2
    lanes = global_dp.plan_lanes(
        np.stack([mid, xl - mid], 1), np.stack([yl, yl], 1),
        x_off=np.stack([xo, xo + mid], 1), y_off=np.stack([yo, yo], 1),
        x_rev=np.tile([False, True], S), y_rev=np.tile([False, True], S))
    rows = global_dp.nw_lastrow_lanes(x, y, lanes, table=table, gap=gap)
    seg = np.repeat(np.arange(S, dtype=np.int64), yl + 1)
    j = np.arange(len(seg), dtype=np.int64) - np.repeat(np.cumsum(yl + 1) - (yl + 1), yl + 1)
    fwd = lanes.out_off[0::2][seg] + j
    bwd = lanes.out_off[1::2][seg] + yl[seg] - j
    idx = torch.from_numpy(np.stack([seg, j, fwd, bwd])).to(x.device)
    seg_t, j_t = idx[0], idx[1]
    val = rows[idx[2]] + rows[idx[3]]
    best = torch.full((S,), torch.iinfo(torch.int32).min, dtype=torch.int32, device=x.device)
    best = best.scatter_reduce(0, seg_t, val, "amax")
    first = torch.where(val == best[seg_t], j_t, len(seg))
    k = torch.full((S,), len(seg), dtype=torch.int64, device=x.device)
    return k.scatter_reduce(0, seg_t, first, "amin"), best


def segments(buf: np.ndarray, off, length):
    """The concatenated slices buf[off_p : off_p + length_p], and each
    element's piece and column (0-based) within it."""
    length = np.asarray(length, np.int64)
    piece = np.repeat(np.arange(len(length), dtype=np.int64), length)
    col = np.arange(len(piece), dtype=np.int64) - np.repeat(np.cumsum(length) - length, length)
    return buf[np.asarray(off, np.int64)[piece] + col], piece, col


def leaf_columns(a, y, y_off, y_len, tab, g: int):
    """The one-byte leaves: a (L,) their x bytes, their y segments y[y_off :
    y_off + y_len] (each non-empty). Returns (jstar, diag, H1(n)) by leaf:
    the walk of the oracle's ``nw_align`` from (1, n) goes west while H(1,
    j) == H(1, j - 1) - g and H(1, j) is not the diagonal's, so it leaves row
    1 at the last j where the diagonal holds or the west does not (0 if
    none): by the diagonal there (diag) or north. H(1, j) = max(-g, max over
    k <= j of s_k + g) - g j, a segmented running maximum."""
    yv, seg, col = segments(y, y_off, y_len)
    n = np.asarray(y_len, np.int64)
    start = np.cumsum(n) - n
    j = col + 1
    s = tab[np.asarray(a, np.int64)[seg], yv.astype(np.int64)]
    v = s + g
    span = int(v.max() - v.min()) + 1
    run = np.maximum.accumulate(v - v.min() + seg * span) - seg * span + v.min()
    h1 = np.maximum(-g, run) - g * j
    prev = np.where(j == 1, -g, np.roll(h1, 1))
    diag = h1 == -g * (j - 1) + s
    stop = diag | (h1 != prev - g)
    jstar = np.maximum.reduceat(np.where(stop, j, 0), start)
    took_diag = np.zeros(len(n), bool)
    hit = jstar > 0
    took_diag[hit] = diag[start[hit] + jstar[hit] - 1]
    return jstar, took_diag, h1[start + n - 1]


def assemble(xb: np.ndarray, yb: np.ndarray, pieces: np.ndarray, jstar, took_diag):
    """The forward consensus strings from the terminal subproblems in x
    order: y against gaps (an empty x, the top only), x against gaps (an
    empty y), and the one-byte leaves -- x's byte on y's column jstar
    (diag) or as a gap after it (north), the rest of y against gaps."""
    xo, xl, yo, yl = pieces.T
    leaf = (xl == 1) & (yl >= 1)
    north = np.zeros(len(pieces), bool)
    north[leaf] = ~took_diag
    width = np.where(leaf, yl + north, np.where(xl == 0, yl, xl))
    start = np.cumsum(width) - width
    cx = np.full(int(width.sum()), ord("-"), np.uint8)
    cy = cx.copy()
    gx = (yl == 0) & (xl > 0)
    v, p, c = segments(xb, xo[gx], xl[gx])
    v.tobytes().decode("ascii")  # raises where the JAX walk's decode would
    cx[start[gx][p] + c] = v
    gy = xl == 0
    v, p, c = segments(yb, yo[gy], yl[gy])
    v.tobytes().decode("ascii")
    cy[start[gy][p] + c] = v
    v, p, c = segments(yb, yo[leaf], yl[leaf])
    js, nth = np.asarray(jstar, np.int64), north[leaf]
    cy[start[leaf][p] + c + (nth[p] & (c >= js[p]))] = v
    cx[start[leaf] + js - 1 + nth] = xb[xo[leaf]]
    return cx.tobytes().decode("latin-1"), cy.tobytes().decode("latin-1")


def hirschberg_align(x, y, cfg: ScoringConfig = ScoringConfig(),
                     device_cells: int = DEVICE_CELLS, device=None) -> AlignResult:
    """Linear-space global alignment; the score and alignment of the JAX
    ``hirschberg_align``. ``device_cells=0`` sends every subproblem to the
    card, a huge value keeps them all on the CPU; ``device`` as
    ``utils.device.resolve_device`` (default the CUDA card). At most one K25
    launch a recursion level."""
    global_dp.check_config(cfg)
    dev = resolve_device(device)
    xb, yb = _as_bytes(x), _as_bytes(y)
    m, n = len(xb), len(yb)
    tab = cfg.byte_table().astype(np.int64)
    g = int(cfg.gap_penalty)
    cpu = torch.device("cpu")
    routes = {}  # device -> (x, y, table) there, made at first use

    def route(d):
        if d not in routes:
            routes[d] = (torch.from_numpy(xb).to(d), torch.from_numpy(yb).to(d),
                         global_dp.byte_table(cfg, d))
        return routes[d]

    pieces = []  # terminal subproblems (xo, xl, yo, yl)
    level = [np.array([v], np.int64) for v in (0, m, 0, n)]
    score = None
    while len(level[0]):
        xo, xl, yo, yl = level
        split = (xl >= 2) & (yl >= 1)
        pieces.append(np.stack([v[~split] for v in level], 1))
        xo, xl, yo, yl = (v[split] for v in level)
        k = np.zeros(len(xo), np.int64)
        on_card = (xl * yl >= max(device_cells, 1)) & (dev.type == "cuda")
        for d, sel in ((dev, on_card), (cpu, ~on_card)):
            if sel.any():
                kd, bd = split_points(*route(d), g, xo[sel], xl[sel], yo[sel], yl[sel])
                # Only the ks come back, and the top level's best: the score.
                got = to_host([kd, bd] if score is None else [kd])
                k[sel] = got[0]
                if score is None:
                    score = float(got[1][0])
        mid = xl // 2
        level = [np.concatenate(p) for p in ((xo, xo + mid), (mid, xl - mid), (yo, yo + k),
                                              (k, yl - k))]
    pieces = np.concatenate(pieces)
    pieces = pieces[np.argsort(pieces[:, 0], kind="stable")]

    leaf = (pieces[:, 1] == 1) & (pieces[:, 3] >= 1)
    lp = pieces[leaf]
    jstar, took_diag, h1 = (leaf_columns(xb[lp[:, 0]], yb, lp[:, 2], lp[:, 3], tab, g)
                            if len(lp) else (np.zeros(0, np.int64), np.zeros(0, bool), None))
    cx, cy = assemble(xb, yb, pieces, jstar, took_diag)
    if score is None:  # no split at the top: x or y empty, or one byte of x
        score = float(h1[0]) if m == 1 and n >= 1 else float(-g * (m + n))
    # Store reversed, matching the reference's push_back-order convention.
    return AlignResult(score=score, pos=1, consensus_x=cx[::-1], consensus_y=cy[::-1],
                       max_i=m, max_j=n)


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
