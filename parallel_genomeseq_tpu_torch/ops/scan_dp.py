"""Anti-diagonal wavefront Smith-Waterman in eager PyTorch: the plain version
beside the CUDA kernels, and the CPU route.

Counterpart of the JAX package's ``ops/scan_dp._wavefront`` (:93),
``_wavefront_affine`` (:221) and ``_reduce_best`` (:302-321), for the
configurations ported so far: exact int32 values, linear or affine (Gotoh)
gaps, the column-major argmax tie-break, and either uniform match/mismatch
scores over raw bytes (K1/K2, affine K6/K7) or a substitution table over
compact codes (K4/K5, affine K8/K9). Same formulation: cell (r, d) is DP cell
(i = r + 1, j = d - r + 1); west and north come from diagonal d - 1,
north-west from d - 2; invalid cells (j < 1, i > m_b, j > n_b) are stored as
H = 0, which is both the zero boundary and what keeps the running argmax
exact (and, affine, E = F = -2^30). The loop runs one diagonal per step over
(M, B) tensors, on whatever device the inputs are. A ``gap_open`` > 0 selects
the affine recurrence, as ``ScoringConfig.is_affine`` does.

Compact codes (as the JAX package's ``_packed_luts``, wavefront_pallas.py:314,
assigns them): code c + 1 stands for ``alphabet[c]``, code 0 for every other
byte (pad bytes, lowercase, anything outside the alphabet), and every pair
involving code 0 scores the matrix minimum, as ``ScoringConfig.score`` does.
A code at or beyond the table's size reads as code 0, here and in the
kernels.

The reference-parity forms (K26, K27; ``sw_score_parity_plain``) add the
JAX ``Semantics.SAT_UINT8`` values and the ``tie="skewed"`` argmax
(scan_dp.py:58-78, :113-166, :325-339). Saturation is one clamp a cell on
the exact linear recurrence, with the operands that ``ScanEngine`` clips
(``sat_operands``, scan_dp.py:360-368): match' = clip(match), mm' =
clip(-mismatch), gap' = clip(gap), each to [0, 255], a cell scoring by byte
equality. JAX's step is diag = clip(clip(h2s + plus) - minus), west =
clip(h1 - gap'), north = clip(h1s - gap'), H = max(diag, west, north), with
(plus, minus) = (match', 0) on a match and (0, mm') else, clip to [0, 255].
Every carried H is in [0, 255], so h1 - gap' <= 255 and west = max(h1 -
gap', 0), north likewise, and on a mismatch diag = max(h2s - mm', 0); on a
match diag = min(h2s + match', 255). Every term but that one is at most 255,
so the min commutes out of the max:

    H = min(max(h2s + s', h1 - gap', h1s - gap', 0), 255),
    s' = match' on a match, -mm' else,

the exact step (``wavefront``) with s' and gap' and ``sat=True``'s clamp
(``tests/test_torch_parity.py`` pins it). The move codes are the exact
step's, on the clamped carries. The skewed tie keeps, per row, the first
maximum (score > 0) of least raw key rj * (M + 33) + ri, the cell's place in
the reference binary's skewed storage (``skewed_keys``), and
``reduce_best_skewed`` takes the least key among the rows holding the
lane's maximum (the first such row on equal keys).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import ScoringConfig, Semantics
from ..utils.encoding import X_PAD, Y_PAD, to_bytes

# Traceback move codes (bits 0-1) and the stop flag (bit 2), as in the JAX
# package's ops/scan_dp.py:83-86: NW if nw >= west and nw >= north, else W if
# west >= both, else N; stop when any of the three neighbours is zero.
MOVE_NW = 0
MOVE_W = 1
MOVE_N = 2
STOP_BIT = 4

# Affine (Gotoh) move byte, as in the JAX package's ops/scan_dp.py:204-215:
# bits 0-1 the term that achieved H (ZERO > NW > E > F on ties), bit 3 the E
# (west) run extends, bit 4 the F (north) run extends (extend wins ties).
H_NW = 0
H_E = 1
H_F = 2
H_ZERO = 3
E_EXT_BIT = 8
F_EXT_BIT = 16
NEG = -(2**30)  # E and F where no gap run can reach

_INT32_MAX = 2**31 - 1
SAT_MAX = 255  # the saturating uint8 ceiling
# Rows per strip of the long-read path: checkpoints are the H values of rows
# kS - 1, and the traceback replays S rows at a time (B13/B17's STRIP_S,
# wavefront_pallas.py:1030).
STRIP_S = 256
# Lanes per block of the plain K4 on a slab: each block is padded only to
# its own longest entry, so a whole length-sorted database fits in memory.
LANE_BLOCK = 4096


def profile_tables(cfg):
    """(encode_lut (256,) uint8, table (A + 1, A + 1) int32) of a
    substitution-matrix config over an alphabet of A letters: byte ->
    compact code, and the score of each (x code, y code) pair."""
    S = np.asarray(cfg.matrix).astype(np.int64)
    A = len(cfg.alphabet)
    table = np.full((A + 1, A + 1), int(S.min()), np.int32)
    table[1:, 1:] = S
    encode_lut = np.zeros(256, np.uint8)
    encode_lut[np.frombuffer(cfg.alphabet.encode("ascii"), np.uint8)] = np.arange(1, A + 1)
    return encode_lut, table


def _shift_down(h: torch.Tensor) -> torch.Tensor:
    """h'[r] = h[r-1], h'[0] = 0 (the i-1 neighbour along a diagonal)."""
    return torch.cat([torch.zeros_like(h[:1]), h[:-1]], dim=0)


def prepare_refs(y_bn: torch.Tensor, M: int) -> torch.Tensor:
    """(B, N) padded refs -> (N + 2M, B) reversed-padded buffer in which
    diagonal d reads rows [N + M - 1 - d, N + 2M - 1 - d)."""
    B = y_bn.shape[0]
    pad = torch.full((B, M), int(Y_PAD), dtype=torch.uint8, device=y_bn.device)
    yr = torch.flip(torch.cat([y_bn, pad], dim=1), dims=[1]).T
    return torch.cat([yr, pad.T], dim=0)


def uniform_scorer(match: int, mismatch: int):
    """Cell scores of uniform scoring over raw bytes."""
    return lambda x_mb, ywin: torch.where(x_mb == ywin, match, mismatch).to(torch.int32)


def table_scorer(table: torch.Tensor):
    """Cell scores from an (ncodes, ncodes) int32 table over compact codes;
    codes >= ncodes read as code 0."""
    nc = table.shape[0]
    flat = table.reshape(-1)

    def score(x_mb, ywin):
        xc = x_mb.long()
        yc = ywin.long()
        xc = torch.where(xc < nc, xc, 0)
        yc = torch.where(yc < nc, yc, 0)
        return flat[xc * nc + yc]

    return score


def wavefront(x_mb, y_bn, m, n, *, score, gap: int, gap_open: int = 0,
              track_pos: bool = True, emit_moves: bool = False, north=None,
              keep=None, sat: bool = False, keys=None, hstack=None):
    """Sweep all M + N - 1 diagonals.

    x_mb (M, B) uint8 reads, y_bn (B, N) uint8 refs, m/n (B,) int32 true
    lengths, clamped to M and N as the kernels clamp them; ``score(x_mb,
    ywin)`` gives one diagonal's (M, B) int32 cell scores (cells outside a
    lane's matrix are masked to 0 whatever they score). Returns
    (best (M, B), bestd (M, B), moves (D, M, B) uint8 or None). With
    track_pos=False bestd stays 0 (score-only sweep). ``gap_open`` > 0 runs
    ``wavefront_affine`` instead, with ``gap`` as the extension cost.

    ``north`` (B, N + 1) int32 is the H row above row 0 for columns j =
    0..N (zeros when None; a strip replay passes its checkpoint row), and
    ``keep`` = (rows (K,) int64, out (K, D, B) int32) records the H of those
    rows on every diagonal (a checkpointing sweep); ``wavefront_affine``
    takes their affine forms.

    ``sat`` clamps every H at SAT_MAX (the saturating uint8 step with the
    operands of ``sat_operands``; see the module's docstring). ``keys``, an
    (M, B) int32 tensor of _INT32_MAX, selects the skewed tie: each row keeps
    its first maximum of least raw key (``skewed_keys``) and ``keys`` ends
    holding that key (JAX's ``bestkey``). ``hstack``, a (D, M, B) int32
    tensor, receives every diagonal's H (JAX's ``keep_matrix``).
    """
    if gap_open > 0:
        if sat or keys is not None:
            raise ValueError("the saturating and skewed forms are linear-gap only")
        return wavefront_affine(
            x_mb, y_bn, m, n, score=score, gap_open=gap_open, gap=gap,
            track_pos=track_pos, emit_moves=emit_moves, north=north, keep=keep,
            hstack=hstack,
        )
    M, B = x_mb.shape
    N = y_bn.shape[1]
    D = M + N - 1
    dev = x_mb.device
    m = m.clamp(max=M)
    n = n.clamp(max=N)
    yr = prepare_refs(y_bn, M)
    rr = torch.arange(M, dtype=torch.int32, device=dev)[:, None]
    rowmask = rr < m[None, :]
    lo = 1 - n[None, :]  # valid rows satisfy rr >= d + 1 - n
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    h1 = torch.zeros((M, B), dtype=torch.int32, device=dev)
    h2 = torch.zeros_like(h1)
    best = torch.zeros_like(h1)
    bestd = torch.zeros_like(h1)
    moves = torch.empty((D, M, B), dtype=torch.uint8, device=dev) if emit_moves else None
    if north is not None:  # padded so that every diagonal reads a column
        north = torch.cat([north.T, torch.zeros((M, B), dtype=torch.int32, device=dev)])
    for d in range(D):
        ywin = yr[N + M - 1 - d : N + 2 * M - 1 - d]
        sc = score(x_mb, ywin)
        h1s = _shift_down(h1)  # north (i-1, j)
        h2s = _shift_down(h2)  # nw    (i-1, j-1)
        if north is not None:  # row 0's cell is j = d + 1
            h1s[0] = north[d + 1]
            h2s[0] = north[d]
        hd = torch.maximum(
            torch.maximum(h2s + sc, h1 - gap), torch.maximum(h1s - gap, zero)
        )
        if sat:
            hd = hd.clamp(max=SAT_MAX)
        valid = (rr <= d) & rowmask & (rr >= lo + d)
        hd = torch.where(valid, hd, zero)
        if keep is not None:
            keep[1][:, d] = hd[keep[0]]
        if hstack is not None:
            hstack[d] = hd
        if keys is not None:  # the skewed tie: least raw key among equal maxima
            key = skewed_keys(d, M, m, n)
            upd = (hd > best) | ((hd == best) & (hd > 0) & (key < keys))
            best = torch.where(upd, hd, best)
            bestd = torch.where(upd, d, bestd)
            keys.copy_(torch.where(upd, key, keys))
        elif track_pos:
            upd = hd > best  # strict: keeps the earliest diagonal (smallest j)
            best = torch.where(upd, hd, best)
            bestd = torch.where(upd, d, bestd)
        else:
            best = torch.maximum(best, hd)
        if emit_moves:
            n1, n2, n3 = h2s, h1, h1s  # nw, west, north
            mv = torch.where(
                (n1 >= n2) & (n1 >= n3), MOVE_NW,
                torch.where((n2 >= n1) & (n2 >= n3), MOVE_W, MOVE_N),
            )
            stop = (n1 == 0) | (n2 == 0) | (n3 == 0)
            moves[d] = (mv + torch.where(stop, STOP_BIT, 0)).to(torch.uint8)
        h2 = h1
        h1 = hd
    return best, bestd, moves


def wavefront_affine(x_mb, y_bn, m, n, *, score, gap_open: int, gap: int,
                     track_pos: bool = True, emit_moves: bool = False, north=None,
                     keep=None, hstack=None):
    """Affine-gap (Gotoh) sweep, line for line ``_wavefront_affine``
    (scan_dp.py:221-299): a gap of length L costs gap_open + L * gap. Two
    more carried diagonals, E (west runs) and F (north runs); invalid cells
    hold H = 0 and E = F = NEG, and row 0's F shifts in as 0, as the scan's
    ``_shift_down`` does. Same arguments and returns as ``wavefront``; the
    moves are the affine bytes (H source, E/F extend bits).

    ``north`` = (H row, F row), each (B, N + 1) int32 for columns j = 0..N:
    the H and F of the row above row 0 (a strip replay passes its two
    checkpoint rows; None keeps H = F = 0 there). E needs no such row: it
    runs along a row and never crosses a strip edge. ``keep`` = (rows (K,)
    int64, out_h, out_f (K, D, B) int32) records the H and F of those rows
    on every diagonal; ``hstack`` every diagonal's H."""
    M, B = x_mb.shape
    N = y_bn.shape[1]
    D = M + N - 1
    dev = x_mb.device
    m = m.clamp(max=M)
    n = n.clamp(max=N)
    yr = prepare_refs(y_bn, M)
    rr = torch.arange(M, dtype=torch.int32, device=dev)[:, None]
    rowmask = rr < m[None, :]
    lo = 1 - n[None, :]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    neg = torch.full((), NEG, dtype=torch.int32, device=dev)
    h1 = torch.zeros((M, B), dtype=torch.int32, device=dev)
    h2 = torch.zeros_like(h1)
    e1 = torch.full_like(h1, NEG)
    f1 = torch.full_like(h1, NEG)
    best = torch.zeros_like(h1)
    bestd = torch.zeros_like(h1)
    moves = torch.empty((D, M, B), dtype=torch.uint8, device=dev) if emit_moves else None
    if north is not None:  # padded so that every diagonal reads a column
        pad = torch.zeros((M, B), dtype=torch.int32, device=dev)
        hnorth, fnorth = (torch.cat([row.T, pad]) for row in north)
    for d in range(D):
        ywin = yr[N + M - 1 - d : N + 2 * M - 1 - d]
        sc = score(x_mb, ywin)
        h1s = _shift_down(h1)  # north   (i-1, j)
        h2s = _shift_down(h2)  # nw      (i-1, j-1)
        f1s = _shift_down(f1)  # north F
        if north is not None:  # row 0's cell is j = d + 1
            h1s[0] = hnorth[d + 1]
            h2s[0] = hnorth[d]
            f1s[0] = fnorth[d + 1]
        e_open = h1 - gap_open
        f_open = h1s - gap_open
        e_d = torch.maximum(e_open, e1) - gap
        f_d = torch.maximum(f_open, f1s) - gap
        diag = h2s + sc
        hd = torch.maximum(torch.maximum(diag, e_d), torch.maximum(f_d, zero))
        valid = (rr <= d) & rowmask & (rr >= lo + d)
        hd = torch.where(valid, hd, zero)
        e_d = torch.where(valid, e_d, neg)
        f_d = torch.where(valid, f_d, neg)
        if keep is not None:
            keep[1][:, d] = hd[keep[0]]
            keep[2][:, d] = f_d[keep[0]]
        if hstack is not None:
            hstack[d] = hd
        if track_pos:
            upd = hd > best  # strict: earliest diagonal (smallest j) wins ties
            best = torch.where(upd, hd, best)
            bestd = torch.where(upd, d, bestd)
        else:
            best = torch.maximum(best, hd)
        if emit_moves:
            h_src = torch.where(
                hd == 0, H_ZERO,
                torch.where(hd == diag, H_NW, torch.where(hd == e_d, H_E, H_F)),
            )
            mv = (h_src + torch.where(e1 >= e_open, E_EXT_BIT, 0)
                  + torch.where(f1s >= f_open, F_EXT_BIT, 0))
            moves[d] = mv.to(torch.uint8)
        h2 = h1
        h1 = hd
        e1 = e_d
        f1 = f_d
    return best, bestd, moves


def reduce_best(best, bestd):
    """(M, B) elementwise bests -> per-lane (score, i, j) int32 with the
    column-major tie-break: min j, then min i; an all-zero lane gives
    (0, 0, 0)."""
    M, B = best.shape
    score = best.max(dim=0).values
    rr = torch.arange(M, dtype=torch.int32, device=best.device)[:, None]
    jj = bestd - rr + 1
    key = jj * (M + 2) + rr + 1  # lexicographic (j, i); i = r + 1 <= M + 1
    key = torch.where(best == score[None, :], key, _INT32_MAX)
    r_star = key.argmin(dim=0)
    lanes = torch.arange(B, device=best.device)
    i_star = (r_star + 1).to(torch.int32)
    j_star = (bestd[r_star, lanes] - r_star + 1).to(torch.int32)
    nonzero = score > 0
    return score, torch.where(nonzero, i_star, 0), torch.where(nonzero, j_star, 0)


def skewed_keys(d: int, M: int, m, n):
    """(M, B) int32 raw keys of diagonal d's cells (i = r + 1, j = d - r +
    1), as the JAX scan computes them (scan_dp.py:144-160): the cell's
    place in the reference binary's skewed storage, rj * (M + 33) + ri, with
    s = i + j, rj = s up to max(m, n) and s - max(m, n) - 1 past it, and ri
    = j unless n > m, where ri = j below min(m, n), j - (n - m) past max(m,
    n) and m - i between. M is the padded read length."""
    dev = m.device
    ii = torch.arange(1, M + 1, dtype=torch.int32, device=dev)[:, None]
    jj = d + 2 - ii
    s = d + 2
    mm, nn = m[None, :], n[None, :]
    minmn, maxmn = torch.minimum(mm, nn), torch.maximum(mm, nn)
    ri = torch.where(
        nn > mm,
        torch.where(s < minmn, jj, torch.where(s > maxmn, jj - (nn - mm), mm - ii)),
        jj,
    )
    rj = torch.where(s <= maxmn, s, s - maxmn - 1)
    return (rj * (M + 33) + ri).to(torch.int32)


def reduce_best_skewed(best, bestd, bestkey):
    """Per-lane (score, i, j) int32 with the skewed tie-break of
    ``_reduce_best_skewed`` (scan_dp.py:325-339): among the rows holding the
    lane's maximum, the least raw key, the first such row on equal keys; an
    all-zero lane gives (0, 0, 0)."""
    B = best.shape[1]
    score = best.max(dim=0).values
    key = torch.where(best == score[None, :], bestkey, _INT32_MAX)
    r_star = key.argmin(dim=0)  # the first of equal minima, as jnp.argmin
    lanes = torch.arange(B, device=best.device)
    i_star = (r_star + 1).to(torch.int32)
    j_star = (bestd[r_star, lanes] - r_star + 1).to(torch.int32)
    nonzero = score > 0
    return score, torch.where(nonzero, i_star, 0), torch.where(nonzero, j_star, 0)


def sat_operands(match, mismatch, gap):
    """(match', mismatch', gap') of a SAT_UINT8 config for the exact step
    with ``sat=True``: the magnitudes ``ScanEngine`` clips to [0, 255]
    (scan_dp.py:363-368, int() truncating), the mismatch as the negated
    clipped penalty."""
    clip = lambda v: min(max(int(v), 0), SAT_MAX)
    return clip(match), -clip(-mismatch), clip(gap)


def sw_score_parity_plain(xs, ys, m, n, *, gap: int, sat: bool, tie: str = "colmajor",
                          match: int = 0, mismatch: int = 0, table=None,
                          track_pos: bool = True, emit_moves: bool = False):
    """Plain version of the K26 kernel (and, past 2,048 rows, K27): the
    linear recurrence on xs (B, M), ys (B, N) with the clamp at SAT_MAX when
    ``sat`` (operands from ``sat_operands``), scored uniformly (match,
    mismatch) or by ``table`` over compact codes, argmax by ``tie``
    ('colmajor' or 'skewed'). Returns per-lane (score, i, j) int32 (i = j =
    0 when neither track_pos nor emit_moves), plus with ``emit_moves`` the
    (M + N - 1, M, B) uint8 move codes."""
    score_fn = table_scorer(table) if table is not None else uniform_scorer(match, mismatch)
    B, M = xs.shape
    pos = track_pos or emit_moves
    keys = (torch.full((M, B), _INT32_MAX, dtype=torch.int32, device=xs.device)
            if pos and tie == "skewed" else None)
    best, bestd, moves = wavefront(
        xs.T, ys, m, n, score=score_fn, gap=gap, track_pos=pos, emit_moves=emit_moves,
        sat=sat, keys=keys,
    )
    if not pos:
        score = best.max(dim=0).values
        z = torch.zeros_like(score)
        return score, z, z.clone()
    out = reduce_best_skewed(best, bestd, keys) if keys is not None else reduce_best(best, bestd)
    return (*out, moves) if emit_moves else out


def sw_score_plain(xs, ys, m, n, *, match: int, mismatch: int, gap: int,
                   gap_open: int = 0, track_pos: bool = True):
    """Plain version of the K1 kernel (K6 with gap_open > 0): xs (B, M), ys
    (B, N) uint8, m/n (B,) int32 -> per-lane (score, i, j) int32; i = j = 0
    when not track_pos."""
    best, bestd, _ = wavefront(
        xs.T, ys, m, n, score=uniform_scorer(match, mismatch), gap=gap,
        gap_open=gap_open, track_pos=track_pos,
    )
    if not track_pos:
        score = best.max(dim=0).values
        z = torch.zeros_like(score)
        return score, z, z.clone()
    return reduce_best(best, bestd)


def sw_score_moves_plain(xs, ys, m, n, *, match: int, mismatch: int, gap: int,
                         gap_open: int = 0):
    """Plain version of the K2 kernel (K7 with gap_open > 0): K1's (score, i,
    j) plus the (M + N - 1, M, B) uint8 move codes."""
    best, bestd, moves = wavefront(
        xs.T, ys, m, n, score=uniform_scorer(match, mismatch), gap=gap,
        gap_open=gap_open, emit_moves=True,
    )
    return (*reduce_best(best, bestd), moves)


def _ckpt_plain(xs, ys, m, n, *, score, gap: int, gap_open: int = 0):
    """(score, i, j) on xs (B, M), ys (B, N) under the cell scores ``score``
    (``uniform_scorer`` or ``table_scorer``) plus the rows kept at every
    STRIP_S-th row, each (B, K, N) int32, K = ceil(M / STRIP_S) - 1: H, and
    under affine gaps F too."""
    B, M = xs.shape
    N = ys.shape[1]
    K = max(0, -(-M // STRIP_S) - 1)
    dev = xs.device
    rows = (torch.arange(K, device=dev) + 1) * STRIP_S - 1
    outs = [torch.zeros((K, M + N - 1, B), dtype=torch.int32, device=dev)
            for _ in range(2 if gap_open > 0 else 1)]
    best, bestd, _ = wavefront(
        xs.T, ys, m, n, score=score, gap=gap, gap_open=gap_open, keep=(rows, *outs),
    )
    # Row r's cell in column j lies on diagonal r + j - 1.
    d = rows[:, None] + torch.arange(N, device=dev)[None, :]
    k = torch.arange(K, device=dev)[:, None]
    planes = [out[k, d].permute(2, 0, 1).contiguous() for out in outs]  # (K, N, B) -> (B, K, N)
    return (*reduce_best(best, bestd), *planes)


def sw_score_ckpt_plain(xs, ys, m, n, *, match: int, mismatch: int, gap: int):
    """Plain version of the K12 kernel: K1's (score, i, j) on xs (B, M), ys
    (B, N) plus the checkpoint rows (B, K, N) int32, K = ceil(M / STRIP_S) -
    1: ck[b, k, j - 1] = H((k + 1) * STRIP_S, j) in 1-based rows, 0 outside
    the lane's matrix."""
    return _ckpt_plain(xs, ys, m, n, score=uniform_scorer(match, mismatch), gap=gap)


def sw_score_affine_ckpt_plain(xs, ys, m, n, *, match: int, mismatch: int, gap_open: int,
                               gap: int):
    """Plain version of the K16 kernel: K6's (score, i, j) on xs (B, M), ys
    (B, N) plus the H checkpoint rows ck and the F rows fck, each (B, K, N)
    int32 as K12's: fck[b, k, j - 1] = F((k + 1) * STRIP_S, j), NEG outside
    the lane's matrix."""
    return _ckpt_plain(xs, ys, m, n, score=uniform_scorer(match, mismatch), gap=gap,
                       gap_open=gap_open)


def sw_profile_ckpt_plain(xs, ys, m, n, *, table, gap: int):
    """Plain version of the K20 kernel: K12's checkpoint rows and K4's (score,
    i, j) under the cell scores of ``table`` over the compact codes xs (B,
    M) and ys (B, N)."""
    return _ckpt_plain(xs, ys, m, n, score=table_scorer(table), gap=gap)


def sw_profile_affine_ckpt_plain(xs, ys, m, n, *, table, gap_open: int, gap: int):
    """Plain version of the K23 kernel: K16's H and F checkpoint rows and
    K8's (score, i, j) under the cell scores of ``table`` over the compact
    codes xs (B, M) and ys (B, N)."""
    return _ckpt_plain(xs, ys, m, n, score=table_scorer(table), gap=gap, gap_open=gap_open)


def _strip_replay(xs, ys, m, n, base: int, north, *, score, gap: int, gap_open: int = 0):
    """The moves of the STRIP_S rows [base, base + STRIP_S) of xs against ys
    under the cell scores ``score``, from the row(s) ``north`` above them, as
    (B, N, STRIP_S) uint8."""
    B, M = xs.shape
    N = ys.shape[1]
    S = STRIP_S
    dev = xs.device
    x = torch.full((B, S), X_PAD, dtype=torch.uint8, device=dev)
    x[:, : max(0, min(S, M - base))] = xs[:, base : base + S]
    ms = (m.clamp(max=M) - base).clamp(0, S).to(torch.int32)
    _, _, moves = wavefront(
        x.T, ys, ms, n, score=score, gap=gap, gap_open=gap_open, track_pos=False,
        emit_moves=True, north=north,
    )
    r = torch.arange(S, device=dev)[None, :]
    d = r + torch.arange(N, device=dev)[:, None]  # cell (r, j) on diagonal r + j - 1
    return moves[d, r].permute(2, 0, 1).contiguous()


def _north_row(row, B: int, N: int, dev):
    """(B, N + 1) int32 boundary row: 0 in column 0, then ``row`` (zeros when
    None)."""
    out = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
    if row is not None:
        out[:, 1:] = row
    return out


def strip_moves_plain(xs, ys, m, n, rowin, base: int, *, match: int, mismatch: int,
                      gap: int):
    """Plain version of the K13 kernel: the move codes of the STRIP_S rows
    [base, base + STRIP_S) of xs (B, M) against ys (B, N), recomputed from
    ``rowin`` (B, N) int32, the H of row ``base`` (1-based) for j = 1..N (None
    for the first strip: zeros). Returns (B, N, STRIP_S) uint8,
    moves[b, j - 1, r] the code of cell (base + r + 1, j); rows past a lane's
    m and columns past its n hold codes no walk reads."""
    B, N = ys.shape
    return _strip_replay(xs, ys, m, n, base, _north_row(rowin, B, N, xs.device),
                         score=uniform_scorer(match, mismatch), gap=gap)


def strip_profile_moves_plain(xs, ys, m, n, rowin, base: int, *, table, gap: int):
    """Plain version of the K21 kernel: ``strip_moves_plain`` under the cell
    scores of ``table`` over the compact codes xs (B, M) and ys (B, N)."""
    B, N = ys.shape
    return _strip_replay(xs, ys, m, n, base, _north_row(rowin, B, N, xs.device),
                         score=table_scorer(table), gap=gap)


def strip_affine_moves_plain(xs, ys, m, n, rowin, frowin, base: int, *, match: int,
                             mismatch: int, gap_open: int, gap: int):
    """Plain version of the K17 kernel: ``strip_moves_plain`` under affine
    gaps, replayed from the H row ``rowin`` and the F row ``frowin`` of row
    ``base`` (both None for the first strip: H = F = 0 above row 1, the
    boundary of the full sweep), emitting the affine move bytes. Every cell
    inside a lane's matrix gets the byte of the full-matrix sweep: E starts
    at NEG in column 0 of each row as there, and F and H come in exact."""
    B, N = ys.shape
    north = tuple(_north_row(row, B, N, xs.device) for row in (rowin, frowin))
    return _strip_replay(xs, ys, m, n, base, north, score=uniform_scorer(match, mismatch),
                         gap=gap, gap_open=gap_open)


def strip_profile_affine_moves_plain(xs, ys, m, n, rowin, frowin, base: int, *, table,
                                     gap_open: int, gap: int):
    """Plain version of the K24 kernel: ``strip_affine_moves_plain`` under the
    cell scores of ``table`` over the compact codes xs (B, M) and ys (B, N)."""
    B, N = ys.shape
    north = tuple(_north_row(row, B, N, xs.device) for row in (rowin, frowin))
    return _strip_replay(xs, ys, m, n, base, north, score=table_scorer(table), gap=gap,
                         gap_open=gap_open)


def _strip_group_plain(replay, xs, ys, m, n, planes, first: int, moves, walk, **kw):
    """The plain group replay: strip first + g of every lane into moves[g]
    of ``moves`` (G, B, N, STRIP_S) uint8 with the per-strip plain function
    ``replay``, from the rows ``planes`` (the (B, K, N) H, and affine F,
    checkpoints; strip t starts from row t - 1, strip 0 from zeros). Only the
    cells the kernels write: with ``walk`` = (i, j, active) a lane replays a
    strip only when active and i - 1 >= its first row, and then columns 1 ..
    min(n, j); without, every lane columns 1 .. n. Each strip runs once over
    the lanes it replays, at the width of their widest bound."""
    G, B, N, S = moves.shape
    cols = n.clamp(0, N).long()
    reached = torch.ones(B, dtype=torch.bool, device=moves.device)
    for g in range(G):
        t = first + g
        base = t * S
        if walk is not None:
            i, j, active = walk
            reached = active & (i - 1 >= base)
            cols = torch.minimum(n.clamp(0, N), j).long()
        lanes = (reached & (cols > 0)).nonzero().flatten()
        if not lanes.numel():
            continue
        width = cols[lanes]
        J = int(width.max())
        rows = [p[lanes, t - 1, :J] if t >= 1 else None for p in planes]
        got = replay(xs[lanes], ys[lanes, :J], m[lanes], n[lanes], *rows, base, **kw)
        keep = (torch.arange(J, device=moves.device)[None, :] < width[:, None])[..., None]
        moves[g, lanes, :J] = torch.where(keep, got, moves[g, lanes, :J])
    return moves


def strip_moves_group_plain(xs, ys, m, n, ck, first: int, moves, walk=None, *, match: int,
                            mismatch: int, gap: int):
    """Plain version of the K13 kernel's group launch
    (``strips_cuda.strip_moves_group``): the moves of strips first .. first +
    G - 1 of xs (B, M) against ys (B, N) into ``moves`` (G, B, N, STRIP_S)
    uint8, moves[g] as ``strip_moves_plain`` gives strip first + g, each from
    its checkpoint row of ``ck`` (B, K, N); the cells outside the bounds of
    ``_strip_group_plain`` keep what they held."""
    return _strip_group_plain(strip_moves_plain, xs, ys, m, n, (ck,), first, moves, walk,
                              match=match, mismatch=mismatch, gap=gap)


def strip_profile_moves_group_plain(xs, ys, m, n, ck, first: int, moves, walk=None, *, table,
                                    gap: int):
    """Plain version of the K21 kernel's group launch:
    ``strip_moves_group_plain`` under the cell scores of ``table``."""
    return _strip_group_plain(strip_profile_moves_plain, xs, ys, m, n, (ck,), first, moves,
                              walk, table=table, gap=gap)


def strip_affine_moves_group_plain(xs, ys, m, n, ck, fck, first: int, moves, walk=None, *,
                                   match: int, mismatch: int, gap_open: int, gap: int):
    """Plain version of the K17 kernel's group launch:
    ``strip_moves_group_plain`` under affine gaps, each strip from its H and
    F checkpoint rows of ``ck`` and ``fck`` (B, K, N)."""
    return _strip_group_plain(strip_affine_moves_plain, xs, ys, m, n, (ck, fck), first, moves,
                              walk, match=match, mismatch=mismatch, gap_open=gap_open, gap=gap)


def strip_profile_affine_moves_group_plain(xs, ys, m, n, ck, fck, first: int, moves,
                                           walk=None, *, table, gap_open: int, gap: int):
    """Plain version of the K24 kernel's group launch:
    ``strip_affine_moves_group_plain`` under the cell scores of ``table``."""
    return _strip_group_plain(strip_profile_affine_moves_plain, xs, ys, m, n, (ck, fck), first,
                              moves, walk, table=table, gap_open=gap_open, gap=gap)


def slab_lengths(R: int, y_off, n):
    """Each lane's n (int64) clamped to what an (R,) slab holds past its
    offset; a lane whose offset lies outside [0, R] gets length 0 -- the
    kernels clamp the same way."""
    off = y_off.long()
    inside = (off >= 0) & (off <= R)
    return torch.where(inside, torch.minimum(n.long(), R - off), 0).clamp(min=0)


def gather_lanes(slab, y_off, n):
    """Lanes of a flat (R,) code slab -> ((B, N) codes padded with 0, the
    lengths clamped by ``slab_lengths``), N = the largest clamped length."""
    off = y_off.long()
    n = slab_lengths(slab.shape[0], y_off, n)
    N = max(1, int(n.max())) if n.numel() else 1
    t = torch.arange(N, device=slab.device)
    valid = t[None, :] < n[:, None]
    ys = torch.zeros(valid.shape, dtype=torch.uint8, device=slab.device)
    ys[valid] = slab[(off[:, None] + t[None, :])[valid]]
    return ys, n.to(torch.int32)


def sw_profile_plain(x, y, m, n, *, table, gap: int, gap_open: int = 0, y_off=None):
    """Plain version of the K4 kernel (K8 with gap_open > 0): per-lane
    (score, i, j) int32 of SW scored by ``table`` (ncodes, ncodes) int32 over
    compact codes.

    x: (B, M) codes, or (M,) codes of one query shared by every lane.
    y: (B, N) codes, or -- with ``y_off`` (B,) int64 -- a flat (R,) slab in
    which lane b reads ``y[y_off[b] : y_off[b] + n[b]]``.
    m, n: (B,) int32 true lengths, clamped to M and to what y holds.
    Lanes run in blocks of LANE_BLOCK.
    """
    B = m.shape[0]
    out = []
    for b0 in range(0, B, LANE_BLOCK):
        sl = slice(b0, min(B, b0 + LANE_BLOCK))
        if y_off is None:
            ys, nb = y[sl], n[sl]
        else:
            ys, nb = gather_lanes(y, y_off[sl], n[sl])
        xs = x[sl] if x.dim() == 2 else x[None, :].expand(ys.shape[0], -1)
        best, bestd, _ = wavefront(
            xs.T, ys, m[sl], nb, score=table_scorer(table), gap=gap,
            gap_open=gap_open,
        )
        out.append(reduce_best(best, bestd))
    if not out:
        z = torch.zeros(0, dtype=torch.int32, device=m.device)
        return z, z.clone(), z.clone()
    return tuple(torch.cat(parts) for parts in zip(*out))


def sw_profile_moves_plain(xs, ys, m, n, *, table, gap: int, gap_open: int = 0):
    """Plain version of the K5 kernel (K9 with gap_open > 0): K4's (score, i,
    j) on xs (B, M) and ys (B, N) codes plus the (M + N - 1, M, B) uint8
    move codes."""
    best, bestd, moves = wavefront(
        xs.T, ys, m, n, score=table_scorer(table), gap=gap, gap_open=gap_open,
        emit_moves=True,
    )
    return (*reduce_best(best, bestd), moves)


def hstack_to_matrix(hstack, m: int, n: int, lane: int = 0) -> np.ndarray:
    """Diagonal-major (D, M, B) stack -> dense (m+1, n+1) DP matrix with the
    zero boundary row and column (copied from scan_dp.py:426-434), as a
    numpy array of the stack's type; ``hstack`` may be a tensor on any
    device."""
    hs = hstack[:, :, lane]
    hs = hs.cpu().numpy() if isinstance(hs, torch.Tensor) else np.asarray(hs)
    H = np.zeros((m + 1, n + 1), dtype=hs.dtype)
    i = np.arange(1, m + 1)[:, None]
    j = np.arange(1, n + 1)[None, :]
    H[1:, 1:] = hs[i + j - 2, i - 1]
    return H


def sw_matrix_scan(x, y, cfg: ScoringConfig = ScoringConfig(), device="cpu") -> np.ndarray:
    """Single-pair convenience (scan_dp.py:437-451): the full (m+1, n+1) DP
    matrix of ``cfg`` by the plain sweep on ``device``, int32, or uint8 under
    SAT_UINT8. Linear or affine gaps, uniform or substitution-matrix
    scoring; a test and inspection utility on no CLI path."""
    from .engine import check_supported

    check_supported(cfg)
    xb = to_bytes(x) if isinstance(x, str) else np.asarray(x, np.uint8)
    yb = to_bytes(y) if isinstance(y, str) else np.asarray(y, np.uint8)
    sat = cfg.semantics == Semantics.SAT_UINT8
    if cfg.is_uniform:
        match, mismatch, gap = (sat_operands(cfg.match, cfg.mismatch, cfg.gap_penalty) if sat
                                else (int(cfg.match), int(cfg.mismatch), int(cfg.gap_penalty)))
        score = uniform_scorer(match, mismatch)
    else:
        if sat:
            raise ValueError("SAT_UINT8 supports uniform scoring only")
        lut, table = profile_tables(cfg)
        xb, yb = lut[xb], lut[yb]
        score = table_scorer(torch.from_numpy(table).to(device))
        gap = int(cfg.gap_penalty)
    m, n = len(xb), len(yb)
    xs = torch.from_numpy(np.ascontiguousarray(xb)).to(device)[:, None]
    ys = torch.from_numpy(np.ascontiguousarray(yb)).to(device)[None, :]
    lens = [torch.tensor([v], dtype=torch.int32, device=device) for v in (m, n)]
    hstack = torch.zeros((max(1, m + n - 1), m, 1), dtype=torch.int32, device=device)
    wavefront(xs, ys, *lens, score=score, gap=gap, gap_open=int(cfg.gap_open), sat=sat,
              hstack=hstack)
    H = hstack_to_matrix(hstack, m, n)
    return H.astype(np.uint8) if sat else H
