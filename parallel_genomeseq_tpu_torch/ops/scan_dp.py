"""Anti-diagonal wavefront Smith-Waterman in eager PyTorch: the plain version
beside the CUDA kernels, and the CPU route.

Counterpart of the JAX package's ``ops/scan_dp._wavefront`` (:93) and
``_reduce_best`` (:302-321), for the configuration this slice runs: exact
int32 values, uniform match/mismatch scoring, linear gaps and the
column-major argmax tie-break. Same formulation: cell (r, d) is DP cell
(i = r + 1, j = d - r + 1); west and north come from diagonal d - 1, north-west
from d - 2; invalid cells (j < 1, i > m_b, j > n_b) are stored as 0, which is
both the zero boundary and what keeps the running argmax exact. The loop runs
one diagonal per step over (M, B) tensors, on whatever device the inputs are.
"""

from __future__ import annotations

import torch

from parallel_genomeseq_tpu.utils.encoding import Y_PAD

# Traceback move codes (bits 0-1) and the stop flag (bit 2), as in the JAX
# package's ops/scan_dp.py:83-86: NW if nw >= west and nw >= north, else W if
# west >= both, else N; stop when any of the three neighbours is zero.
MOVE_NW = 0
MOVE_W = 1
MOVE_N = 2
STOP_BIT = 4

_INT32_MAX = 2**31 - 1


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


def wavefront(x_mb, y_bn, m, n, *, match: int, mismatch: int, gap: int,
              track_pos: bool = True, emit_moves: bool = False):
    """Sweep all M + N - 1 diagonals.

    x_mb (M, B) uint8 reads, y_bn (B, N) uint8 refs, m/n (B,) int32 true
    lengths, clamped to M and N as the kernels clamp them. Returns (best
    (M, B), bestd (M, B), moves (D, M, B) uint8 or None). With
    track_pos=False bestd stays 0 (score-only sweep).
    """
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
    for d in range(D):
        ywin = yr[N + M - 1 - d : N + 2 * M - 1 - d]
        sc = torch.where(x_mb == ywin, match, mismatch).to(torch.int32)
        h1s = _shift_down(h1)  # north (i-1, j)
        h2s = _shift_down(h2)  # nw    (i-1, j-1)
        hd = torch.maximum(
            torch.maximum(h2s + sc, h1 - gap), torch.maximum(h1s - gap, zero)
        )
        valid = (rr <= d) & rowmask & (rr >= lo + d)
        hd = torch.where(valid, hd, zero)
        if track_pos:
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


def sw_score_plain(xs, ys, m, n, *, match: int, mismatch: int, gap: int,
                   track_pos: bool = True):
    """Plain version of the K1 kernel: xs (B, M), ys (B, N) uint8, m/n (B,)
    int32 -> per-lane (score, i, j) int32; i = j = 0 when not track_pos."""
    best, bestd, _ = wavefront(
        xs.T, ys, m, n, match=match, mismatch=mismatch, gap=gap,
        track_pos=track_pos,
    )
    if not track_pos:
        score = best.max(dim=0).values
        z = torch.zeros_like(score)
        return score, z, z.clone()
    return reduce_best(best, bestd)


def sw_score_moves_plain(xs, ys, m, n, *, match: int, mismatch: int, gap: int):
    """Plain version of the K2 kernel: K1's (score, i, j) plus the
    (M + N - 1, M, B) uint8 move/stop codes."""
    best, bestd, moves = wavefront(
        xs.T, ys, m, n, match=match, mismatch=mismatch, gap=gap,
        emit_moves=True,
    )
    return (*reduce_best(best, bestd), moves)
