"""Batched greedy traceback over the forward sweep's move codes.

``walk_moves`` is the counterpart of the JAX package's ``ops/traceback.py``
``walk_moves`` (:30-89), ``walk_moves_affine`` of its affine (Gotoh)
state-machine walk ``walk_moves_affine`` (:92-164), ``walk_strip_level``
of the long-read walk through one row-strip (:167-218) and
``walk_strip_level_affine`` of its affine form (:221-286): on CPU tensors
each runs the plain PyTorch loop below, line for line the JAX body; on CUDA
tensors they launch K3, K10, K14 and K18 (``csrc/traceback.cu``), since the
eager loop would be about fifteen launches per step -- a warp a lane, K3/K10
over gathered segments of the diagonal band of move bytes the walk can
reach, K14/K18 over move tiles staged in shared memory.
``walk_strip_group`` and ``walk_strip_group_affine`` walk a replay group's
strips, top first, in one K14 or K18 launch; on CPU tensors they loop the
per-strip plain walks.
``decode_consensus`` is copied from traceback.py:289-307 and stays numpy.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from ..utils.device import device_of
from . import _build
from .scan_dp import (E_EXT_BIT, F_EXT_BIT, H_E, H_F, H_NW, H_ZERO, MOVE_N, MOVE_W, STOP_BIT,
                      STRIP_S)

GAP_BYTE = ord("-")


def _walk_moves_plain(moves, x_mb, y_bn, i0, j0, max_steps: int):
    M, B = x_mb.shape
    N = y_bn.shape[1]
    dev = x_mb.device
    lanes = torch.arange(B, device=dev)
    cx = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    cy = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    i = i0.to(torch.int32)
    j = j0.to(torch.int32)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    active = i > 0
    gap = torch.tensor(GAP_BYTE, dtype=torch.uint8, device=dev)
    for it in range(max_steps):
        d = (i + j - 2).clamp(0, moves.shape[0] - 1).long()
        r = (i - 1).clamp(0, M - 1).long()
        mv = moves[d, r, lanes]
        stop = (mv & STOP_BIT) != 0
        code = mv & 3
        xc = x_mb[r, lanes]
        yc = y_bn[lanes, (j - 1).clamp(0, N - 1).long()]
        go_w = (code == MOVE_W) & ~stop
        go_n = (code == MOVE_N) & ~stop
        emit_x = torch.where(go_w, gap, xc)
        emit_y = torch.where(go_n, gap, yc)
        # A lane is active from iteration 0 until it stops, so its emission
        # slot is the loop index.
        cx[it] = torch.where(active, emit_x, 0)
        cy[it] = torch.where(active, emit_y, 0)
        steps = torch.where(active, steps + 1, steps)
        pos = torch.where(active & stop, j, pos)
        di = torch.where(go_w, 0, 1).to(torch.int32)
        dj = torch.where(go_n, 0, 1).to(torch.int32)
        i = torch.where(active & ~stop, i - di, i)
        j = torch.where(active & ~stop, j - dj, j)
        active = active & ~stop
    return pos, cx, cy, steps


def _walk_moves_affine_plain(moves, x_mb, y_bn, i0, j0, max_steps: int):
    M, B = x_mb.shape
    N = y_bn.shape[1]
    dev = x_mb.device
    lanes = torch.arange(B, device=dev)
    cx = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    cy = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    i = i0.to(torch.int32)
    j = j0.to(torch.int32)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    state = torch.zeros(B, dtype=torch.int32, device=dev)  # 0 = H, 1 = E run, 2 = F run
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    active = i > 0
    gap = torch.tensor(GAP_BYTE, dtype=torch.uint8, device=dev)
    for it in range(max_steps):
        d = (i + j - 2).clamp(0, moves.shape[0] - 1).long()
        r = (i - 1).clamp(0, M - 1).long()
        mv = moves[d, r, lanes]
        hsrc = (mv & 3).to(torch.int32)
        e_ext = (mv & E_EXT_BIT) != 0
        f_ext = (mv & F_EXT_BIT) != 0
        in_h = state == 0
        # In a run the op is the run; the cell's H source is ignored.
        op = torch.where(in_h, hsrc, state)
        # Only the H state stops: on H_ZERO, or at the i = 0 / j = 0 boundary.
        stop = in_h & ((hsrc == H_ZERO) | (i <= 0) | (j <= 0))
        emitting = active & ~stop
        nw = emitting & (op == H_NW)
        go_w = emitting & (op == H_E)
        go_n = emitting & (op == H_F)
        xc = x_mb[r, lanes]
        yc = y_bn[lanes, (j - 1).clamp(0, N - 1).long()]
        cx[it] = torch.where(emitting, torch.where(go_w, gap, xc), 0)
        cy[it] = torch.where(emitting, torch.where(go_n, gap, yc), 0)
        steps = torch.where(emitting, steps + 1, steps)
        pos = torch.where(nw, j, pos)  # the j of the last NW emission
        state = torch.where(
            nw, 0,
            torch.where(go_w, torch.where(e_ext, 1, 0),
                        torch.where(go_n, torch.where(f_ext, 2, 0), state)),
        ).to(torch.int32)
        i = i - (nw | go_n).to(torch.int32)
        j = j - (nw | go_w).to(torch.int32)
        active = active & ~stop
    return pos, cx, cy, steps


def _launch_walk(name, moves, x_mb, y_bn, i0, j0, max_steps):
    """Shared K3/K10 launch of the entry point ``name`` on the current
    stream, no sync; outputs allocated here."""
    if moves.dtype != torch.uint8 or x_mb.dtype != torch.uint8 or y_bn.dtype != torch.uint8:
        raise TypeError("moves, x_mb and y_bn must be uint8")
    D, M, B = moves.shape
    N = y_bn.shape[1]
    if x_mb.shape != (M, B) or y_bn.shape[0] != B or i0.shape != (B,) or j0.shape != (B,):
        raise ValueError(f"{name}: inconsistent shapes")
    dev = x_mb.device
    moves, x_mb, y_bn = moves.contiguous(), x_mb.contiguous(), y_bn.contiguous()
    i0 = i0.to(torch.int32).contiguous()
    j0 = j0.to(torch.int32).contiguous()
    pos = torch.empty(B, dtype=torch.int32, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev)
    cx = torch.empty((max_steps, B), dtype=torch.uint8, device=dev)
    cy = torch.empty((max_steps, B), dtype=torch.uint8, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            moves.data_ptr(), x_mb.data_ptr(), y_bn.data_ptr(), i0.data_ptr(),
            j0.data_ptr(), D, M, N, B, int(max_steps), pos.data_ptr(),
            cx.data_ptr(), cy.data_ptr(), steps.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, name)
    return pos, cx, cy, steps


def walk_moves(moves, x_mb, y_bn, i0, j0, *, max_steps: int):
    """Walk B lanes from their 1-based argmax cells (i0, j0).

    moves (D, M, B) uint8 codes, x_mb (M, B) uint8 reads, y_bn (B, N) uint8
    refs, i0/j0 (B,) int32; lanes with i0 == 0 are skipped. Returns pos (B,)
    int32, cx/cy (max_steps, B) uint8 NUL-padded reversed consensus, steps
    (B,) int32. The counter ``walk_moves.launches`` counts K3 launches.
    """
    if device_of(moves, x_mb, y_bn, i0, j0).type == "cpu":
        return _walk_moves_plain(moves, x_mb, y_bn, i0, j0, max_steps)
    out = _launch_walk("pgs_walk_moves", moves, x_mb, y_bn, i0, j0, max_steps)
    walk_moves.launches += 1
    return out


walk_moves.launches = 0


def walk_moves_affine(moves, x_mb, y_bn, i0, j0, *, max_steps: int):
    """The affine walk over K7/K9's move bytes: the arguments and returns of
    ``walk_moves``. Each lane is in state H, an E (west gap) run or an F
    (north gap) run; it stops only in H, on H_ZERO or at i <= 0 or j <= 0,
    and pos is the j of its last NW emission. The counter
    ``walk_moves_affine.launches`` counts K10 launches."""
    if device_of(moves, x_mb, y_bn, i0, j0).type == "cpu":
        return _walk_moves_affine_plain(moves, x_mb, y_bn, i0, j0, max_steps)
    out = _launch_walk("pgs_walk_moves_affine", moves, x_mb, y_bn, i0, j0, max_steps)
    walk_moves_affine.launches += 1
    return out


walk_moves_affine.launches = 0


def new_strip_state(i0, j0, max_steps: int, affine: bool = False):
    """The walk's per-lane state before the top strip, as
    wavefront_pallas.py:2723-2728 builds it: (i, j, pos, active, steps, cx,
    cy) -- i, j the argmax cell, pos = steps = 0, active where i > 0, and
    (max_steps, B) NUL consensus buffers. ``affine`` appends the gap state
    (B,) int32, 0 = H, 1 = E run, 2 = F run, all H to start
    (wavefront_pallas.py:2823-2830)."""
    i = i0.to(torch.int32).clone()
    z = torch.zeros_like(i)
    buf = torch.zeros((max_steps, i.shape[0]), dtype=torch.uint8, device=i.device)
    state = (i, j0.to(torch.int32).clone(), z, i > 0, z.clone(), buf, buf.clone())
    return (*state, z.clone()) if affine else state


def _check_strip_state(moves, x_mb, y_bn, state, max_steps: int):
    """Raise unless the strip walk's kernel (K14, K18) takes these tensors:
    uint8 (G, B, N, 256) moves, 16-byte aligned, (M, B) and (B, N)
    sequences, and the state of ``new_strip_state``, all contiguous."""
    if moves.dtype != torch.uint8 or x_mb.dtype != torch.uint8 or y_bn.dtype != torch.uint8:
        raise TypeError("moves, x_mb and y_bn must be uint8")
    i, j, pos, active, steps, cx, cy, *g = state
    _, B, N, S = moves.shape
    if (S != STRIP_S or y_bn.shape != (B, N) or x_mb.shape[1] != B or active.dtype != torch.bool
            or cx.shape != (max_steps, B) or cy.shape != (max_steps, B)
            or not all(t.is_contiguous() for t in (moves, x_mb, y_bn, *state))
            or moves.data_ptr() % 16
            or any(t.dtype != torch.int32 or t.shape != (B,) for t in (i, j, pos, steps, *g))):
        raise ValueError("strip walk: inconsistent shapes, types or layout")


def _walk_strip_plain(moves, x_mb, y_bn, base: int, state, max_steps: int):
    B, N, S = moves.shape
    M = x_mb.shape[0]
    i, j, pos, active, steps, cx, cy = state
    lanes = torch.arange(B, device=moves.device)
    gap = torch.tensor(GAP_BYTE, dtype=torch.uint8, device=moves.device)
    for _ in range(S + N):  # the kernel's cap: no walk inside a strip takes more
        inlevel = active & (i - 1 >= base)
        if not bool(inlevel.any()):
            break
        c = (j - 1).clamp(0, N - 1).long()
        mv = moves[lanes, c, (i - 1 - base).clamp(0, S - 1).long()]
        stop = (mv & STOP_BIT) != 0
        code = mv & 3
        go_w = (code == MOVE_W) & ~stop
        go_n = (code == MOVE_N) & ~stop
        emit_x = torch.where(go_w, gap, x_mb[(i - 1).clamp(0, M - 1).long(), lanes])
        emit_y = torch.where(go_n, gap, y_bn[lanes, c])
        put = inlevel & (steps < max_steps)  # emissions past max_steps drop
        cx[steps[put].long(), lanes[put]] = emit_x[put]
        cy[steps[put].long(), lanes[put]] = emit_y[put]
        steps += inlevel.to(torch.int32)
        pos.copy_(torch.where(inlevel & stop, j, pos))
        move = inlevel & ~stop
        i -= (move & ~go_w).to(torch.int32)
        j -= (move & ~go_n).to(torch.int32)
        active &= ~(inlevel & stop)
    return state


def _walk_strip_affine_plain(moves, x_mb, y_bn, base: int, state, max_steps: int):
    B, N, S = moves.shape
    M = x_mb.shape[0]
    i, j, pos, active, steps, cx, cy, g = state
    lanes = torch.arange(B, device=moves.device)
    gap = torch.tensor(GAP_BYTE, dtype=torch.uint8, device=moves.device)
    for _ in range(S + N):  # the kernel's cap, as in _walk_strip_plain
        inlevel = active & (i - 1 >= base)
        if not bool(inlevel.any()):
            break
        c = (j - 1).clamp(0, N - 1).long()
        mv = moves[lanes, c, (i - 1 - base).clamp(0, S - 1).long()]
        hsrc = (mv & 3).to(torch.int32)
        in_h = g == 0
        op = torch.where(in_h, hsrc, g)  # in a run the op is the run
        # Only the H state stops, without emitting: on H_ZERO, or at j <= 0.
        stop = inlevel & in_h & ((hsrc == H_ZERO) | (j <= 0))
        emitting = inlevel & ~stop
        nw = emitting & (op == H_NW)
        go_w = emitting & (op == H_E)
        go_n = emitting & (op == H_F)
        emit_x = torch.where(go_w, gap, x_mb[(i - 1).clamp(0, M - 1).long(), lanes])
        emit_y = torch.where(go_n, gap, y_bn[lanes, c])
        put = emitting & (steps < max_steps)  # emissions past max_steps drop
        cx[steps[put].long(), lanes[put]] = emit_x[put]
        cy[steps[put].long(), lanes[put]] = emit_y[put]
        steps += emitting.to(torch.int32)
        pos.copy_(torch.where(nw, j, pos))  # the j of the last NW emission
        e_run = torch.where((mv & E_EXT_BIT) != 0, 1, 0)
        f_run = torch.where((mv & F_EXT_BIT) != 0, 2, 0)
        g.copy_(torch.where(nw, 0, torch.where(go_w, e_run, torch.where(go_n, f_run, g))))
        i -= (nw | go_n).to(torch.int32)
        j -= (nw | go_w).to(torch.int32)
        active &= ~stop
    return state


def _walk_strip_group_plain(moves, x_mb, y_bn, low: int, state, max_steps: int):
    """The group walk's plain version: ``_walk_strip_plain`` over strips low
    + G - 1 down to low of moves (G, B, N, STRIP_S), top first."""
    for g in range(moves.shape[0] - 1, -1, -1):
        _walk_strip_plain(moves[g], x_mb, y_bn, (low + g) * STRIP_S, state, max_steps)
    return state


def _walk_strip_group_affine_plain(moves, x_mb, y_bn, low: int, state, max_steps: int):
    """``_walk_strip_group_plain`` under affine gaps, over
    ``_walk_strip_affine_plain``."""
    for g in range(moves.shape[0] - 1, -1, -1):
        _walk_strip_affine_plain(moves[g], x_mb, y_bn, (low + g) * STRIP_S, state, max_steps)
    return state


def walk_shape(B: int):
    """The walks' launch shape for B lanes on the current CUDA device, by the
    kernels' rule: {'tile_rows', 'tile_cols' (K14/K18's tile), 'lanes' (a
    block), 'blocks', 'smem' (K14/K18's bytes a block), 'seg_rows', 'band'
    (K3/K10's gathered band segment: its rows, and its columns each side of
    the diagonal)}; launches nothing."""
    out = (ctypes.c_int * 7)()
    lib = _build.load()
    _build.check(lib.pgs_walk_shape(int(B), ctypes.addressof(out)), "pgs_walk_shape")
    return dict(zip(("tile_rows", "tile_cols", "lanes", "blocks", "smem", "seg_rows", "band"),
                    out))


def _launch_strip_walk(counter, moves, x_mb, y_bn, base: int, state, max_steps: int):
    """One launch of K14 (a 7-tensor state) or K18 (8, the gap state last)
    over the G strips of moves (G, B, N, STRIP_S), strip g starting at row
    base + g * STRIP_S; adds one to ``counter.launches`` and G to
    ``counter.strips``."""
    _check_strip_state(moves, x_mb, y_bn, state, max_steps)
    i, j, pos, active, steps, cx, cy, *g = state
    G, B, N, _ = moves.shape
    dev = moves.device
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pgs_walk_strip_group(
            moves.data_ptr(), x_mb.data_ptr(), y_bn.data_ptr(), x_mb.shape[0], N, B, G,
            int(base), int(max_steps), i.data_ptr(), j.data_ptr(), pos.data_ptr(),
            active.data_ptr(), steps.data_ptr(), g[0].data_ptr() if g else None,
            cx.data_ptr(), cy.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "pgs_walk_strip_group")
    counter.launches += 1
    counter.strips += G
    return state


def walk_strip_level(moves, x_mb, y_bn, base: int, state, *, max_steps: int):
    """Advance the walk through one strip of STRIP_S rows starting at row
    ``base`` (0-based): the counterpart of traceback.py:167-218.

    moves (B, N, STRIP_S) uint8 from ``strips_cuda.strip_moves``, x_mb (M, B)
    and y_bn (B, N) uint8, ``state`` from ``new_strip_state``, updated in
    place and returned. Each active lane whose row lies in the strip walks
    K3's rule until it stops (pos = j) or leaves the strip; its k-th
    emission goes to row k of cx/cy, dropped past max_steps while steps goes
    on counting. On CUDA tensors the G = 1 launch of K14. The counter
    ``walk_strip_level.launches`` counts every K14 launch, the group walk's
    too, and ``walk_strip_level.strips`` the strips those launches walked."""
    if device_of(moves, x_mb, y_bn, *state).type == "cpu":
        return _walk_strip_plain(moves, x_mb, y_bn, base, state, max_steps)
    return _launch_strip_walk(walk_strip_level, moves.unsqueeze(0), x_mb, y_bn, base, state,
                              max_steps)


walk_strip_level.launches = 0
walk_strip_level.strips = 0


def walk_strip_group(moves, x_mb, y_bn, low: int, state, *, max_steps: int):
    """K14 over a replay group: ``walk_strip_level`` through strips low + G
    - 1 down to low of moves (G, B, N, STRIP_S) (``strips_cuda.
    strip_moves_group``'s buffer), top first, in one launch, each strip
    capped as the per-strip walk caps it, so that the state equals G
    per-strip walks'. Counts its launches, and into
    ``walk_strip_level.launches`` and ``.strips``."""
    if device_of(moves, x_mb, y_bn, *state).type == "cpu":
        return _walk_strip_group_plain(moves, x_mb, y_bn, low, state, max_steps)
    _launch_strip_walk(walk_strip_level, moves, x_mb, y_bn, low * STRIP_S, state, max_steps)
    walk_strip_group.launches += 1
    return state


walk_strip_group.launches = 0


def walk_strip_level_affine(moves, x_mb, y_bn, base: int, state, *, max_steps: int):
    """Advance the affine walk through one strip of STRIP_S rows starting at
    row ``base`` (0-based): the counterpart of traceback.py:221-286.

    moves (B, N, STRIP_S) uint8 affine bytes from
    ``strips_cuda.strip_affine_moves``; ``state`` from ``new_strip_state(...,
    affine=True)``, its gap state carried from strip to strip (a gap run
    crossing a strip edge resumes in the next), updated in place and
    returned. Each active lane whose row lies in the strip walks K10's rule
    until it stops (in the H state, on H_ZERO or at j <= 0, emitting
    nothing) or leaves the strip; emissions go to the lane's step slot and
    drop past max_steps. On CUDA tensors the G = 1 launch of K18. The
    counters ``walk_strip_level_affine.launches`` and ``.strips`` count
    every K18 launch and the strips it walked, the group walk's too."""
    if device_of(moves, x_mb, y_bn, *state).type == "cpu":
        return _walk_strip_affine_plain(moves, x_mb, y_bn, base, state, max_steps)
    return _launch_strip_walk(walk_strip_level_affine, moves.unsqueeze(0), x_mb, y_bn, base,
                              state, max_steps)


walk_strip_level_affine.launches = 0
walk_strip_level_affine.strips = 0


def walk_strip_group_affine(moves, x_mb, y_bn, low: int, state, *, max_steps: int):
    """K18 over a replay group: ``walk_strip_group`` under affine gaps, the
    gap state carried across the group's strip edges. Counts its launches,
    and into ``walk_strip_level_affine.launches`` and ``.strips``."""
    if device_of(moves, x_mb, y_bn, *state).type == "cpu":
        return _walk_strip_group_affine_plain(moves, x_mb, y_bn, low, state, max_steps)
    _launch_strip_walk(walk_strip_level_affine, moves, x_mb, y_bn, low * STRIP_S, state,
                       max_steps)
    walk_strip_group_affine.launches += 1
    return state


walk_strip_group_affine.launches = 0


def decode_consensus(cx, cy, steps) -> List[Tuple[str, str]]:
    """Host buffers -> per-lane (consensus_x, consensus_y) strings: one
    transpose and one bytes->str decode per buffer, then B slices (latin-1
    is an exact byte passthrough; the NUL padding is sliced off)."""
    cx = np.ascontiguousarray(np.asarray(cx).T)
    cy = np.ascontiguousarray(np.asarray(cy).T)
    S = cx.shape[1]
    sx = cx.tobytes().decode("latin-1")
    sy = cy.tobytes().decode("latin-1")
    return [
        (sx[b * S : b * S + k], sy[b * S : b * S + k])
        for b, k in enumerate(np.asarray(steps).tolist())
    ]
