"""Batched greedy traceback over the forward sweep's move codes.

``walk_moves`` is the counterpart of the JAX package's ``ops/traceback.py``
``walk_moves`` (:30-89): on CPU tensors it runs the plain PyTorch loop below,
line for line the JAX body; on CUDA tensors it launches the K3 kernel
(``csrc/traceback.cu``), one thread per lane, since the eager loop would be
about fifteen launches per step. ``decode_consensus`` is copied from
traceback.py:289-307 and stays numpy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import _build
from .scan_dp import MOVE_N, MOVE_W, STOP_BIT

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


def walk_moves(moves, x_mb, y_bn, i0, j0, *, max_steps: int):
    """Walk B lanes from their 1-based argmax cells (i0, j0).

    moves (D, M, B) uint8 codes, x_mb (M, B) uint8 reads, y_bn (B, N) uint8
    refs, i0/j0 (B,) int32; lanes with i0 == 0 are skipped. Returns pos (B,)
    int32, cx/cy (max_steps, B) uint8 NUL-padded reversed consensus, steps
    (B,) int32. The counter ``walk_moves.launches`` counts K3 launches.
    """
    tensors = (moves, x_mb, y_bn, i0, j0)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = x_mb.device
    if dev.type == "cpu":
        return _walk_moves_plain(moves, x_mb, y_bn, i0, j0, max_steps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if moves.dtype != torch.uint8 or x_mb.dtype != torch.uint8 or y_bn.dtype != torch.uint8:
        raise TypeError("moves, x_mb and y_bn must be uint8")
    D, M, B = moves.shape
    N = y_bn.shape[1]
    if x_mb.shape != (M, B) or y_bn.shape[0] != B or i0.shape != (B,) or j0.shape != (B,):
        raise ValueError("walk_moves: inconsistent shapes")
    moves, x_mb, y_bn = moves.contiguous(), x_mb.contiguous(), y_bn.contiguous()
    i0 = i0.to(torch.int32).contiguous()
    j0 = j0.to(torch.int32).contiguous()
    pos = torch.empty(B, dtype=torch.int32, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev)
    cx = torch.empty((max_steps, B), dtype=torch.uint8, device=dev)
    cy = torch.empty((max_steps, B), dtype=torch.uint8, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pgs_walk_moves(
            moves.data_ptr(), x_mb.data_ptr(), y_bn.data_ptr(), i0.data_ptr(),
            j0.data_ptr(), D, M, N, B, int(max_steps), pos.data_ptr(),
            cx.data_ptr(), cy.data_ptr(), steps.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "pgs_walk_moves")
    walk_moves.launches += 1
    return pos, cx, cy, steps


walk_moves.launches = 0


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
