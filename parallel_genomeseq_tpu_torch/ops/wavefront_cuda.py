"""Wrappers of the CUDA score kernels K1 and K2 (``csrc/wavefront.cu``).

K1 ``sw_score`` ports the Pallas kernel B1 (``_kernel_uniform``, TPU
``ops/wavefront_pallas.py:160`` via ``_call_uniform`` :924); K2
``sw_score_moves`` ports B2 (``_kernel_uniform_moves`` :535 via
``_call_uniform_moves`` :596). Both take the JAX package's batch-first
layout -- xs (B, M), ys (B, N) uint8 padded with X_PAD / Y_PAD, m, n (B,)
int32 -- and return per-lane int32 (score, i, j); K2 also returns the
(M + N - 1, M, B) uint8 move codes. A lane length beyond the padded shape
is clamped to it (m_b <= M, n_b <= N) on both routes.

Route: tensors on the CPU take the plain PyTorch version (``ops/scan_dp``);
tensors on a CUDA device launch the kernel, and a missing toolkit or a failed
build or launch raises. Each wrapper's ``launches`` counts kernel launches
only.
"""

from __future__ import annotations

import torch

from . import _build
from .scan_dp import sw_score_moves_plain, sw_score_plain


def _check_inputs(xs, ys, m, n):
    if xs.dtype != torch.uint8 or ys.dtype != torch.uint8:
        raise TypeError("xs and ys must be uint8")
    if m.dtype != torch.int32 or n.dtype != torch.int32:
        raise TypeError("m and n must be int32")
    if xs.dim() != 2 or ys.dim() != 2 or xs.shape[0] != ys.shape[0]:
        raise ValueError(f"expected xs (B, M) and ys (B, N), got {tuple(xs.shape)}, {tuple(ys.shape)}")
    if m.shape != (xs.shape[0],) or n.shape != (xs.shape[0],):
        raise ValueError("m and n must have shape (B,)")
    devs = {t.device for t in (xs, ys, m, n)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = xs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch(xs, ys, m, n, *, match, mismatch, gap, track_pos, moves):
    """Shared K1/K2 launch: lane-fastest copies of the inputs, scratch and
    outputs allocated here, kernel on the current stream, no sync."""
    B, M = xs.shape
    N = ys.shape[1]
    dev = xs.device
    lib = _build.load()
    x_mb = xs.T.contiguous()
    y_nb = ys.T.contiguous()
    m = m.contiguous()
    n = n.contiguous()
    hcol = torch.empty((M, B), dtype=torch.int32, device=dev)
    score, bi, bj = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pgs_sw_score(
            x_mb.data_ptr(), y_nb.data_ptr(), m.data_ptr(), n.data_ptr(),
            hcol.data_ptr(), M, N, B, int(match), int(mismatch), int(gap),
            int(track_pos), score.data_ptr(), bi.data_ptr(), bj.data_ptr(),
            moves.data_ptr() if moves is not None else None, stream,
        )
    _build.check(err, "pgs_sw_score")
    return score, bi, bj


def sw_score(xs, ys, m, n, *, match: int, mismatch: int, gap: int,
             track_pos: bool = True):
    """K1: per-lane (score, i, j) int32, column-major argmax tie-break;
    track_pos=False is the score-only sweep and returns i = j = 0 (as
    wavefront_pallas.py:3171-3175 does)."""
    dev = _check_inputs(xs, ys, m, n)
    if dev.type == "cpu":
        return sw_score_plain(
            xs, ys, m, n, match=match, mismatch=mismatch, gap=gap,
            track_pos=track_pos,
        )
    out = _launch(
        xs, ys, m, n, match=match, mismatch=mismatch, gap=gap,
        track_pos=track_pos, moves=None,
    )
    sw_score.launches += 1
    return out


sw_score.launches = 0


def sw_score_moves(xs, ys, m, n, *, match: int, mismatch: int, gap: int):
    """K2: K1's (score, i, j) plus (M + N - 1, M, B) uint8 move/stop codes.
    Only cells inside each lane's m_b x n_b matrix are written; the rest of
    the moves tensor is left uninitialised (the walk never reads it)."""
    dev = _check_inputs(xs, ys, m, n)
    if dev.type == "cpu":
        return sw_score_moves_plain(
            xs, ys, m, n, match=match, mismatch=mismatch, gap=gap
        )
    B, M = xs.shape
    N = ys.shape[1]
    moves = torch.empty((M + N - 1, M, B), dtype=torch.uint8, device=dev)
    score, bi, bj = _launch(
        xs, ys, m, n, match=match, mismatch=mismatch, gap=gap,
        track_pos=True, moves=moves,
    )
    sw_score_moves.launches += 1
    return score, bi, bj, moves


sw_score_moves.launches = 0
