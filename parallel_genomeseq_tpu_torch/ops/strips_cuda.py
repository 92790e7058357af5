"""Wrappers of the CUDA long-read (strip) kernels K11, K12 and K13
(``csrc/strips.cu``): uniform match/mismatch scoring, linear gaps, reads of
any length.

K11 ``sw_score_strips`` ports the Pallas kernel B9 (``_kernel_strips``, TPU
``ops/wavefront_pallas.py:1073`` via ``_call_strips`` :1347); K12
``sw_score_strips_ckpt`` ports B13 (``_kernel_strips_ckpt`` :1134 via
``_call_strips_ckpt`` :1550); K13 ``strip_moves`` ports B17
(``_kernel_strip_moves`` :1792 via ``_call_strip_moves`` :1840). They take
the JAX package's batch-first layout -- xs (B, M), ys (B, N) uint8 padded
with X_PAD / Y_PAD, m, n (B,) int32, clamped to M and N -- and keep int32
boundary rows: the int16 rows, hi/lo pairs, ``INT16_BOUND`` envelope and
slot-packed argmax of the TPU kernels are not ported.

Route: tensors on the CPU take the plain PyTorch versions (``ops/scan_dp``:
``sw_score_plain``, ``sw_score_ckpt_plain``, ``strip_moves_plain``); tensors
on a CUDA device launch the kernel, and a missing toolkit or a failed build
or launch raises. Each wrapper's ``launches`` counts kernel launches only.
"""

from __future__ import annotations

import torch

from . import _build
from .scan_dp import STRIP_S, strip_moves_plain, sw_score_ckpt_plain, sw_score_plain
from .wavefront_cuda import _check_inputs

# Rows one K11/K12 block sweeps in a pass (kMaxThreads x kBand in
# csrc/strips.cu); longer reads carry a boundary row between passes.
ROWS_PER_PASS = 512 * 32


def _sweep(xs, ys, m, n, *, match, mismatch, gap, ckpt):
    """Shared K11/K12 launch on the current stream, no sync; outputs and
    scratch allocated here. Returns (score, i, j, ck or None)."""
    B, M = xs.shape
    N = ys.shape[1]
    dev = xs.device
    xs, ys, m, n = xs.contiguous(), ys.contiguous(), m.contiguous(), n.contiguous()
    score, bi, bj = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    nck = max(0, -(-M // STRIP_S) - 1)
    ck = torch.zeros((B, nck, N), dtype=torch.int32, device=dev) if ckpt else None
    bound = (torch.empty((B, N + 1), dtype=torch.int32, device=dev)
             if M > ROWS_PER_PASS else None)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pgs_strip_sweep(
            xs.data_ptr(), ys.data_ptr(), m.data_ptr(), n.data_ptr(), M, N, B,
            int(match), int(mismatch), int(gap),
            bound.data_ptr() if bound is not None else None,
            ck.data_ptr() if ck is not None and ck.numel() else None, nck,
            score.data_ptr(), bi.data_ptr(), bj.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "pgs_strip_sweep")
    return score, bi, bj, ck


def sw_score_strips(xs, ys, m, n, *, match: int, mismatch: int, gap: int):
    """K11: per-lane (score, i, j) int32 of linear uniform Smith-Waterman for
    reads of any length, column-major argmax tie-break (max score, then min
    j, then min i; (0, 0, 0) for an all-zero lane)."""
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return sw_score_plain(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap)
    out = _sweep(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap, ckpt=False)[:3]
    sw_score_strips.launches += 1
    return out


sw_score_strips.launches = 0


def sw_score_strips_ckpt(xs, ys, m, n, *, match: int, mismatch: int, gap: int):
    """K12: K11's (score, i, j) plus the checkpoint rows (B, K, N) int32, K =
    ceil(M / STRIP_S) - 1: ck[b, k, j - 1] = H((k + 1) * STRIP_S, j) with
    1-based rows, 0 outside the lane's matrix."""
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return sw_score_ckpt_plain(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap)
    out = _sweep(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap, ckpt=True)
    sw_score_strips_ckpt.launches += 1
    return out


sw_score_strips_ckpt.launches = 0


def strip_moves(xs, ys, m, n, rowin, base: int, *, match: int, mismatch: int, gap: int):
    """K13: the move codes of the STRIP_S rows [base, base + STRIP_S) of xs
    (B, M) against ys (B, N), replayed from ``rowin`` (B, N) int32, the H of
    row ``base`` for j = 1..N (a slice of K12's checkpoints; None for the
    first strip). Returns (B, N, STRIP_S) uint8, moves[b, j - 1, r] the code
    of cell (base + r + 1, j) (``scan_dp.MOVE_*`` and ``STOP_BIT``); columns
    past a lane's n are left unwritten."""
    dev = _check_inputs(xs, ys, m, n)
    if base % STRIP_S or base < 0:
        raise ValueError(f"base must be a non-negative multiple of {STRIP_S}, got {base}")
    if rowin is not None and (rowin.dtype != torch.int32 or rowin.shape != ys.shape
                              or rowin.stride(1) != 1 or rowin.device != dev):
        raise ValueError("rowin must be a (B, N) int32 row-contiguous tensor beside ys")
    if dev.type == "cpu":
        return strip_moves_plain(xs, ys, m, n, rowin, base, match=match, mismatch=mismatch,
                                 gap=gap)
    B, M = xs.shape
    N = ys.shape[1]
    xs, ys, m, n = xs.contiguous(), ys.contiguous(), m.contiguous(), n.contiguous()
    moves = torch.empty((B, N, STRIP_S), dtype=torch.uint8, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pgs_strip_moves(
            xs.data_ptr(), ys.data_ptr(), m.data_ptr(), n.data_ptr(), M, N, B, base,
            rowin.data_ptr() if rowin is not None else None,
            rowin.stride(0) if rowin is not None else 0,
            int(match), int(mismatch), int(gap), moves.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "pgs_strip_moves")
    strip_moves.launches += 1
    return moves


strip_moves.launches = 0
