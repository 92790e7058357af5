"""Needleman-Wunsch (global) DP on the card: the port of the JAX package's
``ops/global_dp.py`` (:33-110).

``nw_lastrow`` computes the last NW row H(m_b, j), j = 0..n_b, of B ragged
lanes: no zero floor, the boundary row and column seeded with gap costs, a
linear gap (the recurrence of ``oracle.nw_matrix``). On CPU tensors it runs
the plain PyTorch version below, the JAX ``_nw_lastrow_scan`` (:33) line for
line with ``torch.cummax`` for ``lax.cummax``; on CUDA tensors it launches
K25 (``csrc/global_dp.cu``), a block a lane that sweeps the rows with a
block-wide max-scan, and raises if the kernel does not build or launch.
``nw_lastrow_batch`` and ``nw_score_batch`` are the JAX functions (:81,
:107) over ragged lists. The JAX power-of-two shape buckets (:74) are a
compile cache and not ported: the kernel's loops stop at each lane's true
lengths.

Global alignment here is linear-gap only, as the JAX ``_nw_lastrow_scan``
and ``oracle.nw_matrix`` are (they ignore ``gap_open``): an affine config
raises ``ValueError`` rather than giving another answer, and a non-integral
one raises through ``engine.check_supported`` (ROADMAP A2).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.config import ScoringConfig
from ..utils.device import device_of, resolve_device, to_host
from . import _build
from .engine import check_supported
from .oracle import _as_bytes

def scratch_ints(N: int, B: int) -> int:
    """The int32 global scratch K25 needs for B lanes of reference width N,
    by the kernel's own rule: 0 when a lane's two rows and reference bytes
    fit in its shared memory."""
    out = ctypes.c_longlong()
    _build.check(_build.load().pgs_nw_scratch_ints(N, B, ctypes.byref(out)),
                 "pgs_nw_scratch_ints")
    return out.value


def check_config(cfg: ScoringConfig):
    """Raise for what global alignment does not run: an affine config
    (ValueError; the JAX functions ignore gap_open), and through
    ``check_supported`` a non-integral or sat_uint8 one."""
    if cfg.is_affine:
        raise ValueError(
            "global (NW / Hirschberg) alignment is linear-gap only: the JAX "
            f"reference ignores gap_open, got gap_open={cfg.gap_open}"
        )
    check_supported(cfg)


def byte_table(cfg: ScoringConfig, device) -> torch.Tensor:
    """``cfg``'s (256, 256) score table over raw bytes, int32 on ``device``."""
    check_config(cfg)
    return torch.from_numpy(cfg.byte_table().astype(np.int32)).to(device)


def nw_lastrow_plain(x, y, m, n, *, table, gap: int):
    """The JAX row scan: a loop over the rows, each row's west-gap chain
    one ``cummax`` of u(j) + gap * j; row m_b kept for lane b. Rows past
    every lane's m are not swept (none would be kept)."""
    B, N = y.shape
    dev = y.device
    gj = gap * torch.arange(N + 1, dtype=torch.int32, device=dev)[None, :]
    prev = (-gj).expand(B, N + 1).clone()
    m = m.to(device=dev, dtype=torch.int32).clamp(0, x.shape[1])
    n = n.to(device=dev, dtype=torch.int32).clamp(0, N)
    last = prev.clone()
    yl = y.long()
    flat = table.reshape(-1)
    for i in range(1, int(m.max()) + 1 if B else 1):
        s = flat[x[:, i - 1].long()[:, None] * 256 + yl]  # (B, N)
        u = torch.empty_like(prev)
        u[:, 0] = -gap * i
        u[:, 1:] = torch.maximum(prev[:, :-1] + s, prev[:, 1:] - gap)
        prev = torch.cummax(u + gj, dim=1).values - gj
        last = torch.where((m == i)[:, None], prev, last)
    cols = torch.arange(N + 1, device=dev)[None, :]
    return torch.where(cols <= n[:, None], last, 0).to(torch.int32)


def _launch(x, y, m, n, table, gap):
    if x.dtype != torch.uint8 or y.dtype != torch.uint8:
        raise TypeError("x and y must be uint8")
    if table.dtype != torch.int32 or table.shape != (256, 256):
        raise TypeError("table must be (256, 256) int32")
    B, M = x.shape
    N = y.shape[1]
    if y.shape[0] != B or m.shape != (B,) or n.shape != (B,):
        raise ValueError("nw_lastrow: inconsistent shapes")
    dev = x.device
    x, y, table = x.contiguous(), y.contiguous(), table.contiguous()
    m = m.to(torch.int32).contiguous()
    n = n.to(torch.int32).contiguous()
    out = torch.empty((B, N + 1), dtype=torch.int32, device=dev)
    ints = scratch_ints(N, B)
    scratch = torch.empty(ints, dtype=torch.int32, device=dev) if ints else None
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pgs_nw_lastrow(
            x.data_ptr(), y.data_ptr(), m.data_ptr(), n.data_ptr(), M, N, B,
            table.data_ptr(), int(gap), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "pgs_nw_lastrow")
    return out


def nw_lastrow(x, y, m, n, *, table, gap: int):
    """K25: the last NW row of B lanes. x (B, M) and y (B, N) uint8, m, n (B,)
    int32 true lengths, table (256, 256) int32 over raw bytes, the linear gap.
    Returns (B, N + 1) int32: H(m_b, j) for j <= n_b, 0 past it (a lane with
    m_b = 0 gets row 0, -gap * j). The counter ``nw_lastrow.launches``
    counts K25 launches."""
    if device_of(x, y, m, n, table).type == "cpu":
        return nw_lastrow_plain(x, y, m, n, table=table, gap=gap)
    out = _launch(x, y, m, n, table, gap)
    nw_lastrow.launches += 1
    return out


nw_lastrow.launches = 0


def pack_lanes(xs, ys, device):
    """Ragged lists of strings or byte arrays -> (x (B, M), y (B, N) uint8
    zero-padded, m, n (B,) int32) on ``device``, M and N the longest (at
    least 1)."""
    xb = [_as_bytes(v) for v in xs]
    yb = [_as_bytes(v) for v in ys]
    B = len(xb)
    x = np.zeros((B, max([1] + [len(v) for v in xb])), np.uint8)
    y = np.zeros((B, max([1] + [len(v) for v in yb])), np.uint8)
    for k, (a, c) in enumerate(zip(xb, yb)):
        x[k, : len(a)] = a
        y[k, : len(c)] = c
    m = np.array([len(v) for v in xb], np.int32)
    n = np.array([len(v) for v in yb], np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, y, m, n))


def nw_lastrow_batch(xs, ys, cfg: ScoringConfig = ScoringConfig(), device=None, table=None):
    """Last NW rows for a ragged batch (global_dp.py:81): xs/ys are lists of
    byte arrays or strings; returns a list of numpy (len(ys[k]) + 1,) int32
    vectors. One K25 launch (or the plain version on the CPU), one fetch.
    ``table`` is ``byte_table(cfg, device)`` when the caller holds one."""
    check_config(cfg)
    dev = resolve_device(device)
    x, y, m, n = pack_lanes(xs, ys, dev)
    if table is None:
        table = byte_table(cfg, dev)
    last, n = to_host([nw_lastrow(x, y, m, n, table=table, gap=int(cfg.gap_penalty)), n])
    return [last[k, : n[k] + 1] for k in range(len(n))]


def nw_score_batch(xs, ys, cfg: ScoringConfig = ScoringConfig(), device=None, table=None):
    """Global alignment scores H(m, n) for a ragged batch (global_dp.py:107)."""
    rows = nw_lastrow_batch(xs, ys, cfg, device, table)
    return np.array([r[-1] for r in rows])
