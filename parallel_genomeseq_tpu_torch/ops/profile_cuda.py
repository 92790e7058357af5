"""Wrappers of the CUDA substitution-matrix kernels K4, K5, K8 and K9
(``csrc/profile.cu``: K4/K8; ``csrc/wavefront.cu``: K5/K9).

K4 ``sw_profile`` ports the Pallas kernel B3 (``_kernel_profile``, TPU
``ops/wavefront_pallas.py:418`` via ``_call_profile`` :984); K5
``sw_profile_moves`` ports B4 (``_kernel_profile_moves`` :815 via
``_call_profile_moves`` :874). Their affine (Gotoh) forms: K8
``sw_profile_affine`` ports B7 (``_kernel_profile_affine`` :442 via
``_call_profile_affine`` :500), K9 ``sw_profile_affine_moves`` ports B8
(``_kernel_profile_affine_moves`` :724 via ``_call_profile_affine_moves``
:779). All score compact codes (``ops/scan_dp``'s ``profile_tables``) with
an (ncodes, ncodes) int32 table and return per-lane int32 (score, i, j); K5
and K9 also return the (M + N - 1, M, B) uint8 move codes that K3 (K10 for
K9's affine bytes) walks.

K4 and K8 run the thread-group scan: g threads a lane, each holding r query
rows in registers (``scan_shape``), for queries of up to
``MAX_SCAN_M`` = 2,048 rows, with nothing in device memory but the inputs and
the per-lane results. K5 and K9 are the table-scored form of the short-read
re-run K2/K7 (``wavefront_cuda``): a warp per lane (two past 1,024 rows),
up to 32 entry rows a thread in registers, the table in shared memory, for
entries of up to ``wavefront_cuda.MAX_ROWS`` = 2,048 rows, reading xs and ys
as they are with no scratch; ``wavefront_cuda.launch_shape(..., ncodes=)``
reports their launch, and ``lanes`` / ``warps`` set it as K2's do.

Route: tensors on the CPU take the plain PyTorch version (``ops/scan_dp``);
tensors on a CUDA device launch the kernel, and a missing toolkit or a failed
build or launch raises. Each wrapper's ``launches`` counts kernel launches
only.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.device import device_of
from . import _build
from .scan_dp import sw_profile_moves_plain, sw_profile_plain
from .wavefront_cuda import _launch

MAX_CODES = 64  # the table lives in shared memory: 64 x 64 x 4 B = 16 KB
MAX_SCAN_M = 2048  # query rows of the widest scan shape, 32 threads x 64 rows
_NO_WIDTH = 2**31 - 1  # a slab has no padded width; y_len bounds each lane


def _check_common(m, n, table):
    if m.dtype != torch.int32 or n.dtype != torch.int32:
        raise TypeError("m and n must be int32")
    if m.dim() != 1 or n.shape != m.shape:
        raise ValueError("m and n must have shape (B,)")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != table.shape[1]:
        raise ValueError("table must be a square int32 tensor")
    if not 1 <= table.shape[0] <= MAX_CODES:
        raise ValueError(f"table has {table.shape[0]} codes; the kernels take 1..{MAX_CODES}")


def check_scan_inputs(x, y, m, n, table, y_off) -> torch.device:
    """Validate the inputs of a score-only profile kernel (K4, K8, and the
    strip kernel K19): x (B, M) or (M,) and y (B, N), or a 1-D slab with
    y_off (B,) int64, all uint8 codes. Returns their one device."""
    _check_common(m, n, table)
    if x.dtype != torch.uint8 or y.dtype != torch.uint8:
        raise TypeError("x and y must be uint8 codes")
    B = m.shape[0]
    if x.dim() not in (1, 2) or (x.dim() == 2 and x.shape[0] != B):
        raise ValueError(f"expected x (B, M) or (M,), got {tuple(x.shape)}")
    if y_off is None:
        if y.dim() != 2 or y.shape[0] != B:
            raise ValueError(f"expected y (B, N), got {tuple(y.shape)}")
    elif y.dim() != 1 or y_off.dtype != torch.int64 or y_off.shape != (B,):
        raise ValueError("a slab is a 1-D y with y_off (B,) int64")
    tensors = (x, y, m, n, table) + (() if y_off is None else (y_off,))
    return device_of(*tensors)


def _scores(x, y, m, n, table, gap_open, gap, y_off):
    """K4/K8 route: validate, then the plain version on the CPU or the
    thread-group scan on the card. Returns (launched, (score, i, j))."""
    dev = check_scan_inputs(x, y, m, n, table, y_off)
    if dev.type == "cpu":
        return False, sw_profile_plain(x, y, m, n, table=table, gap_open=gap_open,
                                       gap=gap, y_off=y_off)
    B, M = m.shape[0], x.shape[-1]
    if M > MAX_SCAN_M:
        raise ValueError(f"the scan kernels take queries of up to {MAX_SCAN_M} rows, got {M}; "
                         "longer ones run on strips_cuda.sw_score_strips_profile(_affine)")
    x = x.contiguous()
    if y_off is None:
        N = y.shape[1]
        y_off = torch.arange(B, dtype=torch.int64, device=dev) * N
    else:
        N = _NO_WIDTH
    y, y_off, m, n, table = (t.contiguous() for t in (y, y_off, m, n, table))
    score, bi, bj = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pgs_sw_profile_scan(
            x.data_ptr(), M if x.dim() == 2 else 0, y.data_ptr(), y_off.data_ptr(),
            y.numel(), m.data_ptr(), n.data_ptr(), table.data_ptr(), table.shape[0], M, N,
            B, int(gap_open), int(gap), score.data_ptr(), bi.data_ptr(), bj.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "pgs_sw_profile_scan")
    return True, (score, bi, bj)


def scan_shape(M: int, *, ncodes: int, affine: bool = False, shared: bool = True):
    """The K4 (``affine``: K8) launch for an M-row query on the current CUDA
    device, the query shared by every lane (the slab scan) or per lane:
    {g, r, threads (a block), blocks_per_sm (the CUDA occupancy
    calculator), profile (the shared-memory query profile, else the
    table)}. (g, r) is the shape of ``kShapes`` in ``csrc/profile.cu`` with
    the fewest rows g x r >= M. Launches nothing."""
    lib = _build.load()
    out = (ctypes.c_int * 5)()
    _build.check(lib.pgs_sw_profile_scan_shape(int(M), int(ncodes), int(affine), int(shared),
                                               ctypes.addressof(out)),
                 "pgs_sw_profile_scan_shape")
    return dict(zip(("g", "r", "threads", "blocks_per_sm", "profile"), out))


def _moves(xs, ys, m, n, table, gap_open, gap, lanes, warps):
    """K5/K9 route, as ``_scores``. Returns (launched, (score, i, j, moves))."""
    _check_common(m, n, table)
    if xs.dtype != torch.uint8 or ys.dtype != torch.uint8:
        raise TypeError("xs and ys must be uint8 codes")
    B = m.shape[0]
    if xs.dim() != 2 or ys.dim() != 2 or xs.shape[0] != B or ys.shape[0] != B:
        raise ValueError(f"expected xs (B, M) and ys (B, N), got {tuple(xs.shape)}, "
                         f"{tuple(ys.shape)}")
    dev = device_of(xs, ys, m, n, table)
    if dev.type == "cpu":
        return False, sw_profile_moves_plain(xs, ys, m, n, table=table,
                                             gap_open=gap_open, gap=gap)
    M, N = xs.shape[1], ys.shape[1]
    moves = torch.empty((M + N - 1, M, B), dtype=torch.uint8, device=dev)
    score, bi, bj = _launch(xs, ys, m, n, match=0, mismatch=0, gap_open=gap_open, gap=gap,
                            track_pos=True, moves=moves, lanes=lanes, warps=warps, table=table)
    return True, (score, bi, bj, moves)


def _check_gap_open(gap_open):
    if gap_open < 1:
        raise ValueError(f"gap_open must be >= 1 for the affine kernels, got {gap_open}")


def sw_profile(x, y, m, n, *, table, gap: int, y_off=None):
    """K4: per-lane (score, i, j) int32 of linear-gap SW over compact codes,
    column-major argmax tie-break.

    x: (B, M) uint8 codes, or (M,) codes of one query shared by every lane
    (the database scan). y: (B, N) uint8 codes, or -- with ``y_off`` (B,)
    int64 -- a flat (R,) slab in which lane b reads ``y[y_off[b] :
    y_off[b] + n[b]]``. m, n: (B,) int32 true lengths, clamped to M, N and
    to what y holds past the offset. table: (ncodes, ncodes) int32. On the
    card M <= MAX_SCAN_M (longer queries take ``strips_cuda``'s K19).
    """
    launched, out = _scores(x, y, m, n, table, 0, gap, y_off)
    sw_profile.launches += launched
    return out


sw_profile.launches = 0


def sw_profile_moves(xs, ys, m, n, *, table, gap: int, lanes: int = 0, warps: int = 0):
    """K5: K4's (score, i, j) on xs (B, M) and ys (B, N) uint8 codes plus
    (M + N - 1, M, B) uint8 move/stop codes. Only cells inside each lane's
    m_b x n_b matrix are written; the rest of the moves tensor is left
    uninitialised (the walk never reads it). ``lanes``, ``warps``: the
    lanes a block and the warps a lane on the card (0: the kernel's rules);
    on the card M <= ``wavefront_cuda.MAX_ROWS``."""
    launched, out = _moves(xs, ys, m, n, table, 0, gap, lanes, warps)
    sw_profile_moves.launches += launched
    return out


sw_profile_moves.launches = 0


def sw_profile_affine(x, y, m, n, *, table, gap_open: int, gap: int, y_off=None):
    """K8: K4 under affine (Gotoh) gaps -- a gap of length L costs gap_open
    + L * gap -- with the JAX scan's boundaries; the same arguments as K4
    (the database scan is its shared-query slab form)."""
    _check_gap_open(gap_open)
    launched, out = _scores(x, y, m, n, table, gap_open, gap, y_off)
    sw_profile_affine.launches += launched
    return out


sw_profile_affine.launches = 0


def sw_profile_affine_moves(xs, ys, m, n, *, table, gap_open: int, gap: int,
                            lanes: int = 0, warps: int = 0):
    """K9: K8's (score, i, j) on xs (B, M) and ys (B, N) uint8 codes plus
    the (M + N - 1, M, B) uint8 affine move bytes that
    ``traceback.walk_moves_affine`` walks; only in-matrix cells are
    written, as in K5; ``lanes`` and ``warps`` as there."""
    _check_gap_open(gap_open)
    launched, out = _moves(xs, ys, m, n, table, gap_open, gap, lanes, warps)
    sw_profile_affine_moves.launches += launched
    return out


sw_profile_affine_moves.launches = 0
