"""Wrappers of the CUDA long-read (strip) kernels (``csrc/strips.cu``):
uniform match/mismatch scoring or a substitution matrix, each with linear
or affine (Gotoh) gaps, reads (or queries) of any length.

Linear: K11 ``sw_score_strips`` ports the Pallas kernel B9
(``_kernel_strips``, TPU ``ops/wavefront_pallas.py:1073`` via
``_call_strips`` :1347); K12 ``sw_score_strips_ckpt`` ports B13
(``_kernel_strips_ckpt`` :1134 via ``_call_strips_ckpt`` :1550); K13
``strip_moves`` ports B17 (``_kernel_strip_moves`` :1792 via
``_call_strip_moves`` :1840). Affine: K15 ``sw_score_strips_affine`` ports
B10 (``_kernel_strips_affine`` :1102 via ``_call_strips_affine`` :1389);
K16 ``sw_score_strips_affine_ckpt`` ports B14
(``_kernel_strips_affine_ckpt`` :1147 via ``_call_strips_affine_ckpt``
:1595), checkpointing F beside H; K17 ``strip_affine_moves`` ports B18
(``_kernel_strip_affine_moves`` :1870 via ``_call_strip_affine_moves``
:1953). Substitution matrix, linear gaps: K19 ``sw_score_strips_profile``
ports B11 (``_kernel_strips_profile`` :1081 via ``_call_strips_profile``
:1434), also in B11's ``shared=True`` slab form (one query against every
entry of a resident slab, ``score_db_slab_strips_jit`` :2344); K20
``sw_score_strips_profile_ckpt`` ports B15 (``_kernel_strips_profile_ckpt``
:1642 via ``_call_strips_profile_ckpt`` :1679); K21 ``strip_profile_moves``
ports B19 (``_kernel_strip_profile_moves`` :1986 via
``_call_strip_profile_moves`` :2036). Substitution matrix, affine gaps:
K22 ``sw_score_strips_profile_affine`` ports B12
(``_kernel_strips_profile_affine`` :1116 via
``_call_strips_profile_affine`` :1493), per lane and in the slab form of
``score_db_slab_strips_jit``'s ``gopen`` branch (:2363-2367); K23
``sw_score_strips_profile_affine_ckpt`` ports B16
(``_kernel_strips_profile_affine_ckpt`` :1657 via
``_call_strips_profile_affine_ckpt`` :1734); K24
``strip_profile_affine_moves`` ports B20
(``_kernel_strip_profile_affine_moves`` :2070 via
``_call_strip_profile_affine_moves`` :2149). B12/B16/B20 sweep 128-row
strips (``STRIP_S_PA``), the port 256 (``STRIP_S``) as everywhere: no
score, cell or walk depends on it. They take the JAX package's
batch-first layout -- xs (B, M), ys (B, N) uint8 padded with X_PAD / Y_PAD
(compact codes under a matrix, ``scan_dp.profile_tables``), m, n (B,)
int32, clamped to M and N -- and keep int32 boundary rows: the int16 rows,
hi/lo pairs, ``INT16_BOUND`` and 2^30 envelopes and slot-packed argmax of
the TPU kernels are not ported. The affine boundaries are the port's full
sweep's (``scan_dp.wavefront_affine``): F = 0 above row 1 (B14/B18 and
B16/B20 start strip 0 at -(gap_open + gap + 1); the two differ only on
negative E or F, which no walk reads).

The replays K13/K17/K21/K24 are one kernel with one entry point, which
replays G strips of every lane in one launch, each only where the strip
walk can still read it: the ``*_group`` wrappers, whose G the strip
traceback takes from ``replay_group``; the per-strip wrappers are its G = 1
launch over every column. A per-strip wrapper's ``launches`` counts every
launch of its kernel, the group wrapper's too.

K27 ``sw_score_strips_parity`` is K11 in the reference-parity forms of the
JAX scan (``Semantics.SAT_UINT8``, the skewed tie; no Pallas call ports
them): ``solve_big --semantics sat_uint8``'s window sweep. Under saturation
with uniform scores and the column-major tie it takes its pair form
(``sweep_form``): a block sweeps two lanes, each thread word holding a row
of both in signed 16-bit halves; the skewed tie runs the int32 form, its
key by ``wavefront_cuda.key_rule``. ``sw_score_strips_parity.forms`` counts
its launches by form and key rule.

Route: tensors on the CPU take the plain PyTorch versions (``ops/scan_dp``:
``sw_score_plain``, ``sw_score_ckpt_plain``, ``strip_moves_plain``,
``sw_score_affine_ckpt_plain``, ``strip_affine_moves_plain``,
``sw_profile_plain``, ``sw_profile_ckpt_plain``,
``strip_profile_moves_plain``, and with gap_open ``sw_profile_plain``,
``sw_profile_affine_ckpt_plain``, ``strip_profile_affine_moves_plain``; the
group replays' ``strip_*moves_group_plain``);
tensors on a CUDA device launch the kernel, and a missing toolkit or a
failed build or launch raises. Each wrapper's ``launches`` counts kernel
launches only.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from .profile_cuda import check_scan_inputs
from .scan_dp import (
    NEG,
    STRIP_S,
    slab_lengths,
    strip_affine_moves_group_plain,
    strip_affine_moves_plain,
    strip_moves_group_plain,
    strip_moves_plain,
    strip_profile_affine_moves_group_plain,
    strip_profile_affine_moves_plain,
    strip_profile_moves_group_plain,
    strip_profile_moves_plain,
    sw_profile_affine_ckpt_plain,
    sw_profile_ckpt_plain,
    sw_profile_plain,
    sw_score_affine_ckpt_plain,
    sw_score_ckpt_plain,
    sw_score_parity_plain,
    sw_score_plain,
)
from .wavefront_cuda import _check_inputs, _count_form, pair_fits, tie_code

# Rows one block sweeps in a pass (kRowsPerPass in csrc/strips.cu), under
# linear and affine gaps alike (ROWS_PER_PASS_AFFINE is the same value, the
# name the affine gpu tests use); longer reads carry a boundary row between
# passes. A warp sweeps 32 bands of 16 or 32 rows and hands its last row to
# the next warp through a ring of SWEEP_RING columns (kRing).
ROWS_PER_PASS = ROWS_PER_PASS_AFFINE = 10_240
SWEEP_RING = 128
_NO_WIDTH = 2**31 - 1  # a slab has no padded width; its length bounds each lane


def _sweep(xs, ys, m, n, *, gap, ckpt, match=0, mismatch=0, gap_open=0, table=None,
           y_off=None, sat=False, skewed=0, pair=False):
    """Shared K11/K12 (gap_open > 0: K15/K16; a table: K19/K20; both:
    K22/K23; ``sat`` or ``skewed``, the C tie code: K27, with ``pair`` its
    pair form) launch on the current stream, no sync; outputs and scratch
    allocated here. xs is (B, M) or, shared by every lane, (M,); ys is (B,
    N) or, with ``y_off``, a flat slab. Returns (score, i, j), then with
    ckpt the H checkpoints, and under affine gaps the F ones."""
    B = m.shape[0]
    M = xs.shape[-1]
    dev = m.device
    affine = gap_open > 0
    xs, ys, m, n = xs.contiguous(), ys.contiguous(), m.contiguous(), n.contiguous()
    N = ys.shape[1] if y_off is None else _NO_WIDTH
    score, bi, bj = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    nck = max(0, -(-M // STRIP_S) - 1)
    ck = fck = None
    if ckpt:
        ck = torch.zeros((B, nck, N), dtype=torch.int32, device=dev)
        if affine:
            fck = torch.full((B, nck, N), NEG, dtype=torch.int32, device=dev)
    # The between-pass row: H, or the (H, F) pair, or (pair) a lane pair's
    # packed H; in the slab form one row of n_b + 1 per lane, back to back
    # (one sync for its size), its offsets counted in the row's elements
    # (int32, or (H, F) pairs).
    bound = bound_off = None
    if M > ROWS_PER_PASS:
        if y_off is None:
            rows = -(-B // 2) if pair else B
            bound = torch.empty((rows, N + 1, 2) if affine else (rows, N + 1),
                                dtype=torch.int32, device=dev)
        else:
            width = slab_lengths(ys.shape[0], y_off, n).long() + 1
            ends = torch.cumsum(width, 0)
            bound_off = (ends - width).contiguous()
            bound = torch.empty((int(ends[-1]), 2) if affine else int(ends[-1]),
                                dtype=torch.int32, device=dev)
    lib = _build.load()
    ptr = lambda t: t.data_ptr() if t is not None and t.numel() else None
    with torch.cuda.device(dev):
        err = lib.pgs_strip_sweep(
            xs.data_ptr(), 0 if xs.dim() == 1 else M, ys.data_ptr(), ptr(y_off), ys.numel(),
            m.data_ptr(), n.data_ptr(), M, N, B, ptr(table),
            table.shape[0] if table is not None else 0, int(match), int(mismatch),
            int(gap_open), int(gap), ptr(bound), ptr(bound_off), ptr(ck), ptr(fck), nck,
            score.data_ptr(), bi.data_ptr(), bj.data_ptr(), int(sat), int(skewed), int(pair),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "pgs_strip_sweep")
    return tuple(t for t in (score, bi, bj, ck, fck) if t is not None)


def sweep_occupancy(M: int, *, affine: bool = False, ckpt: bool = False, ncodes: int = 0,
                    parity: bool = False, pair: bool = False):
    """(threads a block, passes, resident blocks per SM, rows a thread) of
    the sweep launch for M rows on the current CUDA device: K11 (K12 with
    ``ckpt``), affine K15/K16, with ``ncodes`` > 0 (a table of that size)
    K19/K20, K22/K23, with ``parity`` K27 (``pair``: its pair form, a block
    a lane pair). Read by the CUDA occupancy calculator, as the launch
    picks its band height; launches nothing."""
    lib = _build.load()
    out = (ctypes.c_int * 4)()
    _build.check(lib.pgs_strip_sweep_occupancy(int(M), int(ckpt), int(affine), int(ncodes),
                                               int(parity), int(pair), ctypes.addressof(out)),
                 "pgs_strip_sweep_occupancy")
    return tuple(out)


def _check_gap_open(gap_open):
    if gap_open <= 0:
        raise ValueError(f"the affine strip kernels need gap_open > 0, got {gap_open}")


def sw_score_strips(xs, ys, m, n, *, match: int, mismatch: int, gap: int):
    """K11: per-lane (score, i, j) int32 of linear uniform Smith-Waterman for
    reads of any length, column-major argmax tie-break (max score, then min
    j, then min i; (0, 0, 0) for an all-zero lane)."""
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return sw_score_plain(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap)
    out = _sweep(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap, ckpt=False)
    sw_score_strips.launches += 1
    return out


sw_score_strips.launches = 0


def sweep_form(*, sat: bool, match: int, mismatch: int, gap: int, tie: str) -> str:
    """The form of a K27 launch: 'pair' (a block a lane pair, two lanes a
    word in 16-bit halves) for the column-major tie where
    ``wavefront_cuda.pair_fits`` (``solve_big --semantics sat_uint8``'s
    sweep, where it measured faster, PERF.md section 6), else 'int32' (exact
    values, and the skewed tie, whose per-column search the pair form does a
    half at a time on half the blocks)."""
    fits = pair_fits(sat=sat, match=match, mismatch=mismatch, gap=gap)
    return "pair" if fits and tie == "colmajor" else "int32"


def sw_score_strips_parity(xs, ys, m, n, *, match: int, mismatch: int, gap: int, sat: bool,
                           tie: str = "colmajor"):
    """K27: K11's per-lane (score, i, j) int32 with every H clamped at 255
    when ``sat`` (the operands of ``scan_dp.sat_operands``) and the argmax by
    ``tie``, 'colmajor' (K11's) or 'skewed' (the reference binary's raw
    key, ``scan_dp.skewed_keys``), for reads of any length. The window
    sweep of ``solve_big --semantics sat_uint8``. The form is
    ``sweep_form``'s."""
    if tie not in ("colmajor", "skewed"):
        raise ValueError(f"unknown tie {tie!r}")
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return sw_score_parity_plain(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap,
                                     sat=sat, tie=tie)
    pair = sweep_form(sat=sat, match=match, mismatch=mismatch, gap=gap, tie=tie) == "pair"
    tcode = tie_code(tie, xs.shape[1], ys.shape[1])
    out = _sweep(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap, ckpt=False, sat=sat,
                 skewed=tcode, pair=pair)
    sw_score_strips_parity.launches += 1
    _count_form(sw_score_strips_parity, pair, tcode)
    return out


sw_score_strips_parity.launches = 0
sw_score_strips_parity.forms = collections.Counter()


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


def _replay(xs, ys, m, n, planes, first: int, moves, walk=None, *, gap, match=0, mismatch=0,
            gap_open=0, table=None):
    """Shared K13/K17/K21/K24 launch on CUDA tensors, no sync: G =
    moves.shape[0] strips from ``first`` into ``moves`` (G, B, N, STRIP_S)
    uint8. ``planes``: the incoming H (and, affine, F) rows, one lane
    stride -- (B, K, N) checkpoints (strip t from row t - 1, strip 0 from
    zeros), or for one strip (G = 1) its (B, N) rows -- or Nones (zeros).
    ``walk``: the strip walk's (i, j, active), or None."""
    dev = xs.device
    B, M = xs.shape
    N = ys.shape[1]
    G = moves.shape[0]
    if first < 0:
        raise ValueError(f"first must be a non-negative strip index, got {first}")
    if (moves.dtype != torch.uint8 or moves.shape != (G, B, N, STRIP_S) or G < 1
            or not moves.is_contiguous() or moves.device != dev):
        raise ValueError(f"moves must be a contiguous (G, {B}, {N}, {STRIP_S}) uint8 tensor "
                         f"on {dev}, got {tuple(moves.shape)}")
    if any(p is None for p in planes) != all(p is None for p in planes):
        raise ValueError("the H and F rows come together")
    hrow = frow = None
    ld_lane = ld_strip = row_first = 0
    if planes[0] is not None:
        ref = planes[0]
        if ref.dim() == 2:  # one strip's rows
            shape, ld_lane, row_first = ys.shape, ref.stride(0), first
            if G != 1:
                raise ValueError("(B, N) rows replay one strip")
        else:  # checkpoints: strip t reads row t - 1
            shape, ld_lane, ld_strip, row_first = (B, ref.shape[1], N), ref.stride(0), \
                ref.stride(1), 1
            if first + G - 1 > ref.shape[1]:
                raise ValueError(f"strips {first}..{first + G - 1} need {first + G - 1} "
                                 f"checkpoint rows, got {ref.shape[1]}")
        if any(p.dtype != torch.int32 or p.shape != shape or p.stride(-1) != 1
               or p.stride() != ref.stride() or p.device != dev for p in planes):
            raise ValueError("the H (and F) rows must be int32 tensors of one layout beside ys, "
                             "each row contiguous")
        hrow, frow = (tuple(planes) + (None,))[:2]
    walk_ptrs = (None, None, None)
    if walk is not None:
        i, j, active = walk
        if (any(a.shape != (B,) or not a.is_contiguous() or a.device != dev for a in walk)
                or i.dtype != torch.int32 or j.dtype != torch.int32
                or active.dtype != torch.bool):
            raise ValueError("walk must be the strip walk's contiguous (B,) int32 i, j and "
                             "bool active")
        walk_ptrs = (i.data_ptr(), j.data_ptr(), active.data_ptr())
    xs, ys, m, n = xs.contiguous(), ys.contiguous(), m.contiguous(), n.contiguous()
    table = table.contiguous() if table is not None else None
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pgs_strip_moves(
            xs.data_ptr(), ys.data_ptr(), m.data_ptr(), n.data_ptr(), M, N, B, G, int(first),
            hrow.data_ptr() if hrow is not None else None,
            frow.data_ptr() if frow is not None else None, ld_lane, ld_strip, row_first,
            *walk_ptrs, table.data_ptr() if table is not None else None,
            table.shape[0] if table is not None else 0,
            int(match), int(mismatch), int(gap_open), int(gap), moves.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "pgs_strip_moves")
    return moves


def _replay_strip(xs, ys, m, n, rows, base: int, **kw):
    """One strip's replay (the per-strip wrappers): the G = 1 launch of
    ``_replay`` into a new (B, N, STRIP_S) tensor."""
    if base % STRIP_S or base < 0:
        raise ValueError(f"base must be a non-negative multiple of {STRIP_S}, got {base}")
    moves = torch.empty((1, *ys.shape, STRIP_S), dtype=torch.uint8, device=xs.device)
    return _replay(xs, ys, m, n, rows, base // STRIP_S, moves, **kw)[0]


def replay_occupancy(*, affine: bool = False, ncodes: int = 0):
    """(warps a block, resident blocks per SM) of the replay launch (K13, K17
    with ``affine``, K21 / K24 with ``ncodes`` > 0, a table of that size) on
    the current CUDA device, from the CUDA occupancy calculator; launches
    nothing."""
    lib = _build.load()
    out = (ctypes.c_int * 2)()
    _build.check(lib.pgs_strip_moves_occupancy(int(affine), int(ncodes), ctypes.addressof(out)),
                 "pgs_strip_moves_occupancy")
    return tuple(out)


# The share of the device memory free at a strip traceback's group that the
# replayed moves may take (``replay_group``).
MOVES_SHARE = 0.5


def replay_group(reach: int, lanes: int, strip_bytes: int, device, *, affine: bool = False,
                 ncodes: int = 0, held: int = 0) -> int:
    """G, the strips a strip traceback replays in one launch: the smallest
    of ``reach``, the strips the walk can still reach; the strips that give
    every warp slot of the card a (lane, strip) pair over the ``lanes``
    still walking (SMs x the replay's resident warps an SM, the occupancy
    calculator's, ``affine`` and ``ncodes`` as in ``replay_occupancy``); and
    the strips whose moves, ``strip_bytes`` each, fit in MOVES_SHARE of the
    device memory free now, counting as free the ``held`` bytes of the
    caller's moves buffer and the caching allocator's unused blocks. At
    least 1; 1 on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    with torch.cuda.device(device):
        per_block, blocks = replay_occupancy(affine=affine, ncodes=ncodes)
        free, _ = torch.cuda.mem_get_info(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fill = -(-sms * per_block * blocks // max(1, lanes))
    free += held + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    fits = int(MOVES_SHARE * free) // max(1, strip_bytes)
    return max(1, min(reach, fill, fits))


def strip_moves(xs, ys, m, n, rowin, base: int, *, match: int, mismatch: int, gap: int):
    """K13: the move codes of the STRIP_S rows [base, base + STRIP_S) of xs
    (B, M) against ys (B, N), replayed from ``rowin`` (B, N) int32, the H of
    row ``base`` for j = 1..N (a slice of K12's checkpoints; None for the
    first strip). Returns (B, N, STRIP_S) uint8, moves[b, j - 1, r] the code
    of cell (base + r + 1, j) (``scan_dp.MOVE_*`` and ``STOP_BIT``); columns
    past a lane's n are left unwritten."""
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return strip_moves_plain(xs, ys, m, n, rowin, base, match=match, mismatch=mismatch,
                                 gap=gap)
    moves = _replay_strip(xs, ys, m, n, (rowin,), base, match=match, mismatch=mismatch, gap=gap)
    strip_moves.launches += 1
    return moves


strip_moves.launches = 0


def strip_moves_group(xs, ys, m, n, ck, first: int, moves, walk=None, *, match: int,
                      mismatch: int, gap: int):
    """K13 on G = moves.shape[0] strips in one launch: the move codes of
    strips first .. first + G - 1 of xs (B, M) against ys (B, N) into
    ``moves`` (G, B, N, STRIP_S) uint8, moves[g] laid out as ``strip_moves``
    gives strip first + g, each replayed from its row of K12's checkpoints
    ``ck`` (B, K, N) (strip t from ck[:, t - 1], strip 0 from zeros).
    ``walk`` = (i, j, active), the strip walk's state
    (``traceback.new_strip_state``), read on the device: a lane that is
    inactive or whose i - 1 lies above a strip's first row replays nothing
    of that strip, the others columns 1 .. min(n, j), every cell the walk
    can still read; the cells outside keep what they held (no ``walk``:
    columns 1 .. n of every strip). No sync. Counts its launches, and into
    ``strip_moves.launches``, K13's count. Returns ``moves``."""
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return strip_moves_group_plain(xs, ys, m, n, ck, first, moves, walk, match=match,
                                       mismatch=mismatch, gap=gap)
    _replay(xs, ys, m, n, (ck,), first, moves, walk, match=match, mismatch=mismatch, gap=gap)
    strip_moves_group.launches += 1
    strip_moves.launches += 1
    return moves


strip_moves_group.launches = 0


def sw_score_strips_affine(xs, ys, m, n, *, match: int, mismatch: int, gap_open: int,
                           gap: int):
    """K15: per-lane (score, i, j) int32 of affine (Gotoh) uniform
    Smith-Waterman for reads of any length -- a gap of length L costs
    gap_open + L * gap -- with K11's column-major argmax tie-break."""
    _check_gap_open(gap_open)
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return sw_score_plain(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap,
                              gap_open=gap_open)
    out = _sweep(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap, ckpt=False,
                 gap_open=gap_open)
    sw_score_strips_affine.launches += 1
    return out


sw_score_strips_affine.launches = 0


def sw_score_strips_affine_ckpt(xs, ys, m, n, *, match: int, mismatch: int, gap_open: int,
                                gap: int):
    """K16: K15's (score, i, j) plus the H checkpoint rows ck and the F rows
    fck, each (B, K, N) int32, K = ceil(M / STRIP_S) - 1: ck[b, k, j - 1] =
    H((k + 1) * STRIP_S, j) and fck[b, k, j - 1] = F((k + 1) * STRIP_S, j)
    with 1-based rows; outside the lane's matrix H = 0 and F = NEG."""
    _check_gap_open(gap_open)
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return sw_score_affine_ckpt_plain(xs, ys, m, n, match=match, mismatch=mismatch,
                                          gap_open=gap_open, gap=gap)
    out = _sweep(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap, ckpt=True,
                 gap_open=gap_open)
    sw_score_strips_affine_ckpt.launches += 1
    return out


sw_score_strips_affine_ckpt.launches = 0


def strip_affine_moves(xs, ys, m, n, rowin, frowin, base: int, *, match: int, mismatch: int,
                       gap_open: int, gap: int):
    """K17: ``strip_moves`` under affine gaps, replayed from the H row
    ``rowin`` and the F row ``frowin`` (slices of K16's checkpoints, with
    one lane stride; both None for the first strip), emitting the affine
    move bytes (``scan_dp.H_*``, ``E_EXT_BIT``, ``F_EXT_BIT``) of the full
    sweep on every cell of a lane's matrix."""
    _check_gap_open(gap_open)
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return strip_affine_moves_plain(xs, ys, m, n, rowin, frowin, base, match=match,
                                        mismatch=mismatch, gap_open=gap_open, gap=gap)
    moves = _replay_strip(xs, ys, m, n, (rowin, frowin), base, match=match, mismatch=mismatch,
                          gap=gap, gap_open=gap_open)
    strip_affine_moves.launches += 1
    return moves


strip_affine_moves.launches = 0


def strip_affine_moves_group(xs, ys, m, n, ck, fck, first: int, moves, walk=None, *,
                             match: int, mismatch: int, gap_open: int, gap: int):
    """K17 on G = moves.shape[0] strips in one launch: ``strip_moves_group``
    under affine gaps, strip t replayed from K16's H and F checkpoint rows
    ck[:, t - 1] and fck[:, t - 1] (strip 0 from H = F = 0). Counts into
    ``strip_affine_moves.launches`` too."""
    _check_gap_open(gap_open)
    if _check_inputs(xs, ys, m, n).type == "cpu":
        return strip_affine_moves_group_plain(xs, ys, m, n, ck, fck, first, moves, walk,
                                              match=match, mismatch=mismatch,
                                              gap_open=gap_open, gap=gap)
    _replay(xs, ys, m, n, (ck, fck), first, moves, walk, match=match, mismatch=mismatch,
            gap=gap, gap_open=gap_open)
    strip_affine_moves_group.launches += 1
    strip_affine_moves.launches += 1
    return moves


strip_affine_moves_group.launches = 0


def sw_score_strips_profile(x, y, m, n, *, table, gap: int, y_off=None):
    """K19: per-lane (score, i, j) int32 of linear-gap Smith-Waterman scored
    by ``table`` (ncodes, ncodes) int32 over compact codes, for queries of any
    length, with K11's column-major argmax tie-break.

    x: (B, M) codes, or (M,) codes of one query shared by every lane (the
    database scan). y: (B, N) codes, or -- with ``y_off`` (B,) int64 -- a
    flat (R,) slab in which lane b reads ``y[y_off[b] : y_off[b] + n[b]]``.
    m, n: (B,) int32 true lengths, clamped to M, N and to what y holds past
    the offset. The arguments of ``profile_cuda.sw_profile``."""
    if check_scan_inputs(x, y, m, n, table, y_off).type == "cpu":
        return sw_profile_plain(x, y, m, n, table=table, gap=gap, y_off=y_off)
    out = _sweep(x, y, m, n, gap=gap, ckpt=False, table=table.contiguous(),
                 y_off=None if y_off is None else y_off.contiguous())
    sw_score_strips_profile.launches += 1
    return out


sw_score_strips_profile.launches = 0


def _check_lanes(xs, ys, m, n, table):
    """Per-lane (B, M), (B, N) codes and a table; returns their device."""
    if xs.dim() != 2:
        raise ValueError(f"expected xs (B, M), got {tuple(xs.shape)}")
    return check_scan_inputs(xs, ys, m, n, table, None)


def sw_score_strips_profile_ckpt(xs, ys, m, n, *, table, gap: int):
    """K20: K19's (score, i, j) on xs (B, M) and ys (B, N) codes plus the
    checkpoint rows (B, K, N) int32 of K12, K = ceil(M / STRIP_S) - 1:
    ck[b, k, j - 1] = H((k + 1) * STRIP_S, j) with 1-based rows, 0 outside
    the lane's matrix."""
    if _check_lanes(xs, ys, m, n, table).type == "cpu":
        return sw_profile_ckpt_plain(xs, ys, m, n, table=table, gap=gap)
    out = _sweep(xs, ys, m, n, gap=gap, ckpt=True, table=table.contiguous())
    sw_score_strips_profile_ckpt.launches += 1
    return out


sw_score_strips_profile_ckpt.launches = 0


def strip_profile_moves(xs, ys, m, n, rowin, base: int, *, table, gap: int):
    """K21: ``strip_moves`` with the cell scores of ``table`` over the
    compact codes xs (B, M) and ys (B, N): the linear move codes of the
    STRIP_S rows [base, base + STRIP_S), replayed from ``rowin`` (a slice of
    K20's checkpoints; None for the first strip), as (B, N, STRIP_S) uint8."""
    if _check_lanes(xs, ys, m, n, table).type == "cpu":
        return strip_profile_moves_plain(xs, ys, m, n, rowin, base, table=table, gap=gap)
    moves = _replay_strip(xs, ys, m, n, (rowin,), base, gap=gap, table=table)
    strip_profile_moves.launches += 1
    return moves


strip_profile_moves.launches = 0


def strip_profile_moves_group(xs, ys, m, n, ck, first: int, moves, walk=None, *, table,
                              gap: int):
    """K21 on G = moves.shape[0] strips in one launch: ``strip_moves_group``
    with the cell scores of ``table`` over the compact codes xs and ys, from
    K20's checkpoints ``ck``. Counts into ``strip_profile_moves.launches``
    too."""
    if _check_lanes(xs, ys, m, n, table).type == "cpu":
        return strip_profile_moves_group_plain(xs, ys, m, n, ck, first, moves, walk,
                                               table=table, gap=gap)
    _replay(xs, ys, m, n, (ck,), first, moves, walk, gap=gap, table=table)
    strip_profile_moves_group.launches += 1
    strip_profile_moves.launches += 1
    return moves


strip_profile_moves_group.launches = 0


def sw_score_strips_profile_affine(x, y, m, n, *, table, gap_open: int, gap: int,
                                   y_off=None):
    """K22: K19 under affine (Gotoh) gaps -- a gap of length L costs
    gap_open + L * gap -- per lane or, with ``y_off``, one query against
    every lane of a flat slab (the arguments of ``sw_score_strips_profile``);
    per-lane (score, i, j) int32 with K11's column-major argmax tie-break."""
    _check_gap_open(gap_open)
    if check_scan_inputs(x, y, m, n, table, y_off).type == "cpu":
        return sw_profile_plain(x, y, m, n, table=table, gap=gap, gap_open=gap_open,
                                y_off=y_off)
    out = _sweep(x, y, m, n, gap=gap, ckpt=False, gap_open=gap_open, table=table.contiguous(),
                 y_off=None if y_off is None else y_off.contiguous())
    sw_score_strips_profile_affine.launches += 1
    return out


sw_score_strips_profile_affine.launches = 0


def sw_score_strips_profile_affine_ckpt(xs, ys, m, n, *, table, gap_open: int, gap: int):
    """K23: K22's (score, i, j) on xs (B, M) and ys (B, N) codes plus K16's
    H and F checkpoint rows, each (B, K, N) int32, K = ceil(M / STRIP_S) -
    1: ck[b, k, j - 1] = H((k + 1) * STRIP_S, j), fck[b, k, j - 1] =
    F((k + 1) * STRIP_S, j) with 1-based rows; outside the lane's matrix H =
    0 and F = NEG."""
    _check_gap_open(gap_open)
    if _check_lanes(xs, ys, m, n, table).type == "cpu":
        return sw_profile_affine_ckpt_plain(xs, ys, m, n, table=table, gap_open=gap_open,
                                            gap=gap)
    out = _sweep(xs, ys, m, n, gap=gap, ckpt=True, gap_open=gap_open, table=table.contiguous())
    sw_score_strips_profile_affine_ckpt.launches += 1
    return out


sw_score_strips_profile_affine_ckpt.launches = 0


def strip_profile_affine_moves(xs, ys, m, n, rowin, frowin, base: int, *, table,
                               gap_open: int, gap: int):
    """K24: ``strip_affine_moves`` with the cell scores of ``table`` over the
    compact codes xs (B, M) and ys (B, N): the affine move bytes of the
    STRIP_S rows [base, base + STRIP_S), replayed from the H row ``rowin``
    and the F row ``frowin`` (slices of K23's checkpoints with one lane
    stride; both None for the first strip), as (B, N, STRIP_S) uint8."""
    _check_gap_open(gap_open)
    if _check_lanes(xs, ys, m, n, table).type == "cpu":
        return strip_profile_affine_moves_plain(xs, ys, m, n, rowin, frowin, base, table=table,
                                                gap_open=gap_open, gap=gap)
    moves = _replay_strip(xs, ys, m, n, (rowin, frowin), base, gap=gap, gap_open=gap_open,
                          table=table)
    strip_profile_affine_moves.launches += 1
    return moves


strip_profile_affine_moves.launches = 0


def strip_profile_affine_moves_group(xs, ys, m, n, ck, fck, first: int, moves, walk=None, *,
                                     table, gap_open: int, gap: int):
    """K24 on G = moves.shape[0] strips in one launch:
    ``strip_affine_moves_group`` with the cell scores of ``table`` over the
    compact codes xs and ys, from K23's H and F checkpoints. Counts into
    ``strip_profile_affine_moves.launches`` too."""
    _check_gap_open(gap_open)
    if _check_lanes(xs, ys, m, n, table).type == "cpu":
        return strip_profile_affine_moves_group_plain(xs, ys, m, n, ck, fck, first, moves, walk,
                                                      table=table, gap_open=gap_open, gap=gap)
    _replay(xs, ys, m, n, (ck, fck), first, moves, walk, gap=gap, gap_open=gap_open,
            table=table)
    strip_profile_affine_moves_group.launches += 1
    strip_profile_affine_moves.launches += 1
    return moves


strip_profile_affine_moves_group.launches = 0
