"""Wrappers of the CUDA uniform-scoring kernels K1, K2, K6 and K7
(``csrc/wavefront.cu``).

K1 ``sw_score`` ports the Pallas kernel B1 (``_kernel_uniform``, TPU
``ops/wavefront_pallas.py:160`` via ``_call_uniform`` :924); K2
``sw_score_moves`` ports B2 (``_kernel_uniform_moves`` :535 via
``_call_uniform_moves`` :596). Their affine (Gotoh) forms: K6
``sw_score_affine`` ports B5 (``_kernel_uniform_affine`` :208 via
``_call_uniform_affine`` :280), K7 ``sw_score_affine_moves`` ports B6
(``_kernel_uniform_affine_moves`` :710 via ``_call_uniform_affine_moves``
:740). All take the JAX package's batch-first layout -- xs (B, M), ys (B, N)
uint8 padded with X_PAD / Y_PAD, m, n (B,) int32 -- and return per-lane int32
(score, i, j); K2 and K7 also return the (M + N - 1, M, B) uint8 move codes
(K7's are the affine bytes that ``traceback.walk_moves_affine`` walks). A
lane length beyond the padded shape is clamped to it (m_b <= M, n_b <= N) on
both routes.

Route: tensors on the CPU take the plain PyTorch version (``ops/scan_dp``);
tensors on a CUDA device launch the kernel, and a missing toolkit or a failed
build or launch raises. Each wrapper's ``launches`` counts kernel launches
only.

The kernels give each lane one or more warps (``csrc/wavefront.cu``): they
read xs and ys as they are, with no scratch, for reads of up to
``MAX_ROWS`` = 2,048 rows (longer ones run on ``ops/strips_cuda``);
``launch_shape`` reports the launch a call makes (rows a thread, lanes a
block, warps a lane, blocks an SM). K2 and K7 take ``lanes``, the lanes a
block that store their move bytes together, and ``warps``, the warps a lane
(0: the kernel's rules). The same template, scored from a substitution
table, is the protein top-K re-run K5/K9 (``profile_cuda.sw_profile_moves``,
``sw_profile_affine_moves``), which launches through ``_launch`` with its
table.

K26 ``sw_score_parity`` is the same template in the reference-parity forms
of the JAX ``lax.scan`` wavefront (``ops/scan_dp.py`` ``_wavefront`` :93
under ``Semantics.SAT_UINT8`` and/or ``tie="skewed"``; no Pallas call ports
them): linear gaps, every H clamped at 255 when ``sat``, the argmax by the
column-major or the skewed tie, score-only, argmax or moves, scored
uniformly or (exact values) from a table. It is built from
``csrc/wavefront_parity.cu``, which compiles ``csrc/wavefront.cu``'s K26
instantiations as a unit of their own. Its score-only sweep under
saturation with uniform scores takes the pair form (``parity_form``): each
thread's word holds the same row of two lanes in signed 16-bit halves,
stepped by DPX s16x2 instructions. Under the skewed tie each column's key
is found at the wrap row while every key of the launch's shape fits 32 bits
(``key_rule``), else computed for each row of the column's maximum.
``sw_score_parity.forms`` counts the launches by form and, for the skewed
argmax, by key rule.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..utils.device import device_of
from . import _build
from .scan_dp import sw_score_moves_plain, sw_score_parity_plain, sw_score_plain


def _check_inputs(xs, ys, m, n):
    if xs.dtype != torch.uint8 or ys.dtype != torch.uint8:
        raise TypeError("xs and ys must be uint8")
    if m.dtype != torch.int32 or n.dtype != torch.int32:
        raise TypeError("m and n must be int32")
    if xs.dim() != 2 or ys.dim() != 2 or xs.shape[0] != ys.shape[0]:
        raise ValueError(f"expected xs (B, M) and ys (B, N), got {tuple(xs.shape)}, {tuple(ys.shape)}")
    if m.shape != (xs.shape[0],) or n.shape != (xs.shape[0],):
        raise ValueError("m and n must have shape (B,)")
    return device_of(xs, ys, m, n)


# Read rows the rules cover: 2 warps of 32 threads x 32 rows (the engine's
# MAX_M; longer reads take the strip kernels).
MAX_ROWS = 2 * 32 * 32
# ``launch_shape``'s modes: score-only (K1/K6), argmax, moves (K2/K7).
MODES = {"score_only": 0, "track_pos": 1, "moves": 2}


def launch_shape(M: int, B: int, *, affine: bool, mode: str, lanes: int = 0,
                 warps: int = 0, ncodes: int = 0, parity: bool = False, pair: bool = False):
    """The launch of K1/K2/K6/K7 -- or, with ``ncodes`` > 0 (mode "moves"),
    of K5/K9 over an (ncodes, ncodes) table; with ``parity``, of K26 (linear,
    a table with mode "track_pos" too; ``pair`` its pair form, mode
    "score_only") -- for B
    lanes of M rows on the current CUDA device (``mode`` one of MODES;
    ``lanes``, ``warps`` as K2 takes them): {rows (a thread), lanes (a
    block; lane pairs under the pair form), warps (a lane or pair),
    blocks_per_sm (the CUDA occupancy calculator), smem (dynamic shared
    bytes a block)}. Launches nothing; raises for a shape the kernels do
    not take."""
    lib = _build.load()
    out = (ctypes.c_int * 5)()
    if parity:
        if affine:
            raise ValueError("K26 is linear-gap only")
        _build.check(lib.pgs_sw_score_parity_shape(int(M), int(B), MODES[mode], int(ncodes),
                                                   int(pair), int(lanes), int(warps),
                                                   ctypes.addressof(out)),
                     "pgs_sw_score_parity_shape")
    else:
        _build.check(lib.pgs_sw_score_shape(int(M), int(B), int(affine), MODES[mode],
                                            int(ncodes), int(lanes), int(warps),
                                            ctypes.addressof(out)),
                     "pgs_sw_score_shape")
    return dict(zip(("rows", "lanes", "warps", "blocks_per_sm", "smem"), out))


def _launch(xs, ys, m, n, *, match, mismatch, gap_open, gap, track_pos, moves, lanes=0,
            warps=0, table=None, parity=None):
    """Shared K1/K2/K6/K7 launch, and K5/K9's with a ``table`` (ncodes,
    ncodes) int32 over compact codes; with ``parity`` = (sat, skewed, pair),
    K26's (skewed: the C tie code, 0 column-major, 1 the key at the wrap
    row, 2 every cell's key): outputs allocated here, kernel on the current
    stream, no sync."""
    B, M = xs.shape
    N = ys.shape[1]
    if M > MAX_ROWS:
        longer = ("entries run on the strip path, engine.CudaEngine.score_batch_strip_moves"
                  if table is not None else "reads run on strips_cuda.sw_score_strips(_affine)")
        raise ValueError(f"{M} rows exceed MAX_ROWS = {MAX_ROWS}; longer {longer}")
    dev = xs.device
    lib = _build.load()
    xs, ys, m, n = (t.contiguous() for t in (xs, ys, m, n))
    if table is not None:
        table = table.contiguous()
    score, bi, bj = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    tab = (table.data_ptr() if table is not None else None,
           table.shape[0] if table is not None else 0)
    outs = (score.data_ptr(), bi.data_ptr(), bj.data_ptr(),
            moves.data_ptr() if moves is not None else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if parity is None:
            name = "pgs_sw_score"
            err = lib.pgs_sw_score(
                xs.data_ptr(), ys.data_ptr(), m.data_ptr(), n.data_ptr(), M, N, B, int(match),
                int(mismatch), int(gap_open), int(gap), *tab, int(track_pos), int(lanes),
                int(warps), *outs, stream,
            )
        else:
            name = "pgs_sw_score_parity"
            err = lib.pgs_sw_score_parity(
                xs.data_ptr(), ys.data_ptr(), m.data_ptr(), n.data_ptr(), M, N, B, int(match),
                int(mismatch), int(gap), *tab, int(track_pos), *(int(v) for v in parity),
                int(lanes), int(warps), *outs, stream,
            )
    _build.check(err, name)
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
        xs, ys, m, n, match=match, mismatch=mismatch, gap_open=0, gap=gap,
        track_pos=track_pos, moves=None,
    )
    sw_score.launches += 1
    return out


sw_score.launches = 0


def sw_score_moves(xs, ys, m, n, *, match: int, mismatch: int, gap: int, lanes: int = 0,
                   warps: int = 0):
    """K2: K1's (score, i, j) plus (M + N - 1, M, B) uint8 move/stop codes.
    Only cells inside each lane's m_b x n_b matrix are written; the rest of
    the moves tensor is left uninitialised (the walk never reads it).
    ``lanes``, ``warps``: the lanes a block and the warps a lane on the card
    (0: the kernel's rules)."""
    dev = _check_inputs(xs, ys, m, n)
    if dev.type == "cpu":
        return sw_score_moves_plain(
            xs, ys, m, n, match=match, mismatch=mismatch, gap=gap
        )
    B, M = xs.shape
    N = ys.shape[1]
    moves = torch.empty((M + N - 1, M, B), dtype=torch.uint8, device=dev)
    score, bi, bj = _launch(
        xs, ys, m, n, match=match, mismatch=mismatch, gap_open=0, gap=gap,
        track_pos=True, moves=moves, lanes=lanes, warps=warps,
    )
    sw_score_moves.launches += 1
    return score, bi, bj, moves


sw_score_moves.launches = 0


def _check_gap_open(gap_open):
    if gap_open < 1:
        raise ValueError(f"gap_open must be >= 1 for the affine kernels, got {gap_open}")


def sw_score_affine(xs, ys, m, n, *, match: int, mismatch: int, gap_open: int,
                    gap: int, track_pos: bool = True):
    """K6: K1 under affine (Gotoh) gaps -- a gap of length L costs
    gap_open + L * gap -- with the JAX scan's boundaries; per-lane (score,
    i, j) int32, i = j = 0 when not track_pos."""
    dev = _check_inputs(xs, ys, m, n)
    _check_gap_open(gap_open)
    if dev.type == "cpu":
        return sw_score_plain(
            xs, ys, m, n, match=match, mismatch=mismatch, gap_open=gap_open,
            gap=gap, track_pos=track_pos,
        )
    out = _launch(
        xs, ys, m, n, match=match, mismatch=mismatch, gap_open=gap_open,
        gap=gap, track_pos=track_pos, moves=None,
    )
    sw_score_affine.launches += 1
    return out


sw_score_affine.launches = 0


def sw_score_affine_moves(xs, ys, m, n, *, match: int, mismatch: int,
                          gap_open: int, gap: int, lanes: int = 0, warps: int = 0):
    """K7: K6's (score, i, j) plus the (M + N - 1, M, B) uint8 affine move
    bytes (``scan_dp.H_*``, ``E_EXT_BIT``, ``F_EXT_BIT``). Only cells inside
    each lane's m_b x n_b matrix are written, as in K2; ``lanes`` and
    ``warps`` as there."""
    dev = _check_inputs(xs, ys, m, n)
    _check_gap_open(gap_open)
    if dev.type == "cpu":
        return sw_score_moves_plain(
            xs, ys, m, n, match=match, mismatch=mismatch, gap_open=gap_open, gap=gap,
        )
    B, M = xs.shape
    N = ys.shape[1]
    moves = torch.empty((M + N - 1, M, B), dtype=torch.uint8, device=dev)
    score, bi, bj = _launch(
        xs, ys, m, n, match=match, mismatch=mismatch, gap_open=gap_open,
        gap=gap, track_pos=True, moves=moves, lanes=lanes, warps=warps,
    )
    sw_score_affine_moves.launches += 1
    return score, bi, bj, moves


sw_score_affine_moves.launches = 0


# K26 and K27's skewed tie finds each column's key at the wrap row while no
# raw key rj * (M + 33) + ri of the launch's padded shape (M, N) can pass
# 2^31: rj <= max(m_b, n_b) <= M + N and ri <= N (csrc/parity.cuh's
# wrap_row_pick). Past that bound the keys wrap as the JAX scan's int32 keys
# do, the key order within a column no longer follows the rows, and the
# launch computes the key of every row of a column's maximum.
KEY_LIMIT = 2**31
TIE_CODES = {"colmajor": 0, "wrap_row": 1, "every_cell": 2}


def key_rule(M: int, N: int) -> str:
    """The skewed tie's key search for a launch of padded shape (M, N):
    'wrap_row' for (M + N) (M + 33) + N < 2^31, else 'every_cell'. A rule
    chosen from the shape on the host, at each launch."""
    return "wrap_row" if (M + N) * (M + 33) + N < KEY_LIMIT else "every_cell"


def pair_fits(*, sat: bool, match: int = 0, mismatch: int = 0, gap: int = 0,
              table=None) -> bool:
    """Whether a config has a pair form: saturation with uniform scores and
    the operands ``scan_dp.sat_operands`` gives (match and gap in [0, 255],
    mismatch in [-255, 0]), so that every value fits a 16-bit half."""
    in_range = 0 <= match <= 255 and -255 <= mismatch <= 0 and 0 <= gap <= 255
    return bool(sat) and table is None and in_range


def parity_form(*, sat: bool, match: int = 0, mismatch: int = 0, gap: int = 0, table=None,
                mode: str = "track_pos") -> str:
    """The form a K26 launch (``mode`` one of MODES) takes for a config:
    'pair' (two lanes a word in 16-bit halves) for the score-only sweep
    where ``pair_fits``, the one launch whose pair form measured faster
    (the 8,704 windows of ``--semantics sat_uint8``, PERF.md section 6); else
    'int32' (exact values, a table, and the argmax and the moves, whose
    per-column work the pair form does a half at a time)."""
    fits = pair_fits(sat=sat, match=match, mismatch=mismatch, gap=gap, table=table)
    return "pair" if fits and mode == "score_only" else "int32"


def tie_code(tie: str, M: int, N: int) -> int:
    """The C tie argument of K26/K27 for ``tie`` at padded shape (M, N)."""
    return TIE_CODES["colmajor" if tie == "colmajor" else key_rule(M, N)]


def _count_form(fn, pair: bool, tcode: int):
    """Count a K26/K27 launch in ``fn.forms``: its form and, under the
    skewed tie, its key rule."""
    fn.forms["pair" if pair else "int32"] += 1
    if tcode:
        fn.forms["wrap_row" if tcode == TIE_CODES["wrap_row"] else "every_cell"] += 1


def sw_score_parity(xs, ys, m, n, *, gap: int, sat: bool, tie: str = "colmajor",
                    match: int = 0, mismatch: int = 0, table=None, track_pos: bool = True,
                    emit_moves: bool = False, lanes: int = 0, warps: int = 0):
    """K26: per-lane (score, i, j) int32 of linear Smith-Waterman with every
    H clamped at 255 when ``sat`` (pass the operands of
    ``scan_dp.sat_operands``) and the argmax by ``tie``, 'colmajor' (K1's)
    or 'skewed' (the reference binary's raw key, ``scan_dp.skewed_keys``);
    scored uniformly (match, mismatch) over raw bytes or, with ``table``
    (ncodes, ncodes) int32, over compact codes. track_pos=False gives i = j
    = 0; ``emit_moves`` appends the (M + N - 1, M, B) uint8 move codes,
    written only inside each lane's m_b x n_b, as K2's. ``lanes``,
    ``warps`` as K2 takes them (lane pairs a block under the pair form; 0:
    the kernel's rules). The form is ``parity_form``'s."""
    if tie not in ("colmajor", "skewed"):
        raise ValueError(f"unknown tie {tie!r}")
    dev = _check_inputs(xs, ys, m, n)
    if dev.type == "cpu":
        return sw_score_parity_plain(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap,
                                     table=table, sat=sat, tie=tie, track_pos=track_pos,
                                     emit_moves=emit_moves)
    mode = "moves" if emit_moves else "track_pos" if track_pos else "score_only"
    pair = parity_form(sat=sat, match=match, mismatch=mismatch, gap=gap, table=table,
                       mode=mode) == "pair"
    B, M = xs.shape
    N = ys.shape[1]
    moves = (torch.empty((M + N - 1, M, B), dtype=torch.uint8, device=dev) if emit_moves
             else None)
    pos = track_pos or emit_moves
    tcode = tie_code(tie, M, N) if pos else 0
    out = _launch(xs, ys, m, n, match=match, mismatch=mismatch, gap_open=0, gap=gap,
                  track_pos=pos, moves=moves, lanes=lanes, warps=warps, table=table,
                  parity=(sat, tcode, pair))
    sw_score_parity.launches += 1
    _count_form(sw_score_parity, pair, tcode)
    return (*out, moves) if emit_moves else out


sw_score_parity.launches = 0
sw_score_parity.forms = collections.Counter()
