"""Needleman-Wunsch (global) DP on the card: the port of the JAX package's
``ops/global_dp.py`` (:33-110).

``nw_lastrow`` computes the last NW row H(m_b, j), j = 0..n_b, of B ragged
lanes: no zero floor, the boundary row and column seeded with gap costs, a
linear gap (the recurrence of ``oracle.nw_matrix``). On CPU tensors it runs
the plain PyTorch version below, the JAX ``_nw_lastrow_scan`` (:33) line for
line with ``torch.cummax`` for ``lax.cummax``; on CUDA tensors it launches
K25 (``csrc/global_dp.cu``), an anti-diagonal sweep over bands of rows whose
lanes are cut into chunks on many SMs, and raises if the kernel does not
build or launch.

``nw_lastrow_lanes`` is the kernel's own form: lanes read in place from two
flat byte buffers by offset and direction (``plan_lanes``), each lane's row
written at its offset of one flat output. A Hirschberg level is one such
call. ``nw_lastrow`` is its packed (B, M) case, lane b at offset b * M,
forward. ``nw_lastrow_batch`` and ``nw_score_batch`` are the JAX functions
(:81, :107) over ragged lists. The JAX power-of-two shape buckets (:74) are
a compile cache and not ported: the kernel's loops stop at each lane's true
lengths.

Global alignment here is linear-gap only, as the JAX ``_nw_lastrow_scan``
and ``oracle.nw_matrix`` are (they ignore ``gap_open``): an affine config
raises ``ValueError`` rather than giving another answer, and a non-integral
or float32 one raises NotImplementedError (ROADMAP A2b). Like the JAX
functions, they take no DP semantics: a ``SAT_UINT8`` config gives the exact
integer rows of its scores.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.config import ScoringConfig
from ..utils.device import device_of, resolve_device, to_host
from . import _build
from .engine import check_supported
from .oracle import _as_bytes

# The launch rule's choices: rows a thread (R; a warp's chunk is 32 R rows)
# and warps a block.
ROWS = (4, 8, 16, 32)
MAX_WARPS = 4
# The rule's model of the sweep, measured on an H100 (132 SMs; the step
# curves and launches of ``tools/nw_shapes.py``): cycles a step of a warp
# alone on its scheduler (the step's latency, R = 4 .. 32), and scheduler
# cycles a warp-step takes when the warps of a launch share the schedulers
# (its issue); a chunk trails the chunk above it by about 100 steps (a word
# of 32 columns loaded a word ahead, and the band pipeline of 32 steps).
STEP_CYCLES = {4: 190, 8: 230, 16: 365, 32: 510}
ISSUE_CYCLES = {4: 94, 8: 144, 16: 210, 32: 356}
SMS = 132
HANDOFF_STEPS = 100
FIELDS = 8  # int64 fields of a lane's descriptor (csrc/global_dp.cu)


def check_config(cfg: ScoringConfig):
    """Raise for what global alignment does not run: an affine config
    (ValueError; the JAX functions ignore gap_open), and a non-integral or
    float32 one (NotImplementedError; the JAX functions then run float32).
    The semantics are otherwise unused, as in the JAX functions: SAT_UINT8
    gives exact integer rows."""
    if cfg.is_affine:
        raise ValueError(
            "global (NW / Hirschberg) alignment is linear-gap only: the JAX "
            f"reference ignores gap_open, got gap_open={cfg.gap_open}"
        )
    check_supported(cfg)
    if not cfg.is_integral:
        raise NotImplementedError(
            "non-integral or float32 scoring is not ported yet: ROADMAP A2b")


def byte_table(cfg: ScoringConfig, device) -> torch.Tensor:
    """``cfg``'s (256, 256) score table over raw bytes, int32 on ``device``."""
    check_config(cfg)
    return torch.from_numpy(cfg.byte_table().astype(np.int32)).to(device)


def chunk_counts(m, rows: int) -> np.ndarray:
    """Chunks of each lane at ``rows`` rows a thread: ceil(m_b / (32 rows)),
    at least 1 (a lane with m_b = 0 still writes row 0)."""
    m = np.asarray(m, np.int64)
    return np.maximum(1, -(-m // (32 * rows)))


def launch_shape(m, n):
    """K25's launch rule: (rows a thread, warps a block) for lanes of true
    lengths m, n. Each R in ``ROWS`` is costed as the larger of its chain --
    the longest lane's span of n_b steps, the bands of its last chunk and
    ``HANDOFF_STEPS`` a chunk boundary, at ``STEP_CYCLES`` a step -- and its
    issue, every chunk's n_b + 32 steps at ``ISSUE_CYCLES`` over the card's
    4 x ``SMS`` schedulers. The cheapest R wins, the larger on a tie. Warps
    a block: the chunks over the SMs, 1 to ``MAX_WARPS``, so that a launch
    of few chunks spreads them a block an SM."""
    m = np.maximum(np.asarray(m, np.int64), 0)
    n = np.maximum(np.asarray(n, np.int64), 0)
    if m.size == 0:
        return ROWS[0], 1
    best = None
    for R in ROWS:
        chunks = chunk_counts(m, R)
        last = m - (chunks - 1) * 32 * R
        span = n + (chunks - 1) * HANDOFF_STEPS + -(-last // R)
        chain = float(span.max()) * STEP_CYCLES[R]
        issue = float(((n + 32) * chunks).sum()) * ISSUE_CYCLES[R] / (4 * SMS)
        cost = max(chain, issue)
        if best is None or cost <= best[0]:
            best = (cost, R, int(chunks.sum()))
    _, R, total = best
    return R, int(min(MAX_WARPS, max(1, total // SMS)))


@dataclasses.dataclass
class Lanes:
    """B lanes read in place, and K25's plan for them. Host arrays (B,):
    x_off, m, y_off, n, the direction bits (1: x reversed, 2: y reversed),
    out_off (lane b's row at out_off[b] + j); rows a thread and warps a
    block; per lane its chunks, its first chunk and its boundary row's
    offset; ``total_out`` the output's length, ``bound_ints`` the boundary
    rows' 64-bit slots: n_b + 1 for each lane of two chunks or more, which
    all its chunks share (0: no lane has two chunks)."""

    x_off: np.ndarray
    m: np.ndarray
    y_off: np.ndarray
    n: np.ndarray
    flags: np.ndarray
    out_off: np.ndarray
    total_out: int
    rows: int
    warps: int
    chunks: np.ndarray
    chunk0: np.ndarray
    bound_off: np.ndarray
    bound_ints: int

    @property
    def B(self) -> int:
        return len(self.m)

    @property
    def total_chunks(self) -> int:
        return int(self.chunks.sum())

    @property
    def blocks(self) -> int:
        return -(-self.total_chunks // self.warps)

    def descriptor(self) -> np.ndarray:
        """The kernel's int64 descriptor: (B, 8) lane fields, then each
        chunk's lane."""
        d = np.stack([self.x_off, self.y_off, self.out_off, self.bound_off, self.m, self.n,
                      self.flags, self.chunk0], axis=1).astype(np.int64)
        lane_of = np.repeat(np.arange(self.B, dtype=np.int64), self.chunks)
        return np.concatenate([d.reshape(-1), lane_of])


def plan_lanes(m, n, x_off=None, y_off=None, x_rev=None, y_rev=None, out_off=None,
               total_out: int = 0, rows: int = 0, warps: int = 0) -> Lanes:
    """K25's plan for lanes x_b = x[x_off : x_off + m_b] and y_b = y[y_off :
    y_off + n_b] (host arrays; reversed where ``x_rev`` / ``y_rev``). Offsets
    default to the lanes packed end to end; ``out_off`` to rows of n_b + 1
    end to end, in an output of at least ``total_out``. ``rows`` / ``warps``
    force the launch shape (0: the rule)."""
    m = np.maximum(np.asarray(m, np.int64).reshape(-1), 0)
    n = np.maximum(np.asarray(n, np.int64).reshape(-1), 0)
    B = len(m)
    excl = lambda v: (np.cumsum(v) - v).astype(np.int64)
    x_off = excl(m) if x_off is None else np.asarray(x_off, np.int64).reshape(-1)
    y_off = excl(n) if y_off is None else np.asarray(y_off, np.int64).reshape(-1)
    if out_off is None:
        out_off = excl(n + 1)
        total_out = int((n + 1).sum())
    else:
        out_off = np.asarray(out_off, np.int64).reshape(-1)
        total_out = max(total_out, int((out_off + n + 1).max()) if B else 0)
    flags = np.zeros(B, np.int64)
    if x_rev is not None:
        flags |= np.asarray(x_rev, bool).astype(np.int64)
    if y_rev is not None:
        flags |= 2 * np.asarray(y_rev, bool).astype(np.int64)
    R, W = launch_shape(m, n)
    R, W = rows or R, warps or W
    if R not in ROWS or not 1 <= W <= MAX_WARPS:
        raise ValueError(f"K25 takes rows in {ROWS} and 1-{MAX_WARPS} warps, got {R}, {W}")
    chunks = chunk_counts(m, R) if B else np.zeros(0, np.int64)
    bound_rows = np.where(chunks > 1, n + 1, 0)
    return Lanes(x_off=x_off, m=m, y_off=y_off, n=n, flags=flags, out_off=out_off,
                 total_out=total_out, rows=R, warps=W, chunks=chunks, chunk0=excl(chunks),
                 bound_off=excl(bound_rows), bound_ints=int(bound_rows.sum()))


def nw_lastrow_plain(x, y, m, n, *, table, gap: int, top=None, row0: int = 0):
    """The JAX row scan: a loop over the rows, each row's west-gap chain
    one ``cummax`` of u(j) + gap * j; row m_b kept for lane b. Rows past
    every lane's m are not swept (none would be kept). ``top`` (B, N + 1),
    when given, is the row above x's first row, H(row0, .), and column 0
    then holds -gap * (row0 + i): the sweep of a segment of rows handed the
    row above it."""
    B, N = y.shape
    dev = y.device
    gj = gap * torch.arange(N + 1, dtype=torch.int32, device=dev)[None, :]
    prev = (-gj).expand(B, N + 1).clone() if top is None else top.to(torch.int32).clone()
    m = m.to(device=dev, dtype=torch.int32).clamp(0, x.shape[1])
    n = n.to(device=dev, dtype=torch.int32).clamp(0, N)
    last = prev.clone()
    yl = y.long()
    flat = table.reshape(-1)
    for i in range(1, int(m.max()) + 1 if B else 1):
        s = flat[x[:, i - 1].long()[:, None] * 256 + yl]  # (B, N)
        u = torch.empty_like(prev)
        u[:, 0] = -gap * (row0 + i)
        u[:, 1:] = torch.maximum(prev[:, :-1] + s, prev[:, 1:] - gap)
        prev = torch.cummax(u + gj, dim=1).values - gj
        last = torch.where((m == i)[:, None], prev, last)
    cols = torch.arange(N + 1, device=dev)[None, :]
    return torch.where(cols <= n[:, None], last, 0).to(torch.int32)


def gather_lanes(x, y, lanes: Lanes):
    """The lanes' bytes packed as (B, M) and (B, N) uint8 (zero past m_b,
    n_b; reversed lanes read back to front), with m and n: the packed form
    of a ``Lanes`` plan, on x's device."""
    dev = x.device
    M = max(1, int(lanes.m.max()) if lanes.B else 1)
    N = max(1, int(lanes.n.max()) if lanes.B else 1)

    def pack(buf, off, length, rev, width):
        k = np.arange(width, dtype=np.int64)[None, :]
        at = np.where(rev[:, None], off[:, None] + length[:, None] - 1 - k, off[:, None] + k)
        inside = k < length[:, None]
        idx = torch.from_numpy(np.where(inside, at, 0)).to(dev)
        out = buf[idx] if buf.numel() else torch.zeros(idx.shape, dtype=torch.uint8, device=dev)
        return torch.where(torch.from_numpy(inside).to(dev), out, 0).to(torch.uint8)

    xs = pack(x, lanes.x_off, lanes.m, (lanes.flags & 1) > 0, M)
    ys = pack(y, lanes.y_off, lanes.n, (lanes.flags & 2) > 0, N)
    m = torch.from_numpy(lanes.m.astype(np.int32)).to(dev)
    n = torch.from_numpy(lanes.n.astype(np.int32)).to(dev)
    return xs, ys, m, n


def nw_lastrow_lanes_plain(x, y, lanes: Lanes, *, table, gap: int):
    """The plain version of ``nw_lastrow_lanes``: the lanes gathered into
    the packed form, the plain row scan, each row written at its offset."""
    dev = x.device
    out = torch.zeros(lanes.total_out, dtype=torch.int32, device=dev)
    if lanes.B == 0:
        return out
    xs, ys, m, n = gather_lanes(x, y, lanes)
    last = nw_lastrow_plain(xs, ys, m, n, table=table, gap=gap)
    j = np.arange(last.shape[1], dtype=np.int64)[None, :]
    keep = j <= lanes.n[:, None]
    at = torch.from_numpy((lanes.out_off[:, None] + j)[keep]).to(dev)
    out[at] = last[torch.from_numpy(keep).to(dev)]
    return out


def _launch(x, y, lanes: Lanes, table, gap, sm_of_block=None):
    if x.dtype != torch.uint8 or y.dtype != torch.uint8 or x.dim() != 1 or y.dim() != 1:
        raise TypeError("x and y must be flat uint8 buffers")
    if table.dtype != torch.int32 or table.shape != (256, 256):
        raise TypeError("table must be (256, 256) int32")
    if lanes.B and (int((lanes.x_off + lanes.m).max()) > x.numel()
                    or int((lanes.y_off + lanes.n).max()) > y.numel()
                    or int(lanes.x_off.min()) < 0 or int(lanes.y_off.min()) < 0):
        raise ValueError("nw_lastrow_lanes: a lane reads past its buffer")
    dev = x.device
    x, y, table = x.contiguous(), y.contiguous(), table.contiguous()
    out = torch.zeros(lanes.total_out, dtype=torch.int32, device=dev)
    desc = torch.from_numpy(lanes.descriptor()).to(dev, non_blocking=False)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    bound = (torch.zeros(lanes.bound_ints, dtype=torch.int64, device=dev)
             if lanes.bound_ints else None)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pgs_nw_lastrow(
            x.data_ptr(), y.data_ptr(), desc.data_ptr(), desc.data_ptr() + 8 * FIELDS * lanes.B,
            lanes.total_chunks, lanes.rows, lanes.warps, table.data_ptr(), int(gap),
            None if bound is None else bound.data_ptr(), ticket.data_ptr(), out.data_ptr(),
            None if sm_of_block is None else sm_of_block.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "pgs_nw_lastrow")
    return out


def nw_lastrow_lanes(x, y, lanes: Lanes, *, table, gap: int):
    """K25 on lanes read in place: x, y flat uint8 buffers, ``lanes`` from
    ``plan_lanes``, table (256, 256) int32 over raw bytes, the linear gap.
    Returns the flat int32 output of ``lanes.total_out``: lane b's H(m_b, j)
    at out_off[b] + j for j = 0..n_b, 0 elsewhere. One launch on CUDA
    tensors (counted in ``nw_lastrow.launches``), the plain version on CPU
    ones."""
    if device_of(x, y, table).type == "cpu":
        return nw_lastrow_lanes_plain(x, y, lanes, table=table, gap=gap)
    out = _launch(x, y, lanes, table, gap)
    nw_lastrow.launches += 1
    return out


def sms_used(x, y, lanes: Lanes, *, table, gap: int) -> int:
    """The distinct SMs one K25 launch on these lanes ran its blocks on,
    each block recording its SM (a launch of its own, not counted in
    ``nw_lastrow.launches``)."""
    sm = torch.full((lanes.blocks,), -1, dtype=torch.int32, device=x.device)
    _launch(x, y, lanes, table, gap, sm_of_block=sm)
    return int(torch.unique(sm).numel())


def nw_lastrow(x, y, m, n, *, table, gap: int):
    """K25: the last NW row of B packed lanes. x (B, M) and y (B, N) uint8,
    m, n (B,) int32 true lengths (clamped to M and N), table (256, 256)
    int32 over raw bytes, the linear gap. Returns (B, N + 1) int32: H(m_b,
    j) for j <= n_b, 0 past it (a lane with m_b = 0 gets row 0, -gap * j).
    The lengths are read on the host to plan the launch; the counter
    ``nw_lastrow.launches`` counts K25 launches."""
    if device_of(x, y, m, n, table).type == "cpu":
        return nw_lastrow_plain(x, y, m, n, table=table, gap=gap)
    B, M = x.shape
    N = y.shape[1]
    if y.shape[0] != B or m.shape != (B,) or n.shape != (B,):
        raise ValueError("nw_lastrow: inconsistent shapes")
    lanes = packed_lanes(m, n, M, N)
    return nw_lastrow_lanes(x.reshape(-1), y.reshape(-1), lanes, table=table,
                            gap=gap).reshape(B, N + 1)


nw_lastrow.launches = 0


def packed_lanes(m, n, M: int, N: int) -> Lanes:
    """The plan of the packed (B, M) form: lane b at b * M and b * N,
    forward, its row at b * (N + 1); lengths clamped to M and N."""
    m, n = (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for v in (m, n))
    m = np.clip(m.astype(np.int64), 0, M)
    n = np.clip(n.astype(np.int64), 0, N)
    b = np.arange(len(m), dtype=np.int64)
    return plan_lanes(m, n, x_off=b * M, y_off=b * N, out_off=b * (N + 1),
                      total_out=len(m) * (N + 1))


def flat_lanes(xs, ys, device):
    """Ragged lists of strings or byte arrays -> (x, y flat uint8 buffers on
    ``device``, their ``Lanes`` plan), the lanes end to end."""
    xb = [_as_bytes(v) for v in xs]
    yb = [_as_bytes(v) for v in ys]
    cat = lambda bs: torch.from_numpy(np.concatenate([np.zeros(0, np.uint8)] + bs)).to(device)
    lanes = plan_lanes([len(v) for v in xb], [len(v) for v in yb])
    return cat(xb), cat(yb), lanes


def nw_lastrow_batch(xs, ys, cfg: ScoringConfig = ScoringConfig(), device=None, table=None):
    """Last NW rows for a ragged batch (global_dp.py:81): xs/ys are lists of
    byte arrays or strings; returns a list of numpy (len(ys[k]) + 1,) int32
    vectors. One K25 launch over the lanes end to end (or the plain version
    on the CPU), one fetch. ``table`` is ``byte_table(cfg, device)`` when
    the caller holds one."""
    check_config(cfg)
    dev = resolve_device(device)
    x, y, lanes = flat_lanes(xs, ys, dev)
    if table is None:
        table = byte_table(cfg, dev)
    (out,) = to_host([nw_lastrow_lanes(x, y, lanes, table=table, gap=int(cfg.gap_penalty))])
    return [out[o : o + k + 1] for o, k in zip(lanes.out_off, lanes.n)]


def nw_score_batch(xs, ys, cfg: ScoringConfig = ScoringConfig(), device=None, table=None):
    """Global alignment scores H(m, n) for a ragged batch (global_dp.py:107)."""
    rows = nw_lastrow_batch(xs, ys, cfg, device, table)
    return np.array([r[-1] for r in rows])
