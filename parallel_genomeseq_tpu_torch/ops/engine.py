"""Score engines: the contract of the JAX package's ``PallasEngine`` that the
ported slices use (``score_batch`` :2556, ``score_batch_moves`` :2575, and
the resident database scan of ``score_db_slab_group_jit`` :2381), and
``make_score_engine``, the counterpart of ``swaligner.py:33-56``.

``CudaEngine`` runs the kernel wrappers -- K1/K2 (``ops/wavefront_cuda``)
for uniform scoring, K4/K5 (``ops/profile_cuda``) for a substitution matrix,
and under affine (Gotoh) gaps their forms K6/K7 and K8/K9, walked by K3 or,
affine, K10 (``ops/traceback``): CUDA tensors launch the kernels or raise,
CPU tensors take the plain route. ``PlainEngine`` always runs the plain
PyTorch wavefront (``ops/scan_dp``) and walk (``ops/traceback``), on either
device. Inputs may be numpy arrays or tensors of raw bytes; results are
tensors on the engine's device, unpadded (B lanes, (M + N - 1, M, B) moves).

Configurations outside the ported slices raise NotImplementedError naming
the ROADMAP item that ports them; none is rerouted.
"""

from __future__ import annotations

import torch

from ..utils.config import ScoringConfig, Semantics
from ..utils.device import resolve_device
from . import profile_cuda, scan_dp, traceback, wavefront_cuda

MAX_M = 2048  # single-strip read-length cap of the JAX kernels (wavefront_pallas.py:55)


def check_supported(cfg: ScoringConfig, tie: str = "colmajor"):
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.semantics == Semantics.SAT_UINT8:
        raise NotImplementedError(
            "sat_uint8 semantics (--parity-mode skewed) is not ported yet: ROADMAP A2"
        )
    if tie != "colmajor":
        raise NotImplementedError(f"tie={tie!r} is not ported yet: ROADMAP A2")
    if cfg.semantics == Semantics.FLOAT32 or not cfg.is_integral:
        raise NotImplementedError(
            "non-integral or float32 scoring is not ported yet: ROADMAP A2"
        )


def _as_tensor(a, dtype, device):
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    return t.to(device=device, dtype=dtype)


def _check_length(rows: int, what: str):
    if rows > MAX_M:
        raise NotImplementedError(
            f"{what} longer than {MAX_M} (strip kernels) are not ported yet: "
            "ROADMAP A10"
        )


class _Engine:
    def __init__(self, cfg: ScoringConfig = ScoringConfig(), device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gap = int(cfg.gap_penalty)
        gaps = {"gap": self.gap}
        if cfg.is_affine:  # `gap` is then the extension cost
            gaps["gap_open"] = int(cfg.gap_open)
        if cfg.is_uniform:
            self._kw = dict(match=int(cfg.match), mismatch=int(cfg.mismatch), **gaps)
        else:
            lut, table = scan_dp.profile_tables(cfg)
            self.encode_lut = lut  # byte -> compact code, on the host
            self._lut = torch.from_numpy(lut).to(self.device)
            self.table = torch.from_numpy(table).to(self.device)
            self._kw = dict(table=self.table, **gaps)

    def _inputs(self, x_bm, y_bn, m, n):
        xs = _as_tensor(x_bm, torch.uint8, self.device)
        _check_length(xs.shape[1], "reads")
        ys = _as_tensor(y_bn, torch.uint8, self.device)
        if not self.cfg.is_uniform:  # raw bytes -> compact codes
            xs, ys = self._lut[xs.long()], self._lut[ys.long()]
        return (
            xs, ys, _as_tensor(m, torch.int32, self.device),
            _as_tensor(n, torch.int32, self.device),
        )

    def score_batch(self, x_bm, y_bn, m, n, need_pos: bool = True):
        """Per-lane 'score', 'i', 'j' (int32); need_pos=False gives
        i = j = 0, as the JAX engine does (:3171-3175)."""
        xs, ys, m, n = self._inputs(x_bm, y_bn, m, n)
        if self.cfg.is_uniform:
            score, i, j = self._uniform(xs, ys, m, n, need_pos)
        else:
            score, i, j = self._profile(xs, ys, m, n, None)
            if not need_pos:
                i, j = torch.zeros_like(i), torch.zeros_like(j)
        return {"score": score, "i": i, "j": j}

    def score_batch_moves(self, x_bm, y_bn, m, n):
        """Score + argmax + (M + N - 1, M, B) uint8 move codes in one pass."""
        args = self._inputs(x_bm, y_bn, m, n)
        score, i, j, moves = (
            self._uniform_moves(*args) if self.cfg.is_uniform else self._profile_moves(*args)
        )
        return {"score": score, "i": i, "j": j, "moves": moves}

    def score_slab(self, query_codes, slab, y_off, lens):
        """The database scan: one query (M,) of compact codes against every
        lane of a resident (R,) code slab, lane b = ``slab[y_off[b] :
        y_off[b] + lens[b]]``. Returns per-lane (score, i, j) int32, j the
        1-based entry index of the maximum."""
        if self.cfg.is_uniform:
            raise ValueError("the slab scan needs a substitution-matrix config")
        _check_length(query_codes.shape[0], "queries")
        m = torch.full_like(lens, query_codes.shape[0])
        return self._profile(query_codes, slab, m, lens, y_off)


class CudaEngine(_Engine):
    """The kernels (plain route for CPU tensors): K1/K2/K4/K5 and the K3
    walk, or under affine gaps K6/K7/K8/K9 and the K10 walk."""

    def __init__(self, cfg: ScoringConfig = ScoringConfig(), device=None):
        super().__init__(cfg, device)
        w, p, t = wavefront_cuda, profile_cuda, traceback
        if cfg.is_affine:
            self._sw, self._sw_moves = w.sw_score_affine, w.sw_score_affine_moves
            self._pr, self._pr_moves = p.sw_profile_affine, p.sw_profile_affine_moves
            self._walk = t.walk_moves_affine
        else:
            self._sw, self._sw_moves = w.sw_score, w.sw_score_moves
            self._pr, self._pr_moves = p.sw_profile, p.sw_profile_moves
            self._walk = t.walk_moves

    def _uniform(self, xs, ys, m, n, need_pos):
        return self._sw(xs, ys, m, n, track_pos=need_pos, **self._kw)

    def _uniform_moves(self, xs, ys, m, n):
        return self._sw_moves(xs, ys, m, n, **self._kw)

    def _profile(self, x, y, m, n, y_off):
        return self._pr(x, y, m, n, y_off=y_off, **self._kw)

    def _profile_moves(self, xs, ys, m, n):
        return self._pr_moves(xs, ys, m, n, **self._kw)

    def walk(self, moves, x_mb, y_bn, i0, j0, max_steps: int):
        return self._walk(moves, x_mb, y_bn, i0, j0, max_steps=max_steps)


class PlainEngine(_Engine):
    """The plain PyTorch wavefront and walk on the engine's device."""

    def _uniform(self, xs, ys, m, n, need_pos):
        return scan_dp.sw_score_plain(xs, ys, m, n, track_pos=need_pos, **self._kw)

    def _uniform_moves(self, xs, ys, m, n):
        return scan_dp.sw_score_moves_plain(xs, ys, m, n, **self._kw)

    def _profile(self, x, y, m, n, y_off):
        return scan_dp.sw_profile_plain(x, y, m, n, y_off=y_off, **self._kw)

    def _profile_moves(self, xs, ys, m, n):
        return scan_dp.sw_profile_moves_plain(xs, ys, m, n, **self._kw)

    def walk(self, moves, x_mb, y_bn, i0, j0, max_steps: int):
        walk = (traceback._walk_moves_affine_plain if self.cfg.is_affine
                else traceback._walk_moves_plain)
        return walk(moves, x_mb, y_bn, i0, j0, max_steps)


def make_score_engine(cfg: ScoringConfig = ScoringConfig(), name: str = "auto",
                      device=None):
    """'cuda' (or 'auto') -> CudaEngine, 'plain' -> PlainEngine."""
    if name in ("auto", "cuda"):
        return CudaEngine(cfg, device)
    if name == "plain":
        return PlainEngine(cfg, device)
    raise ValueError(f"unknown engine {name!r}")
