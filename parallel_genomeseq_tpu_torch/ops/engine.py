"""Score engines: the contract of the JAX package's ``PallasEngine`` that the
short-read slice uses (``score_batch`` :2556, ``score_batch_moves`` :2575),
and ``make_score_engine``, the counterpart of ``swaligner.py:33-56``.

``CudaEngine`` runs the K1/K2 wrappers (``ops/wavefront_cuda``): CUDA tensors
launch the kernels or raise, CPU tensors take the plain route.
``PlainEngine`` always runs the plain PyTorch wavefront (``ops/scan_dp``), on
either device. Inputs may be numpy arrays or tensors; results are tensors on
the engine's device, unpadded (B lanes, (M + N - 1, M, B) moves).

Configurations outside this slice raise NotImplementedError naming the
ROADMAP item that ports them; none is rerouted.
"""

from __future__ import annotations

import torch

from parallel_genomeseq_tpu.utils.config import ScoringConfig, Semantics

from ..utils.device import resolve_device
from . import scan_dp, wavefront_cuda

MAX_M = 2048  # single-strip read-length cap of the JAX kernels (wavefront_pallas.py:55)


def check_supported(cfg: ScoringConfig, tie: str = "colmajor"):
    """Raise NotImplementedError for what this slice does not port yet."""
    if cfg.semantics == Semantics.SAT_UINT8:
        raise NotImplementedError(
            "sat_uint8 semantics (--parity-mode skewed) is not ported yet: ROADMAP A2"
        )
    if tie != "colmajor":
        raise NotImplementedError(f"tie={tie!r} is not ported yet: ROADMAP A2")
    if not cfg.is_uniform:
        raise NotImplementedError(
            "substitution-matrix scoring is not ported yet: ROADMAP A8"
        )
    if cfg.is_affine:
        raise NotImplementedError("affine (Gotoh) gaps are not ported yet: ROADMAP A9")
    if cfg.semantics == Semantics.FLOAT32 or not cfg.is_integral:
        raise NotImplementedError(
            "non-integral or float32 scoring is not ported yet: ROADMAP A2"
        )


def _as_tensor(a, dtype, device):
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    return t.to(device=device, dtype=dtype)


class _Engine:
    def __init__(self, cfg: ScoringConfig = ScoringConfig(), device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._kw = dict(
            match=int(cfg.match), mismatch=int(cfg.mismatch),
            gap=int(cfg.gap_penalty),
        )

    def _inputs(self, x_bm, y_bn, m, n):
        xs = _as_tensor(x_bm, torch.uint8, self.device)
        if xs.shape[1] > MAX_M:
            raise NotImplementedError(
                f"reads longer than {MAX_M} (strip kernels) are not ported "
                "yet: ROADMAP A10"
            )
        return (
            xs, _as_tensor(y_bn, torch.uint8, self.device),
            _as_tensor(m, torch.int32, self.device),
            _as_tensor(n, torch.int32, self.device),
        )

    def score_batch(self, x_bm, y_bn, m, n, need_pos: bool = True):
        """Per-lane 'score', 'i', 'j' (int32); need_pos=False is the
        score-only sweep (i = j = 0)."""
        score, i, j = self._score(*self._inputs(x_bm, y_bn, m, n), need_pos)
        return {"score": score, "i": i, "j": j}

    def score_batch_moves(self, x_bm, y_bn, m, n):
        """Score + argmax + (M + N - 1, M, B) uint8 move codes in one pass."""
        score, i, j, moves = self._score_moves(*self._inputs(x_bm, y_bn, m, n))
        return {"score": score, "i": i, "j": j, "moves": moves}


class CudaEngine(_Engine):
    """The K1/K2 kernels (plain route for CPU tensors)."""

    def _score(self, xs, ys, m, n, need_pos):
        return wavefront_cuda.sw_score(xs, ys, m, n, track_pos=need_pos, **self._kw)

    def _score_moves(self, xs, ys, m, n):
        return wavefront_cuda.sw_score_moves(xs, ys, m, n, **self._kw)


class PlainEngine(_Engine):
    """The plain PyTorch wavefront on the engine's device."""

    def _score(self, xs, ys, m, n, need_pos):
        return scan_dp.sw_score_plain(xs, ys, m, n, track_pos=need_pos, **self._kw)

    def _score_moves(self, xs, ys, m, n):
        return scan_dp.sw_score_moves_plain(xs, ys, m, n, **self._kw)


def make_score_engine(cfg: ScoringConfig = ScoringConfig(), name: str = "auto",
                      device=None):
    """'cuda' (or 'auto') -> CudaEngine, 'plain' -> PlainEngine."""
    if name in ("auto", "cuda"):
        return CudaEngine(cfg, device)
    if name == "plain":
        return PlainEngine(cfg, device)
    raise ValueError(f"unknown engine {name!r}")
