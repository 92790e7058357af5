"""Score engines: the contract of the JAX package's ``PallasEngine`` that the
ported slices use (``score_batch`` :2556, ``score_batch_moves`` :2575,
``score_batch_strip_moves`` :2668, and the resident database scan of
``score_db_slab_group_jit`` :2381), and ``make_score_engine``, the
counterpart of ``swaligner.py:33-56``.

``CudaEngine`` runs the kernel wrappers -- K1/K2 (``ops/wavefront_cuda``)
for uniform scoring, K4/K5 (``ops/profile_cuda``) for a substitution matrix,
and under affine (Gotoh) gaps their forms K6/K7 and K8/K9, walked by K3 or,
affine, K10 (``ops/traceback``); reads longer than MAX_M go to the strip
kernels of ``ops/strips_cuda`` -- K11 (score), K12 (checkpoints) and K13
(replay, a group of strips a launch), walked a group a launch by K14; under
affine gaps K15, K16 (H and F checkpoints) and K17, walked by K18; under a
substitution matrix with linear gaps K19, K20 and K21, walked by K14, and
with affine gaps K22, K23 (H and F checkpoints) and K24, walked by K18
(K19, or K22, also scans a resident slab for a query longer than MAX_M).
Every scoring family runs at every length. The reference-parity forms --
``Semantics.SAT_UINT8`` (uniform scores, linear gaps) and/or the skewed
tie, ``tie="skewed"`` (linear gaps) -- run K26 (``sw_score_parity``: the
score-only sweep, argmax and moves, uniform or, exact, from a table) and,
for reads longer than MAX_M, K27 (``sw_score_strips_parity``, uniform;
score and argmax), walked by K3. CUDA tensors launch the kernels or
raise, CPU tensors take the plain route.
``PlainEngine`` always runs the plain PyTorch wavefront (``ops/scan_dp``)
and walks (``ops/traceback``), on either device. Inputs may be numpy arrays
or tensors of raw bytes; results are tensors on the engine's device,
unpadded (B lanes, (M + N - 1, M, B) moves).

Configurations outside the ported slices (``check_supported``) raise
NotImplementedError naming the ROADMAP item that ports them; none is
rerouted. What the JAX ``ScanEngine`` itself refuses (a non-uniform
SAT_UINT8 config, the skewed tie under affine gaps) raises its ValueError.
"""

from __future__ import annotations

import time

import torch

from ..utils.config import ScoringConfig, Semantics
from ..utils.device import resolve_device
from . import profile_cuda, scan_dp, strips_cuda, traceback, wavefront_cuda

# Single-strip read-length cap of the JAX kernels (wavefront_pallas.py:55):
# longer reads take the strip path (wavefront_pallas.py:3001), here too.
MAX_M = 2048
STRIP_S = scan_dp.STRIP_S

# The long-read (strip) functions of each scoring family, keyed by
# ``strip_key(cfg)`` = (cfg.is_affine, cfg.is_uniform): (sweep,
# checkpointing sweep, group replay, group walk). The kernels' wrappers are
# K11-K14, affine K15-K18, and under a substitution matrix K19-K21 walked by
# K14, affine K22-K24 walked by K18; the plain versions share the full sweeps
# (``sw_score_plain``, ``sw_profile_plain``).
STRIP_KERNELS = {
    (False, True): (strips_cuda.sw_score_strips, strips_cuda.sw_score_strips_ckpt,
                    strips_cuda.strip_moves_group, traceback.walk_strip_group),
    (True, True): (strips_cuda.sw_score_strips_affine,
                   strips_cuda.sw_score_strips_affine_ckpt, strips_cuda.strip_affine_moves_group,
                   traceback.walk_strip_group_affine),
    (False, False): (strips_cuda.sw_score_strips_profile,
                     strips_cuda.sw_score_strips_profile_ckpt,
                     strips_cuda.strip_profile_moves_group, traceback.walk_strip_group),
    (True, False): (strips_cuda.sw_score_strips_profile_affine,
                    strips_cuda.sw_score_strips_profile_affine_ckpt,
                    strips_cuda.strip_profile_affine_moves_group,
                    traceback.walk_strip_group_affine),
}
STRIP_PLAIN = {
    (False, True): (scan_dp.sw_score_plain, scan_dp.sw_score_ckpt_plain,
                    scan_dp.strip_moves_group_plain, traceback._walk_strip_group_plain),
    (True, True): (scan_dp.sw_score_plain, scan_dp.sw_score_affine_ckpt_plain,
                   scan_dp.strip_affine_moves_group_plain,
                   traceback._walk_strip_group_affine_plain),
    (False, False): (scan_dp.sw_profile_plain, scan_dp.sw_profile_ckpt_plain,
                     scan_dp.strip_profile_moves_group_plain, traceback._walk_strip_group_plain),
    (True, False): (scan_dp.sw_profile_plain, scan_dp.sw_profile_affine_ckpt_plain,
                    scan_dp.strip_profile_affine_moves_group_plain,
                    traceback._walk_strip_group_affine_plain),
}


def strip_key(cfg: ScoringConfig):
    """The key of ``cfg``'s scoring family in STRIP_KERNELS / STRIP_PLAIN."""
    return cfg.is_affine, cfg.is_uniform


def check_supported(cfg: ScoringConfig, tie: str = "colmajor"):
    """Raise NotImplementedError for what the port does not run yet: float32
    values (FLOAT32, or non-integral scoring outside SAT_UINT8, whose
    operands are truncated to integers as the JAX ``ScanEngine`` truncates
    them)."""
    if tie not in ("colmajor", "skewed"):
        raise ValueError(f"unknown tie {tie!r} (expected 'colmajor' or 'skewed')")
    sat = cfg.semantics == Semantics.SAT_UINT8
    if cfg.semantics == Semantics.FLOAT32 or (not sat and not cfg.is_integral):
        raise NotImplementedError(
            "non-integral or float32 scoring is not ported yet: ROADMAP A2b"
        )


def check_scan_config(cfg: ScoringConfig, tie: str = "colmajor"):
    """``check_supported``, then what the JAX ``ScanEngine.__init__``
    refuses, with its ValueErrors (scan_dp.py:360-378)."""
    check_supported(cfg, tie)
    if cfg.semantics == Semantics.SAT_UINT8 and not cfg.is_uniform:
        raise ValueError("SAT_UINT8 supports uniform scoring only")
    if cfg.is_affine and tie == "skewed":
        raise ValueError(
            "affine gaps are an extension without a reference skewed "
            "build to mirror; use tie='colmajor'"
        )


def _as_tensor(a, dtype, device):
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    return t.to(device=device, dtype=dtype)


class _Engine:
    _strip_fns = STRIP_KERNELS  # or STRIP_PLAIN

    def __init__(self, cfg: ScoringConfig = ScoringConfig(), device=None,
                 tie: str = "colmajor"):
        """``tie``: the argmax tie-break, 'colmajor' (min j, then min i) or
        'skewed' (the reference binary's raw storage order, as the JAX
        ``ScanEngine(cfg, tie)`` takes it)."""
        check_scan_config(cfg, tie)
        self.cfg = cfg
        self.tie = tie
        # The reference-parity forms (K26, K27): SAT_UINT8 values or the skewed tie.
        self.parity = cfg.semantics == Semantics.SAT_UINT8 or tie == "skewed"
        self._st, self._st_ckpt, self._st_moves, self._st_walk = \
            self._strip_fns[strip_key(cfg)]
        self.device = resolve_device(device)
        self.gap = int(cfg.gap_penalty)
        gaps = {"gap": self.gap}
        if cfg.is_affine:  # `gap` is then the extension cost
            gaps["gap_open"] = int(cfg.gap_open)
        match, mismatch = int(cfg.match), int(cfg.mismatch)
        if self.parity:
            sat = cfg.semantics == Semantics.SAT_UINT8
            gaps.update(sat=sat, tie=tie)
            if sat:  # the clipped operands (scan_dp.sat_operands)
                match, mismatch, self.gap = scan_dp.sat_operands(
                    cfg.match, cfg.mismatch, cfg.gap_penalty)
                gaps["gap"] = self.gap
        if cfg.is_uniform:
            self._kw = dict(match=match, mismatch=mismatch, **gaps)
        else:
            lut, table = scan_dp.profile_tables(cfg)
            self.encode_lut = lut  # byte -> compact code, on the host
            self._lut = torch.from_numpy(lut).to(self.device)
            self.table = torch.from_numpy(table).to(self.device)
            self._kw = dict(table=self.table, **gaps)

    def _inputs(self, x_bm, y_bn, m, n, raw: bool = False):
        """(xs, ys, m, n) on the engine's device, xs and ys as compact codes
        under a matrix; ``raw`` appends the raw bytes (xs, ys) too."""
        x_raw = _as_tensor(x_bm, torch.uint8, self.device)
        y_raw = _as_tensor(y_bn, torch.uint8, self.device)
        xs, ys = x_raw, y_raw
        if not self.cfg.is_uniform:  # raw bytes -> compact codes
            xs, ys = self._lut[x_raw.long()], self._lut[y_raw.long()]
        out = (xs, ys, _as_tensor(m, torch.int32, self.device),
               _as_tensor(n, torch.int32, self.device))
        return (*out, x_raw, y_raw) if raw else out

    def score_batch(self, x_bm, y_bn, m, n, need_pos: bool = True):
        """Per-lane 'score', 'i', 'j' (int32); need_pos=False gives
        i = j = 0, as the JAX engine does (:3171-3175)."""
        xs, ys, m, n = self._inputs(x_bm, y_bn, m, n)
        if self.parity:
            if xs.shape[1] <= MAX_M:
                score, i, j = self._parity(xs, ys, m, n, track_pos=need_pos, **self._kw)
            elif self.cfg.is_uniform:
                score, i, j = self._parity_st(xs, ys, m, n, **self._kw)
                if not need_pos:
                    i, j = torch.zeros_like(i), torch.zeros_like(j)
            else:
                raise NotImplementedError(
                    f"the skewed tie under a substitution matrix past {MAX_M} rows is not "
                    "ported yet: ROADMAP A2b")
            return {"score": score, "i": i, "j": j}
        if xs.shape[1] > MAX_M:
            score, i, j = self._st(xs, ys, m, n, **self._kw)
            if not need_pos:
                i, j = torch.zeros_like(i), torch.zeros_like(j)
        elif self.cfg.is_uniform:
            score, i, j = self._uniform(xs, ys, m, n, need_pos)
        else:
            score, i, j = self._profile(xs, ys, m, n, None)
            if not need_pos:
                i, j = torch.zeros_like(i), torch.zeros_like(j)
        return {"score": score, "i": i, "j": j}

    def score_batch_moves(self, x_bm, y_bn, m, n):
        """Score + argmax + (M + N - 1, M, B) uint8 move codes in one pass."""
        args = self._inputs(x_bm, y_bn, m, n)
        if self.parity:
            if args[0].shape[1] > MAX_M:
                raise NotImplementedError(
                    f"moves of the reference-parity forms past {MAX_M} rows (JAX's scan "
                    "materialises them up to 2 GiB) are not ported yet: ROADMAP A2b")
            score, i, j, moves = self._parity(*args, emit_moves=True, **self._kw)
        elif self.cfg.is_uniform:
            score, i, j, moves = self._uniform_moves(*args)
        else:
            score, i, j, moves = self._profile_moves(*args)
        return {"score": score, "i": i, "j": j, "moves": moves}

    def score_batch_strip_moves(self, x_bm, y_bn, m, n, max_steps: int):
        """Score, argmax and the whole greedy walk for reads longer than
        MAX_M, in checkpoint memory rather than the (M + N - 1, M, B) move
        tensor: one checkpointing sweep (K12), then the strips of STRIP_S
        rows from the bottom of the matrix up, their moves replayed from the
        checkpoints (K13) and every lane inside each walked (K14), as
        wavefront_pallas.py:2668-2764. Under affine gaps the same loop is
        ``score_batch_strip_affine_moves`` (:2766-2871): K16 checkpoints H
        and F, K17 replays from both, and K18 walks with the gap state
        carried from strip to strip. Under a substitution matrix it is
        ``_strip_profile_moves`` (:2873-2991; affine from
        ``score_batch_strip_affine_moves`` :2791-2794): K20 and K21 (affine
        K23 and K24) score compact codes, and K14 (K18) walks the raw
        bytes.

        The strips go in groups: one host sync reads the lanes still
        walking and the highest strip any of them can reach (and ends the
        loop when none can), ``strips_cuda.replay_group`` takes G, one
        replay launch writes the group's G strips, each only where the walk
        can still read it, into one moves buffer allocated for the call, and
        one walk launch (K14, K18) walks the group's strips, top first, with
        no sync between.
        On CPU tensors G = 1, a strip a group. Returns per-lane 'score',
        'i', 'j', 'pos', 'steps' (B,) int32, 'cx', 'cy' (max_steps, B) uint8,
        'level_us', one entry a strip, top strip (largest rows) first: a
        group's replay-and-walk microseconds on its first-walked strip and
        0 on its other strips and on strips no group replayed, and 'groups',
        each group's G."""
        if self.parity:
            raise NotImplementedError(
                "the strip traceback of the reference-parity forms is not ported yet: "
                "ROADMAP A2b")
        xs, ys, m, n, x_raw, y_raw = self._inputs(x_bm, y_bn, m, n, raw=True)
        if xs.shape[1] <= MAX_M:
            raise ValueError(f"the strip path is for reads longer than {MAX_M}")
        score, i, j, *ck = self._st_ckpt(xs, ys, m, n, **self._kw)  # H (and F) checkpoints
        x_mb = x_raw.T.contiguous()  # the walk emits raw bytes, not codes
        state = traceback.new_strip_state(i, j, max_steps, affine=self.cfg.is_affine)
        cur, active = state[0], state[3]
        (B, M), N = xs.shape, ys.shape[1]
        nstrips = -(-M // STRIP_S)
        level_us = [0.0] * nstrips
        groups = []
        moves = None  # (G, B, N, STRIP_S), allocated by the first group
        timing = None  # (level, start) of the group in flight
        ncodes = 0 if self.cfg.is_uniform else self.table.shape[0]
        while True:
            lanes, top = torch.stack([active.sum(),
                                      torch.where(active, cur - 1, -1).max().long()]).tolist()
            if timing is not None:
                level_us[timing[0]] = (time.perf_counter() - timing[1]) * 1e6
            if not lanes or top < 0:  # every walk ended (affine: some at i = 0)
                break
            s = top // STRIP_S
            held = moves.numel() if moves is not None else 0
            G = max(1, min(s + 1, strips_cuda.replay_group(
                s + 1, lanes, B * N * STRIP_S, self.device, affine=self.cfg.is_affine,
                ncodes=ncodes, held=held)))
            if moves is None:
                moves = torch.empty((G, B, N, STRIP_S), dtype=torch.uint8, device=self.device)
            G = min(G, moves.shape[0])
            low = s - G + 1
            timing = (nstrips - 1 - s, time.perf_counter())
            group = self._st_moves(xs, ys, m, n, *ck, low, moves[:G], (cur, state[1], active),
                                   **self._kw)
            self._st_walk(group, x_mb, y_raw, low, state, max_steps=max_steps)
            groups.append(G)
        pos, steps, cx, cy = state[2], state[4], state[5], state[6]
        return {"score": score, "i": i, "j": j, "pos": pos, "cx": cx, "cy": cy,
                "steps": steps, "level_us": tuple(level_us), "groups": tuple(groups)}

    def score_slab(self, query_codes, slab, y_off, lens):
        """The database scan: one query (M,) of compact codes against every
        lane of a resident (R,) code slab, lane b = ``slab[y_off[b] :
        y_off[b] + lens[b]]``, in one launch: K4 (K8 under affine gaps), or
        for a query longer than MAX_M the strip sweep K19 (K22). Returns per-lane
        (score, i, j) int32, j the 1-based entry index of the maximum."""
        if self.cfg.is_uniform:
            raise ValueError("the slab scan needs a substitution-matrix config")
        if self.parity:
            raise ValueError("the slab scan takes the column-major tie only")
        m = torch.full_like(lens, query_codes.shape[0])
        if query_codes.shape[0] > MAX_M:  # K19's (K22's) slab form
            return self._st(query_codes, slab, m, lens, y_off=y_off, **self._kw)
        return self._profile(query_codes, slab, m, lens, y_off)


class CudaEngine(_Engine):
    """The kernels (plain route for CPU tensors): K1/K2/K4/K5, the K3 walk
    and the strips K11-K14 (K19-K21 and K14 under a matrix), or under affine
    gaps K6/K7/K8/K9, the K10 walk and the strips K15-K18 (K22-K24 and K18
    under a matrix); the reference-parity forms K26, K27 and K3."""

    _parity = staticmethod(wavefront_cuda.sw_score_parity)
    _parity_st = staticmethod(strips_cuda.sw_score_strips_parity)

    def __init__(self, cfg: ScoringConfig = ScoringConfig(), device=None,
                 tie: str = "colmajor"):
        super().__init__(cfg, device, tie)
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

    _strip_fns = STRIP_PLAIN
    _parity = staticmethod(scan_dp.sw_score_parity_plain)
    _parity_st = staticmethod(scan_dp.sw_score_parity_plain)

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
                      device=None, tie: str = "colmajor"):
    """'cuda' (or 'auto') -> CudaEngine, 'plain' -> PlainEngine."""
    if name in ("auto", "cuda"):
        return CudaEngine(cfg, device, tie)
    if name == "plain":
        return PlainEngine(cfg, device, tie)
    raise ValueError(f"unknown engine {name!r}")
