"""On-card tests of the port's CUDA kernels, each against its plain PyTorch
version on the same CUDA tensors. Marked ``gpu``; they skip where there is
no card. This file imports neither jax nor the test conftest, so it also runs
on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import collections
import os

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu_torch.cli import solve_small, solve_uniprot
from parallel_genomeseq_tpu_torch.ops import profile_cuda, scan_dp, traceback, wavefront_cuda
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
from parallel_genomeseq_tpu_torch.utils.synth import write_dataset, write_protein_dataset

pytestmark = pytest.mark.gpu
KW = dict(match=3, mismatch=-3, gap=2)
BWA = dict(match=1, mismatch=-4, gap_open=6, gap=1)  # BWA-MEM's affine scoring
BWA_FLAGS = ["--match", "1", "--mismatch", "-4", "--gap-open", "6", "--gap-penalty", "1"]
AFFINE_FLAGS = ["--gap-open", "10", "--gap-penalty", "2"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def ragged(seed, dev, B=67, M=96, N=300, motif=False):
    """Random DNA lanes of ragged true lengths, each read partly planted in
    its reference so that alignments carry gaps and mismatches; with
    ``motif``, read and reference repeat one short motif, so that the best
    score ties across many cells, rows and threads' bands."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    m = rng.integers(1, M + 1, B).astype(np.int32)
    n = rng.integers(1, N + 1, B).astype(np.int32)
    xs = np.full((B, M), 1, np.uint8)
    ys = np.full((B, N), 2, np.uint8)
    for b in range(B):
        if motif:
            unit = rng.choice(acgt, int(rng.integers(2, 5)))
            ys[b, : n[b]] = np.resize(unit, n[b])
            xs[b, : m[b]] = np.resize(unit, m[b])
            continue
        ys[b, : n[b]] = rng.choice(acgt, n[b])
        xs[b, : m[b]] = rng.choice(acgt, m[b])
        k = min(m[b], n[b]) // 2
        if k:
            xs[b, :k] = ys[b, n[b] - k : n[b]]
    return [torch.from_numpy(a).to(dev) for a in (xs, ys, m, n)]


# K1/K2/K6/K7 cases (csrc/wavefront.cu, a warp a lane, kRows rows a thread
# for 32 * kRows >= M, L lanes a block for the moves): (ragged's arguments,
# L for K2/K7 or 0 for the kernel's rule, a change to the lanes). M at each
# rows-a-thread boundary; B of 1, 67 and one past a multiple of L, and B
# that take the moves in 4-, 2- and 1-byte runs; lanes of
# very different n_b in one block; m_b or n_b of 1 or 0 and an all-zero
# lane; ties across bands from repeated motifs.
WAVE_CASES = {
    "seed0": (dict(seed=0), 0, None),
    "seed1": (dict(seed=1), 0, None),
    "rows_1": (dict(seed=2, M=1, N=120), 0, None),
    "rows_32": (dict(seed=3, M=32, N=200), 0, None),
    "rows_33": (dict(seed=4, B=70, M=33, N=200), 4, None),
    "rows_128": (dict(seed=5, B=513, M=128, N=640), 4, None),
    "main_shape": (dict(seed=14, B=512, M=128, N=640), 0, None),
    "rows_129": (dict(seed=6, B=33, M=129, N=300), 16, None),
    "rows_512": (dict(seed=7, B=9, M=512, N=300), 8, None),
    "rows_513": (dict(seed=8, B=5, M=513, N=200), 4, None),
    "rows_2048": (dict(seed=9, B=3, M=2048, N=150), 2, None),
    "b1": (dict(seed=10, B=1), 0, None),
    "mixed_n": (dict(seed=11, B=68, M=128, N=640), 16, "mixed_n"),
    "edges": (dict(seed=12, B=37, M=64, N=100), 2, "edges"),
    "motif_ties": (dict(seed=13, B=40, M=256, N=400, motif=True), 8, None),
}


def wave_lanes(case, dev):
    """(xs, ys, m, n, L) of a WAVE_CASES case on ``dev``."""
    kwargs, lanes, change = WAVE_CASES[case]
    xs, ys, m, n = ragged(dev=dev, **kwargs)
    N = ys.shape[1]
    if change == "mixed_n":  # 1, 2, 31, 32, 33 columns beside full ones in each block
        short = torch.tensor([1, 2, 31, 32, 33, N, N - 1], dtype=torch.int32, device=dev)
        n.copy_(short[torch.arange(n.shape[0], device=dev) % short.shape[0]])
    elif change == "edges":  # m_b = 1, n_b = 1, m_b = 0, n_b = 0, both 1, all-zero lanes
        m[0], n[1], m[2], n[3] = 1, 1, 0, 0
        m[4] = n[4] = 1
        xs[5], ys[5] = 7, 9
        ys[6, : int(n[6])] = xs[6, 0]  # one read byte against a run of it
        m[6] = 1
    return xs, ys, m, n, lanes


@pytest.mark.parametrize("case", list(WAVE_CASES))
@pytest.mark.parametrize("track_pos", [False, True])
def test_k1_matches_plain(cuda, case, track_pos):
    xs, ys, m, n, _ = wave_lanes(case, cuda)
    before = wavefront_cuda.sw_score.launches
    got = wavefront_cuda.sw_score(xs, ys, m, n, track_pos=track_pos, **KW)
    want = scan_dp.sw_score_plain(xs, ys, m, n, track_pos=track_pos, **KW)
    torch.cuda.synchronize()
    assert wavefront_cuda.sw_score.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.parametrize("case", list(WAVE_CASES))
def test_k2_and_k3_match_plain(cuda, case):
    xs, ys, m, n, lanes = wave_lanes(case, cuda)
    got = wavefront_cuda.sw_score_moves(xs, ys, m, n, lanes=lanes, **KW)
    want = scan_dp.sw_score_moves_plain(xs, ys, m, n, **KW)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert valid_moves(got[3], want[3], m, n)
    x_mb = xs.T.contiguous()
    before = traceback.walk_moves.launches
    walked = traceback.walk_moves(got[3], x_mb, ys, got[1], got[2], max_steps=250)
    plain = traceback._walk_moves_plain(got[3], x_mb, ys, got[1], got[2], 250)
    assert traceback.walk_moves.launches == before + 1
    for g, w in zip(walked, plain):
        assert torch.equal(g, w)


def test_wavefront_launch_shapes(cuda):
    """The launch rules of csrc/wavefront.cu: one warp a lane up to 1,024
    rows and two beyond; the fewest rows a thread (1 to 32) that cover M;
    the lanes a block the largest power of two (up to 4 for K1/K6, up to
    the stage's limit for K2/K7) whose busiest SM holds no more warps than
    with one lane a block. The table form (K5/K9), moves only, takes K2/K7's
    rules, but two warps a lane past 64 rows when the lanes are no more than
    the SMs. An M past 2,048 raises, for K5/K9 naming the strip path."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def busiest(B, L, W):
        return -(-(-(-B // L)) // sms) * L * W

    for M, W, rows in ((1, 1, 1), (32, 1, 1), (33, 1, 2), (128, 1, 4), (129, 1, 8),
                       (512, 1, 16), (513, 1, 32), (1024, 1, 32), (1025, 2, 32), (2048, 2, 32)):
        warps_cap = 16 if rows <= 8 else 128 // rows
        for mode in ("score_only", "track_pos", "moves"):
            cap = warps_cap // W if mode == "moves" else min(4, warps_cap // W)
            for B in (1, 67, 512, 8704):
                shape = wavefront_cuda.launch_shape(M, B, affine=False, mode=mode)
                want = max(L for L in (1, 2, 4, 8, 16)
                           if L <= cap and busiest(B, L, W) <= busiest(B, 1, W))
                assert (shape["rows"], shape["warps"], shape["lanes"]) == (rows, W, want), \
                    (M, mode, B, shape)
                assert shape["blocks_per_sm"] >= 1
                if mode == "moves":  # K5/K9: two warps also past 64 rows on few lanes
                    Wt = 2 if M > 1024 or (B <= sms and M > 64) else 1
                    rows_t = min(r for r in (1, 2, 4, 8, 16, 32) if 32 * Wt * r >= M)
                    cap_t = (16 if rows_t <= 8 else 128 // rows_t) // Wt
                    L = max(L for L in (1, 2, 4, 8, 16)
                            if L <= cap_t and busiest(B, L, Wt) <= busiest(B, 1, Wt))
                    for affine in (False, True):
                        table = wavefront_cuda.launch_shape(M, B, affine=affine, mode=mode,
                                                            ncodes=25)
                        assert (table["rows"], table["warps"], table["lanes"]) == \
                               (rows_t, Wt, L), (M, B, table)
                        # 25 x 25 x 4 table bytes (to 16), the rings, the staged bytes
                        assert table["smem"] == (2512 + (Wt - 1) * L * 32 * 8
                                                 + 2 * 8 * Wt * 32 * rows_t * L)
                        assert table["blocks_per_sm"] >= 1
                else:
                    with pytest.raises(RuntimeError):
                        wavefront_cuda.launch_shape(M, B, affine=False, mode=mode, ncodes=25)
    xs = torch.zeros((2, 2049), dtype=torch.uint8, device=cuda)
    ys = torch.zeros((2, 8), dtype=torch.uint8, device=cuda)
    m = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="MAX_ROWS"):
        wavefront_cuda.sw_score(xs, ys, m, m, **KW)
    table = torch.zeros((25, 25), dtype=torch.int32, device=cuda)
    for fn, gaps in ((profile_cuda.sw_profile_moves, dict(gap=12)),
                     (profile_cuda.sw_profile_affine_moves, dict(gap_open=10, gap=2))):
        with pytest.raises(ValueError, match="MAX_ROWS.*strip path"):
            fn(xs, ys, m, m, table=table, **gaps)


@pytest.mark.parametrize("case", ["seed0", "rows_33", "rows_128", "mixed_n", "edges",
                                  "motif_ties"])
def test_k2_and_k7_two_warps_a_lane_match_plain(cuda, case):
    """K2 and K7 with two warps a lane (the rows handed from warp to warp
    through shared memory) where the rule takes one: equal to the plain
    version, moves cell for cell."""
    xs, ys, m, n, lanes = wave_lanes(case, cuda)
    for fn, kw in ((wavefront_cuda.sw_score_moves, KW),
                   (wavefront_cuda.sw_score_affine_moves, BWA)):
        got = fn(xs, ys, m, n, lanes=max(1, lanes // 2), warps=2, **kw)
        want = scan_dp.sw_score_moves_plain(xs, ys, m, n, **kw)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
        assert valid_moves(got[3], want[3], m, n)


def test_lengths_beyond_the_padded_shape_match_plain(cuda):
    """Lanes with m_b > M or n_b > N, and walks started outside the matrix:
    the kernels clamp as the plain versions do and stay in bounds."""
    xs, ys, m, n = ragged(2, cuda)
    M, N = xs.shape[1], ys.shape[1]
    m[:4] = M + torch.tensor([1, 9, 1000, 2**30], dtype=torch.int32, device=cuda)
    n[2:6] = N + torch.tensor([1, 17, 5000, 2**30], dtype=torch.int32, device=cuda)
    for track_pos in (False, True):
        got = wavefront_cuda.sw_score(xs, ys, m, n, track_pos=track_pos, **KW)
        want = scan_dp.sw_score_plain(xs, ys, m, n, track_pos=track_pos, **KW)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = wavefront_cuda.sw_score_moves(xs, ys, m, n, **KW)
    want = scan_dp.sw_score_moves_plain(xs, ys, m, n, **KW)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    D = M + N - 1
    mc, nc = m.clamp(max=M), n.clamp(max=N)
    d = torch.arange(D, device=cuda)[:, None, None]
    r = torch.arange(M, device=cuda)[None, :, None]
    valid = (r < mc) & (d >= r) & (d - r < nc)
    assert torch.equal(got[3][valid], want[3][valid])
    # The moves outside the lanes' matrices are left unwritten by K2, so the
    # walk from out-of-range cells runs on the plain version's moves.
    x_mb = xs.T.contiguous()
    i0 = torch.full_like(m, M + 50)
    j0 = torch.full_like(n, N + 70)
    walked = traceback.walk_moves(want[3], x_mb, ys, i0, j0, max_steps=40)
    plain = traceback._walk_moves_plain(want[3], x_mb, ys, i0, j0, 40)
    for g, w in zip(walked, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", list(WAVE_CASES))
@pytest.mark.parametrize("track_pos", [False, True])
def test_k6_matches_plain(cuda, case, track_pos):
    xs, ys, m, n, _ = wave_lanes(case, cuda)
    before = wavefront_cuda.sw_score_affine.launches
    got = wavefront_cuda.sw_score_affine(xs, ys, m, n, track_pos=track_pos, **BWA)
    want = scan_dp.sw_score_plain(xs, ys, m, n, track_pos=track_pos, **BWA)
    torch.cuda.synchronize()
    assert wavefront_cuda.sw_score_affine.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.parametrize("case", list(WAVE_CASES))
def test_k7_and_k10_match_plain(cuda, case):
    xs, ys, m, n, lanes = wave_lanes(case, cuda)
    before = (wavefront_cuda.sw_score_affine_moves.launches, traceback.walk_moves_affine.launches)
    got = wavefront_cuda.sw_score_affine_moves(xs, ys, m, n, lanes=lanes, **BWA)
    want = scan_dp.sw_score_moves_plain(xs, ys, m, n, **BWA)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert valid_moves(got[3], want[3], m, n)
    x_mb = xs.T.contiguous()
    walked = traceback.walk_moves_affine(got[3], x_mb, ys, got[1], got[2], max_steps=250)
    plain = traceback._walk_moves_affine_plain(got[3], x_mb, ys, got[1], got[2], 250)
    assert (wavefront_cuda.sw_score_affine_moves.launches,
            traceback.walk_moves_affine.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(walked, plain):
        assert torch.equal(g, w)


def test_affine_lengths_beyond_the_padded_shape_match_plain(cuda):
    """K6, K7 and K10 on lanes with m_b > M or n_b > N, and walks started
    outside the matrix, in every lane state the moves lead to."""
    xs, ys, m, n = ragged(2, cuda)
    M, N = xs.shape[1], ys.shape[1]
    m[:4] = M + torch.tensor([1, 9, 1000, 2**30], dtype=torch.int32, device=cuda)
    n[2:6] = N + torch.tensor([1, 17, 5000, 2**30], dtype=torch.int32, device=cuda)
    for track_pos in (False, True):
        got = wavefront_cuda.sw_score_affine(xs, ys, m, n, track_pos=track_pos, **BWA)
        want = scan_dp.sw_score_plain(xs, ys, m, n, track_pos=track_pos, **BWA)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = wavefront_cuda.sw_score_affine_moves(xs, ys, m, n, **BWA)
    want = scan_dp.sw_score_moves_plain(xs, ys, m, n, **BWA)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert valid_moves(got[3], want[3], m.clamp(max=M), n.clamp(max=N))
    x_mb = xs.T.contiguous()
    i0 = torch.full_like(m, M + 50)
    j0 = torch.full_like(n, N + 70)
    i0[::3] = torch.arange(1, M + 1, 3, device=cuda, dtype=torch.int32)[: i0[::3].numel()]
    walked = traceback.walk_moves_affine(want[3], x_mb, ys, i0, j0, max_steps=60)
    plain = traceback._walk_moves_affine_plain(want[3], x_mb, ys, i0, j0, 60)
    for g, w in zip(walked, plain):
        assert torch.equal(g, w)


# K3/K10 cases (csrc/traceback.cu walk_band_kernel, a warp a lane over
# gathered segments of K rows of the diagonal band of move bytes):
# name -> (B, M, N, max_steps or an offset from K as "K-1", moves). B of 1,
# 10, 132, 133, 512 and 600, across the lanes-a-block rule (one lane a block
# up to the SMs, at most 4); max_steps of 1, K - 1, K, K + 1 and 33 (past
# the first 32-step store); M = 2,048
# walks of over 2,000 steps; affine E and F runs that leave the band and
# cross segments and 32-step stores; all-zero lanes.
WALK_BAND_CASES = {
    "b1": (1, 64, 200, None, "random"), "b10": (10, 96, 300, None, "random"),
    "b132": (132, 64, 256, None, "random"), "b133": (133, 64, 256, None, "random"),
    "b512": (512, 128, 640, None, "random"), "b600": (600, 128, 640, None, "random"),
    "steps_1": (67, 64, 200, 1, "random"), "steps_k_minus_1": (67, 64, 200, "K-1", "random"),
    "steps_k": (67, 64, 200, "K", "random"), "steps_k_plus_1": (67, 64, 200, "K+1", "random"),
    "steps_33": (67, 64, 200, 33, "random"),
    "m2048": (12, 2048, 2100, None, "long"), "gap_runs": (140, 96, 400, None, "gaps"),
    "zero": (40, 64, 200, None, "zero"),
}


def band_walk_inputs(case, K, affine, seed=0):
    """numpy (moves (D, M, B), x_mb (M, B), y_bn (B, N), i0, j0, max_steps)
    for a WALK_BAND_CASES case, K the segment's rows. Random moves: linear codes
    mostly NW with 1% stop bits, affine H sources with 1% H_ZERO and random
    extend bits, the unused high bits random; "gaps" 40% E and 40% F with
    extend bits at 90%; "long" no stop but on row 1 (linear; affine stops at
    i or j <= 0). Starts anywhere in [-2, M + 6] x [-2, N + 6], with one lane
    each at i0 = 1, j0 = 1, i0 past M, j0 past N, i0 = 0 and i0 < 0, one
    whose moves are all 0 and, in "zero", every lane at (0, 0)."""
    B, M, N, steps, kind = WALK_BAND_CASES[case]
    rng = np.random.default_rng([seed, B, M, N, int(affine)])
    D = M + N - 1
    p = [0.2, 0.4, 0.4] if kind == "gaps" else [0.7, 0.15, 0.15]
    code = rng.choice(3, (D, M, B), p=p).astype(np.uint8)
    stop_p = 0.0 if kind == "long" else 0.01
    high = rng.integers(0, 256, (D, M, B), dtype=np.uint8) & np.uint8(0xE0)
    if affine:
        code[rng.random((D, M, B)) < stop_p] = scan_dp.H_ZERO
        ext_p = 0.9 if kind == "gaps" else 0.5
        ext = ((rng.random((D, M, B)) < ext_p) * scan_dp.E_EXT_BIT
               | (rng.random((D, M, B)) < ext_p) * scan_dp.F_EXT_BIT).astype(np.uint8)
        moves = code | ext | high
    else:
        stop = ((rng.random((D, M, B)) < stop_p) * scan_dp.STOP_BIT).astype(np.uint8)
        moves = code | stop | high | (rng.integers(0, 2, (D, M, B), dtype=np.uint8) << 3)
        if kind == "long":
            moves[:, 0, :] |= scan_dp.STOP_BIT
    x_mb = rng.integers(65, 91, (M, B), dtype=np.uint8)
    y_bn = rng.integers(97, 123, (B, N), dtype=np.uint8)
    if kind == "long":
        i0 = rng.integers(M - 20, M + 1, B).astype(np.int32)
        j0 = rng.integers(N - 40, N + 1, B).astype(np.int32)
    else:
        i0 = rng.integers(-2, M + 7, B).astype(np.int32)
        j0 = rng.integers(-2, N + 7, B).astype(np.int32)
    for b, (i, j) in enumerate([(1, N // 2), (M // 2, 1), (M + 5, N // 2), (M // 2, N + 9),
                                (0, 5), (-3, 7)][: max(0, B - 1)]):
        i0[b], j0[b] = i, j
    if B > 1:
        moves[:, :, B - 1] = 0
        i0[B - 1], j0[B - 1] = M, N
    if kind == "zero":
        i0[:] = 0
        j0[:] = 0
    if steps is None:
        steps = M + N + 1
    elif isinstance(steps, str):
        steps = K + int(steps[1:] or 0)
    return moves, x_mb, y_bn, i0, j0, steps


def longest_run(flags):
    """The longest run of True down any column of a (steps, B) bool array."""
    run = best = np.zeros(flags.shape[1], np.int64)
    for row in flags:
        run = np.where(row, run + 1, 0)
        best = np.maximum(best, run)
    return int(best.max())


@pytest.mark.parametrize("case", list(WALK_BAND_CASES))
@pytest.mark.parametrize("form", ("K3", "K10"))
def test_band_walks_match_plain(cuda, form, case):
    """K3 (K10 under affine moves) against the plain walk on the same move
    bytes and starts: pos, cx, cy and steps equal, one launch counted."""
    affine = form == "K10"
    walk, plain_walk = ((traceback.walk_moves_affine, traceback._walk_moves_affine_plain)
                        if affine else (traceback.walk_moves, traceback._walk_moves_plain))
    K = traceback.walk_shape(1)["seg_rows"]
    *arrays, steps = band_walk_inputs(case, K, affine)
    moves, x_mb, y_bn, i0, j0 = (torch.from_numpy(a).to(cuda) for a in arrays)
    before = walk.launches
    got = walk(moves, x_mb, y_bn, i0, j0, max_steps=steps)
    want = plain_walk(moves, x_mb, y_bn, i0, j0, steps)
    torch.cuda.synchronize()
    assert walk.launches == before + 1
    for name, g, w in zip(("pos", "cx", "cy", "steps"), got, want):
        assert g.is_cuda and torch.equal(g, w), name
    if case == "m2048":
        assert int(got[3].max()) > 2000
    if case == "zero":
        assert int(got[3].max()) == 0 and int(got[1].max()) == 0
    if case == "gap_runs" and affine:  # an E run past the band and a 32-step store
        assert longest_run(got[1].cpu().numpy() == traceback.GAP_BYTE) > 32


def test_solve_small_cuda_matches_cpu(cuda, tmp_path):
    ref_path, csv_path = write_dataset(tmp_path, ref_len=2000, n_reads=96, seed=5)
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "32"]
    for extra in (["--npiece", "17"], ["--npiece", "1", "--both-strands"]):
        assert solve_small.main(base + extra + ["--output", str(tmp_path / "gpu.csv")]) == 0
        assert solve_small.main(
            base + extra + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
        assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()


def test_solve_small_affine_cuda_matches_cpu(cuda, tmp_path):
    """BWA-MEM's affine scoring: the card's CSV (K6, K7, K10) equals the
    CPU's byte for byte, and the kernels launched."""
    ref_path, csv_path = write_dataset(tmp_path, ref_len=2000, n_reads=96, seed=8)
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "32"] + BWA_FLAGS
    counters = (wavefront_cuda.sw_score_affine, wavefront_cuda.sw_score_affine_moves,
                traceback.walk_moves_affine)
    for extra in (["--npiece", "17"], ["--npiece", "1", "--both-strands"]):
        before = [fn.launches for fn in counters]
        assert solve_small.main(base + extra + ["--output", str(tmp_path / "gpu.csv")]) == 0
        after = [fn.launches for fn in counters]
        assert after[1] > before[1] and after[2] > before[2]
        assert solve_small.main(
            base + extra + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
        assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()
    assert wavefront_cuda.sw_score_affine.launches > 0


@pytest.mark.parametrize("gaps", [[], AFFINE_FLAGS], ids=["linear", "affine"])
def test_solve_small_matrix_cuda_matches_cpu(cuda, tmp_path, gaps):
    """``solve_small --matrix blosum50``: the card's CSV (K4 per lane, K5,
    K3; under 10/2 K8, K9, K10) equals the CPU's byte for byte, windowed
    and whole, and none of the uniform kernels launched."""
    ref_path, csv_path = write_dataset(tmp_path, ref_len=2000, n_reads=96, seed=11)
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "32",
            "--matrix", "blosum50"] + gaps
    counters = ((profile_cuda.sw_profile_affine, profile_cuda.sw_profile_affine_moves,
                 traceback.walk_moves_affine) if gaps else
                (profile_cuda.sw_profile, profile_cuda.sw_profile_moves, traceback.walk_moves))
    uniform = (wavefront_cuda.sw_score, wavefront_cuda.sw_score_moves,
               wavefront_cuda.sw_score_affine, wavefront_cuda.sw_score_affine_moves)
    for extra in (["--npiece", "17"], ["--npiece", "1"]):
        before = [fn.launches for fn in counters + uniform]
        assert solve_small.main(base + extra + ["--output", str(tmp_path / "gpu.csv")]) == 0
        after = [fn.launches for fn in counters + uniform]
        assert all(a > b for a, b in zip(after[1:3], before[1:3])) and after[3:] == before[3:]
        assert (after[0] > before[0]) == (extra[1] == "17")
        assert solve_small.main(
            base + extra + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
        assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()


def test_serve_cuda_matches_cpu(cuda, tmp_path):
    """The server on the card and on the CPU, each on a thread of this
    process, give the same align results (windowed, whole, without
    traceback) and scan_db hits with traceback; the card's ping names it."""
    import threading

    from parallel_genomeseq_tpu_torch.cli import serve

    ref_path, csv_path = write_dataset(tmp_path, ref_len=2000, n_reads=64, seed=12)
    reads = [line.split(",")[2] for line in csv_path.read_text().splitlines()[1:]]
    query, db, query_seq = write_protein_dataset(tmp_path / "p", n_entries=200, query_len=145,
                                                 seed=13)
    replies = {}
    for device in ("cuda", "cpu"):
        sock = str(tmp_path / f"{device}.sock")
        thread = threading.Thread(target=serve.main, daemon=True, args=([
            "--socket", sock, "--ref", str(ref_path), "--protein-db", str(db), "--npiece", "17",
            "--batch-size", "32", "--warm-read-len", "125", "--device", device],))
        thread.start()
        ping = serve.wait_ready(sock, timeout=300)
        assert ping["backend"].startswith("cuda (") == (device == "cuda")
        replies[device] = [serve.request(sock, req) for req in (
            {"op": "align", "reads": reads},
            {"op": "align", "reads": reads, "npiece": 1},
            {"op": "align", "reads": reads, "traceback": False},
            {"op": "scan_db", "query": query_seq, "top": 10, "traceback": True},
        )]
        assert serve.request(sock, {"op": "shutdown"}) == {"ok": True}
        thread.join(60)
        assert not thread.is_alive()
    for got, want in zip(*replies.values()):
        assert got["ok"] and want["ok"]
        assert got.get("results") == want.get("results") and got.get("hits") == want.get("hits")


def protein_lanes(seed, dev, B=77, M=150, N=420):
    """Random protein lanes of ragged true lengths with a shared motif, in
    compact codes, with some codes at or past the table's size (they score
    as code 0, like a byte outside the alphabet)."""
    rng = np.random.default_rng(seed)
    lut, table = scan_dp.profile_tables(blosum_config("blosum50"))
    m = rng.integers(1, M + 1, B).astype(np.int32)
    n = rng.integers(1, N + 1, B).astype(np.int32)
    xs = rng.integers(0, 30, (B, M)).astype(np.uint8)
    ys = rng.integers(0, 30, (B, N)).astype(np.uint8)
    for b in range(B):
        k = min(m[b], n[b]) // 2
        if k:
            ys[b, n[b] - k : n[b]] = xs[b, :k]
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(xs), t(ys), t(m), t(n), t(table)


def valid_moves(got, want, m, n):
    D, M, B = got.shape
    d = torch.arange(D, device=got.device)[:, None, None]
    r = torch.arange(M, device=got.device)[None, :, None]
    valid = (r < m) & (d >= r) & (d - r < n)
    return torch.equal(got[valid], want[valid])


@pytest.mark.parametrize("seed", [0, 1])
def test_k4_matches_plain(cuda, seed):
    """K4 on per-lane queries, and on a flat slab with one shared query and
    lanes that run past the slab's end or start outside it."""
    xs, ys, m, n, table = protein_lanes(seed, cuda)
    before = profile_cuda.sw_profile.launches
    got = profile_cuda.sw_profile(xs, ys, m, n, table=table, gap=12)
    want = scan_dp.sw_profile_plain(xs, ys, m, n, table=table, gap=12)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    slab = ys.reshape(-1)[: ys.numel() - 100].contiguous()
    off = torch.arange(ys.shape[0], device=cuda, dtype=torch.int64) * 420
    off[:3] = torch.tensor([-5, slab.numel(), slab.numel() + 9], device=cuda)
    mq = torch.full_like(m, xs.shape[1])
    got = profile_cuda.sw_profile(xs[0], slab, mq, n * 3, table=table, gap=12, y_off=off)
    want = scan_dp.sw_profile_plain(xs[0], slab, mq, n * 3, table=table, gap=12, y_off=off)
    torch.cuda.synchronize()
    assert profile_cuda.sw_profile.launches == before + 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0][:3].tolist() == [0, 0, 0]


def test_solve_uniprot_cuda_matches_cpu(cuda, tmp_path):
    query, db, _ = write_protein_dataset(tmp_path, n_entries=300, query_len=145, seed=4)
    base = ["--query", str(query), "--database", str(db), "--batch-size", "64"]
    for extra in ([], ["--traceback-all"], ["--matrix", "uniform"]):
        assert solve_uniprot.main(base + extra + ["--output", str(tmp_path / "gpu.csv")]) == 0
        assert solve_uniprot.main(
            base + extra + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
        assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_k8_matches_plain(cuda, seed):
    """K8 on per-lane queries, and on a flat slab with one shared query and
    lanes that run past the slab's end or start outside it."""
    xs, ys, m, n, table = protein_lanes(seed, cuda)
    kw = dict(table=table, gap_open=10, gap=2)
    before = profile_cuda.sw_profile_affine.launches
    got = profile_cuda.sw_profile_affine(xs, ys, m, n, **kw)
    want = scan_dp.sw_profile_plain(xs, ys, m, n, **kw)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    slab = ys.reshape(-1)[: ys.numel() - 100].contiguous()
    off = torch.arange(ys.shape[0], device=cuda, dtype=torch.int64) * 420
    off[:3] = torch.tensor([-5, slab.numel(), slab.numel() + 9], device=cuda)
    mq = torch.full_like(m, xs.shape[1])
    got = profile_cuda.sw_profile_affine(xs[0], slab, mq, n * 3, y_off=off, **kw)
    want = scan_dp.sw_profile_plain(xs[0], slab, mq, n * 3, y_off=off, **kw)
    torch.cuda.synchronize()
    assert profile_cuda.sw_profile_affine.launches == before + 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0][:3].tolist() == [0, 0, 0]


def scan_edge_lanes(M, g, seed):
    """A query of M codes (some past the table) and entries of the lengths
    that end a group's pipeline early or late -- 0, 1, g - 1, g, g + 1 and
    longer, mixed inside one warp -- plus a planted copy of the query's tail."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 30, M).astype(np.uint8)
    lengths = [0, 1, g - 1, g, g + 1, 2, 5, 2 * g + 3, 3 * g, 40]
    entries = [rng.integers(0, 30, L).astype(np.uint8) for L in lengths]
    k = min(M, 30)
    entries.append(np.concatenate([rng.integers(0, 26, 3), q[M - k:],
                                   rng.integers(0, 26, 4)]).astype(np.uint8))
    return rng, q, entries


def scan_tie_lanes(M):
    """Two queries of code-0 filler (every cell scores the matrix minimum)
    and entries whose maxima tie: H/H and P/P score 10 and W/W 15 under
    BLOSUM50. Query 1 holds H in row 1 and P in row M, so entry P-H ties
    (M, 1) with (1, 3), across bands and columns; query 2 holds W in rows 1
    and M, so entry W ties two bands in one column and W--W also two
    columns. The all-filler entry is an all-zero lane."""
    lut = scan_dp.profile_tables(blosum_config("blosum50"))[0]
    H, P, W = (int(lut[ord(c)]) for c in "HPW")
    q1 = np.zeros(M, np.uint8)
    q1[0], q1[-1] = H, P if M > 1 else H
    q2 = np.zeros(M, np.uint8)
    q2[0] = q2[-1] = W
    entries = [np.array([P, 0, H], np.uint8), np.array([W], np.uint8),
               np.array([W, 0, 0, W], np.uint8), np.zeros(7, np.uint8),
               np.array([H, 0, P, 0, H], np.uint8)]
    return (q1, q2), entries


def pack_lanes(entries, pad=2):
    """(slab, offsets, lengths) and the same entries as a padded (B, N) block."""
    lens = np.array([len(e) for e in entries], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    ys = np.zeros((len(entries), int(lens.max()) + pad), np.uint8)
    for b, e in enumerate(entries):
        ys[b, : len(e)] = e
    return np.concatenate(entries), offs, lens, ys


@pytest.mark.parametrize("gaps", [dict(gap=12), dict(gap_open=10, gap=2)],
                         ids=["linear", "affine"])
@pytest.mark.parametrize("form", ["slab", "lane"])
def test_scan_shapes_match_plain(cuda, form, gaps):
    """K4 (K8 under affine gaps), the thread-group scan, exactly equal to the
    plain version at query lengths 1, r, g x r and g x r + 1 of every (g, r)
    shape it launches and 2,048, in its slab form (one shared query, lanes
    whose offset lies past the slab's end or before it) and per lane (each
    lane its own query and m_b <= M), on ragged entries, codes past the
    table, ties across bands and columns and an all-zero lane."""
    scan = profile_cuda.sw_profile_affine if "gap_open" in gaps else profile_cuda.sw_profile
    _, table = scan_dp.profile_tables(blosum_config("blosum50"))
    table = torch.from_numpy(table).to(cuda)
    kw = dict(table=table, **gaps)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    shape = {M: profile_cuda.scan_shape(M, ncodes=table.shape[0], affine="gap_open" in gaps,
                                        shared=form == "slab")
             for M in range(1, profile_cuda.MAX_SCAN_M + 1)}
    shapes = sorted({(sh["g"], sh["r"]) for sh in shape.values()}, key=lambda s: s[0] * s[1])
    assert shapes[-1][0] * shapes[-1][1] == profile_cuda.MAX_SCAN_M
    assert all(sh["g"] * sh["r"] >= M for M, sh in shape.items())
    lengths = sorted({v for g, r in shapes for v in (1, r, g * r, g * r + 1)
                      if v <= profile_cuda.MAX_SCAN_M})
    before = scan.launches
    calls = 0
    for M in lengths:
        g = shape[M]["g"]
        rng, q, entries = scan_edge_lanes(M, g, seed=M)
        slab, offs, lens, ys = pack_lanes(entries)
        if form == "slab":
            offs = np.concatenate([offs, [len(slab) + 3, len(slab) - 2, -4]])
            lens = np.concatenate([lens, [5, 9, 3]]).astype(np.int32)
            args = (t(q), t(slab), t(np.full(len(lens), M, np.int32)), t(lens))
            cases = [(args, dict(y_off=t(offs)))]
        else:
            xs = rng.integers(0, 30, (len(entries), M)).astype(np.uint8)
            xs[0] = q
            m = rng.integers(0, M + 1, len(entries)).astype(np.int32)
            m[0] = m[-1] = M
            cases = [((t(xs), t(ys), t(m), t(lens)), {})]
        queries, tie_entries = scan_tie_lanes(M)
        tslab, toffs, tlens, tys = pack_lanes(tie_entries)
        for qq in queries:
            mm = t(np.full(len(tie_entries), M, np.int32))
            if form == "slab":
                cases.append(((t(qq), t(tslab), mm, t(tlens)), dict(y_off=t(toffs))))
            else:
                cases.append(((t(np.tile(qq, (len(tie_entries), 1))), t(tys), mm, t(tlens)), {}))
        for args, extra in cases:
            got = scan(*args, **extra, **kw)
            want = scan_dp.sw_profile_plain(*args, **extra, **kw)
            calls += 1
            for a, b in zip(got, want):
                assert torch.equal(a, b), (M, shape[M], form, gaps)
        ties, ties2 = (torch.stack(scan(*args, **extra, **kw)).T.tolist()
                       for args, extra in cases[-2:])
        calls += 2
        if M > 4:  # no diagonal joins the planted cells
            # P/P at (M, 1) comes before H/H at (1, 3): min j, not min i.
            assert ties[0] == [10, M, 1]
            assert ties2[1:4] == [[15, 1, 1], [15, 1, 1], [0, 0, 0]]
    torch.cuda.synchronize()
    assert scan.launches == before + calls


# K5/K9 cases (csrc/wavefront.cu's table form, x = entry, y = query):
# (protein_lanes' arguments, a change to the lanes). M at the rules' edges
# (1 -> 2 rows a thread at 33, 4 -> 8 at 129, one warp of 32 rows up to
# 1,024, two warps beyond, 2,048 the last); B of 1, 10 (the top 10), 77 and
# 600; codes past the table in every case; lanes with m_b or n_b 0 or 1,
# all-zero lanes and lengths past the padded shape; BLOSUM50 ties across
# threads and warps.
PROFILE_MOVES_CASES = {
    "rows_32": (dict(seed=0, B=10, M=32, N=200), None),
    "rows_33": (dict(seed=1, B=77, M=33, N=150), None),
    "rows_128_b600": (dict(seed=2, B=600, M=128, N=90), None),
    "rows_129": (dict(seed=3, B=10, M=129, N=256), None),
    "top10": (dict(seed=4, B=10, M=384, N=256), None),
    "rows_1024": (dict(seed=5, B=10, M=1024, N=120), None),
    "rows_1025": (dict(seed=6, B=10, M=1025, N=120), None),
    "rows_2048": (dict(seed=7, B=5, M=2048, N=100), None),
    "b1": (dict(seed=8, B=1, M=150, N=300), None),
    "edges": (dict(seed=9, B=37, M=64, N=100), "edges"),
    "ties_129": (dict(seed=10, B=4, M=129, N=8), "ties"),
    "ties_1025": (dict(seed=11, B=4, M=1025, N=8), "ties"),
}
# The (score, i, j) of the "ties" lanes: P/P at (M, 1) before H/H at (1, 3)
# (min j); W/W at (1, 1) before (M, 1) (min i), and before (1, 4) and (M,
# 4); an all-zero lane.
TIES = lambda M: [[10, M, 1], [15, 1, 1], [15, 1, 1], [0, 0, 0]]


def profile_moves_lanes(case, dev):
    """(xs, ys, m, n, table) of a PROFILE_MOVES_CASES case on ``dev``."""
    kwargs, change = PROFILE_MOVES_CASES[case]
    xs, ys, m, n, table = protein_lanes(dev=dev, **kwargs)
    M, N = xs.shape[1], ys.shape[1]
    if change == "edges":  # m_b 0, n_b 0, 1, 1, both 1, all-zero lanes, past the shape
        m[0], n[1], m[2], n[3] = 0, 0, 1, 1
        m[4] = n[4] = 1
        xs[5], ys[5] = 0, 7  # code 0 scores the matrix minimum everywhere
        xs[6] = 27  # past the table: reads as code 0
        m[7], n[8] = M + 5, N + 100
        m[9], n[9] = 2**30, 2**30
    elif change == "ties":
        lut = scan_dp.profile_tables(blosum_config("blosum50"))[0]
        H, P, W = (int(lut[ord(c)]) for c in "HPW")
        xs.zero_()
        ys.zero_()
        xs[0, 0], xs[0, M - 1] = H, P
        ys[0, :3] = torch.tensor([P, 0, H], device=dev)
        xs[1:3, 0] = xs[1:3, M - 1] = W
        ys[1, 0] = W
        ys[2, :4] = torch.tensor([W, 0, 0, W], device=dev)
        m.fill_(M)
        n.copy_(torch.tensor([3, 1, 4, 7], device=dev))
    return xs, ys, m, n, table


@pytest.mark.parametrize("case", list(PROFILE_MOVES_CASES))
@pytest.mark.parametrize("gaps", [dict(gap=12), dict(gap_open=10, gap=2)], ids=["k5", "k9"])
def test_k5_k9_and_their_walks_match_plain(cuda, gaps, case):
    """K5 (K9 under affine gaps) against the plain version: (score, i, j)
    equal and the moves cell for cell inside each lane's m_b x n_b, at the
    kernels' rule and at every lanes a block the rule allows, with one warp
    a lane and with two; and the K3 (K10) walk on the kernel's moves equal
    to the plain walk on the plain version's."""
    affine = "gap_open" in gaps
    fn = profile_cuda.sw_profile_affine_moves if affine else profile_cuda.sw_profile_moves
    xs, ys, m, n, table = profile_moves_lanes(case, cuda)
    B, M = xs.shape
    N = ys.shape[1]
    kw = dict(table=table, **gaps)
    want = scan_dp.sw_profile_moves_plain(xs, ys, m, n, **kw)
    if case.startswith("ties"):
        assert torch.stack(want[:3]).T.tolist() == TIES(M)
    launches = [(0, 0)]
    for W in (1, 2):
        for L in (1, 2, 4, 8, 16):
            try:
                wavefront_cuda.launch_shape(M, B, affine=affine, mode="moves", lanes=L, warps=W,
                                            ncodes=table.shape[0])
            except RuntimeError:  # past the block's limit, or fewer warps than M needs
                continue
            launches.append((L, W))
    before = fn.launches
    mc, nc = m.clamp(max=M), n.clamp(max=N)
    for lanes, warps in launches:
        got = fn(xs, ys, m, n, lanes=lanes, warps=warps, **kw)
        for g, w in zip(got[:3], want[:3]):
            assert g.is_cuda and torch.equal(g, w), (lanes, warps)
        assert valid_moves(got[3], want[3], mc, nc), (lanes, warps)
        if (lanes, warps) == (0, 0):
            rule = got
    torch.cuda.synchronize()
    assert fn.launches == before + len(launches)
    walk, plain_walk = ((traceback.walk_moves_affine, traceback._walk_moves_affine_plain)
                        if affine else (traceback.walk_moves, traceback._walk_moves_plain))
    x_mb = xs.T.contiguous()
    walked = walk(rule[3], x_mb, ys, rule[1], rule[2], max_steps=M + N)
    plain = plain_walk(want[3], x_mb, ys, want[1], want[2], M + N)
    for g, w in zip(walked, plain):
        assert torch.equal(g, w)


def test_solve_uniprot_affine_cuda_matches_cpu(cuda, tmp_path):
    """swps3's BLOSUM50 10/2 gaps: the card's CSV (K8, K9, K10; K6, K7
    under --matrix uniform) equals the CPU's byte for byte."""
    query, db, _ = write_protein_dataset(tmp_path, n_entries=300, query_len=145, seed=9)
    base = ["--query", str(query), "--database", str(db), "--batch-size", "64"] + AFFINE_FLAGS
    counters = (profile_cuda.sw_profile_affine, profile_cuda.sw_profile_affine_moves,
                traceback.walk_moves_affine)
    before = [fn.launches for fn in counters]
    for extra in ([], ["--traceback-all"], ["--matrix", "uniform"]):
        assert solve_uniprot.main(base + extra + ["--output", str(tmp_path / "gpu.csv")]) == 0
        assert solve_uniprot.main(
            base + extra + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
        assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()
    assert all(fn.launches > b for fn, b in zip(counters, before))


def test_solve_uniprot_plain_engine_on_card_launches_no_kernel(cuda, tmp_path):
    """``--engine plain`` runs the plain versions of K4, K5 and K3 on the
    card: the same CSV as the kernels, and no launch."""
    query, db, _ = write_protein_dataset(tmp_path, n_entries=120, query_len=64, seed=6)
    base = ["--query", str(query), "--database", str(db), "--batch-size", "64"]
    assert solve_uniprot.main(base + ["--output", str(tmp_path / "k.csv")]) == 0
    counters = (profile_cuda.sw_profile, profile_cuda.sw_profile_moves, traceback.walk_moves)
    before = [fn.launches for fn in counters]
    assert solve_uniprot.main(base + ["--engine", "plain", "--output", str(tmp_path / "p.csv")]) == 0
    assert [fn.launches for fn in counters] == before
    assert (tmp_path / "k.csv").read_bytes() == (tmp_path / "p.csv").read_bytes()


def long_lanes(seed, dev, B=9, M=2600, N=700):
    """Long DNA lanes (reads past 2,048 rows) of ragged true lengths, each
    with a mutated stretch of its reference planted across strip edges."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    m = rng.integers(M // 2, M + 1, B).astype(np.int32)
    n = rng.integers(N // 3, N + 1, B).astype(np.int32)
    xs = np.full((B, M), 1, np.uint8)
    ys = np.full((B, N), 2, np.uint8)
    for b in range(B):
        ys[b, : n[b]] = rng.choice(acgt, n[b])
        xs[b, : m[b]] = rng.choice(acgt, m[b])
        k = min(n[b], m[b] - 200)
        seg = ys[b, :k].copy()
        seg[rng.integers(0, k, k // 40)] = rng.choice(acgt, k // 40)
        xs[b, 200 + b * 37 : 200 + b * 37 + k] = seg[: m[b] - 200 - b * 37]
    return [torch.from_numpy(a).to(dev) for a in (xs, ys, m, n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_k11_and_k12_match_plain(cuda, seed):
    """K11 and K12 on long ragged lanes, with lengths past the padded shape
    on some: (score, i, j) and every checkpoint row equal the plain sweep's."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    xs, ys, m, n = long_lanes(seed, cuda)
    m[0] += 5000
    n[1] += 2**30
    before = (strips_cuda.sw_score_strips.launches, strips_cuda.sw_score_strips_ckpt.launches)
    got = strips_cuda.sw_score_strips(xs, ys, m, n, **KW)
    ck = strips_cuda.sw_score_strips_ckpt(xs, ys, m, n, **KW)
    want = scan_dp.sw_score_ckpt_plain(xs, ys, m, n, **KW)
    torch.cuda.synchronize()
    assert (strips_cuda.sw_score_strips.launches,
            strips_cuda.sw_score_strips_ckpt.launches) == (before[0] + 1, before[1] + 1)
    for g, c, w in zip(got, ck, want):
        assert g.is_cuda and torch.equal(g, w) and torch.equal(c, w)
    assert torch.equal(ck[3], want[3]) and int(want[0].min()) > 100


def test_k11_beyond_one_pass_matches_plain(cuda):
    """A read longer than one block's pass (10,240 rows): the bound row
    carries between passes, and the argmax ties resolve across passes."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    M, N = strips_cuda.ROWS_PER_PASS + 700, 300
    ref = rng.choice(acgt, N)
    xs = rng.choice(acgt, (3, M)).astype(np.uint8)
    xs[0, 100:400] = ref  # the same best score in both passes: the first wins
    xs[0, M - 350 : M - 50] = ref
    xs[1, strips_cuda.ROWS_PER_PASS - 150 : strips_cuda.ROWS_PER_PASS + 150] = ref
    ys = np.broadcast_to(ref, (3, N)).copy()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    m, n = t(np.full(3, M, np.int32)), t(np.full(3, N, np.int32))
    got = strips_cuda.sw_score_strips_ckpt(t(xs), t(ys), m, n, **KW)
    want = scan_dp.sw_score_ckpt_plain(t(xs), t(ys), m, n, **KW)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0][:2].tolist() == [900, 900] and int(got[1][0]) == 400


def test_strip_traceback_kernels_match_plain(cuda):
    """K13 (every strip, valid cells) and K14 against their plain versions,
    and the whole strip traceback of the CUDA engine (K12, K13, K14) against
    the plain engine's on the card."""
    from parallel_genomeseq_tpu_torch.ops import engine, strips_cuda

    xs, ys, m, n = long_lanes(2, cuda)
    _, i, j, ck = strips_cuda.sw_score_strips_ckpt(xs, ys, m, n, **KW)
    B, N = ys.shape
    x_mb = xs.T.contiguous()
    state = traceback.new_strip_state(i, j, 900)
    plain_state = tuple(a.clone() for a in state)
    r = torch.arange(256, device=cuda)
    before = (strips_cuda.strip_moves.launches, traceback.walk_strip_level.launches)
    nstrips = -(-xs.shape[1] // 256)
    for s in range(nstrips - 1, -1, -1):
        rowin = ck[:, s - 1] if s else None
        got = strips_cuda.strip_moves(xs, ys, m, n, rowin, s * 256, **KW)
        want = scan_dp.strip_moves_plain(xs, ys, m, n, rowin, s * 256, **KW)
        valid = ((s * 256 + r)[None, None, :] < m[:, None, None]) & \
            (torch.arange(N, device=cuda)[None, :, None] < n[:, None, None])
        assert torch.equal(got[valid], want[valid])
        traceback.walk_strip_level(got, x_mb, ys, s * 256, state, max_steps=900)
        traceback._walk_strip_plain(want, x_mb, ys, s * 256, plain_state, 900)
        for g, w in zip(state, plain_state):
            assert torch.equal(g, w)
    assert (strips_cuda.strip_moves.launches, traceback.walk_strip_level.launches) == (
        before[0] + nstrips, before[1] + nstrips)
    assert int(state[4].min()) > 100 and not bool(state[3].any())
    kw = dict(max_steps=900)
    got = engine.CudaEngine(device=cuda).score_batch_strip_moves(xs, ys, m, n, **kw)
    want = engine.PlainEngine(device=cuda).score_batch_strip_moves(xs, ys, m, n, **kw)
    for k in ("score", "i", "j", "pos", "cx", "cy", "steps"):
        assert torch.equal(got[k], want[k]), k


def test_solve_big_cuda_matches_cpu(cuda, tmp_path):
    """solve_big on the card (K11; with --traceback K12, K13, K14) gives the
    CPU's results, read for read."""
    from parallel_genomeseq_tpu_torch.cli import solve_big
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    base = ["2", "1", "--ref-len", "9000", "--read-len", "2300", "--n-reads", "3"]
    counters = (strips_cuda.sw_score_strips, strips_cuda.sw_score_strips_ckpt,
                strips_cuda.strip_moves, traceback.walk_strip_level)
    for extra in ([], ["--traceback"]):
        before = [fn.launches for fn in counters]
        gpu = solve_big.run(base + extra)
        cpu = solve_big.run(base + extra + ["--device", "cpu"])
        launched = [fn.launches > b for fn, b in zip(counters, before)]
        assert launched == ([True] * 4 if extra else [True, False, False, False])
        fields = lambda r: (r.score, r.pos, r.max_i, r.max_j, r.consensus_x, r.consensus_y)
        assert [fields(r) for r in gpu.results] == [fields(r) for r in cpu.results]
        assert gpu.swept_cells == cpu.swept_cells


def affine_lanes(seed, dev):
    """long_lanes with a 20-base insertion planted in lane 0 across row 512
    (an F run over a strip edge) and a 12-base deletion in lane 1."""
    xs, ys, m, n = long_lanes(seed, dev)
    rng = np.random.default_rng(seed + 10)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = ys[0, : int(n[0])].cpu().numpy()
    cut = len(ref) // 2
    read = np.concatenate([ref[:cut], rng.choice(acgt, 20), ref[cut:]])
    xs[0, 502 - cut : 502 - cut + len(read)] = torch.from_numpy(read).to(dev)
    ref = ys[1, : int(n[1])].cpu().numpy()
    cut = len(ref) // 2
    read = np.concatenate([ref[:cut], ref[cut + 12 :]])
    xs[1, 700 : 700 + len(read)] = torch.from_numpy(read).to(dev)
    m[:2] = xs.shape[1]
    return xs, ys, m, n


@pytest.mark.parametrize("seed", [0, 1])
def test_k15_and_k16_match_plain(cuda, seed):
    """K15 and K16 under BWA-MEM's scoring on long ragged lanes, with lengths
    past the padded shape on some: (score, i, j) and every H and F
    checkpoint row equal the plain sweep's."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    xs, ys, m, n = affine_lanes(seed, cuda)
    m[2] += 5000
    n[3] += 2**30
    before = (strips_cuda.sw_score_strips_affine.launches,
              strips_cuda.sw_score_strips_affine_ckpt.launches)
    got = strips_cuda.sw_score_strips_affine(xs, ys, m, n, **BWA)
    ck = strips_cuda.sw_score_strips_affine_ckpt(xs, ys, m, n, **BWA)
    want = scan_dp.sw_score_affine_ckpt_plain(xs, ys, m, n, **BWA)
    torch.cuda.synchronize()
    assert (strips_cuda.sw_score_strips_affine.launches,
            strips_cuda.sw_score_strips_affine_ckpt.launches) == (before[0] + 1, before[1] + 1)
    for g, c, w in zip(got, ck, want):
        assert g.is_cuda and torch.equal(g, w) and torch.equal(c, w)
    assert torch.equal(ck[3], want[3]) and torch.equal(ck[4], want[4])
    assert int(want[0].min()) > 50 and int(want[4].max()) > 0


def test_k15_beyond_one_pass_matches_plain(cuda):
    """A read longer than one affine block's pass (10,240 rows): the (H, F)
    bound row carries between passes -- lane 1's insertion puts an F run
    across the pass edge -- and the argmax ties resolve across passes."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    edge = strips_cuda.ROWS_PER_PASS_AFFINE
    M, N = edge + 700, 300
    ref = rng.choice(acgt, N)
    xs = rng.choice(acgt, (3, M)).astype(np.uint8)
    xs[0, 100:400] = ref  # the same best score in both passes: the first wins
    xs[0, M - 350 : M - 50] = ref
    read = np.concatenate([ref[:150], rng.choice(acgt, 16), ref[150:]])
    xs[1, edge - 158 : edge - 158 + len(read)] = read
    ys = np.broadcast_to(ref, (3, N)).copy()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    m, n = t(np.full(3, M, np.int32)), t(np.full(3, N, np.int32))
    got = strips_cuda.sw_score_strips_affine_ckpt(t(xs), t(ys), m, n, **BWA)
    want = scan_dp.sw_score_affine_ckpt_plain(t(xs), t(ys), m, n, **BWA)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[0][0]) == 300 and int(got[1][0]) == 400
    assert int(got[0][1]) >= 300 - 6 - 16  # across the insertion


def test_affine_strip_traceback_kernels_match_plain(cuda):
    """K17 (every strip, valid cells) and K18 against their plain versions,
    and the affine strip traceback of the CUDA engine (K16, K17, K18)
    against the plain engine's on the card."""
    from parallel_genomeseq_tpu_torch.ops import engine, strips_cuda
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    xs, ys, m, n = affine_lanes(2, cuda)
    _, i, j, ck, fck = strips_cuda.sw_score_strips_affine_ckpt(xs, ys, m, n, **BWA)
    B, N = ys.shape
    x_mb = xs.T.contiguous()
    state = traceback.new_strip_state(i, j, 900, affine=True)
    plain_state = tuple(a.clone() for a in state)
    r = torch.arange(256, device=cuda)
    before = (strips_cuda.strip_affine_moves.launches, traceback.walk_strip_level_affine.launches)
    nstrips = -(-xs.shape[1] // 256)
    for s in range(nstrips - 1, -1, -1):
        rows = (ck[:, s - 1], fck[:, s - 1]) if s else (None, None)
        got = strips_cuda.strip_affine_moves(xs, ys, m, n, *rows, s * 256, **BWA)
        want = scan_dp.strip_affine_moves_plain(xs, ys, m, n, *rows, s * 256, **BWA)
        valid = ((s * 256 + r)[None, None, :] < m[:, None, None]) & \
            (torch.arange(N, device=cuda)[None, :, None] < n[:, None, None])
        assert torch.equal(got[valid], want[valid])
        traceback.walk_strip_level_affine(got, x_mb, ys, s * 256, state, max_steps=900)
        traceback._walk_strip_affine_plain(want, x_mb, ys, s * 256, plain_state, 900)
        for g, w in zip(state, plain_state):
            assert torch.equal(g, w)
    assert (strips_cuda.strip_affine_moves.launches,
            traceback.walk_strip_level_affine.launches) == (before[0] + nstrips,
                                                            before[1] + nstrips)
    assert int(state[4].min()) > 100 and not bool((state[3] & (state[0] > 0)).any())
    cfg = ScoringConfig(match=1.0, mismatch=-4.0, gap_open=6.0, gap_penalty=1.0)
    got = engine.CudaEngine(cfg, device=cuda).score_batch_strip_moves(xs, ys, m, n, 900)
    want = engine.PlainEngine(cfg, device=cuda).score_batch_strip_moves(xs, ys, m, n, 900)
    for k in ("score", "i", "j", "pos", "cx", "cy", "steps"):
        assert torch.equal(got[k], want[k]), k
    cons = traceback.decode_consensus(got["cx"].cpu(), got["cy"].cpu(), got["steps"].cpu())
    assert "-" * 20 in cons[0][1] and "-" * 12 in cons[1][0]


def test_solve_big_affine_cuda_matches_cpu(cuda):
    """solve_big --gap-open on the card (K15; with --traceback K16, K17,
    K18) gives the CPU's results, read for read, and launches none of the
    linear strip kernels."""
    from parallel_genomeseq_tpu_torch.cli import solve_big
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    base = ["2", "1", "--ref-len", "9000", "--read-len", "2300", "--n-reads", "3"] + BWA_FLAGS
    counters = (strips_cuda.sw_score_strips_affine, strips_cuda.sw_score_strips_affine_ckpt,
                strips_cuda.strip_affine_moves, traceback.walk_strip_level_affine)
    linear = (strips_cuda.sw_score_strips, strips_cuda.sw_score_strips_ckpt,
              strips_cuda.strip_moves, traceback.walk_strip_level)
    for extra in ([], ["--traceback"]):
        before = [fn.launches for fn in counters + linear]
        gpu = solve_big.run(base + extra)
        cpu = solve_big.run(base + extra + ["--device", "cpu"])
        launched = [fn.launches > b for fn, b in zip(counters + linear, before)]
        assert launched == ([True] * 4 if extra else [True, False, False, False]) + [False] * 4
        fields = lambda r: (r.score, r.pos, r.max_i, r.max_j, r.consensus_x, r.consensus_y)
        assert [fields(r) for r in gpu.results] == [fields(r) for r in cpu.results]


# The group replay (csrc/strips.cu strip_moves_kernel, G strips of every
# lane in one launch, each only where the strip walk can still read it): its
# four forms, and the groups and walk states of its edges. Lanes are
# affine_lanes' (lane 0 carries an F run across row 512) cut to 2,328 rows,
# so that the top strip holds 24 rows and ragged m_b end inside strips.
REPLAY_ROWS = 9 * 256 + 24
REPLAY_CASES = ("one", "two", "all", "unreached", "inactive_short_j", "no_walk", "engine_g2",
                "engine_rule")


def replay_form(form):
    """(config, kernel keyword arguments without the table) of a replay form."""
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    return {"K13": (ScoringConfig(), KW),
            "K17": (ScoringConfig(match=1.0, mismatch=-4.0, gap_open=6.0, gap_penalty=1.0), BWA),
            "K21": (blosum_config("blosum50", gap_penalty=2.0), dict(gap=2)),
            "K24": (blosum_config("blosum50", gap_penalty=2.0, gap_open=10.0),
                    PROTEIN_AFFINE)}[form]


@pytest.mark.parametrize("case", REPLAY_CASES)
@pytest.mark.parametrize("form", ("K13", "K17", "K21", "K24"))
def test_strip_replay_groups_match_plain(cuda, form, case, monkeypatch):
    """The group replay of each form against its plain version on every
    cell the walk can read, with nothing written outside them: one strip
    (the 24-row top one), two, all ten, a group whose lower strips no lane
    reaches, an inactive lane beside one whose j is far below its n_b, and no
    walk state (every column); then the CUDA engine's whole strip traceback
    against the plain engine's with G forced to 2 and with G left to the
    rule (which replays every strip in one launch here)."""
    from parallel_genomeseq_tpu_torch.ops import engine, strips_cuda

    cfg, kw = replay_form(form)
    rx, ry, m, n = affine_lanes(2, cuda)
    rx, m = rx[:, :REPLAY_ROWS].contiguous(), m.clamp(max=REPLAY_ROWS)
    xs, ys = rx, ry
    if not cfg.is_uniform:  # A, C, G and T are BLOSUM50 letters; the pads code 0
        lut, table = (torch.from_numpy(a).to(cuda) for a in scan_dp.profile_tables(cfg))
        xs, ys, kw = lut[rx.long()], lut[ry.long()], dict(kw, table=table)
    key = engine.strip_key(cfg)
    _, ckpt, group, _ = engine.STRIP_KERNELS[key]
    plain_group = engine.STRIP_PLAIN[key][2]
    kernel = getattr(strips_cuda, group.__name__.removesuffix("_group"))
    if case.startswith("engine"):
        if case == "engine_g2":
            monkeypatch.setattr(strips_cuda, "replay_group", lambda reach, *a, **k: 2)
        before = group.launches
        got = engine.CudaEngine(cfg, device=cuda).score_batch_strip_moves(rx, ry, m, n, 900)
        want = engine.PlainEngine(cfg, device=cuda).score_batch_strip_moves(rx, ry, m, n, 900)
        for k in ("score", "i", "j", "pos", "cx", "cy", "steps"):
            assert torch.equal(got[k], want[k]), k
        assert group.launches == before + len(got["groups"]) and len(got["level_us"]) == 10
        assert got["groups"] == want["groups"]
        if case == "engine_g2":
            assert got["groups"][0] == 2 and max(got["groups"]) == 2
        else:
            assert got["groups"][0] >= 2
        assert int(got["steps"].min()) > 100
        return
    _, _, _, *ck = ckpt(xs, ys, m, n, **kw)
    B, N = ys.shape
    wi, wj, active = m.clone(), n.clone(), torch.ones(B, dtype=torch.bool, device=cuda)
    wj[3] = n[3] // 2
    first, G = {"one": (9, 1), "two": (8, 2), "all": (0, 10), "unreached": (0, 10),
                "inactive_short_j": (3, 4), "no_walk": (1, 3)}[case]
    if case == "unreached":  # strips 4-9 lie below every lane's row
        wi = wi.clamp(max=3 * 256 + 100)
    if case == "inactive_short_j":
        active[1] = False
        wj[2] = 3
    walk = None if case == "no_walk" else (wi, wj, active)
    got = torch.full((G, B, N, 256), 0xA5, dtype=torch.uint8, device=cuda)
    want = got.clone()
    before = (group.launches, kernel.launches)
    assert group(xs, ys, m, n, *ck, first, got, walk, **kw) is got
    plain_group(xs, ys, m, n, *ck, first, want, walk, **kw)
    torch.cuda.synchronize()
    assert (group.launches, kernel.launches) == (before[0] + 1, before[1] + 1)
    base = (first + torch.arange(G, device=cuda)) * 256
    bound = n if walk is None else torch.minimum(n, wj)
    reached = torch.ones((G, B), dtype=torch.bool, device=cuda) if walk is None else \
        active[None] & (wi[None] - 1 >= base[:, None])
    cols = reached[..., None] & (torch.arange(N, device=cuda) < bound[:, None])[None]
    rows = (base[:, None, None] + torch.arange(256, device=cuda)) < m[None, :, None]
    readable = cols[..., None] & rows[:, :, None, :]
    assert torch.equal(got[readable], want[readable])
    assert bool((got[~cols] == 0xA5).all())  # nothing outside the bounds
    assert int(readable.sum()) > 0 and bool((reached[-1] if case == "one" else reached).any())
    if case == "unreached":
        assert not bool(reached[4:].any())
    if case == "inactive_short_j":
        assert not bool(cols[:, 1].any()) and int(cols[:, 2].sum(dim=1).max()) == 3


# The group walk (csrc/traceback.cu walk_strip_kernel, K14 and K18: a warp a
# lane over staged move tiles, a replay group's strips in one launch)
# against the plain per-strip walks. Lanes are the replay cases' (N = 700,
# not a multiple of the 64-column tile; ragged n_b < N); the moves buffer
# starts as random bytes, so that a read of any cell the replay did not
# write shows. Cases: the top strip any walk reaches (G = 1), the top two,
# all ten strips (every walk starts in a lower strip of the group, at most
# the fifth), strips 2-9 (walks that leave the group active), an
# inactive lane beside one whose j is 3, a 50-step buffer, and walks forced
# along column 1 through every strip and along a strip's first row.
WALK_CASES = ("one", "two", "all", "lower_start", "inactive", "short_buffer", "edges")


@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("form", ("K14", "K18"))
def test_strip_walk_groups_match_plain(cuda, form, case):
    from parallel_genomeseq_tpu_torch.ops import engine

    affine = form == "K18"
    cfg, kw = replay_form("K17" if affine else "K13")
    xs, ys, m, n = affine_lanes(2, cuda)
    xs, m = xs[:, :REPLAY_ROWS].contiguous(), m.clamp(max=REPLAY_ROWS)
    _, ckpt, group, walk = engine.STRIP_KERNELS[engine.strip_key(cfg)]
    per_strip = traceback.walk_strip_level_affine if affine else traceback.walk_strip_level
    plain = traceback._walk_strip_affine_plain if affine else traceback._walk_strip_plain
    _, i, j, *ck = ckpt(xs, ys, m, n, **kw)
    B, N = ys.shape
    max_steps = 50 if case == "short_buffer" else 1200
    state = traceback.new_strip_state(i, j, max_steps, affine=affine)
    top = int((i - 1).max()) // 256
    first, G = {"one": (top, 1), "two": (top - 1, 2), "lower_start": (2, 8)}.get(case, (0, 10))
    if case == "inactive":
        state[3][1] = False
        state[1][2] = 3
    moves = torch.randint(0, 256, (G, B, N, 256), dtype=torch.uint8, device=cuda)
    group(xs, ys, m, n, *ck, first, moves, (state[0], state[1], state[3]), **kw)
    if case == "edges":
        # Lane 5 climbs column 1 from the top row through every strip (an F
        # run under affine gaps); lane 6 runs west along strip 5's first row
        # and stops at column 1 (affine: ends its E run there, stops at j = 0).
        up = scan_dp.H_F | scan_dp.F_EXT_BIT if affine else scan_dp.MOVE_N
        west = scan_dp.H_E | scan_dp.E_EXT_BIT if affine else scan_dp.MOVE_W
        moves[:, 5, 0, :] = up
        moves[5, 6, :, 0] = west
        moves[5, 6, 0, 0] = scan_dp.H_E if affine else scan_dp.STOP_BIT
        state[0][5], state[1][5], state[3][5] = REPLAY_ROWS, 1, True
        state[0][6], state[1][6], state[3][6] = 5 * 256 + 1, N, True
    x_mb = xs.T.contiguous()
    want = tuple(a.clone() for a in state)
    before = (per_strip.launches, per_strip.strips, walk.launches)
    assert walk(moves, x_mb, ys, first, state, max_steps=max_steps) is state
    for g in range(G - 1, -1, -1):
        plain(moves[g], x_mb, ys, (first + g) * 256, want, max_steps)
    torch.cuda.synchronize()
    assert (per_strip.launches, per_strip.strips, walk.launches) == (
        before[0] + 1, before[1] + G, before[2] + 1)
    for g, w in zip(state, want):
        assert torch.equal(g, w)
    assert int(state[4].max()) > 0
    if case == "inactive":
        assert int(state[4][1]) == 0
    if case == "short_buffer":
        assert int(state[4].max()) > max_steps
    if case == "edges":
        assert int(state[4][5]) == REPLAY_ROWS and int(state[4][6]) == N
        assert int(state[1][6]) == int(state[2][6]) == (0 if affine else 1)


def long_protein_slab(seed, dev, q_len):
    """A long query and a flat slab of ragged entries in compact codes (codes
    up to 29, past the table's 25, score as code 0): 60-900-aa entries and
    one of 2,300 aa, mutated query segments planted in two of them, and
    three lanes that start outside the slab or run past its end."""
    rng = np.random.default_rng(seed)
    _, table = scan_dp.profile_tables(blosum_config("blosum50"))
    q = rng.integers(1, 30, q_len).astype(np.uint8)
    lens = list(rng.integers(60, 900, 37)) + [2300]
    ents = [rng.integers(1, 30, int(k)).astype(np.uint8) for k in lens]
    for b, at in ((5, q_len - 700), (37, q_len // 3)):
        seg = q[at : at + 500].copy()
        seg[rng.integers(0, 500, 25)] = rng.integers(1, 30, 25)
        ents[b][40 : 40 + min(500, len(ents[b]) - 40)] = seg[: len(ents[b]) - 40]
    slab = np.concatenate(ents)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    off = np.append(off, [-5, len(slab) - 30, len(slab) + 9])
    n = np.append(np.array(lens, np.int32), [50, 400, 10]).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(q), t(slab), t(off), t(n), t(table)


@pytest.mark.parametrize("seed", [0, 1])
def test_k19_slab_matches_plain(cuda, seed):
    """K19's slab form (one 2,600-aa query shared by every lane, each lane's
    entry read through its offset) against its plain version: a planted
    2,300-aa entry, lanes clamped at the slab's ends."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    q, slab, off, n, table = long_protein_slab(seed, cuda, 2600)
    m = torch.full_like(n, q.shape[0])
    before = strips_cuda.sw_score_strips_profile.launches
    got = strips_cuda.sw_score_strips_profile(q, slab, m, n, table=table, gap=12, y_off=off)
    want = scan_dp.sw_profile_plain(q, slab, m, n, table=table, gap=12, y_off=off)
    torch.cuda.synchronize()
    assert strips_cuda.sw_score_strips_profile.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert int(got[0][5]) > 1000 and int(got[0][37]) > 1000 and int(got[0][38]) == 0


def test_k19_per_lane_matches_plain(cuda):
    """K19 on per-lane long queries (protein codes, ragged true lengths,
    one m past the padded shape) against its plain version."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    xs, ys, m, n, table = protein_lanes(2, cuda, B=9, M=2600, N=500)
    m[0] += 4000
    xs[3, 2000:2200] = ys[3, 100:300]
    n[3] = 400
    before = strips_cuda.sw_score_strips_profile.launches
    got = strips_cuda.sw_score_strips_profile(xs, ys, m, n, table=table, gap=12)
    want = scan_dp.sw_profile_plain(xs, ys, m, n, table=table, gap=12)
    torch.cuda.synchronize()
    assert strips_cuda.sw_score_strips_profile.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k19_beyond_one_pass_matches_plain(cuda):
    """A 16,500-aa query on a small slab: past one block's pass (10,240
    rows) the lanes' bound rows, back to back in the slab form, carry H
    between passes; a segment planted across the pass edge is found."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    q, slab, off, n, table = long_protein_slab(3, cuda, 16_500)
    edge = strips_cuda.ROWS_PER_PASS
    slab[int(off[7]) + 10 : int(off[7]) + 210] = q[edge - 100 : edge + 100]
    n[7] = max(int(n[7]), 220)
    m = torch.full_like(n, q.shape[0])
    got = strips_cuda.sw_score_strips_profile(q, slab, m, n, table=table, gap=12, y_off=off)
    want = scan_dp.sw_profile_plain(q, slab, m, n, table=table, gap=12, y_off=off)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1][7]) > edge and int(got[0][7]) > 500


def test_profile_strip_traceback_kernels_match_plain(cuda):
    """K20 (checkpoints), K21 (every strip, valid cells) and the K14 walk
    over raw letters against their plain versions, and the CUDA engine's
    whole matrix strip traceback against the plain engine's on the card."""
    from parallel_genomeseq_tpu_torch.ops import engine, strips_cuda

    cfg = blosum_config("blosum50", gap_penalty=2.0)
    lut, _ = scan_dp.profile_tables(cfg)
    alpha = np.frombuffer(cfg.alphabet[:20].encode(), np.uint8)
    rng = np.random.default_rng(4)
    B, M, N = 7, 2600, 600
    ref = rng.choice(alpha, N)
    raw_x = rng.choice(alpha, (B, M)).astype(np.uint8)
    for b in range(B - 1):
        seg = ref[25 * b : 25 * b + 400].copy()
        seg[rng.integers(0, 400, 20)] = rng.choice(alpha, 20)
        raw_x[b, 300 + 250 * b : 700 + 250 * b] = seg
    raw_y = np.broadcast_to(ref, (B, N)).copy()
    m = rng.integers(2000, M + 1, B).astype(np.int32)
    n = np.full(B, N, np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    rx, ry, m, n = t(raw_x), t(raw_y), t(m), t(n)
    xs, ys = t(lut)[rx.long()], t(lut)[ry.long()]
    kw = dict(table=t(scan_dp.profile_tables(cfg)[1]), gap=2)
    got = strips_cuda.sw_score_strips_profile_ckpt(xs, ys, m, n, **kw)
    want = scan_dp.sw_profile_ckpt_plain(xs, ys, m, n, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, i, j, ck = got
    x_mb = rx.T.contiguous()
    state = traceback.new_strip_state(i, j, 1200)
    plain_state = tuple(a.clone() for a in state)
    r = torch.arange(256, device=cuda)
    before = strips_cuda.strip_profile_moves.launches
    nstrips = -(-M // 256)
    for s in range(nstrips - 1, -1, -1):
        rowin = ck[:, s - 1] if s else None
        got = strips_cuda.strip_profile_moves(xs, ys, m, n, rowin, s * 256, **kw)
        want = scan_dp.strip_profile_moves_plain(xs, ys, m, n, rowin, s * 256, **kw)
        valid = ((s * 256 + r)[None, None, :] < m[:, None, None]) & \
            (torch.arange(N, device=cuda)[None, :, None] < n[:, None, None])
        assert torch.equal(got[valid], want[valid])
        traceback.walk_strip_level(got, x_mb, ry, s * 256, state, max_steps=1200)
        traceback._walk_strip_plain(want, x_mb, ry, s * 256, plain_state, 1200)
        for g, w in zip(state, plain_state):
            assert torch.equal(g, w)
    assert strips_cuda.strip_profile_moves.launches == before + nstrips
    assert int(state[4][: B - 1].min()) > 300 and not bool(state[3].any())
    got = engine.CudaEngine(cfg, device=cuda).score_batch_strip_moves(rx, ry, m, n, max_steps=1200)
    want = engine.PlainEngine(cfg, device=cuda).score_batch_strip_moves(rx, ry, m, n,
                                                                        max_steps=1200)
    for k in ("score", "i", "j", "pos", "cx", "cy", "steps"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["cx"], state[5])  # raw letters, as the walk above emitted


def test_solve_uniprot_long_query_cuda_matches_cpu(cuda, tmp_path):
    """A 2,300-aa query: the card's CSV (K19's slab scan, then K20, K21 and
    the K14 walk for the planted 2,300-aa entries in the top hits; no K4)
    equals the CPU's, and ``--engine plain`` on the card gives it too
    without a launch."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    query, db, _ = write_protein_dataset(tmp_path, n_entries=40, query_len=2300, seed=5)
    base = ["--query", str(query), "--database", str(db), "--top", "4"]
    counters = (strips_cuda.sw_score_strips_profile, strips_cuda.sw_score_strips_profile_ckpt,
                strips_cuda.strip_profile_moves, traceback.walk_strip_level, profile_cuda.sw_profile)
    before = [fn.launches for fn in counters]
    assert solve_uniprot.main(base + ["--output", str(tmp_path / "gpu.csv")]) == 0
    assert [fn.launches > b for fn, b in zip(counters, before)] == [True] * 4 + [False]
    before = [fn.launches for fn in counters]
    assert solve_uniprot.main(base + ["--engine", "plain", "--output", str(tmp_path / "p.csv")]) == 0
    assert [fn.launches for fn in counters] == before
    assert solve_uniprot.main(base + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
    assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()


PROTEIN_AFFINE = dict(gap_open=10, gap=2)  # swps3's BLOSUM50 gaps


@pytest.mark.parametrize("seed", [0, 1])
def test_k22_slab_matches_plain(cuda, seed):
    """K22's slab form (one 2,600-aa query shared by every lane under gaps
    10/2, each lane's entry read through its offset) against its plain
    version: planted 500-aa segments, lanes clamped at the slab's ends."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    q, slab, off, n, table = long_protein_slab(seed, cuda, 2600)
    m = torch.full_like(n, q.shape[0])
    before = strips_cuda.sw_score_strips_profile_affine.launches
    got = strips_cuda.sw_score_strips_profile_affine(q, slab, m, n, table=table, y_off=off,
                                                     **PROTEIN_AFFINE)
    want = scan_dp.sw_profile_plain(q, slab, m, n, table=table, y_off=off, **PROTEIN_AFFINE)
    torch.cuda.synchronize()
    assert strips_cuda.sw_score_strips_profile_affine.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert int(got[0][5]) > 1000 and int(got[0][37]) > 1000 and int(got[0][38]) == 0


def test_k22_per_lane_matches_plain(cuda):
    """K22 on per-lane long queries (protein codes, ragged true lengths, one
    m past the padded shape, a segment planted with a 7-residue deletion)
    against its plain version."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    xs, ys, m, n, table = protein_lanes(2, cuda, B=9, M=2600, N=500)
    m[0] += 4000
    # Lane 5 (m = 2,117, n = 441): the shared motif (its y's last 220
    # codes) moved to x's rows 1,001-1,213 with 7 of its codes deleted.
    xs[5, :220] = xs[6, 300:520]
    xs[5, 1000:1100] = ys[5, 221:321]
    xs[5, 1100:1213] = ys[5, 328:441]
    got = strips_cuda.sw_score_strips_profile_affine(xs, ys, m, n, table=table, **PROTEIN_AFFINE)
    want = scan_dp.sw_profile_plain(xs, ys, m, n, table=table, **PROTEIN_AFFINE)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1][5]) == 1213 and int(got[2][5]) == 441  # across the deletion


def test_k22_beyond_one_pass_matches_plain(cuda):
    """A 12,800-aa query on a small slab: past one affine block's pass
    (10,240 rows) the lanes' (H, F) bound rows, back to back in the slab
    form, carry between passes; a segment planted across the pass edge with
    an 8-residue insertion (an F run over the edge) is found."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    q, slab, off, n, table = long_protein_slab(3, cuda, 12_800)
    edge = strips_cuda.ROWS_PER_PASS_AFFINE
    at = int(off[7]) + 10
    slab[at : at + 100] = q[edge - 100 : edge]
    slab[at + 100 : at + 200] = q[edge + 8 : edge + 108]
    n[7] = max(int(n[7]), 220)
    m = torch.full_like(n, q.shape[0])
    got = strips_cuda.sw_score_strips_profile_affine(q, slab, m, n, table=table, y_off=off,
                                                     **PROTEIN_AFFINE)
    want = scan_dp.sw_profile_plain(q, slab, m, n, table=table, y_off=off, **PROTEIN_AFFINE)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1][7]) > edge + 50 and int(got[0][7]) > 700


def test_affine_profile_strip_traceback_kernels_match_plain(cuda):
    """K23 (H and F checkpoints), K24 (every strip, valid cells) and the K18
    walk over raw letters against their plain versions under BLOSUM50 10/2,
    and the CUDA engine's whole affine matrix strip traceback against the
    plain engine's on the card."""
    from parallel_genomeseq_tpu_torch.ops import engine, strips_cuda

    cfg = blosum_config("blosum50", gap_penalty=2.0, gap_open=10.0)
    lut, table = scan_dp.profile_tables(cfg)
    alpha = np.frombuffer(cfg.alphabet[:20].encode(), np.uint8)
    rng = np.random.default_rng(4)
    B, M, N = 7, 2600, 600
    ref = rng.choice(alpha, N)
    raw_x = rng.choice(alpha, (B, M)).astype(np.uint8)
    for b in range(B - 1):
        seg = ref[25 * b : 25 * b + 400].copy()
        seg[rng.integers(0, 400, 20)] = rng.choice(alpha, 20)
        seg = np.concatenate([seg[:200], rng.choice(alpha, 3 * b), seg[200:]])  # an insertion
        raw_x[b, 300 + 250 * b : 300 + 250 * b + len(seg)] = seg
    raw_y = np.broadcast_to(ref, (B, N)).copy()
    m = rng.integers(2000, M + 1, B).astype(np.int32)
    m[:6] = M
    n = np.full(B, N, np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    rx, ry, m, n = t(raw_x), t(raw_y), t(m), t(n)
    xs, ys = t(lut)[rx.long()], t(lut)[ry.long()]
    kw = dict(table=t(table), **PROTEIN_AFFINE)
    got = strips_cuda.sw_score_strips_profile_affine_ckpt(xs, ys, m, n, **kw)
    want = scan_dp.sw_profile_affine_ckpt_plain(xs, ys, m, n, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, i, j, ck, fck = got
    x_mb = rx.T.contiguous()
    state = traceback.new_strip_state(i, j, 1200, affine=True)
    plain_state = tuple(a.clone() for a in state)
    r = torch.arange(256, device=cuda)
    before = (strips_cuda.strip_profile_affine_moves.launches,
              traceback.walk_strip_level_affine.launches)
    nstrips = -(-M // 256)
    for s in range(nstrips - 1, -1, -1):
        rows = (ck[:, s - 1], fck[:, s - 1]) if s else (None, None)
        got = strips_cuda.strip_profile_affine_moves(xs, ys, m, n, *rows, s * 256, **kw)
        want = scan_dp.strip_profile_affine_moves_plain(xs, ys, m, n, *rows, s * 256, **kw)
        valid = ((s * 256 + r)[None, None, :] < m[:, None, None]) & \
            (torch.arange(N, device=cuda)[None, :, None] < n[:, None, None])
        assert torch.equal(got[valid], want[valid])
        traceback.walk_strip_level_affine(got, x_mb, ry, s * 256, state, max_steps=1200)
        traceback._walk_strip_affine_plain(want, x_mb, ry, s * 256, plain_state, 1200)
        for g, w in zip(state, plain_state):
            assert torch.equal(g, w)
    assert (strips_cuda.strip_profile_affine_moves.launches,
            traceback.walk_strip_level_affine.launches) == (before[0] + nstrips,
                                                            before[1] + nstrips)
    assert int(state[4][: B - 1].min()) > 300 and not bool((state[3] & (state[0] > 0)).any())
    got = engine.CudaEngine(cfg, device=cuda).score_batch_strip_moves(rx, ry, m, n, max_steps=1200)
    want = engine.PlainEngine(cfg, device=cuda).score_batch_strip_moves(rx, ry, m, n,
                                                                        max_steps=1200)
    for k in ("score", "i", "j", "pos", "cx", "cy", "steps"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["cx"], state[5])  # raw letters, as the walk above emitted
    cons = traceback.decode_consensus(got["cx"].cpu(), got["cy"].cpu(), got["steps"].cpu())
    assert "-" * 15 in cons[5][1]  # lane 5's 15-residue insertion


def test_solve_uniprot_long_query_affine_cuda_matches_cpu(cuda, tmp_path):
    """A 2,300-aa query under --gap-open 10 --gap-penalty 2: the card's CSV
    (K22's slab scan, then K23, K24 and the K18 walk for the planted
    2,300-aa entries in the top hits; no K8 and none of the linear profile
    strips) equals the CPU's, and ``--engine plain`` on the card gives it
    too without a launch."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    query, db, _ = write_protein_dataset(tmp_path, n_entries=40, query_len=2300, seed=5)
    base = ["--query", str(query), "--database", str(db), "--top", "4"] + AFFINE_FLAGS
    counters = (strips_cuda.sw_score_strips_profile_affine,
                strips_cuda.sw_score_strips_profile_affine_ckpt,
                strips_cuda.strip_profile_affine_moves, traceback.walk_strip_level_affine,
                profile_cuda.sw_profile_affine, strips_cuda.sw_score_strips_profile,
                strips_cuda.sw_score_strips_profile_ckpt, strips_cuda.strip_profile_moves)
    before = [fn.launches for fn in counters]
    assert solve_uniprot.main(base + ["--output", str(tmp_path / "gpu.csv")]) == 0
    assert [fn.launches > b for fn, b in zip(counters, before)] == [True] * 4 + [False] * 4
    before = [fn.launches for fn in counters]
    assert solve_uniprot.main(base + ["--engine", "plain", "--output", str(tmp_path / "p.csv")]) == 0
    assert [fn.launches for fn in counters] == before
    assert solve_uniprot.main(base + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
    assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()


def test_solve_big_matrix_affine_cuda_matches_cpu(cuda):
    """solve_big --matrix blosum50 --gap-open 10 --gap-penalty 2 on the card
    (K22; with --traceback K23, K24, K18) gives the CPU's results, read for
    read, and launches neither the uniform nor the linear profile strips."""
    from parallel_genomeseq_tpu_torch.cli import solve_big
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    base = ["2", "1", "--ref-len", "9000", "--read-len", "2300", "--n-reads", "3",
            "--matrix", "blosum50"] + AFFINE_FLAGS
    counters = (strips_cuda.sw_score_strips_profile_affine,
                strips_cuda.sw_score_strips_profile_affine_ckpt,
                strips_cuda.strip_profile_affine_moves, traceback.walk_strip_level_affine)
    others = (strips_cuda.sw_score_strips, strips_cuda.sw_score_strips_affine,
              strips_cuda.sw_score_strips_profile, strips_cuda.sw_score_strips_profile_ckpt,
              strips_cuda.strip_profile_moves, traceback.walk_strip_level)
    for extra in ([], ["--traceback"]):
        before = [fn.launches for fn in counters + others]
        gpu = solve_big.run(base + extra)
        cpu = solve_big.run(base + extra + ["--device", "cpu"])
        launched = [fn.launches > b for fn, b in zip(counters + others, before)]
        assert launched == ([True] * 4 if extra else [True, False, False, False]) + [False] * 6
        fields = lambda r: (r.score, r.pos, r.max_i, r.max_j, r.consensus_x, r.consensus_y)
        assert [fields(r) for r in gpu.results] == [fields(r) for r in cpu.results]


# The sweeps' hand-offs (csrc/strips.cu): a band's last row goes down its
# warp by shuffle and to the next warp through a ring of SWEEP_RING columns;
# the forms of the one sweep kernel, and the cases that stress those edges.
# Short reads take 32-row bands (a warp every 1,024 rows) in every form but
# the uniform affine one, 10,008 rows and longer take 16-row bands (a warp
# every 512).
SWEEP_FORMS = ("uniform", "uniform_affine", "profile", "profile_affine", "slab", "slab_affine")
HANDOFF_CASES = ("rows_1023", "rows_1024", "rows_1025", "rows_10008", "partial_last_warp",
                 "short_n", "m_zero", "past_m_b", "tie_across_warps", "two_passes")


def handoff_lanes(case, alphabet, rows_per_pass, ring, seed=0):
    """Letters (indices below ``alphabet``) of one hand-off case: xs (B, M),
    ys (B, N) uint8, m, n (B,) int32 numpy arrays, and {lane: (i, j)} where
    the case pins the best cell. Each lane with rows and columns holds a
    mutated stretch of its y across a warp edge (row 1,024, a warp edge of
    both band heights; in lanes too short for it row 512, one of 16-row
    bands) or the pass edge. Every case but rows_1023 and rows_1024 launches
    more than one warp, so its lanes cross the ring between warps.
      rows_1023/1024/1025: a band crossing a warp edge of 32-row bands (31 x
        32 + 31 rows and so on); rows_10008: solve_big's window height,
        16-row bands;
      partial_last_warp: 1,700 rows, the last warp partly past m_b;
      short_n: 2,100 rows, n_b of 1, 2, ring - 1, ring, ring + 1 and 0;
      m_zero: 2,100 rows, m_b = 0 beside n_b = 0 and m_b = 1;
      past_m_b: x is y shifted by 60 letters on every row, past m_b too (the
        band holding m_b, in the third warp of 32-row bands, sweeps rows that
        would score higher), standard residues under a table: the best cell
        is (m_b, m_b + 60);
      tie_across_warps: y (120 letters, standard residues under a table) at
        rows 281-400 (warp 0) and 1,281-1,400 (warp 1 of 32-row bands, warp
        2 of 16-row bands) of lane 0: both copies reach the most column 120
        can hold, the smaller i wins; lane 1 keeps only the second copy;
      two_passes: one pass of rows plus 300, the stretch across the edge."""
    rng = np.random.default_rng(seed)
    letters = lambda *shape: rng.integers(0, alphabet, shape).astype(np.uint8)
    M, N = 900, 300
    if case.startswith("rows_"):
        M = int(case[len("rows_"):])
        m, n = [M, M, M - 1, 700], [N, 250, N, 200]
        if M > 2048:
            m, n = [M, M - 8, M - 18], [N, 250, N]
    elif case == "partial_last_warp":
        M = 1700
        m, n = [M, 1650, 1540, 1100], [N, 280, N, 150]
    elif case == "short_n":
        M = 2100
        m, n = [M] * 7, [1, 2, ring - 1, ring, ring + 1, 0, N]
    elif case == "m_zero":
        M = 2100
        m, n = [0, M, 1, 1800], [N, 0, N, 250]
    elif case == "past_m_b":
        M, N = 2100, 2200
        m, n = [2056, 2049, 2063, 2079], [N] * 4
    elif case == "tie_across_warps":
        M, N = 1600, 120
        m, n = [M, M], [N, N]
    else:
        M, N = rows_per_pass + 300, 200
        m, n = [M, rows_per_pass - 3, M], [N, N, 150]
    xs, ys = letters(len(m), M), letters(len(m), N)
    pins = {}
    if case == "past_m_b":
        ys[:] = rng.integers(1 if alphabet > 4 else 0, min(alphabet, 21), ys.shape)
        xs[:] = ys[:, 60 : 60 + M]
        pins = {b: (mb, mb + 60) for b, mb in enumerate(m)}
    elif case == "tie_across_warps":
        ys[:] = rng.integers(1 if alphabet > 4 else 0, min(alphabet, 21), N)
        xs[0, 280:400] = xs[0, 1280:1400] = ys[0]
        xs[1] = xs[0]
        xs[1, 280:400] = letters(120)
        pins = {0: (400, 120), 1: (1400, 120)}
    else:
        for b in range(len(m)):
            k = min(m[b], n[b], 250)
            if k < 20:
                continue
            edge = (rows_per_pass if m[b] > rows_per_pass
                    else 1024 if m[b] >= 1024 + k // 2 else 512)
            at = max(0, min(m[b] - k, edge - k // 2))
            seg = ys[b, :k].copy()
            hit = rng.integers(0, k, k // 25)
            seg[hit] = letters(len(hit))
            xs[b, at : at + k] = seg
    return xs, ys, np.array(m, np.int32), np.array(n, np.int32), pins


@pytest.mark.parametrize("case", HANDOFF_CASES)
@pytest.mark.parametrize("form", SWEEP_FORMS)
def test_sweep_handoffs_match_plain(cuda, form, case):
    """Every form of the sweep kernel (K11/K12, K15/K16, K19/K20, K22/K23,
    K19 and K22 on a slab) against its plain version on the hand-off cases:
    (score, i, j) and, where the form checkpoints, every H (and F) row."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    affine = form.endswith("affine")
    protein = not form.startswith("uniform")
    xs, ys, m, n, pins = handoff_lanes(case, 30 if protein else 4, strips_cuda.ROWS_PER_PASS,
                                       strips_cuda.SWEEP_RING)
    _, table = scan_dp.profile_tables(blosum_config("blosum50"))
    # Every case but the two single-warp ones launches more than one warp.
    for with_ckpt in (False, True)[: 1 if form.startswith("slab") else 2]:
        threads = strips_cuda.sweep_occupancy(xs.shape[-1], affine=affine, ckpt=with_ckpt,
                                              ncodes=table.shape[0] if protein else 0)[0]
        assert threads > 32 or case in ("rows_1023", "rows_1024")
    if not protein:
        acgt = np.frombuffer(b"ACGT", np.uint8)
        xs, ys = acgt[xs], acgt[ys]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    m, n = t(m), t(n)
    if form.startswith("slab"):
        # One query shared by every lane (lane 0's x); the lanes' y back to
        # back in a flat slab.
        off = np.concatenate([[0], np.cumsum(n.cpu().numpy())[:-1]]).astype(np.int64)
        slab = np.concatenate([ys[b, : int(n[b])] for b in range(len(off))])
        kw = dict(table=t(table), **(PROTEIN_AFFINE if affine else dict(gap=12)))
        sweep = (strips_cuda.sw_score_strips_profile_affine if affine
                 else strips_cuda.sw_score_strips_profile)
        before = sweep.launches
        got = sweep(t(xs[0]), t(slab), m, n, y_off=t(off), **kw)
        want = scan_dp.sw_profile_plain(t(xs[0]), t(slab), m, n, y_off=t(off), **kw)
        torch.cuda.synchronize()
        assert sweep.launches == before + 1
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)
        pins = {b: ij for b, ij in pins.items() if b == 0}
    else:
        if protein:
            kw = dict(table=t(table), **(PROTEIN_AFFINE if affine else dict(gap=12)))
            sweep, ckpt, plain = (
                (strips_cuda.sw_score_strips_profile_affine,
                 strips_cuda.sw_score_strips_profile_affine_ckpt,
                 scan_dp.sw_profile_affine_ckpt_plain) if affine else
                (strips_cuda.sw_score_strips_profile, strips_cuda.sw_score_strips_profile_ckpt,
                 scan_dp.sw_profile_ckpt_plain))
        else:
            kw = BWA if affine else KW
            sweep, ckpt, plain = (
                (strips_cuda.sw_score_strips_affine, strips_cuda.sw_score_strips_affine_ckpt,
                 scan_dp.sw_score_affine_ckpt_plain) if affine else
                (strips_cuda.sw_score_strips, strips_cuda.sw_score_strips_ckpt,
                 scan_dp.sw_score_ckpt_plain))
        before = (sweep.launches, ckpt.launches)
        got = sweep(t(xs), t(ys), m, n, **kw)
        got_ck = ckpt(t(xs), t(ys), m, n, **kw)
        want = plain(t(xs), t(ys), m, n, **kw)
        torch.cuda.synchronize()
        assert (sweep.launches, ckpt.launches) == (before[0] + 1, before[1] + 1)
        assert len(got) == 3 and len(got_ck) == len(want) == (5 if affine else 4)
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)
        for g, w in zip(got_ck, want):
            assert torch.equal(g, w)
        if case == "tie_across_warps":
            assert int(want[0][0]) == int(want[0][1])
    for b, (i, j) in pins.items():
        assert (int(want[1][b]), int(want[2][b])) == (i, j)
    live = (m > 0) & (n > 0)
    assert bool((want[0][~live] == 0).all()) and int(want[0].max()) > 0


# K25 cases (csrc/global_dp.cu: an anti-diagonal sweep, a warp a chunk of
# 32 x R rows of a lane, chunks chained through device memory, R and warps a
# block by ops/global_dp.launch_shape): (B, M, N, seed, ragged lengths,
# protein letters under BLOSUM62 gap 4, form). The packed (B, M) form: m = 1
# and n = 1; N + 1 at and past 8 and 4,096 columns (the first design's run
# and tile); N of 25,000 (past the first design's shared-memory rows); lanes
# of very different lengths with m_b = 0 and n_b = 0 among them; B of 1, 2,
# 3, 100. Lanes read in place: at random offsets of two shared buffers,
# forward or reversed ("offsets"); m_b on, one short of and one past the
# chunk edges at R = M, with m_b = 0 and n_b = 0 ("edges"); a deep
# Hirschberg level's B small lanes ("deep"); random bytes of more than 64
# values, which read the byte table from device memory ("bytes"); DNA under
# scores past int8, which read the shared table and not packed registers
# ("wide"); two lanes of 60 and 94 chunks at R = M, every chunk in flight on
# the lane's one boundary row, one lane's x and the other's y reversed
# ("chain").
NW_CASES = {
    "m1": (5, 1, 300, 0, False, False, "packed"),
    "n1": (5, 200, 1, 1, False, False, "packed"),
    "n_one_run": (3, 50, 7, 2, False, False, "packed"),
    "n_past_run": (3, 50, 8, 3, False, False, "packed"),
    "n_tile": (2, 40, 4095, 4, False, False, "packed"),
    "n_past_tile": (2, 40, 4096, 5, False, False, "packed"),
    "global_rows": (2, 30, 25_000, 6, False, False, "packed"),
    "ragged_100": (100, 600, 700, 7, True, False, "packed"),
    "b1": (1, 300, 5000, 8, False, False, "packed"),
    "b2_related": (2, 1000, 2000, 9, False, False, "packed"),
    "blosum62": (17, 300, 400, 10, True, True, "packed"),
    "b3_long": (3, 2600, 4000, 11, True, False, "packed"),
    "offsets_reversed": (40, 2000, 3000, 12, True, False, "offsets"),
    "edges_r4": (9, 4, 700, 13, False, False, "edges"),
    "edges_r8": (9, 8, 700, 14, False, False, "edges"),
    "edges_r16": (9, 16, 700, 15, False, False, "edges"),
    "edges_r32": (9, 32, 700, 16, False, False, "edges"),
    "deep_level": (4096, 5, 12, 17, True, False, "deep"),
    "bytes_past_64_codes": (3, 1500, 2000, 18, True, False, "bytes"),
    "scores_past_int8": (6, 1500, 2000, 19, True, False, "wide"),
    "chain_r4": (2, 4, 3000, 20, False, False, "chain"),
}


def nw_lanes(case, dev):
    """(x, y, m, n, table, gap) of a packed NW_CASES case on ``dev``: each
    read a mutated copy of a stretch of its reference, lengths ragged or
    full."""
    from parallel_genomeseq_tpu_torch.ops import global_dp
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    B, M, N, seed, ragged_lens, protein, _ = NW_CASES[case]
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV" if protein else b"ACGT", np.uint8)
    m = rng.integers(0, M + 1, B) if ragged_lens else np.full(B, M)
    n = rng.integers(0, N + 1, B) if ragged_lens else np.full(B, N)
    if ragged_lens:
        m[:3], n[:3] = [0, M, 1], [N, 0, N]
    x = rng.choice(letters, (B, M))
    y = rng.choice(letters, (B, N))
    for b in range(B):
        k = min(m[b], n[b])
        seg = y[b, :k].copy()
        seg[rng.random(k) < 0.1] = rng.choice(letters)
        x[b, :k] = seg
    cfg = blosum_config("blosum62", gap_penalty=4.0) if protein else ScoringConfig()
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(dev)
    return (t(x, np.uint8), t(y, np.uint8), t(m, np.int32), t(n, np.int32),
            global_dp.byte_table(cfg, dev), int(cfg.gap_penalty))


def nw_lane_form(case, dev):
    """(x, y flat buffers, their Lanes plan, table, gap) of an NW_CASES case
    read in place."""
    from parallel_genomeseq_tpu_torch.ops import global_dp
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    B, M, N, seed, _, _, form = NW_CASES[case]
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    cfg = {"bytes": ScoringConfig(match=5, mismatch=-4, gap_penalty=3),
           "wide": ScoringConfig(match=200, mismatch=-150, gap_penalty=7)}.get(
        form, ScoringConfig())
    shape = {}
    if form == "offsets":
        X = rng.choice(acgt, 40_000)
        Y = X.copy()
        Y[rng.random(len(Y)) < 0.05] = rng.choice(acgt)
        m, n = rng.integers(0, M, B), rng.integers(0, N, B)
        shape = dict(x_off=rng.integers(0, len(X) - m), y_off=rng.integers(0, len(Y) - n),
                     x_rev=rng.random(B) < 0.5, y_rev=rng.random(B) < 0.5)
    elif form == "chain":
        c = 32 * M
        m, n = np.array([94 * c - 5, 60 * c]), np.array([N, N - 7])
        X = rng.choice(acgt, int(m.sum()))
        Y = X[: int(n.sum())].copy()
        Y[rng.random(len(Y)) < 0.05] = rng.choice(acgt)
        shape = dict(rows=M, x_rev=[True, False], y_rev=[False, True])
    else:
        if form == "edges":
            c = 32 * M
            m = np.array([c, c - 1, c + 1, 2 * c, 2 * c + 1, 1, 0, 5, 3 * c - 1])
            n = np.array([N, 1, 300, 129, 0, 2, 40, 0, 64])
            shape = dict(rows=M)
        else:
            m, n = rng.integers(1, M + 1, B), rng.integers(1, N + 1, B)
        alphabet = np.arange(256, dtype=np.uint8) if form == "bytes" else acgt
        X = rng.choice(alphabet, int(m.sum()))
        Y = rng.choice(alphabet, int(n.sum()))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
    return (t(X), t(Y), global_dp.plan_lanes(m, n, **shape), global_dp.byte_table(cfg, dev),
            int(cfg.gap_penalty))


@pytest.mark.parametrize("case", list(NW_CASES))
def test_k25_matches_plain(cuda, case):
    """K25's last rows equal the plain row scan's on every column (0 past
    n_b in the packed form), in one launch whatever the shape: N past the
    first design's shared-memory limit, lanes read in place, every chunk
    edge."""
    from parallel_genomeseq_tpu_torch.ops import global_dp

    before = global_dp.nw_lastrow.launches
    if NW_CASES[case][-1] == "packed":
        x, y, m, n, table, gap = nw_lanes(case, cuda)
        got = global_dp.nw_lastrow(x, y, m, n, table=table, gap=gap)
        want = global_dp.nw_lastrow_plain(x, y, m, n, table=table, gap=gap)
        assert got.is_cuda and got.shape == (x.shape[0], y.shape[1] + 1)
    else:
        x, y, lanes, table, gap = nw_lane_form(case, cuda)
        got = global_dp.nw_lastrow_lanes(x, y, lanes, table=table, gap=gap)
        want = global_dp.nw_lastrow_lanes_plain(x, y, lanes, table=table, gap=gap)
        assert got.is_cuda and got.shape == (lanes.total_out,)
    torch.cuda.synchronize()
    assert global_dp.nw_lastrow.launches == before + 1
    assert torch.equal(got, want)


def test_k25_long_lanes_share_one_boundary_row(cuda):
    """Two lanes of 300,000 x 300,000 cells, thousands of chunks: each lane
    keeps one boundary row of n_b + 1 slots (a row a chunk edge would take
    over 1 GiB), the launch allocates no more than that beside its output,
    and the rows equal the closed form for x of one letter (A) against y of
    two (A, C): min(m, j) pairs, the A's matched first, the rest gapped."""
    from parallel_genomeseq_tpu_torch.ops import global_dp
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    cfg = ScoringConfig()
    L = 300_000
    rng = np.random.default_rng(21)
    m, n = np.array([L, L - 3]), np.array([L - 11, L])
    X = np.full(int(m.sum()), ord("A"), np.uint8)
    Y = rng.choice(np.frombuffer(b"AC", np.uint8), int(n.sum()))
    lanes = global_dp.plan_lanes(m, n, y_rev=[False, True])
    assert lanes.bound_ints == int((n + 1).sum())
    assert 8 * int(((lanes.chunks - 1) * (n + 1)).sum()) > 1 << 30
    x, y = torch.from_numpy(X).to(cuda), torch.from_numpy(Y).to(cuda)
    table = global_dp.byte_table(cfg, cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    got = global_dp.nw_lastrow_lanes(x, y, lanes, table=table, gap=2).cpu().numpy()
    extra = torch.cuda.max_memory_allocated(cuda) - base
    assert extra <= 4 * lanes.total_out + 8 * lanes.bound_ints + (1 << 20)
    for b in range(2):
        yb = Y[int(lanes.y_off[b]) : int(lanes.y_off[b] + n[b])][:: -1 if b else 1]
        j = np.arange(n[b] + 1)
        a = np.concatenate([[0], np.cumsum(yb == ord("A"))])
        p = np.minimum(m[b], j)
        pa = np.minimum(a, p)
        want = 3 * pa - 3 * (p - pa) - 2 * (m[b] + j - 2 * p)
        o = int(lanes.out_off[b])
        np.testing.assert_array_equal(got[o : o + n[b] + 1], want)


def seeded_dataset(tmp_path):
    from parallel_genomeseq_tpu_torch.seqio.readers import read_fasta, read_ground_truth

    ref_path, csv_path = write_dataset(tmp_path, ref_len=3000, n_reads=96, seed=4)
    reads = [r["SEQ"] for r in read_ground_truth(str(csv_path))]
    return ref_path, csv_path, read_fasta(str(ref_path)), reads


@pytest.mark.parametrize("kw", [{}, dict(match=1, mismatch=-4, gap_open=6, gap_penalty=1)],
                         ids=["linear", "bwa"])
def test_seed_extend_cuda_matches_cpu(cuda, tmp_path, kw):
    """SeedExtendAligner on the card (K2 and K3, or K7 and K10, at the
    windows' width, no window sweep) gives the CPU's results, field by
    field, and ``solve_small --seed-extend`` the CPU's CSV."""
    from parallel_genomeseq_tpu_torch.models.seed_extend import SeedExtendAligner
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    ref_path, csv_path, ref, reads = seeded_dataset(tmp_path)
    cfg = ScoringConfig(**kw)
    affine = bool(kw)
    moves = wavefront_cuda.sw_score_affine_moves if affine else wavefront_cuda.sw_score_moves
    walk = traceback.walk_moves_affine if affine else traceback.walk_moves
    sweep = wavefront_cuda.sw_score_affine if affine else wavefront_cuda.sw_score
    batch = reads[:64] + ["WYWYWYWYWYWYWYWYWYWYWYWYWYWYWYWY"]
    before = (moves.launches, walk.launches, sweep.launches)
    got = SeedExtendAligner(ref, cfg, device=cuda).align_batch(batch)
    assert (moves.launches - before[0], walk.launches - before[1]) == (2, 2)  # seeded, full
    assert sweep.launches == before[2]
    want = SeedExtendAligner(ref, cfg, device="cpu").align_batch(batch)
    fields = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")
    for g, w in zip(got, want):
        assert [getattr(g, f) for f in fields] == [getattr(w, f) for f in fields]
    flags = BWA_FLAGS if affine else []
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "32",
            "--seed-extend"] + flags
    assert solve_small.main(base + ["--output", str(tmp_path / "gpu.csv")]) == 0
    assert solve_small.main(base + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
    assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()


@pytest.mark.parametrize("device_cells", [0, 20_000], ids=["all_on_card", "mixed"])
def test_hirschberg_cuda_matches_cpu(cuda, device_cells):
    """hirschberg_align on the card -- every subproblem in K25 (device_cells
    = 0), or the large ones there and the rest on the CPU route within the
    same levels -- gives the CPU's score and consensus strings, with at most
    one K25 launch per recursion level."""
    from parallel_genomeseq_tpu_torch.models import hirschberg
    from parallel_genomeseq_tpu_torch.ops import global_dp
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    rng = np.random.default_rng(3)
    y = "".join(rng.choice(list("ACGT"), 900))
    x = "".join(c if rng.random() > 0.08 else "ACGT"[int(rng.integers(4))] for c in y[50:800])
    prot = "".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"), 400))
    for a, b, cfg in ((x, y, ScoringConfig()), (x[:40], y, ScoringConfig()),
                      (prot[:300], prot[40:], blosum_config("blosum62", gap_penalty=4.0))):
        levels = int(np.ceil(np.log2(len(a)))) + 1
        before = global_dp.nw_lastrow.launches
        got = hirschberg.hirschberg_align(a, b, cfg, device_cells=device_cells, device=cuda)
        assert 1 <= global_dp.nw_lastrow.launches - before <= levels
        want = hirschberg.hirschberg_align(a, b, cfg, device_cells=0, device="cpu")
        assert (got.score, got.consensus_x, got.consensus_y) == \
            (want.score, want.consensus_x, want.consensus_y)


# The randomized campaign on the card: BatchSWAligner's CUDA route against
# its plain route on the same card, random scoring (uniform or a random
# matrix, linear or affine, bytes outside the alphabet), with M drawn from
# the launch rules' edges -- rows a thread (1-32, 32 * rows), warps a lane
# (past 1,024 rows), the strip path past 2,048 rows (G strips a replay
# group) -- and B from lanes-a-block edges. PGS_TORCH_FUZZ_GPU_TRIALS sets
# the count, PGS_TORCH_FUZZ_SEED offsets the trials' seeds.
GPU_FUZZ_TRIALS = int(os.environ.get("PGS_TORCH_FUZZ_GPU_TRIALS", 24))
GPU_FUZZ_M = (1, 2, 32, 33, 64, 65, 128, 129, 256, 257, 512, 513, 1024, 1025, 2048, 2049,
              2304, 2600, 4100)
GPU_FUZZ_B = (1, 2, 3, 5, 16, 17, 67, 133)


@pytest.mark.parametrize("trial", range(GPU_FUZZ_TRIALS))
def test_fuzz_cuda_matches_plain(cuda, trial):
    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    seed = trial + int(os.environ.get("PGS_TORCH_FUZZ_SEED", 0))
    rng = np.random.default_rng(1000 + seed)
    affine = bool(rng.integers(2))
    gaps = dict(gap_penalty=float(rng.integers(1, 8)),
                gap_open=float(rng.integers(2, 12)) if affine else 0.0)
    if rng.integers(2):
        cfg = ScoringConfig(match=float(rng.integers(1, 6)), mismatch=-float(rng.integers(1, 6)),
                            **gaps)
        alpha = "ACGT"
    else:
        A = int(rng.integers(4, 24))
        alpha = "ARNDCQEGHILKMFPSTWYVBZX*"[:A]
        mat = rng.integers(-6, 13, size=(A, A))
        mat = (mat + mat.T) // 2
        np.fill_diagonal(mat, rng.integers(1, 13, size=A))
        cfg = ScoringConfig(matrix=mat.astype(np.float64), alphabet=alpha, **gaps)
    letters = list(alpha + "#j")  # two bytes outside every alphabet
    M = int(rng.choice(GPU_FUZZ_M))
    B = int(rng.choice(GPU_FUZZ_B)) if M <= 2048 else int(rng.integers(1, 4))
    reads, refs = [], []
    for b in range(B):
        m = M if b == 0 else int(rng.integers(1, M + 1))
        n = int(rng.integers(1, 700))
        y = "".join(rng.choice(letters, n))
        x = "".join(rng.choice(letters, m))
        if rng.integers(2):  # plant a mutated stretch of the reference
            s = int(rng.integers(0, n))
            seg = list(y[s : s + m])
            for p in rng.integers(0, max(1, len(seg)), int(rng.integers(0, 4))):
                if seg:
                    seg[p] = rng.choice(letters)
            x = ("".join(seg) + x)[:m]
        reads.append(x)
        refs.append(y)
    got = BatchSWAligner(cfg, device=cuda).align_batch(reads, refs)
    want = BatchSWAligner(cfg, device=cuda, engine="plain").align_batch(reads, refs)
    fields = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")
    for k, (g, w) in enumerate(zip(got, want)):
        assert [getattr(g, f) for f in fields] == [getattr(w, f) for f in fields], \
            (trial, k, M, B, cfg.is_uniform, affine)


# K26 (csrc/wavefront.cu's reference-parity forms, built by
# csrc/wavefront_parity.cu) and K27 (csrc/strips.cu): saturating values with
# the operands ScanEngine clips, at the reference's defaults and at a
# plateau-heavy 100/-50/7 (most lanes reach 255 on many cells), and exact
# values, each under both ties.
def parity_scoring(sat, match, mismatch, gap):
    if sat:
        match, mismatch, gap = scan_dp.sat_operands(match, mismatch, gap)
    return dict(sat=sat, match=match, mismatch=mismatch, gap=gap)


PARITY_SCORING = {
    "sat": parity_scoring(True, 3, -3, 2),
    "sat_plateau": parity_scoring(True, 100, -50, 7),
    "exact": parity_scoring(False, 3, -3, 2),
    "sat_edges": parity_scoring(True, 255, -255, 0),
}


def form_counts(fn, before):
    """The launches of ``fn`` by form and key rule since ``before``."""
    return dict(fn.forms - before)
# Every rows-a-thread choice (M of 1 to 2,048, two warps a lane past 1,024),
# B of 1 and past a lanes-a-block multiple, mixed n_b, m_b or n_b of 0 and
# 1, and repeated motifs (ties across threads and warps).
PARITY_CASES = ("rows_1", "rows_32", "rows_33", "rows_128", "main_shape", "rows_129", "rows_512",
                "rows_513", "rows_2048", "b1", "mixed_n", "edges", "motif_ties")


@pytest.mark.parametrize("case", PARITY_CASES)
@pytest.mark.parametrize("scoring", list(PARITY_SCORING))
@pytest.mark.parametrize("tie", ["colmajor", "skewed"])
def test_k26_matches_plain(cuda, case, scoring, tie):
    """K26 score-only, argmax and moves against its plain version, and the
    K3 walk on its moves."""
    xs, ys, m, n, lanes = wave_lanes(case, cuda)
    kw = dict(tie=tie, **PARITY_SCORING[scoring])
    before = wavefront_cuda.sw_score_parity.launches
    forms = collections.Counter(wavefront_cuda.sw_score_parity.forms)
    for track_pos in (False, True):
        got = wavefront_cuda.sw_score_parity(xs, ys, m, n, track_pos=track_pos, **kw)
        want = scan_dp.sw_score_parity_plain(xs, ys, m, n, track_pos=track_pos, **kw)
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w), (track_pos, g, w)
    got = wavefront_cuda.sw_score_parity(xs, ys, m, n, emit_moves=True, lanes=lanes, **kw)
    want = scan_dp.sw_score_parity_plain(xs, ys, m, n, emit_moves=True, **kw)
    torch.cuda.synchronize()
    assert wavefront_cuda.sw_score_parity.launches == before + 3
    took = form_counts(wavefront_cuda.sw_score_parity, forms)
    assert sum(took.get(f, 0) for f in ("pair", "int32")) == 3
    if scoring == "exact":
        assert took.get("int32") == 3
    else:  # the pair form where the rule takes it for the launch's mode
        modes = ("score_only", "track_pos", "moves")
        assert took.get("pair", 0) == sum(wavefront_cuda.parity_form(
            mode=mo, **PARITY_SCORING[scoring]) == "pair" for mo in modes) == 1
    if tie == "skewed":
        assert took.get("wrap_row") == 2
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert valid_moves(got[3], want[3], m, n)
    x_mb = xs.T.contiguous()
    walked = traceback.walk_moves(got[3], x_mb, ys, got[1], got[2], max_steps=300)
    plain = traceback._walk_moves_plain(want[3], x_mb, ys, want[1], want[2], 300)
    for g, w in zip(walked, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["seed0", "rows_33", "rows_128", "edges", "motif_ties"])
def test_k26_two_warps_a_lane_match_plain(cuda, case):
    """K26 with two warps a lane where the rule takes one (the lane's warps
    reduce their (score, key, i, j) through shared memory)."""
    xs, ys, m, n, lanes = wave_lanes(case, cuda)
    for tie in ("colmajor", "skewed"):
        kw = dict(tie=tie, **PARITY_SCORING["sat_plateau"])
        got = wavefront_cuda.sw_score_parity(xs, ys, m, n, emit_moves=True,
                                             lanes=max(1, lanes // 2), warps=2, **kw)
        want = scan_dp.sw_score_parity_plain(xs, ys, m, n, emit_moves=True, **kw)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
        assert valid_moves(got[3], want[3], m, n)
        got = wavefront_cuda.sw_score_parity(xs, ys, m, n, warps=2, **kw)
        for g, w in zip(got, want[:3]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_k26_table_skewed_matches_plain(cuda, seed):
    """K26's table form (exact values, the skewed tie): argmax and moves."""
    xs, ys, m, n, table = protein_lanes(seed, cuda)
    kw = dict(table=table, gap=12, sat=False, tie="skewed")
    got = wavefront_cuda.sw_score_parity(xs, ys, m, n, **kw)
    want = scan_dp.sw_score_parity_plain(xs, ys, m, n, emit_moves=True, **kw)
    for g, w in zip(got, want[:3]):
        assert torch.equal(g, w)
    got = wavefront_cuda.sw_score_parity(xs, ys, m, n, emit_moves=True, **kw)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert valid_moves(got[3], want[3], m, n)


@pytest.mark.parametrize("shape", [(5, 2049, 300), (3, 2304, 200), (3, 2305, 180),
                                   (2, 10_300, 64)], ids=["2049", "strip_edge", "2305", "passes"])
@pytest.mark.parametrize("scoring", ["sat", "sat_plateau", "exact"])
def test_k27_matches_plain(cuda, shape, scoring):
    """K27 (K11's sweep, saturating and/or skewed) against its plain version
    past 2,048 rows: at a strip edge and beyond one pass of 10,240 rows."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    B, M, N = shape
    xs, ys, m, n = ragged(40 + M, cuda, B=B, M=M, N=N)
    m[0] = M
    for tie in ("colmajor", "skewed"):
        kw = dict(tie=tie, **PARITY_SCORING[scoring])
        before = strips_cuda.sw_score_strips_parity.launches
        got = strips_cuda.sw_score_strips_parity(xs, ys, m, n, **kw)
        want = scan_dp.sw_score_parity_plain(xs, ys, m, n, **kw)
        assert strips_cuda.sw_score_strips_parity.launches == before + 1
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w), (tie, g, w)


def k26_score_only(xs, ys, m, n, *, pair, sat, match, mismatch, gap):
    """K26's score-only sweep in the form asked for, through the wrappers'
    shared launch (the rule's form is ``parity_form``'s)."""
    return wavefront_cuda._launch(xs, ys, m, n, match=match, mismatch=mismatch, gap_open=0,
                                  gap=gap, track_pos=False, moves=None,
                                  parity=(sat, 0, pair))


def k27_sweep(xs, ys, m, n, *, pair, tie, sat, match, mismatch, gap):
    """K27 in the form asked for, through its wrapper's launch (the rule's
    form is ``strips_cuda.sweep_form``'s)."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    return strips_cuda._sweep(xs, ys, m, n, match=match, mismatch=mismatch, gap=gap,
                              ckpt=False, sat=sat, pair=pair,
                              skewed=wavefront_cuda.tie_code(tie, xs.shape[1], ys.shape[1]))


@pytest.mark.parametrize("case", PARITY_CASES)
@pytest.mark.parametrize("scoring", ["sat", "sat_plateau", "sat_edges"])
@pytest.mark.parametrize("pair", [True, False])
def test_k26_forms_match_plain(cuda, case, scoring, pair):
    """K26's score-only sweep under saturation in each form, asked for by
    name: the pair form (two lanes a word in 16-bit halves; an odd B leaves
    an empty half, ragged pairs step to the longer lane) and the int32
    form, against the plain version; the wrapper's launch takes the pair
    form, its argmax and moves the int32 form, and the pair form refuses
    the argmax."""
    xs, ys, m, n, _ = wave_lanes(case, cuda)
    kw = PARITY_SCORING[scoring]
    want = scan_dp.sw_score_parity_plain(xs, ys, m, n, track_pos=False, **kw)
    got = k26_score_only(xs, ys, m, n, pair=pair, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)
    fn = wavefront_cuda.sw_score_parity
    forms = collections.Counter(fn.forms)
    got = fn(xs, ys, m, n, track_pos=False, **kw)
    got_pos = fn(xs, ys, m, n, tie="skewed", **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got_pos[0], want[0])
    assert form_counts(fn, forms) == {"pair": 1, "int32": 1, "wrap_row": 1}
    with pytest.raises(RuntimeError, match="pgs_sw_score_parity"):
        wavefront_cuda._launch(xs, ys, m, n, match=kw["match"], mismatch=kw["mismatch"],
                               gap_open=0, gap=kw["gap"], track_pos=True, moves=None,
                               parity=(True, 0, True))


# K26's moves curve (chip_smoke.py phase 12): warps a lane, lanes a block.
K26_CURVE = [(w, l) for w in (1, 2) for l in (1, 2, 4, 8)]


@pytest.mark.parametrize("warps,lanes", K26_CURVE)
def test_k26_moves_curve_matches_plain(cuda, warps, lanes):
    """Every shape of K26's moves curve on 67 ragged lanes (an odd B) of M =
    128 against 700 columns, plateau-heavy, under the skewed tie."""
    xs, ys, m, n = ragged(91, cuda, B=67, M=128, N=700)
    kw = dict(tie="skewed", **PARITY_SCORING["sat_plateau"])
    forms = collections.Counter(wavefront_cuda.sw_score_parity.forms)
    got = wavefront_cuda.sw_score_parity(xs, ys, m, n, emit_moves=True, warps=warps,
                                         lanes=lanes, **kw)
    want = scan_dp.sw_score_parity_plain(xs, ys, m, n, emit_moves=True, **kw)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert valid_moves(got[3], want[3], m, n)
    assert form_counts(wavefront_cuda.sw_score_parity, forms) == {"int32": 1, "wrap_row": 1}


@pytest.mark.parametrize("case", ["rows_33", "rows_128", "rows_513", "edges", "motif_ties"])
def test_k26_every_cell_key_matches_plain(cuda, case):
    """The key of every row of a column's maximum (the launch's rule past
    the 2^31 key bound, tie code 2) at shapes below the bound, where it must
    agree with the plain version as the wrap row does: argmax and moves."""
    xs, ys, m, n, _ = wave_lanes(case, cuda)
    kw = dict(tie="skewed", **PARITY_SCORING["sat_plateau"])
    want = scan_dp.sw_score_parity_plain(xs, ys, m, n, emit_moves=True, **kw)
    for moves in (None, torch.empty((xs.shape[1] + ys.shape[1] - 1, xs.shape[1], xs.shape[0]),
                                    dtype=torch.uint8, device=cuda)):
        got = wavefront_cuda._launch(xs, ys, m, n, match=kw["match"], mismatch=kw["mismatch"],
                                     gap_open=0, gap=kw["gap"], track_pos=True, moves=moves,
                                     parity=(True, 2, False))
        for g, w in zip(got, want[:3]):
            assert torch.equal(g, w)
        if moves is not None:
            assert valid_moves(moves, want[3], m, n)


@pytest.mark.parametrize("mn", [(100, 100), (128, 60), (60, 128)], ids=["m_eq_n", "m_gt_n",
                                                                       "n_gt_m"])
def test_parity_wrap_row_plateau_matches_plain(cuda, mn):
    """Identical bytes under match 255, mismatch -255, gap 0: every cell of
    a lane is 255, every cell on the wrap row i + j = max(m, n) among them;
    beside it ragged lanes (5 lanes, an odd B). K26 (argmax and moves under
    the skewed tie, the score-only pair form) and K27 (M = 2,304: the
    skewed tie, the column-major pair form) against the plain versions."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    mm, nn = mn
    for M, N, fn in ((128, 128, "k26"), (2304, 160, "k27")):
        xs, ys, m, n = ragged(mm + nn, cuda, B=5, M=M, N=N)
        m[0], n[0] = mm, nn
        xs[0, :mm], ys[0, :nn] = ord("A"), ord("A")
        for tie in ("skewed", "colmajor"):
            kw = dict(tie=tie, **PARITY_SCORING["sat_edges"])
            if fn == "k26":
                want = scan_dp.sw_score_parity_plain(xs, ys, m, n, emit_moves=True, **kw)
                got = wavefront_cuda.sw_score_parity(xs, ys, m, n, **kw)
                moves = wavefront_cuda.sw_score_parity(xs, ys, m, n, emit_moves=True, **kw)[3]
                assert valid_moves(moves, want[3], m, n)
                score = wavefront_cuda.sw_score_parity(xs, ys, m, n, track_pos=False, **kw)[0]
                assert torch.equal(score, want[0])
            else:
                want = scan_dp.sw_score_parity_plain(xs, ys, m, n, **kw)
                got = strips_cuda.sw_score_strips_parity(xs, ys, m, n, **kw)
            assert int(want[0][0]) == 255
            for g, w in zip(got[:3], want[:3]):
                assert torch.equal(g, w), (fn, tie)


@pytest.mark.parametrize("shape", [(5, 2049, 300), (3, 2304, 200), (4, 4096, 160),
                                   (3, 10_300, 64)], ids=["2049", "strip_edge", "4096",
                                                          "passes"])
@pytest.mark.parametrize("scoring", ["sat", "sat_plateau", "sat_edges"])
def test_k27_forms_match_plain(cuda, shape, scoring):
    """K27's pair form (a block a lane pair; an odd B's last block an empty
    half; passes past 10,240 rows carry a packed bound row) and its int32
    form under the column-major tie, and the int32 form under the skewed
    tie, against the plain version; the forms the wrapper's launches take,
    counted; the pair form refuses the skewed tie."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    B, M, N = shape
    xs, ys, m, n = ragged(60 + M, cuda, B=B, M=M, N=N)
    m[0] = M
    fn = strips_cuda.sw_score_strips_parity
    for tie in ("colmajor", "skewed"):
        kw = dict(tie=tie, **PARITY_SCORING[scoring])
        want = scan_dp.sw_score_parity_plain(xs, ys, m, n, **kw)
        forms = collections.Counter(fn.forms)
        got = fn(xs, ys, m, n, **kw)
        assert form_counts(fn, forms) == (
            {"pair": 1} if tie == "colmajor" else {"int32": 1, "wrap_row": 1})
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w), (tie, g, w)
        for pair in ((True, False) if tie == "colmajor" else (False,)):
            got = k27_sweep(xs, ys, m, n, pair=pair, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (tie, pair, g, w)
    with pytest.raises(RuntimeError, match="pgs_strip_sweep"):
        k27_sweep(xs, ys, m, n, pair=True, **dict(kw, tie="skewed"))


def test_k27_band_heights(cuda):
    """Both band heights among test_k27_forms_match_plain's shapes, in each
    form."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    for pair in (True, False):
        rows = {strips_cuda.sweep_occupancy(M, parity=True, pair=pair)[3]
                for M in (2049, 2304, 4096, 10_300)}
        assert rows == {16, 32}, (pair, rows)


def test_k27_key_limit_takes_every_cell(cuda):
    """At M = 46,400 rows keys pass 2^31 (46,400 x 46,433 > 2^31):
    ``key_rule`` takes every cell's key, which K27 follows on a saturated
    plateau of wrapped keys, against the plain version's int32 keys; three
    lanes, one of them the full 46,400 x 64 plateau."""
    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    B, M, N = 3, 46_400, 64
    xs, ys, m, n = ragged(7, cuda, B=B, M=M, N=N)
    m[0], n[0] = M, N
    xs[0], ys[0] = ord("A"), ord("A")
    assert wavefront_cuda.key_rule(M, N) == "every_cell"
    kw = dict(tie="skewed", **PARITY_SCORING["sat"])
    want = scan_dp.sw_score_parity_plain(xs, ys, m, n, **kw)
    fn = strips_cuda.sw_score_strips_parity
    forms = collections.Counter(fn.forms)
    got = fn(xs, ys, m, n, **kw)
    assert form_counts(fn, forms) == {"int32": 1, "every_cell": 1}
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)


def test_solve_small_parity_cuda_matches_cpu(cuda, tmp_path):
    """solve_small --parity-mode skewed (K26, K3) and --semantics sat_uint8
    (K26 score-only, K26 moves, K3): the card's CSV equals the CPU's."""
    ref_path, csv_path = write_dataset(tmp_path, ref_len=2000, n_reads=96, seed=9)
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "32"]
    for extra in (["--parity-mode", "skewed"], ["--parity-mode", "skewed", "--both-strands"],
                  ["--semantics", "sat_uint8", "--npiece", "17"]):
        before = wavefront_cuda.sw_score_parity.launches
        assert solve_small.main(base + extra + ["--output", str(tmp_path / "gpu.csv")]) == 0
        assert wavefront_cuda.sw_score_parity.launches > before
        assert solve_small.main(
            base + extra + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
        assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()


# The reference-parity forms' randomized campaign beside
# test_fuzz_cuda_matches_plain: saturating operands inside and outside [0,
# 255] or exact values, either tie, M from the launch rules' edges (reads
# past 2,048 rows score only: their moves are not ported).
PARITY_FUZZ_TRIALS = int(os.environ.get("PGS_TORCH_FUZZ_GPU_TRIALS", 12))


@pytest.mark.parametrize("trial", range(PARITY_FUZZ_TRIALS))
def test_parity_fuzz_cuda_matches_plain(cuda, trial):
    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig, Semantics

    seed = trial + int(os.environ.get("PGS_TORCH_FUZZ_SEED", 0))
    rng = np.random.default_rng(2000 + seed)
    sat = bool(rng.integers(3))
    tie = "skewed" if rng.integers(3) else "colmajor"
    if sat:
        cfg = ScoringConfig(match=float(rng.integers(1, 300)), mismatch=float(rng.integers(-300, 5)),
                            gap_penalty=float(rng.integers(0, 20)),
                            semantics=Semantics.SAT_UINT8)
    else:
        tie = "skewed"
        cfg = ScoringConfig(match=float(rng.integers(1, 6)), mismatch=-float(rng.integers(1, 6)),
                            gap_penalty=float(rng.integers(1, 8)))
    letters = list("ACGT#j")
    M = int(rng.choice(GPU_FUZZ_M))
    B = int(rng.choice(GPU_FUZZ_B)) if M <= 2048 else int(rng.integers(1, 4))
    reads, refs = [], []
    for b in range(B):
        m = M if b == 0 else int(rng.integers(1, M + 1))
        n = int(rng.integers(1, 700))
        y = "".join(rng.choice(letters, n))
        x = "".join(rng.choice(letters, m))
        if rng.integers(2):  # plant a stretch of the reference
            s = int(rng.integers(0, n))
            x = (y[s : s + m] + x)[:m]
        reads.append(x)
        refs.append(y)
    tb = M <= 2048
    got = BatchSWAligner(cfg, tie=tie, device=cuda).align_batch(reads, refs, traceback=tb)
    want = BatchSWAligner(cfg, tie=tie, device=cuda, engine="plain").align_batch(
        reads, refs, traceback=tb)
    fields = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")
    for k, (g, w) in enumerate(zip(got, want)):
        assert [getattr(g, f) for f in fields] == [getattr(w, f) for f in fields], \
            (trial, k, M, B, sat, tie)
