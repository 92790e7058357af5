"""On-card tests of the port's CUDA kernels, each against its plain PyTorch
version on the same CUDA tensors. Marked ``gpu``; they skip where there is
no card. This file imports neither jax nor the test conftest, so it also runs
on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu_torch.cli import solve_small
from parallel_genomeseq_tpu_torch.ops import scan_dp, traceback, wavefront_cuda
from parallel_genomeseq_tpu_torch.utils.synth import write_dataset

pytestmark = pytest.mark.gpu
KW = dict(match=3, mismatch=-3, gap=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def ragged(seed, dev, B=67, M=96, N=300):
    """Random DNA lanes of ragged true lengths, each read partly planted in
    its reference so that alignments carry gaps and mismatches."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    m = rng.integers(1, M + 1, B).astype(np.int32)
    n = rng.integers(1, N + 1, B).astype(np.int32)
    xs = np.full((B, M), 1, np.uint8)
    ys = np.full((B, N), 2, np.uint8)
    for b in range(B):
        ys[b, : n[b]] = rng.choice(acgt, n[b])
        xs[b, : m[b]] = rng.choice(acgt, m[b])
        k = min(m[b], n[b]) // 2
        if k:
            xs[b, :k] = ys[b, n[b] - k : n[b]]
    return [torch.from_numpy(a).to(dev) for a in (xs, ys, m, n)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("track_pos", [False, True])
def test_k1_matches_plain(cuda, seed, track_pos):
    xs, ys, m, n = ragged(seed, cuda)
    before = wavefront_cuda.sw_score.launches
    got = wavefront_cuda.sw_score(xs, ys, m, n, track_pos=track_pos, **KW)
    want = scan_dp.sw_score_plain(xs, ys, m, n, track_pos=track_pos, **KW)
    torch.cuda.synchronize()
    assert wavefront_cuda.sw_score.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_and_k3_match_plain(cuda, seed):
    xs, ys, m, n = ragged(seed, cuda)
    got = wavefront_cuda.sw_score_moves(xs, ys, m, n, **KW)
    want = scan_dp.sw_score_moves_plain(xs, ys, m, n, **KW)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    D, M, B = got[3].shape
    d = torch.arange(D, device=cuda)[:, None, None]
    r = torch.arange(M, device=cuda)[None, :, None]
    valid = (r < m) & (d >= r) & (d - r < n)
    assert torch.equal(got[3][valid], want[3][valid])
    x_mb = xs.T.contiguous()
    before = traceback.walk_moves.launches
    walked = traceback.walk_moves(got[3], x_mb, ys, got[1], got[2], max_steps=250)
    plain = traceback._walk_moves_plain(got[3], x_mb, ys, got[1], got[2], 250)
    assert traceback.walk_moves.launches == before + 1
    for g, w in zip(walked, plain):
        assert torch.equal(g, w)


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


def test_solve_small_cuda_matches_cpu(cuda, tmp_path):
    ref_path, csv_path = write_dataset(tmp_path, ref_len=2000, n_reads=96, seed=5)
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "32"]
    for extra in (["--npiece", "17"], ["--npiece", "1", "--both-strands"]):
        assert solve_small.main(base + extra + ["--output", str(tmp_path / "gpu.csv")]) == 0
        assert solve_small.main(
            base + extra + ["--device", "cpu", "--output", str(tmp_path / "cpu.csv")]) == 0
        assert (tmp_path / "gpu.csv").read_bytes() == (tmp_path / "cpu.csv").read_bytes()
