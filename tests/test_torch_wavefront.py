"""The port's K1/K2 wrappers (plain PyTorch route, CPU tensors) against the
JAX package's Pallas kernels B1/B2 in interpret mode, on the same ragged
batches. Exact equality: every value is an integer or a byte."""

import numpy as np
import pytest
import torch

from conftest import random_dna
from parallel_genomeseq_tpu.ops.wavefront_pallas import PallasEngine
from parallel_genomeseq_tpu.utils.encoding import X_PAD, Y_PAD, batch_pad, to_bytes
from parallel_genomeseq_tpu_torch.ops import wavefront_cuda

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

KW = dict(match=3, mismatch=-3, gap=2)


def ragged_batch(seed: int):
    """Reads sampled (with substitutions) from a random reference, against
    random windows of it, plus the lanes the tie-break and bounds depend on:
    an all-zero lane, a lane with two equal maxima, and a read longer than
    its window."""
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, 400)
    pairs = []
    for _ in range(9):
        s = int(rng.integers(0, 300))
        read = list(ref[s : s + int(rng.integers(20, 70))])
        for _ in range(3):
            read[int(rng.integers(0, len(read)))] = rng.choice(list("ACGT"))
        lo = max(0, s - int(rng.integers(0, 60)))
        pairs.append(("".join(read), ref[lo : lo + int(rng.integers(40, 180))]))
    pairs += [
        ("AAAAAAAA", "CCCCCCCCCCCC"),  # no match anywhere: (0, 0, 0)
        ("ACGT", "ACGTTTTTACGTGG"),  # equal maxima at j = 4 and j = 12
        (random_dna(rng, 64), random_dna(rng, 30)),  # read longer than window
    ]
    m = np.array([len(x) for x, _ in pairs], np.int32)
    n = np.array([len(y) for _, y in pairs], np.int32)
    xs = batch_pad([to_bytes(x) for x, _ in pairs], int(m.max()) + 3, X_PAD)
    ys = batch_pad([to_bytes(y) for _, y in pairs], int(n.max()) + 5, Y_PAD)
    return xs, ys, m, n


def as_tensors(xs, ys, m, n):
    return tuple(torch.from_numpy(a) for a in (xs, ys, m, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("track_pos", [False, True])
def test_sw_score_matches_pallas_b1(seed, track_pos):
    xs, ys, m, n = ragged_batch(seed)
    want = PallasEngine(interpret=True).score_batch(xs, ys, m, n, need_pos=track_pos)
    got = wavefront_cuda.sw_score(*as_tensors(xs, ys, m, n), track_pos=track_pos, **KW)
    for k, g in zip(("score", "i", "j"), got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[k]), err_msg=k)
    assert int(got[0][-3]) == 0 and int(got[1][-3]) == 0  # all-zero lane
    if track_pos:
        assert (int(got[1][-2]), int(got[2][-2])) == (4, 4)  # first of the tied maxima


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sw_score_moves_matches_pallas_b2(seed):
    xs, ys, m, n = ragged_batch(seed)
    want = PallasEngine(interpret=True).score_batch_moves(xs, ys, m, n)
    score, i, j, moves = wavefront_cuda.sw_score_moves(*as_tensors(xs, ys, m, n), **KW)
    B, M = xs.shape
    for k, g in (("score", score), ("i", i), ("j", j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[k])[:B], err_msg=k)
    D = M + ys.shape[1] - 1
    assert moves.shape == (D, M, B) and moves.dtype == torch.uint8
    # Every cell inside each lane's matrix: 1 <= i <= m_b, 1 <= j <= n_b.
    d = np.arange(D)[:, None, None]
    r = np.arange(M)[None, :, None]
    valid = (r < m[None, None, :]) & (d >= r) & (d - r < n[None, None, :])
    jax_moves = np.asarray(want["moves"])[:D, :M, :B]
    np.testing.assert_array_equal(moves.numpy()[valid], jax_moves[valid])
    assert valid.sum() == int((m.astype(np.int64) * n).sum())


@pytest.mark.parametrize("kernel", ["score_only", "track_pos", "moves"])
def test_lengths_beyond_the_padded_shape_are_clamped(kernel):
    """A lane whose m_b or n_b exceeds the padded M or N is scored as if its
    length were M or N: equal to the JAX kernel on the clamped lengths."""
    xs, ys, m, n = ragged_batch(3)
    B, M = xs.shape
    N = ys.shape[1]
    m_over, n_over = m.copy(), n.copy()
    m_over[:3] = M + np.array([1, 7, 100])
    n_over[1:4] = N + np.array([1, 5, 300])
    m_cl, n_cl = np.minimum(m_over, M), np.minimum(n_over, N)
    eng = PallasEngine(interpret=True)
    if kernel == "moves":
        want = eng.score_batch_moves(xs, ys, m_cl, n_cl)
        got = wavefront_cuda.sw_score_moves(*as_tensors(xs, ys, m_over, n_over), **KW)
        d = np.arange(M + N - 1)[:, None, None]
        r = np.arange(M)[None, :, None]
        valid = (r < m_cl[None, None, :]) & (d >= r) & (d - r < n_cl[None, None, :])
        jax_moves = np.asarray(want["moves"])[: M + N - 1, :M, :B]
        np.testing.assert_array_equal(got[3].numpy()[valid], jax_moves[valid])
    else:
        track_pos = kernel == "track_pos"
        want = eng.score_batch(xs, ys, m_cl, n_cl, need_pos=track_pos)
        got = wavefront_cuda.sw_score(*as_tensors(xs, ys, m_over, n_over),
                                      track_pos=track_pos, **KW)
    for k, g in zip(("score", "i", "j"), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[k])[:B], err_msg=k)
