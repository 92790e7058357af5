"""The port's plain ``walk_moves`` (CPU tensors) against the JAX package's
``walk_moves`` on the same move codes: pos, consensus buffers and steps must
be identical, including truncation at max_steps and skipped lanes."""

import numpy as np
import pytest
import torch

from conftest import random_dna
from parallel_genomeseq_tpu.ops import traceback as jax_tb
from parallel_genomeseq_tpu.ops.scan_dp import ScanEngine
from parallel_genomeseq_tpu.utils.encoding import X_PAD, Y_PAD, batch_pad, to_bytes
from parallel_genomeseq_tpu_torch.ops import traceback as port_tb

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def moves_batch(seed: int):
    """Move codes from the JAX scan engine over mutated reads (gaps
    included), plus an all-zero lane."""
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, 300)
    reads, refs = [], []
    for _ in range(7):
        s = int(rng.integers(0, 200))
        read = list(ref[s : s + int(rng.integers(30, 80))])
        for _ in range(3):
            read[int(rng.integers(0, len(read)))] = rng.choice(list("ACGT"))
        del read[int(rng.integers(5, 25)) : int(rng.integers(25, 28))]
        reads.append("".join(read))
        refs.append(ref[max(0, s - 20) : s + 120])
    reads.append("AAAAAA")
    refs.append("CCCCCCCCCC")
    m = np.array([len(x) for x in reads], np.int32)
    n = np.array([len(y) for y in refs], np.int32)
    xs = batch_pad([to_bytes(x) for x in reads], int(m.max()), X_PAD)
    ys = batch_pad([to_bytes(y) for y in refs], int(n.max()), Y_PAD)
    res = ScanEngine().score_batch(xs, ys, m, n, emit_moves=True)
    return (np.asarray(res["moves"]), np.ascontiguousarray(xs.T), ys,
            np.asarray(res["i"]), np.asarray(res["j"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_steps", [7, 200])
def test_walk_moves_matches_jax(seed, max_steps):
    moves, x_mb, ys, i0, j0 = moves_batch(seed)
    want = jax_tb.walk_moves(moves, x_mb, ys, i0, j0, max_steps=max_steps)
    got = port_tb.walk_moves(
        *(torch.from_numpy(np.array(a)) for a in (moves, x_mb, ys, i0, j0)),
        max_steps=max_steps,
    )
    for name, g, w in zip(("pos", "cx", "cy", "steps"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[0][-1]) == 0 and int(got[3][-1]) == 0  # all-zero lane skipped
    assert port_tb.decode_consensus(*(t.numpy() for t in got[1:])) == \
        jax_tb.decode_consensus(*want[1:])


def clamped_starts(affine: bool):
    """Random move bytes (D, M, B) -- linear: mostly NW, 5% stop bits;
    affine: mostly NW H sources, 5% H_ZERO, random extend bits -- with walks
    started where the walk must clamp: i0 past M, j0 past N, both, i0 = 1,
    j0 = 1, i0 <= 0, and in the matrix."""
    rng = np.random.default_rng(7 + int(affine))
    B, M, N = 9, 24, 40
    D = M + N - 1
    code = rng.choice(3, (D, M, B), p=[0.7, 0.15, 0.15]).astype(np.uint8)
    if affine:
        code[rng.random((D, M, B)) < 0.05] = 3
        moves = code | (rng.integers(0, 4, (D, M, B), dtype=np.uint8) << 3)
    else:
        moves = code | ((rng.random((D, M, B)) < 0.05) * 4).astype(np.uint8)
    x_mb = rng.integers(65, 91, (M, B), dtype=np.uint8)
    ys = rng.integers(97, 123, (B, N), dtype=np.uint8)
    i0 = np.array([M + 6, M // 2, M + 3, 1, M // 2, 0, -2, M, 17], np.int32)
    j0 = np.array([N // 2, N + 8, N + 2, N // 2, 1, 9, 5, N, 30], np.int32)
    return moves, x_mb, ys, i0, j0


@pytest.mark.parametrize("max_steps", [12, 200])
@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
def test_walks_match_jax_at_clamped_starts(affine, max_steps):
    """The plain walks against the JAX walks where the indices clamp (the
    cells K3/K10 gather clamp the same way), with max_steps shorter than
    some walks (12) and longer (200); a linear walk that reaches i, j <= 0
    reads the clamped corner cell until max_steps, as the JAX walk does."""
    arrays = clamped_starts(affine)
    jax_walk = jax_tb.walk_moves_affine if affine else jax_tb.walk_moves
    port_walk = port_tb.walk_moves_affine if affine else port_tb.walk_moves
    want = jax_walk(*arrays, max_steps=max_steps)
    got = port_walk(*(torch.from_numpy(a) for a in arrays), max_steps=max_steps)
    for name, g, w in zip(("pos", "cx", "cy", "steps"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    steps = got[3].numpy()
    assert steps[5] == 0 and steps[6] == 0  # i0 <= 0: inactive
    assert ((steps > 0) & (steps < max_steps)).any()
    assert (steps == max_steps).any() or max_steps == 200
