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
