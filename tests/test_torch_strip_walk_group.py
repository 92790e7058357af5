"""The strip walk over a replay group against the JAX package, on the CPU.

``traceback.walk_strip_group`` and ``walk_strip_group_affine`` (K14 and K18
over a group of replayed strips; on CPU tensors their plain versions) walk
three replayed strips in one call. The JAX ``walk_strip_level`` /
``walk_strip_level_affine`` walk the same move bytes strip by strip, top
first; every state tensor must match exactly, with emissions past a short
buffer dropped while steps counts on. The moves buffer starts as stale
bytes, as the engine's does, and the group replay writes only the cells the
walk can read.
"""

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.ops import traceback as jax_traceback
from parallel_genomeseq_tpu_torch.ops import scan_dp, traceback

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

DNA = np.frombuffer(b"ACGT", np.uint8)
S = scan_dp.STRIP_S
B, N, NSTRIPS = 4, 64, 3
GAPS = {False: dict(match=3, mismatch=-3, gap=2),
        True: dict(match=1, mismatch=-4, gap_open=6, gap=1)}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def group_lanes():
    """Four 768-row reads against 64-bp references: lane 0 holds its
    reference across the strip edge at row 256, lane 1 with a 12-base
    insertion across row 512 (a north gap run over the edge), lane 2 in the
    top strip, lane 3 is unrelated."""
    rng = np.random.default_rng(5)
    M = NSTRIPS * S
    ys = rng.choice(DNA, (B, N)).astype(np.uint8)
    xs = rng.choice(DNA, (B, M)).astype(np.uint8)
    xs[0, 230 : 230 + N] = ys[0]
    xs[1, 474 : 474 + N + 12] = np.concatenate([ys[1, :32], rng.choice(DNA, 12), ys[1, 32:]])
    xs[2, 650 : 650 + N] = ys[2]
    return xs, ys, np.full(B, M, np.int32), np.full(B, N, np.int32)


@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
def test_group_walk_matches_jax_strip_by_strip(affine):
    xs, ys, m, n = group_lanes()
    kw = GAPS[affine]
    if affine:
        score, i, j, *ck = scan_dp.sw_score_affine_ckpt_plain(t(xs), t(ys), t(m), t(n), **kw)
        replay, walk, jax_walk = (scan_dp.strip_affine_moves_group_plain,
                                  traceback.walk_strip_group_affine,
                                  jax_traceback.walk_strip_level_affine)
    else:
        score, i, j, *ck = scan_dp.sw_score_ckpt_plain(t(xs), t(ys), t(m), t(n), **kw)
        replay, walk, jax_walk = (scan_dp.strip_moves_group_plain, traceback.walk_strip_group,
                                  jax_traceback.walk_strip_level)
    max_steps = 40
    state = traceback.new_strip_state(i, j, max_steps, affine=affine)
    moves = torch.full((NSTRIPS, B, N, S), 0xA5, dtype=torch.uint8)
    replay(t(xs), t(ys), t(m), t(n), *ck, 0, moves, (state[0], state[1], state[3]), **kw)
    order = (0, 1, 2, 7, 3, 5, 6, 4) if affine else (0, 1, 2, 3, 5, 6, 4)
    jstate = tuple(np.array(state[k]) for k in order)
    assert walk(moves, t(xs.T), t(ys), 0, state, max_steps=max_steps) is state

    r = np.arange(S)[None, :]
    d = r + np.arange(N)[:, None]
    for s in range(NSTRIPS - 1, -1, -1):
        jax_moves = np.zeros((S + N - 1, S, B), np.uint8)
        jax_moves[d, r] = moves[s].numpy().transpose(1, 2, 0)
        jstate = jax_walk(jax_moves, xs.T[s * S : (s + 1) * S].copy(), ys, s * S, jstate,
                          max_steps=S + N)
    want = dict(zip(order, (np.asarray(a) for a in jstate)))
    for k, got in enumerate(state):
        np.testing.assert_array_equal(got.numpy(), want[k])
    steps = state[4].numpy()
    assert steps[0] > max_steps and steps[1] > max_steps  # the buffer's end dropped emissions
    assert int(i[0]) > S > int(state[0][0]) and int(i[1]) > 2 * S > int(state[0][1])
    assert not (state[3] & (state[0] > 0)).any()  # every walk ended
