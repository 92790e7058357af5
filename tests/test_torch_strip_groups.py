"""The group replay of the strip traceback on the CPU: the plain group
replay (``scan_dp.strip_*moves_group_plain``, the plain version of the
kernels' G-strip launch) against the per-strip plain replays on every cell
the walk can read, and the plain engine with its strips replayed two at a
time against the JAX package's ``score_batch_strip_moves`` (its Pallas strip
kernels in interpret mode). Inputs come from numpy seeds at small sizes.
"""

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.ops import wavefront_pallas as wp
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxScoringConfig
from parallel_genomeseq_tpu_torch.ops import engine, scan_dp, strips_cuda
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

S = scan_dp.STRIP_S
DNA = np.frombuffer(b"ACGT", np.uint8)
FORMS = {
    "linear": ScoringConfig(),
    "affine": ScoringConfig(match=1.0, mismatch=-4.0, gap_open=6.0, gap_penalty=1.0),
    "blosum50": blosum_config("blosum50", gap_penalty=2.0),
    "blosum50_affine": blosum_config("blosum50", gap_penalty=2.0, gap_open=10.0),
}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def lanes(B=4, M=3 * S + 24, N=120, seed=0):
    """Ragged DNA lanes, each with a stretch of its reference planted (lane
    0 with a 9-base insertion across row 512), 4 strips, the top one of 24
    rows."""
    rng = np.random.default_rng(seed)
    m = np.array([M, M - 100, 2 * S + 7, M - 30], np.int32)[:B]
    n = np.array([N, N - 40, N - 7, N // 2], np.int32)[:B]
    xs = rng.choice(DNA, (B, M)).astype(np.uint8)
    ys = np.full((B, N), 2, np.uint8)
    for b in range(B):
        ys[b, : n[b]] = rng.choice(DNA, n[b])
        k = int(n[b]) - 10
        seg = ys[b, :k]
        if b == 0:  # the insertion at row 512: an F run across a strip edge
            seg = np.concatenate([seg[:40], rng.choice(DNA, 9), seg[40:]])
        at = 472 if b == 0 else 150 + 170 * b
        seg = seg[: m[b] - at]
        xs[b, at : at + len(seg)] = seg
    return t(xs), t(ys), t(m), t(n)


def form_inputs(form):
    """(config, xs, ys, m, n, kernel keyword arguments) of a form, compact
    codes under a matrix (A, C, G and T are BLOSUM50 letters)."""
    cfg = FORMS[form]
    xs, ys, m, n = lanes()
    kw = {"gap": int(cfg.gap_penalty)}
    if cfg.is_affine:
        kw["gap_open"] = int(cfg.gap_open)
    if cfg.is_uniform:
        kw.update(match=int(cfg.match), mismatch=int(cfg.mismatch))
    else:
        lut, table = (t(a) for a in scan_dp.profile_tables(cfg))
        xs, ys = lut[xs.long()], lut[ys.long()]
        kw["table"] = table
    return cfg, xs, ys, m, n, kw


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_group_replay_matches_per_strip(form, G):
    """The plain group replay of strips [first, first + G) equals the
    per-strip plain replays on every cell the walk can read -- reached lanes
    (active, i - 1 at or below the strip's first row), columns up to
    min(n, j), rows up to m -- and writes no column outside those bounds: an
    inactive lane, a lane whose j is far below its n, one whose i lies above
    the group's top strip. Without a walk state every column up to n."""
    cfg, xs, ys, m, n, kw = form_inputs(form)
    key = engine.strip_key(cfg)
    _, ckpt, group, _ = engine.STRIP_PLAIN[key]
    per_strip = getattr(scan_dp, group.__name__.replace("_group", ""))
    _, _, _, *ck = ckpt(xs, ys, m, n, **kw)
    B, N = ys.shape
    first = 4 - G  # the group ends at the 24-row top strip
    i = m.clone()
    i[3] = first * S + 10  # inside the group's first strip only
    j = n.clone()
    j[2] = 4
    active = torch.tensor([True, False, True, True])
    want = [per_strip(xs, ys, m, n, *[c[:, s - 1] if s else None for c in ck], s * S, **kw)
            for s in range(first, first + G)]
    for walk in ((i, j, active), None):
        got = torch.full((G, B, N, S), 0xA5, dtype=torch.uint8)
        assert group(xs, ys, m, n, *ck, first, got, walk, **kw) is got
        if walk is not None:  # the CPU route of the kernels' group wrapper is this plain version
            again = torch.full_like(got, 0xA5)
            wrapper = getattr(strips_cuda, group.__name__.removesuffix("_plain"))
            assert torch.equal(wrapper(xs, ys, m, n, *ck, first, again, walk, **kw), got)
        for g in range(G):
            s = first + g
            if walk is None:
                reach, bound = torch.ones(B, dtype=torch.bool), n
            else:
                reach, bound = active & (i - 1 >= s * S), torch.minimum(n, j)
            cols = reach[:, None] & (torch.arange(N)[None, :] < bound[:, None])
            valid = cols[:, :, None] & ((s * S + torch.arange(S)) < m[:, None])[:, None, :]
            assert torch.equal(got[g][valid], want[g][valid])
            assert bool((got[g][~cols] == 0xA5).all())
            if walk is not None:
                assert not bool(cols[1].any()) and int(cols[2].sum()) == (4 if reach[2] else 0)
                assert bool(reach[3]) == (g == 0)


def jax_config(cfg):
    return JaxScoringConfig(match=cfg.match, mismatch=cfg.mismatch, gap_open=cfg.gap_open,
                            gap_penalty=cfg.gap_penalty)


@pytest.mark.parametrize("form", ["linear", "affine"])
def test_plain_engine_in_groups_matches_jax(form, monkeypatch):
    """The plain engine's strip traceback with its strips replayed two at a
    time (``strips_cuda.replay_group`` forced to 2) equals the JAX package's
    ``score_batch_strip_moves`` (B13/B17 in interpret mode), or under affine
    gaps its ``score_batch_strip_affine_moves`` (B14/B18), in score, i, j,
    pos, steps and both consensus buffers."""
    monkeypatch.setattr(strips_cuda, "replay_group", lambda reach, *a, **k: 2)
    cfg = FORMS[form]
    rng = np.random.default_rng(5)
    B, M, N = 3, wp.MAX_M + 52, 300
    ref = rng.choice(DNA, N)
    xs = rng.choice(DNA, (B, M)).astype(np.uint8)
    xs[0, 700 : 700 + N] = ref
    read = np.concatenate([ref[:150], rng.choice(DNA, 7), ref[150:]])  # an insertion
    xs[1, 1400 : 1400 + len(read)] = read
    ys = np.broadcast_to(ref, (B, N)).copy()
    m, n = np.full(B, M, np.int32), np.full(B, N, np.int32)
    got = engine.PlainEngine(cfg, device="cpu").score_batch_strip_moves(xs, ys, m, n, 900)
    jax_engine = wp.PallasEngine(jax_config(cfg))
    strip_moves = (jax_engine.score_batch_strip_affine_moves if cfg.is_affine
                   else jax_engine.score_batch_strip_moves)
    want = strip_moves(xs, ys, m, n, max_steps=900)
    assert got["groups"][0] == 2 and max(got["groups"]) == 2
    assert len(got["level_us"]) == -(-M // S)
    for k in ("score", "i", "j", "pos", "steps"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k])[:B], err_msg=k)
    for k in ("cx", "cy"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k])[:, :B], err_msg=k)
    assert int(got["score"][:2].min()) > 250  # lane 2 is unrelated to the reference
