"""Global alignment in the port against the JAX package, on the CPU: the NW
last-row sweep (K25's plain version, ``ops/global_dp.py``), Hirschberg
(``models/hirschberg.py``), the numpy NW oracle, and the demo CLI. Every
value is an integer or a string, so every comparison is exact."""

import numpy as np
import pytest
import torch

from conftest import random_dna, random_protein
from parallel_genomeseq_tpu.cli import demo as jax_demo
from parallel_genomeseq_tpu.models import hirschberg as jax_hb
from parallel_genomeseq_tpu.ops import global_dp as jax_gdp
from parallel_genomeseq_tpu.ops import oracle as jax_oracle
from parallel_genomeseq_tpu.ops.substitution import blosum_config as jax_blosum
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxScoringConfig
from parallel_genomeseq_tpu_torch.cli import demo
from parallel_genomeseq_tpu_torch.models import hirschberg
from parallel_genomeseq_tpu_torch.ops import global_dp, oracle
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# (port config, JAX config, alphabet): the default uniform 3/-3/2, and
# BLOSUM62 with gap 4.
CONFIGS = {
    "uniform": (ScoringConfig(), JaxScoringConfig(), "ACGT"),
    "blosum62": (blosum_config("blosum62", gap_penalty=4.0),
                 jax_blosum("blosum62", gap_penalty=4.0), None),
}


FIELDS = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")


def mutate(rng, seq: str, alphabet: str, subs: float = 0.08, indels: int = 3) -> str:
    """``seq`` with about ``subs`` of its letters substituted and ``indels``
    1-4 letter insertions or deletions."""
    chars = list(seq)
    for p in np.flatnonzero(rng.random(len(chars)) < subs):
        chars[p] = alphabet[int(rng.integers(len(alphabet)))]
    for _ in range(indels):
        p = int(rng.integers(0, max(1, len(chars))))
        k = int(rng.integers(1, 5))
        if rng.integers(2):
            chars[p:p] = [alphabet[int(c)] for c in rng.integers(len(alphabet), size=k)]
        else:
            del chars[p : p + k]
    return "".join(chars)


def ragged_batch(kind: str, seed: int):
    """A ragged batch of (x, y) pairs: lengths 1-90, related and unrelated
    pairs, an empty x and an empty y."""
    rng = np.random.default_rng(seed)
    gen = random_dna if kind == "uniform" else random_protein
    alpha = "ACGT" if kind == "uniform" else "ARNDCQEGHILKMFPSTWYV"
    xs, ys = [], []
    for _ in range(9):
        y = gen(rng, int(rng.integers(1, 90)))
        x = mutate(rng, y, alpha) if rng.integers(2) else gen(rng, int(rng.integers(1, 90)))
        xs.append(x or alpha[0])
        ys.append(y)
    xs += ["", gen(rng, 7), gen(rng, 1)]
    ys += [gen(rng, 5), "", gen(rng, 60)]
    return xs, ys


@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_nw_lastrow_batch_matches_jax(kind, seed):
    """The plain NW last rows and corner scores of a ragged batch equal the
    JAX device scan's, and the numpy oracle's corner."""
    cfg, jcfg, _ = CONFIGS[kind]
    xs, ys = ragged_batch(kind, seed)
    got = global_dp.nw_lastrow_batch(xs, ys, cfg, device="cpu")
    want = jax_gdp.nw_lastrow_batch(xs, ys, jcfg)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.shape == (len(ys[k]) + 1,)
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g[-1] == jax_oracle.nw_matrix(xs[k], ys[k], jcfg)[-1, -1]
    np.testing.assert_array_equal(global_dp.nw_score_batch(xs, ys, cfg, device="cpu"),
                                  jax_gdp.nw_score_batch(xs, ys, jcfg))


def test_nw_lastrow_plain_masks_past_n():
    """The plain version's contract, as K25's: row m_b for j <= n_b, 0 past
    n_b, row 0 for a lane with m_b = 0."""
    cfg = ScoringConfig()
    table = global_dp.byte_table(cfg, "cpu")
    x = torch.tensor([[65, 67, 71], [65, 0, 0], [0, 0, 0]], dtype=torch.uint8)
    y = torch.tensor([[65, 67, 71, 84], [65, 65, 0, 0], [67, 0, 0, 0]], dtype=torch.uint8)
    m = torch.tensor([3, 1, 0], dtype=torch.int32)
    n = torch.tensor([4, 2, 1], dtype=torch.int32)
    out = global_dp.nw_lastrow(x, y, m, n, table=table, gap=2)
    assert out.tolist() == [
        [-6, -1, 4, 9, 7],  # ACG vs ACGT: three matches then a gap
        [-2, 3, 1, 0, 0],
        [0, -2, 0, 0, 0],
    ]


@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("device_cells", [0, hirschberg.DEVICE_CELLS],
                         ids=["device_cells0", "default"])
def test_hirschberg_matches_jax(kind, device_cells):
    """Score and both consensus strings equal JAX's ``hirschberg_align`` on
    pairs of a few hundred letters, with every subproblem through the row
    sweep (device_cells=0: the plain K25 here, the JAX device scan there) and
    at the default split (all on the host at these sizes)."""
    cfg, jcfg, alpha = CONFIGS[kind]
    alpha = alpha or "ARNDCQEGHILKMFPSTWYV"
    gen = random_dna if kind == "uniform" else random_protein
    rng = np.random.default_rng(5)
    y = gen(rng, 260)
    pairs = [(mutate(rng, y, alpha), y), (gen(rng, 180), gen(rng, 230)), (y[:3], y)]
    for x, yy in pairs:
        got = hirschberg.hirschberg_align(x, yy, cfg, device_cells=device_cells, device="cpu")
        want = jax_hb.hirschberg_align(x, yy, jcfg, device_cells=device_cells)
        assert [getattr(got, f) for f in FIELDS] == [getattr(want, f) for f in FIELDS]
        assert hirschberg.alignment_score(got.consensus_x[::-1], got.consensus_y[::-1],
                                          cfg) == got.score


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_nw_align_matches_jax_oracle(kind):
    cfg, jcfg, alpha = CONFIGS[kind]
    gen = random_dna if kind == "uniform" else random_protein
    rng = np.random.default_rng(11)
    for _ in range(3):
        x, y = gen(rng, int(rng.integers(1, 40))), gen(rng, int(rng.integers(1, 45)))
        np.testing.assert_array_equal(oracle.nw_matrix(x, y, cfg), jax_oracle.nw_matrix(x, y, jcfg))
        got, want = oracle.nw_align(x, y, cfg), jax_oracle.nw_align(x, y, jcfg)
        assert [getattr(got, f) for f in FIELDS] == [getattr(want, f) for f in FIELDS]


def test_affine_config_raises():
    """Global alignment is linear-gap only: an affine config raises rather
    than giving another answer than JAX's (which ignores gap_open)."""
    cfg = ScoringConfig(match=1, mismatch=-4, gap_open=6, gap_penalty=1)
    with pytest.raises(ValueError, match="linear-gap only"):
        hirschberg.hirschberg_align("ACGT", "ACGA", cfg, device="cpu")
    with pytest.raises(ValueError, match="linear-gap only"):
        global_dp.nw_lastrow_batch(["ACGT"], ["ACGA"], cfg, device="cpu")
    with pytest.raises(ValueError, match="linear-gap only"):
        global_dp.nw_score_batch(["ACGT"], ["ACGA"], cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        hirschberg.hirschberg_align("ACGT", "ACGA", ScoringConfig(match=2.5), device="cpu")


def test_demo_prints_jax_lines(capsys):
    assert jax_demo.main(["--platform", "cpu"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert demo.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) == 6
