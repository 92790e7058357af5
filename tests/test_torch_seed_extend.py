"""Seed-and-extend in the port against the JAX package, on the CPU: the FM
index, the diagonal vote, the seeded windows, ``SeedExtendAligner``'s
results and ``solve_small --seed-extend``'s CSV, on a synthesized 1.5-kb
reference (narrower windows than the reference) and a few dozen reads.
The JAX side runs as its own tests run it here. It also rebuilds, on that
reference, the JAX seed-extend cases that need the reference data set."""

import csv

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.cli import solve_small as jax_cli
from parallel_genomeseq_tpu.models.fm_index import FMIndex as JaxFMIndex
from parallel_genomeseq_tpu.models.seed_extend import SeedExtendAligner as JaxSeedExtend
from parallel_genomeseq_tpu.models.seed_extend import cluster_diagonals as jax_cluster
from parallel_genomeseq_tpu.ops.substitution import blosum_config as jax_blosum
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxScoringConfig
from parallel_genomeseq_tpu_torch.cli import solve_small as port_cli
from parallel_genomeseq_tpu_torch.models.fm_index import FMIndex
from parallel_genomeseq_tpu_torch.models.seed_extend import SeedExtendAligner, cluster_diagonals
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
from parallel_genomeseq_tpu_torch.seqio.readers import read_fasta
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig
from parallel_genomeseq_tpu_torch.utils.synth import write_dataset

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

FIELDS = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")
BWA_FLAGS = ["--match", "1", "--mismatch", "-4", "--gap-open", "6", "--gap-penalty", "1"]
# (port config, JAX config): solve_small's default, BWA-MEM's affine
# scoring, and BLOSUM50 (the DNA letters are amino-acid codes too).
CONFIGS = {
    "linear": (ScoringConfig(), JaxScoringConfig()),
    "bwa": (ScoringConfig(match=1, mismatch=-4, gap_open=6, gap_penalty=1),
            JaxScoringConfig(match=1, mismatch=-4, gap_open=6, gap_penalty=1)),
    "blosum50": (blosum_config("blosum50"), jax_blosum("blosum50")),
}
JUNK = "WYWYWYWYWYWYWYWYWYWYWYWYWYWYWYWY"  # shares no 24-mer with DNA


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 1.5-kb reference and 40 reads of 100-125 bp with substitutions and
    1-3 bp indels."""
    ref_path, csv_path = write_dataset(
        tmp_path_factory.mktemp("seed"), ref_len=1500, n_reads=40, read_len=(100, 125),
        seed=3,
    )
    with open(csv_path, newline="") as f:
        reads = [r["SEQ"] for r in csv.DictReader(f)]
    return ref_path, csv_path, read_fasta(ref_path), reads


def assert_same(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert [getattr(g, f) for f in FIELDS] == [getattr(w, f) for f in FIELDS], k


@pytest.mark.parametrize("text", ["ref", "tandem"])
def test_fm_index_matches_jax(dataset, text):
    """SA, BWT, C, backward_search, locate, seeds and seeds_batch equal the
    JAX index's, on the reference and on a tandem repeat (many hits)."""
    _, _, ref, reads = dataset
    if text == "tandem":
        ref = "TGTTACGG" * 40 + ref[:200]
    fm, jfm = FMIndex(ref), JaxFMIndex(ref)
    np.testing.assert_array_equal(fm.sa, jfm.sa)
    np.testing.assert_array_equal(fm.bwt, jfm.bwt)
    np.testing.assert_array_equal(fm.C, jfm.C)
    for pat in [ref[100:124], ref[:5], "GTTAC", "ACGN", "WYWY", reads[0][:30], "A"]:
        assert fm.backward_search(pat) == jfm.backward_search(pat), pat
        assert fm.locate(pat) == jfm.locate(pat), pat
    batch = reads[:12] + [JUNK, "", reads[0][:10], "TGTTACGG" * 4]
    assert fm.seeds_batch(batch, k=24, step=8) == jfm.seeds_batch(batch, k=24, step=8)
    for read in batch:
        assert sorted(fm.seeds(read, 24, 8)) == sorted(jfm.seeds(read, 24, 8))


def test_cluster_diagonals_matches_jax():
    """The JAX tests' two vote cases, and random seed sets at three slacks."""
    seeds = [(0, 100), (8, 109), (0, 4000), (8, 4008), (16, 4016)]
    assert sorted(cluster_diagonals(seeds, slack=4)) == [(2, 100, 101), (3, 4000, 4000)]
    rep = [(0, p) for p in (0, 1000, 2000, 3000, 4000)] + [(0, 500), (8, 508)]
    assert max(cluster_diagonals(rep, slack=4))[0] == 2
    rng = np.random.default_rng(0)
    for _ in range(20):
        k = int(rng.integers(0, 30))
        seeds = [(int(o), int(p)) for o, p in zip(rng.integers(0, 100, k) * 8,
                                                  rng.integers(0, 2000, k))]
        for slack in (0, 4, 32):
            assert cluster_diagonals(seeds, slack) == jax_cluster(seeds, slack)


def test_windows_match_jax_and_are_narrow(dataset):
    _, _, ref, reads = dataset
    se, jse = SeedExtendAligner(ref, device="cpu"), JaxSeedExtend(ref)
    batch = reads + [JUNK, reads[0][:20]]
    got = se.windows_batch(batch)
    assert got == jse.windows_batch(batch)
    assert got == [se.window(r) for r in batch] == [jse.window(r) for r in batch]
    assert got[-2:] == [None, None]
    for left, right in got[:-2]:
        # a 100-125 bp read plus 2 x 64 of margin: far below the reference
        assert right - left < len(ref) // 4


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_seed_extend_matches_jax(dataset, kind):
    """Every AlignResult field of a batch with seeded and unseeded reads
    equals the JAX aligner's, under linear, BWA-MEM affine and BLOSUM50
    scoring."""
    _, _, ref, reads = dataset
    cfg, jcfg = CONFIGS[kind]
    batch = reads[:20] + [JUNK]
    got = SeedExtendAligner(ref, cfg, device="cpu").align_batch(batch)
    assert_same(got, JaxSeedExtend(ref, jcfg).align_batch(batch))


def test_no_seed_falls_back_to_full(dataset):
    """A protein string does not seed and aligns at full width."""
    _, _, ref, _ = dataset
    se = SeedExtendAligner(ref, device="cpu")
    assert se.window(JUNK) is None
    full = BatchSWAligner(device="cpu").align_batch([JUNK], [ref])
    assert_same([se.align(JUNK)], full)


def test_two_identical_copies_prefer_leftmost(dataset):
    """A read matching two identical reference copies places at the
    leftmost, the full-width engines' min-j convention."""
    _, _, ref, reads = dataset
    seq = reads[0]
    ref2 = ref[:300] + seq + ref[300:600] + seq + ref[600:900]
    got = SeedExtendAligner(ref2, device="cpu").align(seq)
    want = BatchSWAligner(device="cpu").align_batch([seq], [ref2])[0]
    assert (got.score, got.pos) == (want.score, want.pos)
    assert got.pos <= 300 + len(seq)
    assert_same([got], [JaxSeedExtend(ref2).align(seq)])


def test_mixed_batch_orders_results(dataset):
    """Seeded and unseeded reads interleave; results follow the input
    order, and equal the full-width aligner's on these reads."""
    _, _, ref, reads = dataset
    batch = [reads[0], JUNK, reads[1], reads[2][:20], reads[3]]
    se = SeedExtendAligner(ref, device="cpu")
    got = se.align_batch(batch)
    want = BatchSWAligner(device="cpu").align_batch(batch, [ref])
    assert [(g.score, g.pos) for g in got] == [(w.score, w.pos) for w in want]
    assert [w is None for w in se.windows_batch(batch)] == [False, True, False, True, False]


def test_mutated_read_still_seeds_and_matches(dataset):
    _, _, ref, reads = dataset
    rng = np.random.default_rng(3)
    chars = list(reads[5])
    for p in rng.choice(len(chars), 6, replace=False):  # ~5% substitutions
        chars[p] = "ACGT"[("ACGT".index(chars[p]) + 1) % 4]
    mutated = "".join(chars)
    se = SeedExtendAligner(ref, device="cpu")
    assert se.window(mutated) is not None
    got = se.align(mutated)
    want = BatchSWAligner(device="cpu").align_batch([mutated], [ref])[0]
    assert (got.score, got.pos) == (want.score, want.pos)


def test_zero_seeded_lane_keeps_zero_coordinates(dataset):
    """Watch list: a seeded lane whose result is 0 keeps pos = max_j = 0 (not
    the window's left edge), and an all-zero lane returns (0, 0, 0), as
    ``collect`` does in JAX. Under match 0 every cell is 0 while the exact
    seeds still place the reads."""
    _, _, ref, reads = dataset
    cfg = ScoringConfig(match=0, mismatch=-1, gap_penalty=1)
    se = SeedExtendAligner(ref, cfg, device="cpu")
    batch = [r for r in reads if se.window(r)[0] > 0][:4]
    assert len(batch) == 4
    got = se.align_batch(batch)
    for r in got:
        assert (r.score, r.pos, r.max_i, r.max_j) == (0, 0, 0, 0)
    jcfg = JaxScoringConfig(match=0, mismatch=-1, gap_penalty=1)
    assert_same(got, JaxSeedExtend(ref, jcfg).align_batch(batch))


@pytest.mark.parametrize("extra", [[], BWA_FLAGS, ["--both-strands", "--limit", "24"]],
                         ids=["linear", "bwa", "both-strands"])
def test_solve_small_seed_extend_csv_byte_identical(dataset, tmp_path, capsys, extra):
    ref_path, csv_path, _, _ = dataset
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "16",
            "--seed-extend"] + extra
    jax_out, port_out = tmp_path / "jax.csv", tmp_path / "port.csv"
    rc_jax = jax_cli.main(base + ["--platform", "cpu", "--output", str(jax_out)])
    assert "full-matrix-equivalent GCUPS" in capsys.readouterr().out
    rc_port = port_cli.main(base + ["--device", "cpu", "--output", str(port_out)])
    assert "full-matrix-equivalent GCUPS" in capsys.readouterr().out
    assert rc_port == rc_jax == 0
    assert port_out.read_bytes() == jax_out.read_bytes()


def test_solve_small_seed_extend_plain_engine(dataset, tmp_path):
    """``--engine plain`` writes the same CSV as the default engine (both
    plain on the CPU; on the card this is the kernels against their plain
    versions)."""
    ref_path, csv_path, _, _ = dataset
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "16",
            "--seed-extend", "--device", "cpu", "--limit", "16"]
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    assert port_cli.main(base + ["--output", str(a)]) == 0
    assert port_cli.main(base + ["--engine", "plain", "--output", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_solve_small_seed_extend_skewed_exits_2(dataset, tmp_path, capsys):
    """--seed-extend scores exact int32: with --parity-mode skewed it exits 2
    with the JAX CLI's message."""
    ref_path, csv_path, _, _ = dataset
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--ref", str(ref_path), "--input", str(csv_path), "--seed-extend",
                       "--parity-mode", "skewed", "--device", "cpu",
                       "--output", str(tmp_path / "o.csv")])
    assert exc.value.code == 2
    assert ("--seed-extend implies exact int32 scoring; drop --parity-mode skewed"
            in capsys.readouterr().err)
