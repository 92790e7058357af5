"""The reference-parity slice (ROADMAP A2): the port's plain route under
Semantics.SAT_UINT8 and the skewed tie against the JAX package's
``ScanEngine`` on the CPU -- every ``score_batch`` field and the (D, M, B)
moves byte for byte, both ties, ragged lanes with m < n, m = n and m > n,
saturated plateaus, operands outside [0, 255], pad bytes and an all-zero
lane -- with the clamp identity K26 and K27 rest on, ``sw_matrix_scan`` and
``hstack_to_matrix``, ``solve_small --parity-mode skewed`` and
``--semantics sat_uint8`` and ``solve_big --semantics sat_uint8`` against
the JAX CLIs, and the global path under a SAT_UINT8 config. Inputs are made
with numpy from seeds."""

import csv

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.cli import solve_big as jax_big
from parallel_genomeseq_tpu.cli import solve_small as jax_cli
from parallel_genomeseq_tpu.models import hirschberg as jax_hb
from parallel_genomeseq_tpu.models.swaligner import BatchSWAligner as JaxBatch
from parallel_genomeseq_tpu.ops import global_dp as jax_gdp
from parallel_genomeseq_tpu.ops import scan_dp as jax_scan
from parallel_genomeseq_tpu.parallel.chunking import ChunkedAligner as JaxChunked
from parallel_genomeseq_tpu.utils.config import ChunkConfig as JaxChunkConfig
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxConfig
from parallel_genomeseq_tpu.utils.config import Semantics as JaxSemantics
from parallel_genomeseq_tpu_torch.cli import solve_big, solve_small
from parallel_genomeseq_tpu_torch.models import hirschberg
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops import engine, global_dp, scan_dp
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
from parallel_genomeseq_tpu_torch.seqio.readers import read_fasta
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig, Semantics
from parallel_genomeseq_tpu_torch.utils.synth import write_dataset

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

FIELDS = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")
# (match, mismatch, gap, semantics): the reference's defaults saturating;
# operands outside [0, 255] (match 300 clips to 255, mismatch +2 to a
# penalty of 0, gap 0); a plateau-heavy 100/-50/7; exact values (the skewed
# tie alone).
SCORING = {
    "sat": (3, -3, 2, "sat_uint8"),
    "sat_outside": (300, 2, 0, "sat_uint8"),
    "sat_plateau": (100, -50, 7, "sat_uint8"),
    "exact": (3, -3, 2, "int32"),
}


def configs(name):
    match, mismatch, gap, sem = SCORING[name]
    kw = dict(match=float(match), mismatch=float(mismatch), gap_penalty=float(gap))
    return (JaxConfig(semantics=JaxSemantics(sem), **kw),
            ScoringConfig(semantics=Semantics(sem), **kw))


def lanes(seed, B=14, M=100, N=160):
    """(xs (B, M), ys (B, N) uint8 padded with X_PAD / Y_PAD, m, n): ragged
    lanes with m < n, m = n and m > n, reads planted in their references
    (saturated plateaus at high match scores), one lane whose read repeats
    a stretch of its reference twice, and an all-zero lane."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    m = rng.integers(1, M + 1, B).astype(np.int32)
    n = rng.integers(1, N + 1, B).astype(np.int32)
    m[:4], n[:4] = (M, 20, M, 1), (N, 20, 30, 1)  # full, m = n, m > n, 1 x 1
    xs = np.full((B, M), 1, np.uint8)
    ys = np.full((B, N), 2, np.uint8)
    for b in range(B):
        ys[b, : n[b]] = rng.choice(acgt, n[b])
        xs[b, : m[b]] = rng.choice(acgt, m[b])
        k = min(m[b], n[b])
        xs[b, :k] = ys[b, n[b] - k : n[b]]
    half = int(n[0]) // 2
    ys[0, half : 2 * half] = ys[0, :half]  # two copies: equal maxima far apart
    xs[0, :half] = ys[0, :half]
    xs[5, : m[5]], ys[5, : n[5]] = ord("A"), ord("C")  # all-zero lane
    return xs, ys, m, n


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scoring", list(SCORING))
@pytest.mark.parametrize("tie", ["colmajor", "skewed"])
def test_plain_route_matches_scan_engine(seed, scoring, tie):
    """Both engines' CPU route (K26's plain version) against JAX
    ScanEngine(cfg, tie): score, i, j of score_batch, and with moves the
    whole (D, M, B) tensor, byte for byte."""
    jcfg, cfg = configs(scoring)
    xs, ys, m, n = lanes(seed)
    want = jax_scan.ScanEngine(jcfg, tie=tie).score_batch(xs, ys, m, n, emit_moves=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    if scoring.startswith("sat"):
        assert int(want["score"].max()) == 255
    if scoring in ("sat_outside", "sat_plateau"):
        assert (want["score"] == 255).sum() > 4
    assert want["score"][5] == 0
    for name in ("cuda", "plain"):
        eng = engine.make_score_engine(cfg, name, device="cpu", tie=tie)
        got = eng.score_batch(xs, ys, m, n)
        for k in ("score", "i", "j"):
            assert np.array_equal(got[k].numpy(), want[k]), (name, k)
        got = eng.score_batch_moves(xs, ys, m, n)
        for k in ("score", "i", "j", "moves"):
            assert np.array_equal(got[k].numpy(), want[k]), (name, k)
        no_pos = eng.score_batch(xs, ys, m, n, need_pos=False)
        assert np.array_equal(no_pos["score"].numpy(), want["score"])
        assert not no_pos["i"].any() and not no_pos["j"].any()


def test_config_matches_jax():
    """The port's ScoringConfig copy: the same DP value type, and the same
    refusal of affine gaps under SAT_UINT8."""
    from parallel_genomeseq_tpu.ops.substitution import blosum_config as jax_blosum

    pairs = [(JaxConfig(), ScoringConfig()), configs("sat"), configs("sat_outside"),
             (JaxConfig(semantics=JaxSemantics.FLOAT32), ScoringConfig(semantics=Semantics.FLOAT32)),
             (JaxConfig(match=2.5), ScoringConfig(match=2.5)),
             (JaxConfig(match=2.5, semantics=JaxSemantics.SAT_UINT8),
              ScoringConfig(match=2.5, semantics=Semantics.SAT_UINT8)),
             (jax_blosum("blosum62"), blosum_config("blosum62"))]
    for jcfg, cfg in pairs:
        assert cfg.dp_dtype() == jcfg.dp_dtype()
    for make in (JaxConfig, ScoringConfig):
        sem = JaxSemantics if make is JaxConfig else Semantics
        with pytest.raises(ValueError, match="affine gaps are not supported in SAT_UINT8"):
            make(gap_open=1.0, semantics=sem.SAT_UINT8)


def test_clamp_identity():
    """The saturating step of JAX ``_dp_step`` (scan_dp.py:67-71), on
    carries in [0, 255] and the clipped operands, equals the exact linear
    step with those operands clamped at 255 -- what K26 and K27 compute."""
    from parallel_genomeseq_tpu.ops.scan_dp import _dp_step

    rng = np.random.default_rng(3)
    K = 200_000
    h = rng.integers(0, 256, (3, K)).astype(np.int32)
    h[:, :8] = [[0, 255, 0, 255, 254, 1, 255, 0]] * 3  # the edges
    eq = rng.integers(0, 2, K).astype(bool)
    for match, mismatch, gap in [(3, -3, 2), (300, 2, 0), (255, -255, 255), (100, -50, 7),
                                 (0, 0, 1)]:
        mt, mm, g = scan_dp.sat_operands(match, mismatch, gap)  # mm is -clip(-mismatch)
        h1s, h1, h2s = h
        plus = np.where(eq, mt, 0).astype(np.int32)
        minus = np.where(eq, 0, -mm).astype(np.int32)
        want = np.asarray(_dp_step(h1s, h1, h2s, (plus, minus), np.int32(g),
                                   JaxSemantics.SAT_UINT8.value, np.int32))
        s = np.where(eq, mt, mm)
        got = np.minimum(np.maximum.reduce([h2s + s, h1 - g, h1s - g, np.zeros_like(h1)]), 255)
        assert np.array_equal(got, want), (match, mismatch, gap)


@pytest.mark.parametrize("cfg_name", ["default", "sat", "sat_outside", "blosum", "affine"])
def test_sw_matrix_scan_matches_jax(cfg_name):
    """``sw_matrix_scan`` (the full H matrix of ``keep_matrix``): values and
    dtype (uint8 under SAT_UINT8, int32 else) equal to JAX's."""
    from parallel_genomeseq_tpu.ops.substitution import blosum_config as jax_blosum

    cfgs = {
        "default": (JaxConfig(), ScoringConfig()),
        "sat": configs("sat"),
        "sat_outside": configs("sat_outside"),
        "blosum": (jax_blosum("blosum50", gap_penalty=4.0), blosum_config("blosum50",
                                                                          gap_penalty=4.0)),
        "affine": (JaxConfig(gap_open=5.0, gap_penalty=1.0),
                   ScoringConfig(gap_open=5.0, gap_penalty=1.0)),
    }
    jcfg, cfg = cfgs[cfg_name]
    rng = np.random.default_rng(11)
    letters = list("ACGTN") if cfg_name != "blosum" else list("ARNDCQEGHWY")
    for m, n in ((1, 1), (12, 30), (40, 17), (110, 90)):
        x = "".join(rng.choice(letters, m))
        y = x[: m // 2] + "".join(rng.choice(letters, n))[: n - m // 2]
        want = jax_scan.sw_matrix_scan(x, y, jcfg)
        got = scan_dp.sw_matrix_scan(x, y, cfg)
        assert got.dtype == np.asarray(want).dtype and np.array_equal(got, want), (m, n)


def test_hstack_to_matrix_matches_jax():
    """``hstack_to_matrix`` on random stacks, numpy or a tensor, every lane."""
    rng = np.random.default_rng(4)
    for D, M, B, m, n in ((9, 4, 3, 4, 6), (30, 12, 2, 7, 19), (1, 1, 1, 1, 1)):
        hs = rng.integers(0, 1000, (D, M, B)).astype(np.int32)
        for lane in range(B):
            want = jax_scan.hstack_to_matrix(hs, m, n, lane)
            assert np.array_equal(scan_dp.hstack_to_matrix(hs, m, n, lane), want)
            assert np.array_equal(scan_dp.hstack_to_matrix(torch.from_numpy(hs), m, n, lane),
                                  want)


def test_long_reads_match_scan_engine():
    """Past 2,048 rows (K27's plain route, score and argmax), both ties,
    saturating and exact values, against JAX ScanEngine."""
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    M, N = 2100, 120
    xs = rng.choice(acgt, (2, M)).astype(np.uint8)
    ys = rng.choice(acgt, (2, N)).astype(np.uint8)
    xs[0, 500:620] = ys[0]
    xs[1, 1000:1060] = ys[1, 30:90]
    m, n = np.array([M, 1700], np.int32), np.array([N, 100], np.int32)
    for scoring in ("sat", "sat_plateau", "exact"):
        jcfg, cfg = configs(scoring)
        for tie in ("colmajor", "skewed"):
            want = jax_scan.ScanEngine(jcfg, tie=tie).score_batch(xs, ys, m, n)
            got = engine.CudaEngine(cfg, "cpu", tie).score_batch(xs, ys, m, n)
            for k in ("score", "i", "j"):
                assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (scoring, tie, k)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 1-kb reference and 64 reads of 125 bp (substitutions at 1%, half
    with a 1-3 bp indel, so some are exact copies): scores saturate at 255
    under match 3."""
    ref_path, csv_path = write_dataset(tmp_path_factory.mktemp("parity"), ref_len=1000,
                                       n_reads=64, read_len=(125, 125), seed=17)
    with open(csv_path, newline="") as f:
        reads = [r["SEQ"] for r in csv.DictReader(f)]
    return ref_path, csv_path, read_fasta(ref_path), reads


@pytest.mark.parametrize("extra", [
    ["--parity-mode", "skewed"],
    ["--parity-mode", "skewed", "--both-strands"],
    ["--semantics", "sat_uint8"],
    ["--semantics", "sat_uint8", "--npiece", "1", "--eval"],
    ["--semantics", "sat_uint8", "--seed-extend"],
], ids=["skewed", "skewed-both-strands", "sat-npiece17", "sat-npiece1-eval", "sat-seed-extend"])
def test_solve_small_parity_csv_byte_identical(dataset, tmp_path, extra):
    ref_path, csv_path, _, _ = dataset
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "32"] + extra
    jax_out, port_out = tmp_path / "jax.csv", tmp_path / "port.csv"
    rc_jax = jax_cli.main(base + ["--platform", "cpu", "--output", str(jax_out)])
    run = solve_small.run(base + ["--device", "cpu", "--output", str(port_out)])
    assert run.rc == rc_jax
    assert port_out.read_bytes() == jax_out.read_bytes()
    if extra[0] == "--parity-mode":
        assert sum(r.score == 255 for r in run.results) > 32  # saturated plateaus


def test_skewed_tie_vs_colmajor_differ(dataset):
    """tests/test_reference_parity.py's check on synthesized data: a read
    with a second copy at the end of the reference, both saturating, so the
    skewed tie (whose raw key is least past the anti-diagonal i + j = n)
    and the column-major one (least j) pick different cells -- and the port
    picks JAX's under each."""
    _, _, ref, _ = dataset
    read = ref[100:225]
    ref = ref + read
    sat = ScoringConfig(semantics=Semantics.SAT_UINT8)
    jsat = JaxConfig(semantics=JaxSemantics.SAT_UINT8)
    got = {
        "skew": BatchSWAligner(sat, tie="skewed", device="cpu").align_batch([read], [ref])[0],
        "sat": BatchSWAligner(sat, device="cpu").align_batch([read], [ref])[0],
        "exact": BatchSWAligner(device="cpu").align_batch([read], [ref])[0],
    }
    want = {
        "skew": JaxBatch(jsat, tie="skewed").align_batch([read], [ref])[0],
        "sat": JaxBatch(jsat).align_batch([read], [ref])[0],
        "exact": JaxBatch(JaxConfig()).align_batch([read], [ref])[0],
    }
    for k in got:
        assert [getattr(got[k], f) for f in FIELDS] == [getattr(want[k], f) for f in FIELDS], k
    assert got["skew"].score == got["sat"].score == 255
    assert (got["skew"].max_i, got["skew"].max_j) != (got["sat"].max_i, got["sat"].max_j)
    assert got["exact"].score == 375


def test_solve_big_sat_matches_jax(tmp_path, capsys):
    """solve_big --semantics sat_uint8 at a reduced shape (3 reads of 600
    bp, a 2,400-bp reference, 2 x 2 windows), score-only and --traceback:
    the port's results equal JAX's ChunkedAligner under the CLI's settings,
    and the JAX CLI runs on the same files."""
    ref = "".join(np.random.default_rng(21).choice(list("ACGT"), 2400))
    (tmp_path / "ref.fa").write_text(f">ref\n{ref}\n")
    starts = (100, 900, 1750)
    rows = "".join(f"{k},r{k},{ref[s:s + 600]},{s + 1}\n" for k, s in enumerate(starts))
    (tmp_path / "reads.csv").write_text("index,QNAME,SEQ,POS\n" + rows)
    reads = [ref[s : s + 600] for s in starts]
    files = ["--ref", str(tmp_path / "ref.fa"), "--reads", str(tmp_path / "reads.csv")]
    flags = ["2", "1", "--semantics", "sat_uint8"] + files
    jcfg = JaxConfig(semantics=JaxSemantics.SAT_UINT8)
    jax_chunked = JaxChunked(cfg=jcfg, chunk=JaxChunkConfig(npiece=4, overlap_ratio=2.0))
    for tb in (False, True):
        extra = ["--traceback"] if tb else []
        assert jax_big.main(flags + extra + ["--platform", "cpu"]) == 0
        run = solve_big.run(flags + extra + ["--device", "cpu"])
        assert run.rc == 0
        want = jax_chunked.align_batch(reads, ref, traceback=tb)
        assert [[getattr(r, f) for f in FIELDS] for r in run.results] == \
            [[getattr(r, f) for f in FIELDS] for r in want]
        assert all(r.score == 255 for r in run.results)
    assert "GCUPS mean" in capsys.readouterr().out


def test_parity_moves_refusals_match_jax():
    """Moves of the parity forms: where JAX's scan would need a move tensor
    over 2 GiB, its ValueError, word for word (so ``solve_big --semantics
    sat_uint8 --traceback`` at its default shape fails as JAX's does); past
    2,048 rows below that bound, NotImplementedError naming A2b."""
    sat = ScoringConfig(semantics=Semantics.SAT_UINT8)
    read, ref = "A" * 3000, "C" * 800_000
    with pytest.raises(ValueError) as want:
        JaxBatch(JaxConfig(semantics=JaxSemantics.SAT_UINT8)).align_batch([read], [ref])
    for tie in ("colmajor", "skewed"):
        with pytest.raises(ValueError) as got:
            BatchSWAligner(sat, tie=tie, device="cpu").align_batch([read], [ref])
        assert str(got.value) == str(want.value)
        with pytest.raises(NotImplementedError, match="ROADMAP A2b"):
            BatchSWAligner(sat, tie=tie, device="cpu").align_batch(["A" * 2100], ["A" * 50])
    with pytest.raises(NotImplementedError, match="ROADMAP A2b"):
        BatchSWAligner(blosum_config("blosum50"), tie="skewed", device="cpu").align_batch(
            ["A" * 2100], ["A" * 50], traceback=False)


def test_global_path_under_sat_config_matches_jax():
    """hirschberg_align, nw_lastrow_batch and nw_score_batch take no DP
    semantics in JAX: under a SAT_UINT8 config they give the exact integer
    answer, and so does the port (rows past 255 and below 0 included)."""
    rng = np.random.default_rng(9)
    xs = ["".join(rng.choice(list("ACGT"), k)) for k in (1, 40, 130, 300)]
    ys = [x[: len(x) // 2] + "".join(rng.choice(list("ACGT"), 90)) for x in xs]
    jcfg, cfg = configs("sat")
    want_rows = jax_gdp.nw_lastrow_batch(xs, ys, jcfg)
    got_rows = global_dp.nw_lastrow_batch(xs, ys, cfg, device="cpu")
    for g, w in zip(got_rows, want_rows):
        assert np.array_equal(g, np.asarray(w))
    assert np.array_equal(global_dp.nw_score_batch(xs, ys, cfg, device="cpu"),
                          np.asarray(jax_gdp.nw_score_batch(xs, ys, jcfg)))
    assert min(int(np.asarray(r).min()) for r in want_rows) < 0
    for x, y in zip(xs[1:], ys[1:]):
        want = jax_hb.hirschberg_align(x, y, jcfg)
        got = hirschberg.hirschberg_align(x, y, cfg, device="cpu")
        assert (got.score, got.consensus_x, got.consensus_y) == \
            (want.score, want.consensus_x, want.consensus_y)
