"""Contract of the PyTorch/CUDA port: it never imports jax or the JAX
package, configurations and options outside the ported slices raise
naming their ROADMAP item while the ported ones (affine gaps among them)
run, CPU tensors take the plain route without counting a kernel launch, and
a missing CUDA toolkit or card raises instead of falling back."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu_torch.cli import solve_big, solve_small, solve_uniprot
from parallel_genomeseq_tpu_torch.models.protein_db import ResidentProteinDB
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops import (
    _build,
    engine,
    profile_cuda,
    strips_cuda,
    traceback,
    wavefront_cuda,
)
from parallel_genomeseq_tpu_torch.ops.substitution import ALPHABET, blosum_config
from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkedAligner
from parallel_genomeseq_tpu_torch.utils import device as device_mod
from parallel_genomeseq_tpu_torch.utils.config import ChunkConfig, ScoringConfig, Semantics

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
COUNTERS = (wavefront_cuda.sw_score, wavefront_cuda.sw_score_moves, traceback.walk_moves,
            profile_cuda.sw_profile, profile_cuda.sw_profile_moves,
            wavefront_cuda.sw_score_affine, wavefront_cuda.sw_score_affine_moves,
            profile_cuda.sw_profile_affine, profile_cuda.sw_profile_affine_moves,
            traceback.walk_moves_affine, strips_cuda.sw_score_strips,
            strips_cuda.sw_score_strips_ckpt, strips_cuda.strip_moves,
            traceback.walk_strip_level, strips_cuda.sw_score_strips_affine,
            strips_cuda.sw_score_strips_affine_ckpt, strips_cuda.strip_affine_moves,
            traceback.walk_strip_level_affine, strips_cuda.sw_score_strips_profile,
            strips_cuda.sw_score_strips_profile_ckpt, strips_cuda.strip_profile_moves,
            strips_cuda.sw_score_strips_profile_affine,
            strips_cuda.sw_score_strips_profile_affine_ckpt,
            strips_cuda.strip_profile_affine_moves, wavefront_cuda.sw_score_parity,
            strips_cuda.sw_score_strips_parity)
AFFINE = {
    "uniform": ScoringConfig(gap_open=10.0),
    "matrix": blosum_config("blosum50", gap_penalty=2.0, gap_open=10.0),
}


def self_score(matrix: str, seq: str) -> int:
    """The sum of ``seq``'s residues' scores against themselves."""
    S = blosum_config(matrix).matrix
    return sum(int(S[ALPHABET.index(c)][ALPHABET.index(c)]) for c in seq)


def test_port_never_imports_jax():
    """Import every module of the port, and chip_smoke, in a fresh
    interpreter: neither jax nor any module of the JAX package
    (parallel_genomeseq_tpu, parallel_genomeseq_tpu.*) may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import parallel_genomeseq_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert 'parallel_genomeseq_tpu_torch.cli.solve_uniprot' in mods\n"
        "assert 'parallel_genomeseq_tpu_torch.cli.solve_big' in mods\n"
        "assert 'parallel_genomeseq_tpu_torch.ops.strips_cuda' in mods\n"
        "assert 'parallel_genomeseq_tpu_torch.cli.serve' in mods\n"
        "assert 'parallel_genomeseq_tpu_torch.cli.solve_batch' in mods\n"
        "for m in ('models.fm_index', 'models.seed_extend', 'models.hirschberg',\n"
        "          'ops.global_dp', 'ops.oracle', 'cli.demo', 'cli.gen_data',\n"
        "          'cli.evaluate', 'seqio.readers', 'seqio.uniprot'):\n"
        "    assert 'parallel_genomeseq_tpu_torch.' + m in mods, m\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'parallel_genomeseq_tpu'\n"
        "             or m.startswith('parallel_genomeseq_tpu.'))\n"
        "print(len(mods), ','.join(bad) or '-')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        check=True, timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"},
    ).stdout.split()
    assert int(out[0]) >= 20 and out[1] == "-", out


@pytest.mark.parametrize("cfg, error, match", [
    (ScoringConfig(semantics=Semantics.SAT_UINT8, matrix=blosum_config("blosum50").matrix,
                   alphabet=ALPHABET), ValueError, "SAT_UINT8 supports uniform scoring only"),
    (ScoringConfig(match=2.5), NotImplementedError, "ROADMAP A2b"),
    (ScoringConfig(semantics=Semantics.FLOAT32), NotImplementedError, "ROADMAP A2b"),
], ids=["sat_uint8", "non_integral", "float32"])
def test_unsupported_configs_raise(cfg, error, match):
    """Float32 values wait for A2b; SAT_UINT8 runs (A2) but, as the JAX
    ScanEngine, only under uniform scores, and refuses a matrix with its
    ValueError."""
    with pytest.raises(error, match=match):
        engine.make_score_engine(cfg, device="cpu")
    with pytest.raises(error, match=match):
        ChunkedAligner(cfg=cfg, device="cpu")


@pytest.mark.parametrize("kind", ["uniform", "matrix"])
def test_affine_configs_run(kind):
    """Affine configs (A9), uniform and matrix, build their engine and
    ChunkedAligner on the CPU and align across one gap: a read with two
    residues deleted scores its matches less gap_open + 2 * gap_penalty."""
    cfg = AFFINE[kind]
    assert type(engine.make_score_engine(cfg, device="cpu")) is engine.CudaEngine
    rng = np.random.default_rng(5)
    letters = list("ACGT") if kind == "uniform" else list(ALPHABET[:20])
    ref = "".join(rng.choice(letters, 300))
    read = ref[100:120] + ref[122:142]
    if kind == "uniform":
        matches = 3 * len(read)
    else:
        matches = sum(int(cfg.matrix[ALPHABET.index(c)][ALPHABET.index(c)]) for c in read)
    res = ChunkedAligner(cfg=cfg, chunk=ChunkConfig(npiece=3, overlap_ratio=2.0),
                         device="cpu").align_batch([read], ref)[0]
    assert res.score == matches - 10 - 2 * 2
    assert (res.pos, res.consensus_x.count("-"), res.consensus_y.count("-")) == (101, 2, 0)
    assert "--" in res.consensus_x


def test_matrix_configs_are_ported_and_scan_long_queries(tmp_path):
    """Linear substitution-matrix scoring runs (A8), and so does its affine
    form (A9): the resident database's default gaps are the affine 10/2 and
    it scans. A database for queries past 2,048 scans them under linear gaps
    (the profile strips, A10c) and under its default affine ones (the affine
    profile strips, A10d): nothing raises any more."""
    eng = engine.make_score_engine(blosum_config("blosum62"), device="cpu")
    assert int(eng.table[1, 1]) == 4 and eng.table.shape == (len(ALPHABET) + 1,) * 2
    entries = [("a", "MKWVTFISLL"), ("b", "GVFRRDTHKS")]
    db = ResidentProteinDB(entries, device="cpu")
    assert (db.cfg.gap_open, db.cfg.gap_penalty) == (10.0, 2.0)
    scores, pos, _ = db.scan_scores("MKWVTFISLL")
    # MKWVTFISLL against itself under BLOSUM50: 7+6+15+5+5+8+5+5+5+5.
    assert (int(scores[0]), int(pos[0])) == (66, 10)
    long_db = ResidentProteinDB(entries, gap_open=0.0, max_query_len=engine.MAX_M + 1,
                                device="cpu")
    scores, pos, _ = long_db.scan_scores("P" * (engine.MAX_M - 9) + "MKWVTFISLL")
    assert (int(scores[0]), int(pos[0])) == (66, 10)
    affine_db = ResidentProteinDB(entries, max_query_len=engine.MAX_M + 1, device="cpu")
    assert affine_db.cfg.is_affine
    scores, pos, _ = affine_db.scan_scores("P" * (engine.MAX_M - 9) + "MKWVTFISLL")
    assert [(int(s), int(p)) for s, p in zip(scores, pos)] == [(66, 10), (8, 3)]


def test_make_score_engine_names():
    assert type(engine.make_score_engine(device="cpu")) is engine.CudaEngine
    assert type(engine.make_score_engine(name="cuda", device="cpu")) is engine.CudaEngine
    plain = engine.make_score_engine(name="plain", device="cpu")
    assert type(plain) is engine.PlainEngine
    xs = np.frombuffer(b"ACGTTACG", np.uint8).copy()[None]
    ys = np.frombuffer(b"TTACGTTACGAA", np.uint8).copy()[None]
    want = engine.CudaEngine(device="cpu").score_batch(xs, ys, [8], [12])
    got = plain.score_batch(xs, ys, [8], [12])
    assert {k: int(v[0]) for k, v in got.items()} == {k: int(v[0]) for k, v in want.items()}
    assert int(got["score"][0]) == 24
    with pytest.raises(ValueError, match="unknown engine"):
        engine.make_score_engine(name="pallas", device="cpu")
    # The aligner takes the same names: 'plain' walks with the plain walk too.
    bat = BatchSWAligner(device="cpu", engine="plain")
    assert type(bat.engine) is engine.PlainEngine
    reads, refs = ["ACGTTACG"], ["TTACGTTACGAA"]
    got = bat.align_batch(reads, refs)[0]
    want = BatchSWAligner(device="cpu").align_batch(reads, refs)[0]
    assert (got.score, got.pos, got.consensus_x, got.consensus_y) == (
        want.score, want.pos, want.consensus_x, want.consensus_y)


def test_skewed_ties_raise_and_strip_length_reads_align():
    """Skewed ties (A2) run under linear gaps and raise the JAX ScanEngine's
    ValueError under affine ones. A read past MAX_M runs under every
    scoring family -- uniform or a substitution matrix, each with linear or
    affine gaps (the strip kernels, A10) -- and aligns."""
    with pytest.raises(ValueError, match="use tie='colmajor'"):
        BatchSWAligner(AFFINE["uniform"], tie="skewed", device="cpu")
    assert BatchSWAligner(tie="skewed", device="cpu").engine.parity
    long_read = np.full((1, engine.MAX_M + 8), ord("A"), np.uint8)
    lens = ([engine.MAX_M + 8], [engine.MAX_M + 8])
    blosum = blosum_config("blosum50", gap_penalty=12.0)  # A-A scores 5
    for cfg, match in ((ScoringConfig(), 3), (AFFINE["uniform"], 3), (blosum, 5),
                       (AFFINE["matrix"], 5)):
        got = engine.make_score_engine(cfg, device="cpu").score_batch(long_read, long_read, *lens)
        assert [int(got[k][0]) for k in ("score", "i", "j")] == \
            [match * (engine.MAX_M + 8)] + lens[0] * 2
    for cfg in (blosum, AFFINE["matrix"]):
        got = BatchSWAligner(cfg, device="cpu").align_batch(["A" * 2100], ["A" * 50])[0]
        assert (got.score, got.pos, got.consensus_x, got.consensus_y) == \
            (250, 1, "A" * 50, "A" * 50)


@pytest.mark.parametrize("flags", [
    ["--matrix", "blosum50"], ["--gap-open", "6", "--matrix", "blosum62"],
], ids=["linear", "affine"])
def test_solve_big_matrix_runs_long_reads(flags, tmp_path):
    """A substitution matrix on long reads runs, with linear gaps (the
    profile strips, A10c) and with affine ones (A10d): a 2,100-bp read of
    the reference scores its exact diagonal over its better window."""
    ref = "".join(np.random.default_rng(6).choice(list("ACGT"), 2400))
    (tmp_path / "ref.fa").write_text(f">ref\n{ref}\n")
    (tmp_path / "reads.csv").write_text(f"index,QNAME,SEQ,POS\n0,r0,{ref[150:2250]},151\n")
    run = solve_big.run(["1", "1", "--ref", str(tmp_path / "ref.fa"), "--reads",
                         str(tmp_path / "reads.csv"), "--overlap-ratio", "0.1",
                         "--device", "cpu"] + flags)
    # 2 windows of 1,305 bp, [0, 1305) and [1095, 2400), each holding 1,155
    # bp of the read; the second's diagonal scores higher.
    matrix = flags[flags.index("--matrix") + 1]
    assert run.rc == 0 and run.results[0].score == self_score(matrix, ref[1095:2250])
    assert self_score(matrix, ref[1095:2250]) > self_score(matrix, ref[150:1305])


@pytest.mark.parametrize("flags, item", [(["--semantics", "float32"], "A2b")],
                         ids=["float32"])
def test_solve_big_rejects_unported_modes(flags, item, capsys):
    """float32 needs A2b (sat_uint8 runs since A2): the refusal exits 2
    before any data is generated."""
    with pytest.raises(SystemExit) as exc:
        solve_big.main(["--device", "cpu"] + flags)
    assert exc.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--seed-extend", "--parity-mode", "skewed"], ["--parity-mode", "skewed", "--engine", "plain"],
])
def test_solve_small_rejects_unported_modes(flags, tmp_path):
    """The skewed parity mode runs (A2), but not with --seed-extend, which is
    refused with the JAX CLI's message (seed-extend scores exact int32), nor
    with --engine, which is the --seed-extend path's."""
    with pytest.raises(SystemExit) as exc:
        solve_small.main(flags + ["--device", "cpu", "--output", str(tmp_path / "o.csv")])
    assert exc.value.code == 2


@pytest.mark.parametrize("flags", [["--engine", "plain"], ["--engine", "cuda", "--npiece", "1"]])
def test_solve_small_engine_needs_seed_extend(flags, tmp_path, capsys):
    """``--engine`` picks the --seed-extend path's engine and is refused on
    the chunked and unchunked paths, before any data is read."""
    with pytest.raises(SystemExit) as exc:
        solve_small.main(flags + ["--device", "cpu", "--output", str(tmp_path / "o.csv")])
    assert exc.value.code == 2
    assert "--engine applies to --seed-extend only" in capsys.readouterr().err


@pytest.mark.parametrize("gaps, row", [
    ([], "a,15,66,10,2,LLSIFTVWK,LLSIFTVWK"),
    (["--gap-open", "10", "--gap-penalty", "2"], "a,15,66,10,1,LLSIFTVWKM,LLSIFTVWKM"),
], ids=["linear", "affine"])
def test_solve_uniprot_runs_long_queries(gaps, row, tmp_path):
    """A query past the single-strip kernels' 2,048 rows runs under linear
    gaps (the profile strips, A10c) and under affine ones (the affine
    profile strips, A10d). MKWVTFISLL's BLOSUM50 diagonal (66) plus GVFRR
    against the repeat's MKWVT (0 - 3 + 1 - 3 - 3) stays 66, ending in the
    entry's column 10; no gap pays under either model. The linear walk
    stops on the entry's second residue (a neighbour of that cell is 0), the
    affine one on its first."""
    (tmp_path / "q.fasta").write_text(">q\n" + "MKWVTFISLL" * 206 + "\n")
    (tmp_path / "db.fasta").write_text(">a\nMKWVTFISLLGVFRR\n")
    assert solve_uniprot.main(["--query", str(tmp_path / "q.fasta"), "--database",
                               str(tmp_path / "db.fasta"), "--device", "cpu", "--output",
                               str(tmp_path / "o.csv")] + gaps) == 0
    assert (tmp_path / "o.csv").read_text().splitlines()[1] == row


@pytest.mark.parametrize("case, item", [("num_processes", "A13")])
def test_solve_uniprot_rejects_unported_modes(case, item, tmp_path, capsys):
    """A sharded run is refused, naming the ROADMAP item that ports it."""
    query = tmp_path / "q.fasta"
    query.write_text(">q\n" + "MKWVTFISLL" * 3 + "\n")
    db = tmp_path / "db.fasta"
    db.write_text(">a\nMKWVTFISLLGVFRR\n")
    base = ["--query", str(query), "--database", str(db), "--device", "cpu", "--output",
            str(tmp_path / "o.csv")]
    flags = {"num_processes": ["--num-processes", "2"]}[case]
    with pytest.raises(SystemExit) as exc:
        solve_uniprot.main(base + flags)
    assert exc.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err
    assert not (tmp_path / "o.csv").exists()


def test_solve_uniprot_runs_affine_gaps(tmp_path, capsys):
    """--gap-open 10 --gap-penalty 2 (A9) scans, walks the top hit and
    writes the CSV."""
    (tmp_path / "q.fasta").write_text(">q\nMKWVTFISLLGVFRRDTHKS\n")
    (tmp_path / "db.fasta").write_text(">a\nMKWVTFISLLGVFRR\n>b\nPPPPGGGG\n")
    out = tmp_path / "o.csv"
    assert solve_uniprot.main(["--query", str(tmp_path / "q.fasta"), "--database",
                               str(tmp_path / "db.fasta"), "--device", "cpu", "--output",
                               str(out), "--gap-open", "10", "--gap-penalty", "2"]) == 0
    rows = out.read_text().splitlines()
    # Entry a is the query's first 15 residues: the BLOSUM50 diagonal's sum,
    # walked back to the query's first residue (consensus reversed).
    walk = "MKWVTFISLLGVFRR"[::-1]
    assert rows[:2] == ["name,len,score,pos_end,pos_pred,consensus_x,consensus_y",
                        f"a,15,101,15,1,{walk},{walk}"]
    assert len(rows) == 3 and "Scored" in capsys.readouterr().out


@pytest.mark.parametrize("gaps", [[], ["--gap-open", "10", "--gap-penalty", "2"]],
                         ids=["linear", "affine"])
def test_solve_uniprot_scans_and_walks_long_entries(gaps, tmp_path):
    """An entry past 2,048 aa is scanned (the entry is K4's y, which has no
    row limit) and walked in strips, emitting the raw letters: under linear
    gaps by K20, K21 and K14, under affine ones by K23, K24 and K18."""
    query = "MKWVTFISLLGVFRRDTHKSEIAHRFKDLGE"
    (tmp_path / "q.fasta").write_text(f">q\n{query}\n")
    (tmp_path / "db.fasta").write_text(
        f">short\n{query[:20]}\n>long\n{'GS' * 1040}{query}\n")
    base = ["--query", str(tmp_path / "q.fasta"), "--database", str(tmp_path / "db.fasta"),
            "--device", "cpu", "--output", str(tmp_path / "o.csv")] + gaps
    L = 2080 + len(query)
    assert solve_uniprot.main(base + ["--traceback-top", "0"]) == 0
    rows = (tmp_path / "o.csv").read_text().splitlines()
    assert rows[2].startswith(f"long,{L},") and rows[2].endswith(f",{L},,,")
    assert solve_uniprot.main(base) == 0
    row = (tmp_path / "o.csv").read_text().splitlines()[2]
    if gaps:
        # Under swps3's affine gaps the whole query aligns to the entry's
        # tail, its diagonal self-score, walked back to its first residue.
        walk = query[::-1]
        assert row == f"long,{L},{self_score('blosum50', query)},{L},1,{walk},{walk}"
    else:
        name, length, score, pos_end, pos_pred, cx, cy = row.split(",")
        assert (name, int(length), int(pos_end)) == ("long", L, L)
        # The entry ends with the query: the walk goes back along it, reversed.
        assert cx == cy and len(cx) >= len(query) - 2 and query[::-1].startswith(cx)


def test_cpu_tensors_take_plain_route_without_launches():
    for fn in COUNTERS:
        fn.launches = 0
    rng = np.random.default_rng(0)
    ref = "".join(rng.choice(list("ACGT"), 600))
    reads = [ref[s : s + 50] for s in (10, 200, 400)]
    BatchSWAligner(device="cpu").align_batch(reads, [ref])
    ChunkedAligner(device="cpu").align_batch(reads, ref)
    engine.CudaEngine(device="cpu").score_batch_moves(
        np.frombuffer(reads[0].encode(), np.uint8).copy()[None],
        np.frombuffer(ref.encode(), np.uint8).copy()[None], [50], [600],
    )
    # The protein path: the resident scan (K4's route), the matrix
    # traceback (K5 then K3) and the per-lane K4 route.
    proteins = ["".join(rng.choice(list(ALPHABET[:20]), k)) for k in (40, 90, 130)]
    db = ResidentProteinDB([(str(k), p) for k, p in enumerate(proteins)],
                           gap_penalty=12.0, gap_open=0.0, device="cpu")
    db.scan(proteins[1][10:60])
    cfg = blosum_config("blosum50", gap_penalty=12.0)
    BatchSWAligner(cfg, pad_m=128, device="cpu").align_batch(proteins, [proteins[1][10:60]])
    BatchSWAligner(cfg, device="cpu").align_batch(proteins, [proteins[2]], traceback=False)
    # The affine forms: the window sweep and winner re-run (K6, K7, K10),
    # the resident scan (K8) and the matrix traceback (K9, K10).
    ChunkedAligner(AFFINE["uniform"], device="cpu").align_batch(reads, ref)
    ResidentProteinDB([(str(k), p) for k, p in enumerate(proteins)], device="cpu").scan(
        proteins[1][10:60])
    BatchSWAligner(AFFINE["matrix"], pad_m=128, device="cpu").align_batch(
        proteins, [proteins[1][10:60]])
    # The long-read path, on one read past MAX_M against a 40-bp reference
    # (the strips run on the rows; the route does not depend on the width):
    # the strip sweep (K11) and the strip traceback (K12, K13, K14), their
    # affine forms (K15; K16, K17, K18), their substitution-matrix forms
    # (K19; K20, K21, K14) and those under affine gaps (K22; K23, K24, K18).
    long_ref = "".join(rng.choice(list("ACGT"), 2400))
    long_read, short_ref = long_ref[100:2200], long_ref[:40]
    for scoring in (ScoringConfig(), AFFINE["uniform"], cfg, AFFINE["matrix"]):
        for tb in (True, False):
            BatchSWAligner(scoring, device="cpu").align_batch([long_read], [short_ref],
                                                              traceback=tb)
    # K19's and K22's slab forms, on a long query.
    for gaps in (dict(gap_penalty=12.0, gap_open=0.0), {}):
        ResidentProteinDB([(str(k), p) for k, p in enumerate(proteins)], max_query_len=2100,
                          device="cpu", **gaps).scan(long_read)
    # The reference-parity forms: K26 (the window sweep, the skewed and the
    # saturating re-runs with moves, the skewed argmax) and K27 (a long read).
    sat = ScoringConfig(semantics=Semantics.SAT_UINT8)
    ChunkedAligner(sat, device="cpu").align_batch(reads, ref)
    BatchSWAligner(sat, tie="skewed", device="cpu").align_batch(reads, [ref])
    BatchSWAligner(tie="skewed", device="cpu").align_batch(reads, [ref], traceback=False)
    BatchSWAligner(sat, device="cpu").align_batch([long_read], [short_ref], traceback=False)
    assert [fn.launches for fn in COUNTERS] == [0] * len(COUNTERS)


def test_cuda_default_without_card_raises(monkeypatch):
    """No silent drop to the CPU: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchSWAligner()
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")


def test_affine_without_card_raises(monkeypatch):
    """An affine config takes the card by default and raises without one;
    a tensor on neither the CPU nor a card raises in every affine wrapper
    rather than taking the plain route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in AFFINE.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.make_score_engine(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ChunkedAligner(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResidentProteinDB([("a", "MKWVTFISLL")])
    meta = lambda *shape, dtype=torch.uint8: torch.empty(shape, dtype=dtype, device="meta")
    xs, ys, m = meta(2, 8), meta(2, 16), meta(2, dtype=torch.int32)
    table = meta(25, 25, dtype=torch.int32)
    calls = [
        lambda: wavefront_cuda.sw_score_affine(xs, ys, m, m, match=1, mismatch=-4, gap_open=6, gap=1),
        lambda: wavefront_cuda.sw_score_affine_moves(xs, ys, m, m, match=1, mismatch=-4,
                                                     gap_open=6, gap=1),
        lambda: profile_cuda.sw_profile_affine(xs, ys, m, m, table=table, gap_open=10, gap=2),
        lambda: profile_cuda.sw_profile_affine_moves(xs, ys, m, m, table=table, gap_open=10, gap=2),
        lambda: traceback.walk_moves_affine(meta(23, 8, 2), xs.T, ys, m, m, max_steps=9),
        lambda: strips_cuda.sw_score_strips_affine(xs, ys, m, m, match=1, mismatch=-4,
                                                   gap_open=6, gap=1),
        lambda: strips_cuda.sw_score_strips_affine_ckpt(xs, ys, m, m, match=1, mismatch=-4,
                                                        gap_open=6, gap=1),
        lambda: strips_cuda.strip_affine_moves(xs, ys, m, m, None, None, 0, match=1,
                                               mismatch=-4, gap_open=6, gap=1),
        lambda: traceback.walk_strip_level_affine(
            meta(2, 16, 256), xs.T, ys, 0, (m, m, m, meta(2, dtype=torch.bool), m,
                                            meta(9, 2), meta(9, 2), m), max_steps=9),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    cpu = (torch.zeros((2, 8), dtype=torch.uint8), torch.zeros((2, 16), dtype=torch.uint8),
           torch.ones(2, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
    for affine in (wavefront_cuda.sw_score_affine, strips_cuda.sw_score_strips_affine,
                   strips_cuda.sw_score_strips_affine_ckpt):
        with pytest.raises(ValueError, match="gap_open"):
            affine(*cpu, match=1, mismatch=-4, gap_open=0, gap=1)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Asking for the kernels where nvcc is absent raises; nothing falls
    back to the plain route."""
    monkeypatch.setenv("NVCC", str(tmp_path / "missing" / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.build()
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.load()
    assert not (tmp_path / "build" / _build.LIB_NAME).exists()


def test_build_command_targets_hopper(monkeypatch, tmp_path):
    """The build compiles each csrc/*.cu for sm_90a in its own nvcc process,
    links the objects into one shared library in the build dir, and a
    compiler or linker failure raises with its message."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\necho \"$@\" >> \"$(dirname \"$0\")/args\"\n"
        "for a in \"$@\"; do [ \"$a\" = -c ] && exec echo compiled; done\n"
        "echo 'error: refused' >&2\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("NVCC", str(nvcc))
    with pytest.raises(RuntimeError, match="refused"):
        _build.build(tmp_path / "build")
    calls = [line.split() for line in (tmp_path / "args").read_text().splitlines()]
    compiles, links = [c for c in calls if "-c" in c], [c for c in calls if "-c" not in c]
    assert [Path(c[-1]).name for c in sorted(compiles, key=lambda c: c[-1])] == \
        ["global_dp.cu", "profile.cu", "strips.cu", "traceback.cu", "wavefront.cu",
         "wavefront_parity.cu"]
    assert len(links) == 1 and "-shared" in links[0]
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert "compiled" in (tmp_path / "build" / "nvcc.log").read_text()
    assert not list((tmp_path / "build").glob("*.o"))


def test_profile_tool_runs_on_the_plain_route(tmp_path, capsys):
    """The profiling tool's phases run end to end at a small size on CPU
    tensors (where it reports no device time)."""
    from parallel_genomeseq_tpu_torch.tools import profile_main

    assert profile_main.main([
        "--device", "cpu", "--reads", "8", "--read-len", "30", "--ref-len", "400",
        "--batch-size", "4", "--sweep", "8", "--out-dir", str(tmp_path),
    ]) == 0
    out = capsys.readouterr().out
    assert '"device_busy_s": null' in out and "batch 8:" in out
    assert (tmp_path / "align_output.csv").exists()


def test_profile_tool_runs_the_affine_paths_on_the_plain_route(tmp_path, capsys):
    """--affine: BWA-MEM's scoring on the short reads, gap 10/2 on the
    protein scan; both runs write their CSV."""
    from parallel_genomeseq_tpu_torch.tools import profile_main

    for workload, size in (("small", ["--reads", "8", "--read-len", "30", "--ref-len", "400",
                                      "--sweep", ""]),
                           ("uniprot", ["--entries", "5", "--query-len", "12"])):
        assert profile_main.main(["--workload", workload, "--affine", "--device", "cpu",
                                  "--batch-size", "8", "--out-dir", str(tmp_path)] + size) == 0
        assert f'"workload": "{workload}", "affine": true' in capsys.readouterr().out
    assert (tmp_path / "align_output.csv").exists() and (tmp_path / "uniprot_output.csv").exists()


def test_profile_tool_runs_the_long_read_workload_on_the_plain_route(tmp_path, capsys):
    """--workload big: solve_big 7 1 on generated data (14 windows), here at
    a size the plain route runs in seconds."""
    from parallel_genomeseq_tpu_torch.tools import profile_main

    assert profile_main.main([
        "--workload", "big", "--device", "cpu", "--reads", "2", "--read-len", "30",
        "--ref-len", "2000", "--out-dir", str(tmp_path),
    ]) == 0
    out = capsys.readouterr().out
    assert '"workload": "big"' in out and '"device_busy_s": null' in out
    assert out.count("big batch 128:") == 3 and "swept GCUPS" in out
    assert len((tmp_path / "big" / "reads.csv").read_text().splitlines()) == 3


def test_profile_tool_runs_the_affine_long_read_workload_on_the_plain_route(tmp_path, capsys):
    """--workload big --affine --traceback: solve_big 7 1 under BWA-MEM's
    scoring with the winners' affine strip traceback, at a size the plain
    route runs in seconds."""
    from parallel_genomeseq_tpu_torch.tools import profile_main

    assert profile_main.main([
        "--workload", "big", "--affine", "--traceback", "--device", "cpu", "--reads", "1",
        "--read-len", "30", "--ref-len", "2000", "--out-dir", str(tmp_path),
    ]) == 0
    out = capsys.readouterr().out
    assert '"workload": "big", "affine": true, "traceback": true' in out
    assert out.count("big batch 128:") == 3


def test_profile_tool_runs_the_protein_path_on_the_plain_route(tmp_path, capsys):
    from parallel_genomeseq_tpu_torch.tools import profile_main

    assert profile_main.main([
        "--workload", "uniprot", "--device", "cpu", "--entries", "5",
        "--query-len", "12", "--batch-size", "8", "--out-dir", str(tmp_path),
    ]) == 0
    out = capsys.readouterr().out
    assert '"workload": "uniprot"' in out and '"device_busy_s": null' in out
    assert out.count("uniprot batch 8: scan") == 3
    assert len((tmp_path / "uniprot_output.csv").read_text().splitlines()) == 6


def test_wrappers_validate_inputs():
    xs = torch.zeros((2, 8), dtype=torch.uint8)
    ys = torch.zeros((2, 16), dtype=torch.uint8)
    m = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        wavefront_cuda.sw_score(xs, ys, m, m.long(), match=3, mismatch=-3, gap=2)
    with pytest.raises(ValueError):
        wavefront_cuda.sw_score(xs, ys[:1], m, m, match=3, mismatch=-3, gap=2)
