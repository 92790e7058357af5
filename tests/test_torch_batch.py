"""solve_batch's timing CSV against the JAX solve_batch's, and the
``detail_timing`` split of ``BatchSWAligner`` that it times with, against the
pipelined path (plain route, CPU)."""

import csv

import pytest
import torch

from parallel_genomeseq_tpu.cli import solve_batch as jax_batch_cli
from parallel_genomeseq_tpu.seqio.readers import read_fasta
from parallel_genomeseq_tpu_torch.cli import solve_batch as port_batch_cli
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig
from parallel_genomeseq_tpu_torch.utils.synth import write_dataset

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

FIELDS = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 1.5-kb reference and 24 reads of 100-125 bp with substitutions and
    1-3 bp indels."""
    ref_path, csv_path = write_dataset(
        tmp_path_factory.mktemp("batch"), ref_len=1500, n_reads=24,
        read_len=(100, 125), seed=7,
    )
    with open(csv_path, newline="") as f:
        reads = [r["SEQ"] for r in csv.DictReader(f)]
    return ref_path, csv_path, read_fasta(ref_path), reads


def assert_same(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for f in FIELDS:
            assert getattr(g, f) == getattr(w, f), (k, f)


def test_solve_batch_timing_csv_matches_jax(dataset, tmp_path, capsys):
    """The JAX and the port's solve_batch append to one timing file: one
    header, the same n_reads and n_lanes, each run's engine value, and a
    walk column of 0 without --traceback."""
    ref_path, csv_path, _, _ = dataset
    timing = tmp_path / "timings.csv"
    base = ["20", "--ref", str(ref_path), "--reads", str(csv_path), "--batch-size", "8",
            "--timing-file", str(timing)]
    assert jax_batch_cli.main(base + ["--traceback", "--platform", "cpu", "--engine", "scan"]) == 0
    assert port_batch_cli.main(base + ["--traceback", "--device", "cpu"]) == 0
    assert port_batch_cli.main(base + ["--device", "cpu", "--engine", "plain"]) == 0
    with open(timing, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["n_reads", "n_lanes", "engine", "avg_t_calcscore", "avg_t_sweep",
                       "avg_t_walk"]
    assert [r[:3] for r in rows[1:]] == [["20", "8", "scan"], ["20", "8", "auto"],
                                         ["20", "8", "plain"]]
    assert all(float(v) > 0 for r in rows[1:3] for v in r[3:])
    assert float(rows[3][3]) > 0 and rows[3][5] == "0.0"
    out = capsys.readouterr().out
    assert out.count("timing row appended") == 3 and "GCUPS end-to-end on cpu" in out


@pytest.mark.parametrize("cfg", [ScoringConfig(), blosum_config("blosum50", gap_open=10.0)],
                         ids=["uniform", "blosum-affine"])
def test_detail_timing_matches_pipelined(dataset, cfg):
    """detail_timing's synchronous split (the score pass fetched, then the
    walk) gives the pipelined path's results, with and without traceback
    for short reads and with it for a read past 2,048 (the strip traceback),
    and times
    both levels (the walk 0 without traceback)."""
    _, _, ref, reads = dataset
    long_read = (ref * 2)[:2100]
    for batch, refs, tbs in ((reads[:6], [ref], (True, False)),
                             ([long_read], [ref[:40]], (True,))):
        for tb in tbs:
            want = BatchSWAligner(cfg, device="cpu").align_batch(batch, refs, traceback=tb)
            got = BatchSWAligner(cfg, device="cpu", detail_timing=True).align_batch(
                batch, refs, traceback=tb)
            assert_same(got, want)
            t = got[0].timings
            assert t.sweep_us > 0 and (t.walk_us > 0 if tb else t.walk_us == 0)
