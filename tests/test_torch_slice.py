"""The short-read slice end to end: the port (plain route, CPU) against the
JAX package on the same generated reads -- ChunkedAligner and
BatchSWAligner results field by field, and solve_small's align_output.csv
byte for byte, with linear gaps, with BWA-MEM's affine scoring (match 1,
mismatch -4, gap open 6, extend 1) and under BLOSUM50 (``--matrix``)."""

import csv

import pytest
import torch

from parallel_genomeseq_tpu.cli import solve_small as jax_cli
from parallel_genomeseq_tpu.models.swaligner import BatchSWAligner as JaxBatch
from parallel_genomeseq_tpu.parallel.chunking import ChunkedAligner as JaxChunked
from parallel_genomeseq_tpu.seqio.readers import read_fasta
from parallel_genomeseq_tpu.utils.config import ChunkConfig as JaxChunkConfig
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxScoringConfig
from parallel_genomeseq_tpu_torch.cli import solve_small as port_cli
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkedAligner
from parallel_genomeseq_tpu_torch.utils.config import ChunkConfig, ScoringConfig
from parallel_genomeseq_tpu_torch.utils.synth import write_dataset

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

FIELDS = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")
BWA = dict(match=1.0, mismatch=-4.0, gap_open=6.0, gap_penalty=1.0)
BWA_FLAGS = ["--match", "1", "--mismatch", "-4", "--gap-open", "6", "--gap-penalty", "1"]
# solve_small --matrix: BLOSUM50 scores the DNA letters (A, C, G and T are
# amino-acid codes too), with the default gap 2 or swps3's affine 10/2.
BLOSUM_FLAGS = ["--matrix", "blosum50"]
SWPS3_GAPS = ["--gap-open", "10", "--gap-penalty", "2"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 1.5-kb reference and 48 reads of 100-125 bp with substitutions and
    1-3 bp indels."""
    ref_path, csv_path = write_dataset(
        tmp_path_factory.mktemp("slice"), ref_len=1500, n_reads=48,
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


def batches(reads, size=16):
    return [reads[k : k + size] for k in range(0, len(reads), size)]


@pytest.mark.parametrize("npiece", [17, 4])
def test_chunked_aligner_matches_jax(dataset, npiece):
    _, _, ref, reads = dataset
    want = [r for b in JaxChunked(chunk=JaxChunkConfig(npiece=npiece, overlap_ratio=2.0),
                                  score_engine="pallas")
            .align_stream(batches(reads), ref) for r in b]
    port = ChunkedAligner(chunk=ChunkConfig(npiece=npiece, overlap_ratio=2.0), device="cpu")
    got = [r for b in port.align_stream(batches(reads), ref) for r in b]
    assert_same(got, want)
    assert_same(port.align_batch(reads[:5], ref), want[:5])


def test_affine_aligners_match_jax(dataset):
    """BWA-MEM's affine scoring through both aligners: the JAX side's Pallas
    B5 window sweep and B6 re-run (interpret mode), the port's plain K6, K7
    and affine walk; the config carried across as the port's own."""
    _, _, ref, reads = dataset
    jcfg, cfg = JaxScoringConfig(**BWA), ScoringConfig(**BWA)
    want = [r for b in JaxChunked(cfg=jcfg, chunk=JaxChunkConfig(npiece=17, overlap_ratio=2.0),
                                  score_engine="pallas")
            .align_stream(batches(reads[:32]), ref) for r in b]
    port = ChunkedAligner(cfg=cfg, chunk=ChunkConfig(npiece=17, overlap_ratio=2.0), device="cpu")
    assert_same([r for b in port.align_stream(batches(reads[:32]), ref) for r in b], want)
    want = JaxBatch(jcfg, score_engine="pallas").align_batch(reads[:12], [ref])
    assert_same(BatchSWAligner(cfg, device="cpu").align_batch(reads[:12], [ref]), want)
    assert any("-" in r.consensus_x + r.consensus_y for r in want)


def test_batch_aligner_matches_jax(dataset):
    """--npiece 1: every read against the whole reference, traceback fused
    in the Pallas moves kernel on the JAX side."""
    _, _, ref, reads = dataset
    want = JaxBatch(score_engine="pallas").align_batch(reads[:24], [ref])
    got = BatchSWAligner(device="cpu").align_batch(reads[:24], [ref])
    assert_same(got, want)
    no_tb = BatchSWAligner(device="cpu").align_batch(reads[:4], [ref], traceback=False)
    assert [(r.score, r.max_i, r.max_j) for r in no_tb] == \
        [(r.score, r.max_i, r.max_j) for r in want[:4]]


@pytest.mark.parametrize("extra", [
    ["--npiece", "17"],
    ["--npiece", "1", "--eval"],
    ["--npiece", "4", "--both-strands", "--limit", "20"],
    BWA_FLAGS + ["--npiece", "17"],
    BWA_FLAGS + ["--npiece", "1", "--eval"],
    BWA_FLAGS + ["--npiece", "17", "--both-strands", "--limit", "20"],
    BLOSUM_FLAGS + ["--npiece", "17", "--limit", "16"],
    BLOSUM_FLAGS + ["--npiece", "1", "--eval", "--limit", "16"],
    BLOSUM_FLAGS + SWPS3_GAPS + ["--npiece", "17", "--limit", "16"],
    BLOSUM_FLAGS + SWPS3_GAPS + ["--npiece", "1", "--eval", "--limit", "16"],
], ids=["npiece17", "npiece1-eval", "both-strands-limit", "bwa-npiece17", "bwa-npiece1-eval",
        "bwa-both-strands", "blosum-npiece17", "blosum-npiece1-eval", "blosum-affine-npiece17",
        "blosum-affine-npiece1-eval"])
def test_solve_small_csv_byte_identical(dataset, tmp_path, capsys, extra):
    ref_path, csv_path, _, _ = dataset
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size", "16"] + extra
    jax_out, port_out = tmp_path / "jax.csv", tmp_path / "port.csv"
    rc_jax = jax_cli.main(base + ["--platform", "cpu", "--output", str(jax_out)])
    rc_port = port_cli.main(base + ["--device", "cpu", "--output", str(port_out)])
    assert rc_port == rc_jax
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert "Aligned" in capsys.readouterr().out

