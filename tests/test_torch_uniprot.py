"""The protein database scan end to end: the port's ``solve_uniprot``
(plain route, CPU) against the JAX package's on the same generated query and
database -- ``uniprot_output.csv`` byte for byte, for the default flags and
each ported option. The database holds entries of 60-600 aa, some of
513-600 aa, so the JAX side walks on both of its traceback routes' shapes,
and 8 mutated copies of the query. The affine runs take swps3's BLOSUM50
10/2 gaps (``--gap-open 10 --gap-penalty 2``)."""

import pytest
import torch

from parallel_genomeseq_tpu.cli import solve_uniprot as jax_cli
from parallel_genomeseq_tpu_torch.cli import solve_uniprot as port_cli
from parallel_genomeseq_tpu_torch.utils.synth import write_protein_dataset

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 60-aa query and 40 entries, and a second 40-aa query."""
    d = tmp_path_factory.mktemp("uniprot")
    query, db, q = write_protein_dataset(d, n_entries=40, query_len=60, seed=3, max_len=600)
    q2 = d / "second.fasta"
    q2.write_text(">second\n" + q[25:] + "MKWVTFISLL\n")
    return query, db, q2


def run_both(tmp_path, capsys, argv, outs=("out.csv",)):
    """Run both CLIs on ``argv`` (``{d}`` = the side's own directory) and
    return ({file: bytes} for the JAX side, the same for the port, the
    port's stdout, the JAX side's stdout)."""
    got = {}
    for side, main, flag in (("jax", jax_cli.main, ["--platform", "cpu"]),
                             ("port", port_cli.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        assert main([a.format(d=d) for a in argv] + flag) == 0
        got[side] = ({o: (d / o).read_bytes() for o in outs}, capsys.readouterr().out)
    return got["jax"], got["port"]


def top_hits(stdout: str):
    lines = stdout.splitlines()
    at = lines.index("top hits:")
    return lines[at : lines.index(next(l for l in lines[at:] if l.startswith("Done")))]


AFFINE = ["--gap-open", "10", "--gap-penalty", "2"]


@pytest.mark.parametrize("extra, walked", [
    ([], 10),
    (["--matrix", "blosum62", "--top", "4"], 4),
    (["--matrix", "uniform", "--traceback-top", "3"], 3),
    (["--traceback-all"], 40),
    (AFFINE, 10),
    (AFFINE + ["--traceback-all"], 40),
    (["--matrix", "uniform", "--gap-open", "4", "--gap-penalty", "1", "--traceback-top", "3"], 3),
], ids=["default", "blosum62", "uniform", "traceback-all", "affine", "affine-traceback-all",
        "affine-uniform"])
def test_solve_uniprot_csv_byte_identical(dataset, tmp_path, capsys, extra, walked):
    query, db, _ = dataset
    argv = ["--query", str(query), "--database", str(db), "--output", "{d}/out.csv",
            "--batch-size", "16"] + extra
    (jax_files, jax_out), (port_files, port_out) = run_both(tmp_path, capsys, argv)
    assert port_files == jax_files
    assert top_hits(port_out) == top_hits(jax_out)
    rows = port_files["out.csv"].decode().splitlines()[1:]
    assert len(rows) == 40 and sum(not r.endswith(",,") for r in rows) == walked


def test_solve_uniprot_two_queries(dataset, tmp_path, capsys):
    """Two queries over one resident slab: one CSV per query."""
    query, db, q2 = dataset
    argv = ["--query", f"{query},{q2}", "--database", str(db), "--output",
            "{d}/out.csv", "--limit", "30", "--top", "5"]
    (jax_files, _), (port_files, port_out) = run_both(
        tmp_path, capsys, argv, outs=("out.csv.query", "out.csv.second"))
    assert port_files == jax_files
    assert "query 2/2: second" in port_out and "one shared resident DB" in port_out


def test_solve_uniprot_checkpoint_resume(dataset, tmp_path, capsys):
    """A run cut short after 25 proteins, then resumed from its checkpoint:
    the same checkpoint file and the same final CSV as the JAX package."""
    check_resume(dataset, tmp_path, capsys, [])


def test_solve_uniprot_checkpoint_resume_affine(dataset, tmp_path, capsys):
    check_resume(dataset, tmp_path, capsys, AFFINE)


def check_resume(dataset, tmp_path, capsys, gaps):
    query, db, _ = dataset
    base = ["--query", str(query), "--database", str(db), "--checkpoint",
            "{d}/ckpt", "--batch-size", "8"] + gaps
    (jax_files, _), (port_files, _) = run_both(
        tmp_path, capsys, base + ["--limit", "25", "--output", "{d}/part.csv"],
        outs=("part.csv", "ckpt"))
    assert port_files == jax_files
    (jax_files, _), (port_files, port_out) = run_both(
        tmp_path, capsys, base + ["--resume", "--output", "{d}/out.csv"],
        outs=("out.csv", "ckpt"))
    assert port_files == jax_files
    assert "resume: 25 proteins restored" in port_out
    assert len(port_files["ckpt"].decode().splitlines()) == 40
