"""The port's host-only tools against the JAX package's: every ``gen_data``
subcommand and every ``evaluate`` option, their output files byte for
byte and their printed lines (with each run's own paths), on synthesized
FASTA, FASTQ, SAM, UniProt-style and timing files written here."""

import csv

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.cli import evaluate as jax_eval
from parallel_genomeseq_tpu.cli import gen_data as jax_gen
from parallel_genomeseq_tpu_torch.cli import evaluate, gen_data

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

RNG = np.random.default_rng(12)
ACGT = list("ACGT")
AMINO = list("ACDEFGHIKLMNPQRSTVWY")


def seq(n, letters=ACGT):
    return "".join(RNG.choice(letters, n))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A genome FASTA (lowercase and N runs, several lines), a FASTQ (a blank
    line among the records), a SAM (meta lines, a blank line, a short
    record), a SwissProt-style multi-record FASTA, a query FASTA, an
    align_output CSV pair and a timing CSV."""
    d = tmp_path_factory.mktemp("gen_inputs")
    genome = seq(400) + "NNNNN" + seq(300).lower() + "N" + seq(500)
    (d / "genome.fa").write_text(">chr\n" + "\n".join(genome[k : k + 60]
                                                      for k in range(0, len(genome), 60)) + "\n")
    fq = []
    for k in range(7):
        s = seq(int(RNG.integers(20, 40)))
        fq += [f"@read{k} extra", s, "+", "I" * len(s)]
    fq.insert(8, "")
    (d / "reads.fq").write_text("\n".join(fq) + "\n")
    sam = ["@HD\tVN:1.6", "@SQ\tSN:chr\tLN:1206"]
    for k in range(6):
        s = seq(30)
        sam.append("\t".join([f"q{k}", "0", "chr", str(100 + 7 * k), "60", "30M", "*", "0", "0",
                              s, "I" * 30]))
    sam.insert(4, "")
    sam.append("\t".join(["short", "4", "*", "0"]))
    (d / "aln.sam").write_text("\n".join(sam) + "\n")
    prot = []
    for k in range(9):
        body = seq(int(RNG.integers(30, 200)), AMINO)
        prot.append(f">sp|P{k:05d}|PROT{k} Protein {k} OS=Synth\n"
                    + "\n".join(body[i : i + 60] for i in range(0, len(body), 60)))
    (d / "sprot.fasta").write_text("\n".join(prot) + "\n")
    (d / "query.fasta").write_text(">query\n" + seq(80, AMINO) + "\n")
    rows = [{"index": k, "QNAME": f"q{k}", "SEQ": seq(20), "POS": 100 + k,
             "pos_pred": 100 + k + (k % 3 == 0), "score": 60 - (k % 4 == 0)} for k in range(12)]
    for name, tweak in (("a.csv", 0), ("b.csv", 1)):
        with open(d / name, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            for k, r in enumerate(rows):
                w.writerow({**r, "score": r["score"] + (tweak if k in (2, 7) else 0)})
    with open(d / "timing.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["n_reads", "n_lanes", "engine", "avg_t_calcscore", "avg_t_sweep",
                    "avg_t_walk", "avg_t_adread"])
        for lanes in (1, 2, 4, 8, 16):
            for rep in range(3):
                t = 1e4 / lanes ** 0.5 * (1 + 0.05 * rep)
                w.writerow([1024, lanes, "auto", t, t / 2, t / 4, t * 1.1])
    return d


def run_both(jax_main, port_main, argv_of, tmp_path, capsys):
    """Run each CLI with ``argv_of(out_dir)`` into its own directory; return
    (rc, printed lines with the directory replaced) of each, and the dirs."""
    out = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        d = tmp_path / name
        d.mkdir()
        rc = main(argv_of(d))
        text = capsys.readouterr().out.replace(str(d), "<out>")
        out.append((rc, text, d))
    return out


def same_files(a, b):
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("case", ["gen_ref_random", "gen_ref_slice", "gen_ref_keep_n",
                                  "gen_reads", "gen_gt", "mpi_prep", "uniprot_split",
                                  "uniprot_single", "gen_protein_db", "gen_protein_db_query"])
def test_gen_data_matches_jax(inputs, tmp_path, capsys, case):
    argv_of = {
        "gen_ref_random": lambda d: ["gen_ref", "--ref-len", "700", "--out", str(d / "ref.fa")],
        "gen_ref_slice": lambda d: ["gen_ref", "--source-fa", str(inputs / "genome.fa"),
                                    "--start-pos", "350", "--ref-len", "500",
                                    "--out", str(d / "ref.fa")],
        "gen_ref_keep_n": lambda d: ["gen_ref", "--source-fa", str(inputs / "genome.fa"),
                                     "--start-pos", "350", "--ref-len", "500", "--keep-n",
                                     "--out", str(d / "ref.fa")],
        "gen_reads": lambda d: ["gen_reads", "--ref", str(inputs / "genome.fa"), "--n-reads",
                                "9", "--read-len", "50", "--seed", "4",
                                "--out-csv", str(d / "reads.csv"), "--out-txt",
                                str(d / "reads.txt")],
        "gen_gt": lambda d: ["gen_gt", "--sam", str(inputs / "aln.sam"),
                             "--out", str(d / "gt.csv")],
        "mpi_prep": lambda d: ["mpi_prep", "--fastq", str(inputs / "reads.fq"),
                               "--out", str(d / "lines.txt")],
        "uniprot_split": lambda d: ["uniprot", "--sprot", str(inputs / "sprot.fasta"),
                                    "--mode", "split", "--out-dir", str(d / "u")],
        "uniprot_single": lambda d: ["uniprot", "--sprot", str(inputs / "sprot.fasta"),
                                     "--out-dir", str(d / "u")],
        "gen_protein_db": lambda d: ["gen_protein_db", "--n-entries", "40", "--max-len", "300",
                                     "--out", str(d / "db" / "database.fasta")],
        "gen_protein_db_query": lambda d: ["gen_protein_db", "--n-entries", "30", "--seed", "3",
                                           "--query", str(inputs / "query.fasta"),
                                           "--out", str(d / "db" / "database.fasta")],
    }[case]
    (rc_j, out_j, dj), (rc_p, out_p, dp) = run_both(jax_gen.main, gen_data.main, argv_of,
                                                    tmp_path, capsys)
    assert rc_p == rc_j == 0
    assert out_p == out_j and out_p.startswith(("wrote", "prepared"))
    same_files(dj, dp)


@pytest.mark.parametrize("case", ["sw_solve_small", "sw_solve_small_no_diffs", "compare_differ",
                                  "compare_same", "ompfg_box", "ompfg_scatter_poly",
                                  "ompfg_gcups_hmean", "ompfg_speedup"])
def test_evaluate_matches_jax(inputs, tmp_path, capsys, case):
    if case.startswith("ompfg"):
        pytest.importorskip("matplotlib")
        pytest.importorskip("pandas")
    same = tmp_path / "same.csv"
    with open(inputs / "a.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    with open(same, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows({**r, "POS": r["pos_pred"]} for r in rows)
    argv_of = {
        "sw_solve_small": lambda d: ["--option", "sw_solve_small", "--align-file",
                                     str(inputs / "a.csv")],
        "sw_solve_small_no_diffs": lambda d: ["-o", "sw_solve_small", "-aln", str(same)],
        "compare_differ": lambda d: ["--option", "compare", "--align-file", str(inputs / "a.csv"),
                                     "--compare-file", str(inputs / "b.csv")],
        "compare_same": lambda d: ["--option", "compare", "--align-file", str(inputs / "a.csv"),
                                   "--compare-file", str(inputs / "a.csv")],
        "ompfg_box": lambda d: ["--option", "ompfg", "--timing-file", str(inputs / "timing.csv"),
                                "--plot-out", str(d / "plot.png")],
        "ompfg_scatter_poly": lambda d: ["-o", "ompfg", "--timing-file",
                                         str(inputs / "timing.csv"), "-p", "scatter", "-f",
                                         "poly", "-y", "normed_time",
                                         "--plot-out", str(d / "plot.png")],
        "ompfg_gcups_hmean": lambda d: ["-o", "ompfg", "--timing-file",
                                        str(inputs / "timing.csv"), "-y", "gcups", "-f", "hmean",
                                        "--plot-out", str(d / "plot.png")],
        "ompfg_speedup": lambda d: ["-o", "ompfg", "--timing-file", str(inputs / "timing.csv"),
                                    "-y", "speedup", "--plot-out", str(d / "plot.png")],
    }[case]
    (rc_j, out_j, dj), (rc_p, out_p, dp) = run_both(jax_eval.main, evaluate.main, argv_of,
                                                    tmp_path, capsys)
    assert rc_p == rc_j
    assert out_p == out_j and out_p
    if case.startswith("ompfg"):
        for d in (dj, dp):
            png = (d / "plot.png").read_bytes()
            assert png.startswith(b"\x89PNG") and len(png) > 1000
    elif case == "compare_differ":
        assert rc_p == 1 and "score identical 10/12" in out_p
    elif case == "compare_same":
        assert rc_p == 0


def test_evaluate_compare_needs_second_file(inputs, capsys):
    for main in (jax_eval.main, evaluate.main):
        with pytest.raises(SystemExit) as exc:
            main(["--option", "compare", "--align-file", str(inputs / "a.csv")])
        assert exc.value.code == 2
    err = capsys.readouterr().err
    assert err.count("--option compare requires --compare-file") == 2
