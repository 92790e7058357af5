"""evaluate: accuracy parity and timing plots (the port of the JAX package's
``cli/evaluate.py``, the reference's py/eval.py; the same options, flags and
output):

- ``--option sw_solve_small``: join align_output.csv with its ground truth
  and report the rows where pos_pred != POS.
- ``--option ompfg``: plot a timing CSV (solve_batch's schema) as absolute
  or normalized time, speedup or GCUPS over the lane count, box or scatter,
  optionally with a quadratic fit or the harmonic mean per lane count, to a
  PNG. matplotlib and pandas are imported here only, as in the JAX CLI.
- ``--option compare``: row-by-row comparison of two align_output files
  (e.g. a ``solve_small --parity-mode skewed`` run against the reference
  binary's), counting identical pos_pred and score; exits 1 unless all
  agree.

A host-only tool: it imports no kernel.

Usage:
    python -m parallel_genomeseq_tpu_torch.cli.evaluate --option sw_solve_small \
        --align-file data/align_output.csv
"""

from __future__ import annotations

import argparse
import csv
import sys

from ..seqio.evaluate import check_parity
from . import common


def _ompfg(args):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    import pandas as pd

    df = pd.read_csv(args.timing_file)
    t_key = "avg_t_adread"
    x = df["n_lanes"].values
    if args.yaxis == "abs_time":
        df["y"] = df[t_key] / 1e6
        ylabel = "Abs Construction Time (s)"
    elif args.yaxis == "normed_time":
        base = df[df["n_lanes"] == df["n_lanes"].min()][t_key].mean()
        df["y"] = df[t_key] / base
        ylabel = "Normalized Construction Time"
    elif args.yaxis == "speedup":
        base = df[df["n_lanes"] == df["n_lanes"].min()][t_key].mean()
        df["y"] = base / df[t_key]
        ylabel = "Speedup"
    else:  # gcups
        df["y"] = args.cells_per_read / (df[t_key] / 1e6) / 1e9
        ylabel = "GCUPS"

    fig, ax = plt.subplots()
    if args.plot_type == "scatter":
        ax.scatter(np.log2(x), df["y"], s=10.0)
    else:
        ux = np.unique(x)
        data = [df[df["n_lanes"] == v]["y"].values for v in ux]
        ax.boxplot(x=data, positions=np.log2(ux), widths=0.15, showfliers=False)
    if args.fit == "poly":
        # Quadratic least-squares fit in log2(lanes), the reference's
        # curve_fit(poly_fit) overlay.
        w = np.polyfit(np.log2(x), df["y"].values, 2)
        x_fit = np.linspace(np.log2(x.min()), np.log2(x.max()), 1000)
        ax.plot(x_fit, np.polyval(w, x_fit), linewidth=1.0, color="red",
                label="Quadratic fit")
        ax.legend(loc="upper left", fontsize=12)
    elif args.fit == "hmean":
        # Harmonic mean of y per lane count: the average of rates measured
        # over equal work.
        ux = np.unique(x)
        y_h = np.array(
            [1.0 / np.mean(1.0 / df[df["n_lanes"] == v]["y"].values) for v in ux]
        )
        ax.plot(np.log2(ux), y_h, linewidth=1.0, color="red", label="Harmonic mean")
        ax.legend(loc="upper left", fontsize=12)
        ax.scatter(np.log2(x), df["y"], s=5.0, color="black", marker="o")
    ax.minorticks_on()
    ax.grid(which="major", linestyle="-", linewidth=0.5)
    ax.grid(which="minor", linestyle=":", linewidth=0.5)
    ax.set_xlabel("log2(batch lanes)", fontsize=14)
    ax.set_ylabel(ylabel, fontsize=14)
    fig.savefig(args.plot_out, dpi=120, bbox_inches="tight")
    print(f"plot written to {args.plot_out}")
    return 0


def _compare(args):
    with open(args.align_file, newline="") as f:
        a = list(csv.DictReader(f, skipinitialspace=True))
    with open(args.compare_file, newline="") as f:
        b = list(csv.DictReader(f, skipinitialspace=True))
    n = min(len(a), len(b))
    pos_same = score_same = 0
    diffs = []
    for k in range(n):
        ps = int(a[k]["pos_pred"]) == int(b[k]["pos_pred"])
        ss = float(a[k]["score"]) == float(b[k]["score"])
        pos_same += ps
        score_same += ss
        if not (ps and ss) and len(diffs) < 10:
            diffs.append((k, a[k]["pos_pred"], b[k]["pos_pred"], a[k]["score"], b[k]["score"]))
    print(f"compared {n} rows: pos identical {pos_same}/{n}, score identical {score_same}/{n}")
    for d in diffs:
        print("  diff:", d)
    return 0 if pos_same == n and score_same == n else 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--option", default="sw_solve_small",
                   choices=["sw_solve_small", "ompfg", "compare"])
    p.add_argument("-aln", "--align-file", default=str(common.REPO_DATA / "align_output.csv"))
    p.add_argument("--compare-file", default=None, help="second align_output for --option compare")
    p.add_argument("--timing-file", default=str(common.REPO_DATA / "timing_batch.csv"))
    p.add_argument("-y", "--yaxis", default="abs_time",
                   choices=["abs_time", "normed_time", "speedup", "gcups"])
    p.add_argument("-p", "--plot-type", default="box_plot", choices=["box_plot", "scatter"])
    p.add_argument("-f", "--fit", default="false", choices=["false", "poly", "hmean"],
                   help="overlay a quadratic fit or per-lane-count harmonic mean "
                        "on the ompfg plot")
    p.add_argument("--plot-out", default=str(common.REPO_DATA / "eval_plot.png"))
    p.add_argument("--cells-per-read", type=float, default=125 * 4980,
                   help="cells per read for GCUPS conversion")
    args = p.parse_args(argv)

    if args.option == "ompfg":
        return _ompfg(args)
    if args.option == "compare":
        if not args.compare_file:
            p.error("--option compare requires --compare-file")
        return _compare(args)
    report = check_parity(args.align_file)
    print(report.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
