"""Where the time goes in the port's main paths.

    python -m parallel_genomeseq_tpu_torch.tools.profile_main \\
        [--workload small|uniprot|big] [--seed 0] [--reads 5120] [--read-len 125]
        [--batch-size 512] [--sweep 128,1024,2048] [--entries 561356]
        [--query-len 145] [--affine] [--traceback]

``--workload small`` (default): ``solve_small`` on the data set of
``chip_smoke.py`` (a seeded 4,980-bp reference and 125-bp reads with
substitutions and small indels, written under ``data/profile/``).
``--workload uniprot``: ``solve_uniprot`` with the ``uniprot_e2e`` settings
(BLOSUM50, gap 12, batch 4,096, top 10) on ``chip_smoke.py``'s protein data
(``--entries`` generated entries with mutated copies of a seeded 145-aa
query planted in them: 9 at the default size); ``--query-len`` over 2,048
(for example 4,096, a titin-class query) scans with the profile strip
kernel K19 and walks the planted full-length copies in strips (K20, K21,
K14). ``--affine`` runs both with affine (Gotoh) gaps: BWA-MEM's scoring
for small (``--match 1 --mismatch -4 --gap-open 6 --gap-penalty 1``),
swps3's 10/2 for uniprot (``--gap-open 10 --gap-penalty 2``; a long query
then scans with K22 and walks with K23, K24 and K18), as ``chip_smoke.py``
does.
``--workload big``: ``solve_big 7 1`` at its default width on
``chip_smoke.py``'s long-read data (a 30,000-bp reference from seed 0, 100
exact 10,000-bp substrings of it, 14 windows; written under
``data/profile/big/``); ``--traceback`` adds the winners' strip traceback,
and ``--affine`` runs it under BWA-MEM's scoring (the affine strip kernels).

After one warm-up run:

1. three timed runs (the CLI's own timer; for uniprot the scan's seconds
   and the whole run's wall seconds);
2. one run under ``torch.profiler``: device time by kernel, then a JSON line
   with the run's wall time, the device's busy time (the sum of the self
   time of every event on the device) and its idle share;
3. one run under ``cProfile``: host time by function, cumulative and self;
4. (small only) one timed run at each batch size of ``--sweep``.

``--device cpu`` runs the same phases on the plain route, at a small size
(for big: ``--ref-len``, ``--read-len`` and ``--reads`` set it), to check
the tool itself; it then reports no device time.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import pstats
import subprocess
import time
from pathlib import Path

import torch

from ..cli import solve_big, solve_small, solve_uniprot
from ..seqio.datagen import gen_reads_custom, gen_ref_custom
from ..utils.device import resolve_device
from ..utils.synth import write_dataset, write_protein_dataset

ROOT = Path(__file__).resolve().parents[2]


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device itself off the card."""
    if dev.type != "cuda":
        return str(dev)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def quiet_run(cli_module, argv):
    """One CLI run with its report lines swallowed: (its Run, wall s)."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = cli_module.run(argv)
    if out.rc != 0:
        raise RuntimeError(f"{cli_module.__name__} exited {out.rc}")
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=["small", "uniprot", "big"], default="small")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=None,
                    help="default 5120 (small) or 100 (big)")
    ap.add_argument("--ref-len", type=int, default=None,
                    help="default 4980 (small) or 30000 (big)")
    ap.add_argument("--read-len", type=int, default=None,
                    help="default 125 (small) or 10000 (big)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="default 512 (small), 4096 (uniprot) or 128 (big)")
    ap.add_argument("--sweep", default="128,1024,2048",
                    help="comma-separated batch sizes for phase 4 ('' for none)")
    ap.add_argument("--entries", type=int, default=561_356)
    ap.add_argument("--query-len", type=int, default=145)
    ap.add_argument("--affine", action="store_true",
                    help="affine gaps: BWA-MEM's scoring (small, big), gap 10/2 (uniprot)")
    ap.add_argument("--traceback", action="store_true",
                    help="big: include the winners' strip traceback")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out-dir", default=str(ROOT / "data" / "profile"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(card_line(dev))
    out_dir = Path(args.out_dir)
    bwa = ["--match", "1", "--mismatch", "-4", "--gap-open", "6", "--gap-penalty", "1"]
    if args.workload == "small":
        batch = args.batch_size or 512
        read_len = args.read_len or 125
        ref, reads = write_dataset(out_dir, ref_len=args.ref_len or 4980,
                                   n_reads=args.reads or 5120, read_len=(read_len, read_len),
                                   seed=args.seed)
        cli_module = solve_small
        gaps = bwa if args.affine else []

        def cli(b):
            return ["--ref", str(ref), "--input", str(reads), "--output",
                    str(out_dir / "align_output.csv"), "--batch-size", str(b),
                    "--device", str(dev)] + gaps

        def timing(out, wall):
            return f"{out.seconds:.6f} s, {len(out.results) / out.seconds:.1f} reads/s"
    elif args.workload == "big":
        batch = args.batch_size or 128  # solve_big's default: one batch of 100
        big = out_dir / "big"
        big.mkdir(parents=True, exist_ok=True)
        ref_seq = gen_ref_custom(big / "ref.fa", ref_len=args.ref_len or 30_000, seed=args.seed)
        gen_reads_custom(ref_seq, big / "reads.csv", n_reads=args.reads or 100,
                         read_len=args.read_len or 10_000)
        cli_module = solve_big

        def cli(b):
            return ["7", "1", "--ref", str(big / "ref.fa"), "--reads", str(big / "reads.csv"),
                    "--batch-size", str(b), "--device", str(dev)] + (
                        ["--traceback"] if args.traceback else []) + (bwa if args.affine else [])

        def timing(out, wall):
            return (f"{sum(out.seconds):.6f} s, {sum(out.swept_cells) / sum(out.seconds) / 1e9:.3f} "
                    f"swept GCUPS, {out.gcups[0]:.3f} GCUPS (first batch), run {wall:.6f} s")
    else:
        batch = args.batch_size or 4096
        query, db, _ = write_protein_dataset(out_dir / "protein", n_entries=args.entries,
                                             query_len=args.query_len, seed=7)
        cli_module = solve_uniprot

        gaps = (["--gap-open", "10", "--gap-penalty", "2"] if args.affine
                else ["--gap-penalty", "12"])

        def cli(b):
            return ["--query", str(query), "--database", str(db), "--output",
                    str(out_dir / "uniprot_output.csv"), "--matrix", "blosum50",
                    "--batch-size", str(b), "--top", "10", "--device", str(dev)] + gaps

        def timing(out, wall):
            scan = out.scans[0]
            return (f"scan {scan['seconds']:.6f} s ({scan['cells'] / scan['seconds'] / 1e9:.3f} "
                    f"GCUPS), pack+upload {out.prep_seconds:.6f} s, run {wall:.6f} s")

    base = cli(batch)
    quiet_run(cli_module, base)  # warm-up: kernel build and first launches
    for _ in range(3):
        print(f"{args.workload} batch {batch}: {timing(*quiet_run(cli_module, base))}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _, wall = quiet_run(cli_module, base)
    if dev.type == "cuda":  # on the CPU there is no device time to read
        events = prof.key_averages()
        print(events.table(sort_by="self_device_time_total", row_limit=15))
        # Only the device's own events (kernels, copies, sets): a host op
        # such as aten::copy_ also carries the device time of what it
        # launched, and counting it too would count that time twice.
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA) / 1e6
        idle = 1 - busy / wall
    else:
        busy = idle = None
    print(json.dumps({"workload": args.workload, "affine": args.affine,
                      "traceback": args.traceback, "batch": batch,
                      "wall_s": wall,
                      "device_busy_s": busy, "idle_share": idle}))

    pr = cProfile.Profile()
    pr.enable()
    quiet_run(cli_module, base)
    pr.disable()
    for key, rows in (("cumulative", 35), ("tottime", 20)):
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats(key).print_stats(rows)
        print(s.getvalue())

    if args.workload == "small":
        for b in (int(v) for v in args.sweep.split(",") if v):
            quiet_run(cli_module, cli(b))  # warm-up at this batch's shapes
            print(f"batch {b}: {timing(*quiet_run(cli_module, cli(b)))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
