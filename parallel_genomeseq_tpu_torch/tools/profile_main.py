"""Where the time goes in the port's ``solve_small`` main path.

    python -m parallel_genomeseq_tpu_torch.tools.profile_main \\
        [--seed 0] [--reads 5120] [--read-len 125] [--batch-size 512] \\
        [--sweep 128,1024,2048]

On the data set of ``chip_smoke.py`` (a seeded 4,980-bp reference and
125-bp reads with substitutions and small indels, written under
``data/profile/`` of the checkout), after one warm-up run:

1. three timed runs (``solve_small``'s own timer);
2. one run under ``torch.profiler``: device time by kernel, then a JSON line
   with the run's wall time, the device's busy time (the sum of the self
   time of every event on the device) and its idle share;
3. one run under ``cProfile``: host time by function, cumulative and self;
4. one timed run at each batch size of ``--sweep``.

``--device cpu`` runs the same phases on the plain route, at a small
``--reads`` and ``--read-len``, to check the tool itself; it then reports
no device time.
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

from ..cli import solve_small
from ..utils.device import resolve_device
from ..utils.synth import write_dataset

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


def quiet_run(cli):
    """One solve_small run with its progress lines swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        out = solve_small.run(cli)
    if out.rc != 0:
        raise RuntimeError(f"solve_small exited {out.rc}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=5120)
    ap.add_argument("--ref-len", type=int, default=4980)
    ap.add_argument("--read-len", type=int, default=125)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--sweep", default="128,1024,2048",
                    help="comma-separated batch sizes for phase 4 ('' for none)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out-dir", default=str(ROOT / "data" / "profile"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(card_line(dev))
    out_dir = Path(args.out_dir)
    ref, reads = write_dataset(out_dir, ref_len=args.ref_len, n_reads=args.reads,
                               read_len=(args.read_len, args.read_len), seed=args.seed)

    def cli(batch):
        return ["--ref", str(ref), "--input", str(reads), "--output",
                str(out_dir / "align_output.csv"), "--batch-size", str(batch),
                "--device", str(dev)]

    base = cli(args.batch_size)
    quiet_run(base)  # warm-up: kernel build and first launches
    timed = [quiet_run(base).seconds for _ in range(3)]
    print(f"batch {args.batch_size}: solve_small seconds {timed}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        quiet_run(base)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    if dev.type == "cuda":
        print(events.table(sort_by="self_device_time_total", row_limit=15))
        # Only the device's own events (kernels, copies, sets): a host op
        # such as aten::copy_ also carries the device time of what it
        # launched, and counting it too would count that time twice.
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA) / 1e6
        idle = 1 - busy / wall
    else:
        busy = idle = None
    print(json.dumps({"batch": args.batch_size, "wall_s": wall,
                      "device_busy_s": busy, "idle_share": idle}))

    pr = cProfile.Profile()
    pr.enable()
    quiet_run(base)
    pr.disable()
    for key, rows in (("cumulative", 35), ("tottime", 20)):
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats(key).print_stats(rows)
        print(s.getvalue())

    for batch in (int(b) for b in args.sweep.split(",") if b):
        quiet_run(cli(batch))  # warm-up at this batch's shapes
        out = quiet_run(cli(batch))
        print(f"batch {batch}: {out.seconds:.6f} s, {len(out.results) / out.seconds:.1f} reads/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
