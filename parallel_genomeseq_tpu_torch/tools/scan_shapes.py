"""Time the database scan K4/K8 at every (g, r) shape of its table.

    python -m parallel_genomeseq_tpu_torch.tools.scan_shapes [--entries 561356] [--reps 3]

The scan (``ops/profile_cuda.sw_profile(_affine)``) picks, for an M-row
query, the shape of ``kShapes`` (``csrc/profile.cu``) with the fewest rows
g x r >= M, and sweeps all g x r rows whatever M is. So a shape's time
hardly depends on M, and the table's density is a trade of build time
against the rows a query leaves idle. This tool measures that trade: for
each shape it times the scan at the shortest and the longest query the
shape takes (M = the previous shape's rows + 1, and g x r), under BLOSUM50
with gap 12 (K4) and with gaps 10/2 (K8), over a length-sorted slab of
``--entries`` random entries whose lengths are ``seqio/datagen.gen_protein_db``'s
(its seed-7 lognormal draw: median ~290 aa, 60-2,048), the database of
``chip_smoke.py``. Prints the card's name and power limit, one JSON line a
launch (ms: the mean of ``--reps`` launches after a warm-up, by CUDA
events; GCUPS of the true cells), then, for each shape, the time its queries
would take on the next larger shape if it were dropped.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops import profile_cuda
from ..ops.scan_dp import profile_tables
from ..ops.substitution import blosum_config

GAPS = {"linear": dict(gap=12), "affine": dict(gap_open=10, gap=2)}


def slab_lengths(n_entries: int) -> np.ndarray:
    """The entry lengths ``gen_protein_db`` draws first (seed 7), sorted."""
    rng = np.random.default_rng(7)
    lens = np.clip(rng.lognormal(mean=np.log(290.0), sigma=0.65, size=n_entries), 60, 2048)
    return np.sort(lens.astype(np.int32))


def shape_table(ncodes: int, affine: bool):
    """[(g, r, shortest M, longest M)] of the shapes the scan picks for M =
    1..MAX_SCAN_M, by rows ascending."""
    out = []
    for M in range(1, profile_cuda.MAX_SCAN_M + 1):
        sh = profile_cuda.scan_shape(M, ncodes=ncodes, affine=affine)
        if not out or (out[-1][0], out[-1][1]) != (sh["g"], sh["r"]):
            out.append([sh["g"], sh["r"], M, M])
        out[-1][3] = M
    return [tuple(s) for s in out]


def mean_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entries", type=int, default=561_356)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_shapes times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    table = torch.from_numpy(profile_tables(blosum_config("blosum50"))[1]).to(dev)
    ncodes = table.shape[0]
    lens = torch.from_numpy(slab_lengths(args.entries)).to(dev)
    offs = torch.zeros_like(lens, dtype=torch.int64)
    offs[1:] = torch.cumsum(lens.long(), 0)[:-1]
    gen = torch.Generator(device=dev).manual_seed(7)
    slab = torch.randint(1, ncodes, (int(lens.long().sum()),), generator=gen, device=dev,
                         dtype=torch.uint8)
    query = torch.randint(1, ncodes, (profile_cuda.MAX_SCAN_M,), generator=gen, device=dev,
                          dtype=torch.uint8)
    residues = int(lens.long().sum())
    for label, gaps in GAPS.items():
        scan = profile_cuda.sw_profile_affine if "gap_open" in gaps else profile_cuda.sw_profile
        shapes = shape_table(ncodes, "gap_open" in gaps)
        per_shape = []
        for g, r, lo, hi in shapes:
            times = {}
            for M in sorted({lo, hi}):
                q = query[:M]
                mm = torch.full_like(lens, M)
                ms = mean_ms(lambda: scan(q, slab, mm, lens, y_off=offs, table=table, **gaps),
                             args.reps)
                times[M] = ms
                print(json.dumps({"gaps": label, "g": g, "r": r, "M": M, "ms": round(ms, 4),
                                  "gcups": round(M * residues / ms / 1e6, 1)}), flush=True)
            per_shape.append((g, r, lo, hi, times))
        # Dropping shape k sends its queries (lo..hi) to shape k + 1: the
        # slowdown is shape k + 1's time over shape k's at its longest query,
        # hi, taking the lower of shape k + 1's two times (a shape's time
        # hardly depends on M, so this errs towards dropping).
        for k in range(len(per_shape) - 1):
            g, r, lo, hi, times = per_shape[k]
            g2, r2, _, _, times2 = per_shape[k + 1]
            t_next = min(times2.values())
            print(json.dumps({"gaps": label, "drop": f"{g}x{r}", "queries": f"{lo}-{hi}",
                              "onto": f"{g2}x{r2}", "ms": round(times[hi], 4),
                              "ms_onto": round(t_next, 4),
                              "slowdown": round(t_next / times[hi], 3)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
