"""Hold K25, the NW last-row sweep, against its plain version at its launch
rule's edges, time it at each rows-a-thread shape, and time
``hirschberg_align`` at several ``device_cells``.

    python -m parallel_genomeseq_tpu_torch.tools.nw_shapes [--reps 5] [--skip-edges]

K25 (``csrc/global_dp.cu``) cuts each lane's rows into chunks of 32 x R
rows, one warp a chunk, chained through device memory; the rule
(``ops/global_dp.launch_shape``) picks R from the lanes' lengths. This tool
first holds the kernel exactly against ``nw_lastrow_lanes_plain`` on edge
cases (B of 1-3; m_b on, one short of and one past a chunk edge at every R;
m_b = 0 and n_b = 0; n of 25,000; lanes read at offsets, reversed; a deep
Hirschberg level of 4,096 small lanes; BLOSUM62 letters; bytes of more than
64 values, which read the byte table from device memory). Then it times
three launches on generated 10-kb DNA reads (a 30,000-bp seeded reference,
reads sampled from it and mutated copies with about 1% substitutions and
three 1-3 bp indels): Hirschberg's top launch (a read's two halves against
its source, 2 lanes), 100 lanes of whole reads, and 64 ragged lanes, at the
rule's shape and at every R. Last, ``hirschberg_align`` of two reads at
``device_cells`` 0, 2^12, 2^16, 2^21 and on the CPU alone: seconds, K25
launches, recursion levels, and the consensus held identical to the
CPU-only run's; and one read under the profiler (wall, K25's device time,
every kernel's, the idle share). Prints the card's name and power limit first and one JSON
line a measurement (ms: the mean of ``--reps`` launches after a warm-up, by
CUDA events; the bound is 3 integer operations a cell over 132 x 128 lanes
at the top SM clock).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..models import hirschberg
from ..ops import global_dp
from ..ops.substitution import blosum_config
from ..utils.config import ScoringConfig

OPS_PER_CELL = 3
LANES_PER_CLOCK = 132 * 4 * 32


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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


def mutate(rng, seq: np.ndarray) -> np.ndarray:
    """About 1% substitutions and three 1-3 bp indels."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seg = seq.copy()
    subs = rng.random(len(seg)) < 0.01
    seg[subs] = rng.choice(acgt, int(subs.sum()))
    for _ in range(3):
        size, at = int(rng.integers(1, 4)), int(rng.integers(20, len(seg) - 20))
        if rng.random() < 0.5:
            seg = np.concatenate([seg[:at], rng.choice(acgt, size), seg[at:]])
        else:
            seg = np.concatenate([seg[:at], seg[at + size :]])
    return seg


def reads(count: int, length: int = 10_000, seed: int = 0):
    """(sources, mutated copies) of ``count`` reads of a 30,000-bp reference."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), 30_000)
    src = [ref[p : p + length] for p in rng.integers(0, len(ref) - length + 1, count)]
    return src, [mutate(rng, s) for s in src]


def flat(parts, dev):
    return torch.from_numpy(np.concatenate([np.zeros(0, np.uint8)] + list(parts))).to(dev)


def held(label, x, y, lanes, table, gap, dev):
    """K25 against its plain version on the card, exactly."""
    got = global_dp.nw_lastrow_lanes(x, y, lanes, table=table, gap=gap)
    want = global_dp.nw_lastrow_lanes_plain(x, y, lanes, table=table, gap=gap)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"K25 {label}: {bad} of {got.numel()} values differ from plain")
    print(json.dumps({"edge": label, "lanes": lanes.B, "rows": lanes.rows,
                      "warps": lanes.warps, "chunks": lanes.total_chunks, "equal": True}))


def edge_cases(dev):
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    cfg = ScoringConfig()
    table = global_dp.byte_table(cfg, dev)
    gap = int(cfg.gap_penalty)

    def lanes_of(ms, ns, **kw):
        xs = [rng.choice(acgt, int(v)) for v in ms]
        ys = [rng.choice(acgt, int(v)) for v in ns]
        for a, b in zip(xs, ys):  # related pairs: a read is a copy of its reference's head
            k = min(len(a), len(b))
            a[: k // 2] = b[: k // 2]
        return flat(xs, dev), flat(ys, dev), global_dp.plan_lanes(ms, ns, **kw)

    for B in (1, 2, 3):
        held(f"b{B}", *lanes_of(rng.integers(300, 3000, B), rng.integers(300, 5000, B)), table,
             gap, dev)
    for R in global_dp.ROWS:
        c = 32 * R
        ms = [c, c - 1, c + 1, 2 * c, 2 * c + 1, 1, 0, 5, 3 * c - 1]
        ns = [700, 1, 300, 129, 0, 2, 40, 0, 64]
        for W in (1, 4):
            held(f"edges_R{R}_W{W}", *lanes_of(ms, ns, rows=R, warps=W), table, gap, dev)
    held("n_25000", *lanes_of([30, 3000], [25_000, 25_000]), table, gap, dev)
    # Offsets and directions: lanes read from two shared buffers.
    X = rng.choice(acgt, 40_000)
    Y = X.copy()
    Y[rng.random(len(Y)) < 0.05] = rng.choice(acgt)
    B = 40
    m = rng.integers(0, 2000, B)
    n = rng.integers(0, 3000, B)
    x_off = rng.integers(0, len(X) - m)
    y_off = rng.integers(0, len(Y) - n)
    for R in (0, 4, 32):
        lanes = global_dp.plan_lanes(m, n, x_off=x_off, y_off=y_off, x_rev=rng.random(B) < 0.5,
                                     y_rev=rng.random(B) < 0.5, rows=R)
        held(f"offsets_reversed_R{lanes.rows}", flat([X], dev), flat([Y], dev), lanes, table,
             gap, dev)
    held("deep_level_4096", *lanes_of(rng.integers(1, 6, 4096), rng.integers(1, 13, 4096)),
         table, gap, dev)
    prot = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    b62 = blosum_config("blosum62", gap_penalty=4.0)
    px = [rng.choice(prot, int(v)) for v in rng.integers(0, 700, 17)]
    py = [rng.choice(prot, int(v)) for v in rng.integers(0, 900, 17)]
    held("blosum62", flat(px, dev), flat(py, dev),
         global_dp.plan_lanes([len(v) for v in px], [len(v) for v in py]),
         global_dp.byte_table(b62, dev), int(b62.gap_penalty), dev)
    wide = ScoringConfig(match=5, mismatch=-4, gap_penalty=3)
    bx = [rng.integers(0, 256, int(v)).astype(np.uint8) for v in (900, 1500, 40)]
    by = [rng.integers(0, 256, int(v)).astype(np.uint8) for v in (1200, 300, 2000)]
    held("bytes_past_64_codes", flat(bx, dev), flat(by, dev),
         global_dp.plan_lanes([len(v) for v in bx], [len(v) for v in by]),
         global_dp.byte_table(wide, dev), 3, dev)


def timed(label, x, y, lanes, table, gap, clock, reps):
    cells = float((lanes.m * lanes.n).sum())
    ms = mean_ms(lambda: global_dp.nw_lastrow_lanes(x, y, lanes, table=table, gap=gap), reps)
    bound_ms = cells * OPS_PER_CELL / (LANES_PER_CLOCK * clock * 1e6) * 1e3
    rec = {"case": label, "rows": lanes.rows, "warps": lanes.warps, "blocks": lanes.blocks,
           "sms": global_dp.sms_used(x, y, lanes, table=table, gap=gap),
           "chunks_a_lane": [int(lanes.chunks.min()), int(lanes.chunks.max())],
           "cells": cells, "ms": round(ms, 4), "gcups": round(cells / ms / 1e6, 2),
           "bound_ms": round(bound_ms, 5), "bound_share": round(bound_ms / ms, 4)}
    print(json.dumps(rec))
    return rec


def timings(dev, clock, reps):
    cfg = ScoringConfig()
    table = global_dp.byte_table(cfg, dev)
    gap = int(cfg.gap_penalty)
    src, mut = reads(100)
    rng = np.random.default_rng(11)
    x0, y0 = mut[0], src[0]
    mid = len(x0) // 2
    cases = {
        "hirschberg_top": ([x0[:mid], x0[mid:][::-1].copy()], [y0, y0[::-1].copy()]),
        "batch_100": (mut, src),
    }
    rx, ry = [], []
    for k in range(64):
        a, b = (int(v) for v in rng.integers(0, 10_000, 2))
        lo = int(rng.integers(0, 10_000 - b + 1))
        rx.append(mut[k][:a])
        ry.append(src[k][lo : lo + b])
    cases["ragged_64"] = (rx, ry)
    out = []
    for label, (xs, ys) in cases.items():
        x, y = flat(xs, dev), flat(ys, dev)
        ms, ns = [len(v) for v in xs], [len(v) for v in ys]
        rule = global_dp.plan_lanes(ms, ns)
        held(label, x, y, rule, table, gap, dev)
        out.append(timed(f"{label} (rule)", x, y, rule, table, gap, clock, reps))
        for R in global_dp.ROWS:
            out.append(timed(f"{label} R={R}", x, y, global_dp.plan_lanes(ms, ns, rows=R),
                             table, gap, clock, reps))
    return out


def step_curve(dev, clock, reps):
    """One lane alone, 1 to 40 chunks at R = 4 and 1 to 5 at R = 32, n of
    2,000 and 10,000: with one warp a chunk on its own SM, a launch takes
    (n + lag x (chunks - 1)) steps, so the pairs give the cycles a step and
    the steps a chunk trails the one above it."""
    cfg = ScoringConfig()
    table = global_dp.byte_table(cfg, dev)
    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for R, chunk_counts in ((4, (1, 10, 40)), (32, (1, 5))):
        for chunks in chunk_counts:
            ms = {}
            for n in (2000, 10_000):
                m = 32 * R * chunks
                x, y = flat([rng.choice(acgt, m)], dev), flat([rng.choice(acgt, n)], dev)
                lanes = global_dp.plan_lanes([m], [n], rows=R, warps=1)
                ms[n] = mean_ms(lambda: global_dp.nw_lastrow_lanes(x, y, lanes, table=table,
                                                                   gap=2), reps)
            cyc = (ms[10_000] - ms[2000]) * 1e-3 * clock * 1e6 / 8000
            lag = (ms[10_000] * 1e-3 * clock * 1e6 / cyc - 10_000) / max(chunks - 1, 1)
            print(json.dumps({"step_curve": f"R={R}, {chunks} chunks", "ms_n2000": ms[2000],
                              "ms_n10000": ms[10_000], "cycles_a_step": round(cyc, 1),
                              "lag_steps_a_chunk": round(lag, 1) if chunks > 1 else None}))


def hirschberg_runs(dev):
    cfg = ScoringConfig()
    src, mut = reads(2, seed=1)
    host = [hirschberg.hirschberg_align(a, b, cfg, device="cpu") for a, b in zip(mut, src)]
    for cells in (0, 1 << 12, 1 << 16, 1 << 21, None):
        before = global_dp.nw_lastrow.launches
        t0 = time.perf_counter()
        got = [hirschberg.hirschberg_align(a, b, cfg, device_cells=cells or 0,
                                           device=dev if cells is not None else "cpu")
               for a, b in zip(mut, src)]
        seconds = time.perf_counter() - t0
        same = all((g.score, g.consensus_x, g.consensus_y) == (h.score, h.consensus_x,
                                                               h.consensus_y)
                   for g, h in zip(got, host))
        if not same:
            raise AssertionError(f"hirschberg_align at device_cells={cells}: not the CPU's strings")
        print(json.dumps({"hirschberg_align": "2 reads of ~10 kb",
                          "device_cells": "cpu only" if cells is None else cells,
                          "seconds": round(seconds, 4),
                          "k25_launches": global_dp.nw_lastrow.launches - before,
                          "levels_a_read": int(np.ceil(np.log2(max(len(mut[0]), 2)))) + 1,
                          "identical_to_cpu": same}))


def hirschberg_profile(dev):
    """One read of ~10 kb at device_cells=0 under the profiler: the wall
    seconds, K25's device time and every kernel's, and the launches."""
    from torch.profiler import ProfilerActivity, profile

    cfg = ScoringConfig()
    src, mut = reads(1, seed=1)
    hirschberg.hirschberg_align(mut[0], src[0], cfg, device_cells=0, device=dev)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hirschberg.hirschberg_align(mut[0], src[0], cfg, device_cells=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    k25 = sum(e.self_device_time_total for e in kernels if "nw_band" in e.key)
    busy = sum(e.self_device_time_total for e in kernels)
    print(json.dumps({"hirschberg_profile": "1 read of ~10 kb, device_cells=0",
                      "wall_ms": round(wall * 1e3, 3), "k25_device_ms": round(k25 / 1e3, 3),
                      "device_busy_ms": round(busy / 1e3, 3),
                      "idle_share": round(1 - busy / 1e3 / (wall * 1e3), 4),
                      "by_kernel_ms": {e.key[:60]: round(e.self_device_time_total / 1e3, 3)
                                       for e in sorted(kernels, key=lambda e:
                                                       -e.self_device_time_total)[:8]}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--skip-edges", action="store_true")
    ap.add_argument("--curve-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nw_shapes times the card's kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"))
    clock = float(smi("clocks.max.sm").split()[0])
    from ..ops import _build

    lib = _build.build()
    _build.load()
    entry = ""
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "entry function" in line:
            entry = line
        if "nw_band" in entry and ("entry function" in line or "Used" in line or "spill" in line):
            print(f"  nvcc: {line.strip()}")
    if not args.skip_edges:
        edge_cases(dev)
    step_curve(dev, clock, args.reps)
    if args.curve_only:
        return 0
    timings(dev, clock, args.reps)
    hirschberg_runs(dev)
    hirschberg_profile(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
