#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--reads 5120] [--batch-size 512]

1. Requires a CUDA card and prints its name and power limit.
2. Builds the port's CUDA kernels from ``parallel_genomeseq_tpu_torch/csrc``.
3. Holds each kernel against its plain PyTorch version on the card, on the
   same inputs, at the main path's shapes, with exact equality (every value
   is an integer or a byte): K1 in both modes (512 reads x 17 windows), K2 on
   the 512 winning windows and on the full reference (--npiece 1), K3 on
   K2's output. Times both with CUDA events.
4. Runs ``solve_small.main`` of the port with its defaults (17 windows) on a
   seeded stand-in for the data_small workload: a 4,980-bp reference and
   125-bp reads with substitutions and small indels. Checks that all three
   kernels launched during that run, and that 32 sampled reads of that run
   agree with the numpy oracle: score over the full reference, and pos and
   consensus of the oracle's alignment on the winning window.
5. Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

Any failed phase raises and exits non-zero before the last line.
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = "parallel_genomeseq_tpu_torch/csrc"
PALLAS = "parallel_genomeseq_tpu/ops/wavefront_pallas.py"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired integer tensors; raises
    unless it is 0."""
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err != 0:
        raise AssertionError(f"kernel disagrees with its plain version: max |diff| = {err}")
    return err


def moves_err(got, want, m, n, chunk: int = 256) -> int:
    """Largest |difference| of two (D, M, B) move tensors over the cells
    inside each lane's m_b x n_b matrix (the only cells the kernel writes)."""
    import torch

    D, M, _ = got.shape
    r = torch.arange(M, device=got.device)[None, :, None]
    err = 0
    for d0 in range(0, D, chunk):
        d = torch.arange(d0, min(D, d0 + chunk), device=got.device)[:, None, None]
        valid = (r < m[None, None, :]) & (d >= r) & (d - r < n[None, None, :])
        diff = (got[d0 : d0 + chunk].int() - want[d0 : d0 + chunk].int()).abs()
        err = max(err, int((diff * valid).max()))
    if err != 0:
        raise AssertionError(f"K2 move codes disagree on valid cells: max |diff| = {err}")
    return err


def check_kernels(reads, ref, batch: int):
    """Phase 3: each kernel against its plain version at the main path's
    shapes. Returns {kernel name: measurements}."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.ops import scan_dp, traceback, wavefront_cuda
    from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkConfig, ChunkedAligner
    from parallel_genomeseq_tpu_torch.utils.device import to_host

    dev = torch.device("cuda")
    kw = dict(match=3, mismatch=-3, gap=2)
    chunked = ChunkedAligner(chunk=ChunkConfig(npiece=17, overlap_ratio=2.0), device=dev)
    aligner = BatchSWAligner(device=dev)
    out = {}

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    # K1: the stage-A window sweep, both modes.
    batch_reads = reads[:batch]
    xs, ys, m, n, all_ranges = chunked.window_lanes(batch_reads, ref)
    xs, ys, m, n = on_card(xs, ys, m, n)
    k1 = {"shape": f"{xs.shape[0]} lanes, M={xs.shape[1]}, N={ys.shape[1]}"}
    for track_pos in (False, True):
        tag = "track_pos" if track_pos else "score_only"
        got = wavefront_cuda.sw_score(xs, ys, m, n, track_pos=track_pos, **kw)
        want = scan_dp.sw_score_plain(xs, ys, m, n, track_pos=track_pos, **kw)
        k1[f"{tag}_max_abs_err"] = max_abs_err(got, want)
        k1[f"{tag}_ms"] = cuda_ms(
            lambda: wavefront_cuda.sw_score(xs, ys, m, n, track_pos=track_pos, **kw), 10)
        k1[f"{tag}_plain_ms"] = cuda_ms(
            lambda: scan_dp.sw_score_plain(xs, ys, m, n, track_pos=track_pos, **kw), 1)
        print(f"K1 sw_score[{tag}] {k1['shape']}: equal; kernel {k1[f'{tag}_ms']:.3f} ms, "
              f"plain {k1[f'{tag}_plain_ms']:.3f} ms")
    out["sw_score"] = k1

    # K2 on the winning windows (the stage-B re-run) and on the full reference.
    (scores,) = to_host([got[0]])
    winner = scores.reshape(len(batch_reads), -1).argmax(axis=1)
    win_refs = [ref[slice(*all_ranges[r][w])] for r, w in enumerate(winner)]
    k2 = {}
    walk_inputs = None
    for tag, refs in (("windows", win_refs), ("npiece1", [ref])):
        xs, ys, m, n = on_card(*aligner.pad_batch(batch_reads, refs))
        got = wavefront_cuda.sw_score_moves(xs, ys, m, n, **kw)
        want = scan_dp.sw_score_moves_plain(xs, ys, m, n, **kw)
        err = max(max_abs_err(got[:3], want[:3]), moves_err(got[3], want[3], m, n))
        k2[f"{tag}_shape"] = f"{xs.shape[0]} lanes, M={xs.shape[1]}, N={ys.shape[1]}"
        k2[f"{tag}_max_abs_err"] = err
        k2[f"{tag}_ms"] = cuda_ms(lambda: wavefront_cuda.sw_score_moves(xs, ys, m, n, **kw), 10)
        k2[f"{tag}_plain_ms"] = cuda_ms(lambda: scan_dp.sw_score_moves_plain(xs, ys, m, n, **kw), 1)
        print(f"K2 sw_score_moves[{tag}] {k2[f'{tag}_shape']}: equal on valid cells; kernel "
              f"{k2[f'{tag}_ms']:.3f} ms, plain {k2[f'{tag}_plain_ms']:.3f} ms")
        if walk_inputs is None:
            walk_inputs = (got[3], xs.T.contiguous(), ys, got[1], got[2],
                           aligner.max_steps(xs.shape[1], ys.shape[1]))
        del got, want
    out["sw_score_moves"] = k2

    # K3 on K2's output for the winning windows.
    moves, x_mb, y_bn, i0, j0, steps = walk_inputs
    got = traceback.walk_moves(moves, x_mb, y_bn, i0, j0, max_steps=steps)
    want = traceback._walk_moves_plain(moves, x_mb, y_bn, i0, j0, steps)
    k3 = {"shape": f"{x_mb.shape[1]} lanes, max_steps={steps}",
          "max_abs_err": max_abs_err(got, want)}
    k3["ms"] = cuda_ms(lambda: traceback.walk_moves(moves, x_mb, y_bn, i0, j0, max_steps=steps), 10)
    k3["plain_ms"] = cuda_ms(lambda: traceback._walk_moves_plain(moves, x_mb, y_bn, i0, j0, steps), 1)
    print(f"K3 walk_moves {k3['shape']}: equal; kernel {k3['ms']:.3f} ms, "
          f"plain {k3['plain_ms']:.3f} ms")
    out["walk_moves"] = k3
    return out


def oracle_matrix(read: str, ref: str, match=3, mismatch=-3, gap=2):
    """Dense (m+1, n+1) Smith-Waterman matrix in numpy, one column at a
    time: the in-column north chain H[i] = max(E[i], H[i-1] - gap) is a
    prefix max of E[i] + gap*i (the method of the JAX package's numpy
    oracle, ops/oracle.sw_score_fast, kept here so this script depends only
    on the port)."""
    import numpy as np

    x = np.frombuffer(read.encode(), np.uint8)
    y = np.frombuffer(ref.encode(), np.uint8)
    H = np.zeros((len(x) + 1, len(y) + 1), np.int64)
    gi = gap * np.arange(1, len(x) + 1)
    for j in range(1, len(y) + 1):
        e = np.maximum(H[:-1, j - 1] + np.where(x == y[j - 1], match, mismatch),
                       np.maximum(H[1:, j - 1] - gap, 0))
        H[1:, j] = np.maximum.accumulate(e + gi) - gi
    return H


def oracle_align(read: str, ref: str):
    """(score, pos, consensus_x, consensus_y): first maximum in column-major
    order, then the greedy NW >= W >= N walk that stops on the first cell with
    a zero neighbour (consensus reversed, '-' for gaps)."""
    import numpy as np

    H = oracle_matrix(read, ref)
    j, i = divmod(int(np.argmax(H.T)), H.shape[0])
    score = int(H[i, j])
    if score <= 0:
        return score, 0, "", ""
    cx, cy = [], []
    while True:
        nw, w, no = H[i - 1, j - 1], H[i, j - 1], H[i - 1, j]
        if nw == 0 or w == 0 or no == 0:
            cx.append(read[i - 1])
            cy.append(ref[j - 1])
            return score, j, "".join(cx), "".join(cy)
        if nw >= w and nw >= no:
            cx.append(read[i - 1])
            cy.append(ref[j - 1])
            i, j = i - 1, j - 1
        elif w >= nw and w >= no:
            cx.append("-")
            cy.append(ref[j - 1])
            j -= 1
        else:
            cx.append(read[i - 1])
            cy.append("-")
            i -= 1


def check_sampled(reads, ref, rows, results, seed: int, count: int = 32):
    """Phase 4 check: sampled reads of the timed run against the numpy
    oracle. ``rows`` is the run's CSV, ``results`` its AlignResults."""
    import numpy as np

    from parallel_genomeseq_tpu_torch.parallel.chunking import make_string_ranges

    picks = np.random.default_rng(seed).choice(len(reads), count, replace=False)
    for k in picks:
        read, res = reads[k], results[k]
        full = int(oracle_matrix(read, ref).max())
        ranges = make_string_ranges(17, len(read), len(ref), 2.0)
        win = int(np.argmax([oracle_matrix(read, ref[l:r]).max() for l, r in ranges]))
        left, right = ranges[win]
        score, pos, cx, cy = oracle_align(read, ref[left:right])
        pos = pos + left if pos > 0 else 0
        got = (int(rows[k]["score"]), int(rows[k]["pos_pred"]), int(res.score),
               res.pos, res.consensus_x, res.consensus_y)
        exp = (full, pos, score, pos, cx, cy)
        if got != exp:
            raise AssertionError(f"read {k}: port {got} != oracle {exp}")
    print(f"oracle check: {count} sampled reads of the timed run agree (score over "
          "the full reference; pos and consensus on the winning window)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=5120)
    ap.add_argument("--batch-size", type=int, default=512)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from parallel_genomeseq_tpu_torch.ops import _build, traceback, wavefront_cuda
    from parallel_genomeseq_tpu_torch.cli import solve_small
    from parallel_genomeseq_tpu_torch.utils.synth import write_dataset

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "entry function" in line or "Used" in line:
            print(f"  nvcc: {line.strip()}")

    data = ROOT / "data" / "chip_smoke"
    ref_path, csv_path = write_dataset(
        data, ref_len=4980, n_reads=args.reads, read_len=(125, 125), seed=args.seed
    )
    ref = "".join(l.strip() for l in open(ref_path) if not l.startswith(">"))
    with open(csv_path, newline="") as f:
        reads = [r["SEQ"] for r in csv.DictReader(f)]
    print(f"data: {len(reads)} reads x 125 bp vs {len(ref)}-bp reference (seed {args.seed})")

    measured = check_kernels(reads, ref, args.batch_size)

    out_csv = data / "align_output.csv"
    cli = ["--ref", str(ref_path), "--input", str(csv_path), "--output", str(out_csv),
           "--batch-size", str(args.batch_size)]
    if solve_small.main(cli + ["--limit", str(args.batch_size)]) != 0:  # warm-up
        raise AssertionError("solve_small warm-up failed")
    counters = (wavefront_cuda.sw_score, wavefront_cuda.sw_score_moves, traceback.walk_moves)
    for fn in counters:
        fn.launches = 0
    run = solve_small.run(cli)
    launches = {fn.__name__: fn.launches for fn in counters}
    if run.rc != 0:
        raise AssertionError(f"solve_small exited {run.rc}")
    print(f"launches during solve_small: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    with open(out_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(run.results) != len(reads) or len(rows) != len(reads):
        raise AssertionError(f"expected {len(reads)} results and rows, got "
                             f"{len(run.results)} and {len(rows)}")
    print(f"solve_small: {len(reads) / run.seconds:.1f} reads/s, "
          f"{run.cells / run.seconds / 1e9:.3f} GCUPS (full-reference cells, "
          f"{run.seconds:.3f} s) on {card}")
    check_sampled(reads, ref, rows, run.results, args.seed)

    # name, source, the TPU code it replaces, prefix of its main-path timing
    spec = (("sw_score", "wavefront.cu", f"{PALLAS}:160", "score_only_"),
            ("sw_score_moves", "wavefront.cu", f"{PALLAS}:535", "windows_"),
            ("walk_moves", "traceback.cu", "parallel_genomeseq_tpu/ops/traceback.py:31", ""))
    kernels = []
    for name, src, replaces, pre in spec:
        m = measured[name]
        main_keys = (f"{pre}ms", f"{pre}plain_ms", f"{pre}max_abs_err")
        kernels.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v for k, v in m.items() if k.endswith("max_abs_err")),
            "ms": m[f"{pre}ms"], "plain_ms": m[f"{pre}plain_ms"],
            **{k: v for k, v in m.items() if k not in main_keys},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
