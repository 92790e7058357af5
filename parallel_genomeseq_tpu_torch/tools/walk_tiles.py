"""Time the strip walk's group launch (K14, K18) at several tile shapes.

    python -m parallel_genomeseq_tpu_torch.tools.walk_tiles [--reps 10] [--source PATH ...]

K14/K18 (``csrc/traceback.cu`` ``walk_strip_kernel``) stage a kTileRows x
kTileCols tile of move bytes a DRAM round trip and walk it from shared
memory, a warp a lane. This tool builds ``traceback.cu`` alone at each shape
of SHAPES (``-DPGS_WALK_TILE_ROWS/COLS``), and each extra ``--source`` (an
earlier version of the file, say) as it is, with nvcc into
``csrc/build/walk_tiles/``, all builds started together. On solve_big's
traceback shapes -- 100 reads of 10,000 bp with about 1% substitutions and
three 1-3 bp indels each, against the 20,000-bp window that holds it -- it
runs the checkpointing sweep and replays every strip in one group, then
times one group walk launch of each build: the mean of ``--reps`` launches
after a warm-up, by CUDA events around each launch, the state restored
between them, the builds in their order and then in reverse. Linear 3/-3/2
and BWA-MEM's affine 1/-4/6/1. Each build's end state must equal the port's
own kernel's. Prints the card's name and power limit, then one JSON line a
(scoring, build): ms (both passes), the longest lane's steps, ns a step.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, scan_dp, strips_cuda, traceback

SHAPES = ((64, 64), (32, 32), (128, 64), (64, 128), (128, 128))
SCORING = {"linear": dict(match=3, mismatch=-3, gap=2),
           "affine": dict(match=1, mismatch=-4, gap_open=6, gap=1)}
B, READ, WINDOW, REF = 100, 10_000, 20_000, 30_000


def build(sources, out_dir: Path):
    """{label: ctypes library}: traceback.cu at each of SHAPES, and each of
    ``sources`` at its own shape, one nvcc each, all at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    own = _build.CSRC / "traceback.cu"
    jobs = {f"{r}x{c}": (own, [f"-DPGS_WALK_TILE_ROWS={r}", f"-DPGS_WALK_TILE_COLS={c}"])
            for r, c in SHAPES}
    jobs.update({str(s): (Path(s), []) for s in sources})
    nvcc = _build.find_nvcc()
    procs = {}
    for k, (label, (src, flags)) in enumerate(jobs.items()):
        so = out_dir / f"walk_{k}.so"
        cmd = [nvcc, *_build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               *flags, "-o", str(so), str(src)]
        procs[label] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.pgs_walk_strip_group.argtypes = _build._SIGNATURES["pgs_walk_strip_group"]
        lib.pgs_walk_strip_group.restype = ctypes.c_int
        libs[label] = lib
    return libs


def lanes(seed: int, dev):
    """(xs (B, M), ys (B, WINDOW), m, n) raw bytes: each read a mutated
    10,000-bp stretch of a random reference, its window the 20,000 bp from
    5,000 before it."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, REF)
    reads, wins = [], []
    for _ in range(B):
        at = int(rng.integers(5_000, REF - WINDOW + 5_000))
        seg = ref[at : at + READ].copy()
        subs = rng.random(READ) < 0.01
        seg[subs] = rng.choice(acgt, int(subs.sum()))
        for _ in range(3):
            size, cut = int(rng.integers(1, 4)), int(rng.integers(20, seg.shape[0] - 20))
            seg = (np.concatenate([seg[:cut], rng.choice(acgt, size), seg[cut:]])
                   if rng.random() < 0.5 else np.concatenate([seg[:cut], seg[cut + size :]]))
        reads.append(seg)
        wins.append(ref[at - 5_000 : at - 5_000 + WINDOW])
    M = max(len(r) for r in reads)
    xs = np.ones((B, M), np.uint8)
    for b, r in enumerate(reads):
        xs[b, : len(r)] = r
    m = np.array([len(r) for r in reads], np.int32)
    n = np.full(B, WINDOW, np.int32)
    return [torch.from_numpy(a).to(dev) for a in (xs, np.stack(wins), m, n)]


def state_ms(launch, pre, reps: int):
    """(mean ms of ``launch(state)`` over ``reps`` launches after a warm-up,
    the state after the last): CUDA events around each launch, the state
    restored from ``pre`` outside them, and a spin on the stream holding the
    start event until the launch is queued, so that the host's launch time
    stays out."""
    work = tuple(a.clone() for a in pre)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for k in range(reps + 1):
        for w, a in zip(work, pre):
            w.copy_(a)
        torch.cuda._sleep(200_000)
        start.record()
        launch(work)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) if k else 0.0
    return total / reps, work


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source", action="append", default=[],
                    help="another traceback.cu to time at its own shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("walk_tiles needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    libs = build(args.source, _build.BUILD_DIR / "walk_tiles")
    xs, ys, m, n = lanes(args.seed, dev)
    M, N = xs.shape[1], ys.shape[1]
    x_mb = xs.T.contiguous()
    S = scan_dp.STRIP_S
    G = -(-M // S)
    for scoring, kw in SCORING.items():
        affine = "gap_open" in kw
        ckpt, group, walk = ((strips_cuda.sw_score_strips_affine_ckpt,
                              strips_cuda.strip_affine_moves_group,
                              traceback.walk_strip_group_affine) if affine else
                             (strips_cuda.sw_score_strips_ckpt, strips_cuda.strip_moves_group,
                              traceback.walk_strip_group))
        _, i, j, *ck = ckpt(xs, ys, m, n, **kw)
        pre = traceback.new_strip_state(i, j, M + N, affine=affine)
        moves = torch.empty((G, B, N, S), dtype=torch.uint8, device=dev)
        group(xs, ys, m, n, *ck, 0, moves, (pre[0], pre[1], pre[3]), **kw)
        want = tuple(a.clone() for a in pre)
        walk(moves, x_mb, ys, 0, want, max_steps=M + N)
        taken = want[4] - pre[4]
        longest = int(taken.max())

        def launch(lib, st):
            i_, j_, pos, active, steps, cx, cy, *g = st
            err = lib.pgs_walk_strip_group(
                moves.data_ptr(), x_mb.data_ptr(), ys.data_ptr(), M, N, B, G, 0, M + N,
                i_.data_ptr(), j_.data_ptr(), pos.data_ptr(), active.data_ptr(),
                steps.data_ptr(), g[0].data_ptr() if g else None, cx.data_ptr(), cy.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "pgs_walk_strip_group")

        times = {label: [] for label in libs}
        for order in (list(libs), list(libs)[::-1]):
            for label in order:
                ms, got = state_ms(lambda st, lib=libs[label]: launch(lib, st), pre, args.reps)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{scoring} {label}: the walk differs from the port's")
                times[label].append(ms)
        for label, ms in times.items():
            print(json.dumps({"scoring": scoring, "build": label, "G": G, "lanes": B,
                              "steps": int(taken.sum()), "longest_steps": longest, "ms": ms,
                              "ns_per_step": min(ms) * 1e6 / longest}))
        del moves, ck
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
