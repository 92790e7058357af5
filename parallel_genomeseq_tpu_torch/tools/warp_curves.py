"""Time the warp-a-lane re-run with moves at few lanes, one warp a lane
against two.

    python -m parallel_genomeseq_tpu_torch.tools.warp_curves [--reps 10]

The re-run with moves is one template (``csrc/wavefront.cu``) scored two
ways: uniformly (K2, affine K7) and from a substitution table (K5, affine
K9, the protein top-K traceback). With few lanes -- the top 10 -- each lane's
block has an SM to itself, and the only parallelism left is inside the
lane: two warps of half the rows step faster, but the second trails the
first by kLag steps. This tool measures that trade, and whether the table's
shared-memory loads cost anything against the uniform scores: for B = 10
and 64 lanes of M = 128 .. 1,024 rows (each lane m_b up to 127 short of M,
codes of a 25-letter alphabet holding a mutated copy of half the query) and
a 145-column query (N = 256), it times each kernel at one warp a lane and at
two (``warps=``), checks that both give the same (score, i, j) and move
bytes, and prints the card's name and power limit, then one JSON line a
shape (ms: the mean of ``--reps`` launches after a warm-up, by CUDA events;
``rule``: the warps a lane the kernel's rule takes).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops import profile_cuda, wavefront_cuda
from ..ops.scan_dp import profile_tables
from ..ops.substitution import blosum_config
from .scan_shapes import mean_ms

ROWS = (128, 256, 384, 512, 768, 1024)
LANES = (10, 64)
QUERY, N = 145, 256


def lanes(B: int, M: int, seed: int, dev):
    """(xs (B, M), ys (B, N) codes 1..25, m, n): each lane's first m_b codes
    random but for a 20%-mutated copy of half the query (or of its first m_b
    codes) at a random place."""
    rng = np.random.default_rng(seed)
    m = (M - rng.integers(0, 128, B)).astype(np.int32)
    q = rng.integers(1, 26, QUERY).astype(np.uint8)
    xs = np.zeros((B, M), np.uint8)
    ys = np.zeros((B, N), np.uint8)
    ys[:, :QUERY] = q
    for b in range(B):
        xs[b, : m[b]] = rng.integers(1, 26, m[b])
        k = min(QUERY // 2, int(m[b]))
        seg = q[:k].copy()
        mut = rng.random(k) < 0.2
        seg[mut] = rng.integers(1, 26, int(mut.sum()))
        at = int(rng.integers(0, m[b] - k + 1))
        xs[b, at : at + k] = seg
    n = np.full(B, QUERY, np.int32)
    return [torch.from_numpy(a).to(dev) for a in (xs, ys, m, n)]


def same(got, want, m, n) -> bool:
    """Equal (score, i, j), and moves equal in every cell inside m_b x n_b."""
    if not all(torch.equal(g, w) for g, w in zip(got[:3], want[:3])):
        return False
    D, M, _ = got[3].shape
    d = torch.arange(D, device=m.device)[:, None, None]
    r = torch.arange(M, device=m.device)[None, :, None]
    valid = (r < m) & (d >= r) & (d - r < n)
    return torch.equal(got[3][valid], want[3][valid])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("warp_curves times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    table = torch.from_numpy(profile_tables(blosum_config("blosum50"))[1]).to(dev)
    kernels = (
        ("K2", wavefront_cuda.sw_score_moves, dict(match=3, mismatch=-3, gap=2), 0),
        ("K7", wavefront_cuda.sw_score_affine_moves,
         dict(match=1, mismatch=-4, gap_open=6, gap=1), 0),
        ("K5", profile_cuda.sw_profile_moves, dict(table=table, gap=12), table.shape[0]),
        ("K9", profile_cuda.sw_profile_affine_moves, dict(table=table, gap_open=10, gap=2),
         table.shape[0]),
    )
    for name, fn, kw, ncodes in kernels:
        for B in LANES:
            for M in ROWS:
                xs, ys, m, n = lanes(B, M, seed=M, dev=dev)
                one, two = (fn(xs, ys, m, n, warps=w, **kw) for w in (1, 2))
                if not same(two, one, m, n):
                    raise AssertionError(f"{name} B={B} M={M}: two warps a lane disagree")
                del one, two
                rule = wavefront_cuda.launch_shape(M, B, affine="gap_open" in kw, mode="moves",
                                                   ncodes=ncodes)["warps"]
                ms = {w: mean_ms(lambda: fn(xs, ys, m, n, warps=w, **kw), args.reps)
                      for w in (1, 2)}
                print(json.dumps({"kernel": name, "lanes": B, "rows": M, "rule": rule,
                                  "ms_one_warp": ms[1], "ms_two_warps": ms[2],
                                  "ratio": ms[2] / ms[1]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
