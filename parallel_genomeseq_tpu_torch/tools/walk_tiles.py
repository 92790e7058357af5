"""Time the walks' staging shapes: K14/K18's move tiles, K3/K10's band segments.

    python -m parallel_genomeseq_tpu_torch.tools.walk_tiles [--reps 10] [--walks strip band]
        [--source PATH ...]

K14/K18 (``csrc/traceback.cu`` ``walk_strip_kernel``) stage a kTileRows x
kTileCols tile of move bytes a DRAM round trip and walk it from shared
memory, a warp a lane; K3/K10 (``walk_band_kernel``) gather the band of
move bytes within kBand columns of the diagonal, kSegRows rows a segment,
the next segment's loads in flight while the walk is in one. This tool
builds ``traceback.cu`` alone at each tile shape of SHAPES
(``-DPGS_WALK_TILE_ROWS/COLS``) and each segment of SEGMENTS
(``-DPGS_WALK_SEG_ROWS``, ``-DPGS_WALK_BAND``), and each extra ``--source`` (an earlier version
of the file, say) as it is, with nvcc into ``csrc/build/walk_tiles/``, all
builds started together. Each launch is timed as the mean of ``--reps``
launches after a warm-up, by CUDA events around each launch (the state
restored between them), the builds in their order and then in reverse, and
each build's result must equal the port's own kernel's.

``strip``: on solve_big's traceback shapes -- 100 reads of 10,000 bp with
about 1% substitutions and three 1-3 bp indels each, against the 20,000-bp
window that holds it -- the checkpointing sweep and one replay of every
strip, then one group walk launch of each tile build (and source).
``band``: the short-read main path's walk -- 512 reads of 125 bp (1%
substitutions, half with a 1-3 bp indel) against the 640-bp windows that
hold them, K2's (K7's) moves -- and the protein top 10 -- a 145-aa query
planted with 10% substitutions in 10 entries of 200-380 aa, BLOSUM50, K5's
(K9's) moves -- one K3 (K10) launch of each segment build (and source).
Linear scoring (3/-3/2; BLOSUM50 gap 12) and affine (BWA-MEM's 1/-4/6/1;
10/2). Prints the card's name and power limit, then one JSON line a
(walk, scoring, build): ms (both passes), the longest lane's steps, ns a
step.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..models.swaligner import BatchSWAligner
from ..ops import _build, profile_cuda, scan_dp, strips_cuda, traceback, wavefront_cuda
from ..ops.substitution import blosum_config
from ..utils.config import ScoringConfig

SHAPES = ((64, 64), (32, 32), (128, 64), (64, 128), (128, 128))
# (segment rows, band: the columns each side of the diagonal).
SEGMENTS = ((16, 1), (4, 1), (8, 1), (32, 1), (64, 1), (128, 2), (16, 2), (16, 3), (32, 2), (32, 3),
            (64, 2))
SCORING = {"linear": dict(match=3, mismatch=-3, gap=2),
           "affine": dict(match=1, mismatch=-4, gap_open=6, gap=1)}
PROTEIN = {"linear": dict(gap=12), "affine": dict(gap_open=10, gap=2)}
B, READ, WINDOW, REF = 100, 10_000, 20_000, 30_000
SHORT_B, SHORT_READ, SHORT_WINDOW, SHORT_REF = 512, 125, 640, 4_980


def seg_label(rows: int, band: int) -> str:
    return f"seg{rows}_band{band}"


def build(sources, out_dir: Path, walks):
    """{label: ctypes library}: traceback.cu at each of SHAPES (``strip`` in
    ``walks``) and SEGMENTS (``band``), and each of ``sources`` at its own
    shape, one nvcc each, all at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    own = _build.CSRC / "traceback.cu"
    jobs = {}
    if "strip" in walks:
        jobs.update({f"{r}x{c}": (own, [f"-DPGS_WALK_TILE_ROWS={r}",
                                        f"-DPGS_WALK_TILE_COLS={c}"]) for r, c in SHAPES})
    if "band" in walks:
        jobs.update({seg_label(r, w): (own, [f"-DPGS_WALK_SEG_ROWS={r}", f"-DPGS_WALK_BAND={w}"])
                     for r, w in SEGMENTS})
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
        for name in ("pgs_walk_strip_group", "pgs_walk_moves", "pgs_walk_moves_affine"):
            getattr(lib, name).argtypes = _build._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
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
        torch.cuda._sleep(1_000_000)
        start.record()
        launch(work)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) if k else 0.0
    return total / reps, work


def short_lanes(seed: int, dev):
    """(xs (512, 128), ys (512, 640), m, n) raw bytes: reads of 125 bp from a
    random 4,980-bp reference, 1% substitutions and half with a 1-3 bp
    indel, each against a 640-bp window that holds it."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, SHORT_REF)
    xs = np.ones((SHORT_B, 128), np.uint8)
    ys = np.empty((SHORT_B, SHORT_WINDOW), np.uint8)
    m = np.empty(SHORT_B, np.int32)
    for b in range(SHORT_B):
        at = int(rng.integers(0, SHORT_REF - SHORT_WINDOW))
        ys[b] = ref[at : at + SHORT_WINDOW]
        off = at + int(rng.integers(0, SHORT_WINDOW - SHORT_READ - 3))
        seg = ref[off : off + SHORT_READ].copy()
        subs = rng.random(SHORT_READ) < 0.01
        seg[subs] = rng.choice(acgt, int(subs.sum()))
        if b % 2:
            size, cut = int(rng.integers(1, 4)), int(rng.integers(20, SHORT_READ - 20))
            seg = (np.concatenate([seg[:cut], rng.choice(acgt, size), seg[cut:]])
                   if rng.random() < 0.5 else np.concatenate([seg[:cut], seg[cut + size :]]))
        xs[b, : len(seg)] = seg
        m[b] = len(seg)
    n = np.full(SHORT_B, SHORT_WINDOW, np.int32)
    return [torch.from_numpy(a).to(dev) for a in (xs, ys, m, n)]


def protein_top10(seed: int, affine: bool, dev):
    """(moves, x_mb, y_bn, i0, j0, max_steps) of the protein top-10 walk: a
    145-aa query planted with 10% substitutions in 10 entries of 200-380 aa,
    K5's (K9's) moves under BLOSUM50 with gap 12 (10/2)."""
    rng = np.random.default_rng(seed)
    cfg = blosum_config("blosum50", gap_penalty=PROTEIN["affine" if affine else "linear"]["gap"],
                        gap_open=10 if affine else 0)
    aa = np.frombuffer(cfg.alphabet[:20].encode(), np.uint8)
    query = rng.choice(aa, 145)
    entries = []
    for _ in range(10):
        size = int(rng.integers(200, 381))
        entry = rng.choice(aa, size)
        seg = query.copy()
        subs = rng.random(145) < 0.1
        seg[subs] = rng.choice(aa, int(subs.sum()))
        at = int(rng.integers(0, size - 145))
        entry[at : at + 145] = seg
        entries.append(entry.tobytes().decode())
    bat = BatchSWAligner(cfg, pad_m=128, device=dev)
    xs, ys, m, n = bat.pad_batch(entries, [query.tobytes().decode()])
    lut, table = scan_dp.profile_tables(cfg)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    moves_k = profile_cuda.sw_profile_affine_moves if affine else profile_cuda.sw_profile_moves
    _, i, j, moves = moves_k(t(lut[xs]), t(lut[ys]), t(m), t(n), table=t(table),
                             **PROTEIN["affine" if affine else "linear"])
    return moves, t(xs.T), t(ys), i, j, bat.max_steps(xs.shape[1], ys.shape[1])


def time_strips(args, libs, dev):
    """The group walk (K14, K18) of each build on solve_big's shapes."""
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
            print(json.dumps({"walk": "strip", "scoring": scoring, "build": label, "G": G,
                              "lanes": B, "steps": int(taken.sum()), "longest_steps": longest,
                              "ms": ms, "ns_per_step": min(ms) * 1e6 / longest}))
        del moves, ck
        torch.cuda.empty_cache()


def time_bands(args, libs, dev):
    """The full-matrix walk (K3, K10) of each build at the short-read main
    path's 512 lanes and at the protein top 10."""
    xs, ys, m, n = short_lanes(args.seed, dev)
    for scoring, kw in SCORING.items():
        affine = "gap_open" in kw
        cfg = ScoringConfig(match=kw["match"], mismatch=kw["mismatch"], gap_penalty=kw["gap"],
                            gap_open=kw.get("gap_open", 0))
        moves_k = wavefront_cuda.sw_score_affine_moves if affine else wavefront_cuda.sw_score_moves
        _, i, j, moves = moves_k(xs, ys, m, n, **kw)
        cases = {"short512": (moves, xs.T.contiguous(), ys, i, j,
                              BatchSWAligner(cfg, device=dev).max_steps(xs.shape[1], ys.shape[1])),
                 "top10": protein_top10(args.seed, affine, dev)}
        walk = traceback.walk_moves_affine if affine else traceback.walk_moves
        name = "pgs_walk_moves_affine" if affine else "pgs_walk_moves"
        for case, (mv, x_mb, y_bn, i0, j0, max_steps) in cases.items():
            want = walk(mv, x_mb, y_bn, i0, j0, max_steps=max_steps)
            longest = int(want[3].max())
            D, M, Bc = mv.shape
            out = [torch.empty_like(want[0]), torch.empty_like(want[1]),
                   torch.empty_like(want[2]), torch.empty_like(want[3])]
            i0c, j0c = i0.to(torch.int32).contiguous(), j0.to(torch.int32).contiguous()

            def launch(lib):
                err = getattr(lib, name)(
                    mv.data_ptr(), x_mb.data_ptr(), y_bn.data_ptr(), i0c.data_ptr(),
                    j0c.data_ptr(), D, M, y_bn.shape[1], Bc, max_steps, out[0].data_ptr(),
                    out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                _build.check(err, name)

            times = {label: [] for label in libs}
            for order in (list(libs), list(libs)[::-1]):
                for label in order:
                    for o in out:
                        o.fill_(0xFF if o.dtype == torch.uint8 else -1)
                    ms, _ = state_ms(lambda st, lib=libs[label]: launch(lib), (), args.reps)
                    if not all(torch.equal(a, b) for a, b in zip(out, want)):
                        raise AssertionError(f"{scoring} {case} {label}: the walk differs "
                                             "from the port's")
                    times[label].append(ms)
            for label, ms in times.items():
                print(json.dumps({"walk": "band", "scoring": scoring, "case": case,
                                  "build": label, "lanes": Bc, "max_steps": max_steps,
                                  "steps": int(want[3].sum()), "longest_steps": longest,
                                  "ms": ms, "ns_per_step": min(ms) * 1e6 / max(1, longest)}))
        del moves, cases
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--walks", nargs="+", choices=("strip", "band"), default=["strip", "band"])
    ap.add_argument("--source", action="append", default=[],
                    help="another traceback.cu to time at its own shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("walk_tiles needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    libs = build(args.source, _build.BUILD_DIR / "walk_tiles", args.walks)
    mine = lambda keep: {k: v for k, v in libs.items() if keep(k) or k in args.source}
    if "strip" in args.walks:
        time_strips(args, mine(lambda k: not k.startswith("seg")), dev)
    if "band" in args.walks:
        time_bands(args, mine(lambda k: k.startswith("seg")), dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
