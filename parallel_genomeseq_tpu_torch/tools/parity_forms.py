"""Time K26, the reference-parity sweep, at ``chip_smoke.py`` phase 12's
shapes: its score-only windows in both forms, and its skewed argmax and
moves in this checkout's build against other checkouts', interleaved.

    python -m parallel_genomeseq_tpu_torch.tools.parity_forms [--against DIR ...] [--reps 20]
        [--rounds 2] [--sass]

Data: the port's synthetic short-read set at phase 3's reference length (a
4,980-bp reference, 512 reads of 125 bp, seed 0, written by
``utils.synth.write_dataset`` under ``data/parity_forms/``), cut as phase 12
cuts it: the 8,704 window lanes of ``solve_small --semantics sat_uint8``
(17 windows), the 512 reads against the whole reference (``--parity-mode
skewed``) and the plateau (512 stretches of the reference against it),
scored with the clipped operands of (3, -3, 2) under saturation.

Each build is the K26 unit alone (``csrc/wavefront_parity.cu`` and the
headers beside it), compiled by ``nvcc`` with the port's flags into
``data/parity_forms/<name>/``; each ``--against DIR`` adds DIR's
(``DIR/parallel_genomeseq_tpu_torch/csrc``, called as its own wrapper calls
its ``pgs_sw_score_parity``, with or without the ``pair`` argument), named
by DIR's last part. The cases run in rounds, this build then the others,
then the others in reverse and this one, and so on; each time is the mean of ``--reps`` launches after a warm-up, by
CUDA events. The skewed cases run with the key at the wrap row (tie code
1; the first form's only rule) and with every cell's key (tie code 2).
Every launch's (score, i, j) and moves equal this build's in the same case,
and the score-only windows' pair form its int32 form's. Prints the card's
name and power limit, one JSON line a case (ms by build and form, each
round's), and with ``--sass`` each build's registers and SASS instruction
count of K26's int32 argmax and moves kernels at 4 rows a thread and one
warp a lane (the ``-Xptxas -v`` report, ``cuobjdump -sass``).
"""

from __future__ import annotations

import argparse
import csv
import ctypes
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, scan_dp
from .nw_shapes import mean_ms, smi

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "data" / "parity_forms"
_P, _I = ctypes.c_void_p, ctypes.c_int
# K26's int32 kernels at 4 rows a thread and one warp a lane: (track_pos,
# moves, affine, rows, warps, table, parity) in the mangled name.
KERNELS = {"argmax": "sw_warp_kernelILb1ELb0ELb0ELi4ELi1ELb0ELb1E",
           "moves": "sw_warp_kernelILb1ELb1ELb0ELi4ELi1ELb0ELb1E"}


def start_build(name: str, csrc: Path):
    """Start nvcc on the K26 unit of ``csrc``, into OUT / name: (process,
    library path, csrc)."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libk26.so"
    flags = [f for f in _build.COMPILE_FLAGS if f != "-c"]
    proc = subprocess.Popen([_build.find_nvcc(), *flags, "-shared", "-o", str(so),
                             str(csrc / "wavefront_parity.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so, csrc


def finish_build(proc, so: Path, csrc: Path):
    """(ctypes library, takes the pair argument, library path, ptxas
    report) of a build start_build began."""
    report = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{report[-4000:]}")
    text = (csrc / "wavefront.cu").read_text()
    entry = text[text.index('extern "C" int pgs_sw_score_parity('):]
    pair_arg = "int pair" in entry[: entry.index(")")]
    lib = ctypes.CDLL(str(so))
    lib.pgs_sw_score_parity.argtypes = ([_P] * 4 + [_I] * 6 + [_P]
                                        + [_I] * (7 if pair_arg else 6) + [_P] * 5)
    lib.pgs_sw_score_parity.restype = _I
    return lib, pair_arg, so, report


def kernel_report(so: Path, ptxas: str) -> dict:
    """Registers and SASS instructions of the KERNELS in a build."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    funcs = re.split(r"\n\s+Function : ", sass)
    out = {}
    for label, key in KERNELS.items():
        body = next(f for f in funcs if key in f.splitlines()[0])
        regs = re.search(re.escape(key) + r"[^\n]*\n[^\n]*\n[^\n]*\n[^\n]*Used (\d+) registers",
                         ptxas)
        out[label] = {"sass_instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/ ", body)),
                      "registers": int(regs.group(1)) if regs else None}
    return out


def data(dev):
    """The phase 12 inputs: {case: (xs, ys, m, n)} on the card."""
    from ..models.swaligner import BatchSWAligner
    from ..parallel.chunking import ChunkConfig, ChunkedAligner
    from ..utils.config import ScoringConfig, Semantics
    from ..utils.synth import write_dataset

    ref_path, csv_path = write_dataset(OUT / "data", ref_len=4980, n_reads=512,
                                       read_len=(125, 125), seed=0)
    ref = "".join(l.strip() for l in open(ref_path) if not l.startswith(">"))
    with open(csv_path, newline="") as f:
        reads = [r["SEQ"] for r in csv.DictReader(f)]
    sat = ScoringConfig(semantics=Semantics.SAT_UINT8)
    aligner = BatchSWAligner(sat, tie="skewed", device=dev)
    chunked = ChunkedAligner(sat, chunk=ChunkConfig(npiece=17, overlap_ratio=2.0), device=dev)
    starts = np.random.default_rng(3).integers(0, len(ref) - 125, len(reads))
    copies = [ref[o : o + 125] for o in starts]

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    return {"windows": on_card(*chunked.window_lanes(reads, ref)[:4]),
            "npiece1": on_card(*aligner.pad_batch(reads, [ref])),
            "plateau": on_card(*aligner.pad_batch(copies, [ref]))}


# (label, lanes, mode, tie code, pair): the launches phase 12 times, the
# skewed ones also with every cell's key.
CASES = [("windows_score_only", "windows", "score_only", 0, True),
         ("windows_score_only", "windows", "score_only", 0, False),
         ("windows_skewed", "windows", "track_pos", 1, False),
         ("windows_skewed", "windows", "track_pos", 2, False),
         ("npiece1_skewed_argmax", "npiece1", "track_pos", 1, False),
         ("npiece1_skewed_argmax", "npiece1", "track_pos", 2, False),
         ("npiece1_skewed", "npiece1", "moves", 1, False),
         ("npiece1_skewed", "npiece1", "moves", 2, False),
         ("plateau_skewed", "plateau", "moves", 1, False),
         ("plateau_skewed", "plateau", "moves", 2, False)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another checkout's root, whose K26 build is timed beside this one")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"))
    started = {"this": start_build("this", _build.CSRC)}
    for root in args.against:
        started[root.name] = start_build(root.name,
                                         root / "parallel_genomeseq_tpu_torch" / "csrc")
    builds = {name: finish_build(*b) for name, b in started.items()}
    if args.sass:
        for name, (_, _, so, ptxas) in builds.items():
            print(json.dumps({"build": name, **kernel_report(so, ptxas)}))
    match, mismatch, gap = scan_dp.sat_operands(3, -3, 2)
    lanes = data(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(build_name, case, pair):
        lib, pair_arg, _, _ = builds[build_name]
        _, key, mode, tcode, _ = case
        xs, ys, m, n = lanes[key]
        B, M = xs.shape
        N = ys.shape[1]
        outs = [torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(3)]
        moves = (torch.zeros((M + N - 1, M, B), dtype=torch.uint8, device=dev)
                 if mode == "moves" else None)
        extra = [int(pair)] if pair_arg else []
        args_ = (xs.data_ptr(), ys.data_ptr(), m.data_ptr(), n.data_ptr(), M, N, B, match,
                 mismatch, gap, None, 0, int(mode != "score_only"), 1, tcode, *extra, 0, 0,
                 *(o.data_ptr() for o in outs), moves.data_ptr() if moves is not None else None,
                 stream)

        def run():
            err = lib.pgs_sw_score_parity(*args_)
            if err:
                raise RuntimeError(f"{build_name}: pgs_sw_score_parity returned {err}")
            return outs, moves

        return run

    order = []
    for r in range(args.rounds):  # this, the others, the others reversed, this, ...
        names = list(builds)
        order += names if r % 2 == 0 else names[::-1]
    score_only = None  # the pair form's windows, held to the int32 form's
    for case in CASES:
        label, _, mode, tcode, pair = case
        want = None
        rec = {"case": label, "form": "pair" if pair else "int32",
               "key": {0: None, 1: "wrap_row", 2: "every_cell"}[tcode], "rounds": {}}
        for name in order:
            if pair and not builds[name][1]:
                continue  # a build with no pair form
            run = launcher(name, case, pair)
            outs, moves = run()
            got = [o.clone() for o in outs] + ([moves.clone()] if moves is not None else [])
            if want is None:
                want = got
            elif not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label}: build {name!r} differs")
            rec["rounds"].setdefault(name, []).append(mean_ms(run, args.reps))
        if mode == "score_only":
            if score_only is not None and not all(
                    torch.equal(g, w) for g, w in zip(want, score_only)):
                raise AssertionError("the score-only windows' two forms differ")
            score_only = want
        rec["ms"] = {k: float(np.mean(v)) for k, v in rec["rounds"].items()}
        print(json.dumps(rec))
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
