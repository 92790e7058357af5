"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source under ``csrc/`` for Hopper (``sm_90a``), one
process per source in parallel, and links them into one shared library with
a plain C interface, at first use, into ``csrc/build/``; ``ctypes`` binds
it. Nothing here runs at import time, so modules that hold a wrapper import
on machines with no CUDA toolkit, and the CPU route never touches this file.
A missing ``nvcc`` or a failed build raises: there is no fallback to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
LIB_NAME = "libpgs_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argtypes; every pointer and the stream are c_void_p (a c_int would
# truncate a 64-bit address), every size and score an int, byte counts 64-bit.
_SIGNATURES = {
    # xs, ys, m, n, M, N, B, match, mismatch, gap_open, gap, table, ncodes,
    # track_pos, lanes, warps, score, best_i, best_j, moves, stream
    "pgs_sw_score": [_P] * 4 + [_I] * 7 + [_P] + [_I] * 4 + [_P] * 5,
    # M, B, affine, mode, ncodes, lanes, warps, out (int32 rows, lanes,
    # warps, blocks per SM, smem)
    "pgs_sw_score_shape": [_I] * 7 + [_P],
    # K26: xs, ys, m, n, M, N, B, match, mismatch, gap, table, ncodes,
    # track_pos, sat, skewed, pair, lanes, warps, score, best_i, best_j,
    # moves, stream
    "pgs_sw_score_parity": [_P] * 4 + [_I] * 6 + [_P] + [_I] * 7 + [_P] * 5,
    # M, B, mode, ncodes, pair, lanes, warps, out (as pgs_sw_score_shape's)
    "pgs_sw_score_parity_shape": [_I] * 7 + [_P],
    # x, x_lane, y, y_off, y_len, m, n, table, ncodes, M, N, B, gap_open,
    # gap, score, best_i, best_j, stream
    "pgs_sw_profile_scan": [_P, _L, _P, _P, _L, _P, _P, _P] + [_I] * 6 + [_P] * 4,
    # M, ncodes, affine, shared, out (int32 g, r, threads, blocks per SM, profile)
    "pgs_sw_profile_scan_shape": [_I] * 4 + [_P],
    # moves, x_mb, y_bn, i0, j0, D, M, N, B, max_steps, pos, cx, cy, steps, stream
    "pgs_walk_moves": [_P] * 5 + [_I] * 5 + [_P] * 5,
    "pgs_walk_moves_affine": [_P] * 5 + [_I] * 5 + [_P] * 5,
    # x, x_lane, y, y_off, y_len, m, n, M, N, B, table, ncodes, match,
    # mismatch, gap_open, gap, bound, bound_off, ck, fck, nck, score, best_i,
    # best_j, sat, skewed, pair (K27), stream
    "pgs_strip_sweep": [_P, _L, _P, _P, _L, _P, _P] + [_I] * 3 + [_P] + [_I] * 5
    + [_P] * 4 + [_I] + [_P] * 3 + [_I] * 3 + [_P],
    # M, ckpt, affine, ncodes, parity, pair, out (int32 threads, passes,
    # blocks per SM, rows)
    "pgs_strip_sweep_occupancy": [_I] * 6 + [_P],
    # x, y, m, n, M, N, B, G, first, hrow, frow, ld_lane, ld_strip, row_first,
    # walk_i, walk_j, walk_active, table, ncodes, match, mismatch, gap_open,
    # gap, moves, stream
    "pgs_strip_moves": [_P] * 4 + [_I] * 5 + [_P, _P, _L, _L, _I] + [_P] * 4 + [_I] * 5
    + [_P] * 2,
    # affine, ncodes, out (int32 warps a block, blocks per SM)
    "pgs_strip_moves_occupancy": [_I] * 2 + [_P],
    # moves, x_mb, y_bn, M, N, B, G, base0, max_steps, i, j, pos, active,
    # steps, gstate (null for K14), cx, cy, stream
    "pgs_walk_strip_group": [_P] * 3 + [_I] * 6 + [_P] * 9,
    # B, out (int32 K14/K18's tile rows, tile columns, lanes a block,
    # blocks, K14/K18's shared bytes a block, K3/K10's segment rows and band)
    "pgs_walk_shape": [_I, _P],
    # x, y, lanes, chunk_lane, chunks, rows, warps, table, gap, bound (null:
    # no lane has two chunks), ticket, out, sm_of_block (null: not recorded),
    # stream
    "pgs_nw_lastrow": [_P] * 4 + [_I] * 3 + [_P, _I] + [_P] * 5,
}

_lib = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """``$NVCC``, else ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``. Raises FileNotFoundError if none exists."""
    explicit = os.environ.get("NVCC")
    if explicit:
        if not os.access(explicit, os.X_OK):
            raise FileNotFoundError(f"NVCC={explicit} is not an executable")
        return explicit
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise FileNotFoundError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels cannot be "
        "built, and CUDA tensors have no other route"
    )


def build(build_dir=None) -> Path:
    """Compile the kernels into ``build_dir`` (default ``csrc/build``) unless
    the library there is newer than every source and header: one ``nvcc
    -c`` per source, all started together, then one link into the shared
    library. Returns the library path; the compilers' resource reports
    (``-Xptxas -v``) are kept beside it in ``nvcc.log``."""
    so = Path(build_dir or BUILD_DIR) / LIB_NAME
    srcs = sources()
    if so.exists() and so.stat().st_mtime >= max(s.stat().st_mtime for s in srcs + headers()):
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{s.stem}.{tag}.o") for s in srcs]
    cmds = [[nvcc, *COMPILE_FLAGS, "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = so.with_name(f"{LIB_NAME}.{tag}")
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if not failed:
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        outs.append(proc.stdout)
        if proc.returncode:
            failed = [(link, proc.returncode, proc.stdout)]
    (so.parent / "nvcc.log").write_text("".join(outs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees old or new, never half
    return so


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pgs_error_string.argtypes = [_I]
        lib.pgs_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        msg = load().pgs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
