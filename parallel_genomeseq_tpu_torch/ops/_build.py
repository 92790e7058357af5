"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source under ``csrc/`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, at first use, into
``csrc/build/``; ``ctypes`` binds it. Nothing here runs at import time, so
modules that hold a wrapper import on machines with no CUDA toolkit, and the
CPU route never touches this file. A missing ``nvcc`` or a failed build
raises: there is no fallback to the plain PyTorch versions.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every pointer and the stream are c_void_p (a c_int would
# truncate a 64-bit address), every size and score an int.
_SIGNATURES = {
    # x_mb, y_nb, m, n, hcol, M, N, B, match, mismatch, gap, track_pos,
    # score, best_i, best_j, moves, stream
    "pgs_sw_score": [_P] * 5 + [_I] * 7 + [_P] * 5,
    # moves, x_mb, y_bn, i0, j0, D, M, N, B, max_steps, pos, cx, cy, steps, stream
    "pgs_walk_moves": [_P] * 5 + [_I] * 5 + [_P] * 5,
}

_lib = None


def sources():
    return sorted(CSRC.glob("*.cu"))


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
    the library there is newer than every source. Returns the library path;
    the compiler's resource report (``-Xptxas -v``) is kept beside it in
    ``nvcc.log``."""
    so = Path(build_dir or BUILD_DIR) / LIB_NAME
    srcs = sources()
    if so.exists() and so.stat().st_mtime >= max(s.stat().st_mtime for s in srcs):
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (so.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
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
