"""Sequence <-> uint8 encoding and padding sentinels (copied from the JAX
package's ``parallel_genomeseq_tpu/utils/encoding.py``; behaviour unchanged).

Sequences are kept as raw ASCII bytes (uint8). The padding sentinels can
never match each other or any real sequence byte (printable, >= 33).
"""

from __future__ import annotations

import numpy as np

X_PAD = np.uint8(1)  # sentinel for padded read (short-sequence) positions
Y_PAD = np.uint8(2)  # sentinel for padded reference (long-sequence) positions


def to_bytes(seq: str) -> np.ndarray:
    """ASCII string -> (len,) uint8 array."""
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8).copy()


def from_bytes(arr) -> str:
    """uint8 array -> ASCII string (stops at first NUL)."""
    b = bytes(np.asarray(arr, dtype=np.uint8))
    nul = b.find(b"\x00")
    return (b[:nul] if nul >= 0 else b).decode("ascii")


_RC = np.arange(256, dtype=np.uint8)
for _a, _b in ((ord("A"), ord("T")), (ord("C"), ord("G")),
               (ord("a"), ord("t")), (ord("c"), ord("g"))):
    _RC[_a], _RC[_b] = _b, _a
# N (and any non-ACGT byte) maps to itself.


def revcomp(seq):
    """Reverse complement. str -> str, uint8 array -> uint8 array.
    A<->T, C<->G (case preserved); other bytes (N, ...) map to themselves."""
    if isinstance(seq, str):
        return from_bytes(revcomp(to_bytes(seq)))
    return _RC[np.asarray(seq, np.uint8)][::-1].copy()


def batch_pad(seqs, length: int, fill: np.uint8) -> np.ndarray:
    """List of uint8 arrays -> (len(seqs), length) uint8 matrix."""
    out = np.full((len(seqs), length), fill, dtype=np.uint8)
    for k, s in enumerate(seqs):
        out[k, : s.shape[0]] = s
    return out
