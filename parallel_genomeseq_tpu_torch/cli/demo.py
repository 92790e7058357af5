"""demo: a minimal end-to-end example on PyTorch/CUDA (the port of the JAX
package's ``cli/demo.py``; the same printed lines, ``--device`` in place of
``--platform``).

Runs the Wikipedia Smith-Waterman example GGTTGACTA vs TGTTACGG through the
aligner (K2 and the K3 walk on the card) and prints score, POS and the
consensus strings; then the same read through the chunked aligner against a
tandem reference (K1, K2, K3) and an FM-index lookup.

Usage: python -m parallel_genomeseq_tpu_torch.cli.demo [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from ..models.fm_index import FMIndex
from ..models.swaligner import SWAligner
from ..parallel.chunking import ChunkedAligner
from ..utils.config import ChunkConfig
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_device_flags(p)
    args = p.parse_args(argv)

    x, y = "GGTTGACTA", "TGTTACGG"
    res = SWAligner(device=args.device).align(x, y)
    print(f"SW {x} vs {y}:")
    print(f"  score = {res.score:.0f}  POS = {res.pos}")
    print(f"  consensus_x = {res.consensus_x}")
    print(f"  consensus_y = {res.consensus_y}")

    ref = y * 8
    chunked = ChunkedAligner(chunk=ChunkConfig(npiece=2, overlap_ratio=2.0), device=args.device)
    cres = chunked.align_batch([x], ref)[0]
    print(f"chunked vs {len(ref)}-bp tandem reference: score {cres.score:.0f} pos {cres.pos}")

    fm = FMIndex(ref)
    print(f"FM-index: 'GTTAC' occurs at {fm.locate('GTTAC')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
