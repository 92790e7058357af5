"""serve on PyTorch/CUDA: a long-lived alignment server. It loads the
reference and the protein database once, builds and warms every serving
path before it listens, then answers ``align`` and ``scan_db`` requests over
a Unix socket for the life of the process.

The port of the JAX package's ``cli/serve.py``: the same newline-delimited
JSON protocol (one object a line, one reply a request), the same ops and
replies, and the same flags with ``--device`` in place of ``--platform``
(default: the CUDA card; ``--device cpu`` runs the plain PyTorch route).

  {"op": "ping"}
      -> {"ok": true, "backend": "cuda (NVIDIA H100 80GB HBM3)",
          "reads_served": 0, "ref_len": ..., "batch_size": ...,
          "protein_db_entries": ..., "load_s": ..., "warmup_s": ...}
  {"op": "align", "reads": ["ACGT...", ...],
   "ref": "...",          # optional: align against this instead
   "traceback": true,     # optional (default true): pos and consensus
   "npiece": 0}           # optional: windows (0 = the server's --npiece)
      -> {"ok": true, "wall_s": ..., "results": [{"score": 72.0, "pos": p,
          "max_i": i, "max_j": j, "consensus_x": "...",
          "consensus_y": "..."}, ...]}
  {"op": "scan_db", "query": "MKT...",
   "top": 10,             # optional: the top-K hits inline
   "traceback": true,     # optional: pos_pred and consensus in the hits
   "output": "hits.csv"}  # optional: every row's CSV, see below
      -> {"ok": true, "wall_s": ..., "gcups": ..., "n_entries": ...,
          "hits": [{"name": ..., "len": ..., "score": ..., "pos_end": ...},
          ...], "output": ..., "n_rows": ...}
  {"op": "shutdown"}
      -> {"ok": true}, and the server exits.

``align`` runs the preloaded reference in ``--npiece`` windows
(``ChunkedAligner``: K1, then K2 and the K3 walk on the winners) and any
other reference whole (``BatchSWAligner``: K2 and K3, or K1 alone without
traceback); under ``--gap-open`` K6, K7 and K10, under ``--matrix`` K4, K5
and K3 (K8, K9, K10). Only the preloaded string object is windowed: a
``ref`` sent in a request is a new object and runs whole even when it
equals the preloaded one, as the JAX server's ``ref is self.ref`` does. A
request's ``npiece`` > 1 windows any reference. ``scan_db`` scans the
resident slab (``ResidentProteinDB``: one K8 launch under the default 10/2,
K4 with ``--db-gap-open 0``, K22 or K19 for a query over 2,048 aa), ranks
entries by score with ties in database order, and with ``traceback``
re-runs the top K with x = entry, y = query (K9 and K10, or K5 and K3;
entries over 2,048 aa walk in strips) and checks that each re-run scores
what the scan did.

Where the port differs from the JAX server:

- **Output path.** A ``scan_db`` ``output`` is refused unless the server
  was started with ``--output-dir``, and must then be a plain file name,
  written inside that directory: an absolute path, ``..`` or a path
  separator is refused. The JAX server writes wherever the client says.
- **CSV after the check.** The CSV (``solve_uniprot --traceback-top 0``'s,
  byte for byte) is written only after the traceback rescore check passed;
  the JAX server writes it first.
- **Residues.** GCUPS counts ``ResidentProteinDB.residues``, computed once,
  not a sum over the entries on every request.
- **Line cap.** A request line longer than ``MAX_REQUEST_BYTES`` (256 MiB,
  above 5,120 reads of 10 kb) gets ``{"ok": false, "error": ...}`` and its
  connection is closed; the server stays up. The JAX server buffers
  without limit.
- **Warm-up.** Every serving path runs once before the socket listens:
  align with and without traceback, the windowed aligner and a warm
  ``scan_db`` with traceback, so the kernels' build and each first launch
  are paid before the first client.
- ``--db-batch-size`` and ``--db-pad-mult`` are accepted so that JAX
  command lines run unchanged, and do nothing: the resident slab has no
  batches or padding.

Queueing (as the JAX server): one connection is served at a time, on the
thread that built the engines; a second client waits in the listen backlog
until the first closes its connection. A malformed request, an unknown op
or a failed request gets ``ok: false``; a client that disconnects
mid-reply drops only its own connection.

Usage:
    python -m parallel_genomeseq_tpu_torch.cli.serve --socket /tmp/pgs.sock \\
        --ref data/genome.fa --warm-read-len 125 [--protein-db db.fasta \\
        --output-dir out/] &
    python -m parallel_genomeseq_tpu_torch.cli.serve --socket /tmp/pgs.sock \\
        --client align --reads-file reads.txt
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import sys
import time

import numpy as np
import torch

from ..models.protein_db import ResidentProteinDB, write_uniprot_csv
from ..models.swaligner import BatchSWAligner, round_up
from ..parallel.chunking import ChunkedAligner
from ..seqio.readers import read_fasta
from ..seqio.uniprot import iter_database
from ..utils.device import resolve_device
from ..utils.encoding import to_bytes
from . import common
from .solve_uniprot import tb_chunks

# The longest request line the server reads before it refuses the request
# and closes the connection (256 MiB, above 5,120 reads of 10 kb).
MAX_REQUEST_BYTES = 256 * 2**20
WARM_PROTEIN = "ACDEFGHIKLMNPQRSTVWY"  # the warm scan's query, repeated


# ---------------------------------------------------------------------------
# client side (copied from serve.py:56-84)
# ---------------------------------------------------------------------------

def request(sock_path: str, obj: dict, timeout: float = 600.0) -> dict:
    """Send one JSON request to a running server and return its reply."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(sock_path)
        s.sendall(json.dumps(obj).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def wait_ready(sock_path: str, timeout: float = 600.0) -> dict:
    """Block until the server answers a ping (start-up includes warm-up)."""
    deadline = time.time() + timeout
    last_err = None
    while time.time() < deadline:
        try:
            return request(sock_path, {"op": "ping"}, timeout=30.0)
        except (OSError, json.JSONDecodeError) as e:
            last_err = e
            time.sleep(0.25)
    raise TimeoutError(f"server at {sock_path} not ready: {last_err}")


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

class AlignServer:
    """Holds the warmed aligners, the preloaded reference and the resident
    protein database; answers requests (``handle``)."""

    def __init__(self, cfg, chunk_cfg, ref: str, batch_size: int = 128,
                 warm_read_len: int = 0, protein_db=None, output_dir=None,
                 device=None, warm_query_len: int = 0, load_s: float = 0.0):
        self.cfg = cfg
        self.chunk_cfg = chunk_cfg
        self.ref = ref
        self.batch_size = batch_size
        self.output_dir = output_dir
        self.reads_served = 0
        self.load_s = load_s
        self.warmup_s = 0.0
        self._batch = BatchSWAligner(cfg, device=device)
        self.device = self._batch.device
        self._chunked = (ChunkedAligner(cfg=cfg, chunk=chunk_cfg, device=self.device)
                         if chunk_cfg.npiece > 1 else None)
        self.protein_db = protein_db
        self._protein_bat = None  # the scan_db traceback aligner, built on first use
        read_len = warm_read_len if ref else 0
        query_len = warm_query_len if protein_db is not None else 0
        if read_len or query_len:
            self.warmup(read_len, query_len)

    def warmup(self, read_len: int, query_len: int):
        """Run every serving path once, so that the kernels' build and each
        first launch are paid before the first client: align with and
        without traceback and the windowed aligner on one batch of
        ``read_len``-bp reads, and a ``scan_db`` with traceback of a
        ``query_len``-aa query. Raises if the warm scan fails."""
        t0 = time.perf_counter()
        if read_len:
            rng = np.random.default_rng(0)
            reads = ["".join(rng.choice(list("ACGT"), size=read_len))
                     for _ in range(self.batch_size)]
            self._batch.align_batch(reads, [self.ref], traceback=True)
            self._batch.align_batch(reads, [self.ref], traceback=False)
            if self._chunked is not None:
                self._chunked.align_batch(reads, self.ref)
        if query_len:
            q = (WARM_PROTEIN * (query_len // len(WARM_PROTEIN) + 1))[:max(query_len, 8)]
            rep = self.handle({"op": "scan_db", "query": q, "top": 1, "traceback": True})
            if not rep["ok"]:
                raise RuntimeError(f"warm scan failed: {rep['error']}")
        self.warmup_s = time.perf_counter() - t0
        print(f"serve: warmup done in {self.warmup_s:.1f}s (read_len={read_len}, "
              f"batch={self.batch_size}, ref={len(self.ref)}bp, query_len={query_len}) "
              f"on {self.device}", flush=True)

    def backend(self) -> str:
        """The device type, and the card's name on a card."""
        if self.device.type == "cuda":
            return f"cuda ({torch.cuda.get_device_name(self.device)})"
        return self.device.type

    def _align(self, req: dict) -> dict:
        reads = req.get("reads") or []
        if not isinstance(reads, list) or not reads or not all(
            isinstance(r, str) and r for r in reads
        ):
            return {"ok": False, "error": "reads must be non-empty strings"}
        ref = req.get("ref") or self.ref
        if not ref:
            return {"ok": False, "error": "no reference (server started "
                    "without --ref and request has no 'ref')"}
        traceback = bool(req.get("traceback", True))
        npiece = int(req.get("npiece", 0))
        # Windows: a request's npiece > 1, or the server's on the preloaded
        # string object itself (serve.py:152-153).
        al = self._batch
        if npiece > 1 and (self._chunked is None or npiece != self.chunk_cfg.npiece):
            al = ChunkedAligner(cfg=self.cfg, chunk=dataclasses.replace(self.chunk_cfg,
                                                                        npiece=npiece),
                                device=self.device)
        elif npiece > 1 or (npiece == 0 and self._chunked is not None and ref is self.ref):
            al = self._chunked
        t0 = time.perf_counter()
        results = []
        for batch in common.batched(reads, self.batch_size):
            if al is self._batch:
                results.extend(al.align_batch(batch, [ref], traceback=traceback))
            else:
                results.extend(al.align_batch(batch, ref, traceback=traceback))
        self.reads_served += len(reads)
        return {
            "ok": True,
            "wall_s": round(time.perf_counter() - t0, 6),
            "results": [
                {
                    "score": r.score, "pos": r.pos,
                    "max_i": r.max_i, "max_j": r.max_j,
                    "consensus_x": r.consensus_x, "consensus_y": r.consensus_y,
                }
                for r in results
            ],
        }

    def _output_path(self, name):
        """The server-side path of a scan_db ``output``, or (None, error)."""
        if self.output_dir is None:
            return None, "output refused: server started without --output-dir"
        if not isinstance(name, str) or name in (".", "..") or "/" in name or os.sep in name:
            return None, ("output must be a plain file name inside the server's "
                          "--output-dir (no path separator, no '..')")
        return os.path.join(self.output_dir, name), None

    def _scan_db(self, req: dict) -> dict:
        db = self.protein_db
        if db is None:
            return {"ok": False, "error": "server started without --protein-db"}
        q = req.get("query")
        if not isinstance(q, str) or not q:
            return {"ok": False, "error": "query must be a non-empty protein string"}
        out_path = None
        if req.get("output"):
            out_path, err = self._output_path(req["output"])
            if err:
                return {"ok": False, "error": err}
        try:
            scores, pos, wall = db.scan_scores(q)
        except ValueError as e:
            return {"ok": False, "error": str(e)}
        gcups = len(q) * db.residues / wall / 1e9 if wall else 0.0
        # Entry indices, ties in database order (names can repeat in a FASTA).
        ranked = [int(k) for k in np.argsort(-scores, kind="stable")
                  [: max(int(req.get("top", 10)), 0)]]
        reply = {
            "ok": True,
            "wall_s": round(wall, 6),
            "gcups": round(gcups, 2),
            "n_entries": len(db.entries),
            "hits": [
                {"name": db.entries[k][0], "len": len(db._seqs[k]),
                 "score": int(scores[k]), "pos_end": int(pos[k])}
                for k in ranked
            ],
        }
        if bool(req.get("traceback", False)) and ranked:
            # solve_uniprot's --traceback-top columns: the top K re-run with
            # x = entry, y = query and pad_m = 128, batched as it batches them.
            if self._protein_bat is None:
                self._protein_bat = BatchSWAligner(db.cfg, pad_m=128, device=db.device)
            chunks = tb_chunks(ranked, db.entries, self.batch_size,
                               round_up(len(to_bytes(q)), 128))
            batches = ([db.entries[k][1] for k in chunk] for chunk in chunks)
            res_tb = [r for rs in self._protein_bat.align_stream(batches, [q]) for r in rs]
            for h, r in zip(reply["hits"], res_tb):
                if int(r.score) != h["score"]:
                    return {"ok": False, "error":
                            f"traceback rescore mismatch on {h['name']}: "
                            f"{int(r.score)} != {h['score']}"}
                h["pos_pred"] = r.pos
                h["consensus_x"] = r.consensus_x
                h["consensus_y"] = r.consensus_y
        if out_path is not None:
            # Every row, the traceback columns empty: the file that
            # solve_uniprot --traceback-top 0 writes.
            write_uniprot_csv(out_path, db.entries, scores, pos)
            reply["output"] = out_path
            reply["n_rows"] = len(db.entries)
        return reply

    def handle(self, req) -> dict:
        if not isinstance(req, dict):
            return {"ok": False, "error": "a request is one JSON object"}
        op = req.get("op")
        if op == "ping":
            return {
                "ok": True,
                "backend": self.backend(),
                "reads_served": self.reads_served,
                "ref_len": len(self.ref),
                "batch_size": self.batch_size,
                "protein_db_entries": (
                    len(self.protein_db.entries) if self.protein_db else 0
                ),
                "load_s": round(self.load_s, 6),
                "warmup_s": round(self.warmup_s, 6),
            }
        if op == "align":
            return self._align(req)
        if op == "scan_db":
            return self._scan_db(req)
        if op == "shutdown":
            return {"ok": True, "_shutdown": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


def _serve_connection(server: AlignServer, conn) -> bool:
    """Answer the requests of one connection until the client closes it, a
    line passes MAX_REQUEST_BYTES or a shutdown is asked for. Returns
    whether to shut down."""
    buf = bytearray()
    scanned = 0  # bytes of buf already searched for a newline
    while True:
        nl = buf.find(b"\n", scanned)
        if nl < 0:
            if len(buf) > MAX_REQUEST_BYTES:
                break
            scanned = len(buf)
            chunk = conn.recv(1 << 20)
            if not chunk:
                return False
            buf += chunk
            continue
        line = bytes(buf[:nl])
        del buf[: nl + 1]
        scanned = 0
        if len(line) > MAX_REQUEST_BYTES:
            break
        if not line.strip():
            continue
        try:
            reply = server.handle(json.loads(line.decode()))
        except Exception as e:  # a failed request must not stop the server
            reply = {"ok": False, "error": repr(e)}
        shutdown = reply.pop("_shutdown", False)
        conn.sendall(json.dumps(reply).encode() + b"\n")
        if shutdown:
            return True
    conn.sendall(json.dumps({
        "ok": False, "error": f"request line exceeds {MAX_REQUEST_BYTES} bytes; "
        "connection closed"}).encode() + b"\n")
    return False


def serve_forever(server: AlignServer, sock_path: str):
    """Listen on ``sock_path`` (an existing file there is unlinked) and
    answer one connection at a time until a shutdown request."""
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    on_card = (torch.cuda.device(server.device) if server.device.type == "cuda"
               else contextlib.nullcontext())
    with on_card, socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as srv:
        srv.bind(sock_path)
        srv.listen(8)
        print(f"serve: listening on {sock_path}", flush=True)
        shutdown = False
        while not shutdown:
            conn, _ = srv.accept()
            with conn:
                try:
                    shutdown = _serve_connection(server, conn)
                except OSError as e:
                    # A client that disconnects mid-request drops only its
                    # own connection.
                    print(f"serve: client connection error: {e!r}", flush=True)
    os.unlink(sock_path)
    print("serve: shut down", flush=True)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--socket", default="/tmp/pgs_align.sock")
    p.add_argument("--ref", default="", help="reference FASTA to preload")
    p.add_argument("--warm-read-len", type=int, default=125,
                   help="warm the align paths with reads of this length (0 = skip)")
    p.add_argument("--client", choices=["ping", "align", "scan_db", "shutdown"], default=None,
                   help="act as a client against a running server instead")
    p.add_argument("--reads-file", default="", help="client align: one read per line")
    p.add_argument("--output", default="",
                   help="client align: CSV output path; client scan_db: the file name "
                   "the server writes every row's CSV to, inside its --output-dir")
    p.add_argument("--output-dir", default=None,
                   help="server: the directory scan_db 'output' files are written to "
                   "(without it, a request that sets 'output' is refused)")
    p.add_argument("--protein-db", default="",
                   help="FASTA protein database to load resident on the device at "
                   "startup; enables the scan_db op (--db-matrix, --db-gap-open, "
                   "--db-gap-extend scoring)")
    p.add_argument("--db-matrix", default="blosum50", choices=["blosum50", "blosum62"])
    p.add_argument("--db-gap-open", type=float, default=10.0)
    p.add_argument("--db-gap-extend", type=float, default=2.0)
    p.add_argument("--db-batch-size", type=int, default=4096,
                   help="accepted for the JAX server's command lines; no effect (the "
                   "resident slab has no batches)")
    p.add_argument("--db-pad-mult", type=int, default=128,
                   help="accepted for the JAX server's command lines; no effect (the "
                   "resident slab has no padding)")
    p.add_argument("--db-max-query-len", type=int, default=0,
                   help="accept scan_db queries up to this length (0 = 2,048; longer "
                   "queries scan with the strip kernels)")
    p.add_argument("--db-warm-len", type=int, default=144,
                   help="warm scan_db with a query of this length (0 = skip)")
    p.add_argument("--query", default="",
                   help="client scan_db: query protein string or FASTA path")
    p.add_argument("--top", type=int, default=10, help="client scan_db: top-K hits inline")
    p.add_argument("--traceback", action="store_true",
                   help="client scan_db: add pos_pred and the consensus strings to the hits")
    common.add_scoring_flags(p)
    common.add_chunk_flags(p, npiece_default=1)
    common.add_device_flags(p)
    return p


def _client(args) -> int:
    """The --client side (serve.py:378-429)."""
    if args.client == "align":
        with open(args.reads_file, encoding="ascii") as f:
            reads = [ln.strip() for ln in f if ln.strip()]
        rep = request(args.socket, {"op": "align", "reads": reads})
        if not rep.get("ok"):
            print(f"error: {rep.get('error')}", file=sys.stderr)
            return 1
        rows = rep["results"]
        if args.output:
            with open(args.output, "w", encoding="ascii") as f:
                f.write("read,pos_pred,score\n")
                for read, r in zip(reads, rows):
                    f.write(f"{read},{r['pos']},{r['score']:g}\n")
            print(f"wrote {len(rows)} rows to {args.output}")
        else:
            for read, r in zip(reads, rows):
                print(f"{read[:24]}... pos={r['pos']} score={r['score']:g}")
        print(f"{len(rows)} reads in {rep['wall_s']:.3f}s server-side "
              f"({len(rows)/max(rep['wall_s'], 1e-9):.0f} reads/s)")
        return 0
    if args.client == "scan_db":
        q = args.query
        looks_like_path = "/" in q or q.lower().endswith((".fa", ".fasta", ".faa"))
        if q and (os.path.isfile(q) or looks_like_path):
            q = read_fasta(q)  # a mistyped path errors here
        req = {"op": "scan_db", "query": q, "top": args.top, "traceback": args.traceback}
        if args.output:
            req["output"] = args.output
        rep = request(args.socket, req)
        print(json.dumps(rep))
        return 0 if rep.get("ok") else 1
    rep = request(args.socket, {"op": args.client})
    print(json.dumps(rep))
    return 0 if rep.get("ok") else 1


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.client:
        return _client(args)

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    ref = read_fasta(args.ref) if args.ref else ""
    protein_db = None
    if args.protein_db:
        protein_db = ResidentProteinDB(
            list(iter_database(args.protein_db)), matrix=args.db_matrix,
            gap_penalty=args.db_gap_extend, gap_open=args.db_gap_open,
            max_query_len=args.db_max_query_len or None, device=device,
        )
        print(f"serve: protein DB resident ({len(protein_db.entries)} entries, "
              f"{protein_db.slab_mb:.0f} MB slab, prep {protein_db.prep_s:.1f}s, "
              f"total {time.perf_counter() - t0:.1f}s)", flush=True)
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    server = AlignServer(
        cfg=common.scoring_from_args(args),
        chunk_cfg=common.chunk_from_args(args),
        ref=ref,
        batch_size=args.batch_size,
        warm_read_len=args.warm_read_len,
        protein_db=protein_db,
        output_dir=args.output_dir,
        device=device,
        warm_query_len=args.db_warm_len,
        load_s=time.perf_counter() - t0,
    )
    serve_forever(server, args.socket)
    return 0


if __name__ == "__main__":
    sys.exit(main())
