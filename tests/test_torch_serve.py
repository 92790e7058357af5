"""The port's alignment server (``parallel_genomeseq_tpu_torch.cli.serve``)
on the CPU: servers in threads of this process and one subprocess, talked
to over their Unix sockets, held to the JAX package's server and CLI on the
same seeded inputs -- a 600-bp reference and 24-bp reads (linear and
BWA-MEM's affine scoring), a 400-aa protein reference aligned under
BLOSUM50 10/2, and a 7-entry protein database with a planted hit. The
``results`` and ``hits`` of a reply must be the JAX server's JSON text; the
``output`` CSV the JAX ``solve_uniprot --traceback-top 0``'s bytes. Then the
hardening cases, each followed by a ping."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.cli import solve_uniprot as jax_uniprot
from parallel_genomeseq_tpu.cli.serve import AlignServer as JaxServer
from parallel_genomeseq_tpu.models.protein_db import ResidentProteinDB as JaxDB
from parallel_genomeseq_tpu.ops.substitution import blosum_config as jax_blosum
from parallel_genomeseq_tpu.utils.config import ChunkConfig as JaxChunkConfig
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxScoringConfig
from parallel_genomeseq_tpu_torch.cli import serve
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AMINO = list("ARNDCQEGHILKMFPSTWYV")
BWA_FLAGS = ["--match", "1", "--mismatch", "-4", "--gap-open", "6", "--gap-penalty", "1"]
MATRIX_FLAGS = ["--matrix", "blosum50", "--gap-penalty", "2", "--gap-open", "10"]
# Server configurations: (flags, the JAX server's scoring, its npiece).
SERVERS = {
    "linear": ([], JaxScoringConfig(), 4),
    "affine": (BWA_FLAGS, JaxScoringConfig(match=1, mismatch=-4, gap_open=6, gap_penalty=1), 4),
    "matrix": (MATRIX_FLAGS, jax_blosum("blosum50", gap_penalty=2.0, gap_open=10.0), 3),
}


def mutate(rng, seg, letters):
    """``seg`` with two substitutions and a 1-2 letter deletion or insertion."""
    s = list(seg)
    for at in rng.choice(len(s), 2, replace=False):
        s[at] = str(rng.choice(letters))
    at, size = int(rng.integers(6, len(s) - 6)), int(rng.integers(1, 3))
    if rng.random() < 0.5:
        del s[at : at + size]
    else:
        s[at:at] = list(rng.choice(letters, size))
    return "".join(s)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The seeded inputs, written once: DNA and protein references with
    their reads, and the protein database with the query planted in p4."""
    d = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    dna = "".join(rng.choice(list("ACGT"), 600))
    dna_reads = [dna[100:124]] + [mutate(rng, dna[s : s + 24], list("ACGT"))
                                  for s in (30, 250, 400, 560)]
    dna_reads += ["".join(rng.choice(list("ACGT"), 24)) for _ in range(3)]
    protein = "".join(rng.choice(AMINO, 400))
    protein_reads = [protein[100:140]] + [mutate(rng, protein[s : s + 40], AMINO)
                                          for s in (20, 300)]
    protein_reads += ["".join(rng.choice(AMINO, 40)) for _ in range(2)]
    seqs = ["".join(rng.choice(AMINO, 60 + 13 * k)) for k in range(7)]
    query = "".join(rng.choice(AMINO, 35))
    seqs[4] = seqs[4][:10] + query + seqs[4][10:]  # the planted hit
    seqs[6] = seqs[6][:50] + mutate(rng, query, AMINO) + seqs[6][50:]
    (d / "dna.fa").write_text(f">ref\n{dna}\n")
    (d / "protein.fa").write_text(f">p\n{protein}\n")
    (d / "db.fasta").write_text("".join(f">p{k}\n{s}\n" for k, s in enumerate(seqs)))
    (d / "q.fasta").write_text(f">q\n{query}\n")
    return {"dir": d, "dna": dna, "dna_reads": dna_reads, "protein": protein,
            "protein_reads": protein_reads, "query": query, "seqs": seqs}


class ThreadServer:
    """``serve.main(argv)`` on a thread of this process; ``stop`` shuts it
    down and joins it."""

    def __init__(self, sock, argv):
        self.sock = sock
        self.thread = threading.Thread(target=serve.main, args=(["--socket", sock] + argv,),
                                       daemon=True)
        self.thread.start()
        serve.wait_ready(sock, timeout=120.0)

    def __call__(self, obj):
        return serve.request(self.sock, obj, timeout=60.0)

    def stop(self):
        assert self({"op": "shutdown"}) == {"ok": True}
        self.thread.join(30)
        assert not self.thread.is_alive() and not os.path.exists(self.sock)


@pytest.fixture(scope="module")
def servers(data):
    """One port server a configuration, each with the protein database;
    the linear one also with --output-dir; and the JAX servers beside
    them."""
    d = data["dir"]
    jax_db = JaxDB([(f"p{k}", s) for k, s in enumerate(data["seqs"])], batch_size=4,
                   pad_mult=64)
    port, jax = {}, {}
    try:
        for name, (flags, cfg, npiece) in SERVERS.items():
            ref = d / ("protein.fa" if name == "matrix" else "dna.fa")
            argv = ["--ref", str(ref), "--device", "cpu", "--batch-size", "8",
                    "--warm-read-len", "24", "--npiece", str(npiece), "--protein-db",
                    str(d / "db.fasta"), "--db-warm-len", "16"] + flags
            if name == "linear":
                argv += ["--output-dir", str(d / "out")]
            port[name] = ThreadServer(str(d / f"{name}.sock"), argv)
            seq = data["protein"] if name == "matrix" else data["dna"]
            jax[name] = JaxServer(cfg, JaxChunkConfig(npiece=npiece, overlap_ratio=2.0), seq,
                                  batch_size=8, protein_db=jax_db)
        yield port, jax
    finally:
        for srv in port.values():
            srv.stop()


def jax_reply(jax_server, req):
    """The JAX server's reply to ``req`` as it arrives off the wire (a new
    ``ref`` string object, never the preloaded one)."""
    return jax_server.handle(json.loads(json.dumps(req)))


def raw_exchange(sock, payload: bytes, timeout=30.0) -> bytes:
    """Send raw bytes on a new connection and read one reply line."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(sock)
        s.sendall(payload)
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    return buf


@pytest.mark.parametrize("name", list(SERVERS))
def test_align_matches_jax_server(servers, data, name):
    """Windowed (the server's npiece, and another per request) and whole
    (npiece 1, and a 'ref' sent in the request, which is whole even though
    it equals the preloaded reference), each with and without traceback:
    the same JSON text as the JAX server's results."""
    port, jax = servers
    reads = data["protein_reads"] if name == "matrix" else data["dna_reads"]
    ref = data["protein"] if name == "matrix" else data["dna"]
    requests = [
        {"op": "align", "reads": reads},
        {"op": "align", "reads": reads, "traceback": False},
        {"op": "align", "reads": reads, "npiece": 1},
        {"op": "align", "reads": reads, "npiece": 1, "traceback": False},
        {"op": "align", "reads": reads, "ref": ref},
        {"op": "align", "reads": reads, "npiece": 2},
    ]
    for req in requests:
        got, want = port[name](req), jax_reply(jax[name], req)
        assert got["ok"] and want["ok"], (req, got, want)
        assert json.dumps(got["results"]) == json.dumps(want["results"]), req
    windowed = port[name](requests[0])["results"]
    assert port[name](requests[4])["results"] == port[name](requests[2])["results"]
    assert any("-" in r["consensus_x"] + r["consensus_y"] for r in windowed)
    assert windowed[0]["score"] == max(r["score"] for r in windowed)
    ping = port[name]({"op": "ping"})
    assert ping["ok"] and ping["backend"] == "cpu" and ping["reads_served"] >= 6
    assert ping["ref_len"] == len(ref) and ping["protein_db_entries"] == 7
    assert ping["warmup_s"] > 0 and ping["load_s"] >= 0


def test_scan_db_matches_jax_server(servers, data):
    """Top-K hits with and without the traceback columns, top 0, and a
    query past the database's bound: the JAX server's JSON text."""
    port, jax = servers
    q = data["query"]
    for req in ({"op": "scan_db", "query": q, "top": 3, "traceback": True},
                {"op": "scan_db", "query": q, "top": 5},
                {"op": "scan_db", "query": q, "top": 0, "traceback": True}):
        got, want = port["linear"](req), jax_reply(jax["linear"], req)
        assert got["ok"] and want["ok"]
        assert json.dumps(got["hits"]) == json.dumps(want["hits"]), req
        assert got["n_entries"] == 7 and got["gcups"] >= 0
    hits = port["linear"]({"op": "scan_db", "query": q, "top": 2, "traceback": True})["hits"]
    assert [h["name"] for h in hits] == ["p4", "p6"] and hits[0]["consensus_x"] == q[::-1]
    assert "-" in hits[1]["consensus_x"] + hits[1]["consensus_y"]
    rep = port["linear"]({"op": "scan_db", "query": "M" * 2049})
    assert not rep["ok"] and "max_query_len" in rep["error"]


def test_scan_db_output_is_solve_uniprot_csv(servers, data, tmp_path):
    """'output' writes every row inside --output-dir: the bytes of the JAX
    solve_uniprot --traceback-top 0 under the server's 10/2 BLOSUM50."""
    port, _ = servers
    rep = port["linear"]({"op": "scan_db", "query": data["query"], "top": 3,
                          "traceback": True, "output": "rows.csv"})
    served = data["dir"] / "out" / "rows.csv"
    assert rep["ok"] and rep["output"] == str(served) and rep["n_rows"] == 7
    assert len(rep["hits"]) == 3
    cli = tmp_path / "cli.csv"
    assert jax_uniprot.main([
        "--platform", "cpu", "--engine", "scan", "--query", str(data["dir"] / "q.fasta"),
        "--database", str(data["dir"] / "db.fasta"), "--output", str(cli), "--matrix",
        "blosum50", "--gap-open", "10", "--gap-penalty", "2", "--traceback-top", "0",
    ]) == 0
    assert served.read_bytes() == cli.read_bytes()


@pytest.mark.parametrize("payload, error", [
    (b"{not json\n", "JSONDecodeError"),
    (b"[1, 2]\n", "one JSON object"),
    (b'{"op": "frobnicate"}\n', "unknown op"),
    (b'{"op": "align", "reads": []}\n', "non-empty"),
    (b'{"op": "align", "reads": ["ACGT", 7]}\n', "non-empty"),
    (b'{"op": "scan_db", "query": ""}\n', "non-empty"),
    (b'{"op": "align", "reads": ["ACGT"], "npiece": "many"}\n', "ValueError"),
], ids=["malformed", "not_object", "unknown_op", "no_reads", "bad_read", "no_query",
        "bad_npiece"])
def test_bad_requests_get_errors(servers, payload, error):
    port, _ = servers
    rep = json.loads(raw_exchange(port["linear"].sock, payload))
    assert rep["ok"] is False and error in rep["error"]
    assert port["linear"]({"op": "ping"})["ok"]


@pytest.mark.parametrize("name, output", [
    ("affine", "rows.csv"), ("linear", ".."), ("linear", "../escape.csv"),
    ("linear", "/tmp/escape.csv"), ("linear", "sub/rows.csv"),
], ids=["no_output_dir", "dotdot", "parent", "absolute", "separator"])
def test_scan_db_output_refused(servers, data, name, output):
    """Without --output-dir any 'output' is refused; with it, anything but
    a plain file name. Nothing is written."""
    port, _ = servers
    before = sorted(os.listdir(data["dir"]))
    rep = port[name]({"op": "scan_db", "query": data["query"], "output": output})
    assert rep["ok"] is False and "output" in rep["error"]
    assert sorted(os.listdir(data["dir"])) == before
    assert not os.path.exists("/tmp/escape.csv")
    assert port[name]({"op": "ping"})["ok"]


def test_second_client_queues_behind_an_open_connection(servers):
    """One connection at a time: a ping on a second connection is answered
    only once the first connection closes."""
    port, _ = servers
    srv = port["linear"]
    first = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    first.connect(srv.sock)
    replies = []
    second = threading.Thread(target=lambda: replies.append(srv({"op": "ping"})))
    try:
        first.sendall(b'{"op": "ping"}\n')
        assert json.loads(first.recv(1 << 16))["ok"]
        second.start()
        time.sleep(0.5)
        assert second.is_alive() and not replies
    finally:
        first.close()
    second.join(30)
    assert not second.is_alive() and replies[0]["ok"]


@pytest.mark.parametrize("newline", [True, False], ids=["line", "unterminated"])
def test_oversized_line_is_refused(servers, monkeypatch, newline):
    """A line past MAX_REQUEST_BYTES gets an error and its connection is
    closed; the server stays up."""
    port, _ = servers
    srv = port["linear"]
    monkeypatch.setattr(serve, "MAX_REQUEST_BYTES", 4096)
    body = json.dumps({"op": "align", "reads": ["ACGT" * 2500]}).encode()
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(30)
        s.connect(srv.sock)
        s.sendall(body + (b"\n" if newline else b""))
        buf = b""
        while not buf.endswith(b"\n"):
            buf += s.recv(1 << 16)
        rep = json.loads(buf)
        assert rep["ok"] is False and "exceeds 4096 bytes" in rep["error"]
        try:
            assert s.recv(1 << 16) == b""  # closed by the server
        except ConnectionResetError:
            pass
    monkeypatch.undo()
    assert srv({"op": "ping"})["ok"]


@pytest.mark.parametrize("partial", [False, True], ids=["before_reply", "mid_line"])
def test_client_disconnect_keeps_server_up(servers, data, partial):
    """A client that closes before its reply (or halfway through its request
    line) drops only its own connection."""
    port, _ = servers
    srv = port["linear"]
    served = srv({"op": "ping"})["reads_served"]
    req = json.dumps({"op": "align", "reads": data["dna_reads"] * 4}).encode()
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(srv.sock)
        s.sendall(req[: len(req) // 2] if partial else req + b"\n")
    ping = srv({"op": "ping"})
    assert ping["ok"] and ping["reads_served"] == served + (0 if partial else 32)


def test_serve_entry_point_subprocess(data, tmp_path, capsys):
    """``python -m parallel_genomeseq_tpu_torch.cli.serve`` on the CPU, and
    its --client modes: ping, align to a CSV, scan_db of a FASTA query with
    traceback and an output file, shutdown."""
    d = data["dir"]
    sock = str(tmp_path / "pgs.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "parallel_genomeseq_tpu_torch.cli.serve", "--socket", sock,
         "--ref", str(d / "dna.fa"), "--device", "cpu", "--warm-read-len", "24",
         "--batch-size", "8", "--protein-db", str(d / "db.fasta"), "--db-warm-len", "16",
         "--db-batch-size", "4", "--db-pad-mult", "64", "--output-dir", str(tmp_path / "o")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    try:
        serve.wait_ready(sock, timeout=120.0)
        assert serve.main(["--socket", sock, "--client", "ping"]) == 0
        assert json.loads(capsys.readouterr().out)["backend"] == "cpu"
        reads = tmp_path / "reads.txt"
        reads.write_text("\n".join(data["dna_reads"][:3]) + "\n")
        out = tmp_path / "align.csv"
        assert serve.main(["--socket", sock, "--client", "align", "--reads-file", str(reads),
                           "--output", str(out)]) == 0
        want = BatchSWAligner(device="cpu").align_batch(data["dna_reads"][:3], [data["dna"]])
        assert out.read_text().splitlines() == ["read,pos_pred,score"] + [
            f"{read},{r.pos},{r.score:g}" for read, r in zip(data["dna_reads"], want)]
        assert want[0].score == 72 and "reads/s" in capsys.readouterr().out
        assert serve.main(["--socket", sock, "--client", "scan_db", "--query",
                           str(d / "q.fasta"), "--top", "2", "--traceback", "--output",
                           "rows.csv"]) == 0
        rep = json.loads(capsys.readouterr().out)
        assert rep["hits"][0]["name"] == "p4" and "pos_pred" in rep["hits"][0]
        assert (tmp_path / "o" / "rows.csv").read_text().count("\n") == 8
        assert serve.main(["--socket", sock, "--client", "shutdown"]) == 0
        assert proc.wait(timeout=60) == 0
        log = proc.stdout.read().decode()
        assert "warmup done" in log and "shut down" in log
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
