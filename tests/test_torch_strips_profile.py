"""The port's substitution-matrix strip path (long protein queries and
entries, linear gaps) against the JAX package, on the CPU.

The plain versions of the profile strip kernels (K19 ``sw_profile_plain``,
per lane and on a resident slab; K20 ``sw_profile_ckpt_plain``; K21
``strip_profile_moves_plain``) are held exactly against the Pallas kernels
B11 (through ``PallasEngine.score_batch`` and ``score_db_slab_strips_jit``),
B15 (its int16 hi/lo checkpoint rows decoded) and B19 in interpret mode;
the routes through ``ResidentProteinDB``, ``BatchSWAligner``,
``cli/solve_uniprot`` and ``cli/solve_big --matrix`` against the JAX
package's. Every comparison is exact (tolerance 0: integers, bytes and
CSV bytes). Inputs come from numpy seeds at small sizes (queries and reads
of 2,064-2,348 residues, entries and references of up to 2,400, B <= 14
lanes); JAX results are shared through module-scoped fixtures.
"""

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.cli import solve_uniprot as jax_uniprot
from parallel_genomeseq_tpu.models.protein_db import ResidentProteinDB as JaxResidentDB
from parallel_genomeseq_tpu.models.swaligner import BatchSWAligner as JaxBatchAligner
from parallel_genomeseq_tpu.ops import wavefront_pallas as wp
from parallel_genomeseq_tpu.ops.substitution import blosum_config as jax_blosum_config
from parallel_genomeseq_tpu.parallel.chunking import ChunkedAligner as JaxChunkedAligner
from parallel_genomeseq_tpu.utils.config import ChunkConfig as JaxChunkConfig
from parallel_genomeseq_tpu_torch.cli import solve_big
from parallel_genomeseq_tpu_torch.cli import solve_uniprot as port_uniprot
from parallel_genomeseq_tpu_torch.models.protein_db import ResidentProteinDB, pack_slab
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops import engine, scan_dp, strips_cuda
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

PADW = wp.STRIP_PADW  # B15's rows hold column j at p = j + PADW
S = scan_dp.STRIP_S
GAP = 12  # the uniprot_e2e linear gap
JAX_CFG = jax_blosum_config("blosum50", gap_penalty=float(GAP))
PORT_CFG = blosum_config("blosum50", gap_penalty=float(GAP))
ALPHA = np.frombuffer(PORT_CFG.alphabet.encode(), np.uint8)
LUT, TABLE = scan_dp.profile_tables(PORT_CFG)
KW = dict(table=torch.from_numpy(TABLE), gap=GAP)
WORST, BEST = int(TABLE.min()), int(TABLE.max())
NCODES = TABLE.shape[0]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def codes(a):
    """Raw bytes -> the port's compact codes, as a tensor."""
    return t(LUT[np.asarray(a)])


def mutate(rng, seq, n_sub, n_indel=0):
    """test_strips.py's ``_mutate_alpha``: substitutions, then 1-residue
    indels."""
    s = list(seq)
    for _ in range(n_sub):
        s[int(rng.integers(0, len(s)))] = int(rng.choice(ALPHA))
    for _ in range(n_indel):
        p = int(rng.integers(1, len(s) - 1))
        if rng.integers(0, 2):
            s.insert(p, int(rng.choice(ALPHA)))
        else:
            del s[p]
    return np.array(s, np.uint8)


def lanes_case():
    """test_strips.py:104-125's case: three 2,304-aa queries against ragged
    entries of 500, 340 and 420 aa, a high-identity region planted in lane 0
    and a mutated one in lane 2."""
    rng = np.random.default_rng(0)
    B, m = 3, wp.MAX_M + 256
    n = np.array([500, 340, 420], np.int32)
    xs = rng.choice(ALPHA, size=(B, m)).astype(np.uint8)
    ys = np.full((B, int(n.max())), 2, np.uint8)
    for b in range(B):
        ys[b, : n[b]] = rng.choice(ALPHA, size=n[b])
    ys[0, 100:400] = xs[0, 1000:1300]
    ys[2, 50:350] = mutate(rng, xs[2, 1900:2200], 40)
    return xs, ys, np.full(B, m, np.int32), n


@pytest.fixture(scope="module")
def b11_b15():
    """B11 (``PallasEngine.score_batch``, the strips branch of
    ``score_prepared``) and B15 (``_call_strips_profile_ckpt``) in
    interpret mode on the lanes case: B11's (score, i, j), B15's H rows
    decoded from their int16 hi/lo pairs to int32, and the packed profile
    and y codes that B19 takes."""
    xs, ys, m, n = lanes_case()
    eng = wp.PallasEngine(JAX_CFG)
    res = eng.score_batch(xs, ys, m, n)
    X, Y = eng.prepare(xs, ys, m, n)["args"]
    plut, elut = eng._lut()
    pprof, ycodes = wp._profile_gather(X, plut), wp._encode_y(Y, elut)
    _, _, hi, lo = wp._call_strips_profile_ckpt(
        pprof, ycodes, worst=WORST, best_sub=BEST, gap=GAP, interpret=True, ncodes=NCODES)
    hi, lo = np.asarray(hi), np.asarray(lo)
    return dict(score={k: np.asarray(res[k]) for k in ("score", "i", "j")}, hi=hi, lo=lo,
                rows=(hi.astype(np.int32) << 15) + lo.astype(np.int32), pprof=pprof,
                ycodes=ycodes)


def test_plain_k19_matches_b11_per_lane(b11_b15):
    """Both engines' score_batch route a 2,304-aa matrix query to the
    profile strips -- the CUDA engine through K19's wrapper, which takes its
    plain version on CPU tensors -- and equal B11's (score, i, j), without
    a launch."""
    xs, ys, m, n = lanes_case()
    want = b11_b15["score"]
    before = strips_cuda.sw_score_strips_profile.launches
    for name in ("cuda", "plain"):
        res = engine.make_score_engine(PORT_CFG, name=name, device="cpu").score_batch(xs, ys, m, n)
        for k in ("score", "i", "j"):
            np.testing.assert_array_equal(res[k].numpy(), want[k], err_msg=f"{name} {k}")
    assert strips_cuda.sw_score_strips_profile.launches == before
    assert int(want["score"][0]) > 1000 and int(want["score"][2]) > 300


@pytest.fixture(scope="module")
def k20():
    """K20's wrapper on the lanes case's CPU tensors (its plain version)."""
    xs, ys, m, n = lanes_case()
    return strips_cuda.sw_score_strips_profile_ckpt(codes(xs), codes(ys), t(m), t(n), **KW)


def test_plain_k20_rows_match_b15(b11_b15, k20):
    """K20's plain version: (score, i, j) as B11, and the H of rows kS - 1
    equal B15's hi/lo rows, decoded as (hi << 15) + lo at p = j + PADW,
    in every column of every lane."""
    xs, ys, m, n = lanes_case()
    got = k20
    for k, g in zip(("score", "i", "j"), got[:3]):
        np.testing.assert_array_equal(g.numpy(), b11_b15["score"][k], err_msg=k)
    ck = got[3].numpy()
    B, N = ys.shape
    K = xs.shape[1] // S - 1
    assert ck.shape == (B, K, N)
    want = b11_b15["rows"][:K, PADW + 1 : PADW + 1 + N, :B].transpose(2, 0, 1)
    valid = np.arange(N)[None, None, :] < n[:, None, None]
    np.testing.assert_array_equal(ck[np.broadcast_to(valid, ck.shape)],
                                  want[np.broadcast_to(valid, ck.shape)])
    assert ck.max() > 1000  # lane 0's planted region crosses row 1,024


@pytest.mark.parametrize("strip", [0, 4], ids=["first", "inner"])
def test_plain_k21_matches_b19(strip, b11_b15, k20):
    """K21's plain version replays a strip from K20's row (zeros for strip
    0) and equals B19 (``_call_strip_profile_moves``, fed B15's hi/lo row)
    on every cell of every lane's matrix in the strip."""
    xs, ys, m, n = lanes_case()
    B, N = ys.shape
    X, Y, mm, nn = codes(xs), codes(ys), t(m), t(n)
    ck = k20[3]
    rowin = ck[:, strip - 1] if strip else None
    got = strips_cuda.strip_profile_moves(X, Y, mm, nn, rowin, strip * S, **KW)
    assert got.shape == (B, N, S) and got.dtype == torch.uint8
    zero = np.zeros(b11_b15["hi"].shape[1:], np.int16)
    hi, lo = (b11_b15[k][strip - 1] if strip else zero for k in ("hi", "lo"))
    jax_moves = np.asarray(wp._call_strip_profile_moves(
        b11_b15["pprof"][:, strip * S : (strip + 1) * S], b11_b15["ycodes"], hi, lo,
        worst=WORST, gap=GAP, interpret=True, ncodes=NCODES))
    r = np.arange(S)[None, :]
    want = jax_moves[r + np.arange(N)[:, None], r][:, :, :B].transpose(2, 0, 1)
    valid = np.broadcast_to(np.arange(N)[None, :, None] < n[:, None, None], want.shape)
    np.testing.assert_array_equal(got.numpy()[valid], want[valid])
    assert (want[valid] & scan_dp.STOP_BIT).any() and (want[valid] & 3 == scan_dp.MOVE_NW).any()


def slab_case():
    """A 2,100-aa query and eight entries of 0-1,200 aa, a mutated query
    segment planted in two of them."""
    rng = np.random.default_rng(1)
    q = rng.choice(ALPHA, size=2100).astype(np.uint8)
    lens = [60, 333, 0, 128, 1200, 777, 950, 91]
    ents = [rng.choice(ALPHA, size=k).astype(np.uint8) for k in lens]
    ents[1][20:320] = mutate(rng, q[1700:2000], 30)[:300]
    ents[4][300:1100] = mutate(rng, q[100:900], 90)[:800]
    return q, ents


def test_plain_k19_slab_matches_score_db_slab_strips_jit():
    """K19's slab form -- one shared query against every lane of a flat
    resident slab, lane b at its 64-bit offset -- equals
    ``score_db_slab_strips_jit`` on the same entries (the query padded to
    a multiple of 256 with X_PAD, slab codes past each entry set to 0)."""
    q, ents = slab_case()
    L = len(ents)
    # The JAX side: one LANE-wide batch of the entries, as pack_slab lays it.
    N = max(len(e) for e in ents)
    Mq = -(-len(q) // S) * S
    plut, elut = (np.asarray(a) for a in wp.PallasEngine(JAX_CFG)._lut())
    Ny = -(-(max(N, 8) + S + 2 * wp.UNROLL) // wp.UNROLL) * wp.UNROLL
    slab2d = np.zeros((Ny, wp.LANE), np.uint8)
    lens = np.zeros(wp.LANE, np.int32)
    for b, e in enumerate(ents):
        slab2d[: len(e), b] = elut[e]
        lens[b] = len(e)
    qcol = np.full(Mq, 1, np.uint8)
    qcol[: len(q)] = q
    pprof = np.ascontiguousarray(np.broadcast_to(
        plut[qcol.astype(np.int32)].T[:, :, None], (plut.shape[1], Mq, wp.LANE)))
    want = [np.asarray(a)[:L] for a in wp.score_db_slab_strips_jit(
        slab2d, 0, lens, pprof, N=N, worst=WORST, best_sub=BEST, gap=GAP, gopen=0,
        interpret=True, ncodes=NCODES)]
    # The port: the length-sorted flat slab of ResidentProteinDB.
    order = sorted(range(L), key=lambda k: len(ents[k]))
    slab, offs, slens = pack_slab(ents, order, LUT)
    got = strips_cuda.sw_score_strips_profile(
        codes(q), t(slab), torch.full((L,), len(q), dtype=torch.int32), t(slens), y_off=t(offs),
        **KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w[order])
    assert int(want[0][4]) > 1000 and int(want[0][1]) > 300 and int(want[0][2]) == 0


def protein_entries(rng, n=9, minlen=30, maxlen=150):
    """test_protein_db.py's ``_mkdb``."""
    alpha = list("ARNDCQEGHILKMFPSTWYV")
    return [(f"p{k}", "".join(rng.choice(alpha, int(rng.integers(minlen, maxlen)))))
            for k in range(n)]


def test_resident_db_matches_jax_short_and_long_queries():
    """test_protein_db.py:14's case: one resident slab serves a 40-aa query
    (K4) and a 2,064-aa query (K19's slab form), and both scans equal the
    JAX ResidentProteinDB's (single-strip and strips slab kernels)."""
    rng = np.random.default_rng(2)
    alpha = list("ARNDCQEGHILKMFPSTWYV")
    entries = protein_entries(rng)
    qshort = "".join(rng.choice(alpha, 40))
    qlong = "".join(rng.choice(alpha, wp.MAX_M + 16))
    jax_db = JaxResidentDB(entries, matrix="blosum50", gap_penalty=float(GAP), gap_open=0.0,
                           batch_size=4, pad_mult=64, max_query_len=wp.MAX_M + 16)
    db = ResidentProteinDB(entries, matrix="blosum50", gap_penalty=float(GAP), gap_open=0.0,
                           max_query_len=wp.MAX_M + 16, device="cpu")
    for q in (qshort, qlong):
        want_s, want_p, _ = jax_db.scan_scores(q)
        got_s, got_p, _ = db.scan_scores(q)
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_p, want_p)
    with pytest.raises(ValueError, match="max_query_len"):
        db.encode_query(qlong + "A")


def traceback_reads():
    """test_strips.py:226-249's linear case: reads of 2,348 aa (a mutated
    700-aa segment of a 900-aa reference at row 200: exact, substitutions,
    substitutions and indels) and an unrelated one."""
    rng = np.random.default_rng(3)
    m, n = wp.MAX_M + 300, 900
    ref = rng.choice(ALPHA, size=n)
    reads = []
    for subs, indels in [(0, 0), (30, 0), (15, 6)]:
        s0 = int(rng.integers(0, n - 700))
        seg = mutate(rng, ref[s0 : s0 + 700], subs, indels)
        r = rng.choice(ALPHA, size=m)
        r[200 : 200 + len(seg)] = seg[: min(len(seg), m - 200)]
        reads.append(r.tobytes().decode())
    reads.append(rng.choice(ALPHA, size=m).tobytes().decode())
    return reads, ref.tobytes().decode()


TB_READS = ["exact", "substitutions", "indels", "unrelated"]


@pytest.fixture(scope="module")
def strip_batches():
    """The JAX Pallas aligner and the port's (plain on CPU) on the
    traceback reads, BLOSUM50 with a linear gap of 2."""
    reads, ref = traceback_reads()
    jcfg = jax_blosum_config("blosum50", gap_penalty=2.0)
    pcfg = blosum_config("blosum50", gap_penalty=2.0)
    before = (strips_cuda.sw_score_strips_profile_ckpt.launches,
              strips_cuda.strip_profile_moves.launches)
    got = BatchSWAligner(pcfg, device="cpu").align_batch(reads, [ref])
    assert (strips_cuda.sw_score_strips_profile_ckpt.launches,
            strips_cuda.strip_profile_moves.launches) == before
    return got, JaxBatchAligner(jcfg, score_engine="pallas").align_batch(reads, [ref])


def fields(r):
    return (r.score, r.pos, r.max_i, r.max_j, r.consensus_x, r.consensus_y)


@pytest.mark.parametrize("k", range(len(TB_READS)), ids=TB_READS)
def test_batch_aligner_profile_strip_traceback_matches_jax(k, strip_batches):
    """BatchSWAligner's strip traceback under BLOSUM50 (K20, then K21 and
    the K14 walk per strip; plain on CPU) equals the JAX aligner's in score,
    pos, max_i, max_j and both consensus strings, which hold the raw
    letters, not compact codes."""
    got, want = strip_batches[0][k], strip_batches[1][k]
    assert fields(got) == fields(want)
    assert len(got.timings.levels_us) == 10
    if TB_READS[k] != "unrelated":
        assert got.score > 1000 and len(got.consensus_x) > 500
        assert set(got.consensus_x + got.consensus_y) <= set(PORT_CFG.alphabet + "-")


@pytest.fixture(scope="module")
def uniprot_data(tmp_path_factory):
    """A 2,300-aa query and 12 entries of 60-800 aa, one of them holding a
    mutated 200-aa segment of the query, plus a 2,400-aa entry holding a
    mutated 900-aa one (the top hit, walked in strips) and a 2,100-aa
    unrelated entry."""
    d = tmp_path_factory.mktemp("uniprot_long")
    rng = np.random.default_rng(4)
    q = rng.choice(ALPHA, size=2300)
    ents = [rng.choice(ALPHA, size=int(k)) for k in rng.integers(60, 600, size=12)]
    long_entry = rng.choice(ALPHA, size=2400)
    seg = mutate(rng, q[600:1500], 80, 4)
    long_entry[1300 : 1300 + len(seg)] = seg
    ents[5:5] = [long_entry, rng.choice(ALPHA, size=2100)]
    ents[9] = np.concatenate([ents[9][:30], mutate(rng, q[2000:2200], 20), ents[9][30:]])
    (d / "query.fasta").write_text(">titin_like\n" + q.tobytes().decode() + "\n")
    (d / "db.fasta").write_text("".join(f">e{k}\n{e.tobytes().decode()}\n"
                                        for k, e in enumerate(ents)))
    return d


@pytest.mark.parametrize("matrix", ["blosum50", "uniform"])
def test_solve_uniprot_long_query_csv_byte_identical(matrix, uniprot_data, tmp_path, capsys):
    """A 2,300-aa query: the port's solve_uniprot (K19's slab scan under
    BLOSUM50, K11 under --matrix uniform; the top hits walked in strips, a
    2,400-aa entry among them) writes the JAX package's CSV byte for
    byte."""
    argv = ["--query", str(uniprot_data / "query.fasta"), "--database",
            str(uniprot_data / "db.fasta"), "--matrix", matrix, "--top", "3"]
    outs = {}
    for side, main, flag in (("jax", jax_uniprot.main, ["--platform", "cpu"]),
                             ("port", port_uniprot.main, ["--device", "cpu"])):
        out = tmp_path / f"{side}.csv"
        assert main(argv + ["--output", str(out)] + flag) == 0
        outs[side] = out.read_bytes()
    assert outs["port"] == outs["jax"]
    rows = outs["port"].decode().splitlines()[1:]
    assert rows[5].startswith("e5,2400,") and not rows[5].endswith(",,")
    assert "Scored" in capsys.readouterr().out


@pytest.fixture(scope="module")
def big_data(tmp_path_factory):
    """solve_big's generated data at a small size (a 2,400-bp reference, two
    2,100-bp reads, one mutated so that the walk takes gaps)."""
    from parallel_genomeseq_tpu_torch.seqio.datagen import gen_reads_custom, gen_ref_custom

    tmp = tmp_path_factory.mktemp("solve_big_matrix")
    ref = gen_ref_custom(tmp / "ref.fa", ref_len=2400, seed=31)
    reads = [s for s, _ in gen_reads_custom(ref, tmp / "reads.csv", n_reads=2, read_len=2100,
                                             seed=32)]
    rng = np.random.default_rng(33)
    seg = list(reads[1])
    for _ in range(23):
        seg[int(rng.integers(0, len(seg)))] = "ACGT"[int(rng.integers(0, 4))]
    for at in (300, 700, 1500):
        del seg[at]
    reads[1] = "".join(seg)
    with open(tmp / "reads.csv", "w") as f:
        f.write("index,QNAME,SEQ,POS\n" + "".join(f"{k},r{k},{s},0\n" for k, s in enumerate(reads)))
    return tmp, ref, reads


@pytest.fixture(scope="module")
def jax_big(big_data):
    """The JAX ChunkedAligner with the Pallas engine under BLOSUM50, linear
    gap 2, on solve_big's windows (npiece 2 -> 4 windows of 1,387 bp at
    overlap ratio 0.5), with and without traceback."""
    _, ref, reads = big_data
    al = JaxChunkedAligner(jax_blosum_config("blosum50", gap_penalty=2.0),
                           chunk=JaxChunkConfig(npiece=4, overlap_ratio=0.5),
                           score_engine="pallas")
    return {tb: al.align_batch(reads, ref, traceback=tb) for tb in (False, True)}


@pytest.mark.parametrize("tb", [False, True], ids=["score_only", "traceback"])
def test_solve_big_matrix_matches_jax(tb, big_data, jax_big, capsys):
    """cli/solve_big --matrix blosum50 on the CPU: K19's window sweep and,
    with --traceback, the winners' profile strip traceback (K20, K21, K14)
    equal the JAX ChunkedAligner in score, pos, argmax and consensus."""
    tmp, ref, reads = big_data
    flags = ["2", "1", "--ref", str(tmp / "ref.fa"), "--reads", str(tmp / "reads.csv"),
             "--overlap-ratio", "0.5", "--matrix", "blosum50", "--device", "cpu"] + \
        (["--traceback"] if tb else [])
    run = solve_big.run(flags)
    assert run.rc == 0 and len(run.results) == 2
    for got, want in zip(run.results, jax_big[tb]):
        assert fields(got) == fields(want)
    out = capsys.readouterr().out
    assert ("traceback strip levels" in out) == tb
    if tb:
        assert len(run.levels_us[0]) == 9  # 2,104 rows
        assert "-" in run.results[1].consensus_x + run.results[1].consensus_y
        assert set(run.results[0].consensus_x) <= set("ACGT")
