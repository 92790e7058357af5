"""The port's affine substitution-matrix strip path (long protein queries
and entries under Gotoh gaps) against the JAX package, on the CPU.

The plain versions of the affine profile strip kernels (K22
``sw_profile_plain`` with gap_open, per lane and on a resident slab; K23
``sw_profile_affine_ckpt_plain``; K24 ``strip_profile_affine_moves_plain``;
the K18 walk over their bytes) are held exactly against the Pallas kernels
B12 (through ``PallasEngine.score_batch`` and ``score_db_slab_strips_jit``),
B16 (its int16 hi/lo checkpoint rows decoded) and B20 in interpret mode,
and against the JAX ``walk_strip_level_affine``; the routes through
``ResidentProteinDB``, ``BatchSWAligner``, ``cli/solve_uniprot`` and
``cli/solve_big --matrix --gap-open`` against the JAX package's. BLOSUM50
with swps3's gaps 10/2 throughout.

Every comparison is exact (tolerance 0: integers, bytes and CSV bytes).
The JAX strips are 128 rows high (``STRIP_S_PA``), the port's 256: rows are
matched by their absolute index. The port keeps its full sweep's affine
boundaries (F = 0 above row 1, E = -2^30 in column 0; B16/B20 start F at
-(open + extend + 1)), so B20's bytes are held in the H source on every
cell of a lane's matrix and in each extend bit where the JAX scan's E (F)
of that cell is >= 0; the scan has the port's boundaries, and its bytes
equal the port's in every bit. Inputs come from numpy seeds at small sizes
(queries and reads of 2,064-2,400 residues, entries and references of up
to 2,400, B <= 5 lanes); JAX results are shared through module-scoped
fixtures.
"""

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.cli import solve_uniprot as jax_uniprot
from parallel_genomeseq_tpu.models.protein_db import ResidentProteinDB as JaxResidentDB
from parallel_genomeseq_tpu.models.swaligner import BatchSWAligner as JaxBatchAligner
from parallel_genomeseq_tpu.ops import traceback as jax_traceback
from parallel_genomeseq_tpu.ops import wavefront_pallas as wp
from parallel_genomeseq_tpu.ops.scan_dp import ScanEngine
from parallel_genomeseq_tpu.ops.substitution import blosum_config as jax_blosum_config
from parallel_genomeseq_tpu.parallel.chunking import ChunkedAligner as JaxChunkedAligner
from parallel_genomeseq_tpu.utils.config import ChunkConfig as JaxChunkConfig
from parallel_genomeseq_tpu_torch.cli import solve_big
from parallel_genomeseq_tpu_torch.cli import solve_uniprot as port_uniprot
from parallel_genomeseq_tpu_torch.models.protein_db import ResidentProteinDB, pack_slab
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops import engine, scan_dp, strips_cuda, traceback
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

PADW = wp.STRIP_PADW  # B16's rows hold column j at p = j + PADW
S = scan_dp.STRIP_S
SPA = wp.STRIP_S_PA  # B12/B16/B20's strip height
GAP_OPEN, GAP = 10, 2  # swps3's BLOSUM50 gaps
GAP_FLAGS = ["--gap-open", str(GAP_OPEN), "--gap-penalty", str(GAP)]
JAX_CFG = jax_blosum_config("blosum50", gap_penalty=float(GAP), gap_open=float(GAP_OPEN))
PORT_CFG = blosum_config("blosum50", gap_penalty=float(GAP), gap_open=float(GAP_OPEN))
ALPHA = np.frombuffer(PORT_CFG.alphabet[:20].encode(), np.uint8)
LUT, TABLE = scan_dp.profile_tables(PORT_CFG)
KW = dict(table=torch.from_numpy(TABLE), gap_open=GAP_OPEN, gap=GAP)
WORST, BEST = int(TABLE.min()), int(TABLE.max())
NCODES = TABLE.shape[0]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def codes(a):
    """Raw bytes -> the port's compact codes, as a tensor."""
    return t(LUT[np.asarray(a)])


def mutate(rng, seq, n_sub, n_indel=0):
    """Substitutions, then 1-residue indels."""
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
    """Three 2,304-aa queries against ragged entries of 500, 340 and 420 aa:
    a query segment planted whole in lane 0, with 12 query rows (251-262)
    skipped in lane 1 (a vertical gap run across the strip edge at row
    256), and mutated in lane 2."""
    rng = np.random.default_rng(0)
    B, m = 3, wp.MAX_M + 256
    n = np.array([500, 340, 420], np.int32)
    xs = rng.choice(ALPHA, size=(B, m)).astype(np.uint8)
    ys = np.full((B, int(n.max())), 2, np.uint8)
    for b in range(B):
        ys[b, : n[b]] = rng.choice(ALPHA, size=n[b])
    ys[0, 100:400] = xs[0, 1000:1300]
    ys[1, 100:300] = np.concatenate([xs[1, 150:250], xs[1, 262:362]])
    ys[2, 50:350] = mutate(rng, xs[2, 1900:2200], 40)
    return xs, ys, np.full(B, m, np.int32), n


def decode(hi, lo):
    """B16's int16 hi/lo row pairs -> int32."""
    return (np.asarray(hi).astype(np.int32) << 15) + np.asarray(lo).astype(np.int32)


@pytest.fixture(scope="module")
def jax_lanes():
    """On the lanes case: B12 (``PallasEngine.score_batch``, the strips
    branch of ``score_prepared``) and B16 (``_call_strips_profile_affine_ckpt``)
    in interpret mode -- B12's (score, i, j), B16's H and F rows decoded to
    int32 and its raw hi/lo planes, the packed profile and y codes B20
    takes -- and the JAX scan's per-cell E, F and moves (the port's
    boundaries)."""
    xs, ys, m, n = lanes_case()
    eng = wp.PallasEngine(JAX_CFG)
    res = eng.score_batch(xs, ys, m, n)
    X, Y = eng.prepare(xs, ys, m, n)["args"]
    plut, elut = eng._lut()
    pprof, ycodes = wp._profile_gather(X, plut), wp._encode_y(Y, elut)
    _, _, *planes = wp._call_strips_profile_affine_ckpt(
        pprof, ycodes, worst=WORST, best_sub=BEST, gap=GAP, gopen=GAP_OPEN, interpret=True,
        ncodes=NCODES)
    scan = ScanEngine(JAX_CFG).score_batch(xs, ys, m, n, keep_matrix=True, emit_moves=True)
    return dict(score={k: np.asarray(res[k]) for k in ("score", "i", "j")},
                planes=planes, rows=decode(*planes[:2]), frows=decode(*planes[2:]),
                pprof=pprof, ycodes=ycodes,
                **{k: np.asarray(scan[k]) for k in ("estack", "fstack", "moves")})


def test_plain_k22_matches_b12_per_lane(jax_lanes):
    """Both engines' score_batch route a 2,304-aa query under BLOSUM50 10/2
    to the affine profile strips -- the CUDA engine through K22's wrapper,
    which takes its plain version on CPU tensors -- and equal B12's (score,
    i, j); need_pos=False keeps the score; no launch."""
    xs, ys, m, n = lanes_case()
    want = jax_lanes["score"]
    before = strips_cuda.sw_score_strips_profile_affine.launches
    for name in ("cuda", "plain"):
        eng = engine.make_score_engine(PORT_CFG, name=name, device="cpu")
        res = eng.score_batch(xs, ys, m, n)
        for k in ("score", "i", "j"):
            np.testing.assert_array_equal(res[k].numpy(), want[k], err_msg=f"{name} {k}")
    res = eng.score_batch(xs, ys, m, n, need_pos=False)
    np.testing.assert_array_equal(res["score"].numpy(), want["score"])
    assert not res["i"].any() and not res["j"].any()
    assert strips_cuda.sw_score_strips_profile_affine.launches == before
    # Lane 1 aligns across its 12-row gap (34 = 10 + 12 x 2 cheaper than
    # ending there).
    assert int(want["score"][0]) > 1500 and int(want["score"][1]) > 600
    assert int(want["i"][1]) > 300


@pytest.fixture(scope="module")
def k23():
    """K23's wrapper on the lanes case's CPU tensors (its plain version)."""
    xs, ys, m, n = lanes_case()
    return strips_cuda.sw_score_strips_profile_affine_ckpt(codes(xs), codes(ys), t(m), t(n),
                                                           **KW)


def at_rows(plane, rows, N):
    """A (D, M, B) per-cell plane at (global 0-based) rows ``rows`` for
    columns 1..N, as (B, len(rows), N): cell (r, j) lies on diagonal
    r + j - 1."""
    d = np.asarray(rows)[:, None] + np.arange(N)[None, :]
    return plane[d, np.asarray(rows)[:, None]].transpose(2, 0, 1)


def test_plain_k23_rows_match_b16(jax_lanes, k23):
    """K23's plain version: (score, i, j) as B12; its H rows at every 256th
    row equal B16's rows of the same absolute row (every second 128-row
    strip's), decoded as (hi << 15) + lo at p = j + PADW, in every column
    of every lane; its F rows equal B16's wherever those are >= 0 and the
    JAX scan's F everywhere."""
    xs, ys, m, n = lanes_case()
    for k, g in zip(("score", "i", "j"), k23[:3]):
        np.testing.assert_array_equal(g.numpy(), jax_lanes["score"][k], err_msg=k)
    ck, fck = k23[3].numpy(), k23[4].numpy()
    B, N = ys.shape
    K = xs.shape[1] // S - 1
    assert ck.shape == fck.shape == (B, K, N)
    # B16's strip c ends at row (c + 1) * 128: the port's row (k + 1) * 256
    # is its strip 2k + 1.
    cols = slice(PADW + 1, PADW + 1 + N)
    theirs_h = jax_lanes["rows"][1::2][:K, cols, :B].transpose(2, 0, 1)
    theirs_f = jax_lanes["frows"][1::2][:K, cols, :B].transpose(2, 0, 1)
    valid = np.broadcast_to(np.arange(N)[None, None, :] < n[:, None, None], ck.shape)
    np.testing.assert_array_equal(ck[valid], theirs_h[valid])
    pos = valid & (theirs_f >= 0)
    np.testing.assert_array_equal(fck[pos], theirs_f[pos])
    rows = (np.arange(K) + 1) * S - 1
    np.testing.assert_array_equal(fck[valid], at_rows(jax_lanes["fstack"], rows, N)[valid])
    assert ck.max() > 1000 and pos.sum() > 100


@pytest.mark.parametrize("strip", [0, 4, 8], ids=["first", "middle", "last"])
def test_plain_k24_matches_b20(strip, jax_lanes, k23):
    """K24's plain version replays a 256-row strip from K23's H and F rows
    (none for strip 0): every byte of a lane's matrix equals the JAX scan's
    (the full sweep's); against B20 (``_call_strip_profile_affine_moves``
    on the two 128-row strips of the same rows, fed B16's hi/lo rows) the H
    source is equal on every cell, and each extend bit wherever the scan's
    E (F) of the cell is >= 0."""
    xs, ys, m, n = lanes_case()
    B, N = ys.shape
    X, Y, mm, nn = codes(xs), codes(ys), t(m), t(n)
    rows = (k23[3][:, strip - 1], k23[4][:, strip - 1]) if strip else (None, None)
    got = strips_cuda.strip_profile_affine_moves(X, Y, mm, nn, *rows, strip * S, **KW)
    assert got.shape == (B, N, S) and got.dtype == torch.uint8
    got = got.numpy()
    theirs = np.zeros_like(got)
    planes = jax_lanes["planes"]
    f0 = divmod(-(GAP_OPEN + GAP + 1), 1 << 15)  # B20's strip-0 F row, as hi/lo
    r = np.arange(SPA)[None, :]
    d = r + np.arange(N)[:, None]  # cell (r, j) on diagonal r + j - 1
    for half in (0, 1):
        c = 2 * strip + half  # B20's strip
        if c:
            rin = [p[c - 1] for p in planes]
        else:
            shape = planes[0].shape[1:]
            rin = [np.zeros(shape, np.int16)] * 2 + [np.full(shape, v, np.int16) for v in f0]
        moves = np.asarray(wp._call_strip_profile_affine_moves(
            jax_lanes["pprof"][:, c * SPA : (c + 1) * SPA], jax_lanes["ycodes"], *rin,
            worst=WORST, gap=GAP, gopen=GAP_OPEN, interpret=True, ncodes=NCODES))
        theirs[:, :, half * SPA : (half + 1) * SPA] = moves[d, r][:, :, :B].transpose(2, 0, 1)
    rr = strip * S + np.arange(S)
    valid = (rr[None, None, :] < m[:, None, None]) & \
        (np.arange(N)[None, :, None] < n[:, None, None])
    scan = {k: at_rows(jax_lanes[k], rr, N).transpose(0, 2, 1)[valid]  # the moves' layout
            for k in ("moves", "estack", "fstack")}
    np.testing.assert_array_equal(got[valid], scan["moves"])
    np.testing.assert_array_equal(got[valid] & 3, theirs[valid] & 3)
    diff = got[valid] ^ theirs[valid]
    assert (scan["estack"][(diff & scan_dp.E_EXT_BIT) != 0] < 0).all()
    assert (scan["fstack"][(diff & scan_dp.F_EXT_BIT) != 0] < 0).all()
    assert ((got[valid] & 3) == scan_dp.H_NW).any() and (got[valid] & scan_dp.E_EXT_BIT).any()


def test_k18_walks_k24_moves_as_jax_walk_strip_level_affine(jax_lanes, k23):
    """The K18 walk's plain version over K24's bytes, strip by strip from
    B12's argmax, against the JAX ``walk_strip_level_affine`` on the same
    bytes: the state (gap state included) is equal after every strip, the
    consensus holds the raw letters although the bytes were scored from
    compact codes, and lane 1's F run crosses the strip edge at row 256."""
    xs, ys, m, n = lanes_case()
    B, M = xs.shape
    N = ys.shape[1]
    X, Y, mm, nn = codes(xs), codes(ys), t(m), t(n)
    _, i, j, ck, fck = k23
    max_steps = 900
    state = traceback.new_strip_state(i, j, max_steps, affine=True)
    # Copies: the port's walk updates its state in place while JAX may still
    # be reading its inputs.
    jstate = tuple(np.array(a) for a in (state[0], state[1], state[2], state[7], state[3],
                                         state[5], state[6], state[4]))
    x_mb = t(xs.T)
    r = np.arange(S)[None, :]
    d = r + np.arange(N)[:, None]
    gap_states = {}
    for s in range(M // S - 1, -1, -1):
        rows = (ck[:, s - 1], fck[:, s - 1]) if s else (None, None)
        moves = strips_cuda.strip_profile_affine_moves(X, Y, mm, nn, *rows, s * S, **KW)
        jax_moves = np.zeros((S + N - 1, S, B), np.uint8)
        jax_moves[d, r] = moves.numpy().transpose(1, 2, 0)
        jstate = jax_traceback.walk_strip_level_affine(
            jax_moves, xs.T[s * S : (s + 1) * S].copy(), ys, s * S, jstate, max_steps=S + N)
        traceback.walk_strip_level_affine(moves, x_mb, t(ys), s * S, state, max_steps=max_steps)
        i_, j_, pos, g, active, cx, cy, steps = (np.asarray(a) for a in jstate)
        for got, want in zip(state, (i_, j_, pos, active, steps, cx, cy, g)):
            np.testing.assert_array_equal(got.numpy(), want)
        gap_states[s] = int(state[7][1])
    assert gap_states[1] == 2  # lane 1 left strip 1 inside its F run
    assert not (state[3] & (state[0] > 0)).any()
    steps = state[4].numpy()
    assert steps.min() > 200 and int(state[2][1]) > 0
    letters = set(PORT_CFG.alphabet.encode()) | {ord("-"), 0}
    assert set(np.unique(state[5].numpy())) <= letters
    assert (state[6].numpy()[:, 1] == ord("-")).sum() == 12  # the skipped query rows


def slab_case():
    """A 2,100-aa query and eight entries of 0-1,200 aa, a mutated query
    segment planted in two of them (one with 3 indels)."""
    rng = np.random.default_rng(1)
    q = rng.choice(ALPHA, size=2100).astype(np.uint8)
    lens = [60, 333, 0, 128, 1200, 777, 950, 91]
    ents = [rng.choice(ALPHA, size=k).astype(np.uint8) for k in lens]
    ents[1][20:320] = mutate(rng, q[1700:2000], 30)[:300]
    ents[4][300:1100] = mutate(rng, q[100:900], 90, 3)[:800]
    return q, ents


def test_plain_k22_slab_matches_score_db_slab_strips_jit():
    """K22's slab form -- one shared query against every lane of a flat
    resident slab, lane b at its 64-bit offset -- equals
    ``score_db_slab_strips_jit(gopen=10)`` (B12 with ``shared=True``) on the
    same entries (the query padded to a multiple of 256 with X_PAD, slab
    codes past each entry set to 0)."""
    q, ents = slab_case()
    L = len(ents)
    # The JAX side: one LANE-wide batch of the entries, as pack_slab lays it.
    N = max(len(e) for e in ents)
    Mq = -(-len(q) // S) * S
    plut, elut = (np.asarray(a) for a in wp.PallasEngine(JAX_CFG)._lut())
    Ny = -(-(max(N, 8) + SPA + 2 * wp.UNROLL) // wp.UNROLL) * wp.UNROLL
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
        slab2d, 0, lens, pprof, N=N, worst=WORST, best_sub=BEST, gap=GAP, gopen=GAP_OPEN,
        interpret=True, ncodes=NCODES)]
    # The port: the length-sorted flat slab of ResidentProteinDB.
    order = sorted(range(L), key=lambda k: len(ents[k]))
    slab, offs, slens = pack_slab(ents, order, LUT)
    before = strips_cuda.sw_score_strips_profile_affine.launches
    got = strips_cuda.sw_score_strips_profile_affine(
        codes(q), t(slab), torch.full((L,), len(q), dtype=torch.int32), t(slens), y_off=t(offs),
        **KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w[order])
    assert strips_cuda.sw_score_strips_profile_affine.launches == before
    assert int(want[0][4]) > 1000 and int(want[0][1]) > 300 and int(want[0][2]) == 0


def protein_entries(rng, n=9, minlen=30, maxlen=150):
    """test_protein_db.py's ``_mkdb``."""
    alpha = list("ARNDCQEGHILKMFPSTWYV")
    return [(f"p{k}", "".join(rng.choice(alpha, int(rng.integers(minlen, maxlen)))))
            for k in range(n)]


def test_resident_db_matches_jax_short_and_long_queries_default_gaps():
    """One resident slab under ResidentProteinDB's default gaps (BLOSUM50,
    10/2) serves a 40-aa query (K8) and a 2,064-aa query (K22's slab form),
    and both scans equal the JAX ResidentProteinDB's (single-strip and
    strips slab kernels)."""
    rng = np.random.default_rng(2)
    alpha = list("ARNDCQEGHILKMFPSTWYV")
    entries = protein_entries(rng)
    qshort = "".join(rng.choice(alpha, 40))
    qlong = "".join(rng.choice(alpha, wp.MAX_M + 16))
    # A mutated stretch of the long query in two entries, with a gap.
    for k, at in ((2, 100), (6, 1900)):
        seg = qlong[at : at + 30] + qlong[at + 33 : at + 60]
        entries[k] = (entries[k][0], entries[k][1][:10] + seg + entries[k][1][10:])
    jax_db = JaxResidentDB(entries, matrix="blosum50", batch_size=4, pad_mult=64,
                           max_query_len=wp.MAX_M + 16)
    db = ResidentProteinDB(entries, max_query_len=wp.MAX_M + 16, device="cpu")
    assert (db.cfg.gap_open, db.cfg.gap_penalty) == (GAP_OPEN, GAP)
    for q in (qshort, qlong):
        want_s, want_p, _ = jax_db.scan_scores(q)
        got_s, got_p, _ = db.scan_scores(q)
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_p, want_p)
    assert min(got_s[2], got_s[6]) > 200
    with pytest.raises(ValueError, match="max_query_len"):
        db.encode_query(qlong + "A")


def traceback_reads():
    """Reads of 2,348 aa holding at row 200 a mutated 700-aa segment of a
    900-aa reference (exact, substitutions, substitutions and indels), an
    unrelated one, and a read whose first 624 rows are a 600-aa segment of
    the reference with 24 residues inserted at rows 500-523, across the
    strip edge at row 512 (its walk's F run crosses it)."""
    rng = np.random.default_rng(3)
    m, n = wp.MAX_M + 300, 900
    ref = rng.choice(ALPHA, size=n)
    reads = []
    for subs, indels in [(0, 0), (30, 0), (15, 6)]:
        s0 = int(rng.integers(0, n - 700))
        seg = mutate(rng, ref[s0 : s0 + 700], subs, indels)
        r = rng.choice(ALPHA, size=m)
        r[200 : 200 + len(seg)] = seg[: min(len(seg), m - 200)]
        reads.append(r)
    reads.append(rng.choice(ALPHA, size=m))
    r = rng.choice(ALPHA, size=m)
    r[:624] = np.concatenate([ref[50:550], rng.choice(ALPHA, size=24), ref[550:650]])
    reads.append(r)
    return [r.tobytes().decode() for r in reads], ref.tobytes().decode()


TB_READS = ["exact", "substitutions", "indels", "unrelated", "insertion"]


@pytest.fixture(scope="module")
def strip_batches():
    """The JAX Pallas aligner (B16, then B20 and the affine strip walk per
    128-row strip) and the port's (K23, then K24 and K18 per 256-row strip;
    plain on CPU) on the traceback reads, BLOSUM50 10/2."""
    reads, ref = traceback_reads()
    counters = (strips_cuda.sw_score_strips_profile_affine_ckpt,
                strips_cuda.strip_profile_affine_moves, traceback.walk_strip_level_affine)
    before = [fn.launches for fn in counters]
    got = BatchSWAligner(PORT_CFG, device="cpu").align_batch(reads, [ref])
    assert [fn.launches for fn in counters] == before
    return got, JaxBatchAligner(JAX_CFG, score_engine="pallas").align_batch(reads, [ref])


def fields(r):
    return (r.score, r.pos, r.max_i, r.max_j, r.consensus_x, r.consensus_y)


@pytest.mark.parametrize("k", range(len(TB_READS)), ids=TB_READS)
def test_batch_aligner_affine_profile_strip_traceback_matches_jax(k, strip_batches):
    """BatchSWAligner's strip traceback under BLOSUM50 10/2 equals the JAX
    aligner's in score, pos, max_i, max_j and both consensus strings, which
    hold the raw letters, not compact codes."""
    got, want = strip_batches[0][k], strip_batches[1][k]
    assert fields(got) == fields(want)
    assert len(got.timings.levels_us) == 10
    if TB_READS[k] != "unrelated":
        assert got.score > 1000 and len(got.consensus_x) > 500
        assert set(got.consensus_x + got.consensus_y) <= set(PORT_CFG.alphabet + "-")
    if TB_READS[k] == "insertion":
        assert "-" * 24 in got.consensus_y


@pytest.fixture(scope="module")
def uniprot_data(tmp_path_factory):
    """A 2,100-aa query and 8 entries of 60-600 aa, one holding a mutated
    200-aa segment of the query, plus a 2,200-aa entry holding a mutated
    700-aa one with indels (the top hit, walked in strips) and a 2,060-aa
    unrelated entry."""
    d = tmp_path_factory.mktemp("uniprot_long_affine")
    rng = np.random.default_rng(4)
    q = rng.choice(ALPHA, size=2100)
    ents = [rng.choice(ALPHA, size=int(k)) for k in rng.integers(60, 600, size=8)]
    long_entry = rng.choice(ALPHA, size=2200)
    seg = mutate(rng, q[600:1300], 60, 4)
    long_entry[1300 : 1300 + len(seg)] = seg
    ents[5:5] = [long_entry, rng.choice(ALPHA, size=2060)]
    ents[8] = np.concatenate([ents[8][:30], mutate(rng, q[1800:2000], 20), ents[8][30:]])
    (d / "query.fasta").write_text(">titin_like\n" + q.tobytes().decode() + "\n")
    (d / "db.fasta").write_text("".join(f">e{k}\n{e.tobytes().decode()}\n"
                                        for k, e in enumerate(ents)))
    return d


def test_solve_uniprot_long_query_affine_csv_byte_identical(uniprot_data, tmp_path, capsys):
    """A 2,100-aa query under BLOSUM50 with ``--gap-open 10 --gap-penalty
    2``: the port's solve_uniprot (K22's slab scan; the top hits walked, the
    2,200-aa entry in strips by K23, K24 and K18) writes the JAX package's
    CSV byte for byte."""
    argv = ["--query", str(uniprot_data / "query.fasta"), "--database",
            str(uniprot_data / "db.fasta"), "--matrix", "blosum50", "--top", "3"] + GAP_FLAGS
    outs = {}
    for side, main, flag in (("jax", jax_uniprot.main, ["--platform", "cpu"]),
                             ("port", port_uniprot.main, ["--device", "cpu"])):
        out = tmp_path / f"{side}.csv"
        assert main(argv + ["--output", str(out)] + flag) == 0
        outs[side] = out.read_bytes()
    assert outs["port"] == outs["jax"]
    rows = outs["port"].decode().splitlines()[1:]
    assert rows[5].startswith("e5,2200,") and not rows[5].endswith(",,")
    assert not rows[8].endswith(",,")  # the 200-aa segment's entry, walked too
    assert "-" in rows[5].split(",")[5] + rows[5].split(",")[6]
    assert "Scored" in capsys.readouterr().out


@pytest.fixture(scope="module")
def big_data(tmp_path_factory):
    """solve_big's generated data at a small size (a 2,400-bp reference, two
    2,100-bp reads, one mutated so that the walk takes gaps)."""
    from parallel_genomeseq_tpu_torch.seqio.datagen import gen_reads_custom, gen_ref_custom

    tmp = tmp_path_factory.mktemp("solve_big_matrix_affine")
    ref = gen_ref_custom(tmp / "ref.fa", ref_len=2400, seed=41)
    reads = [s for s, _ in gen_reads_custom(ref, tmp / "reads.csv", n_reads=2, read_len=2100,
                                             seed=42)]
    rng = np.random.default_rng(43)
    seg = list(reads[1])
    for _ in range(23):
        seg[int(rng.integers(0, len(seg)))] = "ACGT"[int(rng.integers(0, 4))]
    for at in (300, 700, 1500):
        del seg[at : at + 4]
    reads[1] = "".join(seg)
    with open(tmp / "reads.csv", "w") as f:
        f.write("index,QNAME,SEQ,POS\n" + "".join(f"{k},r{k},{s},0\n" for k, s in enumerate(reads)))
    return tmp, ref, reads


@pytest.fixture(scope="module")
def jax_big(big_data):
    """The JAX ChunkedAligner with the Pallas engine under BLOSUM50 10/2 on
    solve_big's windows (npiece 2 -> 4 windows of 1,387 bp at overlap ratio
    0.5), with and without traceback."""
    _, ref, reads = big_data
    al = JaxChunkedAligner(JAX_CFG, chunk=JaxChunkConfig(npiece=4, overlap_ratio=0.5),
                           score_engine="pallas")
    return {tb: al.align_batch(reads, ref, traceback=tb) for tb in (False, True)}


@pytest.mark.parametrize("tb", [False, True], ids=["score_only", "traceback"])
def test_solve_big_matrix_affine_matches_jax(tb, big_data, jax_big, capsys):
    """cli/solve_big --matrix blosum50 --gap-open 10 --gap-penalty 2 on the
    CPU: K22's window sweep and, with --traceback, the winners' affine
    profile strip traceback (K23, K24, K18) equal the JAX ChunkedAligner in
    score, pos, argmax and consensus."""
    tmp, ref, reads = big_data
    flags = ["2", "1", "--ref", str(tmp / "ref.fa"), "--reads", str(tmp / "reads.csv"),
             "--overlap-ratio", "0.5", "--matrix", "blosum50", "--device", "cpu"] + GAP_FLAGS + \
        (["--traceback"] if tb else [])
    run = solve_big.run(flags)
    assert run.rc == 0 and len(run.results) == 2
    for got, want in zip(run.results, jax_big[tb]):
        assert fields(got) == fields(want)
    out = capsys.readouterr().out
    assert ("traceback strip levels" in out) == tb
    if tb:
        assert len(run.levels_us[0]) == 9  # 2,104 rows
        assert "----" in run.results[1].consensus_x + run.results[1].consensus_y
        assert set(run.results[0].consensus_x) <= set("ACGT")
