"""The port's affine long-read (strip) path against the JAX package, on the CPU.

The affine strip kernels' plain versions (K15 ``sw_score_plain`` with
gap_open, K16 ``sw_score_affine_ckpt_plain``, K17
``strip_affine_moves_plain``, K18 ``_walk_strip_affine_plain``) and the
routes through the engine, ``BatchSWAligner``, ``ChunkedAligner``,
``cli/solve_big`` and ``cli/solve_small`` against the Pallas strip kernels
B10, B14 and B18 in interpret mode, the JAX ``walk_strip_level_affine``,
the JAX scan and the JAX aligners, under two configs: 3/-3 with gaps 4 + 1
per base (``tests/test_strips.py``'s) and BWA-MEM's 1/-4 with 6 + 1.

(score, i, j), pos and consensus strings are held exactly. The port keeps
its full sweep's affine boundaries (F = 0 above row 1, E = -2^30 in column
0; B14/B18 start F at -(open + extend + 1) and E at 0), so B14's F rows are
held where they are >= 0, and B18's bytes in the H source on every cell of
a lane's matrix and in each extend bit where the JAX scan's E (F) of that
cell is >= 0 -- the scan has the port's boundaries, and its bytes equal the
port's in every bit. Inputs come from numpy seeds at small sizes (M = 2,048
to 2,560; references of 700 bp, but for the cutover's 2,300 and solve_big's
1,387-bp windows; B <= 6); JAX results are shared through module-scoped
fixtures.
"""

import csv

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.models.swaligner import BatchSWAligner as JaxBatchAligner
from parallel_genomeseq_tpu.ops import traceback as jax_traceback
from parallel_genomeseq_tpu.ops import wavefront_pallas as wp
from parallel_genomeseq_tpu.ops.scan_dp import ScanEngine
from parallel_genomeseq_tpu.parallel.chunking import ChunkedAligner as JaxChunkedAligner
from parallel_genomeseq_tpu.utils.config import ChunkConfig as JaxChunkConfig
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxScoringConfig
from parallel_genomeseq_tpu_torch.cli import solve_big, solve_small
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops import engine, scan_dp, strips_cuda, traceback
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

DNA = np.frombuffer(b"ACGT", np.uint8)
PADW = wp.STRIP_PADW  # B14's rows hold column j at p = j + PADW
S = scan_dp.STRIP_S
SCORING = {"gotoh": (3, -3, 4, 1), "bwa": (1, -4, 6, 1)}  # match, mismatch, open, extend
KW = {k: dict(match=a, mismatch=b, gap_open=o, gap=e) for k, (a, b, o, e) in SCORING.items()}
JAX_CFG = {k: JaxScoringConfig(match=float(a), mismatch=float(b), gap_open=float(o),
                               gap_penalty=float(e)) for k, (a, b, o, e) in SCORING.items()}
PORT_CFG = {k: ScoringConfig(match=float(a), mismatch=float(b), gap_open=float(o),
                             gap_penalty=float(e)) for k, (a, b, o, e) in SCORING.items()}
BWA_FLAGS = ["--match", "1", "--mismatch", "-4", "--gap-open", "6", "--gap-penalty", "1"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def mutate(rng, seq, n_sub, n_indel=0):
    """test_strips.py's mutation: substitutions, then 1-bp indels."""
    s = list(seq)
    for _ in range(n_sub):
        s[int(rng.integers(0, len(s)))] = int(rng.choice(DNA))
    for _ in range(n_indel):
        p = int(rng.integers(1, len(s) - 1))
        if rng.integers(0, 2):
            s.insert(p, int(rng.choice(DNA)))
        else:
            del s[p]
    return np.array(s, np.uint8)


def planted_case():
    """test_strips.py:230-245: three 2,100-bp lanes against a 400-bp
    reference, the reference planted whole in lane 0 and with a 3-bp
    deletion in lane 1 (one gap run)."""
    rng = np.random.default_rng(0)
    B, m, n = 3, wp.MAX_M + 52, 400
    ref = rng.choice(DNA, size=n)
    xs = rng.choice(DNA, size=(B, m)).astype(np.uint8)
    ys = np.broadcast_to(ref[None, :], (B, n)).copy()
    xs[0, 700 : 700 + n] = ref
    seg = np.concatenate([ref[50:150], ref[153:250]])
    xs[1, 300 : 300 + len(seg)] = seg
    return xs, ys, np.full(B, m, np.int32), np.full(B, n, np.int32)


def ragged_case():
    """Ragged reference lengths, each lane partly planted, with a 4-bp
    insertion, so that its best cell lies inside the read."""
    rng = np.random.default_rng(1)
    B, m = 4, wp.MAX_M + 200
    n = np.array([64, 200, 333, 120], np.int32)
    xs = rng.choice(DNA, size=(B, m)).astype(np.uint8)
    ys = np.full((B, int(n.max())), 2, np.uint8)
    for b in range(B):
        ys[b, : n[b]] = rng.choice(DNA, size=n[b])
        k = n[b] // 2
        seg = np.concatenate([ys[b, : k // 2], rng.choice(DNA, 4), ys[b, k // 2 : k]])
        xs[b, 300 * b + 500 : 300 * b + 500 + len(seg)] = seg
    return xs, ys, np.full(B, m, np.int32), n


CASES = {"planted": planted_case, "ragged": ragged_case}
# (config, case) pairs held against B10: both configs on the planted case,
# the ragged case under BWA-MEM's scoring.
B10_CASES = [("gotoh", "planted"), ("bwa", "planted"), ("bwa", "ragged")]


@pytest.fixture(scope="module")
def b10():
    """PallasEngine.score_batch (B10 in interpret mode) on B10_CASES."""
    out = {}
    for cfg, name in B10_CASES:
        res = wp.PallasEngine(JAX_CFG[cfg]).score_batch(*CASES[name]())
        out[cfg, name] = {k: np.asarray(res[k]) for k in ("score", "i", "j")}
    return out


@pytest.mark.parametrize("cfg, case", B10_CASES, ids=[f"{c}-{k}" for c, k in B10_CASES])
def test_score_batch_matches_b10(cfg, case, b10):
    """Both engines route an affine read over MAX_M to K15 (plain on CPU
    tensors) and equal B10's (score, i, j); need_pos=False keeps the score
    and gives i = j = 0; no kernel launches on the CPU."""
    xs, ys, m, n = CASES[case]()
    before = strips_cuda.sw_score_strips_affine.launches
    for name in ("cuda", "plain"):
        eng = engine.make_score_engine(PORT_CFG[cfg], name=name, device="cpu")
        got = eng.score_batch(xs, ys, m, n)
        for k in ("score", "i", "j"):
            np.testing.assert_array_equal(got[k].numpy(), b10[cfg, case][k], err_msg=f"{name} {k}")
        got = eng.score_batch(xs, ys, m, n, need_pos=False)
        np.testing.assert_array_equal(got["score"].numpy(), b10[cfg, case]["score"])
        assert not got["i"].any() and not got["j"].any()
    assert strips_cuda.sw_score_strips_affine.launches == before
    if case == "planted":
        match = SCORING[cfg][0]
        assert int(b10[cfg, case]["score"][0]) == match * 400
        assert int(b10[cfg, case]["score"][1]) >= match * 197 - (SCORING[cfg][2] + 3 * SCORING[cfg][3])


@pytest.fixture(scope="module")
def b14():
    """B14 (_call_strips_affine_ckpt, interpret mode) on the planted case for
    both configs, the padded kernel inputs, and the JAX scan's per-cell E, F
    and moves on the same lanes (the port's boundaries)."""
    xs, ys, m, n = planted_case()
    out = {}
    for cfg, kw in KW.items():
        X, Y = wp.PallasEngine(JAX_CFG[cfg]).prepare(xs, ys, m, n)["args"]
        _, _, rows, frows = wp._call_strips_affine_ckpt(
            X, Y, match=kw["match"], mismatch=kw["mismatch"], gap=kw["gap"],
            gopen=kw["gap_open"], interpret=True)
        scan = ScanEngine(JAX_CFG[cfg]).score_batch(xs, ys, m, n, keep_matrix=True,
                                                    emit_moves=True)
        out[cfg] = dict(X=X, Y=Y, rows=np.asarray(rows).astype(np.int32),
                        frows=np.asarray(frows).astype(np.int32),
                        **{k: np.asarray(scan[k]) for k in ("estack", "fstack", "moves")})
    return out


def at_rows(plane, rows, N):
    """A (D, M, B) per-cell plane at (global 0-based) rows ``rows`` for
    columns 1..N, as (B, len(rows), N): cell (r, j) lies on diagonal
    r + j - 1."""
    d = np.asarray(rows)[:, None] + np.arange(N)[None, :]
    return plane[d, np.asarray(rows)[:, None]].transpose(2, 0, 1)


@pytest.mark.parametrize("cfg", list(SCORING))
def test_checkpoint_rows_match_b14(cfg, b14):
    """K16's plain version: (score, i, j) as K15; its H rows equal B14's
    exactly, its F rows equal B14's wherever those are >= 0 and the JAX
    scan's F everywhere."""
    xs, ys, m, n = planted_case()
    got = strips_cuda.sw_score_strips_affine_ckpt(t(xs), t(ys), t(m), t(n), **KW[cfg])
    want = scan_dp.sw_score_plain(t(xs), t(ys), t(m), t(n), **KW[cfg])
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w)
    ck, fck = got[3].numpy(), got[4].numpy()
    B, N = ys.shape
    K = -(-xs.shape[1] // S) - 1
    assert ck.shape == fck.shape == (B, K, N)
    cols = slice(PADW + 1, PADW + 1 + N)
    np.testing.assert_array_equal(ck, b14[cfg]["rows"][:K, cols, :B].transpose(2, 0, 1))
    theirs = b14[cfg]["frows"][:K, cols, :B].transpose(2, 0, 1)
    pos = theirs >= 0
    np.testing.assert_array_equal(fck[pos], theirs[pos])
    assert pos.sum() > 100 and ck.max() > 0
    rows = (np.arange(K) + 1) * S - 1
    np.testing.assert_array_equal(fck, at_rows(b14[cfg]["fstack"], rows, N))


@pytest.mark.parametrize("strip", [0, 4, 8], ids=["bottom", "middle", "top"])
@pytest.mark.parametrize("cfg", list(SCORING))
def test_strip_replay_matches_b18(cfg, strip, b14):
    """K17's plain version replays a strip from its H and F rows (none for
    strip 0): every byte of a lane's matrix equals the JAX scan's (the full
    sweep's), the H source equals B18's (_call_strip_affine_moves, fed B14's
    rows), and B18's extend bits differ only where the scan's E or F of the
    cell is negative."""
    xs, ys, m, n = planted_case()
    B, N = ys.shape
    kw = KW[cfg]
    ck, fck = scan_dp.sw_score_affine_ckpt_plain(t(xs), t(ys), t(m), t(n), **kw)[3:]
    rows = (ck[:, strip - 1], fck[:, strip - 1]) if strip else (None, None)
    got = strips_cuda.strip_affine_moves(t(xs), t(ys), t(m), t(n), *rows, strip * S, **kw)
    assert got.shape == (B, N, S) and got.dtype == torch.uint8
    got = got.numpy()
    X, Y = b14[cfg]["X"], b14[cfg]["Y"]
    rowin = b14[cfg]["rows"][strip - 1] if strip else np.zeros(b14[cfg]["rows"].shape[1:])
    frowin = (b14[cfg]["frows"][strip - 1] if strip
              else np.full(b14[cfg]["frows"].shape[1:], -(kw["gap_open"] + kw["gap"] + 1)))
    jax_moves = np.asarray(wp._call_strip_affine_moves(
        X[strip * S : (strip + 1) * S], Y, rowin.astype(np.int16), frowin.astype(np.int16),
        match=kw["match"], mismatch=kw["mismatch"], gap=kw["gap"], gopen=kw["gap_open"],
        interpret=True))
    r = np.arange(S)[None, :]
    theirs = jax_moves[r + np.arange(N)[:, None], r][:, :, :B].transpose(2, 0, 1)
    rr = strip * S + np.arange(min(S, xs.shape[1] - strip * S))  # the read's rows
    got, theirs = got[:, :, : len(rr)], theirs[:, :, : len(rr)]
    valid = np.broadcast_to(rr[None, None, :] < m[:, None, None], got.shape)
    scan = {k: at_rows(b14[cfg][k], rr, N).transpose(0, 2, 1)[valid]  # the moves' layout
            for k in ("moves", "estack", "fstack")}
    np.testing.assert_array_equal(got[valid], scan["moves"])
    np.testing.assert_array_equal(got[valid] & 3, theirs[valid] & 3)
    e, f = scan["estack"], scan["fstack"]
    diff = got[valid] ^ theirs[valid]
    assert (e[(diff & scan_dp.E_EXT_BIT) != 0] < 0).all()
    assert (f[(diff & scan_dp.F_EXT_BIT) != 0] < 0).all()
    assert ((got[valid] & scan_dp.F_EXT_BIT) != 0).any()


def insertion_read(rng, m: int = wp.MAX_M + 512):
    """test_strips.py:170-195's planted insertion on a short reference: a
    read of 10 strips whose first 624 rows are a 600-bp segment of a 700-bp
    reference with 24 inserted bases at read rows 500-523, across the strip
    edge at row 512 (the walk's F run crosses it); the other rows are
    random. Returns (read, ref)."""
    ref = rng.choice(DNA, size=700)
    read = rng.choice(DNA, size=m)
    read[:624] = np.concatenate([ref[50:550], rng.choice(DNA, size=24), ref[550:650]])
    return read, ref


def test_strip_walk_matches_jax_walk_strip_level_affine():
    """K18's plain version strip by strip against the JAX
    walk_strip_level_affine on the same moves: the state (gap state
    included) carries in, a lane's F run crosses the strip edge at row 512
    and resumes, and emissions past a short buffer drop while steps counts
    on."""
    rng = np.random.default_rng(4)
    read, ref = insertion_read(rng)
    B, M, N = 3, read.shape[0], ref.shape[0]
    xs = np.stack([read, read, rng.choice(DNA, M)]).astype(np.uint8)
    ys = np.broadcast_to(ref, (B, N)).copy()
    m, n = np.full(B, M, np.int32), np.full(B, N, np.int32)
    kw = KW["gotoh"]
    score, i, j, ck, fck = scan_dp.sw_score_affine_ckpt_plain(t(xs), t(ys), t(m), t(n), **kw)
    max_steps = 1200
    state = traceback.new_strip_state(i, j, max_steps, affine=True)
    state[4][1] = 3  # a lane that emitted three steps in an earlier strip
    # Copies: the port's walk updates its state in place while JAX may still
    # be reading its inputs.
    jstate = tuple(np.array(a) for a in (state[0], state[1], state[2], state[7], state[3],
                                         state[5], state[6], state[4]))
    x_mb = t(xs.T)
    r = np.arange(S)[None, :]
    d = r + np.arange(N)[:, None]
    crossed = False
    strips = {}
    for s in range(-(-M // S) - 1, -1, -1):
        rows = (ck[:, s - 1], fck[:, s - 1]) if s else (None, None)
        moves = strips[s] = scan_dp.strip_affine_moves_plain(t(xs), t(ys), t(m), t(n), *rows,
                                                             s * S, **kw)
        jax_moves = np.zeros((S + N - 1, S, B), np.uint8)
        jax_moves[d, r] = moves.numpy().transpose(1, 2, 0)
        jstate = jax_traceback.walk_strip_level_affine(
            jax_moves, xs.T[s * S : (s + 1) * S].copy(), ys, s * S, jstate, max_steps=S + N)
        traceback.walk_strip_level_affine(moves, x_mb, t(ys), s * S, state, max_steps=max_steps)
        i_, j_, pos, g, active, cx, cy, steps = (np.asarray(a) for a in jstate)
        for got, want in zip(state, (i_, j_, pos, active, steps, cx, cy, g)):
            np.testing.assert_array_equal(got.numpy(), want)
        crossed |= s == 2 and int(state[7][0]) == 2  # left strip 2 inside the F run
    # Every walk ended: stopped, or ran through row 1 (which leaves a lane
    # active at i = 0, in no strip, as in the JAX walk).
    assert crossed and int(state[4][0]) > 600 and not (state[3] & (state[0] > 0)).any()
    # Truncation: the same walk with a 60-row buffer.
    short = traceback.new_strip_state(i, j, 60, affine=True)
    for s, moves in strips.items():
        traceback.walk_strip_level_affine(moves, x_mb, t(ys), s * S, short, max_steps=60)
    assert torch.equal(short[4][0], state[4][0])
    assert torch.equal(short[5][:, 0], state[5][:60, 0])


def strip_reads():
    """test_strips.py:138-224's reads on short references, in one batch:
    four 2,348-bp reads holding at rows 1,500-2,120 a mutated 620-bp
    segment of a 700-bp reference (substitutions, indels), across the strip
    edges at rows 1,536, 1,792 and 2,048; an unrelated read; and the
    2,560-bp read with the 24-base insertion across a strip edge, against
    its own reference."""
    rng = np.random.default_rng(3)
    n, m = 700, wp.MAX_M + 300
    ref = rng.choice(DNA, size=n)
    reads = []
    for subs, indels in [(0, 0), (12, 0), (6, 8), (0, 14)]:
        s0 = int(rng.integers(0, n - 620))
        seg = mutate(rng, ref[s0 : s0 + 620], subs, indels)
        r = rng.choice(DNA, size=m)
        r[1500 : 1500 + len(seg)] = seg
        reads.append(r)
    reads.append(rng.choice(DNA, size=m))
    ins_read, ins_ref = insertion_read(rng)
    refs = [ref] * 5 + [ins_ref]
    return ([r.tobytes().decode() for r in reads + [ins_read]],
            [r.tobytes().decode() for r in refs])


STRIP_READS = ["planted", "substitutions", "indels8", "indels14", "unrelated", "insertion"]


def fields(r):
    return (r.score, r.pos, r.max_i, r.max_j, r.consensus_x, r.consensus_y)


@pytest.fixture(scope="module")
def strip_batches():
    """The JAX aligner (Pallas: B14, then B18 and the affine strip walk) and
    the port's on strip_reads, 3/-3 with gaps 4 + 1."""
    reads, refs = strip_reads()
    jax = JaxBatchAligner(JAX_CFG["gotoh"], score_engine="pallas").align_batch(reads, refs)
    port = BatchSWAligner(PORT_CFG["gotoh"], device="cpu").align_batch(reads, refs)
    return jax, port


@pytest.mark.parametrize("k", range(len(STRIP_READS)), ids=STRIP_READS)
def test_batch_aligner_affine_strip_traceback_matches_jax(k, strip_batches):
    """BatchSWAligner's affine strip traceback (K16, then K17 + K18 per
    strip; plain on CPU) equals the JAX aligner's in score, pos, max_i,
    max_j and both consensus strings."""
    jax, port = strip_batches
    got, want = port[k], jax[k]
    assert fields(got) == fields(want)
    assert len(got.timings.levels_us) == 10
    if STRIP_READS[k] != "unrelated":
        assert got.score > 1000 and len(got.consensus_x) > 500
    if STRIP_READS[k] == "insertion":
        assert "-" * 20 in got.consensus_y


def write_big_data(tmp_path, seed: int):
    """solve_big's generated data at a small size, one read mutated so that
    the walk takes gaps across strip edges."""
    from parallel_genomeseq_tpu_torch.seqio.datagen import gen_reads_custom, gen_ref_custom

    ref = gen_ref_custom(tmp_path / "ref.fa", ref_len=2400, seed=seed)
    reads = [s for s, _ in gen_reads_custom(ref, tmp_path / "reads.csv", n_reads=2,
                                             read_len=2100, seed=seed + 1)]
    rng = np.random.default_rng(seed + 2)
    reads[1] = mutate(rng, np.frombuffer(reads[1].encode(), np.uint8), 23, 5).tobytes().decode()
    with open(tmp_path / "reads.csv", "w") as f:
        f.write("index,QNAME,SEQ,POS\n" + "".join(f"{k},r{k},{s},0\n" for k, s in enumerate(reads)))
    return ref, reads


@pytest.fixture(scope="module")
def big_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("solve_big_affine")
    ref, reads = write_big_data(tmp, 21)
    return tmp, ref, reads


@pytest.fixture(scope="module")
def jax_big(big_data):
    """The JAX ChunkedAligner with the Pallas engine on solve_big's windows
    (npiece 2 -> 4 windows of 1,387 bp at overlap ratio 0.5) under BWA-MEM's
    scoring, with and without traceback."""
    _, ref, reads = big_data
    al = JaxChunkedAligner(JAX_CFG["bwa"], chunk=JaxChunkConfig(npiece=4, overlap_ratio=0.5),
                           score_engine="pallas")
    return {tb: al.align_batch(reads, ref, traceback=tb) for tb in (False, True)}


@pytest.mark.parametrize("tb", [False, True], ids=["score_only", "traceback"])
def test_solve_big_affine_matches_jax_chunked_aligner(tb, big_data, jax_big, capsys):
    """cli/solve_big --gap-open on the CPU: K15's window sweep and, with
    --traceback, the winners' affine strip traceback equal the JAX
    ChunkedAligner, which the port's ChunkedAligner equals too."""
    from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkConfig, ChunkedAligner

    tmp, ref, reads = big_data
    flags = ["2", "1", "--ref", str(tmp / "ref.fa"), "--reads", str(tmp / "reads.csv"),
             "--overlap-ratio", "0.5", "--device", "cpu"] + BWA_FLAGS + (["--traceback"] if tb else [])
    run = solve_big.run(flags)
    assert run.rc == 0 and len(run.results) == 2
    for got, want in zip(run.results, jax_big[tb]):
        assert fields(got) == fields(want)
    out = capsys.readouterr().out
    assert "npiece 4" in out and "GCUPS mean" in out
    assert ("traceback strip levels" in out) == tb
    if tb:
        assert len(run.levels_us[0]) == 9  # 2,104 rows
        assert "-" in run.results[1].consensus_x + run.results[1].consensus_y
    else:
        chunked = ChunkedAligner(PORT_CFG["bwa"], chunk=ChunkConfig(npiece=4, overlap_ratio=0.5),
                                 device="cpu")
        assert [r.score for r in chunked.align_batch(reads, ref, traceback=False)] == \
            [r.score for r in run.results]


@pytest.mark.parametrize("long_len", [2048, 2056], ids=["single_strip", "strips"])
def test_affine_cutover_gives_equal_results(long_len):
    """Affine reads of 2,040 bp aligned in a batch whose longest read is
    2,048 bp (K7 + K10) and 2,056 bp (K16 + K17 + K18): the same results on
    both sides of the cutover, and the longest read's equal to the JAX
    scan's."""
    rng = np.random.default_rng(5)
    ref = rng.choice(DNA, size=2300)
    short = [mutate(rng, ref[s : s + 2040], 10, 3)[:2040].tobytes().decode() for s in (30, 200)]
    longest = mutate(rng, ref[200 : 200 + long_len], 15, 0)
    longest = np.concatenate([longest[:900], rng.choice(DNA, 5), longest[900:]])[:long_len]
    longest = longest.tobytes().decode()
    ref_s = ref.tobytes().decode()
    cfg = PORT_CFG["bwa"]
    got = BatchSWAligner(cfg, device="cpu").align_batch(short + [longest], [ref_s])
    alone = BatchSWAligner(cfg, device="cpu").align_batch(short, [ref_s])
    assert [fields(g) for g in got[:2]] == [fields(a) for a in alone]
    want = JaxBatchAligner(JAX_CFG["bwa"], score_engine="scan").align_batch([longest], [ref_s])[0]
    assert fields(got[2]) == fields(want)
    assert (len(got[2].timings.levels_us) > 0) == (long_len > engine.MAX_M)
    assert "-----" in got[2].consensus_y


def test_solve_small_takes_affine_reads_over_2048(tmp_path):
    """solve_small --gap-open --npiece 1 with 2,100-bp reads (the affine
    strip traceback), each holding a mutated 600-bp segment of a 700-bp
    reference at rows 1,400-2,000: its CSV holds the JAX scan's score and
    pos for every read."""
    rng = np.random.default_rng(6)
    ref = rng.choice(DNA, size=700)
    reads = []
    for s in (20, 80):
        r = rng.choice(DNA, size=2100)
        seg = mutate(rng, ref[s : s + 600], 4, 2)
        r[1400 : 1400 + len(seg)] = seg
        reads.append(r.tobytes().decode())
    ref_s = ref.tobytes().decode()
    (tmp_path / "ref.fa").write_text(f">ref\n{ref_s}\n")
    with open(tmp_path / "reads.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "QNAME", "SEQ", "POS"])
        w.writerows([k, f"r{k}", r, 0] for k, r in enumerate(reads))
    want = JaxBatchAligner(JAX_CFG["bwa"], score_engine="scan").align_batch(reads, [ref_s])
    out = tmp_path / "out.csv"
    assert solve_small.main(["--ref", str(tmp_path / "ref.fa"), "--input",
                             str(tmp_path / "reads.csv"), "--output", str(out),
                             "--npiece", "1", "--device", "cpu"] + BWA_FLAGS) == 0
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [(float(r["score"]), int(r["pos_pred"])) for r in rows] == \
        [(w.score, w.pos) for w in want]
    assert min(w.score for w in want) > 400


def test_affine_scores_past_the_int16_envelope_match_the_scan_engine():
    """match x M > 32,000 under affine gaps: the JAX strip kernel refuses
    (EnvelopeError) and its aligners fall back to ScanEngine; the port's
    int32 rows run it on the affine strip path and equal ScanEngine."""
    rng = np.random.default_rng(2)
    B, m, n = 2, 2100, 2300
    ref = rng.choice(DNA, size=n)
    xs = rng.choice(DNA, size=(B, m)).astype(np.uint8)
    xs[0] = ref[100 : 100 + m]  # a full-length match: score 16 x 2,100
    xs[1, 1000:1250] = ref[:250]
    xs[1, 1253:1500] = ref[250:497]  # an insertion of 3 in the read
    ys = np.broadcast_to(ref[None], (B, n)).copy()
    mm, nn = np.full(B, m, np.int32), np.full(B, n, np.int32)
    jcfg = JaxScoringConfig(match=16.0, mismatch=-3.0, gap_penalty=2.0, gap_open=5.0)
    with pytest.raises(wp.EnvelopeError):
        wp.PallasEngine(jcfg).score_batch(xs, ys, mm, nn)
    want = ScanEngine(jcfg).score_batch(xs, ys, mm, nn)
    got = engine.make_score_engine(
        ScoringConfig(match=16.0, mismatch=-3.0, gap_penalty=2.0, gap_open=5.0),
        device="cpu").score_batch(xs, ys, mm, nn)
    for k in ("score", "i", "j"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert int(got["score"][0]) == 16 * m > wp.INT16_BOUND
