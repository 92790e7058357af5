"""The port's long-read (strip) path against the JAX package, on the CPU.

The strip kernels' plain versions (K11 ``sw_score_plain``, K12
``sw_score_ckpt_plain``, K13 ``strip_moves_plain``, K14
``_walk_strip_plain``) and the routes through the engine, ``BatchSWAligner``,
``ChunkedAligner`` and ``cli/solve_big`` are held exactly (integers and
bytes) against the Pallas strip kernels B9, B13 and B17 in interpret mode,
the JAX ``walk_strip_level`` and the JAX aligners. Inputs come from numpy
seeds at small sizes (M = 2,048-3,072, B <= 5); JAX results are shared
through module-scoped fixtures, one JAX call per case.
"""

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
from parallel_genomeseq_tpu_torch.cli import solve_big
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops import engine, scan_dp, strips_cuda, traceback
from parallel_genomeseq_tpu_torch.seqio.datagen import gen_reads_custom, gen_ref_custom
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

DNA = np.frombuffer(b"ACGT", np.uint8)
KW = dict(match=3, mismatch=-3, gap=2)
PADW = wp.STRIP_PADW  # B13's rows hold column j at p = j + PADW
S = scan_dp.STRIP_S


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
    """test_strips.py:14-26: three 2,100-bp lanes against a 400-bp reference,
    the reference planted in lane 0."""
    rng = np.random.default_rng(0)
    B, m, n = 3, wp.MAX_M + 52, 400
    ref = rng.choice(DNA, size=n)
    xs = rng.choice(DNA, size=(B, m)).astype(np.uint8)
    ys = np.broadcast_to(ref[None, :], (B, n)).copy()
    xs[0, 700 : 700 + n] = ref
    return xs, ys, np.full(B, m, np.int32), np.full(B, n, np.int32)


def ragged_case():
    """test_strips.py:29-41: ragged reference lengths, each lane partly
    planted so that its best cell lies inside the read."""
    rng = np.random.default_rng(1)
    B, m = 4, wp.MAX_M + 200
    n = np.array([64, 200, 333, 120], np.int32)
    xs = rng.choice(DNA, size=(B, m)).astype(np.uint8)
    ys = np.full((B, int(n.max())), 2, np.uint8)
    for b in range(B):
        ys[b, : n[b]] = rng.choice(DNA, size=n[b])
        xs[b, 300 * b + 500 : 300 * b + 500 + n[b] // 2] = ys[b, : n[b] // 2]
    return xs, ys, np.full(B, m, np.int32), n


CASES = {"planted": planted_case, "ragged": ragged_case}


@pytest.fixture(scope="module")
def b9():
    """PallasEngine.score_batch (B9 in interpret mode) on both cases."""
    out = {}
    for name, make in CASES.items():
        xs, ys, m, n = make()
        res = wp.PallasEngine().score_batch(xs, ys, m, n)
        out[name] = {k: np.asarray(res[k]) for k in ("score", "i", "j")}
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_score_batch_matches_b9(case, b9):
    """The port's engines route M > MAX_M to K11 (plain on CPU tensors) and
    equal B9's (score, i, j); need_pos=False keeps the score and gives
    i = j = 0."""
    xs, ys, m, n = CASES[case]()
    for name in ("cuda", "plain"):
        eng = engine.make_score_engine(name=name, device="cpu")
        got = eng.score_batch(xs, ys, m, n)
        for k in ("score", "i", "j"):
            np.testing.assert_array_equal(got[k].numpy(), b9[case][k], err_msg=f"{name} {k}")
        got = eng.score_batch(xs, ys, m, n, need_pos=False)
        np.testing.assert_array_equal(got["score"].numpy(), b9[case]["score"])
        assert not got["i"].any() and not got["j"].any()
    if case == "planted":
        assert int(b9[case]["score"][0]) == 3 * 400


def test_scores_past_the_int16_envelope_match_the_scan_engine():
    """match x M > 32,000: the JAX strip kernel refuses (EnvelopeError) and
    its aligners fall back to ScanEngine; the port's int32 rows run it on the
    strip path and equal ScanEngine."""
    rng = np.random.default_rng(2)
    B, m, n = 2, 2100, 2300
    ref = rng.choice(DNA, size=n)
    xs = rng.choice(DNA, size=(B, m)).astype(np.uint8)
    xs[0] = ref[100 : 100 + m]  # a full-length match: score 16 x 2,100
    xs[1, 1000:1500] = ref[:500]
    ys = np.broadcast_to(ref[None], (B, n)).copy()
    mm, nn = np.full(B, m, np.int32), np.full(B, n, np.int32)
    jcfg = JaxScoringConfig(match=16.0, mismatch=-3.0, gap_penalty=2.0)
    with pytest.raises(wp.EnvelopeError):
        wp.PallasEngine(jcfg).score_batch(xs, ys, mm, nn)
    want = ScanEngine(jcfg).score_batch(xs, ys, mm, nn)
    got = engine.make_score_engine(ScoringConfig(match=16.0, mismatch=-3.0, gap_penalty=2.0),
                                   device="cpu").score_batch(xs, ys, mm, nn)
    for k in ("score", "i", "j"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert int(got["score"][0]) == 16 * m > wp.INT16_BOUND


@pytest.fixture(scope="module")
def b13():
    """B13 (_call_strips_ckpt, interpret mode) on the planted case: the
    padded kernel inputs and the int16 boundary rows, as int32."""
    xs, ys, m, n = planted_case()
    X, Y = wp.PallasEngine().prepare(xs, ys, m, n)["args"]
    _, _, rows = wp._call_strips_ckpt(X, Y, interpret=True, **KW)
    return X, Y, np.asarray(rows).astype(np.int32)


def test_checkpoint_rows_match_b13(b13):
    """K12's plain version: (score, i, j) as K11, and the H of rows kS - 1
    equal B13's boundary rows at p = j + padw, for every column."""
    _, _, rows = b13
    xs, ys, m, n = planted_case()
    got = strips_cuda.sw_score_strips_ckpt(t(xs), t(ys), t(m), t(n), **KW)
    want = scan_dp.sw_score_plain(t(xs), t(ys), t(m), t(n), **KW)
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w)
    ck = got[3].numpy()
    B, N = ys.shape
    assert ck.shape == (B, -(-xs.shape[1] // S) - 1, N)
    want_rows = rows[: ck.shape[1], PADW + 1 : PADW + 1 + N, :B].transpose(2, 0, 1)
    np.testing.assert_array_equal(ck, want_rows)
    assert ck.max() > 0


@pytest.mark.parametrize("strip", [0, 4])
def test_strip_replay_matches_b17(strip, b13):
    """K13's plain version replays a strip from its checkpoint row (zeros for
    strip 0) and equals B17 (_call_strip_moves) on every cell of the strip."""
    X, Y, rows = b13
    xs, ys, m, n = planted_case()
    B, N = ys.shape
    rowin = rows[strip - 1] if strip else np.zeros(rows.shape[1:], np.int16)
    jax_moves = np.asarray(wp._call_strip_moves(
        X[strip * S : (strip + 1) * S], Y, rowin.astype(np.int16), interpret=True, **KW))
    ck_row = t(rows[strip - 1, PADW + 1 : PADW + 1 + N, :B].T) if strip else None
    got = strips_cuda.strip_moves(t(xs), t(ys), t(m), t(n), ck_row, strip * S, **KW).numpy()
    r = np.arange(S)[None, :]
    want = jax_moves[r + np.arange(N)[:, None], r][:, :, :B].transpose(2, 0, 1)
    assert got.shape == (B, N, S)
    np.testing.assert_array_equal(got, want)


def strip_reads():
    """test_strips.py:57-101's reads in one batch: planted, substitutions,
    indels, deletions-and-insertions, unrelated (2,304 bp, from a 3,200-bp
    reference), and a 12-strip read (3,072 bp) with a mutated 2,400-bp
    segment of the reference inside it."""
    rng = np.random.default_rng(3)
    n, m = 3200, wp.MAX_M + 256
    ref = rng.choice(DNA, size=n)
    reads = []
    for subs, indels in [(0, 0), (40, 0), (25, 6), (0, 12)]:
        s0 = int(rng.integers(0, n - m - 40))
        reads.append(mutate(rng, ref[s0 : s0 + m], subs, indels)[:m])
    reads.append(rng.choice(DNA, size=m))
    long_read = rng.choice(DNA, size=12 * S)
    seg = mutate(rng, ref[300:2700], 30, 8)
    long_read[400 : 400 + len(seg)] = seg[: 12 * S - 400]
    reads.append(long_read)
    return [r.tobytes().decode() for r in reads], ref.tobytes().decode()


STRIP_READS = ["planted", "substitutions", "indels", "indels12", "unrelated", "twelve_strips"]


@pytest.fixture(scope="module")
def jax_strip_batch():
    reads, ref = strip_reads()
    return JaxBatchAligner(score_engine="pallas").align_batch(reads, [ref])


@pytest.fixture(scope="module")
def port_strip_batch():
    reads, ref = strip_reads()
    return BatchSWAligner(device="cpu").align_batch(reads, [ref])


def fields(r):
    return (r.score, r.pos, r.max_i, r.max_j, r.consensus_x, r.consensus_y)


@pytest.mark.parametrize("k", range(len(STRIP_READS)), ids=STRIP_READS)
def test_batch_aligner_strip_traceback_matches_jax(k, jax_strip_batch, port_strip_batch):
    """BatchSWAligner's checkpointed strip traceback (K12, then K13 + K14 per
    strip; plain on CPU) equals the JAX aligner's strip traceback in score,
    pos, max_i, max_j and both consensus strings."""
    got, want = port_strip_batch[k], jax_strip_batch[k]
    assert fields(got) == fields(want)
    assert len(got.timings.levels_us) == 12
    if STRIP_READS[k] != "unrelated":
        assert got.score > 1000 and len(got.consensus_x) > 1000


def test_strip_walk_matches_jax_walk_strip_level():
    """K14's plain version on one strip of replayed moves against the JAX
    walk_strip_level: the state carries in, emissions past a short buffer
    drop while steps counts on, and lanes outside the strip pass through."""
    xs, ys, m, n = planted_case()
    res = scan_dp.sw_score_ckpt_plain(t(xs), t(ys), t(m), t(n), **KW)
    ck = res[3]
    B, N = ys.shape
    strip = 3
    moves = scan_dp.strip_moves_plain(t(xs), t(ys), t(m), t(n), ck[:, strip - 1].contiguous(),
                                      strip * S, **KW)
    # Lane 0 enters the strip at its last row; lanes 1 and 2 start inside it
    # and above it.
    i0 = torch.tensor([(strip + 1) * S, strip * S + 100, strip * S - 5], dtype=torch.int32)
    j0 = i0 - 700  # on lane 0's planted diagonal: a walk of a whole strip
    j0[2] = 200
    max_steps = 60
    state = traceback.new_strip_state(i0, j0, max_steps)
    state[4][1] = 3  # a lane that emitted three steps in an earlier strip
    jstate = tuple(np.asarray(a) for a in (state[0], state[1], state[2], state[3], state[5],
                                           state[6], state[4]))
    got = traceback.walk_strip_level(moves, t(xs.T), t(ys), strip * S, state,
                                     max_steps=max_steps)
    r = np.arange(S)[None, :]
    d = r + np.arange(N)[:, None]
    jax_moves = np.zeros((S + N - 1, S, B), np.uint8)
    jax_moves[d, r] = moves.numpy().transpose(1, 2, 0)
    want = jax_traceback.walk_strip_level(jax_moves, xs.T[strip * S : (strip + 1) * S].copy(),
                                          ys, strip * S, jstate, max_steps=S + N)
    i, j, pos, active, cx, cy, steps = (np.asarray(a) for a in want)
    for g, w in zip(got, (i, j, pos, active, steps, cx, cy)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[4][0]) > max_steps  # lane 0's walk ran past the buffer
    assert got[0][2] == i0[2] and got[4][2] == 0  # lane 2 waits for its strip


def write_big_data(tmp_path, seed: int):
    ref = gen_ref_custom(tmp_path / "ref.fa", ref_len=9000, seed=seed)
    pairs = gen_reads_custom(ref, tmp_path / "reads.csv", n_reads=2, read_len=2300,
                             seed=seed + 1)
    return ref, [s for s, _ in pairs]


@pytest.fixture(scope="module")
def big_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("solve_big")
    ref, reads = write_big_data(tmp, 11)
    # One read mutated, so that the walk takes gaps across strip edges.
    rng = np.random.default_rng(12)
    reads[1] = mutate(rng, np.frombuffer(reads[1].encode(), np.uint8), 23, 5).tobytes().decode()
    with open(tmp / "reads.csv", "w") as f:
        f.write("index,QNAME,SEQ,POS\n" + "".join(f"{k},r{k},{s},0\n" for k, s in enumerate(reads)))
    return tmp, ref, reads


@pytest.fixture(scope="module")
def jax_big(big_data):
    """The JAX ChunkedAligner with the Pallas engine on solve_big's windows
    (npiece 2 -> 4 windows), with and without traceback."""
    _, ref, reads = big_data
    al = JaxChunkedAligner(chunk=JaxChunkConfig(npiece=4, overlap_ratio=2.0),
                           score_engine="pallas")
    return {tb: al.align_batch(reads, ref, traceback=tb) for tb in (False, True)}


@pytest.mark.parametrize("tb", [False, True], ids=["score_only", "traceback"])
def test_solve_big_matches_jax_chunked_aligner(tb, big_data, jax_big, capsys):
    """cli/solve_big.run on the CPU: K11's window sweep and, with
    --traceback, the winners' strip traceback equal the JAX ChunkedAligner;
    the report's lines are printed and the swept cells counted."""
    tmp, ref, reads = big_data
    flags = ["2", "1", "--ref", str(tmp / "ref.fa"), "--reads", str(tmp / "reads.csv"),
             "--device", "cpu"] + (["--traceback"] if tb else [])
    run = solve_big.run(flags)
    assert run.rc == 0 and len(run.results) == 2
    for got, want in zip(run.results, jax_big[tb]):
        assert fields(got) == fields(want)
    out = capsys.readouterr().out
    assert "npiece 4" in out and "GCUPS mean" in out and "swept" in out
    assert ("traceback strip levels" in out) == tb
    assert run.swept_cells == [sum(
        len(r) * (hi - lo) for r in reads
        for lo, hi in solve_big.make_string_ranges(4, len(r), len(ref), 2.0))]
    if tb:
        assert len(run.levels_us[0]) == 9 and "-" in run.results[1].consensus_x + \
            run.results[1].consensus_y


@pytest.mark.parametrize("long_len", [2048, 2056], ids=["single_strip", "strips"])
def test_cutover_gives_equal_results(long_len):
    """Reads of 2,040 bp aligned in a batch whose longest read is 2,048 bp
    (the single-strip path, K2 + K3) and 2,056 bp (the strip path, K12 +
    K13 + K14): the same results on both sides of the cutover, and the
    longest read's equal to JAX's."""
    rng = np.random.default_rng(5)
    ref = rng.choice(DNA, size=2600)
    short = [mutate(rng, ref[s : s + 2040], 10, 3)[:2040].tobytes().decode() for s in (30, 400)]
    longest = mutate(rng, ref[200 : 200 + long_len], 15, 0).tobytes().decode()
    ref_s = ref.tobytes().decode()
    got = BatchSWAligner(device="cpu").align_batch(short + [longest], [ref_s])
    alone = BatchSWAligner(device="cpu").align_batch(short, [ref_s])
    assert [fields(g) for g in got[:2]] == [fields(a) for a in alone]
    want = JaxBatchAligner(score_engine="scan").align_batch([longest], [ref_s])[0]
    assert fields(got[2]) == fields(want)
    assert (len(got[2].timings.levels_us) > 0) == (long_len > engine.MAX_M)
