"""Global alignment in the port against the JAX package, on the CPU: the NW
last-row sweep (K25's plain version, ``ops/global_dp.py``, packed and read
in place by offset and direction), K25's arithmetic and its split of a
lane's rows into chunks emulated on the host, Hirschberg's level loop
(``models/hirschberg.py``) and its vectorized leaves, the numpy NW oracle,
and the demo CLI. Every value is an integer or a string, so every
comparison is exact."""

import itertools

import numpy as np
import pytest
import torch

from conftest import random_dna, random_protein
from parallel_genomeseq_tpu.cli import demo as jax_demo
from parallel_genomeseq_tpu.models import hirschberg as jax_hb
from parallel_genomeseq_tpu.ops import global_dp as jax_gdp
from parallel_genomeseq_tpu.ops import oracle as jax_oracle
from parallel_genomeseq_tpu.ops.substitution import blosum_config as jax_blosum
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxScoringConfig
from parallel_genomeseq_tpu_torch.cli import demo
from parallel_genomeseq_tpu_torch.models import hirschberg
from parallel_genomeseq_tpu_torch.ops import global_dp, oracle
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# (port config, JAX config, alphabet): the default uniform 3/-3/2, and
# BLOSUM62 with gap 4.
CONFIGS = {
    "uniform": (ScoringConfig(), JaxScoringConfig(), "ACGT"),
    "blosum62": (blosum_config("blosum62", gap_penalty=4.0),
                 jax_blosum("blosum62", gap_penalty=4.0), None),
}


FIELDS = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")


def mutate(rng, seq: str, alphabet: str, subs: float = 0.08, indels: int = 3) -> str:
    """``seq`` with about ``subs`` of its letters substituted and ``indels``
    1-4 letter insertions or deletions."""
    chars = list(seq)
    for p in np.flatnonzero(rng.random(len(chars)) < subs):
        chars[p] = alphabet[int(rng.integers(len(alphabet)))]
    for _ in range(indels):
        p = int(rng.integers(0, max(1, len(chars))))
        k = int(rng.integers(1, 5))
        if rng.integers(2):
            chars[p:p] = [alphabet[int(c)] for c in rng.integers(len(alphabet), size=k)]
        else:
            del chars[p : p + k]
    return "".join(chars)


def ragged_batch(kind: str, seed: int):
    """A ragged batch of (x, y) pairs: lengths 1-90, related and unrelated
    pairs, an empty x and an empty y."""
    rng = np.random.default_rng(seed)
    gen = random_dna if kind == "uniform" else random_protein
    alpha = "ACGT" if kind == "uniform" else "ARNDCQEGHILKMFPSTWYV"
    xs, ys = [], []
    for _ in range(9):
        y = gen(rng, int(rng.integers(1, 90)))
        x = mutate(rng, y, alpha) if rng.integers(2) else gen(rng, int(rng.integers(1, 90)))
        xs.append(x or alpha[0])
        ys.append(y)
    xs += ["", gen(rng, 7), gen(rng, 1)]
    ys += [gen(rng, 5), "", gen(rng, 60)]
    return xs, ys


@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_nw_lastrow_batch_matches_jax(kind, seed):
    """The plain NW last rows and corner scores of a ragged batch equal the
    JAX device scan's, and the numpy oracle's corner."""
    cfg, jcfg, _ = CONFIGS[kind]
    xs, ys = ragged_batch(kind, seed)
    got = global_dp.nw_lastrow_batch(xs, ys, cfg, device="cpu")
    want = jax_gdp.nw_lastrow_batch(xs, ys, jcfg)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.shape == (len(ys[k]) + 1,)
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g[-1] == jax_oracle.nw_matrix(xs[k], ys[k], jcfg)[-1, -1]
    np.testing.assert_array_equal(global_dp.nw_score_batch(xs, ys, cfg, device="cpu"),
                                  jax_gdp.nw_score_batch(xs, ys, jcfg))


def test_nw_lastrow_plain_masks_past_n():
    """The plain version's contract, as K25's: row m_b for j <= n_b, 0 past
    n_b, row 0 for a lane with m_b = 0."""
    cfg = ScoringConfig()
    table = global_dp.byte_table(cfg, "cpu")
    x = torch.tensor([[65, 67, 71], [65, 0, 0], [0, 0, 0]], dtype=torch.uint8)
    y = torch.tensor([[65, 67, 71, 84], [65, 65, 0, 0], [67, 0, 0, 0]], dtype=torch.uint8)
    m = torch.tensor([3, 1, 0], dtype=torch.int32)
    n = torch.tensor([4, 2, 1], dtype=torch.int32)
    out = global_dp.nw_lastrow(x, y, m, n, table=table, gap=2)
    assert out.tolist() == [
        [-6, -1, 4, 9, 7],  # ACG vs ACGT: three matches then a gap
        [-2, 3, 1, 0, 0],
        [0, -2, 0, 0, 0],
    ]


@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("device_cells", [0, hirschberg.DEVICE_CELLS],
                         ids=["device_cells0", "default"])
def test_hirschberg_matches_jax(kind, device_cells):
    """Score and both consensus strings equal JAX's ``hirschberg_align`` on
    pairs of a few hundred letters, with every subproblem through the row
    sweep (device_cells=0: the plain K25 here, the JAX device scan there) and
    at the port's default split (every subproblem on the card there too)."""
    cfg, jcfg, alpha = CONFIGS[kind]
    alpha = alpha or "ARNDCQEGHILKMFPSTWYV"
    gen = random_dna if kind == "uniform" else random_protein
    rng = np.random.default_rng(5)
    y = gen(rng, 260)
    pairs = [(mutate(rng, y, alpha), y), (gen(rng, 180), gen(rng, 230)), (y[:3], y)]
    for x, yy in pairs:
        got = hirschberg.hirschberg_align(x, yy, cfg, device_cells=device_cells, device="cpu")
        want = jax_hb.hirschberg_align(x, yy, jcfg, device_cells=device_cells)
        assert [getattr(got, f) for f in FIELDS] == [getattr(want, f) for f in FIELDS]
        assert hirschberg.alignment_score(got.consensus_x[::-1], got.consensus_y[::-1],
                                          cfg) == got.score


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_nw_align_matches_jax_oracle(kind):
    cfg, jcfg, alpha = CONFIGS[kind]
    gen = random_dna if kind == "uniform" else random_protein
    rng = np.random.default_rng(11)
    for _ in range(3):
        x, y = gen(rng, int(rng.integers(1, 40))), gen(rng, int(rng.integers(1, 45)))
        np.testing.assert_array_equal(oracle.nw_matrix(x, y, cfg), jax_oracle.nw_matrix(x, y, jcfg))
        got, want = oracle.nw_align(x, y, cfg), jax_oracle.nw_align(x, y, jcfg)
        assert [getattr(got, f) for f in FIELDS] == [getattr(want, f) for f in FIELDS]


def test_affine_config_raises():
    """Global alignment is linear-gap only: an affine config raises rather
    than giving another answer than JAX's (which ignores gap_open)."""
    cfg = ScoringConfig(match=1, mismatch=-4, gap_open=6, gap_penalty=1)
    with pytest.raises(ValueError, match="linear-gap only"):
        hirschberg.hirschberg_align("ACGT", "ACGA", cfg, device="cpu")
    with pytest.raises(ValueError, match="linear-gap only"):
        global_dp.nw_lastrow_batch(["ACGT"], ["ACGA"], cfg, device="cpu")
    with pytest.raises(ValueError, match="linear-gap only"):
        global_dp.nw_score_batch(["ACGT"], ["ACGA"], cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        hirschberg.hirschberg_align("ACGT", "ACGA", ScoringConfig(match=2.5), device="cpu")


def test_demo_prints_jax_lines(capsys):
    assert jax_demo.main(["--platform", "cpu"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert demo.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) == 6


# Inputs that stress the level loop: x much longer than y (many empty y
# segments), y much longer than x, len(x) of 2 and 3, repeats whose rows tie
# at many columns, and BLOSUM62 with gap 4.
def level_pairs(kind: str):
    rng = np.random.default_rng(21)
    if kind == "blosum62":
        y = random_protein(rng, 170)
        return [(mutate(rng, y, "ARNDCQEGHILKMFPSTWYV"), y), (random_protein(rng, 3), y[:40]),
                (y[:25], random_protein(rng, 140))]
    y = random_dna(rng, 160)
    return [
        (random_dna(rng, 300), random_dna(rng, 18)),
        (random_dna(rng, 17), random_dna(rng, 280)),
        (random_dna(rng, 2), y[:40]),
        (random_dna(rng, 3), y[:55]),
        ("AC" * 55, "AC" * 70),
        ("A" * 33, "A" * 41),
        ("ACGTACGA" * 12, "ACGA" * 30),
        (mutate(rng, y, "ACGT"), y),
    ]


@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("device_cells", [0, hirschberg.DEVICE_CELLS, 600, 1 << 21],
                         ids=["device_cells0", "default", "mixed", "jax_default"])
def test_hirschberg_levels_match_jax(kind, device_cells):
    """The breadth-first level loop gives JAX's ``hirschberg_align`` field
    by field on inputs that stress it, at device_cells 0, the port's
    default, a middle value that splits a level between JAX's device scan
    and its host sweep (the card and the CPU route in the port's ``gpu``
    test), and JAX's default (all on JAX's host at these sizes)."""
    cfg, jcfg, _ = CONFIGS[kind]
    for x, y in level_pairs(kind):
        got = hirschberg.hirschberg_align(x, y, cfg, device_cells=device_cells, device="cpu")
        want = jax_hb.hirschberg_align(x, y, jcfg, device_cells=device_cells)
        assert [getattr(got, f) for f in FIELDS] == [getattr(want, f) for f in FIELDS], (x, y)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_level0_score_matches_nw_score_batch(kind):
    """The score, the top level's maximum of fwd + bwd, equals the corner
    H(m, n) of ``nw_score_batch`` in the port and in JAX."""
    cfg, jcfg, _ = CONFIGS[kind]
    pairs = level_pairs(kind)
    xs, ys = [x for x, _ in pairs], [y for _, y in pairs]
    want = jax_gdp.nw_score_batch(xs, ys, jcfg)
    np.testing.assert_array_equal(global_dp.nw_score_batch(xs, ys, cfg, device="cpu"), want)
    got = [hirschberg.hirschberg_align(x, y, cfg, device_cells=0, device="cpu").score
           for x, y in pairs]
    assert got == [float(v) for v in want]


def test_lanes_read_in_place_match_jax():
    """The lane form's plain version -- lanes read from two shared buffers
    at offsets, forward or reversed, rows written at offsets of one flat
    output -- equals JAX ``nw_lastrow_batch`` on the explicitly sliced and
    reversed inputs, with empty lanes among them."""
    cfg, jcfg, _ = CONFIGS["uniform"]
    rng = np.random.default_rng(8)
    X = np.frombuffer(random_dna(rng, 900).encode(), np.uint8).copy()
    Y = np.frombuffer(random_dna(rng, 700).encode(), np.uint8).copy()
    B = 14
    m = rng.integers(0, 120, B)
    n = rng.integers(0, 150, B)
    m[:3], n[3:5] = [0, 1, 2], [0, 1]
    x_off = rng.integers(0, len(X) - m)
    y_off = rng.integers(0, len(Y) - n)
    x_rev, y_rev = rng.random(B) < 0.5, rng.random(B) < 0.5
    out_off = np.cumsum(n + 1 + 3) - (n + 1)  # rows apart, gaps between them
    lanes = global_dp.plan_lanes(m, n, x_off=x_off, y_off=y_off, x_rev=x_rev, y_rev=y_rev,
                                 out_off=out_off)
    got = global_dp.nw_lastrow_lanes(torch.from_numpy(X), torch.from_numpy(Y), lanes,
                                     table=global_dp.byte_table(cfg, "cpu"), gap=2).numpy()
    xs = [X[o : o + k][::-1] if r else X[o : o + k] for o, k, r in zip(x_off, m, x_rev)]
    ys = [Y[o : o + k][::-1] if r else Y[o : o + k] for o, k, r in zip(y_off, n, y_rev)]
    want = jax_gdp.nw_lastrow_batch([v.copy() for v in xs], [v.copy() for v in ys], jcfg)
    for b in range(B):
        np.testing.assert_array_equal(got[out_off[b] : out_off[b] + n[b] + 1],
                                      np.asarray(want[b]))
    outside = np.ones(lanes.total_out, bool)
    for o, k in zip(out_off, n):
        outside[o : o + k + 1] = False
    assert not got[outside].any()


LEAF_CONFIGS = {
    "uniform": (ScoringConfig(), "ACGT"),
    "blosum62": (blosum_config("blosum62", gap_penalty=4.0), "ASW#"),
    "gap3": (ScoringConfig(gap_penalty=3.0), "ACGT"),
}


@pytest.mark.parametrize("kind", list(LEAF_CONFIGS))
def test_leaves_match_oracle_exhaustively(kind):
    """The vectorized one-byte leaves equal ``oracle.nw_align`` on every 1 x
    n input with n <= 5 over a 4-letter alphabet (BLOSUM62: three letters
    and a byte outside its alphabet): the column where the walk leaves row
    1, by the diagonal or north, and H(1, n)."""
    cfg, alpha = LEAF_CONFIGS[kind]
    tab = cfg.byte_table().astype(np.int64)
    g = int(cfg.gap_penalty)
    cases = [(a, "".join(y)) for k in range(1, 6) for a in alpha
             for y in itertools.product(alpha, repeat=k)]
    a = np.frombuffer("".join(c[0] for c in cases).encode(), np.uint8)
    y = np.frombuffer("".join(c[1] for c in cases).encode(), np.uint8)
    y_len = np.array([len(c[1]) for c in cases])
    jstar, diag, h1 = hirschberg.leaf_columns(a, y, np.cumsum(y_len) - y_len, y_len, tab, g)
    for k, (x, y) in enumerate(cases):
        want = oracle.nw_align(x, y, cfg)
        cx, cy = want.consensus_x[::-1], want.consensus_y[::-1]
        js = int(jstar[k])
        if diag[k]:
            assert (cx, cy) == ("-" * (js - 1) + x + "-" * (len(y) - js), y), (x, y)
        else:
            assert (cx, cy) == ("-" * js + x + "-" * (len(y) - js), y[:js] + "-" + y[js:]), (x, y)
        assert h1[k] == want.score


def segment_sweep(x, y, m, n, table, gap, seg_rows):
    """The plain sweep run segment by segment: rows [r0, r0 + seg_rows) of
    every lane handed the previous segment's last row, each lane's row m_b
    kept from the segment that holds it (row 0 where m_b = 0)."""
    out = global_dp.nw_lastrow_plain(x[:, :0], y, torch.zeros_like(m), n, table=table, gap=gap)
    top = None
    for r0 in range(0, int(m.max()), seg_rows):
        seg = x[:, r0 : r0 + seg_rows]
        k = seg.shape[1]
        ends = global_dp.nw_lastrow_plain(seg, y, (m - r0).clamp(0, k), n, table=table, gap=gap,
                                          top=top, row0=r0)
        out = torch.where(((m > r0) & (m <= r0 + k))[:, None], ends, out)
        top = global_dp.nw_lastrow_plain(seg, y, torch.full_like(m, k), n, table=table, gap=gap,
                                         top=top, row0=r0)
    return out


@pytest.mark.parametrize("rows", global_dp.ROWS)
def test_segment_split_matches_unsplit(rows):
    """The split of a lane's rows into K25's chunks of 32 x R rows, each
    handed the row above it: the plain sweep run chunk by chunk equals the
    unsplit sweep on ragged lanes whose m_b lies on, one short of and one
    past a chunk edge, and inside a chunk."""
    cfg = ScoringConfig()
    table = global_dp.byte_table(cfg, "cpu")
    rng = np.random.default_rng(rows)
    c = 32 * rows
    m = np.array([c, c - 1, c + 1, 2 * c, 2 * c + 1, 1, 0, c // 2 + 3, 3 * c - 1])
    n = np.array([70, 1, 30, 29, 0, 2, 40, 65, 64])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    x = torch.from_numpy(rng.choice(acgt, (len(m), int(m.max()))))
    y = torch.from_numpy(rng.choice(acgt, (len(m), int(n.max()))))
    mt, nt = torch.from_numpy(m.astype(np.int32)), torch.from_numpy(n.astype(np.int32))
    want = global_dp.nw_lastrow_plain(x, y, mt, nt, table=table, gap=2)
    lanes = global_dp.plan_lanes(m, n, rows=rows)
    np.testing.assert_array_equal(lanes.chunks, np.maximum(1, -(-m // c)))
    assert torch.equal(segment_sweep(x, y, mt, nt, table, 2, c), want)


def shared_row_sweep(xb, yb, tab, gap, chunk_rows, look, rng):
    """K25's hand-off protocol between the chunks of one lane, emulated with
    every chunk in flight at once over the lane's one boundary row: slot j
    holds (tag, H) and chunk c reads it, up to ``look`` columns ahead of the
    column it computes, once its tag is c, then overwrites it with tag c + 1
    when it computes column j. Each move is a read or a compute of a chunk
    picked at random among those that can move. Asserts that a chunk never
    reads a tag past its own; returns H(m, .)."""
    m, n = len(xb), len(yb)
    chunks = max(1, -(-m // chunk_rows))
    tag = np.zeros(n + 1, np.int64)
    val = np.zeros(n + 1, np.int64)
    r0 = [c * chunk_rows for c in range(chunks)]
    rows = [min(chunk_rows, m - r) for r in r0]
    col = [-gap * np.arange(r + 1, r + k + 1) for r, k in zip(r0, rows)]  # H(., 0)
    north_prev = [-gap * r for r in r0]  # H(r0, 0): the row above, column 0
    read = [dict() for _ in range(chunks)]
    rp, wp = [1] * chunks, [1] * chunks
    last = np.zeros(n + 1, np.int64)
    last[0] = -gap * m
    while any(w <= n for w in wp):
        moves = []
        for c in range(chunks):
            if rp[c] <= n and rp[c] < wp[c] + look:
                if c == 0:
                    moves.append((c, "read"))
                else:
                    assert tag[rp[c]] <= c, "a chunk saw a later chunk's tag"
                    if tag[rp[c]] == c:
                        moves.append((c, "read"))
            if wp[c] < rp[c]:
                moves.append((c, "compute"))
        c, what = moves[rng.integers(len(moves))]
        if what == "read":
            j = rp[c]
            read[c][j] = -gap * j if c == 0 else int(val[j])
            rp[c] += 1
            continue
        j = wp[c]
        north = read[c].pop(j)
        s = tab[xb[r0[c] : r0[c] + rows[c]], yb[j - 1]]
        new = np.empty(rows[c], np.int64)
        above, diag = north, north_prev[c]
        for i in range(rows[c]):
            new[i] = max(diag + s[i], above - gap, col[c][i] - gap)
            diag, above = col[c][i], new[i]
        col[c], north_prev[c] = new, north
        if c + 1 < chunks:
            tag[j], val[j] = c + 1, new[-1]
        else:
            last[j] = new[-1]
        wp[c] += 1
    return last


@pytest.mark.parametrize("seed", range(6))
def test_shared_boundary_row_protocol(seed):
    """Every chunk of a lane shares one boundary row, each slot stepping
    through the chunks' tags in order: under random interleavings of the
    chunks' reads (a word ahead) and writes, no chunk reads a tag past its
    own, and the last row equals the plain sweep's."""
    cfg = ScoringConfig()
    tab = cfg.byte_table().astype(np.int64)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    m, n = int(rng.integers(1, 40)), int(rng.integers(1, 30))
    xb, yb = rng.choice(acgt, m), rng.choice(acgt, n)
    got = shared_row_sweep(xb, yb, tab, 2, int(rng.integers(1, 5)), int(rng.integers(1, 8)), rng)
    want = global_dp.nw_lastrow_plain(torch.from_numpy(xb)[None], torch.from_numpy(yb)[None],
                                      torch.tensor([m], dtype=torch.int32),
                                      torch.tensor([n], dtype=torch.int32),
                                      table=global_dp.byte_table(cfg, "cpu"), gap=2)[0]
    np.testing.assert_array_equal(got, want.numpy())


NEG_PAD = -(1 << 30)


def emulate_k25(X, Y, lanes, tab, gap, max_codes=64, pad=NEG_PAD):
    """K25's arithmetic on the host, lane by lane: G = H + gap (i + j) with
    s' = s + 2 gap and zero boundaries, chunks of 32 R rows handed on by
    their last row, each chunk's last band padded to R rows that score
    ``pad`` (-2^30 in the tables, 0 in the packed registers: any score <= 0
    copies the row above), its scores from the compact codes of the bytes
    the chunk reads (or the byte table past ``max_codes``), and the output
    row G less gap (m_b + j)."""
    out = np.zeros(lanes.total_out, np.int64)
    R = lanes.rows
    for b in range(lanes.B):
        m, n = int(lanes.m[b]), int(lanes.n[b])
        xb = X[lanes.x_off[b] : lanes.x_off[b] + m][:: -1 if lanes.flags[b] & 1 else 1]
        yb = Y[lanes.y_off[b] : lanes.y_off[b] + n][:: -1 if lanes.flags[b] & 2 else 1]
        o = lanes.out_off[b]
        out[o : o + n + 1] = -gap * (m + np.arange(n + 1))
        if m == 0:
            continue
        prev = np.zeros(n + 1, np.int64)  # G(0, .)
        for c in range(int(lanes.chunks[b])):
            r0 = c * 32 * R
            rows = min(m - r0, 32 * R)
            codes = np.unique(np.concatenate([xb[r0 : r0 + rows], yb]))
            compact = len(codes) <= max_codes
            for r in range(r0, r0 + -(-rows // R) * R):
                if r >= m:
                    sp = np.full(n, pad, np.int64)
                elif compact:
                    xc, yc = np.searchsorted(codes, xb[r]), np.searchsorted(codes, yb)
                    sp = tab[codes[xc], codes[yc]] + 2 * gap
                else:
                    sp = tab[xb[r], yb] + 2 * gap
                u = np.zeros(n + 1, np.int64)
                u[1:] = np.maximum(prev[:-1] + sp, prev[1:])
                prev = np.maximum.accumulate(u)
        out[o + 1 : o + n + 1] = prev[1:] - gap * (m + np.arange(1, n + 1))
    return out


@pytest.mark.parametrize("rows", [4, 8])
@pytest.mark.parametrize("max_codes, pad", [(64, 0), (64, NEG_PAD), (2, NEG_PAD)],
                         ids=["packed", "shared_table", "byte_table"])
def test_k25_arithmetic_emulation_matches_plain(rows, max_codes, pad):
    """K25's arithmetic emulated on the host equals the plain version on
    lanes read at offsets, forward and reversed, with m_b on and off chunk
    edges, m_b = 0 and n_b = 0: the G form, the pad rows (0 in the packed
    registers, -2^30 in the tables), the hand-off of a chunk's last row,
    the compact codes and the byte-table route."""
    cfg = ScoringConfig()
    tab = cfg.byte_table().astype(np.int64)
    rng = np.random.default_rng(rows + max_codes)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    X = rng.choice(acgt, 3000)
    Y = X.copy()
    Y[rng.random(3000) < 0.1] = 65
    B = 9
    m = rng.integers(0, 400, B)
    n = rng.integers(0, 300, B)
    m[:4], n[4] = [32 * rows, 32 * rows + 1, 64 * rows - 1, 0], 0
    lanes = global_dp.plan_lanes(m, n, x_off=rng.integers(0, 3000 - m),
                                 y_off=rng.integers(0, 3000 - n), x_rev=rng.random(B) < 0.5,
                                 y_rev=rng.random(B) < 0.5, rows=rows)
    want = global_dp.nw_lastrow_lanes(torch.from_numpy(X), torch.from_numpy(Y), lanes,
                                      table=global_dp.byte_table(cfg, "cpu"), gap=2).numpy()
    np.testing.assert_array_equal(emulate_k25(X, Y, lanes, tab, 2, max_codes, pad), want)


def test_launch_shape_rule():
    """K25's rule: a few long lanes (Hirschberg's top launch) take few rows
    a thread and a block a chunk, spread over many SMs; 100 long lanes take
    32 rows a thread and 4 warps a block; small lanes take 4 rows."""
    R, W = global_dp.launch_shape([5000, 5000], [10000, 10000])
    chunks = 2 * global_dp.chunk_counts([5000], R)[0]
    assert W == 1 and chunks > 2
    assert global_dp.launch_shape([10000] * 100, [10000] * 100) == (32, 4)
    assert global_dp.launch_shape(np.full(4096, 3), np.full(4096, 8))[0] == 4
    # However long the lanes, the boundary rows are one row of n_b + 1
    # slots a lane of two chunks or more, shared by its chunks.
    for L in (100_000, 3_000_000):
        lanes = global_dp.plan_lanes([L, L, 10], [L, 2 * L, L])
        assert lanes.total_chunks > 3 and lanes.bound_ints == 3 * L + 2
    lanes = global_dp.plan_lanes([0, 300, 2000], [5, 0, 900], rows=4)
    np.testing.assert_array_equal(lanes.chunks, [1, 3, 16])
    np.testing.assert_array_equal(lanes.chunk0, [0, 1, 4])
    np.testing.assert_array_equal(lanes.bound_off, [0, 0, 1])
    assert lanes.bound_ints == 1 + 901
    d = lanes.descriptor()
    assert d.shape == (3 * global_dp.FIELDS + 20,)
    np.testing.assert_array_equal(d[3 * global_dp.FIELDS :], [0] + [1] * 3 + [2] * 16)
