"""The pair form of K26 and K27 and the skewed tie's key at the wrap row
(csrc/parity.cuh), as numpy models of the kernels' arithmetic, against the
JAX package's ``ScanEngine`` under Semantics.SAT_UINT8 on the CPU.

The pair model packs two lanes' signed 16-bit cells into uint32 words and
writes out each DPX s16x2 instruction of ``PairStep`` per half, asserting
that no half leaves the signed 16-bit range, with the score pair built by
the kernels' one 32-bit multiply-add; the move codes are the int32 form's
(the moves launch runs it), taken on the model's values. The search model
is the kernels' argmax: each thread's rows (a band of R) keep, per column,
the first maximum (column-major: K27's pair form, every int32 form) or the
cell of least raw key found at the wrap row (skewed, the int32 forms; every
such row's key past ``wavefront_cuda.key_rule``'s bound), and the bands
reduce in the kernels' order. Both are held against ``ScanEngine(cfg,
tie)``'s score, i, j and moves, and through an aligner on every AlignResult
field against the JAX aligner's. Inputs are made with numpy from seeds."""

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.models.swaligner import BatchSWAligner as JaxBatch
from parallel_genomeseq_tpu.ops import scan_dp as jax_scan
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxConfig
from parallel_genomeseq_tpu.utils.config import Semantics as JaxSemantics
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops import engine, scan_dp, strips_cuda, wavefront_cuda
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig, Semantics

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

FIELDS = ("score", "pos", "consensus_x", "consensus_y", "max_i", "max_j")
INT32_MAX = 2**31 - 1
# Saturating configs (match, mismatch, gap) before ScanEngine's clip: the
# reference's defaults, the operands' edges (match 255, mismatch -255, gap
# 0; gap 255), values clipped into them, a plateau-heavy one and a
# mismatch of 0.
SAT_CONFIGS = {
    "defaults": (3, -3, 2),
    "edges": (255, -255, 0),
    "gap255": (5, -1, 255),
    "clipped": (300, -400, 260),
    "plateau": (100, -50, 7),
    "mismatch0": (200, 2, 1),
}


# -- the pair arithmetic: int16 halves packed in uint32 words ---------------

def pack(lo, hi):
    """uint32 words of two signed 16-bit halves, lo in bits 0-15."""
    lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
    assert (np.abs(lo + 0.5) < 32768).all() and (np.abs(hi + 0.5) < 32768).all(), "s16 range"
    return ((lo & 0xFFFF) | ((hi & 0xFFFF) << 16)).astype(np.uint32)


def halves(w):
    """(lo, hi) signed 16-bit halves of uint32 words."""
    w = np.asarray(w, np.int64)
    lo, hi = w & 0xFFFF, (w >> 16) & 0xFFFF
    return np.where(lo >= 32768, lo - 65536, lo), np.where(hi >= 32768, hi - 65536, hi)


def per_half(fn, *words):
    """One s16x2 instruction: ``fn`` on each half, which stays in s16."""
    parts = [halves(w) for w in words]
    return pack(fn(*(p[0] for p in parts)), fn(*(p[1] for p in parts)))


def add16(a, b):
    s = a + b
    assert (np.abs(s + 0.5) < 32768).all(), "a half's sum left s16"
    return s


def viaddmax(a, b, c):
    return per_half(lambda a, b, c: np.maximum(add16(a, b), c), a, b, c)


def viaddmin(a, b, c):
    return per_half(lambda a, b, c: np.minimum(add16(a, b), c), a, b, c)


def vimin_relu(a, b):
    return per_half(lambda a, b: np.maximum(np.minimum(a, b), 0), a, b)


class PairStep:
    """csrc/parity.cuh's PairStep, instruction by instruction."""

    def __init__(self, match, mismatch, gap):
        self.sbias = (match + 256) * 0x10001
        self.diff = match - mismatch
        self.wbias = (256 - gap) * 0x10001
        self.ngap = ((-gap) & 0xFFFF) * 0x10001

    def off_chain(self, x, y, diag, west):
        flag = vimin_relu(np.bitwise_xor(x, y), np.uint32(0x00010001))
        sb = ((self.sbias - flag.astype(np.int64) * self.diff) % 2**32).astype(np.uint32)
        t = viaddmax(west, np.uint32(self.wbias), np.uint32(0x01000100))
        return viaddmin(viaddmax(diag, sb, t), np.uint32(0xFF00FF00), np.uint32(0x00FF00FF))

    def chain(self, north, a):
        return viaddmax(north, np.uint32(self.ngap), a)


def int32_moves(diag, west, north):
    """The int32 form's move code of cells (csrc/wavefront.cu column_linear):
    NW if diag >= max(west, north), else W if west >= north, else N, plus 4
    when any of the three is 0."""
    code = np.where(diag >= np.maximum(west, north), 0, np.where(west >= north, 1, 2))
    return code | np.where(np.minimum(np.minimum(diag, west), north) == 0, 4, 0)


def pair_dp(xs, ys, m, n, match, mismatch, gap):
    """The pair form's DP on lanes (xs (B, M), ys (B, N) uint8, m, n):
    lanes 2p and 2p + 1 in one word (an odd B's last word has an empty
    half), every row of every column computed as the kernels compute it
    (rows past a lane's m_b read byte 0, columns past its n_b its reference
    bytes), one anti-diagonal at a time. Returns H (B, M + 1, N + 1) int64,
    the lanes' clamped (m, n) and the (M + N - 1, M, B) move codes."""
    B, M = xs.shape
    N = ys.shape[1]
    mb, nb = np.clip(m, 0, M), np.clip(n, 0, N)
    empty = (mb == 0) | (nb == 0)
    mb, nb = np.where(empty, 0, mb), np.where(empty, 0, nb)
    P = -(-B // 2)
    lanes = np.arange(2 * P)
    real = lanes < B
    rows = np.arange(M)[:, None]
    xl = np.zeros((M, 2 * P), np.uint32)
    yl = np.zeros((N, 2 * P), np.uint32)
    mpad = np.zeros(2 * P, np.int64)
    mpad[:B] = mb
    xl[:, real] = np.where(rows < mpad[None, :B], xs.T, 0)
    yl[:, real] = ys.T
    X = xl[:, 0::2] | xl[:, 1::2] << np.uint32(16)
    Y = yl[:, 0::2] | yl[:, 1::2] << np.uint32(16)
    step = PairStep(match, mismatch, gap)
    H = np.zeros((M + 1, N + 1, P), np.uint32)
    moves = np.zeros((M + N - 1, M, 2 * P), np.uint8)
    for d in range(2, M + N + 1):  # i + j = d
        i = np.arange(max(1, d - N), min(M, d - 1) + 1)
        j = d - i
        diag, west, north = H[i - 1, j - 1], H[i, j - 1], H[i - 1, j]
        a = step.off_chain(X[i - 1], Y[j - 1], diag, west)
        H[i, j] = step.chain(north, a)
        for h, (dh, wh, nh) in enumerate(zip(halves(diag), halves(west), halves(north))):
            moves[d - 2, i - 1, h::2] = int32_moves(dh, wh, nh)
    lo, hi = halves(H)
    Hl = np.stack([lo, hi], -1).reshape(M + 1, N + 1, 2 * P).transpose(2, 0, 1)
    assert ((Hl >= 0) & (Hl <= 255)).all()
    return Hl[:B], mb, nb, moves[:, :, :B]


# -- the search: each band's candidate, found at the wrap row ---------------

def raw_keys(i, j, mb, nb, M):
    """The raw key rj * (M + 33) + ri of cells (i, j), wrapped to int32 as
    the JAX scan's int32 arithmetic wraps it (scan_dp.py:144-166)."""
    i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
    s = i + j
    lo, hi = min(mb, nb), max(mb, nb)
    ri = np.where(nb > mb, np.where(s < lo, j, np.where(s > hi, j - (nb - mb), mb - i)), j)
    rj = np.where(s <= hi, s, s - hi - 1)
    return ((rj * (M + 33) + ri + 2**31) % 2**32 - 2**31).astype(np.int64)


def band_best(H, mb, nb, M, R, tie, rule="wrap_row"):
    """The kernels' argmax on one lane's H (M + 1, N + 1): bands of R rows
    (a thread's), each keeping per column the first maximum (column-major,
    a strict >) or, under the skewed tie, the column's candidate -- the
    least row of its maximum past the wrap row i = max(mb, nb) - j, else
    the least such row, its key computed alone, a tie only where the
    column's least key can lie below the band's best key ('wrap_row'), or the
    least of every such cell's key ('every_cell') -- when it reaches the
    band's best; then the bands reduce by (score, j, i), or (score, key, i,
    j). Returns (score, i, j)."""
    if mb == 0 or nb == 0:
        return 0, 0, 0
    nbands = -(-mb // R)
    G = np.zeros((nbands * R, nb), np.int64)
    G[:mb] = H[1 : mb + 1, 1 : nb + 1]  # rows past m_b count nothing
    G = G.reshape(nbands, R, nb)
    row0 = np.arange(nbands) * R
    ks = np.arange(R)
    best = np.zeros(nbands, np.int64)
    bi, bj = np.zeros(nbands, np.int64), np.zeros(nbands, np.int64)
    bkey = np.full(nbands, INT32_MAX, np.int64)
    for j in range(1, nb + 1):
        col = G[:, :, j - 1]
        cm = col.max(1)
        eq = col == cm[:, None]
        if tie == "colmajor":
            kk = eq.argmax(1)
            upd = cm > best
            key = bkey
        elif rule == "wrap_row":
            kw = max(mb, nb) - j - row0
            past = eq & (ks[None, :] >= kw[:, None])
            kk = np.where(past.any(1), past.argmax(1), eq.argmax(1))
            key = raw_keys(row0 + kk + 1, j, mb, nb, M)
            # a tie is searched only where the column's least key can lie
            # below the best's (parity.cuh's tie_may_win): with no row past
            # the wrap, by the bound (row0 + 1 + j) (M + 33); else the key
            # of its first row past the wrap
            least = np.where(kw >= R, (row0 + 1 + j) * (M + 33),
                             raw_keys(row0 + np.maximum(kw, 0) + 1, j, mb, nb, M))
            key = np.where((cm > best) | (least < bkey), key, INT32_MAX)
        else:
            keys = np.where(eq, raw_keys(row0[:, None] + ks + 1, j, mb, nb, M), INT32_MAX)
            kk = keys.argmin(1)
            key = keys.min(1)
        if tie != "colmajor":
            i = row0 + kk + 1
            upd = (cm > 0) & ((cm > best) | ((cm == best) & (
                (key < bkey) | ((key == bkey) & ((i < bi) | ((i == bi) & (j < bj)))))))
        best, bkey = np.where(upd, cm, best), np.where(upd, key, bkey)
        bi, bj = np.where(upd, row0 + kk + 1, bi), np.where(upd, j, bj)
    order = (np.lexsort((bj, bi, bkey, -best)) if tie != "colmajor"
             else np.lexsort((bi, bj, -best)))[0]
    if best[order] <= 0:
        return 0, 0, 0
    return int(best[order]), int(bi[order]), int(bj[order])


def brute_best(H, mb, nb, M):
    """The skewed tie's cell by definition: among the cells of the maximum
    score (> 0), the least wrapped raw key, then the least i, then j."""
    if mb == 0 or nb == 0 or H[1 : mb + 1, 1 : nb + 1].max() <= 0:
        return 0, 0, 0
    V = H[1 : mb + 1, 1 : nb + 1]
    i, j = np.nonzero(V == V.max())
    i, j = i + 1, j + 1
    k = np.lexsort((j, i, raw_keys(i, j, mb, nb, M)))[0]
    return int(V.max()), int(i[k]), int(j[k])


def model_parity(xs, ys, m, n, *, gap, sat, tie="colmajor", match=0, mismatch=0, table=None,
                 track_pos=True, emit_moves=False, rows=4):
    """The port's parity path on the pair model, in sw_score_parity's
    signature: the pair DP's values and the int32 form's move codes, then
    each lane's band search with ``rows`` rows a band and the key rule of
    the launch's padded shape."""
    assert sat and table is None
    assert wavefront_cuda.pair_fits(sat=sat, match=match, mismatch=mismatch, gap=gap)
    xs, ys, m, n = (t.numpy() for t in (xs, ys, m, n))
    B, M = xs.shape
    H, mb, nb, moves = pair_dp(xs, ys, m, n, match, mismatch, gap)
    rule = wavefront_cuda.key_rule(M, ys.shape[1])
    out = np.array([band_best(H[b], mb[b], nb[b], M, rows, tie, rule) for b in range(B)],
                   np.int32).reshape(B, 3)
    if not (track_pos or emit_moves):
        out[:, 1:] = 0
    res = tuple(torch.from_numpy(np.ascontiguousarray(out[:, k])) for k in range(3))
    return (*res, torch.from_numpy(moves)) if emit_moves else res


class PairModelEngine(engine.PlainEngine):
    """The plain engine with the pair model in place of K26 and K27."""

    _parity = staticmethod(model_parity)
    _parity_st = staticmethod(model_parity)


# -- inputs -------------------------------------------------------------------

def lanes(seed, B=13, M=40, N=64, copies=False):
    """(xs (B, M), ys (B, N) uint8 padded with the port's pads, m, n):
    lanes of m = n, m > n, n > m, a 1 x 1 lane, an empty one and ragged
    pairs, reads planted in their references; ``copies`` plants every read
    whole (saturated plateaus)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    m = rng.integers(1, M + 1, B).astype(np.int32)
    n = rng.integers(1, N + 1, B).astype(np.int32)
    m[:5], n[:5] = (M, 30, M, 1, 0), (N, 30, 20, 1, 9)  # n > m, m = n, m > n, 1 x 1, empty
    xs = np.full((B, M), 1, np.uint8)
    ys = np.full((B, N), 2, np.uint8)
    for b in range(B):
        ys[b, : n[b]] = rng.choice(acgt, n[b])
        xs[b, : m[b]] = rng.choice(acgt, m[b])
        k = min(m[b], n[b]) if copies else min(m[b], n[b]) // 2
        if k:
            s = int(rng.integers(0, n[b] - k + 1))
            xs[b, :k] = ys[b, s : s + k]
    return xs, ys, m, n


def configs(match, mismatch, gap):
    kw = dict(match=float(match), mismatch=float(mismatch), gap_penalty=float(gap))
    return (JaxConfig(semantics=JaxSemantics.SAT_UINT8, **kw),
            ScoringConfig(semantics=Semantics.SAT_UINT8, **kw))


def operands(cfg):
    match, mismatch, gap = scan_dp.sat_operands(cfg.match, cfg.mismatch, cfg.gap_penalty)
    return dict(match=match, mismatch=mismatch, gap=gap, sat=True)


# -- tests ------------------------------------------------------------------

def test_rules():
    """The pair form is the config's (saturation, uniform scores, the
    clipped operands) for K26's score-only sweep and K27's column-major
    sweep, and the key rule the launch shape's: the wrap row below the 2^31
    bound, every cell's key at and past it."""
    fits, form = wavefront_cuda.pair_fits, wavefront_cuda.parity_form
    assert fits(sat=True, match=3, mismatch=-3, gap=2)
    assert fits(sat=True, match=255, mismatch=-255, gap=255)
    assert not fits(sat=False, match=3, mismatch=-3, gap=2)
    assert not fits(sat=True, match=300, mismatch=-3, gap=2)
    assert not fits(sat=True, match=3, mismatch=1, gap=2)
    assert not fits(sat=True, gap=2, table=torch.zeros(4, 4, dtype=torch.int32))
    for mode in wavefront_cuda.MODES:
        took = form(sat=True, match=3, mismatch=-3, gap=2, mode=mode)
        assert took == ("pair" if mode == "score_only" else "int32")
        assert form(sat=False, match=3, mismatch=-3, gap=2, mode=mode) == "int32"
        assert form(sat=True, gap=2, mode=mode, table=torch.zeros(4, 4, dtype=torch.int32)) \
            == "int32"
    for tie in ("colmajor", "skewed"):
        took = strips_cuda.sweep_form(sat=True, match=3, mismatch=-3, gap=2, tie=tie)
        assert took == ("pair" if tie == "colmajor" else "int32")
        assert strips_cuda.sweep_form(sat=False, match=3, mismatch=-3, gap=2, tie=tie) == "int32"
        assert strips_cuda.sweep_form(sat=True, match=300, mismatch=-3, gap=2, tie=tie) == "int32"
    rule = wavefront_cuda.key_rule
    assert rule(128, 4992) == rule(10_008, 20_736) == "wrap_row"
    M = 46_200  # (M + N) (M + 33) + N crosses 2^31 between N = 249 and 250
    assert (M + 249) * (M + 33) + 249 < 2**31 <= (M + 250) * (M + 33) + 250
    assert rule(M, 249) == "wrap_row" and rule(M, 250) == "every_cell"
    assert rule(46_400, 46) == "every_cell"
    assert [wavefront_cuda.tie_code(t, M, 250) for t in ("colmajor", "skewed")] == [0, 2]
    assert wavefront_cuda.tie_code("skewed", M, 249) == 1


@pytest.mark.parametrize("name", list(SAT_CONFIGS))
def test_pair_arithmetic_exhaustive(name):
    """Every (diag, west, north) in a grid of [0, 255] and both byte
    relations, in both halves at once: the pair step equals the saturating
    step min(max(diag + s, west - gap, north - gap, 0), 255) of the clipped
    operands."""
    _, cfg = configs(*SAT_CONFIGS[name])
    op = operands(cfg)
    v = np.array([0, 1, 2, 7, 100, 128, 200, 250, 253, 254, 255], np.int64)
    d, w, nn, e = (a.ravel() for a in np.meshgrid(v, v, v, [0, 1], indexing="ij"))
    x = np.where(e == 1, 67, 65)  # e = 1: a mismatch on the low half
    step = PairStep(op["match"], op["mismatch"], op["gap"])
    # the high half holds the cells in reverse order, with the other byte relation
    diag, west, north = pack(d, d[::-1]), pack(w, w[::-1]), pack(nn, nn[::-1])
    xw, yw = pack(x, 65 + 2 * e[::-1]), pack(np.full_like(x, 65), np.full_like(x, 65))
    got_lo, got_hi = halves(step.chain(north, step.off_chain(xw, yw, diag, west)))
    for got, dd, ww, nnn, ee in ((got_lo, d, w, nn, e), (got_hi, d[::-1], w[::-1], nn[::-1],
                                                           e[::-1])):
        s = np.where(ee == 1, op["mismatch"], op["match"])
        want = np.minimum(np.maximum.reduce([dd + s, ww - op["gap"], nnn - op["gap"],
                                             np.zeros_like(dd)]), 255)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", list(SAT_CONFIGS))
@pytest.mark.parametrize("tie", ["colmajor", "skewed"])
def test_pair_model_matches_scan_engine(name, tie):
    """The pair model (odd B, ragged pairs, m = n, m > n, n > m, an empty
    lane) against ScanEngine(SAT_UINT8, tie): score, i, j of score_batch,
    and the moves inside every lane's m x n, at 4 and 8 rows a band."""
    jcfg, cfg = configs(*SAT_CONFIGS[name])
    xs, ys, m, n = lanes(len(name) + (tie == "skewed"), copies=name == "plateau")
    want = jax_scan.ScanEngine(jcfg, tie=tie).score_batch(xs, ys, m, n, emit_moves=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    if name in ("edges", "plateau", "clipped"):
        assert (want["score"] == 255).sum() >= 4
    args = [torch.from_numpy(a) for a in (xs, ys, m, n)]
    for rows in (4, 8):
        got = model_parity(*args, tie=tie, emit_moves=True, rows=rows, **operands(cfg))
        for k, g in zip(("score", "i", "j"), got):
            assert np.array_equal(g.numpy(), want[k]), (rows, k)
    moves = got[3].numpy()
    for b in range(xs.shape[0]):
        i, j = np.meshgrid(np.arange(1, m[b] + 1), np.arange(1, n[b] + 1), indexing="ij")
        d, r = (i + j - 2).ravel(), (i - 1).ravel()
        assert np.array_equal(moves[d, r, b], want["moves"][d, r, b]), b


@pytest.mark.parametrize("name", ["defaults", "edges", "plateau"])
@pytest.mark.parametrize("tie", ["colmajor", "skewed"])
def test_pair_model_align_results_match_jax(name, tie):
    """The pair model in place of K26 inside the port's aligner against the
    JAX aligner under the same config and tie, on every AlignResult field:
    reads planted in their references, of lengths below, equal to and
    above the references' (13 lanes, an odd count)."""
    jcfg, cfg = configs(*SAT_CONFIGS[name])
    rng = np.random.default_rng(11)
    refs = ["".join(rng.choice(list("ACGT"), k)) for k in rng.integers(20, 70, 13)]
    reads = []
    for k, y in enumerate(refs):
        length = (len(y) - 7, len(y), len(y) + 9)[k % 3]
        s = int(rng.integers(0, len(y) // 2))
        x = (y[s:] + y[:s] + "".join(rng.choice(list("ACGT"), 10)))[:length]
        if name != "plateau":
            x = "".join(c if rng.random() > 0.1 else "T" for c in x)
        reads.append(x)
    aligner = BatchSWAligner(cfg, tie=tie, device="cpu", engine="plain")
    aligner.engine = PairModelEngine(cfg, device="cpu", tie=tie)
    got = aligner.align_batch(reads, refs)
    want = JaxBatch(jcfg, tie=tie).align_batch(reads, refs)
    for k, (g, w) in enumerate(zip(got, want)):
        assert [getattr(g, f) for f in FIELDS] == [getattr(w, f) for f in FIELDS], k


@pytest.mark.parametrize("mn", [(30, 30), (40, 25), (25, 40)], ids=["m_eq_n", "m_gt_n", "n_gt_m"])
def test_wrap_row_every_cell_saturated(mn):
    """Identical sequences under match 255, mismatch -255, gap 0: every cell
    of the lane is 255, every cell on the wrap row i + j = max(m, n) among
    them. The pair model's cell equals ScanEngine's skewed cell (and the
    brute-force least key), at every band height that splits the rows
    differently."""
    jcfg, cfg = configs(255, -255, 0)
    mm, nn = mn
    xs = np.full((2, 40), 1, np.uint8)
    ys = np.full((2, 40), 2, np.uint8)
    xs[:, :mm], ys[:, :nn] = ord("A"), ord("A")
    m, n = np.array([mm, mm], np.int32), np.array([nn, nn], np.int32)
    want = jax_scan.ScanEngine(jcfg, tie="skewed").score_batch(xs, ys, m, n)
    H, mb, nb, _ = pair_dp(xs, ys, m, n, 255, -255, 0)
    assert (H[0, 1 : mm + 1, 1 : nn + 1] == 255).all()
    assert brute_best(H[0], mm, nn, 40) == tuple(int(want[k][0]) for k in ("score", "i", "j"))
    for rows in (1, 2, 4, 8, 16, 32):
        assert band_best(H[0], mm, nn, 40, rows, "skewed") == brute_best(H[0], mm, nn, 40)


def test_wrap_row_search_on_ties():
    """The search alone, on matrices of many ties (values 0-2): the band
    search at the wrap row equals the least key by definition, on lanes of
    m < n, m = n and m > n, each cell of the maximum on the wrap row or
    around it, at every band height."""
    rng = np.random.default_rng(5)
    for mm, nn in ((9, 23), (16, 16), (23, 9), (31, 64), (64, 31), (1, 12), (12, 1)):
        M = 64
        for trial in range(6):
            H = np.zeros((M + 1, nn + 1), np.int64)
            H[1 : mm + 1, 1:] = rng.integers(0, 3, (mm, nn))
            if trial == 0:  # the maximum on the wrap row alone
                H[:] = 0
                i = np.arange(1, mm + 1)
                j = max(mm, nn) - i
                ok = (j >= 1) & (j <= nn)
                H[i[ok], j[ok]] = 1
            want = brute_best(H, mm, nn, M)
            for rows in (1, 2, 4, 8, 32):
                assert band_best(H, mm, nn, M, rows, "skewed") == want, (mm, nn, trial, rows)


def test_key_limit_takes_every_cell():
    """At the 2^31 key bound (padded M = 46,400, n = 46: ``key_rule`` says
    'every_cell') the keys wrap: the least wrapped key, which the JAX scan's
    int32 keys select, is no longer found at the wrap row. The search with
    the launch's rule equals it; the wrap-row search alone would not."""
    M, mm, nn = 46_400, 46_400, 46
    assert wavefront_cuda.key_rule(M, nn) == "every_cell"
    keys = raw_keys(np.arange(1, mm + 1)[:, None], np.arange(1, nn + 1)[None, :], mm, nn, M)
    assert (keys < 0).any()  # wrapped
    H = np.zeros((mm + 1, nn + 1), np.int64)
    H[1:, 1:] = 7  # a plateau over the whole lane
    want = brute_best(H, mm, nn, M)
    rule = wavefront_cuda.key_rule(M, nn)
    assert band_best(H, mm, nn, M, 32, "skewed", rule) == want
    assert band_best(H, mm, nn, M, 32, "skewed", "wrap_row") != want
