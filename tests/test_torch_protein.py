"""The protein slice's modules (plain PyTorch route, CPU tensors) against the
JAX package on the same inputs: the BLOSUM tables and compact codes, the K4
and K5 plain versions against the Pallas kernels B3/B4 in interpret mode
(and the scan engine beyond B4's 512-row envelope), the resident database,
the CSV writer and the data generator. Exact equality everywhere: every
value is an integer or a byte."""

import numpy as np
import pytest
import torch

from conftest import random_protein
from parallel_genomeseq_tpu.models import protein_db as jax_db
from parallel_genomeseq_tpu.ops import substitution as jax_sub
from parallel_genomeseq_tpu.ops.scan_dp import ScanEngine
from parallel_genomeseq_tpu.ops.wavefront_pallas import (
    LANE,
    PallasEngine,
    _packed_luts,
    score_db_slab_group_jit,
    score_lanes_profile_jit,
)
from parallel_genomeseq_tpu.seqio.datagen import gen_protein_db as jax_gen_protein_db
from parallel_genomeseq_tpu.utils.encoding import X_PAD, Y_PAD, batch_pad, to_bytes
from parallel_genomeseq_tpu_torch.models import protein_db as port_db
from parallel_genomeseq_tpu_torch.ops import profile_cuda, scan_dp, substitution
from parallel_genomeseq_tpu_torch.seqio.datagen import gen_protein_db

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

GAP = 12
ODD = "xJOUb*-"  # bytes outside the 24-letter alphabet, and '*', which is in it


def jax_cfg(name="blosum50"):
    return jax_sub.blosum_config(name, gap_penalty=GAP)


def port_tables(name="blosum50"):
    lut, table = scan_dp.profile_tables(substitution.blosum_config(name, gap_penalty=GAP))
    return lut, torch.from_numpy(table)


def mutate(rng, s: str, k: int) -> str:
    """k substitutions, some with bytes outside the alphabet."""
    s = list(s)
    for _ in range(k):
        s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ARNDCQEGHILKMFPSTWYV" + ODD)))
    return "".join(s)


def protein_pairs(seed: int, n_pairs: int = 9, max_len: int = 120):
    """(entry, query) pairs with a shared motif, mutations and odd bytes,
    plus an all-worst lane and a lane whose query is longer than its entry."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n_pairs):
        motif = random_protein(rng, int(rng.integers(15, 40)))
        x = random_protein(rng, int(rng.integers(0, 30))) + mutate(rng, motif, 3) \
            + random_protein(rng, int(rng.integers(0, max_len - 70)))
        y = random_protein(rng, int(rng.integers(0, 20))) + motif \
            + random_protein(rng, int(rng.integers(5, 30)))
        pairs.append((x, y))
    pairs += [("xxxxxxxx", "JJJJJJ"), (random_protein(rng, 20), random_protein(rng, 64))]
    return pairs


def raw_lanes(pairs):
    m = np.array([len(x) for x, _ in pairs], np.int32)
    n = np.array([len(y) for _, y in pairs], np.int32)
    xs = batch_pad([to_bytes(x) for x, _ in pairs], int(m.max()) + 3, X_PAD)
    ys = batch_pad([to_bytes(y) for _, y in pairs], int(n.max()) + 5, Y_PAD)
    return xs, ys, m, n


def test_blosum_tables_and_codes_match_jax():
    """The copied tables, and the compact codes and scores the kernels use,
    equal the JAX package's packed LUTs for every byte pair."""
    assert substitution.ALPHABET == jax_sub.ALPHABET
    for name in ("blosum50", "blosum62"):
        np.testing.assert_array_equal(substitution.blosum_config(name).matrix,
                                      jax_sub.blosum_config(name).matrix)
        S = jax_cfg(name).matrix
        plut, elut = _packed_luts(S, tuple(jax_sub.ALPHABET.encode()))
        lut, table = scan_dp.profile_tables(substitution.blosum_config(name))
        np.testing.assert_array_equal(lut, elut)
        worst = int(S.min())
        codes = np.arange(table.shape[0])
        words = plut.astype(np.int64) % 2**32  # [x byte, word]
        want = ((words[:, codes // 4] >> (8 * (codes % 4))) & 255) + worst
        np.testing.assert_array_equal(table[lut], want)  # [x byte, y code]
    cfg = substitution.blosum_config("blosum62", gap_penalty=GAP)
    assert (cfg.gap_penalty, cfg.gap_open, cfg.alphabet) == (GAP, 0.0, jax_sub.ALPHABET)


@pytest.mark.parametrize("seed", [0, 1])
def test_sw_profile_matches_pallas_b3(seed):
    """K4's plain version, per-lane x, against score_lanes_profile_jit (the
    Pallas profile kernel B3 in interpret mode)."""
    xs, ys, m, n = raw_lanes(protein_pairs(seed))
    cfg = jax_cfg()
    plut, elut = _packed_luts(cfg.matrix, tuple(cfg.alphabet.encode()))
    S = np.asarray(cfg.matrix).astype(np.int32)
    # B3 takes no lengths: its pad bytes score the matrix minimum, so no
    # pad cell can reach a lane's maximum (the mask-free argument).
    want = score_lanes_profile_jit(
        xs, ys, plut, elut, worst=int(S.min()), best_sub=int(S.max()), gap=GAP,
        interpret=True, ncodes=len(cfg.alphabet) + 1,
    )
    lut, table = port_tables()
    got = profile_cuda.sw_profile(
        torch.from_numpy(lut[xs]), torch.from_numpy(lut[ys]),
        torch.from_numpy(m), torch.from_numpy(n), table=table, gap=GAP,
    )
    for name, g, w in zip(("score", "i", "j"), got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert [int(v[-2]) for v in got] == [0, 0, 0]  # all-worst lane


def test_sw_profile_slab_matches_pallas_slab_scan(rng):
    """K4's plain version on a flat slab with one shared query against the
    JAX resident scan (score_db_slab_group_jit, B3 with shared=True)."""
    cfg = jax_cfg()
    entries = [mutate(rng, random_protein(rng, int(rng.integers(30, 300))), 4) for _ in range(23)]
    query = mutate(rng, entries[5][10:70], 5)
    seqs = [to_bytes(s) for s in entries]
    order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
    eng = PallasEngine(cfg, interpret=True)
    plut, elut = (np.asarray(a) for a in eng._lut())
    Mq = jax_db.ResidentProteinDB._pad_q(len(query))
    B = 8
    slab, lens_mat, row0s, _, groups, _ = jax_db.pack_slab(seqs, order, B, 64, elut, tail_rows=Mq + 24)
    qcol = np.full(Mq, X_PAD, np.uint8)
    qcol[: len(query)] = to_bytes(query)
    pprof = np.ascontiguousarray(np.broadcast_to(
        plut[qcol.astype(np.int32)].T[:, :, None], (plut.shape[1], Mq, LANE)))
    S = np.asarray(cfg.matrix).astype(np.int32)
    want = np.zeros((3, len(seqs)), np.int32)
    for g0, k, N in groups:
        out = score_db_slab_group_jit(
            slab, g0, row0s, lens_mat, pprof, k=k, N=N, worst=int(S.min()),
            best_sub=int(S.max()), gap=GAP, gopen=0, interpret=True,
            ncodes=len(cfg.alphabet) + 1,
        )
        for g in range(k):
            idxs = order[(g0 + g) * B : (g0 + g + 1) * B]
            want[:, idxs] = np.asarray(out)[:, g, : len(idxs)]
    lut, table = port_tables()
    pslab, offs, lens = port_db.pack_slab(seqs, order, lut)
    got = profile_cuda.sw_profile(
        torch.from_numpy(lut[to_bytes(query)]), torch.from_numpy(pslab),
        torch.full((len(seqs),), len(query), dtype=torch.int32),
        torch.from_numpy(lens), table=table, gap=GAP, y_off=torch.from_numpy(offs),
    )
    for name, g, w in zip(("score", "i", "j"), got, want):
        np.testing.assert_array_equal(g.numpy(), w[order], err_msg=name)


def test_slab_lanes_are_clamped_to_the_slab():
    """A lane that runs past the slab's end scores only the bytes the slab
    holds; a lane whose offset lies outside the slab scores 0."""
    lut, table = port_tables()
    entry = "MKWVTFISLLLLFSSAYS"
    slab = torch.from_numpy(lut[to_bytes(entry * 2)])
    q = torch.from_numpy(lut[to_bytes(entry)])
    m = torch.full((4,), len(entry), dtype=torch.int32)
    off = torch.tensor([0, len(entry), 2 * len(entry) + 1, -3], dtype=torch.int64)
    n = torch.tensor([len(entry), 500, 5, 5], dtype=torch.int32)
    score, i, j = profile_cuda.sw_profile(q, slab, m, n, table=table, gap=GAP, y_off=off)
    full = jax_cfg().matrix[[jax_sub.ALPHABET.index(c) for c in entry]][
        :, [jax_sub.ALPHABET.index(c) for c in entry]].trace()
    assert score.tolist() == [full, full, 0, 0]
    assert (i.tolist(), j.tolist()) == ([len(entry)] * 2 + [0, 0], [len(entry)] * 2 + [0, 0])


def moves_pairs(seed: int, long_entries: bool):
    """(entry, query) lanes as solve_uniprot's traceback sees them: x = the
    entry, y = the query; ``long_entries`` takes entries of 513-600 aa."""
    rng = np.random.default_rng(seed)
    query = random_protein(rng, 48)
    pairs = []
    for k in range(6):
        lo, hi = (513, 601) if long_entries else (40, 200)
        body = random_protein(rng, int(rng.integers(lo, hi)) - 30)
        at = int(rng.integers(0, len(body)))
        pairs.append((body[:at] + mutate(rng, query[9:39], 3) + body[at:], query))
    pairs.append(("xxxx" * 5, query))
    return pairs


@pytest.mark.parametrize("long_entries", [False, True], ids=["pallas_b4", "scan_emit_moves"])
def test_sw_profile_moves_matches_jax(long_entries):
    """K5's plain version against the JAX package's two traceback routes:
    the Pallas moves kernel B4 (interpret mode) up to its 512-row envelope,
    the scan engine's emit_moves beyond it. Score, argmax and every move
    code inside each lane's matrix."""
    xs, ys, m, n = raw_lanes(moves_pairs(3, long_entries))
    cfg = jax_cfg()
    if long_entries:
        res = ScanEngine(cfg).score_batch(xs, ys, m, n, emit_moves=True)
    else:
        res = PallasEngine(cfg, interpret=True).score_batch_moves(xs, ys, m, n)
    lut, table = port_tables()
    score, i, j, moves = profile_cuda.sw_profile_moves(
        torch.from_numpy(lut[xs]), torch.from_numpy(lut[ys]),
        torch.from_numpy(m), torch.from_numpy(n), table=table, gap=GAP,
    )
    B, M = xs.shape
    for name, g in (("score", score), ("i", i), ("j", j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(res[name])[:B], err_msg=name)
    D = M + ys.shape[1] - 1
    assert moves.shape == (D, M, B)
    d = np.arange(D)[:, None, None]
    r = np.arange(M)[None, :, None]
    valid = (r < m[None, None, :]) & (d >= r) & (d - r < n[None, None, :])
    np.testing.assert_array_equal(moves.numpy()[valid], np.asarray(res["moves"])[:D, :M, :B][valid])
    assert int(score[-1]) == 0


def test_k5_k9_launch_arguments_leave_the_cpu_route_unchanged():
    """``lanes`` and ``warps`` pick K5/K9's launch on the card; on CPU
    tensors the wrappers run the plain version, the same with or without
    them, and launch nothing."""
    xs, ys, m, n = raw_lanes(moves_pairs(1, False))
    lut, table = port_tables()
    args = (torch.from_numpy(lut[xs]), torch.from_numpy(lut[ys]), torch.from_numpy(m),
            torch.from_numpy(n))
    for fn, gaps in ((profile_cuda.sw_profile_moves, dict(gap=GAP)),
                     (profile_cuda.sw_profile_affine_moves, dict(gap_open=10, gap=2))):
        before = fn.launches
        want = fn(*args, table=table, **gaps)
        got = fn(*args, table=table, lanes=4, warps=2, **gaps)
        assert fn.launches == before
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_resident_db_scan_matches_jax(rng):
    entries = [(f"p{k}", mutate(rng, random_protein(rng, int(rng.integers(30, 260))), 2))
               for k in range(17)]
    entries.append(("planted", entries[4][1][20:90]))
    query = entries[4][1][10:100]
    want = jax_db.ResidentProteinDB(entries, gap_penalty=GAP, gap_open=0.0,
                                    batch_size=4, pad_mult=64)
    got = port_db.ResidentProteinDB(entries, gap_penalty=GAP, gap_open=0.0, device="cpu")
    for q in (query, "W" + query[::-1]):
        w_scores, w_pos, _ = want.scan_scores(q)
        g_scores, g_pos, _ = got.scan_scores(q)
        np.testing.assert_array_equal(g_scores, w_scores)
        np.testing.assert_array_equal(g_pos, w_pos)
    assert got.scan(query, top=5)[0] == want.scan(query, top=5)[0]


def test_write_uniprot_csv_matches_jax(tmp_path):
    entries = [("a", "ARN"), ("b", "DCQEG"), ("c,d", "W")]
    tb = {1: (3, "DC-", "DCQ"), 2: (1, "W", "W")}
    port_db.write_uniprot_csv(tmp_path / "p.csv", entries, [7, 9, 0], [2, 4, 0], tb)
    jax_db.write_uniprot_csv(str(tmp_path / "j.csv"), entries, [7, 9, 0], [2, 4, 0], tb)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert port_db.UNIPROT_CSV_HEADER == jax_db.UNIPROT_CSV_HEADER


def test_gen_protein_db_same_bytes(tmp_path):
    query = "MKWVTFISLLLLFSSAYSRGVFRRDTHKSEIAHRFKDLGE"
    kw = dict(n_entries=50, query=query, seed=11, max_len=700)
    assert gen_protein_db(tmp_path / "p.fa", **kw) == jax_gen_protein_db(tmp_path / "j.fa", **kw) == 8
    assert (tmp_path / "p.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
