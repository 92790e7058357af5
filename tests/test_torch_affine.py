"""The affine (Gotoh) slice's modules (plain PyTorch route, CPU tensors)
against the JAX package on the same seeded inputs, under BWA-MEM's DNA
scoring (1/-4, open 6, extend 1) and BLOSUM50 with swps3's 10/2 gaps:

- the plain K6 and K8 against the Pallas kernels B5/B7 (interpret mode),
- the plain K7 and K9 against B6/B8 in (score, i, j) and the H-source bits,
  and in all five bits against the JAX scan (``_wavefront_affine``), whose
  boundaries the port follows; every extend bit where B6/B8 differ sits on
  a cell whose scan E (or F) is negative, where no gap run reaches H,
- the plain ``walk_moves_affine`` against the JAX walk,
- the slab form of the plain K8 against the JAX resident database.

Exact equality everywhere: every value is an integer or a byte."""

import numpy as np
import pytest
import torch

from conftest import random_dna, random_protein
from parallel_genomeseq_tpu.models import protein_db as jax_db
from parallel_genomeseq_tpu.ops import traceback as jax_tb
from parallel_genomeseq_tpu.ops.scan_dp import ScanEngine
from parallel_genomeseq_tpu.ops.substitution import blosum_config as jax_blosum
from parallel_genomeseq_tpu.ops.wavefront_pallas import PallasEngine
from parallel_genomeseq_tpu.utils.config import ScoringConfig as JaxScoringConfig
from parallel_genomeseq_tpu.utils.encoding import X_PAD, Y_PAD, batch_pad, to_bytes
from parallel_genomeseq_tpu_torch.models import protein_db as port_db
from parallel_genomeseq_tpu_torch.ops import (
    engine,
    profile_cuda,
    scan_dp,
    traceback,
    wavefront_cuda,
)
from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default pool of a thread a core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

BWA = dict(match=1, mismatch=-4, gap_open=6, gap=1)
BLOSUM = dict(gap_open=10, gap=2)
JAX_CFG = {
    "bwa": JaxScoringConfig(match=1.0, mismatch=-4.0, gap_open=6.0, gap_penalty=1.0),
    "blosum50": jax_blosum("blosum50", gap_penalty=2.0, gap_open=10.0),
}
PORT_CFG = {
    "bwa": ScoringConfig(match=1.0, mismatch=-4.0, gap_open=6.0, gap_penalty=1.0),
    "blosum50": blosum_config("blosum50", gap_penalty=2.0, gap_open=10.0),
}
ODD = "xJOUb*"  # bytes outside the 24-letter alphabet, and '*', which is in it


def mutate(rng, s: str, letters: str, nsub: int, nindel: int) -> str:
    """nsub substitutions and nindel single-letter insertions or deletions
    (a run of them makes the long gaps that the extend bits record)."""
    s = list(s)
    for _ in range(nsub):
        s[int(rng.integers(0, len(s)))] = str(rng.choice(list(letters)))
    for _ in range(nindel):
        p = int(rng.integers(1, len(s) - 1))
        if rng.integers(0, 2):
            s[p:p] = list(rng.choice(list(letters), int(rng.integers(1, 5))))
        else:
            del s[p : p + int(rng.integers(1, 5))]
    return "".join(s)


def lanes(kind: str, seed: int):
    """Seven ragged (x, y) lanes with substitutions and gap runs (M <= 64,
    N <= 300), plus one lane with nothing to align."""
    rng = np.random.default_rng(seed)
    if kind == "bwa":
        letters, rand, blank = "ACGT", random_dna, ("AAAAAA", "CCCCCCCCC")
    else:
        letters, rand = "ARNDCQEGHILKMFPSTWYV" + ODD, random_protein
        blank = ("xxxxxx", "JJJJJJJJJ")
    ref = rand(rng, 300)
    pairs = []
    for k in range(7):
        s = int(rng.integers(0, 220))
        x = mutate(rng, ref[s : s + int(rng.integers(30, 61))], letters, k % 3, 1 + k % 4)
        lo = max(0, s - int(rng.integers(0, 40)))
        pairs.append((x, ref[lo : lo + int(rng.integers(60, 300))]))
    pairs.append(blank)
    m = np.array([len(x) for x, _ in pairs], np.int32)
    n = np.array([len(y) for _, y in pairs], np.int32)
    xs = batch_pad([to_bytes(x) for x, _ in pairs], int(m.max()) + 3, X_PAD)
    ys = batch_pad([to_bytes(y) for _, y in pairs], int(n.max()) + 5, Y_PAD)
    return xs, ys, m, n


def port_call(kind, fn_uniform, fn_profile, xs, ys, m, n, **kw):
    """The port's affine wrapper of ``kind`` on CPU tensors (raw bytes for
    uniform scoring, compact codes for the matrix)."""
    m, n = torch.from_numpy(m), torch.from_numpy(n)
    if kind == "bwa":
        return fn_uniform(torch.from_numpy(xs), torch.from_numpy(ys), m, n, **BWA, **kw)
    lut, table = scan_dp.profile_tables(blosum_config("blosum50", gap_penalty=2.0, gap_open=10.0))
    return fn_profile(torch.from_numpy(lut[xs]), torch.from_numpy(lut[ys]), m, n,
                      table=torch.from_numpy(table), **BLOSUM, **kw)


def in_matrix(m, n, D, M):
    d = np.arange(D)[:, None, None]
    r = np.arange(M)[None, :, None]
    return (r < m[None, None, :]) & (d >= r) & (d - r < n[None, None, :])


@pytest.mark.parametrize("kind", ["bwa", "blosum50"])
@pytest.mark.parametrize("need_pos", [False, True])
def test_k6_k8_match_pallas_b5_b7(kind, need_pos):
    """Through the port's engine, which routes an affine config to the K6
    (uniform) or K8 (matrix) wrapper: their plain versions on CPU tensors."""
    xs, ys, m, n = lanes(kind, 0)
    want = PallasEngine(JAX_CFG[kind], interpret=True).score_batch(xs, ys, m, n, need_pos=need_pos)
    counter = wavefront_cuda.sw_score_affine if kind == "bwa" else profile_cuda.sw_profile_affine
    before = counter.launches
    port = engine.CudaEngine(PORT_CFG[kind], device="cpu")
    got = port.score_batch(xs, ys, m, n, need_pos=need_pos)
    assert counter.launches == before  # CPU tensors: the plain route
    for name in ("score", "i", "j"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    assert int(got["score"][-1]) == 0 and int(got["score"][:-1].min()) > 0
    if not need_pos:  # the score-only sweep (chunking's stage A) gives i = j = 0
        assert not got["i"].any() and not got["j"].any()


@pytest.mark.parametrize("kind", ["bwa", "blosum50"])
@pytest.mark.parametrize("seed", [1, 2])
def test_k7_k9_match_pallas_b6_b8_and_the_scan(kind, seed):
    """(score, i, j) and bits 0-1 against B6/B8; all five bits against the
    scan; B6/B8's extend bits differ only where the scan's E or F is < 0."""
    xs, ys, m, n = lanes(kind, seed)
    B, M = xs.shape
    D = M + ys.shape[1] - 1
    score, i, j, moves = port_call(
        kind, wavefront_cuda.sw_score_affine_moves, profile_cuda.sw_profile_affine_moves,
        xs, ys, m, n)
    pallas = PallasEngine(JAX_CFG[kind], interpret=True).score_batch_moves(xs, ys, m, n)
    scan = ScanEngine(JAX_CFG[kind]).score_batch(xs, ys, m, n, keep_matrix=True, emit_moves=True)
    for name, g in (("score", score), ("i", i), ("j", j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(pallas[name])[:B], err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(scan[name]), err_msg=name)
    assert moves.shape == (D, M, B) and moves.dtype == torch.uint8
    valid = in_matrix(m, n, D, M)
    got = moves.numpy()[valid]
    np.testing.assert_array_equal(got, np.asarray(scan["moves"])[valid])
    theirs = np.asarray(pallas["moves"])[:D, :M, :B][valid]
    np.testing.assert_array_equal(got & 3, theirs & 3)
    e_diff = ((got ^ theirs) & scan_dp.E_EXT_BIT) != 0
    f_diff = ((got ^ theirs) & scan_dp.F_EXT_BIT) != 0
    assert (np.asarray(scan["estack"])[valid][e_diff] < 0).all()
    assert (np.asarray(scan["fstack"])[valid][f_diff] < 0).all()
    # The lanes carry gap runs: the extend bits are exercised.
    assert (got & scan_dp.E_EXT_BIT).any() and (got & 3 == scan_dp.H_E).any()
    assert (got & 3 == scan_dp.H_F).any()


@pytest.mark.parametrize("kind", ["bwa", "blosum50"])
@pytest.mark.parametrize("max_steps", [9, 400])
def test_walk_moves_affine_matches_jax(kind, max_steps):
    """The plain affine walk against the JAX walk on the same moves (K7/K9's
    plain output): pos, both consensus buffers and steps, with truncation at
    max_steps and the empty lane skipped."""
    xs, ys, m, n = lanes(kind, 3)
    score, i, j, moves = port_call(
        kind, wavefront_cuda.sw_score_affine_moves, profile_cuda.sw_profile_affine_moves,
        xs, ys, m, n)
    x_mb = np.ascontiguousarray(xs.T)
    want = jax_tb.walk_moves_affine(moves.numpy(), x_mb, ys, i.numpy(), j.numpy(),
                                    max_steps=max_steps)
    got = traceback.walk_moves_affine(moves, torch.from_numpy(x_mb), torch.from_numpy(ys),
                                      i, j, max_steps=max_steps)
    for name, g, w in zip(("pos", "cx", "cy", "steps"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[3][-1]) == 0 and int(got[0][-1]) == 0
    if max_steps == 400:
        cons = traceback.decode_consensus(*(t.numpy() for t in got[1:]))
        assert any("--" in cx or "--" in cy for cx, cy in cons)  # a gap run was walked


def test_k8_slab_matches_jax_resident_db(rng):
    """The slab form of the plain K8 (one shared query, a flat code slab)
    against the JAX ResidentProteinDB's affine scan, and the port's
    ResidentProteinDB (default 10/2 gaps) on top of it."""
    entries = [(f"p{k}", mutate(rng, random_protein(rng, int(rng.integers(30, 200))),
                                "ARNDCQEGHILKMFPSTWYV" + ODD, 2, 1))
               for k in range(13)]
    entries.append(("planted", mutate(rng, entries[4][1][10:80], "ARNDCQEGHILKMFPSTWYV", 3, 2)))
    query = entries[4][1][5:90]
    want = jax_db.ResidentProteinDB(entries, gap_penalty=2.0, gap_open=10.0,
                                    batch_size=4, pad_mult=64)
    w_scores, w_pos, _ = want.scan_scores(query)
    lut, table = scan_dp.profile_tables(blosum_config("blosum50", gap_penalty=2.0, gap_open=10.0))
    seqs = [to_bytes(s) for _, s in entries]
    order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
    slab, offs, lens = port_db.pack_slab(seqs, order, lut)
    score, _, jj = profile_cuda.sw_profile_affine(
        torch.from_numpy(lut[to_bytes(query)]), torch.from_numpy(slab),
        torch.full((len(seqs),), len(query), dtype=torch.int32), torch.from_numpy(lens),
        table=torch.from_numpy(table), **BLOSUM, y_off=torch.from_numpy(offs))
    np.testing.assert_array_equal(score.numpy(), w_scores[order])
    np.testing.assert_array_equal(jj.numpy(), w_pos[order])
    got = port_db.ResidentProteinDB(entries, device="cpu")
    g_scores, g_pos, _ = got.scan_scores(query)
    np.testing.assert_array_equal(g_scores, w_scores)
    np.testing.assert_array_equal(g_pos, w_pos)
    assert got.scan(query, top=4)[0] == want.scan(query, top=4)[0]
