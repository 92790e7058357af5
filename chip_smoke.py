#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--reads 5120] [--batch-size 512]
                          [--entries 561356] [--protein-seed 7]

1. Requires a CUDA card and prints its name, power limit and top SM clock.
2. Builds the port's CUDA kernels from ``parallel_genomeseq_tpu_torch/csrc``
   and prints their registers and spills.
3. DNA short-read path. Holds K1 (both modes, 512 reads x 17 windows), K2
   (the 512 winning windows and the full reference) and K3 (on K2's output)
   against their plain PyTorch versions on the card, on the same inputs,
   with exact equality (every value is an integer or a byte). Runs
   ``solve_small`` of the port with its defaults on a seeded stand-in for the
   data_small workload (4,980-bp reference, 5,120 reads of 125 bp with
   substitutions and small indels), checks that K1, K2 and K3 launched during
   that run, and that 32 sampled reads agree with the numpy oracle.
4. The same path with affine (Gotoh) gaps under BWA-MEM's scoring (match 1,
   mismatch -4, gap open 6, extend 1) on the same reads: K6 (both modes),
   K7 (winning windows and the full reference) and K10 (on K7's output)
   against their plain versions, ``solve_small --match 1 --mismatch -4
   --gap-open 6 --gap-penalty 1``, K6, K7 and K10 launched during it, and 32
   sampled reads against a numpy Gotoh oracle (score, pos and both consensus
   strings).
5. Protein database scan path, at SwissProt scale: 561,356 generated entries
   (lognormal lengths, median ~290 aa, 60-2,048) with 9 mutated copies of a
   seeded 145-aa query planted (every index k with k % 70,169 == 3). Holds
   K4 against its plain version on every 4th lane of its whole-slab launch
   (the main path's single launch), on the shortest and longest 4,096-lane
   length groups, per lane on the longest (the query tiled over the lanes;
   equal to the slab scan too) and with a seeded 2,048-aa query over the
   shortest (the widest thread-group shape); K5 and K3 on the top-10 traceback
   batch and on 256 of the longest entries (M = 2,048, about 1.2 GB of
   moves), K5 also at every lanes a block (L = 1..16) and warps a lane (1,
   2) its launch takes. Holds their affine forms under BLOSUM50 with gap
   10/2 on the same slab: K8 on the same cases, its whole-slab launch on
   every 16th lane, K9 and K10 on the affine top 10 and the 256 longest
   (K9's curves as K5's).
   Runs ``solve_uniprot`` of the port with the ``uniprot_e2e`` settings
   (BLOSUM50, gap 12, batch 4,096, pad 128, top 10), then with ``--gap-open
   10 --gap-penalty 2``, each after a warm-up on 20,000 entries, prints
   pack+upload seconds, scan seconds, GCUPS and proteins/s, checks that K4,
   K5 and K3 (K8, K9 and K10) launched during that run, and holds the
   planted entries, the top 10 and 32 sampled entries against the numpy
   oracle (score and pos_end; pos_pred and both consensus strings for the
   top 10).
6. Long-read path, at ``solve_big``'s default width: a 30,000-bp generated
   reference (seed 0), 100 reads of 10,000 bp sampled from it (what
   ``solve_big`` generates) and a mutated copy of them (about 1%
   substitutions and three 1-3 bp indels per read), 14 windows. Holds K11
   (the 1,400-lane window sweep on one read's 14 lanes, and every lane of a
   reduced 1,400 x 2,304 x 4,608 shape), K12 (the 100 winners, on 4 of
   them), K13 (on every 4th lane and a lane that reaches the top strip) and
   K14 (every lane) on the top, a middle
   and the bottom strip of the winners' traceback's first group against
   their plain versions: K13 as the engine launches it, G strips at once by
   ``strips_cuda.replay_group``, on the cells the walk can read (timed, and
   at G = 4, 8 and 16, with G, the warps an SM, the cycles a column step and
   the moves' GB), and as the per-strip wrapper (G = 1, every column), each
   held on the strip's first PLAIN_REPLAY_COLS (2,560) columns, which the
   plain replay (a loop over columns) replays; the group launch's right
   edges, min(n_b, j) and n_b, which lie past those columns here, held by
   launching it again into a buffer of 0xFF with each lane's n and walk j
   moved inside them (``replay_edges``: equal codes below the edge, no byte
   written past it); K14 as the engine launches it, the group's G strips in one launch, its end
   state held on every lane against the plain per-strip walks over the same
   strips, and as the per-strip launch (G = 1) on those three strips, each
   timed by CUDA events with the longest lane's steps, the ns a step on that
   chain, the tile shape and the lanes a block. Runs
   ``solve_big 7 3`` on the exact reads and ``solve_big 7 1 --traceback`` on
   the mutated ones, checks that K11 (and K12, K13, K14) launched during
   them (one walk launch a replay group, and fewer groups than strips
   walked), and holds 2
   sampled reads of the traceback run against the numpy oracle over their
   winning window (score, pos, both consensus strings).
7. The long-read path with affine (Gotoh) gaps under BWA-MEM's scoring, on
   the same reference and reads: K15 (one read's 14 lanes, and the reduced
   shape), K16 (the 100 winners, held on 4 of them), K17 (every 4th lane)
   and K18 (every lane) on the top, a middle and the bottom strip against
   their plain versions;
   ``solve_big 7 3`` and ``solve_big 7 1 --traceback`` with the BWA-MEM
   flags, checking that K15 (and K16, K17, K18) launched during them and
   K11-K14 did not, and one sampled read of the traceback run against the
   numpy Gotoh oracle over its winning window.
8. A titin-class query: a seeded 4,096-aa query against phase 5's entries
   and three planted entries of 2,600, 3,500 and 4,600 aa, each holding a
   mutated segment of the query (a database apart from phase 5's). Holds
   K19 against its plain version on the whole-slab launch (on the planted
   lanes and every 1,024th lane), on the shortest and longest 4,096-lane
   groups, and per lane on a reduced BLOSUM50 shape of 1,400 x 2,304 x
   4,608; K20, K21 and K14 on the top-10 traceback batch (the top, a middle
   and the bottom strip, every lane). Runs ``solve_uniprot`` of the port on
   it (BLOSUM50, gap 12, top 10) after a warm-up, prints pack+upload
   seconds, scan seconds, GCUPS and proteins/s, checks that K19, K20, K21
   and K14 launched during the run and K4, K5 and K3 did not, and holds the
   planted entries, the top 10 and 32 sampled entries against the numpy
   oracle. Holds K19, K20, K21 and K14 as phase 6 holds K11-K14, at
   ``solve_big --matrix blosum50 7 1 --traceback``'s shapes on phase 6's
   mutated reads; then runs it, checks its launches (K19, K20, K21, K14; none of K11-K13,
   K15-K18, K22-K24) and holds one sampled read against the oracle.
9. Phase 8 under swps3's affine gaps (BLOSUM50, ``--gap-open 10
   --gap-penalty 2``) on the same query and database: K22 held against its
   plain version as K19 is, K23, K24 and K18 on the top-10 traceback batch;
   ``solve_uniprot`` with K22, K23, K24 and K18 launched and none of K3-K5,
   K8-K10, K14 or K19-K21; the planted entries, the top 10 and 32 sampled
   entries against the numpy Gotoh oracle; K22-K24 and K18 at
   ``solve_big --matrix blosum50 --gap-open 10 --gap-penalty 2 7 1
   --traceback``'s shapes, as phase 7 holds K15-K18; that run on phase 6's
   mutated reads, checking its launches (K22, K23, K24, K18; none of K11-K17,
   K19-K21, K14), and one sampled read against the Gotoh oracle.
10. The serving entry points, on phase 3's reads and phase 5's database.
   ``solve_small --matrix blosum50`` (gap 2, then ``--gap-open 10
   --gap-penalty 2``) at ``--npiece 17``, batch 512: K4 (K8) per lane, the
   table route, held against its plain version on the window sweep's 8,704
   lanes, K5 (K9) on the 512 winning windows and K3 (K10) on its output;
   the run, with K4, K5 and K3 (K8, K9, K10) launched and none of K1, K2,
   K6 or K7, and 32 sampled reads against the numpy oracle (Gotoh for
   10/2) under BLOSUM50. Then the port's server on a thread of this
   process (``cli/serve.py``: phase 3's reference, phase 5's database,
   ``--npiece 17``, ``--output-dir`` a scratch directory), talked to over
   its Unix socket: ping, 10 ``align`` requests of 512 reads (equal to
   phase 3's CSV rows), 5 top-10 ``scan_db`` requests with traceback (equal
   to phase 5's affine top 10), one ``scan_db`` with ``output`` (its name,
   len, score and pos_end equal to phase 5's affine CSV), shutdown; K1,
   K2, K3, K8, K9 and K10 launched during the requests and none of K4-K7.
   Prints the server's load and warm-up seconds and each request kind's
   median and range of ``wall_s``, reads/s, GCUPS and proteins/s. Then
   ``solve_batch 5120 --traceback`` (K2 and K3 launched, its timing row
   written).
11. Seed-and-extend and global alignment. ``solve_small --seed-extend`` on
   phase 3's reads, with linear gaps and with BWA-MEM's: the host's FM-index
   build and ``seeds_batch`` seconds; K2 and K3 (K7 and K10) held against
   their plain versions at the seeded windows' shape (the first batch's
   seeded reads against their windows); the run, with K2 and K3 (K7, K10)
   launched and neither K1 nor K6 (no window sweep), its reads/s beside
   phase 3's (4's), 32 sampled reads against the numpy oracle (Gotoh) inside
   their windows, no score above phase 3's (4's) full-width CSV and the
   rows that differ from it counted, and ``--engine plain``'s CSV on the
   first batch equal to the card's. Then K25, the NW last-row sweep, held
   exactly against its plain version on phase 6's data, each case timed
   beside its rows a thread, warps a block, blocks, segments (chunks) a
   lane, GCUPS and bound share, and PR 16's time where it had the case:
   Hirschberg's top launch (2 lanes read in place: a mutated read's first
   half, and its second half reversed, against its source read forward and
   reversed), an ``nw_score_batch`` of the 100 mutated reads against their
   sources, a ragged 64-lane batch, a deep recursion level's launch (4,096
   lanes of a few rows and columns), 40 lanes at random offsets, forward or
   reversed, and the segment edges (B of 1, 2 and 3; m_b on, one short of
   and one past a segment edge at 4 and 32 rows a thread, m_b = 0 and n_b =
   0; n of 25,000); two of the scores against the host row sweep. Then
   ``hirschberg_align`` on 2 reads at ``device_cells=0`` (K25's launches
   counted from 0) and at the default, each with at most one K25 launch a
   recursion level, its seconds and launches beside PR 16's, and its score
   and consensus strings identical to the CPU-only run's; ``cli/demo.py``
   on the card, its lines equal to the CPU's.
12. The reference-parity modes (saturating uint8 values, ``Semantics.SAT_UINT8``,
   and the reference binary's skewed tie-break), on phase 3's data: K26
   held exactly against its plain version under both ties -- the 8,704
   window lanes (score-only, and the skewed argmax), the 512 reads against
   the whole reference (moves under both ties, the skewed argmax), a
   plateau (512 reads copied from the reference, every lane at 255) and
   lanes of m = n, m > n and n > m -- with K3 on its skewed moves; K27 on
   phase 6's 1,400-lane window sweep (held on one read's 14 lanes) and the
   skewed tie on a reduced 28 x 2,304 x 4,608 shape. Each case runs in the
   form the launch rule takes (``wavefront_cuda.parity_form``,
   ``strips_cuda.sweep_form``), and the two with a pair form (two lanes a
   word in 16-bit halves: K26's score-only windows, K27's column-major
   sweep) in both forms, each held to the plain version and timed beside
   the kernel's first form's time, with the bound at the pair form's
   operation count (``bound_ms``) and at the int32 form's
   (``int32_bound_ms``); K26's moves at the full reference also through
   its curve, warps a lane (1 or 2, so 4 or 2 rows a thread) and lanes a
   block (1-8), each point held; each skewed case with a position again
   with every cell's key (the rule past the 2^31 key bound), held and
   timed beside the key at the wrap row. Then ``solve_small
   --parity-mode skewed`` (K26 and K3 launched, neither K1 nor K2; 32
   sampled reads against a numpy oracle of the saturating DP and raw key:
   score, pos, both consensus strings; its first 1,024 rows equal to the
   same aligner's with engine="plain" on the card), ``solve_small
   --semantics sat_uint8`` (17 windows; 32 sampled reads against the
   saturating oracle) and ``solve_big 7 1 --semantics sat_uint8`` on phase
   6's exact reads (K27 launched, K11 not; every score 255), each with its
   reads/s, GCUPS and the forms its K26 and K27 launches took.
13. Prints the seconds of each phase, then the kernels' JSON line -- each kernel's time, its plain version's,
   and its bound: the larger of the integer operations its cells need over
   the card's integer issue peak and the bytes it must move over the memory
   rate; for K1, K2, K6 and K7, and K5 and K9 (a warp a lane) also the rows
   a thread, warps a lane, lanes a block, warps an SM, the cycles a column
   step takes (``wave_steps``) and the bound at the instructions the step
   issues a cell (``WAVE_ISSUED_PER_CELL``), for K5 and K9 at both shapes
   the curves of lanes a block and warps a lane, and for K2 and K7 at both
   shapes the curve of lanes a block (L = 1..16, each held against the plain
   version), two warps
   a lane (2 rows a thread) and, on the winning windows, the lanes' first 64
   rows (2 rows a thread, one warp); for the strip sweeps (K11, K12, K15,
   K16, K19, K20, K22, K23) also
   the threads a block, the blocks an SM holds, the waves and the cycles a
   block step takes (``sweep_steps``), for the scans K4 and K8 the threads a
   lane, the rows a thread, the warps an SM, the cycles a column step
   takes (``scan_steps``) and the bound at the instructions the scan issues
   a cell (``SCAN_ISSUED_PER_CELL``), for the walks (K3, K10, K14, K18) the
   longest lane's steps, the ns a step on that chain, the band segment (K3,
   K10) or tile (K14, K18) they stage and the lanes a block, printed beside
   each time as well; phase 10's cases under their labels and each run's
   launches as ``launches_<run>``, added to ``launches``, phase 11's
   seeded cases under ``seeded`` and its runs' launches the same way, and
   K25's entry (its Hirschberg top launch first, the other cases under their
   labels, its launches those of the ``device_cells=0`` ``hirschberg_align``
   runs), phase 12's K3 case under ``parity_skewed`` and its runs' launches,
   and K26's and K27's entries (their launches those of phase 12's runs) --
   then ``{"ok": true, "device": ...}`` last.

Any failed phase raises and exits non-zero before the last line.
"""

from __future__ import annotations

import argparse
import collections
import csv
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = "parallel_genomeseq_tpu_torch/csrc"
PALLAS = "parallel_genomeseq_tpu/ops/wavefront_pallas.py"

# The card's published memory rate (H100 SXM, 80 GB HBM3) and its integer
# issue width: an SM's 4 schedulers each issue one warp-instruction of 32
# lanes a cycle, 132 x 4 x 32 = 16,896 lanes, and every operation counted
# below is one instruction, so no kernel can do them faster (the 64 INT32
# lanes an SM of the data sheet are a floor that the strip sweep's step
# beats: its integer instructions also issue to the FMA pipes). The int32
# peak is that width times the top SM clock nvidia-smi reports.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 4 * 32
# Integer ALU operations per DP cell that the function needs on sm_90a,
# counted from the recurrence H = max(diag + s, max(west, north) - gap, 0).
# Memory traffic is not counted (the column scratch, the shared-memory table
# read and the move-byte store issue on the load/store pipe), nor addressing.
#   the score s: uniform, a compare and a select (2); a table, one
#     shared-memory read (0);
#   the recurrence: max(west, north), the gap subtract, and one DPX
#     __viaddmax_s32_relu(diag, s, .) for the add, the max and the zero max (3);
#   the running best: score only, one max (1); with its cell, one max over a
#     packed (score, -row) key plus the key's multiply-add (2), the column
#     taken once per column, not per cell;
#   the move code: nw against the recurrence's max(west, north) and west
#     against north (2 compares), 2 selects; the stop flag, a DPX
#     __vimin3_s32 of the three neighbours, a compare with 0 and an or into
#     the code (3): 7.
# The affine (Gotoh) cell, E = max(H_west - open, E_west) - extend, F the same
# from the north, H = max(diag + s, E, F, 0):
#   the recurrence: E and F each one DPX __viaddmax_s32(H, -open, run) and
#     the extend subtract (2 + 2), H one max(E, F) and one DPX
#     __viaddmax_s32_relu(diag, s, .) for the add and the rest of the max (2):
#     6;
#   the move byte: H's source from three equality tests (H == 0, == diag +
#     s, == E) and three selects (6); the extend bits, the two opening
#     values (H - open) the DPX folded away, two compares and two ors into
#     the byte (6): 12.
# The long-read kernels count as their single-strip twins: K11 and K12 as
# K1 with its cell (K12's row store is bytes, not operations), K13 as K2
# without the running best (a replay keeps none); affine, K15 and K16 as K6
# with its cell, K17 as K7 without the running best; under a table, K19 and
# K20 as K4 (0 + 3 + 2), K21 as K5 without the running best (0 + 3 + 7),
# and affine K22 and K23 as K8 (0 + 6 + 2), K24 as K9 without the running
# best (0 + 6 + 12).
OPS_PER_CELL = {
    ("sw_score", False): 2 + 3 + 1,
    ("sw_score", True): 2 + 3 + 2,
    "sw_score_strips": 2 + 3 + 2,
    "sw_score_strips_ckpt": 2 + 3 + 2,
    "strip_moves": 2 + 3 + 7,
    "sw_score_moves": 2 + 3 + 2 + 7,
    "sw_profile": 0 + 3 + 2,
    "sw_profile_moves": 0 + 3 + 2 + 7,
    ("sw_score_affine", False): 2 + 6 + 1,
    ("sw_score_affine", True): 2 + 6 + 2,
    "sw_score_affine_moves": 2 + 6 + 2 + 12,
    "sw_profile_affine": 0 + 6 + 2,
    "sw_profile_affine_moves": 0 + 6 + 2 + 12,
    "sw_score_strips_affine": 2 + 6 + 2,
    "sw_score_strips_affine_ckpt": 2 + 6 + 2,
    "strip_affine_moves": 2 + 6 + 12,
    "sw_score_strips_profile": 0 + 3 + 2,
    "sw_score_strips_profile_ckpt": 0 + 3 + 2,
    "strip_profile_moves": 0 + 3 + 7,
    "sw_score_strips_profile_affine": 0 + 6 + 2,
    "sw_score_strips_profile_affine_ckpt": 0 + 6 + 2,
    "strip_profile_affine_moves": 0 + 6 + 12,
}
# The scan K4/K8 (csrc/profile.cu) issues fewer integer instructions a cell
# than OPS_PER_CELL counts for it: the recurrence (K4 3, K8 6, as above) and,
# for the running best, one __vimax3_s32 over two rows of a column (0.5), the
# cell taken once a column. Their bound at that count is printed beside the
# bound (``issued_bound_ms``), the shares it gives are the lower ones.
SCAN_ISSUED_PER_CELL = {"sw_profile": 3 + 0.5, "sw_profile_affine": 6 + 0.5}
# The short-read kernels K1/K2/K6/K7 (csrc/wavefront.cu, a warp a lane)
# likewise: the cell as issued -- the score's compare and select (2), west -
# gap and the two DPX of the linear cell (3); affine, E as one DPX and the
# extend subtract (2), the score (2), a (1), the F chain's subtract and DPX
# (2), H = max(a, F) (1) -- plus one __vimax3_s32 per two rows of a column
# for the running best (0.5), the cell taken once a column in either mode;
# K2/K7 add the move code as OPS_PER_CELL counts it (7, 12).
# K5/K9, the same template scored from a table, issue the code's extract (1)
# in place of the compare and select, and a shared-memory load that this
# count leaves out, as K4/K8's leaves out the profile load.
WAVE_ISSUED_PER_CELL = {
    ("sw_score", False): 5 + 0.5, ("sw_score", True): 5 + 0.5, "sw_score_moves": 5 + 0.5 + 7,
    ("sw_score_affine", False): 8 + 0.5, ("sw_score_affine", True): 8 + 0.5,
    "sw_score_affine_moves": 8 + 0.5 + 12,
    "sw_profile_moves": 4 + 0.5 + 7, "sw_profile_affine_moves": 7 + 0.5 + 12,
}
# K2/K7's lanes a block measured beside the kernel's rule (the L curve; 16
# is the block's limit at the main path's 4 rows a thread).
LANES_CURVE = (1, 2, 4, 8, 16)
# Per walk step (the code read is a load, not counted). K3: test the stop
# bit and the two moves (3), select the two emitted bytes (2), update i, j,
# pos, steps and the active flag (5). K10: the op in force, a state test and
# a select (2); the stop rule, the H_ZERO and two boundary tests, their or
# and the state's and (5); NW and E against the op (2); the two emitted
# bytes (2); the next state, the extend bit's test and a select (2); i, j,
# pos, steps and the active flag (5).
# K14, the strip walk, as K3 (10), and K18, the affine strip walk, as K10
# (18); their in-strip and slot tests are loop control.
OPS_PER_STEP = {"walk_moves": 10, "walk_moves_affine": 18, "walk_strip_level": 10,
                "walk_strip_level_affine": 18}
# The card's name and power limit as nvidia-smi prints them (set by main).
CARD = ""
LANE_BYTES = 8 + 12  # per lane: two int32 lengths in, (score, i, j) out
# The DNA path's scoring: solve_small's defaults, and BWA-MEM's affine
# scoring (a gap of length L costs gap_open + L * gap).
LINEAR = dict(match=3, mismatch=-3, gap=2)
BWA = dict(match=1, mismatch=-4, gap_open=6, gap=1)
BWA_FLAGS = ["--match", "1", "--mismatch", "-4", "--gap-open", "6", "--gap-penalty", "1"]
# The protein path's gaps: the uniprot_e2e linear 12, and swps3's affine 10/2.
PROTEIN_LINEAR = dict(gap=12)
PROTEIN_AFFINE = dict(gap_open=10, gap=2)
TABLE = {"table": None}  # strip_kernels' key for substitution-matrix scoring
# solve_big's defaults: 100 reads of 10,000 bp against a 30,000-bp reference
# in 2 x 7 windows of overlap ratio 2.0, linear 3/-3/2 scoring (and, in the
# affine long-read phase, BWA-MEM's).
BIG = dict(ref_len=30_000, read_len=10_000, n_reads=100, npiece=7, overlap=2.0)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), milliseconds of that one call by CUDA events): for plain
    versions too slow to run twice."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(ops: float, nbytes: float, clock_mhz: float):
    """(bound_ms, bound_by): the larger of the operations over the integer
    issue peak and the bytes over the memory rate."""
    t_ops = ops / (INT32_LANES * clock_mhz * 1e6) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sweep_steps(sweep, rec, M: int, n, clock_mhz: float, table=None, slab: bool = False,
                pair: bool = False):
    """Add a strip sweep's launch shape and its cost per block step to
    ``rec``: rows a thread, threads a block, the blocks an SM holds (the CUDA
    occupancy calculator), the waves and the cycles a block step takes, ms x
    clock / (waves x steps). A block of T threads sweeps n_b + T - 1 steps a
    pass. Per lane, waves = ceil(B / (blocks x SMs)) of passes x (max n_b +
    T - 1) steps; in the slab form, where n_b varies, waves x steps is the
    lanes' steps summed over the card's block slots. ``pair``: K27's pair
    form, a block a lane pair."""
    import torch

    from parallel_genomeseq_tpu_torch.ops import strips_cuda

    name = sweep.__name__
    threads, passes, blocks, rows = strips_cuda.sweep_occupancy(
        M, affine="affine" in name, ckpt=name.endswith("_ckpt"),
        ncodes=0 if table is None else table.shape[0], parity=name.endswith("_parity"),
        pair=pair)
    slots = blocks * torch.cuda.get_device_properties(0).multi_processor_count
    B = -(-n.shape[0] // 2) if pair else n.shape[0]
    if slab:
        steps = passes * (float(n.double().mean()) + threads - 1)
        waves = B / slots
    else:
        steps = passes * (int(n.max()) + threads - 1)
        waves = -(-B // slots)
    rec.update(band_rows=rows, threads=threads, blocks_per_sm=blocks,
               warps_per_sm=blocks * threads // 32,
               waves=waves, cycles_per_step=rec["ms"] * 1e-3 * clock_mhz * 1e6 / (waves * steps))


def scan_steps(rec, M: int, n, clock_mhz: float, ncodes: int, affine: bool, shared: bool):
    """Add a K4/K8 scan launch's shape and its cost per column step to
    ``rec``: threads a lane (g) and query rows a thread (r), the route (the
    shared query's profile or the table), threads a block, warps an SM (the
    CUDA occupancy calculator), and the cycles a warp's column step takes,
    ms x clock / (the warps' steps over the warps the card runs at once). A
    warp holds 32 / g consecutive lanes and steps to its longest lane's n_b
    + g - 1."""
    import torch

    from parallel_genomeseq_tpu_torch.ops import profile_cuda

    sh = profile_cuda.scan_shape(M, ncodes=ncodes, affine=affine, shared=shared)
    g, per = sh["g"], 32 // sh["g"]
    steps = torch.where(n > 0, n.long() + g - 1, 0)
    steps = torch.nn.functional.pad(steps, (0, -steps.shape[0] % per)).view(-1, per).max(1).values
    warps_per_sm = sh["blocks_per_sm"] * sh["threads"] // 32
    slots = min(steps.shape[0], warps_per_sm * torch.cuda.get_device_properties(0).multi_processor_count)
    rec.update(group_threads=g, band_rows=sh["r"], route="profile" if sh["profile"] else "table",
               threads=sh["threads"], warps_per_sm=warps_per_sm,
               cycles_per_step=rec["ms"] * 1e-3 * clock_mhz * 1e6 * slots / float(steps.sum()))


def wave_steps(rec, fn, M: int, N: int, m, n, clock_mhz: float, mode: str, lanes: int = 0,
               warps: int = 0, ncodes: int = 0, parity: bool = False, pair: bool = False):
    """Add a K1/K2/K6/K7 (``ncodes`` > 0: K5/K9) launch's shape and its cost
    per column step to ``rec``: rows a thread, lanes a block, warps a lane, the warps the
    busiest SM holds at once (the CUDA occupancy calculator's blocks an SM,
    or fewer when the launch has fewer blocks), and the cycles a warp's
    column step takes, ms x clock x the warps the card runs at once / the
    warps' steps summed. A lane steps n_b + the place of the thread holding
    row m_b in its warp + 40 for each warp before it; the warps of a block
    that meets at barriers (K2/K7, or more than one warp a lane) step
    together to its longest lane, in groups of 8. ``pair``: K26's pair form,
    whose warps each step a lane pair to the longer of its two lanes."""
    import torch

    from parallel_genomeseq_tpu_torch.ops import wavefront_cuda

    B = m.shape[0]
    sh = wavefront_cuda.launch_shape(M, B, affine="affine" in fn.__name__, mode=mode,
                                     lanes=lanes, warps=warps, ncodes=ncodes, parity=parity,
                                     pair=pair)
    rows, L, W = sh["rows"], sh["lanes"], sh["warps"]
    mb, nb = m.clamp(0, M).long(), n.clamp(0, N).long()
    g = (mb - 1).clamp(min=0) // rows  # the thread holding row m_b, over the lane's warps
    steps = torch.where((mb > 0) & (nb > 0), nb + g % 32 + g // 32 * 40, 0)
    if pair:  # a unit of two lanes steps to the longer
        steps = torch.nn.functional.pad(steps, (0, B % 2)).view(-1, 2).max(1).values
        B = steps.shape[0]
    if mode == "moves" or W > 1:
        steps = torch.nn.functional.pad(steps, (0, -B % L)).view(-1, L).max(1).values
        steps = (steps + 7) // 8 * 8 * L * W
    blocks = -(-B // L)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = min(sh["blocks_per_sm"], -(-blocks // sms))
    resident = min(blocks, per_sm * sms) * L * W
    rec.update(rows_a_thread=rows, lanes_a_block=L, warps_a_lane=W, warps_per_sm=per_sm * L * W,
               cycles_per_step=rec["ms"] * 1e-3 * clock_mhz * 1e6 * resident
               / float(steps.sum()))


def lane_work(m, n):
    """(cells, input sequence bytes) of lanes with true lengths m, n."""
    m, n = m.long(), n.long()
    return int((m * n).sum()), int(m.sum() + n.sum())


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired integer tensors; raises
    unless it is 0."""
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err != 0:
        raise AssertionError(f"kernel disagrees with its plain version: max |diff| = {err}")
    return err


def moves_err(got, want, m, n, chunk: int = 256) -> int:
    """Largest |difference| of two (D, M, B) move tensors over the cells
    inside each lane's m_b x n_b matrix (the only cells the kernel writes)."""
    import torch

    D, M, _ = got.shape
    r = torch.arange(M, device=got.device)[None, :, None]
    err = 0
    for d0 in range(0, D, chunk):
        d = torch.arange(d0, min(D, d0 + chunk), device=got.device)[:, None, None]
        valid = (r < m[None, None, :]) & (d >= r) & (d - r < n[None, None, :])
        diff = (got[d0 : d0 + chunk].int() - want[d0 : d0 + chunk].int()).abs()
        err = max(err, int((diff * valid).max()))
    if err != 0:
        raise AssertionError(f"move codes disagree on valid cells: max |diff| = {err}")
    return err


def report(name, label, rec):
    steps = ""
    if "ns_per_step" in rec:
        staged = rec["band"] if "band" in rec else f"{rec['tile']} tiles"
        steps = (f"; longest lane {rec['longest_steps']} steps, {rec['ns_per_step']:.1f} ns a "
                 f"step on it, {staged}, {rec['block_lanes']} lanes a block; {CARD}")
    elif "lanes_a_block" in rec:
        steps = (f"; {rec['rows_a_thread']} rows a thread, {rec['warps_a_lane']} warps a "
                 f"lane, {rec['lanes_a_block']} lanes a block, {rec['warps_per_sm']} warps/SM, "
                 f"{rec['cycles_per_step']:.0f} cycles a column step; bound at the "
                 f"instructions the step issues {rec['issued_bound_ms']:.3f} ms")
        if "lanes_curve" in rec:
            steps += "; L curve " + ", ".join(
                f"L={L} {c['ms']:.3f} ms ({c['cycles_per_step']:.0f} cycles)"
                for L, c in rec["lanes_curve"].items())
        if "warps_curve" in rec:
            steps += "; W curve " + ", ".join(
                f"W={W} {c['ms']:.3f} ms ({c['cycles_per_step']:.0f} cycles)"
                for W, c in rec["warps_curve"].items())
        if "warps2_ms" in rec:
            steps += (f"; two warps a lane (2 rows a thread, {rec['warps2_lanes']} lanes a block) "
                      f"{rec['warps2_ms']:.3f} ms, {rec['warps2_cycles_per_step']:.0f} cycles a "
                      f"column step")
        if "rows2_ms" in rec:
            steps += (f"; 2 rows a thread (M=64, the lanes' first 64 rows) "
                      f"{rec['rows2_ms']:.3f} ms, {rec['rows2_cycles_per_step']:.0f} cycles a "
                      f"column step")
    elif "G" in rec:
        steps = (f"; G = {rec['G']} strips a launch (groups {rec.get('groups', '?')}), "
                 f"{rec['strip_ms']:.3f} ms a strip, {rec['warps_per_sm']} warps/SM, "
                 f"{rec['cycles_per_step']:.0f} cycles a column step, moves "
                 f"{rec['moves_gb']:.3f} GB; plain on {rec['checked_cells']} cells of 3 strips")
    elif "group_threads" in rec:
        steps = (f"; g = {rec['group_threads']} threads a lane x r = {rec['band_rows']} rows, "
                 f"{rec['route']} route, {rec['threads']}-thread blocks, {rec['warps_per_sm']} "
                 f"warps/SM, {rec['cycles_per_step']:.0f} cycles a column step; bound at the "
                 f"instructions the scan issues {rec['issued_bound_ms']:.3f} ms")
    elif "cycles_per_step" in rec:
        steps = (f"; {rec['band_rows']}-row bands, {rec['blocks_per_sm']} blocks/SM of "
                 f"{rec['threads']} threads "
                 f"({rec['warps_per_sm']} warps), {rec['waves']:.2f} waves, "
                 f"{rec['cycles_per_step']:.0f} cycles a block step")
    print(f"{name}[{label}] {rec['shape']}: equal; kernel {rec['ms']:.3f} ms, plain "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})"
          + steps)


def walk_case(walk, plain_walk, moves, x_mb, y_bn, i0, j0, steps, clock, reps=10):
    """K3 or K10 (``walk``) against its plain walk on the same move codes,
    with the longest lane's steps, the ns a step on that chain, the band
    segment it gathers and the lanes a block."""
    from parallel_genomeseq_tpu_torch.ops import traceback
    from parallel_genomeseq_tpu_torch.tools.walk_tiles import state_ms

    got = walk(moves, x_mb, y_bn, i0, j0, max_steps=steps)
    want, plain_ms = timed(lambda: plain_walk(moves, x_mb, y_bn, i0, j0, steps))
    B = x_mb.shape[1]
    walked, longest = int(got[3].long().sum()), int(got[3].max())
    sh = traceback.walk_shape(B)
    # CUDA events around each launch with the stream held until it is
    # queued: the launch is shorter than the wrapper's host time.
    rec = {"shape": f"{B} lanes, max_steps={steps}, {walked} steps",
           "max_abs_err": max_abs_err(got, want),
           "ms": state_ms(lambda _: walk(moves, x_mb, y_bn, i0, j0, max_steps=steps), (),
                          reps)[0],
           "plain_ms": plain_ms, "steps": walked, "longest_steps": longest,
           "band": f"{sh['seg_rows']}-row segments of a {2 * sh['band'] + 1}-cell band",
           "block_lanes": sh["lanes"]}
    rec["ns_per_step"] = rec["ms"] * 1e6 / max(1, longest)
    # Read per step: one move code and two sequence bytes; write both
    # (max_steps, B) consensus buffers, and per lane (i0, j0) in, (pos, steps) out.
    rec["bound_ms"], rec["bound_by"] = bound(
        walked * OPS_PER_STEP[walk.__name__], 3 * walked + 2 * steps * B + 16 * B, clock)
    return rec


def dna_kernels(kw):
    """(score sweep, re-run with moves, walk, plain walk) of the DNA path
    under the gaps of ``kw``: K1, K2, K3, or with gap_open K6, K7, K10."""
    from parallel_genomeseq_tpu_torch.ops import traceback, wavefront_cuda

    if "gap_open" in kw:
        return (wavefront_cuda.sw_score_affine, wavefront_cuda.sw_score_affine_moves,
                traceback.walk_moves_affine, traceback._walk_moves_affine_plain)
    return (wavefront_cuda.sw_score, wavefront_cuda.sw_score_moves, traceback.walk_moves,
            traceback._walk_moves_plain)


def dna_config(kw):
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    return ScoringConfig(match=kw["match"], mismatch=kw["mismatch"], gap_penalty=kw["gap"],
                         gap_open=kw.get("gap_open", 0))


def check_kernels(reads, ref, batch: int, clock: float, dev, kw):
    """DNA phase: the score sweep, the re-run with moves and the walk of the
    scoring ``kw`` (K1/K2/K3, or K6/K7/K10) against their plain versions at
    the main path's shapes. Returns {kernel: {case label: measurements}}."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.ops import scan_dp, wavefront_cuda
    from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkConfig, ChunkedAligner
    from parallel_genomeseq_tpu_torch.utils.device import to_host

    score_k, moves_k, walk_k, plain_walk = dna_kernels(kw)
    cfg = dna_config(kw)
    chunked = ChunkedAligner(cfg, chunk=ChunkConfig(npiece=17, overlap_ratio=2.0), device=dev)
    aligner = BatchSWAligner(cfg, device=dev)
    out = {score_k.__name__: {}, moves_k.__name__: {}, walk_k.__name__: {}}
    tag = f"K{'6' if 'gap_open' in kw else '1'} {score_k.__name__}"

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    # The stage-A window sweep, both modes.
    batch_reads = reads[:batch]
    xs, ys, m, n, all_ranges = chunked.window_lanes(batch_reads, ref)
    xs, ys, m, n = on_card(xs, ys, m, n)
    cells, seq_bytes = lane_work(m, n)
    for track_pos in (False, True):
        label = "track_pos" if track_pos else "score_only"
        got = score_k(xs, ys, m, n, track_pos=track_pos, **kw)
        want = scan_dp.sw_score_plain(xs, ys, m, n, track_pos=track_pos, **kw)
        rec = {"shape": f"{xs.shape[0]} lanes, M={xs.shape[1]}, N={ys.shape[1]}",
               "max_abs_err": max_abs_err(got, want),
               "ms": cuda_ms(lambda: score_k(xs, ys, m, n, track_pos=track_pos, **kw), 10),
               "plain_ms": cuda_ms(lambda: scan_dp.sw_score_plain(
                   xs, ys, m, n, track_pos=track_pos, **kw), 1)}
        rec["bound_ms"], rec["bound_by"] = bound(
            cells * OPS_PER_CELL[(score_k.__name__, track_pos)],
            seq_bytes + LANE_BYTES * xs.shape[0], clock)
        rec["issued_bound_ms"] = bound(
            cells * WAVE_ISSUED_PER_CELL[(score_k.__name__, track_pos)],
            seq_bytes + LANE_BYTES * xs.shape[0], clock)[0]
        wave_steps(rec, score_k, xs.shape[1], ys.shape[1], m, n, clock, label)
        out[score_k.__name__][label] = rec
        report(tag, label, rec)

    # The re-run with moves on the winning windows (stage B) and on the full
    # reference.
    tag = f"K{'7' if 'gap_open' in kw else '2'} {moves_k.__name__}"
    (scores,) = to_host([got[0]])
    winner = scores.reshape(len(batch_reads), -1).argmax(axis=1)
    win_refs = [ref[slice(*all_ranges[r][w])] for r, w in enumerate(winner)]
    walk_inputs = None
    for label, refs in (("windows", win_refs), ("npiece1", [ref])):
        xs, ys, m, n = on_card(*aligner.pad_batch(batch_reads, refs))
        got = moves_k(xs, ys, m, n, **kw)
        want = scan_dp.sw_score_moves_plain(xs, ys, m, n, **kw)
        cells, seq_bytes = lane_work(m, n)
        rec = {"shape": f"{xs.shape[0]} lanes, M={xs.shape[1]}, N={ys.shape[1]}",
               "max_abs_err": max(max_abs_err(got[:3], want[:3]), moves_err(got[3], want[3], m, n)),
               "ms": cuda_ms(lambda: moves_k(xs, ys, m, n, **kw), 10),
               "plain_ms": cuda_ms(lambda: scan_dp.sw_score_moves_plain(xs, ys, m, n, **kw), 1)}
        rec["bound_ms"], rec["bound_by"] = bound(
            cells * OPS_PER_CELL[moves_k.__name__],
            seq_bytes + LANE_BYTES * xs.shape[0] + cells, clock)  # + one move byte per cell
        rec["issued_bound_ms"] = bound(cells * WAVE_ISSUED_PER_CELL[moves_k.__name__],
                                       seq_bytes + LANE_BYTES * xs.shape[0] + cells, clock)[0]
        M, N = xs.shape[1], ys.shape[1]
        wave_steps(rec, moves_k, M, N, m, n, clock, "moves")
        # The L curve and two warps a lane (2 rows a thread at M = 128), each
        # held against the plain version too.
        rec["lanes_curve"] = {}
        for L, W in [(L, 0) for L in LANES_CURVE] + [(0, 2)]:
            try:
                wavefront_cuda.launch_shape(M, xs.shape[0], affine="gap_open" in kw,
                                            mode="moves", lanes=L, warps=W)
            except RuntimeError:  # past the block's limit
                continue
            g = moves_k(xs, ys, m, n, lanes=L, warps=W, **kw)
            rec["max_abs_err"] = max(rec["max_abs_err"], max_abs_err(g[:3], want[:3]),
                                     moves_err(g[3], want[3], m, n))
            del g
            c = {"ms": cuda_ms(lambda: moves_k(xs, ys, m, n, lanes=L, warps=W, **kw), 10)}
            wave_steps(c, moves_k, M, N, m, n, clock, "moves", lanes=L, warps=W)
            if W:
                rec.update(warps2_ms=c["ms"], warps2_lanes=c["lanes_a_block"],
                           warps2_cycles_per_step=c["cycles_per_step"])
            else:
                rec["lanes_curve"][L] = {k: c[k] for k in ("ms", "cycles_per_step")}
        if label == "windows":  # fewer rows a thread: the lanes' first 64 rows
            x64, m64 = xs[:, :64].contiguous(), m.clamp(max=64)
            g = moves_k(x64, ys, m64, n, **kw)
            w = scan_dp.sw_score_moves_plain(x64, ys, m64, n, **kw)
            rec["max_abs_err"] = max(rec["max_abs_err"], max_abs_err(g[:3], w[:3]),
                                     moves_err(g[3], w[3], m64, n))
            del g, w
            c = {"ms": cuda_ms(lambda: moves_k(x64, ys, m64, n, **kw), 10)}
            wave_steps(c, moves_k, 64, N, m64, n, clock, "moves")
            rec.update(rows2_ms=c["ms"], rows2_cycles_per_step=c["cycles_per_step"])
        out[moves_k.__name__][label] = rec
        report(tag, label, rec)
        if walk_inputs is None:
            walk_inputs = (got[3], xs.T.contiguous(), ys, got[1], got[2],
                           aligner.max_steps(xs.shape[1], ys.shape[1]))
        del got, want

    # The walk on the re-run's output for the winning windows.
    rec = walk_case(walk_k, plain_walk, *walk_inputs, clock)
    out[walk_k.__name__]["windows"] = rec
    report(f"K{'10' if 'gap_open' in kw else '3'} {walk_k.__name__}", "windows", rec)
    return out


def oracle_columns(read: str, ref: str, gap=2, sub=None, dtype=None):
    """The columns H(., j), j = 1..n, of the Smith-Waterman matrix in numpy,
    one (m+1,) array at a time (the same array, updated in place): the
    in-column north chain H[i] = max(E[i], H[i-1] - gap) is a prefix max of
    E[i] + gap*i (the method of the JAX package's numpy oracle,
    ops/oracle.sw_score_fast, kept here so this script depends only on the
    port). ``sub`` is None for uniform +3/-3 scoring, else a (256, 256) score
    table indexed by byte pair (``byte_pair_scores``)."""
    import numpy as np

    x = np.frombuffer(read.encode(), np.uint8)
    if sub is None:
        column = lambda yb: np.where(x == yb, 3, -3)
    else:
        rows = sub[x]  # (m, 256): the score of x_i against each byte
        column = lambda yb: rows[:, yb]
    h = np.zeros(len(x) + 1, dtype or np.int64)
    gi = gap * np.arange(1, len(x) + 1, dtype=h.dtype)
    for yb in np.frombuffer(ref.encode(), np.uint8):
        e = np.maximum(h[:-1] + column(yb), np.maximum(h[1:] - gap, 0))
        h[1:] = np.maximum.accumulate(e + gi) - gi
        yield h


def oracle_matrix(read: str, ref: str, gap=2, sub=None, dtype=None):
    """The dense (m+1, n+1) matrix of ``oracle_columns``."""
    import numpy as np

    H = np.zeros((len(read) + 1, len(ref) + 1), dtype or np.int64)
    for j, col in enumerate(oracle_columns(read, ref, gap, sub, dtype), 1):
        H[:, j] = col
    return H


def byte_pair_scores(alphabet: str, matrix):
    """(256, 256) int64 scores of every byte pair, by letter from a
    substitution matrix: a pair with a byte outside the alphabet (lowercase
    too) scores the matrix minimum."""
    import numpy as np

    low = int(matrix.min())
    index = {ord(c): k for k, c in enumerate(alphabet)}
    out = np.full((256, 256), low, np.int64)
    for a, ka in index.items():
        for b, kb in index.items():
            out[a, b] = int(matrix[ka][kb])
    return out


def oracle_best(H):
    """(score, i, j) of the first maximum in column-major order."""
    import numpy as np

    j, i = divmod(int(np.argmax(H.T)), H.shape[0])
    return int(H[i, j]), i, j


def oracle_align(read: str, ref: str, gap=2, sub=None, dtype=None):
    """(score, pos, consensus_x, consensus_y): first maximum in column-major
    order, then the greedy NW >= W >= N walk that stops on the first cell with
    a zero neighbour (consensus reversed, '-' for gaps)."""
    H = oracle_matrix(read, ref, gap, sub, dtype)
    score, i, j = oracle_best(H)
    return (score, *oracle_walk(H, read, ref, i, j)) if score > 0 else (score, 0, "", "")


def oracle_walk(H, read: str, ref: str, i: int, j: int):
    """(pos, consensus_x, consensus_y) of the greedy NW >= W >= N walk on the
    dense matrix H from cell (i, j), stopping on the first cell with a zero
    neighbour."""
    cx, cy = [], []
    while True:
        nw, w, no = H[i - 1, j - 1], H[i, j - 1], H[i - 1, j]
        if nw == 0 or w == 0 or no == 0:
            cx.append(read[i - 1])
            cy.append(ref[j - 1])
            return j, "".join(cx), "".join(cy)
        if nw >= w and nw >= no:
            cx.append(read[i - 1])
            cy.append(ref[j - 1])
            i, j = i - 1, j - 1
        elif w >= nw and w >= no:
            cx.append("-")
            cy.append(ref[j - 1])
            j -= 1
        else:
            cx.append(read[i - 1])
            cy.append("-")
            i -= 1


def gotoh(X, y, sub, gap_open: int, gap: int, keep: bool = False):
    """Gotoh's affine-gap local DP in numpy for R rows X (R, m) uint8 against
    y (n,) uint8, one column at a time, with pair scores ``sub`` (256, 256):
    E = max(H_west - open, E_west) - gap, F the same from the north, H =
    max(0, diag + s, E, F). The in-column F chain is a prefix max of A + gap*i
    with A = max(0, diag + s, E), the method of the JAX package's
    oracle.sw_affine_score_fast, kept here so this script depends only on
    the port. Returns per row (best, i, j), the first maximum in column-major
    order; with ``keep`` also H, E, F (R, m + 1, n + 1) with the oracle's
    boundaries (H = 0 on row and column 0, E = F = -2^40 there)."""
    import numpy as np

    R, m = X.shape
    n = len(y)
    neg = -(2**40)
    rows = sub[X]  # (R, m, 256): each x_i's score against every byte
    gi = gap * np.arange(1, m + 1, dtype=np.int64)
    h = np.zeros((R, m + 1), np.int64)  # H of the previous column, row 0 = 0
    e = np.full((R, m), neg, np.int64)  # E of the previous column, rows 1..m
    zero = np.zeros((R, 1), np.int64)
    best = np.zeros(R, np.int64)
    bi = np.zeros(R, np.int64)
    bj = np.zeros(R, np.int64)
    if keep:
        H = np.zeros((R, m + 1, n + 1), np.int64)
        E = np.full((R, m + 1, n + 1), neg, np.int64)
        F = np.full((R, m + 1, n + 1), neg, np.int64)
    for j in range(1, n + 1):
        e = np.maximum(h[:, 1:] - gap_open, e) - gap
        a = np.maximum(np.maximum(h[:, :-1] + rows[:, :, y[j - 1]], e), 0)
        q = np.maximum.accumulate(np.concatenate([zero, a + gi], axis=1), axis=1)
        f = q[:, :-1] - gap_open - gi
        col = np.maximum(a, f)
        cm = col.max(axis=1)
        upd = cm > best
        best = np.where(upd, cm, best)
        bi = np.where(upd, col.argmax(axis=1) + 1, bi)
        bj = np.where(upd, j, bj)
        h[:, 1:] = col
        if keep:
            H[:, 1:, j], E[:, 1:, j], F[:, 1:, j] = col, e, f
    return (best, bi, bj, H, E, F) if keep else (best, bi, bj)


def gotoh_align(x: str, y: str, sub, gap_open: int, gap: int):
    """(score, pos, consensus_x, consensus_y) of x against y: the first
    maximum in column-major order, then the walk of the JAX package's
    oracle.affine_traceback: in H, NW if H = diag + s, else enter E if
    H = E, else F; an E (F) run emits a gap column and continues while
    E(i, j) = E(i, j-1) - gap (F(i, j) = F(i-1, j) - gap); stop in H on a
    zero cell. pos is the j of the last column that used y."""
    import numpy as np

    xb = np.frombuffer(x.encode(), np.uint8)
    yb = np.frombuffer(y.encode(), np.uint8)
    best, bi, bj, H, E, F = (v[0] for v in gotoh(xb[None], yb, sub, gap_open, gap, keep=True))
    score, i, j = int(best), int(bi), int(bj)
    if score <= 0:
        return score, 0, "", ""
    cx, cy = [], []
    state, pos = "H", j
    while True:
        if state == "H":
            if H[i, j] == 0:
                return score, pos, "".join(cx), "".join(cy)
            if H[i, j] == H[i - 1, j - 1] + sub[xb[i - 1], yb[j - 1]]:
                cx.append(x[i - 1])
                cy.append(y[j - 1])
                pos = j
                i, j = i - 1, j - 1
            else:
                state = "E" if H[i, j] == E[i, j] else "F"
        elif state == "E":
            cx.append("-")
            cy.append(y[j - 1])
            pos = j
            extend = E[i, j] == E[i, j - 1] - gap
            j -= 1
            state = "E" if extend else "H"
        else:
            cx.append(x[i - 1])
            cy.append("-")
            extend = F[i, j] == F[i - 1, j] - gap
            i -= 1
            state = "F" if extend else "H"


def uniform_pair_scores(match: int, mismatch: int):
    """(256, 256) int64 scores of uniform scoring over raw bytes."""
    import numpy as np

    return np.where(np.eye(256, dtype=bool), match, mismatch).astype(np.int64)


def check_sampled(reads, ref, rows, results, seed: int, count: int = 32, gap=2, sub=None):
    """DNA check: sampled reads of the timed run against the numpy oracle
    (+3/-3, or the pair scores ``sub``, with linear gap ``gap``). ``rows`` is
    the run's CSV, ``results`` its AlignResults."""
    import numpy as np

    from parallel_genomeseq_tpu_torch.parallel.chunking import make_string_ranges

    picks = np.random.default_rng(seed).choice(len(reads), count, replace=False)
    for k in picks:
        read, res = reads[k], results[k]
        full = int(oracle_matrix(read, ref, gap, sub).max())
        ranges = make_string_ranges(17, len(read), len(ref), 2.0)
        win = int(np.argmax([oracle_matrix(read, ref[l:r], gap, sub).max() for l, r in ranges]))
        left, right = ranges[win]
        score, pos, cx, cy = oracle_align(read, ref[left:right], gap, sub)
        pos = pos + left if pos > 0 else 0
        got = (int(rows[k]["score"]), int(rows[k]["pos_pred"]), int(res.score),
               res.pos, res.consensus_x, res.consensus_y)
        exp = (full, pos, score, pos, cx, cy)
        if got != exp:
            raise AssertionError(f"read {k}: port {got} != oracle {exp}")
    print(f"oracle check: {count} sampled reads of the timed run agree (score over "
          "the full reference; pos and consensus on the winning window)")


def check_sampled_affine(reads, ref, rows, results, seed: int, count: int = 32, sub=None,
                         gaps=None):
    """The affine DNA check: sampled reads (all of one length, so one batch
    of numpy columns) against the Gotoh oracle under BWA-MEM's scoring (or
    the pair scores ``sub`` with ``gaps``) -- the best over the full
    reference, the winning window (first on ties), and on it (score, i, j),
    pos and both consensus strings."""
    import numpy as np

    from parallel_genomeseq_tpu_torch.parallel.chunking import make_string_ranges

    if sub is None:
        sub = uniform_pair_scores(BWA["match"], BWA["mismatch"])
    gap_open, gap = (gaps or BWA)["gap_open"], (gaps or BWA)["gap"]
    picks = np.random.default_rng(seed).choice(len(reads), count, replace=False)
    if len({len(reads[k]) for k in picks}) != 1:
        raise AssertionError("the affine oracle batches reads of one length")
    X = np.stack([np.frombuffer(reads[k].encode(), np.uint8) for k in picks])
    y = np.frombuffer(ref.encode(), np.uint8)
    full = gotoh(X, y, sub, gap_open, gap)[0]
    ranges = make_string_ranges(17, X.shape[1], len(ref), 2.0)
    per_window = np.stack([gotoh(X, y[l:r], sub, gap_open, gap)[0] for l, r in ranges], axis=1)
    for r, k in enumerate(picks):
        left, right = ranges[int(np.argmax(per_window[r]))]
        score, pos, cx, cy = gotoh_align(reads[k], ref[left:right], sub, gap_open, gap)
        pos = pos + left if pos > 0 else 0
        res = results[k]
        got = (int(rows[k]["score"]), int(rows[k]["pos_pred"]), int(res.score),
               res.pos, res.consensus_x, res.consensus_y)
        exp = (int(full[r]), pos, score, pos, cx, cy)
        if got != exp:
            raise AssertionError(f"read {k}: port {got} != Gotoh oracle {exp}")
    gapped = sum("-" in results[k].consensus_x + results[k].consensus_y for k in picks)
    print(f"oracle check: {count} sampled reads of the affine run agree with the Gotoh oracle "
          f"({gapped} of them gapped)")


def dna_run(label, cli, kw, reads, ref, out_csv, card, seed, counters=None, absent=(),
            check=None):
    """Drive the port's solve_small once for ``label`` after a warm-up on
    one batch, with the counts of its kernels (``counters``, by default the
    sweep, re-run and walk of ``kw``) and of ``absent`` set to 0 just before
    the run and read just after: each of ``counters`` must have launched,
    none of ``absent``. Check its output and sampled reads (``check``, by
    default the oracle of ``kw``'s scoring). Returns (the launches, reads/s)."""
    from parallel_genomeseq_tpu_torch.cli import solve_small

    if solve_small.main(cli + ["--limit", cli[cli.index("--batch-size") + 1]]) != 0:  # warm-up
        raise AssertionError(f"solve_small {label} warm-up failed")
    counters = counters or dna_kernels(kw)[:3]
    zero_counts((*counters, *absent))
    run = solve_small.run(cli)
    launches = read_counts(counters)
    others = read_counts(absent)
    if run.rc != 0:
        raise AssertionError(f"solve_small {label} exited {run.rc}")
    print(f"launches during solve_small {label}: {launches}, of other kernels {others}")
    if min(launches.values()) < 1 or any(others.values()):
        raise AssertionError(f"solve_small {label}: launches {launches}, {others}")
    with open(out_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(run.results) != len(reads) or len(rows) != len(reads):
        raise AssertionError(f"expected {len(reads)} results and rows, got "
                             f"{len(run.results)} and {len(rows)}")
    rate = len(reads) / run.seconds
    print(f"solve_small {label}: {rate:.1f} reads/s, "
          f"{run.cells / run.seconds / 1e9:.3f} GCUPS (full-reference cells, "
          f"{run.seconds:.3f} s) on {card}")
    check = check or (check_sampled_affine if "gap_open" in kw else check_sampled)
    check(reads, ref, rows, run.results, seed)
    return launches, rate


def dna_phase(args, card: str, clock: float, dev):
    """Phases 3 and 4. Returns (measurements, launches during each
    solve_small run, its reads/s), each keyed by 'linear' and 'affine', and
    the data (reference and reads paths, reference, reads)."""
    from parallel_genomeseq_tpu_torch.utils.synth import write_dataset

    data = ROOT / "data" / "chip_smoke"
    ref_path, csv_path = write_dataset(
        data, ref_len=4980, n_reads=args.reads, read_len=(125, 125), seed=args.seed
    )
    ref = "".join(l.strip() for l in open(ref_path) if not l.startswith(">"))
    with open(csv_path, newline="") as f:
        reads = [r["SEQ"] for r in csv.DictReader(f)]
    print(f"data: {len(reads)} reads x 125 bp vs {len(ref)}-bp reference (seed {args.seed})")

    measured, launches, rates = {}, {}, {}
    for label, kw, flags in (("linear", LINEAR, []), ("affine", BWA, BWA_FLAGS)):
        print(f"-- DNA short reads, {label} gaps: {kw}")
        measured[label] = check_kernels(reads, ref, args.batch_size, clock, dev, kw)
        out_csv = data / f"align_output_{label}.csv"
        cli = ["--ref", str(ref_path), "--input", str(csv_path), "--output", str(out_csv),
               "--batch-size", str(args.batch_size), "--device", str(dev)] + flags
        launches[label], rates[label] = dna_run(label, cli, kw, reads, ref, out_csv, card,
                                                args.seed)
    return measured, launches, rates, (ref_path, csv_path, ref, reads)


def protein_kernels(gaps):
    """(scan, re-run with moves, walk, plain walk) of the protein path under
    ``gaps``: K4, K5, K3, or with gap_open K8, K9, K10."""
    from parallel_genomeseq_tpu_torch.ops import profile_cuda, traceback

    if "gap_open" in gaps:
        return (profile_cuda.sw_profile_affine, profile_cuda.sw_profile_affine_moves,
                traceback.walk_moves_affine, traceback._walk_moves_affine_plain)
    return (profile_cuda.sw_profile, profile_cuda.sw_profile_moves, traceback.walk_moves,
            traceback._walk_moves_plain)


def check_protein_kernels(db, query: str, clock: float, gaps, stride: int = 1):
    """Protein phase: the scan on the resident slab, and the re-run with
    moves and the walk on the traceback batches, each against its plain
    version, under ``gaps`` (K4/K5/K3, or K8/K9/K10 on the same slab and
    table). The whole-slab launch is held on every ``stride``-th lane.
    Returns {kernel: {case: measurements}}."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.ops import scan_dp, wavefront_cuda
    from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
    from parallel_genomeseq_tpu_torch.utils.device import to_host

    scan_k, moves_k, walk_k, plain_walk = protein_kernels(gaps)
    affine = "gap_open" in gaps
    names = ("K8", "K9", "K10") if affine else ("K4", "K5", "K3")
    dev = db.device
    table, lut = db.engine.table, db.engine.encode_lut
    kw = dict(table=table, **gaps)
    out = {scan_k.__name__: {}, moves_k.__name__: {}, walk_k.__name__: {}}
    q = db.encode_query(query)
    slab, offs, lens = db._slab, db._offs, db._lens

    def scan_case(sl, step=1, qc=q):
        o, n = offs[sl], lens[sl]
        mm = torch.full_like(n, qc.shape[0])
        call = lambda: scan_k(qc, slab, mm, n, y_off=o, **kw)
        got = call()
        ps = slice(None, None, step)
        want, plain_ms = timed(lambda: scan_dp.sw_profile_plain(
            qc, slab, mm[ps], n[ps], y_off=o[ps], **kw))
        cells, _ = lane_work(mm, n)
        rec = {"shape": f"{n.shape[0]} lanes, query {qc.shape[0]} aa, entries "
                        f"{int(n.min())}-{int(n.max())} aa",
               "max_abs_err": max_abs_err([g[ps] for g in got], want), "ms": cuda_ms(call, 3),
               "plain_ms": plain_ms}
        if step > 1:  # held, and the plain version timed, on every step-th lane
            rec["plain_lanes"] = int(n[ps].shape[0])
        # Each entry byte and the query read once (the query counted in m's
        # cells, not its bytes, so take n's bytes and the query once), the
        # lane's offset, lengths and results.
        rec["bound_ms"], rec["bound_by"] = bound(
            cells * OPS_PER_CELL[scan_k.__name__],
            int(n.long().sum()) + qc.shape[0] + (LANE_BYTES + 8) * n.shape[0]
            + table.numel() * 4, clock)
        rec["issued_bound_ms"] = bound(cells * SCAN_ISSUED_PER_CELL[scan_k.__name__], 0,
                                       clock)[0]
        scan_steps(rec, qc.shape[0], n, clock, table.shape[0], affine, shared=True)
        return rec, got

    def per_lane_case(sl):
        """The per-lane form at a batch of solve_uniprot's width: the query
        tiled over the lanes (x (B, M)), the entries padded to a multiple of
        128 (y (B, N)); its results equal the slab scan's on the same lanes."""
        ys, n = scan_dp.gather_lanes(slab, offs[sl], lens[sl])
        ys = torch.nn.functional.pad(ys, (0, -ys.shape[1] % 128))
        xs = q[None, :].repeat(n.shape[0], 1)
        mm = torch.full_like(n, q.shape[0])
        call = lambda: scan_k(xs, ys, mm, n, **kw)
        got = call()
        want, plain_ms = timed(lambda: scan_dp.sw_profile_plain(xs, ys, mm, n, **kw))
        cells, seq_bytes = lane_work(mm, n)
        rec = {"shape": f"{n.shape[0]} lanes, x {tuple(xs.shape)}, y {tuple(ys.shape)}",
               "max_abs_err": max_abs_err(got, want), "ms": cuda_ms(call, 3),
               "plain_ms": plain_ms}
        rec["bound_ms"], rec["bound_by"] = bound(
            cells * OPS_PER_CELL[scan_k.__name__],
            seq_bytes + LANE_BYTES * n.shape[0] + table.numel() * 4, clock)
        rec["issued_bound_ms"] = bound(cells * SCAN_ISSUED_PER_CELL[scan_k.__name__], 0,
                                       clock)[0]
        scan_steps(rec, q.shape[0], n, clock, table.shape[0], affine, shared=False)
        return rec, got

    L = lens.shape[0]
    rec, got = scan_case(slice(0, L), stride)
    out[scan_k.__name__]["db"] = rec
    report(f"{names[0]} {scan_k.__name__}", "db", rec)
    short, long_ = slice(0, min(L, 4096)), slice(max(0, L - 4096), L)
    # The widest scan shape: a seeded 2,048-aa query over the short group.
    q2048 = torch.from_numpy(np.random.default_rng(2048).integers(
        1, table.shape[0], 2048).astype(np.uint8)).to(dev)
    for label, case in (("short_group", lambda: scan_case(short)),
                        ("long_group", lambda: scan_case(long_)),
                        ("per_lane", lambda: per_lane_case(long_)),
                        ("query2048", lambda: scan_case(short, qc=q2048))):
        out[scan_k.__name__][label], got_case = case()
        report(f"{names[0]} {scan_k.__name__}", label, out[scan_k.__name__][label])
        if label == "per_lane" and not all(torch.equal(a, b[long_]) for a, b in zip(got_case, got)):
            raise AssertionError("the per-lane scan disagrees with the slab scan")

    # The re-run with moves (and the walk on its codes) on the batches the
    # traceback runs: the top 10, and 256 of the longest entries. x = entry,
    # y = query, pad_m = 128.
    score = to_host([got[0]])[0]
    top = [db.order[k] for k in np.argsort(-score, kind="stable")[:10]]
    longest = db.order[-256:]
    cfg = blosum_config("blosum50", gap_penalty=gaps["gap"], gap_open=gaps.get("gap_open", 0))
    bat = BatchSWAligner(cfg, pad_m=128, device=dev)
    ncodes = table.shape[0]
    for label, idxs in (("top10", top), ("long256", longest)):
        xs, ys, mm, nn = bat.pad_batch([db.entries[k][1] for k in idxs], [query])
        xs, ys = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
        mm, nn = torch.from_numpy(mm).to(dev), torch.from_numpy(nn).to(dev)
        xc = torch.from_numpy(lut).to(dev)[xs.long()]
        yc = torch.from_numpy(lut).to(dev)[ys.long()]
        B, M, N = xs.shape[0], xs.shape[1], ys.shape[1]
        call = lambda: moves_k(xc, yc, mm, nn, **kw)
        got5 = call()
        want5, plain_ms = timed(lambda: scan_dp.sw_profile_moves_plain(xc, yc, mm, nn, **kw))
        cells, seq_bytes = lane_work(mm, nn)
        rec = {"shape": f"{B} lanes, M={M}, N={N}, moves {got5[3].numel() / 1e9:.3f} GB",
               "max_abs_err": max(max_abs_err(got5[:3], want5[:3]),
                                  moves_err(got5[3], want5[3], mm, nn)),
               "plain_ms": plain_ms}
        # The curves of lanes a block (at the rule's warps a lane) and of
        # warps a lane (at the rule's lanes a block), each launch held
        # against the plain version too.
        rule = wavefront_cuda.launch_shape(M, B, affine=affine, mode="moves", ncodes=ncodes)
        rec["lanes_curve"], rec["warps_curve"] = {}, {}
        for lc, wc, curve in ([(lc, rule["warps"], "lanes_curve") for lc in LANES_CURVE]
                              + [(rule["lanes"], wc, "warps_curve") for wc in (1, 2)]):
            try:
                wavefront_cuda.launch_shape(M, B, affine=affine, mode="moves", lanes=lc,
                                            warps=wc, ncodes=ncodes)
            except RuntimeError:  # past the block's limit, or fewer warps than M needs
                continue
            g = moves_k(xc, yc, mm, nn, lanes=lc, warps=wc, **kw)
            rec["max_abs_err"] = max(rec["max_abs_err"], max_abs_err(g[:3], want5[:3]),
                                     moves_err(g[3], want5[3], mm, nn))
            del g
            c = {"ms": cuda_ms(lambda: moves_k(xc, yc, mm, nn, lanes=lc, warps=wc, **kw), 3)}
            wave_steps(c, moves_k, M, N, mm, nn, clock, "moves", lanes=lc, warps=wc,
                       ncodes=ncodes)
            rec[curve][lc if curve == "lanes_curve" else wc] = {
                k: c[k] for k in ("ms", "cycles_per_step")}
        del want5
        rec["ms"] = cuda_ms(call, 3)
        rec["bound_ms"], rec["bound_by"] = bound(
            cells * OPS_PER_CELL[moves_k.__name__],
            seq_bytes + LANE_BYTES * B + cells + table.numel() * 4, clock)
        rec["issued_bound_ms"] = bound(
            cells * WAVE_ISSUED_PER_CELL[moves_k.__name__],
            seq_bytes + LANE_BYTES * B + cells + table.numel() * 4, clock)[0]
        wave_steps(rec, moves_k, M, N, mm, nn, clock, "moves", ncodes=ncodes)
        out[moves_k.__name__][label] = rec
        report(f"{names[1]} {moves_k.__name__}", label, rec)
        steps = bat.max_steps(xs.shape[1], ys.shape[1])
        out[walk_k.__name__][f"protein_{label}"] = walk_case(
            walk_k, plain_walk, got5[3], xs.T.contiguous(), ys, got5[1], got5[2], steps, clock,
            reps=3)
        report(f"{names[2]} {walk_k.__name__}", f"protein_{label}",
               out[walk_k.__name__][f"protein_{label}"])
        del got5
        torch.cuda.empty_cache()
    return out


def protein_run(label, cli, gaps, entries, query, out_csv, card, seed, counters=None,
                absent=(), planted=None):
    """Drive the port's solve_uniprot once for ``label`` after a warm-up on
    20,000 entries, with the counts of its kernels (``counters``, by default
    the scan, re-run and walk of ``gaps``) and of ``absent`` set to 0 just
    before the run and read just after: each of ``counters`` must have
    launched, none of ``absent``. Then hold the planted copies (``planted``,
    by default gen_protein_db's), the top 10 and 32 sampled entries against
    the numpy oracle (score and pos_end with x = query, y = entry; for the
    top 10 also the walk, pos_pred and both consensus strings with x =
    entry, y = query). Returns the launches."""
    import numpy as np

    from parallel_genomeseq_tpu_torch.cli import solve_uniprot
    from parallel_genomeseq_tpu_torch.ops.substitution import ALPHABET, BLOSUM50

    solve_uniprot.run(cli + ["--limit", "20000"])  # warm-up
    counters = counters or protein_kernels(gaps)[:3]
    zero_counts((*counters, *absent))
    run = solve_uniprot.run(cli)
    launches = read_counts(counters)
    others = {fn.__name__: fn.launches for fn in absent}
    print(f"launches during solve_uniprot {label}: {launches}, of other kernels {others}")
    if run.rc != 0 or min(launches.values()) < 1 or any(others.values()):
        raise AssertionError(f"solve_uniprot {label} rc {run.rc}, launches {launches}, {others}")
    scan = run.scans[0]
    print(f"solve_uniprot {label}: pack+upload {run.prep_seconds:.3f} s, scan "
          f"{scan['seconds']:.3f} s, {scan['cells'] / scan['seconds'] / 1e9:.3f} GCUPS, "
          f"{len(entries) / scan['seconds']:.1f} proteins/s on {card}")

    with open(out_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != len(entries):
        raise AssertionError(f"expected {len(entries)} rows, got {len(rows)}")
    results, tb_rows = scan["results"], scan["tb_rows"]
    sub = byte_pair_scores(ALPHABET, BLOSUM50)
    step = max(1, len(entries) // 8)
    planted = list(planted if planted is not None
                   else (k for k in range(len(entries)) if k % step == 3))
    top = sorted(range(len(entries)), key=lambda k: -results[k][0])[:10]
    sampled = np.random.default_rng(seed).choice(len(entries), 32, replace=False)
    qb = np.frombuffer(query.encode(), np.uint8)
    for k in sorted(set(planted) | set(top) | set(int(s) for s in sampled)):
        if "gap_open" in gaps:
            best, _, bj = gotoh(qb[None], np.frombuffer(entries[k][1].encode(), np.uint8), sub,
                                gaps["gap_open"], gaps["gap"])
            score, j = int(best[0]), int(bj[0])
        else:
            score, _, j = oracle_best(oracle_matrix(query, entries[k][1], gaps["gap"], sub))
        got = (int(rows[k]["score"]), int(rows[k]["pos_end"]), *results[k])
        if got != (score, j, score, j):
            raise AssertionError(f"entry {k}: port (score, pos_end) {got} != oracle {(score, j)}")
    for k in top:
        if "gap_open" in gaps:
            want = gotoh_align(entries[k][1], query, sub, gaps["gap_open"], gaps["gap"])
        else:
            want = oracle_align(entries[k][1], query, gaps["gap"], sub)
        got = (int(rows[k]["score"]), int(rows[k]["pos_pred"]), rows[k]["consensus_x"],
               rows[k]["consensus_y"])
        if got != want or tb_rows[k] != want[1:]:
            raise AssertionError(f"entry {k}: port walk {got} != oracle {want}")
    if not all(results[k][0] > 100 for k in planted):
        raise AssertionError("a planted copy of the query scored low")
    print(f"oracle check ({label}): {len(planted)} planted, top 10 and 32 sampled entries of "
          "the timed run agree (score, pos_end; pos_pred and consensus for the top 10)")
    return launches


def protein_phase(args, card: str, clock: float, dev):
    """Phase 5. Returns (measurements, launches during each solve_uniprot
    run), both keyed by 'linear' and 'affine', the database's entries, and
    the query, the database's path and each run's CSV path."""
    import torch

    from parallel_genomeseq_tpu_torch.models.protein_db import ResidentProteinDB
    from parallel_genomeseq_tpu_torch.seqio.uniprot import iter_database
    from parallel_genomeseq_tpu_torch.utils.synth import write_protein_dataset

    data = ROOT / "data" / "chip_smoke" / "protein"
    t0 = time.perf_counter()
    query_path, db_path, query = write_protein_dataset(
        data, n_entries=args.entries, query_len=145, seed=args.protein_seed)
    entries = list(iter_database(db_path))
    residues = sum(len(s) for _, s in entries)
    print(f"protein data: {len(entries)} entries, {residues} residues "
          f"(slab {residues / 1e6:.1f} MB), query {len(query)} aa (seed "
          f"{args.protein_seed}), generated and read in {time.perf_counter() - t0:.2f} s")

    # One resident slab for both gap models' kernel checks: the codes and
    # the BLOSUM50 table are the same, the gaps are the kernels' arguments.
    db = ResidentProteinDB(entries, matrix="blosum50", gap_penalty=12.0, gap_open=0.0,
                           device=dev)
    measured = {"linear": check_protein_kernels(db, query, clock, PROTEIN_LINEAR, stride=4)}
    print(f"-- protein scan, affine gaps: {PROTEIN_AFFINE}")
    measured["affine"] = check_protein_kernels(db, query, clock, PROTEIN_AFFINE, stride=16)
    del db
    torch.cuda.empty_cache()

    launches, csvs = {}, {}
    base = ["--query", str(query_path), "--database", str(db_path), "--matrix", "blosum50",
            "--batch-size", "4096", "--pad-mult", "128", "--top", "10", "--device", str(dev)]
    for label, gaps, flags in (
        ("linear", PROTEIN_LINEAR, ["--gap-penalty", "12"]),
        ("affine", PROTEIN_AFFINE, ["--gap-open", "10", "--gap-penalty", "2"]),
    ):
        out_csv = csvs[label] = data / f"uniprot_output_{label}.csv"
        launches[label] = protein_run(label, base + flags + ["--output", str(out_csv)], gaps,
                                      entries, query, out_csv, card, args.protein_seed)
    return measured, launches, entries, (query, db_path, csvs)


def mutated_reads(reads, seed: int):
    """Each read with about 1% substitutions and three 1-3 bp indels at
    random places, so that the walks take gaps across strip edges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for read in reads:
        seg = np.frombuffer(read.encode(), np.uint8).copy()
        subs = rng.random(seg.shape[0]) < 0.01
        seg[subs] = rng.choice(acgt, int(subs.sum()))
        for _ in range(3):
            size, at = int(rng.integers(1, 4)), int(rng.integers(20, seg.shape[0] - 20))
            if rng.random() < 0.5:
                seg = np.concatenate([seg[:at], rng.choice(acgt, size), seg[at:]])
            else:
                seg = np.concatenate([seg[:at], seg[at + size :]])
        out.append(seg.tobytes().decode())
    return out


def strip_kernels(kw):
    """(names, (sweep, checkpointing sweep, group replay, group walk), their
    plain versions) of the long-read path under the scoring of
    ``kw``, from the engines' table: K11-K14, with gap_open K15-K18, with a
    table K19-K21 and K14, with both K22-K24 and K18."""
    from parallel_genomeseq_tpu_torch.ops import engine

    affine, uniform = "gap_open" in kw, "table" not in kw
    names = {(False, True): ("K11", "K12", "K13", "K14"),
             (True, True): ("K15", "K16", "K17", "K18"),
             (False, False): ("K19", "K20", "K21", "K14"),
             (True, False): ("K22", "K23", "K24", "K18")}[affine, uniform]
    return names, engine.STRIP_KERNELS[affine, uniform], engine.STRIP_PLAIN[affine, uniform]


def strip_counters(kw):
    """The launch counts a strip traceback under ``kw`` runs through: the
    sweep, the checkpointing sweep, the replay kernel and the walk kernel
    (their per-strip wrappers' counts, which every launch of the kernel
    adds to; the walk's ``strips`` counts the strips it walked), then the
    group replay's own count."""
    sweep, ckpt, group, walk = strip_kernels(kw)[1]
    return sweep, ckpt, replay_pair(group)[0], walk_pair(walk)[0], group


def zero_counts(fns):
    """Set the launch counts of ``fns`` (and the strip walks' ``strips``) to 0."""
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "strips"):
            fn.strips = 0


def read_counts(fns):
    """{name: launches} of ``fns``, and {name}_strips for the strip walks."""
    out = {fn.__name__: fn.launches for fn in fns}
    out.update({f"{fn.__name__}_strips": fn.strips for fn in fns if hasattr(fn, "strips")})
    return out


def check_groups(label, launches, counters):
    """Raise unless a run's strip traceback went a replay group at a time:
    fewer group replay launches than strips walked (groups of G >= 2), and
    one walk launch a group."""
    group, walk = counters[4].__name__, counters[3].__name__
    strips = launches[f"{walk}_strips"]
    print(f"solve_big/solve_uniprot {label}: {launches[group]} group replay launches and "
          f"{launches[walk]} walk launches for {strips} walked strips")
    if not launches[group] < strips:
        raise AssertionError(f"{label}: the replay ran a strip a launch")
    if launches[walk] != launches[group]:
        raise AssertionError(f"{label}: {launches[walk]} walk launches for {launches[group]} "
                             "replay groups")


def check_strip_kernels(reads, ref, clock: float, dev, kw, cfg=None, prefix: str = ""):
    """Long-read phase under the scoring of ``kw``: the sweep (K11, or K15;
    the 1,400-lane window sweep, held on one read's 14 lanes; and every lane
    of a reduced 1,400 x 2,304 x 4,608 shape), the checkpointing sweep (K12,
    K16; the 100 winners, held on 4), the replay and the walk (K13 and K14,
    K17 and K18; the top, a middle and the bottom strip of the winners'
    traceback, the replay held on every 4th lane, the walk on every lane)
    against their plain versions at the main path's shapes. Under a
    substitution matrix (``cfg``, and kw's table key; K19-K21 and K14, or
    K22-K24 and K18) the same at ``solve_big --matrix``'s shapes, the
    kernels on compact codes and the walk on the raw bytes; the long-query
    phase holds the reduced shape itself. Returns {kernel: {prefix + case:
    measurements}}."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkConfig, ChunkedAligner

    names, (sweep, ckpt, replay, walk), (plain_sweep, plain_ckpt, plain_replay, plain_walk) = \
        strip_kernels(kw)
    affine = "gap_open" in kw
    out = {fn.__name__: {} for fn in (sweep, ckpt, replay_pair(replay)[0], walk_pair(walk)[0])}
    cfg = cfg or dna_config(kw)
    chunked = ChunkedAligner(cfg, chunk=ChunkConfig(npiece=2 * BIG["npiece"],
                                                    overlap_ratio=BIG["overlap"]), device=dev)
    table_bytes = 0
    if "table" in kw:  # raw bytes -> compact codes, as the engine scores them
        kw = dict(kw, table=chunked.engine.table)
        table_bytes = kw["table"].numel() * 4
        lut = torch.from_numpy(chunked.engine.encode_lut).to(dev)
        codes = lambda a: lut[a.long()]
    else:
        codes = lambda a: a

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def sweep_case(label, xs, ys, m, n, held):
        """The sweep on every lane, held against the plain sweep on lanes
        ``held``."""
        got = sweep(xs, ys, m, n, **kw)
        want, plain_ms = timed(lambda: plain_sweep(xs[held], ys[held], m[held], n[held], **kw))
        cells, seq_bytes = lane_work(m, n)
        rec = {"shape": f"{xs.shape[0]} lanes, M={xs.shape[1]}, N={ys.shape[1]}",
               "max_abs_err": max_abs_err([g[held] for g in got], want),
               "ms": cuda_ms(lambda: sweep(xs, ys, m, n, **kw), 3), "plain_ms": plain_ms,
               "plain_lanes": int(m[held].shape[0])}
        rec["bound_ms"], rec["bound_by"] = bound(
            cells * OPS_PER_CELL[sweep.__name__],
            seq_bytes + LANE_BYTES * xs.shape[0] + table_bytes, clock)
        sweep_steps(sweep, rec, xs.shape[1], n, clock, kw.get("table"))
        out[sweep.__name__][prefix + label] = rec
        report(f"{names[0]} {sweep.__name__}", prefix + label, rec)
        return got

    # The stage-A window sweep: 100 reads x 14 windows at full width.
    xs, ys, m, n, all_ranges = chunked.window_lanes(reads, ref)
    xs, ys, m, n = on_card(xs, ys, m, n)
    got = sweep_case("sweep", codes(xs), codes(ys), m, n, slice(0, 2 * BIG["npiece"]))
    scores = got[0].cpu().numpy().reshape(len(reads), -1)
    del xs, ys
    if "table" not in kw:
        # A reduced shape whose every lane the plain sweep can hold: each
        # read's first 2,304 bases against 14 windows of 4,608.
        rng = np.random.default_rng(1)
        lanes = [(r, int(rng.integers(0, len(ref) - 4608))) for r in range(len(reads))
                 for _ in range(2 * BIG["npiece"])]
        xr = np.stack([np.frombuffer(reads[r][:2304].encode(), np.uint8) for r, _ in lanes])
        yr = np.stack([np.frombuffer(ref[o : o + 4608].encode(), np.uint8) for _, o in lanes])
        xr, yr, mr, nr = on_card(xr, yr, np.full(len(lanes), 2304, np.int32),
                                 np.full(len(lanes), 4608, np.int32))
        sweep_case("reduced", xr, yr, mr, nr, slice(None))
        del xr, yr

    # The winner re-run: the checkpointing sweep on the 100 winning windows,
    # held on 4 lanes.
    winner = scores.argmax(axis=1)
    win_refs = [ref[slice(*all_ranges[r][w])] for r, w in enumerate(winner)]
    aligner = BatchSWAligner(cfg, device=dev)
    x_raw, y_raw, m, n = on_card(*aligner.pad_batch(reads, win_refs))
    xs, ys = codes(x_raw), codes(y_raw)
    got = ckpt(xs, ys, m, n, **kw)
    held = slice(0, 4)
    want, plain_ms = timed(lambda: plain_ckpt(xs[held], ys[held], m[held], n[held], **kw))
    cells, seq_bytes = lane_work(m, n)
    ck_bytes = sum(c.numel() * 4 for c in got[3:])  # H (and F) checkpoint planes
    rec = {"shape": f"{xs.shape[0]} lanes, M={xs.shape[1]}, N={ys.shape[1]}, checkpoints "
                    f"{ck_bytes / 1e9:.3f} GB",
           "max_abs_err": max_abs_err([g[held] for g in got], want), "plain_ms": plain_ms,
           "plain_lanes": 4}
    del want
    rec["ms"] = cuda_ms(lambda: ckpt(xs, ys, m, n, **kw), 3)
    rec["bound_ms"], rec["bound_by"] = bound(
        cells * OPS_PER_CELL[ckpt.__name__],
        seq_bytes + LANE_BYTES * xs.shape[0] + ck_bytes + table_bytes, clock)
    sweep_steps(ckpt, rec, xs.shape[1], n, clock, kw.get("table"))
    out[ckpt.__name__][prefix + "winners"] = rec
    report(f"{names[1]} {ckpt.__name__}", prefix + "winners", rec)

    # The replay and the walk through every strip of the winners' traceback,
    # top first; held against the plain replay (on every 4th lane) and walk
    # on the top, a middle and the bottom strip.
    check_strip_traceback(names[2:], (replay, walk), (plain_replay, plain_walk), xs, ys, m, n,
                          kw, got, x_raw, y_raw, aligner.max_steps(xs.shape[1], ys.shape[1]),
                          clock, out, affine, prefix=prefix, lane_step=4)
    torch.cuda.empty_cache()
    return out


def replay_pair(group):
    """(the per-strip wrapper, its plain version) of a group replay: the
    G = 1 launch of the same kernel, whose ``launches`` counts every launch
    of it, the group's too."""
    from parallel_genomeseq_tpu_torch.ops import scan_dp, strips_cuda

    name = group.__name__.removesuffix("_group")
    return getattr(strips_cuda, name), getattr(scan_dp, f"{name}_plain")


def walk_pair(group_walk):
    """(the per-strip wrapper, its plain version) of a group walk (K14,
    K18): the G = 1 launch of the same kernel, whose ``launches`` and
    ``strips`` count every launch of it, the group's too."""
    from parallel_genomeseq_tpu_torch.ops import traceback

    affine = group_walk.__name__.endswith("_affine")
    return ((traceback.walk_strip_level_affine, traceback._walk_strip_affine_plain) if affine
            else (traceback.walk_strip_level, traceback._walk_strip_plain))


# The group sizes the replay is timed at beside the rule's (``PERF.md``'s
# G-versus-time curve).
REPLAY_CURVE = (4, 8, 16)
# The columns of a strip the plain replay replays to hold the replay kernels
# on (their first ones; ~1/8 of solve_big's 20,736).
PLAIN_REPLAY_COLS = 2560


def check_strip_traceback(names, fns, plains, xs, ys, m, n, kw, swept, x_walk, y_walk,
                          steps_cap: int, clock: float, out, affine: bool = False, prefix="",
                          lane_step: int = 1):
    """The group replay and the group walk (``fns``: K13 and K14, K17 and
    K18, K21 and K14, or K24 and K18) through every strip of a strip
    traceback, as the engine runs them: groups of G strips by
    ``strips_cuda.replay_group`` from the top, one moves buffer, one replay
    and one walk launch a group, from the checkpointing sweep's output
    ``swept`` = (score, i, j, H checkpoints[, F checkpoints]). The first
    group's replay is timed (and at the G of REPLAY_CURVE), and its top,
    middle and bottom strips are held against the plain per-strip replay on
    every ``lane_step``-th lane (lanes are independent) and the first lane
    that reaches the top strip, on every cell the walk can read among the
    first PLAIN_REPLAY_COLS columns, and its right edges by ``replay_edges``
    (the real launch is then made again for the walk); the per-strip wrapper (the same kernel at G = 1, every
    column) is held and timed on those strips too. The first group's walk is
    held on every lane against the plain per-strip walks (``walk_pair``)
    over the group's strips, top first, and timed by CUDA events
    (``state_ms``); its per-strip launch (G = 1) is held against the plain
    walk and timed on the top, middle and bottom strips. xs, ys are what
    the replay scores (compact codes under a matrix), x_walk, y_walk the
    bytes the walk emits. Measurements go to out[kernel][prefix + label]:
    each kernel's group under 'group', the per-strip launches under 'top',
    'middle' and 'bottom'."""
    import torch

    from parallel_genomeseq_tpu_torch.ops import scan_dp, strips_cuda, traceback

    S = scan_dp.STRIP_S
    group, group_walk = fns
    replay, plain_replay = replay_pair(group)
    walk, plain_walk = walk_pair(group_walk)
    dev = xs.device
    _, i, j, *ck = swept
    B, M = xs.shape
    N = ys.shape[1]
    x_mb = x_walk.T.contiguous()
    state = traceback.new_strip_state(i, j, steps_cap, affine=affine)
    cur, active = state[0], state[3]
    nstrips = -(-M // S)
    ncodes = kw["table"].shape[0] if "table" in kw else 0
    table_bytes = kw["table"].numel() * 4 if "table" in kw else 0
    r = torch.arange(S, device=dev)
    moves, groups = None, []
    while True:
        lanes, top = torch.stack([active.sum(),
                                  torch.where(active, cur - 1, -1).max().long()]).tolist()
        if not lanes or top < 0:
            break
        s = top // S
        G = strips_cuda.replay_group(s + 1, lanes, B * N * S, dev, affine=affine, ncodes=ncodes,
                                     held=moves.numel() if moves is not None else 0)
        if moves is None:
            moves = torch.empty((G, B, N, S), dtype=torch.uint8, device=dev)
        G = min(G, moves.shape[0])
        low = s - G + 1
        walk_state = (cur, state[1], active)
        call = lambda g=G, lo=s - G + 1: group(xs, ys, m, n, *ck, lo, moves[:g], walk_state, **kw)
        if groups:
            call()
            group_walk(moves[:G], x_mb, y_walk, low, state, max_steps=steps_cap)
            groups.append(G)
            continue
        # The first group: timed, then held.
        checked = {low: "bottom", low + G // 2: "middle", s: "top"}  # top wins a tie
        # Every lane_step-th lane, and the first lane whose walk reads the top strip.
        reach_top = torch.nonzero(active & (cur - 1 >= s * S)).flatten()[:1]
        held = torch.unique(torch.cat([torch.arange(0, B, lane_step, device=dev), reach_top]))
        wants = {}
        rec = replay_group_case(group, xs, ys, m, n, ck, kw, walk_state, low, G, call, clock,
                                table_bytes)
        out[replay.__name__][prefix + "group"] = rec
        for g in REPLAY_CURVE:
            if g <= min(s + 1, moves.shape[0]) and g != G:
                ms = cuda_ms(lambda g=g: call(g, s - g + 1), 3)
                rec[f"g{g}_ms"], rec[f"g{g}_strip_ms"] = ms, ms / g
        print(f"{names[0]} {group.__name__}[{prefix}group] G-versus-time: "
              + ", ".join(f"G = {g}: {rec[f'g{g}_ms']:.3f} ms ({rec[f'g{g}_strip_ms']:.3f} "
                          "a strip)" for g in REPLAY_CURVE if f"g{g}_ms" in rec)
              + f", G = {G} (rule): {rec['ms']:.3f} ms ({rec['strip_ms']:.3f} a strip)")
        call()
        at_launch = tuple(a.clone() for a in walk_state)  # what the launch read
        groups.append(G)
        for t, label in sorted(checked.items(), reverse=True):
            label = prefix + label
            rows = [c[:, t - 1] if t else None for c in ck]
            # The plain replay is a loop over columns: it replays the first
            # PLAIN_REPLAY_COLS columns of the held lanes (a column's codes
            # depend only on the columns to its left, so they are the full
            # replay's), and the kernels are held on those columns.
            C = min(N, PLAIN_REPLAY_COLS)
            mh, nh = m[held], n[held].clamp(max=C)
            want, plain_ms = timed(lambda: plain_replay(
                xs[held], ys[held, :C].contiguous(), mh, nh,
                *[row if row is None else row[held, :C].contiguous() for row in rows],
                t * S, **kw))
            valid = (((t * S + r)[None, None, :] < mh[:, None, None])
                     & (torch.arange(C, device=dev)[None, :, None] < nh[:, None, None]))
            # The group's strip on the cells the walk can read.
            i0, j0, active0 = (a[held] for a in at_launch)
            readable = valid & ((active0 & (i0 - 1 >= t * S))[:, None, None]
                                & (torch.arange(C, device=dev)[None, :, None]
                                   < torch.minimum(nh, j0)[:, None, None]))
            err = int((moves[t - low][held][:, :C][readable].int()
                       - want[readable].int()).abs().max()) if bool(readable.any()) else 0
            one = replay(xs, ys, m, n, *rows, t * S, **kw)  # the G = 1 launch, every column
            err = max(err, int((one[held][:, :C][valid].int() - want[valid].int()).abs().max()))
            if err:
                raise AssertionError(f"{names[0]} strip {t}: move codes differ on valid cells")
            rec["plain_ms"] += plain_ms
            rec["checked_cells"] += int(readable.sum())
            wants[t] = want
            del valid, readable
            lanes_rows = (m - t * S).clamp(0, S).long()
            cells = int((lanes_rows * n.long()).sum())
            one_rec = {"shape": f"strip {t} of {nstrips}, {B} lanes, N={N}, G = 1, moves "
                                f"{one.numel() / 1e9:.3f} GB", "max_abs_err": err,
                       "ms": cuda_ms(lambda: replay(xs, ys, m, n, *rows, t * S, **kw), 3),
                       "plain_ms": plain_ms}
            del one
            if lane_step > 1:
                one_rec["plain_lanes"] = int(mh.shape[0])
            one_rec["plain_cols"] = C
            # Read the strip's read bytes, the references and the checkpoint
            # row(s) (and a table); write one move byte per cell.
            one_rec["bound_ms"], one_rec["bound_by"] = bound(
                cells * OPS_PER_CELL[replay.__name__],
                int(lanes_rows.sum()) + int(n.long().sum()) * (1 + 4 * len(ck) if t else 1)
                + cells + table_bytes, clock)
            out[replay.__name__][label] = one_rec
            report(f"{names[0]} {replay.__name__}", label, one_rec)
        rec.update(replay_edges(names[0], group, xs, ys, m, n, ck, kw, low, moves[:G], at_launch,
                                held, wants, C))
        del wants
        call()  # the walk reads the real launch's bytes
        walk_group_case(names[1], walk, plain_walk, group_walk, moves[:G], x_mb, y_walk, low,
                        state, steps_cap, checked, clock, out, affine, prefix)
    out[replay.__name__][prefix + "group"]["groups"] = "+".join(map(str, groups))
    report(f"{names[0]} {group.__name__}", prefix + "group", out[replay.__name__][prefix + "group"])
    # Every walk ended: it stopped, or (affine) ran through row 1, which
    # leaves a lane active at i = 0, in no strip.
    if bool((state[3] & (state[0] > 0)).any()):
        raise AssertionError("a lane's walk did not end at the bottom strip")
    return state


def replay_edges(name, group, xs, ys, m, n, ck, kw, low: int, moves, at_launch, held, wants,
                 C: int):
    """The group replay's right edges, which lie past the C columns the plain
    replay holds on solve_big's data. The launch replays columns 1 ..
    min(n_b, j) of the lanes the walk reaches (walk state (i, j, active) =
    ``at_launch``), and with no walk state columns 1 .. n_b. It is launched
    again at the same shapes, into ``moves`` filled with 0xFF (no move code:
    bits 0-4), once with every lane's n and walk j moved inside the window
    and once with those n and no walk state. On each checked strip
    (``wants``: strip -> the plain replay's codes of the ``held`` lanes on C
    columns) every held lane is held: below its edge the codes equal the
    plain ones on the read's rows, and no byte at or past its edge, nor of a
    lane the walk does not reach, is written. The moved edges are drawn so
    that j binds in a third of the held lanes, n in a third, and the two tie
    in the rest; the first held lane's sit on column C. Fails when a strip has no held lane
    with its edge in the window, or no strip a j-bound or an n-bound one.
    Returns the counts of held lanes with their edge in the window: in the
    real launch, and moved (j-bound, n-bound). Leaves ``moves`` for the
    caller to rewrite."""
    import torch

    from parallel_genomeseq_tpu_torch.ops import scan_dp

    S = scan_dp.STRIP_S
    dev = xs.device
    B, N = ys.shape
    i0, j0, active0 = at_launch
    gen = torch.Generator().manual_seed(16)
    e = torch.randint(1, C // 2 + 1, (B,), generator=gen)
    d = torch.randint(1, C // 2 + 1, (B,), generator=gen)
    kind = torch.zeros(B, dtype=torch.long)  # 0: tied, 1: j binds, 2: n binds
    kind[held.cpu()] = torch.arange(held.numel()) % 3
    j_e = torch.where(kind == 2, e + d, e)
    n_e = torch.where(kind == 1, e + d, e)
    j_e[int(held[0])] = n_e[int(held[0])] = C
    j_e = j_e.to(device=dev, dtype=j0.dtype)
    n_e = torch.minimum(n_e.to(device=dev, dtype=n.dtype), n)
    cols = torch.arange(N, device=dev)[None, :, None]
    rows = torch.arange(S, device=dev)
    mh = m[held][:, None, None]
    counts = dict(edge_lanes_real=0, edge_lanes_moved=0, edge_lanes_j=0, edge_lanes_n=0)
    for walk in ((i0, j_e, active0), None):
        moves.fill_(0xFF)
        group(xs, ys, m, n_e, *ck, low, moves, walk, **kw)
        for t, want in sorted(wants.items(), reverse=True):
            reach = active0 & (i0 - 1 >= t * S)
            edge = n_e if walk is None else torch.where(reach, torch.minimum(n_e, j_e), 0)
            eh = edge[held]
            got = moves[t - low][held]
            written = cols < eh[:, None, None]
            on_read = written[:, :C] & ((t * S + rows)[None, None, :] < mh)
            if (bool((got[:, :C][on_read] != want[on_read]).any())
                    or bool((torch.where(written, 0xFF, got) != 0xFF).any())):
                raise AssertionError(f"{name} {group.__name__} strip {t}: the launch with moved "
                                     f"edges ({'walk state' if walk else 'every column'}) "
                                     "differs from the plain codes or wrote past an edge")
            lanes = int((eh > 0).sum())
            if walk is None:
                print(f"{name} {group.__name__} strip {t} right edge n_b, no walk state: "
                      f"{lanes} held lanes equal below it, nothing written past it")
                continue
            real = int((reach & (torch.minimum(n, j0) <= C))[held].sum())
            j_bound = int(((eh > 0) & (j_e < n_e)[held]).sum())
            n_bound = int(((eh > 0) & (n_e < j_e)[held]).sum())
            print(f"{name} {group.__name__} strip {t} right edge min(n_b, j): {real} held lanes "
                  f"have it in the {C} compared columns in the launch; moved inside them, "
                  f"{lanes} held lanes ({j_bound} j-bound, {n_bound} n-bound) equal below it, "
                  "nothing written past it")
            if not lanes:
                raise AssertionError(f"{name} strip {t}: no held lane has its edge in the window")
            counts["edge_lanes_real"] += real
            counts["edge_lanes_moved"] += lanes
            counts["edge_lanes_j"] += j_bound
            counts["edge_lanes_n"] += n_bound
    if not counts["edge_lanes_j"] or not counts["edge_lanes_n"]:
        raise AssertionError(f"{name} {group.__name__}: the moved edges missed a kind: {counts}")
    return counts


def walk_record(walk, pre, post, ms, plain_ms, err, shape, clock, affine):
    """A walk launch's record: its time and the plain version's, the steps
    its lanes took from ``pre`` to ``post`` (the longest lane's, and the ns a
    step on that chain), its tile shape and lanes a block, and its bound."""
    from parallel_genomeseq_tpu_torch.ops import traceback

    taken = post[4] - pre[4]
    walked, longest = int(taken.sum()), int(taken.max())
    B = taken.shape[0]
    sh = traceback.walk_shape(B)
    rec = {"shape": f"{shape}, {B} lanes, {walked} steps", "ms": ms, "plain_ms": plain_ms,
           "max_abs_err": err, "steps": walked, "longest_steps": longest,
           "ns_per_step": ms * 1e6 / max(1, longest),
           "tile": f"{sh['tile_rows']}x{sh['tile_cols']}", "block_lanes": sh["lanes"]}
    # Per step read one move code and two sequence bytes, write two
    # consensus bytes; per lane the state in and out (i, j, pos, steps, the
    # active flag, and affine the gap state).
    rec["bound_ms"], rec["bound_by"] = bound(
        walked * OPS_PER_STEP[walk.__name__], 5 * walked + 2 * (21 if affine else 17) * B, clock)
    return rec


def walk_group_case(name, walk, plain_walk, group_walk, moves, x_mb, y_walk, low: int, state,
                    steps_cap: int, checked, clock: float, out, affine: bool, prefix: str):
    """The first group's walk: the plain per-strip walks over its G strips
    (moves (G, B, N, S)), top first, from ``state`` on a copy; on the
    ``checked`` strips ({strip: label}) the per-strip launch (G = 1) held
    against the plain walk from the same state and timed; then the group
    walk (one launch) timed from ``state`` (``walk_tiles.state_ms``: CUDA
    events around each of 10 launches, the state restored between them),
    run on it, and held on every lane against the plain walks' end state."""
    import torch

    from parallel_genomeseq_tpu_torch.ops import scan_dp
    from parallel_genomeseq_tpu_torch.tools.walk_tiles import state_ms

    S = scan_dp.STRIP_S
    G = moves.shape[0]
    pre = tuple(a.clone() for a in state)
    plain_state = tuple(a.clone() for a in state)
    plain_total = 0.0
    for g in range(G - 1, -1, -1):
        t = low + g
        if t not in checked:
            _, ms = timed(lambda: plain_walk(moves[g], x_mb, y_walk, t * S, plain_state,
                                             steps_cap))
            plain_total += ms
            continue
        before = tuple(a.clone() for a in plain_state)
        probe = tuple(a.clone() for a in before)
        walk(moves[g], x_mb, y_walk, t * S, probe, max_steps=steps_cap)
        _, plain_ms = timed(lambda: plain_walk(moves[g], x_mb, y_walk, t * S, plain_state,
                                               steps_cap))
        plain_total += plain_ms
        err = max_abs_err(probe, plain_state)
        ms = state_ms(lambda st: walk(moves[g], x_mb, y_walk, t * S, st, max_steps=steps_cap),
                      before, 10)[0]
        rec = walk_record(walk, before, plain_state, ms, plain_ms, err, f"strip {t}, G = 1",
                          clock, affine)
        out[walk.__name__][prefix + checked[t]] = rec
        report(f"{name} {walk.__name__}", prefix + checked[t], rec)
    ms = state_ms(lambda st: group_walk(moves, x_mb, y_walk, low, st, max_steps=steps_cap), pre,
                  10)[0]
    group_walk(moves, x_mb, y_walk, low, state, max_steps=steps_cap)
    err = max_abs_err(state, plain_state)
    rec = walk_record(walk, pre, state, ms, plain_total, err,
                      f"strips {low}-{low + G - 1}, G = {G}, one launch", clock, affine)
    rec.update(G=G, strip_ms=ms / G)
    out[walk.__name__][prefix + "group"] = rec
    report(f"{name} {group_walk.__name__}", prefix + "group", rec)
    torch.cuda.synchronize()


def replay_group_case(group, xs, ys, m, n, ck, kw, walk_state, low: int, G: int, call,
                      clock: float, table_bytes: int):
    """The first group's launch (``call``, strips low .. low + G - 1) timed,
    with its shape, and its bound counted on the cells it computes: the rows
    of each (lane, strip) pair the walk reaches times min(n_b, j). Also the
    replay's warps an SM (the CUDA occupancy calculator) and the cycles a
    warp's column step takes, ms x clock over the pairs' column steps
    (min(n_b, j) + 31 each) spread over the card's resident warp slots.
    The held cells and the plain time are added as the group's strips are
    checked. Returns the record, stored under its kernel's 'group' case by
    the caller's ``out``."""
    import torch

    from parallel_genomeseq_tpu_torch.ops import scan_dp, strips_cuda

    S = scan_dp.STRIP_S
    B, N = ys.shape
    cur, wj, active = walk_state
    base = (low + torch.arange(G, device=xs.device)) * S
    reached = active[None] & (cur[None] - 1 >= base[:, None])  # (G, B)
    cols = torch.where(reached, torch.minimum(n.clamp(max=N), wj)[None].clamp(min=0), 0).long()
    rows = (m.clamp(max=xs.shape[1])[None] - base[:, None]).clamp(0, S).long()
    cells = int((rows * cols).sum())
    pairs = int((cols > 0).sum())
    per_block, blocks = strips_cuda.replay_occupancy(affine="gap_open" in kw,
                                                     ncodes=kw["table"].shape[0]
                                                     if "table" in kw else 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = min(pairs, per_block * blocks * sms)
    ms = cuda_ms(call, 3)
    steps = int((torch.where(cols > 0, cols + 31, 0)).sum())
    rec = {"shape": f"strips {low}-{low + G - 1} of {B} lanes, N={N}, {pairs} (lane, strip) "
                    f"pairs reached, moves {G * B * N * S / 1e9:.3f} GB",
           "G": G, "warps_per_sm": per_block * blocks, "moves_gb": G * B * N * S / 1e9,
           "ms": ms, "strip_ms": ms / G, "max_abs_err": 0, "plain_ms": 0.0, "checked_cells": 0,
           "cycles_per_step": ms * 1e-3 * clock * 1e6 * slots / max(1, steps)}
    # Read each reached pair's read rows, its reference columns and their
    # checkpoint values (H, and F; none for strip 0) and the table; write one
    # move byte a computed cell.
    ck_values = int((cols * (base[:, None] > 0)).sum()) * 4 * len(ck)
    rec["bound_ms"], rec["bound_by"] = bound(
        cells * OPS_PER_CELL[replay_pair(group)[0].__name__],
        int((rows * (cols > 0)).sum()) + int(cols.sum()) + ck_values + cells + table_bytes, clock)
    return rec


def big_run(label, flags, counters, reads_path, ref_path, absent=()):
    """Drive the port's solve_big once with the counts of ``counters`` and
    ``absent`` set to 0 just before the run and read just after; each of
    ``counters`` must have launched, none of ``absent``. Returns (its Run,
    the launches of ``counters``)."""
    from parallel_genomeseq_tpu_torch.cli import solve_big

    zero_counts((*counters, *absent))
    t0 = time.perf_counter()
    run = solve_big.run(flags + ["--ref", str(ref_path), "--reads", str(reads_path)])
    launches = read_counts(counters)
    others = {fn.__name__: fn.launches for fn in absent}
    print(f"launches during solve_big {label}: {launches}, of other kernels {others} "
          f"({time.perf_counter() - t0:.1f} s with data reading)")
    if run.rc != 0 or min(launches.values()) < 1 or any(others.values()):
        raise AssertionError(f"solve_big {label}: rc {run.rc}, launches {launches}, {others}")
    return run, launches


def first_best_window(best_of, ranges, full_best: int) -> int:
    """The window a chunked aligner picks, the first with the best score,
    given ``best_of(l, r)``, the oracle's best score in ref[l:r], and
    ``full_best``, the best over the whole reference, which bounds every
    window's: the windows are scored in order until one reaches it (all of
    them if none does), and the first maximum of those scored wins."""
    import numpy as np

    best = []
    for l, r in ranges:
        best.append(best_of(l, r))
        if best[-1] >= full_best:
            break
    return int(np.argmax(best))


def check_long_oracle(reads, ref, results, seed: int, count: int = 2, gap=2, sub=None):
    """Sampled reads of the traceback run against the numpy oracle (uniform
    3/-3, or the byte-pair scores ``sub``, and a linear ``gap``): the
    winning window (first on ties) by the best score in each, then on it the
    score, pos and both consensus strings of the greedy walk."""
    import numpy as np

    from parallel_genomeseq_tpu_torch.parallel.chunking import make_string_ranges

    for k in np.random.default_rng(seed).choice(len(reads), count, replace=False):
        read = reads[k]
        ranges = make_string_ranges(2 * BIG["npiece"], len(read), len(ref), BIG["overlap"])
        best_of = lambda l, r: max(int(c.max()) for c in oracle_columns(read, ref[l:r], gap, sub,
                                                                      np.int32))
        win = first_best_window(best_of, ranges, best_of(0, len(ref)))
        left, right = ranges[win]
        score, pos, cx, cy = oracle_align(read, ref[left:right], gap, sub, np.int32)
        pos = pos + left if pos > 0 else 0
        res = results[k]
        got = (int(res.score), res.pos, res.consensus_x, res.consensus_y)
        if got != (score, pos, cx, cy):
            raise AssertionError(f"long read {k}: port (score {got[0]}, pos {got[1]}, "
                                 f"{len(cx)}-column walk) != oracle ({score}, {pos})")
        print(f"oracle check: long read {k} (window {win}) agrees: score {score}, pos {pos}, "
              f"{len(cx)} columns, {cx.count('-') + cy.count('-')} gap columns")


def check_long_oracle_affine(reads, ref, results, seed: int, count: int = 1, sub=None,
                             gaps=BWA):
    """Sampled reads of the affine traceback run against the numpy Gotoh
    oracle under BWA-MEM's scoring (or the byte-pair scores ``sub`` and the
    gaps of ``gaps``): the winning window (first on ties) by the best score
    in each, then on it the score, pos and both consensus strings of the
    state-machine walk."""
    import numpy as np

    from parallel_genomeseq_tpu_torch.parallel.chunking import make_string_ranges

    if sub is None:
        sub = uniform_pair_scores(BWA["match"], BWA["mismatch"])
    y = np.frombuffer(ref.encode(), np.uint8)
    for k in np.random.default_rng(seed + 2).choice(len(reads), count, replace=False):
        read = reads[k]
        x = np.frombuffer(read.encode(), np.uint8)[None]
        ranges = make_string_ranges(2 * BIG["npiece"], len(read), len(ref), BIG["overlap"])
        best_of = lambda l, r: int(gotoh(x, y[l:r], sub, gaps["gap_open"], gaps["gap"])[0][0])
        win = first_best_window(best_of, ranges, best_of(0, len(ref)))
        left, right = ranges[win]
        score, pos, cx, cy = gotoh_align(read, ref[left:right], sub, gaps["gap_open"],
                                         gaps["gap"])
        pos = pos + left if pos > 0 else 0
        res = results[k]
        got = (int(res.score), res.pos, res.consensus_x, res.consensus_y)
        if got != (score, pos, cx, cy):
            raise AssertionError(f"long read {k}: port (score {got[0]}, pos {got[1]}, "
                                 f"{len(res.consensus_x)}-column walk) != Gotoh oracle "
                                 f"({score}, {pos}, {len(cx)} columns)")
        print(f"Gotoh oracle check: long read {k} (window {win}) agrees: score {score}, pos "
              f"{pos}, {len(cx)} columns, {cx.count('-') + cy.count('-')} gap columns")


def long_data(args):
    """solve_big's default data in ``data/chip_smoke/big``: a 30,000-bp
    reference (seed 0), 100 exact 10,000-bp reads of it (reads.csv) and a
    mutated copy (mutated.csv). Returns (data dir, ref, exact, mutated)."""
    from parallel_genomeseq_tpu_torch.seqio.datagen import gen_reads_custom, gen_ref_custom

    data = ROOT / "data" / "chip_smoke" / "big"
    data.mkdir(parents=True, exist_ok=True)
    ref = gen_ref_custom(data / "ref.fa", ref_len=BIG["ref_len"], seed=0)
    exact = [s for s, _ in gen_reads_custom(ref, data / "reads.csv", n_reads=BIG["n_reads"],
                                            read_len=BIG["read_len"])]
    mutated = mutated_reads(exact, args.seed + 1)
    with open(data / "mutated.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "QNAME", "SEQ", "POS"])
        w.writerows([k, f"mutated-{k}", s, 0] for k, s in enumerate(mutated))
    print(f"long-read data: {len(exact)} reads x {BIG['read_len']} bp (and a mutated copy, "
          f"{min(map(len, mutated))}-{max(map(len, mutated))} bp) vs {len(ref)}-bp reference")
    return data, ref, exact, mutated


def long_phase(args, card: str, clock: float, dev, data, kw):
    """Phases 6 (linear) and 7 (affine, ``kw`` with gap_open): solve_big's
    default width on ``long_data``. Returns (measurements, launches keyed by
    kernel over both runs, the runs' launches)."""
    t_phase = time.perf_counter()
    data_dir, ref, _, mutated = data
    affine = "gap_open" in kw
    print(f"-- long reads, {'affine' if affine else 'linear'} gaps: {kw}")
    measured = check_strip_kernels(mutated, ref, clock, dev, kw)

    tb = strip_counters(kw)
    # Must not launch: the other gap model's strip kernels, and the profile
    # strips' own (K19-K21, K22-K24).
    other = (strip_counters(LINEAR if affine else BWA)[:4] + strip_counters(TABLE)[:3]
             + strip_counters({**TABLE, **PROTEIN_AFFINE})[:3])
    base = [str(BIG["npiece"]), "--device", str(dev)] + (BWA_FLAGS if affine else [])
    score_run, score_launches = big_run(
        "7 3", base[:1] + ["3"] + base[1:], tb[:1], data_dir / "reads.csv", data_dir / "ref.fa",
        absent=other)
    tb_run, tb_launches = big_run(
        "7 1 --traceback", base[:1] + ["1", "--traceback"] + base[1:], tb,
        data_dir / "mutated.csv", data_dir / "ref.fa", absent=other)
    label = "affine" if affine else "linear"
    check_groups(f"7 1 --traceback, {label}", tb_launches, tb)
    print(f"solve_big {label} on {card}: score-only {score_run.seconds[0] * 1e3:.1f} ms, "
          f"{score_run.gcups[0]:.3f} GCUPS; with traceback {tb_run.seconds[0] * 1e3:.1f} ms, "
          f"{tb_run.gcups[0]:.3f} GCUPS")
    if affine:
        check_long_oracle_affine(mutated, ref, tb_run.results, args.seed)
    else:
        check_long_oracle(mutated, ref, tb_run.results, args.seed)
    print(f"long-read phase ({label}): {time.perf_counter() - t_phase:.1f} s")
    sweep = tb[0].__name__
    launches = {sweep: score_launches[sweep] + tb_launches[sweep],
                **{fn.__name__: tb_launches[fn.__name__] for fn in tb[1:]}}
    return measured, launches, {"solve_big_7_3": score_launches,
                                "solve_big_traceback": tb_launches}


# Phases 8 and 9: a titin-class query (4,096 aa) over phase 5's entries,
# and three planted entries over 2,048 aa (length, the query segment it
# holds), so that the top-10 traceback walks in strips.
LONG_QUERY_LEN = 4096
LONG_PLANTED = ((2600, 600), (3500, 1000), (4600, 1500))
# K19's and K22's per-lane check: lanes, query and entry residues (phase
# 6's reduced long-read shape).
LONG_QUERY_REDUCED = (1400, 2304, 4608)


def long_query_data(args, entries):
    """Phases 8 and 9's database, apart from phase 5's: a seeded 4,096-aa
    query, and phase 5's entries after three planted ones of
    ``LONG_PLANTED``, each holding a segment of the query with 5%
    substitutions. Writes ``query_long.fasta`` and ``database_long.fasta``
    under ``data/chip_smoke/protein``. Returns (query path, database path,
    query, entries)."""
    import numpy as np

    data = ROOT / "data" / "chip_smoke" / "protein"
    rng = np.random.default_rng(args.protein_seed + 100)
    amino = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    q = rng.choice(amino, LONG_QUERY_LEN)
    planted = []
    for k, (length, seg_len) in enumerate(LONG_PLANTED):
        entry = rng.choice(amino, length)
        at_q = int(rng.integers(0, LONG_QUERY_LEN - seg_len))
        at_e = int(rng.integers(0, length - seg_len))
        seg = q[at_q : at_q + seg_len].copy()
        subs = rng.random(seg_len) < 0.05
        seg[subs] = rng.choice(amino, int(subs.sum()))
        entry[at_e : at_e + seg_len] = seg
        planted.append((f"LONG{k}", entry.tobytes().decode()))
    query = q.tobytes().decode()
    entries = planted + list(entries)
    query_path, db_path = data / "query_long.fasta", data / "database_long.fasta"
    query_path.write_text(f">titin_class\n{query}\n")
    with open(db_path, "w") as f:
        f.writelines(f">{name}\n{seq}\n" for name, seq in entries)
    return query_path, db_path, query, entries


def check_long_query_kernels(db, query: str, clock: float, dev, gaps):
    """The kernel checks of phases 8 and 9 under ``gaps``, each against its
    plain version: K19 (K22 under affine gaps) on the resident slab (the
    whole-database launch, held on the planted lanes and every 1,024th
    lane; the shortest and longest 4,096-lane groups, every lane) and per
    lane on a reduced BLOSUM50 shape of 1,400 x 2,304 x 4,608; K20, K21 and
    K14 (K23, K24 and K18) on the top-10 traceback batch (x = entry, y =
    query, pad_m = 128; the replay and the walk on the top, a middle and
    the bottom strip, every lane). Returns {kernel: {case:
    measurements}}."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.ops import scan_dp
    from parallel_genomeseq_tpu_torch.utils.device import to_host

    names, (sweep, ckpt, replay, walk), (_, plain_ckpt, plain_replay, plain_walk) = \
        strip_kernels({**TABLE, **gaps})
    affine = "gap_open" in gaps
    out = {fn.__name__: {} for fn in (sweep, ckpt, replay_pair(replay)[0], walk_pair(walk)[0])}
    table, lut = db.engine.table, db.engine.encode_lut
    kw = dict(table=table, **gaps)
    q = db.encode_query(query)
    slab, offs, lens = db._slab, db._offs, db._lens
    m = torch.full_like(lens, q.shape[0])

    def sweep_case(label, x, y, mm, n, held, y_off=None):
        """The sweep on every lane, held against its plain version on lanes
        ``held`` (an index tensor or a slice)."""
        call = lambda: sweep(x, y, mm, n, y_off=y_off, **kw)
        got = call()
        if y_off is None:
            want, plain_ms = timed(lambda: scan_dp.sw_profile_plain(
                x[held], y[held], mm[held], n[held], **kw))
        else:
            want, plain_ms = timed(lambda: scan_dp.sw_profile_plain(
                x, y, mm[held], n[held], y_off=y_off[held], **kw))
        cells, seq_bytes = lane_work(mm, n)
        rec = {"shape": f"{n.shape[0]} lanes, M={x.shape[-1]}, entries "
                        f"{int(n.min())}-{int(n.max())}",
               "max_abs_err": max_abs_err([g[held] for g in got], want),
               "ms": cuda_ms(call, 3), "plain_ms": plain_ms,
               "plain_lanes": int(mm[held].shape[0])}
        if y_off is not None:  # the query once, each entry byte once, the offsets
            seq_bytes = int(n.long().sum()) + x.shape[-1] + 8 * n.shape[0]
        rec["bound_ms"], rec["bound_by"] = bound(
            cells * OPS_PER_CELL[sweep.__name__],
            seq_bytes + LANE_BYTES * n.shape[0] + table.numel() * 4, clock)
        sweep_steps(sweep, rec, x.shape[-1], n, clock, table, slab=y_off is not None)
        out[sweep.__name__][label] = rec
        report(f"{names[0]} {sweep.__name__}", label, rec)
        return got

    # The main path's launch: the query against every lane of the slab, held
    # on the planted lanes (the longest, at the end of the scan order) and
    # every 1,024th lane.
    L = lens.shape[0]
    planted = [db.order.index(k) for k in range(len(LONG_PLANTED))]
    held = torch.tensor(sorted(set(range(0, L, 1024)) | set(planted)), device=dev)
    got = sweep_case("db", q, slab, m, lens, held, y_off=offs)
    for label, sl in (("short_group", slice(0, min(L, 4096))),
                      ("long_group", slice(max(0, L - 4096), L))):
        sweep_case(label, q, slab, m[sl], lens[sl], slice(None), y_off=offs[sl])
    score = to_host([got[0]])[0]
    del got

    # Per lane, as solve_big --matrix's window sweep runs it: 1,400 lanes of
    # 2,304 against 4,608 residues, every 7th lane's y holding a stretch of
    # its x.
    B, Mr, Nr = LONG_QUERY_REDUCED
    rng = np.random.default_rng(2)
    amino = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    xr = rng.choice(amino, (B, Mr)).astype(np.uint8)
    yr = rng.choice(amino, (B, Nr)).astype(np.uint8)
    k = min(Mr, Nr) // 4
    yr[::7, Nr // 4 : Nr // 4 + k] = xr[::7, Mr // 2 : Mr // 2 + k]
    on_card = lambda a: torch.from_numpy(lut[a]).to(dev)
    mr = torch.full((B,), Mr, dtype=torch.int32, device=dev)
    nr = torch.full((B,), Nr, dtype=torch.int32, device=dev)
    sweep_case("reduced", on_card(xr), on_card(yr), mr, nr, slice(None))
    del xr, yr

    # The top-10 traceback batch: K20 on every lane, then K21 and K14.
    top = [db.order[k] for k in np.argsort(-score, kind="stable")[:10]]
    if not set(range(len(LONG_PLANTED))) <= set(top):
        raise AssertionError(f"the planted long entries are not all in the top 10: {top}")
    bat = BatchSWAligner(db.cfg, pad_m=128, device=dev)
    raw = bat.pad_batch([db.entries[k][1] for k in top], [query])
    xs_raw, ys_raw, mm, nn = (torch.from_numpy(a).to(dev) for a in raw)
    lut_d = torch.from_numpy(lut).to(dev)
    xc, yc = lut_d[xs_raw.long()], lut_d[ys_raw.long()]
    got = ckpt(xc, yc, mm, nn, **kw)
    want, plain_ms = timed(lambda: plain_ckpt(xc, yc, mm, nn, **kw))
    cells, seq_bytes = lane_work(mm, nn)
    ck_bytes = sum(c.numel() * 4 for c in got[3:])  # H (and F) checkpoint planes
    rec = {"shape": f"{xc.shape[0]} lanes, M={xc.shape[1]}, N={yc.shape[1]}, checkpoints "
                    f"{ck_bytes / 1e9:.3f} GB",
           "max_abs_err": max_abs_err(got, want), "plain_ms": plain_ms,
           "ms": cuda_ms(lambda: ckpt(xc, yc, mm, nn, **kw), 3)}
    del want
    rec["bound_ms"], rec["bound_by"] = bound(
        cells * OPS_PER_CELL[ckpt.__name__],
        seq_bytes + LANE_BYTES * xc.shape[0] + ck_bytes + table.numel() * 4, clock)
    sweep_steps(ckpt, rec, xc.shape[1], nn, clock, table)
    out[ckpt.__name__]["top10"] = rec
    report(f"{names[1]} {ckpt.__name__}", "top10", rec)
    check_strip_traceback(names[2:], (replay, walk), (plain_replay, plain_walk), xc, yc, mm, nn,
                          kw, got, xs_raw, ys_raw,
                          bat.max_steps(xc.shape[1], yc.shape[1]), clock, out, affine,
                          prefix="query_")
    torch.cuda.empty_cache()
    return out


def long_query_phase(args, card: str, clock: float, dev, data, long, gaps):
    """Phase 8 (linear ``gaps``) or 9 (affine): the 4,096-aa query over
    ``long_query_data``'s database ``data``, and ``solve_big --matrix
    blosum50 7 1 --traceback`` under the same gaps on the long-read phase's
    data ``long``, its kernels first held to their plain versions at its
    shapes (``check_strip_kernels``, cases prefixed ``big_``). Returns (measurements, launches keyed by kernel over both
    runs, the runs' launches)."""
    import torch

    from parallel_genomeseq_tpu_torch.models.protein_db import ResidentProteinDB
    from parallel_genomeseq_tpu_torch.ops import profile_cuda, traceback
    from parallel_genomeseq_tpu_torch.ops.substitution import ALPHABET, BLOSUM50, blosum_config

    t_phase = time.perf_counter()
    affine = "gap_open" in gaps
    label = "affine" if affine else "linear"
    print(f"-- long protein query, {label} gaps {gaps} (profile strips)")
    query_path, db_path, query, entries = data
    db = ResidentProteinDB(entries, matrix="blosum50", gap_penalty=float(gaps["gap"]),
                           gap_open=float(gaps.get("gap_open", 0)), max_query_len=len(query),
                           device=dev)
    measured = check_long_query_kernels(db, query, clock, dev, gaps)
    del db
    torch.cuda.empty_cache()

    tb = strip_counters({**TABLE, **gaps})
    # Must not launch: the single-strip protein kernels (both gap models)
    # and the other gap model's profile strips (the walks of the two models
    # are K14 and K18).
    other = strip_counters({**TABLE, **(PROTEIN_LINEAR if affine else PROTEIN_AFFINE)})[:4]
    short = (profile_cuda.sw_profile, profile_cuda.sw_profile_moves, traceback.walk_moves,
             profile_cuda.sw_profile_affine, profile_cuda.sw_profile_affine_moves,
             traceback.walk_moves_affine, *other)
    out_csv = query_path.parent / f"uniprot_output_long_{label}.csv"
    gap_flags = ["--gap-penalty", str(gaps["gap"])] + (
        ["--gap-open", str(gaps["gap_open"])] if affine else [])
    cli = ["--query", str(query_path), "--database", str(db_path), "--matrix", "blosum50",
           "--batch-size", "4096", "--pad-mult", "128", "--top", "10", "--device", str(dev),
           "--output", str(out_csv)] + gap_flags
    uniprot = protein_run(f"long query, {label}", cli, gaps, entries, query, out_csv, card,
                          args.protein_seed, counters=tb, absent=short,
                          planted=range(len(LONG_PLANTED)))
    data_dir, ref, _, mutated = long
    # solve_big's linear run keeps its default gap of 2. Its kernels against
    # their plain versions at its shapes, as the long-read phases hold them.
    big_gaps = gaps if affine else dict(gap=2)
    cfg = blosum_config("blosum50", gap_penalty=float(big_gaps["gap"]),
                        gap_open=float(big_gaps.get("gap_open", 0)))
    big_measured = check_strip_kernels(mutated, ref, clock, dev, {**TABLE, **big_gaps}, cfg=cfg,
                                       prefix="big_")
    for name, cases in big_measured.items():
        measured[name].update(cases)
    # Must not launch: the uniform strips' sweeps and replays (K11-K13,
    # K15-K17; their walks are the profile strips' too) and the other gap
    # model's profile strips.
    uniform = strip_counters(LINEAR)[:3] + strip_counters(BWA)[:3]
    big_cli = ["--matrix", "blosum50", *(gap_flags if affine else []), str(BIG["npiece"]),
               "1", "--traceback"]
    big, big_launches = big_run(
        " ".join(big_cli), big_cli + ["--device", str(dev)], tb, data_dir / "mutated.csv",
        data_dir / "ref.fa", absent=uniform + other)
    check_groups(f"--matrix blosum50 {label} --traceback", big_launches, tb)
    check_groups(f"long query, {label}", uniprot, tb)
    print(f"solve_big --matrix blosum50 {label} on {card}: with traceback "
          f"{big.seconds[0] * 1e3:.1f} ms, {big.gcups[0]:.3f} GCUPS")
    sub = byte_pair_scores(ALPHABET, BLOSUM50)
    if affine:
        check_long_oracle_affine(mutated, ref, big.results, args.seed + 4, sub=sub, gaps=gaps)
    else:
        check_long_oracle(mutated, ref, big.results, args.seed + 3, count=1, sub=sub)
    print(f"long-query phase ({label}): {time.perf_counter() - t_phase:.1f} s")
    launches = {fn.__name__: uniprot[fn.__name__] + big_launches[fn.__name__] for fn in tb}
    suffix = "_affine" if affine else ""
    return measured, launches, {f"solve_uniprot_long{suffix}": uniprot,
                                f"solve_big_matrix{suffix}_traceback": big_launches}


# Phase 10: the serving entry points. solve_small --matrix scores the DNA
# letters from BLOSUM50 (A, C, G and T are amino-acid codes too), with the
# default gap 2 or swps3's 10/2; the server serves phase 3's reads at 17
# windows and phase 5's database under its default 10/2.
MATRIX_DNA = {"linear": dict(gap=2), "affine": dict(gap_open=10, gap=2)}
ALIGN_REQUESTS, SCAN_REQUESTS = 10, 5


def check_matrix_kernels(reads, ref, batch: int, clock: float, dev, gaps):
    """``solve_small --matrix blosum50``'s kernels under ``gaps`` at its
    shapes, each against its plain version: K4 (K8) per lane, the table
    route, on the window sweep's 17 x ``batch`` lanes; K5 (K9) on the
    winning windows and K3 (K10) on its output. Returns {kernel: {case:
    measurements}}."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.ops import scan_dp
    from parallel_genomeseq_tpu_torch.ops.substitution import blosum_config
    from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkConfig, ChunkedAligner
    from parallel_genomeseq_tpu_torch.utils.device import to_host

    scan_k, moves_k, walk_k, plain_walk = protein_kernels(gaps)
    affine = "gap_open" in gaps
    names = ("K8", "K9", "K10") if affine else ("K4", "K5", "K3")
    cfg = blosum_config("blosum50", gap_penalty=gaps["gap"], gap_open=gaps.get("gap_open", 0))
    chunked = ChunkedAligner(cfg, chunk=ChunkConfig(npiece=17, overlap_ratio=2.0), device=dev)
    aligner = BatchSWAligner(cfg, device=dev)
    table = chunked.engine.table
    lut = torch.from_numpy(chunked.engine.encode_lut).to(dev)
    kw = dict(table=table, **gaps)
    ncodes = table.shape[0]

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    batch_reads = reads[:batch]
    xs, ys, m, n, all_ranges = chunked.window_lanes(batch_reads, ref)
    xs, ys, m, n = on_card(xs, ys, m, n)
    xc, yc = lut[xs.long()], lut[ys.long()]
    call = lambda: scan_k(xc, yc, m, n, **kw)
    got = call()
    want, plain_ms = timed(lambda: scan_dp.sw_profile_plain(xc, yc, m, n, **kw))
    cells, seq_bytes = lane_work(m, n)
    rec = {"shape": f"{xs.shape[0]} lanes, M={xs.shape[1]}, N={ys.shape[1]}",
           "max_abs_err": max_abs_err(got, want), "ms": cuda_ms(call, 10), "plain_ms": plain_ms}
    rec["bound_ms"], rec["bound_by"] = bound(
        cells * OPS_PER_CELL[scan_k.__name__],
        seq_bytes + LANE_BYTES * xs.shape[0] + table.numel() * 4, clock)
    rec["issued_bound_ms"] = bound(cells * SCAN_ISSUED_PER_CELL[scan_k.__name__], 0, clock)[0]
    scan_steps(rec, xs.shape[1], n, clock, ncodes, affine, shared=False)
    out = {scan_k.__name__: {"dna_windows": rec}, moves_k.__name__: {}, walk_k.__name__: {}}
    report(f"{names[0]} {scan_k.__name__}", "dna_windows", rec)

    (scores,) = to_host([got[0]])
    winner = scores.reshape(len(batch_reads), -1).argmax(axis=1)
    win_refs = [ref[slice(*all_ranges[r][w])] for r, w in enumerate(winner)]
    xs, ys, m, n = on_card(*aligner.pad_batch(batch_reads, win_refs))
    xc, yc = lut[xs.long()], lut[ys.long()]
    call = lambda: moves_k(xc, yc, m, n, **kw)
    got = call()
    want, plain_ms = timed(lambda: scan_dp.sw_profile_moves_plain(xc, yc, m, n, **kw))
    cells, seq_bytes = lane_work(m, n)
    M, N, B = xs.shape[1], ys.shape[1], xs.shape[0]
    rec = {"shape": f"{B} lanes, M={M}, N={N}",
           "max_abs_err": max(max_abs_err(got[:3], want[:3]), moves_err(got[3], want[3], m, n)),
           "ms": cuda_ms(call, 10), "plain_ms": plain_ms}
    del want
    nbytes = seq_bytes + LANE_BYTES * B + cells + table.numel() * 4  # + a move byte a cell
    rec["bound_ms"], rec["bound_by"] = bound(cells * OPS_PER_CELL[moves_k.__name__], nbytes,
                                             clock)
    rec["issued_bound_ms"] = bound(cells * WAVE_ISSUED_PER_CELL[moves_k.__name__], nbytes,
                                   clock)[0]
    wave_steps(rec, moves_k, M, N, m, n, clock, "moves", ncodes=ncodes)
    out[moves_k.__name__]["dna_winners"] = rec
    report(f"{names[1]} {moves_k.__name__}", "dna_winners", rec)
    rec = walk_case(walk_k, plain_walk, got[3], xs.T.contiguous(), ys, got[1], got[2],
                    aligner.max_steps(M, N), clock)
    out[walk_k.__name__]["dna_matrix_winners"] = rec
    report(f"{names[2]} {walk_k.__name__}", "dna_matrix_winners", rec)
    return out


def start_server(argv, sock: str):
    """``serve.main(argv)`` on a thread of this process (so that the launch
    counts see its kernels); returns (thread, its first ping reply, the
    seconds until it answered). Raises if the thread ends first."""
    import threading

    from parallel_genomeseq_tpu_torch.cli import serve

    failed = []

    def run():
        try:
            serve.main(argv)
        except BaseException as e:
            failed.append(e)
            raise

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    while True:
        if failed or not thread.is_alive():
            raise RuntimeError(f"the server thread ended before it answered: {failed}")
        try:
            return thread, serve.request(sock, {"op": "ping"}, timeout=30.0), \
                time.perf_counter() - t0
        except (OSError, json.JSONDecodeError):
            if time.perf_counter() - t0 > 600:
                raise
            time.sleep(0.25)


def spread(values):
    """'median (min-max)' of ``values``."""
    import numpy as np

    return f"{float(np.median(values)):.6f} ({min(values):.6f}-{max(values):.6f})"


def serve_run(card, dev, dna_data, protein_data):
    """The port's server on a thread of this process, loaded with phase 3's
    reference and phase 5's database, ``--output-dir`` a scratch directory,
    driven over its Unix socket with the counts of K1-K3 and K8-K10 (and of
    K4-K7, which must not launch) set to 0 just before the requests and read
    just after: ping; 10 align requests of 512 reads at 17 windows, equal to
    phase 3's CSV rows; 5 top-10 scan_db requests with traceback, equal to
    phase 5's affine top 10; one scan_db with output, its CSV's name, len,
    score and pos_end equal to phase 5's affine CSV; shutdown. Returns the
    launches."""
    import os

    import numpy as np

    from parallel_genomeseq_tpu_torch.cli import serve
    from parallel_genomeseq_tpu_torch.ops import profile_cuda, traceback, wavefront_cuda

    ref_path, csv_path, _, reads = dna_data
    query, db_path, csvs = protein_data
    data = ROOT / "data" / "chip_smoke"
    out_dir = data / "serve_out"
    sock = os.path.relpath(data / "serve.sock")  # short: a socket path has 108 bytes
    argv = ["--socket", sock, "--ref", str(ref_path), "--protein-db", str(db_path),
            "--output-dir", str(out_dir), "--npiece", "17", "--batch-size", "512",
            "--warm-read-len", "125", "--db-warm-len", str(len(query)), "--device", str(dev)]
    thread, ping, ready_s = start_server(argv, sock)
    if not (ping["ok"] and ping["backend"].startswith("cuda (") and ping["reads_served"] == 0):
        raise AssertionError(f"unexpected ping reply {ping}")
    print(f"serve: ready in {ready_s:.3f} s, load {ping['load_s']:.3f} s (reference and "
          f"{ping['protein_db_entries']} entries read, slab packed and uploaded), warm-up "
          f"{ping['warmup_s']:.3f} s; backend {ping['backend']}; {card}")

    with open(csv_path.parent / "align_output_linear.csv", newline="") as f:
        dna_rows = list(csv.DictReader(f))
    with open(csvs["affine"], newline="") as f:
        protein_rows = list(csv.DictReader(f))
    counters = (wavefront_cuda.sw_score, wavefront_cuda.sw_score_moves, traceback.walk_moves,
                profile_cuda.sw_profile_affine, profile_cuda.sw_profile_affine_moves,
                traceback.walk_moves_affine)
    absent = (profile_cuda.sw_profile, profile_cuda.sw_profile_moves,
              wavefront_cuda.sw_score_affine, wavefront_cuda.sw_score_affine_moves)
    zero_counts((*counters, *absent))
    align_walls = []
    for k in range(ALIGN_REQUESTS):
        lo, hi = k * 512, (k + 1) * 512
        rep = serve.request(sock, {"op": "align", "reads": reads[lo:hi], "npiece": 17})
        if not rep["ok"] or len(rep["results"]) != hi - lo:
            raise AssertionError(f"align request {k}: {str(rep)[:300]}")
        got = [(r["pos"], r["score"]) for r in rep["results"]]
        want = [(int(row["pos_pred"]), float(row["score"])) for row in dna_rows[lo:hi]]
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            raise AssertionError(f"align request {k}, read {lo + bad}: served {got[bad]} != "
                                 f"solve_small's {want[bad]}")
        align_walls.append(rep["wall_s"])
    ranked = sorted(range(len(protein_rows)), key=lambda k: -int(protein_rows[k]["score"]))[:10]
    want_hits = [{"name": protein_rows[k]["name"], "len": int(protein_rows[k]["len"]),
                  "score": int(protein_rows[k]["score"]),
                  "pos_end": int(protein_rows[k]["pos_end"]),
                  "pos_pred": int(protein_rows[k]["pos_pred"]),
                  "consensus_x": protein_rows[k]["consensus_x"],
                  "consensus_y": protein_rows[k]["consensus_y"]} for k in ranked]
    scan_walls = []
    for k in range(SCAN_REQUESTS):
        rep = serve.request(sock, {"op": "scan_db", "query": query, "top": 10,
                                   "traceback": True})
        if not rep["ok"] or rep["hits"] != want_hits:
            raise AssertionError(f"scan_db request {k}: {str(rep)[:600]} != phase 5's top 10 "
                                 f"{want_hits}")
        scan_walls.append(rep["wall_s"])
    rep = serve.request(sock, {"op": "scan_db", "query": query, "top": 10,
                               "output": "uniprot_served.csv"})
    launches, others = read_counts(counters), read_counts(absent)
    print(f"launches during the server's requests: {launches}, of other kernels {others}")
    if min(launches.values()) < 1 or any(others.values()):
        raise AssertionError(f"serve: launches {launches}, {others}")
    served = out_dir / "uniprot_served.csv"
    if not rep["ok"] or rep["output"] != str(served) or rep["n_rows"] != len(protein_rows):
        raise AssertionError(f"scan_db with output: {str(rep)[:300]}")
    with open(served, newline="") as f:
        served_rows = list(csv.DictReader(f))
    cols = ("name", "len", "score", "pos_end")
    if [[r[c] for c in cols] for r in served_rows] != [[r[c] for c in cols]
                                                       for r in protein_rows]:
        raise AssertionError("the served CSV's name, len, score, pos_end differ from phase 5's")
    if serve.request(sock, {"op": "shutdown"}) != {"ok": True}:
        raise AssertionError("shutdown refused")
    thread.join(60)
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")

    residues = sum(int(r["len"]) for r in protein_rows)
    walls = np.array(align_walls)
    print(f"serve align ({ALIGN_REQUESTS} x 512 reads, 17 windows, traceback): wall_s "
          f"{spread(align_walls)}, {512 / float(np.median(walls)):.1f} reads/s (median; "
          f"{512 / walls.max():.1f}-{512 / walls.min():.1f}); equal to solve_small's rows; {card}")
    walls = np.array(scan_walls)
    print(f"serve scan_db ({SCAN_REQUESTS} x top 10 with traceback, {len(protein_rows)} "
          f"entries, 10/2): wall_s {spread(scan_walls)}, "
          f"{len(query) * residues / float(np.median(walls)) / 1e9:.3f} GCUPS, "
          f"{len(protein_rows) / float(np.median(walls)):.1f} proteins/s (median; GCUPS "
          f"{len(query) * residues / walls.max() / 1e9:.3f}-"
          f"{len(query) * residues / walls.min() / 1e9:.3f}); hits equal to phase 5's; {card}")
    print(f"serve scan_db with output: wall_s {rep['wall_s']:.6f}, {rep['n_rows']} rows, "
          f"name/len/score/pos_end equal to phase 5's CSV; {card}")
    return launches


def serving_phase(args, card: str, clock: float, dev, dna_data, protein_data):
    """Phase 10: ``solve_small --matrix blosum50`` (linear, then 10/2) with
    its kernels held at its shapes, the server, then ``solve_batch
    --traceback``. Returns (measurements by kernel, launches by run)."""
    import functools

    from parallel_genomeseq_tpu_torch.cli import solve_batch
    from parallel_genomeseq_tpu_torch.ops import traceback, wavefront_cuda
    from parallel_genomeseq_tpu_torch.ops.substitution import ALPHABET, BLOSUM50

    t_phase = time.perf_counter()
    ref_path, csv_path, ref, reads = dna_data
    data = ROOT / "data" / "chip_smoke"
    sub = byte_pair_scores(ALPHABET, BLOSUM50)
    uniform = (wavefront_cuda.sw_score, wavefront_cuda.sw_score_moves,
               wavefront_cuda.sw_score_affine, wavefront_cuda.sw_score_affine_moves)
    measured, runs = {}, {}
    for label, gaps in MATRIX_DNA.items():
        print(f"-- solve_small --matrix blosum50, {label} gaps: {gaps}")
        for name, cases in check_matrix_kernels(reads, ref, args.batch_size, clock, dev,
                                                gaps).items():
            measured.setdefault(name, {}).update(cases)
        out_csv = data / f"align_output_matrix_{label}.csv"
        flags = ["--matrix", "blosum50", "--gap-penalty", str(gaps["gap"])]
        if "gap_open" in gaps:
            flags += ["--gap-open", str(gaps["gap_open"])]
            check = functools.partial(check_sampled_affine, sub=sub, gaps=gaps)
        else:
            check = functools.partial(check_sampled, gap=gaps["gap"], sub=sub)
        cli = ["--ref", str(ref_path), "--input", str(csv_path), "--output", str(out_csv),
               "--batch-size", str(args.batch_size), "--device", str(dev)] + flags
        runs[f"solve_small_matrix_{label}"], _ = dna_run(
            f"--matrix blosum50 {label}", cli, gaps, reads, ref, out_csv, card, args.seed,
            counters=protein_kernels(gaps)[:3], absent=uniform, check=check)

    print("-- the server")
    runs["serve"] = serve_run(card, dev, dna_data, protein_data)

    print("-- solve_batch --traceback")
    timing = data / "timing_batch.csv"
    timing.unlink(missing_ok=True)
    counters = (wavefront_cuda.sw_score_moves, traceback.walk_moves)
    zero_counts(counters)
    if solve_batch.main([str(len(reads)), "--traceback", "--batch-size", str(args.batch_size),
                         "--ref", str(ref_path), "--reads", str(csv_path), "--timing-file",
                         str(timing), "--device", str(dev)]) != 0:
        raise AssertionError("solve_batch failed")
    runs["solve_batch"] = read_counts(counters)
    with open(timing, newline="") as f:
        rows = list(csv.reader(f))
    if (len(rows) != 2 or rows[1][:3] != [str(len(reads)), str(args.batch_size), "auto"]
            or not all(float(v) > 0 for v in rows[1][3:])
            or min(runs["solve_batch"].values()) < 1):
        raise AssertionError(f"solve_batch: timing rows {rows}, launches {runs['solve_batch']}")
    print(f"solve_batch {len(reads)} --traceback: launches {runs['solve_batch']}; timing row "
          f"{dict(zip(rows[0], rows[1]))} (us a read); {card}")
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s")
    return measured, runs


# K25's operations a cell: in the G form (G = H + gap (i + j)) a cell is an
# add and two maxima, max(max(diag + s', west), north); the bound counts
# those 3 whatever instructions the kernel issues.
NW_OPS_PER_CELL = 3
# K25's first design (a block a lane, PR 16; NVIDIA H100 80GB HBM3, 700.00
# W): its times on the cases it had, and hirschberg_align's seconds and
# launches for the 2 reads at device_cells=0.
NW_PR16_MS = {"hirschberg_top": 12.747, "score_batch": 25.441, "ragged": 23.852}
HIRSCHBERG_PR16 = (8.86, 19_995)


def check_seeded_kernels(se, reads, batch: int, clock: float, dev, kw):
    """K2 and K3 (K7 and K10) against their plain versions at the seeded
    windows' shape: the first batch's seeded reads against their windows.
    Returns {kernel: {'seeded': measurements}}."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.ops import scan_dp

    _, moves_k, walk_k, plain_walk = dna_kernels(kw)
    first = reads[:batch]
    windows = se.windows_batch(first)
    seeded = [k for k, w in enumerate(windows) if w is not None]
    xs, ys, m, n = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                    se.aligner.pad_batch([first[k] for k in seeded],
                                         [se.ref[slice(*windows[k])] for k in seeded]))
    got = moves_k(xs, ys, m, n, **kw)
    want, plain_ms = timed(lambda: scan_dp.sw_score_moves_plain(xs, ys, m, n, **kw))
    cells, seq_bytes = lane_work(m, n)
    rec = {"shape": f"{xs.shape[0]} seeded lanes, M={xs.shape[1]}, N={ys.shape[1]} (windows "
                    f"of {int(n.min())}-{int(n.max())} bp)",
           "max_abs_err": max(max_abs_err(got[:3], want[:3]), moves_err(got[3], want[3], m, n)),
           "ms": cuda_ms(lambda: moves_k(xs, ys, m, n, **kw), 10), "plain_ms": plain_ms}
    nbytes = seq_bytes + LANE_BYTES * xs.shape[0] + cells  # + one move byte a cell
    rec["bound_ms"], rec["bound_by"] = bound(cells * OPS_PER_CELL[moves_k.__name__], nbytes,
                                             clock)
    rec["issued_bound_ms"] = bound(cells * WAVE_ISSUED_PER_CELL[moves_k.__name__], nbytes,
                                   clock)[0]
    wave_steps(rec, moves_k, xs.shape[1], ys.shape[1], m, n, clock, "moves")
    affine = "gap_open" in kw
    report(f"K{'7' if affine else '2'} {moves_k.__name__}", "seeded", rec)
    wrec = walk_case(walk_k, plain_walk, got[3], xs.T.contiguous(), ys, got[1], got[2],
                     se.aligner.max_steps(xs.shape[1], ys.shape[1]), clock)
    report(f"K{'10' if affine else '3'} {walk_k.__name__}", "seeded", wrec)
    return {moves_k.__name__: {"seeded": rec}, walk_k.__name__: {"seeded": wrec}}


def check_seeded_sampled(se, kw, reads, ref, rows, results, seed: int, count: int = 32):
    """Sampled reads of a ``--seed-extend`` run against the numpy oracle
    (Gotoh under affine gaps) inside the window the seeds give them (the
    whole reference for an unseeded read): score, pos, both consensus
    strings."""
    import numpy as np

    sub = uniform_pair_scores(kw["match"], kw["mismatch"])
    picks = np.random.default_rng(seed).choice(len(reads), count, replace=False)
    for k in picks:
        left, right = se.window(reads[k]) or (0, len(ref))
        if "gap_open" in kw:
            score, pos, cx, cy = gotoh_align(reads[k], ref[left:right], sub, kw["gap_open"],
                                             kw["gap"])
        else:
            score, pos, cx, cy = oracle_align(reads[k], ref[left:right], kw["gap"], sub)
        pos = pos + left if pos > 0 else 0
        res = results[k]
        got = (int(rows[k]["score"]), int(rows[k]["pos_pred"]), int(res.score), res.pos,
               res.consensus_x, res.consensus_y)
        if got != (score, pos, score, pos, cx, cy):
            raise AssertionError(f"seeded read {k}: port {got} != oracle "
                                 f"{(score, pos, cx, cy)} in window {(left, right)}")
    print(f"oracle check: {count} sampled reads of the seeded run agree inside their windows")


def seeded_runs(args, card: str, clock: float, dev, dna_data, full_rates):
    """Phase 11's seed-and-extend half: ``solve_small --seed-extend`` on phase
    3's data, linear and BWA-MEM's, each with K2/K3 (K7/K10) held at the
    windows' shape, its launches (none of K1 and K6: no window sweep), its
    plain route's CSV on the first batch, its scores against phase 3's
    full-width CSV and 32 sampled reads against the oracle, and its reads/s
    beside phase 3's and 4's (``full_rates``, by label). Returns
    (measurements by kernel, launches by run)."""
    import functools

    from parallel_genomeseq_tpu_torch.cli import solve_small
    from parallel_genomeseq_tpu_torch.models.fm_index import FMIndex
    from parallel_genomeseq_tpu_torch.models.seed_extend import SeedExtendAligner
    from parallel_genomeseq_tpu_torch.ops import wavefront_cuda

    ref_path, csv_path, ref, reads = dna_data
    data = ROOT / "data" / "chip_smoke"
    t0 = time.perf_counter()
    FMIndex(ref)
    fm_s = time.perf_counter() - t0
    measured, runs = {}, {}
    for label, kw, flags in (("linear", LINEAR, []), ("affine", BWA, BWA_FLAGS)):
        print(f"-- solve_small --seed-extend, {label} gaps: {kw}")
        se = SeedExtendAligner(ref, dna_config(kw), device=dev)
        batches = [reads[k : k + args.batch_size] for k in range(0, len(reads), args.batch_size)]
        t0 = time.perf_counter()
        seeds = [se.fm.seeds_batch(b, se.k, se.step) for b in batches]
        seeds_s = (time.perf_counter() - t0) / len(batches)
        unseeded = sum(se._window_from_seeds(r, s) is None
                       for b, ss in zip(batches, seeds) for r, s in zip(b, ss))
        print(f"host: FM-index build {fm_s:.3f} s ({len(ref)} bp), seeds_batch "
              f"{seeds_s:.4f} s a batch of {args.batch_size}; {unseeded} of {len(reads)} "
              "reads unseeded")
        for name, cases in check_seeded_kernels(se, reads, args.batch_size, clock, dev,
                                                kw).items():
            measured.setdefault(name, {}).update(cases)
        out_csv = data / f"align_output_seeded_{label}.csv"
        cli = ["--ref", str(ref_path), "--input", str(csv_path), "--output", str(out_csv),
               "--batch-size", str(args.batch_size), "--device", str(dev),
               "--seed-extend"] + flags
        _, moves_k, walk_k = dna_kernels(kw)[:3]
        run = f"solve_small_seed_extend_{label}"
        runs[run], rate = dna_run(
            f"--seed-extend {label}", cli, kw, reads, ref, out_csv, card, args.seed,
            counters=(moves_k, walk_k),
            absent=(wavefront_cuda.sw_score, wavefront_cuda.sw_score_affine),
            check=functools.partial(check_seeded_sampled, se, kw))
        print(f"solve_small --seed-extend {label}: {rate:.1f} reads/s against phase "
              f"{3 if label == 'linear' else 4}'s full width {full_rates[label]:.1f}; {card}")
        # The plain route on the first batch: the same CSV rows, byte for byte.
        plain_csv = data / f"align_output_seeded_{label}_plain.csv"
        cli_plain = [a if a != str(out_csv) else str(plain_csv) for a in cli]
        if solve_small.main(cli_plain + ["--engine", "plain", "--limit",
                                         str(args.batch_size)]) != 0:
            raise AssertionError(f"solve_small --seed-extend --engine plain {label} failed")
        card_lines = out_csv.read_bytes().splitlines(keepends=True)[: args.batch_size + 1]
        if plain_csv.read_bytes() != b"".join(card_lines):
            raise AssertionError(f"--seed-extend {label}: the card's CSV differs from the "
                                 "plain route's on the first batch")
        with open(out_csv, newline="") as f:
            seeded_rows = list(csv.DictReader(f))
        with open(data / f"align_output_{label}.csv", newline="") as f:
            full_rows = list(csv.DictReader(f))
        higher = [k for k, (s, w) in enumerate(zip(seeded_rows, full_rows))
                  if int(s["score"]) > int(w["score"])]
        if higher:
            raise AssertionError(f"--seed-extend {label}: seeded scores above the full-width "
                                 f"ones at rows {higher[:10]}")
        differ = sum(s != w for s, w in zip(seeded_rows, full_rows))
        lower = sum(int(s["score"]) < int(w["score"]) for s, w in zip(seeded_rows, full_rows))
        print(f"--seed-extend {label}: the card's first {args.batch_size} rows equal the plain "
              f"route's; no seeded score above the full-width one; {differ} of "
              f"{len(full_rows)} rows differ from phase {3 if label == 'linear' else 4}'s CSV "
              f"({lower} with a lower score)")
    return measured, runs


def nw_case(label, x, y, lanes, table, gap: int, clock: float, reps: int = 3):
    """K25 on lanes read in place from the flat buffers x, y (a ``Lanes``
    plan) against its plain version, exactly: times, launch shape, bound."""
    from parallel_genomeseq_tpu_torch.ops import global_dp

    got = global_dp.nw_lastrow_lanes(x, y, lanes, table=table, gap=gap)
    want, plain_ms = timed(lambda: global_dp.nw_lastrow_lanes_plain(x, y, lanes, table=table,
                                                                    gap=gap))
    cells = int((lanes.m * lanes.n).sum())
    seq_bytes = int(lanes.m.sum() + lanes.n.sum())
    segs = [int(lanes.chunks.min()), int(lanes.chunks.max())] if lanes.B else [0, 0]
    rec = {"shape": f"{lanes.B} lanes, {cells:.3e} cells, {lanes.rows} rows a thread, "
                    f"{lanes.warps} warps a block, {lanes.blocks} blocks, "
                    f"{segs[0]}-{segs[1]} segments a lane",
           "max_abs_err": max_abs_err([got], [want]), "plain_ms": plain_ms,
           "ms": cuda_ms(lambda: global_dp.nw_lastrow_lanes(x, y, lanes, table=table, gap=gap),
                         reps),
           "cells": cells, "rows_a_thread": lanes.rows, "warps_a_block": lanes.warps,
           "blocks": lanes.blocks, "segments_a_lane": segs,
           "sms": global_dp.sms_used(x, y, lanes, table=table, gap=gap)}
    # Read each lane's bytes, its descriptor and the table once, write the rows.
    rec["bound_ms"], rec["bound_by"] = bound(
        cells * NW_OPS_PER_CELL,
        seq_bytes + 8 * lanes.descriptor().size + table.numel() * 4 + 4 * lanes.total_out,
        clock)
    rec["gcups"] = cells / rec["ms"] / 1e6
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    if label in NW_PR16_MS:
        rec["pr16_ms"] = NW_PR16_MS[label]
    then = f", PR 16 {NW_PR16_MS[label]:.3f} ms" if label in NW_PR16_MS else ""
    print(f"K25 nw_lastrow[{label}] {rec['shape']}, on {rec['sms']} SMs: equal; kernel "
          f"{rec['ms']:.3f} ms "
          f"({rec['gcups']:.2f} GCUPS{then}), plain {rec['plain_ms']:.3f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, {100 * rec['bound_share']:.2f}%); {CARD}")
    return got, rec


def nw_edge_lanes(exact, mutated):
    """K25's edge cases as (label, x, y, plan arguments) over host buffers:
    B of 1, 2, 3; m_b on, one short of and one past a segment edge at 4 and
    32 rows a thread with m_b = 0 and n_b = 0 among them; n of 25,000."""
    import numpy as np

    X = np.frombuffer("".join(mutated[:3]).encode(), np.uint8)
    Y = np.frombuffer("".join(exact[:3]).encode(), np.uint8)
    cases = []
    for B, ms, ns in ((1, [3000], [5000]), (2, [4000, 129], [9000, 7000]),
                      (3, [2500, 6000, 1], [3000, 10_000, 4000])):
        cases.append((f"b{B}", X, Y, dict(m=ms, n=ns)))
    for R in (4, 32):
        c = 32 * R
        ms = [c, c - 1, c + 1, 2 * c, 2 * c + 1, 0, 5, 3 * c - 1]
        ns = [5000, 1, 300, 2000, 0, 40, 0, 4000]
        cases.append((f"edges_r{R}", X, Y, dict(m=ms, n=ns, rows=R)))
    cases.append(("n_25000", X, Y, dict(m=[3000, 30], n=[25_000, 25_000], y_off=[0, 4000])))
    return cases


def deep_level_lanes(x: str, y: str, subproblems: int = 2048):
    """A deep Hirschberg level's lanes over one read pair: x and y cut into
    ``subproblems`` consecutive pieces, each a forward lane of its first
    half and a reversed lane of its second half against its piece of y
    (forward and reversed) -- the level's shape, a few rows and columns a
    lane. Returns the plan's arguments."""
    import numpy as np

    cut = lambda total: (np.arange(subproblems + 1) * total) // subproblems
    xb, yb = cut(len(x)), cut(len(y))
    xo, xl = xb[:-1], np.diff(xb)
    yo, yl = yb[:-1], np.diff(yb)
    mid = xl // 2
    two = lambda a, b: np.stack([a, b], 1).reshape(-1)
    return dict(m=two(mid, xl - mid), n=two(yl, yl), x_off=two(xo, xo + mid),
                y_off=two(yo, yo), x_rev=np.tile([False, True], subproblems),
                y_rev=np.tile([False, True], subproblems))


def long_lanes_check(dev, table, gap: int, L: int = 300_000):
    """K25 on two lanes of L x L cells, thousands of chunks: each lane keeps
    one boundary row of n_b + 1 slots (a row a chunk edge would take over
    1 GiB), the launch allocates no more than that beside its output, and
    the rows equal the closed form for x of one letter (A) against y of two
    (A, C) under the default scores (3, -3): min(m, j) pairs, the A's
    matched first, the rest gapped. Too
    large for the plain version; the kernel's launch is not counted as a
    case."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.ops import global_dp

    rng = np.random.default_rng(21)
    m, n = np.array([L, L - 3]), np.array([L - 11, L])
    X = np.full(int(m.sum()), ord("A"), np.uint8)
    Y = rng.choice(np.frombuffer(b"AC", np.uint8), int(n.sum()))
    lanes = global_dp.plan_lanes(m, n, y_rev=[False, True])
    edge_rows = 8 * int(((lanes.chunks - 1) * (n + 1)).sum())
    if lanes.bound_ints != int((n + 1).sum()) or edge_rows <= 1 << 30:
        raise AssertionError(f"K25 long lanes: {lanes.bound_ints} boundary slots, {edge_rows} "
                             f"bytes of chunk-edge rows")
    x, y = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    got = global_dp.nw_lastrow_lanes(x, y, lanes, table=table, gap=gap).cpu().numpy()
    seconds = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated(dev) - base
    if extra > 4 * lanes.total_out + 8 * lanes.bound_ints + (1 << 20):
        raise AssertionError(f"K25 long lanes allocated {extra} bytes")
    for b in range(2):
        yb = Y[int(lanes.y_off[b]) : int(lanes.y_off[b] + n[b])][:: -1 if b else 1]
        j = np.arange(n[b] + 1)
        a = np.concatenate([[0], np.cumsum(yb == ord("A"))])
        p = np.minimum(m[b], j)
        pa = np.minimum(a, p)
        want = 3 * pa - 3 * (p - pa) - gap * (m[b] + j - 2 * p)
        o = int(lanes.out_off[b])
        if not np.array_equal(got[o : o + n[b] + 1], want):
            raise AssertionError(f"K25 long lane {b} differs from its closed form")
    print(f"K25 long lanes: 2 lanes of {L:,} x {L:,}, {lanes.total_chunks} chunks at "
          f"{lanes.rows} rows a thread, equal to the closed form; {seconds:.3f} s with the "
          f"fetch; boundary rows {8 * lanes.bound_ints:,} bytes (one row a lane; a row a "
          f"chunk edge would take {edge_rows:,}), {extra:,} bytes allocated in all")


def global_runs(card: str, clock: float, dev, long):
    """Phase 11's global half, on phase 6's long-read data: K25 held exactly
    against its plain version on Hirschberg's top launch, an
    ``nw_score_batch`` of the 100 mutated reads against their sources, a
    ragged 64-lane batch, a deep level's 4,096 lanes, 40 lanes at random
    offsets and directions, and the segment edges; two scores against the
    host row sweep; two lanes of 300,000 x 300,000 against a closed form, in
    one boundary row a lane; ``hirschberg_align`` on two reads at
    device_cells=0 (the default; K25's launches counted from 0) and at 2^16,
    where levels mix the card and the CPU route, at most one launch a
    recursion level, valid alignments of their scores and identical to the
    CPU-only run; the demo on the card.
    Returns (K25's cases, its launches in the device_cells=0 runs)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.cli import demo
    from parallel_genomeseq_tpu_torch.models import hirschberg
    from parallel_genomeseq_tpu_torch.ops import global_dp
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig

    _, _, exact, mutated = long
    cfg = ScoringConfig()
    gap = int(cfg.gap_penalty)
    table = global_dp.byte_table(cfg, dev)
    up = lambda a: torch.from_numpy(np.frombuffer(a.encode(), np.uint8).copy()).to(dev)

    cases = {}
    x0, y0 = mutated[0], exact[0]
    mid = len(x0) // 2
    _, cases["hirschberg_top"] = nw_case(
        "hirschberg_top", up(x0), up(y0),
        global_dp.plan_lanes([mid, len(x0) - mid], [len(y0)] * 2, x_off=[0, mid], y_off=[0, 0],
                             x_rev=[False, True], y_rev=[False, True]), table, gap, clock)
    xb, yb, lanes = global_dp.flat_lanes(mutated, exact, dev)
    got, cases["score_batch"] = nw_case("score_batch", xb, yb, lanes, table, gap, clock)
    scores = got[torch.from_numpy(lanes.out_off + lanes.n).to(dev)].cpu().numpy()
    rng = np.random.default_rng(11)
    rx, ry = [], []
    for k in range(64):
        a, b = (int(v) for v in rng.integers(0, 10_000, 2))
        lo = int(rng.integers(0, 10_000 - b + 1))
        rx.append(mutated[k % 100][:a])
        ry.append(exact[k % 100][lo : lo + b])
    _, cases["ragged"] = nw_case("ragged", *global_dp.flat_lanes(rx, ry, dev), table, gap, clock)
    _, cases["deep_level"] = nw_case("deep_level", up(x0), up(y0),
                                     global_dp.plan_lanes(**deep_level_lanes(x0, y0)), table,
                                     gap, clock)
    X, Y = "".join(mutated[:4]), "".join(exact[:4])
    m, n = rng.integers(0, 3000, 40), rng.integers(0, 4000, 40)
    _, cases["offsets_reversed"] = nw_case(
        "offsets_reversed", up(X), up(Y),
        global_dp.plan_lanes(m, n, x_off=rng.integers(0, len(X) - m),
                             y_off=rng.integers(0, len(Y) - n), x_rev=rng.random(40) < 0.5,
                             y_rev=rng.random(40) < 0.5), table, gap, clock)
    for label, Xe, Ye, kw in nw_edge_lanes(exact, mutated):
        _, cases[label] = nw_case(label, torch.from_numpy(Xe.copy()).to(dev),
                                  torch.from_numpy(Ye.copy()).to(dev),
                                  global_dp.plan_lanes(**kw), table, gap, clock)
    tab = cfg.byte_table().astype(np.float64)
    for k in (0, 57):
        host = hirschberg._nw_lastrow(np.frombuffer(mutated[k].encode(), np.uint8),
                                      np.frombuffer(exact[k].encode(), np.uint8), tab, gap)
        if int(scores[k]) != host[-1]:
            raise AssertionError(f"K25 score of read {k} {int(scores[k])} != host row sweep "
                                 f"{host[-1]}")
    print(f"K25 scores of reads 0 and 57 equal the host row sweep's ({int(scores[0])}, "
          f"{int(scores[57])})")

    long_lanes_check(dev, table, gap)

    levels = sum(int(np.ceil(np.log2(len(mutated[k])))) + 1 for k in (0, 1))
    t0 = time.perf_counter()
    host = [hirschberg.hirschberg_align(mutated[k], exact[k], cfg, device_cells=1 << 60,
                                        device=dev) for k in (0, 1)]
    print(f"hirschberg_align, 2 reads of ~10 kb, every subproblem on the CPU route: "
          f"{time.perf_counter() - t0:.2f} s")
    launches = 0
    # 0 (the default) sends every subproblem to the card; at 2^16 a level's
    # subproblems split between the card and the CPU route.
    for cells, label in ((0, "device_cells=0"), (1 << 16, "device_cells=2^16, mixed")):
        global_dp.nw_lastrow.launches = 0
        t0 = time.perf_counter()
        runs = [hirschberg.hirschberg_align(mutated[k], exact[k], cfg, device_cells=cells,
                                            device=dev) for k in (0, 1)]
        seconds = time.perf_counter() - t0
        n_launch = global_dp.nw_lastrow.launches
        if cells == 0:
            launches = n_launch
        if not 1 <= n_launch <= levels:
            raise AssertionError(f"hirschberg_align at {label}: {n_launch} K25 launches for "
                                 f"{levels} recursion levels")
        for k, (on_card, h) in enumerate(zip(runs, host)):
            if (on_card.score, on_card.consensus_x, on_card.consensus_y) != \
                    (h.score, h.consensus_x, h.consensus_y):
                raise AssertionError(f"hirschberg read {k} at {label}: the card's alignment "
                                     f"differs from the CPU-only run's")
            # A valid alignment of its score: the strings rebuild both reads.
            cx, cy = on_card.consensus_x[::-1], on_card.consensus_y[::-1]
            if (cx.replace("-", "") != mutated[k] or cy.replace("-", "") != exact[k]
                    or hirschberg.alignment_score(cx, cy, cfg) != on_card.score):
                raise AssertionError(f"hirschberg read {k} at {label}: not a valid alignment "
                                     f"of score {on_card.score}")
        print(f"hirschberg_align, 2 reads of ~10 kb, {label}: {seconds:.3f} s, {n_launch} K25 "
              f"launches for {levels} levels (PR 16 at device_cells=0: {HIRSCHBERG_PR16[0]} s, "
              f"{HIRSCHBERG_PR16[1]:,} launches); scores {runs[0].score:.0f}, "
              f"{runs[1].score:.0f}, valid alignments of those scores, consensus strings "
              f"identical to the CPU-only run's; {card}")

    outs = []
    for device in (str(dev), "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if demo.main(["--device", device]) != 0:
                raise AssertionError(f"demo on {device} failed")
        outs.append(buf.getvalue())
    if outs[0] != outs[1]:
        raise AssertionError(f"demo on the card printed {outs[0]!r}, on the CPU {outs[1]!r}")
    print("demo on the card (the CPU's lines):\n" + outs[0].rstrip())
    return cases, launches


def a12_phase(args, card: str, clock: float, dev, dna_data, full_rates, long):
    """Phase 11: seed-and-extend and global alignment (``full_rates``:
    phases 3 and 4's reads/s). Returns (the seeded measurements by kernel,
    the seeded runs' launches, K25's cases, K25's launches)."""
    t_phase = time.perf_counter()
    measured, runs = seeded_runs(args, card, clock, dev, dna_data, full_rates)
    nw_cases, nw_launches = global_runs(card, clock, dev, long)
    print(f"seed-extend and global phase: {time.perf_counter() - t_phase:.1f} s")
    return measured, runs, nw_cases, nw_launches


# Phase 12: the reference-parity modes (ROADMAP A2) -- saturating uint8 values
# (Semantics.SAT_UINT8) and the skewed tie -- on K26 (csrc/wavefront.cu's
# parity forms) and K27 (csrc/strips.cu). Operations a cell as OPS_PER_CELL
# counts K1/K2 and K11, plus the clamp (1), and under the skewed tie the raw
# key's compare (1) where the argmax is kept; PARITY_STEP_OPS, the same
# added to what K1/K2's step executes a cell. The pair form (two lanes a
# word in 16-bit halves, csrc/parity.cuh) does the same work at two cells
# an operation, so the least time the card could take, ``bound_ms``, is at
# half the int32 count, and ``int32_bound_ms`` is at the int32 count (the
# count K1/K2's and K11's bounds take). Every case times the form the launch
# rule takes (``ms``, ``form``), the cases with a pair form both forms
# (``int32_ms``, ``pair_ms``), beside the time of the kernels' first form
# (int32 only, every cell's key) in the same case on the same card model
# (PARITY_FIRST_FORM_MS, PERF.md section 6).
SAT_KW = dict(match=3, mismatch=-3, gap=2, sat=True)  # scan_dp.sat_operands(3, -3, 2)
PARITY_OPS = {("score_only", "colmajor"): 2 + 3 + 1 + 1, ("score_only", "skewed"): 2 + 3 + 1 + 1,
              ("track_pos", "colmajor"): 2 + 3 + 2 + 1, ("track_pos", "skewed"): 2 + 3 + 2 + 2,
              ("moves", "colmajor"): 2 + 3 + 2 + 7 + 1, ("moves", "skewed"): 2 + 3 + 2 + 7 + 2}
PARITY_STEP_OPS = {("score_only", "colmajor"): 5 + 0.5 + 1, ("score_only", "skewed"): 5 + 0.5 + 1,
                 ("track_pos", "colmajor"): 5 + 0.5 + 1, ("track_pos", "skewed"): 5 + 0.5 + 2,
                 ("moves", "colmajor"): 5 + 0.5 + 7 + 1, ("moves", "skewed"): 5 + 0.5 + 7 + 2}
PARITY_STRIP_OPS = {"colmajor": 2 + 3 + 2 + 1, "skewed": 2 + 3 + 2 + 2}
PARITY_FIRST_FORM_MS = {"windows_score_only": 0.369, "windows_skewed": 0.672,
                        "npiece1_skewed": 2.217, "npiece1_colmajor": 1.916,
                        "npiece1_skewed_argmax": 0.741, "plateau_skewed": 1.849,
                        "plateau_colmajor": 1.823, "branches_skewed": 0.263, "sweep": 162.237,
                        "reduced_skewed": 10.412}
# K26's moves curve at --parity-mode skewed's launch: (warps a lane, lanes a
# block).
PARITY_MOVES_CURVE = [(w, l) for w in (1, 2) for l in (1, 2, 4, 8)]
# K26 and K27: (wrapper, source, the JAX device code they replace, the case
# the JSON line quotes first).
PARITY_KERNELS = [
    ("sw_score_parity", "wavefront.cu", "parallel_genomeseq_tpu/ops/scan_dp.py:93",
     "npiece1_skewed"),
    ("sw_score_strips_parity", "strips.cu", "parallel_genomeseq_tpu/ops/scan_dp.py:93", "sweep"),
]


def sat_matrices(X, y, match=3, mismatch=-3, gap=2):
    """The saturating DP in numpy, R reads X (R, m) uint8 against y (n,)
    uint8, one anti-diagonal at a time: H = min(max(diag + s, west - gap,
    north - gap, 0), 255) with the clipped operands, which is the JAX scan's
    saturating step (ops/scan_dp.py's module docstring shows the identity).
    Returns H (R, m + 1, n + 1) int16 with the zero boundary."""
    import numpy as np

    R, m = X.shape
    n = len(y)
    H = np.zeros((R, m + 1, n + 1), np.int16)
    for d in range(2, m + n + 1):  # i + j = d
        i = np.arange(max(1, d - n), min(m, d - 1) + 1)
        j = d - i
        s = np.where(X[:, i - 1] == y[j - 1], match, mismatch).astype(np.int16)
        v = np.maximum(np.maximum(H[:, i - 1, j - 1] + s, H[:, i, j - 1] - gap),
                       np.maximum(H[:, i - 1, j] - gap, 0))
        H[:, i, j] = np.minimum(v, 255)
    return H


def skewed_best(H, M: int):
    """(score, i, j) of the reference binary's skewed tie on one dense
    matrix H (m + 1, n + 1), M the padded read length: among the cells of
    the maximum score (> 0), the least raw key rj * (M + 33) + ri, then the
    least i, then the least j (ops/scan_dp.skewed_keys, written out here)."""
    import numpy as np

    m, n = H.shape[0] - 1, H.shape[1] - 1
    score = int(H.max())
    if score <= 0:
        return 0, 0, 0
    i, j = np.nonzero(H[1:, 1:] == score)
    i, j = i + 1, j + 1
    s = i + j
    lo, hi = min(m, n), max(m, n)
    ri = np.where(n > m, np.where(s < lo, j, np.where(s > hi, j - (n - m), m - i)), j)
    rj = np.where(s <= hi, s, s - hi - 1)
    k = np.lexsort((j, i, rj.astype(np.int64) * (M + 33) + ri))[0]
    return score, int(i[k]), int(j[k])


def check_parity_sampled(reads, ref, rows, results, seed: int, count: int = 32):
    """``solve_small --parity-mode skewed`` check: sampled reads (all of one
    length) against the numpy saturating DP over the whole reference, the
    skewed tie's cell and the greedy walk from it -- score, pos and both
    consensus strings."""
    import numpy as np

    picks = np.random.default_rng(seed).choice(len(reads), count, replace=False)
    X = np.stack([np.frombuffer(reads[k].encode(), np.uint8) for k in picks])
    H = sat_matrices(X, np.frombuffer(ref.encode(), np.uint8))
    M = -(-X.shape[1] // 8) * 8  # the aligner's padded read length (PAD_M = 8)
    saturated = 0
    for r, k in enumerate(picks):
        score, i, j = skewed_best(H[r], M)
        pos, cx, cy = oracle_walk(H[r], reads[k], ref, i, j) if score > 0 else (0, "", "")
        res = results[k]
        got = (int(rows[k]["score"]), int(rows[k]["pos_pred"]), int(res.score), res.pos,
               res.consensus_x, res.consensus_y)
        exp = (score, pos, score, pos, cx, cy)
        if got != exp:
            raise AssertionError(f"read {k}: port {got} != saturating skewed oracle {exp}")
        saturated += score == 255
    print(f"saturating oracle check: {count} sampled reads agree (score, pos and both "
          f"consensus strings under the skewed tie; {saturated} of them at 255)")


def check_sat_windows_sampled(reads, ref, rows, results, seed: int, count: int = 32):
    """``solve_small --semantics sat_uint8`` check: sampled reads against the
    numpy saturating DP in each of the 17 windows -- the first window of the
    best score, then on it the column-major cell and the walk: score, pos and
    both consensus strings."""
    import numpy as np

    from parallel_genomeseq_tpu_torch.parallel.chunking import make_string_ranges

    picks = np.random.default_rng(seed + 5).choice(len(reads), count, replace=False)
    X = np.stack([np.frombuffer(reads[k].encode(), np.uint8) for k in picks])
    y = np.frombuffer(ref.encode(), np.uint8)
    ranges = make_string_ranges(17, X.shape[1], len(ref), 2.0)
    per_window = [sat_matrices(X, y[l:r]) for l, r in ranges]
    for r, k in enumerate(picks):
        win = int(np.argmax([int(H[r].max()) for H in per_window]))
        H = per_window[win][r]
        score, i, j = oracle_best(H)
        pos, cx, cy = oracle_walk(H, reads[k], ref[slice(*ranges[win])], i, j) \
            if score > 0 else (0, "", "")
        pos = pos + ranges[win][0] if pos > 0 else 0
        res = results[k]
        got = (int(rows[k]["score"]), int(rows[k]["pos_pred"]), int(res.score), res.pos,
               res.consensus_x, res.consensus_y)
        if got != (score, pos, score, pos, cx, cy):
            raise AssertionError(f"read {k}: port {got} != saturating oracle "
                                 f"{(score, pos, cx, cy)} (window {win})")
    print(f"saturating oracle check: {count} sampled reads of the 17-window run agree")


def key_search_ms(fn, run, reps: int):
    """The skewed tie's key search in one call: (ms of ``run``'s K26/K27
    launch with every cell's key -- tie code 2, the rule past the 2^31 key
    bound, taken at any shape by replacing ``wavefront_cuda.key_rule`` for
    the call --, then ms of it with the key at the wrap row, the launch's
    own rule; the launch's output with every cell's key). Raises unless
    ``fn.forms`` shows those launches took every cell's key."""
    from parallel_genomeseq_tpu_torch.ops import wavefront_cuda

    rule, before = wavefront_cuda.key_rule, fn.forms["every_cell"]
    wavefront_cuda.key_rule = lambda M, N: "every_cell"
    try:
        got = run()
        every_ms = cuda_ms(run, reps)
    finally:
        wavefront_cuda.key_rule = rule
    if fn.forms["every_cell"] == before:
        raise AssertionError(f"{fn.__name__}: no launch took every cell's key")
    return every_ms, cuda_ms(run, reps), got


def check_parity_kernels(reads, ref, batch: int, clock: float, dev):
    """K26 against its plain version on the card, exactly, both ties: the
    8,704 window lanes of ``--semantics sat_uint8`` (score-only, and the
    skewed argmax), the 512 reads against the whole reference of
    ``--parity-mode skewed`` (moves under both ties, the skewed argmax),
    a plateau (512 reads copied from the reference: every lane at 255), and
    lanes of m = n, m > n and n > m (the three branches of the raw key's
    ri); K3 on K26's skewed moves. Returns {kernel: {case: measurements}}."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.ops import scan_dp, traceback, wavefront_cuda
    from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkConfig, ChunkedAligner
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig, Semantics

    fn, plain = wavefront_cuda.sw_score_parity, scan_dp.sw_score_parity_plain
    sat = ScoringConfig(semantics=Semantics.SAT_UINT8)
    aligner = BatchSWAligner(sat, tie="skewed", device=dev)
    out = {fn.__name__: {}, "walk_moves": {}}

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def forced(xs, ys, m, n, pair):
        """The score-only windows in the form asked for (the wrapper's
        launch, uncounted)."""
        return wavefront_cuda._launch(xs, ys, m, n, match=SAT_KW["match"],
                                      mismatch=SAT_KW["mismatch"], gap_open=0,
                                      gap=SAT_KW["gap"], track_pos=False, moves=None,
                                      parity=(True, 0, pair))

    def case(label, xs, ys, m, n, tie, mode, curve=False):
        kw = dict(SAT_KW, tie=tie)
        if mode == "moves":
            kw["emit_moves"] = True
        else:
            kw["track_pos"] = mode != "score_only"
        forms = dict(fn.forms)
        got = fn(xs, ys, m, n, **kw)
        form = next(f for f in ("pair", "int32") if fn.forms[f] > forms.get(f, 0))
        want, plain_ms = timed(lambda: plain(xs, ys, m, n, **kw))

        def err_of(out):
            err = max_abs_err(out[:3], want[:3])
            if mode == "moves":
                err = max(err, moves_err(out[3], want[3], m, n))
            return err

        err = err_of(got)
        rec = {"shape": f"{xs.shape[0]} lanes, M={xs.shape[1]}, N={ys.shape[1]}, {mode}, "
                        f"{tie} tie", "plain_ms": plain_ms, "form": form,
               "saturated_lanes": int((got[0] == 255).sum())}
        rec["ms"] = cuda_ms(lambda: fn(xs, ys, m, n, **kw), 10)
        rec[f"{form}_ms"] = rec["ms"]
        if mode == "score_only":  # the other form, held to the plain version too, and timed
            other = "int32" if form == "pair" else "pair"
            err = max(err, err_of(forced(xs, ys, m, n, other == "pair")))
            rec[f"{other}_ms"] = cuda_ms(lambda: forced(xs, ys, m, n, other == "pair"), 10)
        rec["first_form_ms"] = PARITY_FIRST_FORM_MS[label]
        if curve:  # the moves launch's curve, each point held to the plain version
            rec["moves_curve"] = {}
            for w, L in PARITY_MOVES_CURVE:
                run = lambda: fn(xs, ys, m, n, warps=w, lanes=L, **kw)
                err = max(err, err_of(run()))
                rec["moves_curve"][f"W{w}_L{L}"] = cuda_ms(run, 5)
        if tie == "skewed" and mode != "score_only":  # the key search, in this call
            rec["every_cell_ms"], rec["wrap_row_ms"], alt = key_search_ms(
                fn, lambda: fn(xs, ys, m, n, **kw), 10)
            err = max(err, err_of(alt))
            del alt
        rec["max_abs_err"] = err
        del want
        cells, seq_bytes = lane_work(m, n)
        nbytes = seq_bytes + LANE_BYTES * xs.shape[0] + (cells if mode == "moves" else 0)
        rec["bound_ms"], rec["bound_by"] = bound(cells * PARITY_OPS[mode, tie] / 2, nbytes, clock)
        rec["int32_bound_ms"] = bound(cells * PARITY_OPS[mode, tie], nbytes, clock)[0]
        rec["issued_bound_ms"] = bound(cells * PARITY_STEP_OPS[mode, tie], nbytes, clock)[0]
        wave_steps(rec, fn, xs.shape[1], ys.shape[1], m, n, clock, mode, parity=True,
                   pair=form == "pair")
        out[fn.__name__][label] = rec
        report("K26 sw_score_parity", label, rec)
        both = (f"pair {rec['pair_ms']:.3f} ms, int32 {rec['int32_ms']:.3f} ms"
                if mode == "score_only" else f"{form} {rec['ms']:.3f} ms")
        print(f"    K26 {label}: {form} form by the rule; {both}, first form "
              f"{rec['first_form_ms']:.3f} ms; bound {rec['bound_ms']:.3f} ms at the pair count, "
              f"{rec['int32_bound_ms']:.3f} ms at the int32 count; {CARD}")
        if curve:
            print("    K26 moves curve (int32 form; rows a thread follow W: 4 at W=1, 2 at W=2; "
                  "every point equal to the plain version): " + ", ".join(
                      f"{k} {v:.3f} ms" for k, v in rec["moves_curve"].items()))
        if "every_cell_ms" in rec:
            print(f"    K26 {label}: the skewed key at the wrap row {rec['wrap_row_ms']:.3f} ms, "
                  f"every cell's key {rec['every_cell_ms']:.3f} ms ({form} form, this call)")
        return got

    batch_reads = reads[:batch]
    chunked = ChunkedAligner(sat, chunk=ChunkConfig(npiece=17, overlap_ratio=2.0), device=dev)
    lanes = on_card(*chunked.window_lanes(batch_reads, ref)[:4])
    case("windows_score_only", *lanes, "colmajor", "score_only")
    case("windows_skewed", *lanes, "skewed", "track_pos")
    full = on_card(*aligner.pad_batch(batch_reads, [ref]))
    got = case("npiece1_skewed", *full, "skewed", "moves", curve=True)
    xs, ys = full[:2]
    walk_inputs = (got[3], xs.T.contiguous(), ys, got[1], got[2],
                   aligner.max_steps(xs.shape[1], ys.shape[1]))
    rec = walk_case(traceback.walk_moves, traceback._walk_moves_plain, *walk_inputs, clock)
    out["walk_moves"]["parity_skewed"] = rec
    report("K3 walk_moves", "parity_skewed", rec)
    del got, walk_inputs
    case("npiece1_colmajor", *full, "colmajor", "moves")
    case("npiece1_skewed_argmax", *full, "skewed", "track_pos")
    # The plateau: reads copied from the reference, every lane at 255.
    rng = np.random.default_rng(3)
    starts = rng.integers(0, len(ref) - 125, batch)
    copies = [ref[o : o + 125] for o in starts]
    plateau = on_card(*aligner.pad_batch(copies, [ref]))
    for tie in ("skewed", "colmajor"):
        got = case(f"plateau_{tie}", *plateau, tie, "moves")
        if not bool((got[0] == 255).all()):
            raise AssertionError("the plateau case has a lane below 255")
        del got
    # The raw key's three branches of ri: windows as long as the read (m =
    # n), shorter (m > n) and longer (n > m), around each copy's source.
    wins = []
    for k, o in enumerate(starts[:192]):
        width = (125, 90, 400)[k % 3]
        left = int(min(max(0, o - (width - 125) // 2), len(ref) - width))
        wins.append(ref[left : left + width])
    branches = on_card(*aligner.pad_batch(copies[:192], wins))
    case("branches_skewed", *branches, "skewed", "moves")
    torch.cuda.empty_cache()
    return out


def check_parity_strips(reads, ref, clock: float, dev):
    """K27 against its plain version: solve_big --semantics sat_uint8's
    1,400-lane window sweep (100 reads x 14 windows, M = 10,008), held on one
    read's 14 lanes; and the skewed tie on a reduced shape (2 reads' first
    2,304 bases against 14 windows of 4,608), held on every lane."""
    import numpy as np
    import torch

    from parallel_genomeseq_tpu_torch.ops import scan_dp, strips_cuda
    from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkConfig, ChunkedAligner
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig, Semantics

    fn, plain = strips_cuda.sw_score_strips_parity, scan_dp.sw_score_parity_plain
    out = {fn.__name__: {}}
    chunked = ChunkedAligner(ScoringConfig(semantics=Semantics.SAT_UINT8),
                             chunk=ChunkConfig(npiece=2 * BIG["npiece"],
                                               overlap_ratio=BIG["overlap"]), device=dev)

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def forced(xs, ys, m, n, pair):
        """The column-major sweep in the form asked for (the wrapper's
        launch, uncounted)."""
        return strips_cuda._sweep(xs, ys, m, n, match=SAT_KW["match"],
                                  mismatch=SAT_KW["mismatch"], gap=SAT_KW["gap"], ckpt=False,
                                  sat=True, skewed=0, pair=pair)

    def case(label, xs, ys, m, n, tie, held):
        kw = dict(SAT_KW, tie=tie)
        forms = dict(fn.forms)
        got = fn(xs, ys, m, n, **kw)
        form = next(f for f in ("pair", "int32") if fn.forms[f] > forms.get(f, 0))
        want, plain_ms = timed(lambda: plain(xs[held], ys[held], m[held], n[held], **kw))
        cells, seq_bytes = lane_work(m, n)
        rec = {"shape": f"{xs.shape[0]} lanes, M={xs.shape[1]}, N={ys.shape[1]}, {tie} tie",
               "max_abs_err": max_abs_err([g[held] for g in got], want),
               "form": form, "plain_ms": plain_ms, "plain_lanes": int(m[held].shape[0])}
        del got
        other = None
        if tie == "colmajor":  # the other form, held to the plain version too
            other = "int32" if form == "pair" else "pair"
            alt = forced(xs, ys, m, n, other == "pair")
            rec["max_abs_err"] = max(rec["max_abs_err"], max_abs_err([g[held] for g in alt], want))
            del alt
        if tie == "skewed":  # the key search, in this call
            rec["every_cell_ms"], rec["wrap_row_ms"], alt = key_search_ms(
                fn, lambda: fn(xs, ys, m, n, **kw), 3)
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     max_abs_err([g[held] for g in alt], want))
            del alt
        rec["ms"] = cuda_ms(lambda: fn(xs, ys, m, n, **kw), 3)
        rec[f"{form}_ms"] = rec["ms"]
        if other:
            rec[f"{other}_ms"] = cuda_ms(lambda: forced(xs, ys, m, n, other == "pair"), 3)
        rec["first_form_ms"] = PARITY_FIRST_FORM_MS[label]
        rec["bound_ms"], rec["bound_by"] = bound(cells * PARITY_STRIP_OPS[tie] / 2,
                                                 seq_bytes + LANE_BYTES * xs.shape[0], clock)
        rec["int32_bound_ms"] = bound(cells * PARITY_STRIP_OPS[tie],
                                      seq_bytes + LANE_BYTES * xs.shape[0], clock)[0]
        sweep_steps(fn, rec, xs.shape[1], n, clock, pair=form == "pair")
        out[fn.__name__][label] = rec
        report("K27 sw_score_strips_parity", label, rec)
        both = (f"pair {rec['pair_ms']:.3f} ms, int32 {rec['int32_ms']:.3f} ms" if other
                else f"{form} {rec['ms']:.3f} ms")
        print(f"    K27 {label}: {form} form by the rule; {both}, first form "
              f"{rec['first_form_ms']:.3f} ms; bound {rec['bound_ms']:.3f} ms at the pair count, "
              f"{rec['int32_bound_ms']:.3f} ms at the int32 count; {CARD}")
        if "every_cell_ms" in rec:
            print(f"    K27 {label}: the skewed key at the wrap row {rec['wrap_row_ms']:.3f} ms, "
                  f"every cell's key {rec['every_cell_ms']:.3f} ms ({form} form, this call)")

    xs, ys, m, n, _ = chunked.window_lanes(reads, ref)
    case("sweep", *on_card(xs, ys, m, n), "colmajor", slice(0, 2 * BIG["npiece"]))
    lanes = [(r, o) for r in range(2) for o in np.random.default_rng(2).integers(
        0, len(ref) - 4608, 2 * BIG["npiece"])]
    xr = np.stack([np.frombuffer(reads[r][:2304].encode(), np.uint8) for r, _ in lanes])
    yr = np.stack([np.frombuffer(ref[o : o + 4608].encode(), np.uint8) for _, o in lanes])
    xr[:, 1000:1100] = yr[:, 2000:2100]  # a saturating stretch in every lane
    case("reduced_skewed", *on_card(xr, yr, np.full(len(lanes), 2304, np.int32),
                                    np.full(len(lanes), 4608, np.int32)), "skewed", slice(None))
    torch.cuda.empty_cache()
    return out


def parity_phase(args, card: str, clock: float, dev, dna_data, long):
    """Phase 12. K26 and K27 against their plain versions (above); then
    ``solve_small --parity-mode skewed`` on phase 3's data, its launches
    (K26 and K3; none of K1 or K2), 32 sampled reads against the saturating
    skewed oracle and its first 1,024 rows equal to the same aligner's with
    engine="plain" on the card; ``solve_small --semantics sat_uint8`` (17
    windows; K26 score-only and with moves, K3) with 32 sampled reads against
    the saturating oracle; ``solve_big 7 1 --semantics sat_uint8`` on phase
    6's exact reads (K27; not K11), every score 255. Returns (measurements by
    kernel, launches by run)."""
    from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
    from parallel_genomeseq_tpu_torch.ops import strips_cuda, traceback, wavefront_cuda
    from parallel_genomeseq_tpu_torch.seqio.readers import read_ground_truth
    from parallel_genomeseq_tpu_torch.seqio.writers import write_align_output
    from parallel_genomeseq_tpu_torch.utils.config import ScoringConfig, Semantics

    t_phase = time.perf_counter()
    ref_path, csv_path, ref, reads = dna_data
    data_dir, big_ref, exact, mutated = long
    print("-- reference-parity modes: saturating uint8 values and the skewed tie")
    measured = check_parity_kernels(reads, ref, args.batch_size, clock, dev)
    measured.update(check_parity_strips(mutated, big_ref, clock, dev))

    data = ROOT / "data" / "chip_smoke"
    k26, k3 = wavefront_cuda.sw_score_parity, traceback.walk_moves
    k27 = strips_cuda.sw_score_strips_parity
    absent = (wavefront_cuda.sw_score, wavefront_cuda.sw_score_moves)
    runs = {}
    forms_before = {}

    def forms_of(run):
        """Print (and keep under the run's launches) the forms its K26 and
        K27 launches took, by form and key rule."""
        for fn in (k26, k27):
            took = dict(fn.forms - forms_before.get(fn.__name__, collections.Counter()))
            forms_before[fn.__name__] = collections.Counter(fn.forms)
            if took and run in runs:
                runs[run][f"{fn.__name__}_forms"] = took
                print(f"    {run}: {fn.__name__} launched {took}")

    forms_of("the kernel checks")
    base = ["--ref", str(ref_path), "--input", str(csv_path), "--batch-size",
            str(args.batch_size), "--device", str(dev)]
    out_csv = data / "align_output_parity.csv"
    runs["solve_small_parity"], _ = dna_run(
        "--parity-mode skewed", base + ["--output", str(out_csv), "--parity-mode", "skewed"],
        LINEAR, reads, ref, out_csv, card, args.seed, counters=(k26, k3), absent=absent,
        check=check_parity_sampled)
    forms_of("solve_small_parity")
    # The same aligner on the plain route, on the card: the first 1,024 rows.
    limit = 2 * args.batch_size
    plain = BatchSWAligner(ScoringConfig(semantics=Semantics.SAT_UINT8), tie="skewed",
                           device=dev, engine="plain")
    t0 = time.perf_counter()
    results = [r for b in plain.align_stream(
        [reads[k : k + args.batch_size] for k in range(0, limit, args.batch_size)], [ref])
        for r in b]
    plain_s = time.perf_counter() - t0
    plain_csv = data / "align_output_parity_plain.csv"
    write_align_output(plain_csv, read_ground_truth(csv_path)[:limit], results)
    card_lines = out_csv.read_bytes().splitlines(keepends=True)[: limit + 1]
    if plain_csv.read_bytes() != b"".join(card_lines):
        raise AssertionError("--parity-mode skewed: the card's CSV differs from the plain "
                             f"engine's on the first {limit} rows")
    print(f"--parity-mode skewed: the card's first {limit} rows equal engine='plain' on the "
          f"card ({plain_s:.1f} s for the plain route)")
    out_csv = data / "align_output_sat.csv"
    runs["solve_small_sat"], _ = dna_run(
        "--semantics sat_uint8", base + ["--output", str(out_csv), "--semantics", "sat_uint8"],
        LINEAR, reads, ref, out_csv, card, args.seed, counters=(k26, k3), absent=absent,
        check=check_sat_windows_sampled)
    forms_of("solve_small_sat")
    run, runs["solve_big_sat"] = big_run(
        "7 1 --semantics sat_uint8", [str(BIG["npiece"]), "1", "--device", str(dev),
                                      "--semantics", "sat_uint8"],
        (strips_cuda.sw_score_strips_parity,), data_dir / "reads.csv", data_dir / "ref.fa",
        absent=(strips_cuda.sw_score_strips,))
    forms_of("solve_big_sat")
    if any(r.score != 255 for r in run.results):
        raise AssertionError("solve_big --semantics sat_uint8: an exact 10,000-bp read below 255")
    print(f"solve_big --semantics sat_uint8 on {card}: {run.seconds[0] * 1e3:.1f} ms, "
          f"{run.gcups[0]:.3f} GCUPS, {len(run.results) / run.seconds[0]:.1f} reads/s; "
          "every read at 255")
    print(f"reference-parity phase: {time.perf_counter() - t_phase:.1f} s")
    return measured, runs


def add_phase(kernels, measured, runs):
    """Merge a later phase (10, 11) into the kernels' entries: its cases
    under their labels, and each run's launches (``launches_<run>``, added
    to the entry's ``launches``)."""
    for entry in kernels:
        name = entry["name"]
        for label, c in measured.get(name, {}).items():
            entry["max_abs_err"] = max(entry["max_abs_err"], c["max_abs_err"])
            entry.update({f"{label}_{k}": v for k, v in c.items() if k != "max_abs_err"})
        for run, counts in runs.items():
            if name in counts:
                entry[f"launches_{run}"] = counts[name]
                entry["launches"] += counts[name]
    return kernels


# K1-K24: (wrapper, source, the TPU code it replaces, gap model or phase,
# the main path's case that the JSON line quotes first).
KERNELS = [
    ("sw_score", "wavefront.cu", f"{PALLAS}:160", "linear", "score_only"),
    ("sw_score_moves", "wavefront.cu", f"{PALLAS}:535", "linear", "windows"),
    ("walk_moves", "traceback.cu", "parallel_genomeseq_tpu/ops/traceback.py:31", "linear",
     "windows"),
    ("sw_profile", "profile.cu", f"{PALLAS}:418", "linear", "db"),
    ("sw_profile_moves", "wavefront.cu", f"{PALLAS}:815", "linear", "top10"),
    ("sw_score_affine", "wavefront.cu", f"{PALLAS}:208", "affine", "score_only"),
    ("sw_score_affine_moves", "wavefront.cu", f"{PALLAS}:710", "affine", "windows"),
    ("sw_profile_affine", "profile.cu", f"{PALLAS}:442", "affine", "db"),
    ("sw_profile_affine_moves", "wavefront.cu", f"{PALLAS}:724", "affine", "top10"),
    ("walk_moves_affine", "traceback.cu", "parallel_genomeseq_tpu/ops/traceback.py:93", "affine",
     "windows"),
    ("sw_score_strips", "strips.cu", f"{PALLAS}:1073", "long", "sweep"),
    ("sw_score_strips_ckpt", "strips.cu", f"{PALLAS}:1134", "long", "winners"),
    ("strip_moves", "strips.cu", f"{PALLAS}:1792", "long", "group"),
    ("walk_strip_level", "traceback.cu", "parallel_genomeseq_tpu/ops/traceback.py:167", "long",
     "group"),
    ("sw_score_strips_affine", "strips.cu", f"{PALLAS}:1102", "long_affine", "sweep"),
    ("sw_score_strips_affine_ckpt", "strips.cu", f"{PALLAS}:1147", "long_affine", "winners"),
    ("strip_affine_moves", "strips.cu", f"{PALLAS}:1870", "long_affine", "group"),
    ("walk_strip_level_affine", "traceback.cu", "parallel_genomeseq_tpu/ops/traceback.py:221",
     "long_affine", "group"),
    ("sw_score_strips_profile", "strips.cu", f"{PALLAS}:1081", "long_query", "db"),
    ("sw_score_strips_profile_ckpt", "strips.cu", f"{PALLAS}:1642", "long_query", "top10"),
    ("strip_profile_moves", "strips.cu", f"{PALLAS}:1986", "long_query", "query_group"),
    ("sw_score_strips_profile_affine", "strips.cu", f"{PALLAS}:1116", "long_query_affine", "db"),
    ("sw_score_strips_profile_affine_ckpt", "strips.cu", f"{PALLAS}:1657", "long_query_affine",
     "top10"),
    ("strip_profile_affine_moves", "strips.cu", f"{PALLAS}:2070", "long_query_affine",
     "query_group"),
]
# K25, phase 11's kernel: (wrapper, source, the JAX device code it replaces).
NW_KERNEL = ("nw_lastrow", "global_dp.cu", "parallel_genomeseq_tpu/ops/global_dp.py:33")
# The strip walks run in a long-read phase and in a long-query phase.
WALK_QUERY_PHASE = {"walk_strip_level": "long_query",
                    "walk_strip_level_affine": "long_query_affine"}


def card_info():
    """(name and power limit as nvidia-smi prints them, top SM clock MHz)."""
    def query(fields):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

    clock = float(query("clocks.max.sm").split()[0])
    return query("name,power.limit"), clock


def kernel_line(name, src, replaces, cases, main, launches):
    """One entry of the kernels JSON line: the main-path case's numbers, the
    other cases' under their labels."""
    entry = {"name": name, "route": "cuda", "source": f"{CSRC}/{src}", "replaces": replaces,
             "launches": launches,
             "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
             "library_ms": None}
    # ms, plain_ms, bound_ms, bound_by, shape, and plain_lanes where the plain
    # version ran on a sample of the lanes.
    entry.update({k: v for k, v in cases[main].items() if k != "max_abs_err"})
    for label, c in cases.items():
        if label != main:
            entry.update({f"{label}_{k}": v for k, v in c.items() if k != "max_abs_err"})
    return entry


def kernel_entries(dna, dna_launches, protein, protein_launches, long):
    """The kernels JSON line's entries, K1-K24, from the phases'
    measurements and launches (keyed by gap model, then kernel; the
    long-read and long-query phases' keyed 'long', 'long_affine',
    'long_query' and 'long_query_affine', each (measurements by kernel,
    launches by kernel, each run's launches)). K14 and K18 walk in a
    long-read and a long-query phase: their entries sum both."""
    kernels = []
    for name, src, replaces, gaps, main_case in KERNELS:
        if gaps.startswith("long"):
            phases = [long[gaps]] + ([long[WALK_QUERY_PHASE[name]]]
                                     if name in WALK_QUERY_PHASE else [])
            cases = {k: v for measured, _, _ in phases for k, v in measured[name].items()}
            entry = kernel_line(name, src, replaces, cases, main_case,
                                sum(launches[name] for _, launches, _ in phases))
            for _, _, runs in phases:
                entry.update({f"launches_{run}": n[name] for run, n in runs.items() if name in n})
                entry.update({f"strips_walked_{run}": n[f"{name}_strips"]
                              for run, n in runs.items() if f"{name}_strips" in n})
        elif name.startswith("walk_moves"):  # both paths walk
            cases = {**dna[gaps][name], **protein[gaps][name]}
            on_dna, on_protein = dna_launches[gaps][name], protein_launches[gaps][name]
            entry = kernel_line(name, src, replaces, cases, main_case, on_dna + on_protein)
            entry.update(launches_solve_small=on_dna, launches_solve_uniprot=on_protein)
        else:
            measured, launches = ((dna, dna_launches) if name in dna[gaps]
                                  else (protein, protein_launches))
            entry = kernel_line(name, src, replaces, measured[gaps][name], main_case,
                                launches[gaps][name])
        kernels.append(entry)
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=5120)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--entries", type=int, default=561_356)
    ap.add_argument("--protein-seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    global CARD
    card, clock = card_info()
    CARD = card
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
          f"max SM clock {clock:.0f} MHz")

    from parallel_genomeseq_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")

    dev = torch.device("cuda", 0)
    seconds = {}
    t0 = t_all = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    dna, dna_launches, dna_rates, dna_data = dna_phase(args, card, clock, dev)
    lap("3-4 short reads")
    protein, protein_launches, entries, protein_data = protein_phase(args, card, clock, dev)
    lap("5 protein scan")
    data = long_data(args)
    long = {"long": long_phase(args, card, clock, dev, data, LINEAR)}
    lap("6 long reads")
    long["long_affine"] = long_phase(args, card, clock, dev, data, BWA)
    lap("7 long reads affine")
    query_data = long_query_data(args, entries)
    del entries
    print(f"long-query data: {len(query_data[3])} entries ({len(LONG_PLANTED)} planted of "
          f"{', '.join(str(n) for n, _ in LONG_PLANTED)} aa), query {len(query_data[2])} aa, "
          f"written in {time.perf_counter() - t0:.1f} s")
    long["long_query"] = long_query_phase(args, card, clock, dev, query_data, data,
                                          PROTEIN_LINEAR)
    lap("8 long query")
    long["long_query_affine"] = long_query_phase(args, card, clock, dev, query_data, data,
                                                 PROTEIN_AFFINE)
    lap("9 long query affine")
    del query_data
    serving, serving_runs = serving_phase(args, card, clock, dev, dna_data, protein_data)
    lap("10 serving")
    seeded, seeded_runs_, nw_cases, nw_launches = a12_phase(args, card, clock, dev, dna_data,
                                                             dna_rates, data)
    lap("11 seed-extend and global")
    parity, parity_runs = parity_phase(args, card, clock, dev, dna_data, data)
    lap("12 reference parity")

    kernels = add_phase(add_phase(add_phase(
        kernel_entries(dna, dna_launches, protein, protein_launches, long), serving,
        serving_runs), seeded, seeded_runs_), parity, parity_runs)
    name, src, replaces = NW_KERNEL
    kernels.append(kernel_line(name, src, replaces, nw_cases, "hirschberg_top", nw_launches))
    kernels[-1]["launches_hirschberg_align"] = nw_launches
    for name, src, replaces, main_case in PARITY_KERNELS:
        counts = {run: n[name] for run, n in parity_runs.items() if name in n}
        kernels.append(kernel_line(name, src, replaces, parity[name], main_case,
                                   sum(counts.values())))
        kernels[-1].update({f"launches_{run}": c for run, c in counts.items()})
    print(f"phase seconds: {seconds}; total {time.perf_counter() - t_all:.1f} s "
          "(the build before them)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
