"""parallel_genomeseq_tpu_torch -- the PyTorch/CUDA port of parallel_genomeseq_tpu.

Smith-Waterman local alignment on one NVIDIA H100, grown slice by slice
beside the JAX package, which stays the reference. The port imports torch
and never jax; it reuses the JAX package's jax-free modules (scoring and
chunk configs, encodings, results, sequence IO, the numpy oracle, CLI flag
plumbing) as they are.

Layers (bottom-up), for the DNA short-read slice:
- csrc:     hand-written CUDA kernels (sm_90a): K1 score sweep, K2 score +
            move codes, K3 traceback walk
- ops:      kernel build/loading, wrappers with launch counters, the plain
            PyTorch wavefront and walk (CPU route and reference), engines
- models:   BatchSWAligner / SWAligner (score + argmax + traceback)
- parallel: overlapping reference windows and the per-read argmax merge
- cli:      solve_small
- utils:    device resolution, host transfers, seeded synthetic data
"""
