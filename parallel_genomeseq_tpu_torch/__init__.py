"""parallel_genomeseq_tpu_torch -- the PyTorch/CUDA port of parallel_genomeseq_tpu.

Smith-Waterman local alignment on one NVIDIA H100, grown slice by slice
beside the JAX package, which stays the reference. The port imports torch
and never jax, nor anything of the JAX package: it keeps its own copies of
the jax-free modules it needs (scoring and chunk configs, encodings,
results, sequence IO, data generation, CLI flag plumbing, substitution
matrices), each with a pointer to its source.

Layers (bottom-up):
- csrc:     hand-written CUDA kernels (sm_90a): K1 score sweep, K2 score +
            move codes, K3 traceback walk, K4 substitution-matrix score
            sweep (the database scan), K5 substitution-matrix moves, and
            their affine (Gotoh) forms K6-K9 with the affine walk K10
- ops:      kernel build/loading, wrappers with launch counters, the plain
            PyTorch wavefront and walk (CPU route and reference), engines,
            substitution matrices
- models:   BatchSWAligner / SWAligner (score + argmax + traceback),
            ResidentProteinDB (one resident slab, many query scans)
- parallel: overlapping reference windows and the per-read argmax merge
- cli:      solve_small, solve_uniprot
- seqio:    FASTA/CSV readers and writers, the UNIPROT database reader,
            seeded data generation
- utils:    configs, encodings, results, device resolution, host
            transfers, seeded stand-in data sets
- tools:    where the main paths' time goes (torch.profiler, cProfile)
"""
