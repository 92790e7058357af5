"""Contract of the PyTorch/CUDA port: it never imports jax, configurations
outside the ported slice raise NotImplementedError, CPU tensors take the
plain route without counting a kernel launch, and a missing CUDA toolkit or
card raises instead of falling back."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_genomeseq_tpu.utils.config import ScoringConfig, Semantics
from parallel_genomeseq_tpu_torch.cli import solve_small
from parallel_genomeseq_tpu_torch.models.swaligner import BatchSWAligner
from parallel_genomeseq_tpu_torch.ops import _build, engine, traceback, wavefront_cuda
from parallel_genomeseq_tpu_torch.parallel.chunking import ChunkedAligner
from parallel_genomeseq_tpu_torch.utils import device as device_mod

REPO = Path(__file__).resolve().parents[1]
COUNTERS = (wavefront_cuda.sw_score, wavefront_cuda.sw_score_moves, traceback.walk_moves)


def test_port_never_imports_jax():
    """Import every module of the port, and chip_smoke, in a fresh
    interpreter: jax must not be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import parallel_genomeseq_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert 'parallel_genomeseq_tpu_torch.cli.solve_small' in mods\n"
        "print(len(mods), 'jax' in sys.modules)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        check=True, timeout=120,
    ).stdout.split()
    assert int(out[0]) >= 10 and out[1] == "False", out


@pytest.mark.parametrize("cfg", [
    ScoringConfig(semantics=Semantics.SAT_UINT8),
    ScoringConfig(gap_open=10.0),
    ScoringConfig(matrix=np.eye(4) * 5 - 1, alphabet="ACGT"),
    ScoringConfig(match=2.5),
    ScoringConfig(semantics=Semantics.FLOAT32),
], ids=["sat_uint8", "affine", "matrix", "non_integral", "float32"])
def test_unsupported_configs_raise(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        engine.make_score_engine(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        ChunkedAligner(cfg=cfg, device="cpu")


def test_make_score_engine_names():
    assert type(engine.make_score_engine(device="cpu")) is engine.CudaEngine
    assert type(engine.make_score_engine(name="cuda", device="cpu")) is engine.CudaEngine
    plain = engine.make_score_engine(name="plain", device="cpu")
    assert type(plain) is engine.PlainEngine
    xs = np.frombuffer(b"ACGTTACG", np.uint8).copy()[None]
    ys = np.frombuffer(b"TTACGTTACGAA", np.uint8).copy()[None]
    want = engine.CudaEngine(device="cpu").score_batch(xs, ys, [8], [12])
    got = plain.score_batch(xs, ys, [8], [12])
    assert {k: int(v[0]) for k, v in got.items()} == {k: int(v[0]) for k, v in want.items()}
    assert int(got["score"][0]) == 24
    with pytest.raises(ValueError, match="unknown engine"):
        engine.make_score_engine(name="pallas", device="cpu")


def test_skewed_ties_and_strip_length_reads_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        BatchSWAligner(tie="skewed", device="cpu")
    long_read = np.full((1, engine.MAX_M + 8), ord("A"), np.uint8)
    eng = engine.make_score_engine(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        eng.score_batch(long_read, long_read, [engine.MAX_M + 8], [engine.MAX_M + 8])


@pytest.mark.parametrize("flags", [
    ["--seed-extend"], ["--parity-mode", "skewed"], ["--matrix", "blosum62"],
])
def test_solve_small_rejects_unported_modes(flags, tmp_path):
    with pytest.raises(SystemExit) as exc:
        solve_small.main(flags + ["--device", "cpu", "--output", str(tmp_path / "o.csv")])
    assert exc.value.code == 2


def test_cpu_tensors_take_plain_route_without_launches():
    for fn in COUNTERS:
        fn.launches = 0
    rng = np.random.default_rng(0)
    ref = "".join(rng.choice(list("ACGT"), 600))
    reads = [ref[s : s + 50] for s in (10, 200, 400)]
    BatchSWAligner(device="cpu").align_batch(reads, [ref])
    ChunkedAligner(device="cpu").align_batch(reads, ref)
    engine.CudaEngine(device="cpu").score_batch_moves(
        np.frombuffer(reads[0].encode(), np.uint8).copy()[None],
        np.frombuffer(ref.encode(), np.uint8).copy()[None], [50], [600],
    )
    assert [fn.launches for fn in COUNTERS] == [0, 0, 0]


def test_cuda_default_without_card_raises(monkeypatch):
    """No silent drop to the CPU: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchSWAligner()
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Asking for the kernels where nvcc is absent raises; nothing falls
    back to the plain route."""
    monkeypatch.setenv("NVCC", str(tmp_path / "missing" / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.build()
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.load()
    assert not (tmp_path / "build" / _build.LIB_NAME).exists()


def test_build_command_targets_hopper(monkeypatch, tmp_path):
    """The build compiles every csrc/*.cu for sm_90a into the build dir,
    and a compiler failure raises with its message."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho \"$@\" > \"$(dirname \"$0\")/args\"\n"
                    "echo 'error: refused' >&2\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("NVCC", str(nvcc))
    with pytest.raises(RuntimeError, match="refused"):
        _build.build(tmp_path / "build")
    args = (tmp_path / "args").read_text().split()
    assert "arch=compute_90a,code=sm_90a" in args and "-shared" in args
    assert {Path(a).name for a in args if a.endswith(".cu")} == {"wavefront.cu", "traceback.cu"}


def test_profile_tool_runs_on_the_plain_route(tmp_path, capsys):
    """The profiling tool's phases run end to end at a small size on CPU
    tensors (where it reports no device time)."""
    from parallel_genomeseq_tpu_torch.tools import profile_main

    assert profile_main.main([
        "--device", "cpu", "--reads", "8", "--read-len", "30", "--ref-len", "400",
        "--batch-size", "4", "--sweep", "8", "--out-dir", str(tmp_path),
    ]) == 0
    out = capsys.readouterr().out
    assert '"device_busy_s": null' in out and "batch 8:" in out
    assert (tmp_path / "align_output.csv").exists()


def test_wrappers_validate_inputs():
    xs = torch.zeros((2, 8), dtype=torch.uint8)
    ys = torch.zeros((2, 16), dtype=torch.uint8)
    m = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        wavefront_cuda.sw_score(xs, ys, m, m.long(), match=3, mismatch=-3, gap=2)
    with pytest.raises(ValueError):
        wavefront_cuda.sw_score(xs, ys[:1], m, m, match=3, mismatch=-3, gap=2)
