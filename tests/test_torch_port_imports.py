"""Import hygiene of the PyTorch/CUDA port (``deepspeed_tpu_torch``): it
imports torch and never JAX, flax, Triton or the JAX package; importing it
builds and touches nothing; its entry points refuse to run on the CPU
unless asked to."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "deepspeed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "deepspeed_tpu", "triton")


def test_port_modules_import_without_jax_flax_triton_or_the_jax_package():
    code = f"""
import importlib, pkgutil, sys
import deepspeed_tpu_torch
bare = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})
names = [m.name for m in pkgutil.walk_packages(
    deepspeed_tpu_torch.__path__, prefix='deepspeed_tpu_torch.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})
assert not bare and not bad, (bare, bad)
for m in ('deepspeed_tpu_torch.inference.engine_v2',
          'deepspeed_tpu_torch.inference.speculative',
          'deepspeed_tpu_torch.moe', 'deepspeed_tpu_torch.moe.layer',
          'deepspeed_tpu_torch.moe.sharded_moe',
          'deepspeed_tpu_torch.ops.grouped_matmul',
          'deepspeed_tpu_torch.config', 'deepspeed_tpu_torch.parallel.topology',
          'deepspeed_tpu_torch.utils.timer',
          'deepspeed_tpu_torch.runtime.lr_schedules',
          'deepspeed_tpu_torch.ops.optimizers',
          'deepspeed_tpu_torch.runtime.fp16', 'deepspeed_tpu_torch.models.loss',
          'deepspeed_tpu_torch.ops.remat',
          'deepspeed_tpu_torch.runtime.activation_checkpointing',
          'deepspeed_tpu_torch.ops.flash_attention',
          'deepspeed_tpu_torch.ops.sparse_attention',
          'deepspeed_tpu_torch.ops.block_sparse_attention',
          'deepspeed_tpu_torch.ops.paged_attention',
          'deepspeed_tpu_torch.runtime.data_pipeline.data_sampler',
          'deepspeed_tpu_torch.runtime.data', 'deepspeed_tpu_torch.runtime.engine'):
    assert m in names, (m, names)
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert int(out.stdout.split()[-1]) >= 30


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_file_imports_jax_flax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_package_is_cheap():
    code = ("import sys, deepspeed_tpu_torch; "
            "heavy = [m for m in sys.modules if m.startswith("
            "'deepspeed_tpu_torch.') and m != 'deepspeed_tpu_torch.version' "
            "or m == 'torch']; assert not heavy, heavy")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=ROOT)


def test_entry_points_default_to_the_card():
    from deepspeed_tpu_torch.accelerator import get_device
    from deepspeed_tpu_torch.models import build_model

    assert get_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("tiny-llama")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device("cuda")


def test_kernel_sources_ship_with_the_package():
    import tomllib

    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]
    assert "ops/csrc/*.cu" in data["deepspeed_tpu_torch"]
    assert "ops/csrc/*.cuh" in data["deepspeed_tpu_torch"]   # hopper.cuh
    from deepspeed_tpu_torch.ops.kernels import SOURCES

    assert {"paged_attention", "quant_matmul", "grouped_matmul",
            "flash_attention", "block_sparse_attention"} <= set(SOURCES)
    for src in SOURCES.values():
        assert (PORT / "ops" / "csrc" / src).is_file(), src
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "deepspeed_tpu_torch/ops/build/" in ignored


def test_library_name_covers_the_source_every_header_and_the_flags(
        tmp_path, monkeypatch):
    """An edited source, header or flag gives another library name, so a
    stale build is never loaded."""
    from deepspeed_tpu_torch.ops import kernels

    (tmp_path / "flash_attention.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels._lib_path("flash_attention")
    assert first == kernels._lib_path("flash_attention")
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = kernels._lib_path("flash_attention")
    (tmp_path / "flash_attention.cu").write_text('#include "hopper.cuh"\n//\n')
    third = kernels._lib_path("flash_attention")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    fourth = kernels._lib_path("flash_attention")
    assert len({first, second, third, fourth}) == 4
    assert all(p.parent == kernels.BUILD for p in (first, fourth))
