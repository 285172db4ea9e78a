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
          'deepspeed_tpu_torch.moe', 'deepspeed_tpu_torch.moe.layer',
          'deepspeed_tpu_torch.moe.sharded_moe',
          'deepspeed_tpu_torch.ops.grouped_matmul'):
    assert m in names, (m, names)
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert int(out.stdout.split()[-1]) >= 15


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
    from deepspeed_tpu_torch.ops.kernels import SOURCES

    assert {"paged_attention", "quant_matmul", "grouped_matmul"} <= \
        set(SOURCES)
    for src in SOURCES.values():
        assert (PORT / "ops" / "csrc" / src).is_file(), src
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "deepspeed_tpu_torch/ops/build/" in ignored
