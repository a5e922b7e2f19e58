"""Import hygiene of the PyTorch port: no file of ``detectinblur_tpu_torch/``
and not ``chip_smoke.py`` imports JAX, Flax or the JAX package, and every
module of the port imports on a machine without nvcc or triton."""

import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "detectinblur_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "detectinblur_tpu"}
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def _top_level_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    # Exact top-level names: detectinblur_tpu_torch starts with
    # detectinblur_tpu but is not it.
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{path.name} imports {bad}"


def test_every_port_module_imports_without_jax_nvcc_or_triton():
    """In a fresh interpreter where importing jax, flax, triton or the JAX
    package fails and nvcc is off the PATH, every port module and the
    smoke script import, and none of them pulls in JAX."""
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {sorted(FORBIDDEN | {"triton"})!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
for m in {MODULES!r}:
    importlib.import_module(m)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(k.split(".")[0] in ("jax", "flax") for k in sys.modules)
print("ok")
"""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_default_to_cuda():
    """Without a card, an entry point raises unless the caller asks for
    the CPU; it never drops to the CPU on its own."""
    import torch

    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.ops.psf import sample_psf

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FasterRCNN(FasterRCNNConfig(precision="highest"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_psf(1, 0.005, 0.5, iters=10)
    assert sample_psf(1, 0.005, 0.5, iters=10, device="cpu").shape == (1, 128, 128)


def test_port_modules_listed():
    assert "detectinblur_tpu_torch.ops.roi_align_cuda" in MODULES
    for m in MODULES:
        assert importlib.util.find_spec(m) is not None, m
