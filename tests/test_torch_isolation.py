"""The PyTorch port stands alone: it imports neither ``jax`` nor anything
of the JAX package ``deepspeed_tpu`` (whose ``__init__`` imports jax and
the engine), and neither does ``chip_smoke.py``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deepspeed_tpu_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "deepspeed_tpu")


def _imports(path: Path):
    """Every absolute module name a file imports (relative imports stay
    inside the port by construction)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].is_file()
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_match_is_exact_not_prefix():
    assert _forbidden("deepspeed_tpu") and _forbidden("deepspeed_tpu.models")
    assert _forbidden("jax.numpy")
    assert not _forbidden("deepspeed_tpu_torch")
    assert not _forbidden("deepspeed_tpu_torch.models.gpt2")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, deepspeed_tpu_torch.inference, "
            "deepspeed_tpu_torch.models, "
            "deepspeed_tpu_torch.ops.transformer.paged_attention\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepspeed_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """No nvcc, no kernels: the builder raises instead of falling back."""
    from deepspeed_tpu_torch.ops.op_builder import cuda as builder
    monkeypatch.setattr(builder.os, "access", lambda *a: False)
    monkeypatch.setattr(builder.shutil, "which", lambda *a: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        builder.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        builder.build_all(["paged_attention"])
