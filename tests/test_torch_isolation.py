"""The port stands alone: ``gpquad_torch``, ``chip_smoke.py`` and
``scripts/port_compare_trees.py`` import neither JAX nor the JAX package
``gpquad``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "gpquad")


def _sources():
    files = sorted((ROOT / "gpquad_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.append(ROOT / "scripts" / "port_compare_trees.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_pulls_in_no_jax():
    code = ("import sys, gpquad_torch, gpquad_torch.convert, "
            "gpquad_torch.ops.cuda_nufft, gpquad_torch.ops.slq, "
            "gpquad_torch.ops.deflation, gpquad_torch.ops.kron_precond, "
            "gpquad_torch.kernels.params, gpquad_torch.models.model, "
            "gpquad_torch.models.gradient, gpquad_torch.models.pipeline, "
            "gpquad_torch.models.ski, gpquad_torch.ops.cuda_interp\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for module in ("gpquad_torch/models/gradient.py",
                   "gpquad_torch/models/pipeline.py",
                   "gpquad_torch/ops/slq.py", "gpquad_torch/ops/cuda_nufft.py",
                   "gpquad_torch/ops/deflation.py",
                   "gpquad_torch/ops/kron_precond.py",
                   "gpquad_torch/kernels/params.py",
                   "gpquad_torch/models/model.py",
                   "gpquad_torch/models/ski.py",
                   "gpquad_torch/ops/cuda_interp.py", "chip_smoke.py"):
        assert module in names, module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_forbidden_import_statements(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
