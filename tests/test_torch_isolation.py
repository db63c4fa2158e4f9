"""The port stands alone: ``gpquad_torch``, ``chip_smoke.py`` and
``scripts/port_compare_trees.py`` import neither JAX nor the JAX package
``gpquad``, the Polya-Gamma estimators neither sklearn nor optax, and the
utilities neither orbax nor, when imported, the loaders' optional h5py,
pandas and PIL (imported inside the loaders that read those formats)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "gpquad")
# what gpquad's PG estimators import and the card's machine does not have
FORBIDDEN_PG = ("sklearn", "optax")
# gpquad's checkpoint backend, and the loaders' optional file-format
# packages, which the card's machine does not have
FORBIDDEN_UTILS = ("orbax",)
OPTIONAL = ("h5py", "pandas", "PIL")


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
            "gpquad_torch.models.ski, gpquad_torch.ops.cuda_interp, "
            "gpquad_torch.kernels.bessel, gpquad_torch.kernels.matern, "
            "gpquad_torch.models.pg_core, gpquad_torch.models.precision, "
            "gpquad_torch.models.gradient_high, "
            "gpquad_torch.models.variance_high, "
            "gpquad_torch.models.pg, gpquad_torch.models.pg_high, "
            "gpquad_torch.utils.f64_oracles, gpquad_torch.ops.spread_nufft, "
            "gpquad_torch.ops.spread_banded, gpquad_torch.models.sampling, "
            "gpquad_torch.utils, gpquad_torch.utils.profiling, "
            "gpquad_torch.utils.checkpoint, gpquad_torch.utils.loaders, "
            "gpquad_torch.native, gpquad_torch.parallel, "
            "gpquad_torch.parallel.sharding, "
            "gpquad_torch.parallel.msharded\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + FORBIDDEN_PG + FORBIDDEN_UTILS + OPTIONAL!r})\n"
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
                   "gpquad_torch/ops/cuda_interp.py",
                   "gpquad_torch/kernels/bessel.py",
                   "gpquad_torch/kernels/matern.py",
                   "gpquad_torch/models/pg_core.py",
                   "gpquad_torch/models/pg.py",
                   "gpquad_torch/models/pg_high.py",
                   "gpquad_torch/models/precision.py",
                   "gpquad_torch/models/gradient_high.py",
                   "gpquad_torch/models/variance_high.py",
                   "gpquad_torch/utils/f64_oracles.py",
                   "gpquad_torch/ops/spread_nufft.py",
                   "gpquad_torch/ops/spread_banded.py",
                   "gpquad_torch/models/sampling.py",
                   "gpquad_torch/utils/__init__.py",
                   "gpquad_torch/utils/profiling.py",
                   "gpquad_torch/utils/checkpoint.py",
                   "gpquad_torch/utils/loaders.py",
                   "gpquad_torch/native.py",
                   "gpquad_torch/parallel/__init__.py",
                   "gpquad_torch/parallel/sharding.py",
                   "gpquad_torch/parallel/msharded.py", "chip_smoke.py"):
        assert module in names, module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_forbidden_import_statements(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path))
                 & set(FORBIDDEN + FORBIDDEN_PG + FORBIDDEN_UTILS))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_optional_packages_not_imported_at_module_level():
    """h5py, pandas and PIL only inside the functions that need them (the
    loaders), never in a module's top-level statements."""
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for stmt in tree.body for n in ast.walk(stmt)
               if not isinstance(stmt, (ast.FunctionDef,
                                        ast.AsyncFunctionDef,
                                        ast.ClassDef))]
        roots = set()
        for node in top:
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        bad = sorted(roots & set(OPTIONAL))
        assert not bad, f"{path.relative_to(ROOT)} imports {bad} at the top"


def test_ops_do_not_load_the_loaders():
    """The ops open ``utils.profiling``'s scopes; importing them does not
    load the dataset loaders, which still resolve as ``gpquad_torch.utils``'s
    names."""
    code = ("import sys\n"
            "import gpquad_torch.ops.cg, gpquad_torch.ops.nufft, "
            "gpquad_torch.ops.toeplitz, gpquad_torch.ops.cuda_nufft\n"
            "loaded = 'gpquad_torch.utils.loaders' in sys.modules\n"
            "from gpquad_torch import utils\n"
            "from gpquad_torch.utils import load_synthetic_gp\n"
            "assert load_synthetic_gp.__module__ == "
            "'gpquad_torch.utils.loaders'\n"
            "assert all(callable(getattr(utils, n)) "
            "for n in utils.__all__)\n"
            "print(loaded)\n"
            "sys.exit(1 if loaded else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
