"""Fixtures of the benchmark's own tests: a throwaway copy of the
benchmark with small cells, which the harness drives on the CPU."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the small cells' limits: the CPU path's own rounding sits far below them,
# every planted fault far above
SMALL_LIMITS = {
    "train": dict(mtot_gap=0, grad1_gap=1e-2, grad2_gap=1e-2, grad3_gap=1e-2,
                  change_gap=1e-2, sign_flips=0),
    "fit": dict(mtot_gap=0, mean_err=1e-4, var_err=5e-3, grad_err=1e-2),
}


def add_small_cells(root: Path):
    """Add a small 2-D configuration and its two cells to the benchmark at
    ``root``, by new files and new entries only."""
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((bench / "configs" / "se2d-1m.json").read_text())
    conf["data"].update(n=3000, targets=200)
    conf["kernel"]["lengthscale"] = 0.1
    conf["name"] = "small2d"
    (bench / "configs" / "small2d.json").write_text(json.dumps(conf))
    spec["configs"].append(dict(name="small2d", source="test", reduced=[],
                                file="benchmark/configs/small2d.json",
                                why="a test's"))
    for traffic in ("train", "fit"):
        name = f"small2d.{traffic}"
        spec["workloads"].append(dict(name=name, config="small2d",
                                      traffic=traffic, chips=1, why="test"))
        (bench / "limits" / f"{name}.json").write_text(
            json.dumps(SMALL_LIMITS[traffic]))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if any(w.endswith("." + traffic) for w in m.get("workloads", ())) \
                    and m["name"] != "fit_p95_ms":
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's folder with the small
    cells added."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_small_cells(tmp_path)
    torch.set_num_threads(2)
    return tmp_path
