"""The harness on the CPU: cells, mixes and metrics found by name, the
result line, the import guard, and ``correct`` under planted faults."""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import faults, harness

ROOT = Path(__file__).resolve().parents[2]


def _digests(folder: Path):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()}


def test_new_config_traffic_and_metric_need_no_edit(bench_copy):
    """A configuration, a traffic mix and a per-layer metric added as new
    files with their entries are picked up; no file that was there
    changes."""
    bench = bench_copy / "benchmark"
    before = _digests(bench)
    mix = json.loads((bench / "traffic" / "train.json").read_text())
    mix.update(trace_samples=3, restart_every=4, trace_units=3)
    (bench / "traffic" / "short.json").write_text(json.dumps(mix))
    (bench / "limits" / "small2d.short.json").write_text(
        (bench / "limits" / "small2d.train.json").read_text())
    (bench / "metrics" / "units_seen.short.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    spec = json.loads((bench_copy / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name="small2d.short", config="small2d",
                                  traffic="short", chips=1, why="test"))
    spec["end_to_end"][0]["workloads"].append("small2d.short")
    spec["per_layer"].append(dict(
        name="units_seen.short", unit="steps", better="higher",
        source="program_counter", layer="entry points",
        moves="train_step_ms", workloads=["small2d.short"]))
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(_digests(bench)[k] == v for k, v in before.items())

    line, _ = harness.run_cell(bench_copy, "small2d.short", 7, 0.5, True,
                               "cpu")
    assert line["metrics"]["units_seen.short"] == dict(value=3.0,
                                                       unit="steps")
    assert line["correct"] and line["attempted"] == 3
    line, _ = harness.run_cell(bench_copy, "small2d.short", 7, 0.5, False,
                               "cpu")
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}


@pytest.mark.parametrize("cell", ["small2d.train", "small2d.fit"])
def test_result_line(bench_copy, cell):
    line, checks = harness.run_cell(bench_copy, cell, 2 ** 31 + 12345, 0.5,
                                    False, "cpu")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert all(lim is not None and v <= lim for _, v, lim in checks)
    assert line["metrics"]["setup_s"]["value"] > 0
    e2e = "train_step_ms" if cell.endswith("train") else "fit_ms"
    assert line["metrics"][e2e]["value"] > 0


@pytest.mark.parametrize("cell", ["small2d.train", "small2d.fit"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_faults_are_not_correct(bench_copy, cell, fault):
    """The timed path broken underneath, the rest of a run as it is:
    ``correct`` comes out false."""
    line, _ = harness.run_cell(bench_copy, cell, 99, 0.2, False, "cpu",
                               loop_hook=faults.FAULTS[fault])
    assert line["correct"] is False


def _short_train(root: Path, units: int):
    """small2d.train's loop with a restart every 4 steps, made to run
    ``units`` steps in its window."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    mix = json.loads((bench / "traffic" / "train.json").read_text())
    mix.update(trace_samples=3, restart_every=4)
    (bench / "traffic" / "every4.json").write_text(json.dumps(mix))
    (bench / "limits" / "small2d.every4.json").write_text(
        (bench / "limits" / "small2d.train.json").read_text())
    spec["workloads"].append(dict(name="small2d.every4", config="small2d",
                                  traffic="every4", chips=1, why="test"))
    spec["end_to_end"][0]["workloads"].append("small2d.every4")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    def hook(loop):
        loop.min_units = units
    return hook


def test_train_checks_a_block_after_a_restart(bench_copy):
    """A window that completes blocks after the first checks one of them,
    drawn from the seed, and the reference follows it from the start."""
    hook = _short_train(bench_copy, 11)
    cell = harness.cell_of(bench_copy, "small2d.every4")
    mod = harness.load_module(cell.loop_path)
    from benchmark import data
    inputs = data.make_inputs(cell.config)
    seen = set()
    for seed in (1, 2, 3, 4, 5):
        loop = mod.Loop(cell, inputs, seed, "cpu")
        hook(loop)
        loop.setup()
        for i in range(11):
            loop.unit(i)
        program = loop.outputs_program()
        assert program["checked"] in ([4, 5, 6], [8, 9, 10])
        seen.add(program["checked"][0])
        ref = mod.outputs_reference(cell, inputs, seed, program, "f64",
                                    "cpu")
        _, correct = harness.judge(mod.numbers(program, ref), cell.limits, 0)
        assert correct
    assert seen == {4, 8}


def test_a_fault_after_warm_up_is_not_correct(bench_copy):
    """The step altered only from its sixth call on (past set-up and the
    first block): the window's check still sees it."""
    short = _short_train(bench_copy, 8)

    def hook(loop):
        short(loop)
        entry, calls = loop.entry, [0]

        def call(*args, **kw):
            calls[0] += 1
            res = entry(*args, **kw)
            if calls[0] > 5:
                res = res._replace(grad=res.grad * 1.05)
            return res
        loop.entry = call
    line, _ = harness.run_cell(bench_copy, "small2d.every4", 3, 0.1, False,
                               "cpu", loop_hook=hook)
    assert line["attempted"] >= 8 and line["correct"] is False
    line, _ = harness.run_cell(bench_copy, "small2d.every4", 3, 0.1, False,
                               "cpu", loop_hook=short)
    assert line["attempted"] >= 8 and line["correct"] is True


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpquad_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpquad.fake", sys)
    assert harness.forbidden_modules() == ["gpquad"]


def test_import_path_loads_no_jax():
    """The harness's whole import path and a small run, in a fresh
    process: no module named jax, jaxlib, flax or gpquad is loaded."""
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1]);"
        "sys.path.insert(0, sys.argv[2]);"
        "from conftest import add_small_cells;"
        "import shutil, tempfile, pathlib, torch; torch.set_num_threads(2);"
        "from benchmark import harness, calibrate, faults;"
        "tmp = pathlib.Path(tempfile.mkdtemp());"
        "shutil.copy(sys.argv[1] + '/BENCHMARK.json', tmp);"
        "shutil.copytree(sys.argv[1] + '/benchmark', tmp / 'benchmark');"
        "add_small_cells(tmp);"
        "harness.run_cell(tmp, 'small2d.train', 1, 0.2, True, 'cpu');"
        "shutil.rmtree(tmp);"
        "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT),
                          str(Path(__file__).parent)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run_cli(cwd: Path):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "se2d-1m.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_cli_without_a_card_prints_no_result():
    out = _run_cli(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_cli_without_the_program_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
