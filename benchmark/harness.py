"""The benchmark of ``gpquad_torch`` on NVIDIA GPUs: one run of one cell.

Everything that belongs to one cell comes from files found by the names in
``BENCHMARK.json``: the configuration (``configs/<config>.json``), the
traffic mix (``traffic/<traffic>.json``, whose ``kind`` names the loop in
``loops/<kind>.py``), the correctness limits (``limits/<cell>.json``) and
one reader per per-layer metric (``metrics/<metric>.py``, or for a name
with a suffix such as ``nufft_ms.fit`` the shared ``metrics/nufft_ms.py``
where no file of the full name exists).  A run makes its
inputs from the seed, sets up and warms the cell's loop, measures a window
(or, traced, a few units under the profiler), and then judges what the
timed path produced against the plain reference in ``reference/``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark import data, profile_read, work

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpquad")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``gpquad_torch`` is not ``gpquad``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: Path):
    """A module from a file of this benchmark, by its path (its name may
    hold dots and dashes)."""
    name = "benchmark._loaded." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list            # the cell's end-to-end metric entries
    per_layer: list             # the cell's per-layer metric entries
    bench: Path                 # the benchmark's folder

    @property
    def loop_path(self) -> Path:
        return self.bench / "loops" / f"{self.traffic['kind']}.py"


def _reports(entry: dict, cell: str, e2e_names) -> bool:
    """A per-layer metric is read in the cells it lists, or without the
    list in every cell that reports the end-to-end metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry["moves"] in e2e_names


def cell_of(root: Path, workload: str) -> Cell:
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    w = cells[workload]
    bench = root / spec["paths"][0]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, e2e_names)]
    return Cell(name=workload, config=read_json(root / conf["file"]),
                traffic=read_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(bench / "limits" / f"{workload}.json"),
                chips=w["chips"], end_to_end=e2e, per_layer=per_layer,
                bench=bench)


def metric_path(bench: Path, name: str) -> Path:
    """The reader of a per-layer metric: its own file, else the one of
    the name before its first dot."""
    own = bench / "metrics" / f"{name}.py"
    return own if own.exists() else \
        bench / "metrics" / f"{name.split('.')[0]}.py"


def judge(numbers: dict, limits: dict, failed: int):
    """(checks, correct): each number beside its limit, and whether every
    one has a limit and lies within it with no unit failed."""
    checks = [(k, v, float(limits[k]) if k in limits else None)
              for k, v in numbers.items()]
    correct = failed == 0 and all(
        lim is not None and math.isfinite(v) and v <= lim
        for _, v, lim in checks)
    return checks, correct


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    units: int
    seconds: float
    unit_seconds: list = field(default_factory=list)


def timed_window(loop, seconds: float, device) -> Window:
    """Units back to back until ``seconds`` have passed (and at least the
    loop's ``min_units``), ended by a synchronise: all the work and all the
    time of the window."""
    i, times = loop.first_unit, []
    last = loop.first_unit + getattr(loop, "min_units", 1)
    t0 = time.perf_counter()
    while True:
        times.append(loop.unit(i))
        i += 1
        if i >= last and time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return Window(units=i - loop.first_unit, seconds=time.perf_counter() - t0,
                  unit_seconds=times)


class _ShapeRecorder:
    """Records (type, d, n, mtot, B) of every NUFFT apply while active, by
    wrapping the type1/type2 methods of the program's operators."""

    def __init__(self, classes):
        self.classes = classes
        self.calls = []
        self._keep = []

    def __enter__(self):
        for cls in self.classes:
            for kind in (1, 2):
                name = f"type{kind}"
                orig = getattr(cls, name)
                self._keep.append((cls, name, orig))
                setattr(cls, name, self._wrap(orig, kind))
        return self

    def _wrap(self, orig, kind):
        calls = self.calls

        def apply(op, vals):
            per = op.n if kind == 1 else op.mtot ** op.d
            calls.append((kind, op.d, op.n, op.mtot, vals.numel() // per))
            return orig(op, vals)
        return apply

    def __exit__(self, *exc):
        for cls, name, orig in self._keep:
            setattr(cls, name, orig)
        return False


def nufft_classes():
    """The program's exact NUFFT operators: the kernels' and the plain
    phase matrices' (the CPU path)."""
    from gpquad_torch.ops import cuda_nufft, nufft
    return [cuda_nufft.CudaNUFFT, nufft.NUFFT]


@dataclass
class Context:
    """What a per-layer metric's reader reads."""
    units: int
    window_s: float
    busy_s: float
    trace: profile_read.Trace
    nufft_calls: list
    counters: dict
    work = work

    def scope_s(self, name: str) -> float:
        return self.trace.scope_s(name)


def traced_window(loop, units: int, device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with _ShapeRecorder(nufft_classes()) as rec:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(loop.first_unit, loop.first_unit + units):
                loop.unit(i)
            sync(device)
            window_s = time.perf_counter() - t0
    trace = profile_read.Trace(profile_read.export_events(prof))
    return Window(units=units, seconds=window_s), trace, rec.calls


def device_info(device, chips: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                    count=chips,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                        dev)))
    return dict(platform="cpu", kind="cpu", count=chips, memory_peak_bytes=0)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start=None, loop_hook=None):
    """One run.  Returns (result line, checks): the checks are
    (name, value, limit) of each number compared."""
    t_start = time.perf_counter() if t_start is None else t_start
    parts = [("imports", time.perf_counter())]
    cell = cell_of(root, workload)
    inputs = data.make_inputs(cell.config)
    parts.append(("inputs", time.perf_counter()))
    mod = load_module(cell.loop_path)
    loop = mod.Loop(cell, inputs, seed, device)
    if loop_hook is not None:
        loop_hook(loop)
    sync(device)
    parts.append(("program", time.perf_counter()))
    loop.setup()
    sync(device)
    parts.append(("warm", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("setup_s " + " ".join(
        f"{name} {t1 - t0:.3f}" for (_, t0), (name, t1)
        in zip([("", t_start)] + parts, parts)), file=sys.stderr)

    if trace:
        window, tr, calls = traced_window(
            loop, max(int(cell.traffic["trace_units"]),
                      getattr(loop, "min_units", 1)), device)
    else:
        window, tr, calls = timed_window(loop, seconds, device), None, []
    dev_info = device_info(device, cell.chips)
    counters = loop.counters()
    failed = loop.failed()
    program = loop.outputs_program()
    loop.release()
    del loop
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    reference = mod.outputs_reference(cell, inputs, seed, program, "f64",
                                      device)
    checks, correct = judge(mod.numbers(program, reference), cell.limits,
                            failed)
    iters = counters.get("pcg_iters") or [0]
    print(f"window units {window.units} seconds {window.seconds:.3f} "
          f"pcg_iters per unit {sum(iters) / len(iters):.3f} "
          f"checked {program.get('checked')}", file=sys.stderr)

    metrics = {}
    if trace:
        ctx = Context(units=window.units, window_s=window.seconds,
                      busy_s=tr.busy_s, trace=tr, nufft_calls=calls,
                      counters=counters)
        for m in cell.per_layer:
            value = load_module(metric_path(cell.bench, m["name"])
                                ).read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        dev_info.update(busy_s=tr.busy_s, window_s=window.seconds)
    else:
        values = mod.end_to_end(window)
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = dict(value=setup_s, unit="s")
            else:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    line = dict(correct=bool(correct), attempted=window.units, failed=failed,
                metrics=metrics, device=dev_info)
    if trace:
        line["breakdown"] = dict(device_ops=tr.device_ops(),
                                 idle_gaps=tr.idle_gaps())
    line["checks"] = {k: dict(value=v, limit=lim) for k, v, lim in checks}
    return line, checks


def main(argv=None, t_start=None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = BENCH.parent
    cell = cell_of(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, checks = run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0
