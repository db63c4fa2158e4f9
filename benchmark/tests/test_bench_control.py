"""The correctness check's control on the card: the reference computed in
TF32, put in the program's place, comes out not correct under the cell's
own limits by the rule a run uses, where the program comes out correct,
and reads well above the program against the float64 reference.  At the
cells' own sizes this is benchmark/calibrate.py --control; here a 2-D
training cell and a 3-D fit at sizes a test run holds, under the limits
of the cells they are cut from.  Run on the card with
``python -m pytest benchmark/tests -m cuda``."""
import json

import pytest
import torch

from benchmark import data, harness


def _mid_cells(root):
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for base, name, n, ell in (("se2d-1m", "mid2d", 200_000, 0.01),
                               ("se3d-roads", "mid3d", 100_000, 0.1)):
        conf = json.loads((bench / "configs" / f"{base}.json").read_text())
        conf["data"].update(n=n, targets=2000)
        conf["kernel"]["lengthscale"] = ell
        (bench / "configs" / f"{name}.json").write_text(json.dumps(conf))
        spec["configs"].append(dict(name=name, source="test", reduced=[],
                                    file=f"benchmark/configs/{name}.json",
                                    why="test"))
        for traffic in ("train", "fit"):
            spec["workloads"].append(dict(name=f"{name}.{traffic}",
                                          config=name, traffic=traffic,
                                          chips=1, why="test"))
            limits = bench / "limits" / f"{base}.{traffic}.json"
            (bench / "limits" / f"{name}.{traffic}.json").write_text(
                limits.read_text() if limits.exists() else "{}")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mid2d.train", "mid3d.fit"])
def test_control_reads_above_the_program(bench_copy, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 exists only "
                    "on the card")
    _mid_cells(bench_copy)
    c = harness.cell_of(bench_copy, cell)
    mod = harness.load_module(c.loop_path)
    for seed in (1, 2, 3):
        inputs = data.make_inputs(c.config)
        loop = mod.Loop(c, inputs, seed, "cuda:0")
        loop.setup()
        for i in range(loop.first_unit,
                       loop.first_unit + getattr(loop, "min_units", 2)):
            loop.unit(i)
        program = loop.outputs_program()
        loop.release()
        ref = mod.outputs_reference(c, inputs, seed, program, "f64",
                                    "cuda:0")
        ctrl = mod.outputs_reference(c, inputs, seed, program, "tf32",
                                     "cuda:0")
        prog_n = mod.numbers(program, ref)
        ctrl_n = mod.numbers(mod.as_program(ctrl), ref)
        ratios = [ctrl_n[k] / max(prog_n[k], 1e-300) for k in prog_n
                  if k not in ("mtot_gap", "sign_flips")]
        assert max(ratios) >= 3, (seed, prog_n, ctrl_n)
        assert harness.judge(prog_n, c.limits, 0)[1], (seed, prog_n)
        assert not harness.judge(ctrl_n, c.limits, 0)[1], (seed, ctrl_n)
