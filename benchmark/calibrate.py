"""Readings that set a cell's correctness limits, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control tf32|f32] [--fault half|unchanged|altered] [--units N]

For each seed: the program's numbers against the reference (the lower
reading), with ``--control tf32`` the control's (the reference computed in
TF32 put in the program's place; the upper reading), with ``--control f32``
a witness's (the reference in plain float32), with ``--fault`` the
numbers of the program with that fault planted under its entry point.
Each seed runs ``--units`` units after set-up, at the cell's own load:
fused cells that many calls, of which a sample is checked; training cells
that many steps from step 0 (3: the first block; 23 or more: a block after
a restart, as a window's check draws it).  One JSON line per seed on
standard output, each reading with its verdict under the cell's own
limits file by the rule a run uses (``harness.judge``): ``program_correct``
(the program, or the program with the fault planted) and
``control_correct`` (the control).  The benchmark's own runs do not run
this.
"""
import json
import sys
import time
from pathlib import Path


def _grads(out):
    """The gradients an output holds, as lists (for the look at a cell
    whose readings spread)."""
    if "grads" in out:
        return [g.tolist() for g in out["grads"]]
    return [c[2].tolist() for c in out["calls"].values()]


def main(argv=None) -> int:
    import argparse
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    from benchmark import data, faults, harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", choices=("tf32", "f32"))
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--units", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    root = harness.BENCH.parent
    cell = harness.cell_of(root, args.workload)
    mod = harness.load_module(cell.loop_path)
    for seed in args.seeds:
        inputs = data.make_inputs(cell.config)
        loop = mod.Loop(cell, inputs, seed, args.device)
        if args.fault:
            faults.FAULTS[args.fault](loop)
        t0 = time.perf_counter()
        loop.setup()
        for i in range(loop.first_unit, loop.first_unit + args.units):
            loop.unit(i)
        harness.sync(args.device)
        prog_s = time.perf_counter() - t0
        program, failed = loop.outputs_program(), loop.failed()
        loop.release()
        del loop
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = mod.outputs_reference(cell, inputs, seed, program, "f64",
                                    args.device)
        ref_s = time.perf_counter() - t0
        numbers = mod.numbers(program, ref)
        row = dict(seed=seed, fault=args.fault, program_s=prog_s,
                   reference_s=ref_s, checked=program.get("checked"),
                   program=numbers, program_correct=harness.judge(
                       numbers, cell.limits, failed)[1])
        if args.control:
            t0 = time.perf_counter()
            ctrl = mod.outputs_reference(cell, inputs, seed, program,
                                         args.control, args.device)
            row["control_s"] = time.perf_counter() - t0
            row[args.control] = mod.numbers(mod.as_program(ctrl), ref)
            row["control_correct"] = harness.judge(
                row[args.control], cell.limits, 0)[1]
            row["grads"] = dict(program=_grads(program),
                                ref=_grads(mod.as_program(ref)),
                                control=_grads(mod.as_program(ctrl)))
        print(json.dumps(row), flush=True)
        del ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
