"""PCG loop steps launched per unit of the traced window, over every solve
(the mean's, the gradient's mean and trace, the variance's): the sum of the
program's ``pcg_steps`` counters on its ``pcg`` spans."""
from benchmark.metrics import program_spans


def read(ctx):
    steps = program_spans.counter_sum(
        program_spans.named(program_spans.log(), "pcg"), "pcg_steps")
    return steps / ctx.units if steps is not None else None
