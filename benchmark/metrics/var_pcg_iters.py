"""PCG iterations of the variance's solves per unit of the traced window:
``pcg_iters`` of the ``pcg`` spans whose parent is a ``variance`` span."""
from benchmark.metrics import program_spans


def read(ctx):
    spans = program_spans.log()
    variance = {s.id for s in program_spans.named(spans, "variance")}
    iters = program_spans.counter_sum(
        [s for s in program_spans.named(spans, "pcg")
         if s.parent in variance], "pcg_iters")
    return iters / ctx.units if iters is not None else None
