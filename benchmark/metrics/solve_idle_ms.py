"""Device idle inside the solves, ms per unit of the traced window: the
time in which the host was inside a ``pcg`` span (the spans nested in it
included) and no operation ran on the device."""
from benchmark.metrics import program_spans


def read(ctx):
    spans = program_spans.log()
    solves = program_spans.named(spans, "pcg")
    if not solves:
        return None
    clock = program_spans.on_trace_clock(spans, ctx.trace)
    if not clock:
        return None
    idle = program_spans.idle_within(
        ctx.trace.busy, program_spans.union(clock[s.id] for s in solves))
    return idle / 1e3 / ctx.units
