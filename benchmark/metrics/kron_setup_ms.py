"""The Kronecker preconditioner's set-up on the device's timeline, ms per
unit of the traced window: for each ``kron_setup`` span, from the later of
its start and the end of the device work queued before it, to the later of
its end and the end of the last device operation launched inside it.  The
set-up's ``eigh`` waits for the device, so its span also holds the wait
for the work queued ahead of it (the lag table's NUFFT); that wait is not
the set-up's."""
from benchmark.metrics import program_spans


def read(ctx):
    spans = program_spans.log()
    kron = program_spans.named(spans, "kron_setup")
    if not kron:
        return None
    clock = program_spans.on_trace_clock(spans, ctx.trace)
    if not clock:
        return None
    total = 0.0
    for s in kron:
        start, end = clock[s.id]
        ready = program_spans.queue_end(ctx.trace, start)
        done = program_spans.device_end(ctx.trace, s.tid, start, end)
        total += max(0.0, done - ready)
    return total / 1e3 / ctx.units
