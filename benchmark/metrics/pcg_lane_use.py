"""The share of the batched lanes' steps that the solves needed: 100 x the
sum of ``pcg_active_lane_steps`` over the sum of B x ``pcg_steps``, over
every ``pcg`` span of the traced window, in %."""
from benchmark.metrics import program_spans


def read(ctx):
    solves = program_spans.named(program_spans.log(), "pcg")
    launched = sum(s.attrs["B"] * s.counters["pcg_steps"] for s in solves
                   if "pcg_steps" in s.counters)
    active = program_spans.counter_sum(solves, "pcg_active_lane_steps")
    if active is None or launched <= 0:
        return None
    return 100.0 * active / launched
