"""PCG iterations per unit of the traced window: the mean solve's and the
batched trace solve's, as the result reports them."""


def read(ctx):
    iters = ctx.counters.get("pcg_iters")
    return sum(iters) / len(iters) if iters else None
