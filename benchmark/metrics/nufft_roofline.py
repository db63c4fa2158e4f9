"""The NUFFT layer's share of its roofline: the least time of every NUFFT
call in the traced window (``work.least_ms`` of its recorded shape) over
the device time of the kernels launched inside the nufft_type1 /
nufft_type2 scopes, in %; nothing without calls."""

SCOPES = ("nufft_type1", "nufft_type2")


def read(ctx):
    device_s = sum(ctx.scope_s(s) for s in SCOPES)
    if not ctx.nufft_calls or device_s <= 0:
        return None
    least_s = sum(ctx.work.least_ms(*c)[0] for c in ctx.nufft_calls) / 1e3
    return 100.0 * least_s / device_s
