"""Device ms of the kernels launched inside the nufft_type1 /
nufft_type2 scopes, per unit of the traced window."""

SCOPES = ("nufft_type1", "nufft_type2")


def read(ctx):
    device_s = sum(ctx.scope_s(s) for s in SCOPES)
    return device_s * 1e3 / ctx.units if device_s > 0 else None
