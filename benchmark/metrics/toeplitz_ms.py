"""Device ms of the kernels launched inside toeplitz_matvec scopes, per
unit of the traced window."""


def read(ctx):
    device_s = ctx.scope_s("toeplitz_matvec")
    return device_s * 1e3 / ctx.units if device_s > 0 else None
