"""Faults planted under a loop's entry point, for the readings that set
the correctness limits and for the test that sees ``correct`` come out
false.  Each takes a loop and replaces its ``entry``."""
from __future__ import annotations


def half(loop):
    """Half of the points left out: the entry sees the first half of x, y
    (and of the data-space probes) and takes its means over them."""
    entry = loop.entry

    def call(x, y, *args, **kw):
        k = x.shape[0] // 2
        if kw.get("probes") is not None:
            Z, V = kw["probes"]
            kw = dict(kw, probes=(Z[:, :k], V))
        return entry(x[:k], y[:k], *args, **kw)
    loop.entry = call


def unchanged(loop):
    """A step that leaves the state unchanged: the gradient comes back
    zero, so Adam does not move the hypers."""
    entry = loop.entry

    def call(*args, **kw):
        res = entry(*args, **kw)
        return res._replace(grad=res.grad * 0)
    loop.entry = call


def altered(loop):
    """An answer altered where it is produced: the lengthscale's gradient
    changes sign, and the posterior mean at the first target moves by 1%
    of the largest."""
    entry = loop.entry

    def call(*args, **kw):
        res = entry(*args, **kw)
        grad = res.grad.clone()
        grad[0] = -grad[0]
        res = res._replace(grad=grad)
        if hasattr(res, "mean"):
            mean = res.mean.clone()
            mean[0] += 0.01 * mean.abs().max()
            res = res._replace(mean=mean)
        return res
    loop.entry = call


FAULTS = {"half": half, "unchanged": unchanged, "altered": altered}
