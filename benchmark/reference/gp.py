"""Plain reference of the EFGP computations the benchmark times: the grid
plan, the quadrature weights, the direct-sum NUFFT, the Toeplitz Gram, the
Kronecker-preconditioned CG, and from them the posterior mean, the stochastic
variance and the hyper-gradient, for the squared-exponential kernel at
d = 2 and 3.

It is written from the mathematics alone, in plain PyTorch, and imports
nothing of the program.  Every NUFFT is a direct sum over blocks of points
as products of per-axis phase matrices (real GEMMs, so that the precision of
every product is the one asked for), and the Gram apply is a linear
convolution by FFT.  The solves are the configured algorithm itself: CG
from the stated start, preconditioned by the separable approximation of the
system, stopped at the stated relative residual; in exact arithmetic it
gives what a sound program gives, so the comparison sees rounding and not
the solves' truncation.  A stop decision that rounding could turn is read
both ways (``Solve``).

Precision ``"f64"`` is the reference.  ``"tf32"`` is its control: the same
computation in float32 with every matrix product in TF32, the angles
t = h x and the phases rounded to float32.  ``"f32"`` is a witness: plain float32, TF32 off.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
import torch

# elements of a block of phase products (complex), which bounds memory
_BLOCK_ELEMS = 1 << 26


@dataclass(frozen=True)
class Precision:
    name: str
    real: torch.dtype
    cplx: torch.dtype
    tf32: bool


F64 = Precision("f64", torch.float64, torch.complex128, False)
TF32 = Precision("tf32", torch.float32, torch.complex64, True)
F32 = Precision("f32", torch.float32, torch.complex64, False)
PRECISIONS = {"f64": F64, "tf32": TF32, "f32": F32}


@contextlib.contextmanager
def matmul_precision(prec: Precision):
    """TF32 on for the control, off for the reference; restored after."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = prec.tf32
    torch.backends.cudnn.allow_tf32 = prec.tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


# ---------------------------------------------------------------------------
# the grid plan: a frozen copy of the integral method (float64 bisection)
# ---------------------------------------------------------------------------

def _bisect(f, eps, upper=1000.0, iters=200, doublings=10):
    """L with f(L) ~= eps for a decreasing f: doublings of an upper bound,
    then bisection until a step changes nothing."""
    b = upper
    for _ in range(doublings):
        if not f(b) > eps:
            break
        b *= 2.0
    a = 0.0
    for _ in range(iters):
        mid = 0.5 * (a + b)
        if f(mid) > eps:
            if mid == a:
                break
            a = mid
        else:
            if mid == b:
                break
            b = mid
    return 0.5 * (a + b)


def se_plan(lengthscale, variance, eps, L, d):
    """(h, mtot) for the SE kernel: h = 1 / (L + Ltime) with k(Ltime) = eps,
    and hm = ceil(Lfreq / h) with |r|^(d-1) S(r) / S(0) = eps."""
    l2 = lengthscale * lengthscale

    def k(r):
        return variance * math.exp(-0.5 * r * r / l2)

    def tail(r):
        return abs(r ** (d - 1)) * math.exp(-2.0 * math.pi ** 2 * l2 * r * r)

    h = 1.0 / (L + _bisect(k, eps))
    hm = int(math.ceil(_bisect(tail, eps) / h - 1e-12))
    return h, 2 * hm + 1


def se_axis_weights(lengthscale, h, mtot):
    """The SE spectral density's 1-D factor times h, on the nodes j h,
    j = -m..m (float64): S(xi) h^d = variance * prod over axes of it."""
    m = (mtot - 1) // 2
    xi = torch.arange(-m, m + 1, dtype=torch.float64) * h
    return (math.sqrt(2 * math.pi) * lengthscale * h
            * torch.exp(-2 * math.pi ** 2 * lengthscale ** 2 * xi * xi))


def outer_flat(vecs):
    """Outer product over the last axis, flattened row-major; leading
    axes are batch."""
    out = vecs[0]
    for v in vecs[1:]:
        out = (out[..., :, None] * v[..., None, :]).reshape(
            *out.shape[:-1], -1)
    return out


# ---------------------------------------------------------------------------
# direct sums
# ---------------------------------------------------------------------------

def cmatmul(a, b):
    """Complex product by real matrix products (TF32 where enabled)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


class DirectSum:
    """NUFFTs of the points ``x`` ((n, d), float64) by direct summation:
    type-1 F* c[k] = sum_n c_n exp(-2 pi i h <k, x_n>), type-2
    F f[n] = sum_k f_k exp(+2 pi i h <k, x_n>), modes k in [-m, m]^d in
    row-major order."""

    def __init__(self, x, h, prec: Precision):
        self.x = x.to(torch.float64)
        self.h = h
        self.prec = prec

    @property
    def n(self):
        return self.x.shape[0]

    def _phases(self, rows, mtot):
        """Per-axis exp(-2 pi i t k) of the rows, t = h x: in float64 for
        the reference; for float32, t rounded to float32 as a float32 run
        rounds it, then the phases from that t rounded to float32."""
        m = (mtot - 1) // 2
        k = torch.arange(-m, m + 1, dtype=torch.float64, device=self.x.device)
        out = []
        for d in range(self.x.shape[1]):
            t = self.x[rows, d].to(self.prec.real) * torch.tensor(
                self.h, dtype=self.prec.real)
            p = t.to(torch.float64)[:, None] * k[None, :]
            ang = -2 * math.pi * (p - torch.round(p))
            out.append(torch.polar(torch.ones_like(ang), ang)
                       .to(self.prec.cplx))
        return out

    def _blocks(self, width):
        step = max(1024, _BLOCK_ELEMS // max(width, 1))
        for s in range(0, self.n, step):
            yield slice(s, min(s + step, self.n))

    def type1(self, c, mtot):
        """(B, n) -> (B, mtot^d)."""
        c = c.to(self.prec.cplx)
        B, d = c.shape[0], self.x.shape[1]
        mlead = mtot ** (d - 1)
        out = torch.zeros((B * mlead, mtot), dtype=self.prec.cplx,
                          device=c.device)
        for rows in self._blocks(B * mlead):
            ph = self._phases(rows, mtot)
            lead = outer_flat(ph[:-1])                    # (nb, mlead)
            a = lead[None] * c[:, rows, None]             # (B, nb, mlead)
            a = a.transpose(1, 2).reshape(B * mlead, -1)
            out += cmatmul(a, ph[-1])
        return out.reshape(B, mlead * mtot)

    def type2(self, f, mtot):
        """(B, mtot^d) -> (B, n)."""
        f = f.to(self.prec.cplx)
        B, d = f.shape[0], self.x.shape[1]
        mlead = mtot ** (d - 1)
        # (mlead, B * mtot): the modes of the leading axes by the vectors'
        # last-axis modes
        fm = f.reshape(B, mlead, mtot).transpose(0, 1).reshape(mlead, -1)
        out = torch.empty((B, self.n), dtype=self.prec.cplx, device=f.device)
        for rows in self._blocks(max(mlead, B * mtot)):
            ph = [p.conj() for p in self._phases(rows, mtot)]
            lead = outer_flat(ph[:-1])                    # (nb, mlead)
            g = cmatmul(lead, fm).reshape(-1, B, mtot)
            out[:, rows] = (g * ph[-1][:, None, :]).sum(-1).T
        return out


# ---------------------------------------------------------------------------
# the Gram, its preconditioner and CG
# ---------------------------------------------------------------------------

def next_smooth(n):
    """Smallest 2,3,5,7-smooth integer >= n."""
    while True:
        k = n
        for p in (2, 3, 5, 7):
            while k % p == 0:
                k //= p
        if k == 1:
            return n
        n += 1


class Gram:
    """T beta[j] = sum_k v[j - k] beta[k] with the lag table
    v[l] = sum_n exp(-2 pi i h <l, x_n>), l in [-(mtot-1), mtot-1]^d, as a
    linear convolution by FFT."""

    def __init__(self, ds: DirectSum, mtot, d):
        self.mtot, self.d = mtot, d
        ones = torch.ones((1, ds.n), dtype=ds.prec.cplx, device=ds.x.device)
        L = 2 * mtot - 1
        self.v = ds.type1(ones, L).reshape((L,) * d)
        self.size = (next_smooth(L),) * d
        self.dims = tuple(range(-d, 0))
        self.vf = torch.fft.fftn(self.v, s=self.size, dim=self.dims)

    def __call__(self, beta):
        B = beta.shape[0]
        mtot, d = self.mtot, self.d
        xb = beta.reshape((B,) + (mtot,) * d)
        y = torch.fft.ifftn(torch.fft.fftn(xb, s=self.size, dim=self.dims)
                            * self.vf, dim=self.dims)
        sl = (slice(None),) + (slice(mtot - 1, 2 * mtot - 1),) * d
        return y[sl].reshape(B, -1)

    def marginal(self, axis):
        """(mtot, mtot) Toeplitz matrix of the lags along ``axis``, the
        other axes at lag 0."""
        mtot = self.mtot
        idx = tuple(slice(None) if a == axis else mtot - 1
                    for a in range(self.d))
        vi = self.v[idx]
        j = torch.arange(mtot, device=vi.device)
        return vi[j[:, None] - j[None, :] + mtot - 1]


class KronPrecond:
    """Separable approximation of A = D T D + s I:
    P = var (M_1 x ... x M_d) / n^(d-1) + s I, M_i = diag(w) T_i diag(w)
    with T_i the marginal Toeplitz matrices and w the SE weights' 1-D
    factor; inverted through the eigendecompositions of the M_i."""

    def __init__(self, gram: Gram, w1, variance, shift, n):
        d = gram.d
        self.d, self.mtot = d, gram.mtot
        self.Us, lams = [], []
        for i in range(d):
            Ti = gram.marginal(i).to(torch.complex128)
            wi = w1.to(torch.float64)
            Mi = wi[:, None] * Ti * wi[None, :]
            lam, U = torch.linalg.eigh(0.5 * (Mi + Mi.conj().T))
            lams.append(torch.clamp(lam, min=0.0))
            self.Us.append(U.to(gram.v.dtype))
        prod = outer_flat(lams)
        self.denom = (variance * prod / n ** (d - 1) + shift).to(
            gram.v.real.dtype)

    def _modes(self, X, mats):
        for i, Mi in enumerate(mats):
            X = torch.movedim(X, i + 1, -1)
            shp = X.shape
            X = cmatmul(X.reshape(-1, self.mtot), Mi.T).reshape(shp)
            X = torch.movedim(X, -1, i + 1)
        return X

    def __call__(self, r):
        B = r.shape[0]
        X = r.reshape((B,) + (self.mtot,) * self.d)
        Y = self._modes(X, [U.conj().T for U in self.Us])
        Y = Y / self.denom.reshape((1,) + (self.mtot,) * self.d)
        return self._modes(Y, self.Us).reshape(B, -1)


# the stop rule's rounding band: a row whose relative residual lies within
# this share of the tolerance may stop one iteration earlier or later in a
# run that rounds otherwise
STOP_BAND = 1e-2
VARIANTS = ("mid", "lo", "hi")


class Solve:
    """Solutions of a batched PCG under three readings of its stop rule:
    "mid" stops each row at its first relative residual under tol, "lo"
    under tol (1 + STOP_BAND), "hi" under tol (1 - STOP_BAND)."""

    def __init__(self, xs):
        self.xs = xs

    def get(self, variant):
        return self.xs[variant]

    def differs(self, variant):
        return variant != "mid" and not torch.equal(self.xs[variant],
                                                    self.xs["mid"])


def pcg(A, b, M_inv, tol, maxiter, x0=None) -> Solve:
    """Batched PCG on the rows of b from x0 (zero when None), the
    preconditioned recurrence and the stop rule of the EFGP solves: a row
    stops once ||r|| / ||b|| < tol (or ||r|| < 1e-12), checked before the
    first iteration and after each."""
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    r = b - A(x) if x0 is not None else b.clone()
    z = M_inv(r)
    p = z.clone()
    rz = (r.conj() * z).sum(-1).real
    bn = torch.linalg.vector_norm(b, dim=-1)
    bn = torch.where(bn > 0, bn, torch.ones_like(bn))
    levels = {"lo": tol * (1 + STOP_BAND), "mid": tol,
              "hi": tol * (1 - STOP_BAND)}
    xs = {v: x.clone() for v in levels}
    stopped = {v: torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
               for v in levels}

    def mark(x, r):
        rn = torch.linalg.vector_norm(r, dim=-1)
        for v, lev in levels.items():
            new = ~stopped[v] & ((rn / bn < lev) | (rn < 1e-12))
            xs[v] = torch.where(new[:, None], x, xs[v])
            stopped[v] |= new
        return ~stopped["hi"]

    active = mark(x, r)
    for _ in range(maxiter):
        if not bool(active.any()):
            break
        Ap = A(p)
        pAp = (p.conj() * Ap).sum(-1).real
        # a breakdown (the operator, rounded, is no longer positive
        # definite along p) stops the row where it is
        broken = active & ~(pAp > 0)
        for v in levels:
            xs[v] = torch.where((broken & ~stopped[v])[:, None], x, xs[v])
            stopped[v] |= broken
        active &= ~broken
        alpha = torch.where(active, rz / torch.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = M_inv(r)
        rz_new = (r.conj() * z).sum(-1).real
        beta = torch.where(active, rz_new / torch.where(rz == 0, 1.0, rz),
                           0.0)
        p = torch.where(active[:, None], z + beta[:, None] * p, p)
        rz = torch.where(active, rz_new, rz)
        active = mark(x, r)
    for v in levels:
        xs[v] = torch.where(stopped[v][:, None], xs[v], x)
    return Solve(xs)


# ---------------------------------------------------------------------------
# the EFGP quantities
# ---------------------------------------------------------------------------

@dataclass
class Tolerances:
    """Relative residuals and iteration caps of the solves, as the
    configuration and the traffic state them."""
    mean: float
    mean_iters: int
    var: float = 0.0
    var_iters: int = 0
    grad: float = 0.0


def tolerances_of(config: dict, traffic: dict) -> Tolerances:
    cg = traffic["cg_tol"]
    return Tolerances(mean=cg, mean_iters=traffic["max_cg_iter"],
                      var=traffic.get("var_cg_tol", cg),
                      var_iters=config.get("var_max_cg_iter",
                                           traffic["max_cg_iter"]),
                      grad=traffic.get("grad_cg_tol", cg))


class SEModel:
    """The EFGP model of the SE kernel on the points x with targets y, on
    the grid (h, mtot); the lag table is made once and serves every hyper
    value.  The solves are kron-preconditioned CG to the stated
    tolerances; each output comes under every reading of the stop rule
    that changes it ({variant: value}, "mid" always)."""

    def __init__(self, x, y, h, mtot, prec: Precision = F64):
        self.prec = prec
        self.d = x.shape[1]
        self.h, self.mtot = h, mtot
        self.ds = DirectSum(x, h, prec)
        self.y = y.to(torch.float64).to(prec.cplx)
        with matmul_precision(prec):
            self.gram = Gram(self.ds, mtot, self.d)
            self.Fy = self.ds.type1(self.y[None], mtot)[0]

    @property
    def n(self):
        return self.ds.n

    def _hypers(self, lengthscale, variance):
        """ws = sqrt(S h^d) (M,), its 1-D factor without the variance, and
        D' (M, 2): dS/dl h^d and dS/dvariance h^d on the grid."""
        d, mtot, h = self.d, self.mtot, self.h
        w1 = se_axis_weights(lengthscale, h, mtot)
        s = variance * outer_flat([w1] * d)                   # S h^d
        m = (mtot - 1) // 2
        xi = torch.arange(-m, m + 1, dtype=torch.float64) * h
        nsq = sum(g * g for g in torch.meshgrid(*([xi] * d), indexing="ij"))
        nsq = nsq.reshape(-1)
        dl = s * (d / lengthscale - (2 * math.pi) ** 2 * lengthscale * nsq)
        dv = s / variance
        dev = self.y.device
        ws = torch.sqrt(s).to(dev, self.prec.real)
        dprime = torch.stack([dl, dv], dim=-1).to(dev, self.prec.real)
        return ws, torch.sqrt(w1).to(dev, self.prec.real), dprime

    def _system(self, ws, w1, variance, sigmasq, scale):
        """(A, M_inv) of (D T D + s I) / scale (scale 1: the mean system;
        scale sigma^2: the variance system)."""
        pre = KronPrecond(self.gram, w1, variance, sigmasq, self.n)

        def A(v):
            return (ws * self.gram(ws * v) + sigmasq * v) / scale

        def M_inv(r):
            return pre(r) * scale
        return A, M_inv

    def fit(self, lengthscale, variance, sigmasq, tol: Tolerances) -> Solve:
        """beta_raw of the mean solve A beta = D F* y, from zero."""
        ws, w1, _ = self._hypers(lengthscale, variance)
        with matmul_precision(self.prec):
            A, M_inv = self._system(ws, w1, variance, sigmasq, 1.0)
            return pcg(A, (ws * self.Fy)[None], M_inv, tol.mean,
                       tol.mean_iters)

    def predict_mean(self, fit: Solve, xq, lengthscale, variance):
        ws, _, _ = self._hypers(lengthscale, variance)
        dq = DirectSum(xq, self.h, self.prec)
        with matmul_precision(self.prec):
            return {v: dq.type2(ws * fit.get(v), self.mtot)[0].real
                    for v in VARIANTS if v == "mid" or fit.differs(v)}

    def variance(self, etas, xq, lengthscale, variance, sigmasq,
                 tol: Tolerances):
        """Hutchinson variance at xq from the +-1 probes etas (P, M): solve
        A_var u = D eta, cross-correlate g = D u with eta over the lags
        [-(mtot-1), mtot-1]^d, sum over the probes, evaluate at xq."""
        ws, w1, _ = self._hypers(lengthscale, variance)
        mtot, d = self.mtot, self.d
        L = 2 * mtot - 1
        size = (next_smooth(L),) * d
        dims = tuple(range(1, d + 1))
        dq = DirectSum(xq, self.h, self.prec)
        lag = torch.arange(-(mtot - 1), mtot, device=ws.device) % size[0]
        with matmul_precision(self.prec):
            A, M_inv = self._system(ws, w1, variance, sigmasq, sigmasq)
            e = etas.to(self.prec.cplx)
            sol = pcg(A, ws * e, M_inv, tol.var, tol.var_iters)
            E = torch.fft.fftn(e.reshape((-1,) + (mtot,) * d), s=size,
                               dim=dims).conj()
            out = {}
            for v in VARIANTS:
                if v != "mid" and not sol.differs(v):
                    continue
                g = (ws * sol.get(v)).reshape((-1,) + (mtot,) * d)
                est = torch.fft.ifftn(torch.fft.fftn(g, s=size, dim=dims)
                                      * E, dim=dims).sum(0) / e.shape[0]
                for ax in range(d):
                    est = torch.index_select(est, ax, lag)
                out[v] = dq.type2(est.reshape(1, -1), L)[0].real
            return out

    def gradient(self, lengthscale, variance, sigmasq, Z, V,
                 tol: Tolerances, beta0=None):
        """0.5 (term1 - term2) of the negative log marginal with respect to
        (lengthscale, variance, sigmasq), with the data-space probes Z
        (T, n) for the lengthscale's trace and the feature-space probes
        V (T, M) for the noise's; the mean solve starts at ``beta0``
        (a Solve, of the fit) where given."""
        ws, w1, dprime = self._hypers(lengthscale, variance)
        n, mtot = self.n, self.mtot
        cd = self.prec.cplx
        out = {}
        with matmul_precision(self.prec):
            A, M_inv = self._system(ws, w1, variance, sigmasq, 1.0)
            Zc, Vc = Z.to(cd), V.to(cd)
            T = Z.shape[0]
            di_fz = dprime[:, 0] * self.ds.type1(Zc, mtot)
            rhs_data = self.ds.type2(di_fz, mtot)
            B = torch.cat([ws * self.gram(di_fz), ws * self.gram(ws * Vc)])
            trace = pcg(A, B, M_inv, tol.grad, tol.mean_iters)
            means = {}
            for v in VARIANTS:
                x0 = None if beta0 is None else beta0.get(v)
                if v == "mid" or (beta0 is not None and beta0.differs(v)):
                    means[v] = pcg(A, (ws * self.Fy)[None], M_inv, tol.grad,
                                   tol.mean_iters, x0)
            for v in VARIANTS:
                mean = means.get(v, means["mid"])
                if v != "mid" and not (mean.differs(v) or trace.differs(v)
                                       or v in means):
                    continue
                beta = ws * mean.get(v)[0]
                alpha = (self.y - self.ds.type2(beta[None], mtot)[0]) / sigmasq
                fa = (self.Fy - self.gram(beta[None])[0]) / sigmasq
                an = (alpha.conj() * alpha).sum().real
                ya = (self.y.conj() * alpha).sum().real
                term2 = torch.stack([
                    (fa.conj() * dprime[:, 0] * fa).sum().real,
                    (ya - sigmasq * an) / variance,
                    an])
                X = trace.get(v)
                alph = (rhs_data - self.ds.type2(ws * X[:T], mtot)) / sigmasq
                t1_l = (Zc * alph).sum(-1).real.sum() / T
                t1_noise = (n / sigmasq
                            - (Vc.conj() * X[T:]).sum(-1).real.sum()
                            / sigmasq / T)
                term1 = torch.stack([t1_l,
                                     (n - sigmasq * t1_noise) / variance,
                                     t1_noise])
                out[v] = (0.5 * (term1 - term2)).to(torch.float64)
        return out


def make_model(x, y, h, mtot, precision="f64") -> SEModel:
    return SEModel(x, y, h, mtot, PRECISIONS[precision])
