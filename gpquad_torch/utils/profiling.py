"""Profiling scopes, a span log and stage timing; port of
``gpquad/utils/profiling.py``.

gpquad names its pipeline stages after the reference's ``torch.profiler``
scopes ("0_book_keeping" ... "9_log_marginal_likelihood") and opens
``jax.named_scope``s in the exact NUFFT, the Toeplitz matvec and the PCG.
The port keeps the names and adds its own (:data:`SPANS`):

  - :func:`stage`: a ``torch.profiler.record_function`` scope while a
    profiler runs, else a shared null context (a ``record_function`` costs
    microseconds on the host even with no profiler, and the Toeplitz scope
    is entered once a CG iteration).  While a profiler runs each scope is
    also a span of the log: its id, the id of the innermost span open on
    the same thread when it began (the span that caused it), its name, the
    thread's native id, its start and end by ``time.time_ns()`` and its
    attributes;
  - :func:`spanned`: a decorator that runs a function inside a stage;
  - :func:`count`: a counter on the innermost open span; a device tensor
    stays a tensor until :func:`spans` reads the log, so recording reads
    nothing back from the device;
  - :func:`spans`, :func:`reset`: the log since the process started or since
    the last reset, at most ``LOG_CAP`` spans (later ones are counted in
    :func:`dropped` only);
  - :func:`trace`: ``torch.profiler`` over the CPU and, where present, the
    CUDA device, written as a Chrome trace (``TRACE_FILE`` in ``log_dir``);
  - :class:`StageTimer`: a host wall-clock table of stages, synchronising
    the CUDA device of the tensor it is given before it reads the clock.

A span's start is read just before its ``record_function`` opens and its
end just after it closes, so each span holds its ``user_annotation`` event
of the Chrome trace: the k-th span of a name on a thread is the k-th such
event of that name and thread, which puts the log on the trace's clock.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

__all__ = ["stage", "spanned", "count", "recording", "keyed", "spans", "reset",
           "dropped", "trace", "Span", "StageTimer", "STAGES", "SPANS",
           "TRACE_FILE", "LOG_CAP"]

# the reference's stage taxonomy (efgpnd.py:61-289)
STAGES = (
    "0_book_keeping",
    "1_frequency_grid_setup",
    "2_nufft_setup",
    "3_toeplitz_setup",
    "4_solve_cg",
    "5_compute_term2",
    "6_monte_carlo_trace",
    "7_batch_cg_solve",
    "7.5_compute_alpha",
    "8_gradient_calculation",
    "9_log_marginal_likelihood",
)

# the port's spans beyond the stages: the entry points, the lag table, the
# Kronecker set-up, the solves and their host checks, the operators
SPANS = (
    "fit_predict_grad",
    "gradient_with_grid",
    "fit_with_grid",
    "predict_mean",
    "variance",
    "lag_table",
    "kron_setup",
    "pcg",
    "pcg_check",
    "nufft_type1",
    "nufft_type2",
    "toeplitz_matvec",
)

# the Chrome trace's name in trace()'s log_dir
TRACE_FILE = "trace.json"

# the most spans the log holds
LOG_CAP = 1 << 16

_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One closed span of the log."""
    id: int
    parent: Optional[int]     # the innermost span open at its start
    name: str
    tid: int                  # the thread's native id (the trace's tid)
    start_ns: int             # time.time_ns()
    end_ns: int
    attrs: dict
    counters: dict            # numbers once read through spans()


_log: List[list] = []         # closed spans, as Span fields in a list
_dropped = 0                  # spans closed while the log was full
_ids = itertools.count()
_local = threading.local()


def _open_spans() -> list:
    """This thread's open spans; the thread's native id is read once."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.tid = threading.get_native_id()
    return stack


class _Span(torch.profiler.record_function):
    """A ``record_function`` scope that is also a span of the log."""

    def __init__(self, name: str, attrs: dict):
        super().__init__(name)
        self.fields = [None, None, name, 0, 0, 0, attrs, {}]

    def __enter__(self):
        f = self.fields
        stack = _open_spans()
        f[0] = next(_ids)
        f[1] = stack[-1][0] if stack else None
        f[3] = _local.tid
        stack.append(f)
        f[4] = time.time_ns()
        return super().__enter__()

    def __exit__(self, *exc):
        global _dropped
        out = super().__exit__(*exc)
        f = self.fields
        f[5] = time.time_ns()
        _open_spans().pop()
        if len(_log) < LOG_CAP:
            _log.append(f)
        else:
            _dropped += 1
        return out


def recording() -> bool:
    """Whether a profiler runs, and so whether spans and counts are
    recorded."""
    return _profiler_enabled()


def stage(name: str, attrs: Optional[Callable[..., dict]] = None, *args):
    """Named scope for a pipeline stage; shows up in profiler traces and,
    while a profiler runs, in the span log.  ``attrs(*args)`` gives the
    span's attributes; it is called only while recording."""
    if _profiler_enabled():
        return _Span(name, attrs(*args) if attrs is not None else {})
    return _NULL


def spanned(name: str):
    """Decorator: the function's calls run inside ``stage(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with stage(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def keyed(*keys: str) -> Callable[..., dict]:
    """An ``attrs`` for :func:`stage` that names its arguments ``keys``."""
    def attrs(*values):
        return dict(zip(keys, values))
    return attrs


def count(name: str, value) -> None:
    """Set the counter ``name`` of the innermost open span to ``value`` (a
    number or a tensor of one element, read when the log is read); nothing
    while no profiler runs or no span is open."""
    if not _profiler_enabled():
        return
    stack = _open_spans()
    if stack:
        stack[-1][7][name] = value


def _number(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def spans() -> List[Span]:
    """The log in the order the spans started, each counter read as a
    number (device tensors are read here, once)."""
    out = []
    for f in sorted(_log, key=lambda f: f[0]):
        f[7] = {k: _number(v) for k, v in f[7].items()}
        out.append(Span(*f))
    return out


def dropped() -> int:
    """Spans closed while the log was full since the last reset."""
    return _dropped


def reset() -> None:
    """Empty the log."""
    global _dropped
    _log.clear()
    _dropped = 0


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block (CPU and, where torch sees one, the CUDA device)
    and write its Chrome trace to ``log_dir / TRACE_FILE`` (default
    ``gpquad-trace`` in the temporary directory, gpquad's
    ``/tmp/gpquad-trace``).  The span log is reset on entry, so afterwards
    it holds the block's spans.  Yields ``log_dir`` as a ``Path``."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = Path(log_dir if log_dir is not None
                   else Path(tempfile.gettempdir()) / "gpquad-trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


class StageTimer:
    """Wall-clock stage table (device-synchronizing).

    Usage::

        timer = StageTimer()
        with timer.time("4_solve_cg", sync=beta):
            beta = ...
        print(timer.table())

    ``sync``: a tensor whose CUDA device is synchronised when the block
    ends, which waits for all the work queued there, the block's included;
    so any tensor on the block's device serves, one made before it too.
    """

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def table(self) -> str:
        rows = ["stage".ljust(28) + "calls   total_s     mean_s"]
        total = 0.0
        for name, vals in self.records.items():
            total += sum(vals)
            rows.append(f"{name:<28}{len(vals):>5}{sum(vals):>10.4f}"
                        f"{sum(vals)/len(vals):>11.5f}")
        rows.append(f"{'TOTAL':<28}{'':>5}{total:>10.4f}")
        return "\n".join(rows)
