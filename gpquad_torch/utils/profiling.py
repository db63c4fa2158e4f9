"""Profiling scopes and stage timing; port of ``gpquad/utils/profiling.py``.

gpquad names its pipeline stages after the reference's ``torch.profiler``
scopes ("0_book_keeping" ... "9_log_marginal_likelihood") and opens
``jax.named_scope``s in the exact NUFFT, the Toeplitz matvec and the PCG.
The port keeps the names:

  - :func:`stage`: a ``torch.profiler.record_function`` scope while a
    profiler runs, else a shared null context (a ``record_function`` costs
    microseconds on the host even with no profiler, and the Toeplitz scope
    is entered once a CG iteration);
  - :func:`trace`: ``torch.profiler`` over the CPU and, where present, the
    CUDA device, written as a Chrome trace (``TRACE_FILE`` in ``log_dir``);
  - :class:`StageTimer`: a host wall-clock table of stages, synchronising
    the CUDA device of the tensor it is given before it reads the clock.
"""
from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

__all__ = ["stage", "trace", "StageTimer", "STAGES", "TRACE_FILE"]

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

# the Chrome trace's name in trace()'s log_dir
TRACE_FILE = "trace.json"

_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def stage(name: str):
    """Named scope for a pipeline stage; shows up in profiler traces."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block (CPU and, where torch sees one, the CUDA device)
    and write its Chrome trace to ``log_dir / TRACE_FILE`` (default
    ``gpquad-trace`` in the temporary directory, gpquad's
    ``/tmp/gpquad-trace``).  Yields ``log_dir`` as a ``Path``."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = Path(log_dir if log_dir is not None
                   else Path(tempfile.gettempdir()) / "gpquad-trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
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
