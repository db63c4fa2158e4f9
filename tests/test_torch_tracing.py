"""The span log of ``gpquad_torch/utils/profiling.py`` on the CPU.

- With no profiler, ``stage`` is the shared null context, builds no
  attributes, and ``count`` records nothing.
- A CPU ``fit_predict_grad`` (kron PCG), a ``fit_with_grid`` and a
  ``gradient_with_grid`` without a state under ``profiling.trace``: every
  span the program opens is there, each under the span that caused it.
- The NUFFT spans' (kind, d, n, mtot, B) are the benchmark's
  ``_ShapeRecorder`` list, call for call.
- Put on the trace's clock, each span lies within 0.2 ms of its
  ``user_annotation`` event at both ends.
- A batched solve whose lanes converge at different steps counts its
  steps, iterations and active lane-steps exactly; the log keeps at most
  ``LOG_CAP`` spans.
"""
import json

import numpy as np
import pytest
import torch

import gpquad_torch
from benchmark import harness, profile_read
from benchmark.metrics import program_spans
from gpquad_torch.ops.cg import _CHECK_EVERY, pcg
from gpquad_torch.utils import profiling

torch.set_num_threads(1)

ENTRY = ("fit_predict_grad", "gradient_with_grid", "fit_with_grid",
         "predict_mean", "variance")
GRADIENT_STAGES = ("1_frequency_grid_setup", "3_toeplitz_setup",
                   "4_solve_cg", "5_compute_term2", "6_monte_carlo_trace",
                   "7_batch_cg_solve", "7.5_compute_alpha",
                   "8_gradient_calculation")
# (span, its parent) pairs that the three calls must show
NESTING = ({("fit_predict_grad", None), ("fit_with_grid", None),
            ("gradient_with_grid", None)}
           | {(c, "fit_predict_grad") for c in (
               "lag_table", "kron_setup", "pcg", "predict_mean", "variance",
               "gradient_with_grid")}
           | {(c, "fit_with_grid") for c in ("lag_table", "kron_setup",
                                              "pcg")}
           | {(s, "gradient_with_grid") for s in GRADIENT_STAGES}
           | {("lag_table", "3_toeplitz_setup"),
              ("kron_setup", "3_toeplitz_setup"), ("pcg", "4_solve_cg"),
              ("pcg", "7_batch_cg_solve"), ("pcg", "variance"),
              ("nufft_type1", "lag_table"), ("nufft_type2", "predict_mean"),
              ("nufft_type2", "variance"), ("pcg_check", "pcg"),
              ("toeplitz_matvec", "pcg")})
ATTRS = {"nufft_type1": ("kind", "d", "n", "mtot", "B", "precision"),
         "nufft_type2": ("kind", "d", "n", "mtot", "B", "precision"),
         "toeplitz_matvec": ("batch",), "pcg": ("B", "n", "tol", "maxiter"),
         "kron_setup": ("d", "mtot"), "lag_table": ("mtot",)}


def _calls():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (300, 2))
    y = np.sin(4 * x[:, 0]) + 0.1 * rng.normal(size=300)
    kern = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.0)
    kw = dict(solver="cg", precond="kron", device="cpu")
    gpquad_torch.fit_predict_grad(
        x, y, x[:20], kern, 0.05, 0.4, torch.Generator().manual_seed(0),
        mtot=9, trace_samples=2, var_probes=8, **kw)
    gpquad_torch.fit_with_grid(x, y, kern, 0.05, 0.4, 9, **kw)
    gpquad_torch.gradient_with_grid(
        x, y, kern, 0.05, 0.4, torch.Generator().manual_seed(1), mtot=9,
        trace_samples=2, **kw)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The three calls under ``profiling.trace`` and the benchmark's shape
    recorder: (spans, the trace's events, the recorded NUFFT shapes)."""
    log_dir = tmp_path_factory.mktemp("trace")
    with harness._ShapeRecorder(harness.nufft_classes()) as rec:
        with profiling.trace(log_dir):
            _calls()
    events = json.loads((log_dir / profiling.TRACE_FILE).read_text())[
        "traceEvents"]
    return profiling.spans(), events, rec.calls


def test_stage_and_count_are_inert_without_a_profiler():
    def attrs(*_):
        raise AssertionError("attributes built with no profiler")
    profiling.reset()
    assert not profiling.recording()
    assert profiling.stage("pcg", attrs, 1, 2) is profiling.stage("lag_table")
    with profiling.stage("pcg", attrs, 1, 2):
        profiling.count("pcg_steps", 3)
    b = torch.ones((2, 4), dtype=torch.float64)
    pcg(lambda v: 2.0 * v, b, tol=1e-8)
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_trace_resets_the_log(tmp_path):
    with profiling.trace(tmp_path / "a"):
        with profiling.stage("pcg"):
            pass
    with profiling.trace(tmp_path / "b"):
        with profiling.stage("lag_table"):
            profiling.count("x", torch.tensor(2))
    assert [(s.name, s.parent, s.counters) for s in profiling.spans()] == \
        [("lag_table", None, {"x": 2})]


def test_spans_nest_as_the_program_calls(traced):
    spans, _, _ = traced
    by_id = {s.id: s for s in spans}
    pairs = {(s.name, by_id[s.parent].name if s.parent is not None
              else None) for s in spans}
    assert NESTING <= pairs, NESTING - pairs
    names = {s.name for s in spans}
    assert set(ENTRY + GRADIENT_STAGES + profiling.SPANS) <= names
    assert not set(profiling.STAGES) & set(profiling.SPANS)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert tuple(s.attrs) == ATTRS.get(s.name, ()), s
    assert {s.attrs["mtot"] for s in spans if s.name == "lag_table"} == {17}
    assert all(s.attrs == dict(d=2, mtot=9) for s in spans
               if s.name == "kron_setup")


def test_nufft_spans_carry_the_recorded_shapes(traced):
    spans, _, recorded = traced
    ours = [(s.attrs["kind"], s.attrs["d"], s.attrs["n"], s.attrs["mtot"],
             s.attrs["B"]) for s in spans
            if s.name in ("nufft_type1", "nufft_type2")]
    assert len(recorded) > 6 and ours == recorded
    assert {s.attrs["precision"] for s in spans
            if s.name.startswith("nufft")} == {"float64"}


def test_spans_sit_on_their_annotations(traced):
    spans, events, _ = traced
    trace = profile_read.Trace(events)
    clock = program_spans.on_trace_clock(spans, trace)
    twins = {}
    for e in sorted(trace.host, key=lambda e: e["ts"]):
        if e["cat"] == "user_annotation":
            twins.setdefault((e["tid"], e["name"]), []).append(e)
    seen = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        k = seen[(s.tid, s.name)] = seen.get((s.tid, s.name), -1) + 1
        e = twins[(s.tid, s.name)][k]
        start, end = clock[s.id]
        assert abs(start - e["ts"]) <= 200.0, (s, e)
        assert abs(end - (e["ts"] + e["dur"])) <= 200.0, (s, e)
    assert sum(len(v) for v in twins.values()) == len(spans)


@pytest.mark.parametrize("maxiter", [None, 10])
def test_pcg_counts_steps_iterations_and_lanes(tmp_path, maxiter):
    """A = diag(1..30): a right-hand side on the first c eigenvectors
    converges in c steps, so the lanes stop at 1, 3, 5, 11 and 13; the loop
    stops at the first check after the last, or at ``maxiter``."""
    n, conv = 30, (1, 3, 5, 11, 13)
    diag = torch.arange(1, n + 1, dtype=torch.float64)
    b = torch.zeros((len(conv), n), dtype=torch.float64)
    for lane, c in enumerate(conv):
        b[lane, :c] = torch.linspace(1.0, 2.0, c, dtype=torch.float64)
    with profiling.trace(tmp_path):
        res = pcg(lambda v: diag * v, b, tol=1e-10, maxiter=maxiter)
    (span,) = [s for s in profiling.spans() if s.name == "pcg"]
    limit = 2 * n if maxiter is None else maxiter
    assert res.conv_iters.tolist() == [min(c, limit) for c in conv]
    first_check = -(-max(conv) // _CHECK_EVERY) * _CHECK_EVERY
    assert span.counters == dict(
        pcg_iters=int(res.iters), pcg_steps=min(first_check, limit),
        pcg_active_lane_steps=int(res.conv_iters.sum()))
    assert span.attrs == dict(B=len(conv), n=n, tol=1e-10, maxiter=limit)
    checks = [s for s in profiling.spans() if s.name == "pcg_check"]
    assert len(checks) == -(-span.counters["pcg_steps"] // _CHECK_EVERY) + (
        maxiter is None)
    assert all(s.parent == span.id for s in checks)


def test_log_keeps_at_most_its_cap(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "LOG_CAP", 3)
    with profiling.trace(tmp_path):
        for _ in range(5):
            with profiling.stage("pcg_check"):
                pass
    assert len(profiling.spans()) == 3 and profiling.dropped() == 2
