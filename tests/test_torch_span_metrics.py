"""The benchmark's readers of the program's span log
(``benchmark/metrics/pcg_steps.py``, ``pcg_lane_use.py``,
``var_pcg_iters.py``, ``kron_setup_ms.py``, ``solve_idle_ms.py``) on a
hand-built traced window: a span log with known counters and a trace of
synthetic events whose busy and idle intervals are known, so each number
is exact; and None where the spans are absent or the program keeps no
log."""
import pytest

from benchmark import harness, profile_read
from gpquad_torch.utils import profiling

METRICS = ("pcg_steps", "pcg_lane_use", "var_pcg_iters", "kron_setup_ms",
           "solve_idle_ms")
T0 = 1_790_000_000_000_000_000    # the log's clock, ns
SHIFT = 4321.0                    # the trace's clock: (ns - T0) / 1e3 + SHIFT
TID = 77

# (name, parent index, start us, end us, attrs, counters), over two units
LOG = [
    ("fit_predict_grad", None, 0, 10_000, {}, {}),
    ("kron_setup", 0, 100, 1_100, dict(d=2, mtot=9), {}),
    ("pcg", 0, 2_000, 4_000, dict(B=1, n=81, tol=1e-6, maxiter=100),
     dict(pcg_iters=5, pcg_steps=8, pcg_active_lane_steps=5)),
    ("variance", 0, 5_000, 9_000, {}, {}),
    ("pcg", 3, 5_500, 8_500, dict(B=4, n=81, tol=1e-4, maxiter=100),
     dict(pcg_iters=10, pcg_steps=16, pcg_active_lane_steps=40)),
    ("pcg_check", 4, 6_000, 6_100, {}, {}),
]
# device operations: (launch us, start us, end us)
OPS = [(50, 0, 300),            # queued before the kron set-up
       (1_000, 1_050, 1_600),   # launched in it, ends 500 us after it
       (2_100, 2_500, 3_000),   # in the mean solve
       (5_600, 6_000, 7_000)]   # in the variance's solve


def _log():
    return [profiling.Span(i, parent, name, TID, T0 + a * 1000,
                           T0 + b * 1000, attrs, counters)
            for i, (name, parent, a, b, attrs, counters) in enumerate(LOG)]


def _trace():
    events = [dict(ph="X", cat="user_annotation", name=name, pid=1, tid=TID,
                   ts=a + SHIFT, dur=b - a)
              for name, _, a, b, _, _ in LOG]
    for corr, (launch, a, b) in enumerate(OPS):
        events.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                           pid=1, tid=TID, ts=launch + SHIFT, dur=5,
                           args=dict(correlation=corr)))
        events.append(dict(ph="X", cat="kernel", name=f"k{corr}", pid=0,
                           tid=7, ts=a + SHIFT, dur=b - a,
                           args=dict(correlation=corr)))
    return profile_read.Trace(events)


def _read(name, trace=None):
    trace = trace or _trace()
    ctx = harness.Context(units=2, window_s=0.02, busy_s=trace.busy_s,
                          trace=trace, nufft_calls=[], counters={})
    path = harness.metric_path(harness.BENCH, name + ".fit")
    return harness.load_module(path).read(ctx)


def test_each_reader_reads_its_number(monkeypatch):
    monkeypatch.setattr(profiling, "spans", _log)
    assert _read("pcg_steps") == (8 + 16) / 2
    assert _read("pcg_lane_use") == 100.0 * (5 + 40) / (1 * 8 + 4 * 16)
    assert _read("var_pcg_iters") == 10 / 2
    # kron: from 300 us, when the op queued before it ends, to the end of
    # the op it launched, 1 600 us
    assert _read("kron_setup_ms") == 1.3 / 2
    # mean solve 2 000 us less 500 busy, variance's 3 000 less 1 000
    assert _read("solve_idle_ms") == (1.5 + 2.0) / 2


def test_train_names_share_the_readers():
    for name in METRICS:
        if name != "var_pcg_iters":
            assert harness.metric_path(harness.BENCH, name + ".train") == \
                harness.metric_path(harness.BENCH, name + ".fit")


@pytest.mark.parametrize("name", METRICS)
def test_a_reader_without_its_spans_reads_none(monkeypatch, name):
    """No span of its kind, an empty log, a log that dropped spans, or a
    program without a log: None."""
    only_entry = [s for s in _log() if s.name == "fit_predict_grad"]
    monkeypatch.setattr(profiling, "spans", lambda: only_entry)
    assert _read(name) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(name) is None
    monkeypatch.setattr(profiling, "spans", _log)
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    assert _read(name) is None
    monkeypatch.delattr(profiling, "spans")
    assert _read(name) is None


@pytest.mark.parametrize("name", ["kron_setup_ms", "solve_idle_ms"])
def test_a_trace_without_the_spans_events_reads_none(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", _log)
    devices_only = profile_read.Trace(
        [e for e in _trace().device] + list(_trace().launches.values()))
    assert _read(name, devices_only) is None
