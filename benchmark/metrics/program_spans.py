"""The program's span log (``gpquad_torch.utils.profiling``) for the readers
of the solves' metrics, and the log put on the traced window's clock.

Each span of the log is also a ``user_annotation`` event of the trace: the
k-th span of a name on a thread is the k-th event of that name on that
thread.  The median gap between the two, over every pair and both ends,
carries the log's clock (``time.time_ns()``) to the trace's (microseconds).
A program without the log gives None throughout.
"""
from __future__ import annotations

import bisect
import statistics


def log():
    """The spans the program recorded in the traced window, or None where
    the program keeps no log, recorded nothing, or dropped spans from a
    full log (its sums would be short)."""
    from gpquad_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    if read is None or profiling.dropped():
        return None
    return read() or None


def named(spans, name: str) -> list:
    return [s for s in spans or () if s.name == name]


def counter_sum(spans, counter: str):
    """The sum of ``counter`` over ``spans``, None where none has it."""
    values = [s.counters[counter] for s in spans if counter in s.counters]
    return sum(values) if values else None


def on_trace_clock(spans, trace) -> dict:
    """{span id: (start, end)} in the trace's microseconds; empty where no
    span has its event in ``trace``."""
    events = {}
    for e in trace.host:
        if e.get("cat") == "user_annotation":
            events.setdefault((e.get("tid"), e["name"]), []).append(e)
    mine = {}
    for s in spans:
        mine.setdefault((s.tid, s.name), []).append(s)
    t0 = min(s.start_ns for s in spans)
    gaps = []
    for key, ours in mine.items():
        theirs = sorted(events.get(key, ()), key=lambda e: e["ts"])
        for s, e in zip(sorted(ours, key=lambda s: s.start_ns), theirs):
            gaps.append(e["ts"] - (s.start_ns - t0) / 1e3)
            gaps.append(e["ts"] + e["dur"] - (s.end_ns - t0) / 1e3)
    if not gaps:
        return {}
    off = statistics.median(gaps)
    return {s.id: ((s.start_ns - t0) / 1e3 + off, (s.end_ns - t0) / 1e3 + off)
            for s in spans}


def _launched(trace):
    """(launch, device operation) pairs, launch to operation by
    correlation id."""
    for e in trace.device:
        launch = trace.launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            yield launch, e


def device_end(trace, tid, start: float, end: float) -> float:
    """The end of the last device operation launched on thread ``tid``
    between ``start`` and ``end``, or ``end`` where it is later or none
    was launched."""
    last = end
    for launch, e in _launched(trace):
        if launch.get("tid") == tid and start <= launch["ts"] <= end:
            last = max(last, e["ts"] + e["dur"])
    return last


def queue_end(trace, start: float) -> float:
    """When the device finished the operations launched before ``start``
    (``start`` itself where it had finished them by then)."""
    last = start
    for launch, e in _launched(trace):
        if launch["ts"] < start:
            last = max(last, e["ts"] + e["dur"])
    return last


def idle_within(busy, intervals) -> float:
    """Microseconds of ``intervals`` that no interval of ``busy`` covers
    (both sorted and disjoint)."""
    starts = [s for s, _ in busy]
    idle = 0.0
    for start, end in intervals:
        idle += end - start
        i = max(bisect.bisect_right(starts, start) - 1, 0)
        while i < len(busy) and busy[i][0] < end:
            idle -= max(0.0, min(busy[i][1], end) - max(busy[i][0], start))
            i += 1
    return idle


def union(intervals) -> list:
    """The sorted, disjoint union of ``intervals``."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out
