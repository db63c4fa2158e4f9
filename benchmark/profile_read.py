"""Reading a torch.profiler trace of the traced window: the device's busy
time, the device time of the kernels launched inside the program's scopes
(a launch on the scope's thread within its span, matched to its device
event by correlation id), the device operations that took most time, and
the longest idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
import json
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def export_events(prof) -> list:
    """The profiler's Chrome trace events (written to and read back from
    a temporary directory)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The events of one traced window (microsecond timestamps)."""

    def __init__(self, events: list):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and "dur" in e]
        corr = {e["args"]["correlation"] for e in self.device
                if "correlation" in e.get("args", {})}
        self.launches = {e["args"]["correlation"]: e for e in events
                         if e.get("cat") in LAUNCH_CATS
                         and e.get("args", {}).get("correlation") in corr}
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and "dur" in e]
        self.busy = _union([(e["ts"], e["ts"] + e["dur"])
                            for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def scope_s(self, name: str) -> float:
        """Device seconds of the events launched inside scopes ``name``."""
        spans = {}
        for e in self.host:
            if e["name"] == name and e.get("cat") == "user_annotation":
                spans.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (e["ts"], e["ts"] + e["dur"]))
        if not spans:
            return 0.0
        # spans of one name do not nest: the last one to start before a
        # launch is the only one that can hold it
        spans = {k: _union(v) for k, v in spans.items()}
        starts = {k: [s for s, _ in v] for k, v in spans.items()}
        total = 0.0
        for e in self.device:
            launch = self.launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            key = (launch.get("pid"), launch.get("tid"))
            i = bisect.bisect_right(starts.get(key, ()), launch["ts"]) - 1
            if i >= 0 and launch["ts"] <= spans[key][i][1]:
                total += e["dur"]
        return total / 1e6

    def device_ops(self, top=10):
        by = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """The longest idle gaps between device events, each named by the
        innermost host event that covers its middle."""
        gaps = sorted(((s1 - e0, 0.5 * (e0 + s1)) for (_, e0), (s1, _)
                       in zip(self.busy, self.busy[1:])), reverse=True)
        out = []
        for length, mid in gaps[:top]:
            inner = None
            for h in self.host:
                if h["ts"] <= mid <= h["ts"] + h["dur"] and (
                        inner is None or h["dur"] < inner["dur"]):
                    inner = h
            out.append([inner["name"][:120] if inner else "(no host event)",
                        length / 1e6])
        return out
