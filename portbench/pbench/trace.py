"""The traced window: ``torch.profiler`` over a few seconds of serving.

A traced run (``--trace 1``) serves on past the measured window for
``TRACE_SECONDS`` with the profiler on, every engine step inside a
``record_function`` span of the benchmark's (``portbench.prefill``,
``portbench.decode``), so that the device's kernels can be set against the
steps they belong to. ``read`` reduces the profile to plain lists: the
device activities (kernels, copies and sets) and the spans, in
microseconds on the profiler's timeline, the traced window's length, the
seconds in which some activity ran on the device (their union), the
device operations that took most time and the longest idle gaps by what
the host was doing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

TRACE_SECONDS = 3.0
SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class TraceData:
    device: List[Tuple[str, float, float]]      # (name, start us, end us)
    spans: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window_s: float
    t0_us: float
    t1_us: float

    def busy_us(self, lo: float = None, hi: float = None) -> float:
        """Microseconds of the union of device activity within [lo, hi]."""
        lo = self.t0_us if lo is None else lo
        hi = self.t1_us if hi is None else hi
        return sum(b - a for a, b in union(self.device, lo, hi))

    @property
    def busy_s(self) -> float:
        return self.busy_us() / 1e6

    def kernels(self, *names: str) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if any(n in e[0] for n in names)]


def union(events, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    iv = sorted((max(a, lo), min(b, hi)) for _, a, b in events
                if b > lo and a < hi)
    out: List[List[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def spanned(name: str, fn):
    """``fn`` run inside a ``record_function`` span named ``name``."""
    from torch.profiler import record_function

    def run(*args, **kw):
        with record_function(name):
            return fn(*args, **kw)
    return run


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def read(prof, window_s: float) -> TraceData:
    """The profile's raw events (kineto's, without building the profiler's
    event tree, which takes minutes over a few seconds of serving)."""
    from torch.autograd import DeviceType
    device, spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        name = e.name()
        row = (name, a, a + e.duration_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX):  # a span's device copy
                device.append(row)
        elif name.startswith(SPAN_PREFIX):
            spans.append(row)
        else:
            host.append(row)
    starts = [r[1] for r in spans + host + device]
    ends = [r[2] for r in spans + host + device]
    t0 = min(starts) if starts else 0.0
    t1 = max(ends) if ends else 0.0
    return TraceData(device, spans, host, window_s, t0, t1)


def breakdown(td: TraceData, top: int = 10, gaps_read: int = 400
              ) -> Dict[str, List]:
    """The device operations that took most time, and the idle gaps (the
    ``gaps_read`` longest, each over 50 us) summed by what the host was
    doing: the innermost host op around the gap's middle, under the
    benchmark's span if any. Names are cut to 100 characters."""
    import numpy as np
    by_op: Dict[str, float] = {}
    for name, a, b in td.device:
        by_op[name[:100]] = by_op.get(name[:100], 0.0) + (b - a) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    prev = td.t0_us
    for a, b in union(td.device, td.t0_us, td.t1_us) + [(td.t1_us,
                                                         td.t1_us)]:
        if a - prev > 50.0:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:gaps_read]
    names = [r[0] for r in td.host_ops]
    starts = np.array([r[1] for r in td.host_ops])
    ends = np.array([r[2] for r in td.host_ops])
    by_what: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        span = next((n for n, s, e in td.spans if s <= mid <= e),
                    "portbench.loop")
        op = "-"
        if len(names):
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if inside.size:
                op = names[inside[np.argmin(ends[inside] - starts[inside])]]
        key = f"{span[len(SPAN_PREFIX):]}: {op}"[:100]
        by_what[key] = by_what.get(key, 0.0) + (b - a) / 1e6
    idle = sorted(by_what.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
