"""The ``Workload`` protocol: timed request events + completion feedback.

The paper's headline findings are statements about *workloads* — prefill-
heavy traffic favors disaggregation (§4.2), and rate matching must track the
traffic as it shifts (§4.3) — so scenarios are first-class objects here. A
``Workload`` is pulled incrementally by ``Cluster.serve()`` through the
virtual-time event loop:

  - ``poll(now)`` returns the requests that have arrived by virtual time
    ``now`` (generated lazily — nothing is pre-materialized);
  - ``next_arrival()`` is the earliest future event time, letting an idle
    cluster jump its clock forward (or ``None`` while the workload is
    waiting on a completion — the closed-loop case);
  - ``on_complete(req, now)`` feeds finished requests back, so a multi-turn
    session can schedule turn N+1 only after turn N's ``done_t`` (think
    time included) — inexpressible with a pre-materialized request list;
  - ``summary()`` reduces the scenario to ``(isl, osl, rate,
    reuse_fraction)`` marginals, the exact inputs the analytic side
    (``core.rate_matching`` / ``core.design_space`` / ``core.frontiers``)
    consumes — the executable simulator and the analytic sweeps evaluate
    the *same* scenario objects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.traffic import TrafficPattern
from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class WorkloadSummary:
    """The ``(isl, osl, rate, reuse_fraction)`` marginals of a scenario.

    ``isl``/``osl`` are expected per-request token counts, ``rate`` the
    offered request rate (req/s; 0 for pure closed-loop workloads whose
    rate is completion-driven), ``reuse_fraction`` the expected fraction of
    prompt tokens already resident in a prefix cache (multi-turn context,
    shared system prompts) — prefill *compute* scales by
    ``1 - reuse_fraction`` while KV residency still scales with the full
    ``isl``.
    """
    isl: float
    osl: float
    rate: float = 0.0
    reuse_fraction: float = 0.0

    @property
    def effective_isl(self) -> float:
        """Prefill-compute tokens per request after KV reuse."""
        return max(1.0, self.isl * (1.0 - self.reuse_fraction))

    @property
    def prefill_heavy(self) -> bool:
        return self.effective_isl >= 4 * self.osl

    def p50_pattern(self, name: str = "workload-p50") -> TrafficPattern:
        """Closest power-of-two pattern (Appendix-C style approximation)."""
        return TrafficPattern(
            name,
            2 ** round(math.log2(max(self.isl, 1))),
            2 ** round(math.log2(max(self.osl, 1))))


@dataclasses.dataclass(frozen=True)
class SLATier:
    """A service class stamped onto emitted requests (priority + targets)."""
    name: str
    priority: int = 0
    ftl_target_s: Optional[float] = None
    ttl_target_s: Optional[float] = None

    def apply(self, req: Request) -> Request:
        req.priority = self.priority
        req.ftl_target_s = self.ftl_target_s
        req.ttl_target_s = self.ttl_target_s
        return req


# Reference tiers (round-number stand-ins for the paper's 10 s FTL cutoff
# and interactivity targets; real deployments tune these per product).
INTERACTIVE = SLATier("interactive", priority=5,
                      ftl_target_s=2.0, ttl_target_s=0.2)
STANDARD = SLATier("standard", priority=1, ftl_target_s=10.0)
BATCH = SLATier("batch", priority=0)


@runtime_checkable
class Workload(Protocol):
    """Timed request events, pulled by ``Cluster.serve()``."""

    def poll(self, now: float) -> List[Request]:
        """Requests with ``arrival_t <= now`` not yet emitted, arrival
        order. The caller owns the returned requests."""
        ...

    def next_arrival(self) -> Optional[float]:
        """Earliest known future event time, or None (exhausted, or a
        closed-loop workload waiting on ``on_complete``)."""
        ...

    def on_complete(self, req: Request, now: float) -> None:
        """Completion feedback (closed-loop hooks; no-op for open-loop)."""
        ...

    def exhausted(self) -> bool:
        """True once no further request will ever be emitted."""
        ...

    def summary(self) -> WorkloadSummary:
        ...


def materialize(workload: Workload, *, until: float = float("inf"),
                max_requests: int = 1_000_000) -> List[Request]:
    """Drain an *open-loop* workload into a flat request list (the legacy
    ``TrafficGen.generate`` surface). Closed-loop workloads cannot be
    materialized — their later events depend on completions — and raise
    rather than silently truncating to their first turns."""
    out: List[Request] = []
    while len(out) < max_requests:
        t = workload.next_arrival()
        if t is None:
            if not workload.exhausted():
                raise ValueError(
                    "closed-loop workload is waiting on completions and "
                    "cannot be materialized; drive it with Cluster.serve()")
            break
        if t > until:
            break
        out.extend(workload.poll(t))
    return out[:max_requests]


class StaticWorkload:
    """A pre-materialized request list as a ``Workload`` — what
    ``Cluster.run(requests)`` wraps. Open-loop: arrivals are fixed at
    construction and completions are ignored."""

    def __init__(self, requests: List[Request]):
        self._sorted: List[Request] = sorted(requests,
                                             key=lambda r: r.arrival_t)
        self._cursor = 0        # poll() is called once per scheduling
        #                         round; a cursor keeps it O(emitted)
        self.requests = list(requests)      # original order, for metrics

    def poll(self, now: float) -> List[Request]:
        i = self._cursor
        while i < len(self._sorted) and self._sorted[i].arrival_t <= now:
            i += 1
        out = self._sorted[self._cursor:i]
        self._cursor = i
        return out

    def next_arrival(self) -> Optional[float]:
        if self._cursor >= len(self._sorted):
            return None
        return self._sorted[self._cursor].arrival_t

    def on_complete(self, req: Request, now: float) -> None:
        pass

    def exhausted(self) -> bool:
        return self._cursor >= len(self._sorted)

    def expected_requests(self) -> float:
        return float(len(self.requests))

    def max_context(self) -> Optional[int]:
        """Largest isl+osl any request reaches (engine-capacity hint)."""
        if not self.requests:
            return None
        return max(r.isl + r.osl for r in self.requests)

    def summary(self) -> WorkloadSummary:
        rs = self.requests
        if not rs:
            return WorkloadSummary(isl=1, osl=1, rate=0.0)
        span = max(r.arrival_t for r in rs) - min(r.arrival_t for r in rs)
        return WorkloadSummary(
            isl=float(np.mean([r.isl for r in rs])),
            osl=float(np.mean([r.osl for r in rs])),
            rate=len(rs) / span if span > 0 else 0.0)


class Recorder:
    """Delegating wrapper that keeps every request a workload emits —
    for post-hoc per-request analysis (``record_trace``, mean-FTL over
    the emitted set, closed-loop assertions) without changing behavior."""

    def __init__(self, inner: Workload):
        self.inner = inner
        self.emitted: List[Request] = []

    def poll(self, now: float) -> List[Request]:
        out = self.inner.poll(now)
        self.emitted.extend(out)
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


class Superpose:
    """Union of several workloads' event streams (e.g. an interactive tier
    superposed on a batch backfill, or two traffic phases offset in time).
    Completions are routed back to the emitting child (keyed by request
    object identity, so children sharing rid ranges still route correctly
    — though distinct ``start_rid`` ranges keep metrics legible)."""

    def __init__(self, workloads: List[Workload]):
        assert workloads
        self.children = list(workloads)
        self._owner = {}            # id(request) -> child workload

    def poll(self, now: float) -> List[Request]:
        out: List[Request] = []
        for w in self.children:
            for r in w.poll(now):
                self._owner[id(r)] = w
                out.append(r)
        out.sort(key=lambda r: r.arrival_t)
        return out

    def next_arrival(self) -> Optional[float]:
        ts = [t for t in (w.next_arrival() for w in self.children)
              if t is not None]
        return min(ts) if ts else None

    def on_complete(self, req: Request, now: float) -> None:
        w = self._owner.pop(id(req), None)
        if w is not None:
            w.on_complete(req, now)

    def exhausted(self) -> bool:
        return all(w.exhausted() for w in self.children)

    def summary(self) -> WorkloadSummary:
        """Per-request mixture of the children's marginals, weighted by
        each child's expected request count when every child can report
        one (``expected_requests``), else by offered rate — a burst of 10
        long prompts must outweigh a burst of 4 short ones."""
        ss = [w.summary() for w in self.children]
        counts = [getattr(w, "expected_requests", lambda: None)()
                  for w in self.children]
        if all(c is not None and np.isfinite(c) and c > 0 for c in counts):
            wts = [float(c) for c in counts]
        else:
            wts = [s.rate if s.rate > 0 else 1.0 for s in ss]
        tot = sum(wts)
        return WorkloadSummary(
            isl=sum(w * s.isl for w, s in zip(wts, ss)) / tot,
            osl=sum(w * s.osl for w, s in zip(wts, ss)) / tot,
            rate=sum(s.rate for s in ss),
            reuse_fraction=sum(w * s.reuse_fraction
                               for w, s in zip(wts, ss)) / tot)
