"""Open-loop workload generation: ``ArrivalProcess`` x ``ShapeSampler``.

``OpenLoopWorkload`` is the lazy, pull-based replacement for the legacy
``TrafficGen.generate()`` pre-materialized list: requests exist only once
the cluster's virtual clock reaches them, so unbounded processes (diurnal
cycles, long traces) serve in O(1) memory, and the same object yields the
``(isl, osl, rate, reuse)`` marginals for the analytic sweeps.
"""
from __future__ import annotations

import itertools
from typing import Callable, List, Optional, Union

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.workloads.arrivals import ArrivalProcess
from repro_torch.workloads.base import SLATier, WorkloadSummary
from repro_torch.workloads.shapes import ShapeSampler

TierLike = Union[SLATier, Callable[[np.random.Generator], SLATier], None]


def _stamp_tier(req: Request, tier: TierLike, rng) -> Request:
    if tier is None:
        return req
    if isinstance(tier, SLATier):
        return tier.apply(req)
    return tier(rng).apply(req)


class OpenLoopWorkload:
    """Timed single-turn requests from an arrival process and a shape
    sampler. Open loop: the stream never reacts to completions, so the
    same seed always yields the identical event stream."""

    def __init__(self, arrivals: ArrivalProcess, shape: ShapeSampler, *,
                 vocab: int, seed: int = 0, max_requests: int = 10_000,
                 horizon_s: float = float("inf"), tier: TierLike = None,
                 start_rid: int = 0):
        assert vocab > 0
        self.arrivals = arrivals
        self.shape = shape
        self.vocab = vocab
        self.max_requests = max_requests
        self.horizon_s = horizon_s
        self.tier = tier
        self.rng = np.random.default_rng(seed)
        self._ids = itertools.count(start_rid)
        self._t = 0.0
        self._emitted = 0
        self._spent = False
        self._next: Optional[Request] = None
        self._advance()

    def _advance(self) -> None:
        """Lazily draw the next request (one event of lookahead, so
        ``next_arrival`` is always known)."""
        self._next = None
        if self._spent or self._emitted >= self.max_requests:
            self._spent = True
            return
        t = self.arrivals.next_after(self.rng, self._t)
        if t is None or t > self.horizon_s:
            self._spent = True
            return
        isl, osl = self.shape.sample(self.rng)
        prompt = self.rng.integers(0, self.vocab, size=isl).astype(np.int32)
        req = Request(rid=next(self._ids), prompt=prompt, osl=osl,
                      arrival_t=t)
        self._next = _stamp_tier(req, self.tier, self.rng)
        self._t = t
        self._emitted += 1

    # -- Workload protocol -------------------------------------------------

    def poll(self, now: float) -> List[Request]:
        out: List[Request] = []
        while self._next is not None and self._next.arrival_t <= now:
            out.append(self._next)
            self._advance()
        return out

    def next_arrival(self) -> Optional[float]:
        return self._next.arrival_t if self._next is not None else None

    def on_complete(self, req: Request, now: float) -> None:
        pass

    def exhausted(self) -> bool:
        return self._next is None

    def expected_requests(self) -> float:
        """Expected emission count — the mixture weight ``Superpose`` uses.
        A count-limited arrival process (``Burst.size``) wins over the
        rate x horizon estimate; an unbounded process falls back to the
        ``max_requests`` cap (which is what will actually be emitted)."""
        n = float(self.max_requests)
        size = getattr(self.arrivals, "size", None)
        if size is not None:
            n = min(n, float(size))
        rate = self.arrivals.mean_rate()
        if np.isfinite(rate) and np.isfinite(self.horizon_s):
            n = min(n, rate * self.horizon_s)
        return n

    def summary(self) -> WorkloadSummary:
        isl, osl = self.shape.expected()
        rate = self.arrivals.mean_rate()
        return WorkloadSummary(isl=isl, osl=osl,
                               rate=rate if np.isfinite(rate) else 0.0)
