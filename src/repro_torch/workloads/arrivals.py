"""Arrival processes: *when* requests show up.

An ``ArrivalProcess`` yields inter-arrival gaps against the cluster's
virtual clock. Composed with a ``ShapeSampler`` by ``OpenLoopWorkload``
(workloads/generators.py); the diurnal / piecewise processes subsume the
old hand-built two-phase ``TrafficGen`` hacks (``rate=1e6`` bursts, manual
``arrival_t`` offsets) the examples used to fake non-Poisson traffic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class ArrivalProcess(Protocol):
    def next_after(self, rng: np.random.Generator, t: float
                   ) -> Optional[float]:
        """Absolute time of the next arrival strictly after ``t`` (monotone
        non-decreasing across calls), or None when the process is spent."""
        ...

    def mean_rate(self) -> float:
        """Long-run offered request rate (req/s) for summaries."""
        ...


@dataclasses.dataclass
class Poisson:
    """Memoryless arrivals at a constant rate (the classic open-loop M/·)."""
    rate: float

    def __post_init__(self):
        assert self.rate > 0

    def next_after(self, rng, t):
        return t + rng.exponential(1.0 / self.rate)

    def mean_rate(self):
        return self.rate


@dataclasses.dataclass
class Burst:
    """``size`` arrivals at time ``at`` (optionally ``spacing`` seconds
    apart) — replaces the ``rate=1e6`` Poisson hack for closed bursts."""
    size: int
    at: float = 0.0
    spacing: float = 0.0

    def __post_init__(self):
        assert self.size > 0
        self._emitted = 0

    def next_after(self, rng, t):
        if self._emitted >= self.size:
            return None
        t_i = self.at + self._emitted * self.spacing
        self._emitted += 1
        return max(t, t_i)

    def mean_rate(self):
        if self.spacing > 0:
            return 1.0 / self.spacing
        return float("inf")


@dataclasses.dataclass
class PiecewiseRate:
    """Piecewise-constant Poisson: ``phases = [(duration_s, rate), ...]``.

    Exact (not an approximation): exponential gaps are memoryless, so a draw
    that crosses a phase boundary is simply re-drawn from the boundary at
    the new rate. ``repeat=True`` tiles the schedule forever (a square-wave
    diurnal cycle); otherwise the process ends after the last phase.
    """
    phases: Sequence[Tuple[float, float]]
    repeat: bool = False

    def __post_init__(self):
        assert self.phases and all(d > 0 and r >= 0 for d, r in self.phases)
        self._period = sum(d for d, _ in self.phases)

    def _phase_at(self, t: float) -> Tuple[float, float]:
        """(rate, end_time) of the phase containing absolute time t."""
        if self.repeat:
            base = math.floor(t / self._period) * self._period
        else:
            base = 0.0
        local = t - base
        acc = 0.0
        for dur, rate in self.phases:
            acc += dur
            if local < acc:
                return rate, base + acc
        return 0.0, float("inf")        # past the schedule (repeat=False)

    def next_after(self, rng, t):
        t = max(t, 0.0)
        while True:
            rate, end = self._phase_at(t)
            if not self.repeat and t >= self._period:
                return None
            if rate <= 0:               # silent phase: jump to its end
                t = end
                continue
            gap = rng.exponential(1.0 / rate)
            if t + gap <= end:
                return t + gap
            t = end                     # crossed the boundary: restart there

    def mean_rate(self):
        return sum(d * r for d, r in self.phases) / self._period


@dataclasses.dataclass
class Diurnal:
    """Sinusoidal-rate Poisson via thinning (exact):
    ``rate(t) = base * (1 + amplitude * sin(2*pi*t/period + phase))``."""
    base: float
    amplitude: float = 0.5
    period: float = 86400.0
    phase: float = 0.0

    def __post_init__(self):
        assert self.base > 0 and 0 <= self.amplitude <= 1

    def _rate(self, t: float) -> float:
        return self.base * (1 + self.amplitude *
                            math.sin(2 * math.pi * t / self.period
                                     + self.phase))

    def next_after(self, rng, t):
        peak = self.base * (1 + self.amplitude)
        while True:
            t = t + rng.exponential(1.0 / peak)
            if rng.uniform() * peak <= self._rate(t):
                return t

    def mean_rate(self):
        return self.base


class Merged:
    """Superposition of arrival processes (rates add)."""

    def __init__(self, processes: List[ArrivalProcess]):
        assert processes
        self.processes = list(processes)
        self._pending: List[Optional[float]] = [None] * len(processes)

    def next_after(self, rng, t):
        for i, p in enumerate(self.processes):
            if self._pending[i] is None:
                self._pending[i] = p.next_after(rng, t)
        live = [x for x in self._pending if x is not None]
        if not live:
            return None
        nxt = min(live)
        self._pending[self._pending.index(nxt)] = None
        return nxt

    def mean_rate(self):
        return sum(p.mean_rate() for p in self.processes)
