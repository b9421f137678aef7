"""Throughput-interactivity Pareto frontiers (Fig 1 and friends).

Determinism contract (sweep goldens are byte-compared across runs and
platforms): ``pareto_frontier`` is a pure function of the *set* of input
points — input order never changes the output. Ties are broken explicitly:
exact duplicates collapse to one point, equal-interactivity points keep
only the max-throughput one, and equal-throughput points keep only the
max-interactivity one (weak dominance), so the frontier is strictly
increasing in x and strictly decreasing in y.

The port's copy of ``repro.core.pareto``, unchanged.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Point = Tuple[float, float]   # (interactivity = tokens/s/user, tput/chip)


def pareto_frontier(points: Sequence[Point]) -> List[Point]:
    """Upper-right frontier: max throughput for any given interactivity."""
    # sort on the full (x, y) value — a total order on the deduped set, so
    # the result is independent of input ordering (stable-sort ties cannot
    # leak input order through)
    pts = sorted(set(points), key=lambda p: (-p[0], -p[1]))
    out: List[Point] = []
    best = -math.inf
    for x, y in pts:
        # strict >: on equal y the earlier (larger-x) point weakly
        # dominates; on equal x the earlier (larger-y) point wins
        if y > best:
            out.append((x, y))
            best = y
    return list(reversed(out))   # ascending interactivity


def frontier_at(frontier: Sequence[Point], interactivity: float) -> float:
    """Best throughput achievable at >= the given interactivity."""
    best = 0.0
    for x, y in frontier:
        if x >= interactivity:
            best = max(best, y)
    return best


def area_under_frontier(frontier: Sequence[Point],
                        x_lo: float, x_hi: float, samples: int = 64) -> float:
    """The paper's versatility metric: area under the frontier over an
    interactivity window (log-spaced sampling; ``math.fsum`` keeps the
    reduction exactly associative-order-free)."""
    if not frontier or x_hi <= x_lo:
        return 0.0
    lo, hi = math.log(x_lo), math.log(x_hi)
    total = math.fsum(
        frontier_at(frontier, math.exp(lo + (hi - lo) * (i + 0.5) / samples))
        for i in range(samples))
    return total / samples


class ParetoAccumulator:
    """Incremental frontier merge for streaming sweeps.

    Shards of a design-space sweep complete out of order (multiprocessing,
    resume-from-partial-store); feeding each shard's points through
    ``add`` keeps a bounded working set instead of materializing the full
    point cloud, and ``frontier()`` at any moment equals
    ``pareto_frontier(all points added so far)`` — the compaction below is
    exact, not approximate, because dominated points can never rejoin a
    frontier."""

    def __init__(self, compact_at: int = 4096):
        assert compact_at >= 2
        self._compact_at = compact_at
        self._pts: List[Point] = []
        self._n_seen = 0

    def add(self, points: Iterable[Point]) -> "ParetoAccumulator":
        for p in points:
            self._pts.append(p)
            self._n_seen += 1
        if len(self._pts) >= self._compact_at:
            self._pts = pareto_frontier(self._pts)
        return self

    @property
    def n_seen(self) -> int:
        return self._n_seen

    def frontier(self) -> List[Point]:
        return pareto_frontier(self._pts)

    def area(self, x_lo: float, x_hi: float, samples: int = 64) -> float:
        return area_under_frontier(self.frontier(), x_lo, x_hi, samples)
