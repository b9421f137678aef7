"""Shape samplers: *how big* each request is (ISL/OSL).

These wrap the analytic traffic models in ``core.traffic`` — the four §4.2
patterns and the Appendix-C lognormal — behind one sampling protocol, plus
mixtures of either. ``expected()`` exposes the marginals the analytic
sweeps consume via ``WorkloadSummary``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.traffic import PATTERNS, DynamicTraffic, TrafficPattern


@runtime_checkable
class ShapeSampler(Protocol):
    def sample(self, rng: np.random.Generator) -> Tuple[int, int]:
        """One (isl, osl) draw."""
        ...

    def expected(self) -> Tuple[float, float]:
        """(E[isl], E[osl]) — the summary marginals."""
        ...


@dataclasses.dataclass(frozen=True)
class FixedShape:
    """Constant ISL/OSL (the paper's power-of-two P50 approximations)."""
    isl: int
    osl: int

    @classmethod
    def from_pattern(cls, pattern: TrafficPattern) -> "FixedShape":
        return cls(pattern.isl, pattern.osl)

    def sample(self, rng):
        return self.isl, self.osl

    def expected(self):
        return float(self.isl), float(self.osl)


@dataclasses.dataclass(frozen=True)
class LognormalShape:
    """Appendix-C lognormal ISL/OSL mixture (``core.traffic.DynamicTraffic``
    as a per-request sampler)."""
    median_isl: int
    median_osl: int
    sigma_isl: float = 0.8
    sigma_osl: float = 0.7

    @classmethod
    def from_dynamic(cls, dyn: DynamicTraffic) -> "LognormalShape":
        return cls(dyn.median_isl, dyn.median_osl,
                   dyn.sigma_isl, dyn.sigma_osl)

    def sample(self, rng):
        isl = math.exp(rng.normal(math.log(self.median_isl), self.sigma_isl))
        osl = math.exp(rng.normal(math.log(self.median_osl), self.sigma_osl))
        return max(1, int(isl)), max(1, int(osl))

    def expected(self):
        # lognormal mean = median * exp(sigma^2 / 2)
        return (self.median_isl * math.exp(self.sigma_isl ** 2 / 2),
                self.median_osl * math.exp(self.sigma_osl ** 2 / 2))


class MixtureShape:
    """Weighted mixture of shape samplers (e.g. 80% chat + 20% long-doc)."""

    def __init__(self, components: Sequence[Tuple[float, ShapeSampler]]):
        assert components
        self.samplers = [s for _, s in components]
        w = np.asarray([max(float(x), 0.0) for x, _ in components])
        assert w.sum() > 0
        self.weights = w / w.sum()

    def sample(self, rng):
        i = int(rng.choice(len(self.samplers), p=self.weights))
        return self.samplers[i].sample(rng)

    def expected(self):
        ei = sum(w * s.expected()[0]
                 for w, s in zip(self.weights, self.samplers))
        eo = sum(w * s.expected()[1]
                 for w, s in zip(self.weights, self.samplers))
        return float(ei), float(eo)


# The four §4.2 patterns as ready-made samplers, keyed by pattern name.
PATTERN_SHAPES = {p.name: FixedShape.from_pattern(p) for p in PATTERNS}
