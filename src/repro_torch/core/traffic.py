"""Traffic patterns (§4.2, Appendix C): the port's copy of
``repro.core.traffic``.

Constant-ISL/OSL patterns are the power-of-two P50 approximations the paper
uses; the lognormal sampler reproduces the Appendix-C dynamic-traffic check.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficPattern:
    name: str
    isl: int
    osl: int

    @property
    def prefill_heavy(self) -> bool:
        return self.isl >= 4 * self.osl


# The four §4.2 patterns (ISL:OSL)
PATTERNS = [
    TrafficPattern("prefill-heavy", 16384, 512),
    TrafficPattern("balanced", 4096, 1024),
    TrafficPattern("generation-heavy", 1024, 4096),
    TrafficPattern("long-context", 32768, 256),
]


@dataclasses.dataclass(frozen=True)
class DynamicTraffic:
    """Lognormal ISL/OSL mixture (Appendix C, Fig 13)."""
    median_isl: int
    median_osl: int
    sigma_isl: float = 0.8
    sigma_osl: float = 0.7

    def sample(self, n: int, seed: int = 0) -> List[Tuple[int, int]]:
        rng = np.random.default_rng(seed)
        isl = np.exp(rng.normal(math.log(self.median_isl), self.sigma_isl, n))
        osl = np.exp(rng.normal(math.log(self.median_osl), self.sigma_osl, n))
        return [(max(1, int(i)), max(1, int(o))) for i, o in zip(isl, osl)]

    def p50_pattern(self) -> TrafficPattern:
        """Closest power-of-two P50 approximation (Appendix C)."""
        return TrafficPattern(
            "p50-approx",
            2 ** round(math.log2(self.median_isl)),
            2 ** round(math.log2(self.median_osl)))
