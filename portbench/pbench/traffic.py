"""One general traffic generator over the mixes of ``traffic/*.json``.

A mix is data: its arrivals (an open Poisson loop at a fixed rate, or a
closed loop of clients that each send their next request the moment the
last completes) and its length distributions. Every seed gets the same
multiset of prompt lengths, output lengths and inter-arrival gaps, in
another order: the seed permutes a pool of values taken once at the
distribution's stratified quantiles, and it draws the prompt's token
ids. An open loop's pool holds exactly the requests
due before the run stops (its rate times the run's horizon), so every run
sends the same requests, gaps summing to the same horizon, in another
order; a closed loop's holds ``pool`` requests (its clients' first
round), repeated in a fresh order after that. So runs of different seeds
do the same work and differ only in its order, which keeps their spread
close to that of two runs of one seed.

Times are seconds from the moment the load starts (the ramp's start).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np

MASK64 = (1 << 64) - 1


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one purpose of one run: any whole ``seed``, negative
    or above 64 bits included, maps to the same stream every time."""
    return np.random.default_rng([int(seed) & MASK64, stream])


def length_pool(spec: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` lengths at the stratified quantiles (i + 0.5) / n of the
    distribution ``spec``: ``loguniform`` or ``uniform`` over [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    lo, hi = float(spec["lo"]), float(spec["hi"])
    if kind == "loguniform":
        v = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    elif kind == "uniform":
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def gap_pool(spec: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` inter-arrival gaps (seconds) of an open loop at ``rate``
    requests a second: ``poisson``, at the exponential's stratified
    quantiles, rescaled so that the pool's mean gap is 1 / rate."""
    rate = float(spec["rate"])
    if rate <= 0:
        raise ValueError("an open loop needs a rate above 0")
    if spec["process"] != "poisson":
        raise ValueError(f"unknown arrival process {spec['process']!r}")
    u = (np.arange(n) + 0.5) / n
    g = -np.log1p(-u)
    return g / g.mean() / rate


@dataclasses.dataclass
class Item:
    """One request as the traffic makes it."""
    prompt: np.ndarray
    osl: int


class Traffic:
    """The request stream of one mix and one seed.

    ``item(j)`` is the j-th request made (its prompt and output length
    depend on ``j`` and the seed only); ``due(j)`` is an open loop's due
    time of request j. A closed loop of ``clients`` issues the next item the
    moment a client's request completes."""

    def __init__(self, mix: Dict[str, Any], seed: int, vocab: int,
                 horizon_s: float = 60.0):
        self.mix = mix
        self.vocab = int(vocab)
        arr = mix["arrivals"]
        if arr["process"] == "closed":
            n = int(mix.get("pool", arr["clients"]))
        else:
            n = max(16, int(round(float(arr["rate"]) * horizon_s)))
        self.n = n
        rng = rng_for(seed, 1)
        self._isl = length_pool(mix["isl"], n)[rng.permutation(n)]
        self._osl = length_pool(mix["osl"], n)[rng.permutation(n)]
        self.closed = arr["process"] == "closed"
        if self.closed:
            self.clients = int(arr["clients"])
            self._due = None
        else:
            gaps = gap_pool(arr, n)[rng.permutation(n)]
            self._due = np.cumsum(gaps)
            self._period = float(self._due[-1])
        self._tok_seed = seed

    def due(self, j: int) -> float:
        """Open loop: the due time of request j (past the horizon the pool
        repeats with its own period)."""
        wraps, i = divmod(j, self.n)
        return wraps * self._period + float(self._due[i])

    def item(self, j: int) -> Item:
        wraps, i = divmod(j, self.n)
        if wraps:           # past the pool: the same values, another order
            i = int(rng_for(self._tok_seed, 10 + wraps).permutation(
                self.n)[i])
        rng = rng_for(self._tok_seed, 1000 + j)
        prompt = rng.integers(0, self.vocab, int(self._isl[i]))
        return Item(prompt.astype(np.int32), int(self._osl[i]))


def load(path) -> Dict[str, Any]:
    import json
    with open(path) as f:
        mix = json.load(f)
    for key in ("arrivals", "isl", "osl", "ramp_s"):
        if key not in mix:
            raise ValueError(f"{path}: traffic mix lacks {key!r}")
    return mix


def bounds(spec: Dict[str, Any]) -> Tuple[int, int]:
    """The shortest and longest length a distribution can give."""
    return int(spec["lo"]), int(spec["hi"])


__all__: List[str] = ["Traffic", "Item", "load", "length_pool", "gap_pool",
                      "rng_for", "bounds"]
