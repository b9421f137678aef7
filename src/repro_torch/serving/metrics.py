"""Incremental serving metrics: O(1) memory over million-request episodes.

The port's copy of ``repro.serving.metrics``, unchanged.

``Cluster.serve`` historically retained every completed ``Request`` and
computed ``sla_metrics`` over the full list at episode end — fine for
thousands of requests, fatal for the fleet-scale runs the paper's studies
need (1k engines x multi-day diurnal traffic x 1e6+ requests). This module
provides the streaming replacement: pass ``metrics=StreamingMetrics()`` to
``serve`` and the loop feeds completions into fixed-size accumulators
instead of keeping requests alive, so peak RSS stays flat no matter how
long the episode runs (asserted by ``tests/test_metrics.py``).

Three pieces, each with bounded state:

- ``QuantileSketch``: DDSketch-style log-bucketed histogram. Relative
  accuracy ``alpha`` (default 0.5%) over [1e-9 s, ~1e7 s] costs ~3k int64
  buckets; p50/p99 estimates land within 1% of exact numpy percentiles on
  1M-sample streams.
- ``WindowedRate``: ring-buffer event rate over a sliding virtual-time
  window, with exact running totals kept alongside for batch
  cross-checks.
- ``StreamingMetrics``: the ``serve`` hook object. ``result()`` mirrors
  ``request.sla_metrics`` key-for-key (quantiles via sketches, means and
  spans exactly) and adds windowed throughput + per-pool occupancy.

numpy-only (no jax), like the rest of the simulation path.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

import numpy as np

__all__ = ["QuantileSketch", "WindowedRate", "StreamingMetrics"]


class QuantileSketch:
    """Fixed-size log-bucket quantile sketch (the DDSketch construction).

    Bucket ``k`` covers ``(min_value * gamma^(k-1), min_value * gamma^k]``
    with ``gamma = (1 + alpha) / (1 - alpha)``; reporting the geometric
    midpoint bounds the *relative* error of any quantile by ``alpha``.
    Values at or below ``min_value`` (including zeros) collapse into
    bucket 0; values beyond the top bucket clamp into it. Memory is the
    bucket array — independent of how many samples stream through."""

    def __init__(self, alpha: float = 0.005, min_value: float = 1e-9,
                 max_value: float = 1e7):
        self.alpha = float(alpha)
        self._min = float(min_value)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lng = math.log(self._gamma)
        nbuckets = int(math.ceil(
            math.log(max_value / min_value) / self._lng)) + 2
        self._counts = np.zeros(nbuckets, dtype=np.int64)
        self.count = 0

    def _index(self, x: float) -> int:
        if x <= self._min:
            return 0
        k = int(math.ceil(math.log(x / self._min) / self._lng))
        return min(max(k, 0), len(self._counts) - 1)

    def add(self, x: float) -> None:
        self._counts[self._index(x)] += 1
        self.count += 1

    def add_many(self, xs) -> None:
        """Bulk insert (one vectorized pass — the per-request TTL lists)."""
        x = np.asarray(xs, dtype=np.float64)
        if x.size == 0:
            return
        with np.errstate(divide="ignore", invalid="ignore"):
            k = np.ceil(np.log(x / self._min) / self._lng)
        k = np.where(np.isfinite(k), k, 0.0)
        idx = np.clip(k, 0, len(self._counts) - 1).astype(np.int64)
        self._counts += np.bincount(idx, minlength=len(self._counts))
        self.count += int(x.size)

    def quantile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]); NaN when empty."""
        if self.count == 0:
            return float("nan")
        target = (self.count - 1) * (q / 100.0)
        cum = np.cumsum(self._counts)
        k = int(np.searchsorted(cum, target, side="right"))
        k = min(k, len(self._counts) - 1)
        if k == 0:
            return self._min
        # geometric midpoint of the bucket: 2 g^k / (g + 1) = g^(k-1/2)±a
        return self._min * 2.0 * self._gamma ** k / (self._gamma + 1.0)

    @property
    def nbytes(self) -> int:
        return int(self._counts.nbytes)


class WindowedRate:
    """Sliding-window event rate on the cluster's *virtual* clock.

    A ring of ``bins`` buckets each ``window_s / bins`` wide; ``add``
    advances the ring (zeroing skipped buckets) and ``rate`` is the ring
    sum over the window. Counts are integers so the incremental ring sum
    is exact, and the running ``total``/``t_first``/``t_last`` aggregates
    let tests recompute the window from scratch and compare exactly."""

    def __init__(self, window_s: float = 60.0, bins: int = 60):
        assert window_s > 0 and bins > 0
        self.window_s = float(window_s)
        self.bins = int(bins)
        self.bin_s = self.window_s / self.bins
        self._counts = np.zeros(self.bins, dtype=np.float64)
        self._cur: Optional[int] = None     # absolute index of newest bin
        self._sum = 0.0                     # ring sum (current window)
        self.total = 0.0
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.peak_rate = 0.0

    def add(self, t: float, n: float = 1.0) -> None:
        b = int(t // self.bin_s)
        if self._cur is None:
            self._cur = b
        if b > self._cur:                   # advance, zeroing skipped bins
            for i in range(1, min(b - self._cur, self.bins) + 1):
                j = (self._cur + i) % self.bins
                self._sum -= float(self._counts[j])
                self._counts[j] = 0.0
            self._cur = b
        self._counts[max(b, self._cur) % self.bins] += n
        self._sum += n
        self.total += n
        if self.t_first is None:
            self.t_first = t
        self.t_last = t
        r = self._sum / self.window_s
        if r > self.peak_rate:
            self.peak_rate = r

    def rate(self) -> float:
        """Events/s over the window ending at the newest bin."""
        return self._sum / self.window_s

    def window_total(self) -> float:
        """Events in the current window (exact ring sum)."""
        return self._sum

    def totals(self) -> Dict[str, float]:
        """Exact lifetime aggregates (for batch cross-checks)."""
        return {"total": self.total,
                "t_first": self.t_first if self.t_first is not None else 0.0,
                "t_last": self.t_last if self.t_last is not None else 0.0}


class StreamingMetrics:
    """Incremental stand-in for ``request.sla_metrics``.

    ``Cluster.serve(workload, metrics=StreamingMetrics())`` stops
    retaining completed requests and returns ``result()`` instead —
    identical keys, with quantiles estimated by ``QuantileSketch`` (within
    its ``alpha``) and counts / means / throughput spans computed exactly.
    Extra fleet-level keys (windowed + peak rates, per-pool occupancy,
    arrival count) ride along under names ``sla_metrics`` never used."""

    def __init__(self, *, window_s: float = 60.0,
                 occupancy_every_s: float = 1.0, alpha: float = 0.005):
        self._ftl = QuantileSketch(alpha)
        self._ttl = QuantileSketch(alpha)
        # per-phase latency-attribution sketches (Request.queue_wait_s /
        # prefill_s / transfer_s / decode_stall_s)
        self._queue = QuantileSketch(alpha)
        self._pre = QuantileSketch(alpha)
        self._xfer = QuantileSketch(alpha)
        self._stall = QuantileSketch(alpha)
        self.arrived = 0
        self.completed = 0
        self._wait_sum = 0.0
        self._wait_n = 0
        self._sla_met = 0
        self._tokens = 0
        self._t0: Optional[float] = None    # min arrival among completed
        self._t1 = 0.0                      # max completion time
        self.completions = WindowedRate(window_s)
        self.tokens = WindowedRate(window_s)
        self._occ_every = float(occupancy_every_s)
        self._occ_next = -math.inf
        self._occ: Dict[str, List[float]] = {}   # pool -> [frac sum, n]

    # ---- serve hooks -----------------------------------------------------

    def on_arrival(self, req, now: float) -> None:
        self.arrived += 1

    def on_complete(self, req, now: float) -> None:
        self.completed += 1
        ftl = req.ftl
        if ftl is not None:
            self._ftl.add(ftl)
        ttls = req.ttls
        if ttls:
            self._ttl.add_many(ttls)
        w = req.queue_wait_s
        if w is not None:
            self._wait_sum += w
            self._wait_n += 1
            self._queue.add(w)
        pre = req.prefill_s
        if pre is not None:
            self._pre.add(pre)
        xfer = req.transfer_s
        if xfer is not None:
            self._xfer.add(xfer)
        stall = req.decode_stall_s
        if stall is not None:
            self._stall.add(stall)
        self._sla_met += bool(req.sla_met)
        ntok = len(req.output)
        self._tokens += ntok
        if self._t0 is None or req.arrival_t < self._t0:
            self._t0 = req.arrival_t
        done_t = req.done_t if req.done_t is not None else now
        if done_t > self._t1:
            self._t1 = done_t
        self.completions.add(done_t)
        self.tokens.add(done_t, ntok)

    def on_round(self, cluster) -> None:
        """Occupancy sampling, rate-limited on the virtual clock so a busy
        round storm costs one pool walk per ``occupancy_every_s``."""
        now = cluster.now
        if now < self._occ_next:
            return
        self._occ_next = now + self._occ_every
        # sorted role order: _occ insertion order (and so the
        # occupancy_<pool> column order in result()) is stable no matter
        # which pool a cluster happened to mutate first
        for name in sorted(cluster.pools):
            pool = cluster.pools[name]
            used = 0
            cap = 0
            for e in pool:
                if e.healthy:
                    used += e.active
                    cap += e.slots
            rec = self._occ.setdefault(name, [0.0, 0])
            rec[0] += used / cap if cap else 0.0
            rec[1] += 1

    # ---- report ----------------------------------------------------------

    def result(self) -> Dict[str, float]:
        p50_ttl = self._ttl.quantile(50)
        span = max(self._t1 - (self._t0 if self._t0 is not None else 0.0),
                   1e-9)
        out = {
            "completed": self.completed,
            "p50_ftl_s": self._ftl.quantile(50),
            "p99_ftl_s": self._ftl.quantile(99),
            "p50_ttl_s": p50_ttl,
            "p99_ttl_s": self._ttl.quantile(99),
            "queue_wait_s": (self._wait_sum / self._wait_n
                             if self._wait_n else 0.0),
            "p50_queue_wait_s": self._queue.quantile(50),
            "p99_queue_wait_s": self._queue.quantile(99),
            "p50_prefill_s": self._pre.quantile(50),
            "p99_prefill_s": self._pre.quantile(99),
            "p50_transfer_s": self._xfer.quantile(50),
            "p99_transfer_s": self._xfer.quantile(99),
            "p50_decode_stall_s": self._stall.quantile(50),
            "p99_decode_stall_s": self._stall.quantile(99),
            "sla_attainment": (self._sla_met / self.completed
                               if self.completed else 0.0),
            "tokens_per_s": self._tokens / span,
            "tps_per_user": (1.0 / p50_ttl
                             if self._ttl.count and p50_ttl > 0 else 0.0),
            # fleet extras (absent from batch sla_metrics)
            "arrived": self.arrived,
            "window_rps": self.completions.rate(),
            "peak_rps": self.completions.peak_rate,
            "window_tokens_per_s": self.tokens.rate(),
            "peak_tokens_per_s": self.tokens.peak_rate,
        }
        for name, (frac, n) in sorted(self._occ.items()):
            out[f"occupancy_{name}"] = frac / n if n else 0.0
        return out

    def result_json(self) -> str:
        """``result()`` as byte-stable JSON (``sort_keys``, non-finite
        quantiles of empty sketches rendered as null) — the form the trace
        exporter embeds and CI diffs."""
        clean = {k: (v if isinstance(v, (int,)) or math.isfinite(v)
                     else None)
                 for k, v in self.result().items()}
        return json.dumps(clean, sort_keys=True)
