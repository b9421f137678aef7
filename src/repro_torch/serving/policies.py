"""Pluggable policy seams for the ``Cluster`` serving runtime.

The paper's core finding (§4.3, Figs 9-10) is that Pareto-optimal
disaggregation hinges on *swappable policy* — dynamic rate matching and
elastic scaling — not on a fixed pipeline. The runtime therefore exposes
three protocol seams, each the unit of experimentation for a family of
scenarios:

  - ``SchedulerPolicy``: admission + batch formation. Which queued request
    does a prefill-capable engine take next, and how is its prefill run
    (whole-prompt vs chunked/piggybacked)?
  - ``Router``: prefill->decode placement. Which decode-capable engine
    receives the KV cache (the disaggregation hop)?
  - ``RateMatcher``: pool sizing over time. How many engines play each role
    (static analytic split vs elastic runtime re-balancing)?

``cluster.Cluster`` drives all three from one virtual-time event loop,
fed by a ``repro_torch.workloads`` scenario through ``Cluster.serve``.

This is the port's copy of ``repro.serving.policies``, every policy
included.
"""
from __future__ import annotations

from fractions import Fraction
from typing import (Any, List, Optional, Protocol, TYPE_CHECKING, Tuple,
                    runtime_checkable)

from repro_torch.core.rate_matching import split_pool
from repro_torch.serving.elastic import ElasticConfig, ElasticRateMatcher
from repro_torch.serving.request import Request

if TYPE_CHECKING:       # annotation-only: policies are backend-agnostic
    from repro_torch.serving.engine import Engine


# --------------------------------------------------------------------------
# SchedulerPolicy: admission + batch formation
# --------------------------------------------------------------------------

@runtime_checkable
class SchedulerPolicy(Protocol):
    """Picks the next request for a prefill-capable engine and runs its
    prefill. Implementations may keep state (e.g. affinity maps)."""

    def select(self, cluster, engine: Engine) -> Optional[Request]:
        """Next request this engine should admit, or None. Must pick from
        ``cluster.ready_requests()``; the cluster removes it from the queue."""
        ...

    def run_prefill(self, cluster, engine: Engine, req: Request
                    ) -> Tuple[int, Any]:
        """Execute the prefill for an admitted request -> (first_tok, cache).
        May interleave decode via ``cluster.decode_round(engine)``."""
        ...


class FCFSScheduler:
    """First-come-first-served whole-prompt prefill — the baseline policy
    both legacy orchestrators hardcoded."""

    def select(self, cluster, engine):
        # head-of-queue probe: O(1), never materializes the ready list
        return cluster.first_ready()

    def run_prefill(self, cluster, engine, req):
        return engine.prefill(req.prompt)


class PriorityScheduler(FCFSScheduler):
    """SLA-aware admission: urgent classes first (``Request.priority``,
    larger = more urgent), deadline-tightest first within a class (requests
    declaring an ``ftl_target_s`` order by slack), FCFS as the tiebreak."""

    def select(self, cluster, engine):
        ready = cluster.ready_requests()
        if not ready:
            return None

        def key(r):
            slack = (r.arrival_t + r.ftl_target_s - cluster.now
                     if r.ftl_target_s is not None else float("inf"))
            return (-r.priority, slack, r.arrival_t, r.rid)
        return min(ready, key=key)


class PrefixAffinityScheduler:
    """Routes requests sharing prompt prefixes to the engine already holding
    their prefix in its ``PrefixCache`` (Mooncake/SGLang-style locality), and
    prefills in chunks so the cache is actually consulted/populated.

    An engine prefers the ready request with the longest cached common prefix
    *on that engine*; with no hit anywhere it falls back to FCFS, which
    naturally shards distinct prefix families across the pool."""

    def __init__(self, chunk: int = 8):
        self.chunk = chunk
        self._memo = {}     # (engine_id, rid, cache_version) -> hit length

    def on_episode(self, cluster):
        """New serve() episode: rids restart, so per-request memos from the
        previous episode must not alias onto new requests."""
        self._memo.clear()

    def _hit_len(self, engine, req):
        """match_len is an O(entries x isl) scan; memoize per (engine,
        request, cache version) so a scheduling round probes each live pair
        at most once across all select() calls."""
        pc = engine.prefix_cache
        if pc is None:
            return 0
        key = (engine.engine_id, req.rid, pc.version)
        n = self._memo.get(key)
        if n is None:
            if len(self._memo) > 1 << 16:
                self._memo.clear()
            n = pc.match_len(req.prompt)
            self._memo[key] = n
        return n

    def select(self, cluster, engine):
        ready = cluster.ready_requests()
        if not ready:
            return None
        hits = {r.rid: self._hit_len(engine, r) for r in ready}
        best = max(ready, key=lambda r: (hits[r.rid], -r.arrival_t))
        if hits[best.rid] > 0:
            return best
        # no affinity for this engine: leave requests whose prefix lives on a
        # *different* engine for that engine, take the oldest unaffiliated one
        others = [e for e in cluster.prefill_capable_healthy()
                  if e is not engine and e.healthy
                  and e.prefix_cache is not None]
        for r in ready:
            if not any(self._hit_len(e, r) > 0 for e in others):
                return r
        return ready[0]

    def run_prefill(self, cluster, engine, req):
        if engine.prefix_cache is None:     # engine built without chunking
            return engine.prefill(req.prompt)
        return engine.prefill_chunked(req.prompt, self.chunk)


class ChunkedPiggybackScheduler(FCFSScheduler):
    """Sarathi-style chunked prefill with decode piggybacked between chunks —
    the co-located orchestrator's policy, now expressible on any cluster."""

    def __init__(self, chunk: int):
        assert chunk > 0
        self.chunk = chunk

    def run_prefill(self, cluster, engine, req):
        return engine.prefill_chunked(
            req.prompt, self.chunk,
            on_chunk=lambda i, n: cluster.decode_round(engine))


# --------------------------------------------------------------------------
# Router: prefill -> decode placement
# --------------------------------------------------------------------------

@runtime_checkable
class Router(Protocol):
    def route(self, cluster, req: Request, src: Optional[Engine]
              ) -> Optional[Engine]:
        """Decode-capable engine to receive the KV cache, or None to wait
        for capacity. Must return an engine with a free slot."""
        ...


class FirstFitRouter:
    """Always scan from the head of the decode pool — the legacy
    orchestrator placement (packs early engines densely)."""

    def route(self, cluster, req, src):
        for eng in cluster.decode_capable_healthy():
            if eng.healthy and eng.has_free_slot():
                return eng
        return None


class RoundRobinRouter:
    """First alive decode engine with a free slot, scanning from a rotating
    start — degenerates to the legacy first-fit scan on a 1-engine pool."""

    def __init__(self):
        self._next = 0

    def route(self, cluster, req, src):
        pool = cluster.decode_capable_healthy()
        if not pool:
            return None
        n = len(pool)
        for i in range(n):
            eng = pool[(self._next + i) % n]
            if eng.healthy and eng.has_free_slot():
                self._next = (self._next + i + 1) % n
                return eng
        return None


class LeastLoadedRouter:
    """Fewest active slots wins (ties: lowest engine id) — spreads decode
    batch pressure evenly so per-step batch sizes stay balanced."""

    def route(self, cluster, req, src):
        best = None
        best_key = None
        for e in cluster.decode_capable_healthy():
            if not e.healthy or not e.has_free_slot():
                continue
            key = (e.active, e.engine_id)
            if best_key is None or key < best_key:
                best, best_key = e, key
        return best


class KVLocalityRouter:
    """Keep the KV where it was produced when possible: if the prefilling
    engine itself can decode (mixed/colocated role) and has a free slot, the
    insert is a local scatter and the transfer hop disappears. Otherwise
    fall back to least-loaded placement."""

    def __init__(self):
        self._fallback = LeastLoadedRouter()

    def route(self, cluster, req, src):
        if (src is not None and src.healthy and src.has_free_slot()
                and src in cluster.decode_capable_healthy()):
            return src
        return self._fallback.route(cluster, req, src)


# --------------------------------------------------------------------------
# RateMatcher: pool sizing over time
# --------------------------------------------------------------------------

@runtime_checkable
class RateMatcher(Protocol):
    """May also define ``prepare(cluster)``, called once before the first
    scheduling round (initial pool sizing)."""

    def step(self, cluster) -> None:
        """Called once per scheduling round; may migrate engines between
        ``cluster.prefill_pool`` and ``cluster.decode_pool``."""
        ...

    def on_failure(self, cluster, engine: Engine) -> None:
        """Called after a dead engine's requests were re-queued."""
        ...


class ElasticPolicy:
    """The dynamic rate matcher: wraps ``elastic.ElasticRateMatcher``
    (queue-depth vs decode-occupancy triggers, straggler drain, failover)
    behind the ``RateMatcher`` protocol."""

    def __init__(self, elastic: Optional[ElasticRateMatcher] = None, *,
                 cfg: Optional[ElasticConfig] = None,
                 tick_every_s: Optional[float] = None):
        self.elastic = elastic or ElasticRateMatcher(cfg or ElasticConfig())
        # timed cadence: when set, the event loop schedules an
        # EV_REBALANCE tick every tick_every_s *virtual* seconds and
        # step() stops counting rounds — fleet-scale runs want rebalance
        # pressure tied to traffic drift, not to round count (rounds per
        # simulated second vary wildly with fleet occupancy)
        self.tick_every_s = tick_every_s

    @property
    def moves(self) -> List[str]:
        return self.elastic.moves

    @property
    def last_signal(self):
        """Latest (backlog, decode occupancy) rebalance signal — attached
        to "rebalance" span events by the trace recorder."""
        return self.elastic.last_signal

    def step(self, cluster):
        if self.tick_every_s is None:
            self.elastic.maybe_rebalance(cluster)

    def tick(self, cluster):
        """Virtual-time rebalance (fired by the event heap)."""
        self.elastic.rebalance_now(cluster)

    def on_failure(self, cluster, engine):
        self.elastic.on_failure(cluster, engine)


class StaticSplitRateMatcher:
    """The fixed-ratio baseline (paper Fig 10): size the prefill:decode pools
    once from the analytic rate-matching alpha (Appendix B Algorithm 2 via
    ``core.rate_matching``) and hold that split. Re-asserts the split only
    when a failure shrinks the fleet, so the comparison against
    ``ElasticPolicy`` isolates *dynamic* adaptation as the variable."""

    def __init__(self, alpha: Fraction | float):
        if float(alpha) <= 0:
            raise ValueError(
                f"static split needs a positive prefill:decode alpha, "
                f"got {alpha}")
        self.alpha = alpha
        self.moves: List[str] = []
        self._applied = False

    def _rebalance(self, cluster, why: str):
        pre, dec = cluster.prefill_pool, cluster.decode_pool
        total = len([e for e in pre + dec if e.healthy])
        if total < 2:
            return
        n_pre, _ = split_pool(total, self.alpha)
        while len([e for e in pre if e.healthy]) > n_pre:
            eng = min((e for e in pre if e.healthy), key=lambda e: e.active)
            cluster.migrate(eng, pre, dec)
            self.moves.append(f"{eng.engine_id}:{why}->decode")
        while len([e for e in pre if e.healthy]) < n_pre \
                and len([e for e in dec if e.healthy]) > 1:
            eng = min((e for e in dec if e.healthy), key=lambda e: e.active)
            cluster.migrate(eng, dec, pre)
            self.moves.append(f"{eng.engine_id}:{why}->prefill")

    def prepare(self, cluster):
        """Size the pools before the first round, so no request lands on an
        engine the split is about to move."""
        self._applied = True
        self._rebalance(cluster, "static-split")

    def step(self, cluster):
        if not self._applied:       # direct driving without run()/prepare()
            self.prepare(cluster)

    def on_failure(self, cluster, engine):
        cluster.retire(engine)
        self._rebalance(cluster, "failover")


__all__ = [
    "SchedulerPolicy", "FCFSScheduler", "PriorityScheduler",
    "PrefixAffinityScheduler", "ChunkedPiggybackScheduler",
    "Router", "FirstFitRouter", "RoundRobinRouter", "LeastLoadedRouter",
    "KVLocalityRouter",
    "RateMatcher", "ElasticPolicy", "StaticSplitRateMatcher",
]
