"""Policy-driven serving runtime: one event loop, role-tagged engine pools.

The PyTorch port's own copy of ``repro.serving.cluster`` (the port imports
nothing of the JAX package). ``Cluster`` owns pools of ``Engine``s tagged
by role — ``"prefill"``, ``"decode"``, or ``"mixed"`` — and drives them
with a single virtual-time event loop over real compute: engine step wall
times advance the cluster clock, so FTL/TTL/throughput metrics reflect
actual computation (scaled by straggler-injection factors where tests use
them).

Traffic comes in through ``serve(workload)``: a ``repro_torch.workloads``
``Workload`` is pulled incrementally as the virtual clock advances and is
fed every completion back, so closed-loop scenarios (multi-turn sessions
whose turn N+1 only exists after turn N finishes) are first-class.
``run(requests)`` is the static special case (a ``StaticWorkload``).

Every scheduling decision is delegated to three pluggable seams
(``serving/policies.py``):

  1. admission + batch formation  -> ``SchedulerPolicy``
  2. prefill->decode placement    -> ``Router``
  3. pool sizing over time        -> ``RateMatcher``

The paper's two deployment archetypes are configurations, not code paths:

  disagg    = Cluster({"prefill": [...], "decode": [...]}, ...)
  colocated = Cluster({"mixed": [...]},
                      scheduler=ChunkedPiggybackScheduler(...),
                      router=KVLocalityRouter())

Unlike the reference, this copy carries no invariant sanitizer, span
recorder or streaming-metrics hooks; those modules are not ported yet.

Fault tolerance is uniform: a dead engine raises ``EngineFailure``; the
cluster re-queues its in-flight requests (``Request.reset_for_requeue``) and
continues on the surviving pool, notifying the rate matcher for failover.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, TYPE_CHECKING, Tuple

import numpy as np

from repro_torch.serving.common import EngineFailure
from repro_torch.serving.request import Request, sla_metrics

if TYPE_CHECKING:       # Engine is annotation-only: the loop is backend-
    from repro_torch.serving.engine import Engine     # agnostic

PREFILL, DECODE, MIXED = "prefill", "decode", "mixed"

# EventQueue event kinds. ARRIVAL marks a future-dated queued request (the
# stuck-branch wake-up target); REBALANCE is an opt-in virtual-time rate-
# matcher tick (``RateMatcher.tick_every_s``).
EV_ARRIVAL, EV_REBALANCE = "arrival", "rebalance"


class EventQueue:
    """Min-heap of future virtual-time events keyed on ``(time, seq)``.

    ``seq`` is a monotone push counter, so ties break deterministically by
    insertion order and the pop order is total — two runs that push the
    same events in the same order pop them identically (the schedule-
    parity property ``tests/test_fleet_scale.py`` certifies). Entries are
    ``(time, seq, kind, payload)``; kinds are the ``EV_*`` constants plus
    whatever callers mint (payloads are opaque to the queue)."""

    __slots__ = ("_heap", "_seq")

    def __init__(self):
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._seq = 0

    def push(self, t: float, kind: str, payload: Any = None) -> int:
        """Schedule ``kind`` at virtual time ``t``; returns the tie-break
        sequence number assigned to the event."""
        self._seq += 1
        heapq.heappush(self._heap, (float(t), self._seq, kind, payload))
        return self._seq

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def peek(self) -> Optional[Tuple[float, int, str, Any]]:
        return self._heap[0] if self._heap else None

    def pop(self) -> Tuple[float, int, str, Any]:
        return heapq.heappop(self._heap)

    def pop_due(self, now: float) -> Optional[Tuple[float, int, str, Any]]:
        """Pop the earliest event scheduled at or before ``now`` — O(1)
        when nothing is due, which is every round on a tickless cluster."""
        if self._heap and self._heap[0][0] <= now:
            return heapq.heappop(self._heap)
        return None

    def next_wake(self, now: float) -> Optional[float]:
        """Earliest scheduled time strictly after ``now`` (stale entries at
        or before ``now`` are dropped in passing), or None when idle."""
        while self._heap:
            t = self._heap[0][0]
            if t > now:
                return t
            heapq.heappop(self._heap)
        return None

    def clear(self) -> None:
        self._heap.clear()


class AdmissionQueue:
    """Indexed admission queue: the list the event loop used to scan, with
    the two hot operations made O(1) — removal by identity (every admission
    did ``list.remove``) and front-insertion (every requeue) — and the
    ready-prefix scan made O(ready) instead of O(queued).

    Order semantics match the old ``List[Request]`` exactly: requeued
    requests sit at the front (most recent requeue first), arrivals follow
    in append order. Arrivals from ``Workload.poll`` are chronological, so
    the "arrived by now" requests form a prefix and ``ready(now)`` stops at
    the first future arrival; a caller that appends out of order only
    downgrades the scan to O(queued), never changes the result."""

    def __init__(self, on_append=None):
        # two insertion-ordered id(req)->req maps: _front holds requeues
        # (iterated newest-first), _back holds arrivals in append order
        self._front: Dict[int, Request] = {}
        self._back: Dict[int, Request] = {}
        self._back_sorted = True
        self._last_arrival = float("-inf")
        # bumped on every content change; (now, _version) keys the
        # cluster's ready_requests() memo
        self._version = 0
        # arrival hook: the cluster heap-schedules future-dated appends so
        # the event loop can wake at the next arrival without scanning
        self._on_append = on_append

    def append(self, req: Request) -> None:
        self._version += 1
        self._back[id(req)] = req
        if req.arrival_t < self._last_arrival:
            self._back_sorted = False
        else:
            self._last_arrival = req.arrival_t
        if self._on_append is not None:
            self._on_append(req)

    def push_front(self, req: Request) -> None:
        """Front-insert (requeue). Re-inserting a request that is already
        queued *moves* it to the front — a single entry, never two, so a
        later ``remove`` can't leave a ghost copy behind."""
        self._version += 1
        k = id(req)
        self._back.pop(k, None)
        self._front.pop(k, None)
        self._front[k] = req

    def insert(self, index: int, req: Request) -> None:
        assert index == 0, "admission queue only supports front insertion"
        self.push_front(req)

    def remove(self, req: Request) -> None:
        self._version += 1
        k = id(req)
        if k in self._front:
            del self._front[k]
        else:
            del self._back[k]       # KeyError ~ the old ValueError

    def __len__(self) -> int:
        return len(self._front) + len(self._back)

    def __iter__(self):
        yield from reversed(self._front.values())
        yield from self._back.values()

    def ready(self, now: float) -> List[Request]:
        """Arrived requests in queue order (requeues first). Front entries
        are filtered on arrival too — in-repo requeues always have past
        arrivals, but the queue is public and the old list scan excluded
        future-dated entries wherever they sat."""
        out = [r for r in reversed(self._front.values())
               if r.arrival_t <= now]
        for r in self._back.values():
            if r.arrival_t <= now:
                out.append(r)
            elif self._back_sorted:
                break
        return out

    def first_ready(self, now: float) -> Optional[Request]:
        """Head of ``ready(now)`` without materializing it — the FCFS
        admission probe, O(1) on chronological queues."""
        for r in reversed(self._front.values()):
            if r.arrival_t <= now:
                return r
        for r in self._back.values():
            if r.arrival_t <= now:
                return r
            if self._back_sorted:
                return None
        return None

    def ready_count(self, now: float) -> int:
        n = sum(1 for r in self._front.values() if r.arrival_t <= now)
        for r in self._back.values():
            if r.arrival_t <= now:
                n += 1
            elif self._back_sorted:
                break
        return n

    def next_future_arrival(self, now: float) -> Optional[float]:
        """Earliest queued arrival strictly after ``now``, or None."""
        future = None
        for r in self._front.values():
            if r.arrival_t > now and (future is None
                                      or r.arrival_t < future):
                future = r.arrival_t
        for r in self._back.values():
            if r.arrival_t > now:
                if self._back_sorted:
                    return (r.arrival_t if future is None
                            else min(future, r.arrival_t))
                if future is None or r.arrival_t < future:
                    future = r.arrival_t
        return future


class ObservedList(list):
    """A pool list that notifies the cluster on mutation, so cached healthy
    views stay correct under failures, migrations, and straggler drains
    (all of which edit pool lists directly)."""

    def __init__(self, items, on_change):
        super().__init__(items)
        self._on_change = on_change

    def _mut(name):
        fn = getattr(list, name)

        def wrapped(self, *a, **kw):
            out = fn(self, *a, **kw)
            self._on_change()
            return out
        wrapped.__name__ = name
        return wrapped

    append = _mut("append")
    extend = _mut("extend")
    insert = _mut("insert")
    remove = _mut("remove")
    pop = _mut("pop")
    clear = _mut("clear")
    sort = _mut("sort")
    reverse = _mut("reverse")
    __setitem__ = _mut("__setitem__")
    __delitem__ = _mut("__delitem__")
    __iadd__ = _mut("__iadd__")
    del _mut


@dataclasses.dataclass
class PoolStats:
    prefill_busy_s: float = 0.0
    decode_busy_s: float = 0.0
    transfers: int = 0
    transferred_bytes: int = 0
    requeued: int = 0
    engine_failures: int = 0
    drained_stragglers: int = 0


def kv_bytes(cache) -> int:
    """Size of one request's KV/state handoff payload (the Eq 1-2 hop).
    Called at most once per transferring request; caches that already
    know their payload size (``SimEngine``'s bookkeeping caches and the
    real engine's ``PagedCache``, which ships block-rounded true length
    instead of capacity-padded tensors) expose ``nbytes`` directly and
    skip the tensor walk."""
    nbytes = getattr(cache, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    return sum(int(np.prod(v.shape)) * v.dtype.itemsize
               for k, v in cache.items() if k != "pos")


class Cluster:
    """Role-tagged engine pools driven by one virtual-time event loop."""

    def __init__(self, pools: Dict[str, List[Engine]], *,
                 scheduler=None, router=None, rate_matcher=None):
        from repro_torch.serving.policies import FCFSScheduler, RoundRobinRouter
        assert pools and all(r in (PREFILL, DECODE, MIXED) for r in pools), \
            f"roles must be {PREFILL}/{DECODE}/{MIXED}: {list(pools)}"
        self._views: Dict[str, List[Engine]] = {}
        self.pools: Dict[str, List[Engine]] = {
            role: ObservedList(engines, self._invalidate_views)
            for role, engines in pools.items()}
        self._ensure_pool(PREFILL)
        self._ensure_pool(DECODE)
        self.scheduler = scheduler or FCFSScheduler()
        self.router = router or RoundRobinRouter()
        self.rate_matcher = rate_matcher
        self.queue = AdmissionQueue(self._note_arrival)
        self.pending_insert: List[Tuple[Request, int, Any,
                                        Optional[Engine]]] = []
        self.stats = PoolStats()
        self.now = 0.0
        self._workload = None       # set while serve() is driving
        # ready_requests() memo: ((now, queue version), snapshot)
        self._ready_cache: Optional[Tuple[Tuple[float, int],
                                          List[Request]]] = None
        self.events = EventQueue()
        # engines holding at least one resident request (id(engine) ->
        # engine): the decode phase walks this instead of the fleet, so
        # idle engines cost zero work per round
        self._occupied: Dict[int, Engine] = {}
        self._decode_scratch: List[Engine] = []

    # -- pool views (also the legacy orchestrator attribute surface) -------

    def _ensure_pool(self, role: str) -> List[Engine]:
        pool = self.pools.get(role)
        if pool is None:
            pool = self.pools[role] = ObservedList(
                [], self._invalidate_views)
        return pool

    def _invalidate_views(self) -> None:
        self._views.clear()

    def _note_arrival(self, req: Request) -> None:
        """AdmissionQueue append hook: heap-schedule future-dated arrivals
        so the event loop's stuck branch wakes at the next arrival in O(log
        events) instead of scanning the queue. Past-dated appends (the
        ``serve`` poll path delivers exactly those) cost one compare."""
        if req.arrival_t > self.now:
            self.events.push(req.arrival_t, EV_ARRIVAL)

    def _decode_pos(self) -> Dict[int, int]:
        """id(engine) -> iteration rank over ``decode_capable_healthy()``,
        memoized with the healthy views (pool mutations invalidate). The
        occupied-set decode phase sorts by this rank so it steps engines in
        exactly the order the full-fleet scan used to."""
        pos = self._views.get("__decode_pos__")
        if pos is None:
            pos = {}
            i = 0
            for e in self.decode_capable_healthy():
                pos[id(e)] = i
                i += 1
            self._views["__decode_pos__"] = pos
        return pos

    def _healthy_view(self, key: str, roles: Tuple[str, ...]) -> List[Engine]:
        """Cached healthy-engine list for a role set. Pool edits (failure,
        migration, straggler drain) invalidate through ``ObservedList``;
        ``Engine.fail()`` alone does not — the next use raises
        ``EngineFailure`` and ``_fail_engine`` invalidates then."""
        view = self._views.get(key)
        if view is None:
            view = [e for role in roles
                    for e in self.pools.get(role, ()) if e.healthy]
            self._views[key] = view
        return view

    @property
    def prefill_pool(self) -> List[Engine]:
        return self.pools[PREFILL]

    @property
    def decode_pool(self) -> List[Engine]:
        return self.pools[DECODE]

    @property
    def mixed_pool(self) -> List[Engine]:
        return self._ensure_pool(MIXED)

    def prefill_capable(self) -> List[Engine]:
        return self.pools[PREFILL] + self.pools.get(MIXED, [])

    def decode_capable(self) -> List[Engine]:
        return self.pools[DECODE] + self.pools.get(MIXED, [])

    def prefill_capable_healthy(self) -> List[Engine]:
        return self._healthy_view("prefill", (PREFILL, MIXED))

    def decode_capable_healthy(self) -> List[Engine]:
        return self._healthy_view("decode", (DECODE, MIXED))

    def engines(self) -> List[Engine]:
        """Every pooled engine (healthy or not), memoized until the next
        pool mutation (``ObservedList`` invalidates through
        ``_invalidate_views``). Treat as a read-only snapshot."""
        view = self._views.get("__all__")
        if view is None:
            view = [e for pool in self.pools.values() for e in pool]
            self._views["__all__"] = view
        return view

    def ready_requests(self) -> List[Request]:
        """Queued requests that have arrived, in queue order (requeued
        requests sit at the front). Memoized on (virtual time, queue
        version) — schedulers probing it once per engine per round share
        one scan. Treat as a read-only snapshot."""
        key = (self.now, self.queue._version)
        cached = self._ready_cache
        if cached is None or cached[0] != key:
            cached = (key, self.queue.ready(self.now))
            self._ready_cache = cached
        return cached[1]

    def ready_count(self) -> int:
        """Number of arrived-but-unadmitted requests (the rate matcher's
        backlog signal), without materializing the list."""
        return self.queue.ready_count(self.now)

    def first_ready(self) -> Optional[Request]:
        """Oldest arrived request (requeues first) without building the
        ready list — what FCFS admission actually consumes."""
        return self.queue.first_ready(self.now)

    def pool_hardware(self) -> Dict[str, Dict[str, int]]:
        """Per-role chip-class census (heterogeneous-pool telemetry), e.g.
        ``{"prefill": {"tpu-v5p": 1}, "decode": {"tpu-v5e": 2}}``."""
        out: Dict[str, Dict[str, int]] = {}
        for role, engines in self.pools.items():
            census: Dict[str, int] = {}
            for e in engines:
                census[e.hardware] = census.get(e.hardware, 0) + 1
            out[role] = census
        return out

    # -- mutation hooks shared with RateMatcher policies --------------------

    def requeue_inflight(self, eng: Engine):
        """Re-queue (at the front) everything in flight on an engine and
        release its slots — the one requeue path for failures, migrations,
        and straggler drains."""
        for slot, req in list(eng.slot_req.items()):
            req.reset_for_requeue()
            self.queue.insert(0, req)
            self.stats.requeued += 1
            eng.evict(slot)
        self._occupied.pop(id(eng), None)

    def migrate(self, eng: Engine, src: List[Engine], dst: List[Engine]):
        """Move a role-free engine between pools, re-queueing its in-flight
        requests (cache resets on role change)."""
        self.requeue_inflight(eng)
        src.remove(eng)
        dst.append(eng)

    def retire(self, eng: Engine):
        """Drop an engine from the fleet entirely (the rate-matcher
        failover path): re-queue anything still in flight, then remove it
        from every pool that holds it. Policies call this instead of
        editing pool lists directly."""
        self.requeue_inflight(eng)
        for pool in self.pools.values():
            if eng in pool:
                pool.remove(eng)

    def _fail_engine(self, eng: Engine):
        """Re-queue everything in flight on a dead engine."""
        self.stats.engine_failures += 1
        self._invalidate_views()    # the engine may stay pooled, unhealthy
        self.requeue_inflight(eng)
        if self.rate_matcher is not None:
            self.rate_matcher.on_failure(self, eng)

    # -- event loop ---------------------------------------------------------

    def run(self, requests: List[Request], *, max_wall_s: float = 1e9
            ) -> Dict[str, float]:
        """Serve a pre-materialized request list (a ``StaticWorkload``)."""
        from repro_torch.workloads.base import StaticWorkload
        return self.serve(StaticWorkload(requests), max_wall_s=max_wall_s)

    def serve(self, workload, *, until: Optional[float] = None,
              max_wall_s: float = 1e9) -> Dict[str, float]:
        """Drive a ``Workload`` through the virtual-time event loop.

        Events are pulled incrementally (``workload.poll``) as the clock
        advances, and completions are fed back (``workload.on_complete``)
        the moment a request finishes — closed-loop workloads (multi-turn
        sessions with think time) schedule their next event from that
        feedback. ``until`` stops *admitting* new arrivals at that virtual
        time and drains what is in flight; ``max_wall_s`` hard-stops the
        loop. Returns ``sla_metrics`` over every request the workload
        emitted.

        Each call is one episode: the virtual clock restarts at 0 so
        workload timestamps are serve-relative (back-to-back calls — e.g.
        a jit warm-up pass then a measured pass — stay comparable).
        Engine-local clocks/telemetry persist across episodes."""
        # an empty capability would spin the virtual clock to max_wall_s
        if not self.prefill_capable():
            raise ValueError("cluster has no prefill-capable engines "
                             "(prefill or mixed pool)")
        if not self.decode_capable():
            raise ValueError("cluster has no decode-capable engines "
                             "(decode or mixed pool)")
        served: List[Request] = []
        self.now = 0.0
        # a previous episode cut short by max_wall_s may have left queued
        # or in-flight work behind; each serve() starts clean — stale slot
        # occupants must not decode into (or complete against) this episode
        self.queue = AdmissionQueue(self._note_arrival)
        self._ready_cache = None    # fresh queue restarts at version 0
        self.pending_insert = []
        self.events.clear()         # no events from a cut-short episode
        self._occupied.clear()
        self._invalidate_views()    # engines may have failed between episodes
        for eng in self.engines():
            for slot in list(eng.slot_req):
                eng.evict(slot)
        on_episode = getattr(self.scheduler, "on_episode", None)
        if on_episode is not None:
            on_episode(self)    # e.g. drop per-request affinity memos
        self._workload = workload
        prepare = getattr(self.rate_matcher, "prepare", None)
        if prepare is not None:
            prepare(self)       # e.g. apply a static split before round 1
        # opt-in timed rebalance: a matcher declaring tick_every_s gets
        # tick(cluster) at that virtual-time cadence via the event heap
        # (event loop only — the frozen legacy loop never drains events)
        tick_every = getattr(self.rate_matcher, "tick_every_s", None)
        if tick_every:
            self.events.push(self.now + tick_every, EV_REBALANCE)
        try:
            while True:
                horizon = self.now if until is None \
                    else min(self.now, until)
                for r in workload.poll(horizon):
                    served.append(r)
                    self.queue.append(r)    # chronological; requeues stay
                    #                         at the front (reset_for_requeue)
                progressed = self._step()
                if self.now > max_wall_s:
                    break
                if self.rate_matcher is not None:
                    self.rate_matcher.step(self)
                if progressed:
                    continue
                # fully idle: jump the clock to the workload's next event
                # (until is inclusive, matching the poll horizon above)
                nxt = workload.next_arrival()
                if nxt is not None and (until is None or nxt <= until):
                    self.now = max(self.now, nxt)
                    continue
                break       # exhausted (or waiting on nothing: drained)
        finally:
            self._workload = None
        return sla_metrics(served)

    def _step(self) -> bool:
        """One scheduling round (the event-heap round). Returns False when
        everything is drained. The pre-heap full-fleet scan this replaced
        (``serving/legacy_loop.py``) soaked one PR behind
        ``legacy_loop=True`` with byte-identical schedules and is gone;
        schedule identity is now certified by trace parity
        (``tests/test_fleet_scale.py``)."""
        return self._step_event()

    def _fire_due_events(self) -> None:
        """Drain heap events scheduled at or before ``now``. ARRIVAL events
        are pure wake-ups (the request is already pollable); REBALANCE
        events call the rate matcher's ``tick`` and re-arm at its
        ``tick_every_s`` cadence. O(1) when nothing is due."""
        ev = self.events
        while True:
            due = ev.pop_due(self.now)
            if due is None:
                return
            t, _seq, kind, _payload = due
            if kind == EV_REBALANCE and self.rate_matcher is not None:
                tick = getattr(self.rate_matcher, "tick", None)
                if tick is not None:
                    tick(self)
                every = getattr(self.rate_matcher, "tick_every_s", None)
                if every:
                    nxt = t + every
                    if nxt <= self.now:     # idle jump skipped whole ticks:
                        nxt = self.now + every      # resume cadence from now
                    ev.push(nxt, EV_REBALANCE)

    def _step_event(self) -> bool:
        """The event-heap round: same three phases as the legacy scan, with
        the fleet-width work removed — admission probes stop once the ready
        queue is empty (``select`` is contract-bound to pick from
        ``ready_requests()``, so the skipped probes could only return None)
        and decode walks the occupied set instead of every engine, ordered
        by the memoized fleet rank so the schedule is byte-identical."""
        progressed = False
        self._fire_due_events()

        # 1) admission + prefill: the scheduler picks per prefill-capable
        #    engine; mixed engines also need a local decode slot to admit.
        #    first_ready() is re-probed after each admission because prefill
        #    advances the clock, which can ready future-dated queued
        #    requests; a select() that returns None leaves the probe valid
        #    (purity-checked: it touches neither the queue nor the clock).
        mixed = self.pools.get(MIXED, ())
        ready = self.first_ready() is not None
        for eng in self.prefill_capable_healthy():
            if not ready:
                break                   # nothing admissible: select would
            #                             return None for every later engine
            if not eng.healthy:         # failed since the view was cached
                continue
            if mixed and eng in mixed and not eng.has_free_slot():
                continue
            req = self.scheduler.select(self, eng)
            if req is None:
                continue
            self.queue.remove(req)
            req.prefill_start_t = max(self.now, req.arrival_t)
            n0 = len(eng.step_times)
            try:
                tok, cache = self.scheduler.run_prefill(self, eng, req)
            except EngineFailure:
                self.queue.insert(0, req)   # req was ready when selected,
                self._fail_engine(eng)      # so the cached probe stands
                continue
            # step_times[n0] is the prefill tick itself; piggybacked decode
            # rounds (which advance the clock on their own) append after it.
            dt = eng.step_times[n0]
            self.now += dt
            self.stats.prefill_busy_s += dt
            req.first_token_t = self.now
            req.output.append(tok)
            self.pending_insert.append((req, tok, cache, eng))
            progressed = True
            ready = self.first_ready() is not None      # queue + clock moved

        # 2) placement: the router assigns each pending KV cache to a decode
        #    slot (the disaggregation hop when it crosses engines).
        still = []
        for req, tok, cache, src in self.pending_insert:
            target = self.router.route(self, req, src)
            if target is None:
                still.append((req, tok, cache, src))
                continue
            target.insert(req, cache)
            self._occupied[id(target)] = target
            req._next_tok = tok
            req.insert_t = self.now
            if target is not src:
                self.stats.transfers += 1
                # one kv_bytes() per transferring request (an entry leaves
                # pending on insert); a PagedCache answers from its nbytes
                self.stats.transferred_bytes += kv_bytes(cache)
            progressed = True
        self.pending_insert = still

        # 3) decode: only engines holding requests step — the occupied set,
        #    sorted into the fleet-scan order the legacy loop used (engines
        #    outside the healthy view are skipped there exactly as the
        #    legacy decode_round guard skipped them: no progress either way)
        if self._occupied:
            pos = self._decode_pos()
            active = self._decode_scratch
            active.clear()
            for eng in self._occupied.values():
                rank = pos.get(id(eng))
                if rank is not None:
                    active.append((rank, eng))
            active.sort()       # ranks are unique: plain int-tuple sort
            for _rank, eng in active:
                progressed |= self.decode_round(eng)
            active.clear()      # drop engine refs between rounds

        if not progressed and (self.queue or self.pending_insert):
            # stuck waiting on arrivals or capacity: advance virtual time
            # to the next heap event (future-dated queued arrivals and
            # rebalance ticks both live there), else nudge
            future = self.events.next_wake(self.now)
            self.now = future if future is not None else self.now + 1e-3
            return True
        return progressed or bool(self.queue or self.pending_insert)

    def decode_round(self, eng: Engine) -> bool:
        """One decode step on one engine (public: piggyback policies
        interleave this between prefill chunks)."""
        if not eng.healthy or not eng.slot_req:
            return False
        toks = {s: r._next_tok for s, r in eng.slot_req.items()}
        try:
            nxt = eng.decode_step(toks)
        except EngineFailure:
            self._fail_engine(eng)
            return True
        dt = eng.step_times[-1]
        self.now += dt
        self.stats.decode_busy_s += dt
        for slot, tok in nxt.items():
            req = eng.slot_req[slot]
            req.output.append(tok)
            req.token_times.append(self.now)
            req._next_tok = tok
            req.decode_active_s += dt
            if req.done:
                req.done_t = self.now
                eng.evict(slot)
                if self._workload is not None:
                    self._workload.on_complete(req, self.now)
        if not eng.slot_req:        # drained: drop from the occupied set so
            self._occupied.pop(id(eng), None)   # idle rounds skip it
        return True
