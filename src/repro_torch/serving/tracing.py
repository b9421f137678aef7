"""Structured span/event tracing for the serving runtime (virtual time).

The port's copy of ``repro.serving.tracing``, unchanged but for its
imports of the port's own modules.

``TraceRecorder`` is the observability seam of ``serving.cluster.Cluster``:
the event loop calls the same narrow hook surface the sanitizer uses
(``rec = self.recorder; if rec is not None: rec.on_x(...)``) at every
request lifecycle transition

    arrival -> admit -> prefill -> transfer -> insert -> decode... -> complete

plus engine/fleet transitions (decode steps, requeues, engine failures,
migrations, rebalance ticks) and a rate-limited counter sample per
``counter_every_s`` of *virtual* time. Every event is a plain tuple keyed
on the cluster's virtual clock — no wallclock reads, no per-event dict or
string formatting — so two runs of the same seeded workload produce
byte-identical event streams (``span_digest``). ``content=False``
projects the stream to lifecycle structure (timestamps and modeled byte
counts dropped) for comparing runs whose clocks differ but whose event
order coincides; *cross-backend* parity is asserted per request
(``lifecycle``), since the interleaving of events across requests
follows each backend's own virtual clock.

Three consumers sit on top:

  1. latency attribution — the loop stamps ``Request.insert_t`` and
     accumulates ``Request.decode_active_s`` unconditionally (cheap field
     writes, identical with tracing on or off), so per-phase durations
     (``queue_wait/prefill/transfer/decode_stall``) telescope exactly to
     end-to-end latency and feed ``sla_metrics``/``StreamingMetrics``
     columns and sweep records whether or not a recorder is attached;
  2. the Chrome/Perfetto exporter (``serving.obs``) renders the event
     stream as one track per engine + async per-request phase slices +
     counter tracks;
  3. the ``FlightRecorder`` — a bounded ring of the most recent events,
     dumped with full span context on ``SanitizerError`` (the sanitizer's
     ad-hoc transition tail is replaced by this ring when a recorder is
     attached), engine failure, or SLO breach.

Disabled tracing is free: ``Cluster`` collapses a recorder whose
``enabled`` is false (``NullRecorder``) to ``None`` at construction, so
the hot path runs the exact ``is not None`` guard the hotpath budget
(``analysis/hotpath.py``) already audits — zero allocations, zero calls.
The fleet-scan loops inside ``TraceRecorder`` itself are *enabled-path
only* and carry annotated ``why`` entries in ``analysis/baseline.json``.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serving.metrics import WindowedRate

__all__ = ["NullRecorder", "TraceRecorder", "FlightRecorder",
           "LIFECYCLE_KINDS", "describe_engine"]

# request-lifecycle event kinds: ordered identically across backends when
# schedules match (the structural-parity surface). Time-driven kinds
# (counter/rebalance/decode/migrate) are excluded — their firing points
# depend on backend step *times*, not on the schedule.
LIFECYCLE_KINDS = ("arrival", "admit", "prefill", "insert", "complete",
                  "requeue", "engine_failure")

# structural projection: fields to drop from the *tail* of an event (after
# the backend-dependent floats are stripped) — insert carries nbytes,
# which the sim backend models rather than measures.
_STRUCT_DROP_TAIL = {"insert": 1}


def describe_engine(eng) -> Dict[str, Any]:
    """Engine metadata for trace track labels; tolerates test doubles
    that lack ``describe()``."""
    describe = getattr(eng, "describe", None)
    if describe is not None:
        return describe()
    return {"engine_id": getattr(eng, "engine_id", -1),
            "backend": getattr(eng, "backend", "unknown"),
            "hardware": getattr(eng, "hardware", "uniform"),
            "slots": getattr(eng, "slots", 0)}


class NullRecorder:
    """The no-op recorder: every hook is an empty method and ``enabled``
    is false, so ``Cluster`` collapses it to ``None`` at construction and
    the event loop never calls into it — the zero-allocation off state
    the hotpath budget verifies."""

    enabled = False
    flight: Optional["FlightRecorder"] = None
    events: Tuple = ()
    dumps: Tuple = ()

    def on_episode_begin(self, cluster) -> None:
        pass

    def on_arrival(self, req, t: float) -> None:
        pass

    def on_admit(self, req, eng, t: float) -> None:
        pass

    def on_prefill(self, req, eng, t0: float, t1: float) -> None:
        pass

    def on_insert(self, req, eng, src, t: float, nbytes: int) -> None:
        pass

    def on_decode_step(self, eng, t0: float, t1: float, batch: int) -> None:
        pass

    def on_complete(self, req, t: float) -> None:
        pass

    def on_requeue(self, req, t: float) -> None:
        pass

    def on_engine_failure(self, eng, t: float) -> None:
        pass

    def on_migrate(self, eng, dst_role: str, t: float) -> None:
        pass

    def on_rebalance(self, t: float, signal) -> None:
        pass

    def on_round(self, cluster) -> None:
        pass

    def span_digest(self, *, content: bool = True) -> str:
        return _digest((), content=content)


class FlightRecorder:
    """Bounded ring of the most recent trace events + the dump log.

    ``record`` is O(1) (deque append with maxlen); ``dump`` snapshots the
    ring with a reason/time/detail header — called on engine failure, SLO
    breach, and ``SanitizerError`` (the sanitizer holds a reference via
    ``ClusterSanitizer.flight``). At most ``max_dumps`` dumps are kept so
    a breach storm cannot grow memory; later ones only count."""

    def __init__(self, limit: int = 256, max_dumps: int = 8):
        self.ring: deque = deque(maxlen=int(limit))
        self.dumps: List[Dict[str, Any]] = []
        self.max_dumps = int(max_dumps)
        self.dropped_dumps = 0

    def record(self, ev: Tuple) -> None:
        self.ring.append(ev)

    def snapshot(self) -> List[Tuple]:
        return list(self.ring)

    def dump(self, reason: str, t: float, detail: str = ""
             ) -> Optional[Dict[str, Any]]:
        """Capture the ring under ``reason``; None once ``max_dumps`` hit."""
        if len(self.dumps) >= self.max_dumps:
            self.dropped_dumps += 1
            return None
        d = {"reason": reason, "t": t, "detail": detail,
             "events": self.snapshot()}
        self.dumps.append(d)
        return d

    def format(self, tail: int = 64) -> str:
        """Human-readable tail of the ring (oldest first) — what the
        sanitizer appends to ``SanitizerError`` messages."""
        evs = self.snapshot()[-tail:]
        return "\n".join(f"  {ev[0]} {ev[1:]}" for ev in evs)

    def clear(self) -> None:
        self.ring.clear()


class TraceRecorder:
    """The live span/event recorder (``enabled`` true).

    Events are plain tuples ``(kind, time(s)..., ids...)`` appended to a
    bounded list (``max_events``; overflow is counted, never grows) and
    mirrored into the ``FlightRecorder`` ring. State resets at each serve
    episode (``on_episode_begin``), matching the sanitizer's
    final-episode parity semantics, and engine metadata
    (``describe_engine``) is captured once per episode for track labels.

    All timestamps are the cluster's *virtual* clock — this module never
    reads wallclock (enforced by the determinism lint)."""

    enabled = True

    def __init__(self, *, ring: int = 256, max_events: int = 2_000_000,
                 max_dumps: int = 8, counter_every_s: float = 1.0,
                 window_s: float = 60.0):
        self.max_events = int(max_events)
        self.counter_every_s = float(counter_every_s)
        self.window_s = float(window_s)
        self.flight = FlightRecorder(ring, max_dumps)
        self.events: List[Tuple] = []
        self.dropped = 0
        self.episodes = 0
        self.engines: Dict[int, Dict[str, Any]] = {}
        self.roles: Dict[int, str] = {}
        self._counter_next = float("-inf")
        self._rate = WindowedRate(self.window_s)

    @property
    def dumps(self) -> List[Dict[str, Any]]:
        return self.flight.dumps

    # -- plumbing ----------------------------------------------------------

    def _push(self, ev: Tuple) -> None:
        self.flight.ring.append(ev)
        if len(self.events) < self.max_events:
            self.events.append(ev)
        else:
            self.dropped += 1

    # -- hooks (called by Cluster) -----------------------------------------

    def on_episode_begin(self, cluster) -> None:
        """Reset to this episode's stream and capture engine metadata —
        one fleet walk per serve() call, never per round."""
        self.episodes += 1
        self.events.clear()
        self.flight.clear()
        self.dropped = 0
        self._counter_next = float("-inf")
        self._rate = WindowedRate(self.window_s)
        self.engines = {}
        self.roles = {}
        for role in sorted(cluster.pools):
            for e in cluster.pools[role]:
                self.engines[e.engine_id] = describe_engine(e)
                self.roles[e.engine_id] = role
        self._push(("episode", 0.0, self.episodes))

    def on_arrival(self, req, t: float) -> None:
        self._push(("arrival", t, req.rid))

    def on_admit(self, req, eng, t: float) -> None:
        self._push(("admit", t, req.rid, eng.engine_id))

    def on_prefill(self, req, eng, t0: float, t1: float) -> None:
        self._push(("prefill", t0, t1, req.rid, eng.engine_id))

    def on_insert(self, req, eng, src, t: float, nbytes: int) -> None:
        self._push(("insert", t, req.rid, eng.engine_id,
                    src.engine_id if src is not None else -1, nbytes))

    def on_decode_step(self, eng, t0: float, t1: float, batch: int) -> None:
        self._push(("decode", t0, t1, eng.engine_id, batch))

    def on_complete(self, req, t: float) -> None:
        self._push(("complete", t, req.rid))
        self._rate.add(t)
        # SLO-breach flight dump: only requests that *declare* targets are
        # judged (sla_met walks the token times — enabled path only)
        if (req.ftl_target_s is not None or req.ttl_target_s is not None) \
                and not req.sla_met:
            self.flight.dump("slo_breach", t, f"rid={req.rid}")

    def on_requeue(self, req, t: float) -> None:
        self._push(("requeue", t, req.rid))

    def on_engine_failure(self, eng, t: float) -> None:
        self._push(("engine_failure", t, eng.engine_id))
        self.flight.dump("engine_failure", t,
                         f"engine_id={eng.engine_id}")

    def on_migrate(self, eng, dst_role: str, t: float) -> None:
        self._push(("migrate", t, eng.engine_id, dst_role))
        self.roles[eng.engine_id] = dst_role

    def on_rebalance(self, t: float, signal) -> None:
        self._push(("rebalance", t, signal))

    def on_round(self, cluster) -> None:
        """Counter sampling (queue depth, occupied engines, completion
        rate, per-pool occupancy), rate-limited on the virtual clock so a
        round storm costs one fleet walk per ``counter_every_s``."""
        now = cluster.now
        if now < self._counter_next:
            return
        self._counter_next = now + self.counter_every_s
        occ = []
        for role in sorted(cluster.pools):
            used = 0
            cap = 0
            for e in cluster.pools[role]:
                if e.healthy:
                    used += e.active
                    cap += e.slots
            occ.append((role, used / cap if cap else 0.0))
        self._push(("counter", now, len(cluster.queue),
                    len(cluster._occupied), self._rate.rate(), tuple(occ)))

    # -- digests -----------------------------------------------------------

    def span_digest(self, *, content: bool = True) -> str:
        """sha256 over the event stream. ``content=True`` covers every
        field of every event — byte-identity between same-backend runs.
        ``content=False`` keeps lifecycle kinds only and drops timestamps
        (floats) and modeled byte counts, so runs whose clocks differ but
        whose event *order* matches (e.g. uniform hardware speed scaling)
        digest identically. Cross-backend comparisons go through
        ``lifecycle`` per request instead: event interleaving across
        requests follows each backend's virtual clock."""
        return _digest(self.events, content=content)

    def lifecycle(self, rid: int) -> List[Tuple]:
        """Every lifecycle event touching ``rid``, in stream order."""
        out = []
        for ev in self.events:
            if ev[0] in ("arrival", "admit", "complete", "requeue") \
                    and ev[2] == rid:
                out.append(ev)
            elif ev[0] == "prefill" and ev[3] == rid:
                out.append(ev)
            elif ev[0] == "insert" and ev[2] == rid:
                out.append(ev)
        return out


def _structural(ev: Tuple) -> Optional[Tuple]:
    kind = ev[0]
    if kind not in LIFECYCLE_KINDS:
        return None
    fields = ev[1:]
    drop = _STRUCT_DROP_TAIL.get(kind, 0)
    if drop:
        fields = fields[:-drop]
    return (kind,) + tuple(x for x in fields if not isinstance(x, float))


def _digest(events, *, content: bool = True) -> str:
    h = hashlib.sha256()
    for ev in events:
        row = ev if content else _structural(ev)
        if row is None:
            continue
        h.update(repr(row).encode())
        h.update(b"\n")
    return h.hexdigest()
