"""Trace consumers: Chrome/Perfetto export and schema validation.

The port's copy of ``repro.serving.obs``, unchanged but for the flight
dump's file writer, which nothing of the port called (the dumps stay in
``TraceRecorder.dumps`` and in the sanitizer's message).

``serving.tracing.TraceRecorder`` captures the event stream; this module
renders it. ``perfetto_trace`` builds a Chrome trace-event JSON object
(loadable in chrome://tracing and ui.perfetto.dev):

  - one *process* per pool role and one *thread* (track) per engine,
    labeled from ``describe_engine`` metadata (backend, hardware class);
  - ``X`` complete slices for every prefill tick and decode step on the
    engine that ran them;
  - ``b``/``e`` async slices per request (cat ``request``, id = rid) for
    the lifecycle phases ``queue -> prefill -> transfer -> decode``,
    derived by ``request_phases`` — the phases tile ``[arrival_t,
    done_t]`` exactly, so their durations sum to end-to-end latency;
  - ``C`` counter tracks (queue depth, occupied engines, windowed
    completion rate, per-pool occupancy) from the recorder's rate-limited
    samples;
  - ``i`` instant events for engine failures and migrations.

``validate_trace`` is the schema gate used by tests and ``scripts/ci.sh``:
it checks phase types, timestamps, slice durations, async begin/end
balance, and counter payloads, and returns per-phase-type counts.

All timestamps are virtual-time microseconds; serialization is
``sort_keys=True`` throughout (this module sits behind the determinism
lint's serialized-paths rule — byte-stable across reruns).
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["request_phases", "perfetto_trace", "validate_trace",
           "export_perfetto"]

PHASES = ("queue", "prefill", "transfer", "decode")
_PH_TYPES = ("M", "X", "b", "e", "C", "i")


def _us(t: float) -> float:
    """Virtual seconds -> trace microseconds (rounded to picoseconds so
    serialized floats stay short and stable)."""
    return round(t * 1e6, 6)


def request_phases(recorder) -> Dict[int, List[Tuple[str, float, float]]]:
    """rid -> ordered ``(phase, t0, t1)`` intervals derived from the event
    stream. Intervals are contiguous and tile ``[arrival_t, done_t]``:
    a requeue closes the open phase and reopens ``queue`` at the same
    instant, so the sum of durations is always the end-to-end latency."""
    out: Dict[int, List[Tuple[str, float, float]]] = {}
    open_: Dict[int, Tuple[str, float]] = {}        # rid -> (phase, t0)

    def close(rid: int, t: float) -> None:
        cur = open_.pop(rid, None)
        if cur is not None:
            out.setdefault(rid, []).append((cur[0], cur[1], t))

    for ev in recorder.events:
        kind = ev[0]
        if kind == "arrival":
            _, t, rid = ev
            open_[rid] = ("queue", t)
            out.setdefault(rid, [])
        elif kind == "admit":
            _, t, rid, _eid = ev
            close(rid, t)
            open_[rid] = ("prefill", t)
        elif kind == "prefill":
            _, _t0, t1, rid, _eid = ev
            close(rid, t1)
            open_[rid] = ("transfer", t1)
        elif kind == "insert":
            _, t, rid = ev[0:3]
            close(rid, t)
            open_[rid] = ("decode", t)
        elif kind == "complete":
            _, t, rid = ev
            close(rid, t)
        elif kind == "requeue":
            _, t, rid = ev
            close(rid, t)
            open_[rid] = ("queue", t)
    # still-open phases (episode cut short) close at their own start so
    # durations remain well-defined
    for rid in sorted(open_):
        phase, t0 = open_[rid]
        out.setdefault(rid, []).append((phase, t0, t0))
    return out


def perfetto_trace(recorder, *, metrics: Optional[Dict[str, float]] = None
                   ) -> Dict[str, Any]:
    """Render the recorder's event stream as a Chrome trace-event JSON
    object. ``metrics`` (e.g. the serve() return) rides along under
    ``otherData`` with non-finite values dropped."""
    events: List[Dict[str, Any]] = []
    roles = recorder.roles                  # engine_id -> role
    role_pids: Dict[str, int] = {}
    for eid in sorted(roles):
        role_pids.setdefault(roles[eid], 0)
    for i, role in enumerate(sorted(role_pids)):
        role_pids[role] = i + 1

    events.append({"ph": "M", "pid": 0, "name": "process_name",
                   "args": {"name": "requests"}})
    for role in sorted(role_pids):
        events.append({"ph": "M", "pid": role_pids[role],
                       "name": "process_name",
                       "args": {"name": f"{role} pool"}})
    for eid in sorted(recorder.engines):
        meta = recorder.engines[eid]
        events.append({
            "ph": "M", "pid": role_pids.get(roles.get(eid, ""), 0),
            "tid": eid, "name": "thread_name",
            "args": {"name": f"engine {eid} "
                             f"({meta.get('hardware', 'uniform')}, "
                             f"{meta.get('backend', '?')})"}})

    def track(eid: int) -> Tuple[int, int]:
        return role_pids.get(roles.get(eid, ""), 0), eid

    for ev in recorder.events:
        kind = ev[0]
        if kind == "prefill":
            _, t0, t1, rid, eid = ev
            pid, tid = track(eid)
            events.append({"ph": "X", "pid": pid, "tid": tid,
                           "ts": _us(t0), "dur": _us(t1 - t0),
                           "cat": "engine", "name": f"prefill r{rid}"})
        elif kind == "decode":
            _, t0, t1, eid, batch = ev
            pid, tid = track(eid)
            events.append({"ph": "X", "pid": pid, "tid": tid,
                           "ts": _us(t0), "dur": _us(t1 - t0),
                           "cat": "engine", "name": f"decode x{batch}"})
        elif kind == "engine_failure":
            _, t, eid = ev
            pid, tid = track(eid)
            events.append({"ph": "i", "pid": pid, "tid": tid,
                           "ts": _us(t), "s": "t", "cat": "fleet",
                           "name": "engine_failure"})
        elif kind == "migrate":
            _, t, eid, dst_role = ev
            pid, tid = track(eid)
            events.append({"ph": "i", "pid": pid, "tid": tid,
                           "ts": _us(t), "s": "t", "cat": "fleet",
                           "name": f"migrate->{dst_role}"})
        elif kind == "counter":
            _, t, qlen, occupied, rps, occ = ev
            ts = _us(t)
            events.append({"ph": "C", "pid": 0, "ts": ts,
                           "name": "queue_len", "args": {"value": qlen}})
            events.append({"ph": "C", "pid": 0, "ts": ts,
                           "name": "occupied_engines",
                           "args": {"value": occupied}})
            events.append({"ph": "C", "pid": 0, "ts": ts,
                           "name": "window_rps",
                           "args": {"value": round(rps, 6)}})
            events.append({"ph": "C", "pid": 0, "ts": ts,
                           "name": "occupancy",
                           "args": {role: round(frac, 6)
                                    for role, frac in occ}})

    phases = request_phases(recorder)
    for rid in sorted(phases):
        for phase, t0, t1 in phases[rid]:
            base = {"pid": 0, "tid": 0, "cat": "request", "id": str(rid),
                    "name": phase}
            events.append({"ph": "b", "ts": _us(t0), **base})
            events.append({"ph": "e", "ts": _us(t1), **base})

    other: Dict[str, Any] = {"episodes": recorder.episodes,
                             "dropped_events": recorder.dropped}
    if metrics:
        other["metrics"] = {
            k: v for k, v in sorted(metrics.items())
            if isinstance(v, (int, float)) and math.isfinite(v)}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def validate_trace(trace: Dict[str, Any]) -> Dict[str, int]:
    """Schema gate: raise ``ValueError`` on any malformed event, return
    per-``ph`` counts on success. Checks the invariants the exporter
    promises — known phase types, non-negative timestamps and durations,
    balanced async begin/end per ``(cat, id, name)``, numeric counters."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a traceEvents list")
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    counts = {ph: 0 for ph in _PH_TYPES}
    counts["total"] = 0
    open_async: Dict[Tuple[str, str, str], int] = {}
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"event {i}: not a dict with 'ph'")
        ph = ev["ph"]
        if ph not in _PH_TYPES:
            raise ValueError(f"event {i}: unknown ph {ph!r}")
        counts[ph] += 1
        counts["total"] += 1
        if ph == "M":
            if ev.get("name") not in ("process_name", "thread_name") \
                    or not isinstance(ev.get("args", {}).get("name"), str):
                raise ValueError(f"event {i}: malformed metadata")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) \
                or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X slice with bad dur {dur!r}")
        elif ph in ("b", "e"):
            if "cat" not in ev or "id" not in ev:
                raise ValueError(f"event {i}: async event without cat/id")
            key = (ev["cat"], ev["id"], ev.get("name", ""))
            n = open_async.get(key, 0) + (1 if ph == "b" else -1)
            if n < 0:
                raise ValueError(f"event {i}: async end before begin "
                                 f"for {key}")
            open_async[key] = n
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) and math.isfinite(v)
                    for v in args.values()):
                raise ValueError(f"event {i}: counter needs numeric args")
        elif ph == "i":
            if ev.get("s") not in ("g", "p", "t"):
                raise ValueError(f"event {i}: instant needs scope s")
    unbalanced = {k: n for k, n in sorted(open_async.items()) if n}
    if unbalanced:
        raise ValueError(f"unbalanced async slices: {unbalanced}")
    return counts


def export_perfetto(recorder, path: str, *,
                    metrics: Optional[Dict[str, float]] = None
                    ) -> Dict[str, int]:
    """Validate + write the Perfetto JSON; returns the validation counts."""
    trace = perfetto_trace(recorder, metrics=metrics)
    counts = validate_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f, sort_keys=True)
    return counts
