"""Virtual-time sanitizer: online invariant checking for the event loop.

The port's copy of ``repro.analysis.sanitizer``, unchanged (the same
``REPRO_SANITIZE`` gate). The static passes beside it are the runtime
checks' twins.

``ClusterSanitizer`` hooks into ``serving.cluster.Cluster`` (opt-in:
``Cluster(sanitize=True)`` or ``REPRO_SANITIZE=1``) and asserts, on every
transition the loop makes:

  - **virtual-time monotonicity** — the cluster clock never runs
    backwards within a serve episode;
  - **lifecycle order** — a request is prefilled only after arrival,
    inserted only after prefill, decoded only while inserted (no request
    decodes before its KV handoff), completed only once;
  - **one prefill per engine per round** — the scheduling loop hands each
    prefill-capable engine at most one admission per round;
  - **conservation** — at episode end every request the workload emitted
    is accounted exactly once: completed, still queued, awaiting
    placement, or in flight (admitted = completed + failed-requeued +
    in-flight, nothing lost or duplicated).

It also records a sha256 over each request's final token stream, turning
the ``benchmarks/sim_speed.py`` parity check into a reusable assertion:
run the same workload on two backends with sanitizers attached and call
``assert_stream_parity`` — identical schedules must produce identical
per-request streams.

A violation raises ``SanitizerError`` carrying the tail of the recorded
transition trace, so the failing schedule is inspectable — or, when the
cluster also carries a ``serving.tracing.TraceRecorder``, the recorder's
flight ring (full span context, dumped via ``self.flight``) replaces the
ad-hoc tail. The sanitizer is duck-typed against the cluster (no serving
import): it stays dependency-free and usable from any layer.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

_TRACE_LIMIT = 256

# lifecycle states
_ARRIVED, _PREFILLED, _INSERTED, _DONE = ("arrived", "prefilled",
                                          "inserted", "done")


class SanitizerError(AssertionError):
    """An event-loop invariant was violated (message carries the recent
    transition trace)."""


class ClusterSanitizer:
    """Online invariant monitor for one ``Cluster``. State resets at each
    serve episode; token-stream hashes persist for the *last completed*
    value per rid (cross-backend parity compares final episodes)."""

    def __init__(self, trace_limit: int = _TRACE_LIMIT):
        self.trace: Deque[Tuple] = deque(maxlen=trace_limit)
        self.events = 0
        self._hashes: Dict[int, str] = {}
        self._counts: Dict[int, int] = {}
        # optional serving.tracing.FlightRecorder: when a Cluster carries
        # both a sanitizer and a TraceRecorder it wires the recorder's
        # flight ring here, and _fail() dumps + reports span context
        # instead of the sanitizer's own transition tail
        self.flight = None
        self._reset_episode()

    def _reset_episode(self) -> None:
        self._now = 0.0
        self._state: Dict[int, str] = {}        # id(req) -> lifecycle
        self._engine_of: Dict[int, Any] = {}    # id(req) -> engine
        self._rid_of: Dict[int, int] = {}
        self._prefills_this_round: Dict[int, int] = {}  # id(engine) -> n
        self.admitted = 0
        self.completed = 0
        self.requeued = 0
        self.engine_failures = 0

    # -- failure plumbing ---------------------------------------------------

    def _fail(self, msg: str) -> None:
        if self.flight is not None:
            self.flight.dump("sanitizer_error", self._now, msg)
            tail = self.flight.format()
            raise SanitizerError(
                f"{msg}\nflight recorder (oldest first):\n{tail}")
        tail = "\n".join(f"  {t}" for t in list(self.trace)[-12:])
        raise SanitizerError(
            f"{msg}\nlast transitions (oldest first):\n{tail}")

    def _record(self, *event: Any) -> None:
        self.events += 1
        self.trace.append(event)

    def _check_clock(self, now: float, what: str) -> None:
        if now < self._now:
            self._fail(f"virtual time ran backwards at {what}: "
                       f"{now!r} < {self._now!r}")
        self._now = now

    def _rid(self, req: Any) -> int:
        return self._rid_of.get(id(req), getattr(req, "rid", -1))

    # -- hooks (called by Cluster) -----------------------------------------

    def on_episode_begin(self, cluster: Any) -> None:
        self._reset_episode()
        self._record("episode_begin",)

    def on_round(self, now: float) -> None:
        self._check_clock(now, "round start")
        self._prefills_this_round.clear()
        self._record("round", now)

    def on_arrival(self, req: Any, now: float) -> None:
        self._check_clock(now, "arrival")
        k = id(req)
        if self._state.get(k) is not None:
            self._fail(f"request rid={req.rid} emitted twice by the "
                       "workload (duplicate arrival)")
        self._state[k] = _ARRIVED
        self._rid_of[k] = req.rid
        self.admitted += 1
        self._record("arrival", req.rid, now)

    def on_prefill(self, req: Any, engine: Any, now: float) -> None:
        self._check_clock(now, "prefill")
        k = id(req)
        state = self._state.get(k)
        if state is None:
            self._fail(f"prefill of rid={getattr(req, 'rid', '?')} that "
                       "never arrived through the workload")
        if state in (_INSERTED, _DONE):
            self._fail(f"prefill of rid={self._rid(req)} while {state} "
                       "(double admission without requeue)")
        ek = id(engine)
        n = self._prefills_this_round.get(ek, 0) + 1
        self._prefills_this_round[ek] = n
        if n > 1:
            self._fail(f"engine {engine.engine_id} served {n} prefills "
                       "in one scheduling round (limit 1)")
        self._state[k] = _PREFILLED
        self._record("prefill", self._rid(req), engine.engine_id, now)

    def on_insert(self, req: Any, engine: Any, now: float) -> None:
        self._check_clock(now, "insert")
        k = id(req)
        state = self._state.get(k)
        if state != _PREFILLED:
            self._fail(f"insert of rid={self._rid(req)} in state "
                       f"{state!r} (expected 'prefilled')")
        self._state[k] = _INSERTED
        self._engine_of[k] = engine
        self._record("insert", self._rid(req), engine.engine_id, now)

    def on_token(self, req: Any, engine: Any, now: float) -> None:
        self._check_clock(now, "decode token")
        k = id(req)
        state = self._state.get(k)
        if state != _INSERTED:
            self._fail(f"rid={self._rid(req)} decoded a token in state "
                       f"{state!r} — decoded before insert")
        if self._engine_of.get(k) is not engine:
            self._fail(f"rid={self._rid(req)} decoded on engine "
                       f"{engine.engine_id} but was inserted on engine "
                       f"{getattr(self._engine_of.get(k), 'engine_id', '?')}")
        self._record("token", self._rid(req), engine.engine_id, now)

    def on_complete(self, req: Any, now: float) -> None:
        self._check_clock(now, "completion")
        k = id(req)
        if self._state.get(k) != _INSERTED:
            self._fail(f"rid={self._rid(req)} completed in state "
                       f"{self._state.get(k)!r}")
        self._state[k] = _DONE
        self._engine_of.pop(k, None)
        self.completed += 1
        self._hashes[self._rid(req)] = _stream_hash(req.output)
        self._counts[self._rid(req)] = len(req.output)
        self._record("complete", self._rid(req), now)

    def on_requeue(self, req: Any) -> None:
        k = id(req)
        if self._state.get(k) == _DONE:
            self._fail(f"rid={self._rid(req)} requeued after completion")
        if self._state.get(k) is not None:
            self._state[k] = _ARRIVED
        self._engine_of.pop(k, None)
        self.requeued += 1
        self._record("requeue", self._rid(req))

    def on_engine_failure(self, engine: Any) -> None:
        self.engine_failures += 1
        self._record("engine_failure", engine.engine_id)

    def on_episode_end(self, cluster: Any, served: List[Any]) -> None:
        """Conservation: every workload-emitted request is accounted in
        exactly one place — done, queued, awaiting placement, or resident
        in an engine slot."""
        queued = {id(r) for r in cluster.queue}
        pending = {id(r) for r, *_ in cluster.pending_insert}
        inflight = {id(r) for e in cluster.engines()
                    for r in e.slot_req.values()}
        done = {k for k, s in self._state.items() if s == _DONE}
        for req in served:
            k = id(req)
            where = [name for name, group in (
                ("done", done), ("queued", queued),
                ("pending-insert", pending), ("in-flight", inflight))
                if k in group]
            if len(where) != 1:
                self._fail(
                    f"conservation violated for rid={self._rid(req)}: "
                    f"found in {where or ['nowhere']} "
                    f"(admitted={self.admitted} completed={self.completed} "
                    f"requeued={self.requeued})")
        self._record("episode_end", len(served), self.completed)

    # -- policy-purity guard ------------------------------------------------
    # runtime twin of analysis/contracts.py's contract-mutation rule: the
    # static pass catches direct mutations in hook bodies; this catches
    # mutation laundered through calls the AST can't resolve.

    def state_digest(self, cluster: Any) -> Tuple:
        """Cheap fingerprint of cluster-visible state — O(engines), no
        per-slot detail, so the sim_speed floor survives with the
        sanitizer on. Memo caches and prefix caches are deliberately
        excluded: policies may warm those."""
        pools = tuple(
            (role, tuple((id(e), bool(e.healthy), len(e.slot_req))
                         for e in cluster.pools[role]))
            for role in sorted(cluster.pools))
        return (cluster.now, len(cluster.queue),
                len(cluster.pending_insert), pools)

    def check_hook_purity(self, cluster: Any, hook: str,
                          before: Tuple) -> None:
        """Called by the event loop right after a pure hook returns: the
        digest must not have moved while the policy was deciding."""
        after = self.state_digest(cluster)
        if after != before:
            self._fail(
                f"policy hook {hook} mutated cluster-visible state "
                f"(pure hooks observe and return decisions; use "
                f"cluster.migrate/requeue_inflight/retire from "
                f"RateMatcher hooks instead):\n"
                f"  before: {before}\n  after:  {after}")

    # -- parity surface -----------------------------------------------------

    def token_hashes(self) -> Dict[int, str]:
        """rid -> sha256 of the completed token stream (final value per
        rid across episodes)."""
        return dict(self._hashes)

    def token_counts(self) -> Dict[int, int]:
        """rid -> completed stream length — the cross-backend parity
        surface (real and sim engines agree on *schedules*, not on the
        synthetic token ids the sim backend emits)."""
        return dict(self._counts)


def _stream_hash(tokens: List[int]) -> str:
    h = hashlib.sha256()
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


def assert_stream_parity(a: ClusterSanitizer, b: ClusterSanitizer,
                         label_a: str = "a", label_b: str = "b", *,
                         content: bool = True) -> None:
    """Identical schedules must produce identical per-request token
    streams: compare the two sanitizers' tables, naming the first
    diverging rid. ``content=True`` compares sha256 over token ids
    (same-backend replay determinism); ``content=False`` compares stream
    lengths only — the cross-backend check, since the sim backend's
    synthetic token ids never match the real model's."""
    ha, hb = (a.token_hashes(), b.token_hashes()) if content \
        else (a.token_counts(), b.token_counts())
    if set(ha) != set(hb):
        raise SanitizerError(
            f"request sets differ: only-{label_a}={sorted(set(ha) - set(hb))} "
            f"only-{label_b}={sorted(set(hb) - set(ha))}")
    what = "token stream" if content else "token count"
    for rid in sorted(ha):
        if ha[rid] != hb[rid]:
            raise SanitizerError(
                f"{what} of rid={rid} diverged between "
                f"{label_a} ({str(ha[rid])[:12]}) and {label_b} "
                f"({str(hb[rid])[:12]})")


def sanitize_enabled_by_env() -> bool:
    """Shared env-var gate: ``REPRO_SANITIZE`` set to anything but
    ''/'0'/'false' enables the sanitizer on every new ``Cluster``."""
    import os
    return os.environ.get("REPRO_SANITIZE", "").lower() \
        not in ("", "0", "false")
