"""Wall-clock pacing and stamps: the load as users send it, the tokens as
they see them.

The port's ``Cluster`` keeps a virtual clock that advances only by the
engines' step times; the KV handoff, the loop's own host work and idle
gaps cost nothing on it. So the benchmark keeps its own clock:

- ``PacedWorkload`` is the ``Workload`` the cluster polls. It releases a
  request once its due time has passed on the wall clock (an open loop's
  schedule, or the completion of a closed-loop client's request), stamps
  ``arrival_t`` with the cluster's clock at release, so the cluster's queue
  logic stays consistent, and sleeps until the next due time when the
  cluster is idle.
- ``WallRecorder`` is the cluster's recorder. It stamps
  ``time.perf_counter()`` at each first token (``on_prefill``), each
  decode token (``on_decode_step``, over the engine's slots) and each
  completion, counts the handoff's bytes, keeps each step's measured time
  and size,
  and closes the run at the first round after the stop time by raising
  ``WindowClosed`` out of ``Cluster.serve``.

Every latency counts from the request's due time.
"""
from __future__ import annotations

import heapq
import time
from typing import Any, Callable, Dict, List, Optional


LOGIT_STEPS = ("prefill_full", "prefill_chunked", "prefill_chunked_paged",
               "decode_step", "decode_step_paged")


def capture(module, box: Dict[str, Any]) -> Callable[[], None]:
    """Wrap the model's step functions (``LOGIT_STEPS`` of ``module``,
    each returning the step's logits first) so that each call leaves its
    rows' largest logit, a device vector, in ``box["max"]``: the logit of
    the token the engine's greedy sampling then takes, as the timed path
    computed it. One reduction kernel a step; the logits themselves and
    the step's result are untouched. Returns the function that undoes
    it."""
    saved = {}
    for name in LOGIT_STEPS:
        fn = getattr(module, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def wrapped(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            box["max"] = out[0].amax(dim=-1)
            return out
        setattr(module, name, wrapped)

    def undo():
        for name, fn in saved.items():
            setattr(module, name, fn)
    return undo


class WindowClosed(Exception):
    """Raised from the recorder's ``on_round`` once the run's stop time has
    passed; ``Cluster.serve`` lets it through."""


class Stamps:
    """One request's wall-clock record (seconds of ``perf_counter``)."""

    __slots__ = ("rid", "isl", "osl", "due", "prefill_start", "first",
                 "tokens", "done", "req")

    def __init__(self, rid: int, isl: int, osl: int, due: float, req):
        self.rid, self.isl, self.osl, self.due = rid, isl, osl, due
        self.prefill_start = self.first = self.done = None
        self.tokens: List[float] = []       # decode tokens (not the first)
        self.req = req

    def token_times(self) -> List[float]:
        """Every output token's stamp, the first token's included."""
        if self.first is None:
            return []
        return [self.first] + self.tokens


class PacedWorkload:
    """The ``Workload`` protocol against the wall clock.

    ``make_request(item, arrival_t)`` builds the program's request;
    ``now()`` reads the cluster's virtual clock (stamped as ``arrival_t``).
    Nothing is released at or after ``stop_at``."""

    def __init__(self, traffic, *, t0: float, stop_at: float,
                 make_request: Callable, cluster_now: Callable[[], float],
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep,
                 prebuilt: int = 0):
        self.traffic = traffic
        self.t0 = t0
        self.stop_at = stop_at
        self.make_request = make_request
        self.cluster_now = cluster_now
        self.clock = clock
        self.sleep = sleep
        self.stamps: Dict[int, Stamps] = {}
        self._items = {j: traffic.item(j) for j in range(prebuilt)}
        self._next = 0                  # next request index
        # closed loop: a heap of (due, client) for clients waiting to send
        self._ready: List = []
        self._client_of: Dict[int, int] = {}
        if traffic.closed:
            self._ready = [(t0, c) for c in range(traffic.clients)]
            heapq.heapify(self._ready)

    def _item(self, j: int):
        it = self._items.pop(j, None)
        return it if it is not None else self.traffic.item(j)

    def _next_due(self) -> Optional[float]:
        if self.traffic.closed:
            return self._ready[0][0] if self._ready else None
        return self.t0 + self.traffic.due(self._next)

    def _release(self, due: float, client: Optional[int]):
        j = self._next
        self._next += 1
        it = self._item(j)
        req = self.make_request(j, it.prompt, it.osl, self.cluster_now())
        self.stamps[j] = Stamps(j, len(it.prompt), it.osl, due, req)
        if client is not None:
            self._client_of[j] = client
        return req

    def poll(self, now: float) -> List[Any]:
        t = self.clock()
        out = []
        while True:
            due = self._next_due()
            if due is None or due > t or due >= self.stop_at:
                return out
            client = heapq.heappop(self._ready)[1] if self.traffic.closed \
                else None
            out.append(self._release(due, client))

    def next_arrival(self) -> Optional[float]:
        """Called by an idle cluster: sleep until the next due time and
        return the cluster's clock (so it polls at once), or None once
        nothing is due before the stop time."""
        due = self._next_due()
        if due is None or due >= self.stop_at:
            return None
        wait = due - self.clock()
        if wait > 0:
            self.sleep(wait)
        return self.cluster_now()

    def on_complete(self, req, now: float) -> None:
        client = self._client_of.pop(req.rid, None)
        if client is not None:
            heapq.heappush(self._ready, (self.clock(), client))

    def exhausted(self) -> bool:
        return False

    @property
    def released(self) -> int:
        return self._next


class WallRecorder:
    """The cluster's recorder: wall stamps at the layer boundaries.

    ``prefills``: (wall end, step seconds, prompt tokens, engine id);
    ``decodes``: (wall end, step seconds, active slots, attended positions
    of the active slots, slots). Step seconds are the engine's own measured
    step time (host clock ending in a device synchronise), which the hook
    receives as ``t1 - t0``. ``on_round`` calls ``tick(now)``, which may
    raise ``WindowClosed``."""

    enabled = True

    def __init__(self, stamps: Dict[int, Stamps], tick: Callable[[float], None],
                 clock: Callable[[], float] = time.perf_counter):
        self.stamps = stamps
        self.tick = tick
        self.clock = clock
        self.prefills: List = []
        self.decodes: List = []
        self.handoff_bytes = 0
        self.requeued = 0
        self.failures = 0
        # the program's logit at each served token (``capture``): rid ->
        # [(a device vector of per-row maxima, row)], in token order
        self.box: Optional[Dict[str, Any]] = None
        self.served_logit: Dict[int, List] = {}

    def on_episode_begin(self, cluster) -> None:
        pass

    def on_arrival(self, req, t: float) -> None:
        pass

    def on_admit(self, req, eng, t: float) -> None:
        pass

    def on_prefill(self, req, eng, t0: float, t1: float) -> None:
        now = self.clock()
        s = self.stamps[req.rid]
        s.first = now
        s.prefill_start = now - (t1 - t0)
        self.prefills.append((now, t1 - t0, s.isl, eng.engine_id))
        if self.box is not None:
            self.served_logit[req.rid] = [(self.box.pop("max"), 0)]

    def on_insert(self, req, eng, src, t: float, nbytes: int) -> None:
        self.handoff_bytes += nbytes

    def on_decode_step(self, eng, t0: float, t1: float, batch: int) -> None:
        now = self.clock()
        ctx = 0
        stamps = self.stamps
        mx = self.box.pop("max") if self.box is not None else None
        for slot, r in eng.slot_req.items():
            stamps[r.rid].tokens.append(now)
            # positions the step attended: the prompt, the tokens so far
            # and the one it wrote
            ctx += r.isl + len(r.output)
            if mx is not None:
                self.served_logit[r.rid].append((mx, slot))
        self.decodes.append((now, t1 - t0, batch, ctx, eng.slots))

    def on_complete(self, req, t: float) -> None:
        self.stamps[req.rid].done = self.clock()

    def on_requeue(self, req, t: float) -> None:
        self.requeued += 1

    def on_engine_failure(self, eng, t: float) -> None:
        self.failures += 1

    def on_migrate(self, eng, dst_role: str, t: float) -> None:
        pass

    def on_rebalance(self, t: float, signal) -> None:
        pass

    def on_round(self, cluster) -> None:
        self.tick(self.clock())
