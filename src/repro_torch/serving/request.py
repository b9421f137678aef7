"""Request lifecycle and SLA metrics for the executable serving runtime
(the port's copy of ``repro.serving.request``, without the deprecated
``TrafficGen`` shim)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # int32 [isl]
    osl: int                        # tokens to generate
    arrival_t: float = 0.0
    # scheduling class (consumed by SchedulerPolicy implementations)
    priority: int = 0               # larger = more urgent
    ftl_target_s: Optional[float] = None   # SLA: first-token latency target
    ttl_target_s: Optional[float] = None   # SLA: median inter-token target
    # conversation identity (set by closed-loop workloads)
    session_id: Optional[int] = None
    turn: int = 0                   # 0-based turn index within the session
    # lifecycle timestamps (engine clock, seconds)
    prefill_start_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    output: List[int] = dataclasses.field(default_factory=list)
    # runtime bookkeeping
    engine_id: Optional[int] = None
    slot: Optional[int] = None
    prefill_progress: int = 0       # chunked-prefill offset
    # latency-attribution stamps, maintained unconditionally by the event
    # loop (identical with tracing on or off): when the KV cache landed in
    # a decode slot, and how much of the decode span the request actually
    # spent inside decode steps (the rest is stall: slot contention,
    # straggler co-tenants, scheduler gaps)
    insert_t: Optional[float] = None
    decode_active_s: float = 0.0

    @property
    def isl(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def ftl(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    @property
    def ttls(self) -> List[float]:
        ts = [self.first_token_t] + self.token_times if self.first_token_t \
            else self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    @property
    def done(self) -> bool:
        return len(self.output) >= self.osl

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.prefill_start_t is None:
            return None
        return self.prefill_start_t - self.arrival_t

    @property
    def prefill_s(self) -> Optional[float]:
        """Admission -> first token (the prefill tick, plus any piggybacked
        decode rounds a chunked scheduler interleaved)."""
        if self.prefill_start_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.prefill_start_t

    @property
    def transfer_s(self) -> Optional[float]:
        """First token -> KV landed in a decode slot: the disaggregation
        hop plus placement wait (router deferrals, slot contention)."""
        if self.first_token_t is None or self.insert_t is None:
            return None
        return self.insert_t - self.first_token_t

    @property
    def decode_s(self) -> Optional[float]:
        if self.insert_t is None or self.done_t is None:
            return None
        return self.done_t - self.insert_t

    @property
    def decode_stall_s(self) -> Optional[float]:
        """Decode-span time *not* spent inside this request's decode steps
        (waiting on co-tenants, stragglers, or scheduler gaps)."""
        d = self.decode_s
        if d is None:
            return None
        return max(d - self.decode_active_s, 0.0)

    @property
    def e2e_s(self) -> Optional[float]:
        """End-to-end latency. For the final serving attempt the phases
        telescope exactly: queue_wait_s + prefill_s + transfer_s +
        decode_s == e2e_s (queue_wait absorbs any earlier requeued
        attempts, since ``reset_for_requeue`` clears the later stamps)."""
        if self.done_t is None:
            return None
        return self.done_t - self.arrival_t

    @property
    def sla_met(self) -> bool:
        """True when every *declared* target is met (no targets -> met)."""
        if self.ftl_target_s is not None:
            if self.ftl is None or self.ftl > self.ftl_target_s:
                return False
        if self.ttl_target_s is not None:
            ts = self.ttls
            if ts and float(np.median(ts)) > self.ttl_target_s:
                return False
        return True

    def reset_for_requeue(self) -> None:
        """Return the request to its pre-admission state so it can be
        re-queued after an engine failure / migration / straggler drain.
        Generation restarts from scratch (greedy decode is deterministic,
        so the replay produces identical tokens)."""
        self.slot = None
        self.engine_id = None
        self.prefill_start_t = None
        self.first_token_t = None
        self.prefill_progress = 0
        self.insert_t = None
        self.decode_active_s = 0.0
        self.output.clear()
        self.token_times.clear()


def percentile(xs: List[float], p: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs), p))


def sla_metrics(requests: List[Request]) -> Dict[str, float]:
    done = [r for r in requests if r.done_t is not None]
    ftls = [r.ftl for r in done if r.ftl is not None]
    ttls = [t for r in done for t in r.ttls]
    waits = [r.queue_wait_s for r in done if r.queue_wait_s is not None]
    prefills = [r.prefill_s for r in done if r.prefill_s is not None]
    xfers = [r.transfer_s for r in done if r.transfer_s is not None]
    stalls = [r.decode_stall_s for r in done
              if r.decode_stall_s is not None]
    total_tokens = sum(len(r.output) for r in done)
    # throughput spans first arrival -> last completion (arrivals need not
    # start at t=0: drained traffic phases, warm restarts, ...)
    t0 = min((r.arrival_t for r in done), default=0.0)
    t1 = max((r.done_t for r in done), default=0.0)
    span = max(t1 - t0, 1e-9)
    return {
        "completed": len(done),
        "p50_ftl_s": percentile(ftls, 50),
        "p99_ftl_s": percentile(ftls, 99),
        "p50_ttl_s": percentile(ttls, 50),
        "p99_ttl_s": percentile(ttls, 99),
        "queue_wait_s": float(np.mean(waits)) if waits else 0.0,
        # per-phase latency attribution (see Request.prefill_s and
        # friends): queue wait + prefill + transfer + decode telescope to
        # end-to-end latency for every completed request
        "p50_queue_wait_s": percentile(waits, 50),
        "p99_queue_wait_s": percentile(waits, 99),
        "p50_prefill_s": percentile(prefills, 50),
        "p99_prefill_s": percentile(prefills, 99),
        "p50_transfer_s": percentile(xfers, 50),
        "p99_transfer_s": percentile(xfers, 99),
        "p50_decode_stall_s": percentile(stalls, 50),
        "p99_decode_stall_s": percentile(stalls, 99),
        "sla_attainment": (sum(r.sla_met for r in done) / len(done)
                           if done else 0.0),
        "tokens_per_s": total_tokens / span,
        "tps_per_user": 1.0 / percentile(ttls, 50) if ttls else 0.0,
    }
