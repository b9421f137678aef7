"""Closed-loop multi-turn sessions: the port's copy of
``repro.workloads.sessions``.

A session is a conversation: turn N+1's prompt is the *entire prior
context* (system prefix + every earlier prompt and model reply) plus a
fresh user delta, and it arrives only ``think_time`` seconds after turn N
completes. That closed loop is what couples the workload to the serving
system ("Not All Prefills Are Equal", "Efficient Multi-round LLM Inference
over Disaggregated Serving"): later turns re-prefill mostly tokens whose
KV already exists somewhere, so prefix-affinity scheduling and KV-locality
routing — not just pool sizing — decide the achievable FTL.

Sessions within a *family* share a system prefix (the shared-prompt
deployment pattern), giving ``PrefixAffinityScheduler`` cross-session
locality on top of the cross-turn reuse.

Determinism: every session draws its deltas/think-times from its own
``default_rng(seed + sid)`` stream in turn order, so prompt content is a
function of (seed, model outputs) alone — independent of how the serving
side interleaves completions across sessions.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.workloads.arrivals import ArrivalProcess, Burst
from repro_torch.workloads.base import SLATier, WorkloadSummary

Span = Union[int, Tuple[int, int]]          # fixed, or inclusive range
TimeSpan = Union[float, Tuple[float, float]]


def _draw(rng, span: Span) -> int:
    if isinstance(span, tuple):
        lo, hi = span
        return int(rng.integers(lo, hi + 1))
    return int(span)


def _draw_time(rng, span: TimeSpan) -> float:
    if isinstance(span, tuple):
        lo, hi = span
        return float(rng.uniform(lo, hi))
    return float(span)


class _Session:
    def __init__(self, sid: int, rng: np.random.Generator,
                 context: np.ndarray, turns: int):
        self.sid = sid
        self.rng = rng
        self.context = context          # prefix + all prior prompts/replies
        self.turns_left = turns
        self.turn = 0


class SessionWorkload:
    """Multi-turn conversations with think time (closed loop)."""

    def __init__(self, *, vocab: int, seed: int = 0, sessions: int = 4,
                 arrivals: Optional[ArrivalProcess] = None,
                 turns: Span = 3, families: int = 1,
                 system_prefix_len: int = 32, user_isl: Span = 16,
                 osl: Span = 8, think_time: TimeSpan = 0.0,
                 tier: Optional[SLATier] = None, start_rid: int = 0):
        assert vocab > 0 and sessions > 0 and families > 0
        self.vocab = vocab
        self.n_sessions = sessions
        self.families = families
        self.system_prefix_len = system_prefix_len
        self.user_isl = user_isl
        self.osl_span = osl
        self.turns_span = turns
        self.think_time = think_time
        self.tier = tier
        self._ids = itertools.count(start_rid)
        self._seq = itertools.count()       # heap tiebreak

        root = np.random.default_rng(seed)
        prefixes = [root.integers(0, vocab, size=system_prefix_len
                                  ).astype(np.int32)
                    for _ in range(families)]
        starts = self._session_starts(arrivals, root)
        # (time, seq, request) events not yet emitted; later turns are
        # pushed by on_complete
        self._pending: List[Tuple[float, int, Request]] = []
        self._owner: Dict[int, _Session] = {}       # rid -> session
        self._active = 0                            # sessions not finished
        for sid, t0 in enumerate(starts):
            s = _Session(sid, np.random.default_rng(seed + 1 + sid),
                         prefixes[sid % families].copy(),
                         _draw(root, turns))
            self._active += 1
            self._schedule_turn(s, t0)

    def _session_starts(self, arrivals: Optional[ArrivalProcess], rng
                        ) -> List[float]:
        proc = arrivals or Burst(self.n_sessions, at=0.0)
        out, t = [], 0.0
        for _ in range(self.n_sessions):
            nxt = proc.next_after(rng, t)
            if nxt is None:
                break
            out.append(nxt)
            t = nxt
        return out

    def _schedule_turn(self, s: _Session, at: float) -> None:
        delta = s.rng.integers(0, self.vocab,
                               size=_draw(s.rng, self.user_isl)
                               ).astype(np.int32)
        prompt = np.concatenate([s.context, delta])
        req = Request(rid=next(self._ids), prompt=prompt,
                      osl=_draw(s.rng, self.osl_span), arrival_t=at,
                      session_id=s.sid, turn=s.turn)
        if self.tier is not None:
            self.tier.apply(req)
        s.turn += 1
        s.turns_left -= 1
        self._owner[req.rid] = s
        heapq.heappush(self._pending, (at, next(self._seq), req))

    # -- Workload protocol -------------------------------------------------

    def poll(self, now: float) -> List[Request]:
        out: List[Request] = []
        while self._pending and self._pending[0][0] <= now:
            out.append(heapq.heappop(self._pending)[2])
        return out

    def next_arrival(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    def on_complete(self, req: Request, now: float) -> None:
        s = self._owner.pop(req.rid, None)
        if s is None:
            return
        # the conversation so far = this turn's prompt + the model's reply
        reply = np.asarray(req.output, dtype=np.int32) % self.vocab
        s.context = np.concatenate([req.prompt, reply])
        if s.turns_left > 0:
            self._schedule_turn(s, now + _draw_time(s.rng, self.think_time))
        else:
            self._active -= 1

    def exhausted(self) -> bool:
        return self._active == 0 and not self._pending

    def expected_requests(self) -> float:
        n = (sum(self.turns_span) / 2 if isinstance(self.turns_span, tuple)
             else float(self.turns_span))
        return self.n_sessions * max(n, 1.0)

    def max_context(self) -> int:
        """Largest isl+osl the final turn can reach (capacity hint)."""
        hi = (lambda s: s[1] if isinstance(s, tuple) else s)
        n = int(hi(self.turns_span))
        u, o = int(hi(self.user_isl)), int(hi(self.osl_span))
        return self.system_prefix_len + n * (u + o)

    def summary(self) -> WorkloadSummary:
        """Expected marginals over a session's turns. Turn k's prompt is
        ``P + k*u + (k-1)*o`` tokens of which all but the fresh ``u`` user
        tokens already sat in some prefix cache (prior context; the family
        prefix for turn 1)."""
        P = float(self.system_prefix_len)
        u = (sum(self.user_isl) / 2 if isinstance(self.user_isl, tuple)
             else float(self.user_isl))
        o = (sum(self.osl_span) / 2 if isinstance(self.osl_span, tuple)
             else float(self.osl_span))
        n = (sum(self.turns_span) / 2 if isinstance(self.turns_span, tuple)
             else float(self.turns_span))
        n = max(n, 1.0)
        lens = [P + k * u + (k - 1) * o for k in range(1, int(round(n)) + 1)]
        shared = [L - u for L in lens]
        return WorkloadSummary(
            isl=float(np.mean(lens)), osl=o, rate=0.0,
            reuse_fraction=float(sum(shared) / max(sum(lens), 1.0)))
