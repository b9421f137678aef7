"""JSONL trace replay (and recording) — production-trace workloads.

The port's copy of ``repro.workloads.trace``, unchanged but for its
imports of the port's own modules.

Record format, one JSON object per line (à la the sglang /
production-stack benchmark traces):

    {"arrival_t": 0.12, "isl": 512, "osl": 64}
    {"arrival_t": 0.30, "isl": 48, "osl": 8, "priority": 5,
     "ftl_target_s": 0.5, "session_id": 3, "prompt": [17, 4, ...]}

``arrival_t`` (alias ``ts``) is seconds from trace start; ``prompt`` is
optional — absent prompts are synthesized deterministically from the seed
(token *content* rarely survives into traces; shape and timing do).
``record_trace`` writes served requests back out in the same format, so a
live run can be re-served as a replay.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Union

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.workloads.base import StaticWorkload

Record = Dict[str, object]


def _load_records(source: Union[str, os.PathLike, Iterable[Record]]
                  ) -> List[Record]:
    if isinstance(source, (str, os.PathLike)):
        with open(source) as f:
            return [json.loads(line) for line in f if line.strip()]
    return [dict(r) for r in source]


class TraceReplay(StaticWorkload):
    """Replay a JSONL trace (path or iterable of records) as a workload.

    Open-loop by construction: the trace's timestamps are honored as-is
    (scaled by ``time_scale``; < 1 compresses, > 1 stretches), which is
    exactly what makes a replay comparable across policy stacks.
    """

    def __init__(self, source: Union[str, os.PathLike, Iterable[Record]],
                 *, vocab: int, seed: int = 0, time_scale: float = 1.0,
                 start_rid: int = 0):
        assert vocab > 0 and time_scale > 0
        rng = np.random.default_rng(seed)
        requests: List[Request] = []
        for i, rec in enumerate(_load_records(source)):
            t = float(rec.get("arrival_t", rec.get("ts", 0.0))) * time_scale
            if "prompt" in rec:
                prompt = np.asarray(rec["prompt"], dtype=np.int32) % vocab
            else:
                prompt = rng.integers(0, vocab, size=int(rec["isl"])
                                      ).astype(np.int32)
            requests.append(Request(
                rid=start_rid + i, prompt=prompt, osl=int(rec["osl"]),
                arrival_t=t,
                priority=int(rec.get("priority", 0)),
                ftl_target_s=rec.get("ftl_target_s"),
                ttl_target_s=rec.get("ttl_target_s"),
                session_id=rec.get("session_id"),
                turn=int(rec.get("turn", 0))))
        super().__init__(requests)


def record_trace(requests: Iterable[Request],
                 path: Union[str, os.PathLike, None] = None, *,
                 with_prompts: bool = False) -> List[Record]:
    """Serialize served (or generated) requests as trace records; writes
    JSONL to ``path`` when given. Round-trips through ``TraceReplay``."""
    records: List[Record] = []
    for r in sorted(requests, key=lambda r: (r.arrival_t, r.rid)):
        rec: Record = {"arrival_t": r.arrival_t, "isl": r.isl, "osl": r.osl}
        if r.priority:
            rec["priority"] = r.priority
        if r.ftl_target_s is not None:
            rec["ftl_target_s"] = r.ftl_target_s
        if r.ttl_target_s is not None:
            rec["ttl_target_s"] = r.ttl_target_s
        if r.session_id is not None:
            rec["session_id"] = r.session_id
            rec["turn"] = r.turn
        if with_prompts:
            rec["prompt"] = [int(t) for t in r.prompt]
        records.append(rec)
    if path is not None:
        with open(path, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return records
