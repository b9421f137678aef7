"""Simulator-in-the-loop sweep cells: a bounded ``Cluster.serve`` episode
per design point, on the analytic-time ``SimEngine`` backend.

This closes the ROADMAP gap between the two evaluators: the analytic side
reduces a cell to rate-matched roofline frontiers, while this module runs
the *executable* event loop — admission, KV handoff, IFB slot reuse,
prefix caching — on the same (model, chips, ISL, OSL, reuse) coordinate
and records ``sla_metrics`` columns next to the analytic
``tput_per_chip``. On ``SimEngine`` the episode costs milliseconds, so it
rides inside every sweep cell behind the same content-addressed
``SweepStore`` (resumable, cache-hit on rerun); against the real backend
the same episode would take seconds to minutes per cell.

Everything is deterministic — seeded workload, roofline clocks, counting-
rng tokens — so shards are byte-stable across reruns and platforms, same
as the analytic records.

The port's copy of ``repro.sweeps.simulate``. It runs the episode on the
port's ``SimEngine``, ``Cluster``, policies, ``Request`` and
``StaticWorkload`` (copies of the reference's, number for number), and
resolves an architecture id through the port's registry.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.hardware import get_chip
from repro_torch.core.paper_models import get_perf_model
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.policies import ChunkedPiggybackScheduler, KVLocalityRouter
from repro_torch.serving.request import Request
from repro_torch.serving.simengine import SimEngine
from repro_torch.sweeps.spec import SweepCell
from repro_torch.workloads import StaticWorkload

# fixed tiny-fleet shape: 1 prefill + 2 decode engines (disagg) or 2 mixed
# engines (coloc). The sim measures *schedule-level* behavior per chip at
# one deployment scale; the analytic side owns the full chips axis.
SIM_SLOTS = 8


def _chunk_for(isl: int) -> int:
    """Chunk size for prefix-reuse cells: 1/8 of the prompt, power-of-two,
    at least 8 — keeps chunk counts (and PrefixCache probes) bounded."""
    c = 8
    while c * 16 <= isl:
        c *= 2
    return c


def _requests(cell: SweepCell, vocab: int, n: int,
              shared_len: int, isl: int) -> List[Request]:
    """A t=0 burst of ``n`` prompts (saturation episode) of length
    ``isl``, the first ``shared_len`` tokens family-shared."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, shared_len).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, isl - shared_len).astype(np.int32)
        out.append(Request(rid=i, prompt=np.concatenate([shared, tail]),
                           osl=cell.osl, arrival_t=0.0))
    return out


def simulate_cell(cell: SweepCell, *, slots: int = SIM_SLOTS
                  ) -> List[dict]:
    """Run the cell's bounded serve episode -> one ``kind="sim"`` record.

    The record carries the cell coordinate (so ``SweepResult`` filters
    treat it like any other row), the served ``sla_metrics``, and the
    simulated throughput objectives (``tput_per_chip`` /
    ``tput_per_dollar`` over the fleet's engines-as-chips)."""
    model = get_perf_model(cell.model)
    vocab = int(model.vocab_size)
    n = max(cell.sim_requests, 1)
    chunk = _chunk_for(cell.isl)
    # reuse mechanism mirrors the analytic effective-ISL contract (compute
    # scales by 1 - reuse): attention models replay a shared prompt prefix
    # through the real PrefixCache; cache-less families (rwkv, hybrid —
    # SimEngine attaches no PrefixCache, matching the real backend) get
    # the discount directly as shorter prompts
    caches_prefixes = model.attention in ("gqa", "mla")
    isl, shared_len, chunk_size, reuse_via = cell.isl, 0, 0, "none"
    if cell.reuse > 0:
        if caches_prefixes:
            # nearest chunk-aligned prefix (capped so a suffix chunk
            # remains processable); a reuse too small to express at this
            # chunking is labeled honestly instead of claimed
            shared_len = min(round(cell.isl * cell.reuse / chunk) * chunk,
                             max(cell.isl - chunk, 0))
            if shared_len > 0:
                chunk_size = chunk
                reuse_via = "prefix_cache"
        else:
            isl = max(1, round(cell.isl * (1.0 - cell.reuse)))
            reuse_via = "effective_isl"
    capacity = cell.isl + cell.osl + 8

    def eng(i, chip_name, chunked=True):
        return SimEngine(i, model, slots=slots, capacity=capacity,
                         chunk_size=(chunk_size if chunked else 0),
                         chip=get_chip(chip_name))

    if cell.mode == "disagg":
        # only the prefill engine chunks (and carries a PrefixCache);
        # decode-role engines never prefill
        pools = {"prefill": [eng(0, cell.prefill_chip)],
                 "decode": [eng(1, cell.decode_chip, chunked=False),
                            eng(2, cell.decode_chip, chunked=False)]}
        chips = [cell.prefill_chip, cell.decode_chip, cell.decode_chip]
        cluster = Cluster(pools, scheduler=(
            ChunkedPiggybackScheduler(chunk) if chunk_size else None))
    else:
        pools = {"mixed": [eng(0, cell.prefill_chip),
                           eng(1, cell.prefill_chip)]}
        chips = [cell.prefill_chip, cell.prefill_chip]
        cluster = Cluster(pools,
                          scheduler=ChunkedPiggybackScheduler(chunk),
                          router=KVLocalityRouter())

    work = StaticWorkload(_requests(cell, vocab, n, shared_len, isl))
    metrics = cluster.serve(work, max_wall_s=1e9)
    n_chips = len(chips)
    cost = sum(get_chip(c).cost_per_hour for c in chips)
    hit_tokens = sum(e.prefix_cache.hit_tokens for e in cluster.engines()
                     if e.prefix_cache is not None)
    rec = {
        "model": cell.model, "mode": cell.mode,
        "prefill_chip": cell.prefill_chip, "decode_chip": cell.decode_chip,
        "isl": cell.isl, "osl": cell.osl, "reuse": cell.reuse,
        "kind": "sim",
        "sim_requests": n,
        "reuse_via": reuse_via,
        "n_engines": n_chips,
        "completed": int(metrics["completed"]),
        "p50_ftl_s": metrics["p50_ftl_s"],
        "p99_ftl_s": metrics["p99_ftl_s"],
        "p50_ttl_s": metrics["p50_ttl_s"],
        "p99_ttl_s": metrics["p99_ttl_s"],
        "queue_wait_s": metrics["queue_wait_s"],
        # phase-level latency attribution (serving.tracing): where each
        # request's end-to-end latency went, as quantile columns
        "p50_queue_wait_s": metrics["p50_queue_wait_s"],
        "p99_queue_wait_s": metrics["p99_queue_wait_s"],
        "p50_prefill_s": metrics["p50_prefill_s"],
        "p99_prefill_s": metrics["p99_prefill_s"],
        "p50_transfer_s": metrics["p50_transfer_s"],
        "p99_transfer_s": metrics["p99_transfer_s"],
        "p50_decode_stall_s": metrics["p50_decode_stall_s"],
        "p99_decode_stall_s": metrics["p99_decode_stall_s"],
        "tokens_per_s": metrics["tokens_per_s"],
        "tps_per_user": metrics["tps_per_user"],
        "tput_per_chip": metrics["tokens_per_s"] / n_chips,
        "tput_per_dollar": metrics["tokens_per_s"] / cost,
        "transfers": cluster.stats.transfers,
        "transferred_bytes": cluster.stats.transferred_bytes,
        "cache_hit_tokens": hit_tokens,
    }
    return [rec]
