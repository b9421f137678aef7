"""Design-space enumeration (§3): partitioning x batch, per phase.

Enumerates (chips-per-instance, TP, PP, DP_attn, CPP-chunks, batch) points
subject to mesh divisibility + HBM capacity, mirroring the paper's sweep of
"TP, EP, PP, CPP and TEP across a wide range of batch sizes". EP is implied:
MoE experts always span the chips of a stage (perf_model.Mapping.ep).

The port's copy of ``repro.core.design_space``, unchanged but for its
imports of the port's ``core`` modules.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List, Optional

from repro_torch.core.hardware import SystemConfig, DEFAULT_SYSTEM
from repro_torch.core.perf_model import (Mapping, PerfLLM, PhasePerf,
                                   decode_step_perf, hbm_fits, prefill_perf)


def _pow2(lo: int, hi: int) -> List[int]:
    out = []
    v = lo
    while v <= hi:
        out.append(v)
        v *= 2
    return out


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    mapping: Mapping
    batch: int
    perf: PhasePerf
    phase: str                      # "prefill" | "decode"
    system: SystemConfig = DEFAULT_SYSTEM   # hardware this point was swept on

    @property
    def chip_name(self) -> str:
        return self.system.chip.name

    @property
    def latency_s(self) -> float:
        return self.perf.latency_s

    def throughput_per_chip(self) -> float:
        """prefill: requests/s/chip; decode: tokens/s/chip (paper Table 1)."""
        if self.phase == "prefill":
            return self.batch / (self.perf.latency_s * self.mapping.chips)
        return self.batch / (self.perf.latency_s * self.mapping.chips)


def enumerate_mappings(model: PerfLLM, sys_: SystemConfig,
                       *, prefill: bool, max_chips: Optional[int] = None
                       ) -> Iterator[Mapping]:
    max_chips = max_chips or sys_.ici_domain
    for g in _pow2(1, max_chips):
        for pp in _pow2(1, min(g, 64)):
            if g % pp:
                continue
            for tp in _pow2(1, g // pp):
                if (g // pp) % tp:
                    continue
                dp = g // (pp * tp)
                chunk_opts = _pow2(1, 16) if prefill else [1]
                for cpp in chunk_opts:
                    if cpp > 1 and pp == 1:
                        continue        # chunking w/o pipeline = plain chunking
                    m = Mapping(chips=g, tp=tp, pp=pp, dp_attn=dp,
                                cpp_chunks=cpp)
                    if m.valid(model, sys_):
                        yield m


def sweep_prefill(model: PerfLLM, isl: int, sys_: SystemConfig = DEFAULT_SYSTEM,
                  batches: Optional[List[int]] = None,
                  max_chips: Optional[int] = None,
                  mem_isl: Optional[int] = None) -> List[DesignPoint]:
    """``isl`` drives prefill *compute*; ``mem_isl`` (>= isl) drives the HBM
    capacity check. They differ under KV reuse (``WorkloadSummary.
    reuse_fraction``): cached prefix tokens skip the FLOPs but their KV must
    still be resident."""
    batches = batches or _pow2(1, 64)
    mem_isl = mem_isl or isl
    pts = []
    for m in enumerate_mappings(model, sys_, prefill=True,
                                max_chips=max_chips):
        for b in batches:
            if not hbm_fits(model, m, b, mem_isl, sys_):
                continue
            perf = prefill_perf(model, m, b, isl, sys_)
            pts.append(DesignPoint(m, b, perf, "prefill", sys_))
    return pts


def sweep_decode(model: PerfLLM, kv_len: int,
                 sys_: SystemConfig = DEFAULT_SYSTEM,
                 batches: Optional[List[int]] = None,
                 max_chips: Optional[int] = None,
                 max_ctx: Optional[int] = None) -> List[DesignPoint]:
    """kv_len: average context for the step-time model; max_ctx: capacity
    check (requests reach full ISL+OSL context before completing)."""
    batches = batches or _pow2(1, 2048)
    max_ctx = max_ctx or kv_len
    pts = []
    for m in enumerate_mappings(model, sys_, prefill=False,
                                max_chips=max_chips):
        for b in batches:
            if not hbm_fits(model, m, b, max_ctx, sys_):
                continue
            perf = decode_step_perf(model, m, b, kv_len, sys_)
            pts.append(DesignPoint(m, b, perf, "decode", sys_))
    return pts
