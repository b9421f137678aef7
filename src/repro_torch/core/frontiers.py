"""Frontier builders: disaggregated vs co-located (piggybacked or not).

These assemble the Pareto curves behind Figs 1, 6, 7, 8, 10, 11 from the
perf model + design space + rate matching.

The port's copy of ``repro.core.frontiers``, unchanged but for its
imports of the port's ``core`` and ``sweeps`` modules.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.design_space import (DesignPoint, sweep_decode, sweep_prefill,
                                     _pow2)
from repro_torch.core.hardware import (DEFAULT_SYSTEM, HardwareLike, SystemConfig,
                                 as_system)
from repro_torch.core.pareto import pareto_frontier
from repro_torch.core.perf_model import (Mapping, PerfLLM, decode_step_perf,
                                   hbm_fits, piggyback_step_perf,
                                   prefill_perf)
from repro_torch.core.rate_matching import dynamic_rate_match

Point = Tuple[float, float]

FTL_CUTOFF_DEFAULT = 10.0          # paper: FTL > 10 s excluded


def default_ttl_targets(n: int = 24) -> List[float]:
    """Log-spaced TTL targets: 2 ms .. 1 s (interactivity 1..500 tok/s/user).
    ``n=1`` degenerates to the tightest target alone."""
    return [2e-3 * (500 ** (i / max(n - 1, 1))) for i in range(n)]


def matched_objective(r, weight: str = "chip") -> float:
    """The y-axis of a frontier point: per-chip (paper Table 1) or
    per-dollar (cost-weighted) throughput of a ``RateMatchedPoint``."""
    if weight == "chip":
        return r.overall_tput_per_chip
    if weight == "cost":
        return r.overall_tput_per_dollar
    raise ValueError(f"weight must be 'chip' or 'cost': {weight!r}")


def disaggregated_frontier(model: PerfLLM, isl: int, osl: int,
                           sys_: SystemConfig = DEFAULT_SYSTEM, *,
                           ftl_cutoff: float = FTL_CUTOFF_DEFAULT,
                           ttl_targets: Optional[Sequence[float]] = None,
                           max_chips: Optional[int] = None,
                           reuse_fraction: float = 0.0,
                           hardware: Optional[dict] = None,
                           weight: str = "chip",
                           engine: str = "scalar"
                           ) -> List[Point]:
    """``reuse_fraction`` models KV-cache reuse (multi-turn / shared-prefix
    workloads): prefill computes only the un-cached ``isl * (1 - reuse)``
    tokens, while HBM residency and decode context still span the full
    ``isl + osl``.

    ``hardware`` makes the pools heterogeneous:
    ``{"prefill": "v5p", "decode": "v5e"}`` (values are ``SystemConfig`` /
    ``ChipConfig`` / registry names) sweeps each phase's design space on
    its own chip; a missing key falls back to ``sys_``. Throughput stays
    normalized per chip over *all* chips of the matched deployment, so
    heterogeneous and homogeneous frontiers share one y-axis.

    ``weight``: ``"chip"`` (tokens/s/chip, the paper's axis) or ``"cost"``
    (tokens/s per $/hour, using ``ChipConfig.cost_per_hour``).

    ``engine``: ``"scalar"`` walks the per-point python perf model;
    ``"vectorized"`` delegates to ``repro_torch.sweeps.vectorized`` (NumPy over
    the whole design grid — same formulas, same selections, ~20-100x
    faster; equivalence is property-tested in tests/test_sweeps.py)."""
    assert 0.0 <= reuse_fraction < 1.0, reuse_fraction
    if weight not in ("chip", "cost"):    # fail before sweeping anything
        raise ValueError(f"weight must be 'chip' or 'cost': {weight!r}")
    pre_sys, dec_sys = sys_, sys_
    if hardware:
        unknown = set(hardware) - {"prefill", "decode"}
        assert not unknown, f"hardware keys must be prefill/decode: {unknown}"
        pre_sys = as_system(hardware.get("prefill", sys_), base=sys_)
        dec_sys = as_system(hardware.get("decode", sys_), base=sys_)
    targets = list(ttl_targets or default_ttl_targets())
    if engine == "vectorized":
        from repro_torch.sweeps.vectorized import matched_points_vec
        matched = matched_points_vec(
            model, isl, osl, pre_sys, dec_sys, ftl_cutoff=ftl_cutoff,
            ttl_targets=targets, max_chips=max_chips,
            reuse_fraction=reuse_fraction)
    elif engine == "scalar":
        isl_eff = max(1, round(isl * (1.0 - reuse_fraction)))
        pre = sweep_prefill(model, isl_eff, pre_sys, max_chips=max_chips,
                            mem_isl=isl)
        dec = sweep_decode(model, isl + osl // 2, dec_sys,
                           max_chips=max_chips, max_ctx=isl + osl)
        matched = dynamic_rate_match(pre, dec, isl=isl_eff, osl=osl,
                                     ftl_cutoff=ftl_cutoff,
                                     ttl_targets=targets)
    else:
        raise ValueError(f"engine must be 'scalar' or 'vectorized': "
                         f"{engine!r}")
    pts = [(r.tps_per_user, matched_objective(r, weight)) for r in matched]
    return pareto_frontier(pts)


def best_hardware_frontier(model: PerfLLM, isl: int, osl: int,
                           options: Sequence[HardwareLike],
                           sys_: SystemConfig = DEFAULT_SYSTEM,
                           **kw) -> List[Point]:
    """Pareto union over every per-pool chip assignment drawn from
    ``options`` (all |options|^2 prefill x decode pairs, homogeneous pairs
    included). By construction this frontier dominates-or-ties each
    homogeneous frontier at the same chip budget — the analytic upper
    bound of what heterogeneous pools can buy.

    ``weight="cost"`` ranks deployments by tokens/s per dollar instead of
    per chip — under it a cheap-silicon pool can dominate a faster one,
    which chip-count weighting structurally cannot show. ``engine=
    "vectorized"`` sweeps each pair on the NumPy path."""
    pts: List[Point] = []
    for pre_hw in options:
        for dec_hw in options:
            pts.extend(disaggregated_frontier(
                model, isl, osl, sys_,
                hardware={"prefill": pre_hw, "decode": dec_hw}, **kw))
    return pareto_frontier(pts)


def workload_frontier(model: PerfLLM, workload,
                      sys_: SystemConfig = DEFAULT_SYSTEM, *,
                      mode: str = "disagg", **kw) -> List[Point]:
    """Frontier for a ``repro_torch.workloads`` scenario object (or a bare
    ``WorkloadSummary``): the analytic sweep consumes the same
    ``(isl, osl, reuse_fraction)`` marginals the executable simulator
    serves, so both evaluators see one scenario definition.

    ``mode``: ``"disagg"`` (reuse-aware, Fig 2 right) or ``"coloc"``
    (Fig 2 left; reuse ignored — the co-located perf model has no
    prefix-cache term). ``hardware={"prefill": ..., "decode": ...}``
    passes through to ``disaggregated_frontier`` for heterogeneous pools;
    for ``"coloc"`` it is dropped (one mixed pool runs one chip), so a
    caller can sweep both modes with one kwargs dict."""
    summary = workload.summary() if hasattr(workload, "summary") else workload
    isl = max(1, round(summary.isl))
    osl = max(1, round(summary.osl))
    if mode == "disagg":
        return disaggregated_frontier(
            model, isl, osl, sys_,
            reuse_fraction=summary.reuse_fraction, **kw)
    if mode == "coloc":
        # one mixed pool: no per-pool hardware, and the vectorized coloc
        # path lives in repro_torch.sweeps.engine
        kw.pop("hardware", None)
        kw.pop("engine", None)
        weight = kw.pop("weight", "chip")
        if weight not in ("chip", "cost"):   # fail before sweeping anything
            raise ValueError(f"weight must be 'chip' or 'cost': {weight!r}")
        f = colocated_frontier(model, isl, osl, sys_, **kw)
        if weight == "cost":
            # every instance runs the one chip, so per-dollar is a uniform
            # rescale — keeps coloc/disagg cost frontiers unit-compatible
            f = [(x, y / sys_.chip.cost_per_hour) for x, y in f]
        return f
    raise ValueError(f"mode must be 'disagg' or 'coloc': {mode!r}")


def colocated_frontier(model: PerfLLM, isl: int, osl: int,
                       sys_: SystemConfig = DEFAULT_SYSTEM, *,
                       piggyback: bool = True,
                       non_piggyback: bool = True,
                       ftl_cutoff: float = FTL_CUTOFF_DEFAULT,
                       mla_chunk_cache: bool = False,
                       max_chips: Optional[int] = None
                       ) -> List[Point]:
    """Co-located pool: every instance serves both phases.

    non-piggybacked: batch alternates a full prefill then OSL decode steps;
    decode stalls during prefill inflate effective TTL (the IFB tension).

    piggybacked: every step carries decode_batch tokens + a prefill chunk
    sized for steady-state rate balance (chunk = b*ISL/OSL); TTL is uniform
    but each step is slower (Sarathi). MLA pays chunk re-projection (§4.1)
    unless mla_chunk_cache.
    """
    pts: List[Point] = []
    max_chips = max_chips or sys_.ici_domain
    for g in _pow2(1, max_chips):
        for pp in _pow2(1, min(g, 16)):
            if g % pp:
                continue
            for tp in _pow2(1, g // pp):
                if (g // pp) % tp:
                    continue
                m = Mapping(chips=g, tp=tp, pp=pp, dp_attn=g // (pp * tp))
                if not m.valid(model, sys_):
                    continue
                for b in _pow2(1, 1024):
                    if not hbm_fits(model, m, b, isl + osl, sys_):
                        continue
                    d = decode_step_perf(model, m, b, isl + osl // 2, sys_)
                    if non_piggyback:
                        # cycle: prefill the whole batch, then osl decode
                        # steps; prefills preempt decode (the IFB stall)
                        pb_ = prefill_perf(model, m, b, isl, sys_)
                        cycle = pb_.latency_s + osl * d.latency_s
                        ftl = pb_.latency_s
                        if ftl < ftl_cutoff:
                            ttl_eff = cycle / osl
                            tput = b * osl / (cycle * g)
                            pts.append((1.0 / ttl_eff, tput))
                    if piggyback:
                        # balanced chunk so request in-rate == out-rate
                        chunk = max(1, int(b * isl / max(osl, 1)))
                        chunk = min(chunk, isl)
                        pb = piggyback_step_perf(
                            model, m, b, isl + osl // 2, chunk, isl // 2,
                            sys_, mla_chunk_cache=mla_chunk_cache)
                        ftl = isl / chunk * pb.latency_s
                        if ftl < ftl_cutoff:
                            ttl = pb.latency_s
                            tput = b / (pb.latency_s * g)
                            pts.append((1.0 / ttl, tput))
    return pareto_frontier(pts)
