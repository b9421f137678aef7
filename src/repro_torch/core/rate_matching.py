"""Rate matching (paper Appendix B, Algorithms 1 & 2) + dynamic variant.

Algorithm 1 picks the prefill mapping with the best requests/s/chip under the
FTL cutoff. Algorithm 2 then, for each candidate decode mapping, finds the
rational prefill:decode instance ratio alpha that balances request throughput
(a Fraction.limit-denominator integer solve, the paper's "integer solver with
tolerance"), yielding overall tokens/s/chip accounting for *all* chips.

Note: Algorithm 2 as printed defines alpha = prefill_tput / decode_req_tput
and multiplies numerator(alpha) by the *decode* GPU count. Taken literally
that does not balance the two pools (units don't cancel); we implement the
stated *intent* — "find the right balance between the throughput of prefill
and decode phases" — i.e. the instance ratio satisfying
    i_pre * G_pre * pre_tput == i_dec * G_dec * dec_req_tput,
rounded to a small rational with the same tolerance parameter.

The solve is hardware-heterogeneous: each ``DesignPoint`` carries the
``SystemConfig`` it was swept on, so the prefill pool can run a different
chip than the decode pool (compute-rich prefill x bandwidth-rich decode).
``dynamic_rate_match(model=..., prefill_sys=..., decode_sys=...)``
enumerates each phase's design space on its own hardware; per-pool chip
counts come out of the same integer solve.

The port's copy of ``repro.core.rate_matching``, unchanged but for its
imports of the port's ``core`` modules. ``serving.policies`` takes
``split_pool`` from here, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.design_space import DesignPoint
from repro_torch.core.hardware import HardwareLike, as_system


@dataclasses.dataclass(frozen=True)
class RateMatchedPoint:
    prefill: DesignPoint
    decode: DesignPoint
    alpha: Fraction                 # prefill : decode instance ratio
    num_prefill_chips: int
    num_decode_chips: int
    overall_tput_per_chip: float    # tokens/s/chip over ALL chips (Table 1)
    tps_per_user: float             # interactivity = 1/TTL
    ftl_s: float
    osl: int = 0                    # output length the solve balanced for

    @property
    def total_chips(self) -> int:
        return self.num_prefill_chips + self.num_decode_chips

    @property
    def ctx_gen_ratio(self) -> float:
        return self.num_prefill_chips / max(self.num_decode_chips, 1)

    @property
    def prefill_chip(self) -> str:
        return self.prefill.chip_name

    @property
    def decode_chip(self) -> str:
        return self.decode.chip_name

    @property
    def heterogeneous(self) -> bool:
        return self.prefill_chip != self.decode_chip

    @property
    def cost_per_hour(self) -> float:
        """$/hour of the full matched deployment (both pools at their own
        chip's list price)."""
        return (self.num_prefill_chips * self.prefill.system.chip.cost_per_hour
                + self.num_decode_chips * self.decode.system.chip.cost_per_hour)

    @property
    def overall_tput_per_dollar(self) -> float:
        """Tokens/s per $/hour — the cost-weighted objective. Chip-count
        weighting (``overall_tput_per_chip``) treats a v5e and an h100 as
        equal denominators; dollars are the denominator operators actually
        budget."""
        cost_per_hour = self.cost_per_hour
        if cost_per_hour <= 0:
            return 0.0
        return (self.overall_tput_per_chip * self.total_chips
                / cost_per_hour)

    def pool_rates(self) -> Tuple[float, float]:
        """(prefill, decode) balanced request rates over the sized pools."""
        pre_tput = self.prefill.batch / (self.prefill.perf.latency_s
                                         * self.prefill.mapping.chips)
        dec_req = (self.decode.batch / (self.decode.perf.latency_s
                                        * self.decode.mapping.chips)
                   / max(self.osl - 1, 1))
        return pre_tput * self.num_prefill_chips, \
            dec_req * self.num_decode_chips

    @property
    def balance_residual(self) -> float:
        """Relative imbalance of the integer solve: 0 when
        i_pre*G_pre*pre_tput == i_dec*G_dec*dec_req_tput exactly; bounded
        by the solver tolerance whenever alpha was representable within
        ``max_denominator``."""
        a, b = self.pool_rates()
        return abs(a - b) / max(a, b)


def prefill_config_selection(points: Sequence[DesignPoint], ftl_cutoff: float
                             ) -> Optional[DesignPoint]:
    """Algorithm 1: best requests/s/chip among FTL-feasible prefill configs."""
    best, best_tput = None, 0.0
    for p in points:
        if p.perf.latency_s < ftl_cutoff:
            tput = p.batch / (p.perf.latency_s * p.mapping.chips)
            if tput > best_tput:
                best, best_tput = p, tput
    return best


def rate_match(prefill_pt: DesignPoint, decode_pts: Sequence[DesignPoint],
               osl: int, *, ttl_cutoff: Optional[float] = None,
               tolerance: float = 0.03, max_denominator: int = 64
               ) -> List[RateMatchedPoint]:
    """Algorithm 2: balance prefill and decode request throughput."""
    out = []
    G_pre = prefill_pt.mapping.chips
    pre_tput = prefill_pt.batch / (prefill_pt.perf.latency_s * G_pre)  # req/s/chip
    for d in decode_pts:
        ttl = d.perf.latency_s
        if ttl_cutoff is not None and ttl > ttl_cutoff:
            continue
        G_dec = d.mapping.chips
        dec_tok_tput = d.batch / (ttl * G_dec)                   # tok/s/chip
        dec_req_tput = dec_tok_tput / max(osl - 1, 1)            # req/s/chip
        # Balance: i_pre * G_pre * pre_tput == i_dec * G_dec * dec_req_tput
        # -> instance ratio rounded to a small rational (the integer solve).
        ratio = (G_dec * dec_req_tput) / (G_pre * pre_tput)
        alpha = _round_fraction(ratio, tolerance, max_denominator)
        if alpha == 0:
            continue
        i_pre, i_dec = alpha.numerator, alpha.denominator
        n_pre = i_pre * G_pre
        n_dec = i_dec * G_dec
        # bottleneck pool limits the balanced request rate (rounding slack)
        req_rate = min(pre_tput * n_pre, dec_req_tput * n_dec)
        total = n_pre + n_dec
        overall = req_rate * (osl - 1) / total                  # tok/s/chip
        out.append(RateMatchedPoint(
            prefill=prefill_pt, decode=d, alpha=alpha,
            num_prefill_chips=n_pre, num_decode_chips=n_dec,
            overall_tput_per_chip=overall,
            tps_per_user=1.0 / ttl,
            ftl_s=prefill_pt.perf.latency_s, osl=osl))
    return out


def _round_fraction(x: float, tolerance: float, max_denominator: int
                    ) -> Fraction:
    """Simplest positive fraction within relative `tolerance` of x; falls
    back to the closest representable positive fraction (the paper's
    'integer solver ... with tolerance')."""
    if x <= 0:
        return Fraction(0)
    for d in range(1, max_denominator + 1):
        n = int(x * d + 0.5)              # nearest, ties away from zero
        f = Fraction(n, d)
        if f > 0 and abs(float(f) - x) / x <= tolerance:
            return f
    best = Fraction(x).limit_denominator(max_denominator)
    return best if best > 0 else Fraction(1, max_denominator)


def split_pool(n_engines: int, alpha) -> Tuple[int, int]:
    """Bridge Algorithm 2's analytic instance ratio into runtime pool sizing:
    split ``n_engines`` role-free engines into (n_prefill, n_decode) closest
    to ``alpha`` = prefill:decode (a ``Fraction`` from ``rate_match`` or any
    positive float), keeping at least one engine in each role.

    This is what ``serving.policies.StaticSplitRateMatcher`` uses to turn a
    ``RateMatchedPoint.alpha`` into an actual static deployment."""
    assert n_engines >= 2, "need at least one engine per role"
    a = float(alpha)
    assert a > 0, alpha
    # alpha = n_pre / n_dec  ->  n_pre = n * a / (1 + a), rounded to nearest
    n_pre = int(round(n_engines * a / (1.0 + a)))
    n_pre = min(max(n_pre, 1), n_engines - 1)
    return n_pre, n_engines - n_pre


def rate_match_fixed_ratio(prefill_pt: DesignPoint,
                           decode_pts: Sequence[DesignPoint], osl: int,
                           fixed_ratio: float) -> List[RateMatchedPoint]:
    """Fig 10: rate matching constrained to a fixed ctx:gen chip ratio.

    Deployment is sized by the *bottleneck* phase: with the ratio pinned,
    whichever pool is undersized throttles the balanced request rate.
    """
    out = []
    pre_tput = prefill_pt.batch / (prefill_pt.perf.latency_s
                                   * prefill_pt.mapping.chips)
    for d in decode_pts:
        ttl = d.perf.latency_s
        dec_tok_tput = d.batch / (ttl * d.mapping.chips)
        dec_req_tput = dec_tok_tput / max(osl - 1, 1)
        # chips allocated at the fixed ratio (continuous approximation)
        n_pre = fixed_ratio
        n_dec = 1.0
        req_rate = min(pre_tput * n_pre, dec_req_tput * n_dec)
        overall = req_rate * (osl - 1) / (n_pre + n_dec)
        out.append(RateMatchedPoint(
            prefill=prefill_pt, decode=d, alpha=Fraction(1),
            num_prefill_chips=int(round(n_pre * d.mapping.chips)),
            num_decode_chips=d.mapping.chips,
            overall_tput_per_chip=overall,
            tps_per_user=1.0 / ttl,
            ftl_s=prefill_pt.perf.latency_s, osl=osl))
    return out


def dynamic_rate_match(prefill_pts: Optional[Sequence[DesignPoint]] = None,
                       decode_pts: Optional[Sequence[DesignPoint]] = None, *,
                       isl: int, osl: int, ftl_cutoff: float,
                       ttl_targets: Sequence[float],
                       tolerance: float = 0.03,
                       model=None,
                       prefill_sys: Optional[HardwareLike] = None,
                       decode_sys: Optional[HardwareLike] = None,
                       max_chips: Optional[int] = None,
                       mem_isl: Optional[int] = None
                       ) -> List[RateMatchedPoint]:
    """Full §3.2 pipeline: Alg 1 under the FTL cutoff, then Alg 2 for every
    TTL target — the frontier generator behind Figs 1/6/7/8/10/11.

    Two call styles:

    - pre-swept: pass ``prefill_pts`` / ``decode_pts`` (possibly built on
      *different* ``SystemConfig``s — each ``DesignPoint`` carries its own
      hardware, and the balance solve never assumes they match);
    - per-pool hardware: pass ``model`` plus ``prefill_sys`` / ``decode_sys``
      (``SystemConfig``, ``ChipConfig``, or a registry name like "v5p") and
      each phase's design space is enumerated on its own chip — e.g. TPU
      v5p prefill x v5e decode. ``mem_isl`` (>= isl) sizes the prefill HBM
      check under KV reuse, mirroring ``sweep_prefill``.
    """
    if prefill_pts is None or decode_pts is None:
        from repro_torch.core.design_space import sweep_decode, sweep_prefill
        from repro_torch.core.hardware import DEFAULT_SYSTEM
        if model is None:
            raise ValueError("need `model` to sweep design spaces when "
                             "prefill_pts/decode_pts are not given")
        fallback = (prefill_sys if prefill_sys is not None else
                    decode_sys if decode_sys is not None else DEFAULT_SYSTEM)
        if prefill_pts is None:
            pre_sys = as_system(prefill_sys if prefill_sys is not None
                                else fallback)
            prefill_pts = sweep_prefill(model, isl, pre_sys,
                                        max_chips=max_chips, mem_isl=mem_isl)
        if decode_pts is None:
            dec_sys = as_system(decode_sys if decode_sys is not None
                                else fallback)
            decode_pts = sweep_decode(
                model, (mem_isl or isl) + osl // 2, dec_sys,
                max_chips=max_chips, max_ctx=(mem_isl or isl) + osl)
    best_pre = prefill_config_selection(prefill_pts, ftl_cutoff)
    if best_pre is None:
        return []
    out = []
    for ttl in ttl_targets:
        cands = rate_match(best_pre, decode_pts, osl, ttl_cutoff=ttl,
                           tolerance=tolerance)
        if not cands:
            continue
        out.append(max(cands, key=lambda r: r.overall_tput_per_chip))
    return out


def dynamic_rate_match_for(prefill_pts: Optional[Sequence[DesignPoint]],
                           decode_pts: Optional[Sequence[DesignPoint]],
                           summary, *,
                           ftl_cutoff: float,
                           ttl_targets: Sequence[float],
                           tolerance: float = 0.03,
                           **hardware) -> List[RateMatchedPoint]:
    """Rate matching driven by a scenario's marginals: ``summary`` is any
    object with ``isl`` / ``effective_isl`` / ``osl``
    (``workloads.WorkloadSummary`` duck-typed, so ``core`` stays
    import-independent of the workload layer). KV reuse enters through
    ``effective_isl``: the prefill sweep fed in should have been built at
    that token count (``design_space.sweep_prefill(..., mem_isl=
    full_isl)``). Pass ``prefill_pts=decode_pts=None`` plus ``model`` and
    per-pool ``prefill_sys`` / ``decode_sys`` keywords to sweep each phase
    on its own hardware."""
    full_isl = max(1, round(getattr(summary, "isl", summary.effective_isl)))
    # mem_isl sizes HBM residency for *both* auto-swept phases (prefill
    # capacity check and decode KV context span the full isl, not the
    # reuse-reduced effective_isl)
    auto_sweep = prefill_pts is None or decode_pts is None
    return dynamic_rate_match(
        prefill_pts, decode_pts,
        isl=max(1, round(summary.effective_isl)),
        osl=max(1, round(summary.osl)),
        ftl_cutoff=ftl_cutoff, ttl_targets=ttl_targets,
        tolerance=tolerance,
        **dict({"mem_isl": full_isl} if auto_sweep else {}, **hardware))
