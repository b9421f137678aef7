"""NumPy-vectorized twin of ``core.perf_model`` + ``core.design_space``.

The scalar perf model evaluates one (mapping, batch) point per python call;
a paper-scale sweep (models x chips x ISL/OSL x reuse x TTL targets) is
hundreds of thousands of such points, and the interpreter overhead — not
the arithmetic — dominates. This module evaluates whole design grids as
float64 arrays.

Equivalence contract: every expression below is written with the *same
operand order* as its scalar twin in ``core.perf_model``, so results agree
to within a few ULPs (IEEE double ops are deterministic; only association
differs where NumPy broadcasting forces it). ``tests/test_sweeps.py``
pins scalar-vs-vectorized agreement at rtol=1e-9 on a property-tested
grid, and the rate-match selections (argmax over points) are required to
be *identical*, not merely close.

Layout: struct-of-arrays. ``MappingGrid`` holds the integer mapping axes
(chips, tp, pp, dp_attn, cpp_chunks) x batch, one entry per design point;
``PhaseGrid`` holds the evaluated per-point timings. Both are plain
numpy — no jax anywhere on this path, so multiprocessing workers fork
cheaply.

The port's copy of ``repro.sweeps.vectorized``, unchanged but for its
imports of the port's ``core`` modules.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.design_space import DesignPoint, _pow2, enumerate_mappings
from repro_torch.core.hardware import DEFAULT_SYSTEM, SystemConfig
from repro_torch.core.perf_model import (OP_LATENCY, Mapping, PerfLLM, PhasePerf,
                                   kv_shard_chips)
from repro_torch.core.rate_matching import (RateMatchedPoint, _round_fraction)


# ---------------------------------------------------------------------------
# grids


@dataclasses.dataclass
class MappingGrid:
    """One design point per row: mapping axes x batch (int64 arrays)."""
    chips: np.ndarray
    tp: np.ndarray
    pp: np.ndarray
    dp: np.ndarray
    cpp: np.ndarray
    batch: np.ndarray

    def __len__(self) -> int:
        return len(self.chips)

    @property
    def ep(self) -> np.ndarray:
        return np.maximum(1, self.chips // self.pp)

    def select(self, mask: np.ndarray) -> "MappingGrid":
        return MappingGrid(self.chips[mask], self.tp[mask], self.pp[mask],
                           self.dp[mask], self.cpp[mask], self.batch[mask])

    def mapping(self, i: int) -> Mapping:
        return Mapping(chips=int(self.chips[i]), tp=int(self.tp[i]),
                       pp=int(self.pp[i]), dp_attn=int(self.dp[i]),
                       cpp_chunks=int(self.cpp[i]))


@dataclasses.dataclass
class PhaseGrid:
    """Evaluated per-point phase timings (float64 arrays), mirroring
    ``perf_model.PhasePerf`` fields."""
    grid: MappingGrid
    compute_s: np.ndarray
    memory_s: np.ndarray
    collective_s: np.ndarray
    latency_s: np.ndarray
    step_s: np.ndarray
    tokens: np.ndarray
    phase: str
    system: SystemConfig
    grid_total: int = 0     # pre-HBM-mask grid rows (points/s accounting)

    def __len__(self) -> int:
        return len(self.compute_s)

    @property
    def tput_per_chip(self) -> np.ndarray:
        """requests/s/chip (prefill) or tokens/s/chip (decode)."""
        return self.grid.batch / (self.latency_s * self.grid.chips)

    def phase_perf(self, i: int) -> PhasePerf:
        return PhasePerf(float(self.compute_s[i]), float(self.memory_s[i]),
                         float(self.collective_s[i]), float(self.latency_s[i]),
                         float(self.step_s[i]), float(self.tokens[i]),
                         int(self.grid.chips[i]))

    def design_point(self, i: int) -> DesignPoint:
        """Bridge one row back into the scalar world (rate-matched winners
        become ordinary ``DesignPoint``s so downstream consumers —
        ``RateMatchedPoint``, serving bridges — are unchanged)."""
        return DesignPoint(self.grid.mapping(i), int(self.grid.batch[i]),
                           self.phase_perf(i), self.phase, self.system)


def build_grid(model: PerfLLM, sys_: SystemConfig, *, prefill: bool,
               batches: Optional[Sequence[int]] = None,
               max_chips: Optional[int] = None) -> MappingGrid:
    """Cross-product of valid mappings x batch sizes, mappings-major /
    batches-minor — the exact iteration order of the scalar sweeps."""
    maps = list(enumerate_mappings(model, sys_, prefill=prefill,
                                   max_chips=max_chips))
    batches = list(batches or (_pow2(1, 64) if prefill else _pow2(1, 2048)))
    n_m, n_b = len(maps), len(batches)
    rep = lambda xs: np.repeat(np.asarray(xs, dtype=np.int64), n_b)
    return MappingGrid(
        chips=rep([m.chips for m in maps]),
        tp=rep([m.tp for m in maps]),
        pp=rep([m.pp for m in maps]),
        dp=rep([m.dp_attn for m in maps]),
        cpp=rep([m.cpp_chunks for m in maps]),
        batch=np.tile(np.asarray(batches, dtype=np.int64), n_m))


# ---------------------------------------------------------------------------
# vectorized perf-model internals (scalar twins in core.perf_model)


def _attn_flops_per_token_vec(model: PerfLLM, kv_len) -> np.ndarray:
    span = np.asarray(kv_len, dtype=np.float64)
    if model.attention == "none":
        return np.full_like(span,
                            4.0 * model.num_layers * model.d_model * model.dh)
    if model.sliding_window:
        span = np.minimum(span, model.sliding_window)
    if model.attention == "mla":
        rank = model.mla_kv_rank + model.mla_rope_dim
        return 4.0 * model.num_layers * model.num_heads * rank * span
    return 4.0 * model.num_layers * model.num_heads * model.dh * span


def _eff_vec(sys_: SystemConfig, tokens_per_chip: np.ndarray) -> np.ndarray:
    t = np.maximum(tokens_per_chip, 1e-9)
    return sys_.matmul_eff * t / (t + sys_.eff_knee_tokens)


def _dense_params(model: PerfLLM) -> float:
    return model.params() - (model.num_layers * model.num_experts * 3
                             * model.d_model * model.d_ff_expert
                             if model.is_moe else 0.0)


def _expert_param_bytes(model: PerfLLM) -> float:
    return (model.num_layers * model.num_experts * 3
            * model.d_model * model.d_ff_expert * model.bytes_param)


def _weight_bytes_per_chip_vec(model: PerfLLM, g: MappingGrid,
                               batch_tokens: np.ndarray) -> np.ndarray:
    per_chip = _dense_params(model) * model.bytes_param / (g.tp * g.pp)
    if model.is_moe:
        touched = np.minimum(
            1.0, batch_tokens * model.top_k / model.num_experts)
        per_chip = per_chip + (_expert_param_bytes(model) * touched
                               / (g.ep * g.pp))
    return per_chip


def _expert_flops_per_token(model: PerfLLM) -> float:
    if not model.is_moe:
        return 0.0
    return (2.0 * model.num_layers
            * (model.top_k + model.num_shared_experts)
            * 3 * model.d_model * model.d_ff_expert)


def _kv_shard_chips_vec(model: PerfLLM, g: MappingGrid) -> np.ndarray:
    if model.attention == "mla":
        kv_tp = np.ones_like(g.tp)
    else:
        kv_tp = np.minimum(g.tp, model.num_kv_heads)
    return kv_tp * g.pp * g.dp


def _compute_time_vec(model: PerfLLM, g: MappingGrid,
                      batch_seqs: np.ndarray, tokens: np.ndarray,
                      attn_flops: np.ndarray,
                      sys_: SystemConfig) -> np.ndarray:
    eff = _eff_vec(sys_, tokens / np.maximum(g.dp * g.pp, 1))
    peak = sys_.chip.flops_bf16 * eff
    expert = _expert_flops_per_token(model) * tokens
    linear = 2.0 * model.active_params() * tokens - expert
    par_att = g.tp * g.pp * np.maximum(1.0, np.minimum(batch_seqs, g.dp))
    return expert / (g.chips * peak) + (linear + attn_flops) / (par_att * peak)


def hbm_fits_vec(model: PerfLLM, g: MappingGrid, max_ctx: int,
                 sys_: SystemConfig) -> np.ndarray:
    w = _dense_params(model) * model.bytes_param / (g.tp * g.pp)
    if model.is_moe:
        w = w + _expert_param_bytes(model) / (g.ep * g.pp)
    kv = (g.batch * max_ctx * model.kv_bytes_per_token()
          / _kv_shard_chips_vec(model, g))
    return (w + kv) * 1.1 <= sys_.chip.hbm_cap


def decode_step_perf_vec(model: PerfLLM, g: MappingGrid, kv_len: int,
                         sys_: SystemConfig = DEFAULT_SYSTEM) -> PhaseGrid:
    """Vectorized ``decode_step_perf`` over every row of ``g``."""
    b = g.batch.astype(np.float64)
    attn_flops = _attn_flops_per_token_vec(model, kv_len) * b
    w_bytes = _weight_bytes_per_chip_vec(model, g, b)
    kv_total = b * kv_len * model.kv_bytes_per_token()
    kv_bytes = kv_total / _kv_shard_chips_vec(model, g)
    act_bytes = (8.0 * b * model.d_model * model.bytes_act
                 * model.num_layers / (g.tp * g.pp))
    mem_bytes = w_bytes + kv_bytes + act_bytes

    compute_s = _compute_time_vec(model, g, b, b, attn_flops, sys_)
    memory_s = mem_bytes / sys_.chip.hbm_bw

    L, D, ba = model.num_layers, model.d_model, model.bytes_act
    coll = np.zeros(len(g))
    n_ops = np.zeros(len(g))
    b_local = b / g.dp
    mtp = g.tp > 1
    coll += np.where(mtp, 2 * L * 2.0 * b_local * D * ba
                     * (g.tp - 1) / g.tp, 0.0)
    n_ops += np.where(mtp, 2 * L, 0)
    if model.is_moe:
        mep = g.ep > 1
        coll += np.where(mep, 2 * L * (b * model.top_k / g.ep) * D * ba
                         * (g.ep - 1) / g.ep, 0.0)
        n_ops += np.where(mep, 2 * L, 0)
    mpp = g.pp > 1
    coll += np.where(mpp, (g.pp - 1) * b_local * D * ba / g.pp, 0.0)
    n_ops += np.where(mpp, g.pp - 1, 0)
    collective_s = coll / sys_.chip.ici_bw + n_ops * OP_LATENCY

    exposed = collective_s * (1.0 - sys_.collective_overlap)
    step = np.maximum(compute_s, memory_s) + exposed
    return PhaseGrid(g, compute_s, memory_s, collective_s, step, step,
                     b, "decode", sys_)


def prefill_perf_vec(model: PerfLLM, g: MappingGrid, isl: int,
                     sys_: SystemConfig = DEFAULT_SYSTEM) -> PhaseGrid:
    """Vectorized ``prefill_perf``: the per-chunk growing-context loop runs
    over chunk *index* (<= max cpp, 16), each iteration vectorized across
    points, preserving the scalar accumulation order per point."""
    b = g.batch.astype(np.float64)
    tokens = b * isl
    n_chunks = np.maximum(g.cpp, 1)
    chunk_len = isl / n_chunks

    attn_flops = np.zeros(len(g))
    for i in range(int(n_chunks.max(initial=0))):
        active = i < n_chunks
        ctx = (i + 0.5) * chunk_len
        per_tok = _attn_flops_per_token_vec(model, np.floor(ctx))
        attn_flops += np.where(active, per_tok * chunk_len * b, 0.0)

    w_bytes = _weight_bytes_per_chip_vec(model, g, tokens)
    act_bytes = (8.0 * tokens * model.d_model * model.bytes_act
                 * model.num_layers / (g.tp * g.pp))
    kv_bytes = (tokens * model.kv_bytes_per_token()
                / _kv_shard_chips_vec(model, g))
    mem_bytes = w_bytes * n_chunks + act_bytes + kv_bytes

    compute_s = _compute_time_vec(model, g, b, tokens, attn_flops, sys_)
    memory_s = mem_bytes / sys_.chip.hbm_bw

    L, D, ba = model.num_layers, model.d_model, model.bytes_act
    coll = np.zeros(len(g))
    n_ops = np.zeros(len(g))
    tokens_local = tokens / g.dp
    mtp = g.tp > 1
    coll += np.where(mtp, 2 * L * 2.0 * tokens_local * D * ba
                     * (g.tp - 1) / g.tp, 0.0)
    n_ops += np.where(mtp, 2 * L * n_chunks, 0)
    if model.is_moe:
        mep = g.ep > 1
        coll += np.where(mep, 2 * L * (tokens * model.top_k / g.ep) * D * ba
                         * (g.ep - 1) / g.ep, 0.0)
        n_ops += np.where(mep, 2 * L * n_chunks, 0)
    mpp = g.pp > 1
    coll += np.where(mpp, (g.pp - 1) * tokens_local * D * ba / g.pp, 0.0)
    n_ops += np.where(mpp, (g.pp - 1) * n_chunks, 0)
    collective_s = coll / sys_.chip.ici_bw + n_ops * OP_LATENCY

    exposed = collective_s * (1.0 - sys_.collective_overlap)
    work = np.maximum(compute_s, memory_s) + exposed
    micro = n_chunks * g.batch
    latency = work * (1.0 + (g.pp - 1) / micro)
    return PhaseGrid(g, compute_s, memory_s, collective_s, latency, work,
                     tokens, "prefill", sys_)


def piggyback_step_perf_vec(model: PerfLLM, g: MappingGrid, kv_len: int,
                            chunk_tokens: np.ndarray, chunk_ctx: int,
                            sys_: SystemConfig = DEFAULT_SYSTEM,
                            mla_chunk_cache: bool = False) -> PhaseGrid:
    """Vectorized ``piggyback_step_perf`` (co-located piggybacked step):
    ``g.batch`` is the decode batch, ``chunk_tokens`` the per-point prefill
    chunk riding along."""
    b = g.batch.astype(np.float64)
    ct = chunk_tokens.astype(np.float64)
    toks = b + ct
    attn_flops = _attn_flops_per_token_vec(model, kv_len) * b
    attn_flops = attn_flops + _attn_flops_per_token_vec(
        model, chunk_ctx + chunk_tokens // 2) * ct
    if model.attention == "mla" and not mla_chunk_cache:
        reproj = (2.0 * model.num_layers * chunk_ctx
                  * model.mla_kv_rank * model.num_heads * model.dh * 2)
        attn_flops = attn_flops + np.where(chunk_tokens > 0, reproj, 0.0)

    w_bytes = _weight_bytes_per_chip_vec(model, g, toks)
    kv_total = (b * kv_len + chunk_ctx) * model.kv_bytes_per_token()
    kv_bytes = kv_total / _kv_shard_chips_vec(model, g)
    act_bytes = (8.0 * toks * model.d_model * model.bytes_act
                 * model.num_layers / (g.tp * g.pp))
    mem_bytes = w_bytes + kv_bytes + act_bytes

    compute_s = _compute_time_vec(model, g, b + 1, toks, attn_flops, sys_)
    memory_s = mem_bytes / sys_.chip.hbm_bw

    L, D, ba = model.num_layers, model.d_model, model.bytes_act
    coll = np.zeros(len(g))
    n_ops = np.zeros(len(g))
    mtp = g.tp > 1
    coll += np.where(mtp, 2 * L * 2.0 * (toks / g.dp) * D * ba
                     * (g.tp - 1) / g.tp, 0.0)
    n_ops += np.where(mtp, 2 * L, 0)
    if model.is_moe:
        mep = g.ep > 1
        coll += np.where(mep, 2 * L * (toks * model.top_k / g.ep) * D * ba
                         * (g.ep - 1) / g.ep, 0.0)
        n_ops += np.where(mep, 2 * L, 0)
    collective_s = coll / sys_.chip.ici_bw + n_ops * OP_LATENCY

    exposed = collective_s * (1.0 - sys_.collective_overlap)
    step = np.maximum(compute_s, memory_s) + exposed
    return PhaseGrid(g, compute_s, memory_s, collective_s, step, step,
                     toks, "piggyback", sys_)


# ---------------------------------------------------------------------------
# vectorized sweeps (twins of design_space.sweep_prefill / sweep_decode)


def sweep_prefill_vec(model: PerfLLM, isl: int,
                      sys_: SystemConfig = DEFAULT_SYSTEM,
                      batches: Optional[Sequence[int]] = None,
                      max_chips: Optional[int] = None,
                      mem_isl: Optional[int] = None) -> PhaseGrid:
    grid = build_grid(model, sys_, prefill=True, batches=batches,
                      max_chips=max_chips)
    fit = hbm_fits_vec(model, grid, mem_isl or isl, sys_)
    pg = prefill_perf_vec(model, grid.select(fit), isl, sys_)
    pg.grid_total = len(grid)
    return pg


def sweep_decode_vec(model: PerfLLM, kv_len: int,
                     sys_: SystemConfig = DEFAULT_SYSTEM,
                     batches: Optional[Sequence[int]] = None,
                     max_chips: Optional[int] = None,
                     max_ctx: Optional[int] = None) -> PhaseGrid:
    grid = build_grid(model, sys_, prefill=False, batches=batches,
                      max_chips=max_chips)
    fit = hbm_fits_vec(model, grid, max_ctx or kv_len, sys_)
    pg = decode_step_perf_vec(model, grid.select(fit), kv_len, sys_)
    pg.grid_total = len(grid)
    return pg


# ---------------------------------------------------------------------------
# vectorized rate matching (twin of rate_matching.dynamic_rate_match)


def matched_points_vec(model: PerfLLM, isl: int, osl: int,
                       pre_sys: SystemConfig, dec_sys: SystemConfig, *,
                       ftl_cutoff: float, ttl_targets: Sequence[float],
                       tolerance: float = 0.03,
                       max_chips: Optional[int] = None,
                       reuse_fraction: float = 0.0
                       ) -> List[RateMatchedPoint]:
    """Sweep both phases vectorized, then run Algorithms 1+2. Selections
    match ``dynamic_rate_match`` on scalar-swept points exactly: argmax
    semantics (first max wins) are identical, and only the winners are
    reified into ``RateMatchedPoint`` objects."""
    isl_eff = max(1, round(isl * (1.0 - reuse_fraction)))
    pre = sweep_prefill_vec(model, isl_eff, pre_sys, max_chips=max_chips,
                            mem_isl=isl)
    dec = sweep_decode_vec(model, isl + osl // 2, dec_sys,
                           max_chips=max_chips, max_ctx=isl + osl)
    return rate_match_vec(pre, dec, osl=osl, ftl_cutoff=ftl_cutoff,
                          ttl_targets=ttl_targets, tolerance=tolerance)


def _best_prefill_idx(pre: PhaseGrid, ftl_cutoff: float) -> Optional[int]:
    """Algorithm 1 on a grid. Scalar twin keeps strictly-greater tput while
    iterating in grid order — i.e. the *first* max among feasible points;
    ``np.argmax`` has the same first-max semantics."""
    feasible = pre.latency_s < ftl_cutoff
    if not feasible.any():
        return None
    tput = np.where(feasible, pre.tput_per_chip, 0.0)
    i = int(np.argmax(tput))
    if tput[i] <= 0.0:
        return None
    return i


def rate_match_vec(pre: PhaseGrid, dec: PhaseGrid, *, osl: int,
                   ftl_cutoff: float, ttl_targets: Sequence[float],
                   tolerance: float = 0.03, max_denominator: int = 64,
                   with_targets: bool = False):
    """Algorithms 1+2 over phase grids; one winner per feasible TTL
    target. ``with_targets=True`` returns ``[(ttl_target, point), ...]``
    (the sweep store keys records by target); default returns bare points
    like ``dynamic_rate_match``."""
    best_i = _best_prefill_idx(pre, ftl_cutoff)
    if best_i is None:
        return []
    G_pre = int(pre.grid.chips[best_i])
    pre_lat = float(pre.latency_s[best_i])
    pre_tput = float(pre.grid.batch[best_i]) / (pre_lat * G_pre)

    ttl = dec.latency_s
    G_dec = dec.grid.chips
    dec_tok_tput = dec.grid.batch / (ttl * G_dec)
    dec_req_tput = dec_tok_tput / max(osl - 1, 1)
    ratio = (G_dec * dec_req_tput) / (G_pre * pre_tput)

    # the integer ratio solve is inherently per-point (simplest-fraction
    # search), but it only depends on the decode point — not the TTL
    # target — so it runs once per point instead of once per (point,
    # target) as the scalar path does
    n = len(dec)
    n_pre = np.zeros(n, dtype=np.int64)
    n_dec = np.zeros(n, dtype=np.int64)
    alphas: List[Fraction] = []
    for j in range(n):
        a = _round_fraction(float(ratio[j]), tolerance, max_denominator)
        alphas.append(a)
        if a > 0:
            n_pre[j] = a.numerator * G_pre
            n_dec[j] = a.denominator * G_dec[j]
    valid = n_pre > 0
    req_rate = np.minimum(pre_tput * n_pre, dec_req_tput * n_dec)
    total = n_pre + n_dec
    overall = np.where(valid,
                       req_rate * (osl - 1) / np.maximum(total, 1), 0.0)

    out = []
    pre_pt = None
    for target in ttl_targets:
        eligible = valid & (ttl <= target)
        if not eligible.any():
            continue
        j = int(np.argmax(np.where(eligible, overall, -np.inf)))
        if pre_pt is None:
            pre_pt = pre.design_point(best_i)
        r = RateMatchedPoint(
            prefill=pre_pt, decode=dec.design_point(j), alpha=alphas[j],
            num_prefill_chips=int(n_pre[j]), num_decode_chips=int(n_dec[j]),
            overall_tput_per_chip=float(overall[j]),
            tps_per_user=1.0 / float(ttl[j]),
            ftl_s=pre_lat, osl=osl)
        out.append((target, r) if with_targets else r)
    return out
