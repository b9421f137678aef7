"""Analytical per-phase performance model (the paper's simulator, opened up).

The port's copy of ``repro.core.perf_model``, unchanged but for its import
of the port's ``core.hardware`` (whose chip table holds ``GPU_H100``).

The paper uses a proprietary GPU simulator; we replace it with a transparent
three-term roofline model per phase:

    compute_t    = FLOPs / (chips * peak * eff(tokens/chip))
    memory_t     = bytes_touched / (chips * HBM_bw)
    collective_t = collective_bytes / ICI_bw + n_ops * op_latency

    phase_t      = max(compute_t, memory_t)
                   + (1 - overlap) * collective_t       (overlap: §5.1)

It is deliberately napkin-grade — the paper presents *normalized* trends, and
every benchmark reproduces a trend, not an absolute number. All inputs/outputs
are plain python floats so the design-space sweeps (10^5-10^6 points) stay
fast and jax-free.

Supported phases / modes:
  - prefill (optionally chunked-pipeline-parallel: the paper's CPP, Fig 4-5)
  - decode  (token-by-token with a KV cache)
  - piggyback co-located step (decode batch + prefill chunk share a step;
    models the MLA chunk re-projection overhead from §4.1)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.hardware import SystemConfig, DEFAULT_SYSTEM


# ---------------------------------------------------------------------------
# Lightweight model description (decoupled from the executable ModelConfig so
# the paper's own study models — DeepSeek-R1 w/ MLA, Llama — are expressible)


@dataclasses.dataclass(frozen=True)
class PerfLLM:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    attention: str = "gqa"          # "gqa" | "mla" | "none" (rwkv) | "hybrid"
    mla_kv_rank: int = 512          # compressed kv dim (+rope 64) for MLA
    mla_rope_dim: int = 64
    # MoE
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    # numerics
    bytes_param: float = 2.0
    bytes_kv: float = 2.0
    bytes_act: float = 2.0
    sliding_window: int = 0         # hybrid/SWA effective attention span

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def params(self) -> float:
        D, L = self.d_model, self.num_layers
        n = 2 * self.vocab_size * D
        per = 0.0
        if self.attention == "mla":
            per += D * (self.mla_kv_rank + self.mla_rope_dim)      # kv down
            per += D * 1536 + 1536 * self.num_heads * self.dh      # q lora
            per += self.mla_kv_rank * self.num_heads * self.dh * 2  # k,v up
            per += self.num_heads * self.dh * D
        elif self.attention != "none":
            per += D * self.num_heads * self.dh
            per += 2 * D * self.num_kv_heads * self.dh
            per += self.num_heads * self.dh * D
        if self.is_moe:
            per += self.num_experts * 3 * D * self.d_ff_expert
            per += self.num_shared_experts * 3 * D * self.d_ff_expert
            per += D * self.num_experts
        else:
            per += 3 * D * self.d_ff
        return n + L * per

    def active_params(self) -> float:
        if not self.is_moe:
            return self.params()
        inactive = (self.num_layers * (self.num_experts - self.top_k)
                    * 3 * self.d_model * self.d_ff_expert)
        return self.params() - inactive

    def kv_bytes_per_token(self) -> float:
        """Eq 1/2 numerator term: per-token per-request KV-cache bytes."""
        if self.attention == "none":
            return 0.0
        if self.attention == "mla":
            per_layer = (self.mla_kv_rank + self.mla_rope_dim) * self.bytes_kv
        else:
            per_layer = 2 * self.num_kv_heads * self.dh * self.bytes_kv
        return self.num_layers * per_layer

    def attn_flops_per_token(self, kv_len: int) -> float:
        """Attention score+value FLOPs for one query token vs kv_len keys."""
        if self.attention == "none":
            # rwkv: O(1) state update per token ~ 2 * D * head_dim
            return 4.0 * self.num_layers * self.d_model * self.dh
        span = kv_len
        if self.sliding_window:
            span = min(kv_len, self.sliding_window)
        if self.attention == "mla":
            rank = self.mla_kv_rank + self.mla_rope_dim
            return 4.0 * self.num_layers * self.num_heads * rank * span
        return 4.0 * self.num_layers * self.num_heads * self.dh * span


@dataclasses.dataclass(frozen=True)
class Mapping:
    """One model-partitioning point (per pool: prefill or decode)."""
    chips: int = 1         # g: chips per model instance
    tp: int = 1            # attention/dense-FFN tensor parallel
    pp: int = 1            # pipeline stages
    dp_attn: int = 1       # attention data parallel inside the instance
    cpp_chunks: int = 1    # chunked pipeline parallelism (prefill only)

    @property
    def ep(self) -> int:
        """MoE expert parallel spans every chip of a stage (paper's 'EP in
        the NVLink domain')."""
        return max(1, self.chips // self.pp)

    def valid(self, model: PerfLLM, sys_: SystemConfig) -> bool:
        if self.tp * self.pp * self.dp_attn != self.chips:
            return False
        if self.chips > sys_.ici_domain:
            return False
        if self.pp > model.num_layers:
            return False
        if model.attention not in ("none",) and self.tp > model.num_heads:
            return False
        if model.is_moe and self.ep > model.num_experts:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class PhasePerf:
    compute_s: float
    memory_s: float
    collective_s: float
    latency_s: float          # end-to-end phase latency
    step_s: float             # per-iteration time (== latency for decode)
    tokens: float             # tokens processed per step
    chips: int

    @property
    def bound(self) -> str:
        m = max(self.compute_s, self.memory_s, self.collective_s)
        if m == self.compute_s:
            return "compute"
        if m == self.memory_s:
            return "memory"
        return "collective"


OP_LATENCY = 3e-6  # per-collective base latency on ICI (s)


def _eff(sys_: SystemConfig, tokens_per_chip: float) -> float:
    """MXU efficiency saturating in per-chip GEMM rows."""
    t = max(tokens_per_chip, 1e-9)
    return sys_.matmul_eff * t / (t + sys_.eff_knee_tokens)


def _weight_bytes_per_chip(model: PerfLLM, m: Mapping, batch_tokens: float
                           ) -> float:
    """Bytes of weights streamed from HBM in one step, per chip."""
    dense = model.params() - (model.num_layers * model.num_experts * 3
                              * model.d_model * model.d_ff_expert
                              if model.is_moe else 0.0)
    per_chip = dense * model.bytes_param / (m.tp * m.pp)
    if model.is_moe:
        # fraction of experts touched by batch_tokens routed tokens
        touched = min(1.0, batch_tokens * model.top_k / model.num_experts)
        expert_bytes = (model.num_layers * model.num_experts * 3
                        * model.d_model * model.d_ff_expert
                        * model.bytes_param)
        per_chip += expert_bytes * touched / (m.ep * m.pp)
    return per_chip


def kv_shard_chips(model: PerfLLM, m: Mapping) -> int:
    """Chips that hold *distinct* KV shards (paper §5.1: TP beyond the KV
    head count duplicates instead of sharding)."""
    if model.attention == "mla":
        kv_tp = 1          # MLA latent is a single logical head
    else:
        kv_tp = min(m.tp, model.num_kv_heads)
    return kv_tp * m.pp * m.dp_attn


def _expert_flops_per_token(model: PerfLLM) -> float:
    if not model.is_moe:
        return 0.0
    return (2.0 * model.num_layers
            * (model.top_k + model.num_shared_experts)
            * 3 * model.d_model * model.d_ff_expert)


def _compute_time(model: PerfLLM, m: Mapping, batch_seqs: float,
                  tokens: float, attn_flops: float,
                  sys_: SystemConfig) -> float:
    """Component-aware compute time.

    Experts spread over every chip of a stage (EP); attention + dense parts
    only parallelize over tp x pp x min(batch, dp_attn) — under EP-only
    mappings attention is *replicated* per DP rank, which is exactly why the
    paper's Fig-5 prefill needs CPP.
    """
    eff = _eff(sys_, tokens / max(m.dp_attn * m.pp, 1))
    peak = sys_.chip.flops_bf16 * eff
    expert = _expert_flops_per_token(model) * tokens
    linear = 2.0 * model.active_params() * tokens - expert
    par_att = m.tp * m.pp * max(1.0, min(batch_seqs, m.dp_attn))
    return expert / (m.chips * peak) + (linear + attn_flops) / (par_att * peak)


def decode_step_perf(model: PerfLLM, m: Mapping, batch: int, kv_len: int,
                     sys_: SystemConfig = DEFAULT_SYSTEM) -> PhasePerf:
    """One decode iteration: `batch` sequences, one token each."""
    g = m.chips
    b = batch
    attn_flops = model.attn_flops_per_token(kv_len) * b
    flops = 2.0 * model.active_params() * b + attn_flops

    w_bytes = _weight_bytes_per_chip(model, m, b)
    kv_total_bytes = b * kv_len * model.kv_bytes_per_token()
    kv_bytes = kv_total_bytes / kv_shard_chips(model, m)
    act_bytes = 8.0 * b * model.d_model * model.bytes_act * model.num_layers / (m.tp * m.pp)
    mem_bytes = w_bytes + kv_bytes + act_bytes

    compute_s = _compute_time(model, m, b, b, attn_flops, sys_)
    memory_s = mem_bytes / sys_.chip.hbm_bw

    coll_bytes = 0.0
    n_ops = 0
    b_local = b / m.dp_attn
    if m.tp > 1:
        coll_bytes += (2 * model.num_layers * 2.0 * b_local * model.d_model
                       * model.bytes_act * (m.tp - 1) / m.tp)
        n_ops += 2 * model.num_layers
    if model.is_moe and m.ep > 1:
        coll_bytes += (2 * model.num_layers * (b * model.top_k / m.ep)
                       * model.d_model * model.bytes_act * (m.ep - 1) / m.ep)
        n_ops += 2 * model.num_layers
    if m.pp > 1:
        coll_bytes += (m.pp - 1) * b_local * model.d_model * model.bytes_act / m.pp
        n_ops += m.pp - 1
    collective_s = coll_bytes / sys_.chip.ici_bw + n_ops * OP_LATENCY

    exposed_s = collective_s * (1.0 - sys_.collective_overlap)
    step_s = max(compute_s, memory_s) + exposed_s
    return PhasePerf(compute_s, memory_s, collective_s, step_s, step_s,
                     float(b), g)


def prefill_perf(model: PerfLLM, m: Mapping, batch: int, isl: int,
                 sys_: SystemConfig = DEFAULT_SYSTEM) -> PhasePerf:
    """Process `batch` prompts of isl tokens; CPP chunks pipeline across pp
    stages (Fig 4). Returns latency = FTL for the batch."""
    g = m.chips
    tokens = float(batch) * isl
    n_chunks = max(m.cpp_chunks, 1)
    chunk_len = isl / n_chunks

    # per-chunk compute with growing context
    attn_flops = 0.0
    for i in range(n_chunks):
        ctx = (i + 0.5) * chunk_len
        attn_flops += (model.attn_flops_per_token(int(ctx)) * chunk_len
                       * batch)

    w_bytes = _weight_bytes_per_chip(model, m, tokens)
    act_bytes = (8.0 * tokens * model.d_model * model.bytes_act
                 * model.num_layers / (m.tp * m.pp))
    kv_bytes = tokens * model.kv_bytes_per_token() / kv_shard_chips(model, m)
    mem_bytes = w_bytes * n_chunks + act_bytes + kv_bytes

    compute_s = _compute_time(model, m, batch, tokens, attn_flops, sys_)
    memory_s = mem_bytes / sys_.chip.hbm_bw

    coll_bytes = 0.0
    n_ops = 0
    tokens_local = tokens / m.dp_attn
    if m.tp > 1:
        coll_bytes += (2 * model.num_layers * 2.0 * tokens_local
                       * model.d_model * model.bytes_act * (m.tp - 1) / m.tp)
        n_ops += 2 * model.num_layers * n_chunks
    if model.is_moe and m.ep > 1:
        coll_bytes += (2 * model.num_layers * (tokens * model.top_k / m.ep)
                       * model.d_model * model.bytes_act * (m.ep - 1) / m.ep)
        n_ops += 2 * model.num_layers * n_chunks
    if m.pp > 1:
        coll_bytes += (m.pp - 1) * tokens_local * model.d_model * model.bytes_act / m.pp
        n_ops += (m.pp - 1) * n_chunks
    collective_s = coll_bytes / sys_.chip.ici_bw + n_ops * OP_LATENCY

    exposed_s = collective_s * (1.0 - sys_.collective_overlap)
    work_s = max(compute_s, memory_s) + exposed_s
    # CPP pipelining: n_chunks*batch microbatches across pp stages
    micro = n_chunks * batch
    latency = work_s * (1.0 + (m.pp - 1) / micro)
    return PhasePerf(compute_s, memory_s, collective_s, latency, work_s,
                     tokens, g)


def piggyback_step_perf(model: PerfLLM, m: Mapping, decode_batch: int,
                        kv_len: int, chunk_tokens: int, chunk_ctx: int,
                        sys_: SystemConfig = DEFAULT_SYSTEM,
                        mla_chunk_cache: bool = False) -> PhasePerf:
    """Co-located piggybacked step: decode_batch decode tokens + one prefill
    chunk of chunk_tokens (context already processed: chunk_ctx).

    Captures the paper's §4.1 observation: with MLA, each chunk re-projects
    the *whole* cached context through the kv up-projection unless the
    up-projected KV is cached (mla_chunk_cache=True).
    """
    g = m.chips
    toks = decode_batch + chunk_tokens
    attn_flops = model.attn_flops_per_token(kv_len) * decode_batch
    attn_flops += model.attn_flops_per_token(
        chunk_ctx + chunk_tokens // 2) * chunk_tokens
    if model.attention == "mla" and chunk_tokens > 0 and not mla_chunk_cache:
        # redundant up/down re-projection of cached context per chunk
        reproj = (2.0 * model.num_layers * chunk_ctx
                  * model.mla_kv_rank * model.num_heads * model.dh * 2)
        attn_flops += reproj

    w_bytes = _weight_bytes_per_chip(model, m, toks)
    kv_total_bytes = ((decode_batch * kv_len + chunk_ctx)
                      * model.kv_bytes_per_token())
    kv_bytes = kv_total_bytes / kv_shard_chips(model, m)
    act_bytes = (8.0 * toks * model.d_model * model.bytes_act
                 * model.num_layers / (m.tp * m.pp))
    mem_bytes = w_bytes + kv_bytes + act_bytes

    compute_s = _compute_time(model, m, decode_batch + 1, toks, attn_flops,
                              sys_)
    memory_s = mem_bytes / sys_.chip.hbm_bw

    coll_bytes = 0.0
    n_ops = 0
    if m.tp > 1:
        coll_bytes += (2 * model.num_layers * 2.0 * (toks / m.dp_attn)
                       * model.d_model * model.bytes_act * (m.tp - 1) / m.tp)
        n_ops += 2 * model.num_layers
    if model.is_moe and m.ep > 1:
        coll_bytes += (2 * model.num_layers * (toks * model.top_k / m.ep)
                       * model.d_model * model.bytes_act * (m.ep - 1) / m.ep)
        n_ops += 2 * model.num_layers
    collective_s = coll_bytes / sys_.chip.ici_bw + n_ops * OP_LATENCY

    exposed_s = collective_s * (1.0 - sys_.collective_overlap)
    step_s = max(compute_s, memory_s) + exposed_s
    return PhasePerf(compute_s, memory_s, collective_s, step_s, step_s,
                     float(toks), g)


def hbm_fits(model: PerfLLM, m: Mapping, batch: int, max_ctx: int,
             sys_: SystemConfig = DEFAULT_SYSTEM) -> bool:
    """Weights + KV cache must fit HBM (Fig 3: 'KV cache and weights are
    hosted in HBM memory and capacity constraints are accounted for')."""
    # dense part shards over tp*pp; expert part over ep*pp
    dense = model.params() - (model.num_layers * model.num_experts * 3
                              * model.d_model * model.d_ff_expert
                              if model.is_moe else 0.0)
    w = dense * model.bytes_param / (m.tp * m.pp)
    if model.is_moe:
        w += (model.num_layers * model.num_experts * 3 * model.d_model
              * model.d_ff_expert * model.bytes_param) / (m.ep * m.pp)
    kv = (batch * max_ctx * model.kv_bytes_per_token()
          / kv_shard_chips(model, m))
    return (w + kv) * 1.1 <= sys_.chip.hbm_cap
