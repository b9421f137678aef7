"""Model configuration: the port's mirror of ``repro.models.config``.

Same fields, defaults and properties as the reference, so a config built
here describes exactly the model the JAX package builds. Where the
reference has ``jdtype`` (a jnp dtype) the mirror has ``tdtype`` (a torch
dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # Minimum per-expert capacity (slots); guards tiny decode batches against
    # routing skew. Effective capacity = min(T, max(cf*T*k/E, min_capacity)).
    min_capacity: int = 8
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- attention options ---
    qkv_bias: bool = False         # qwen2.5
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 = full causal; >0 = SWA (hymba)
    # --- block composition ---
    block: str = "attn"            # attn | rwkv | hybrid
    moe: Optional[MoEConfig] = None
    # --- SSM (hybrid / mamba branch) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 1
    # --- frontend stubs ---
    frontend: Optional[str] = None  # None | "audio" | "vision"
    vision_patches: int = 0         # llava: number of anyres patch embeddings
    vision_dim: int = 1024
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    logits_chunk: int = 1024        # seq-chunked CE to bound logits memory
    # --- sharding-driven padding (semantics-exact, masked; DESIGN.md §5) ---
    pad_heads_to: int = 0           # pad q-head count to this multiple
    vocab_pad: int = 0              # extra (masked) vocab rows for sharding
    # --- serving-perf knobs (EXPERIMENTS.md §Perf levers) ---
    kv_quant: bool = False          # int8 KV cache w/ per-token-head scales
    moe_combine_fp32: bool = True   # MoE combine psum precision
    moe_expert_tp: bool = False     # shard expert d_ff over the data axis
    #     (weight-resident MoE decode: no per-step FSDP all-gather)
    grouped_decode: bool = True     # GQA decode w/o materializing expanded KV
    # --- training ---
    optimizer: str = "adamw"        # adamw | adafactor (factored, for >=100B)
    remat: bool = True
    grad_accum: int = 1             # microbatch accumulation steps
    tie_embeddings: bool = False

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_group(self) -> int:
        return self.num_heads // self.num_kv_heads if self.num_kv_heads else 0

    @property
    def padded_heads(self) -> int:
        """q-head count padded to a shardable multiple; padded heads are
        masked out of the output projection (exact semantics, wasted FLOPs
        charged in the roofline)."""
        if not self.pad_heads_to:
            return self.num_heads
        import math as _m
        return _m.ceil(self.num_heads / self.pad_heads_to) * self.pad_heads_to

    @property
    def padded_vocab(self) -> int:
        return self.vocab_size + self.vocab_pad

    @property
    def padded_kv_heads(self) -> int:
        """KV heads padded so padded q heads group evenly (enables the
        grouped decode-attention path). Only grows when Hp % q_group == 0."""
        Hp = self.padded_heads
        g = self.q_group
        if Hp != self.num_heads and g and Hp % g == 0:
            return Hp // g
        return self.num_kv_heads

    @property
    def can_group_decode(self) -> bool:
        g = self.q_group
        return (self.block in ("attn", "hybrid") and g > 0
                and self.padded_heads % g == 0
                and self.padded_heads // g == self.padded_kv_heads)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_attention_free(self) -> bool:
        return self.block == "rwkv"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(window) / O(1) per token (long_500k ok)."""
        return self.block in ("rwkv", "hybrid")

    def param_count(self) -> int:
        """Total parameter count (analytic, matches init)."""
        D, dh, L = self.d_model, self.dh, self.num_layers
        n = self.vocab_size * D                              # embed
        if not self.tie_embeddings:
            n += D * self.vocab_size                         # lm_head
        n += D                                               # final norm
        per_layer = 0
        if self.block in ("attn", "hybrid"):
            per_layer += D * self.num_heads * dh             # wq
            per_layer += 2 * D * self.num_kv_heads * dh      # wk, wv
            per_layer += self.num_heads * dh * D             # wo
            if self.qkv_bias:
                per_layer += (self.num_heads + 2 * self.num_kv_heads) * dh
            if self.qk_norm:
                per_layer += 2 * dh
            per_layer += D                                   # attn norm
        if self.block == "hybrid":
            di = self.ssm_expand * D
            per_layer += D * 2 * di                          # in_proj (x, z)
            per_layer += di * self.ssm_conv                  # conv
            per_layer += di * (2 * self.ssm_state + 1)       # B, C, dt proj
            per_layer += di * 2                              # A_log, D skip
            per_layer += di * D                              # out_proj
        if self.block == "rwkv":
            # time-mix: r,k,v,g,o + decay lora + u; channel-mix: rk, kv, vk
            per_layer += 5 * D * D + 2 * D * 64 + 64 * D + 2 * D
            per_layer += D * int(3.5 * D) * 2 + D * D        # channel mix
            per_layer += 2 * D                               # two norms
        if self.moe is not None:
            m = self.moe
            per_layer += D * m.num_experts                   # router
            per_layer += m.num_experts * 3 * D * m.d_ff_expert
            per_layer += m.num_shared_experts * 3 * D * m.d_ff_expert
            per_layer += D                                   # ffn norm
        elif self.block != "rwkv":
            per_layer += 3 * D * self.d_ff                   # swiglu
            per_layer += D                                   # ffn norm
        return n + L * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        total = self.param_count()
        all_expert = self.num_layers * m.num_experts * 3 * self.d_model * m.d_ff_expert
        active_expert = self.num_layers * (m.top_k + m.num_shared_experts) * (
            3 * self.d_model * m.d_ff_expert)
        return total - all_expert + active_expert

    def kv_bytes_per_token(self, bytes_element: int = 2) -> int:
        """KV-cache bytes per token (for Eq 1/2 transfer analysis)."""
        if self.block == "rwkv":
            return 0  # O(1) state, not per-token
        per_layer = 2 * self.num_kv_heads * self.dh * bytes_element
        return self.num_layers * per_layer

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
