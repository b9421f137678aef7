"""Model configuration: the port's mirror of ``repro.models.config``.

Same fields, defaults and properties as the reference, so a config built
here describes exactly the model the JAX package builds. Where the
reference has ``jdtype`` (a jnp dtype) the mirror has ``tdtype`` (a torch
dtype).

The port adds settings the reference has no model for (Jamba's
interleaved layers, a Mamba-1 mixer, a router's unrenormalised gates and
the experts one card holds of an expert-parallel deployment). They are
init-only arguments (``dataclasses.InitVar``), kept as attributes but not
as dataclass fields, so that ``dataclasses.asdict`` of every configuration
is the reference's; equality, hashing and ``replace`` take them in, and
each defaults to what every other configuration means.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _port_dataclass(*names: str):
    """A frozen dataclass whose init-only settings ``names``
    (``PORT_ONLY``) are kept as attributes, with equality, a hash and
    ``replace`` that take them in."""
    def wrap(cls):
        def __post_init__(self, *values):
            for name, v in zip(names, values):
                object.__setattr__(self, name, v)

        def key(self):
            return (tuple(getattr(self, f.name)
                          for f in dataclasses.fields(self))
                    + tuple(getattr(self, n) for n in names))

        def __eq__(self, other):
            if other.__class__ is not self.__class__:
                return NotImplemented
            return key(self) == key(other)

        def replace(self, **kw):
            for n in names:
                kw.setdefault(n, getattr(self, n))
            return dataclasses.replace(self, **kw)

        cls.__post_init__ = __post_init__
        cls = dataclasses.dataclass(frozen=True)(cls)
        cls.__eq__ = __eq__
        cls.__hash__ = lambda self: hash(key(self))
        cls.replace = replace
        cls.PORT_ONLY = names
        return cls
    return wrap


@_port_dataclass("router_experts", "first_expert", "renormalize")
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
    # --- port-only (init-only; see the module's docstring) ---
    # the router's width: tokens route over this many experts, of which
    # this card holds num_experts, from first_expert on (one card of an
    # expert-parallel deployment; 0: the router's width is num_experts)
    router_experts: dataclasses.InitVar[int] = 0
    first_expert: dataclasses.InitVar[int] = 0
    renormalize: dataclasses.InitVar[bool] = True   # top-k gates sum to 1

    @property
    def routed(self) -> int:
        """The experts a token is routed over (the router's outputs)."""
        return self.router_experts or self.num_experts


@_port_dataclass("attn_layer_period", "attn_layer_offset",
                 "expert_layer_period", "expert_layer_offset", "rope",
                 "ssm_dt_rank", "ssm_conv_bias")
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
    block: str = "attn"            # attn | rwkv | hybrid | jamba
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
    # --- port-only (init-only; see the module's docstring) ---
    # the jamba block: attention in the layers i with i % attn_layer_period
    # == attn_layer_offset, a Mamba-1 mixer (models/ssm.py) in the others;
    # with ``moe``, the MoE FFN in the layers i % expert_layer_period ==
    # expert_layer_offset, a dense SwiGLU in the others (every layer at
    # the defaults)
    attn_layer_period: dataclasses.InitVar[int] = 1
    attn_layer_offset: dataclasses.InitVar[int] = 0
    expert_layer_period: dataclasses.InitVar[int] = 1
    expert_layer_offset: dataclasses.InitVar[int] = 0
    rope: dataclasses.InitVar[bool] = True     # False: no position encoding
    ssm_dt_rank: dataclasses.InitVar[int] = 0  # Mamba-1's dt projection rank
    ssm_conv_bias: dataclasses.InitVar[bool] = False

    def mixer(self, i: int) -> str:
        """Layer i's kind (``transformer.MIXERS``): the block's, but a
        jamba model's ``"attn"`` in its pattern and ``"mamba"`` else."""
        if self.block != "jamba":
            return self.block
        if i % self.attn_layer_period == self.attn_layer_offset:
            return "attn"
        return "mamba"

    def attends(self, i: int) -> bool:
        """Layer i has attention: every layer of the attn and hybrid
        blocks, the pattern's layers of a jamba model, none of RWKV's."""
        return self.mixer(i) in ("attn", "hybrid")

    def has_experts(self, i: int) -> bool:
        """Layer i's FFN is the MoE FFN."""
        return (self.moe is not None
                and i % self.expert_layer_period == self.expert_layer_offset)

    @property
    def attn_layer_ids(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.num_layers) if self.attends(i))

    @property
    def mamba_layer_ids(self) -> Tuple[int, ...]:
        """A jamba model's Mamba-1 layers (none in any other block)."""
        return tuple(i for i in range(self.num_layers)
                     if self.mixer(i) == "mamba")

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
        return (self.block in ("attn", "hybrid", "jamba") and g > 0
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
        if self.block == "jamba":
            return self._jamba_param_count()
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

    def _jamba_param_count(self) -> int:
        """A jamba model's, layer by layer: attention or the Mamba-1
        mixer, and the MoE FFN (the experts held) or the dense SwiGLU."""
        D, dh = self.d_model, self.dh
        di, ds, R = self.ssm_expand * D, self.ssm_state, self.ssm_dt_rank
        n = self.vocab_size * D * (1 if self.tie_embeddings else 2) + D
        attn = D * (self.num_heads + 2 * self.num_kv_heads) * dh \
            + self.num_heads * dh * D
        mamba = (D * 2 * di + di * self.ssm_conv + di * (R + 2 * ds)
                 + R * di + di * ds + di * D + R + 2 * ds
                 + di * (3 if self.ssm_conv_bias else 2))
        for i in range(self.num_layers):
            n += 2 * D + (attn if self.attends(i) else mamba)
            if self.has_experts(i):
                m = self.moe
                n += D * m.routed + (m.num_experts + m.num_shared_experts) \
                    * 3 * D * m.d_ff_expert
            else:
                n += 3 * D * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        total = self.param_count()
        L = sum(self.has_experts(i) for i in range(self.num_layers))
        all_expert = L * m.num_experts * 3 * self.d_model * m.d_ff_expert
        active_expert = L * (m.top_k + m.num_shared_experts) * (
            3 * self.d_model * m.d_ff_expert)
        return total - all_expert + active_expert

    def kv_bytes_per_token(self, bytes_element: int = 2) -> int:
        """KV-cache bytes per token (for Eq 1/2 transfer analysis): the
        attention layers'."""
        if self.block == "rwkv":
            return 0  # O(1) state, not per-token
        per_layer = 2 * self.num_kv_heads * self.dh * bytes_element
        return len(self.attn_layer_ids) * per_layer



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
