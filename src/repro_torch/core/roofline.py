"""Per-cell roofline terms: the port's copy of ``repro.core.roofline``.

The closed forms are the reference's, unchanged, so ``RooflineTerms``
agree field for field (``tests/test_torch_roofline.py`` holds them with
``==``). They price the reference's chip, ``TPU_V5E`` from the port's
``core/hardware.py``: the seconds below are that model's, kept for parity
with the reference's dry run, and are no measurement of any card.

    compute_s    = HLO_FLOPs / (chips * 197e12)
    memory_s     = HBM_bytes_per_chip / 819e9
    collective_s = collective_bytes_per_chip / (4 * 50e9)

HLO_FLOPs charges everything the reference's compiled program executes:
remat re-forward, flash diagonal-block masked waste, head padding
(H % model_axis != 0), SWA 2-chunk overlap. MODEL_FLOPS = 6*N_active*T
(train) / 2*N_active*T (inference) excludes all of it; the ratio exposes
the waste. ``cfg`` and ``shape`` are read duck-typed (any object with the
``ModelConfig`` / ``ShapeConfig`` attributes), as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, TYPE_CHECKING

from repro_torch.core.hardware import TPU_V5E

if TYPE_CHECKING:       # annotation-only: the closed forms read cfg/shape
    from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class MeshDesc:
    name: str
    total: int
    data: int       # product of (pod, data) axes
    model: int


SINGLE_POD = MeshDesc("16x16", 256, 16, 16)
MULTI_POD = MeshDesc("2x16x16", 512, 32, 16)


@dataclasses.dataclass(frozen=True)
class Overrides:
    """Hillclimb knobs (EXPERIMENTS.md §Perf iteration levers)."""
    remat: bool = True            # charge remat re-forward in train flops
    pad_heads: bool = True        # charge GSPMD head padding
    attn_block: int = 1024        # flash q/kv block (diag waste = S*block/2)
    moe_combine_fp32: bool = True  # MoE combine psum in fp32 (vs bf16)
    fsdp_passes: int = 3          # weight all-gathers: fwd + remat + bwd
    swa_span_factor: float = 2.0  # 2-chunk SWA executes 2W span per token
    # decode-serving levers
    kv_bytes_elem: float = 2.0    # 1.0+2/dh with int8 KV quant
    decode_grouped: bool = False  # grouped GQA decode: no expanded-KV temp
    serve_fsdp: bool = False      # weight-gathered serving (per-step AG!)
    expert_touch_frac: float = -1.0  # override MoE touched fraction


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # executed, whole step
    model_flops: float            # useful, whole step
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self, chip=TPU_V5E):
        self.compute_s = self.hlo_flops / (self.chips * chip.flops_bf16)
        self.memory_s = self.hbm_bytes_per_chip / chip.hbm_bw
        self.collective_s = self.collective_bytes_per_chip / chip.ici_bw
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def roofline_fraction(self) -> float:
        """model-FLOPs utilization of the step vs the pure-compute roofline
        (the §Perf score: 1.0 = useful FLOPs at peak, zero waste/stall)."""
        ideal = self.model_flops / (self.chips * TPU_V5E.flops_bf16)
        return ideal / max(self.step_s, 1e-30)

    @property
    def flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)


def _pad(n: int, m: int) -> int:
    return math.ceil(n / m) * m


def cell_roofline(cfg: ModelConfig, shape: ShapeConfig,
                  mesh: MeshDesc = SINGLE_POD,
                  ov: Overrides = Overrides()) -> RooflineTerms:
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    bpe = 2.0
    chips, dp, tp = mesh.total, mesh.data, mesh.model
    N_active = cfg.active_param_count()
    N_total = cfg.param_count()
    # embedding gather costs no FLOPs; lm_head matmul does
    N_linear = N_active - V * D * (1 if cfg.tie_embeddings else 2) + V * D

    Hp = _pad(H, tp) if (ov.pad_heads and cfg.block != "rwkv") else H
    pad_extra = 2.0 * L * 2 * D * (Hp - H) * dh     # wq+wo on padded heads

    A = max(cfg.grad_accum, 1) if shape.kind == "train" else 1
    F_eff = (cfg.moe.top_k * cfg.moe.d_ff_expert
             + cfg.moe.num_shared_experts * cfg.moe.d_ff_expert
             if cfg.moe else cfg.d_ff)

    # ---------------- FLOPs (fwd) ----------------
    def attn_flops_fwd(tokens: float) -> float:
        if cfg.block == "rwkv":
            N = D // H
            Lc = 32
            per_tok = H * (7.0 * Lc * N + 4.0 * N * N)
            return L * tokens * per_tok
        if shape.kind == "decode":
            span = min(S, cfg.sliding_window) if cfg.sliding_window else S
            return 4.0 * L * Hp * dh * span * B
        if cfg.sliding_window:
            span = ov.swa_span_factor * cfg.sliding_window
            return 4.0 * L * Hp * dh * span * tokens
        # causal flash: S^2/2 useful + diagonal-block masked half-waste
        blk = min(ov.attn_block, S)
        per_seq = S * S / 2.0 + S * blk / 2.0
        return 4.0 * L * Hp * dh * per_seq * (tokens / S)

    def ssm_flops_fwd(tokens: float) -> float:
        if cfg.block != "hybrid":
            return 0.0
        di = cfg.ssm_expand * D
        return L * tokens * (10.0 * di * cfg.ssm_state
                             + 2.0 * cfg.ssm_conv * di)

    if shape.kind == "train":
        fwd = (2.0 * N_linear * T + pad_extra * T
               + attn_flops_fwd(T) + ssm_flops_fwd(T))
        remat = fwd if (cfg.remat and ov.remat) else 0.0
        hlo_flops = 3.0 * fwd + remat            # fwd + 2x bwd (+ remat)
        model_flops = 6.0 * N_active * T
        step_tokens = T
    elif shape.kind == "prefill":
        # lm_head runs only on the last token of each sequence
        head = cfg.padded_vocab * D
        hlo_flops = (2.0 * (N_linear - head) * T + 2.0 * head * B
                     + pad_extra * T + attn_flops_fwd(T) + ssm_flops_fwd(T))
        model_flops = 2.0 * N_active * T
        step_tokens = T
    else:  # decode: one token per sequence
        hlo_flops = (2.0 * N_linear * B + pad_extra * B
                     + attn_flops_fwd(B) + ssm_flops_fwd(B))
        model_flops = 2.0 * N_active * B
        step_tokens = B

    # ---------------- HBM bytes per chip ----------------
    if shape.kind == "train":
        passes = ov.fsdp_passes if (cfg.remat and ov.remat) else 2
        w_stream = N_total * bpe * passes * A / chips
        g_accum = (N_total * 4.0 * 2 * A / chips) if A > 1 else \
            (N_total * 4.0 / chips)
        opt = (N_total * 24.0 / chips if cfg.optimizer == "adamw"
               else N_total * 5.0 / chips)
        acts = (8.0 * D + 4.0 * F_eff) * T * bpe * L / chips
        ce = 2.0 * T * V * 4.0 / chips * (2 if cfg.remat else 1)
        hbm = w_stream + g_accum + opt + acts + ce
    elif shape.kind == "prefill":
        w_stream = N_total * bpe / chips
        acts = (6.0 * D + 2.0 * F_eff) * T * bpe * L / chips
        kv_write = T * cfg.kv_bytes_per_token() / chips
        # flash streams K/V once per q block
        if cfg.block == "attn" and not cfg.sliding_window:
            rereads = max(S // ov.attn_block, 1)
            kv_reread = (T * 2 * Hkv * dh * bpe * L / 2) * rereads / chips
        else:
            kv_reread = 0.0
        hbm = w_stream + acts + kv_write + kv_reread
    else:
        if cfg.moe is not None:
            touched_frac = min(1.0, B * cfg.moe.top_k / cfg.moe.num_experts)
            if ov.expert_touch_frac >= 0:
                touched_frac = ov.expert_touch_frac
            expert_bytes = (L * cfg.moe.num_experts * 3 * D
                            * cfg.moe.d_ff_expert * bpe)
            w_stream = ((N_total * bpe - expert_bytes)
                        + expert_bytes * touched_frac) / chips
        else:
            w_stream = N_total * bpe / chips
        if cfg.block == "rwkv":
            N = D // H
            kv_read = L * B * H * N * N * 4.0 * 2 / chips   # state r+w fp32
        else:
            kv_cap = min(S, cfg.sliding_window) if cfg.sliding_window else S
            kv_elem_ratio = ov.kv_bytes_elem / 2.0
            kv_read = (B * kv_cap * cfg.kv_bytes_per_token() * kv_elem_ratio
                       / chips)
            if not ov.decode_grouped:
                # expanded-KV temp: write+read at bf16 over padded q heads
                kv_read += (B * kv_cap * cfg.kv_bytes_per_token() / chips
                            * 2.0 * Hp / max(Hkv, 1))
            if cfg.block == "hybrid":
                di = cfg.ssm_expand * D
                kv_read += L * B * di * cfg.ssm_state * 4.0 * 2 / chips
        acts = 6.0 * B * D * bpe * L / chips
        hbm = w_stream + kv_read + acts + B * V * 4.0 / chips
        if ov.serve_fsdp:
            # weight-gathered serving: gathered weights written + read
            hbm += 2.0 * N_total * bpe * (dp - 1) / dp / tp
    # ---------------- collective bytes per chip ----------------
    micro_tokens = step_tokens / A
    tokens_local = micro_tokens / dp if step_tokens >= dp else micro_tokens
    rs = 2.0 * (tp - 1) / tp                     # ring AR per-chip factor
    if cfg.block == "rwkv":
        per_layer = 2 * tokens_local * D * bpe * rs
    elif cfg.moe is not None:
        psum_b = 4.0 if ov.moe_combine_fp32 else bpe
        per_layer = (tokens_local * D * bpe * rs          # attn AR
                     + tokens_local * D * psum_b * rs)    # moe combine psum
    else:
        per_layer = 2 * tokens_local * D * bpe * rs
    act_coll = per_layer * L
    act_coll += tokens_local * D * bpe * rs              # embed gather psum
    if shape.kind == "train":
        mult = 3.0 if (cfg.remat and ov.remat) else 2.0  # fwd(+remat)+bwd
        act_coll *= mult * A
        fsdp_ag = (N_total * bpe * (dp - 1) / dp / tp
                   * (ov.fsdp_passes if cfg.remat else 2) * 1.0)
        fsdp_rs = N_total * 4.0 * (dp - 1) / dp / tp
        coll = act_coll + fsdp_ag + fsdp_rs
    else:
        coll = act_coll
        if ov.serve_fsdp:
            coll += N_total * bpe * (dp - 1) / dp / tp   # per-step weight AG

    rt = RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=mesh.name, chips=chips,
        hlo_flops=hlo_flops, model_flops=model_flops,
        hbm_bytes_per_chip=hbm, collective_bytes_per_chip=coll)
    return rt.finalize()
