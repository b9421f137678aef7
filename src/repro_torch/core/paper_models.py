"""PerfLLM descriptions of the paper's study models + assigned-arch bridge.

The port's copy of ``repro.core.paper_models``. It differs in one place:
``get_perf_model`` resolves an architecture id through the port's own
registry (``repro_torch.configs``), which holds the architectures the port
serves, so the other ids of the reference's registry are unknown here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.perf_model import PerfLLM

# --- the paper's own case studies -----------------------------------------

DEEPSEEK_R1 = PerfLLM(
    name="deepseek-r1", num_layers=61, d_model=7168, num_heads=128,
    num_kv_heads=128, head_dim=128, d_ff=18432, vocab_size=129280,
    attention="mla", mla_kv_rank=512, mla_rope_dim=64,
    num_experts=256, top_k=8, d_ff_expert=2048, num_shared_experts=1)

LLAMA31_8B = PerfLLM(
    name="llama-3.1-8b", num_layers=32, d_model=4096, num_heads=32,
    num_kv_heads=8, d_ff=14336, vocab_size=128256)

LLAMA31_70B = PerfLLM(
    name="llama-3.1-70b", num_layers=80, d_model=8192, num_heads=64,
    num_kv_heads=8, d_ff=28672, vocab_size=128256)

LLAMA31_405B = PerfLLM(
    name="llama-3.1-405b", num_layers=126, d_model=16384, num_heads=128,
    num_kv_heads=8, d_ff=53248, vocab_size=128256)


PAPER_MODELS: Dict[str, PerfLLM] = {
    m.name: m for m in (DEEPSEEK_R1, LLAMA31_8B, LLAMA31_70B, LLAMA31_405B)
}


def get_perf_model(name: str) -> PerfLLM:
    """Resolve a sweep-spec model name: a paper study model, or any
    assigned-arch id from ``repro_torch.configs`` (bridged full-size
    config). The configs import is lazy, as in the reference."""
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    from repro_torch.configs import ARCH_IDS, get_config
    if name in ARCH_IDS:
        return perf_llm_from_config(get_config(name))
    known = sorted(PAPER_MODELS) + sorted(ARCH_IDS)
    raise KeyError(f"unknown model {name!r}; known: {known}")


def perf_llm_from_config(cfg: "ModelConfig") -> PerfLLM:
    """Bridge an executable assigned-arch config into the analytic model."""
    moe = cfg.moe
    return PerfLLM(
        name=cfg.name,
        num_layers=cfg.num_layers,
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.dh,
        d_ff=cfg.d_ff,
        vocab_size=cfg.vocab_size,
        attention=("none" if cfg.block == "rwkv"
                   else "hybrid" if cfg.block == "hybrid" else "gqa"),
        num_experts=moe.num_experts if moe else 0,
        top_k=moe.top_k if moe else 0,
        d_ff_expert=moe.d_ff_expert if moe else 0,
        num_shared_experts=moe.num_shared_experts if moe else 0,
        sliding_window=cfg.sliding_window,
    )
