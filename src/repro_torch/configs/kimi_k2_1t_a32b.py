"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8.

[arXiv:2501.kimi2 paper-table]. 61L d_model=7168 64H (GQA kv=8, head_dim=128)
d_ff_expert=2048 vocab=163840, +1 shared expert. Trains with Adafactor +
FSDP + grad accumulation (1T params; see DESIGN.md §8).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=2048, vocab_size=163840, rope_theta=50_000.0,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1),
    optimizer="adafactor", grad_accum=8, logits_chunk=512,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=32, vocab_size=128, remat=False, logits_chunk=32,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                  num_shared_experts=1, capacity_factor=2.0),
    optimizer="adafactor",
)
