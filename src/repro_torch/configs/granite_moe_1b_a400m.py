"""granite-moe-1b-a400m [moe]: 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base]. 24L d_model=1024 16H (GQA kv=8)
d_ff_expert=512 vocab=49155.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, rope_theta=10_000.0,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512),
    # 49155 doesn't divide the 16-way model axis; 13 masked pad rows make the
    # embedding/lm_head shardable (padded logits forced to -inf).
    vocab_pad=13,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=32, vocab_size=96, remat=False, logits_chunk=32,
    moe=MoEConfig(num_experts=8, top_k=4, d_ff_expert=32,
                  capacity_factor=2.0),
)
