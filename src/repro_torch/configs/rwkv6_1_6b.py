"""rwkv6-1.6b [ssm]: Finch — data-dependent decay, attention-free.

[arXiv:2404.05892]. 24L d_model=2048 d_ff=7168 (channel-mix 3.5x) vocab=65536.
Head size 64 -> 32 WKV heads. Decode state is O(1) per request: per layer
an fp32 WKV state [32, 64, 64] and two token-shift rows of d_model.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", block="rwkv",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536,
)

SMOKE = ModelConfig(
    name="rwkv6-1.6b-smoke", family="ssm", block="rwkv",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=224, vocab_size=96, remat=False, logits_chunk=32,
)
