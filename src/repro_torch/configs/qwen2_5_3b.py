"""qwen2.5-3b [dense]: GQA with QKV bias. [hf:Qwen/Qwen2.5 family]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, rope_theta=1_000_000.0,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-3b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=160, vocab_size=128, remat=False, logits_chunk=32,
    qkv_bias=True,
)
