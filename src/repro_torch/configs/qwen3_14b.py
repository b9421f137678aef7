"""qwen3-14b [dense]: qk_norm, GQA. [hf:Qwen/Qwen3 family]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab_size=151936, rope_theta=1_000_000.0,
    qk_norm=True,
)

SMOKE = ModelConfig(
    name="qwen3-14b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=128, remat=False, logits_chunk=32,
    qk_norm=True,
)
