"""phi3-medium-14b [dense]: RoPE SwiGLU GQA. [arXiv:2404.14219]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=100352, rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=160, vocab_size=96, remat=False, logits_chunk=32,
)
