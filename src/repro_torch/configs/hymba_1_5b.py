"""hymba-1.5b [hybrid]: parallel attn+mamba heads. [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 ssm_state=16.
As the reference's configuration: every attention layer is a sliding
window of 1024 over a ring-buffer KV cache (Hymba's 3 global-attention
layers are dropped), beside a selective-SSM branch that carries the
long-range state.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", block="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001, rope_theta=10_000.0,
    sliding_window=1024, ssm_state=16, ssm_conv=4, ssm_expand=1,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid", block="hybrid",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=96, remat=False, logits_chunk=32,
    sliding_window=16, ssm_state=4,
)
