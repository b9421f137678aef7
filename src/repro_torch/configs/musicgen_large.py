"""musicgen-large [audio]: decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf]. 48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192
vocab=2048 (EnCodec codebook). The EnCodec tokenizer is the stubbed frontend;
the backbone consumes code tokens directly (DESIGN.md / frontends.py).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="dense",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=64, remat=False, logits_chunk=32,
)
