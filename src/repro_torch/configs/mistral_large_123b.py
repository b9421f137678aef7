"""mistral-large-123b [dense]. [hf:mistralai/Mistral-Large-Instruct-2407].

88L puts ~123B params; trains with factored Adafactor + grad accumulation
(see DESIGN.md §8 memory notes).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=28672, vocab_size=32768, rope_theta=1_000_000.0,
    optimizer="adafactor", grad_accum=8,
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=192, vocab_size=80, remat=False, logits_chunk=32,
    optimizer="adafactor",
)
