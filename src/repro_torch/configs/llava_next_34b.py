"""llava-next-34b [vlm]: anyres tiling backbone. [hf:llava-hf/llava-v1.6].

Backbone-only per assignment: the CLIP tower + anyres tiler is the stubbed
frontend; inputs carry 2880 precomputed patch embeddings (5 tiles x 576)
of dim 1024, projected by a 2-layer MLP and prepended to text tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, rope_theta=5_000_000.0,
    frontend="vision", vision_patches=2880, vision_dim=1024,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=96, remat=False, logits_chunk=32,
    frontend="vision", vision_patches=8, vision_dim=32,
)
