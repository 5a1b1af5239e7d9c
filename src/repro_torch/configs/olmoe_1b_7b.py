"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8 [arXiv:2409.02060; hf].  Every layer is MoE.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe_1b_7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    mlp="glu",
    num_experts=64,
    top_k=8,
    moe_every=1,
)
