"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm [hf:Qwen/Qwen3-8B; hf].

Qwen3 sets head_dim=128 explicitly (not d_model/num_heads).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp="glu",
)
