"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, RoPE [arXiv:2402.19173; hf].  Plain-MLP (gelu) FFN.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    mlp="gelu",
)
