"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, RoPE [arXiv:2402.19173; hf].  Plain-MLP (gelu) FFN.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    mlp="gelu",
)
