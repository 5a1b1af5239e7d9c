"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, code [arXiv:2405.04324; hf].

Granite-34B-code is gpt_bigcode-style: MQA (kv=1) with a plain 2-matrix
gelu FFN (d_ff = 4d), which lands the analytic count at ~34B.  MQA means
the CP KV exchange is 48x smaller than a Q exchange — FlashCP's
sharding-aware savings still compound on top.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite_34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    mlp="gelu",
)
