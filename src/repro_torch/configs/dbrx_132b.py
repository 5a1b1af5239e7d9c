"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].  Every layer is MoE.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx_132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    mlp="glu",
    num_experts=16,
    top_k=4,
    moe_every=1,
)
