"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave
[arXiv:2403.19887; hf].

Jamba period-8 blocks: one attention layer (offset 4) per 8 layers, the
rest Mamba; MoE FFN every 2nd layer.  Because Mamba is sequence-recurrent,
CP for this arch uses *contiguous* sequence sharding with FlashCP's
sharding-aware communication (see DESIGN.md §Arch-applicability); boundary
SSM state crosses CP ranks via an associative chunk-summary exchange.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    mlp="glu",
    num_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    attn_offset=4,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)
