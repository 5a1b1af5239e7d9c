"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2 [arXiv:2404.16821; hf].

Only the LM backbone is modeled: the InternViT frontend is not, and the
batch carries precomputed patch embeddings (``patch_embeds``) that
replace the token embeddings where ``patch_mask`` is set (256 image
tokens forming the leading document of the packed sequence).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    mlp="glu",
    frontend="vit_patches",
    num_patch_tokens=256,
)
