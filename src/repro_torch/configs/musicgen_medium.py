"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec frontend is not modeled: the batch
carries precomputed frame embeddings (``frame_embeds``) in place of
token ids, so the stack has no embedding table and its own lm_head.
MusicGen uses a plain (non-GLU) transformer decoder.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    mlp="gelu",
    frontend="audio_frames",
)
