"""Optimizer of the port: AdamW with an fp32 master, global-norm
clipping, gradient compression, LR schedules."""

from .adamw import adamw_init, adamw_update
from .clipping import clip_by_global_norm, global_norm
from .grad_compress import compress_tree, ef_init, wire_bytes
from .schedule import constant, warmup_cosine

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_tree", "ef_init", "global_norm", "wire_bytes",
           "constant", "warmup_cosine"]
