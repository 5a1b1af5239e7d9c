"""Optimizer of the port: AdamW with an fp32 master, global-norm
clipping, LR schedules.  Gradient compression waits for the distributed
slice."""

from .adamw import adamw_init, adamw_update
from .clipping import clip_by_global_norm, global_norm
from .schedule import constant, warmup_cosine

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "constant", "warmup_cosine"]
