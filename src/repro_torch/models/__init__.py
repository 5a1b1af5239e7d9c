"""Decoder stacks of the port: dense, MoE, hybrid and SSM (training and
serving paths)."""

from .context import ExecContext, make_local_context
from .convert import params_from_numpy
from .transformer import (block_kinds, decode_step, forward, init_cache,
                          init_paged_cache, init_params, loss_fn,
                          loss_fn_chunked_head, period_length,
                          prefill_forward, supports_cached_prefill,
                          supports_paged_cache, torch_dtype)

__all__ = ["ExecContext", "block_kinds", "decode_step", "forward",
           "init_cache", "init_paged_cache", "init_params", "loss_fn",
           "loss_fn_chunked_head", "make_local_context", "params_from_numpy",
           "period_length", "prefill_forward", "supports_cached_prefill",
           "supports_paged_cache", "torch_dtype"]
