"""Dense decoder stack of the port (serving path)."""

from .convert import params_from_numpy
from .transformer import (block_kinds, decode_step, init_cache,
                          init_paged_cache, init_params, period_length,
                          prefill_forward, torch_dtype)

__all__ = ["block_kinds", "decode_step", "init_cache", "init_paged_cache",
           "init_params", "params_from_numpy", "period_length",
           "prefill_forward", "torch_dtype"]
