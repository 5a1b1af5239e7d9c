"""Architecture registry of the port: the dense and MoE attention
stacks.

The other families of the reference (hybrid, SSM, audio, VLM) are not
ported yet, so ``get_config`` resolves only these six.
"""

from __future__ import annotations

from .base import ModelConfig, RunConfig, reduce_for_smoke

from . import (dbrx_132b, granite_34b, olmoe_1b_7b, qwen3_32b,
               starcoder2_3b, starcoder2_7b)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (starcoder2_3b, starcoder2_7b, granite_34b, qwen3_32b,
              olmoe_1b_7b, dbrx_132b)
}


def get_config(name: str) -> ModelConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]


__all__ = ["ModelConfig", "RunConfig", "ARCHS", "get_config",
           "reduce_for_smoke"]
