"""Architecture registry of the port: all ten architectures of the
reference (the dense and MoE attention stacks, the Jamba hybrid, the
xLSTM SSM stack, the musicgen audio stack and the internvl VLM
backbone), resolved by ``--arch`` name.
"""

from __future__ import annotations

from .base import (SHAPES, ModelConfig, RunConfig, ShapeConfig,
                   reduce_for_smoke, run_config_from_dict,
                   run_config_to_dict)

from . import (dbrx_132b, granite_34b, internvl2_1b, jamba_v0_1_52b,
               musicgen_medium, olmoe_1b_7b, qwen3_32b, starcoder2_3b,
               starcoder2_7b, xlstm_350m)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (starcoder2_3b, starcoder2_7b, granite_34b, qwen3_32b,
              olmoe_1b_7b, dbrx_132b, jamba_v0_1_52b, xlstm_350m,
              musicgen_medium, internvl2_1b)
}


def get_config(name: str) -> ModelConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]


__all__ = ["ModelConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCHS",
           "get_config",
           "reduce_for_smoke", "run_config_to_dict", "run_config_from_dict"]
