"""Elastic mesh management: rebuild a mesh after host loss (the port's
copy of the reference's ``repro.runtime.elastic``).

Losing a host removes its devices; the recovery strategy (consistent with
reshard-on-restore checkpoints) is to choose the largest supported mesh
shape that fits the surviving device count and re-layout.
``shrink_mesh_shape`` picks that shape; the training driver then rebuilds
the mesh over the survivors, re-applies the sharding rules, and restores
the latest checkpoint onto the new layout, resharded leaf by leaf.

The data-parallel axis shrinks first (model/context axes are constrained
by memory and the CP plan); global batch is preserved by gradient
accumulation over ``accum_factor`` micro-steps.
"""

from __future__ import annotations

import dataclasses

__all__ = ["shrink_mesh_shape", "ElasticPlan"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    accum_factor: int          # grad-accumulation to preserve global batch


def shrink_mesh_shape(alive_chips: int, *, model_axis: int,
                      axis_names=("data", "model"),
                      old_data_axis: int | None = None) -> ElasticPlan:
    """Largest power-of-two data axis that fits the surviving chips while
    keeping the model/CP axis intact."""
    if alive_chips < model_axis:
        raise ValueError(
            f"cannot keep model axis {model_axis} with {alive_chips} chips")
    data = 1
    while data * 2 * model_axis <= alive_chips:
        data *= 2
    accum = 1
    if old_data_axis is not None and old_data_axis > data:
        accum = (old_data_axis + data - 1) // data
    return ElasticPlan(mesh_shape=(data, model_axis),
                       axis_names=tuple(axis_names), accum_factor=accum)
