"""Visit-table layout contract shared by the kernels, the table emitter
and the CP context (the port's own copy of the reference's
``table_layout``; no torch, no numpy).

One kernel grid schedule <-> one table array family:

* ``grid="rect"`` — rectangular visit tables, 2 arrays per direction:
  ``(idx, nvis)`` for the fwd/dQ map and the dKV reverse map.
* ``grid="flat"`` — flattened work queues, 3 arrays per direction:
  ``(row, col, flags)`` (see
  :func:`repro_torch.kernels.doc_attention.build_work_queue`).

The emitter (:func:`repro_torch.planner.encode.emit_visit_tables`)
prefixes these base names per table group (``tab_``, ``tab_loc_``,
``tab_hop_``); :func:`repro_torch.core.cp_attention.make_cp_context`
resolves the same keys back out of the plan arrays.
"""

from __future__ import annotations

RECT_TABLE_NAMES = ("kv_idx", "kv_nvis", "q_idx", "q_nvis")
FLAT_TABLE_NAMES = ("fq_row", "fq_col", "fq_flags",
                    "rq_row", "rq_col", "rq_flags")

#: arrays per direction (fwd/dQ map | dKV reverse map) for each grid
GRID_TABLE_HALF = {"rect": 2, "flat": 3}


def grid_table_names(grid: str) -> tuple[str, ...]:
    if grid not in GRID_TABLE_HALF:
        raise ValueError(f"unknown kernel grid {grid!r}")
    return FLAT_TABLE_NAMES if grid == "flat" else RECT_TABLE_NAMES


def table_keys(prefix: str, grid: str) -> tuple[str, ...]:
    """Plan-array key family for one table group (e.g. ``tab_loc_``)."""
    return tuple(f"{prefix}{n}" for n in grid_table_names(grid))
