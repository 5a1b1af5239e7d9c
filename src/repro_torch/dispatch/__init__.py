"""Adaptive DP×CP token dispatcher (DESIGN.md §Dispatch): the port's copy
of the reference's ``repro.dispatch``.

Sits between the data pipeline and the planner registry: per global step,
:func:`dispatch_step` sizes the CP subgroups from the document-length
profile and LPT-dispatches the step's documents across the resulting
DP×CP groups with cross-rank token/workload balancing.  The emitted
:class:`DispatchPlan` drives
:func:`repro_torch.data.pipeline.make_dispatch_batch` (per-group
planning/encoding at the chosen degree) and
:func:`repro_torch.launch.mesh.make_group_mesh` (the re-tiled rank grid).

Host-side numpy only, the reference's code: every rank of a job makes
the same decision from the same inputs.
"""

from .balance import (PackedPool, effective_imbalance, imbalance,
                      lpt_assign, pack_pool, sequence_workload)
from .dispatcher import (DispatchConfig, DispatchPlan, cp_degree_options,
                         dispatch_step, estimate_comm_tokens)
from .profile import LengthProfile, profile_lengths

__all__ = [
    "PackedPool", "effective_imbalance", "imbalance", "lpt_assign",
    "pack_pool", "sequence_workload",
    "DispatchConfig", "DispatchPlan", "cp_degree_options", "dispatch_step",
    "estimate_comm_tokens",
    "LengthProfile", "profile_lengths",
]
