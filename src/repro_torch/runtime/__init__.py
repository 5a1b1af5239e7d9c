"""Distributed runtime of the port: the ZeRO-3 layout and its
collectives, and the elastic supervision of the training loops (failure
policy, recovery plans, straggler monitor; copies of the reference's
``repro.runtime`` host logic)."""

from .elastic import ElasticPlan, shrink_mesh_shape
from .fault_tolerance import (FailureAction, FailurePolicy, HeartbeatMonitor,
                              TrainingFailure, run_with_recovery)
from .recovery import (ElasticSupervisor, FailureInjector, HostTopology,
                       RecoveryPlan, StragglerSim, parse_fail_spec,
                       parse_straggle_specs, replan_after_failure)
from .straggler import StragglerMonitor

__all__ = ["ElasticPlan", "shrink_mesh_shape", "FailureAction",
           "FailurePolicy", "HeartbeatMonitor", "TrainingFailure",
           "run_with_recovery", "StragglerMonitor", "ElasticSupervisor",
           "FailureInjector", "HostTopology", "RecoveryPlan",
           "StragglerSim", "parse_fail_spec", "parse_straggle_specs",
           "replan_after_failure"]
