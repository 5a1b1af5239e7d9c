"""Planner registry: one API surface for every CP sharding strategy.

The port's copy of the reference's ``repro.planner.registry``.  A
planner is registered **once**:

    @register_planner("my_strategy", comm_style="flashcp",
                      exec_style="flashcp", order_invariant=True)
    def my_plan(doc_lens, num_workers, *, validate=True) -> ShardingPlan:
        ...

and every consumer resolves it by name with :func:`get_planner`, including
its capability metadata (:class:`PlannerInfo`):

* ``comm_style``    — the KV-exchange style stamped on emitted plans
  (``flashcp`` | ``allgather`` | ``ring``), used by cost models;
* ``exec_style``    — the execution-strategy name handed to the device-side
  training steps (:func:`repro_torch.data.pipeline.exec_style_of`);
* ``needs_equal_tokens`` — whether emitted plans satisfy Eq. 2 exactly
  (Per-Doc zigzag leaves ±1-token remainders handled by padding);
* ``order_invariant``    — the plan depends only on the *multiset* of
  document lengths, so :class:`repro_torch.planner.cache.PlanCache` may
  canonicalize by sorted length;
* ``preserves_token_order`` — packed token order survives across ranks
  (required by recurrent/hybrid architectures — SSM state flows rank
  i → i+1);
* ``supports_target_ratio`` — accepts a ``target_ratio`` imbalance knob;
* ``cost_hint``          — rough planner cost class, used by tooling to
  warn before running exponential reference solvers on big inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from .plan import ShardingPlan

__all__ = ["Planner", "PlannerInfo", "RegisteredPlanner", "register_planner",
           "get_planner", "available_planners", "planner_info",
           "planners_for_family", "RECURRENT_FAMILIES"]

#: model families whose training steps require ``preserves_token_order``
#: planners (SSM state flows rank i -> i+1 across the CP axis)
RECURRENT_FAMILIES = ("hybrid", "ssm")


@dataclasses.dataclass(frozen=True)
class PlannerInfo:
    """Capability metadata attached to every registered planner."""

    name: str
    description: str = ""
    comm_style: str = "flashcp"       # comm style stamped on plans
    exec_style: str = "flashcp"       # strategy name for training steps
    needs_equal_tokens: bool = True   # plans satisfy Eq. 2 exactly
    order_invariant: bool = False     # plan depends only on length multiset
    preserves_token_order: bool = False
    supports_target_ratio: bool = False
    cost_hint: str = "vectorized"     # "vectorized" | "search" | "exponential"
    #: packed context must be a multiple of ``context_multiple * N``
    #: (llama3's 2N zigzag chunking; 1 for everyone else)
    context_multiple: int = 1
    aliases: tuple[str, ...] = ()


@runtime_checkable
class Planner(Protocol):
    """A CP sharding strategy: lengths + worker count -> ShardingPlan."""

    info: PlannerInfo

    def __call__(self, doc_lens, num_workers: int, *,
                 validate: bool = True, **kwargs) -> ShardingPlan:
        ...


class RegisteredPlanner:
    """Callable wrapper binding a planner function to its metadata."""

    __slots__ = ("info", "_fn")

    def __init__(self, info: PlannerInfo, fn: Callable[..., ShardingPlan]):
        self.info = info
        self._fn = fn

    def __call__(self, doc_lens, num_workers: int, *, validate: bool = True,
                 **kwargs) -> ShardingPlan:
        return self._fn(np.asarray(doc_lens, dtype=np.int64),
                        int(num_workers), validate=validate, **kwargs)

    def __repr__(self) -> str:
        return f"<planner {self.info.name!r} ({self.info.comm_style})>"


_REGISTRY: dict[str, RegisteredPlanner] = {}
_ALIASES: dict[str, str] = {}


def register_planner(name: str, *, aliases: tuple[str, ...] = (),
                     **info_kwargs) -> Callable:
    """Decorator registering ``fn`` as planner ``name``.

    Returns the original function unchanged, so direct imports keep
    working; registry consumers get the :class:`RegisteredPlanner` wrapper
    (with ``.info``) via :func:`get_planner`.
    """
    def deco(fn: Callable[..., ShardingPlan]) -> Callable[..., ShardingPlan]:
        if name in _REGISTRY:
            raise ValueError(f"planner {name!r} already registered")
        info = PlannerInfo(name=name, aliases=tuple(aliases), **info_kwargs)
        _REGISTRY[name] = RegisteredPlanner(info, fn)
        for alias in aliases:
            if alias in _REGISTRY or alias in _ALIASES:
                raise ValueError(f"planner alias {alias!r} already taken")
            _ALIASES[alias] = name
        return fn

    return deco


def get_planner(name: str) -> RegisteredPlanner:
    """Resolve a planner by name or alias.

    Raises ``KeyError`` listing the available planners on unknown names —
    the error the launchers surface for a mistyped ``--strategy``.
    """
    key = _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown planner {name!r}; available: "
            f"{available_planners(include_aliases=True)}") from None


def available_planners(*, include_aliases: bool = False) -> list[str]:
    names = list(_REGISTRY)
    if include_aliases:
        names += list(_ALIASES)
    return sorted(names)


def planner_info(name: str) -> PlannerInfo:
    return get_planner(name).info


def planners_for_family(family: str) -> list[str]:
    """Registered planner names whose capability metadata admits a model
    family: recurrent families (:data:`RECURRENT_FAMILIES`) require
    ``preserves_token_order``; every other family admits any planner.

    The reference's training steps swap an inadmissible request for
    ``contiguous``; its autotuner uses this list to never emit the
    inadmissible candidate in the first place.
    """
    return [name for name in available_planners()
            if family not in RECURRENT_FAMILIES
            or get_planner(name).info.preserves_token_order]
