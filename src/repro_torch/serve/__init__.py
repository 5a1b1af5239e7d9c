"""Continuous-batching serving engine of the port (DESIGN.md §7).

``ServeEngine`` drives budgeted chunked prefill and ragged flash-decode
steps over a global KV block pool (``BlockPool``) with cross-request
prefix sharing (``PrefixCache``); the dense per-slot stripe layout is
the parity oracle.  ``Scheduler``/``Request`` manage admission, the
token budget and retirement; ``sampling`` holds the per-request keyed
sampler; ``resilience`` the bounded admission, the watchdog, chaos
injection and engine snapshots.
"""

from .block_pool import BlockPool
from .engine import ServeEngine
from .prefix import PrefixCache
from .resilience import (AdmissionConfig, ChaosInjector, EngineKilled,
                         Watchdog, parse_chaos)
from .sampling import apply_top_k, sample_tokens_keyed
from .scheduler import Request, Scheduler, SlotState

__all__ = ["ServeEngine", "Request", "Scheduler", "SlotState",
           "BlockPool", "PrefixCache", "AdmissionConfig", "Watchdog",
           "ChaosInjector", "EngineKilled", "parse_chaos",
           "apply_top_k", "sample_tokens_keyed"]
