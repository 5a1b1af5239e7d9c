"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to CUDA.
Without a card it raises rather than quietly running on the CPU: a
caller that wants the CPU (the parity tests) asks for it.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "sm_count"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this process; the port runs on an "
            "NVIDIA GPU by default. Pass device='cpu' to run the plain "
            "PyTorch path on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device: what the split kernels
    size their grids by."""
    return torch.cuda.get_device_properties(device).multi_processor_count
