"""PyTorch / CUDA port of the FlashCP reproduction, for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: it imports torch
and numpy, never jax and never ``repro``, and keeps its own copies of
the host code it needs.  Its layout mirrors ``repro``'s so that each
module's counterpart is easy to find (``configs``, ``core``,
``kernels``, ``models``, ``serve``, ``launch``).  The ported slice is
the serving path: paged continuous batching over a dense attention
stack, with hand-written CUDA flash-decode kernels
(``kernels/csrc/flash_decode.cu``).

Entry points take an explicit ``device`` and default to "cuda"; without
a card they raise unless the caller passes "cpu", which runs the
kernels' plain PyTorch versions.
"""
