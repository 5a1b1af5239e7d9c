"""PyTorch / CUDA port of the FlashCP reproduction, for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: it imports torch
and numpy, never jax and never ``repro``, and keeps its own copies of
the host code it needs.  Its layout mirrors ``repro``'s so that each
module's counterpart is easy to find (``configs``, ``core``, ``data``,
``planner``, ``kernels``, ``models``, ``optim``, ``runtime``,
``checkpoint``, ``serve``, ``launch``).
Ported: the serving path (paged continuous batching over a dense
attention stack, hand-written CUDA flash-decode kernels in
``kernels/csrc/flash_decode.cu``) and training (the data pipeline and
planners, doc-masked attention through the CUDA training kernels in
``kernels/csrc/doc_attention.cu``, the CP islands, AdamW, and the
training loop on a ``data x model`` mesh with ZeRO-3 sharding and
checkpoints).

Entry points take an explicit ``device`` and default to "cuda"; without
a card they raise unless the caller passes "cpu", which runs the
kernels' plain PyTorch versions.
"""
