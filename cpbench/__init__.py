"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

One cell is one model configuration (``configs/<name>.json``) under one
traffic mix (``mixes/<name>.json``); ``BENCHMARK.json`` at the root of
the repository lists the cells and the metrics, and every per-layer
metric is read by ``metrics/<name>.py``.  ``python3 -m cpbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one
cell once; see ``README.md``.

Nothing here imports ``jax`` or the JAX package ``repro``; the reference
(``reference.py``) imports nothing of ``repro_torch`` either.
"""
