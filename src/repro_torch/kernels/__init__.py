"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``flash_decode`` and ``doc_attention`` hold the wrappers (and the
training kernels' visit tables); ``ops`` the differentiable attention;
``csrc/`` the CUDA sources, built at first use by ``_build``; ``ref`` the
attention oracle.
"""
