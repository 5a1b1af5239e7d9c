"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``flash_decode`` holds the wrappers; ``csrc/`` the CUDA sources, built
at first use by ``_build``; ``ref`` the attention oracle.
"""
