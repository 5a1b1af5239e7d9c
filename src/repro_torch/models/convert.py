"""Parameters across frameworks: the JAX package's tree, as numpy, to
the port's tensors.

The JAX tree is nested dicts of arrays with the same keys as the port's
(``layers.sub_j.{norm1.g, <mixer>, norm2.g?, mlp.{wi,wg?,wo} or
moe.{router,wi,wg?,wo}}`` stacked on a leading period axis, the mixer
one of ``attn.{wq,wk,wv,wo,q_norm?,k_norm?}``, ``mamba.{in_proj,conv_w,
conv_b,x_proj,dt_proj,dt_bias,A_log,D,out_proj}``,
``mlstm.{up,wq,wk,wv,wf,wi,down}`` or ``slstm.{wz,wi,wf,wo,down}``,
plus ``final_norm.g``, ``embed.e`` (absent in the audio family, whose
inputs are frame embeddings) and ``lm_head.w``), and the same
matmul layout (``x @ w`` with w of shape (d_in, d_out); an expert leaf
is (E, d_in, d_out)).  So conversion is leaf
for leaf and exact, bfloat16 included.  The caller turns the JAX arrays
into numpy (``jax.tree.map(np.asarray, params)``); the port never sees
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_numpy"]


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit patterns
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, *, device: str | torch.device = "cuda"):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``, dtypes kept."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev)

    return conv(tree)
