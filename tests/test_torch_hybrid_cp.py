"""A 1x2 ZeRO-3 jamba step of the port (``contiguous``: the selective-
scan island and the Mamba convolution's halo over gloo ranks, the
attention through the flashcp island) against the reference's
``contiguous`` CP step on 2 simulated host devices, in a subprocess
(the recipe of tests/multidevice/train_parity.py), smoke size, float32,
drop-free (the MoE capacity is per rank): loss, CE and aux 1e-5
relative, every gradient leaf 1e-4 of its largest entry (as
tests/test_torch_train.py holds the dense stacks).  The ranks ask for
flashcp; the step swaps it for contiguous (``effective_strategy``).
"""

import os
import subprocess
import sys

import numpy as np

import _torch_cp_ranks as cpranks
from repro_torch.launch.ranks import spawn_ranks

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
JOIN_TIMEOUT = 240
HERE = os.path.dirname(os.path.abspath(__file__))


def _close(got, want, rel, what=""):
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=rel * scale, rtol=0, err_msg=what)


CP_ARCH = "jamba_v0_1_52b"
DROP_FREE = {"capacity_factor": 8.0}
PIPE_KW = dict(dataset="wlb_llm", context_len=256, batch_per_host=2,
               strategy="contiguous", seed=1, align=16, emit_tables=False,
               table_grid="flat", table_block_q=64, table_block_k=64)
RUN_KW = dict(lr=1e-3, warmup_steps=1, total_steps=4)

CP_REF_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, sys.argv[1])
import ast
import numpy as np
import jax
import jax.numpy as jnp
from repro.compat import make_mesh, set_mesh
from repro.configs import get_config, reduce_for_smoke
from repro.core.cp_attention import make_cp_context
from repro.data.pipeline import PipelineConfig, make_batch
from repro.models import init_params, loss_fn

pipe_kw = ast.literal_eval(sys.argv[3])
cfg = dataclasses.replace(reduce_for_smoke(get_config(sys.argv[2])),
                          **ast.literal_eval(sys.argv[4]))
params = init_params(jax.random.PRNGKey(1), cfg)
flat = {}
def walk(t, pre=""):
    for k in sorted(t):
        if isinstance(t[k], dict):
            walk(t[k], pre + k + ".")
        else:
            flat[pre + k] = np.asarray(t[k])
walk(params)
np.savez(sys.argv[5], **flat)
batch = make_batch(PipelineConfig(**pipe_kw, cp_size=2,
                                  vocab_size=cfg.vocab_size), 0)
mesh = make_mesh((1, 2), ("data", "model"))
with set_mesh(mesh):
    ctx = make_cp_context(
        mesh, {k: jnp.asarray(batch[k]) for k in
               ("doc", "pos", "send_idx", "gath_doc", "gath_pos")},
        strategy="contiguous", impl="xla", batch_axes=("data",),
        head_dim=cfg.resolved_head_dim, q_chunk=64)
    b = {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")}
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, cfg, ctx, b, remat=False), has_aux=True))(params)
out = {"loss": np.asarray(loss), "ce": np.asarray(m["ce"]),
       "aux": np.asarray(m["aux"])}
flat.clear()
walk(g)
out.update({"grad/" + k: v for k, v in flat.items()})
np.savez(sys.argv[6], **out)
"""


def test_jamba_cp_step_1x2_matches_reference_cp_step(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    params, ref = tmp_path / "params.npz", tmp_path / "ref.npz"
    proc = subprocess.run(
        [sys.executable, "-c", CP_REF_SCRIPT, os.path.join(HERE, "..", "src"),
         CP_ARCH, repr(PIPE_KW), repr(DROP_FREE), str(params), str(ref)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    # the ranks ask for flashcp: the step swaps it for contiguous
    spawn_ranks(cpranks.train_rank, 2,
                args=(2, str(tmp_path / "store"), str(tmp_path),
                      str(params), {"plain": PIPE_KW},
                      {**RUN_KW, "cp_strategy": "flashcp"},
                      [("plain", "none")], (1, 2), CP_ARCH, DROP_FREE),
                timeout=JOIN_TIMEOUT)
    want = dict(np.load(ref))
    for r in range(2):
        res = dict(np.load(tmp_path / f"rank{r}.npz"))
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(res[f"plain/none/{k}"], want[k],
                                       rtol=LOSS_TOL, err_msg=f"rank {r} {k}")
        grads = {k[len("grad/"):]: v for k, v in want.items()
                 if k.startswith("grad/")}
        for name, g in grads.items():
            _close(res[f"plain/none/grad/{name}"], g, GRAD_TOL,
                   f"rank {r} grad {name}")
        assert np.isfinite(res["plain/none/step/grad_norm"])
