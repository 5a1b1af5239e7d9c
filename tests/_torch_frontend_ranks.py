"""The audio and VLM frontends' inputs for the port's tests, and the rank
body of the CP step with them (torch and numpy only, so the spawned
ranks never import JAX).

No data source of the repo makes frame or patch embeddings, so the tests
draw them from a seeded numpy generator in natural (packed) token order
and put them through the batch's ``perm`` as the pipeline puts
``tokens``: plan position i of row b carries natural token
``perm[b, i]``, and a padding position (``perm < 0``) carries zeros.
Patches take the first ``num_patch_tokens`` natural positions of each
row (as the reference's model tests place them).
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.ranks import init_rank


def frontend_inputs(cfg, perm: np.ndarray, seed: int) -> dict:
    """The frontend keys of ``cfg``'s family for a batch whose plan
    order is ``perm`` (B, C): {} for a token family."""
    if cfg.frontend == "none":
        return {}
    rng = np.random.default_rng(seed)
    B, C = perm.shape
    valid = perm >= 0
    src = np.where(valid, perm, 0)
    emb = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    plan = np.take_along_axis(emb, src[..., None], axis=1)
    plan[~valid] = 0.0
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": plan}
    return {"patch_embeds": plan,
            "patch_mask": valid & (perm < cfg.num_patch_tokens)}


def frontend_step_rank(rank, world, store, out_dir, params_file, arch,
                       pipe_kw, run_kw, mesh_shape, seed):
    """Step 0 of the smoke ``arch`` on a ``mesh_shape`` mesh of gloo ranks
    (ZeRO-3), its frontend keys in this mesh's plan order: the loss, ce
    and whole gradients, written to ``<out_dir>/rank<r>.npz``."""
    from _torch_cp_ranks import leaf_names, nest
    from repro_torch import configs as tcfgs
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import batch_to_device, build_train_step
    from repro_torch.models import params_from_numpy
    from repro_torch.optim._slices import leaves
    from repro_torch.runtime.zero import Zero3, tree_shapes

    init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)
    try:
        mesh = make_local_mesh(*mesh_shape, device_type="cpu")
        cfg = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
        with np.load(params_file) as f:
            whole = params_from_numpy(nest({k: f[k] for k in f.files}),
                                      device="cpu")
        names = leaf_names(whole)
        zero = Zero3(mesh, "gloo", tree_shapes(whole))
        step_fn = build_train_step(
            cfg, tcfgs.RunConfig(arch=arch, **run_kw), q_chunk=64,
            block_q=64, block_k=64, device="cpu", zero=zero)
        batch = make_batch(PipelineConfig(**pipe_kw, cp_size=mesh_shape[1],
                                          vocab_size=cfg.vocab_size), 0)
        batch.update(frontend_inputs(cfg, batch["perm"], seed))
        (loss, metrics), grads = step_fn.loss_and_grads(
            zero.shard(whole), batch_to_device(batch, "cpu"))
        res = {"loss": loss.numpy(), "ce": metrics["ce"].numpy()}
        res.update({f"grad/{n}": g.numpy() for n, g in
                    zip(names, leaves(zero.gather_full(grads)))})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
