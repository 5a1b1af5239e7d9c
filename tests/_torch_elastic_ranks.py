"""Helpers of the port's dispatch and elastic tests: the reference's own
``train()`` in a subprocess on simulated host devices, a checkpoint both
loops start from, and a rank body that runs the port's training loop
and records what each rank decided (torch and numpy only, so the spawned
ranks never import JAX).

The port draws its parameters with torch and the reference with
``jax.random``, so a comparison starts both from one checkpoint the port
writes after one step (the reference's dispatch loop restores only a
checkpoint of a step above 0).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.launch.ranks import init_rank

ROOT = Path(__file__).resolve().parent.parent
SMOKE = ["--smoke", "--device", "cpu", "--q-chunk", "64",
         "--attention-impl", "plain"]
OUT_KEYS = ("losses", "mesh", "accum", "dead_hosts", "recoveries",
            "final_step", "degree_switches")

REFERENCE_TRAIN = """
import json, sys, types
from repro.launch.train import train
kw = dict(arch="starcoder2_3b", smoke=True, strategy="flashcp",
          attention_impl="xla", dataset="wlb_llm", lr=3e-4, q_chunk=64,
          grad_compression="none", log_every=1, resume=True,
          prefetch=False, no_remat=False, dispatch=False,
          dispatch_target=1.1, dispatch_min_cp=1, fail_at="",
          straggle=None, hosts=0, max_restarts=10)
kw.update(json.loads(sys.argv[1]))
out = train(types.SimpleNamespace(**kw))
print("OUT", json.dumps({k: out.get(k) for k in %r}))
""" % (OUT_KEYS,)


def seed_checkpoint(main, directory, seq_len: int, batch: int) -> None:
    """The port's one-rank step-1 checkpoint (plain attention) in
    ``directory``."""
    main(SMOKE + ["--seq-len", str(seq_len), "--batch", str(batch),
                  "--steps", "1", "--checkpoint-dir", str(directory)])


def reference_train(ckpt_dir, devices: int, timeout: int = 600,
                    **kw) -> dict:
    """The reference's ``train()`` resuming ``ckpt_dir`` on ``devices``
    simulated host devices, with the CLI fields ``kw``; its result's
    :data:`OUT_KEYS`."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    kw = {**kw, "checkpoint_dir": str(ckpt_dir)}
    proc = subprocess.run([sys.executable, "-c", REFERENCE_TRAIN,
                           json.dumps(kw)], env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.split("OUT", 1)[1])


def loop_rank(rank, world, store, out_dir, argv):
    """One rank of the port's training loop on the CPU (``argv`` the CLI's
    arguments): what this rank decided, as JSON in
    ``<out_dir>/rank<r>.json``."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import build_parser, parse_mesh, train

    init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)
    try:
        args = build_parser().parse_args(argv)
        mesh = make_local_mesh(*parse_mesh(args.mesh), device_type="cpu")
        out = train(args, mesh=mesh, device="cpu")
        keep = {k: out[k] for k in OUT_KEYS + ("degrees", "targets",
                                                "dispatch", "left")}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(keep, f)
    finally:
        dist.destroy_process_group()


def mesh_rank(rank, world, store, out_dir):
    """The group meshes of a 2x2 grid (degrees 1 and 2) and a 1x2 grid of
    ranks [1, 3]: each as (data, model, this rank's coordinates), and the
    subset grid's sum of its ranks over its own world group, in
    ``<out_dir>/rank<r>.npz``."""
    import numpy as np

    from repro_torch.core.comm import CPComm, all_reduce_
    from repro_torch.launch.mesh import (make_group_mesh, mesh_axes,
                                         mesh_coords, mesh_world)

    init_rank(rank, world, "gloo", store, "cpu")
    try:
        res = {}

        def record(name, mesh):
            res[name] = np.asarray(
                [-1] if mesh is None else
                [*mesh_axes(mesh).values(), *mesh_coords(mesh).values()])

        for g in (1, 2):
            record(f"g{g}", make_group_mesh(2, 2, g, device_type="cpu"))
        sub = make_group_mesh(1, 2, 2, device_type="cpu", ranks=[1, 3])
        record("sub", sub)
        if sub is not None:
            total = torch.tensor([float(rank)])
            all_reduce_([total], CPComm("gloo", mesh_world(sub)))
            res["sub_sum"] = total.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
