"""Training CLI of the port (the reference's ``repro.launch.train``: its
plain and its ``--dispatch`` loop, under its elastic supervisor).

Wires the data pipeline (document packing, the planner, plan order,
visit tables) to the training step (doc-masked attention through the
CUDA kernels, AdamW with an fp32 master) and the checkpoints.
``--mesh DxM`` with D x M > 1 runs that many ranks, which this CLI
starts itself (``torch.multiprocessing``, a ``FileStore`` rendezvous in
a temporary directory), with the backend named by ``--dist-backend``;
rank r runs on ``cuda:(r % device_count)``, or on the CPU with
``--device cpu``.  Under ``torchrun`` (its ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set) every process
is one rank: it joins through ``env://`` on ``cuda:LOCAL_RANK`` and
starts nothing, so a job spans nodes; ``--mesh prod`` is the reference's
16 x 16 production mesh (256 ranks):

    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-backend c10d \
        --rdzv-endpoint HOST:29500 -m repro_torch.launch.train \
        --mesh 2x4 --dist-backend nccl --seq-len 8192 --batch 2  The batch rows go over ``data``, each row's tokens
over ``model`` (context parallelism through the CP islands), and the
parameters and optimizer state are sharded over both (ZeRO-3).
CPU-scale examples (the kernels' plain twins on CPU tensors):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 6 --seq-len 512 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --mesh 2x2 --dist-backend gloo --steps 3 --seq-len 512 \\
        --checkpoint-dir ckpt --ckpt-every 2

Full width on one H100 (random weights from the seed):

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        --seq-len 8192 --batch 1 --steps 4

The recurrent archs (``jamba_v0_1_52b``, ``xlstm_350m``) train on the
``contiguous`` planner whatever ``--strategy`` asks for, unless it
preserves token order (the scan state crosses the CP ranks in token
order); xlstm_350m has no attention, so no visit tables are built:

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_350m \\
        --seq-len 8192 --batch 1 --steps 3

MoE archs (``olmoe_1b_7b``, ``dbrx_132b``) train the same way; on a mesh
their experts split over ``model`` and each layer's tokens reach them by
the expert-parallel all-to-all.  The log and the result carry the aux
load-balancing loss.  olmoe's 16 layers of training state (111 GB) do
not fit one card, so cut its depth:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe_1b_7b \\
        --layers 4 --seq-len 8192 --batch 1 --steps 3

Checkpoints are written only where ``--checkpoint-dir`` names a
directory (the reference defaults to ``/tmp/repro_ckpt``; the port
writes nothing its caller did not name).

Adaptive dispatch (``--dispatch``, DESIGN.md §Dispatch) re-tiles the D x
M ranks per batch into CP groups of the degree the dispatcher picks for
its documents, and the elastic supervisor (DESIGN.md §Recovery) wraps
both loops: ``--fail-at STEP`` restarts from the latest checkpoint,
``--fail-at STEP:HOSTS`` loses those simulated hosts (``--hosts``, each a
contiguous range of ranks) and shrinks the data axis onto the
survivors, restoring the checkpoint resharded onto them; ``--straggle
HOST:FACTOR`` slows a host's simulated time.  On the CPU, a 2x2 mesh that
switches CP degree and loses its second host at step 3:

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --mesh 2x2 --dist-backend gloo --seq-len 1024 --batch 4 --steps 6 \
        --dispatch --hosts 2 --fail-at 3:1 --checkpoint-dir ckpt \
        --ckpt-every 1

The audio and VLM archs (``musicgen_medium``, ``internvl2_1b``) train on
frame or patch embeddings that no data source of the repo makes: the CLI
refuses them, and ``launch.steps.build_train_step`` trains them on
batches that carry those keys.

``--autotune`` (DESIGN.md §Autotune) picks ``cp_strategy``,
``cp_overlap``, ``kernel_grid``, ``dispatch`` (and its target) and
``kv_comm_dtype`` with the cost-model autotuner (``repro_torch.autotune``,
the H100's cost constants) before training, once and before any rank
starts (under ``torchrun``, rank 0 tunes and broadcasts the pick);
``--autotune-cache DIR`` keeps the result under a content address,
``--autotune-dry`` prints the pick and trains nothing:

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --mesh 1x2 --seq-len 512 --batch 2 --autotune --autotune-dry
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.autotune import autotune_run
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.core.comm import CPComm, broadcast_
from repro_torch.data.pipeline import (PipelineConfig, Prefetcher, make_batch,
                                       make_dispatch_batch)
from repro_torch.device import resolve_device
from repro_torch.dispatch import DispatchConfig
from repro_torch.launch.mesh import (PRODUCTION_SHAPE, make_group_mesh,
                                     make_local_mesh, make_production_mesh,
                                     mesh_axes, mesh_world)
from repro_torch.launch.ranks import env_rank, init_rank, spawn_ranks
from repro_torch.launch.steps import (batch_to_device, build_train_step,
                                      effective_strategy, frontend_keys)
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.runtime import (ElasticSupervisor, FailureInjector,
                                 FailurePolicy, HostTopology,
                                 StragglerMonitor, StragglerSim,
                                 parse_fail_spec, parse_straggle_specs)
from repro_torch.runtime.zero import Zero3, named_leaves, tree_shapes

__all__ = ["train", "build_parser", "main", "parse_mesh",
           "restore_state", "check_same_on_ranks", "refuse_frontends",
           "model_config", "base_run", "autotune", "TUNED_KNOBS"]

#: the RunConfig knobs ``--autotune`` picks (``autotune.Candidate``'s)
TUNED_KNOBS = ("cp_strategy", "cp_overlap", "kernel_grid", "dispatch",
               "dispatch_target_imbalance", "kv_comm_dtype")


def parse_mesh(mesh: str) -> tuple[int, int]:
    """``"DxM"`` -> (data, model); ``"prod"`` -> the production mesh's
    (16, 16)."""
    if mesh == "prod":
        return PRODUCTION_SHAPE
    try:
        data, model = (int(x) for x in mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {mesh!r}: expected DxM, e.g. 2x4, or "
                         "prod") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {mesh}: both axes must be >= 1")
    return data, model


def model_config(args):
    """The arch's config as ``--smoke`` and ``--layers`` cut it."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if getattr(args, "layers", 0):
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def base_run(args) -> RunConfig:
    """The run's :class:`RunConfig` as the flags give it (the strategy as
    asked, before ``effective_strategy``)."""
    return RunConfig(arch=args.arch, cp_strategy=args.strategy,
                     attention_impl=args.attention_impl,
                     kernel_grid=args.grid, lr=args.lr,
                     total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     grad_compression=args.grad_compression,
                     checkpoint_dir=args.checkpoint_dir,
                     remat=not args.no_remat, seed=args.seed,
                     dispatch="adaptive" if args.dispatch else "off",
                     dispatch_target_imbalance=args.dispatch_target,
                     dispatch_min_cp=args.dispatch_min_cp)


def autotune(args) -> dict:
    """``--autotune``: the cost-model autotuner's pick of
    :data:`TUNED_KNOBS` for this run (DESIGN.md §Autotune), on the
    document pool of the run's own dataset and seed, the mesh and the
    pipeline's alignment; cached under ``--autotune-cache``.  Prints the
    reference's ``[autotune]`` line and returns ``{"run_config": the
    tuned RunConfig's dict, "autotune": the search's summary}``."""
    cfg = model_config(args)
    data, model = parse_mesh(args.mesh)
    run, res = autotune_run(
        base_run(args), cfg, data=data, model=model,
        context_len=args.seq_len, seqs=args.batch, dataset=args.dataset,
        cache_dir=args.autotune_cache, top_k=args.autotune_topk)
    print(f"[autotune] {'cache hit' if res.cached else 'searched'} "
          f"{res.n_candidates} candidates (top-{res.top_k} "
          f"measured): {run.cp_strategy}/{run.cp_overlap}/"
          f"{run.kernel_grid}/{run.dispatch}/{run.kv_comm_dtype} "
          f"frontier_rho={res.spearman_frontier:.2f}", flush=True)
    best = next(f for f in res.frontier
                if f["candidate"] == res.best.as_dict())
    return {"run_config": res.run_config,
            "autotune": {"best": res.best.as_dict(), "key": res.key,
                         "cached": res.cached,
                         "n_candidates": res.n_candidates,
                         "top_k": res.top_k,
                         "frontier_rho": res.spearman_frontier,
                         "predicted": best["predicted"],
                         "measured": best["measured"]}}


def refuse_frontends(cfg) -> None:
    """Raise for a family whose batches need inputs that no data source
    of the repo makes: the audio family trains on ``frame_embeds``, the
    VLM family on ``patch_embeds`` and ``patch_mask``.  The reference's
    CLI takes such an arch and fails inside its first step (ROADMAP.md,
    Queue 3, F6); :func:`~repro_torch.launch.steps.build_train_step`
    trains both families on batches that carry those keys."""
    keys = frontend_keys(cfg)
    if keys:
        raise ValueError(
            f"--arch {cfg.name}: the {cfg.family} family trains on "
            f"{', '.join(keys)}, which the data pipeline does not make; "
            "pass batches that carry them to build_train_step")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_same_on_ranks(mine: torch.Tensor, world: CPComm,
                        what: str) -> None:
    """Raise on every rank whose ``mine`` (a float64 checksum of ``what``)
    differs from rank 0's."""
    first = mine.clone()
    broadcast_([first], world)
    if not torch.equal(mine, first):
        raise RuntimeError(f"rank {world.rank} holds other {what} than "
                           "rank 0")


def _param_shapes(manifest: dict) -> dict:
    """A checkpoint's whole parameter leaves as ``{path: shape}``, in leaf
    order."""
    tree: dict = {}
    for key, a in manifest["arrays"].items():
        parts = key.split("/")
        if parts[0] == "params":
            node = tree
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = tuple(a["shape"])
    return dict(named_leaves(tree))


def restore_state(ckpt: CheckpointManager, step: int, mesh, backend,
                  dev) -> tuple:
    """(params, optimizer state, ZeRO-3 layout or None) of checkpoint
    ``step`` on ``dev``, as this rank of ``mesh`` (None: one rank) holds
    them.  Each leaf is cut to this rank's shard on the host as it is
    read (reshard-on-restore onto any mesh), so a rank never holds more
    than one whole leaf, and that on the host; on a mesh the whole
    parameters' checksum is held against rank 0's."""
    zero = None if mesh is None else \
        Zero3(mesh, backend, _param_shapes(ckpt.manifest(step)))
    sums = []

    def leaf(key: str, x: torch.Tensor) -> torch.Tensor:
        parts = key.split("/")      # params/<path>, opt/<slot>/<path>
        path = "/".join(parts[2:] if parts[0] == "opt" else parts[1:])
        if zero is not None and path in zero.specs:
            if parts[0] == "params":
                sums.append(x.sum(dtype=torch.float64))
            x = zero.shard_leaf(path, x)
        return x.to(dev)

    _, tree, _ = ckpt.restore(step, leaf=leaf)
    if zero is not None:
        check_same_on_ranks(torch.stack(sums).sum().reshape(1).to(dev),
                            zero.world, "restored parameters")
    return tree["params"], tree["opt"], zero


def _latest(ckpt, world: CPComm | None, dev) -> int | None:
    """The latest checkpoint as the group's first rank (the writer) sees
    it, the same on every rank of ``world`` (None: one rank)."""
    latest = ckpt.latest_step() if ckpt else None
    step = torch.tensor([-1 if latest is None else latest],
                        dtype=torch.int64, device=dev)
    if world is not None:
        broadcast_([step], world)
    return None if int(step) < 0 else int(step)


def _agreed(x: float, world: CPComm | None, dev) -> float:
    """The group's first rank's ``x`` on every rank of ``world``: the
    step time every rank's straggler monitor reads, so that every rank
    takes the same dispatch and planning decisions."""
    if world is None:
        return x
    t = torch.tensor([x], dtype=torch.float64, device=dev)
    broadcast_([t], world)
    return float(t)


def _ft_setup(args, n_dev: int, model_axis: int):
    """Fault-tolerance plumbing shared by both train loops (the
    reference's): the simulated host topology (``--hosts``, default one
    host per data row; host h holds ranks ``[h dph, (h+1) dph)``), the
    failure policy (min_hosts = the hosts that still hold the model axis
    after a shrink), the straggler monitor, and the injection hooks
    (``--fail-at STEP[:HOSTS]``, ``--straggle HOST:FACTOR``).  See
    DESIGN.md §Recovery."""
    fail_step, fail_hosts = parse_fail_spec(getattr(args, "fail_at", ""))
    factors = parse_straggle_specs(getattr(args, "straggle", None))
    hosts = getattr(args, "hosts", 0) or max(n_dev // model_axis, 1)
    if n_dev % hosts:
        raise ValueError(f"--hosts {hosts} must divide the device "
                         f"count {n_dev}")
    dph = n_dev // hosts
    for h in list(fail_hosts) + list(factors):
        if not 0 <= h < hosts:
            raise ValueError(f"host {h} out of range for --hosts {hosts}")
    topology = HostTopology(num_hosts=hosts, devices_per_host=dph)
    policy = FailurePolicy(
        min_hosts=max(1, -(-model_axis // dph)),
        max_restarts=getattr(args, "max_restarts", 10))
    return (topology, policy, StragglerMonitor(),
            FailureInjector(fail_step, fail_hosts), StragglerSim(factors))


def _effective_accum(batch: int, groups: int, accum: int) -> int:
    """The gradient-accumulation factor usable at this tiling: micro
    slicing needs ``batch % (groups * accum) == 0``, else the whole
    batch runs in one micro-step (the global batch is the same either
    way)."""
    return accum if accum > 1 and batch % (groups * accum) == 0 else 1


def _divisors(n: int) -> list[int]:
    return [g for g in range(1, n + 1) if n % g == 0]


def train(args, params=None, mesh=None, device=None) -> dict:
    """Run training steps up to ``args.steps`` under the elastic
    supervisor; returns the per-step losses (replayed steps again after
    a recovery, as the reference's), grad norms, LRs, token counts, MoE
    aux losses (0 for a dense model), wall times, CP degrees, target
    imbalances (the planner's, or under ``--dispatch`` the
    dispatcher's, after the step) and dispatch statistics, the
    supervision's outcome (``final_step``, ``recoveries``,
    ``dead_hosts``, ``mesh`` and ``accum`` of the final layout,
    ``degree_switches``, and ``left``: whether this rank left the job
    at a shrink), plus the final ``params``, ``opt_state``, ``step_fn``,
    ``pipeline`` config and (on a mesh) the ``zero`` layout, so a caller
    can run further steps.

    ``params`` (whole leaves, on the device) replaces the seeded
    initialization: a CUDA generator and a CPU one draw different
    numbers from the same seed.  ``mesh`` (``launch.mesh``) makes this
    process one rank of a ``--mesh`` of more than one rank, on
    ``device``; it then holds only its ZeRO-3 shards: every rank draws
    the same parameters from the seed (a checksum against rank 0's
    proves it) and keeps its shards, or restores its shards of a
    checkpoint (:func:`restore_state`); only the first rank of the live
    mesh logs and writes checkpoints.

    Supervision (DESIGN.md §Recovery): a failure injected at a step
    (``--fail-at``) restarts from the latest checkpoint on the same mesh,
    or, naming lost hosts, shrinks the data axis onto the survivors'
    ranks and restores the checkpoint resharded onto them, running
    ``accum_factor`` micro-batches a step where the batch divides.
    Every rank takes part in making the survivors' process groups; a
    lost host's ranks then leave the loop and wait at the job's end.
    Every rank's straggler monitor reads the first live rank's step time
    (``--straggle`` inflates a host's), which tightens the planner's
    target imbalance and, under ``--dispatch``, weighs the dispatcher's
    placement, so every rank decides the same.

    ``--dispatch`` re-tiles the ``D x M`` ranks per batch into CP groups
    of the degree the dispatcher picks (every divisor of M has its mesh,
    made up front); a switch reshards the parameters and optimizer state
    onto the new tiling leaf by leaf, and each (data, degree, accum) has
    its own step."""
    dev = resolve_device(device or getattr(args, "device", "cuda"))
    D, M = parse_mesh(getattr(args, "mesh", "1x1"))
    axes = {"data": 1, "model": 1} if mesh is None else mesh_axes(mesh)
    if axes != {"data": D, "model": M}:
        raise ValueError(f"--mesh {args.mesh} on a mesh of {axes}: main() "
                         "starts the ranks of a mesh")
    backend = args.dist_backend
    world = None if mesh is None else CPComm(backend)
    rank = 0 if world is None else world.rank
    cfg = model_config(args)
    refuse_frontends(cfg)
    run = base_run(args)
    tuned = getattr(args, "tuned", None)
    if tuned:
        run = dataclasses.replace(run, **{k: tuned[k] for k in TUNED_KNOBS})
    # unknown strategies fail fast; recurrent families swap for contiguous
    strategy = effective_strategy(cfg, run.cp_strategy)
    run = dataclasses.replace(run, cp_strategy=strategy)
    dispatch = run.dispatch == "adaptive"
    flash = run.attention_impl == "flash"
    # the kernels need block-divisible rank slices
    align = 128 if flash else (1 if (D * M if dispatch else M) == 1
                               else 16)
    pipe = PipelineConfig(
        dataset=args.dataset, context_len=args.seq_len,
        batch_per_host=args.batch, cp_size=M, strategy=strategy,
        vocab_size=cfg.vocab_size, seed=run.seed, align=align,
        emit_tables=flash and cfg.uses_attention,
        table_overlap=run.cp_overlap, table_grid=run.kernel_grid)
    if (args.resume or args.ckpt_every) and not run.checkpoint_dir:
        raise ValueError("--resume and --ckpt-every need --checkpoint-dir")
    ckpt = CheckpointManager(run.checkpoint_dir, keep=2) \
        if run.checkpoint_dir else None
    topology, policy, monitor, injector, sim = _ft_setup(args, D * M, M)
    supervisor = ElasticSupervisor(
        topology, policy, data=D, model=M, monitor=monitor,
        logger=print if rank == 0 else (lambda *_: None))
    # the live layout; on_restore rewrites it after a shrink
    cur = {"data": D, "ranks": None, "accum": 1, "world": world,
           "pipe": pipe, "key": None, "left": False,
           "dcfg": DispatchConfig(
               data=D, model=M, seqs=args.batch,
               target_imbalance=run.dispatch_target_imbalance,
               min_cp=run.dispatch_min_cp, quantum=align,
               bin_quantum=args.dispatch_bin_quantum)}
    degrees = _divisors(M) if dispatch else [M]
    meshes = {M: mesh}
    layouts: dict[tuple, tuple] = {}

    def make_meshes(ranks) -> dict:
        """The mesh of every degree over ``ranks`` (every rank makes
        every group, in degree order); None where this rank is not in
        it."""
        if world is None:
            return {g: None for g in degrees}
        return {g: make_group_mesh(cur["data"], M, g,
                                   device_type=dev.type, ranks=ranks)
                for g in degrees}

    if world is not None and dispatch:
        meshes.update({g: make_group_mesh(D, M, g, device_type=dev.type)
                       for g in degrees if g != M})

    def layout(g: int, zero=None) -> tuple:
        """(key, Zero3 or None, step) of degree ``g`` on the live mesh:
        one built step per (data, degree, accum); ``zero`` (a restored
        layout) replaces the key's."""
        groups = cur["data"] * M // g
        key = (cur["data"], g,
               _effective_accum(args.batch, groups, cur["accum"]))
        if key not in layouts or zero is not None:
            if zero is None and meshes[g] is not None:
                zero = Zero3(meshes[g], backend, shapes)
            layouts[key] = (zero, build_train_step(
                cfg, run, q_chunk=args.q_chunk, accum=key[2], device=dev,
                zero=zero))
        return (key, *layouts[key])

    def new_state():
        """Fresh parameters from the seed (or the caller's), every rank's
        the same, and fresh optimizer state, whole."""
        whole = params_in if params_in is not None else \
            init_params(cfg, seed=run.seed, device=dev)
        if cur["world"] is not None:
            mine = torch.stack([x.sum(dtype=torch.float64)
                                for _, x in named_leaves(whole)])
            check_same_on_ranks(mine.sum().reshape(1), cur["world"],
                                "parameters")
        return whole

    it = pending = None

    def stream(step: int):
        """(prefetcher or None, the first batch or None) from ``step``."""
        if dispatch:
            if args.prefetch:
                pf = Prefetcher(cur["pipe"], start_step=step,
                                dispatch=cur["dcfg"],
                                speeds_fn=supervisor.device_speeds)
                return pf, next(pf)
            return None, make_dispatch_batch(
                cur["pipe"], cur["dcfg"], step,
                device_speeds=supervisor.device_speeds())
        if args.prefetch:
            return Prefetcher(cur["pipe"], start_step=step), None
        return None, None

    def degree_of(batch) -> int:
        return batch["stats"]["dispatch"]["cp_degree"] if dispatch else M

    params_in = params
    # --resume: rank 0's latest checkpoint, the same on every rank
    resume = _latest(ckpt, world, dev) if args.resume else None
    start = resume or 0
    it, pending = stream(start)
    g0 = degree_of(pending) if pending is not None else M
    if resume is not None:
        params, opt_state, zero = restore_state(ckpt, resume, meshes[g0],
                                                backend, dev)
        shapes = _param_shapes(ckpt.manifest(resume))
        key, zero, step_fn = layout(g0, zero)
        if rank == 0:
            print(f"[train] resumed from step {start}", flush=True)
    else:
        whole = new_state()
        shapes = tree_shapes(whole)
        key, zero, step_fn = layout(g0)
        params = whole if zero is None else zero.shard(whole)
        del whole
        opt_state = None
    if opt_state is None:
        opt_state = adamw_init(params)
    cur["key"] = key
    out = {"losses": [], "grad_norms": [], "lrs": [], "tokens": [],
           "auxes": [], "step_s": [], "degrees": [], "targets": [],
           "dispatch": []}
    switches = 0

    def writer() -> bool:
        return cur["world"] is None or cur["world"].rank == 0

    def save(step: int, blocking: bool) -> None:
        state = {"params": params, "opt": opt_state}
        if zero is not None:
            state = zero.gather_state(state, keep=writer())
        if writer():
            ckpt.save(step, state, blocking=blocking)
        if blocking and cur["world"] is not None:
            # every rank returns once the writer has committed it
            broadcast_([torch.zeros((1,), device=dev)], cur["world"])

    def one_step(step: int) -> None:
        nonlocal params, opt_state, zero, step_fn, pending, switches
        t0 = time.perf_counter()
        injector.maybe_fail(step)
        if pending is not None:
            batch, pending = pending, None
        elif it is not None:
            batch = next(it)
        elif dispatch:
            batch = make_dispatch_batch(
                cur["pipe"], cur["dcfg"], step,
                device_speeds=supervisor.device_speeds())
        else:
            batch = make_batch(cur["pipe"], step)
        g = degree_of(batch)
        key, new_zero, new_fn = layout(g)
        if key != cur["key"]:
            if zero is not None:
                state = zero.reshard_state(
                    {"params": params, "opt": opt_state}, new_zero)
                params, opt_state = state["params"], state["opt"]
                del state
            cur["key"] = key
            switches += 1
        zero, step_fn = new_zero, new_fn
        metrics = step_fn(params, opt_state, batch_to_device(batch, dev),
                          step)
        loss = float(metrics["loss"])          # waits for the step
        _sync(dev)
        dt = time.perf_counter() - t0
        for k, v in (("losses", loss), ("step_s", dt), ("degrees", g),
                     ("grad_norms", float(metrics["grad_norm"])),
                     ("lrs", float(metrics["lr"])),
                     ("tokens", int(metrics["tokens"])),
                     ("auxes", float(metrics["aux"]))):
            out[k].append(v)
        # every rank's monitor reads the first live rank's time, so the
        # next batch's target and placement are the same on every rank
        sim.observe(monitor, _agreed(dt, cur["world"], dev),
                    supervisor.surviving_hosts())
        name = "dcfg" if dispatch else "pipe"
        if it is None:
            tgt = round(monitor.adjusted_target(), 2)
            if abs(tgt - cur[name].target_imbalance) > 1e-9:
                cur[name] = dataclasses.replace(cur[name],
                                                target_imbalance=tgt)
        out["targets"].append(cur[name].target_imbalance)
        ds = batch["stats"].get("dispatch")
        if ds:
            out["dispatch"].append(ds)
        if writer() and step % args.log_every == 0:
            where = (f"cp {g} groups {ds['n_groups']} "
                     f"tok_imb {ds['token_imbalance']:.3f} "
                     f"work_imb {ds['work_imbalance']:.3f}") if ds else \
                (f"imb {batch['stats']['imbalance']:.3f} "
                 f"comm_tok {batch['stats']['comm_tokens']}")
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"aux {float(metrics['aux']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"lr {float(metrics['lr']):.2e} {where} "
                  f"{dt:.2f}s", flush=True)
        if ckpt and args.ckpt_every and step \
                and step % args.ckpt_every == 0:
            save(step + 1, blocking=False)

    def on_restore(action, plan) -> int:
        nonlocal params, opt_state, zero, step_fn, it, pending, meshes
        if ckpt and writer():
            try:
                ckpt.wait()         # settle any in-flight save
            except RuntimeError as err:
                print(f"[train] pending checkpoint save failed: {err}")
        if it is not None:
            it.close()
        it = pending = None
        params = opt_state = zero = None
        if plan is not None:        # elastic shrink onto the survivors
            cur.update(data=plan.data_axis, ranks=list(plan.devices),
                       accum=plan.accum_factor)
            meshes = make_meshes(cur["ranks"])
            layouts.clear()
            if world is not None and rank not in cur["ranks"]:
                cur.update(left=True, world=None)
                return args.steps   # a lost host's rank leaves the loop
            if world is not None:
                cur["world"] = CPComm(backend, mesh_world(meshes[M]))
            cur["dcfg"] = dataclasses.replace(cur["dcfg"],
                                              data=plan.data_axis)
        resume = _latest(ckpt, cur["world"], dev)
        it, pending = stream(resume or 0)
        g = degree_of(pending) if pending is not None else M
        if resume is None:
            whole = new_state()
            key, zero, step_fn = layout(g)
            params = whole if zero is None else zero.shard(whole)
            del whole
            opt_state = adamw_init(params)
        else:
            params, opt_state, restored = restore_state(
                ckpt, resume, meshes[g], backend, dev)
            key, zero, step_fn = layout(g, restored)
        cur["key"] = key
        if writer():
            print(f"[train] restored step {resume or 0} after "
                  f"{action.value} (mesh {cur['data']}x{M}, accum "
                  f"{key[2]})", flush=True)
        return resume or 0

    try:
        final = supervisor.run(one_step, start_step=start,
                               total_steps=args.steps,
                               on_restore=on_restore)
        if ckpt and not cur["left"]:
            save(max(args.steps, start), blocking=True)
    finally:
        if it is not None:
            it.close()
    if world is not None:
        # a lost host's ranks wait here for the survivors
        dist.barrier()
    if dispatch and writer() and not cur["left"]:
        print(f"[train] dispatch: {switches} degree switches over "
              f"{len(out['losses'])} steps", flush=True)
    out.update(final_step=max(final, start), params=params,
               opt_state=opt_state, step_fn=step_fn, pipeline=cur["pipe"],
               config=cfg, run=run, zero=zero,
               recoveries=policy.restarts,
               dead_hosts=sorted(supervisor.dead),
               mesh=(cur["data"], M), accum=cur["accum"],
               degree_switches=switches, left=cur["left"])
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (depth only; "
                         "0 keeps the config's)")
    ap.add_argument("--strategy", default="flashcp")
    ap.add_argument("--attention-impl", default="flash",
                    choices=("flash", "plain"),
                    help="flash = the CUDA kernels (their plain twins on "
                         "the CPU); plain = chunked dense attention")
    ap.add_argument("--grid", default="flat", choices=("flat", "rect"),
                    help="kernel schedule over the visit tables")
    ap.add_argument("--dataset", default="wlb_llm")
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--q-chunk", type=int, default=128)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "topk", "int8"),
                    help="compress the clipped gradients (zero error "
                         "feedback, as the reference does)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="directory of the checkpoints ('' = none)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save asynchronously after every this many steps "
                         "(0 = only the final save)")
    ap.add_argument("--resume", action="store_true",
                    help="start from the latest checkpoint, on any mesh")
    ap.add_argument("--prefetch", action="store_true",
                    help="build batches ahead on a background thread")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: data x model (CP) axes, or prod (16x16)")
    ap.add_argument("--dispatch", action="store_true",
                    help="adaptive DP x CP dispatch: per batch, CP groups "
                         "of a degree sized to its documents and the "
                         "documents balanced over them")
    ap.add_argument("--dispatch-target", type=float, default=1.1,
                    help="the cross-group token / workload imbalance above "
                         "which the dispatcher takes a larger CP degree")
    ap.add_argument("--dispatch-min-cp", type=int, default=1)
    ap.add_argument("--dispatch-bin-quantum", type=int, default=1,
                    help="bin totals trimmed to multiples of lcm(degree, "
                         "this): the lcm of the degrees under comparison "
                         "packs every degree alike (1 = the reference's)")
    ap.add_argument("--fail-at", default="", metavar="STEP[:HOSTS]",
                    help="inject a failure at STEP: a restart from the "
                         "latest checkpoint, or with ':h1,h2' those hosts "
                         "lost and the data axis shrunk onto the "
                         "survivors")
    ap.add_argument("--straggle", action="append", default=None,
                    metavar="HOST:FACTOR",
                    help="simulate HOST running FACTOR x slower "
                         "(repeatable; feeds the straggler monitor)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="simulated hosts, each a contiguous range of "
                         "ranks (0 = one host per data row)")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--autotune", action="store_true",
                    help="search run-config knobs (strategy/overlap/grid/"
                         "dispatch/kv dtype) with the cost-model autotuner "
                         "before training (DESIGN.md §Autotune); on a mesh "
                         "once, before any rank starts")
    ap.add_argument("--autotune-cache", default="",
                    help="directory for the content-addressed tune result "
                         "cache ('' = no persistence)")
    ap.add_argument("--autotune-topk", type=int, default=8,
                    help="measured-trial frontier size")
    ap.add_argument("--autotune-dry", action="store_true",
                    help="tune and print the selected config, skip training")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    help="collective backend, required when D x M > 1 "
                         "(gloo where ranks share a card: NCCL takes one "
                         "rank per device)")
    return ap


def _report(out) -> None:
    if out["losses"]:
        print(f"[train] done at step {out['final_step']}; "
              f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}",
              flush=True)


def _rank_main(rank: int, args, world: int, store: str | None) -> dict:
    """One rank of the mesh: joins through ``store`` (a FileStore path)
    or env:// (None), trains, and returns its result.  Under env:// with
    ``--autotune``, rank 0 tunes and every rank takes its pick."""
    _, dev = init_rank(rank, world, args.dist_backend, store, args.device)
    try:
        tuned = None
        if args.autotune and not getattr(args, "tuned", None):
            box = [autotune(args) if rank == 0 else None]
            dist.broadcast_object_list(box, src=0, device=dev
                                       if args.dist_backend == "nccl"
                                       else None)
            tuned = box[0]
            if args.autotune_dry:
                return {"final_step": 0, "losses": [], **tuned}
            args = argparse.Namespace(**{**vars(args),
                                         "tuned": tuned["run_config"]})
        if args.mesh == "prod":
            mesh = make_production_mesh(device_type=dev.type)
        else:
            mesh = make_local_mesh(*parse_mesh(args.mesh),
                                   device_type=dev.type)
        out = train(args, mesh=mesh, device=dev)
        if rank == 0:
            _report(out)
        return out if tuned is None else {**out, **tuned}
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict | None:
    """Run the CLI.  Returns this process's result: one rank's, or under
    an env:// launcher (``torchrun``) this rank's; None where it started
    the ranks itself."""
    args = build_parser().parse_args(argv)
    refuse_frontends(get_config(args.arch))
    data, model = parse_mesh(args.mesh)
    world = data * model
    launched = env_rank()
    tuned = None
    if args.autotune and launched is None:
        # tune once, before any rank starts; the ranks take the pick
        tuned = autotune(args)
        if args.autotune_dry:
            return {"final_step": 0, "losses": [], **tuned}
        args.tuned = tuned["run_config"]
    if launched is None and world == 1:
        out = train(args)
        _report(out)
        return out if tuned is None else {**out, **tuned}
    if args.dist_backend is None:
        raise SystemExit(f"--mesh {args.mesh} needs --dist-backend "
                         "{nccl,gloo}")
    if launched is not None:
        rank, size = launched
        if size != world:
            raise SystemExit(f"--mesh {args.mesh} needs {world} ranks; the "
                             f"launcher started {size}")
        return _rank_main(rank, args, world, None)
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_rank_main, world,
                    args=(args, world, os.path.join(tmp, "store")))
    return None


if __name__ == "__main__":
    main()
