#!/usr/bin/env python
"""flashcheck_torch — static plan / wire / source verifier of the port
(DESIGN.md §Static-analysis; the twin of ``scripts/flashcheck.py``).

Proves the comm-efficiency and determinism invariants of
``src/repro_torch`` with host-side numpy and AST walking; only the
opt-in wire audit runs anything (two gloo ranks on the CPU).

Layers:

1. **Plan checks** (``repro_torch.analysis.plan_check``) — every
   config-zoo arch's plan under the strategy the training step picks for
   its family, and every registered planner's on one arch's mix:
   exact-once coverage, Eq.2 equal tokens, causal closure of
   the Eq.5 compact exchange, block-table soundness against the dense
   causal-visibility oracle, work-queue flag/LPT discipline, and serve
   block-pool refcount conservation.
2. **Autotune space checks** (``repro_torch.autotune.space``) — the
   tuner's candidate enumeration must be deterministic (two runs,
   identical keys, sorted, deduplicated) and every emitted candidate must
   pass its own admissibility predicate (TUNE001/TUNE002).
3. **Wire audit** (``repro_torch.analysis.wire_audit``) — opt-in via
   ``--wire``: the flashcp island, chunked and monolithic, on two gloo
   ranks on the CPU; each rank's forward bytes by collective kind must
   match the analytic comm budget (1% slack, WIRE101-WIRE103).
4. **Step audit** (``repro_torch.analysis.step_audit``) — opt-in via
   ``--train``: one smoke training step through the doc kernels on the
   card (their plain twins with ``--device cpu``) under a dispatch mode;
   no f64 and no host
   sync outside the device's named sites (STEP104/STEP105), the
   counterpart of the reference's ``--hlo-train``.
5. **Source lint** (``repro_torch.analysis.lint``) — unseeded RNG and
   set-order dependence in planner/dispatch/autotune code, deprecated
   shim imports, import hygiene, over the port's files.

Exit status 0 = no error-severity findings; 1 = at least one.

Usage::

    python scripts/flashcheck_torch.py           # lint + full plan sweep
    python scripts/flashcheck_torch.py --fast    # lint + 2-arch plan spot
    python scripts/flashcheck_torch.py --wire    # + the wire audit
    python scripts/flashcheck_torch.py --train   # + the step audit (card)
    python scripts/flashcheck_torch.py --train --device cpu    # on the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import errors, format_findings  # noqa: E402
from repro_torch.analysis.lint import (default_targets,  # noqa: E402
                                       lint_paths)
from repro_torch.analysis.plan_check import (  # noqa: E402
    check_block_tables, check_encoding, check_plan, check_serve_state,
    check_work_queue)

CONTEXT_LEN = 1024
CP_DEGREES = (1, 2, 4)
BLOCK = 128
FAST_ARCHS = ("starcoder2_3b", "xlstm_350m")

#: loose declared bound for the balanced planners (PLAN004); FlashCP's
#: Eq.3 objective lands far below this on every zoo mix — tripping it
#: means the balancer regressed, not that the mix is adversarial.
BALANCED_IMBALANCE = 1.5

#: the wire audit's island: two ranks, f32 K/V at (Hq, Hkv, D), one row
WIRE_WORLD = 2
WIRE_HEADS = (4, 2, 16)
WIRE_OVERLAPS = ("chunked", "none")


def arch_doc_mix(arch: str, context_len: int = CONTEXT_LEN) -> np.ndarray:
    """Deterministic per-arch document-length mix summing to the context.

    Seeded from a stable digest of the arch name (``hash()`` is
    process-salted), lognormal-ish so every arch exercises a different
    long-tail shape."""
    seed = int.from_bytes(
        hashlib.blake2b(arch.encode(), digest_size=4).digest(), "little")
    rng = np.random.default_rng(seed)
    lens: list[int] = []
    left = context_len
    while left > 0:
        d = int(min(max(rng.lognormal(mean=4.5, sigma=1.0), 8), left))
        lens.append(d)
        left -= d
    return np.asarray(lens, dtype=np.int64)


def _flashcp_kv_metadata(enc, num_workers: int):
    """Per-rank KV metadata of the blocking flashcp layout:
    ``[local | gathered-with-self-masked]`` (mirrors the concat in
    :func:`repro_torch.planner.encode.emit_visit_tables`)."""
    N = num_workers
    t_loc, buf = enc.t_loc, enc.buf_len
    ld = enc.doc.reshape(N, t_loc)
    lp = enc.pos.reshape(N, t_loc)
    L = enc.gath_doc.shape[-1]
    gd = np.broadcast_to(enc.gath_doc, (N, L)).copy()
    seg = np.arange(L) // buf
    gd[seg[None, :] == np.arange(N)[:, None]] = -2
    gp = np.broadcast_to(enc.gath_pos, (N, L))
    kd = np.concatenate([ld, gd], axis=-1)
    kp = np.concatenate([lp, gp], axis=-1)
    return ld, lp, kd, kp


def check_config(arch: str, cp: int, strategy: str | None = None) -> list:
    """Layer-1 sweep for one (arch, CP degree): plan, encoding, rect
    tables, and both flat work queues, under ``strategy`` (default: the
    one the training step would actually pick for the family)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.doc_attention import build_block_tables
    from repro_torch.launch.steps import effective_strategy
    from repro_torch.planner import encode_plan
    from repro_torch.planner.registry import get_planner

    cfg = get_config(arch)
    strategy = strategy or effective_strategy(cfg, "flashcp")
    planner = get_planner(strategy)
    doc_lens = arch_doc_mix(arch)
    ctx = f"{arch}/cp{cp}/{strategy}"

    plan = planner(doc_lens, cp)
    max_imb = BALANCED_IMBALANCE if strategy in ("flashcp", "bnb") else None
    out = check_plan(plan, max_imbalance=max_imb,
                     require_equal_tokens=planner.info.needs_equal_tokens,
                     context=f"{ctx}/plan")
    # rank slices aligned to the kernels' block, as the pipeline does
    enc = encode_plan(plan, align=BLOCK)
    out += check_encoding(plan, enc, context=f"{ctx}/encoding")

    if planner.info.comm_style == "flashcp":
        ld, lp, kd, kp = _flashcp_kv_metadata(enc, cp)
    else:  # full-exchange baselines attend the whole packed sequence
        t_loc = enc.t_loc
        ld = enc.doc.reshape(cp, t_loc)
        lp = enc.pos.reshape(cp, t_loc)
        kd = np.broadcast_to(enc.doc, (cp, enc.doc.shape[0]))
        kp = np.broadcast_to(enc.pos, (cp, enc.pos.shape[0]))

    t = build_block_tables(ld, lp, kd, kp, block_q=BLOCK, block_k=BLOCK)
    out += check_block_tables(ld, lp, kd, kp, t.kv_idx, t.kv_nvis,
                              block_q=BLOCK, block_k=BLOCK,
                              context=f"{ctx}/rect")
    out += check_work_queue(t.kv_idx, t.kv_nvis,
                            t.fq_row, t.fq_col, t.fq_flags,
                            context=f"{ctx}/flat-fq")
    out += check_work_queue(t.q_idx, t.q_nvis,
                            t.rq_row, t.rq_col, t.rq_flags,
                            context=f"{ctx}/flat-rq")
    return out


def check_serve_scenario() -> list:
    """SRV001-SRV003 over a live prefix-sharing scenario: two requests
    sharing a cached 3-block prefix, then the first request draining."""
    from repro_torch.serve.block_pool import BlockPool
    from repro_torch.serve.prefix import PrefixCache

    pool = BlockPool(num_blocks=32, block_size=16)
    pc = PrefixCache(block_size=16)
    tokens = list(range(100, 148))                   # 3 full blocks

    blocks_a = pool.alloc(4)                         # prefix + 1 unique
    pc.insert(tokens, blocks_a[:3], pool)
    shared = pc.match(tokens)
    pool.retain(shared)
    blocks_b = shared + pool.alloc(2)
    tables = {"req_a": list(blocks_a), "req_b": list(blocks_b)}
    out = check_serve_state(pool, tables, pc, context="serve/steady")

    pool.release(tables.pop("req_a"))                # req_a drains
    out += check_serve_state(pool, tables, pc, context="serve/drained")
    return out


def check_autotune() -> list:
    """Layer-2 sweep over small CPU-mesh search spaces: enumeration must
    be deterministic (sorted, deduplicated, stable across calls) and
    every emitted candidate must pass its own admissibility predicate
    (TUNE001/TUNE002)."""
    from repro_torch.analysis.findings import Finding
    from repro_torch.autotune import (TuneProblem, candidate_admissible,
                                      candidate_degrees,
                                      enumerate_candidates)

    problems = {
        "plain-2way": TuneProblem(data=1, model=2, context_len=512, seqs=2,
                                  quantum=1, attention_impl="plain"),
        "flash-2way": TuneProblem(data=1, model=2, context_len=CONTEXT_LEN,
                                  seqs=2, quantum=BLOCK,
                                  attention_impl="flash"),
        "hybrid-4way": TuneProblem(data=1, model=4, context_len=2048,
                                   seqs=2, quantum=BLOCK,
                                   attention_impl="flash",
                                   family="hybrid"),
    }
    out: list = []
    for name, problem in problems.items():
        cands = enumerate_candidates(problem)
        keys = [c.key() for c in cands]
        if keys != sorted(set(keys)):
            out.append(Finding(
                "TUNE001", "error", f"autotune/{name}",
                "enumeration is not sorted+deduplicated by Candidate.key",
                hint="enumerate_candidates must emit sorted unique keys"))
        rerun = [c.key() for c in enumerate_candidates(problem)]
        if rerun != keys:
            out.append(Finding(
                "TUNE001", "error", f"autotune/{name}",
                f"two enumerations disagree ({len(keys)} vs "
                f"{len(rerun)} candidates)",
                hint="enumeration must depend only on (problem, space)"))
        for cand in cands:
            if not candidate_admissible(cand, problem):
                out.append(Finding(
                    "TUNE002", "error", f"autotune/{name}",
                    f"enumerated candidate fails admissibility: "
                    f"{cand.key()}",
                    hint="enumerate_candidates must filter through "
                         "candidate_admissible"))
                continue
            degrees = candidate_degrees(cand, problem)
            bad = [g for g in degrees
                   if problem.model % g or problem.context_len % g]
            if not degrees or bad:
                out.append(Finding(
                    "TUNE002", "error", f"autotune/{name}",
                    f"candidate {cand.key()} has invalid degrees "
                    f"{bad or degrees}",
                    hint="cp_degree_options must enforce g | model and "
                         "g | context"))
    return out


def run_lint() -> list:
    return lint_paths(default_targets(ROOT), root=ROOT)


def wire_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One gloo CPU rank of the wire audit: the flashcp island on
    ``arch_doc_mix("starcoder2_3b")``, each overlap mode, its forward
    bytes by collective kind audited against the island's budget; the
    findings and counts go to ``<out_dir>/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis.wire_audit import audit_wire, island_budget
    from repro_torch.core.cp_attention import make_cp_context
    from repro_torch.launch.ranks import init_rank
    from repro_torch.planner import encode_plan_batch, get_planner

    comm, _ = init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)
    try:
        hq, hkv, d = WIRE_HEADS
        plan = get_planner("flashcp")(arch_doc_mix("starcoder2_3b"), world)
        stack, encs = encode_plan_batch([plan], align=16)
        t_loc = stack["doc"].shape[1] // world
        gen = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn((1, h, t_loc, d), generator=gen)
                   for h in (hq, hkv, hkv))
        arrays = {n: torch.from_numpy(np.ascontiguousarray(a))
                  for n, a in stack.items() if n != "perm"}
        found, counts = [], []
        for overlap in WIRE_OVERLAPS:
            ctx = make_cp_context(arrays, strategy="flashcp", impl="plain",
                                  head_dim=d, q_chunk=64, overlap=overlap,
                                  comm=comm)
            comm.reset_wire()
            ctx.attn(q, k, v)
            budget = island_budget("flashcp", overlap,
                                   buf_len=encs[0].buf_len,
                                   num_workers=world, kv_heads=hkv,
                                   head_dim=d, dtype_bytes=4)
            found += [dataclasses.asdict(f) for f in audit_wire(
                comm.wire_bytes_by_kind, budget,
                largest=comm.wire_peak_by_kind,
                context=f"wire/flashcp/{overlap}/rank{rank}")]
            counts.append({"counted": dict(comm.wire_bytes_by_kind),
                           "allowed": budget.allowed, "overlap": overlap})
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump({"findings": found, "counts": counts}, f)
    finally:
        dist.destroy_process_group()


def run_wire() -> list:
    """Spawn the wire audit's ranks; print each rank's counted against
    allowed bytes per overlap mode, and return their findings."""
    from repro_torch.analysis.findings import Finding
    from repro_torch.launch.ranks import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(wire_rank, WIRE_WORLD,
                    args=(WIRE_WORLD, f"{tmp}/store", tmp), timeout=240)
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(WIRE_WORLD)]
    for r, res in enumerate(ranks):
        for x in res["counts"]:
            print(f"[wire] rank {r} flashcp/{x['overlap']}: counted "
                  f"{ {k: v for k, v in x['counted'].items() if v} } "
                  f"allowed {x['allowed']}")
    return [Finding(**x) for res in ranks for x in res["findings"]]


def run_train_audit(device: str) -> list:
    """One smoke ``train_step`` (flash attention, the flat queue) on
    ``device`` under the step audit; prints its sites and returns its
    findings.  ``"cuda"`` raises where this process has no card."""
    from repro_torch.analysis.step_audit import audit_findings, audit_step
    from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import batch_to_device, build_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    device = resolve_device(device)
    cfg = reduce_for_smoke(get_config(FAST_ARCHS[0]))
    pipe = PipelineConfig(context_len=CONTEXT_LEN, batch_per_host=2,
                          cp_size=1, vocab_size=cfg.vocab_size, seed=0,
                          align=BLOCK, emit_tables=True, table_grid="flat")
    batch = batch_to_device(make_batch(pipe, 0), device)
    params = init_params(cfg, seed=0, device=device)
    opt = adamw_init(params)
    step = build_train_step(cfg, RunConfig(attention_impl="flash"),
                            device=device)
    _, audit = audit_step(step, params, opt, batch, 0)
    for key in sorted({s.key for s in audit.sites}):
        site = next(s for s in audit.sites if s.key == key)
        print(f"[train] site {site.render()}")
    print(f"[train] {audit.ops} ops, {len(audit.sites)} flagged")
    return audit_findings(audit.sites, device.type)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flashcheck_torch", description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="lint + plan checks on two small archs only")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the source-lint layer")
    ap.add_argument("--wire", action="store_true",
                    help="also audit the flashcp island's wire bytes "
                         "(2 gloo ranks on the CPU)")
    ap.add_argument("--train", action="store_true",
                    help="also audit one smoke training step for f64 and "
                         "host syncs")
    ap.add_argument("--device", default="cuda",
                    help="the step audit's device (cuda, the default, or "
                         "cpu)")
    args = ap.parse_args(argv)
    if args.train:
        from repro_torch.device import resolve_device
        resolve_device(args.device)     # no card: fail before the checks

    findings = []
    n_configs = 0

    if not args.no_lint:
        lint = run_lint()
        findings += lint
        print(f"[lint] {len(default_targets(ROOT))} files, "
              f"{len(errors(lint))} errors / "
              f"{len(lint) - len(errors(lint))} warnings")

    from repro_torch.configs import ARCHS
    archs = FAST_ARCHS if args.fast else tuple(ARCHS)
    cps = CP_DEGREES[:2] if args.fast else CP_DEGREES
    for arch in archs:
        for cp in cps:
            fs = check_config(arch, cp)
            findings += fs
            n_configs += 1
            if errors(fs):
                print(f"[plan] {arch} cp={cp}: "
                      f"{len(errors(fs))} errors")
    print(f"[plan] {n_configs} configs "
          f"({len(archs)} archs x CP{list(cps)}), "
          f"{len(errors(findings))} total errors so far")

    from repro_torch.planner import available_planners
    planners = available_planners()
    fs = [f for name in planners for cp in cps
          for f in check_config(FAST_ARCHS[0], cp, name)]
    findings += fs
    print(f"[plan] {len(planners)} planners x CP{list(cps)} on "
          f"{FAST_ARCHS[0]}'s mix: {len(errors(fs))} errors")

    fs = check_autotune()
    findings += fs
    print(f"[autotune] 3 search spaces: {len(errors(fs))} errors")

    if not args.fast:
        fs = check_serve_scenario()
        findings += fs
        print(f"[serve] prefix-sharing scenario: "
              f"{len(errors(fs))} errors")

    if args.wire:
        fs = run_wire()
        findings += fs
        print(f"[wire] flashcp island at N={WIRE_WORLD}, "
              f"{'/'.join(WIRE_OVERLAPS)}: {len(errors(fs))} errors")

    if args.train:
        fs = run_train_audit(args.device)
        findings += fs
        print(f"[train] smoke train_step on {args.device}: "
              f"{len(errors(fs))} errors")

    if findings:
        print()
        print(format_findings(findings))
    errs = errors(findings)
    print(f"\nflashcheck_torch: {len(errs)} error(s), "
          f"{len(findings) - len(errs)} warning(s)")
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
