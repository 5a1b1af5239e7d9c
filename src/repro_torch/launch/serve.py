"""Serving CLI of the port: the paged-KV continuous-batching engine.

Builds a :class:`repro_torch.serve.ServeEngine`, submits a ragged mix of
requests and drains it: budgeted cache-writing prefill and ragged
flash-decode over a paged KV block pool (``--kv-layout dense`` keeps
per-slot stripes as the parity oracle; ``--decode-impl dense`` selects
the softmax attention oracle), greedy or temperature/top-k sampling,
and admission/retirement mid-flight (more requests than ``--slots``
exercises continuous batching).  ``--shared-prefix N`` prepends the same
N-token system prompt to every request, exercising prefix-cache block
sharing; ``--serial`` disables the unified token-budget step.

Prefill and decode are timed and counted separately: prompt tokens and
the prefill-produced first token are prefill output; decode tok/s
covers decode steps only.

On the GPU (the default device):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \
        --requests 12 --slots 6 --prompt-len 1024 --gen 32 \
        --prefill-chunk 128 --shared-prefix 128

On the CPU, at smoke size:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --requests 4 --prompt-len 64 --gen 16 --shared-prefix 16

MoE archs serve the same way (``--arch olmoe_1b_7b``, all 16 layers fit
one H100): prefill chunks route drop-free, decode at the config's
capacity factor over the slot rows, as the reference does.

The recurrent archs (``--arch jamba_v0_1_52b``, ``xlstm_350m``) keep the
dense layout (``auto`` picks it; ``paged`` is refused) and replay each
prompt through the decode step at admission.  xlstm_350m serves at full
size on one H100; jamba's 32 layers (103 GB of bf16 weights) do not fit
one (``chip_smoke.py`` serves it cut to one period of 8 layers).

The audio arch (``--arch musicgen_medium``) gives each request its own
frame embeddings, drawn from the seed: prompts prefill from them (and
share no prefix-cache blocks), decode steps feed zero frames.  The VLM
arch (``--arch internvl2_1b``) serves token prompts, prefilled with zero
patches.

``--attn-shards N`` splits the dense-layout decode cache into N
LSE-merged segments (``flash_decode`` in partial mode per segment).

Resilience (DESIGN.md §Serving-resilience): ``--max-queue`` bounds the
queue and ``--admission deadline`` sheds the least-slack request under
overload (``--deadline N`` gives every request an N-step deadline);
``--chaos-nan RID:STEP`` / ``--chaos-stuck RID:STEP`` /
``--chaos-delay STEP:SECONDS`` inject faults the watchdog must
quarantine; ``--kill-at STEP`` with ``--snapshot-every N --snapshot-dir
D`` kills the engine mid-run and restores a fresh one from the latest
snapshot in-process (``--drain-at STEP`` is the orderly variant:
snapshot, stop, restore).  Every submitted request ends in the results:
ok, rejected, shed or aborted.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --requests 6 --slots 3 --prompt-len 48 --gen 8 --chaos-nan 1:6 \
        --chaos-stuck 2:4 --kill-at 9 --snapshot-every 3 --snapshot-dir snap
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.serve import EngineKilled, ServeEngine, parse_chaos

_RC = RunConfig()   # serve defaults live on RunConfig (single source)


def serve(args) -> dict:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)

    B, Tp, gen = args.requests, args.prompt_len, args.gen
    slots = args.slots or min(B, 8)
    rng = np.random.default_rng(args.seed)

    # ragged prompt mix: lengths in [Tp/4, Tp], one request at the full Tp
    lens = np.full((B,), Tp, np.int64)
    if args.ragged and B > 1:
        lens[1:] = rng.integers(max(1, Tp // 4), Tp + 1, (B - 1,))
    lens = np.maximum(lens, args.shared_prefix + 1)
    max_len = int(lens.max() + gen)

    chaos = parse_chaos(args.chaos_nan, args.chaos_stuck, args.chaos_delay,
                        kill_at=args.kill_at)

    def build(with_chaos):
        eng = ServeEngine(
            cfg, device=args.device, num_slots=slots, max_len=max_len,
            prefill_chunk=args.prefill_chunk, decode_impl=args.decode_impl,
            attn_shards=args.attn_shards, seed=args.seed,
            kv_layout=args.kv_layout, block_size=args.block_size,
            num_blocks=args.num_blocks, token_budget=args.token_budget,
            prefix_cache=args.prefix_cache, unified=args.unified,
            max_queue=args.max_queue, admission=args.admission,
            admit_lookahead=args.admit_lookahead, watchdog=args.watchdog,
            stall_patience=args.stall_patience, chaos=with_chaos)
        eng.warmup()
        return eng

    eng = build(chaos)

    sys_prompt = rng.integers(0, cfg.vocab_size, args.shared_prefix) \
        .astype(np.int32)
    for i in range(B):
        frames = None
        if cfg.frontend == "audio_frames":
            # the request's own frame embeddings reach the KV cache
            # through prefill (drawn as the reference draws them)
            frames = rng.standard_normal(
                (int(lens[i]), cfg.d_model)).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size,
                            int(lens[i]) - args.shared_prefix) \
            .astype(np.int32)
        eng.submit(np.concatenate([sys_prompt, toks]), max_new=gen,
                   temperature=args.temperature, top_k=args.top_k,
                   frames=frames, deadline_steps=args.deadline)

    t0 = time.perf_counter()
    restored_from = None
    try:
        results = eng.run(max_steps=args.max_steps,
                          snapshot_every=args.snapshot_every,
                          snapshot_dir=args.snapshot_dir or None,
                          drain_at=args.drain_at)
        interrupted = args.drain_at >= 0 and eng.sched.has_work
        if interrupted:
            print(f"[serve] drained at step {eng.stats['steps']} into "
                  f"{args.snapshot_dir}")
    except EngineKilled as e:
        print(f"[serve] {e}; restoring from {args.snapshot_dir}")
        interrupted = True
    if interrupted:
        # the restart-from-snapshot round trip, in-process: a fresh engine
        # (no chaos: the fault fired) resumes the in-flight work
        eng = build(None)
        restored_from = eng.restore_snapshot(args.snapshot_dir)
        print(f"[serve] restored snapshot at step {restored_from}; "
              "resuming")
        results = eng.run(max_steps=args.max_steps)
    wall = time.perf_counter() - t0
    # every submitted request terminates in the results: a lost rid is
    # a bug, fail loudly
    missing = [r for r in range(B) if r not in results]
    if missing:
        raise RuntimeError(f"requests lost from results: {missing}")

    s = eng.stats
    tp = eng.throughput()
    print(f"[serve] {cfg.name} on {eng.device}: {B} requests ({slots} "
          f"slots, prompts {lens.min()}..{lens.max()}, gen {gen}, "
          f"kv_layout={eng.layout}, decode_impl={eng.decode_impl})")
    print(f"[serve] prefill: {s['prefill_tokens']} prompt tokens "
          f"({s['prefill_chunk_tokens']} computed, "
          f"{s['prefill_cached_tokens']} prefix-cached) in "
          f"{s['prefill_steps']} chunk steps + "
          f"{s['prefill_decode_steps']} replay steps, {s['prefill_s']:.2f}s "
          f"({tp['prefill_tok_s']:.1f} computed tok/s, "
          f"{tp['prefill_effective_tok_s']:.1f} effective)")
    print(f"[serve] decode:  {s['decode_tokens']} tokens in "
          f"{s['decode_steps']} steps, {s['decode_s']:.2f}s "
          f"({tp['decode_tok_s']:.1f} tok/s); wall {wall:.2f}s; "
          f"stalled decode steps {s['stalled_decode_steps']}")
    if eng.layout == "paged":
        ps = eng.pool.stats()
        print(f"[serve] pool:    {ps['allocated']}/{ps['num_blocks']} "
              f"blocks live (peak {ps['peak_allocated']}, block_size "
              f"{ps['block_size']}), cow {s['cow_copies']}, "
              f"backoffs {s['admission_backoffs']}")
        if eng.prefix is not None:
            xs = eng.prefix.stats()
            print(f"[serve] prefix:  {xs['nodes']} cached blocks, "
                  f"hit rate {xs['hit_rate']:.2f} "
                  f"({xs['hit_tokens']} tokens skipped)")
    statuses: dict[str, int] = {}
    for r in results.values():
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    lat = eng.latency_percentiles()
    print(f"[serve] outcomes: {statuses}; "
          f"rejected {s['rejected_by_reason']}, "
          f"shed {s['shed_by_reason']}, aborted {s['aborted_by_reason']}")
    print(f"[serve] latency (ok): p50 {lat['p50_steps']:.0f} steps / "
          f"{lat['p50_s'] * 1e3:.0f} ms, p99 {lat['p99_steps']:.0f} "
          f"steps / {lat['p99_s'] * 1e3:.0f} ms"
          + (f"; restored from step {restored_from}"
             if restored_from is not None else ""))
    return {"results": results, "stats": dict(s), "throughput": tp,
            "prompt_lens": lens, "kv_layout": eng.layout, "latency": lat,
            "wall_s": wall, "restored_from": restored_from,
            "pool": None if eng.pool is None else eng.pool.stats(),
            "prefix": None if eng.prefix is None else eng.prefix.stats(),
            "tokens": {r: results[r]["tokens"] for r in results
                       if results[r]["status"] == "ok"}}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=_RC.arch)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0,
                    help="cache slots (0 = min(requests, 8))")
    ap.add_argument("--prompt-len", type=int, default=64, dest="prompt_len")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    dest="prefill_chunk")
    ap.add_argument("--decode-impl", choices=("flash", "dense"),
                    default=_RC.decode_impl, dest="decode_impl")
    ap.add_argument("--attn-shards", type=int, default=1,
                    dest="attn_shards",
                    help="LSE-merged segments of the dense decode cache")
    ap.add_argument("--kv-layout", choices=("auto", "paged", "dense"),
                    default=_RC.kv_layout, dest="kv_layout")
    ap.add_argument("--block-size", type=int, default=_RC.serve_block_size,
                    dest="block_size", help="tokens per paged KV block")
    ap.add_argument("--num-blocks", type=int, default=0, dest="num_blocks",
                    help="pool blocks (0 = dense-equivalent capacity)")
    ap.add_argument("--token-budget", type=int,
                    default=_RC.serve_token_budget, dest="token_budget",
                    help="tokens per unified step (0 = slots + chunk)")
    ap.add_argument("--no-prefix-cache", action="store_false",
                    dest="prefix_cache",
                    help="disable cross-request prefix block sharing")
    ap.add_argument("--serial", action="store_false", dest="unified",
                    help="drain prefill before decode (stall baseline)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    dest="shared_prefix",
                    help="shared system-prompt tokens per request")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0, dest="top_k")
    ap.add_argument("--uniform", action="store_false", dest="ragged",
                    help="all prompts at --prompt-len (default: ragged)")
    ap.add_argument("--seed", type=int, default=_RC.seed)
    ap.add_argument("--max-queue", type=int, default=_RC.serve_max_queue,
                    dest="max_queue", help="queue bound (0 = unbounded)")
    ap.add_argument("--admission", choices=("fifo", "deadline"),
                    default=_RC.serve_admission)
    ap.add_argument("--admit-lookahead", type=int,
                    default=_RC.serve_admit_lookahead,
                    dest="admit_lookahead")
    ap.add_argument("--deadline", type=int, default=-1,
                    help="deadline_steps of every request (-1 = none)")
    ap.add_argument("--no-watchdog", action="store_false", dest="watchdog")
    ap.add_argument("--stall-patience", type=int,
                    default=_RC.serve_stall_patience, dest="stall_patience")
    ap.add_argument("--chaos-nan", action="append", default=[],
                    dest="chaos_nan", metavar="RID:STEP",
                    help="poison a request's logits to NaN from STEP on")
    ap.add_argument("--chaos-stuck", action="append", default=[],
                    dest="chaos_stuck", metavar="RID:STEP",
                    help="drop a request's planned work from STEP on")
    ap.add_argument("--chaos-delay", action="append", default=[],
                    dest="chaos_delay", metavar="STEP:SECONDS",
                    help="inject a latency spike at STEP")
    ap.add_argument("--kill-at", type=int, default=-1, dest="kill_at",
                    help="raise EngineKilled at this step (restore needs "
                         "--snapshot-every and --snapshot-dir)")
    ap.add_argument("--drain-at", type=int, default=-1, dest="drain_at",
                    help="orderly drain: snapshot and stop at this step, "
                         "then restore and finish in-process")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    dest="snapshot_every",
                    help="snapshot the engine every N steps")
    ap.add_argument("--snapshot-dir", default="", dest="snapshot_dir")
    ap.add_argument("--max-steps", type=int, default=100_000,
                    dest="max_steps")
    return ap


def main(argv=None):
    serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
