"""Run one cell of the benchmark once and print its result line.

    python3 -m cpbench.run --workload sc2_3b_e32.train.wlb_llm --seed 7 \\
        --seconds 30 --trace 0

Set-up (timed as ``setup_s``, from the process's start): the port's CUDA
kernels are built or loaded (``src/repro_torch/kernels/build/`` of the
checkout); the weights are drawn from the seed on the card; the
training step is built; the first steps run through the window's own
call and feed, and the port's loss, first gradient and parameter change
are read from its state.  The window then trains for ``--seconds``
seconds, every step ending the way the port's ``train()`` ends one, on
``float(loss)``.  After it the port's state is freed and the plain
reference (``reference.py``) trains the same first steps from the same
weights; ``check.py`` compares the two sides against the cell's limits.
With ``--trace 1`` the window runs under ``torch.profiler`` and the
cell's per-layer metrics are read from the trace (``metrics/*.py``).

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which also end standard error).  The per-step times go to
``cpbench/out/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from .manifest import (HERE, load_cell, load_reader, load_reference,  # noqa: E402
                       load_runner)

__all__ = ["main", "run_cell", "RunRecord", "FORBIDDEN", "forbidden_loaded"]

#: top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WINDOW_SPAN = "cpbench.window"
OUT = HERE / "out"
#: the compared first steps: the set-up's steps, which the reference
#: follows
CHECK_STEPS = 2


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


@dataclasses.dataclass
class RunRecord:
    """What a per-layer reader reads: the cell, the window's steps (each
    ``{"wait_s", "step_s", "plan_s", "plans", "plan_hits", "tokens",
    "doc_lens"}``), the trace (None
    without ``--trace 1``) and the card's published peaks."""
    cell: object
    steps: list
    trace: object
    peaks: dict


@torch.no_grad()
def _norms(tree_flat: dict, scale: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) * scale
            for k, v in tree_flat.items()}


@torch.no_grad()
def _change_norms(master: dict, weights) -> dict:
    """{leaf: ||master - start||} with the start's leaves from
    ``weights`` (a generator of (path, tensor)), a slice at a time."""
    from .reference import _slices

    out = {}
    for path, w0 in weights:
        sq = torch.zeros((), dtype=torch.float64, device=w0.device)
        for a, b in _slices(master[path], w0):
            sq += torch.sum((a - b.float()) ** 2, dtype=torch.float64)
        out[path] = math.sqrt(float(sq))
        del w0
    return out


def _reference(module, spec, seed, dev, rows_per_step, precision="fp32",
               drop_half=False, steps=CHECK_STEPS) -> dict:
    """The reference's losses, first clipped gradient norms and change
    norms over ``steps`` steps of ``rows_per_step``."""
    from .reference import Reference, make_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(module, spec, dict(make_weights(module, spec, seed, dev)),
                    dev, precision)
    out = {"losses": []}
    for step in range(steps):
        rows = [(r.doc_lens, r.tokens, r.labels) for r in rows_per_step[step]]
        out["losses"].append(ref.loss_and_grads(rows, drop_half=drop_half))
        ref.apply(step)
        if step == 0:
            out["grad_norms"] = ref.grad_norms()
    del ref.g, ref.mu, ref.nu
    out["change_norms"] = _change_norms(ref.p, make_weights(module, spec,
                                                            seed, dev))
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float = T_START, fault=None) -> dict:
    """One run of ``cell``; returns the result dict.  ``fault`` (a
    callable of the port's step, or None) replaces the timed step by a
    broken one, for the tests that show ``correct`` fails."""
    from .check import judge, readings
    from .flops import peaks, window_flops
    from .port import (Feed, Prefetch, check_optimizer, flatten,
                       import_port, mark_doc_attention, model_config,
                       run_config, to_tree)
    from .reference import make_weights
    from .traffic import Traffic

    phases = {}     # set-up's phases, seconds from t_start, to the steps file

    def mark(name):
        phases[name] = time.perf_counter() - t_start

    mark("entry")
    import_port()
    from repro_torch.launch.steps import batch_to_device, build_train_step
    from repro_torch.optim import adamw_init

    spec = cell.spec
    module = load_reference(spec.reference)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if cuda:
        from repro_torch.kernels._build import doc_attention_lib

        torch.cuda.set_device(dev)
        doc_attention_lib()
    mark("kernels")
    check_optimizer(spec)
    cfg, run = model_config(spec, module.PORT_MODEL), run_config(spec, seed)
    params = to_tree(dict(make_weights(module, spec, seed, dev)))
    opt = adamw_init(params)
    mark("weights")
    step_fn = build_train_step(cfg, run, q_chunk=spec.train["q_chunk"],
                               device=dev)
    if fault is not None:
        step_fn = fault(step_fn)
    traffic = Traffic(cell.mix, spec.vocab, seed)
    pf = Prefetch(Feed(traffic, spec))
    b1 = spec.train["betas"][0]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def one_step(step):
        """One step as the port's ``train()`` runs it with
        ``--prefetch``; returns (loss, rows, seconds waited, the batch's
        stats)."""
        t0 = time.perf_counter()
        batch, rows = next(pf)
        waited = time.perf_counter() - t0
        metrics = step_fn(params, opt, batch_to_device(batch, dev), step)
        loss = float(metrics["loss"])
        sync()
        for k in ("grad_norm", "lr", "tokens", "aux"):
            float(metrics[k])
        return loss, rows, waited, batch["stats"]

    try:
        prog, seen = {"losses": []}, []
        for step in range(CHECK_STEPS):
            loss, rows, _, _ = one_step(step)
            prog["losses"].append(loss)
            seen.append(rows)
            mark(f"step{step}")
            if step == 0:
                prog["grad_norms"] = _norms(flatten(opt["mu"]),
                                            1.0 / (1.0 - b1))
        master = flatten(opt["master"] if "master" in opt else params)
        prog["change_norms"] = _change_norms(
            master, make_weights(module, spec, seed, dev))
        sync()
        setup_s = time.perf_counter() - t_start

        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        steps, prof = [], None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
        with (mark_doc_attention() if trace else contextlib.nullcontext()), \
                torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            step = CHECK_STEPS
            while True:
                ts = time.perf_counter()
                loss, rows, waited, stats = one_step(step)
                t1 = time.perf_counter()
                steps.append({"step": step, "loss": loss, "wait_s": waited,
                              "step_s": t1 - ts, "plan_s": stats["plan_s"],
                              "plans": len(rows),
                              "plan_hits": stats["plan_hits"],
                              "tokens": sum(int((r.labels >= 0).sum())
                                            for r in rows),
                              "doc_lens": [r.doc_lens.tolist()
                                           for r in rows]})
                step += 1
                if t1 - t0 >= seconds:
                    break
        window_s = t1 - t0
        trace_path = None
        if prof is not None:
            prof.__exit__(None, None, None)
            OUT.mkdir(parents=True, exist_ok=True)
            trace_path = OUT / f"{cell.name}.trace.json"
            prof.export_chrome_trace(str(trace_path))
            del prof
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    finally:
        pf.close()
    del params, opt, step_fn, master
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = _reference(module, spec, seed, dev, seen)
    read = readings(prog, ref)
    read["reference_s"] = time.perf_counter() - t_ref
    correct, checks = judge(read, cell.limits["limits"])
    failed = sum(1 for s in steps if not math.isfinite(s["loss"]))
    correct = correct and failed == 0

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    pk = peaks(kind) if cuda else None
    tokens = sum(s["tokens"] for s in steps)
    device_out = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(steps),
              "failed": failed}
    record = RunRecord(cell, steps, None, pk)
    if trace_path is not None:
        from .port import DOC_ATTN_SPAN
        from .trace import read_trace

        record.trace = read_trace(trace_path, WINDOW_SPAN, DOC_ATTN_SPAN)
        trace_path.unlink()
        device_out["busy_s"] = record.trace.busy_s()
        device_out["window_s"] = record.trace.window_s
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": record.trace.top_ops(10),
                               "idle_gaps": record.trace.idle_gaps(10)}
    else:
        values = {"train_tokens_per_s": tokens / window_s,
                  "mfu": None if pk is None else
                  100.0 * window_flops(spec, steps)
                  / (window_s * pk["bf16_flops_per_s"] * cell.chips),
                  "peak_mem_gib": peak / 2 ** 30,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"])
                   is not None}
    result["metrics"] = metrics
    result["device"] = device_out
    result["plan_cache"] = {"plans": sum(s["plans"] for s in steps),
                            "hits": sum(s["plan_hits"] for s in steps)}
    result["readings"] = {k: v for k, v in read.items()
                          if k not in checks}
    result["checks"] = checks
    _write_steps(cell.name, seed, trace, steps, setup_s, window_s, phases)
    return result


def _write_steps(name, seed, trace, steps, setup_s, window_s,
                 phases) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{name}.seed{seed}.trace{int(trace)}.steps.json"
    path.write_text(json.dumps({"setup_s": setup_s, "window_s": window_s,
                                "setup_phases": phases,
                                "steps": [{k: v for k, v in s.items()
                                           if k != "doc_lens"}
                                          for s in steps]}))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    _cache_dirs()
    cell = load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"cpbench: {args.workload} needs {cell.chips} CUDA devices; "
              f"this process sees {have}", file=sys.stderr)
        return 3
    try:
        runner = load_runner(cell.chips)
    except FileNotFoundError as err:
        print(f"cpbench: {args.workload}: {err}", file=sys.stderr)
        return 3
    result = runner(cell, args.seed, args.seconds, bool(args.trace),
                    T_START)
    found = forbidden_loaded()
    if found:
        print(f"cpbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
