"""The port's static verifier (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the same numpy inputs.

* ``RULES``: the reference's registry minus the rules that read XLA or
  Pallas program text (HLO101-HLO106, KER001), plus WIRE101-WIRE103 and
  STEP104-STEP105,
  with the reference's text.
* The plan checks (PLAN, ENC, TAB, WQ, SRV): the port's functions on the
  port's plans, encodings, tables and serving pool give the reference's
  findings on the reference's (rule, severity, location and message
  equal), clean on three planners at CP 2 and 4, and after each fault
  injection of ``tests/test_analysis.py`` (one case per rule).
* The lint: the reference test's snippets give the reference's findings,
  KER001 excepted and DEP001 under the port's module name; the port's
  own files lint clean; ``scripts/flashcheck_torch.py --fast`` exits 0.
* The wire budget (``kv_exchange_budget``) equals the reference's
  ``hlo_audit`` budget with the port's kind names.
"""

import copy
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import repro.analysis.findings as jfind
import repro.analysis.hlo_audit as jhlo
import repro.analysis.lint as jlint
import repro.analysis.plan_check as jpc
import repro.kernels.doc_attention as jda
import repro.planner as jpl
import repro.serve.block_pool as jpool
import repro.serve.prefix as jprefix
import repro_torch.analysis.findings as tfind
import repro_torch.analysis.lint as tlint
import repro_torch.analysis.plan_check as tpc
import repro_torch.analysis.wire_audit as twire
import repro_torch.kernels.doc_attention as tda
import repro_torch.planner as tpl
import repro_torch.serve.block_pool as tpool
import repro_torch.serve.prefix as tprefix

ROOT = Path(__file__).resolve().parent.parent
DOC_LENS = np.asarray([300, 120, 260, 180, 164], dtype=np.int64)  # sum 1024
N = 4

#: the two packages' modules, so every scenario runs once on each
PKGS = {
    "ref": types.SimpleNamespace(pc=jpc, pl=jpl, da=jda, pool=jpool,
                                 prefix=jprefix),
    "port": types.SimpleNamespace(pc=tpc, pl=tpl, da=tda, pool=tpool,
                                  prefix=tprefix),
}


def _rows(findings):
    return [(f.rule, f.severity, f.location, f.message, f.hint)
            for f in findings]


def _both(fn, *args):
    """``fn(pkg, *args)`` on the reference and on the port: their
    findings as comparable rows."""
    return {name: _rows(fn(P, *args)) for name, P in PKGS.items()}


def test_rules_are_the_references_minus_program_text_plus_wire():
    dropped = {f"HLO10{i}" for i in range(1, 7)} | {"KER001"}
    wire = {"WIRE101", "WIRE102", "WIRE103"}
    step = {"STEP104", "STEP105"}
    assert set(tfind.RULES) == (set(jfind.RULES) - dropped) | wire | step
    for rule in set(tfind.RULES) - wire - step:
        assert tfind.RULES[rule] == jfind.RULES[rule], rule
    # the step audit's f64 rule is the reference's HLO104
    assert tfind.RULES["STEP104"] == jfind.RULES["HLO104"]
    # the wire rules keep the collective rules' invariants
    for i in (1, 2):
        assert tfind.RULES[f"WIRE10{i}"].split()[-3:] == \
            jfind.RULES[f"HLO10{i}"].split()[-3:]
    with pytest.raises(AssertionError):
        tfind.Finding("HLO101", "error", "x", "msg")
    f = tfind.Finding("WIRE102", "error", "here", "msg", hint="do x")
    assert f.render() == jfind.Finding("HLO102", "error", "here", "msg",
                                       hint="do x").render() \
        .replace("HLO102", "WIRE102")


# ------------------------------------------------------------------ #
# Layer 1 on clean inputs
# ------------------------------------------------------------------ #
def _rank_metadata(enc, n, style):
    """Per-rank (q doc, q pos, kv doc, kv pos) of the blocking layout:
    ``[local | gathered w/ self-masked]`` for flashcp, the whole packed
    sequence for the full-exchange baselines."""
    ld = enc.doc.reshape(n, enc.t_loc)
    lp = enc.pos.reshape(n, enc.t_loc)
    if style != "flashcp":
        return (ld, lp, np.broadcast_to(enc.doc, (n, enc.doc.shape[0])),
                np.broadcast_to(enc.pos, (n, enc.pos.shape[0])))
    L = enc.gath_doc.shape[-1]
    gd = np.broadcast_to(enc.gath_doc, (n, L)).copy()
    seg = np.arange(L) // enc.buf_len
    gd[seg[None, :] == np.arange(n)[:, None]] = -2
    gp = np.broadcast_to(enc.gath_pos, (n, L))
    return (ld, lp, np.concatenate([ld, gd], -1),
            np.concatenate([lp, gp], -1))


def _clean_sweep(P, name, n):
    planner = P.pl.get_planner(name)
    plan = planner(DOC_LENS, n)
    out = P.pc.check_plan(
        plan, max_imbalance=1.5 if name == "flashcp" else None,
        require_equal_tokens=planner.info.needs_equal_tokens,
        context=f"{name}/cp{n}/plan")
    enc = P.pl.encode_plan(plan)
    out += P.pc.check_encoding(plan, enc, context=f"{name}/cp{n}/enc")
    ld, lp, kd, kp = _rank_metadata(enc, n, planner.info.comm_style)
    t = P.da.build_block_tables(ld, lp, kd, kp, block_q=128, block_k=128)
    out += P.pc.check_block_tables(ld, lp, kd, kp, t.kv_idx, t.kv_nvis,
                                   block_q=128, block_k=128,
                                   context=f"{name}/cp{n}/rect")
    out += P.pc.check_work_queue(t.kv_idx, t.kv_nvis, t.fq_row, t.fq_col,
                                 t.fq_flags, context=f"{name}/cp{n}/fq")
    out += P.pc.check_work_queue(t.q_idx, t.q_nvis, t.rq_row, t.rq_col,
                                 t.rq_flags, context=f"{name}/cp{n}/rq")
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["flashcp", "llama3", "per_doc"])
def test_clean_plans_match_reference(name, n):
    got = _both(_clean_sweep, name, n)
    assert got["port"] == got["ref"] == []


# ------------------------------------------------------------------ #
# Layer 1 after each fault injection of tests/test_analysis.py
# ------------------------------------------------------------------ #
def _plan(P, name="flashcp"):
    return P.pl.get_planner(name)(DOC_LENS, N)


def inj_double_cover(P):
    plan = _plan(P)
    plan.arrays.length[0] += 1
    return P.pc.check_plan(plan, require_equal_tokens=False)


def inj_gap(P):
    plan = _plan(P)
    plan.arrays.length[0] -= 1
    return P.pc.check_plan(plan, require_equal_tokens=False)


def inj_out_of_range(P):
    plan = _plan(P)
    plan.arrays.worker[0] = N + 3
    return P.pc.check_plan(plan)


def inj_unequal_tokens(P):
    plan = _plan(P, "contiguous")
    plan.arrays.worker[0] = (plan.arrays.worker[0] + 1) % N
    return P.pc.check_plan(plan, require_equal_tokens=True)


def inj_imbalance(P):
    plan = _plan(P)
    return P.pc.check_plan(plan, max_imbalance=plan.imbalance_ratio() * 0.5)


def inj_corrupt_perm(P):
    plan = _plan(P)
    enc = copy.deepcopy(P.pl.encode_plan(plan))
    valid = np.flatnonzero(enc.perm >= 0)
    enc.perm[valid[0]] = enc.perm[valid[1]]
    return P.pc.check_encoding(plan, enc)


def inj_bad_pos(P):
    plan = _plan(P)
    enc = copy.deepcopy(P.pl.encode_plan(plan))
    i = int(np.flatnonzero(enc.perm >= 0)[3])
    enc.pos[i] += 1
    return P.pc.check_encoding(plan, enc)


def inj_dropped_send(P):
    plan = _plan(P)
    enc = copy.deepcopy(P.pl.encode_plan(plan))
    j, s = np.unravel_index(int(np.argmax(enc.send_idx >= 0)),
                            enc.send_idx.shape)
    enc.send_idx[j, s:] = np.roll(enc.send_idx[j, s:], -1)
    enc.send_idx[j, -1] = -1
    flat = j * enc.buf_len + s
    end = (j + 1) * enc.buf_len
    enc.gath_doc[flat:end] = np.roll(enc.gath_doc[flat:end], -1)
    enc.gath_pos[flat:end] = np.roll(enc.gath_pos[flat:end], -1)
    enc.gath_doc[end - 1] = -1
    enc.gath_pos[end - 1] = 0
    return P.pc.check_encoding(plan, enc)


def inj_redundant_send(P):
    """A last-shard token appended to a send buffer's padding (Eq.5's
    redundant exchange)."""
    plan = _plan(P)
    enc = copy.deepcopy(P.pl.encode_plan(plan))
    a = plan.arrays
    last = a.is_last(plan.doc_lens)
    for j in range(N):
        free = np.flatnonzero(enc.send_idx[j] < 0)
        mine = np.flatnonzero((a.worker == j) & last)
        if len(free) and len(mine):
            break
    # the first token of that last shard, at its local plan slot
    loc = np.flatnonzero(
        enc.perm[j * enc.t_loc:(j + 1) * enc.t_loc] >= 0)
    doc_start = np.concatenate([[0], np.cumsum(plan.doc_lens)])
    packed = doc_start[a.doc_id[mine[0]]] + a.start[mine[0]]
    li = loc[enc.perm[j * enc.t_loc + loc] == packed][0]
    enc.send_idx[j, free[0]] = li
    enc.gath_doc[j * enc.buf_len + free[0]] = enc.doc[j * enc.t_loc + li]
    enc.gath_pos[j * enc.buf_len + free[0]] = enc.pos[j * enc.t_loc + li]
    return P.pc.check_encoding(plan, enc)


def _flashcp_tables(P):
    enc = P.pl.encode_plan(_plan(P))
    ld, lp, kd, kp = _rank_metadata(enc, N, "flashcp")
    return (ld, lp, kd, kp), P.da.build_block_tables(
        ld, lp, kd, kp, block_q=128, block_k=128)


def inj_pruned_table(P):
    meta, t = _flashcp_tables(P)
    idx, nvis = t.kv_idx.copy(), t.kv_nvis.copy()
    idx[0, 0, :-1] = idx[0, 0, 1:]
    nvis[0, 0] -= 1
    return P.pc.check_block_tables(*meta, idx, nvis, block_q=128,
                                   block_k=128)


def inj_table_range(P):
    meta, t = _flashcp_tables(P)
    idx = t.kv_idx.copy()
    idx[0, 0, 0] = 99
    return P.pc.check_block_tables(*meta, idx, t.kv_nvis, block_q=128,
                                   block_k=128)


def inj_misflagged_queue(P):
    _, t = _flashcp_tables(P)
    flags = t.fq_flags.copy()
    b, s = np.unravel_index(int(np.argmax((flags & P.da.FLAG_LAST) > 0)),
                            flags.shape)
    flags[b, s] &= ~P.da.FLAG_LAST
    return P.pc.check_work_queue(t.kv_idx, t.kv_nvis, t.fq_row, t.fq_col,
                                 flags)


def inj_non_lpt(P):
    idx = np.asarray([[[0, 1], [1, 0]]], dtype=np.int32)
    nvis = np.asarray([[2, 1]], dtype=np.int32)
    row, col, flags = P.da.build_work_queue(idx, nvis)
    perm = np.asarray([2, 0, 1])
    return P.pc.check_work_queue(idx, nvis, row[:, perm], col[:, perm],
                                 flags[:, perm])


def inj_dropped_visit(P):
    _, t = _flashcp_tables(P)
    col = t.fq_col.copy()
    b, s = np.unravel_index(
        int(np.argmax((t.fq_flags & P.da.FLAG_VALID) > 0)), col.shape)
    col[b, s] = (col[b, s] + 1) % t.kv_idx.shape[-1]
    return P.pc.check_work_queue(t.kv_idx, t.kv_nvis, t.fq_row, col,
                                 t.fq_flags)


def _serve_scenario(P):
    pool = P.pool.BlockPool(num_blocks=16, block_size=4)
    pc = P.prefix.PrefixCache(block_size=4)
    tokens = list(range(50, 62))
    a = pool.alloc(4)
    pc.insert(tokens, a[:3], pool)
    shared = pc.match(tokens)
    pool.retain(shared)
    b = shared + pool.alloc(1)
    return pool, pc, {"a": list(a), "b": list(b)}


def inj_leaked_reference(P):
    pool, pc, tables = _serve_scenario(P)
    pool.retain([tables["a"][0]])
    return P.pc.check_serve_state(pool, tables, pc)


def inj_unregistered_sharing(P):
    pool, pc, tables = _serve_scenario(P)
    tables["c"] = [tables["a"][3]]
    pool.retain(tables["c"])
    return P.pc.check_serve_state(pool, tables, pc)


def inj_out_of_pool_block(P):
    pool, pc, tables = _serve_scenario(P)
    tables["a"][-1] = 99
    return P.pc.check_serve_state(pool, tables, pc)


def serve_clean(P):
    pool, pc, tables = _serve_scenario(P)
    out = P.pc.check_serve_state(pool, tables, pc)
    pool.release(tables.pop("a"))
    return out + P.pc.check_serve_state(pool, tables, pc)


INJECTIONS = [("PLAN001", inj_double_cover), ("PLAN001", inj_gap),
              ("PLAN002", inj_out_of_range),
              ("PLAN003", inj_unequal_tokens),
              ("PLAN004", inj_imbalance), ("ENC001", inj_corrupt_perm),
              ("ENC002", inj_bad_pos), ("ENC004", inj_redundant_send),
              ("ENC005", inj_dropped_send), ("TAB001", inj_pruned_table),
              ("TAB002", inj_table_range),
              ("WQ001", inj_misflagged_queue), ("WQ002", inj_non_lpt),
              ("WQ003", inj_dropped_visit),
              ("SRV001", inj_unregistered_sharing),
              ("SRV002", inj_leaked_reference),
              ("SRV003", inj_out_of_pool_block)]


@pytest.mark.parametrize("rule,inject", INJECTIONS,
                         ids=[f"{r}-{f.__name__}" for r, f in INJECTIONS])
def test_fault_injection_matches_reference(rule, inject):
    got = _both(inject)
    assert got["port"] == got["ref"]
    assert rule in {row[0] for row in got["port"]}, got["port"]


def test_serve_scenario_clean_matches_reference():
    got = _both(serve_clean)
    assert got["port"] == got["ref"] == []


# ------------------------------------------------------------------ #
# Layer 2: the wire budget
# ------------------------------------------------------------------ #
KIND = {"permute": "collective-permute", "all_gather": "all-gather"}


@pytest.mark.parametrize("kw", [
    dict(buf_len=128, num_workers=4, kv_heads=2, head_dim=16,
         dtype_bytes=4, fwd_and_bwd=True, batch=1, layers=4),
    dict(buf_len=256, num_workers=4, kv_heads=2, head_dim=16,
         overlap="none"),
    dict(buf_len=4096, num_workers=4, kv_heads=2, head_dim=128, batch=2,
         extra={"all_gather": 7.0}),
    dict(buf_len=8192, num_workers=2, kv_heads=8, head_dim=128,
         dtype_bytes=1, overlap="none", slack=0.02)])
def test_kv_exchange_budget_matches_reference(kw):
    ref_kw = dict(kw)
    if "extra" in kw:
        ref_kw["extra"] = {KIND[k]: v for k, v in kw["extra"].items()}
    port = twire.kv_exchange_budget(**kw)
    ref = jhlo.kv_exchange_budget(**ref_kw)
    assert {KIND[k]: v for k, v in port.allowed.items()} == ref.allowed
    assert (port.slack, port.full_gather_bytes) == \
        (ref.slack, ref.full_gather_bytes)


def test_audit_wire_rules():
    budget = twire.kv_exchange_budget(128, 4, 2, 16, dtype_bytes=4)
    cap = budget.allowed["permute"]
    assert not twire.audit_wire({"permute": cap, "all_gather": 0}, budget)
    assert not twire.audit_wire({"permute": cap * 1.009}, budget)
    for got in (cap * 1.02, cap * 0.98, 0):
        fs = twire.audit_wire({"permute": got}, budget)
        assert [f.rule for f in fs] == ["WIRE102"], got
    fs = twire.audit_wire({"permute": cap, "reduce_scatter": 8}, budget)
    assert [f.rule for f in fs] == ["WIRE101"]
    gathered = twire.CommBudget(allowed={"all_gather": float("inf")},
                                full_gather_bytes=4096)
    assert not twire.audit_wire({"all_gather": 10 ** 9}, gathered,
                                largest={"all_gather": 4095})
    fs = twire.audit_wire({"all_gather": 10 ** 9}, gathered,
                          largest={"all_gather": 4096})
    assert [f.rule for f in fs] == ["WIRE103"]


# ------------------------------------------------------------------ #
# Layer 3: the lint
# ------------------------------------------------------------------ #
PLANNER = "src/{pkg}/planner/fake.py"
SNIPPETS = [
    ("import random\n\ndef plan(xs):\n    random.shuffle(xs)\n", PLANNER),
    ("import random\n\ndef plan(xs):\n    random.Random(0).shuffle(xs)\n",
     PLANNER),
    ("import random\n\ndef plan(xs):\n    random.shuffle(xs)\n",
     "src/{pkg}/x.py"),
    ("import numpy as np\n\ndef plan():\n    return np.random.default_rng()\n",
     PLANNER),
    ("import numpy as np\n\ndef plan():\n"
     "    return np.random.default_rng(0)\n", PLANNER),
    ("def plan(xs):\n    for x in set(xs):\n        x\n", PLANNER),
    ("def plan(xs):\n    for x in sorted(set(xs)):\n        x\n", PLANNER),
    ("def plan(xs):\n    return [x for x in {1, 2} | set(xs)]\n",
     "src/{pkg}/autotune/fake.py"),
    ("def attn_kernel(q_ref, k_ref, o_ref):\n    x = q_ref[0, 0]\n"
     "    if x > 0:\n        o_ref[0, 0] = x\n", "src/{pkg}/kernels/fake.py"),
    ("from {pkg}.core.plan import ShardingPlan\n\nShardingPlan\n",
     "src/{pkg}/launch/x.py"),
    ("from {pkg}.core.plan import ShardingPlan\n\nShardingPlan\n",
     "src/{pkg}/core/plan.py"),
    ("from {pkg}.core import heuristic\n\nheuristic\n",
     "src/{pkg}/launch/x.py"),
    ("from {pkg}.planner.plan import ShardingPlan\n\nShardingPlan\n",
     "src/{pkg}/launch/x.py"),
    ("import os\n", "x.py"), ("def f(xs=[]):\n    return xs\n", "x.py"),
    ("def f(list):\n    return list\n", "x.py"),
    ("dict = 3\n", "x.py"),
    ("import os\n\n\ndef f(xs=()):\n    return os.name, xs\n", "x.py"),
    ("import os  # noqa: HYG001\n", "x.py"), ("import os  # noqa\n", "x.py"),
    ("import os  # noqa: F401\n", "x.py"),
    ("def broken(:\n", "x.py"),
]


@pytest.mark.parametrize("src,path", SNIPPETS,
                         ids=[f"snippet{i}" for i in range(len(SNIPPETS))])
def test_lint_source_matches_reference(src, path):
    """The port's lint under the port's names equals the reference's
    under the reference's, KER001 excepted."""
    def named(text, pkg):
        return text.replace("{pkg}", pkg)

    ref = [r for r in _rows(jlint.lint_source(named(src, "repro"),
                                              named(path, "repro")))
           if r[0] != "KER001"]
    port = _rows(tlint.lint_source(named(src, "repro_torch"),
                                   named(path, "repro_torch")))
    assert [tuple(str(x).replace("repro_torch", "repro") for x in r)
            for r in port] == ref


def test_port_lints_clean():
    targets = tlint.default_targets(ROOT)
    names = {str(p.relative_to(ROOT)) for p in targets}
    assert "chip_smoke.py" in names
    assert "scripts/flashcheck_torch.py" in names
    assert "tests/test_torch_analysis.py" in names
    assert "src/repro_torch/analysis/lint.py" in names
    assert not any(n.startswith("src/repro/") for n in names)
    fs = tlint.lint_paths(targets, root=ROOT)
    assert not [f for f in fs if f.severity == "error"], \
        "\n".join(f.render() for f in fs)


def test_flashcheck_torch_fast_exits_zero():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "flashcheck_torch.py"),
         "--fast"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "flashcheck_torch: 0 error(s)" in proc.stdout
