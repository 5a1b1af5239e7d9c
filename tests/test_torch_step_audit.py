"""The step audit (``repro_torch.analysis.step_audit``, STEP104/STEP105,
the port's counterparts of the reference's HLO104 and HLO105) on the
smoke training step on the CPU:

* through the doc kernels' plain twins (the CPU's flash path) it finds
  exactly the sites of ``EXPECTED_SITES["cpu"]``, and no finding;
* through the plain attention it finds no site at all;
* an f32->f64 cast and an ``.item()`` injected into the step are found,
  as STEP104 and STEP105 errors at the step's own line (its update,
  ``apply_grads``);
* the mode sees the ``train_step`` call it wraps and nothing else;
* ``scripts/flashcheck_torch.py``'s ``--train`` audit is clean.

The step's loss is the reference's (its JAX step on the same batch and
parameters), so the audit runs the step it claims to.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.data.pipeline import PipelineConfig as JPipe
from repro.data.pipeline import make_batch as jbatch
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models.context import make_local_context as jctx
from repro_torch import configs as tcfgs
from repro_torch.analysis import findings as tfind
from repro_torch.analysis import step_audit
from repro_torch.data.pipeline import PipelineConfig, make_batch
from repro_torch.launch import steps
from repro_torch.launch.steps import batch_to_device, build_train_step
from repro_torch.models import params_from_numpy
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parent.parent
SEQ, BATCH = 256, 2


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _pipe_kw(vocab):
    return dict(dataset="wlb_llm", context_len=SEQ, batch_per_host=BATCH,
                cp_size=1, strategy="flashcp", vocab_size=vocab, seed=1,
                align=64, emit_tables=True, table_grid="flat",
                table_block_q=64, table_block_k=64)


def _audited(impl):
    """One smoke train_step (``impl`` attention) under the audit, and the
    reference's loss on the same batch and parameters."""
    jc = jcfgs.reduce_for_smoke(jcfgs.get_config("starcoder2_3b"))
    tc = tcfgs.reduce_for_smoke(tcfgs.get_config("starcoder2_3b"))
    jp = jinit(jax.random.PRNGKey(1), jc)
    params = params_from_numpy(_np_tree(jp), device="cpu")
    batch = batch_to_device(make_batch(PipelineConfig(
        **_pipe_kw(tc.vocab_size)), 0), "cpu")
    step = build_train_step(tc, tcfgs.RunConfig(attention_impl=impl),
                            q_chunk=64, block_q=64, block_k=64,
                            device="cpu")
    metrics, audit = step_audit.audit_step(step, params, adamw_init(params),
                                           batch, 0)
    jb = jbatch(JPipe(**_pipe_kw(jc.vocab_size)), 0)
    ctx = jctx(jnp.asarray(jb["doc"]), jnp.asarray(jb["pos"]),
               attention_impl="xla", q_chunk=64)
    jl, _ = jloss(jp, jc, ctx, {k: jnp.asarray(jb[k])
                                for k in ("tokens", "labels")}, remat=True)
    return metrics, audit, float(jl)


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_smoke_step_has_exactly_the_cpu_sites(impl):
    metrics, audit, jl = _audited(impl)
    np.testing.assert_allclose(float(metrics["loss"]), jl, rtol=1e-5)
    assert audit.ops > 1000
    keys = {s.key for s in audit.sites}
    assert keys == (set(step_audit.EXPECTED_SITES["cpu"])
                    if impl == "flash" else set())
    assert not step_audit.audit_findings(audit.sites, "cpu")
    # every site is the port's own line
    assert all(s.file.startswith("repro_torch/") and s.line > 0
               for s in audit.sites)


def test_injected_f64_and_item_are_found(monkeypatch):
    clip = steps.clip_by_global_norm

    def leaky(grads, max_norm, *, norm=None):
        out, n = clip(grads, max_norm, norm=norm)
        n.double()
        n.item()
        return out, n

    monkeypatch.setattr(steps, "clip_by_global_norm", leaky)
    _, audit, _ = _audited("plain")
    found = step_audit.audit_findings(audit.sites, "cpu")
    assert {f.rule for f in found} == {"STEP104", "STEP105"}
    for f in found:
        assert f.location.startswith("repro_torch/launch/steps.py:")
        assert f.location.endswith("(apply_grads)")
    kinds = {s.kind for s in audit.sites}
    assert kinds == {"f32->f64 cast", "item"}
    # the card's list allows none of them either
    assert len(step_audit.audit_findings(audit.sites, "cuda")) == 2


def test_audit_sees_only_the_wrapped_call():
    x = torch.ones(4)
    x.sum().item()                      # before: not seen
    _, audit = step_audit.audit_step(lambda t: (t * 2).sum(), x)
    assert audit.ops == 2 and not audit.sites
    assert x.double().dtype == torch.float64       # after: not seen
    assert audit.ops == 2


def test_rules_are_registered():
    assert {"STEP104", "STEP105"} <= set(tfind.RULES)
    every = {k for sites in step_audit.EXPECTED_SITES.values()
             for k in sites}
    assert all(k[2] in ("item", "device-to-host copy",
                        "data-dependent shape") for k in every)


def _flashcheck():
    spec = importlib.util.spec_from_file_location(
        "flashcheck_torch", ROOT / "scripts" / "flashcheck_torch.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    return fc


def test_flashcheck_train_audit_is_clean():
    assert _flashcheck().run_train_audit("cpu") == []


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal of a process with no card")
def test_flashcheck_train_audit_runs_on_the_card_by_default():
    """``--train`` without ``--device`` is the card's audit: with no card
    it refuses before any check runs."""
    fc = _flashcheck()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fc.main(["--no-lint", "--train"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fc.run_train_audit("cuda")
