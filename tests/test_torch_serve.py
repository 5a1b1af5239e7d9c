"""The port's serving engine against the JAX package's.

Both engines serve the same prompts (ragged, with a shared system
prefix, and one prompt repeated so that it is entirely prefix-cached)
with the same parameters (the JAX init, converted), greedy.  The JAX
engine runs its Pallas kernels in interpret mode on the CPU; the port
runs on the CPU through the kernels' plain versions.  Greedy tokens must
be identical per request, and the host-side statistics (pool peak,
copy-on-write copies, prefix hits, decode stalls) identical, since the
scheduling is the same code path on the same events.
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro.serve import ServeEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.launch.serve import build_parser, serve
from repro_torch.models import init_params, params_from_numpy
from repro_torch.serve import ServeEngine

ARCH = "starcoder2_3b"
GEN = 6
GEOM = dict(num_slots=3, prefill_chunk=8, block_size=8)


def _prompts():
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 512, 16)
    lens = [32, 21, 37, 26, 30]
    prompts = [np.concatenate([prefix, rng.integers(0, 512, n - 16)])
               .astype(np.int32) for n in lens]
    # a repeat of the first prompt (4 full blocks): fully prefix-cached,
    # so its last token is recomputed in a copied-on-write block
    return prompts + [prompts[0].copy()]


PROMPTS = _prompts()
MAX_LEN = max(len(p) for p in PROMPTS) + GEN


def _drive(eng):
    for p in PROMPTS:
        eng.submit(p, max_new=GEN)
    out = eng.run()
    assert all(e["status"] == "ok" for e in out.values())
    return eng, {r: e["tokens"].tolist() for r, e in out.items()}


def _stats(eng):
    s = eng.stats
    out = {k: s[k] for k in ("steps", "decode_steps", "prefill_steps",
                             "decode_tokens", "prefill_cached_tokens",
                             "stalled_decode_steps", "cow_copies",
                             "admission_backoffs")}
    if eng.pool is not None:
        out["peak_blocks"] = eng.pool.peak_allocated
    if eng.prefix is not None:
        out["prefix_hits"] = eng.prefix.hits
    return out


@pytest.fixture(scope="module")
def params():
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(ARCH))
    tcfg = tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH))
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             device="cpu")


@pytest.fixture(scope="module")
def runs(params):
    jcfg, tcfg, jp, tp = params
    out = {}
    for name, kw in (("paged", dict(kv_layout="paged")),
                     ("dense", dict(kv_layout="dense")),
                     ("serial", dict(kv_layout="paged", unified=False))):
        out[name] = (
            _drive(JaxEngine(jcfg, params=jp, max_len=MAX_LEN, **GEOM, **kw)),
            _drive(ServeEngine(tcfg, tp, device="cpu", max_len=MAX_LEN,
                               **GEOM, **kw)))
    return out


@pytest.mark.parametrize("mode", ["paged", "dense", "serial"])
def test_engine_matches_jax(runs, mode):
    (jeng, jtok), (teng, ttok) = runs[mode]
    assert ttok == jtok
    assert _stats(teng) == _stats(jeng)


def test_engine_exercises_prefix_cow_and_stalls(runs):
    """The fixture's traffic reaches the paths it is meant to cover."""
    paged, serial = runs["paged"][1][0], runs["serial"][1][0]
    assert paged.stats["cow_copies"] >= 1
    assert paged.prefix.hits >= len(PROMPTS[0])     # the repeat alone
    assert paged.stats["stalled_decode_steps"] == 0
    assert serial.stats["stalled_decode_steps"] > 0


def test_paged_and_dense_tokens_agree(runs):
    assert runs["paged"][1][1] == runs["dense"][1][1]
    assert runs["paged"][1][1] == runs["serial"][1][1]


def test_keyed_sampling_reproducible_per_request(params):
    """Temperature requests own (seed, rid, count) streams: identical
    concurrent prompts sample independently, a request reproduces
    across runs and batch compositions, another seed moves it."""
    _, tcfg, _, _ = params
    prompt = np.random.default_rng(5).integers(0, 512, 12).astype(np.int32)

    def drive(n_copies, seed=0):
        eng = ServeEngine(tcfg, init_params(tcfg, seed=seed, device="cpu"),
                          device="cpu", num_slots=2, max_len=32,
                          prefill_chunk=8, seed=seed)
        rids = [eng.submit(prompt.copy(), max_new=10, temperature=1.0,
                           top_k=50) for _ in range(n_copies)]
        out = eng.run()
        return [out[r]["tokens"].tolist() for r in rids]

    a0, a1 = drive(2)
    assert a0 != a1
    b0, b1 = drive(2)
    assert (a0, a1) == (b0, b1)
    (c0,) = drive(1)
    assert c0 == a0
    d0, _ = drive(2, seed=7)
    assert d0 != a0


def test_cli_smoke_on_cpu(capsys):
    args = build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--requests", "5", "--slots", "2",
         "--prompt-len", "24", "--gen", "4", "--shared-prefix", "8"])
    out = serve(args)
    assert len(out["results"]) == 5
    assert all(e["status"] == "ok" for e in out["results"].values())
    assert "outcomes: {'ok': 5}" in capsys.readouterr().out


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--device", "tpu"])
