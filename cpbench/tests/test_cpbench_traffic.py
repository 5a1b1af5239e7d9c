"""The frozen samplers against the port's, and the generator and the feed
on the CPU."""

import dataclasses
import json

import numpy as np
import pytest

from cpbench.manifest import HERE, ModelSpec
from cpbench.port import Feed, import_port
from cpbench.samplers import (labels_of, make_rng, pack_sequence,
                              sample_length, synth_tokens)
from cpbench.traffic import Row, Traffic, attention_work

import_port()
from repro_torch.data import distributions, packing  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402


def _mix(name):
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["wlb_llm", "pile"])
def test_lengths_equal_the_ports(name):
    comps = _mix(name)["lengths"]
    for seed in range(20):
        a, b = make_rng(seed), distributions.make_rng(seed)
        mine = [sample_length(a, comps) for _ in range(200)]
        port = [distributions.sample_doc_length(name, b) for _ in range(200)]
        assert mine == port


@pytest.mark.parametrize("name", ["wlb_llm", "pile"])
@pytest.mark.parametrize("context", [1024, 16384])
def test_packing_equals_the_ports(name, context):
    comps = _mix(name)["lengths"]
    for seed in range(30):
        mine = pack_sequence(comps, context, make_rng(seed))
        port = packing.pack_sequence(name, context, make_rng(seed))
        np.testing.assert_array_equal(mine, port)


def test_tokens_and_labels_equal_the_ports():
    tok = _mix("wlb_llm")["tokens"]
    for seed in range(10):
        lens = packing.pack_sequence("wlb_llm", 2048, make_rng(seed))
        n = int(lens.sum())
        t_port = np.full(n, -1, np.int32)
        l_port = np.full(n, -1, np.int32)
        pipeline._synthesize_row(t_port, l_port, lens, np.arange(n),
                                 make_rng(seed + 100), 49152)
        t = synth_tokens(make_rng(seed + 100), n, 49152, **tok)
        np.testing.assert_array_equal(t, t_port)
        np.testing.assert_array_equal(labels_of(t, lens), l_port)


def test_every_seed_trains_the_same_documents():
    mix = _mix("wlb_llm")
    a, b = Traffic(mix, 49152, 7), Traffic(mix, 49152, 2 ** 31 + 5)
    ra, rb = a.rows(3)[0], b.rows(3)[0]
    assert sorted(ra.doc_lens) == sorted(rb.doc_lens)
    assert int(ra.doc_lens.sum()) == mix["context_len"]
    assert not np.array_equal(ra.tokens, rb.tokens)
    again = Traffic(mix, 49152, 7).rows(3)[0]
    np.testing.assert_array_equal(ra.tokens, again.tokens)
    np.testing.assert_array_equal(ra.doc_lens, again.doc_lens)
    assert ra.tokens.min() >= 0 and ra.tokens.max() < 49152


@pytest.mark.parametrize("name", ["wlb_llm", "pile"])
def test_each_step_packs_fresh_rows_from_the_sizes_seed(name):
    mix = dict(_mix(name), context_len=2048, rows=2, sizes_seed=3)
    t = Traffic(mix, 512, 2 ** 31 + 9)
    for step in range(4):
        rng = make_rng([3, step])
        want = [pack_sequence(mix["lengths"], 2048, rng) for _ in range(2)]
        for got, w, row in zip(t.sizes(step), want, t.rows(step)):
            np.testing.assert_array_equal(got, w)
            assert sorted(row.doc_lens) == sorted(w)
    full = Traffic(_mix(name), 512, 0)
    assert len({attention_work(full.sizes(s)[0]) for s in range(8)}) > 5


def test_labels_end_each_document():
    lens = np.array([3, 1, 4])
    lab = labels_of(np.arange(8, dtype=np.int32), lens)
    assert lab.tolist() == [1, 2, -1, -1, 5, 6, 7, -1]


def _spec(cp):
    cfg = json.loads((HERE / "configs" / "starcoder2_3b_e32.json").read_text())
    cfg["train"] = dict(cfg["train"], mesh={"data": 1, "model": cp})
    return ModelSpec.from_file("starcoder2_3b_e32", cfg)


@pytest.mark.parametrize("cp", [1, 2])
def test_feed_places_the_rows_in_plan_order(cp):
    spec = _spec(cp)
    mix = dict(_mix("wlb_llm"), context_len=2048)
    batch, rows = Feed(Traffic(mix, spec.vocab, 11), spec).batch(0)
    perm = batch["perm"][0]
    valid = perm >= 0
    np.testing.assert_array_equal(batch["tokens"][0][valid],
                                  rows[0].tokens[perm[valid]])
    np.testing.assert_array_equal(batch["labels"][0][valid],
                                  rows[0].labels[perm[valid]])
    assert any(k.startswith("tab_") for k in batch)


class _MakeBatchRows:
    """The rows the port's ``make_batch`` draws for (seed, step, rank 0),
    through the frozen samplers: its generator, its packing, then its
    tokens row by row."""

    def __init__(self, mix, vocab, seed):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.context_len = mix["context_len"]

    def rows(self, step):
        rng = make_rng(hash((self.seed, 0, step)) % (2 ** 63))
        lens = [pack_sequence(self.mix["lengths"], self.context_len, rng)
                for _ in range(self.mix["rows"])]
        out = []
        for lo in lens:
            t = synth_tokens(rng, int(lo.sum()), self.vocab,
                             **self.mix["tokens"])
            out.append(Row(lo, t, labels_of(t, lo)))
        return out


@pytest.mark.parametrize("name", ["wlb_llm", "pile"])
@pytest.mark.parametrize("cp", [1, 2])
def test_feed_batch_equals_the_ports_make_batch(name, cp):
    """The harness's copy of ``make_batch`` (``port.Feed``) makes the
    port's batch, key for key and bit for bit, from the same rows."""
    spec = _spec(cp)
    mix = dict(_mix(name), context_len=2048, rows=2)
    feed = Feed(_MakeBatchRows(mix, spec.vocab, 5), spec)
    cfg = dataclasses.replace(feed.cfg, dataset=name, seed=5)
    for step in (0, 3):
        mine, _ = feed.batch(step)
        port = pipeline.make_batch(cfg, step)
        assert set(mine) == set(port)
        for k in port:
            if k != "stats":
                np.testing.assert_array_equal(mine[k], port[k], err_msg=k)
