"""The port's exposed-communication schedule model
(``repro_torch.launch.schedule``) against the reference's
``hlo_analysis.schedule_model``.

* The reference's two toy programs (``tests/test_overlap.py``), written
  in torch: a blocking all-gather before two 1024² f32 products, and a
  permute that flies under the first product.  The reference test's
  assertions hold, the products' FLOPs and bytes equal the reference's
  HLO count, and every ``ScheduleCost`` field equals the reference's on
  its HLO text to 1e-6 relative.
* The edge cases that exist without HLO (``tests/test_analysis.py``): an
  empty trace, a collective-only trace (all of it exposed), and a loop,
  which an eager trace unrolls.
* The flashcp island at N = 4 on ``bench_overlap.py``'s documents (8192
  tokens), on the recording communicator: chunked exposes less than
  monolithic, the comm stream's busy time is the bytes the communicator
  counted over the wire rate, one collective per call it counted.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro.launch import hlo_analysis as jha
from repro_torch.autotune.cost_model import HW
from repro_torch.core.comm import (all_gather_tiled, all_reduce_, hop_start,
                                   hop_wait)
from repro_torch.launch.schedule import (ScheduleCost, ScheduleTrace,
                                         schedule_model)

ROOT = Path(__file__).resolve().parent.parent

_BLOCKING_HLO = """\
ENTRY %main (p0: f32[1024,1024], p1: f32[1024,1024]) -> f32[1024,1024] {
  %p0 = f32[1024,1024] parameter(0)
  %p1 = f32[1024,1024] parameter(1)
  %ag = f32[1024,1024] all-gather(%p0), replica_groups={{0,1,2,3}}
  %d0 = f32[1024,1024] dot(%ag, %p1), lhs_contracting_dims={1}
  ROOT %d1 = f32[1024,1024] dot(%d0, %p1), lhs_contracting_dims={1}
}
"""

_OVERLAPPED_HLO = """\
ENTRY %main (p0: f32[1024,1024], p1: f32[1024,1024]) -> f32[1024,1024] {
  %p0 = f32[1024,1024] parameter(0)
  %p1 = f32[1024,1024] parameter(1)
  %cp = f32[1024,1024] collective-permute(%p0), source_target_pairs={{0,1}}
  %d0 = f32[1024,1024] dot(%p0, %p1), lhs_contracting_dims={1}
  ROOT %d1 = f32[1024,1024] dot(%cp, %d0), lhs_contracting_dims={1}
}
"""


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _blocking():
    """The all-gather (this rank's 256 rows of 4) feeds both products."""
    trace = ScheduleTrace(0, 4)
    p0, p1 = _meta(256, 1024), _meta(1024, 1024)
    with trace:
        ag = all_gather_tiled(p0, trace.comm, 0)
        d0 = ag @ p1
        d0 @ p1
    return trace


def _overlapped():
    """The hop is started, the first product runs, the second reads the
    received buffer."""
    trace = ScheduleTrace(0, 4)
    p0, p1 = _meta(1024, 1024), _meta(1024, 1024)
    with trace:
        handle = hop_start(trace.comm, (p0,))
        d0 = p0 @ p1
        (cp,) = hop_wait(handle)
        cp @ d0
    return trace


TOYS = {"blocking": (_blocking, _BLOCKING_HLO),
        "overlapped": (_overlapped, _OVERLAPPED_HLO)}


def _same_cost(t: ScheduleCost, j, rel=1e-6):
    for f in dataclasses.fields(ScheduleCost):
        a, b = getattr(t, f.name), getattr(j, f.name)
        assert a == pytest.approx(b, rel=rel, abs=1e-15), f.name


def test_schedule_cost_has_the_references_fields():
    assert [f.name for f in dataclasses.fields(ScheduleCost)] == \
        [f.name for f in dataclasses.fields(jha.ScheduleCost)]


def test_schedule_model_blocking_vs_overlapped():
    blocking = schedule_model(_blocking())
    overlapped = schedule_model(_overlapped())
    # blocking: the gather gates all compute -> fully exposed
    assert blocking.exposed_comm_s == pytest.approx(
        blocking.comm_busy_s, rel=1e-6)
    # overlapped: the permute flies under the first product -> hidden
    assert overlapped.exposed_comm_s < 0.2 * overlapped.comm_busy_s
    assert blocking.collective_count == 1
    assert overlapped.collective_count == 1


@pytest.mark.parametrize("name", sorted(TOYS))
def test_toy_products_count_the_references_flops_and_bytes(name):
    build, hlo = TOYS[name]
    comps, entry = jha._parse_computations(hlo)
    ref = [(op.flops, op.bytes) for op in comps[entry].ops
           if op.opcode == "dot"]
    ours = [(op.flops, op.bytes) for op in build().records
            if op.kind == "compute"]
    assert len(ref) == 2
    assert ours == ref


@pytest.mark.parametrize("rates", ["reference", "h100"])
@pytest.mark.parametrize("name", sorted(TOYS))
def test_toy_schedule_matches_reference(name, rates):
    build, hlo = TOYS[name]
    kw = {} if rates == "reference" else dict(
        flops_per_s=HW["peak_flops"], bytes_per_s=HW["hbm_bw"],
        wire_per_s=HW["ici_bw"])
    ours = schedule_model(build(), **kw)
    _same_cost(ours, jha.schedule_model(hlo, **kw))
    if rates == "h100":
        assert schedule_model(build(), hw=HW) == ours


def test_schedule_model_edge_cases():
    # empty trace
    trace = ScheduleTrace()
    with trace:
        pass
    empty = schedule_model(trace)
    assert empty == ScheduleCost(0.0, 0.0, 0.0, 0.0, 0.0)
    assert schedule_model([]) == empty
    # collective-only trace: all comm time is exposed
    trace = ScheduleTrace(0, 4)
    x = _meta(1024)
    with trace:
        hop_wait(hop_start(trace.comm, (x,)))
    s = schedule_model(trace, wire_per_s=1.0)
    assert s.collective_count == 1
    assert s.compute_busy_s == 0.0
    assert s.makespan_s == 4096.0
    assert s.exposed_comm_s == pytest.approx(s.makespan_s)


def test_loops_are_unrolled():
    """The reference recurses into a ``while`` body and multiplies by its
    trip count; an eager trace records every trip: six all-reduces of
    4096 bytes over a group of 4 (2 x 4096 x 3/4 each)."""
    trace = ScheduleTrace(0, 4)
    x = _meta(1024)
    with trace:
        for _ in range(3):
            for _ in range(2):
                all_reduce_([x], trace.comm)
    s = schedule_model(trace, wire_per_s=1.0)
    assert s.collective_count == 6
    assert s.comm_busy_s == pytest.approx(6144.0 * 6)
    assert trace.comm.wire_bytes_by_kind["all_reduce"] == 6144 * 6


# --------------------------------------------------------------------- #
# the flashcp island at N = 4
# --------------------------------------------------------------------- #
def _island_script():
    spec = importlib.util.spec_from_file_location(
        "schedule_island_torch", ROOT / "scripts" / "schedule_island_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def islands():
    mod = _island_script()
    assert sum(mod.DOC_LENS) == 8192 and mod.N_CP == 4
    return {ov: mod.trace_island(ov) for ov in ("none", "chunked")}


@pytest.mark.parametrize("rates", ["reference", "h100"])
def test_chunked_island_exposes_less_than_monolithic(islands, rates):
    kw = {} if rates == "reference" else {"hw": HW}
    mono = schedule_model(islands["none"], **kw)
    chunked = schedule_model(islands["chunked"], **kw)
    assert mono.exposed_comm_s > 0
    assert chunked.exposed_comm_s < mono.exposed_comm_s
    # the monolithic gather is exposed whole
    assert mono.exposed_comm_s == pytest.approx(mono.comm_busy_s, rel=1e-6)


@pytest.mark.parametrize("overlap", ["none", "chunked"])
def test_island_comm_is_the_bytes_the_comm_counted(islands, overlap):
    trace = islands[overlap]
    s = schedule_model(trace, wire_per_s=25e9)
    wire = sum(trace.comm.wire_bytes_by_kind.values())
    assert wire > 0
    assert s.comm_busy_s == pytest.approx(wire / 25e9, rel=1e-12)
    colls = [op for op in trace.records if op.kind == "collective"]
    assert s.collective_count == len(colls)
    # the monolithic island all-gathers K and V; the chunked one sends
    # the Eq.-5 buffer (K, V, doc, pos) in N - 1 = 3 hops
    kinds = {"none": ["all_gather"] * 2, "chunked": ["permute"] * 3}
    assert [op.name for op in colls] == kinds[overlap]
