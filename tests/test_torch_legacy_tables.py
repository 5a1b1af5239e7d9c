"""The port's legacy visit-table builder
(``build_block_tables(..., legacy=True)``) on the three layouts of the
reference's own parity tests (``tests/test_overlap.py``): random
(unsorted, the dense path), sorted with padding (the interval path) and
segmented (a flashcp ``[local | buffers]`` concat with the -2 self mask).

On each it equals the port's vectorized builder and the reference's
legacy builder bit for bit: the four tables, ``visited_frac`` and
``full_frac``.
"""

import numpy as np
import pytest

import repro.kernels.doc_attention as jda
from repro_torch.kernels import doc_attention as tda

FIELDS = ("kv_idx", "kv_nvis", "q_idx", "q_nvis")


def _sorted_layout(B, T, lens, pad=0):
    d = np.concatenate([np.full(l, i, np.int32) for i, l in enumerate(lens)]
                       + ([np.full(pad, -1, np.int32)] if pad else []))
    p = np.concatenate([np.arange(l, dtype=np.int32) for l in lens]
                       + ([np.zeros(pad, np.int32)] if pad else []))
    assert d.shape[0] == T
    return np.tile(d, (B, 1)), np.tile(p, (B, 1))


def _random_cases():
    rng = np.random.default_rng(5)
    for _ in range(15):
        B = int(rng.integers(1, 3))
        kd = rng.integers(-1, 5, (B, 128)).astype(np.int32)
        kp = rng.integers(0, 60, (B, 128)).astype(np.int32)
        qd = rng.integers(-1, 5, (B, 64)).astype(np.int32)
        qp = rng.integers(0, 60, (B, 64)).astype(np.int32)
        yield qd, qp, kd, kp


def _sorted_cases():
    rng = np.random.default_rng(6)
    for _ in range(15):
        nd = int(rng.integers(1, 8))
        lens = rng.multinomial(256 - 16, np.ones(nd) / nd)
        lens = [int(x) for x in lens if x] or [240]
        lens[-1] += 240 - sum(lens)
        d, p = _sorted_layout(2, 256, lens, pad=16)
        yield d, p, d, p


def _segmented_cases():
    d1, p1 = _sorted_layout(1, 128, [70, 58])
    d2, p2 = _sorted_layout(1, 128, [50, 60], pad=18)
    kd = np.concatenate([d1, np.full_like(d2, -2), d2], axis=1)
    kp = np.concatenate([p1, p2, p2], axis=1)
    yield d1, p1, kd, kp


LAYOUTS = {"random": _random_cases, "sorted": _sorted_cases,
           "segmented": _segmented_cases}


def _same_tables(a, b, msg):
    for n in FIELDS:
        x, y = getattr(a, n), getattr(b, n)
        assert x.dtype == y.dtype, f"{msg}:{n}"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg}:{n}")
    assert (a.block_q, a.block_k) == (b.block_q, b.block_k), msg
    assert a.visited_frac == b.visited_frac, msg
    assert a.full_frac == b.full_frac, msg


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_legacy_tables_match_vectorized(layout):
    for i, (qd, qp, kd, kp) in enumerate(LAYOUTS[layout]()):
        a = tda.build_block_tables(qd, qp, kd, kp, block_q=16, block_k=16)
        b = tda.build_block_tables(qd, qp, kd, kp, block_q=16, block_k=16,
                                   legacy=True)
        for n in FIELDS:
            np.testing.assert_array_equal(getattr(a, n), getattr(b, n),
                                          err_msg=f"{layout}{i}:{n}")
        assert abs(a.visited_frac - b.visited_frac) < 1e-12
        assert abs(a.full_frac - b.full_frac) < 1e-12


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_legacy_tables_match_reference_legacy(layout):
    for i, (qd, qp, kd, kp) in enumerate(LAYOUTS[layout]()):
        t = tda.build_block_tables(qd, qp, kd, kp, block_q=16, block_k=16,
                                   legacy=True)
        j = jda.build_block_tables(qd, qp, kd, kp, block_q=16, block_k=16,
                                   legacy=True)
        _same_tables(t, j, f"{layout}{i}")
        # the flat queues derived from them too
        for n in ("fq_row", "fq_col", "fq_flags", "rq_row", "rq_col",
                  "rq_flags"):
            np.testing.assert_array_equal(getattr(t, n), getattr(j, n),
                                          err_msg=f"{layout}{i}:{n}")
