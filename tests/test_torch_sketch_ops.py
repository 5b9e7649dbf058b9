"""The reference's device code that no path runs, ported as torch ops,
against the reference on the same seeded numpy inputs.

`ops/hashing.py`'s uint32 mixes (`murmur_fmix32`, `splitmix32`,
`hash_columns32`, `hash_columns_pair`) bit-exact, as
`tests/test_sketches.py:148-208` demands of the reference; the count-min
sketch (`ops/sketches.py:331-371`: tables, merges and estimates exact,
its accuracy gates as `tests/test_sketches.py:148,171`); the paged
DDSketch step (`ops/pages.py::dd_step`) and `registry/metrics.py::
gauge_add` (exact on integer weights, float sums at rtol 1e-6);
`ops/moments.py::moments_merge` (exact).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu import ops as jops
from tempo_tpu.ops import moments as jmom
from tempo_tpu.ops import pages as jpages
from tempo_tpu.registry import metrics as jm
from tempo_tpu_torch.ops import hashing as th
from tempo_tpu_torch.ops import moments as tmom
from tempo_tpu_torch.ops import pages as tpages
from tempo_tpu_torch.ops import sketches as tsk
from tempo_tpu_torch.registry import metrics as tm

U32_EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                      0xFFFFFFFF, 0x9E3779B9, 0xDEADBEEF], np.uint32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("fn", ["murmur_fmix32", "splitmix32"])
def test_mixers_bit_exact(fn):
    rng = np.random.default_rng(1)
    x = np.concatenate([U32_EDGES, rng.integers(0, 1 << 32, 4096,
                                                dtype=np.uint64)
                        .astype(np.uint32)])
    want = np.asarray(getattr(jops, fn)(jnp.asarray(x)))
    np.testing.assert_array_equal(_u32(getattr(th, fn)(x)), want)
    # the same lanes as int32 (negative) and as a tensor
    xi = x.view(np.int32)
    np.testing.assert_array_equal(_u32(getattr(th, fn)(torch.from_numpy(xi))),
                                  want)


@pytest.mark.parametrize("shape,seed", [((1000, 5), 0), ((257,), 3),
                                        ((64, 1), 0x5BD1E995)])
def test_hash_columns_bit_exact(shape, seed):
    rng = np.random.default_rng(4)
    cols = rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)
    want = np.asarray(jops.hash_columns32(jnp.asarray(cols), seed=seed))
    got = _u32(th.hash_columns32(cols, seed=seed))
    np.testing.assert_array_equal(got, want)
    j1, j2 = jops.hash_columns_pair(jnp.asarray(cols), seed=seed)
    t1, t2 = th.hash_columns_pair(torch.from_numpy(cols), seed=seed)
    np.testing.assert_array_equal(_u32(t1), np.asarray(j1))
    np.testing.assert_array_equal(_u32(t2), np.asarray(j2))
    # deterministic and spread (tests/test_sketches.py:203)
    small = rng.integers(0, 50, size=(1000, 5)).astype(np.int32)
    h = _u32(th.hash_columns32(small))
    assert np.unique(h).size >= np.unique(small, axis=0).shape[0] - 2


def _items():
    items, true = [], {}
    for i in range(1, 200):
        c = max(1, 10000 // i)
        items += [i] * c
        true[i] = c
    items = np.array(items, np.uint32)
    np.random.default_rng(3).shuffle(items)
    return items, true


def test_cms_matches_reference_and_its_accuracy_gates():
    items, true = _items()
    jh1 = jops.splitmix32(jnp.asarray(items))
    jh2 = jops.murmur_fmix32(jnp.asarray(items) ^ jnp.uint32(0xDEADBEEF))
    th1 = th.splitmix32(items)
    th2 = th.murmur_fmix32(items ^ np.uint32(0xDEADBEEF))
    np.testing.assert_array_equal(_u32(th1), np.asarray(jh1))
    zeros = np.zeros(items.size, np.int32)
    j = jops.cms_update(jops.cms_init(2, depth=4, width=2048), zeros, jh1, jh2)
    t = tsk.cms_update(tsk.cms_init(2, depth=4, width=2048, device="cpu"),
                       zeros, th1, th2)
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    q = np.array(sorted(true), np.uint32)
    qz = np.zeros(q.size, np.int32)
    jest = np.asarray(jops.cms_estimate(
        j, qz, jops.splitmix32(jnp.asarray(q)),
        jops.murmur_fmix32(jnp.asarray(q) ^ jnp.uint32(0xDEADBEEF))))
    test = tsk.cms_estimate(t, qz, th.splitmix32(q),
                            th.murmur_fmix32(q ^ np.uint32(0xDEADBEEF)))
    np.testing.assert_array_equal(test.numpy(), jest)
    want = np.array([true[int(i)] for i in q], np.float32)
    est = test.numpy()
    assert (est >= want - 1e-3).all()
    heavy = want >= 1000
    assert (np.abs(est[heavy] - want[heavy]) <= 100).all()


def test_cms_weights_mask_merge_and_bad_width():
    rng = np.random.default_rng(8)
    n = 500
    sids = rng.integers(0, 4, n).astype(np.int32)
    h1 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w = rng.integers(1, 4, n).astype(np.float32)
    mask = rng.random(n) < 0.7
    j = jops.cms_update(jops.cms_init(4, depth=3, width=64), sids,
                        jnp.asarray(h1), jnp.asarray(h2), counts=w,
                        mask=jnp.asarray(mask))
    t = tsk.cms_update(tsk.cms_init(4, depth=3, width=64, device="cpu"),
                       sids, h1, h2, counts=w, mask=mask)
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    jm2, tm2 = jops.cms_merge(j, j), tsk.cms_merge(t, t)
    np.testing.assert_array_equal(tm2.table.numpy(), np.asarray(jm2.table))
    # a negative or past-the-end series id drops (the reference's scatter
    # wraps a negative id onto the last rows; ROADMAP section 3, as for
    # `hll_update`)
    before = t.table.clone()
    tsk.cms_update(t, np.array([-1, 4], np.int32), h1[:2], h2[:2])
    assert torch.equal(t.table, before)
    with pytest.raises(ValueError, match="power of two"):
        tsk.cms_init(1, width=100, device="cpu")
    with pytest.raises(ValueError):
        tsk.cms_merge(t, tsk.cms_init(4, depth=2, width=64, device="cpu"))


@pytest.mark.parametrize("weights", ["ones", "ints"])
def test_paged_dd_step_matches_reference(weights):
    gamma, nb = tsk.dd_params(0.01, 1e-9, 1e6)
    pr, shift = 16, 4
    rng = np.random.default_rng(6)
    n, rows = 2000, 8 * pr
    slots = rng.integers(-1, 6 * pr, n).astype(np.int32)
    vals = np.concatenate([rng.lognormal(-4, 2, n - 10),
                           np.zeros(5), np.full(5, 1e-10)]).astype(np.float32)
    w = np.ones(n, np.float32) if weights == "ones" else \
        rng.integers(1, 5, n).astype(np.float32)
    # page maps: a few unbacked pages, the zeros plane on its own pages
    t_counts = np.array([3, -1, 1, 5, 2, 7], np.int32)
    t_zeros = np.array([2, 4, -1, 1, 6, 3], np.int32)
    step = jpages.dd_step(gamma, 1e-9, shift)
    jz, jd = step(jnp.zeros(rows, jnp.float32),
                  jnp.zeros((rows, nb), jnp.float32), jnp.asarray(t_counts),
                  jnp.asarray(t_zeros), jnp.asarray(slots),
                  jnp.asarray(vals), jnp.asarray(w))
    tz, td = torch.zeros(rows), torch.zeros((rows, nb))
    tpages.dd_step(tz, td, torch.from_numpy(t_counts),
                   torch.from_numpy(t_zeros), slots, vals, w, gamma=gamma,
                   min_value=1e-9, page_shift=shift)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert td[:pr].sum() == 0 and tz[:pr].sum() == 0      # trash page


def test_gauge_add_matches_reference():
    rng = np.random.default_rng(9)
    n, cap = 600, 64
    slots = rng.integers(-2, cap + 3, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    for vals, exact in ((rng.integers(-5, 6, n).astype(np.float32), True),
                        (rng.normal(size=n).astype(np.float32), False)):
        j = jm.gauge_add(jm.gauge_init(cap), jnp.asarray(slots),
                         jnp.asarray(vals), mask=jnp.asarray(mask))
        t = tm.gauge_add(tm.gauge_init(cap, device="cpu"), slots, vals,
                         mask=mask)
        if exact:
            np.testing.assert_array_equal(t.values.numpy(),
                                          np.asarray(j.values))
        else:
            np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values),
                                       rtol=1e-6, atol=1e-6)


def test_moments_merge_matches_reference():
    rng = np.random.default_rng(12)
    k = 12
    a = jmom.moments_init(16, k)
    ta = tmom.moments_init(16, k, device="cpu")
    for s in range(2):
        data = rng.random((16, k + 3)).astype(np.float32)
        a2 = jmom.MomentsSketch(jnp.asarray(data), a.k, a.lo, a.hi)
        b = jmom.MomentsSketch(jnp.asarray(data[::-1].copy()), a.k, a.lo,
                               a.hi)
        ta2 = tmom.MomentsSketch(torch.from_numpy(data), ta.k, ta.lo, ta.hi)
        tb = tmom.MomentsSketch(torch.from_numpy(data[::-1].copy()), ta.k,
                                ta.lo, ta.hi)
        np.testing.assert_array_equal(
            tmom.moments_merge(ta2, tb).data.numpy(),
            np.asarray(jmom.moments_merge(a2, b).data))
    with pytest.raises(ValueError, match="incompatible"):
        tmom.moments_merge(ta, tmom.moments_init(16, 8, device="cpu"))
