"""The port's paged state against the JAX reference.

Page-table translation, gather, zero and page release of
`tempo_tpu_torch.ops.pages`, the registry metric updates of
`tempo_tpu_torch.registry.metrics`, the DDSketch quantile, pool
allocation with the reserved trash page, and the `load_reference_state`
round trip — each fed the same seeded numpy inputs as its counterpart in
`tempo_tpu`. Integer-valued planes are compared exactly, float sums at
rtol=1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.ops import pages as jop
from tempo_tpu.ops import sketches as jsk
from tempo_tpu.registry import metrics as jm
from tempo_tpu.registry import pages as jpages
from tempo_tpu_torch.ops import pages as top
from tempo_tpu_torch.ops import sketches as tsk
from tempo_tpu_torch.registry import metrics as tm
from tempo_tpu_torch.registry import pages as tpages

SHIFT = 3
ROWS = 6 * 8


def _table_slots(seed, n=64):
    rng = np.random.default_rng(seed)
    table = np.array([2, -1, 4, 1, 5], np.int32)     # logical page 1 unbacked
    slots = rng.integers(-2, 7 * 8, n).astype(np.int32)   # incl. past the table
    return table, slots


@pytest.mark.parametrize("seed", [0, 1])
def test_translate_matches(seed):
    table, slots = _table_slots(seed)
    ref = np.asarray(jop.translate(jnp.asarray(table), jnp.asarray(slots),
                                   SHIFT, ROWS))
    got = top.translate(torch.from_numpy(table), torch.from_numpy(slots),
                        SHIFT, ROWS).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("width", [1, 5])
def test_gather_zero_and_zero_pages_match(width):
    table, slots = _table_slots(3)
    rng = np.random.default_rng(4)
    arena = rng.integers(0, 9, (ROWS,) if width == 1 else (ROWS, width)
                         ).astype(np.float32)
    ndim = arena.ndim
    ref = np.asarray(jop.gather_step(ndim, SHIFT)(
        jnp.asarray(arena), jnp.asarray(table), slots))
    got = top.gather_step(torch.from_numpy(arena), torch.from_numpy(table),
                          torch.from_numpy(slots), page_shift=SHIFT).numpy()
    np.testing.assert_array_equal(got, ref)

    ref = np.asarray(jop.zero_step(ndim, SHIFT)(
        jnp.asarray(arena), jnp.asarray(table), slots[:9]))
    t = torch.from_numpy(arena.copy())
    top.zero_step(t, torch.from_numpy(table), torch.from_numpy(slots[:9]),
                  page_shift=SHIFT)
    np.testing.assert_array_equal(t.numpy(), ref)

    pages = np.array([2, -1, 5, -1], np.int32)
    ref = np.asarray(jop.zero_pages_step(ndim, 8)(jnp.asarray(arena), pages))
    t = torch.from_numpy(arena.copy())
    top.zero_pages_step(t, torch.from_numpy(pages), page_rows=8)
    np.testing.assert_array_equal(t.numpy(), ref)


def test_counter_and_histogram_steps_match():
    table, slots = _table_slots(5)
    rng = np.random.default_rng(6)
    vals = rng.integers(1, 4, len(slots)).astype(np.float32)
    dur = rng.lognormal(-3, 1.5, len(slots)).astype(np.float32)
    edges = (0.002, 0.008, 0.032, 0.128)
    ref = np.asarray(jop.counter_add_step(SHIFT)(
        jnp.zeros(ROWS), jnp.asarray(table), slots, vals))
    got = torch.zeros(ROWS)
    top.counter_add_step(got, torch.from_numpy(table), torch.from_numpy(slots),
                         torch.from_numpy(vals), page_shift=SHIFT)
    np.testing.assert_array_equal(got.numpy(), ref)

    jt = jnp.asarray(table)
    r_sums, r_counts, r_b = jop.histogram_observe_step(edges, SHIFT)(
        jnp.zeros(ROWS), jnp.zeros(ROWS), jnp.zeros((ROWS, len(edges) + 1)),
        jt, jt, jt, slots, dur, vals)
    sums, counts = torch.zeros(ROWS), torch.zeros(ROWS)
    b = torch.zeros(ROWS, len(edges) + 1)
    tt = torch.from_numpy(table)
    top.histogram_observe_step(sums, counts, b, tt, tt, tt,
                               torch.from_numpy(slots), torch.from_numpy(dur),
                               torch.from_numpy(vals), edges=edges,
                               page_shift=SHIFT)
    np.testing.assert_array_equal(b.numpy(), np.asarray(r_b))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(r_counts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(r_sums), rtol=1e-5,
                               atol=1e-6)


def test_registry_metric_updates_match():
    """counter_update, histogram_update and zero_slots against the
    reference's dense metric functions (discards and masked rows drop)."""
    rng = np.random.default_rng(7)
    cap, n = 32, 200
    slots = rng.integers(-1, cap, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    w = rng.integers(1, 4, n).astype(np.float32)
    v = rng.lognormal(-3, 1.5, n).astype(np.float32)
    edges = (0.002, 0.008, 0.032, 0.128)
    rc = jm.counter_update(jm.counter_init(cap), slots, w, mask)
    tc = tm.counter_update(tm.counter_init(cap, device="cpu"), torch.from_numpy(slots),
                           torch.from_numpy(w), torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(rc.values))
    rh = jm.histogram_update(jm.histogram_init(cap, edges), slots, v, w, mask)
    th = tm.histogram_update(tm.histogram_init(cap, edges, device="cpu"),
                             torch.from_numpy(slots), torch.from_numpy(v),
                             torch.from_numpy(w), torch.from_numpy(mask))
    np.testing.assert_array_equal(th.bucket_counts.numpy(),
                                  np.asarray(rh.bucket_counts))
    np.testing.assert_array_equal(th.counts.numpy(), np.asarray(rh.counts))
    np.testing.assert_allclose(th.sums.numpy(), np.asarray(rh.sums),
                               rtol=1e-5, atol=1e-6)
    evict = np.array([3, 7, cap, cap], np.int32)     # padded with capacity
    rz = jm.zero_slots(rh, evict)
    tz = tm.zero_slots(th, torch.from_numpy(evict))
    np.testing.assert_array_equal(tz.bucket_counts.numpy(),
                                  np.asarray(rz.bucket_counts))
    np.testing.assert_array_equal(tz.counts.numpy(), np.asarray(rz.counts))


@pytest.mark.parametrize("q", [0.5, 0.99])
def test_dd_quantile_matches(q):
    """The DDSketch quantile over integer counts is bit-identical,
    empty rows and all-zero-latency rows included."""
    gamma, nb = jsk.dd_params(0.01, 1e-6, 1e5)
    rng = np.random.default_rng(8)
    counts = np.zeros((64, nb), np.float32)
    for i in range(64):
        idx = rng.integers(0, nb, rng.integers(0, 40))
        np.add.at(counts[i], idx, 1.0)
    zeros = rng.integers(0, 3, 64).astype(np.float32)
    zeros[5] = 7.0
    counts[5] = 0.0
    ref = np.asarray(jsk.dd_quantile(jsk.DDSketch(
        jnp.asarray(counts), jnp.asarray(zeros), gamma, 1e-6), q))
    got = tsk.dd_quantile(tsk.DDSketch(torch.from_numpy(counts),
                                       torch.from_numpy(zeros), gamma, 1e-6),
                          q).numpy()
    np.testing.assert_array_equal(got, ref)


def test_dd_merge_checks_meta():
    a = tsk.DDSketch(torch.zeros(2, 4), torch.zeros(2), 1.02, 1e-6)
    b = tsk.DDSketch(torch.zeros(2, 4), torch.zeros(2), 1.05, 1e-6)
    with pytest.raises(ValueError, match="incompatible"):
        tsk.dd_merge(a, b)
    assert tsk.dd_merge(a, a).counts.shape == (2, 4)


def _pools(page_rows=4, arena_slots=24):
    cfg = dict(enabled=True, page_rows=page_rows, arena_slots=arena_slots)
    return (jpages.PagePool(jpages.PagePoolConfig(**cfg)),
            tpages.PagePool(tpages.PagePoolConfig(**cfg), device="cpu"))


def test_pool_alloc_free_matches_and_reserves_page_zero():
    """The same slot script through both packages' PageBacking gives the
    same page maps, free lists and refcounts; page 0 is never handed out
    and a released page comes back zeroed."""
    jpool, tpool = _pools()
    planes = []
    for pool, mod in ((jpool, jpages), (tpool, tpages)):
        back = mod.PageBacking(pool)
        a = mod.PagedPlane(pool, "float32", 1, 16, "t", role="a")
        b = mod.PagedPlane(pool, "float32", 3, 16, "t", role="b")
        back.add_plane(a)
        back.add_plane(b, limit=8)
        planes.append((back, a, b))
    script = [("ensure", s) for s in (0, 5, 9, 13, 1, 14)] + \
        [("release", np.array([9])), ("ensure", 10), ("release",
                                                       np.array([0, 1, 5]))]
    for op, arg in script:
        out = [getattr(back, "ensure_slot" if op == "ensure" else "release")(arg)
               for back, _, _ in planes]
        assert out[0] == out[1], (op, arg)
    (_, ja, jb), (_, ta, tb) = planes
    for j, t in ((ja, ta), (jb, tb)):
        np.testing.assert_array_equal(t.page_map, j.page_map)
        np.testing.assert_array_equal(t.refcnt, j.refcnt)
        assert t._arena.free == j._arena.free
        assert 0 not in t.page_map and 0 not in t._arena.free
    assert tpool.total_pages() == jpool.total_pages()
    assert tpool.free_pages() == jpool.free_pages()
    # exhaustion refuses the slot atomically, like the reference
    for s in (2, 6, 11, 15, 3, 7, 12):
        assert planes[1][0].ensure_slot(s) == planes[0][0].ensure_slot(s)
    assert tpool.alloc_failures == jpool.alloc_failures


def test_pool_config_raises_instead_of_falling_back():
    with pytest.raises(ValueError, match="power of two"):
        tpages.configure(tpages.PagePoolConfig(enabled=True, page_rows=6),
                         device="cpu")
    assert tpages.configure(tpages.PagePoolConfig(enabled=False)) is None


def test_load_reference_state_round_trip():
    """A JAX processor's non-zero paged state installed in the port's pool:
    arenas and page maps round-trip exactly, and the next fused update of
    both packages from that state agrees."""
    from tempo_tpu.generator.processors.spanmetrics import (
        SpanMetricsConfig as JCfg, SpanMetricsProcessor as JProc)
    from tempo_tpu.model.span_batch import synthetic_batch
    from tempo_tpu.registry.registry import (ManagedRegistry as JReg,
                                             RegistryOverrides as JOv)
    from tempo_tpu_torch.generator.processors.spanmetrics import (
        SpanMetricsConfig, SpanMetricsProcessor)
    from tempo_tpu_torch.registry.registry import (ManagedRegistry,
                                                   RegistryOverrides)

    pc = dict(enabled=True, page_rows=64, arena_slots=2048)
    sm = dict(sketch_max_series=256)
    jpool = jpages.PagePool(jpages.PagePoolConfig(**pc))
    with jpages.use(jpool):
        jreg = JReg("t", JOv(max_active_series=1024), now=lambda: 1000.0)
        jproc = JProc(jreg, JCfg(use_scheduler=False, **sm))
    for seed in range(2):
        jproc.push_batch(synthetic_batch(500, interner=jreg.interner,
                                         n_services=6, n_names=60, seed=seed))
    tpool = tpages.PagePool(tpages.PagePoolConfig(**pc), device="cpu")
    with tpages.use(tpool):
        treg = ManagedRegistry("t", RegistryOverrides(max_active_series=1024),
                               now=lambda: 1000.0)
        tproc = SpanMetricsProcessor(treg, SpanMetricsConfig(**sm))
    arenas = {k: np.asarray(a.data) for k, a in jpool.arenas.items()}
    jplanes = jproc._paged_planes()
    maps = {(p.tenant, p._arena.role): p.page_map for p in jplanes}
    refs = {(p.tenant, p._arena.role): p.refcnt for p in jplanes}
    tpages.load_reference_state(tpool, arenas, maps, refs)
    for key, a in arenas.items():
        np.testing.assert_array_equal(tpool.arenas[key].data.numpy(), a)
    tplanes = tproc._paged_planes()
    for jp, tp in zip(jplanes, tplanes):
        np.testing.assert_array_equal(tp.page_map, jp.page_map)
        assert set(tp._arena.free).isdisjoint(tp.page_map.tolist())
    # the next update, on the same slots, from the installed state
    rng = np.random.default_rng(9)
    live = np.flatnonzero(jproc.calls.table.active)
    mat = np.zeros((4, 256), np.float32)
    mat[0] = rng.choice(live, 256)
    mat[0, :8] = -1
    mat[1] = rng.lognormal(-3, 1.5, 256)
    mat[2] = rng.integers(100, 5000, 256)
    mat[3] = 1.0
    jproc._paged_dispatch_packed4(mat)
    tproc._paged_update(mat[0], mat[1], mat[2], mat[3])
    for r, (jp, tp) in enumerate(zip(jplanes, tplanes)):
        ref, got = np.asarray(jp.data), tp.data.numpy()
        if r in (1, 3):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"role {r}")


def test_metric_states_default_to_cuda(monkeypatch):
    """`counter_init` / `histogram_init` run on the card unless the CPU is
    asked for: without CUDA the default raises, `device="cpu"` works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.counter_init(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.histogram_init(8, (0.1, 1.0))
    assert tm.counter_init(8, device="cpu").values.device.type == "cpu"
    h = tm.histogram_init(8, (0.1, 1.0), device="cpu")
    assert h.bucket_counts.shape == (8, 3) and h.sums.device.type == "cpu"


@pytest.mark.parametrize("family", ["counter", "histogram"])
def test_compact_families_refuse_non_fused_writes(family):
    """A compact-state family is written only through the paged fused
    update (one rounding per cell per dispatch): its own per-call write
    raises and leaves the planes untouched; an f32 family's works."""
    from tempo_tpu_torch.registry.registry import (ManagedRegistry,
                                                   RegistryOverrides)

    _, tpool = _pools(page_rows=8, arena_slots=64)
    with tpages.use(tpool):
        reg = ManagedRegistry("t", RegistryOverrides(max_active_series=32),
                              now=lambda: 1000.0)
    slots = np.array([0, 3, 3], np.int32)
    w = np.array([0.25, 0.25, 0.5], np.float32)
    for compact in (True, False):
        name = f"{family}_{compact}"
        if family == "counter":
            m = reg.new_counter(name, ("a",), compact=compact)
            write = lambda: m.add_slots(slots, w)  # noqa: E731
        else:
            m = reg.new_histogram(name, ("a",), compact=compact)
            write = lambda: m.observe_slots(  # noqa: E731
                slots, np.full(3, 0.01, np.float32), w)
        m.table.backing.ensure_slot(0)
        m.table.backing.ensure_slot(3)
        if compact:
            with pytest.raises(NotImplementedError, match="fused_step"):
                write()
            assert not any(p.data.any() for p in m.planes.values())
        else:
            write()
            plane = m.values if family == "counter" else m.counts
            np.testing.assert_array_equal(plane.gather(slots), [0.25, 0.75,
                                                                0.75])


def test_load_reference_state_compact_round_trip():
    """A JAX processor under `sketch: both` with compact state (int32
    counts, a bf16 Kahan pair, the moments plane; the reference's Pallas
    kernel in interpret mode) installed in the port's pool: each arena
    round-trips in its own dtype, and one more identical push through
    both packages gives equal planes (int32 exact, the pair folded within
    1%, f32 sums at rtol 1e-5, moment sums and bounds at the `log`
    tolerance of tests/test_torch_moments.py)."""
    from tempo_tpu.generator.processors.spanmetrics import (
        SpanMetricsConfig as JCfg, SpanMetricsProcessor as JProc)
    from tempo_tpu.model.span_batch import synthetic_batch
    from tempo_tpu.registry.registry import (ManagedRegistry as JReg,
                                             RegistryOverrides as JOv)
    from tempo_tpu_torch.generator.processors.spanmetrics import (
        SpanMetricsConfig, SpanMetricsProcessor)
    from tempo_tpu_torch.registry.registry import (ManagedRegistry,
                                                   RegistryOverrides)

    pc = dict(enabled=True, page_rows=64, arena_slots=1024)
    sm = dict(sketch_max_series=128, sketch="both", compact_state=True,
              sketch_rel_err=0.05, moments_k=6)
    jpool = jpages.PagePool(jpages.PagePoolConfig(**pc))
    with jpages.use(jpool):
        jreg = JReg("t", JOv(max_active_series=512), now=lambda: 1000.0)
        jproc = JProc(jreg, JCfg(use_scheduler=False, kernel="pallas",
                                 pallas_interpret=True, **sm))
    assert jproc._compact
    jproc.push_batch(synthetic_batch(400, interner=jreg.interner,
                                     n_services=4, n_names=40, seed=1))
    tpool = tpages.PagePool(tpages.PagePoolConfig(**pc), device="cpu")
    with tpages.use(tpool):
        treg = ManagedRegistry("t", RegistryOverrides(max_active_series=512),
                               now=lambda: 1000.0)
        tproc = SpanMetricsProcessor(treg, SpanMetricsConfig(**sm))
    arenas = {k: np.asarray(a.data) for k, a in jpool.arenas.items()}
    assert {a.dtype.name for a in arenas.values()} == \
        {"int32", "bfloat16", "float32"}
    jplanes = jproc._paged_planes()
    maps = {(p.tenant, p._arena.role): p.page_map for p in jplanes}
    tpages.load_reference_state(tpool, arenas, maps)
    for key, a in arenas.items():
        got = tpool.arenas[key].data
        assert str(got.dtype) == f"torch.{a.dtype.name}"
        np.testing.assert_array_equal(got.float().numpy(),
                                      a.astype(np.float32))
    bad = dict(arenas)
    key = next(k for k, a in arenas.items() if a.dtype.name == "int32")
    bad[key] = arenas[key].astype(np.float32)
    with pytest.raises(ValueError, match="dtype"):
        tpages.load_reference_state(tpool, bad, {})
    rng = np.random.default_rng(11)
    live = np.flatnonzero(jproc.calls.table.active)
    mat = np.zeros((4, 128), np.float32)
    mat[0] = rng.choice(live, 128)
    mat[1] = rng.lognormal(-3, 1.5, 128)
    mat[2] = rng.integers(100, 5000, 128)
    mat[3] = rng.integers(1, 3, 128)
    jproc._paged_dispatch_packed4(mat)
    tproc._paged_update(mat[0], mat[1], mat[2], mat[3])
    tplanes = tproc._paged_planes()
    k = sm["moments_k"]
    for r, (jp, tp) in enumerate(zip(jplanes, tplanes)):
        ref = np.asarray(jp.data).astype(np.float32)
        got = tp.data.float().numpy()
        if r == 1:
            np.testing.assert_allclose(got.sum(axis=1), ref.sum(axis=1),
                                       rtol=1e-2, atol=1e-6)
        elif r == 3:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        elif r == 7:
            assert (np.abs(got[:, 1:k + 1] - ref[:, 1:k + 1])
                    <= 1e-5 * np.abs(ref[:, 1:k + 1])
                    + 2e-5 * ref[:, :1]).all()
            np.testing.assert_array_equal(got[:, 0], ref[:, 0])
            np.testing.assert_allclose(got[:, k + 1:], ref[:, k + 1:],
                                       rtol=0, atol=2e-6)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"role {r}")
