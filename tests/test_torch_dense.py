"""The port's dense state layout against the JAX reference's.

With no page pool, both packages keep a tenant's state dense: the
reference in jitted composed scatters (`_fused_update_impl`, `kernel="xla"`,
direct route), the port in row views of trash-paged arenas that its
paged fused update (K1, the plain version here on the CPU) reaches
through identity page tables. Both resolve series in their C++ row
tables (first-seen slot order). Small widths:
`max_active_series` 1,024, sketches over 256 series.

Tolerances: calls, bucket and count samples and the DDSketch grid exact;
sums (latency `_sum`, size) at rtol 1e-5; DDSketch quantiles equal;
moment rows and moments quantiles under ROADMAP section 3 (counts exact,
sums rtol 1e-5 plus 2e-5 per unit of weight, bounds atol 2e-6; q99 at
rtol 1e-3, a q50 outside it inside the row's support).
"""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.generator.processors.spanmetrics import \
    _fused_update_impl as j_fused_update_impl
from tempo_tpu.ops import moments as jmom
from tempo_tpu.ops import sketches as jsk
from tempo_tpu.registry import metrics as jm

import tempo_tpu_torch as tt
from tempo_tpu_torch.generator.processors.spanmetrics import _fused_update_impl
from tempo_tpu_torch.ops import moments as tmom
from tempo_tpu_torch.ops import pages as top
from tempo_tpu_torch.ops import sketches as tsk
from tempo_tpu_torch.registry import DEFAULT_HISTOGRAM_EDGES as EDGES
from tempo_tpu_torch.registry import metrics as tm
from tempo_tpu_torch.registry import pages as tpages
from tests.test_torch_spanmetrics import (POOL, SERIES, SM, T0, _compare_collect,
                                          _compare_tier, _payload, _push, _worlds)

TIERS = {"dd": dict(), "moments": dict(sketch="moments"),
         "both": dict(sketch="both")}
DD_ROWS = SM["sketch_max_series"]
K, MIN_S, MAX_S = 12, 1e-6, 1e5


def _dense_worlds(tier="dd", **kw):
    clock, jg, tg = _worlds(jsm=TIERS[tier], tsm=TIERS[tier], pool=None, **kw)
    jp, tp = jg.processors["span-metrics"], tg.processors["span-metrics"]
    assert jg.state_layout == tg.state_layout == "dense"
    assert (jp.mom is None) == (tp.mom is None) == (tier == "dd")
    assert (jp.dd is None) == (tp.dd is None) == (tier == "moments")
    return clock, jg, tg


def _compare(jg, tg, tier, ctx):
    """Samples, DDSketch quantiles and (moments tiers) moment rows and
    quantiles, under the module docstring's rules."""
    if tier == "dd":
        _compare_collect(jg, tg, ctx)
        jp, tp = jg.processors["span-metrics"], tg.processors["span-metrics"]
        for q in (0.5, 0.99):
            assert tp.quantile(q) == jp.quantile(q), f"{ctx}: quantile({q})"
    else:
        _compare_tier(jg, tg, ctx, compact=False)


@pytest.mark.parametrize("tier", list(TIERS))
def test_dense_push_collect_quantile_match(tier):
    """(a) Three pushes, then collect and quantiles, under each sketch
    tier."""
    _, jg, tg = _dense_worlds(tier)
    for seed in range(3):
        _push(jg, tg, _payload(seed, T0))
    assert tg.registry.active_series == jg.registry.active_series > DD_ROWS
    _compare(jg, tg, tier, tier)


def test_dense_purge_then_reuse_clean_sketch_rows():
    """(b) After a purge the evicted slots' sketch rows are zero; the
    freed slots are then reused, and every row matches the reference."""
    clock, jg, tg = _dense_worlds("both")
    _push(jg, tg, _payload(0, T0))
    clock[0] = T0 + 600
    _push(jg, tg, _payload(2, clock[0], kinds=(2,), statuses=(0,)))
    clock[0] = T0 + 1000
    table = tg.processors["span-metrics"].calls.table
    stale = np.flatnonzero(table.active & (table.last_seen < clock[0] - 900))
    assert tg.registry.purge_stale() == jg.registry.purge_stale() == stale.size
    tp = tg.processors["span-metrics"]
    gone = stale[stale < DD_ROWS]
    assert gone.size and not tp.dd.counts[gone].any()
    assert not tp.dd.zeros[gone].any() and not tp.mom.data[gone].any()
    _compare(jg, tg, "both", "after purge")
    _push(jg, tg, _payload(3, clock[0]))
    assert np.isin(gone, tp.calls.table.active_slots()).any()
    _compare(jg, tg, "both", "after reuse")


def _batch(seed, n=2000, series=SERIES):
    """Seeded inputs: discards, slots past the sketch rows, DDSketch zero
    durations, integer weights."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(-1, series, n).astype(np.int32)
    slots[:64] = -1
    dur = rng.lognormal(-3, 1.5, n).astype(np.float32)
    dur[64:70] = (0.0, MIN_S / 2, MIN_S, 1.0, 2e5, 1e-9)
    sizes = rng.integers(100, 5000, n).astype(np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    assert (slots >= DD_ROWS).sum() > n // 2
    return slots, dur, sizes, w


def _port_states(series=SERIES, page_rows=top.DENSE_PAGE_ROWS):
    dev = dict(device="cpu", page_rows=page_rows)
    return (tm.counter_init(series, **dev),
            tm.histogram_init(series, EDGES, **dev),
            tm.counter_init(series, **dev),
            tsk.dd_init(DD_ROWS, 0.01, MIN_S, MAX_S, **dev),
            tmom.moments_init(DD_ROWS, K, MIN_S, MAX_S, **dev))


def _flat(states) -> list[np.ndarray]:
    """Every plane of (calls, latency, sizes, dd, mom), role by role:
    calls, hist sums, hist counts, sizes, buckets, dd zeros, dd grid,
    moments."""
    c, h, z, dd, mom = states
    return [np.asarray(x, np.float32) for x in (
        c.values, h.sums, h.counts, z.values, h.bucket_counts, dd.zeros,
        dd.counts, mom.data)]


def _assert_planes(got, want, ctx):
    for r, (a, b) in enumerate(zip(got, want)):
        if r == 7:
            assert (a[:, 0] == b[:, 0]).all(), f"{ctx}: moments count"
            assert (np.abs(a[:, 1:K + 1] - b[:, 1:K + 1])
                    <= 1e-5 * np.abs(b[:, 1:K + 1]) + 2e-5 * b[:, :1]).all(), \
                f"{ctx}: moments sums"
            np.testing.assert_allclose(a[:, K + 1:], b[:, K + 1:], rtol=0,
                                       atol=2e-6, err_msg=f"{ctx}: bounds")
        elif r in (1, 3):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{ctx}: role {r}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: role {r}")


def test_composed_twin_matches_reference_step():
    """(c) The port's composed twin against the reference's
    `_fused_update_impl`, two pushes from zero state."""
    ref = (jm.counter_init(SERIES), jm.histogram_init(SERIES, EDGES),
           jm.counter_init(SERIES), jsk.dd_init(DD_ROWS, 0.01, MIN_S, MAX_S),
           jmom.MomentsSketch(data=jnp.zeros((DD_ROWS, K + 3), jnp.float32),
                              k=K, lo=float(np.log(MIN_S)),
                              hi=float(np.log(MAX_S))))
    got = _port_states()
    assert (got[4].k, got[4].lo, got[4].hi) == (K, ref[4].lo, ref[4].hi)
    for seed in (1, 2):
        b = _batch(seed)
        ref = j_fused_update_impl(*ref, *b)
        _fused_update_impl(*got, *(torch.from_numpy(x) for x in b))
    _assert_planes(_flat(got), _flat(ref), "twin vs reference")


@pytest.mark.parametrize("series", [SERIES, 1000])
def test_k1_plain_over_identity_tables_matches_twin(series):
    """(d) K1's plain version over dense state's identity tables against
    the composed twin, two pushes; the trash pages stay zero. 1,000
    series leave the last page partly past the series table."""
    pr = top.DENSE_PAGE_ROWS
    twin, k1 = _port_states(series), _port_states(series)
    views = (k1[0].values, k1[1].sums, k1[1].counts, k1[2].values,
             k1[1].bucket_counts, k1[3].zeros, k1[3].counts, k1[4].data)
    arenas = [top.arena_of(v, pr) for v in views]
    tables = top.identity_tables([v.shape[0] for v in views], pr, "cpu")
    assert tables.shape == (8, -(-series // pr))
    gamma, _ = tsk.dd_params(0.01, MIN_S, MAX_S)
    for seed in (3, 4):
        b = _batch(seed, series=series)
        _fused_update_impl(*twin, *(torch.from_numpy(x) for x in b))
        top.fused_step(arenas, tables, tuple(b), edges=EDGES, gamma=gamma,
                       min_value=MIN_S, dd_rows=DD_ROWS,
                       page_shift=pr.bit_length() - 1, mom_rows=DD_ROWS,
                       mom_meta=tmom.moments_params(K, MIN_S, MAX_S))
    _assert_planes(_flat(k1), _flat(twin), "K1 plain vs twin")
    for r, a in enumerate(arenas):
        assert not a[:pr].any(), f"role {r}: trash page written"


def test_dense_and_paged_layouts_collect_the_same():
    """(e) The port's dense and paged layouts, fed the same pushes,
    collect the same samples and answer the same quantiles."""
    insts = []
    for pool in (None, POOL):
        with tpages.use(pool and tpages.PagePool(
                tpages.PagePoolConfig(**pool), device="cpu")):
            insts.append(tt.GeneratorInstance("t", tt.GeneratorConfig(
                registry=tt.RegistryOverrides(max_active_series=SERIES),
                spanmetrics=tt.SpanMetricsConfig(sketch="both", **SM)),
                now=lambda: T0, device="cpu"))
    dense, paged = insts
    assert (dense.state_layout, paged.state_layout) == ("dense", "paged")
    for seed in range(3):
        for g in insts:
            g.push_batch(tt.otlp_proto_to_batch(
                _payload(seed, T0), tt.SpanBatchBuilder(g.registry.interner)))
    assert _compare_collect(dense, paged, "dense vs paged") > 1000
    pd, pp = dense.processors["span-metrics"], paged.processors["span-metrics"]
    for q in (0.5, 0.99):
        assert pd.quantile(q) == pp.quantile(q)
        assert pd.dd_quantiles((q,)) == pp.dd_quantiles((q,))


def test_capacity_indivisible_tenant_goes_dense(caplog):
    """(f) With a page pool whose pages do not divide max_active_series,
    both packages keep the tenant dense (with a warning) and agree."""
    with caplog.at_level(logging.WARNING, "tempo_tpu_torch.registry"):
        _, jg, tg = _worlds(series=1000)
    assert jg.state_layout == tg.state_layout == "dense"
    assert "stays on the dense layout" in caplog.text
    for seed in range(2):
        _push(jg, tg, _payload(seed, T0))
    _compare(jg, tg, "dd", "indivisible")


def test_compact_state_on_dense_raises():
    """(g) Dense state has no compact tier: no pool, or a capacity the
    pool's pages do not divide, with `compact_state` raises."""
    cfg = tt.SpanMetricsConfig(compact_state=True, **SM)
    for pool, series in ((None, SERIES), (POOL, 1000)):
        with tpages.use(pool and tpages.PagePool(
                tpages.PagePoolConfig(**pool), device="cpu")):
            with pytest.raises(ValueError, match="paged layout"):
                tt.GeneratorInstance("t", tt.GeneratorConfig(
                    registry=tt.RegistryOverrides(max_active_series=series),
                    spanmetrics=cfg), device="cpu")


@pytest.mark.parametrize("tier", list(TIERS))
def test_device_state_bytes_are_the_references_plus_trash_pages(tier):
    """(h) Dense device state bytes: the reference's full pre-sized planes
    plus exactly one trash page of each plane."""
    _, jg, tg = _dense_worlds(tier)
    _push(jg, tg, _payload(0, T0))
    tp = tg.processors["span-metrics"]
    row = 4 * (4 + len(EDGES) + 1)                  # calls, lat, size, hist
    if tp.dd is not None:
        row += 4 * (1 + tp.dd.counts.shape[1])
    if tp.mom is not None:
        row += 4 * tp.mom.data.shape[1]
    assert tg.registry.dense_page_rows == top.DENSE_PAGE_ROWS
    assert tg.device_state_bytes() == \
        jg.device_state_bytes() + top.DENSE_PAGE_ROWS * row
