"""The port's log2 sketch and native histograms against the JAX reference.

`ops.sketches` log2 half (`log2_bucket`, `log2_hist_*`, `log2_quantile`),
the dense native-histogram state of `registry/metrics.py`, the paged
steps `ops.pages.native_hist_step` / `log2_hist_step` and the registry's
`NativeHistogram` / `PagedNativeHistogram` families with
`native_histograms()`, each fed the same seeded numpy inputs as its
counterpart in `tempo_tpu` (mirroring `tests/test_sketches.py:18-97`,
`tests/test_registry.py:114`, `tests/test_pages.py:166,405-420` and
`tests/test_generator.py:228-260,367-394`).

Tolerances. Counts, buckets and zero counts are compared exactly, sums
at rtol 1e-6 and quantiles (an `exp2` of the bucket position) at rtol
1e-6. The bucket of a value is exact except on the one-ulp edge rule:
torch's f32 `log2` and XLA's may differ by one ulp, so a value whose
nudged f32 log2 lies within two ulps of an integer may land one bucket
apart from the reference's, never more; exact powers of two (2^62
included) and 65,536 lognormal durations land where the reference's do.
"""

from __future__ import annotations

import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu import ops as jops
from tempo_tpu.generator import remote_write as jrw
from tempo_tpu.ops import pages as jop
from tempo_tpu.registry import pages as jpages
from tempo_tpu.registry.registry import ManagedRegistry as JReg
from tempo_tpu.registry.registry import RegistryOverrides as JOv
from tempo_tpu_torch.generator import remote_write as trw
from tempo_tpu_torch.ops import pages as top
from tempo_tpu_torch.ops import sketches as tsk
from tempo_tpu_torch.registry import metrics as tm
from tempo_tpu_torch.registry import pages as tpages
from tempo_tpu_torch.registry.registry import ManagedRegistry as TReg
from tempo_tpu_torch.registry.registry import RegistryOverrides as TOv

def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _port_bucket(vals, offset=0) -> np.ndarray:
    return top.log2_bucket(_t(vals), offset).numpy()


def _ref_bucket(vals, offset=0) -> np.ndarray:
    return np.asarray(jops.log2_bucket(jnp.asarray(vals, jnp.float32),
                                       offset))


# -- log2_bucket -------------------------------------------------------------

def test_log2_bucket_matches_bit_length():
    vals = np.array([0, 1, 2, 3, 4, 7, 8, 1023, 1024, 2**40, 2**62],
                    dtype=np.float64)
    want = np.array([int(v).bit_length() if v < 2**53
                     else min(63, math.floor(math.log2(v)) + 1)
                     for v in vals])
    got = _port_bucket(vals.astype(np.float32))
    np.testing.assert_array_equal(got, np.minimum(want, 63))
    np.testing.assert_array_equal(got, _ref_bucket(vals))


@pytest.mark.parametrize("offset", [0, 32])
def test_log2_bucket_edge_probes_within_one_ulp(offset):
    """Probes at every power of two in [2^-40, 2^62] and around each
    nudged edge 2^(k - 1e-4), eight f32 neighbours each side: exact
    powers land where the reference's do; a probe may land one bucket
    apart only where its nudged log2 lies within two f32 ulps of an
    integer (the one-ulp difference of the two f32 log2's, plus the
    nudge's rounding)."""
    ks = np.arange(-40, 63)
    powers = np.ldexp(np.float32(1.0), ks).astype(np.float32)
    np.testing.assert_array_equal(_port_bucket(powers, offset),
                                  _ref_bucket(powers, offset))
    edges = np.exp2(ks.astype(np.float64) - 1e-4).astype(np.float32)
    probes = [edges]
    lo = hi = edges
    for _ in range(8):
        lo = np.nextafter(lo, np.float32(0))
        hi = np.nextafter(hi, np.float32(np.inf))
        probes += [lo, hi]
    v = np.concatenate(probes + [powers]).astype(np.float32)
    got, want = _port_bucket(v, offset), _ref_bucket(v, offset)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    x = np.log2(v.astype(np.float64)) + 1e-4
    ulp = np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)
    near = np.abs(x - np.round(x)) <= 2 * ulp
    assert not (diff & ~near).any(), v[(diff > 0) & ~near]


def test_log2_bucket_lognormal_durations_exact():
    rng = np.random.default_rng(11)
    v = rng.lognormal(-4, 2, 65536).astype(np.float32)
    for off in (0, 32):
        np.testing.assert_array_equal(_port_bucket(v, off),
                                      _ref_bucket(v, off))


# -- log2 histograms ---------------------------------------------------------

def _pair_hist(n_series, sids, vals, offset=0, mask=None, weights=None):
    j = jops.log2_hist_update(jops.log2_hist_init(n_series, offset=offset),
                              jnp.asarray(sids), jnp.asarray(vals,
                                                             jnp.float32),
                              mask=None if mask is None else jnp.asarray(mask),
                              weights=None if weights is None
                              else jnp.asarray(weights))
    t = tsk.log2_hist_update(
        tsk.log2_hist_init(n_series, offset=offset, device="cpu"),
        _t(sids, torch.int64), _t(vals),
        mask=None if mask is None else torch.as_tensor(mask),
        weights=None if weights is None else _t(weights))
    return j, t


def test_log2_hist_update_and_counts():
    j, t = _pair_hist(3, [0, 0, 1, 2, 2, 2], [1.0, 3.0, 100.0, 0.0, 5.0, 5.0])
    c = t.counts.numpy()
    assert c[0, 1] == 1 and c[0, 2] == 1 and c[1, 7] == 1
    assert c[2, 0] == 1 and c[2, 3] == 2 and c.sum() == 6
    np.testing.assert_array_equal(c, np.asarray(j.counts))


def test_log2_hist_mask_drops_padding():
    j, t = _pair_hist(1, [0, 0, 0, 0], [1.0, 2.0, 4.0, 8.0],
                      mask=[True, True, False, False])
    assert float(t.counts.sum()) == 2.0
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))


def test_log2_hist_ids_outside_the_rows_drop():
    """Ids past the rows drop in both; a negative id drops in the port
    (the reference's scatter wraps it to the last rows)."""
    t = tsk.log2_hist_update(tsk.log2_hist_init(2, device="cpu"),
                             _t([0, 2, 5, -1], torch.int64),
                             _t([1.0, 1.0, 1.0, 1.0]))
    assert float(t.counts.sum()) == 1.0 and t.counts[0, 1] == 1


def test_log2_quantile_within_bucket_bounds():
    rng = np.random.default_rng(0)
    vals = rng.lognormal(mean=10, sigma=2, size=20000)
    j, t = _pair_hist(1, np.zeros(vals.size, np.int64), vals)
    qs = []
    for q in (0.1, 0.5, 0.9, 0.99):
        est = float(tsk.log2_quantile(t, q)[0])
        np.testing.assert_allclose(est, float(jops.log2_quantile(j, q)[0]),
                                   rtol=1e-6)
        if q >= 0.5:
            true = np.quantile(vals, q)
            assert true / 2 <= est <= true * 2, (q, est, true)
        qs.append(est)
    assert qs == sorted(qs)


def test_log2_quantile_stays_inside_the_hit_bucket():
    j, t = _pair_hist(1, np.zeros(1000, np.int64), np.full(1000, 3.5))
    for q in (0.01, 0.5, 0.99):
        est = float(tsk.log2_quantile(t, q)[0])
        assert 2.0 <= est <= 4.0, (q, est)
        np.testing.assert_allclose(est, float(jops.log2_quantile(j, q)[0]),
                                   rtol=1e-6)


def test_log2_offset_keeps_subsecond_resolution():
    j, t = _pair_hist(1, np.zeros(3, np.int64), [0.001, 0.03, 0.5],
                      offset=32)
    c = t.counts.numpy()[0]
    assert c[0] == 0 and (c > 0).sum() == 3
    est = float(tsk.log2_quantile(t, 0.99)[0])
    assert 0.25 <= est <= 1.0
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))


def test_log2_hist_merge_equals_concat():
    rng = np.random.default_rng(1)
    vals = rng.exponential(1e6, 500)
    sids = rng.integers(0, 2, vals.size)
    j, t = _pair_hist(2, sids, vals)
    m = tsk.log2_hist_merge(t, t)
    np.testing.assert_array_equal(m.counts.numpy(), 2 * t.counts.numpy())
    np.testing.assert_array_equal(
        m.counts.numpy(), np.asarray(jops.log2_hist_merge(j, j).counts))
    with pytest.raises(ValueError, match="incompatible"):
        tsk.log2_hist_merge(t, tsk.log2_hist_init(2, offset=32,
                                                  device="cpu"))


# -- dense native-histogram state and the paged steps ------------------------

def _obs(seed, n=256, n_series=40):
    rng = np.random.default_rng(seed)
    sids = rng.integers(-1, n_series + 2, n).astype(np.int32)
    vals = np.concatenate([np.zeros(8), rng.lognormal(-3, 2, n - 8)]) \
        .astype(np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    return sids, vals, w


def test_native_histogram_update_matches_reference():
    from tempo_tpu.registry import metrics as jm

    sids, vals, w = _obs(3)
    keep = sids >= 0   # the reference wraps a negative slot's scatter
    j = jm.native_histogram_update(jm.native_histogram_init(40),
                                   jnp.asarray(np.where(keep, sids, 40)),
                                   jnp.asarray(vals), jnp.asarray(w))
    t = tm.native_histogram_update(tm.native_histogram_init(40, device="cpu"),
                                   _t(sids, torch.int64), _t(vals), _t(w))
    np.testing.assert_array_equal(t.hist.counts.numpy(),
                                  np.asarray(j.hist.counts))
    for f in ("counts", "zeros"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    np.testing.assert_allclose(t.sums.numpy(), np.asarray(j.sums), rtol=1e-6)
    assert t.hist.offset == tm.NATIVE_HISTOGRAM_OFFSET == 32
    tm.zero_slots(t, np.array([0, 1, 40], np.int32))
    assert not t.hist.counts[:2].any() and not t.sums[:2].any()


def test_paged_native_and_log2_steps_match_dense():
    """`native_hist_step` / `log2_hist_step` through an identity page
    table equal the dense updates (`tests/test_pages.py:405-420`), and the
    reference's paged steps."""
    n_series, page_rows = 128, 16
    shift = page_rows.bit_length() - 1
    sids, vals, w = _obs(5, n=512, n_series=n_series)
    sids = np.where(sids >= n_series, -1, sids).astype(np.int32)
    table = np.arange(n_series // page_rows, dtype=np.int32)
    lg = tsk.log2_hist_update(tsk.log2_hist_init(n_series, offset=32,
                                                 device="cpu"),
                              _t(sids, torch.int64), _t(vals), weights=_t(w))
    ah = torch.zeros((n_series, 64))
    top.log2_hist_step(ah, torch.from_numpy(table), sids, vals, w,
                       offset=32, page_shift=shift)
    np.testing.assert_array_equal(lg.counts.numpy(), ah.numpy())
    jah = jop.log2_hist_step(32, shift)(jnp.zeros((n_series, 64)), table,
                                        sids, vals, w)
    np.testing.assert_array_equal(ah.numpy(), np.asarray(jah))
    nh = tm.native_histogram_update(
        tm.native_histogram_init(n_series, device="cpu"),
        _t(sids, torch.int64), _t(vals), _t(w))
    arenas = [torch.zeros(n_series) for _ in range(3)]
    ah2 = torch.zeros((n_series, 64))
    tt = torch.from_numpy(table)
    top.native_hist_step(*arenas, ah2, tt, tt, tt, tt, sids, vals, w,
                         offset=32, page_shift=shift)
    np.testing.assert_array_equal(ah2.numpy(), nh.hist.counts.numpy())
    for a, f in zip(arenas, ("sums", "counts", "zeros")):
        np.testing.assert_array_equal(a.numpy(), getattr(nh, f).numpy())
    ja = jop.native_hist_step(32, shift)(
        jnp.zeros(n_series), jnp.zeros(n_series), jnp.zeros(n_series),
        jnp.zeros((n_series, 64)), table, table, table, table, sids, vals, w)
    for a, b in zip([*arenas, ah2], ja):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# -- the registry families ---------------------------------------------------

def _regs(**kw):
    return (JReg("t1", JOv(**kw), now=lambda: 1000.0),
            TReg("t1", TOv(**kw), now=lambda: 1000.0, device="cpu"))


def test_native_histogram_counts():
    """`tests/test_registry.py:114` on both registries."""
    for reg in _regs():
        nh = reg.new_native_histogram("lat", ("svc",))
        rows = reg.interner.intern_many(["a"] * 3).reshape(3, 1)
        nh.observe_batch(rows, np.array([0.0, 1.0, 8.0], np.float32))
        m = {(s.name, s.labels): s.value for s in reg.collect(1)
             if not s.is_stale_marker}
        assert [v for (n, _), v in m.items() if n == "lat_count"] == [3.0]
        slots, labels, hist, sums, counts, zeros = nh.native_payload()
        assert counts[0] == 3.0 and zeros[0] == 1.0 and sums[0] == 9.0
        assert hist[0].sum() == 3.0 and hist[0][0] == 1.0


def _drive_native(reg, t):
    rng = np.random.default_rng(7)
    nh = reg.new_native_histogram("nh", ("svc",))
    c = reg.new_counter("c_total", ("svc",))
    outs = []
    for round_ in range(3):
        for _ in range(4):
            rows = reg.interner.intern_many(
                [f"s{j}" for j in rng.integers(0, 9, 32)])[:, None]
            c.inc_batch(rows, rng.random(32).astype(np.float32))
            nh.observe_batch(rows, (rng.random(32) * 3).astype(np.float32))
        outs.append(sorted((s.name, s.labels, s.value)
                           for s in reg.collect(round_)
                           if s.value == s.value))
        outs.append([np.asarray(x).tolist()
                     for x in nh.native_payload()[2:]])
        outs.append([(lab, np.asarray(h).tolist(), *rest)
                     for lab, h, *rest in reg.native_histograms(round_)])
        t[0] += 1000
        reg.purge_stale()     # evict everything, the next round reuses
    return outs


def _close(a, b):
    """Nested sample structures equal, floats at rtol 1e-6."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-6)
    else:
        assert a == b


def test_families_bit_identical_paged_vs_dense_with_eviction():
    """`tests/test_pages.py:166` with a native histogram family: the port
    paged equals the port dense bit for bit, and both equal the
    reference's dense run (sums at rtol 1e-6)."""
    def reg_on(pool, t, port):
        mod, Reg, Ov = (tpages, TReg, TOv) if port else (jpages, JReg, JOv)
        kw = dict(device="cpu") if port else {}
        with mod.use(pool):
            return Reg("t", Ov(max_active_series=64, stale_duration_s=100.0),
                       now=lambda: t[0], **kw)

    t1, t2, t3 = [1000.0], [1000.0], [1000.0]
    pool = tpages.PagePool(tpages.PagePoolConfig(
        enabled=True, page_rows=16, arena_slots=512), device="cpu")
    paged_reg = reg_on(pool, t1, True)
    assert type(paged_reg.new_native_histogram("x", ("a",))).__name__ == \
        "PagedNativeHistogram"
    paged_reg._metrics.pop("x")
    paged = _drive_native(paged_reg, t1)
    dense = _drive_native(reg_on(None, t2, True), t2)
    assert paged == dense
    ref = _drive_native(reg_on(None, t3, False), t3)
    _close(dense, ref)


def test_native_histogram_encoding_matches_reference():
    """The remote-write proto of a native histogram
    (`tests/test_generator.py:228-260`), byte for byte."""
    counts = np.zeros(64)
    counts[3], counts[4], counts[10], counts[32] = 5, 2, 1, 4
    for off in (0, 32):
        assert trw.encode_native_histogram(
            counts, total=12, zeros=0, sum_=40.0, ts_ms=7, offset=off) == \
            jrw.encode_native_histogram(
                counts, total=12, zeros=0, sum_=40.0, ts_ms=7, offset=off)


def test_native_histograms_vs_concurrent_pushes():
    """`tests/test_generator.py:367`: `collect()`, `native_histograms()`
    and `quantile()` on a reader thread while pushes update the state;
    every read serializes on the registry state lock and none raises."""
    from tempo_tpu_torch.generator import GeneratorConfig, GeneratorInstance
    from tempo_tpu_torch.model.span_batch import SpanBatchBuilder

    from tempo_tpu_torch.generator.processors.spanmetrics import (
        SpanMetricsConfig)
    from tempo_tpu_torch.registry import RegistryOverrides

    inst = GeneratorInstance("t", GeneratorConfig(
        processors=("span-metrics",),
        registry=RegistryOverrides(max_active_series=1024),
        spanmetrics=SpanMetricsConfig(sketch_max_series=256)), device="cpu")
    nh = inst.registry.new_native_histogram("nh", ("svc",))
    proc = inst.processors["span-metrics"]
    rng = np.random.default_rng(9)
    stop = threading.Event()
    errs: list = []

    def reader():
        while not stop.is_set():
            try:
                inst.registry.collect(1000)
                inst.registry.native_histograms(1000)
                proc.quantile(0.99)
            except Exception as e:      # pragma: no cover - the regression
                errs.append(e)

    th = threading.Thread(target=reader)
    th.start()
    try:
        for k in range(8):
            b = SpanBatchBuilder(inst.registry.interner)
            for i in range(64):
                b.append(trace_id=rng.bytes(16), span_id=rng.bytes(8),
                         name=f"op-{i % 4}", service=f"svc-{i % 3}", kind=2,
                         status_code=0, start_unix_nano=0,
                         end_unix_nano=int(rng.integers(1, 10 ** 9)))
            inst.push_batch(b.build())
            rows = inst.registry.interner.intern_many(
                [f"s{i % 5}" for i in range(64)])[:, None]
            nh.observe_batch(rows, rng.random(64).astype(np.float32))
    finally:
        stop.set()
        th.join()
    assert not errs, errs
    got = inst.registry.native_histograms(1)
    assert len(got) == 5 and sum(g[3] for g in got) == 8 * 64
