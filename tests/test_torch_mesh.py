"""The port's serving mesh against the reference, on logical CPU shards.

Mirrors `tests/test_parallel.py`, `tests/test_mesh_serving.py` and the
mesh cases of `tests/test_pages.py:318-350` and
`tests/test_moments.py:365-426`. The reference's mesh runs on the 8
virtual CPU devices of `tests/conftest.py`; the port's on a list of
`torch.device("cpu")` repeated per shard (`ServingMesh(cfg, devices=)`).

jax 0.9.0's `shard_map` takes no `check_rep`, so the reference's
sharded serving step and paged mesh step raise `TypeError` and cannot
be compared against. The port's sharded serving path is held against
the reference's single-device path (counts, buckets and DDSketch rows
exact; float sums at rtol 1e-6, since K1 folds a push's delta where
the reference adds span by span), and against itself unsharded: with
one data shard, `collect()` and the sketch quantiles are bit-identical
at 1, 2, 4 and 8 series shards (each shard applies the same batch rows
in the same order to the rows it owns). Two data shards reduce their
deltas in shard order: counts exact, sums and moments at rtol 1e-5.
`sharded_spanmetrics_step` and `sharded_query_range_step`, which run
under jax 0.9.0, are held against the reference's own on its 8 devices
(counts exact, sums rtol 1e-5 / 1e-6).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.ops import pages as op
from tempo_tpu_torch.parallel import serving
from tempo_tpu_torch.registry import pages as tpages

CPU = torch.device("cpu")
SUM_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _singletons():
    tsched.reset()
    serving.reset()
    yield
    serving.reset()
    tsched.reset()


def mesh(shards: int, series: int = 0, **kw) -> serving.ServingMesh:
    return serving.ServingMesh(serving.MeshConfig(
        enabled=True, series_shards=series, **kw), devices=[CPU] * shards)


def mk_proc(port: bool, max_series: int = 512, clock=None, **cfg):
    """(registry, processor) of one package; the port on the CPU."""
    clock = clock or [1000.0]
    if port:
        from tempo_tpu_torch.generator.processors.spanmetrics import (
            SpanMetricsConfig, SpanMetricsProcessor)
        from tempo_tpu_torch.registry import ManagedRegistry, RegistryOverrides
        kw = {"device": "cpu"}
    else:
        from tempo_tpu.generator.processors.spanmetrics import (
            SpanMetricsConfig, SpanMetricsProcessor)
        from tempo_tpu.registry import ManagedRegistry, RegistryOverrides
        kw = {}
        cfg.setdefault("kernel", "xla")
    reg = ManagedRegistry("t", RegistryOverrides(
        max_active_series=max_series, stale_duration_s=10.0),
        now=lambda: clock[0], **kw)
    return reg, SpanMetricsProcessor(reg, SpanMetricsConfig(**cfg))


def batch(reg, seed: int, n: int = 600, port: bool = True):
    if port:
        from tempo_tpu_torch.model.span_batch import SpanBatchBuilder
    else:
        from tempo_tpu.model.span_batch import SpanBatchBuilder
    b = SpanBatchBuilder(reg.interner)
    r = np.random.default_rng(seed)
    for i in range(n):
        b.append(trace_id=r.bytes(16), span_id=r.bytes(8),
                 name=f"op-{i % 9}", service=f"svc-{i % 3}",
                 kind=int(i % 6), status_code=int(i % 3),
                 start_unix_nano=10**18,
                 end_unix_nano=10**18 + int(r.lognormal(16, 1.0)))
    return b.build()


def collect(reg) -> list:
    # EXACT float values: the bit-identity surface
    return sorted((s.name, s.labels, s.value) for s in reg.collect(5000)
                  if s.value == s.value)


def is_sum(name: str) -> bool:
    return name.endswith("_sum") or name == "traces_spanmetrics_size_total"


def assert_collect_close(got, want, rtol=SUM_RTOL):
    """Series sets equal; counts and buckets exact, float sums at rtol."""
    assert [x[:2] for x in got] == [x[:2] for x in want]
    for (n, lab, v), (_, _, w) in zip(got, want):
        if is_sum(n):
            assert abs(v - w) <= rtol * abs(w), (n, lab, v, w)
        else:
            assert v == w, (n, lab, v, w)


def run(port: bool, seeds=(1, 2, 3), sm=None, **kw):
    with serving.use(sm):
        reg, proc = mk_proc(port, **kw)
        for seed in seeds:
            proc.push_batch(batch(reg, seed, port=port))
        return reg, proc


def count_k1(monkeypatch) -> list:
    """Count K1 dispatches (`ops.pages.fused_step`) on the CPU."""
    calls = []
    real = op.fused_step

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(op, "fused_step", counted)
    return calls


# -- tests/test_mesh_serving.py -------------------------------------------------

@pytest.mark.parametrize("sketch", ["dd", "both"])
def test_collect_bit_identical_across_series_shards(sketch):
    """collect() and the quantile sketch are bit-identical at 1, 2, 4
    and 8 series shards and to the unsharded port, and equal the
    reference's single-device processor to the contract."""
    outs = {}
    for shards in (1, 2, 4, 8):
        reg, proc = run(True, seeds=(1, 2), sm=mesh(shards), sketch=sketch)
        assert proc._mesh is not None and proc._mesh.series_shards == shards
        outs[shards] = (collect(reg), proc.quantile(0.99))
    reg, proc = run(True, seeds=(1, 2), sketch=sketch)
    plain = (collect(reg), proc.quantile(0.99))
    assert outs[1][0] and outs[1] == outs[2] == outs[4] == outs[8] == plain
    jreg, jproc = run(False, seeds=(1, 2), sketch=sketch)
    assert_collect_close(outs[8][0], collect(jreg))
    if sketch == "dd":
        assert outs[8][1] == jproc.quantile(0.99)


def test_mesh_vs_single_device_parity():
    """Two data shards x two series shards: the series set equals the
    reference's single-device one, counts exact, sums within 1e-5."""
    reg_m, proc_m = run(True, seeds=(1, 2), sm=mesh(4, series=2))
    assert proc_m._mesh.data_shards == 2
    jreg, _ = run(False, seeds=(1, 2))
    got, want = collect(reg_m), collect(jreg)
    assert len(got) == len(want) > 100
    assert_collect_close(got, want, rtol=1e-5)


def test_scheduler_route_bit_identical_across_series_shards():
    outs = {}
    for shards in (1, 2, 4):
        sc = tsched.DeviceScheduler(tsched.SchedConfig(pipeline_depth=0),
                                    start_worker=False)
        with tsched.use(sc):
            reg, proc = run(True, seeds=(1, 2), sm=mesh(shards))
            assert sc.flush()
            assert sc.batches_total.get("spanmetrics_fused_update", 0) >= 1
            outs[shards] = collect(reg)
    assert outs[1] and outs[1] == outs[2] == outs[4]


def test_sharded_state_donated_no_copy(monkeypatch):
    """The port's counterpart of donation: each shard's K1 writes a window
    of the processor's own planes in place (no state copy, the tensors
    keep their storage), one launch per shard per dispatch."""
    k1 = count_k1(monkeypatch)
    sm = mesh(4)
    with serving.use(sm):
        reg, proc = mk_proc(True)
        proc.push_batch(batch(reg, 1))
        calls0, dd0 = proc.calls.state.values, proc.dd.counts
        ptrs = (calls0.data_ptr(), dd0.data_ptr())
        plan = proc._mesh_plan
        assert len(plan.arenas) == 4 and len(k1) == 4
        arena = op.arena_of(calls0, reg.dense_page_rows)
        for s, wins in enumerate(plan.arenas):
            w = wins[0]
            assert w.untyped_storage().data_ptr() == \
                arena.untyped_storage().data_ptr()
            assert w.shape[0] == reg.dense_page_rows + 128
        proc.push_batch(batch(reg, 2))
        assert len(k1) == 8
        assert proc.calls.state.values is calls0 and proc.dd.counts is dd0
        assert (calls0.data_ptr(), dd0.data_ptr()) == ptrs
        # each shard's K1 touched only its own rows: a shard's window
        # table names no page outside it
        for t in plan.tables:
            assert int(t.max()) <= 128 // reg.dense_page_rows


def test_purge_then_push_keeps_working():
    clock = [1000.0]
    with serving.use(mesh(4)):
        reg, proc = mk_proc(True, clock=clock)
        proc.push_batch(batch(reg, 1))
        clock[0] += 100.0
        assert reg.purge_stale() > 0
        proc.push_batch(batch(reg, 2))
        assert proc.calls.state.values.sum() > 0
    jclock = [1000.0]
    jreg, jproc = mk_proc(False, clock=jclock)
    jproc.push_batch(batch(jreg, 1, port=False))
    jclock[0] += 100.0
    jreg.purge_stale()
    jproc.push_batch(batch(jreg, 2, port=False))
    assert_collect_close(collect(reg), collect(jreg))


def test_unshardable_capacity_falls_back_single_device():
    with serving.use(mesh(4)):
        reg, proc = mk_proc(True, max_series=510)     # 510 % 4 != 0
        proc.push_batch(batch(reg, 1, n=100))
        assert proc._mesh is None
        assert proc.calls.state.values.sum() > 0


def test_distinct_devices_raise_naming_item_13b():
    """Resident state over a mesh of distinct devices is item 13b."""
    sm = mesh(2)
    sm.registry_mesh.devices[0, 1] = torch.device("meta")
    with serving.use(sm):
        reg, proc = mk_proc(True)
        with pytest.raises(NotImplementedError, match="item 13b"):
            proc.push_batch(batch(reg, 1, n=16))


def test_coalescer_aligns_bucket_and_emits_shard_obs():
    """submit_rows(align=N) rounds the merged bucket up to a multiple of
    N, and mesh dispatches emit per-shard occupancy and padding rows
    under the `shard` label, as the reference's scheduler does."""
    from tempo_tpu import sched as jsched
    from tempo_tpu.obs.jaxruntime import RUNTIME as JRUNTIME
    from tempo_tpu.obs.registry import parse_exposition
    from tempo_tpu_torch.obs.runtime import RUNTIME as TRUNTIME

    out = []
    for mod, runtime in ((jsched, JRUNTIME), (tsched, TRUNTIME)):
        got = {}
        sc = mod.DeviceScheduler(mod.SchedConfig(min_bucket_rows=64),
                                 start_worker=False)
        with mod.use(sc):
            sc.submit_rows("mesh_k", "m", (np.zeros(48, np.int32),), 48,
                           lambda *a: got.setdefault("shape", a[0].shape),
                           pads=(-1,), align=3, shards=3)
            sc.drain_once(force=True)
            fams = parse_exposition(runtime.render())
        occ = fams["tempo_sched_batch_occupancy_ratio"]["samples"]
        shard_rows = sorted(
            dict(k[1]).get("shard") for k in occ
            if k[0] == "tempo_sched_batch_occupancy_ratio_bucket"
            and dict(k[1]).get("kernel") == "mesh_k"
            and dict(k[1]).get("le") == "+Inf")
        pad = {dict(k[1]).get("shard"): v for k, v in
               fams["tempo_sched_padding_waste_bytes_total"]["samples"]
               .items() if dict(k[1]).get("kernel") == "mesh_k"}
        out.append((got["shape"], shard_rows, pad))
        sc.stop() if hasattr(sc, "stop") else None
    assert out[0] == out[1]
    assert out[1][0] == (66,) and out[1][1] == ["0", "1", "2"]
    assert out[1][2]["2"] > 0


def _series_lists(rng, n_lists, n_series, T, labels="name", exemplars=True):
    from tempo_tpu_torch.traceql.engine_metrics import TimeSeries
    return [[(((labels, f"op-{i}"),),
              rng.integers(0, 500, T).astype(np.float64),
              [{"traceId": f"{j}-{i}"}] if exemplars else [])
             for i in range(n_series)] for j in range(n_lists)], TimeSeries


@pytest.mark.parametrize("kind", ["RATE", "COUNT_OVER_TIME",
                                  "MIN_OVER_TIME", "MAX_OVER_TIME"])
def test_frontend_combine_in_mesh_matches_host_fold(kind):
    """SeriesCombiner under the serving mesh: count-exact kinds merge via
    the in-mesh reduce, bit-equal to the port's host fold and to the
    reference's."""
    from tempo_tpu.traceql import ast as JA
    from tempo_tpu.traceql.engine_metrics import SeriesCombiner as JComb
    from tempo_tpu.traceql.engine_metrics import TimeSeries as JTS
    from tempo_tpu_torch.traceql import ast as TA
    from tempo_tpu_torch.traceql.engine_metrics import SeriesCombiner

    lists, TS = _series_lists(np.random.default_rng(7), 4, 11, 10)

    def run_comb(comb, ts_cls):
        for lst in lists:
            comb.add_all([ts_cls(lab, s.copy(), list(ex))
                          for lab, s, ex in lst])
        return {k: (v.samples, len(v.exemplars))
                for k, v in comb.series.items()}

    ref = run_comb(JComb(getattr(JA.MetricsKind, kind), 10), JTS)
    host = run_comb(SeriesCombiner(getattr(TA.MetricsKind, kind), 10), TS)
    sm = mesh(4, series=2, combine_min_elements=1)
    with serving.use(sm):
        got = run_comb(SeriesCombiner(getattr(TA.MetricsKind, kind), 10), TS)
    assert set(ref) == set(host) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k][0], ref[k][0])
        np.testing.assert_array_equal(host[k][0], ref[k][0])
        assert got[k][1] == host[k][1] == ref[k][1]


def test_frontend_combine_bit_identical_across_shard_counts():
    from tempo_tpu_torch.traceql import ast as TA
    from tempo_tpu_torch.traceql.engine_metrics import SeriesCombiner

    lists, TS = _series_lists(np.random.default_rng(9), 3, 9, 6, "svc",
                              exemplars=False)
    outs = {}
    for shards in (1, 2, 4):
        with serving.use(mesh(4, series=shards, combine_min_elements=1)):
            c = SeriesCombiner(TA.MetricsKind.RATE, 6)
            for lst in lists:
                c.add_all([TS(lab, s.copy()) for lab, s, _ in lst])
            outs[shards] = {k: v.samples.tobytes()
                            for k, v in c.series.items()}
    assert outs[1] == outs[2] == outs[4]


def test_mesh_config_check_warnings():
    """The `mesh:` block's warnings equal the reference's."""
    from tempo_tpu.app.config import load_config as jload
    from tempo_tpu_torch.app.config import load_config as tload

    for text in ("mesh:\n  enabled: true\n  series_shards: -1\n",
                 "mesh:\n  enabled: true\n  devices: 4\n"
                 "  series_shards: 3\n",
                 "mesh:\n  enabled: true\n  devices: 6\n",
                 "mesh:\n  enabled: true\n"):
        jw = [w for w in jload(text=text).check() if w.startswith("mesh")]
        tw = [w for w in tload(text=text).check() if w.startswith("mesh")]
        assert tw == jw
    assert any("divide" in w for w in tload(
        text="mesh:\n  enabled: true\n  devices: 4\n  series_shards: 3\n"
    ).check())


def test_configure_falls_back_on_bad_shape():
    """Bad shapes warn and fall back to the largest pow-2 series sharding
    that fits, as the reference's `ServingMesh` does; one device gives a
    1 x 1 mesh; `configure` never raises."""
    from tempo_tpu.parallel import serving as jserving

    for devices, series in ((4, 3), (6, 0), (8, 16), (3, 2)):
        cfg = dict(enabled=True, devices=devices, series_shards=series)
        j = jserving.ServingMesh(jserving.MeshConfig(**cfg))
        t = serving.ServingMesh(serving.MeshConfig(**cfg),
                                devices=[CPU] * 8)
        assert (t.n_devices, t.series_shards, t.data_shards) == \
            (j.n_devices, j.series_shards, j.data_shards)
    sm = serving.configure(serving.MeshConfig(enabled=True), device="cpu")
    assert sm is serving.active()
    assert (sm.n_devices, sm.series_shards, sm.data_shards) == (1, 1, 1)
    assert serving.configure(serving.MeshConfig(enabled=False)) is None
    assert serving.active() is None


def test_step_cache_not_keyed_by_mesh_id():
    from tempo_tpu_torch.parallel.mesh import make_mesh, mesh_fingerprint
    from tempo_tpu_torch.parallel.product import _STEP_CACHE, _cached_step

    _STEP_CACHE.clear()
    m1 = make_mesh(4, series_shards=2, devices=[CPU] * 8)
    m2 = make_mesh(4, series_shards=2, devices=[CPU] * 8)
    assert mesh_fingerprint(m1) == mesh_fingerprint(m2)
    f1 = _cached_step(m1, (0.1, 1.0), 1.02, 1e-9)
    assert _cached_step(m2, (0.1, 1.0), 1.02, 1e-9) is f1
    m3 = make_mesh(8, series_shards=2, devices=[CPU] * 8)
    assert mesh_fingerprint(m3) != mesh_fingerprint(m1)
    assert _cached_step(m3, (0.1, 1.0), 1.02, 1e-9) is not f1
    assert len(_STEP_CACHE) == 2
    _STEP_CACHE.clear()


def test_batch_placement_and_step_cache():
    """`put_batch` / `put_packed` split a batch's columns over the data
    shards in contiguous chunks (the reference's `P("data")`), and
    `serving_step` memoizes one step per hyperparameter set."""
    sm = mesh(8, series=2)
    a = np.arange(16, dtype=np.int32)
    chunks = sm.put_batch(a, a * 2)
    assert [c.tolist() for c in chunks[0]] == [a[i:i + 4].tolist()
                                              for i in range(0, 16, 4)]
    assert torch.equal(torch.cat(chunks[1]), torch.from_numpy(a * 2))
    mat = np.stack([a, a + 1]).astype(np.float32)
    parts = sm.put_packed(mat)
    assert len(parts) == 4 and all(p.shape == (2, 4) for p in parts)
    assert torch.equal(torch.cat(parts, dim=1), torch.from_numpy(mat))
    with pytest.raises(ValueError, match="split"):
        sm.put_batch(np.arange(10))
    kw = dict(edges=(0.1, 1.0), gamma=1.02, min_value=1e-9, capacity=64,
              dd_rows=64)
    assert sm.serving_step(**kw) is sm.serving_step(**kw)
    assert sm.serving_step(**kw) is not sm.serving_step(**kw, packed=True)
    with pytest.raises(ValueError, match="divide by series_shards"):
        sm.serving_step(**dict(kw, capacity=63))


def test_mesh_families_and_status():
    """The three `tempo_mesh_*` gauges and /status's "mesh" block."""
    from tempo_tpu.obs.registry import parse_exposition
    from tempo_tpu_torch.obs.runtime import RUNTIME

    fams = parse_exposition(RUNTIME.render())
    assert not fams["tempo_mesh_devices"]["samples"]
    with serving.use(mesh(8, series=4)):
        fams = parse_exposition(RUNTIME.render())
        got = {n: list(fams[n]["samples"].values())
               for n in ("tempo_mesh_devices", "tempo_mesh_series_shards",
                         "tempo_mesh_data_shards")}
    assert got == {"tempo_mesh_devices": [8.0],
                   "tempo_mesh_series_shards": [4.0],
                   "tempo_mesh_data_shards": [2.0]}


# -- tests/test_parallel.py -------------------------------------------------------

def test_multihost_mesh_falls_back_single_process():
    from tempo_tpu.parallel import make_multihost_mesh as jmm
    from tempo_tpu_torch.parallel import make_multihost_mesh

    m = make_multihost_mesh(series_shards=2, devices=[CPU] * 8)
    j = jmm(series_shards=2)
    assert m.axis_names == j.axis_names
    assert m.devices.shape == j.devices.shape == (4, 2)


def _jput(mesh_, arr, spec):
    import jax
    from jax.sharding import NamedSharding

    return jax.device_put(arr, NamedSharding(mesh_, spec))


@pytest.mark.parametrize("n_buckets", [0, 64])
def test_sharded_query_range_matches_reference(n_buckets):
    """`sharded_query_range_step` on 4 data x 2 series logical shards
    against the reference's on its 8 devices: the histogram plane's
    counts exact, the value grid within rtol 1e-6; iterating
    accumulates."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tempo_tpu.parallel import make_mesh as jmake
    from tempo_tpu.parallel import sharded_query_range_step as jstep
    from tempo_tpu_torch.parallel import make_mesh, sharded_query_range_step

    n_series, n_steps, n_spans = 32, 4, 256
    rng = np.random.default_rng(n_buckets)
    slots = rng.integers(0, n_series, n_spans).astype(np.int32)
    steps = rng.integers(0, n_steps, n_spans).astype(np.int32)
    vals = (rng.lognormal(17, 1.5, n_spans) if n_buckets
            else rng.random(n_spans)).astype(np.float32)
    shape = (n_series, n_steps) + ((n_buckets,) if n_buckets else ())
    jm = jmake(8, series_shards=2)
    js = jstep(jm, n_buckets=n_buckets)
    spec = P("series", None, None) if n_buckets else P("series", None)
    jg = _jput(jm, jnp.zeros(shape, jnp.float32), spec)
    jb = [_jput(jm, jnp.asarray(x), P("data")) for x in (slots, steps, vals)]
    tm = make_mesh(8, series_shards=2, devices=[CPU] * 8)
    ts = sharded_query_range_step(tm, n_buckets=n_buckets)
    tg = torch.zeros(shape)
    for _ in range(2):
        jg = js(jg, *jb)
        tg = ts(tg, slots, steps, vals)
        if n_buckets:
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        else:
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    ref = np.zeros(shape, np.float32)
    if n_buckets:
        b = np.clip(np.ceil(np.log2(np.maximum(vals, 1.0))), 0,
                    n_buckets - 1).astype(int)
        np.add.at(ref, (slots, steps, b), 2.0)
        np.testing.assert_array_equal(tg.numpy(), ref)
    else:
        np.add.at(ref, (slots, steps), 2 * vals)
        np.testing.assert_allclose(tg.numpy(), ref, rtol=1e-5)


def test_sharded_spanmetrics_step_matches_reference(monkeypatch):
    """The dry-run step of `__graft_entry__.dryrun_multichip`: 4 data x
    2 series shards, two iterations; counts, buckets and DDSketch grids
    exact against the reference's on its 8 devices, sums at rtol 1e-5;
    K1 launched once per (data, series) shard."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tempo_tpu.ops import sketches as jsk
    from tempo_tpu.parallel import make_mesh as jmake
    from tempo_tpu.parallel import sharded_spanmetrics_step as jstep
    from tempo_tpu_torch.parallel import make_mesh, sharded_spanmetrics_step

    edges = (0.002, 0.032, 0.512, 8.192)
    gamma, nb = jsk.dd_params(0.01, 1e-9, 1e6)
    n_series, n_spans = 32, 256
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, n_series, n_spans).astype(np.int32),
             rng.lognormal(-3, 1.0, n_spans).astype(np.float32),
             rng.integers(100, 1000, n_spans).astype(np.float32),
             np.ones(n_spans, np.float32))
    shapes = ((n_series,), (n_series, len(edges) + 1), (n_series,),
              (n_series,), (n_series,), (n_series, nb), (n_series,))
    jm = jmake(8, series_shards=2)
    js = jstep(jm, edges, gamma, 1e-9)
    jst = tuple(_jput(jm, jnp.zeros(s, jnp.float32),
                      P("series") if len(s) == 1 else P("series", None))
                for s in shapes)
    jb = tuple(_jput(jm, jnp.asarray(x), P("data")) for x in batch)
    k1 = count_k1(monkeypatch)
    ts = sharded_spanmetrics_step(make_mesh(8, series_shards=2,
                                            devices=[CPU] * 8),
                                  edges, gamma, 1e-9)
    tst = tuple(torch.zeros(s) for s in shapes)
    for _ in range(2):
        jst = js(*jst, *jb)
        tst = ts(*tst, *batch)
    assert len(k1) == 2 * 8
    for r, (a, b) in enumerate(zip(tst, jst)):
        if r in (2, 4):                 # latency sum, size counter
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(tst[0].sum()) == 2 * n_spans


def test_sharded_serving_step_matches_k1_unsharded():
    """The functional serving step (dense planes, DDSketch and moments,
    packed batch) at 1 data x 4 series shards is bit-identical to K1's
    single launch over the same planes; at 2 x 2 the counts are exact
    and the sums and moments within rtol 1e-5."""
    from tempo_tpu_torch.ops import moments as tmom
    from tempo_tpu_torch.ops import sketches as tsk
    from tempo_tpu_torch.parallel import make_mesh, sharded_serving_step

    edges = (0.002, 0.032, 0.512, 8.192)
    gamma, nb = tsk.dd_params(0.01, 1e-9, 1e6)
    k, lo, hi = tmom.moments_params(12, 1e-9, 1e6)
    cap, n = 256, 512
    rng = np.random.default_rng(3)
    mat = np.stack([rng.integers(-1, cap, n).astype(np.float32),
                    rng.lognormal(-3, 1.0, n).astype(np.float32),
                    rng.integers(100, 1000, n).astype(np.float32),
                    np.ones(n, np.float32)])
    widths = (None, len(edges) + 1, None, None, None, nb, None, k + 3)
    pr = 64

    def planes():
        return [op.dense_zeros(cap, w, page_rows=pr, device="cpu")
                for w in widths]

    kw = dict(edges=edges, gamma=gamma, min_value=1e-9, dd_rows=cap,
              mom_rows=cap, mom_meta=(k, lo, hi))
    ref = planes()
    roles = [ref[i] for i in (0, 2, 3, 4, 1, 6, 5, 7)]
    op.fused_step(tuple(op.arena_of(v, pr) for v in roles),
                  op.identity_tables([cap] * 8, pr, "cpu"),
                  torch.from_numpy(mat), page_shift=6, **kw)
    for ds, ss, exact in ((1, 4, True), (2, 2, False)):
        step = sharded_serving_step(
            make_mesh(ds * ss, series_shards=ss, devices=[CPU] * 8),
            edges, gamma, 1e-9, cap, cap, packed=True, mom_rows=cap,
            mom_meta=(k, lo, hi))
        out = step(*planes(), mat)
        for r, (a, b) in enumerate(zip(out, ref)):
            if exact or r not in (2, 4, 7):
                assert torch.equal(a, b), (ds, ss, r)
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _product_block(n=2000):
    rng = np.random.default_rng(17)
    T0 = 1_700_000_000
    traces = []
    for i in range(n):
        tid = rng.bytes(16)
        start = int((T0 + i * 0.25) * 1e9)
        traces.append((tid, [{
            "trace_id": tid, "span_id": rng.bytes(8),
            "name": f"op-{i % 7}", "service": f"svc-{i % 4}",
            "kind": int(i % 6), "status_code": int(i % 3),
            "start_unix_nano": start,
            "end_unix_nano": start + int(rng.lognormal(16, 1.2)),
            "attrs": ({"http.status_code": 200 + (i % 300),
                       "ratio": [0.5, 1.5, -2.25][i % 3]}
                      if i % 4 else
                      {"http.status_code": 200 + (i % 300)}),
        }]))
    return traces, T0


def test_sharded_plane_query_range_product_parity():
    """`TempoDB` with `plane_mesh` over 8 logical shards: the span columns
    split over 'data', each shard's grid on its chunk, reduced in shard
    order. Series match the single-device plane (rtol 1e-6) and the
    host engine, search matches; no query falls back. (The reference's
    test writes 10,000 spans; 2,000 here keep it inside the guard.)"""
    from tempo_tpu_torch.backend.mem import MemBackend
    from tempo_tpu_torch.db.tempodb import TempoDB, TempoDBConfig
    from tempo_tpu_torch.parallel import make_mesh
    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

    traces, T0 = _product_block()
    be = MemBackend()
    m = make_mesh(8, series_shards=1, devices=[CPU] * 8)
    dev1 = TempoDB(be, be, TempoDBConfig(device_plane=True), device="cpu")
    devm = TempoDB(be, be, TempoDBConfig(device_plane=True, plane_mesh=m),
                   device="cpu")
    host = TempoDB(be, be, TempoDBConfig(device_plane=False), device="cpu")
    dev1.write_block("t", traces, replication_factor=1)
    for db in (dev1, devm, host):
        db.poll_now()

    def smap(series):
        return {tuple(sorted((str(k), str(v)) for k, v in s.labels)):
                np.nan_to_num(np.asarray(s.samples, np.float64))
                for s in series}

    for q in ('{ } | rate() by (resource.service.name)',
              '{ duration > 50ms } | rate() by (name)',
              '{ } | quantile_over_time(duration, .99)'
              ' by (resource.service.name)',
              '{ } | min_over_time(duration) by (name)',
              '{ } | avg_over_time(duration) by (resource.service.name)',
              '{ span.ratio > 0.5 } | count_over_time() by (name)'):
        req = QueryRangeRequest(query=q, start_ns=int(T0 * 1e9),
                                end_ns=int((T0 + 600) * 1e9),
                                step_ns=int(60e9))
        am = smap(devm.query_range("t", req))
        a1 = smap(dev1.query_range("t", req))
        b = smap(host.query_range("t", req))
        assert set(am) == set(b) == set(a1), q
        for k in b:
            np.testing.assert_allclose(am[k], b[k], rtol=1e-5, atol=1e-4,
                                       err_msg=f"mesh-vs-host {q} {k}")
            np.testing.assert_allclose(am[k], a1[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"mesh-vs-1dev {q} {k}")
    assert devm.plane_stats["fused_metric_blocks"] >= 6
    assert not any(k.startswith("fallback_") for k in devm.plane_stats)
    q = '{ duration > 50ms && span.http.status_code >= 400 }'
    s_m = sorted(x.trace_id for x in devm.search("t", q, limit=5000))
    s_h = sorted(x.trace_id for x in host.search("t", q, limit=5000))
    assert s_m == s_h and s_m
    for db in (dev1, devm, host):
        db.shutdown()


def test_sharded_registry_product_push_collect_parity(monkeypatch):
    """`product.sharded_push_batch` (4 data x 2 series shards) collects
    the reference's single-device samples: counts exact, sums within
    rtol 1e-5; quantiles within rtol 1e-5."""
    from tempo_tpu_torch.parallel import make_mesh
    from tempo_tpu_torch.parallel.product import (shard_processor_state,
                                                  sharded_push_batch)

    m = make_mesh(8, series_shards=2, devices=[CPU] * 8)
    reg_m, proc_m = mk_proc(True)
    shard_processor_state(proc_m, m)
    k1 = count_k1(monkeypatch)
    for seed in (1, 2):
        sharded_push_batch(proc_m, m, batch(reg_m, seed))
    assert len(k1) == 2 * 8
    jreg, jproc = run(False, seeds=(1, 2))
    assert_collect_close(collect(reg_m), collect(jreg), rtol=1e-5)
    qm, qj = proc_m.quantile(0.99), jproc.quantile(0.99)
    assert qm.keys() == qj.keys() and qm
    for k in qm:
        np.testing.assert_allclose(qm[k], qj[k], rtol=1e-5)


# -- the mesh cases of tests/test_pages.py and tests/test_moments.py ----------

def _run_paged(shards: "int | None", compact=False, sketch="dd"):
    """Two pushes, a purge that evicts and reuses pages, two more, on a
    page pool (a mesh of `shards` series shards, None: dense)."""
    clock = [1000.0]
    sm = mesh(shards) if shards else None
    with serving.use(sm):
        pool = tpages.PagePool(tpages.PagePoolConfig(
            enabled=True, page_rows=64, arena_slots=4096), device="cpu") \
            if shards else None
        with tpages.use(pool):
            reg, proc = mk_proc(True, clock=clock, sketch_max_series=256,
                                use_scheduler=False, sketch=sketch,
                                compact_state=compact)
        if pool is not None:
            assert pool.mesh is sm and proc._paged
            assert pool.status()["series_shards"] == shards
        for seed in (1, 2):
            proc.push_batch(batch(reg, seed))
        clock[0] += 1000
        reg.purge_stale()
        for seed in (3, 4):
            proc.push_batch(batch(reg, seed))
        return collect(reg), proc.quantile(0.9)


@pytest.mark.parametrize("compact", [False, True])
def test_paged_collect_bit_identical_across_series_shards(compact):
    """Arenas split page-aligned over 'series'; each shard's K1 writes
    the pages it owns: collect() and the quantiles are bit-identical at
    1, 2 and 4 shards, and (f32) equal the dense single-device answer."""
    outs = {s: _run_paged(s, compact) for s in (1, 2, 4)}
    assert outs[1][0] and outs[1] == outs[2] == outs[4]
    if not compact:
        assert outs[1] == _run_paged(None)


def test_pool_on_data_parallel_mesh_stays_single_device(caplog):
    with serving.use(mesh(4, series=2)):
        pool = tpages.PagePool(tpages.PagePoolConfig(
            enabled=True, page_rows=16, arena_slots=512), device="cpu")
    assert pool.mesh is None
    assert "data_shards=2" in caplog.text


def _moments_world(port: bool, sm=None, pool=False):
    with serving.use(sm):
        p = tpages.PagePool(tpages.PagePoolConfig(
            enabled=True, page_rows=16, arena_slots=512), device="cpu") \
            if pool else None
        with tpages.use(p):
            reg, proc = mk_proc(port, max_series=64, use_scheduler=False,
                                sketch="moments", sketch_max_series=32)
        rng = np.random.default_rng(11)
        for name in ("a", "b"):
            if port:
                from tempo_tpu_torch.model.span_batch import SpanBatchBuilder
            else:
                from tempo_tpu.model.span_batch import SpanBatchBuilder
            b = SpanBatchBuilder(reg.interner)
            for d in rng.lognormal(-2, 0.5, 64):
                b.append(trace_id=bytes(16), span_id=bytes(8), name=name,
                         service="svc", kind=2, status_code=0,
                         start_unix_nano=10**18,
                         end_unix_nano=10**18 + int(d * 1e9))
            proc.push_batch(b.build())
        return proc.quantile(0.9), collect(reg), proc


def test_mesh_serving_step_with_moments_matches_single_device():
    """The moments plane under the mesh: bit-identical at 1 and 2 series
    shards and to the unsharded port; the reference's single-device
    quantiles within rtol 1e-3 (`ROADMAP` section 3, moments rows)."""
    results = {}
    for shards in (1, 2):
        q, c, proc = _moments_world(True, mesh(shards))
        assert proc._mesh is not None
        results[shards] = (q, c)
    q, c, _ = _moments_world(True)
    assert results[1] == results[2] == (q, c)
    jq, jc, _ = _moments_world(False)
    assert_collect_close(c, jc)
    assert q.keys() == jq.keys()
    for k in q:
        np.testing.assert_allclose(q[k], jq[k], rtol=1e-3)


def test_paged_mesh_step_with_moments_matches_dense():
    """Paged arenas over 2 series shards with a moments arena answer as
    the dense single-device port does, exactly."""
    mq, mc, proc = _moments_world(True, mesh(2), pool=True)
    assert proc._paged and proc._pool.mesh is not None
    dq, dc, _ = _moments_world(True)
    assert (mq, mc) == (dq, dc)
