"""The port's service-graphs processor and its registry writes against the
JAX reference.

The same spans go through both packages' `ServiceGraphsProcessor` (edge
matching on the host, edge metrics through `Counter.add_slots` /
`Histogram.observe_slots`), on dense state and on paged state, and the
collected samples are compared by label set: counts (`_total`,
`_count`, `_bucket`) exact, `_sum` samples at rtol 1e-5. Seeded trace
trees (`chip_smoke.trace_tree_spans`) also go through whole default
generator instances of both packages (span metrics and service graphs),
on the direct route and on the scheduler route. The reference keeps its
series tables on its numpy path (see tests/test_torch_spanmetrics.py).

The registry writes (`registry/metrics.py`) are held against the
reference's on negative, out-of-range, duplicate and hot slots, and a
`TorchDispatchMode` records that the slot writes make no boolean
selection, no `nonzero` and no host sync.
"""

from __future__ import annotations

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tempo_tpu import sched as jsched
from tempo_tpu.generator.instance import (GeneratorConfig as JGenCfg,
                                          GeneratorInstance as JGen)
from tempo_tpu.generator.processors.servicegraphs import (
    ServiceGraphsConfig as JSgCfg, ServiceGraphsProcessor as JSg)
from tempo_tpu.generator.processors.spanmetrics import SpanMetricsConfig as JSmCfg
from tempo_tpu.model.span_batch import SpanBatchBuilder as JBuilder
from tempo_tpu.registry import metrics as jm
from tempo_tpu.registry import pages as jpages
from tempo_tpu.registry.registry import (ManagedRegistry as JReg,
                                         RegistryOverrides as JOv)
from tempo_tpu.sched import SchedConfig as JSchedCfg

import tempo_tpu_torch as tt
from tempo_tpu_torch.model.otlp import encode_spans_otlp
from tempo_tpu_torch.registry import metrics as tm
from tempo_tpu_torch.registry import pages as tpages
from chip_smoke import trace_tree_spans
from tests.test_torch_spanmetrics import T0, _compare_collect, _push

POOL = dict(enabled=True, page_rows=64, arena_slots=2048)
SERIES = 1024
KIND_SERVER, KIND_CLIENT, KIND_PRODUCER, KIND_CONSUMER = 2, 3, 4, 5
LAYOUTS = ("dense", "paged")


@pytest.fixture(autouse=True)
def _singletons():
    """The port's process scheduler and devtime state reset around each
    test (the reference's scheduler is only ever installed with `use`)."""
    tt.sched.reset()
    yield
    tt.sched.reset()


class Clock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


def _numpy_tables(reg):
    """Hold the reference's series tables on their numpy path."""
    for mt in reg._metrics.values():
        mt.table._nat = None


def _regs(layout, clock):
    """(reference registry, port registry), each with its own pool when
    `layout` is "paged"."""
    pool = POOL if layout == "paged" else None
    with jpages.use(pool and jpages.PagePool(jpages.PagePoolConfig(**pool))):
        jreg = JReg("t", JOv(max_active_series=SERIES), now=clock)
    with tpages.use(pool and tpages.PagePool(tpages.PagePoolConfig(**pool),
                                             device="cpu")):
        treg = tt.ManagedRegistry("t", tt.RegistryOverrides(
            max_active_series=SERIES), now=clock, device="cpu")
    return jreg, treg


def _sg(layout, clock, **cfg):
    jreg, treg = _regs(layout, clock)
    with jpages.use(jreg.pages):
        jp = JSg(jreg, JSgCfg(**cfg))
    with tpages.use(treg.pages):
        tp = tt.ServiceGraphsProcessor(treg, tt.ServiceGraphsConfig(**cfg))
    _numpy_tables(jreg)
    assert (jreg.pages is None) == (treg.pages is None) == (layout == "dense")
    return jp, tp


def _push_sg(jp, tp, spans):
    for proc, builder in ((jp, JBuilder), (tp, tt.SpanBatchBuilder)):
        b = builder(proc.registry.interner)
        for sp in spans:
            b.append(**sp)
        proc.push_batch(b.build())


def _compare(jp, tp, ctx):
    return _compare_collect(types.SimpleNamespace(registry=jp.registry),
                            types.SimpleNamespace(registry=tp.registry), ctx)


def _span(i, service="svc-a", name="op", kind=KIND_SERVER, status=0,
          dur_ns=10**9, attrs=None, parent=b"", trace=None, start=10**9):
    """The reference tests' span fixture (tests/test_generator.py)."""
    return dict(trace_id=(trace if trace is not None else bytes([i]) * 16),
                span_id=bytes([i]) * 8, parent_span_id=parent, name=name,
                service=service, kind=kind, status_code=status,
                start_unix_nano=start, end_unix_nano=start + dur_ns,
                attrs=attrs or {})


def _value(samples, name, **labels):
    for s in samples:
        d = dict(s.labels)
        if s.name == name and not s.is_stale_marker and \
                all(d.get(k) == v for k, v in labels.items()):
            return s.value
    return None


# ---------------------------------------------------------------------------
# the processor against the reference (tests/test_generator.py:122,144)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_edge_completion_matches_reference(layout):
    jp, tp = _sg(layout, Clock())
    t = bytes(16)
    _push_sg(jp, tp, [
        _span(1, service="frontend", kind=KIND_CLIENT, trace=t,
              dur_ns=3 * 10**8),
        _span(2, service="backend", kind=KIND_SERVER, trace=t,
              parent=bytes([1]) * 8, dur_ns=2 * 10**8, status=2)])
    assert _compare(jp, tp, layout) > 0
    samples = tp.registry.collect(1)
    assert _value(samples, "traces_service_graph_request_total",
                  client="frontend", server="backend") == 1.0
    assert _value(samples, "traces_service_graph_request_failed_total",
                  client="frontend", server="backend") == 1.0
    assert _value(samples, "traces_service_graph_request_client_seconds_sum",
                  client="frontend", server="backend") == pytest.approx(0.3)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_expiry_virtual_nodes_match_reference(layout):
    clock = Clock()
    jp, tp = _sg(layout, clock, wait_s=5.0)
    _push_sg(jp, tp, [
        _span(1, service="api", kind=KIND_SERVER, parent=bytes([9]) * 8),
        _span(2, service="web", kind=KIND_CLIENT,
              attrs={"db.system": "mysql"})])
    assert _value(tp.registry.collect(1), "traces_service_graph_request_total",
                  client="user") is None
    clock.t += 10.0
    _push_sg(jp, tp, [])                      # the tick that expires them
    assert tp.expired == jp.expired == 2
    _compare(jp, tp, layout)
    samples = tp.registry.collect(2)
    assert _value(samples, "traces_service_graph_request_total",
                  client="user", server="api") == 1.0
    assert _value(samples, "traces_service_graph_request_total",
                  client="web", server="mysql") == 1.0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_messaging_histogram_and_prefix_flag_match_reference(layout):
    """PRODUCER/CONSUMER pairs feed the messaging-system latency histogram
    (the consumer's start after the producer's); the reference keeps
    `enable_client_server_prefix` as a config field that changes no
    series, and so does the port."""
    jp, tp = _sg(layout, Clock(), enable_messaging_system_latency_histogram=True,
                 enable_client_server_prefix=True)
    spans = []
    for i in range(1, 40):
        t = bytes([i]) * 16
        spans += [
            _span(i, service=f"p{i % 3}", kind=KIND_PRODUCER, trace=t,
                  dur_ns=10**7 * i, start=10**9),
            _span(100 + i, service=f"c{i % 4}", kind=KIND_CONSUMER, trace=t,
                  parent=bytes([i]) * 8, dur_ns=10**6 * i,
                  start=10**9 + 10**6 * i, status=2 if i % 5 == 0 else 0),
            _span(200 - i, service="x", kind=KIND_CLIENT, trace=t,
                  dur_ns=10**8)]
    _push_sg(jp, tp, spans)
    assert tp.messaging_hist is not None
    n = _compare(jp, tp, layout)
    names = {s.name for s in tp.registry.collect(1)}
    assert "traces_service_graph_request_messaging_system_seconds_sum" in names
    assert n > 100


# ---------------------------------------------------------------------------
# whole default instances: span metrics + service graphs
# ---------------------------------------------------------------------------

def _tree_payload(seed, n=300):
    return encode_spans_otlp(trace_tree_spans(
        n, seed=seed, now_ns=int(T0 * 1e9), n_services=6, n_ops=8))


def _instances(layout, clock, scheduled):
    """Default-config generator instances of both packages (span metrics
    and service graphs; the reference's span metrics on its xla tier)."""
    pool = POOL if layout == "paged" else None
    with jpages.use(pool and jpages.PagePool(jpages.PagePoolConfig(**pool))):
        jg = JGen("t", JGenCfg(registry=JOv(max_active_series=SERIES),
                               spanmetrics=JSmCfg(kernel="xla",
                                                  sketch_max_series=256)),
                  now=clock)
    with tpages.use(pool and tpages.PagePool(tpages.PagePoolConfig(**pool),
                                             device="cpu")):
        tg = tt.GeneratorInstance("t", tt.GeneratorConfig(
            registry=tt.RegistryOverrides(max_active_series=SERIES),
            spanmetrics=tt.SpanMetricsConfig(sketch_max_series=256)),
            now=clock, device="cpu")
    _numpy_tables(jg.registry)
    assert tuple(jg.processors) == tuple(tg.processors) == \
        ("span-metrics", "service-graphs")
    assert jg.cfg.spanmetrics.use_scheduler and tg.cfg.spanmetrics.use_scheduler
    return jg, tg


@pytest.mark.parametrize("scheduled", [False, True], ids=["direct", "sched"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_trace_trees_through_default_instances_match(layout, scheduled):
    """Trace trees (client/server pairs, db clients with no server side)
    through default instances of both packages: every span-metrics and
    service-graph series equal, then again after the clock steps past
    `wait_s` and an empty push turns the db clients into virtual-node
    edges. On the scheduler route both packages take the same merged
    windows (two pushes a window, drained by hand)."""
    clock = Clock()
    jg, tg = _instances(layout, clock, scheduled)
    jsc = jsched.DeviceScheduler(JSchedCfg(), start_worker=False)
    tsc = tt.DeviceScheduler(tt.SchedConfig(), start_worker=False)
    with jsched.use(jsc if scheduled else None), \
            tt.sched.use(tsc if scheduled else None):
        for seed in range(4):
            _push(jg, tg, _tree_payload(seed))
            if seed % 2:
                jsc.drain_once(force=True)
                tsc.drain_once(force=True)
        assert tsc.pending() == jsc.pending() == 0
        assert _compare_collect(jg, tg, "pushes") > 500
        assert tsc.batches_total.get("spanmetrics_fused_update", 0) == \
            jsc.batches_total.get("spanmetrics_fused_update", 0) == \
            (2 if scheduled else 0)
        clock.t += 11.0
        _push(jg, tg, encode_spans_otlp([]))
        jg.drain(), tg.drain()
        sg = tg.processors["service-graphs"]
        assert sg.expired == jg.processors["service-graphs"].expired > 0
        _compare_collect(jg, tg, "expired")
    virtual = [s for s in tg.registry.collect(1)
               if s.name == "traces_service_graph_request_total"
               and dict(s.labels)["connection_type"] == "virtual_node"]
    assert virtual and {dict(s.labels)["server"] for s in virtual} <= \
        {"postgresql", "redis", "mysql", "mongodb"}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_service_graph_state_carries_from_reference(layout):
    """The reference's service-graph state seeds the port's: dense
    families through `ManagedRegistry.load_reference_state`, paged ones
    through `registry.pages.load_reference_state`; the port's own
    updates are discarded first, and the collected samples then equal
    the reference's."""
    jp, tp = _sg(layout, Clock())
    spans = trace_tree_spans(400, seed=5, now_ns=int(T0 * 1e9), n_services=6,
                             n_ops=8)
    _push_sg(jp, tp, spans)
    fams = (jp.total, jp.failed, jp.client_hist, jp.server_hist)
    if layout == "dense":
        for fam in (tp.total, tp.failed, tp.client_hist, tp.server_hist):
            for f in dataclasses.fields(fam.state):
                t = getattr(fam.state, f.name)
                if isinstance(t, torch.Tensor):
                    t.zero_()
        tp.registry.load_reference_state({
            fam.name: {f.name: np.asarray(getattr(fam.state, f.name))
                       for f in dataclasses.fields(fam.state)
                       if f.name != "edges"} for fam in fams})
        with pytest.raises(ValueError, match="reference .* vs"):
            tp.registry.load_reference_state({jp.total.name: {
                "values": np.zeros(3, np.float32)}})
    else:
        jpool, tpool = jp.registry.pages, tp.registry.pages
        for a in tpool.arenas.values():
            a.data.zero_()
        arenas = {k: np.asarray(a.data) for k, a in jpool.arenas.items()}
        planes = [p for fam in fams for p in fam.planes.values()]
        maps = {(p.tenant, p._arena.role): p.page_map for p in planes}
        tpages.load_reference_state(tpool, arenas, maps)
    assert _compare(jp, tp, layout) > 100


# ---------------------------------------------------------------------------
# the registry writes (registry/metrics.py) against the reference's
# ---------------------------------------------------------------------------

CAP = 64
EDGES = (0.002, 0.016, 0.128, 1.024)


def _slots(case, rng, n=4096):
    if case == "negative":          # discards and out-of-range slots
        return rng.choice(np.array([-1, -7, CAP, CAP + 5, 0, 3, CAP - 1]), n)
    if case == "duplicate":         # every slot many times
        return rng.integers(0, 8, n)
    return np.where(rng.random(n) < 0.9, 5,              # "hot"
                    rng.integers(-1, CAP, n))


@pytest.mark.parametrize("case", ["negative", "duplicate", "hot"])
def test_registry_writes_match_reference(case):
    """`counter_update`, `histogram_update` (with and without a mask) and
    `gauge_set` give the reference's rows: counts and buckets exact under
    integer weights, sums at rtol 1e-5."""
    rng = np.random.default_rng(len(case))
    slots = _slots(case, rng).astype(np.int32)
    w = rng.integers(1, 4, slots.size).astype(np.float32)
    v = rng.lognormal(-3, 2, slots.size).astype(np.float32)
    mask = rng.random(slots.size) < 0.8
    jc = jm.counter_update(jm.counter_init(CAP), jnp.asarray(slots),
                           jnp.asarray(w), None)
    tc = tm.counter_update(tm.counter_init(CAP, device="cpu"), slots, w)
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    for msk in (None, mask):
        jh = jm.histogram_update(jm.histogram_init(CAP, EDGES),
                                 jnp.asarray(slots), jnp.asarray(v),
                                 jnp.asarray(w),
                                 None if msk is None else jnp.asarray(msk))
        th = tm.histogram_update(tm.histogram_init(CAP, EDGES, device="cpu"),
                                 slots, v, w, msk)
        np.testing.assert_array_equal(th.bucket_counts.numpy(),
                                      np.asarray(jh.bucket_counts))
        np.testing.assert_array_equal(th.counts.numpy(), np.asarray(jh.counts))
        np.testing.assert_allclose(th.sums.numpy(), np.asarray(jh.sums),
                                   rtol=1e-5)
    # gauges: one row per slot (the host's last-wins staging), -1 padding
    gs = np.unique(slots[(slots >= 0) & (slots < CAP)])
    gs = np.concatenate([gs, [-1, -1, CAP]]).astype(np.int32)
    gv = rng.normal(size=gs.size).astype(np.float32)
    jgs = jm.gauge_set(jm.gauge_init(CAP), jnp.asarray(gs), jnp.asarray(gv),
                       None)
    tgs = tm.gauge_set(tm.gauge_init(CAP, device="cpu"), gs, gv)
    np.testing.assert_array_equal(tgs.values.numpy(), np.asarray(jgs.values))
    arena = tgs.values._base
    assert not arena[:arena.shape[0] - CAP].any()    # the trash page


class _Ops(TorchDispatchMode):
    """Records the aten ops a block dispatches and flags boolean indexing."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.bool_index = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.ops.append(name)
        if "index" in name:
            idx = args[1] if len(args) > 1 else ()
            for t in (idx if isinstance(idx, (list, tuple)) else (idx,)):
                if isinstance(t, torch.Tensor) and t.dtype == torch.bool:
                    self.bool_index.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_slot_writes_make_no_boolean_selection(layout):
    """`add_slots` / `observe_slots` (and a gauge set) on dense and paged
    families: no `nonzero`, no `masked_select`, no boolean index, no
    host read (`_local_scalar_dense`), and at least one `index_add_`."""
    _, treg = _regs(layout, Clock())
    c = treg.new_counter("c", ("a",))
    h = treg.new_histogram("h", ("a",), edges=EDGES)
    g = treg.new_gauge("g", ("a",))
    keys = treg.interner.intern_many([f"k{i}" for i in range(7)])
    rows = keys[np.arange(40) % 7][:, None].astype(np.int32)
    slots = c.resolve_slots(rows)
    h.share_table(c)
    slots = np.concatenate([slots, [-1, -1, CAP * 99]]).astype(np.int32)
    vals = np.linspace(0.001, 2.0, slots.size).astype(np.float32)
    g.set_batch(rows[:3], np.ones(3, np.float32))      # back its pages
    with _Ops() as mode:
        c.add_slots(slots)
        c.add_slots(slots, np.full(slots.size, 2.0, np.float32))
        h.observe_slots(slots, vals)
        g._device_set(np.array([0, -1, -1, -1], np.int32),
                      np.ones(4, np.float32))
    bad = {"nonzero", "masked_select", "_local_scalar_dense", "item"}
    assert not bad & set(mode.ops), sorted(bad & set(mode.ops))
    assert not mode.bool_index, mode.bool_index
    assert "aten.index_add_" in mode.ops or "aten.index_add" in mode.ops, \
        sorted(set(mode.ops))
    got = {s.labels: s.value for s in treg.collect(1) if s.name == "c"}
    assert sorted(got.values()) == [15.0] * 2 + [18.0] * 5   # 40 rows, 7 keys


# ---------------------------------------------------------------------------
# defaults
# ---------------------------------------------------------------------------

def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
    return out


def test_default_configs_match_reference():
    """The generator's processors, and every default of SpanMetricsConfig,
    SchedConfig and ServiceGraphsConfig that both packages have, equal the
    reference's; span metrics ride the scheduler by default."""
    assert tt.GeneratorConfig().processors == JGenCfg().processors == \
        ("span-metrics", "service-graphs")
    assert tt.SpanMetricsConfig().use_scheduler is True
    for port, ref in ((tt.SpanMetricsConfig, JSmCfg),
                      (tt.SchedConfig, JSchedCfg),
                      (tt.ServiceGraphsConfig, JSgCfg)):
        pd, rd = _defaults(port), _defaults(ref)
        common = pd.keys() & rd.keys()
        assert common, port
        for k in sorted(common):
            if k == "filter_policies":
                assert pd[k] == rd[k] == ()
                continue
            assert pd[k] == rd[k], f"{port.__name__}.{k}: {pd[k]} vs {rd[k]}"
    # the port lacks only the reference's tier knobs (ROADMAP section 3)
    assert _defaults(JSmCfg).keys() - _defaults(tt.SpanMetricsConfig).keys() \
        == {"kernel", "pallas_interpret"}
    assert _defaults(JSchedCfg).keys() == _defaults(tt.SchedConfig).keys()
    assert _defaults(JSgCfg).keys() == _defaults(tt.ServiceGraphsConfig).keys()
