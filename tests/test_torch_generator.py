"""The port's multi-tenant `Generator` against the reference's, on the
same numpy-seeded payloads and a pinned clock (the port on the CPU, K1's
plain version).

Held equal to the reference: the instance config each tenant's overrides
produce (processors, series budget, collection interval and switch,
ingestion slack, sketch tier, moments count, kernel tier), what
`needs_attr_columns` / `staging_profile` ask the distributor to stage,
`push_id` dedupe, every route's state by label strings (`push_otlp`,
`push_otlp_recs`, `push_staged_view`, `push_spans`), `collect_all`'s
samples by label set, `consume_bus` on a static bus (skipping a tenant
with generation disabled, `tests/test_ingest_bus.py:91,111`), and the
obs family names. Also: the push fence against `pop_instance`,
`reattach_instance`, `remove_instance` returning a paged tenant's pages,
`start` / `shutdown`, the ingest WAL's append and replay, native
histograms sent under `send_native_histograms`, and `consume_bus` in the
Kafka consumer group's mode against the mock broker.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from tempo_tpu.generator.generator import Generator as JGen
from tempo_tpu.generator.instance import GeneratorConfig as JGenCfg
from tempo_tpu.generator.processors.spanmetrics import (
    SpanMetricsConfig as JSmCfg)
from tempo_tpu.ingest.bus import Bus as JBus
from tempo_tpu.ingest.encoding import produce_traces as j_produce
from tempo_tpu.model.otlp_batch import stage_otlp as j_stage
from tempo_tpu.overrides import Limits as JLimits
from tempo_tpu.overrides import Overrides as JOv

import tempo_tpu_torch as tt
from tempo_tpu_torch import native as tnative
from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.generator import Generator as TGen
from tempo_tpu_torch.generator import GeneratorConfig as TGenCfg
from tempo_tpu_torch.ingest.bus import Bus as TBus
from tempo_tpu_torch.ingest.encoding import produce_traces as t_produce
from tempo_tpu_torch.ops.hashing import token_for
from tempo_tpu_torch.overrides import Limits as TLimits
from tempo_tpu_torch.overrides import Overrides as TOv
from tempo_tpu_torch.registry import pages as tpages
from tests.test_torch_distributor import (DEFAULT, SM_ONLY, T0, k6_spans,
                                          assert_same_state, payload,
                                          state_by_labels, tenant_patch,
                                          tree_spans)


@pytest.fixture(autouse=True)
def _singletons():
    tsched.reset()
    yield
    tsched.reset()


def gens(patches, defaults=None, sm=None, **kw):
    """(reference Generator, port Generator on the CPU) on the pinned
    clock, each with its own `Overrides` holding `patches`."""
    now = lambda: T0  # noqa: E731
    sm = dict(sketch_max_series=256, **(sm or {}))
    out = []
    for port in (False, True):
        ov = (TOv if port else JOv)(defaults=defaults and defaults(port))
        for tenant, patch in patches.items():
            ov.set_tenant_patch(tenant, patch)
        if port:
            out.append(TGen(TGenCfg(spanmetrics=tt.SpanMetricsConfig(**sm)),
                            overrides=ov, now=now, device="cpu", **kw))
        else:
            out.append(JGen(JGenCfg(spanmetrics=JSmCfg(kernel="xla", **sm)),
                            overrides=ov, now=now, **kw))
    return out


def _cfg_view(inst):
    c = inst.cfg
    return (tuple(c.processors), dataclasses.asdict(c.registry),
            c.ingestion_time_range_slack_s, c.spanmetrics.sketch,
            c.spanmetrics.moments_k, c.spanmetrics.kernel,
            c.spanmetrics.sketch_max_series,
            dataclasses.asdict(c.traceanalytics))


PATCHES = {
    "plain": tenant_patch(SM_ONLY),
    "tuned": tenant_patch(DEFAULT, generator={
        "max_active_series": 512, "collection_interval_s": 5.0,
        "disable_collection": True, "ingestion_time_range_slack_s": 0.0,
        "kernel": "pallas"}),
    "moments": tenant_patch(SM_ONLY, generator={
        "sketch": "both", "sketch_moments_k": 8}),
    "analytics": tenant_patch(SM_ONLY, generator={"ta_trace_idle_s": 3.0}),
    "no-override": {},
}


def test_instance_config_from_overrides_matches_reference():
    jg, tg = gens(PATCHES)
    for tenant in PATCHES:
        assert _cfg_view(tg.instance(tenant)) == \
            _cfg_view(jg.instance(tenant)), tenant
        assert tg.instance(tenant).device == torch.device("cpu")
    assert tuple(tg.instance("no-override").processors) == DEFAULT
    # trace-analytics is asked for: both build it, with the ta_* limits
    # applied, and both hand the instance the materializer's overrides
    # resolver
    for g in (jg, tg):
        g.overrides.set_tenant_patch("ta", tenant_patch(
            ("trace-analytics",), generator={"ta_max_live_traces": 9,
                                             "ta_max_spans_per_trace": 7}))
    assert _cfg_view(tg.instance("ta")) == _cfg_view(jg.instance("ta"))
    assert tg.instance("ta").cfg.traceanalytics.max_live_traces == 9
    assert tuple(tg.instance("ta").processors) == ("trace-analytics",)
    assert tg.instance("ta")._matview_limits() == \
        tg.overrides.for_tenant("ta")


@pytest.mark.parametrize("sm", [{}, {"dimensions": ("http.method",)},
                                {"span_multiplier_key": "m"}])
def test_staging_profile_matches_reference(sm):
    jg, tg = gens({"a": tenant_patch(SM_ONLY), "b": tenant_patch(DEFAULT)},
                  sm=sm)
    for tenant in ("a", "b"):
        _, *jp = jg.staging_profile(tenant)
        it, *tp = tg.staging_profile(tenant)
        assert tp == jp
        assert it is tg.staging_interner(tenant) is \
            tg.instance(tenant).registry.interner
        assert tg.instance(tenant).needs_attr_columns() == \
            jg.instance(tenant).needs_attr_columns()


def test_push_routes_match_reference():
    """`push_otlp` (fast route for span metrics alone, staged SpanBatch
    for the default processors), `push_otlp_recs`, `push_staged_view` and
    `push_spans`, tenant by tenant, against the reference."""
    jg, tg = gens({"sm": tenant_patch(SM_ONLY), "dflt": tenant_patch(DEFAULT)})
    k6 = payload(k6_spans(800, 21, traces=300))
    tree = payload(tree_spans(600, 22))
    counts = []
    for g, stage in ((jg, j_stage), (tg, tt.stage_otlp)):
        got = [g.push_otlp("sm", k6), g.push_otlp("dflt", tree, trusted=True),
               g.push_otlp_recs("sm", k6, tnative.otlp_scan(k6)),
               g.push_otlp_recs("dflt", tree, tnative.otlp_scan(tree))]
        for tenant, data in (("sm", k6), ("dflt", tree)):
            st = stage(data, g.staging_interner(tenant))
            got.append(g.push_staged_view(tenant, st.view(np.arange(0, st.n,
                                                                    2))))
        g.push_spans("dflt", tree_spans(100, 23))
        counts.append(got)
    assert counts[0] == counts[1] == [800, 600, 800, None, 400, 300]
    for tenant in ("sm", "dflt"):
        assert_same_state(jg.instance(tenant), tg.instance(tenant))


def test_push_id_dedupe_matches_reference():
    jg, tg = gens({"t": tenant_patch(SM_ONLY)})
    data = payload(k6_spans(300, 31))
    for g in (jg, tg):
        assert g.push_otlp("t", data, push_id="p1") == 300
        assert g.push_otlp("t", data, push_id="p1") == 300
        assert g.push_otlp("t", data, push_id="p2") == 300
        assert g.instance("t").spans_received == 600
        for i in range(600):
            g.instance("t").note_push(f"x{i}", i)
        assert g.instance("t").seen_push("p1") is None     # evicted FIFO
        assert len(g.instance("t")._push_ids) == 512
    assert_same_state(jg.instance("t"), tg.instance("t"))


def test_collect_all_samples_match_reference():
    jg, tg = gens({"a": tenant_patch(SM_ONLY), "b": tenant_patch(DEFAULT),
                   "off": tenant_patch(SM_ONLY, generator={
                       "disable_collection": True})})
    for g in (jg, tg):
        g.push_otlp("a", payload(k6_spans(500, 41)))
        g.push_otlp("b", payload(tree_spans(400, 42)))
        g.push_otlp("off", payload(k6_spans(100, 43)))
    n = [jg.collect_all(), tg.collect_all()]
    assert n[0] == n[1] > 0
    for tenant in ("a", "b"):
        assert assert_same_state(jg.instance(tenant), tg.instance(tenant))
    # collection disabled: the registry collects nothing
    assert assert_same_state(jg.instance("off"), tg.instance("off")) == 0
    snap = tg.collect_duration.snapshot()
    assert snap["count"] == 2       # the disabled tenant is not collected


def _mktrace(i, n_spans=2):
    tid = bytes([i]) * 16
    return tid, [{"trace_id": tid, "span_id": bytes([i, k]) * 4,
                  "name": f"op-{k}", "service": "svc",
                  "start_unix_nano": int(T0 * 1e9) - 10**9 + k,
                  "end_unix_nano": int(T0 * 1e9) - 10**8 + k,
                  "attrs": {"k": k}} for k in range(n_spans)]


def test_consume_bus_matches_reference_and_skips_disabled():
    """`tests/test_ingest_bus.py:91,111` on both packages: the bus carries
    every trace, a tenant with generation disabled gets no instance but
    its offsets are still committed past."""
    def defaults(port):
        lim = (TLimits if port else JLimits)()
        lim.generator = dataclasses.replace(lim.generator, processors=())
        return lim
    jg, tg = gens({"acme": tenant_patch(SM_ONLY)}, defaults=defaults)
    out = []
    for g, bus_cls, produce in ((jg, JBus, j_produce),
                                (tg, TBus, t_produce)):
        bus = bus_cls(n_partitions=2)
        for tenant in ("acme", "quiet"):
            traces = [_mktrace(i, 1 + i % 3) for i in range(1, 21)]
            mat = np.stack([np.frombuffer(t, np.uint8) for t, _ in traces])
            produce(bus, tenant, traces, token_for(tenant, mat))
        n = g.consume_bus(bus)
        out.append((n, sorted(g.instances), g.instance("acme").spans_received,
                    [bus.lag("metrics-generator", p) for p in range(2)],
                    g.consume_bus(bus, [0, 1])))
    assert out[0] == out[1]
    assert out[1][1] == ["acme"] and out[1][2] == 41 and out[1][4] == 0
    assert_same_state(jg.instance("acme"), tg.instance("acme"))

    # a Kafka bus with partitions=None: the consumer group assigns both
    # partitions, and the generation-fenced commits land as on the
    # static bus (tests/test_ingest_bus.py:589 on both packages)
    from tempo_tpu.ingest.kafka import KafkaBus as JKafka
    from tempo_tpu_torch.ingest.kafka import KafkaBus as TKafka
    from tests.mock_kafka import start_mock_kafka

    jg, tg = gens({"acme": tenant_patch(SM_ONLY)}, defaults=defaults)
    out = []
    for g, kafka_cls, produce in ((jg, JKafka, j_produce),
                                  (tg, TKafka, t_produce)):
        srv, port, _broker = start_mock_kafka(n_partitions=2)
        bus = kafka_cls(f"127.0.0.1:{port}", n_partitions=2, timeout_s=5.0)
        try:
            traces = [_mktrace(i, 1 + i % 3) for i in range(1, 9)]
            mat = np.stack([np.frombuffer(t, np.uint8) for t, _ in traces])
            produce(bus, "acme", traces, token_for("acme", mat))
            out.append((g.consume_bus(bus),
                        g._cgroups["metrics-generator"].assignment,
                        [bus.lag("metrics-generator", p) for p in range(2)],
                        g.consume_bus(bus)))
        finally:
            bus.close()
            srv.shutdown()
    assert out[0] == out[1]
    assert out[1][1] == [0, 1] and out[1][2] == [0, 0] and out[1][3] == 0
    assert_same_state(jg.instance("acme"), tg.instance("acme"))


def test_push_fence_pop_reattach_remove_and_pages():
    pool = tpages.PagePool(tpages.PagePoolConfig(
        enabled=True, page_rows=64, arena_slots=2048), device="cpu")
    with tpages.use(pool):
        _, tg = gens({"t": tenant_patch(SM_ONLY)})
        data = payload(k6_spans(300, 51))
        tg.push_otlp("t", data)
        old = tg.instance("t")
        assert old.state_layout == "paged"
        backed = sum(int((p.page_map >= 0).sum()) for p in pool.planes
                     if p.tenant == "t")
        assert backed > 0
        # a push that resolved the instance before the pop re-resolves
        assert old.try_track()
        popped = tg.pop_instance("t")
        assert popped is old and old.detached and not old.try_track()
        assert not old.wait_pushes_idle(0.01)
        old.untrack()
        assert old.wait_pushes_idle(0.01)
        assert tg.peek_instance("t") is None and tg.tenants() == []
        tg.push_otlp("t", data)         # a fresh instance
        assert tg.peek_instance("t") is not old
        assert tg.reattach_instance("t", old) is False
        fresh = tg.remove_instance("t")
        assert tg.reattach_instance("t", old) is True and not old.detached
        assert old.spans_received == 300 and fresh.spans_received == 300
        tg.remove_instance("t")
        assert all((p.page_map < 0).all() for p in pool.planes
                   if p.tenant == "t")
        assert tg.collect_all() == 0


PUSHES_PER_THREAD = 40


def test_tracked_push_waits_out_a_concurrent_pop():
    """Pushes from 4 threads while the tenant is popped and reattached in
    a loop: every acked span lands in the instance that ends up in the
    map, or in one popped while it was not in flight. Each thread makes a
    fixed number of pushes, so the work does not grow with the time a
    loaded machine gives the loop."""
    _, tg = gens({"t": tenant_patch(SM_ONLY)})
    data = payload(k6_spans(64, 61))
    tg.push_otlp("t", data)
    stop = threading.Event()
    acked = []
    errors = []

    def pusher():
        try:
            for _ in range(PUSHES_PER_THREAD):
                if stop.is_set():
                    break
                acked.append(tg.push_otlp("t", data))
        except BaseException as e:      # noqa: BLE001 — asserted below
            errors.append(e)

    popped = []
    threads = [threading.Thread(target=pusher) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        for _ in range(20):
            inst = tg.pop_instance("t")
            if inst is not None:
                assert inst.wait_pushes_idle(5.0)
                if not tg.reattach_instance("t", inst):
                    popped.append(inst)
            time.sleep(0.002)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
    assert not any(th.is_alive() for th in threads) and not errors
    live = tg.peek_instance("t")
    total = sum(i.spans_received for i in popped + [live])
    assert total == 64 * (len(acked) + 1)


def test_start_and_shutdown_collect():
    _, tg = gens({"t": tenant_patch(SM_ONLY)})
    tg.base_cfg.registry.collection_interval_s = 0.01
    tg.push_otlp("t", payload(k6_spans(200, 71)))
    tg.start()
    deadline = time.monotonic() + 5.0
    while tg.collect_duration.snapshot() is None or \
            tg.collect_duration.snapshot()["count"] < 2:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    tg.shutdown()
    assert not any(t.is_alive() for t in tg._threads)
    n = tg.collect_duration.snapshot()["count"]
    time.sleep(0.05)
    assert tg.collect_duration.snapshot()["count"] == n


def test_unported_surfaces_raise_naming_their_item(tmp_path):
    """The ingest WAL and the fleet names came with item 12 and work: a
    WAL generator appends each push and replays it into a second one; the
    Kafka consumer group came with item 14 and sits in `ingest.kafka`, as
    in the reference (the package exports the same names)."""
    from tempo_tpu_torch.generator.wal import GeneratorWal, IngestWalConfig

    def walgen():
        # the WAL stamps records on the generator's pinned clock, which
        # replay's slack filter reads
        return TGen(TGenCfg(), overrides=TOv(), now=lambda: T0,
                    device="cpu", wal=GeneratorWal(IngestWalConfig(
                        enabled=True, dir=str(tmp_path / "wal")),
                        now=lambda: T0))

    g1 = walgen()
    g1.overrides.set_tenant_patch("t", tenant_patch(SM_ONLY))
    assert g1.push_otlp("t", payload(k6_spans(40, 7))) == 40
    g2 = walgen()
    g2.overrides.set_tenant_patch("t", tenant_patch(SM_ONLY))
    assert g2.replay_wal_all() == {"tenants": 1, "batches": 1,
                                   "dead_letters": 0}
    assert state_by_labels(g2.instance("t"), True) == \
        state_by_labels(g1.instance("t"), True)
    assert g2.replay_wal("t", past_seq=0) == {"batches": 0,
                                             "dead_letters": 0}
    g2.truncate_wal("t", 0)
    assert g2.wal._tw("t").segments() == []
    _, tg = gens({"t": tenant_patch(SM_ONLY)})
    assert tg.replay_wal_all() == {"tenants": 0, "batches": 0,
                                   "dead_letters": 0}
    # a tenant with no instance answers the empty summary, as in the
    # reference (tests/test_torch_querier.py holds it against it)
    assert tg.get_metrics("nobody", "{}", ()).results() == []
    assert tg.query_range("nobody", None) == []
    tg.instance("t")
    with pytest.raises(RuntimeError, match="local-blocks"):
        tg.query_range("t", None)
    with pytest.raises(RuntimeError, match="local-blocks"):
        tg.get_metrics("t", "{}", ())
    tg.instance("t").tick(immediate=True)           # no processor cuts
    from tempo_tpu_torch import fleet, ingest
    from tempo_tpu_torch.fleet.controller import FleetController
    assert fleet.FleetController is FleetController
    import tempo_tpu.ingest as jingest
    from tempo_tpu_torch.ingest import kafka as tkafka
    assert sorted(ingest.__all__) == sorted(jingest.__all__)
    assert not hasattr(ingest, "ConsumerGroup")
    assert sorted(tkafka.__all__) == sorted(
        __import__("tempo_tpu.ingest.kafka", fromlist=["x"]).__all__)
    assert isinstance(tkafka.ConsumerGroup, type)


def test_send_native_histograms_raises_naming_item_6():
    """`remote_write.send_native_histograms` (ROADMAP section 2, item 6,
    ported): the collection sends `registry.native_histograms()` beside
    the samples, as the reference's does; the payload equals the
    reference's native histograms series for series."""
    from tempo_tpu.generator.instance import GeneratorInstance as JInst
    from tempo_tpu.generator.remote_write import (
        RemoteWriteConfig as JRwCfg)

    from tempo_tpu_torch.generator import GeneratorConfig, GeneratorInstance
    from tempo_tpu_torch.generator.remote_write import RemoteWriteConfig

    got = {}
    rng = np.random.default_rng(5)
    vals = np.concatenate([[0.0, 2.0 ** -32, 1.0, 2.0 ** 30],
                           rng.lognormal(-3, 2, 60)]).astype(np.float32)
    for port in (True, False):
        if port:
            inst = GeneratorInstance("t", GeneratorConfig(
                processors=("span-metrics",),
                remote_write=RemoteWriteConfig(send_native_histograms=True)),
                now=lambda: T0, device="cpu")
        else:
            inst = JInst("t", JGenCfg(processors=("span-metrics",),
                                      remote_write=JRwCfg(
                                          send_native_histograms=True)),
                         now=lambda: T0)
        sent = []
        inst.remote_write.send = lambda s, n=(): sent.append(list(n)) or True
        nh = inst.registry.new_native_histogram("nh", ("svc",))
        rows = np.array([[inst.registry.interner.intern(f"s{i % 3}")]
                         for i in range(len(vals))], np.int32)
        nh.observe_batch(rows, vals)
        assert inst.collect_and_push(ts_ms=7) > 0
        got[port] = {tuple(lab): (np.asarray(h), s, c, z, ts, off)
                     for lab, h, s, c, z, ts, off in sent[0]}
    assert got[True].keys() == got[False].keys() and len(got[True]) == 3
    for lab, (h, s, c, z, ts, off) in got[False].items():
        ph, ps, pc, pz, pts, poff = got[True][lab]
        assert np.array_equal(ph, h) and (pc, pz, pts, poff) == (c, z, ts, off)
        assert ps == pytest.approx(s, rel=1e-6)
    off = GeneratorInstance("t", GeneratorConfig(
        processors=("span-metrics",)), device="cpu")
    assert off.collect_and_push() == 0


def test_generator_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGen()
    g = TGen(device="cpu")
    assert g.device == torch.device("cpu")


def test_obs_families_match_reference():
    jg, tg = gens({"t": tenant_patch(SM_ONLY)})
    for g in (jg, tg):
        g.push_otlp("t", payload(k6_spans(50, 81)))
        g.collect_all()

    def families(g):
        return {ln.split()[2] for ln in g.obs.render().splitlines()
                if ln.startswith("# TYPE")}
    assert families(tg) == families(jg)
    text = tg.obs.render()
    assert 'tempo_metrics_generator_spans_received_total{tenant="t"} 50' \
        in text
    assert 'tempo_registry_state_bytes{tenant="t",layout="dense"}' in text
    samples, _ = state_by_labels(tg.instance("t"), True)
    assert samples
