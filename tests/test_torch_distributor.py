"""The port's distributor against the reference's, each feeding its own
package's multi-tenant `Generator` (the port's on the CPU, K1's plain
version), on the same numpy-seeded OTLP payloads and a pinned clock.

Rigs: 3 staged-capable stub ingesters at the default `rf=3` and a
generator ring of 1 or 2 `Generator`s, as the reference's own tests rig
them (`tests/test_ingest_pipeline.py:53-70`); and a rig of 3 real
`Ingester`s of each package (the port's against the reference's, on the
same payloads through both tees: every ingester's `find_trace_by_id`
equal after the push and after `flush_all`). Routes and what each test
exercises:

- the decode-once staged tee (one generator, so one interner: every
  target reads row views of one `stage_otlp`), span metrics alone (the
  fast route) and the default processors (the staged SpanBatch);
- the columnar tee (two generators, two interners: `_staging_plan`
  declines), span metrics alone taking `push_otlp_recs` and the default
  processors taking payload slices;
- the dict route (`push_spans`, attribute truncation, forwarders, the
  generator tee re-encoded to OTLP) and the ingest bus
  (`produce_traces` → `Generator.consume_bus`);
- `generator_placement="tenant"`.

Held equal to the reference: the discard reasons and counts, the
distributor's counters, what each stub ingester received (staged row
indices, or payload bytes), what each generator id received, and the
generator state by label strings (counts, buckets and DDSketch rows
exact; float sums at rtol 1e-6, the f32 reduction-order tolerance of
ROADMAP's numerics contract). Also: overload sampling (keep masks and
weights equal, calls within 5% of the truth, sampling off identical to a
tenant that opted out), admission before staging (a rejected push does
not intern), and the reference's distributor-bound scheduler tests
(`tests/test_sched.py:375,400`) on the port's scheduler.
"""

from __future__ import annotations

import numpy as np
import pytest

from tempo_tpu import sched as jsched
from tempo_tpu.distributor import Distributor as JDist
from tempo_tpu.distributor.distributor import DistributorConfig as JDistCfg
from tempo_tpu.distributor.limiter import IngestBackpressure as JBackpressure
from tempo_tpu.distributor.sampler import SpanSampler as JSampler
from tempo_tpu.backend.mem import MemBackend as JMem
from tempo_tpu.generator.generator import Generator as JGen
from tempo_tpu.generator.instance import GeneratorConfig as JGenCfg
from tempo_tpu.generator.processors.spanmetrics import (
    SpanMetricsConfig as JSmCfg)
from tempo_tpu.ingest.bus import Bus as JBus
from tempo_tpu.ingester import Ingester as JIng
from tempo_tpu.model.otlp_batch import stage_otlp as j_stage
from tempo_tpu.overrides import Overrides as JOv
from tempo_tpu.overrides.limits import SamplingLimits as JSampling
from tempo_tpu.ring import ring as jring

import tempo_tpu_torch as tt
from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.backend.mem import MemBackend as TMem
from tempo_tpu_torch.distributor import Distributor as TDist
from tempo_tpu_torch.distributor.distributor import (
    REASON_BACKPRESSURE, REASON_INVALID_TRACE_ID, REASON_RATE_LIMITED,
    REASON_SAMPLED, DistributorConfig as TDistCfg, MalformedPayload,
    RateLimited)
from tempo_tpu_torch.distributor.forwarder import Forwarder, ForwarderConfig
from tempo_tpu_torch.distributor.limiter import IngestBackpressure as TBackpressure
from tempo_tpu_torch.distributor.sampler import SpanSampler as TSampler
from tempo_tpu_torch.generator import Generator as TGen
from tempo_tpu_torch.generator import GeneratorConfig as TGenCfg
from tempo_tpu_torch.ingest.bus import Bus as TBus
from tempo_tpu_torch.ingester import Ingester as TIng
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
from tempo_tpu_torch.overrides import Overrides as TOv
from tempo_tpu_torch.overrides.limits import SamplingLimits as TSampling
from tempo_tpu_torch.ring import ring as tring
from tempo_tpu_torch.utils import faults as tfaults
from chip_smoke import trace_tree_spans
from tests.test_torch_staged import _dd_rows

T0 = 1_700_000_000.0
NOW_NS = int(T0 * 1e9)
SERIES = 1024
SM_ONLY = ("span-metrics",)
DEFAULT = ("span-metrics", "service-graphs")
SUM_RTOL = 1e-6
UNLIMITED = {"rate_limit_bytes": 1 << 40, "burst_size_bytes": 1 << 40}


@pytest.fixture(autouse=True)
def _singletons():
    """The port's process scheduler and fault points reset around each
    test (the reference's are reset by tests/conftest.py)."""
    tsched.reset()
    tfaults.reset()
    yield
    tsched.reset()
    tfaults.reset()


# -- payloads ----------------------------------------------------------------


def k6_spans(n, seed, traces=None, bad_ids=0):
    """`n` k6-like span dicts ending within 10 s before the pinned clock,
    `traces` distinct trace ids among them (some short), the first
    `bad_ids` with an empty (invalid) trace id."""
    spans = synthetic_spans(n, seed=seed, now_ns=NOW_NS, n_services=8,
                            n_ops=8)
    rng = np.random.default_rng(seed + 1)
    if traces is not None:
        pool = [rng.bytes(16 if k % 5 else 8) for k in range(traces)]
        for s in spans:
            s["trace_id"] = pool[int(rng.integers(0, traces))]
    for s in spans[:bad_ids]:
        s["trace_id"] = b""
    for i, s in enumerate(spans):
        s["attrs"] = {"http.method": ["GET", "POST"][i % 2],
                      "note": "x" * (i % 40)}
        s["res_attrs"] = {"service.name": s["service"], "zone": "z1"}
    return spans


def tree_spans(n, seed):
    return trace_tree_spans(n, seed=seed, now_ns=NOW_NS, n_services=6,
                            n_ops=6)


def payload(spans):
    return encode_spans_otlp(spans)


# -- rigs ----------------------------------------------------------------------


class StubIngester:
    """Staged-capable stub ingester: records what it received and answers
    with no per-trace errors."""

    staged_needs_attrs = False

    def __init__(self):
        self.got = []

    def push(self, tenant, traces):
        self.got.append(("dicts", tenant, sorted(t for t, _ in traces)))
        return [None] * len(traces)

    def push_otlp(self, tenant, data):
        self.got.append(("otlp", tenant, data))
        return {}

    def push_staged(self, tenant, view):
        self.got.append(("staged", tenant, view.row_indices().tolist()))
        return {}


def _ring(mod, ids, now, rf=1):
    r = mod.Ring(replication_factor=rf, now=now)
    for iid in ids:
        r.register(mod.InstanceDesc(id=iid, state=mod.ACTIVE,
                                    tokens=mod._instance_tokens(iid, 64),
                                    heartbeat_ts=now()))
    return r


def tenant_patch(processors=SM_ONLY, **groups):
    p = {"generator": {"processors": list(processors),
                       "max_active_series": SERIES},
         "ingestion": dict(UNLIMITED)}
    for k, v in groups.items():
        p.setdefault(k, {}).update(v)
    return p


class Side:
    """One package's distributor, stub ingesters and generators."""

    def __init__(self, port, patches, n_gen=1, cfg=None, sm=None,
                 bus=None, ing_dir=None):
        self.port = port
        now = lambda: T0  # noqa: E731
        self.ov = (TOv if port else JOv)()
        for tenant, patch in patches.items():
            self.ov.set_tenant_patch(tenant, patch)
        sm = dict(sketch_max_series=256, **(sm or {}))
        if port:
            gcfg = TGenCfg(spanmetrics=tt.SpanMetricsConfig(**sm))
            self.gens = {f"g{i}": TGen(gcfg, overrides=self.ov,
                                       instance_id=f"g{i}", now=now,
                                       device="cpu") for i in range(n_gen)}
        else:
            gcfg = JGenCfg(spanmetrics=JSmCfg(**{"kernel": "xla", **sm}))
            self.gens = {f"g{i}": JGen(gcfg, overrides=self.ov,
                                       instance_id=f"g{i}", now=now)
                         for i in range(n_gen)}
        mod = tring if port else jring
        if ing_dir is None:
            self.ings = {f"i{i}": StubIngester() for i in range(3)}
        else:       # real ingesters of this package, one data dir each
            self.store = (TMem if port else JMem)()
            self.ings = {f"i{i}": (TIng if port else JIng)(
                str(ing_dir / ("port" if port else "ref") / f"i{i}"),
                flush_writer=self.store, overrides=self.ov, now=now,
                instance_id=f"i{i}") for i in range(3)}
        self.dist = (TDist if port else JDist)(
            _ring(mod, self.ings, now, rf=3), self.ings, overrides=self.ov,
            generator_ring=_ring(mod, self.gens, now),
            generator_clients=self.gens,
            cfg=(TDistCfg if port else JDistCfg)(**(cfg or {})),
            bus=bus, now=now)

    def plan(self, tenant):
        return self.dist._staging_plan(tenant, self.ov.for_tenant(tenant))


def pair(patches, **kw):
    return Side(False, patches, **kw), Side(True, patches, **kw)


def both(js, ts, fn):
    """fn(side) on the reference's side, then the port's; (ref, port)
    results, or the exception type and attributes each raised."""
    out = []
    for side in (js, ts):
        try:
            out.append(fn(side))
        except RuntimeError as e:      # either package's RateLimited
            out.append((type(e).__name__, getattr(e, "reason", None),
                        getattr(e, "retry_after_s", None)))
    return out


# -- state comparison ----------------------------------------------------------


def _drained(inst, port):
    if port:
        inst.drain()
    else:
        jsched.flush()
        for p in inst.processors.values():
            fn = getattr(p, "drain_pipeline", None)
            if fn is not None:
                fn()
    return inst


def state_by_labels(inst, port):
    """{(family, labels): value} of one collection, and the DDSketch rows
    {labels: (counts, zeros)}."""
    _drained(inst, port)
    samples = {(s.name, s.labels): s.value
               for s in inst.registry.collect(1)}
    proc = inst.processors["span-metrics"]
    slots = proc.calls.table.active_slots()
    slots = slots[slots < proc.cfg.sketch_max_series]
    rows = _dd_rows(proc, slots, not port)
    dd = {proc.calls.labels_of(int(s)): (rows[0][i].tolist(),
                                         rows[1][i].tolist())
          for i, s in enumerate(slots)}
    return samples, dd


def assert_same_state(jinst, tinst):
    """The port instance equals the reference's by label strings: counts
    and buckets exact, sums at rtol 1e-6, DDSketch rows exact. Returns the
    number of samples."""
    assert (tinst.spans_received, tinst.spans_filtered_slack) == \
        (jinst.spans_received, jinst.spans_filtered_slack)
    (js, jdd), (ts, tdd) = state_by_labels(jinst, False), \
        state_by_labels(tinst, True)
    assert ts.keys() == js.keys()
    for k, v in ts.items():
        if k[0].endswith("_sum") or k[0] == "traces_spanmetrics_size_total":
            assert abs(v - js[k]) <= SUM_RTOL * abs(js[k]), (k, v, js[k])
        else:
            assert v == js[k], (k, v, js[k])
    assert tdd == jdd
    return len(ts)


def calls_total(inst, port):
    samples, _ = state_by_labels(inst, port)
    return sum(v for (name, _), v in samples.items()
               if name == "traces_spanmetrics_calls_total")


def ingested(side):
    return {iid: ing.got for iid, ing in side.ings.items()}


# -- the decode-once staged tee ------------------------------------------------


@pytest.mark.parametrize("processors", [SM_ONLY, DEFAULT],
                         ids=["fast-route", "default-processors"])
def test_staged_tee_matches_reference(processors):
    js, ts = pair({"t1": tenant_patch(processors)})
    assert ts.plan("t1") is not None and js.plan("t1") is not None
    spans = tree_spans(1500, 3) if processors == DEFAULT else \
        k6_spans(1500, 3, traces=600, bad_ids=7)
    raw = payload(spans)
    for _ in range(2):                  # series new, then known
        errs = both(js, ts, lambda s: s.dist.push_otlp("t1", raw))
        assert errs[0] == errs[1]
    assert ts.dist.discarded == js.dist.discarded
    assert ts.dist.metrics == js.dist.metrics
    assert ingested(ts) == ingested(js)
    n_bad = 0 if processors == DEFAULT else 7
    # every valid span reached exactly rf=3 ingesters, once each push
    rows = [r for ing in ts.ings.values() for kind, _, rs in ing.got
            for r in rs]
    assert len(rows) == 2 * 3 * (len(spans) - n_bad)
    assert ts.dist.metrics["spans_received_total"] == 2 * len(spans)
    assert assert_same_state(js.gens["g0"].instance("t1"),
                             ts.gens["g0"].instance("t1")) > 0


# -- real ingesters ---------------------------------------------------------------


def _found(side, tids):
    return {iid: [_norm(ing.find_trace_by_id("t1", t)) for t in tids]
            for iid, ing in side.ings.items()}


def _norm(spans):
    if spans is None:
        return None
    return sorted(({**s, "trace_id": bytes(s["trace_id"]).ljust(16, b"\0"),
                    "span_id": bytes(s["span_id"]).ljust(8, b"\0"),
                    "parent_span_id": bytes(s.get("parent_span_id") or b"")
                    .ljust(8, b"\0"),
                    "events": s.get("events") or [],
                    "links": s.get("links") or []}
                   for s in spans),
                  key=lambda s: (s["trace_id"], s["span_id"]))


@pytest.mark.parametrize("n_gen", [1, 2], ids=["staged-tee", "columnar-tee"])
@pytest.mark.parametrize("processors", [SM_ONLY, DEFAULT],
                         ids=["span-metrics", "default-processors"])
def test_real_ingesters_match_reference(tmp_path, n_gen, processors):
    """3 real ingesters of each package behind its distributor: the
    staged tee hands them row views (span attrs now staged, since real
    ingesters want them), the columnar tee payload slices; every
    ingester finds every trace the reference's does, equal span for span,
    live and after `flush_all` (a complete block flushed to the store)."""
    js, ts = pair({"t1": tenant_patch(processors)}, n_gen=n_gen,
                  ing_dir=tmp_path)
    assert (ts.plan("t1") is not None) == (n_gen == 1)
    spans = tree_spans(48, 13)
    for s in spans[::3]:
        s["attrs"] = {"http.method": "GET", "retries": 2, "ok": True}
        s["res_attrs"] = {"service.name": s["service"], "zone": "z1"}
    raw = payload(spans)
    errs = both(js, ts, lambda s: s.dist.push_otlp("t1", raw))
    assert errs[0] == errs[1] == {}
    tids = sorted({s["trace_id"] for s in spans})[:20] + [b"\xee" * 16]
    live = _found(ts, tids)
    assert live == _found(js, tids)
    want = {t: [] for t in tids}
    for s in spans:
        if s["trace_id"] in want:
            want[s["trace_id"]].append(s)
    for iid, got in live.items():
        for t, g in zip(tids, got):
            if t == b"\xee" * 16:
                assert g is None
            else:
                assert [x["span_id"][:8] for x in g] == \
                    [x["span_id"] for x in _norm(want[t])]
                assert [x["attrs"] for x in g] == \
                    [x.get("attrs", {}) for x in _norm(want[t])]
    for side in (js, ts):
        for ing in side.ings.values():
            ing.flush_all()
    flushed = _found(ts, tids)
    assert flushed == _found(js, tids) == live
    assert len(ts.store._objects) == len(js.store._objects) > 0
    for ing in ts.ings.values():
        (entry,) = ing.instance("t1").complete.values()
        assert entry.flushed_ts and entry.meta.encoding == "gzip"
        assert not ing.instance("t1").discarded


# -- the columnar tee ----------------------------------------------------------


@pytest.mark.parametrize("processors", [SM_ONLY, DEFAULT],
                         ids=["recs-route", "payload-route"])
def test_columnar_tee_matches_reference(processors):
    js, ts = pair({"t1": tenant_patch(processors)}, n_gen=2)
    assert ts.plan("t1") is None and js.plan("t1") is None
    taken = {"recs": 0, "payload": 0}
    for g in ts.gens.values():
        inner_recs, inner_otlp = g.push_otlp_recs, g.push_otlp

        def recs(tenant, raw, rr, inner=inner_recs):
            got = inner(tenant, raw, rr)
            taken["recs"] += got is not None
            return got

        def otlp(tenant, data, trusted=False, inner=inner_otlp):
            taken["payload"] += 1
            return inner(tenant, data, trusted=trusted)
        g.push_otlp_recs, g.push_otlp = recs, otlp
    spans = tree_spans(1200, 5) if processors == DEFAULT else \
        k6_spans(1200, 5, traces=500, bad_ids=3)
    raw = payload(spans)
    errs = both(js, ts, lambda s: s.dist.push_otlp("t1", raw))
    assert errs[0] == errs[1] == ({} if processors == DEFAULT else
                                  {REASON_INVALID_TRACE_ID: 3})
    assert ingested(ts) == ingested(js)
    assert ts.dist.metrics == js.dist.metrics
    if processors == SM_ONLY:
        assert taken == {"recs": 2, "payload": 0}
    else:
        assert taken == {"recs": 0, "payload": 2}
    got = 0
    for gid in ("g0", "g1"):
        ji, ti = js.gens[gid].instance("t1"), ts.gens[gid].instance("t1")
        assert 0 < ti.spans_received < len(spans)
        got += ti.spans_received
        assert_same_state(ji, ti)
    assert got == len(spans) - (0 if processors == DEFAULT else 3)


# -- the dict route, forwarders and the bus -------------------------------------


def test_dict_route_truncation_and_forwarders_match_reference():
    """`max_attribute_bytes` sends `push_otlp` down the dict route: the
    attributes are truncated before the forwarders and the generator tee
    (re-encoded to OTLP) see them; a span-metrics dimension on a
    truncated attribute shows it."""
    patch = tenant_patch(SM_ONLY, ingestion={"max_attribute_bytes": 12})
    js, ts = pair({"t1": patch}, sm=dict(dimensions=("note",)))
    sinks = []
    for side in (js, ts):
        seen = []
        sinks.append(seen)
        side.dist.forwarders.register("t1", Forwarder(ForwarderConfig(
            name="f", filter={"include": {"http.method": "GET"}}),
            sink=seen.extend) if side.port else _jforwarder(seen))
    spans = k6_spans(600, 8, traces=200, bad_ids=5)
    raw = payload(spans)
    errs = both(js, ts, lambda s: s.dist.push_otlp("t1", raw))
    assert errs[0] == errs[1] == {REASON_INVALID_TRACE_ID: 5}
    dicts = both(js, ts, lambda s: s.dist.push_spans("t1", spans[:100]))
    assert dicts[0] == dicts[1]
    for side in (js, ts):
        side.dist.forwarders.shutdown()
    assert len(sinks[1]) == len(sinks[0]) > 0
    assert all(len(v) <= 12 for s in sinks[1] for v in s["attrs"].values()
               if isinstance(v, str))
    assert ingested(ts) == ingested(js)
    inst = ts.gens["g0"].instance("t1")
    assert assert_same_state(js.gens["g0"].instance("t1"), inst) > 0
    labels = {dict(k[1]).get("note") for k in state_by_labels(inst, True)[0]}
    assert labels == {"x" * k for k in range(13)}


def _jforwarder(seen):
    from tempo_tpu.distributor.forwarder import (Forwarder as JF,
                                                 ForwarderConfig as JFC)
    return JF(JFC(name="f", filter={"include": {"http.method": "GET"}}),
              sink=seen.extend)


def test_bus_route_then_consume_bus_matches_reference():
    patches = {"t1": tenant_patch(SM_ONLY), "quiet": tenant_patch(())}
    buses = (JBus(n_partitions=2), TBus(n_partitions=2))
    js, ts = (Side(port, patches, bus=bus)
              for port, bus in ((False, buses[0]), (True, buses[1])))
    spans = k6_spans(400, 9, traces=150)
    for tenant in ("t1", "quiet"):
        errs = both(js, ts, lambda s: s.dist.push_otlp(tenant, payload(spans)))
        assert errs[0] == errs[1] == {}
    assert ingested(ts) == ingested(js) and not any(ingested(ts).values())
    logs = [[[(r.tenant, r.value) for r in bus.fetch(p, 0, 1000)]
             for p in range(2)] for bus in buses]
    assert logs[0] == logs[1] and sum(map(len, logs[1])) > 2
    n = [side.gens["g0"].consume_bus(bus) for side, bus in
         zip((js, ts), buses)]
    assert n[0] == n[1] == sum(map(len, logs[1]))
    assert "quiet" not in ts.gens["g0"].instances
    assert all(buses[1].lag("metrics-generator", p) == 0 for p in range(2))
    assert ts.gens["g0"].consume_bus(buses[1]) == 0
    assert_same_state(js.gens["g0"].instance("t1"),
                      ts.gens["g0"].instance("t1"))


def test_tenant_placement_routes_like_reference():
    patches = {f"t{i}": tenant_patch(SM_ONLY) for i in range(6)}
    js, ts = pair(patches, n_gen=3, cfg=dict(generator_placement="tenant"))
    raw = payload(k6_spans(200, 4, traces=80))
    for tenant in patches:
        errs = both(js, ts, lambda s: s.dist.push_otlp(tenant, raw))
        assert errs[0] == errs[1] == {}
    for side in (js, ts):
        side.owners = {t: [gid for gid, g in side.gens.items()
                           if g.instance(t).spans_received]
                       for t in patches}
    assert ts.owners == js.owners
    assert all(len(v) == 1 for v in ts.owners.values())
    assert len({v[0] for v in ts.owners.values()}) > 1
    for tenant, (gid,) in ts.owners.items():
        assert ts.gens[gid].instance(tenant).spans_received == 200


# -- admission, discards and malformed input -----------------------------------


def test_rate_limit_and_backpressure_discards_match_reference():
    patch = tenant_patch(SM_ONLY, ingestion={"rate_limit_bytes": 10_000,
                                             "burst_size_bytes": 20_000})
    js, ts = pair({"t1": patch})
    small, big = payload(k6_spans(50, 1)), payload(k6_spans(800, 2))
    assert len(small) < 10_000 < len(big)
    outcomes = [both(js, ts, lambda s, d=d: s.dist.push_otlp("t1", d))
                for d in (small, big, small)]
    for a, b in outcomes:
        assert a == b
    assert outcomes[1][1] == ("RateLimited", REASON_RATE_LIMITED, 1.0)
    js.dist.backpressure = JBackpressure(retry_after_fn=lambda: 2.5)
    ts.dist.backpressure = TBackpressure(retry_after_fn=lambda: 2.5)
    for d in (small, payload([dict(s) for s in k6_spans(30, 3)])):
        a, b = both(js, ts, lambda s: s.dist.push_otlp("t1", d))
        assert a == b == ("RateLimited", REASON_BACKPRESSURE, 2.5)
    # the dict route admits the same way
    a, b = both(js, ts, lambda s: s.dist.push_spans("t1", k6_spans(20, 5)))
    assert a == b == ("RateLimited", REASON_BACKPRESSURE, 2.5)
    assert ts.dist.discarded == js.dist.discarded == {
        REASON_RATE_LIMITED: 800, REASON_BACKPRESSURE: 100}
    assert ts.dist.metrics == js.dist.metrics


def test_rejected_push_does_not_intern_or_stage():
    """Admission runs BEFORE staging (`tests/test_ingest_pipeline.py:360`):
    a rate-limited push does not grow the tenant registry's interner and
    still attributes the rejected span count."""
    patch = tenant_patch(SM_ONLY, ingestion={"rate_limit_bytes": 1,
                                             "burst_size_bytes": 1})
    ts = Side(True, {"t1": patch})
    assert ts.plan("t1") is not None
    inst = ts.gens["g0"].instance("t1")
    before = len(inst.registry.interner)
    with pytest.raises(RateLimited):
        ts.dist.push_otlp("t1", payload(k6_spans(32, 6)))
    assert len(inst.registry.interner) == before
    assert ts.dist.discarded.get(REASON_RATE_LIMITED) == 32
    assert not any(ingested(ts).values())


def test_malformed_payload_raises():
    ts = Side(True, {"t1": tenant_patch(SM_ONLY), "t2": tenant_patch(())})
    for tenant in ("t1", "t2"):         # staged, then columnar
        with pytest.raises(MalformedPayload):
            ts.dist.push_otlp(tenant, b"\x0a\xff\xff\xff\x0f garbage")


# -- overload sampling ---------------------------------------------------------


def test_sampler_keep_masks_and_weights_match_reference():
    raw = payload(k6_spans(3000, 7, traces=900))
    recs = [j_stage(raw, JGen().instance("x").registry.interner).spans,
            tt.stage_otlp(raw, TGen(device="cpu").instance("x")
                          .registry.interner).spans]
    assert np.array_equal(recs[0]["trace_id"], recs[1]["trace_id"])
    rng = np.random.default_rng(0)
    valid = rng.random(3000) > 0.05
    for frac in (0.1, 0.5, 0.93):
        for tail in (0.0, 0.9):
            pols = [mod(floor=0.0, tail_quantile=tail, tail_min_spans=100)
                    for mod in (JSampling, TSampling)]
            samplers = [JSampler(fraction_source=lambda: frac,
                                 now=lambda: T0),
                        TSampler(fraction_source=lambda: frac,
                                 now=lambda: T0)]
            out = []
            for smp, pol, r in zip(samplers, pols, recs):
                smp.observe("t", r)
                assert smp.effective_fraction("t", pol) == frac
                out.append(smp.sample("t", r, valid, frac, pol))
            (jk, jw), (tk, tw) = out
            assert np.array_equal(tk, jk)
            assert tw.dtype == jw.dtype == np.float32
            assert np.array_equal(tw, jw)
            assert samplers[1].fractions() == samplers[0].fractions()


def _sampling_rig(fraction, sampling):
    patch = tenant_patch(SM_ONLY, sampling=sampling)
    js, ts = pair({"t1": patch})
    js.dist.sampler = JSampler(fraction_source=lambda: fraction,
                               now=lambda: T0)
    ts.dist.sampler = TSampler(fraction_source=lambda: fraction,
                               now=lambda: T0)
    return js, ts


def test_sampled_push_matches_reference_within_5pct_of_truth():
    js, ts = _sampling_rig(0.5, {"floor": 0.25, "tail_quantile": 0.0})
    spans = k6_spans(4000, 11, traces=1500)
    errs = both(js, ts, lambda s: s.dist.push_otlp("t1", payload(spans)))
    assert errs[0] == errs[1] == {}
    dropped = ts.dist.discarded[REASON_SAMPLED]
    assert ts.dist.discarded == js.dist.discarded
    assert 0.3 * len(spans) < dropped < 0.7 * len(spans)
    assert ingested(ts) == ingested(js)
    inst = ts.gens["g0"].instance("t1")
    assert_same_state(js.gens["g0"].instance("t1"), inst)
    total = calls_total(inst, True)
    assert abs(total - len(spans)) <= 0.05 * len(spans)
    # error spans are kept at weight 1, hash-kept spans at exactly 2.0
    forced = ts.dist.sampler._tenants["t1"].kept_forced_total
    assert total == forced + 2 * (len(spans) - dropped - forced)


def test_sampling_off_is_identical_to_opted_out():
    raw = payload(k6_spans(2000, 13, traces=700))
    states = []
    for frac, sampling in ((1.0, {}), (0.3, {"enabled": False})):
        _js, ts = _sampling_rig(frac, sampling)
        assert ts.dist.push_otlp("t1", raw) == {}
        assert REASON_SAMPLED not in ts.dist.discarded
        states.append((ingested(ts),
                       state_by_labels(ts.gens["g0"].instance("t1"), True)))
    assert states[0] == states[1]


class PressureScheduler(tsched.DeviceScheduler):
    """A port scheduler whose live-ingest queue fill is forced to
    `forced_pressure` (the counterpart of `tests/conftest.py`'s
    `make_pressure_scheduler`): the keep-fraction controller and
    `IngestBackpressure` read it through `depth()`. No worker."""

    def __init__(self, pressure=0.0):
        super().__init__(tsched.SchedConfig(sampling_smoothing_s=0.0,
                                            pipeline_depth=0),
                         start_worker=False)
        self.forced_pressure = pressure

    def depth(self, prio):
        if prio == tsched.PRIO_INGEST:
            return int(round(self.forced_pressure * self._limit(prio)))
        return super().depth(prio)


def test_escalation_full_stream_then_sampling_then_429():
    """Through the port's own scheduler signal: no pressure keeps every
    span, pressure in the sampling band samples (error spans kept), and
    saturation rejects with the scheduler's Retry-After."""
    sc = PressureScheduler(0.0)
    ts = Side(True, {"t1": tenant_patch(SM_ONLY)})
    spans = k6_spans(512, 15)
    for i, s in enumerate(spans):
        s["status_code"] = 2 if i % 16 == 0 else 0
    raw = payload(spans)
    with tsched.use(sc):
        assert ts.dist.push_otlp("t1", raw) == {}
        assert REASON_SAMPLED not in ts.dist.discarded
        sc.forced_pressure = 0.95
        assert ts.dist.push_otlp("t1", raw) == {}
        n_dropped = ts.dist.discarded[REASON_SAMPLED]
        assert 0 < n_dropped < 512
        kept = ts.ings["i0"].got[-1][2]
        assert len(kept) == 512 - n_dropped
        status = tt.stage_otlp(raw, ts.gens["g0"].staging_interner(
            "t1")).spans["status_code"]
        assert int((status[kept] == 2).sum()) == 32     # every error kept
        sc.forced_pressure = 1.0
        with pytest.raises(RateLimited) as ei:
            ts.dist.push_otlp("t1", raw)
        assert ei.value.reason == REASON_BACKPRESSURE
        assert ei.value.retry_after_s == sc.cfg.retry_after_s


# -- the reference's distributor-bound scheduler tests (test_sched.py) ---------


def _mini_distributor():
    class NullIng:
        def push(self, tenant, traces):
            return [None] * len(traces)

        def push_otlp(self, tenant, data):
            return {}

    now = lambda: T0  # noqa: E731
    ov = TOv()
    ov.set_tenant_patch("t", {"ingestion": dict(UNLIMITED)})
    return TDist(_ring(tring, ["i0"], now), {"i0": NullIng()}, overrides=ov,
                 now=now)


def test_distributor_rejects_429_when_ingest_saturated():
    sc = tsched.DeviceScheduler(tsched.SchedConfig(max_queue_ingest=1,
                                                   retry_after_s=3.0),
                                start_worker=False)
    sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4, lambda s: None,
                   pads=(-1,))
    assert sc.ingest_saturated()
    spans = [{"trace_id": bytes([7]) * 16, "span_id": b"x" * 8,
              "name": "op", "service": "s",
              "start_unix_nano": 1, "end_unix_nano": 2}]
    with tsched.use(sc):
        d = _mini_distributor()
        with pytest.raises(RateLimited) as ei:
            d.push_spans("t", spans)
        assert ei.value.retry_after_s == 3.0
        assert ei.value.reason == REASON_BACKPRESSURE
        assert d.discarded.get(REASON_BACKPRESSURE) == 1
    sc.drain_once(force=True)           # queue drained: admitted again
    with tsched.use(sc):
        assert d.push_spans("t", spans) == {}


def test_backpressure_hook_injectable():
    assert TBackpressure(retry_after_fn=lambda: 2.5).retry_after() == 2.5
    assert TBackpressure(lambda: None).retry_after() is None
    with tsched.use(None):              # no scheduler: admit everything
        assert TBackpressure().retry_after() is None


def test_distributor_reads_the_ports_scheduler_not_the_references():
    """A saturated reference scheduler does not shed the port's pushes,
    and the sampler reads the port's keep fraction."""
    sc = jsched.DeviceScheduler(jsched.SchedConfig(max_queue_ingest=1),
                                start_worker=False)
    sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4, lambda s: None,
                   pads=(-1,))
    with jsched.use(sc):
        assert TBackpressure().retry_after() is None
        assert TSampler().global_fraction() == 1.0
        assert JBackpressure().retry_after() is not None
    sc.drain_once(force=True)
    with tsched.use(PressureScheduler(0.95)):
        assert TSampler().global_fraction() < 1.0


def test_usage_and_dataquality_match_reference():
    spans = k6_spans(300, 17, traces=100)
    spans[5]["start_unix_nano"] = NOW_NS + int(3 * 3600e9)
    for patch in (tenant_patch(SM_ONLY), tenant_patch(())):
        js, ts = pair({"t1": patch})
        both(js, ts, lambda s: s.dist.push_otlp("t1", payload(spans)))
        both(js, ts, lambda s: s.dist.push_spans("t1", spans[:50]))
        assert ts.dist.usage.snapshot() == js.dist.usage.snapshot()
        assert ts.dist.dataquality.snapshot() == \
            js.dist.dataquality.snapshot()
        names = lambda reg: sorted({ln.split("{")[0].split(" ")[0]  # noqa: E731
                                    for ln in reg.render().splitlines()
                                    if ln and ln[0] != "#"})
        assert names(ts.dist.obs) == names(js.dist.obs)
