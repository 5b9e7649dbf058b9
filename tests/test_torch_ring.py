"""The port's host layer under the distributor against the reference's, on
the same numpy-seeded inputs: hashing, the ring and its KV, tenant
placement, overrides, the in-memory backend, the ingest bus encoding, and
the distributor's small helpers (rate limiter, forwarder filters, usage
and data-quality accounting, live traces).

Held bit-identical: every hash (`fnv1_32`, `fnv1a_32`, `fnv1a_64`,
`token_for`, the native `token_for`, `_instance_tokens`,
`trace_hash_u01`, `tenant_token`), replication sets and their error
budgets, `owner_of`, `shuffle_shard` membership, `do_batch` sends and
quorum outcomes, lifecycler membership through the KV, and every limit
field; overrides layering (defaults < wildcard < tenant < user patch)
from one YAML file resolves to equal `Limits`.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest

from tempo_tpu.backend.mem import MemBackend as JMem
from tempo_tpu.distributor import forwarder as jfwd
from tempo_tpu.distributor import limiter as jlim
from tempo_tpu.distributor.sampler import trace_hash_u01 as j_u01
from tempo_tpu.fleet.placement import TenantPlacement as JPlacement
from tempo_tpu.fleet.placement import tenant_token as j_tenant_token
from tempo_tpu.ingest import encoding as jenc
from tempo_tpu.ingest.bus import Bus as JBus
from tempo_tpu.ops import hashing as jhash
from tempo_tpu.overrides import Limits as JLimits
from tempo_tpu.overrides import Overrides as JOverrides
from tempo_tpu.overrides import UserConfigurableOverrides as JUco
from tempo_tpu.ring import kv as jkv
from tempo_tpu.ring import ring as jring
from tempo_tpu.utils import dataquality as jdq
from tempo_tpu.utils import livetraces as jlive
from tempo_tpu.utils import usage as jusage

from tempo_tpu_torch import native as tnative
from tempo_tpu_torch.backend import KeyPath as TKeyPath
from tempo_tpu_torch.backend import MemBackend as TMem
from tempo_tpu_torch.distributor import forwarder as tfwd
from tempo_tpu_torch.distributor import limiter as tlim
from tempo_tpu_torch.distributor.sampler import trace_hash_u01 as t_u01
from tempo_tpu_torch.fleet import TenantPlacement as TPlacement
from tempo_tpu_torch.fleet import tenant_token as t_tenant_token
from tempo_tpu_torch.ingest import encoding as tenc
from tempo_tpu_torch.ingest.bus import Bus as TBus
from tempo_tpu_torch.ops import hashing as thash
from tempo_tpu_torch.overrides import Limits as TLimits
from tempo_tpu_torch.overrides import Overrides as TOverrides
from tempo_tpu_torch.overrides import UserConfigurableOverrides as TUco
from tempo_tpu_torch.ring import kv as tkv
from tempo_tpu_torch.ring import ring as tring
from tempo_tpu_torch.utils import dataquality as tdq
from tempo_tpu_torch.utils import livetraces as tlive
from tempo_tpu_torch.utils import usage as tusage

BOTH_RINGS = (jring, tring)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _ids(seed, n, width=16):
    return np.random.default_rng(seed).integers(0, 256, (n, width),
                                                dtype=np.uint8)


# -- hashing -----------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 7, 16, 33])
def test_fnv_hashes_bit_identical(width):
    m = _ids(width, 500, width)
    for fn in ("fnv1_32", "fnv1a_32", "fnv1a_64"):
        a, b = getattr(thash, fn)(m), getattr(jhash, fn)(m)
        assert a.dtype == b.dtype and np.array_equal(a, b), fn
    assert np.array_equal(thash.fnv1a_32(m[0]), jhash.fnv1a_32(m[0]))


@pytest.mark.parametrize("tenant", ["", "acme", "tenant-ü-42"])
def test_token_for_bit_identical(tenant):
    m = _ids(3, 1000)
    want = jhash.token_for(tenant, m)
    assert np.array_equal(thash.token_for(tenant, m), want)
    # the distributor's native batch of the same hash
    assert np.array_equal(tnative.token_for(tenant, m), want)


def test_instance_tokens_and_tenant_tokens_bit_identical():
    for iid in ("i0", "ingester-7", "generator-0", ""):
        for n in (1, 64, 128):
            assert np.array_equal(tring._instance_tokens(iid, n),
                                  jring._instance_tokens(iid, n))
        assert tring._hash_str(iid) == jring._hash_str(iid)
    for t in ("t1", "acme", "tenant-" * 9):
        assert t_tenant_token(t) == j_tenant_token(t)


def test_trace_hash_u01_bit_identical():
    m = _ids(11, 4096)
    a, b = t_u01(m), j_u01(m)
    assert a.dtype == b.dtype == np.float64
    assert np.array_equal(a, b)
    assert (a >= 0).all() and (a < 1).all()


# -- ring ----------------------------------------------------------------------


def _rings(n, zones=0, unhealthy=(), tokens=64):
    """The same membership on both packages' rings."""
    clock = FakeClock()
    out = []
    for mod in BOTH_RINGS:
        r = mod.Ring(replication_factor=3, heartbeat_timeout_s=60.0,
                     now=clock)
        for i in range(n):
            iid = f"i{i}"
            r.register(mod.InstanceDesc(
                id=iid, zone=f"z{i % zones}" if zones else "",
                state=mod.UNHEALTHY if i in unhealthy else mod.ACTIVE,
                tokens=mod._instance_tokens(iid, tokens),
                heartbeat_ts=clock()))
        out.append(r)
    return out


def _sets(ring, tokens, rf):
    """(per-position (member ids, max errors), inverse), or the error a
    position without quorum raises."""
    try:
        sets, inv = ring.batch_lookup(tokens, rf)
    except RuntimeError as e:
        return str(e), None
    return [([i.id for i in s.instances], s.max_errors) for s in sets], inv


def _one(ring, token, rf):
    try:
        s = ring.get(token, rf)
    except RuntimeError as e:
        return str(e)
    return [i.id for i in s.instances], s.max_errors, s.quorum


@pytest.mark.parametrize("n,zones,unhealthy,rf", [
    (1, 0, (), 3), (3, 0, (), 3), (5, 0, (), 3), (6, 3, (), 3),
    (5, 0, (2,), 3), (4, 2, (1,), 2), (7, 0, (), 1)])
def test_replication_sets_equal(n, zones, unhealthy, rf):
    jr, tr = _rings(n, zones, unhealthy)
    toks = np.random.default_rng(n).integers(0, 2**32, 3000,
                                             dtype=np.uint64).astype(np.uint32)
    (js, ji), (ts, ti) = _sets(jr, toks, rf), _sets(tr, toks, rf)
    assert ts == js and (ti is ji is None or np.array_equal(ti, ji))
    # small batches take the sort branch
    assert _sets(tr, toks[:5], rf)[0] == _sets(jr, toks[:5], rf)[0]
    assert [_one(tr, t, rf) for t in toks[:200].tolist()] == \
        [_one(jr, t, rf) for t in toks[:200].tolist()]
    assert tr.ownership() == jr.ownership()


def test_owner_of_and_shuffle_shard_equal():
    jr, tr = _rings(8, unhealthy=(3, 5))
    for key in [f"tenant-{i}" for i in range(40)] + [7, 2**31, 2**32 - 1]:
        a, b = tr.owner_of(key), jr.owner_of(key)
        assert (a and a.id) == (b and b.id)
        assert tr.owns("i0", key) == jr.owns("i0", key)
    for tenant in ("t1", "acme", "x"):
        for size in (0, 1, 3, 5, 8, 9):
            a = tr.shuffle_shard(tenant, size)
            b = jr.shuffle_shard(tenant, size)
            assert sorted(i.id for i in a.instances()) == \
                sorted(i.id for i in b.instances())
    pa, pb = TPlacement(tr, "i1"), JPlacement(jr, "i1")
    ts = [f"t{i}" for i in range(30)]
    assert pa.lost(ts) == pb.lost(ts)
    assert [pa.owns(t) for t in ts] == [pb.owns(t) for t in ts]


@pytest.mark.parametrize("failing,rf", [((), 3), (("i1",), 3),
                                        (("i1", "i2"), 3), (("i0",), 1)])
def test_do_batch_sends_and_quorum_equal(failing, rf):
    jr, tr = _rings(4)
    toks = np.random.default_rng(5).integers(0, 2**32, 400,
                                             dtype=np.uint64).astype(np.uint32)
    outcome = []
    for mod, ring in zip(BOTH_RINGS, (jr, tr)):
        sent = {}

        def send(inst, items, sent=sent):
            sent[inst.id] = sorted(items)
            if inst.id in failing:
                raise ConnectionError(inst.id)
        try:
            mod.do_batch(ring, toks, list(range(len(toks))), send, rf=rf)
            ok = True
        except RuntimeError as e:
            ok = str(e).split(" item group")[0]
        outcome.append((ok, sent))
    assert outcome[0] == outcome[1]
    with pytest.raises(RuntimeError, match="ring is empty"):
        tring.do_batch(tring.Ring(), toks, [0], lambda i, x: None)


def test_lifecycler_through_the_kv():
    """Join, heartbeat and leave through each package's KV: a watching
    ring sees the same members, tokens, states and health."""
    seen = []
    for mod, kvmod in ((jring, jkv), (tring, tkv)):
        clock = FakeClock()
        kv = kvmod.KVStore()
        ring = mod.Ring(kv, heartbeat_timeout_s=30.0, now=clock)
        lcs = [mod.Lifecycler(kv, f"m{i}", zone=f"z{i % 2}", n_tokens=32,
                              now=clock) for i in range(3)]
        states = [sorted((i.id, i.state, i.zone, i.tokens.tobytes())
                         for i in ring.instances())]
        clock.t += 40.0
        lcs[0].heartbeat()
        states.append([(i.id, ring.healthy(i)) for i in ring.instances()])
        lcs[1].leave()
        states.append([i.id for i in ring.instances()])
        lcs[2].start_heartbeat(interval_s=0.05)
        lcs[2].stop_heartbeat()
        assert lcs[2]._hb_thread is None
        states.append(kv.keys())
        seen.append(states)
    assert seen[0] == seen[1]
    assert seen[1][1] == [("m0", True), ("m1", False), ("m2", False)]


def test_kv_cas_json_and_merge_equal():
    a, b = jkv.KVStore(), tkv.KVStore()
    for kv in (a, b):
        kv.cas("k", lambda cur: (cur or 0) + 1)
        kv.cas("k", lambda cur: None)
        assert kv.cas_versioned("k", 1, 5) == (True, 2)
        assert kv.cas_versioned("k", 1, 6) == (False, 2)
    assert a.get_versioned("k") == b.get_versioned("k") == (2, 5)
    ring_map = {f"m{i}": tring.InstanceDesc(
        id=f"m{i}", zone="z", tokens=tring._instance_tokens(f"m{i}", 4),
        heartbeat_ts=float(i)) for i in range(3)}
    doc = tkv._value_to_json(ring_map)
    jmap = {k: jring.InstanceDesc(**dataclasses.asdict(v))
            for k, v in ring_map.items()}
    assert doc == jkv._value_to_json(jmap)
    back = tkv._value_from_json(doc)
    assert {k: (v.id, v.tokens.tolist(), v.heartbeat_ts)
            for k, v in back.items()} == \
        {k: (v.id, v.tokens.tolist(), v.heartbeat_ts)
         for k, v in jmap.items()}
    older = {"m0": dataclasses.replace(ring_map["m0"], heartbeat_ts=9.0)}
    merged = tkv._merge_values([ring_map, older, None])
    assert merged["m0"].heartbeat_ts == 9.0 and len(merged) == 3
    assert [tkv._poll_backoff(1.0, s) for s in range(8)] == \
        [jkv._poll_backoff(1.0, s) for s in range(8)]
    kv, host = tkv.make_kv("local")
    assert kv is host and isinstance(kv, tkv.KVStore)


# -- overrides -----------------------------------------------------------------


def _fields(obj):
    return {f.name: (_fields(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_limits_defaults_equal_field_by_field():
    assert _fields(TLimits()) == _fields(JLimits())
    patch = {"generator": {"processors": ["span-metrics"], "sketch": "both",
                           "dimensions": ["http.method"]},
             "sampling": {"floor": 0.5}, "nope": {"x": 1},
             "ingestion": {"rate_limit_bytes": 7, "not_a_field": 1}}
    assert _fields(TLimits().merged_with(patch)) == \
        _fields(JLimits().merged_with(patch))


RUNTIME_YAML = """
overrides:
  "*":
    ingestion: {rate_limit_bytes: 1000, burst_size_bytes: 2000}
    generator: {max_active_series: 777}
  acme:
    generator: {processors: [span-metrics], collection_interval_s: 5.0}
    sampling: {enabled: false}
"""


def test_overrides_layering_from_yaml_and_user_configurable(tmp_path):
    path = tmp_path / "runtime.yaml"
    path.write_text(RUNTIME_YAML)
    got = []
    for ov_cls, uco_cls, mem in ((JOverrides, JUco, JMem),
                                 (TOverrides, TUco, TMem)):
        be = mem()
        uco = uco_cls(be, be)
        ov = ov_cls(runtime_config_path=str(path), user_configurable=uco)
        v1 = uco.set("acme", {"generator": {"dimensions": ["http.route"],
                                            "disable_collection": True}})
        with pytest.raises(ValueError, match="not user-configurable"):
            uco.set("acme", {"ingestion": {"rate_limit_bytes": 1}})
        with pytest.raises(RuntimeError, match="version conflict"):
            uco.set("acme", {"generator": {}}, version="7")
        ov.set_tenant_patch("beta", {"generator": {"sketch": "moments"}})
        got.append([v1, ov.reload(), *(_fields(ov.for_tenant(t))
                                       for t in ("acme", "beta", "other")),
                    uco.get("acme"), be.list(TKeyPath(())), be.writes])
        uco.delete("acme")
        assert uco.get("acme") is None
    assert got[0] == got[1]
    acme = got[1][2]
    assert acme["generator"]["max_active_series"] == 777
    assert acme["generator"]["dimensions"] == ("http.route",)
    assert acme["sampling"]["enabled"] is False


def test_runtime_config_without_pyyaml_raises(tmp_path, monkeypatch):
    """No PyYAML: a given runtime-config file raises naming its path (the
    limits are never quietly the defaults); no path needs no PyYAML."""
    path = tmp_path / "rt.yaml"
    path.write_text(RUNTIME_YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert _fields(TOverrides().for_tenant("acme")) == _fields(TLimits())
    with pytest.raises(ImportError, match="rt.yaml"):
        TOverrides(runtime_config_path=str(path))


def test_mem_backend_equal():
    from tempo_tpu.backend.raw import KeyPath as JKP
    from tempo_tpu_torch.backend import DoesNotExist, KeyPath

    got = []
    for mem, kp in ((JMem, JKP), (TMem, KeyPath)):
        be = mem()
        for t in ("a", "b"):
            for blk in ("1", "2"):
                be.write("meta.json", kp((t, blk)), f"{t}{blk}".encode())
        be.delete("", kp(("b",)), recursive=True)
        got.append((be.list(kp(())), be.list(kp(("a",))),
                    be.find(kp(("a",)), ".json"),
                    be.read_range("meta.json", kp(("a", "2")), 1, 5),
                    be.reads, be.writes))
    assert got[0] == got[1]
    with pytest.raises(DoesNotExist):
        TMem().read("x", KeyPath(("t",)))


# -- the distributor's helpers -------------------------------------------------


def test_rate_limiter_decisions_equal():
    rng = np.random.default_rng(2)
    clocks = [FakeClock(), FakeClock()]
    lims = [jlim.RateLimiter(now=clocks[0], idle_ttl_s=10.0, max_buckets=4),
            tlim.RateLimiter(now=clocks[1], idle_ttl_s=10.0, max_buckets=4)]
    out = [[], []]
    for step in range(400):
        tenant = f"t{rng.integers(0, 7)}"
        n = int(rng.integers(0, 3000))
        dt = float(rng.exponential(0.5))
        for k in (0, 1):
            clocks[k].t += dt
            out[k].append(lims[k].allow(tenant, n, 2000.0, 4000.0))
    assert out[0] == out[1] and 0 < sum(out[1]) < 400
    assert sorted(lims[0]._buckets) == sorted(lims[1]._buckets)
    for s in ("local", "global"):
        assert tlim.effective_rate(s, 90.0, 3) == \
            jlim.effective_rate(s, 90.0, 3)


def _dict_spans(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "trace_id": rng.bytes(16), "span_id": rng.bytes(8),
            "name": f"op-{i % 5}", "service": f"svc-{i % 3}",
            "kind": int(i % 6), "status_code": int(i % 3),
            "start_unix_nano": int(1.7e18) + i,
            "end_unix_nano": int(1.7e18) + i + 1000,
            "attrs": {"http.method": ["GET", "POST"][i % 2], "n": i},
            "res_attrs": {"service.name": f"svc-{i % 3}", "zone": "z1"}})
    return out


POLICIES = [
    {"include": {"match_type": "strict", "attributes": [
        {"key": "kind", "value": "SPAN_KIND_SERVER"}]}},
    {"exclude": {"match_type": "regex", "attributes": [
        {"key": "span.http.method", "value": "PO.*"}]}},
    {"include": {"attributes": [{"key": "resource.zone", "value": "z1"}]}},
]


@pytest.mark.parametrize("flt,policies", [
    ({}, POLICIES), ({"include": {"service": "svc-1"}}, ()),
    ({"exclude": {"http.method": "GET"}}, POLICIES[:1]),
    ({"include": {"zone": "z1"}, "exclude": {"name": "op-2"}}, ())])
def test_forwarder_filters_equal(flt, policies):
    spans = _dict_spans(120, 4)
    keep_j = [jfwd.keep_span(s, flt, policies) for s in spans]
    keep_t = [tfwd.keep_span(s, flt, policies) for s in spans]
    assert keep_t == keep_j
    assert tfwd.otlp_json_payload(spans[:9]) == jfwd.otlp_json_payload(spans[:9])


def test_forwarder_queue_and_sink():
    got = []
    fwd = tfwd.Forwarder(tfwd.ForwarderConfig(
        name="f", filter={"include": {"service": "svc-0"}}, queue_size=4),
        sink=got.extend)
    mgr = tfwd.ForwarderManager()
    assert mgr.empty
    mgr.register("t", fwd)
    mgr.offer("t", _dict_spans(30, 1))
    mgr.offer("other", _dict_spans(30, 1))
    mgr.shutdown()
    assert not fwd._thread.is_alive()
    assert len(got) == 10 and fwd.forwarded == 10 and fwd.dropped == 0


def test_usage_dataquality_livetraces_equal():
    spans = _dict_spans(300, 9)
    spans[3]["start_unix_nano"] = int(2e18)      # far future
    spans[4]["start_unix_nano"] = int(1e15)      # far past
    now = lambda: 1.7e9  # noqa: E731
    out = []
    for us, dq, lt in ((jusage, jdq, jlive), (tusage, tdq, tlive)):
        u = us.UsageTracker(us.UsageTrackerConfig(
            dimensions=("service", "http.method", "zone"),
            max_cardinality=4))
        u.observe("t", spans, size_bytes=90_000)
        u.observe_grouped("t", [(("a", "b", "c"), 3, 12.5)])
        q = dq.DataQuality(now=now)
        q.observe_spans("t", spans)
        q.observe_start_ns("u", [s["start_unix_nano"] for s in spans])
        store = lt.LiveTraceStore(max_live_traces=5, max_trace_bytes=900,
                                  now=now)
        reasons = [store.push(s["trace_id"][:1], [s]) for s in spans[:40]]
        cut = store.cut(immediate=True)
        out.append((u.snapshot(), u.prometheus_text(), q.snapshot(), reasons,
                    store.pushes_rejected, [(c.trace_id, len(c.spans))
                                            for c in cut]))
    assert out[0] == out[1]


def test_orphan_counter_on_the_ports_runtime_registry():
    from tempo_tpu_torch.obs.runtime import RUNTIME

    tdq.reset_orphan_spans()
    try:
        tdq.note_orphan_spans("t", 3)
        tdq.note_orphan_spans("t", 0)
        assert tdq.orphan_spans_snapshot() == {"t": 3}
        text = RUNTIME.render()
        assert 'tempo_dataquality_orphan_spans_total{tenant="t"} 3' in text
    finally:
        tdq.reset_orphan_spans()


# -- the ingest bus ------------------------------------------------------------


def test_bus_encoding_and_partitions_equal():
    spans = _dict_spans(200, 12)
    for s in spans[:5]:
        s["links"] = [{"trace_id": b"\1" * 16, "span_id": b"\2" * 8}]
    groups = {}
    for s in spans:
        groups.setdefault(s["trace_id"][:2], []).append(s)
    traces = list(groups.items())
    toks = jhash.token_for("t", np.stack([np.frombuffer(
        t.ljust(16, b"\0"), np.uint8) for t, _ in traces]))
    assert tenc.encode_push(traces, 4096) == jenc.encode_push(traces, 4096)
    assert np.array_equal(tenc.partition_for(toks, 5),
                          jenc.partition_for(toks, 5))
    rec = tenc.encode_push(traces)[0]
    assert list(tenc.decode_push(rec)) == list(jenc.decode_push(rec))
    logs = []
    for enc, bus_cls in ((jenc, JBus), (tenc, TBus)):
        bus = bus_cls(n_partitions=3)
        enc.produce_traces(bus, "t", traces, toks)
        bus.commit("g", 1, 1)
        logs.append([(p, bus.high_watermark(p), bus.lag("g", p),
                      [r.value for r in bus.fetch(p, 0, 100)])
                     for p in range(3)])
    assert logs[0] == logs[1]
