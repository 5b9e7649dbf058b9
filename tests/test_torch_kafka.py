"""The port's Kafka ingest and Jaeger agent receiver against the reference's.

Mirrors `tests/test_ingest_bus.py:226-645` (the Kafka wire client, its
CRC, leader and coordinator routing, failover, the consumer group and
its rebalance, the block-builder and generator in group mode, the
ingest-storage deployment and two block-builder Apps sharing a group),
`tests/test_write_path.py:364` (the Kafka receiver) and
`tests/test_app.py:536,587` (the UDP agent receiver, alone and in the
App). Each scenario runs once per package against its own mock broker
(`tests/mock_kafka.py`, which checks every batch's CRC32C with its own
table) and the observations are held equal: offsets, records, assignments,
commits and fenced errors exactly; generator state by label strings with
float sums at rtol 1e-6 (`assert_same_state`). The port runs on the CPU.
The mock's CRC is a Python loop a byte, so the records stay small, and
the differential block-builders write no sketch sidecars (the reference
compiles them for seconds; `test_torch_blockbuilder.py` holds them).
"""

from __future__ import annotations

import importlib
import socket
import time

import numpy as np
import pytest

from tempo_tpu_torch import sched as tsched
from tests.mock_kafka import (MockKafkaBroker, start_mock_kafka,
                              start_mock_kafka_cluster)
from tests.test_app import _agent_datagram
from tests.test_torch_distributor import assert_same_state

PKGS = ("tempo_tpu", "tempo_tpu_torch")


@pytest.fixture(autouse=True)
def _singletons():
    tsched.reset()
    yield
    tsched.reset()


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def dev(pkg: str) -> dict:
    """The device keyword: the port runs on the CPU, the reference takes none."""
    return {"device": "cpu"} if pkg == "tempo_tpu_torch" else {}


def both(scenario):
    """Run `scenario(pkg)` for each package; return the two results."""
    return [scenario(pkg) for pkg in PKGS]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


# -- the wire ----------------------------------------------------------------

def test_crc32c_and_record_batch_bytes_match_reference():
    rng = np.random.default_rng(11)
    jk, tk = (mod(p, "ingest.kafka") for p in PKGS)
    for n in (0, 1, 7, 64, 1000):
        data = rng.bytes(n)
        assert tk.crc32c(data) == jk.crc32c(data)
    recs = [(b"t%d" % i, rng.bytes(int(rng.integers(0, 40))))
            for i in range(5)]
    batch = tk.encode_record_batch(17, recs, first_ts_ms=1_700_000_000_000)
    assert batch == jk.encode_record_batch(17, recs,
                                           first_ts_ms=1_700_000_000_000)
    assert tk.decode_record_batches(batch) == jk.decode_record_batches(batch)


def test_kafka_wire_produce_fetch_commit():
    def scenario(pkg):
        srv, port, broker = start_mock_kafka(n_partitions=2)
        bus = mod(pkg, "ingest.kafka").KafkaBus(f"127.0.0.1:{port}",
                                                n_partitions=2)
        try:
            offs = [bus.produce(0, "t1", b"hello"),
                    bus.produce(0, "t1", b"world"),
                    bus.produce(1, "t2", b"other")]
            obs = [offs, broker.produce_batches,
                   [(r.offset, r.tenant, r.value) for r in bus.fetch(0, 0)],
                   bus.fetch(0, 1)[0].value, bus.fetch(0, 2),
                   bus.high_watermark(0), bus.high_watermark(1),
                   bus.committed("g", 0)]
            bus.commit("g", 0, 2)
            obs += [bus.committed("g", 0), bus.lag("g", 0), bus.lag("g", 1)]
            return obs
        finally:
            bus.close()
            srv.shutdown()

    j, t = both(scenario)
    assert t == j
    assert t[:3] == [[0, 1, 0], 3, [(0, "t1", b"hello"), (1, "t1", b"world")]]
    assert t[-3:] == [2, 0, 1]


def test_kafka_wire_crc_rejected():
    """A corrupted batch is rejected by the port's decoder and the broker."""
    tk = mod("tempo_tpu_torch", "ingest.kafka")
    batch = bytearray(tk.encode_record_batch(0, [(b"t", b"payload")]))
    batch[-1] ^= 0xFF
    for decode in (tk.decode_record_batches,
                   mod("tempo_tpu", "ingest.kafka").decode_record_batches,
                   MockKafkaBroker()._decode_batch):
        with pytest.raises(ValueError, match="crc"):
            decode(bytes(batch))


def _split_cluster(pkg, n_partitions, timeout_s):
    servers, ports, brokers, cluster = start_mock_kafka_cluster(
        n_partitions=n_partitions, n_brokers=2)
    bus = mod(pkg, "ingest.kafka").KafkaBus(
        f"127.0.0.1:{ports[0]}", n_partitions=n_partitions,
        timeout_s=timeout_s)
    return servers, brokers, cluster, bus


def test_kafka_leader_routing_split_cluster():
    def scenario(pkg):
        servers, brokers, cluster, bus = _split_cluster(pkg, 4, 5.0)
        try:
            for p in range(4):
                bus.produce(p, "t", b"v%d" % p)
            got = [[r.value for r in bus.fetch(p, 0)] for p in range(4)]
            bus.commit("g", 1, 1)
            return got, brokers[1].produce_reqs > 0, bus.committed("g", 1)
        finally:
            bus.close()
            for s in servers:
                s.shutdown()

    j, t = both(scenario)
    assert t == j == ([[b"v0"], [b"v1"], [b"v2"], [b"v3"]], True, 1)


def test_kafka_releader_refresh_and_dead_broker_failover():
    """A moved leader heals by one metadata refresh; a dead one by a remap."""
    def moved(pkg):
        servers, brokers, cluster, bus = _split_cluster(pkg, 2, 5.0)
        try:
            bus.produce(0, "t", b"a")
            cluster.move_leader(0, 1)
            bus.produce(0, "t", b"b")
            return [r.value for r in bus.fetch(0, 0)]
        finally:
            bus.close()
            for s in servers:
                s.shutdown()

    def dead(pkg):
        servers, brokers, cluster, bus = _split_cluster(pkg, 2, 2.0)
        try:
            bus.produce(1, "t", b"a")
            servers[1].shutdown()
            cluster.move_leader(1, 0)
            with cluster.lock:
                cluster.addrs.pop(1, None)
            bus.produce(1, "t", b"b")
            return [r.value for r in bus.fetch(1, 0)]
        finally:
            bus.close()
            for s in servers:
                s.shutdown()

    for scenario in (moved, dead):
        j, t = both(scenario)
        assert t == j == [b"a", b"b"]


# -- consumer groups ---------------------------------------------------------

def _group_bus(pkg, port, n_partitions=4):
    return mod(pkg, "ingest.kafka").KafkaBus(
        f"127.0.0.1:{port}", n_partitions=n_partitions, timeout_s=5.0)


def test_consumer_group_join_and_range_assignment():
    def scenario(pkg):
        srv, port, broker = start_mock_kafka(n_partitions=4)
        bus = _group_bus(pkg, port)
        try:
            cg = mod(pkg, "ingest.kafka").ConsumerGroup
            now = [1000.0]
            c1 = cg(bus, "bb", now=lambda: now[0])
            c2 = cg(bus, "bb", now=lambda: now[0])
            first = (c1.ensure_active(), c2.ensure_active())
            now[0] += 3600
            return first, (c1.ensure_active(), c2.ensure_active())
        finally:
            bus.close()
            srv.shutdown()

    j, t = both(scenario)
    assert t == j
    (f1, f2), (a1, a2) = t
    assert f1 == [0, 1, 2, 3] and f2 == []
    assert sorted(a1 + a2) == [0, 1, 2, 3] and a1 and a2


def test_consumer_group_member_death_rebalances_without_loss():
    def scenario(pkg):
        kafka = mod(pkg, "ingest.kafka")
        srv, port, broker = start_mock_kafka(n_partitions=4)
        bus = _group_bus(pkg, port)
        try:
            for p in range(4):
                for i in range(3):
                    bus.produce(p, "t", b"p%d-%d" % (p, i))
            now = [1000.0]
            c1 = kafka.ConsumerGroup(bus, "bb", now=lambda: now[0])
            c2 = kafka.ConsumerGroup(bus, "bb", now=lambda: now[0])
            c1.ensure_active()
            c2.ensure_active()
            now[0] += 3600
            a1, a2 = c1.ensure_active(), c2.ensure_active()
            c1.commit(a1[0], 2)
            c2.commit(a2[0], 1)
            broker.cluster.expire_member("bb", c2.member_id)
            now[0] += 3600
            a1b = c1.ensure_active() or c1.ensure_active()
            tail = bus.fetch(a2[0], bus.committed("bb", a2[0]))
            with pytest.raises(kafka.KafkaError):
                c2.commit(a2[0], 3)
            return (a1, a2, a1b, bus.committed("bb", a2[0]),
                    [r.value for r in tail])
        finally:
            bus.close()
            srv.shutdown()

    j, t = both(scenario)
    assert t == j
    a1, a2, a1b, committed, tail = t
    assert a1b == [0, 1, 2, 3] and committed == 1 and len(tail) == 2


def test_consumer_group_survives_coordinator_move():
    def scenario(pkg):
        servers, ports, brokers, cluster = start_mock_kafka_cluster(
            n_partitions=4, n_brokers=2)
        bus = _group_bus(pkg, ports[0])
        try:
            now = [1000.0]
            cg = mod(pkg, "ingest.kafka").ConsumerGroup(
                bus, "bb", now=lambda: now[0])
            before = cg.ensure_active()
            cluster.move_coordinator(1)
            now[0] += 3600
            after = cg.ensure_active()
            cg.commit(0, 5)
            return before, after, bus.committed("bb", 0)
        finally:
            bus.close()
            for s in servers:
                s.shutdown()

    j, t = both(scenario)
    assert t == j == ([0, 1, 2, 3], [0, 1, 2, 3], 5)


# -- consumers over the wire -------------------------------------------------

def _traces(t0_ns: int, n: int = 8):
    out = []
    for i in range(1, n + 1):
        tid = bytes([i]) * 16
        out.append((tid, [{"trace_id": tid, "span_id": bytes([i]) * 8,
                           "name": f"k-{i % 2}", "service": "ksvc",
                           "start_unix_nano": t0_ns,
                           "end_unix_nano": t0_ns + 10 ** 6 + i}]))
    return out


def _generator(pkg, now):
    ov = mod(pkg, "overrides").Overrides()
    ov.set_tenant_patch("t1", {"generator": {"processors": ["span-metrics"],
                                             "max_active_series": 1024}})
    gmod = mod(pkg, "generator.generator")
    sm = mod(pkg, "generator.processors.spanmetrics").SpanMetricsConfig(
        sketch_max_series=256,
        **({} if pkg == "tempo_tpu_torch" else {"kernel": "xla"}))
    cfg = mod(pkg, "generator.instance").GeneratorConfig(
        processors=("span-metrics",), spanmetrics=sm)
    return gmod.Generator(cfg, overrides=ov, now=now, **dev(pkg))


def test_kafka_bus_feeds_blockbuilder_and_generator():
    """Distributor-side produce, block-builder consume (commit after the
    flush) and generator consume over the wire, static partitions."""
    T = 1_700_000_000.0
    traces = _traces(int((T - 3) * 1e9))

    def scenario(pkg):
        srv, port, broker = start_mock_kafka(n_partitions=2)
        bus = _group_bus(pkg, port, n_partitions=2)
        try:
            bbmod = mod(pkg, "blockbuilder.blockbuilder")
            bbmod.produce_traces(bus, "t1", traces,
                                 np.arange(1, 9, dtype=np.uint32) * 1000)
            total = bus.high_watermark(0) + bus.high_watermark(1)
            be = mod(pkg, "backend.mem").MemBackend()
            bb = bbmod.BlockBuilder(bus, be, bbmod.BlockBuilderConfig(
                partitions=(0, 1), sidecars=False), now=lambda: T,
                **dev(pkg))
            n = bb.consume_cycle()
            db = mod(pkg, "db.tempodb").TempoDB(be, be, **dev(pkg))
            db.poll_now()
            objs = sum(m.total_objects for m in db.blocklist.metas("t1"))
            commits = [bus.committed(bbmod.CONSUMER_GROUP, p) for p in (0, 1)]
            db.shutdown()
            gen = _generator(pkg, lambda: T)
            got = gen.consume_bus(bus, (0, 1))
            return (total, n, objs, commits, got,
                    gen.instance("t1").spans_received), gen
        finally:
            bus.close()
            srv.shutdown()

    (j, jg), (t, tg) = both(scenario)
    assert t == j
    assert t[1] == t[0] and t[2] == 8 and t[5] == 8
    assert_same_state(jg.instance("t1"), tg.instance("t1"))


def test_blockbuilder_and_generator_group_mode():
    """`partitions=None` on a Kafka bus runs both consumers in group mode:
    the group assigns every partition and commits carry its generation."""
    T = 1_700_000_000.0
    traces = _traces(int((T - 3) * 1e9), n=4)

    def scenario(pkg):
        enc = mod(pkg, "ingest.encoding")
        srv, port, broker = start_mock_kafka(n_partitions=2)
        bus = _group_bus(pkg, port, n_partitions=2)
        try:
            for p in range(2):
                for tid, spans in traces[p::2]:
                    bus.produce(p, "t1", enc.encode_push([(tid, spans)])[0])
            bbmod = mod(pkg, "blockbuilder.blockbuilder")
            bb = bbmod.BlockBuilder(
                bus, mod(pkg, "backend.mem").MemBackend(),
                bbmod.BlockBuilderConfig(partitions=None, sidecars=False),
                now=lambda: T, **dev(pkg))
            n = bb.consume_cycle()
            gen = _generator(pkg, lambda: T)
            got = gen.consume_bus(bus)
            cg = gen._cgroups["metrics-generator"]
            return (n, bb.blocks_flushed, bb._cg.assignment,
                    bb._cg.generation >= 0,
                    [bus.committed("blockbuilder", p) for p in (0, 1)],
                    got, cg.assignment,
                    [bus.committed("metrics-generator", p) for p in (0, 1)],
                    gen.consume_bus(bus)), gen
        finally:
            bus.close()
            srv.shutdown()

    (j, jg), (t, tg) = both(scenario)
    assert t == j
    assert t[0] == 4 and t[2] == [0, 1] and t[4] == [2, 2] and t[5] == 4
    assert t[8] == 0
    assert_same_state(jg.instance("t1"), tg.instance("t1"))


def test_group_consumers_rebalance_without_loss():
    """A second generator joins the group mid-stream: the partitions split
    between the two, and every record is applied exactly once over the
    pair (the summed state equals one generator's over the whole topic)."""
    T = 1_700_000_000.0
    traces = _traces(int((T - 3) * 1e9), n=8)

    def scenario(pkg):
        enc = mod(pkg, "ingest.encoding")
        srv, port, broker = start_mock_kafka(n_partitions=4)
        bus = _group_bus(pkg, port)
        now = [T]
        try:
            for i, (tid, spans) in enumerate(traces[:4]):
                bus.produce(i % 4, "t1", enc.encode_push([(tid, spans)])[0])
            g1, g2 = _generator(pkg, lambda: now[0]), \
                _generator(pkg, lambda: now[0])
            first = g1.consume_bus(bus)
            for i, (tid, spans) in enumerate(traces[4:]):
                bus.produce(i % 4, "t1", enc.encode_push([(tid, spans)])[0])
            got = [first, g2.consume_bus(bus)]
            for _ in range(3):
                now[0] += 3600
                got += [g1.consume_bus(bus), g2.consume_bus(bus)]
            a1 = g1._cgroups["metrics-generator"].assignment
            a2 = g2._cgroups["metrics-generator"].assignment
            spans = g1.instance("t1").spans_received + \
                g2.instance("t1").spans_received
            return got, a1, a2, spans, [
                bus.lag("metrics-generator", p) for p in range(4)]
        finally:
            bus.close()
            srv.shutdown()

    j, t = both(scenario)
    assert t == j
    got, a1, a2, spans, lag = t
    assert sorted(a1 + a2) == [0, 1, 2, 3] and a1 and a2
    assert sum(got) == 8 and spans == 8 and lag == [0, 0, 0, 0]


# -- the receivers -----------------------------------------------------------

def _write_rig(pkg, tmp_path, t):
    """3 ingesters on a ring behind one RF3 distributor (the reference's
    `tests/test_write_path.py` rig), in package `pkg`."""
    now = lambda: t[0]  # noqa: E731
    ingmod = mod(pkg, "ingester")
    ringmod = mod(pkg, "ring")
    rr = mod(pkg, "ring.ring")
    cfg = ingmod.IngesterConfig(instance=mod(pkg, "ingester.instance")
                                .InstanceConfig(trace_idle_s=2.0,
                                                trace_live_s=10.0,
                                                max_block_duration_s=30.0))
    backend = mod(pkg, "backend.mem").MemBackend()
    ring = ringmod.Ring(replication_factor=3, now=now)
    ingesters = {}
    for i in range(3):
        iid = f"ing-{i}"
        ingesters[iid] = ingmod.Ingester(
            str(tmp_path / f"{pkg}-ing{i}"), flush_writer=backend, cfg=cfg,
            now=now, instance_id=iid)
        ring.register(ringmod.InstanceDesc(
            id=iid, state=ringmod.ACTIVE, tokens=rr._instance_tokens(iid, 64),
            heartbeat_ts=now()))
    dmod = mod(pkg, "distributor")
    dist = dmod.Distributor(ring, ingesters,
                            cfg=dmod.DistributorConfig(rf=3), now=now)
    return ingesters, dist


def test_kafka_receiver_consumes_topic(tmp_path):
    """OTLP records from a topic go into `Distributor.push_otlp`, the
    tenant on the record key; offsets commit after the push. The
    receiver's config defaults are the reference's."""
    import dataclasses

    assert dataclasses.asdict(
        mod("tempo_tpu_torch", "distributor.receiver_kafka")
        .KafkaReceiverConfig()) == dataclasses.asdict(
        mod("tempo_tpu", "distributor.receiver_kafka").KafkaReceiverConfig())
    def scenario(pkg):
        t = [1000.0]
        ingesters, dist = _write_rig(pkg, tmp_path, t)
        rk = mod(pkg, "distributor.receiver_kafka")
        enc = mod(pkg, "model.otlp").encode_spans_otlp
        bus = mod(pkg, "ingest.bus").Bus(n_partitions=2)

        def span(tid, sid, name):
            return {"trace_id": tid, "span_id": sid, "name": name,
                    "service": "svc", "start_unix_nano": 10 ** 18,
                    "end_unix_nano": 10 ** 18 + 10 ** 6,
                    "res_attrs": {"service.name": "kr-svc"}}
        bus.produce(0, "t1", enc([span(bytes([40]) * 16, bytes([1]) * 8,
                                       "kr-op")]))
        bus.produce(1, "t1", enc([span(bytes([41]) * 16, bytes([2]) * 8,
                                       "kr-op2")]))
        bus.produce(1, "", b"\xff not otlp")        # default tenant, poison
        rx = rk.KafkaReceiver(bus, dist,
                              rk.KafkaReceiverConfig(partitions=(0, 1)))
        n = rx.run_once()
        held = [sum(1 for ing in ingesters.values()
                    if ing.find_trace_by_id("t1", bytes([b]) * 16))
                for b in (40, 41)]
        names = sorted(s["name"] for s in next(
            ing.find_trace_by_id("t1", bytes([41]) * 16)
            for ing in ingesters.values()))
        return (n, held, names, rx.spans_pushed, rx.errors,
                [bus.committed(rx.cfg.group, p) for p in (0, 1)],
                rx.run_once())

    j, t = both(scenario)
    assert t == j
    assert t[0] == 3 and t[1] == [3, 3] and t[5] == [1, 2] and t[6] == 0


def test_jaeger_agent_udp_receiver():
    """A thrift-compact datagram over loopback UDP decodes to the same
    span in both packages; junk is counted and dropped."""
    gram = _agent_datagram("udp-svc", [{
        "tid_lo": 0x1234, "tid_hi": 0, "sid": 0x77, "psid": 0x55,
        "name": "udp-op", "start_us": 1_700_000_000_000_000,
        "dur_us": 25_000,
        "tags": {"span.kind": "server", "error": True,
                 "retries": 3, "ratio": 0.5, "note": "hé"}}])

    def scenario(pkg):
        ra = mod(pkg, "distributor.receiver_agent")
        pushed = []

        class Rec:
            def push_spans(self, tenant, spans, size_bytes=None, **kw):
                pushed.append((tenant, spans, size_bytes))
                return {}

        assert ra.JaegerAgentConfig() == ra.JaegerAgentConfig(
            host="127.0.0.1", port=6831, allow_wildcard_bind=False,
            tenant="single-tenant", max_datagram=65_000)
        with pytest.raises(ValueError, match="allow_wildcard_bind"):
            ra.JaegerAgentReceiver(Rec(), ra.JaegerAgentConfig(
                host="0.0.0.0", port=0)).start()
        rx = ra.JaegerAgentReceiver(Rec(), ra.JaegerAgentConfig(port=0))
        rx.start()
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.sendto(gram, ("127.0.0.1", rx.port))
            s.sendto(b"\xff junk not thrift", ("127.0.0.1", rx.port))
            s.close()
            deadline = time.time() + 5
            while time.time() < deadline and (not pushed or rx.errors < 1):
                time.sleep(0.02)
            return pushed, rx.batches_received, rx.spans_received, rx.errors
        finally:
            rx.stop()

    j, t = both(scenario)
    assert t == j
    pushed, batches, spans, errors = t
    assert (batches, spans, errors) == (1, 1, 1)
    tenant, got, size = pushed[0]
    assert tenant == "single-tenant" and size == len(gram)
    sp = got[0]
    assert sp["name"] == "udp-op" and sp["service"] == "udp-svc"
    assert sp["kind"] == 2 and sp["status_code"] == 2
    assert sp["end_unix_nano"] - sp["start_unix_nano"] == 25_000_000


# -- the App -----------------------------------------------------------------

def _app(pkg, cfg, **kw):
    app = mod(pkg, "app").App(cfg, **dev(pkg), **kw)
    app.overrides.set_tenant_patch("single-tenant", {
        "generator": {"processors": ["span-metrics"]}})
    return app


def test_jaeger_agent_wired_into_app(tmp_path):
    """`distributor.jaeger_agent_port` boots the receiver in the App; a
    datagram lands in the ingester and, through the generator tee, in the
    span-metrics state, the same in both packages."""
    now_us = int((time.time() - 2) * 1e6)
    grams = [_agent_datagram("agent-svc", [{
        "tid_lo": 0xABC0 + i, "tid_hi": 0, "sid": 1 + i,
        "name": f"agent-op-{i % 2}", "start_us": now_us,
        "dur_us": 1000 + i, "tags": {}}]) for i in range(4)]

    def scenario(pkg):
        cfg = mod(pkg, "app.config").Config()
        cfg.storage.backend = "mem"
        cfg.storage.wal_path = str(tmp_path / pkg / "wal")
        cfg.generator.localblocks.data_dir = str(tmp_path / pkg / "lb")
        cfg.distributor.jaeger_agent_port = free_port()
        app = _app(pkg, cfg)
        app.start_loops()
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for g in grams:
                s.sendto(g, ("127.0.0.1", app.jaeger_agent.port))
            s.close()
            deadline = time.time() + 5
            while time.time() < deadline and \
                    app.jaeger_agent.spans_received < 4:
                time.sleep(0.02)
            tid = bytes(8) + (0xABC0).to_bytes(8, "big")
            found = [sp["name"] for sp in
                     app.ingester.find_trace_by_id("single-tenant", tid)]
            inst = app.generator.instance("single-tenant")
            inst.drain() if hasattr(inst, "drain") else None
            return (app.jaeger_agent.spans_received, found,
                    app.jaeger_agent.cfg.host), inst
        finally:
            app.shutdown()

    (j, ji), (t, ti) = both(scenario)
    assert t == j == (4, ["agent-op-0"], "127.0.0.1")
    assert_same_state(ji, ti)


def test_ingest_storage_deployment_over_kafka(tmp_path):
    """`ingest.kafka_bootstrap`: a distributor App produces to the broker,
    a block-builder App persists blocks and a generator App aggregates,
    sharing only the broker and the object store (port only: the
    reference's deployment is `tests/test_ingest_bus.py:329`)."""
    from tempo_tpu_torch.app.api import serve
    from tempo_tpu_torch.app.config import Config
    from tempo_tpu_torch.ingest.kafka import KafkaBus
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    srv, kport, broker = start_mock_kafka(n_partitions=2)
    store = str(tmp_path / "store")
    apps, servers = {}, {}

    def boot(name, cfg):
        cfg.server.http_listen_port = free_port()
        cfg.storage.wal_path = str(tmp_path / name / "wal")
        cfg.ingest.enabled = True
        cfg.ingest.kafka_bootstrap = f"127.0.0.1:{kport}"
        cfg.ingest.n_partitions = 2
        cfg.ingest.consume_interval_s = 0.1
        app = _app("tempo_tpu_torch", cfg)
        app.start_loops()
        apps[name] = app
        servers[name] = serve(app, block=False)

    try:
        boot("dist", Config(target="distributor"))
        for name, target in (("bb", "block-builder"),
                             ("gen", "metrics-generator")):
            c = Config(target=target)
            c.storage.backend = "local"
            c.storage.local_path = store
            c.generator.localblocks.data_dir = str(tmp_path / "lb")
            boot(name, c)
        assert isinstance(apps["dist"].bus, KafkaBus)
        t0 = int((time.time() - 3) * 1e9)
        spans = [{"trace_id": bytes([i]) * 16, "span_id": b"\xab" * 8,
                  "name": "kf-op", "service": "kf", "kind": 2,
                  "start_unix_nano": t0, "end_unix_nano": t0 + 10 ** 7,
                  "res_attrs": {"service.name": "kf"}}
                 for i in range(1, 13)]
        apps["dist"].distributor.push_otlp("single-tenant",
                                           encode_spans_otlp(spans))
        assert broker.produce_batches >= 1
        deadline = time.time() + 8
        while time.time() < deadline:
            inst = apps["gen"].generator.instances.get("single-tenant")
            apps["bb"].db.poll_now()
            objs = sum(m.total_objects for m in
                       apps["bb"].db.blocklist.metas("single-tenant"))
            if inst is not None and inst.spans_received == 12 and objs == 12:
                break
            time.sleep(0.1)
        assert apps["gen"].generator.instance(
            "single-tenant").spans_received == 12
        assert objs == 12
        back = apps["bb"].db.find_trace_by_id("single-tenant",
                                              bytes([5]) * 16)
        assert back and back[0]["name"] == "kf-op"
    finally:
        for s in servers.values():
            s.shutdown()
            s.server_close()
        for a in apps.values():
            a.shutdown()
        srv.shutdown()


def test_two_blockbuilder_apps_split_partitions_via_group(tmp_path):
    """Two block-builder Apps with `ingest.partitions: ()` share a group:
    the 4 partitions split between them and every record is persisted once
    (port only: the reference's is `tests/test_ingest_bus.py:645`)."""
    from tempo_tpu_torch.app.config import Config
    from tempo_tpu_torch.backend.meta import read_block_meta
    from tempo_tpu_torch.backend.raw import blocks as list_blocks
    from tempo_tpu_torch.ingest.encoding import encode_push
    from tempo_tpu_torch.ingest.kafka import KafkaBus

    srv, kport, broker = start_mock_kafka(n_partitions=4)
    store = str(tmp_path / "store")
    apps = []
    try:
        producer = KafkaBus(f"127.0.0.1:{kport}", n_partitions=4,
                            timeout_s=5.0)
        rng = np.random.default_rng(3)
        for p in range(4):
            for i in range(2):
                tid = rng.bytes(16)
                producer.produce(p, "t", encode_push([(tid, [{
                    "trace_id": tid, "span_id": rng.bytes(8),
                    "name": f"op-p{p}-{i}", "service": "svc",
                    "start_unix_nano": 1_700_000_000_000_000_000 + p,
                    "end_unix_nano": 1_700_000_000_000_000_001 + p,
                    "kind": 2, "status_code": 0}])])[0])
        producer.close()
        clock = [1000.0]

        def boot():
            cfg = Config(target="block-builder")
            cfg.storage.backend = "local"
            cfg.storage.local_path = store
            cfg.storage.wal_path = str(tmp_path / f"wal{len(apps)}")
            cfg.ingest.enabled = True
            cfg.ingest.kafka_bootstrap = f"127.0.0.1:{kport}"
            cfg.ingest.n_partitions = 4
            cfg.ingest.partitions = ()
            app = mod("tempo_tpu_torch", "app").App(
                cfg, now=lambda: clock[0], device="cpu")
            apps.append(app)
            return app

        a, b = boot(), boot()
        assert a.blockbuilder.cfg.partitions is None
        for _ in range(6):
            clock[0] += 3600
            a.blockbuilder.consume_cycle()
            b.blockbuilder.consume_cycle()
        pa = a.blockbuilder._cg.assignment
        pb = b.blockbuilder._cg.assignment
        assert sorted(pa + pb) == [0, 1, 2, 3] and pa and pb
        total = sum(read_block_meta(a.backend, bid, "t").total_objects
                    for bid in list_blocks(a.backend, "t"))
        assert total == 8
        assert [a.bus.committed("blockbuilder", p) for p in range(4)] == \
            [2, 2, 2, 2]
    finally:
        for app in apps:
            app.shutdown()
        srv.shutdown()
