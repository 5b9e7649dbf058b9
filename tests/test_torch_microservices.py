"""Per-target Apps of the port over HTTP RPC, against the reference's.

Mirrors `tests/test_microservices.py`'s 5 tests on the CPU: distributor,
ingester, metrics-generator and query tier run as separate port Apps
(`device="cpu"`, in-process servers), joined by static peers or by the
ring KV, sharing only the object store. The same scenario runs on a
cluster of reference Apps, and what each cluster answers (the trace by
id, the search, the metrics, which replicas hold a trace, the ring's
healthy members) is compared.

The ring scenarios keep the reference's 0.2 s heartbeat and 1.5 s
timeout. Each cluster stops its Apps before their servers and closes
every listening socket (a dead process's port refuses at once), so a
scenario runs in seconds where the reference's waits out its peers'
timeouts.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import urllib.request

import pytest

from tests.test_torch_app import free_port, _reset_port
from tests.test_torch_frontend import mod

SIDES = ("port", "ref")
HEARTBEAT_S, TIMEOUT_S = 0.2, 1.5



def _post(url, body, ctype="application/json"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read() or b"{}")


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read() or b"{}")


class Cluster:
    """Apps of one package, each serving HTTP; stopped together."""

    def __init__(self, side, tmp_path, t0):
        self.side, self.tmp, self.t0 = side, tmp_path / side, t0
        self.store = str(self.tmp / "store")
        self.apps, self.servers = {}, {}

    def cfg(self, target, **kw):
        cfg = mod(self.side, "app.config").Config(target=target)
        if target != "distributor":
            cfg.storage.backend = "local"
            cfg.storage.local_path = self.store
        for k, v in kw.items():
            setattr(cfg, k, v)
        return cfg

    def boot(self, name, cfg, port=None, processors=("span-metrics",)):
        cfg.server.http_listen_port = port or free_port()
        App = mod(self.side, "app").App
        app = App(cfg, device="cpu") if self.side == "port" else App(cfg)
        app.overrides.set_tenant_patch("single-tenant", {
            "generator": {"processors": list(processors)}})
        app.start_loops()
        self.apps[name] = app
        self.servers[name] = mod(self.side, "app.api").serve(app, block=False)
        return self.url(name)

    def url(self, name):
        return f"http://127.0.0.1:{self.apps[name].cfg.server.http_listen_port}"

    def kill(self, name):
        """An abrupt death: the server and loops stop, no ring leave; the
        listening socket closes, as a dead process's does (peers are
        refused at once instead of waiting out their timeouts)."""
        victim = self.apps.pop(name)
        srv = self.servers.pop(name)
        srv.shutdown()
        srv.server_close()
        victim._stop.set()
        for lc in victim._lifecyclers:
            lc.stop_heartbeat()
        return victim

    def close(self):
        # the Apps first, newest first, while every server (and so every
        # ring KV member) still answers their ring leaves; then the
        # servers together (each takes up to its 0.5 s poll to stop)
        for name in reversed(list(self.apps)):
            self.apps[name].shutdown()
        stops = [threading.Thread(target=srv.shutdown)
                 for srv in self.servers.values()]
        for t in stops:
            t.start()
        for t in stops:
            t.join()
        for srv in self.servers.values():
            srv.server_close()
        if self.side == "port":
            _reset_port()


def _clusters(tmp_path, scenario):
    """The scenario on a cluster of each package, with one span clock."""
    got = {}
    t0 = int((time.time() - 5) * 1e9)
    for side in SIDES:
        c = Cluster(side, tmp_path, t0)
        try:
            got[side] = scenario(c)
        finally:
            c.close()
    return got


def _static(c):
    """distributor + ingester + generator + query tier over static
    `http://` peers (the reference's `cluster` fixture)."""
    ing = c.cfg("ingester")
    ing.storage.wal_path = str(c.tmp / "ing" / "wal")
    ing.ingester.instance.trace_idle_s = 0.1
    lb = ("span-metrics", "local-blocks")
    c.boot("ing", ing, processors=lb)
    gen = c.cfg("metrics-generator")
    gen.generator.localblocks.data_dir = str(c.tmp / "gen-lb")
    c.boot("gen", gen, processors=lb)
    peers = ({"ing-1": c.url("ing")}, {"gen-1": c.url("gen")})
    q = c.cfg("query-frontend")
    q.peers.ingesters, q.peers.generators = peers
    c.boot("query", q, processors=lb)
    d = c.cfg("distributor")
    d.peers.ingesters, d.peers.generators = peers
    c.boot("dist", d, processors=lb)


def _write_read(c):
    _static(c)
    t0 = c.t0
    otlp = {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": "micro"}}]},
        "scopeSpans": [{"spans": [{
            "traceId": "ee" * 16, "spanId": "bb" * 8, "name": "ms-op",
            "kind": 2, "startTimeUnixNano": str(t0),
            "endTimeUnixNano": str(t0 + 40_000_000),
            "status": {"code": 0}}]}]}]}
    code, _ = _post(c.url("dist") + "/v1/traces", json.dumps(otlp).encode())
    assert code == 200
    assert c.apps["ing"].ingester.instance("single-tenant").live
    received = c.apps["gen"].generator.instance(
        "single-tenant").spans_received
    q = c.url("query")
    _, tr = _get(q + f"/api/traces/{'ee' * 16}")
    _, res = _get(q + "/api/search?q=" + urllib.parse.quote(
        '{ resource.service.name = "micro" }'))
    now = time.time()
    _, qr = _get(q + "/api/metrics/query_range?q=" +
                 urllib.parse.quote("{ } | count_over_time()") +
                 f"&start={now - 300}&end={now}&step=300")
    total = sum(d["value"] for s in qr["series"]
                for d in s.get("samples", []) if d["value"] == d["value"])
    code, tags = _get(q + "/api/search/tags")
    assert code == 200
    return (received, tr["spans"], res["traces"], total,
            sorted(tags["tagNames"]))


def test_microservices_write_read(tmp_path):
    """Write through the distributor App; the ingester App holds the live
    trace, the generator App aggregated it, and the query tier answers
    trace by id, search, metrics and tags through the remote clients;
    the same answers as the reference's cluster."""
    got = _clusters(tmp_path, _write_read)
    assert got["port"] == got["ref"]
    received, spans, traces, total, _ = got["port"]
    assert received == 1 and spans[0]["name"] == "ms-op"
    assert len(traces) == 1 and total == 1


def _flush(c):
    _static(c)
    t0 = c.t0
    otlp = {"resourceSpans": [{"scopeSpans": [{"spans": [{
        "traceId": "dd" * 16, "spanId": "aa" * 8, "name": "flushed",
        "startTimeUnixNano": str(t0),
        "endTimeUnixNano": str(t0 + 10_000_000)}]}]}]}
    _post(c.url("dist") + "/v1/traces", json.dumps(otlp).encode())
    time.sleep(0.2)
    c.apps["ing"].ingester.flush_all()
    db = c.apps["query"].db
    db.poll_now()
    spans = db.find_trace_by_id("single-tenant", b"\xdd" * 16)
    return [(s["name"], s["span_id"], s["start_unix_nano"]) for s in spans], \
        len(db.blocklist.metas("single-tenant"))


def test_microservices_flush_to_shared_store(tmp_path):
    """The ingester App flushes to the shared store and the query tier
    finds the trace in the backend, as the reference's cluster does."""
    got = _clusters(tmp_path, _flush)
    assert got["port"] == got["ref"]
    assert got["port"][0][0][0] == "flushed" and got["port"][1] == 1


def _ring_cfg(c, target, kv_url):
    cfg = c.cfg(target, ring_kv_url=kv_url, heartbeat_interval_s=HEARTBEAT_S,
                heartbeat_timeout_s=TIMEOUT_S)
    return cfg


def _ingester_cfg(c, i, kv_url):
    cfg = _ring_cfg(c, "ingester", kv_url)
    cfg.storage.wal_path = str(c.tmp / f"ing{i}" / "wal")
    cfg.ingester.instance.trace_idle_s = 0.1
    return cfg


def _wait(pred, timeout_s=8.0):
    deadline = time.time() + timeout_s
    while not pred() and time.time() < deadline:
        time.sleep(0.05)
    return pred()


def _push(c, tid_hex, svc):
    t0 = c.t0
    otlp = {"resourceSpans": [{"resource": {"attributes": [
        {"key": "service.name", "value": {"stringValue": svc}}]},
        "scopeSpans": [{"spans": [{
            "traceId": tid_hex, "spanId": "ab" * 8, "name": f"{svc}-op",
            "kind": 2, "startTimeUnixNano": str(t0),
            "endTimeUnixNano": str(t0 + 10_000_000)}]}]}]}
    return _post(c.url("dist") + "/v1/traces", json.dumps(otlp).encode())[0]


def _held(c, names, tid):
    return sorted(n for n in names if c.apps[n].ingester.find_trace_by_id(
        "single-tenant", tid))


def _ring_death(c):
    d = _ring_cfg(c, "distributor", "local")
    d.distributor.rf = 3
    kv_url = c.boot("dist", d)
    for i in range(3):
        c.boot(f"ing{i}", _ingester_cfg(c, i, kv_url))
    q = _ring_cfg(c, "query-frontend", kv_url)
    q.querier.rf = 3
    c.boot("query", q)
    ring = c.apps["dist"].distributor.ingester_ring
    assert _wait(lambda: len(ring) >= 3)
    out = [_push(c, "11" * 16, "rk"),
           _held(c, ("ing0", "ing1", "ing2"), b"\x11" * 16)]
    out.append(_get(c.url("query") + f"/api/traces/{'11' * 16}")[1]["spans"])
    victim = c.kill("ing1")
    out += [_push(c, "22" * 16, "rk"),
            _held(c, ("ing0", "ing2"), b"\x22" * 16),
            _get(c.url("query") + f"/api/traces/{'22' * 16}")[1]["spans"]]
    qring = c.apps["query"].querier.ring
    dead = victim._iid("ingester")
    assert _wait(lambda: len(qring.healthy_instances()) == 2)
    healthy = {i.id for i in qring.healthy_instances()}
    _, res = _get(c.url("query") + "/api/search?q=" + urllib.parse.quote(
        '{ resource.service.name = "rk" }'))
    out += [len(healthy), dead in healthy,
            sorted(t["traceID"] for t in res["traces"])]
    return out


def test_ring_kv_cluster_survives_ingester_death(tmp_path):
    """Three ingesters, a distributor hosting the ring KV and a query tier
    at RF3: every replica holds a write; after one ingester dies without
    leaving, writes (quorum 2 of 3) and reads still succeed and the ring
    drops it after the heartbeat timeout; as in the reference's cluster."""
    got = _clusters(tmp_path, _ring_death)
    assert got["port"] == got["ref"]
    out = got["port"]
    assert out[0] == 200 and out[1] == ["ing0", "ing1", "ing2"]
    assert out[3] == 200 and out[4] == ["ing0", "ing2"]
    assert out[5][0]["name"] == "rk-op"
    assert out[6] == 2 and out[7] is False and len(out[8]) >= 1


def _kv_host_death(c):
    ports = [free_port() for _ in range(3)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    kv_all = ",".join(urls)
    for i in range(3):
        members = ["local" if j == i else urls[j] for j in range(3)]
        c.boot(f"ing{i}", _ingester_cfg(c, i, ",".join(members)),
               port=ports[i])
    d = _ring_cfg(c, "distributor", kv_all)
    d.distributor.rf = 3
    c.boot("dist", d)
    q = _ring_cfg(c, "query-frontend", kv_all)
    q.querier.rf = 3
    c.boot("query", q)
    ring = c.apps["dist"].distributor.ingester_ring
    assert _wait(lambda: len(ring) >= 3)
    out = [_push(c, "31" * 16, "rkv"),
           _held(c, ("ing0", "ing1", "ing2"), b"\x31" * 16)]
    c.kill("ing1")
    out += [_push(c, "32" * 16, "rkv"),
            _held(c, ("ing0", "ing2"), b"\x32" * 16),
            _get(c.url("query") + f"/api/traces/{'32' * 16}")[1]["spans"]]
    qring = c.apps["query"].querier.ring
    assert _wait(lambda: len(qring.healthy_instances()) == 2)
    out.append(len(qring.healthy_instances()))
    c.boot("ing3", _ingester_cfg(c, 3, kv_all))
    assert _wait(lambda: len(qring.healthy_instances()) >= 3)
    out += [len(qring.healthy_instances()), _push(c, "33" * 16, "rkv")]
    return out


def test_replicated_kv_survives_kv_host_death(tmp_path):
    """The ring KV replicated over the three ingesters: one of them (a KV
    member and a replica) dies; writes, reads and ring convergence go on
    and a new ingester joins through the surviving members; as in the
    reference's cluster."""
    got = _clusters(tmp_path, _kv_host_death)
    assert got["port"] == got["ref"]
    out = got["port"]
    assert out[0] == 200 and out[1] == ["ing0", "ing1", "ing2"]
    assert out[2] == 200 and out[3] == ["ing0", "ing2"]
    assert out[4][0]["name"] == "rkv-op"
    assert out[5:] == [2, 3, 200]


def _fanout(c):
    lb = ("span-metrics", "local-blocks")

    def all_cfg(name, kv_url):
        cfg = c.cfg("all", ring_kv_url=kv_url,
                    heartbeat_interval_s=HEARTBEAT_S, heartbeat_timeout_s=5.0)
        cfg.storage.wal_path = str(c.tmp / name / "wal")
        cfg.generator.localblocks.data_dir = str(c.tmp / name / "lb")
        return cfg

    kv_url = c.boot("a", all_cfg("a", "local"), processors=lb)
    c.boot("b", all_cfg("b", kv_url), processors=lb)
    assert _wait(lambda: all(len(c.apps[n].distributor.generator_ring) >= 2
                             for n in ("a", "b")))
    t0 = c.t0
    spans = [{"traceId": ("%02x" % i) * 16, "spanId": "ab" * 8,
              "name": "fan-op", "kind": 2, "startTimeUnixNano": str(t0),
              "endTimeUnixNano": str(t0 + 10_000_000)} for i in range(1, 41)]
    otlp = {"resourceSpans": [{"resource": {"attributes": [
        {"key": "service.name", "value": {"stringValue": "fan"}}]},
        "scopeSpans": [{"spans": spans}]}]}
    code, _ = _post(c.url("a") + "/v1/traces", json.dumps(otlp).encode())
    got = [c.apps[n].generator.instance("single-tenant").spans_received
           for n in ("a", "b")]
    now = time.time()
    totals = []
    for n in ("a", "b"):
        _, qr = _get(c.url(n) + "/api/metrics/query_range?q=" +
                     urllib.parse.quote("{ } | count_over_time()") +
                     f"&start={now - 300}&end={now}&step=300")
        totals.append(sum(d["value"] for s in qr["series"]
                          for d in s.get("samples", [])
                          if d["value"] == d["value"]))
    return code, sum(got), all(g > 0 for g in got), totals


def test_scaled_monolith_generator_fanout(tmp_path):
    """Two `all` Apps on one ring KV: the distributor spreads generator
    spans over both, and each frontend fans out over the whole generator
    ring to see all 40; as in the reference's cluster."""
    got = _clusters(tmp_path, _fanout)
    assert got["port"] == got["ref"] == (200, 40, True, [40, 40])
