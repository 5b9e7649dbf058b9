"""The port's observability substrate against the reference's.

Mirrors the 14 tests of `tests/test_obs.py` that need no self-tracing
(its two self-tracing tests are in `test_torch_selftrace.py`) on the
CPU. `test_torch_sched.py:680-736` already holds the byte-for-byte render
of one mixed registry and the scheduler's families; here each family
semantic (counters and gauges, get-or-create, escaping, cumulative
buckets and exemplars, func families and a failing collector, the
disabled registry, the parser's refusals, route templates, the queue
wait at claim, concurrent record and scrape) runs on both packages'
`obs` and the renders, parses and errors are compared. The live-process
tests (the `/metrics` round trip, `/usage_metrics`, the drift gate and
the bail-cause gate, with their negative cases) run on a port App and
compare the family names and types with a reference App's after the
same traffic; the names only one side has are listed with their reason
(`test_torch_app.py`'s `REF_ONLY` / `PORT_ONLY`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import urllib.parse
import urllib.request

import pytest

from tests.test_torch_app import free_port, PORT_ONLY, REF_ONLY, _reset_port
from tests.test_torch_frontend import PKG, mod

SIDES = ("port", "ref")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = os.path.join(ROOT, "operations")


def _on_both(fn):
    got = {side: fn(mod(side, "obs")) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


def test_counter_gauge_render_with_help_type():
    def run(obs):
        reg = obs.Registry()
        c = reg.counter("tempo_t_things_total", "things processed",
                        labels=("reason",))
        c.inc(2, ("full",))
        c.inc(labels=("full",))
        reg.gauge("tempo_t_depth", "queue depth").set(4.5)
        text = reg.render()
        return text, obs.parse_exposition(text)

    text, fams = _on_both(run)
    assert "# HELP tempo_t_things_total things processed" in text
    assert 'tempo_t_things_total{reason="full"} 3' in text
    assert "tempo_t_depth 4.5" in text
    key = ("tempo_t_things_total", (("reason", "full"),))
    assert fams["tempo_t_things_total"]["samples"][key] == 3.0


def test_get_or_create_identity_and_mismatch():
    def run(obs):
        reg = obs.Registry()
        a = reg.counter("tempo_t_total", "h", labels=("x",))
        out = [reg.counter("tempo_t_total", labels=("x",)) is a]
        out += [_raises(lambda: reg.gauge("tempo_t_total", labels=("x",))),
                _raises(lambda: reg.counter("tempo_t_total", labels=("y",))),
                _raises(lambda: a.inc(1, ())),
                _raises(lambda: reg.counter("tempo bad name"))]
        reg.counter_func("tempo_t_cb_total", lambda: [((), 1)])
        out.append(_raises(lambda: reg.counter_func(
            "tempo_t_cb_total", lambda: [((), 2)])))
        return out

    out = _on_both(run)
    assert out[0] is True and all(o.startswith("ValueError") for o in out[1:])


def test_label_escaping_centralized_roundtrip():
    evil = 'a"} 9\ninjected{x="y'

    def run(obs):
        reg = obs.Registry()
        reg.counter("tempo_t_total", "h", labels=("tenant",)).inc(1, (evil,))
        text = reg.render()
        return obs.escape_label(evil), text, obs.parse_exposition(text)

    esc, text, fams = _on_both(run)
    assert "\\n" in esc and '\\"' in esc
    (name, labels), v = next(iter(fams["tempo_t_total"]["samples"].items()))
    assert v == 1.0 and "injected" in dict(labels)["tenant"]


def test_histogram_cumulative_buckets_and_exemplar():
    def run(obs):
        reg = obs.Registry()
        h = reg.histogram("tempo_t_seconds", "latency", labels=("op",),
                          buckets=obs.exponential_buckets(0.001, 2.0, 4))
        for v in (0.0005, 0.003, 99.0):
            h.observe(v, ("read",))
        h.observe(0.1, ("read",), trace_id="ab" * 16)
        snap = h.snapshot(("read",))
        return (snap["count"], snap["exemplar"][0], h.exemplar(("write",)),
                obs.parse_exposition(reg.render()),
                "tempo_t_seconds_bucket" in reg.metric_names())

    count, ex, none, fams, named = _on_both(run)
    assert count == 4 and ex == "ab" * 16 and none is None and named
    inf_key = ("tempo_t_seconds_bucket",
               tuple(sorted((("op", "read"), ("le", "+Inf")))))
    assert fams["tempo_t_seconds"]["samples"][inf_key] == 4.0


def test_func_families_and_failing_collector():
    def run(obs):
        state = {"hits": 3}
        reg = obs.Registry()
        reg.counter_func("tempo_t_hits_total", lambda: [((), state["hits"])],
                         help="hits")
        reg.gauge_func("tempo_t_broken",
                       lambda: (_ for _ in ()).throw(RuntimeError("boom")),
                       help="always fails")
        first = reg.render()
        obs.parse_exposition(first)
        state["hits"] = 7
        return first, reg.render()

    first, second = _on_both(run)
    assert "tempo_t_hits_total 3" in first
    assert "# TYPE tempo_t_broken gauge" in first
    assert "tempo_t_hits_total 7" in second


def test_disabled_registry_is_noop():
    def run(obs):
        reg = obs.Registry(enabled=False)
        c = reg.counter("tempo_t_total", "h")
        h = reg.histogram("tempo_t_seconds", "h")
        c.inc()
        h.observe(1.0)
        reg.counter_func("tempo_t_cb_total", lambda: [((), 1)])
        return c.value(), h.snapshot(), reg.render(), reg.metric_names()

    assert _on_both(run) == (0.0, None, "", set())


def test_parser_rejects_nonconformant_text():
    cases = ["tempo_x_total 1\n",
             "# TYPE tempo_x_total counter\ntempo_x_total 1\ntempo_x_total 2\n",
             '# TYPE tempo_x_total counter\ntempo_x_total{tenant="a} 1\n',
             '# TYPE tempo_h histogram\ntempo_h_bucket{le="0.1"} 5\n'
             'tempo_h_bucket{le="+Inf"} 3\ntempo_h_count 3\n']

    def run(obs):
        return [_raises(lambda t=t: obs.parse_exposition(t)) for t in cases]

    errs = _on_both(run)
    for err, want in zip(errs, ("no TYPE", "duplicate series", "malformed",
                                "not cumulative")):
        assert want in err


def test_route_template_bounds_label_cardinality():
    paths = ["/v1/traces", "/api/traces/abcd1234",
             "/api/v2/search/tag/x/values", "/kv/collectors/i-12",
             "/internal/ingester/push", "/internal/ingester/zzz9",
             "/internal/x/y/z/w", "/wp-admin/setup.php"]
    got = {side: [mod(side, "app.api")._route_of(p) for p in paths]
           for side in SIDES}
    assert got["port"] == got["ref"]
    assert got["port"] == ["/v1/traces", "/api/traces/{id}",
                           "/api/v2/search/tag/{name}/values", "/kv/{key}",
                           "/internal/ingester/push", "/internal/other",
                           "/internal/other", "other"]


def test_queue_wait_observed_at_claim_exactly_once():
    def run(obs):
        side = "port" if obs.__name__.startswith("tempo_tpu_torch") else "ref"
        Job = mod(side, "frontend.frontend")._Job
        reg = obs.Registry()
        h = reg.histogram("tempo_t_wait_seconds", "w")
        wj = Job(job=None, fn=lambda j: None, spec={"kind": "x"})
        wj.enqueued_at = time.perf_counter()
        wj.queue_wait = h
        claims = [wj.try_claim(), wj.try_claim()]
        n1 = h.snapshot(())["count"]
        wj2 = Job(job=None, fn=lambda j: None)
        wj2.run()
        return claims, n1, h.snapshot(())["count"]

    assert _on_both(run) == ([True, False], 1, 1)


def test_concurrent_record_and_scrape_conformant():
    """Four writers (counter, gauge, histogram and the device-time
    ledger) race the port's renders for a second: every render parses
    (with both packages' parsers) and the ledger's tenant split holds."""
    from tempo_tpu.obs import parse_exposition as jparse
    from tempo_tpu_torch.obs import Registry, devtime, parse_exposition

    reg = Registry()
    c = reg.counter("tempo_t_race_total", "r", labels=("k",))
    g = reg.gauge("tempo_t_race_depth", "r", labels=("k",))
    h = reg.histogram("tempo_t_race_seconds", "r", labels=("k",),
                      buckets=(0.1, 1.0, 10.0))
    led = devtime.DeviceTimeLedger()
    reg.counter_func("tempo_t_race_ledger_seconds_total",
                     lambda: [(k, v / 1e9) for k, v in led._rows("wall_ns")],
                     labels=("kernel", "bucket", "class", "shard"))
    stop = threading.Event()
    errors = []

    def writer(i):
        n = 0
        while not stop.is_set():
            n += 1
            label = (f"k{n % 17}",)
            try:
                c.inc(1, label)
                g.set(n, label)
                h.observe(n % 13 / 3.0, label)
                led.record_batch(kernel=f"k{n % 17}", bucket=64 << (n % 3),
                                 prio=n % 3, shards=n % 2, wall_ns=1000,
                                 rows=10, padded_rows=3, queue_wait_ns=5,
                                 h2d_bytes=80,
                                 tenant_rows={f"t{i}": 7, "s": 3})
            except Exception as e:  # noqa: BLE001 — recorded
                errors.append(e)
                return

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    renders = 0
    try:
        deadline = time.time() + 1.0
        while time.time() < deadline:
            text = reg.render()
            parse_exposition(text)
            jparse(text)
            renders += 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert not errors and renders > 10
    total = led.total_device_ns()
    assert total > 0
    assert abs(total - sum(led.tenant_device_ns().values())) <= total * 0.05


# -- live processes: /metrics, /usage_metrics, the drift and bail gates ------


def _push_one_trace(base: str, t0: int) -> None:
    otlp = {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": "shop"}}]},
        "scopeSpans": [{"spans": [{
            "traceId": "ab" * 16, "spanId": "cd" * 8, "name": "obs-op",
            "startTimeUnixNano": str(t0),
            "endTimeUnixNano": str(t0 + 1_000_000)}]}]}]}
    urllib.request.urlopen(urllib.request.Request(
        f"{base}/v1/traces", data=json.dumps(otlp).encode(),
        headers={"Content-Type": "application/json"}), timeout=10).close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A port App and a reference App, each serving HTTP, each sent the
    same trace, a query and a collection and compaction pass."""
    _reset_port()
    out = {}
    t0 = int((time.time() - 3) * 1e9)
    for side in SIDES:
        tmp = tmp_path_factory.mktemp(f"obs-{side}")
        cfg = mod(side, "app.config").Config(target="all")
        cfg.storage.backend = "mem"
        cfg.storage.wal_path = str(tmp / "wal")
        cfg.generator.localblocks.data_dir = str(tmp / "lb")
        cfg.server.http_listen_port = free_port()
        App = mod(side, "app").App
        app = App(cfg, device="cpu") if side == "port" else App(cfg)
        app.overrides.set_tenant_patch("single-tenant", {
            "generator": {"processors": ["span-metrics", "local-blocks"]}})
        app.start_loops()
        srv = mod(side, "app.api").serve(app, block=False)
        base = f"http://127.0.0.1:{cfg.server.http_listen_port}"
        _push_one_trace(base, t0)
        now = time.time()
        with urllib.request.urlopen(
                f"{base}/api/metrics/query_range?q=" +
                urllib.parse.quote("{ } | rate()") +
                f"&start={now - 300}&end={now}&step=300", timeout=10) as r:
            assert r.status == 200
        app.ingester.sweep_all()
        app.generator.collect_all()
        app.db.compact_tenant_once("single-tenant")
        out[side] = (app, srv, base)
    yield out
    for app, srv, _ in out.values():
        srv.shutdown()
        app.shutdown()
    _reset_port()


def _scrape(base, path="/metrics"):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return r.headers["Content-Type"], r.read().decode()


def test_metrics_exposition_roundtrip(servers):
    """`/metrics` parses with both packages' parsers; the duration
    histograms of every layer are there after traffic; the family names
    and types equal the reference's, less `REF_ONLY` and `PORT_ONLY`."""
    from tempo_tpu.obs import parse_exposition as jparse
    from tempo_tpu_torch.obs import parse_exposition

    fams = {}
    for side in SIDES:
        ctype, text = _scrape(servers[side][2])
        assert ctype.startswith("text/plain")
        fams[side] = parse_exposition(text)
        assert jparse(text).keys() == fams[side].keys()
    port, ref = fams["port"], fams["ref"]
    histograms = {n for n, f in port.items() if f["type"] == "histogram"}
    for name in ("tempo_request_duration_seconds",
                 "tempo_grpc_request_duration_seconds",
                 "tempo_distributor_push_duration_seconds",
                 "tempo_ingester_cut_duration_seconds",
                 "tempo_ingester_flush_duration_seconds",
                 "tempo_query_frontend_request_duration_seconds",
                 "tempo_query_frontend_queue_wait_seconds",
                 "tempo_querier_block_scan_duration_seconds",
                 "tempo_compactor_cycle_duration_seconds",
                 "tempo_metrics_generator_collect_duration_seconds",
                 "tempo_jax_kernel_duration_seconds"):
        assert name in histograms, name
    assert set(ref) - set(port) <= REF_ONLY
    assert set(port) - set(ref) == PORT_ONLY
    for n in set(port) & set(ref):
        assert port[n]["type"] == ref[n]["type"], n
    assert port["tempo_distributor_spans_received_total"]["help"]
    dur = port["tempo_request_duration_seconds"]["samples"]
    assert any(n == "tempo_request_duration_seconds_count" and v > 0
               for (n, _l), v in dur.items())


def test_usage_metrics_share_exposition_writer(servers):
    """`/usage_metrics` renders through the same writer, with the same
    families and values as the reference's after the same push."""
    from tempo_tpu_torch.obs import parse_exposition

    got = {side: parse_exposition(_scrape(servers[side][2],
                                          "/usage_metrics")[1])
           for side in SIDES}
    assert got["port"] == got["ref"]
    fam = got["port"]["tempo_usage_tracker_bytes_received_total"]
    assert fam["type"] == "counter" and sum(fam["samples"].values()) > 0


def test_ops_metric_names_registered(servers, tmp_path):
    """The drift gate on the port's registries: every name the alerts and
    dashboards reference is registered but the jit-compile names the port
    does not have (`REF_ONLY`); a made-up name is caught, and histogram
    suffixes resolve; the same verdicts as the reference's gate."""
    got = {}
    for side in SIDES:
        drift = mod(side, "obs.drift")
        runtime = mod(side, "obs.runtime" if side == "port"
                      else "obs.jaxruntime").RUNTIME
        regs = [servers[side][0].obs, runtime]
        refs = drift.referenced_metric_names(OPS)
        bogus = tmp_path / side
        bogus.mkdir()
        (bogus / "alerts.yaml").write_text(
            "expr: rate(tempo_nonexistent_total[5m]) > 0\n")
        neg = drift.check_drift(str(bogus), regs)
        (bogus / "alerts.yaml").write_text(
            "expr: rate(tempo_request_duration_seconds_bucket[5m])\n")
        got[side] = (refs, neg, drift.check_drift(str(bogus), regs),
                     drift.check_drift(OPS, regs))
    assert got["port"][:3] == got["ref"][:3]
    refs, neg, hist, live = got["port"]
    assert "tempo_distributor_push_failures_total" in refs
    assert len(neg) == 1 and "tempo_nonexistent_total" in neg[0]
    assert hist == [] and got["ref"][3] == []
    assert {p.split()[0] for p in live} <= REF_ONLY


def test_bail_causes_documented(tmp_path):
    """The fallback-cause gate over the port's `block/device_scan.py`:
    documented today, and a runbook copy missing one cause is caught, as
    the reference's gate catches it over its own."""
    got = {}
    for side in SIDES:
        drift = mod(side, "obs.drift")
        ok = drift.check_bail_causes(OPS)
        repo2 = tmp_path / side
        (repo2 / "operations").mkdir(parents=True)
        (repo2 / PKG[side] / "block").mkdir(parents=True)
        shutil.copy(os.path.join(ROOT, PKG[side], "block", "device_scan.py"),
                    repo2 / PKG[side] / "block" / "device_scan.py")
        with open(os.path.join(OPS, "runbook.md")) as f:
            runbook = f.read()
        (repo2 / "operations" / "runbook.md").write_text(
            runbook.replace("| `grid_size` |", "| `gridsize_typo` |"))
        got[side] = (ok, drift.check_bail_causes(str(repo2 / "operations")))
    assert got["port"] == got["ref"]
    ok, problems = got["port"]
    assert ok == [] and len(problems) == 1 and "grid_size" in problems[0]
