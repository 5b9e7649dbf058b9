"""The port's query frontend (`tempo_tpu_torch.frontend`) against the
reference's, over the port's querier and TempoDB.

Each fixture builds the same stack in both packages from the same inputs
(`Stack`): backend blocks written by each package's own writer into its
own `MemBackend` under fixed block ids, an ingester with live traces on
a ring, a `Querier` and a `Frontend` under one fake clock. The port runs
on the CPU (`device="cpu"`). Held equal between the packages:

- `tests/test_read_path.py`: search over recent and backend data (trace
  ids and metadata, in order), filters, the early-exit limit, find over
  ingester and backend, `query_range` rate (counts exact) and log2-tier
  quantiles (equal), the worker pool, the queue, sharders and SLOs;
- `tests/test_frontend_features.py`: the job cache (hits, the query in
  the key, the worker path), multi-tenant federation of search, find
  and tags, and the rejection of multi-tenant metrics;
- `tests/test_query_stats.py`: one "query complete" line per request
  with the reference's JSON keys, the qlog sampling and rate-limit
  decisions, `LatencySketch` quantiles, the tenant read-cost counters;
- `obs/queryfp.py` over every query string of `tests/test_traceql.py`
  and `tests/test_engine.py`;
- the backend cutoff: the frontend's series equal `TempoDB.query_range`
  clipped at the cutoff after `SeriesCombiner.final`;
- `tests/test_sched.py:411`: a saturated query class sheds requests with
  `QueryBackpressure`, counted per op.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import json
import logging
import pathlib
import uuid

import numpy as np
import pytest
import torch

from tempo_tpu_torch import sched as tsched

T0 = 1_700_000_000.0
PKG = {"ref": "tempo_tpu", "port": "tempo_tpu_torch"}


def mod(side: str, path: str):
    return importlib.import_module(f"{PKG[side]}.{path}")


def mkspan(tid, sid, name="op", svc="svc", t0_s=T0, dur_ms=50, **kw):
    t0 = int(t0_s * 1e9)
    return {"trace_id": tid, "span_id": sid, "name": name, "service": svc,
            "start_unix_nano": t0, "end_unix_nano": t0 + int(dur_ms * 1e6),
            **kw}


def block_id(i: int) -> str:
    return str(uuid.UUID(int=i + 1))


def make_db(side: str, be, now, **cfg):
    tdb = mod(side, "db.tempodb")
    kw = {"device": "cpu"} if side == "port" else {}
    return tdb.TempoDB(be, be, tdb.TempoDBConfig(**cfg), now=now, **kw)


@pytest.fixture(autouse=True)
def _singletons():
    """The port's process scheduler is process-wide: reset around each
    test (the reference's is reset by tests/conftest.py)."""
    tsched.reset()
    yield
    tsched.reset()


class Stack:
    """`tests/test_read_path.py`'s stack in one package: 2 RF1 backend
    blocks written an hour ago and one ingester with a live trace."""

    def __init__(self, side: str, tmp_path, clock_s: float = T0 + 3600.0,
                 fe_cfg: dict | None = None, db_cfg: dict | None = None,
                 blocks=None, ingester: bool = True, cache: bool = False,
                 tenant: str = "t1"):
        self.side = side
        self.clock = [clock_s]
        self.now = now = lambda: self.clock[0]
        self.be = mod(side, "backend.mem").MemBackend()
        self.db = make_db(side, self.be, now, **(db_cfg or {}))
        blocks = blocks if blocks is not None else default_blocks()
        for i, (t, traces) in enumerate(blocks):
            self.db.write_block(t, traces, block_id=block_id(i),
                                replication_factor=1)
        self.db.poll_now()
        ring_m = mod(side, "ring")
        self.ring = ring_m.Ring(replication_factor=1, now=now)
        clients = {}
        self.ing = None
        if ingester:
            ing_m = mod(side, "ingester")
            self.ing = ing_m.Ingester(
                str(tmp_path / side / "ing"), flush_writer=self.be,
                cfg=ing_m.IngesterConfig(
                    instance=mod(side, "ingester.instance").InstanceConfig()),
                now=now, instance_id="ing-0")
            self.ring.register(ring_m.InstanceDesc(
                id="ing-0", state=ring_m.ACTIVE,
                tokens=mod(side, "ring.ring")._instance_tokens("ing-0", 64),
                heartbeat_ts=now()))
            self.rid = b"\xaa" * 16
            self.ing.push(tenant, [(self.rid, [mkspan(
                self.rid, b"\x01" * 8, svc="recent-svc",
                t0_s=now() - 10)])])
            clients["ing-0"] = self.ing
        qm = mod(side, "querier.querier")
        self.q = CountingQuerier.of(side)(self.db, self.ring, clients,
                                          cfg=qm.QuerierConfig(rf=1))
        fm = mod(side, "frontend")
        slo = mod(side, "frontend.slos")
        cfg = dict(target_bytes_per_job=1,
                   slo={"search": slo.SLOConfig(duration_slo_s=60.0)})
        cfg.update(fe_cfg or {})
        provider = (mod(side, "backend.cache").CacheProvider()
                    if cache else None)
        self.fe = fm.Frontend(self.db, self.q, cfg=fm.FrontendConfig(**cfg),
                              cache_provider=provider, now=now)

    def close(self):
        self.fe.shutdown()
        self.db.shutdown()


_COUNTING = {}


class CountingQuerier:
    """`tests/test_frontend_features.py`'s counting querier, per package."""

    @staticmethod
    def of(side: str):
        if side not in _COUNTING:
            base = mod(side, "querier").Querier

            class Counting(base):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    self.search_block_calls = 0
                    self.query_range_calls = 0

                def search_block(self, *a, **kw):
                    self.search_block_calls += 1
                    return super().search_block(*a, **kw)

                def query_range_block(self, *a, **kw):
                    self.query_range_calls += 1
                    return super().query_range_block(*a, **kw)

            _COUNTING[side] = Counting
        return _COUNTING[side]


def default_blocks():
    out = []
    for blk in range(2):
        traces = []
        for i in range(1, 6):
            tid = bytes([blk * 16 + i]) * 16
            traces.append((tid, [mkspan(tid, bytes([i]) * 8,
                                        svc=f"svc-{blk}", t0_s=T0 + i)]))
        out.append(("t1", traces))
    return out


def tenant_blocks():
    """`tests/test_frontend_features.py`'s rig: two tenants, 8 traces
    each plus one trace id shared by both."""
    out = []
    for base, (tenant, svc) in enumerate(
            (("acme", "acme-svc"), ("globex", "globex-svc"))):
        traces = []
        for i in range(1, 9):
            tid = bytes([base * 100 + i]) * 16
            traces.append((tid, [mkspan(tid, bytes([i]) * 8, svc=svc,
                                        t0_s=T0 + i)]))
        shared = bytes([250]) * 16
        traces.append((shared, [mkspan(shared, bytes([base + 1]) * 8,
                                       svc=svc, t0_s=T0)]))
        out.append((tenant, traces))
    return out


@pytest.fixture
def pair(tmp_path, request):
    kw = getattr(request, "param", {})
    p, r = Stack("port", tmp_path, **kw), Stack("ref", tmp_path, **kw)
    yield p, r
    p.close()
    r.close()


def md_json(res):
    return [m.to_json() for m in res]


def series_map(series):
    return {tuple(s.labels): np.asarray(s.samples, np.float64)
            for s in series}


def assert_series(a, b, exact: bool):
    ma, mb = series_map(a), series_map(b)
    assert set(ma) == set(mb)
    for k in mb:
        if exact:
            np.testing.assert_array_equal(ma[k], mb[k], err_msg=str(k))
        else:
            np.testing.assert_allclose(ma[k], mb[k], rtol=1e-6,
                                       err_msg=str(k))


# ---------------------------------------------------------------------------
# defaults and devices
# ---------------------------------------------------------------------------

def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_default_configs_match_reference():
    for path, name in (("frontend", "FrontendConfig"),
                       ("querier", "QuerierConfig"),
                       ("frontend.slos", "SLOConfig")):
        t = _fields(getattr(mod("port", path), name)())
        j = _fields(getattr(mod("ref", path), name)())
        assert t == j, name
    fc = mod("port", "frontend").FrontendConfig()
    assert fc.sidecar_folds and fc.metrics_block_rf == 1


def test_frontend_stack_runs_on_cuda_by_default(tmp_path, monkeypatch):
    """The frontend runs on its TempoDB's device: `cuda` unless the CPU
    is asked for; without CUDA the stack raises."""
    from tempo_tpu_torch.backend.mem import MemBackend
    from tempo_tpu_torch.db import TempoDB
    from tempo_tpu_torch.frontend import Frontend
    from tempo_tpu_torch.querier import Querier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    be = MemBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        TempoDB(be, be)
    db = TempoDB(be, be, device="cpu")
    fe = Frontend(db, Querier(db))
    assert fe.db.device.type == "cpu"
    assert fe.search("t", "{ }") == []
    fe.shutdown()
    db.shutdown()


def test_unported_frontend_surfaces_raise_naming_their_item(pair):
    p, _ = pair
    from tempo_tpu_torch import matview

    # no materializer configured: the reference's answers, not a raise
    assert matview.materializer() is None
    assert p.fe.subscribe_query("t1", "{ } | rate()", 60.0) == \
        (False, "matview tier disabled")
    assert p.fe.unsubscribe_query("t1", "{ } | rate()", 60.0) is False
    assert p.fe.generator_query_range is None


def test_obs_families_match_reference(pair):
    p, r = pair
    p.fe.search("t1", "{ }", limit=50, start_s=0, end_s=p.now())
    r.fe.search("t1", "{ }", limit=50, start_s=0, end_s=r.now())
    names = lambda reg: sorted({ln.split()[2] for ln in
                                reg.render().splitlines()
                                if ln.startswith("# TYPE")})
    assert names(p.fe.obs) == names(r.fe.obs)
    assert names(p.q.obs) == names(r.q.obs)


# ---------------------------------------------------------------------------
# tests/test_read_path.py on both packages
# ---------------------------------------------------------------------------

def test_time_windows_and_shards_match_reference():
    ts, js = mod("port", "frontend.sharders"), mod("ref", "frontend.sharders")
    now = 10_000.0
    for args in ((0.0, now, 900, 1800), (now - 60, now, 900, 1800),
                 (now - 1000, now - 950, 900, 1800), (0.0, 100.0, 900, 1800)):
        assert ts.time_windows(now, *args) == js.time_windows(now, *args)
    for n in (1, 4, 7):
        assert ts.trace_id_shards(n) == js.trace_id_shards(n)
    shards = ts.trace_id_shards(4)
    assert shards[0][0] == b"\x00" * 16 and shards[-1][1] == b"\xff" * 16


def test_backend_jobs_match_reference(pair):
    p, r = pair
    for target in (1, 10 ** 9):
        a = mod("port", "frontend.sharders").backend_search_jobs(
            "t1", p.db.blocklist.metas("t1"), 0, p.now(), target)
        b = mod("ref", "frontend.sharders").backend_search_jobs(
            "t1", r.db.blocklist.metas("t1"), 0, r.now(), target)
        assert [(j.meta.block_id, j.row_groups) for j in a] == \
            [(j.meta.block_id, j.row_groups) for j in b]
    qa = mod("port", "frontend.sharders").query_range_jobs(
        "t1", p.db.blocklist.metas("t1"), T0 - 53.0, T0 + 605.0, 60.0)
    qb = mod("ref", "frontend.sharders").query_range_jobs(
        "t1", r.db.blocklist.metas("t1"), T0 - 53.0, T0 + 605.0, 60.0)
    assert [(j.kind, j.start_s, j.end_s) for j in qa] == \
        [(j.kind, j.start_s, j.end_s) for j in qb]
    assert len(qa) == 2 and qa[0].kind == "backend_metrics"
    assert qa[0].start_s == T0 - 80.0 and qa[0].end_s == T0 + 640.0


@pytest.mark.parametrize("query,limit", [
    ("{ }", 50),
    ('{ resource.service.name = "svc-1" }', 50),
    ("{ }", 3),
    ('{ name = "op" && duration > 10ms }', 7),
])
def test_search_matches_reference(pair, query, limit):
    p, r = pair
    a = p.fe.search("t1", query, limit=limit, start_s=0, end_s=p.now())
    b = r.fe.search("t1", query, limit=limit, start_s=0, end_s=r.now())
    assert md_json(a) == md_json(b)
    assert len(a) == min(limit, 11 if query == "{ }" else len(b))
    if query == "{ }" and limit == 50:
        svcs = {m.root_service_name for m in a}
        assert {"recent-svc", "svc-0", "svc-1"} <= svcs
        assert p.fe.slos.within[("search", "t1")] == 1
        assert p.fe.slos.total == r.fe.slos.total


def test_find_trace_matches_reference(pair):
    p, r = pair
    for tid in (p.rid, bytes([1]) * 16, bytes([18]) * 16, b"\x77" * 16):
        a, b = p.fe.find_trace("t1", tid), r.fe.find_trace("t1", tid)
        assert a == b
    assert len(p.fe.find_trace("t1", p.rid)) == 1
    assert p.fe.find_trace("t1", bytes([1]) * 16)[0]["name"] == "op"


@pytest.mark.parametrize("query,step,exact", [
    ("{ } | rate()", 60.0, True),
    ("{ } | rate() by (resource.service.name)", 60.0, True),
    ("{ } | count_over_time() by (name)", 120.0, True),
    ("{ } | quantile_over_time(duration, .5)", 660.0, True),
    ("{ } | quantile_over_time(duration, .5, .99) by "
     "(resource.service.name)", 300.0, True),
])
def test_query_range_matches_reference(pair, query, step, exact):
    p, r = pair
    kw = dict(start_s=T0 - 60, end_s=T0 + 600, step_s=step)
    a = p.fe.query_range("t1", query, **kw)
    b = r.fe.query_range("t1", query, **kw)
    assert a and b
    assert_series(a, b, exact)
    if "quantile" in query:
        vals = [v for s in a for v in s.samples if np.isfinite(v) and v > 0]
        assert vals and 0.02 < vals[0] < 0.2
    else:
        assert sum(float(np.nansum(s.samples)) for s in a) > 0


def test_worker_pool_matches_inline(pair):
    p, r = pair
    inline = md_json(p.fe.search("t1", "{ }", limit=50, start_s=0,
                                 end_s=p.now()))
    p.fe.start_workers(2)
    r.fe.start_workers(2)
    a = p.fe.search("t1", "{ }", limit=50, start_s=0, end_s=p.now())
    b = r.fe.search("t1", "{ }", limit=50, start_s=0, end_s=r.now())
    assert md_json(a) == md_json(b) == inline and len(a) == 11
    qa = p.fe.query_range("t1", "{ } | rate()", start_s=T0 - 60,
                          end_s=T0 + 600, step_s=60.0)
    qb = r.fe.query_range("t1", "{ } | rate()", start_s=T0 - 60,
                          end_s=T0 + 600, step_s=60.0)
    assert_series(qa, qb, exact=True)


def test_queue_matches_reference():
    out = []
    for side in ("port", "ref"):
        qm = mod(side, "frontend.queue")
        q = qm.RequestQueue(max_outstanding_per_tenant=10)
        for i in range(6):
            q.enqueue("a", f"a{i}")
        q.enqueue("b", "b0")
        seen = []
        while True:
            batch = q.dequeue_batch(2)
            if not batch:
                break
            seen.append(batch)
        capped = qm.RequestQueue(max_outstanding_per_tenant=2)
        capped.enqueue("a", 1)
        capped.enqueue("a", 2)
        with pytest.raises(qm.QueueFull):
            capped.enqueue("a", 3)
        q.close()
        with pytest.raises(RuntimeError, match="closed"):
            q.enqueue("a", 9)
        out.append(seen)
    assert out[0] == out[1]
    assert [x for b in out[0] for x in b].index("b0") < 6


def test_slo_recorder_matches_reference():
    got = []
    for side in ("port", "ref"):
        sm = mod(side, "frontend.slos")
        r = sm.SLORecorder({"search": sm.SLOConfig(
            duration_slo_s=1.0, throughput_bytes_slo=1000.0)})
        got.append(([r.record("search", "t", *a) for a in
                     ((0.5, 0), (5.0, 100_000), (5.0, 100))]
                    + [r.record("other", "t", 9.0, 0)], r.total, r.within))
    assert got[0] == got[1]
    assert got[0][0] == [True, True, False, True]


# ---------------------------------------------------------------------------
# the backend cutoff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query", [
    "{ } | rate() by (resource.service.name)",
    "{ } | quantile_over_time(duration, .9)",
])
def test_cutoff_split_equals_clipped_tempodb(tmp_path, query):
    """With the clock set so that the backend cutoff falls inside the
    window, the frontend's answer is `TempoDB.query_range` clipped at the
    cutoff, finalized by `SeriesCombiner`, in both packages."""
    clock = T0 + 3 + 900.0          # cutoff = T0 + 3: blocks straddle it
    outs = {}
    for side in ("port", "ref"):
        st = Stack(side, tmp_path, clock_s=clock, ingester=False)
        em = mod(side, "traceql.engine_metrics")
        w0, w1, step = T0 - 60, T0 + 600, 60.0
        got = st.fe.query_range("t1", query, start_s=w0, end_s=w1,
                                step_s=step)
        req = em.QueryRangeRequest(query=query, start_ns=int(w0 * 1e9),
                                   end_ns=int(w1 * 1e9),
                                   step_ns=int(step * 1e9))
        cutoff_ns = int((clock - 900.0) * 1e9)
        raw = st.db.query_range("t1", req, clip_end_ns=cutoff_ns)
        comb = em.SeriesCombiner(em.metrics_kind(query), req.n_steps)
        comb.add_all(raw)
        want = comb.final(req)
        assert_series(got, want, exact=True)
        outs[side] = got
        st.close()
    assert_series(outs["port"], outs["ref"], exact=True)
    total = sum(float(np.nansum(s.samples)) for s in outs["port"])
    if "rate" in query:
        # 2 spans a block start before the cutoff (T0 + 1, T0 + 2)
        assert total == pytest.approx(4 / 60.0)


def test_metrics_read_rf1_blocks_only(tmp_path):
    """At the default `metrics_block_rf=1`, RF3 blocks (ingester output)
    answer search but not metrics, in both packages."""
    for side in ("port", "ref"):
        st = Stack(side, tmp_path, ingester=False)
        st.db.write_block("t1", default_blocks()[0][1],
                          block_id=block_id(9), replication_factor=3)
        st.db.poll_now()
        s = st.fe.query_range("t1", "{ } | count_over_time()",
                              start_s=T0 - 60, end_s=T0 + 600, step_s=660.0)
        assert float(np.nansum(s[0].samples)) == 10.0
        assert len(st.fe.search("t1", "{ }", limit=50, start_s=0,
                                end_s=st.now())) == 10
        st.close()


# ---------------------------------------------------------------------------
# tests/test_frontend_features.py on both packages
# ---------------------------------------------------------------------------

RIG = dict(clock_s=T0 + 7200.0, blocks=tenant_blocks(), ingester=False,
           cache=True)


@pytest.mark.parametrize("pair", [RIG], indirect=True)
def test_repeated_search_hits_cache(pair):
    got = []
    for st in pair:
        q = '{ resource.service.name = "acme-svc" }'
        res1 = st.fe.search("acme", q, limit=50, start_s=0, end_s=st.now())
        first = st.q.search_block_calls
        assert first > 0 and len(res1) == 9
        res2 = st.fe.search("acme", q, limit=50, start_s=0, end_s=st.now())
        assert st.q.search_block_calls == first
        assert st.fe.cache_stats["hits"] >= first
        assert md_json(res1) == md_json(res2)
        got.append((md_json(res1), st.fe.cache_stats,
                    st.fe.cache_hit_ratio()))
    assert got[0] == got[1]


@pytest.mark.parametrize("pair", [RIG], indirect=True)
def test_search_cache_key_includes_query(pair):
    calls = []
    for st in pair:
        st.fe.search("acme", "{ }", limit=50, start_s=0, end_s=st.now())
        jobs1 = st.q.search_block_calls
        st.fe.search("acme", '{ name = "op" }', limit=50, start_s=0,
                     end_s=st.now())
        assert st.q.search_block_calls > jobs1
        calls.append((jobs1, st.q.search_block_calls))
    assert calls[0] == calls[1]


@pytest.mark.parametrize("pair", [RIG], indirect=True)
def test_repeated_query_range_hits_cache(pair):
    outs = []
    for st in pair:
        kw = dict(start_s=T0, end_s=T0 + 60, step_s=10.0)
        s1 = st.fe.query_range("acme", "{ } | rate() by (name)", **kw)
        first = st.q.query_range_calls
        assert first > 0
        s2 = st.fe.query_range("acme", "{ } | rate() by (name)", **kw)
        assert st.q.query_range_calls == first
        assert_series(s1, s2, exact=True)
        outs.append(s1)
    assert_series(outs[0], outs[1], exact=True)


@pytest.mark.parametrize("pair", [RIG], indirect=True)
def test_multi_tenant_reads_federate(pair):
    p, r = pair
    a = p.fe.search("acme|globex", "{ }", limit=50, start_s=0, end_s=p.now())
    b = r.fe.search("acme|globex", "{ }", limit=50, start_s=0, end_s=r.now())
    assert md_json(a) == md_json(b) and len(a) == 17
    assert {m.root_service_name for m in a} == {"acme-svc", "globex-svc"}
    fa = p.fe.find_trace("acme|globex", bytes([250]) * 16)
    assert fa == r.fe.find_trace("acme|globex", bytes([250]) * 16)
    assert {s.get("service") for s in fa} == {"acme-svc", "globex-svc"}
    va = p.fe.tag_values("acme|globex", "resource.service.name")
    assert va == r.fe.tag_values("acme|globex", "resource.service.name")
    assert {"acme-svc", "globex-svc"} <= {v["value"] for v in va}
    assert p.fe.tag_names("acme|globex") == r.fe.tag_names("acme|globex")
    tsplit = mod("port", "frontend.frontend").split_tenants
    jsplit = mod("ref", "frontend.frontend").split_tenants
    for t in ("a", "a|b", " a | b |a|", "|", "a|a"):
        assert tsplit(t) == jsplit(t)


@pytest.mark.parametrize("pair", [RIG], indirect=True)
def test_multi_tenant_metrics_rejected(pair):
    p, _ = pair
    err = mod("port", "frontend.frontend").UnsupportedMultiTenant
    with pytest.raises(err, match="multi-tenant"):
        p.fe.query_range("acme|globex", "{ } | rate()",
                         start_s=T0, end_s=T0 + 60, step_s=10.0)
    assert issubclass(err, ValueError)


@pytest.mark.parametrize("pair", [RIG], indirect=True)
def test_cache_engages_on_worker_dispatch_path(pair):
    for st in pair:
        st.fe.start_workers(2)
        st.fe.search("acme", '{ name = "op" }', limit=50, start_s=0,
                     end_s=st.now())
        first = st.q.search_block_calls
        assert first > 0
        st.fe.search("acme", '{ name = "op" }', limit=50, start_s=0,
                     end_s=st.now())
        assert st.q.search_block_calls == first
        assert st.fe.cache_stats["hits"] >= first
    assert pair[0].fe.cache_stats == pair[1].fe.cache_stats


# ---------------------------------------------------------------------------
# tests/test_query_stats.py on both packages
# ---------------------------------------------------------------------------

QS = dict(ingester=False, db_cfg=dict(row_group_rows=2),
          fe_cfg=dict(qlog_sample_every=1, slo={}))


def _run_search(side, st):
    qs = mod(side, "obs.querystats")
    with qs.scope() as s:
        res = st.fe.search("t1", "{ }", limit=50, start_s=0, end_s=st.now())
    return res, s


@pytest.mark.parametrize("pair", [QS], indirect=True)
def test_sharded_search_merges_stats_like_reference(pair):
    got = {}
    for st in pair:
        res, s = _run_search(st.side, st)
        assert len(res) == 10
        assert s.total_jobs >= 3 and s.completed_jobs == s.total_jobs
        assert s.blocks_scanned >= s.total_jobs and s.total_blocks == 2
        assert s.inspected_bytes > 0 and s.inspected_traces >= 10
        for stage in ("block_fetch", "engine_eval", "merge"):
            assert s.stage_ns.get(stage, 0) > 0, stage
        st.fe.start_workers(3)
        res2, s2 = _run_search(st.side, st)
        assert md_json(res2) == md_json(res)
        assert s2.completed_jobs == s.completed_jobs
        assert s2.inspected_bytes == s.inspected_bytes
        assert s2.inspected_traces == s.inspected_traces
        assert "queue_wait" in s2.stage_ns
        got[st.side] = (md_json(res), s.total_jobs, s.completed_jobs,
                        s.blocks_scanned, s.total_blocks,
                        s.inspected_traces, s.inspected_spans,
                        sorted(s.stage_ns), sorted(s2.stage_ns))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("pair", [QS], indirect=True)
def test_cache_hits_counted_like_reference(pair):
    got = []
    for st in pair:
        fm = mod(st.side, "frontend")
        fe = fm.Frontend(st.db, st.q, cfg=fm.FrontendConfig(
            target_bytes_per_job=1),
            cache_provider=mod(st.side, "backend.cache").CacheProvider(),
            now=st.now)
        st.fe = fe
        _, first = _run_search(st.side, st)
        _, second = _run_search(st.side, st)
        assert first.cache_hits == 0
        assert second.cache_hits == second.completed_jobs > 0
        assert second.inspected_bytes == 0
        got.append((first.completed_jobs, second.cache_hits))
    assert got[0] == got[1]


@pytest.mark.parametrize("pair", [QS], indirect=True)
def test_each_request_writes_one_query_complete_line(pair, caplog):
    """Every endpoint call writes exactly one parseable "query complete"
    line whose keys are the reference's, and whose numbers match the
    request's merged stats."""
    recs = {}
    for st in pair:
        name = mod(st.side, "obs.qlog").LOGGER_NAME
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=name):
            _, s = _run_search(st.side, st)
            st.fe.query_range("t1", "{ } | rate()", start_s=T0 - 60,
                              end_s=T0 + 600, step_s=60.0)
            with pytest.raises(Exception):
                st.fe.search("t1", "{ not a query", limit=5)
        lines = [json.loads(r.getMessage()) for r in caplog.records
                 if r.name == name]
        assert [ln["op"] for ln in lines] == ["search", "metrics", "search"]
        assert [ln["status"] for ln in lines] == ["ok", "ok", "error"]
        sm = s.search_metrics()
        assert lines[0]["completedJobs"] == sm["completedJobs"] >= 3
        assert lines[0]["inspectedBytes"] == sm["inspectedBytes"] > 0
        assert lines[0]["totalBlocks"] == sm["totalBlocks"] == 2
        assert lines[0]["traceId"] is None
        recs[st.side] = lines
    for a, b in zip(recs["port"], recs["ref"]):
        assert sorted(a) == sorted(b)
        for k in ("msg", "reason", "op", "tenant", "query", "status",
                  "queryFp", "totalBlocks", "totalJobs", "completedJobs",
                  "inspectedTraces", "inspectedSpans"):
            assert a.get(k) == b.get(k), k


@pytest.mark.parametrize("pair", [QS], indirect=True)
def test_tenant_read_cost_counters_like_reference(pair):
    got = []
    for st in pair:
        _, s = _run_search(st.side, st)
        fam = st.fe.obs.get("tempo_tpu_query_inspected_bytes_total")
        assert dict(fam.fn())[("t1",)] == s.inspected_bytes > 0
        fam = st.fe.obs.get("tempo_tpu_query_blocks_scanned_total")
        assert dict(fam.fn())[("t1",)] == s.blocks_scanned
        fam = st.fe.obs.get("tempo_tpu_frontend_cache_hits_total")
        got.append((s.blocks_scanned, list(fam.fn())))
    assert got[0] == got[1]


def test_latency_sketch_matches_reference():
    rng = np.random.default_rng(5)
    ts = mod("port", "obs.qlog").LatencySketch()
    js = mod("ref", "obs.qlog").LatencySketch()
    for v in np.concatenate([rng.lognormal(-4, 1.5, 500), [0.0, -1.0,
                                                           1e-12, 1e9]]):
        ts.record(float(v))
        js.record(float(v))
    assert ts.counts == js.counts
    for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ts.quantile(q) == js.quantile(q), q
    assert mod("port", "obs.qlog").LatencySketch().quantile(0.5) == 0.0


def _drive_qlog(side: str):
    t = [0.0]
    ql = mod(side, "obs.qlog").QueryLogger(
        slow_quantile=0.9, sample_every=7, min_observations=10,
        rate_limit_per_s=2.0, burst=3, now=lambda: t[0],
        logger=logging.getLogger(f"qlog-test-{side}"))
    rng = np.random.default_rng(3)
    out = []
    for i in range(200):
        t[0] += float(rng.exponential(0.3))
        status = "error" if i % 37 == 5 else "ok"
        d = float(rng.lognormal(-4, 1.0)) * (50 if i % 41 == 7 else 1)
        rec = ql.log_query(op=("search", "metrics")[i % 2], tenant="t",
                           query="{ }", status=status, duration_s=d,
                           error="x" if status == "error" else None)
        out.append(None if rec is None else rec["reason"])
    fp = [ql.note_fingerprint(f) for f in ("a", "b", "a", "a")]
    return (out, sorted(ql.emitted_by_reason()), ql.suppressed,
            ql.threshold("search"), fp, ql.fingerprint_count("a"))


def test_qlog_decisions_match_reference():
    a, b = _drive_qlog("port"), _drive_qlog("ref")
    assert a == b
    reasons = set(a[0]) - {None}
    assert {"error", "slow", "sampled"} <= reasons and a[2] > 0


# ---------------------------------------------------------------------------
# obs/queryfp.py
# ---------------------------------------------------------------------------

def _query_strings() -> list[str]:
    """Every string literal of tests/test_traceql.py and
    tests/test_engine.py that parses as TraceQL."""
    from tempo_tpu.traceql.parser import parse

    out = set()
    root = pathlib.Path(__file__).parent
    for name in ("test_traceql.py", "test_engine.py"):
        tree = ast.parse((root / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and "{" in node.value:
                try:
                    parse(node.value)
                except Exception:
                    continue
                out.add(node.value)
    return sorted(out)


def test_query_fingerprint_matches_reference():
    tq, jq = mod("port", "obs.queryfp"), mod("ref", "obs.queryfp")
    queries = _query_strings()
    assert len(queries) >= 70
    queries += ["{ a && b", "  {   }  ", "", "{ .a = 1 && .b = 2 }",
                "{ .b = 2 && .a = 1 }", "{ .x = 1 } && { .y = 2 }",
                "{ .y = 2 } && { .x = 1 }"]
    for q in queries:
        assert tq.canonical_query(q) == jq.canonical_query(q), q
        for op, step in (("metrics", 60.0), ("search", None),
                         ("metrics", 0.0015)):
            assert tq.query_fingerprint(op, q, step) == \
                jq.query_fingerprint(op, q, step), q
    assert tq.query_fingerprint("m", "{ .a = 1 && .b = 2 }") == \
        tq.query_fingerprint("m", "{ .b = 2 && .a = 1 }")


# ---------------------------------------------------------------------------
# tests/test_sched.py:411 — query backpressure at the request boundary
# ---------------------------------------------------------------------------

def test_frontend_sheds_queries_when_query_class_saturated():
    from tempo_tpu_torch.backend.mem import MemBackend
    from tempo_tpu_torch.db import TempoDB
    from tempo_tpu_torch.frontend import Frontend
    from tempo_tpu_torch.querier import Querier
    from tempo_tpu_torch.ring import Ring
    from tempo_tpu_torch.sched import (PRIO_QUERY, DeviceScheduler,
                                       QueryBackpressure, SchedConfig)

    be = MemBackend()
    db = TempoDB(be, be, device="cpu")
    fe = Frontend(db, Querier(db, Ring(replication_factor=1), {}))
    sc = DeviceScheduler(SchedConfig(max_queue_query=1, retry_after_s=2.0),
                         start_worker=False)
    blocker = tsched.Job(priority=PRIO_QUERY, kernel="q", fn=lambda: None)
    with sc._cond:
        sc._queues[PRIO_QUERY].append(blocker)
    try:
        with tsched.use(sc):
            for op, call in (("search", lambda: fe.search("t", "{ }")),
                             ("metrics", lambda: fe.query_range(
                                 "t", "{ } | rate()", start_s=0, end_s=60)),
                             ("search", lambda: fe.search("t", "{ }"))):
                with pytest.raises(QueryBackpressure) as ei:
                    call()
                assert ei.value.retry_after_s == 2.0
            assert fe.shed_requests == {"search": 2, "metrics": 1}
            shed = dict(fe.obs.get("tempo_query_frontend_shed_total").fn())
            assert shed == {("search",): 2, ("metrics",): 1}
            sc.drain_once(force=True)
            assert fe.search("t", "{ }") == []
    finally:
        sc.stop()
        fe.shutdown()
        db.shutdown()


def test_read_plane_masks_ride_the_query_class(tmp_path):
    """`tests/test_sched.py:610`: `BlockScanPlane` masks run as jobs of
    the scheduler's query class and give the same bits as the direct
    dispatch, `condition_mask` and the reference's plane."""
    from tempo_tpu.block.device_scan import BlockScanPlane as JPlane
    from tempo_tpu.block.fetch import scan_views as j_scan
    from tempo_tpu.block.reader import BackendBlock as JBlock
    from tempo_tpu.traceql.conditions import extract_conditions as jx
    from tempo_tpu.traceql.parser import parse as jparse
    from tempo_tpu_torch.block.device_scan import BlockScanPlane
    from tempo_tpu_torch.block.fetch import condition_mask, scan_views
    from tempo_tpu_torch.block.reader import BackendBlock
    from tempo_tpu_torch.sched import DeviceScheduler, SchedConfig
    from tempo_tpu_torch.traceql.conditions import extract_conditions
    from tempo_tpu_torch.traceql.parser import parse
    from tests.test_torch_traceql import port_block

    rng = np.random.default_rng(7)
    traces = []
    for i in range(200):
        tid = rng.bytes(16)
        start = int((1_700_000_000 + i) * 1e9)
        traces.append((tid, [{
            "trace_id": tid, "span_id": rng.bytes(8),
            "name": f"op-{i % 5}", "service": f"svc-{i % 3}",
            "start_unix_nano": start, "end_unix_nano": start + 10**7}]))
    traces.sort(key=lambda t: t[0])
    tb, jb = port_block(tmp_path, traces, row_group_rows=64)
    assert isinstance(tb, BackendBlock) and isinstance(jb, JBlock)
    views = [v for v, _ in scan_views(tb, device="cpu")]
    req = extract_conditions(parse('{ name = "op-1" }'))
    preds = [c for c in req.conditions if c.op is not None]
    plane = BlockScanPlane(views, device="cpu")
    direct = plane.mask(preds, req.all_conditions)
    sc = DeviceScheduler(SchedConfig(), start_worker=True)
    try:
        with tsched.use(sc):
            routed = plane.mask(preds, req.all_conditions)
    finally:
        sc.stop()
    np.testing.assert_array_equal(direct, routed)
    want = np.concatenate([condition_mask(v, req) for v in views])
    np.testing.assert_array_equal(routed, want)
    assert sc.jobs_total["query"] >= 1
    jreq = jx(jparse('{ name = "op-1" }'))
    jplane = JPlane([v for v, _ in j_scan(jb)])
    ref = jplane.mask([c for c in jreq.conditions if c.op is not None],
                      jreq.all_conditions)
    np.testing.assert_array_equal(routed, ref)
