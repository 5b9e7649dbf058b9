"""The port's querier, the ingesters' read side, `traceql.memview` and
`traceql.metrics_summary` against the reference's.

Both packages take the same seeded traces (`tests/test_torch_traceql.
seeded_traces`, every column family the read side adopts). Held equal:

- `Querier`: trace by id with rf-quorum over 3 ingesters (a failing
  replica tolerated, a second one raising), recent search, a block job
  of search and of metrics, `tag_names` (with its partial snapshots) and
  `tag_values` (a resident block and a cold one);
- `Ingester.search`, `tag_names` and `tag_values` over live traces and
  local complete blocks;
- `memview.view_from_traces`: every column, strings compared as decoded
  values, and the view metadata;
- `metrics_summary.get_metrics` over memview views and block views, and
  `Generator.get_metrics` for a tenant with no instance (the empty
  `MetricsResults`).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from tests.test_torch_frontend import assert_series
from tests.test_torch_traceql import port_block, seeded_traces

T0 = 1_700_000_000
PKG = {"ref": "tempo_tpu", "port": "tempo_tpu_torch"}


def mod(side: str, path: str):
    return importlib.import_module(f"{PKG[side]}.{path}")


def traces_at(seed: int, n: int, t0_s: float):
    return seeded_traces(seed, n, t0_ns=int(t0_s * 1e9), span_s=50.0)


class Rig:
    """3 ingesters on a ring (rf 3), each fed the same live traces and a
    completed local block, over a TempoDB holding two backend blocks."""

    def __init__(self, side: str, tmp_path, n_ing: int = 3):
        self.side = side
        self.clock = [float(T0 + 3600)]
        now = self.now = lambda: self.clock[0]
        self.be = mod(side, "backend.mem").MemBackend()
        tdb = mod(side, "db.tempodb")
        kw = {"device": "cpu"} if side == "port" else {}
        self.db = tdb.TempoDB(self.be, self.be,
                              tdb.TempoDBConfig(row_group_rows=64),
                              now=now, **kw)
        self.db.write_block("t", traces_at(3, 120, T0),
                            block_id="00000000-0000-0000-0000-000000000001",
                            replication_factor=1)
        self.db.write_block("t", traces_at(4, 60, T0 + 100),
                            block_id="00000000-0000-0000-0000-000000000002",
                            replication_factor=1)
        self.db.poll_now()
        rm = mod(side, "ring")
        self.ring = rm.Ring(replication_factor=3, now=now)
        ing_m = mod(side, "ingester")
        self.ings = {}
        for k in range(n_ing):
            iid = f"ing-{k}"
            ing = ing_m.Ingester(str(tmp_path / side / iid),
                                 flush_writer=self.be, now=now,
                                 instance_id=iid)
            self.ring.register(rm.InstanceDesc(
                id=iid, state=rm.ACTIVE,
                tokens=mod(side, "ring.ring")._instance_tokens(iid, 64),
                heartbeat_ts=now()))
            # an older batch cut and completed into a local block, then a
            # live batch still in memory
            ing.push("t", traces_at(5, 40, self.clock[0] - 600))
            ing.sweep_all(immediate=True)
            ing.queues.drain(ing._handle_op)
            ing.push("t", traces_at(6, 30, self.clock[0] - 60))
            self.ings[iid] = ing
        qm = mod(side, "querier")
        self.q = qm.Querier(self.db, self.ring, dict(self.ings),
                            cfg=qm.QuerierConfig(rf=3), now=now)

    def close(self):
        self.db.shutdown()


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    path = tmp_path_factory.mktemp("querier")
    p, r = Rig("port", path), Rig("ref", path)
    yield p, r
    p.close()
    r.close()


def md_json(res):
    return [m.to_json() for m in res]


# ---------------------------------------------------------------------------
# Querier
# ---------------------------------------------------------------------------

def test_querier_find_trace_by_id_matches_reference(rigs):
    p, r = rigs
    ids = ([t for t, _ in traces_at(3, 120, T0)][::17]
           + [t for t, _ in traces_at(5, 40, 0)][::9]
           + [t for t, _ in traces_at(6, 30, 0)][::7] + [b"\x01" * 16])
    for tid in ids:
        a = p.q.find_trace_by_id("t", tid)
        b = r.q.find_trace_by_id("t", tid)
        assert a == b, tid.hex()
    assert sum(p.q.find_trace_by_id("t", t) is not None for t in ids) \
        == len(ids) - 1


class _Down:
    def find_trace_by_id(self, tenant, trace_id):
        raise ConnectionError("replica down")


def test_querier_quorum_tolerates_one_failed_replica(rigs):
    p, r = rigs
    tid = traces_at(6, 30, 0)[4][0]
    outs = []
    for rig in (p, r):
        q = rig.q
        saved = dict(q.clients)
        try:
            q.clients["ing-1"] = _Down()
            outs.append(q.find_trace_by_id("t", tid))
            q.clients["ing-2"] = _Down()
            with pytest.raises(ConnectionError):
                q.find_trace_by_id("t", tid)
        finally:
            q.clients.clear()
            q.clients.update(saved)
    assert outs[0] == outs[1] and outs[0] is not None


@pytest.mark.parametrize("query,limit", [
    ("{ }", 200), ('{ name = "op-1" }', 20),
    ("{ span.http.status_code >= 400 }", 5),
    ("{ resource.deployment = \"d1\" && duration > 50ms }", 100),
])
def test_querier_search_matches_reference(rigs, query, limit):
    p, r = rigs
    now = p.now()
    a = p.q.search_recent("t", query, limit, now - 1800, now)
    b = r.q.search_recent("t", query, limit, now - 1800, now)
    assert md_json(a) == md_json(b) and a
    for m in p.db.blocklist.metas("t"):
        jm = next(x for x in r.db.blocklist.metas("t")
                  if x.block_id == m.block_id)
        for rgs in (None, [0], [1, 2]):
            a = p.q.search_block("t", query, m, rgs, limit, 0, now)
            b = r.q.search_block("t", query, jm, rgs, limit, 0, now)
            assert md_json(a) == md_json(b), (m.block_id, rgs)


def test_querier_query_range_block_matches_reference(rigs):
    p, r = rigs
    for query in ("{ } | rate() by (resource.service.name)",
                  "{ span.http.status_code >= 300 } | count_over_time()"):
        reqs = [mod(s, "traceql.engine_metrics").QueryRangeRequest(
            query=query, start_ns=T0 * 10**9, end_ns=(T0 + 300) * 10**9,
            step_ns=60 * 10**9) for s in ("port", "ref")]
        for m in p.db.blocklist.metas("t"):
            jm = next(x for x in r.db.blocklist.metas("t")
                      if x.block_id == m.block_id)
            for rgs, clip in ((None, None), ([1], (T0 + 120) * 10**9)):
                a = p.q.query_range_block("t", reqs[0], m, rgs,
                                          clip_end_ns=clip)
                b = r.q.query_range_block("t", reqs[1], jm, rgs,
                                          clip_end_ns=clip)
                assert_series(a, b, exact=True)
    names = lambda q: sorted({ln.split()[2] for ln in
                              q.obs.render().splitlines()
                              if ln.startswith("# TYPE")})
    assert names(p.q) == names(r.q)


def test_querier_tags_match_reference(rigs):
    p, r = rigs
    snaps = {"port": [], "ref": []}
    a = p.q.tag_names("t", on_partial=snaps["port"].append)
    b = r.q.tag_names("t", on_partial=snaps["ref"].append)
    assert a == b and a["span"] and a["resource"]
    assert snaps["port"] == snaps["ref"] and snaps["port"][-1] == a
    assert p.q.tag_names("t", scopes=("span",)) == \
        r.q.tag_names("t", scopes=("span",))
    for name in ("resource.service.name", "span.region", "name",
                 "span.http.status_code", "span.nothere"):
        for limit in (1000, 3):
            assert p.q.tag_values("t", name, limit) == \
                r.q.tag_values("t", name, limit), name
    # a block already resident in the plane cache answers from it
    for rig in (p, r):
        rig.db.search("t", "{ }", limit=5)
    for name in ("resource.service.name", "span.region"):
        a = p.q.tag_values("t", name)
        assert a == r.q.tag_values("t", name) and a
    m = p.db.blocklist.metas("t")[0]
    assert p.db.planes.peek("t", m.block_id) is not None


# ---------------------------------------------------------------------------
# the ingesters' read side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query", [
    "{ }", '{ name =~ "op-[12]" }', "{ kind = server || status = error }",
    "{ span.ratio > 0.5 } >> { }", "{ } | count() > 1",
])
def test_ingester_search_matches_reference(rigs, query):
    p, r = rigs
    now = p.now()
    for window in ((0, 0), (now - 1800, now), (now - 120, now)):
        a = p.ings["ing-0"].search("t", query, 500, *window)
        b = r.ings["ing-0"].search("t", query, 500, *window)
        assert md_json(a) == md_json(b), window
    assert p.ings["ing-0"].search("nobody", query) == []


def test_ingester_tags_match_reference(rigs):
    p, r = rigs
    pi, ri = p.ings["ing-0"], r.ings["ing-0"]
    assert pi.instance("t").complete_blocks()
    assert pi.tag_names("t") == ri.tag_names("t")
    for name in ("resource.service.name", "span.region", "name",
                 "span.err", "kind", "span.http.status_code"):
        for limit in (1000, 2):
            assert pi.tag_values("t", name, limit) == \
                ri.tag_values("t", name, limit), name
    assert pi.tag_names("nobody") == {} and pi.tag_values("nobody", "x") == []


# ---------------------------------------------------------------------------
# memview and metrics_summary
# ---------------------------------------------------------------------------

def _decoded(col):
    """(type, values as plain Python objects, exists) of a Col."""
    vals = col.values
    if vals.dtype == object:
        vals = [None if v is None else (list(v) if isinstance(v, list)
                                        else v) for v in vals.tolist()]
    else:
        vals = vals.tolist()
    return col.t, vals, col.exists.tolist()


def test_view_from_traces_matches_reference():
    tmv, jmv = mod("port", "traceql.memview"), mod("ref", "traceql.memview")
    traces = traces_at(8, 80, T0)
    # mixed-type attribute: the first type wins in both
    traces[0][1][0]["attrs"]["region"] = 7
    tv, jv = tmv.view_from_traces(traces), jmv.view_from_traces(traces)
    assert tv.n == jv.n > 80
    assert sorted(tv._cols) == sorted(jv._cols)
    for key in jv._cols:
        assert _decoded(tv.col(key)) == _decoded(jv.col(key)), key
    for a in ("parent_row", "nested_left", "nested_right", "trace_idx"):
        np.testing.assert_array_equal(getattr(tv, a), getattr(jv, a))
    assert tv.meta.keys() == jv.meta.keys()
    for k in jv.meta:
        a, b = tv.meta[k], jv.meta[k]
        if isinstance(b, np.ndarray):
            assert a.tolist() == b.tolist(), k
        else:
            assert a == b, k
    empty = tmv.view_from_traces([])
    assert empty.n == 0 and empty.col("duration").values.shape == (0,)


def _summary(side, views, query, group_by, max_series=1000):
    ms = mod(side, "traceql.metrics_summary")
    res = ms.get_metrics(query, group_by, views, max_series=max_series)
    return ([s.to_json() for s in res.results()], res.span_count,
            res.estimated)


@pytest.mark.parametrize("query,group_by,max_series", [
    ("{ }", (), 1000),
    ("{ }", ("resource.service.name",), 1000),
    ('{ name =~ "op-[0-3]" }', ("name", "span.region"), 1000),
    ("{ status = error }", ("resource.service.name", "kind"), 1000),
    ("{ }", ("name", "span.region", "resource.deployment"), 4),
])
def test_get_metrics_matches_reference(query, group_by, max_series,
                                      tmp_path):
    traces = traces_at(9, 150, T0)
    tv = mod("port", "traceql.memview").view_from_traces(traces)
    jv = mod("ref", "traceql.memview").view_from_traces(traces)
    a = _summary("port", [(tv, np.arange(tv.n))], query, group_by,
                 max_series)
    b = _summary("ref", [(jv, np.arange(jv.n))], query, group_by,
                 max_series)
    assert a == b and a[1] > 0
    tb, jb = port_block(tmp_path, traces, row_group_rows=64)
    tvs = list(mod("port", "block.fetch").scan_views(tb))
    jvs = list(mod("ref", "block.fetch").scan_views(jb))
    assert _summary("port", tvs, query, group_by, max_series) == \
        _summary("ref", jvs, query, group_by, max_series)
    ms = mod("port", "traceql.metrics_summary")
    np.testing.assert_array_equal(
        ms.bucketize_ns(np.array([0, 1, 2, 3, 1 << 40, 1e30])),
        mod("ref", "traceql.metrics_summary").bucketize_ns(
            np.array([0, 1, 2, 3, 1 << 40, 1e30])))
    with pytest.raises(ValueError, match="at most 5"):
        ms.get_metrics("{ }", ("a",) * 6, [])


def test_generator_get_metrics_for_unknown_tenant_is_empty():
    from tempo_tpu.generator.generator import Generator as JGen
    from tempo_tpu_torch.generator.generator import Generator as TGen
    from tempo_tpu_torch.traceql.metrics_summary import MetricsResults

    tg, jg = TGen(device="cpu"), JGen()
    try:
        a = tg.get_metrics("nobody", "{ }", ("name",), max_series=7)
        b = jg.get_metrics("nobody", "{ }", ("name",), max_series=7)
        assert isinstance(a, MetricsResults)
        assert (a.results(), a.span_count, a.estimated, a.max_series) == \
            (b.results(), b.span_count, b.estimated, b.max_series)
        assert "nobody" not in tg.instances
    finally:
        tg.shutdown()
        jg.shutdown()
