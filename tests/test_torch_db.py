"""The port's `db/` (blocklist, poller, pool, TempoDB) against the
reference.

Mirrors the List/Poller/Pool arms of `tests/test_db.py` and the TempoDB
read paths: `write_block` → `poll_now` → `find_trace_by_id`, `search` and
`query_range` with the device plane on (the reference's default
`TempoDBConfig`) and off. Both packages share one `LocalBackend`
directory; the port writes, the reference reads through pyarrow. The
cold tier (compaction, retention, the sidecar backfill) is held in
`tests/test_torch_compact.py`.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from tempo_tpu.backend.local import LocalBackend as JLocal
from tempo_tpu.backend.meta import BlockMeta as JMeta
from tempo_tpu.db import (CompactorConfig as JCompCfg, List as JList,
                          Poller as JPoller, PollerConfig as JPollerCfg,
                          Pool as JPool, TempoDB as JDB,
                          TempoDBConfig as JCfg,
                          TimeWindowBlockSelector as JSel)
from tempo_tpu.traceql import engine_metrics as jem

from tempo_tpu_torch.backend import read_tenant_index
from tempo_tpu_torch.backend.local import LocalBackend as TLocal
from tempo_tpu_torch.backend.meta import BlockMeta as TMeta
from tempo_tpu_torch.backend.meta import CompactedBlockMeta as TCMeta
from tempo_tpu_torch.db import (CompactorConfig as TCompCfg, List as TList,
                                Poller as TPoller, PollerConfig as TPollerCfg,
                                Pool as TPool, TempoDB as TDB,
                                TempoDBConfig as TCfg,
                                TimeWindowBlockSelector as TSel)
from tempo_tpu_torch.ops import pages as op
from tempo_tpu_torch.traceql import engine_metrics as tem
from tests.test_block import trace
from tests.test_torch_engine_metrics import assert_series_equal, smap
from tests.test_torch_traceql import T0_NS, seeded_traces


def _dbs(path, **cfg):
    tb, jb = TLocal(path), JLocal(path)
    return (TDB(tb, tb, TCfg(row_group_rows=32, **cfg), device="cpu"),
            JDB(jb, jb, JCfg(row_group_rows=32, **cfg)), tb, jb)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_default_configs_match_reference():
    t, j = _fields(TCfg()), _fields(JCfg())
    assert set(t) == set(j)
    for k in ("poller", "compactor"):
        assert _fields(t.pop(k)) == _fields(j.pop(k))
    assert t == j
    assert TCfg().device_plane and TCfg().plane_budget_bytes == 1 << 30
    assert (TCfg().plane_max_blocks, TCfg().pool_workers,
            TCfg().row_group_rows) == (64, 30, 50_000)
    assert _fields(TPollerCfg()) == _fields(JPollerCfg())


def test_tempodb_runs_on_cuda_by_default(tmp_path):
    be = TLocal(str(tmp_path))
    if torch.cuda.is_available():
        assert TDB(be, be).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TDB(be, be)
    db = TDB(be, be, device="cpu")
    assert db.device.type == "cpu" and db.planes.device.type == "cpu"
    db.shutdown()


def test_unported_surfaces_raise_naming_their_item(tmp_path):
    be = TLocal(str(tmp_path))
    db = TDB(be, be, device="cpu")
    # the cold tier is ported (tests/test_torch_compact.py): on a tenant
    # with no blocks every sweep is a no-op, as in the reference
    assert db.compact_tenant_once("t") == 0
    assert db.retention_once("t") == ([], [])
    assert db.backfill_sidecars_once("t") == 0
    # the mesh surfaces came with item 13 (the name is kept from when
    # they raised): a plane mesh reaches the plane cache, the in-mesh
    # combine folds as the reference's does, and moments_place puts a
    # plane into a trash-paged arena (a no-op once it is one)
    from tempo_tpu.parallel import serving as jserving
    from tempo_tpu_torch.ops import moments
    from tempo_tpu_torch.parallel import make_mesh, serving
    m = make_mesh(4, devices=["cpu"] * 4)
    mdb = TDB(be, be, TCfg(plane_mesh=m), device="cpu")
    assert mdb.planes.mesh is m
    mdb.shutdown()
    rng = np.random.default_rng(5)
    pend = [[(((("name", f"op-{i}"),), rng.integers(0, 9, 3)
               .astype(np.float64))) for i in range(5)] for _ in range(3)]
    got = []
    for mod, sm in ((jem, jserving.ServingMesh(jserving.MeshConfig(
            enabled=True, devices=4, series_shards=2))),
            (tem, serving.ServingMesh(serving.MeshConfig(
                enabled=True, series_shards=2), devices=["cpu"] * 4))):
        comb = mod.SeriesCombiner(mod.A.MetricsKind.RATE, 3)
        comb._merge_mesh(sm, [[mod.TimeSeries(lab, v.copy()) for lab, v
                               in lst] for lst in pend], "sum")
        got.append({k: v.samples.tolist() for k, v in comb.series.items()})
    assert got[0] == got[1] and got[1]
    st = moments.moments_init(32, device="cpu")
    assert moments.moments_place(st, "cpu", 64).data is st.data
    loose = moments.MomentsSketch(torch.ones(32, st.data.shape[1]), st.k,
                                  st.lo, st.hi)
    placed = moments.moments_place(loose, "cpu", 64)
    assert torch.equal(placed.data, loose.data)
    assert op.arena_of(placed.data, 64).shape[0] == 128
    # the sidecar fold (tests/test_torch_sidecar.py) and its writer, the
    # block-builder (tests/test_torch_blockbuilder.py), hold both halves
    # against the reference; the backfill is tests/test_torch_compact.py
    from tempo_tpu_torch.block import sidecar
    assert sidecar.sidecar_from_traces([], device="cpu").total_spans == 0
    assert db.sidecar_plan("{ } | rate()") is not None


def test_selector_groups_by_level_and_window():
    for Sel, Cfg, Meta in ((TSel, TCompCfg, TMeta), (JSel, JCompCfg, JMeta)):
        sel = Sel(Cfg(max_compaction_window_s=100.0, min_inputs=2,
                      max_inputs=3))
        metas = [Meta.new("t", end_time=t, compaction_level=lvl,
                          total_spans=1)
                 for t, lvl in [(10, 0), (20, 0), (30, 0), (40, 0), (150, 0),
                                (160, 0), (30, 1)]]
        jobs = sel.blocks_to_compact(metas)
        assert [len(j) for j in jobs] == [3, 2]
        assert all(m.compaction_level == 0 for j in jobs for m in j)


# ---------------------------------------------------------------------------
# List / Poller / Pool (tests/test_db.py)
# ---------------------------------------------------------------------------

def test_blocklist_matches_reference():
    t, j = TList(), JList()
    tm = [TMeta.new("t1", end_time=i, total_spans=i) for i in range(5)]
    jm = [JMeta.from_json(m.to_json()) for m in tm]
    for lst, ms, C in ((t, tm, TCMeta), (j, jm, None)):
        lst.update("t1", add=ms[:3])
        lst.update("t1", add=ms[3:], remove=ms[:1])
        lst.update("t2", add=ms[:1])
    assert [m.block_id for m in t.metas("t1")] == \
        [m.block_id for m in j.metas("t1")]
    assert sorted(t.tenants()) == sorted(j.tenants())
    t.update("t1", remove=tm[1:2], compacted_add=[TCMeta(tm[1], 5.0)])
    assert [c.meta.block_id for c in t.compacted_metas("t1")] == \
        [tm[1].block_id]
    t.apply_poll_results({"t1": tm[:2]}, {"t1": []})
    assert [m.block_id for m in t.metas("t1")] == [m.block_id for m in tm[:2]]
    assert t.tenants() == ["t1"] or sorted(t.tenants()) == ["t1"]


def test_write_poll_find(tmp_path):
    """`tests/test_db.py::test_write_poll_find` on both packages."""
    path = str(tmp_path / "store")
    port, ref, tb, jb = _dbs(path)
    t5 = trace(5)
    port.write_block("t1", [trace(1), trace(2), t5])
    port.write_block("t1", [trace(8), trace(9)])
    port.write_block("t2", [trace(3)])
    for db in (TDB(tb, tb, device="cpu"), JDB(jb, jb)):
        db.poll_now()
        assert len(db.blocks("t1")) == 2
        spans = db.find_trace_by_id("t1", t5[0])
        assert spans is not None and len(spans) == 3
        assert db.find_trace_by_id("t2", t5[0]) is None
    assert len(read_tenant_index(tb, "t1").metas) == 2


def test_find_combines_rf_duplicates_like_reference(tmp_path):
    """The same trace flushed by three ingesters (rf=3) into three blocks
    is answered once, deduplicated by span id, as the reference does."""
    path = str(tmp_path / "store")
    port, ref, tb, jb = _dbs(path)
    traces = seeded_traces(7, 40)
    port.write_block("t", traces[:30])
    port.write_block("t", traces[10:])
    port.write_block("t", traces)
    ref.poll_now()
    for tid, spans in traces:
        a = port.find_trace_by_id("t", tid)
        b = ref.find_trace_by_id("t", tid)
        key = lambda s: s["span_id"]
        assert sorted(a, key=key) == sorted(b, key=key)
        assert len(a) == len(spans)
    assert port.find_trace_by_id("t", b"\xee" * 16) is None


def test_time_pruned_blocks(tmp_path):
    port, ref, _, _ = _dbs(str(tmp_path / "store"))
    port.write_block("t1", [trace(1)])
    port.write_block("t1", [trace(50)])
    ref.poll_now()
    for db in (port, ref):
        assert len(db.blocks("t1")) == 2
        assert len(db.blocks("t1", start_s=40.0)) == 1
        assert len(db.blocks("t1", end_s=10.0)) == 1
        lo, hi = bytes([20] * 16), bytes([60] * 16)
        assert len(db.blocks("t1", shard_bounds=(lo, hi))) == 1


def test_poller_matches_reference(tmp_path):
    path = str(tmp_path / "store")
    port, _, tb, jb = _dbs(path)
    for i in range(3):
        port.write_block(f"t{i % 2}", [trace(i + 1)])
    t = TPoller(tb, tb, TPollerCfg()).do()
    j = JPoller(jb, jb, JPollerCfg()).do()
    assert {k: sorted(m.block_id for m in v) for k, v in t[0].items()} == \
        {k: sorted(m.block_id for m in v) for k, v in j[0].items()}
    assert {k: len(v) for k, v in t[1].items()} == \
        {k: len(v) for k, v in j[1].items()}


def test_pool_stop_when_and_errors():
    for Pool in (TPool, JPool):
        pool = Pool(max_workers=4)
        results, errors = pool.run_jobs(
            range(100), lambda i: i if i % 10 == 0 else None,
            stop_when=lambda rs: len(rs) >= 3)
        assert len(results) >= 3 and not errors

        def fn(i):
            if i == 1:
                raise ValueError("boom")
            return i

        results, errors = pool.run_jobs([0, 1, 2], fn)
        assert sorted(results) == [0, 2] and len(errors) == 1
        pool.shutdown()


# ---------------------------------------------------------------------------
# TempoDB's read paths against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("db") / "store")
    tb, jb = TLocal(path), JLocal(path)
    port = TDB(tb, tb, TCfg(row_group_rows=100), device="cpu")
    for seed in (1, 2, 3):
        port.write_block("t", seeded_traces(seed, 120))
    dbs = {"port": port,
           "port_host": TDB(tb, tb, TCfg(device_plane=False), device="cpu"),
           "ref": JDB(jb, jb), "ref_host": JDB(jb, jb,
                                              JCfg(device_plane=False))}
    for db in dbs.values():
        db.poll_now()
    return dbs


SEARCHES = ["{ span.http.status_code >= 400 }",
            '{ name =~ "op-1.*" && duration > 20ms }',
            "{ } >> { status = error }",
            '{ resource.service.name = "svc-1" } | count() > 1']


@pytest.mark.parametrize("limit", [5, 20, 1000])
@pytest.mark.parametrize("q", SEARCHES)
def test_search_matches_reference(world, q, limit):
    got = {k: [m.to_json() for m in db.search("t", q, limit=limit)]
           for k, db in world.items()}
    assert got["port"] == got["ref"] == got["port_host"] == got["ref_host"]
    s, e = (T0_NS / 1e9 + 100, T0_NS / 1e9 + 500)
    a = [m.to_json() for m in world["port"].search("t", q, limit=limit,
                                                   start_s=s, end_s=e)]
    b = [m.to_json() for m in world["ref"].search("t", q, limit=limit,
                                                  start_s=s, end_s=e)]
    assert a == b


QUERIES = ["{ } | rate() by (resource.service.name)",
           "{ } | quantile_over_time(duration, .5, .99) by (resource.service.name)",
           "{ span.http.status_code >= 400 } | count_over_time() by (name)",
           "{ } | avg_over_time(duration) by (span.region)",
           "{ } | max_over_time(span.ratio)",
           '{ name = "op-1" && (resource.service.name = "svc-0" '
           '|| span.region = "r1") } | rate() by (name)',
           "{ } | compare({ status = error })"]


@pytest.mark.parametrize("q", QUERIES)
def test_query_range_matches_reference(world, q):
    before = {k: dict(world[k].plane_stats) for k in ("port", "ref")}
    got = {}
    for k, db in world.items():
        mod = tem if k.startswith("port") else jem
        req = mod.QueryRangeRequest(q, T0_NS, T0_NS + 900 * 10**9,
                                    60 * 10**9)
        got[k] = smap(db.query_range("t", req))
    for k in ("port_host", "ref", "ref_host"):
        assert_series_equal(got["port"], got[k], q, k)
    deltas = [{s: v - before[k].get(s, 0)
               for s, v in world[k].plane_stats.items()}
              for k in ("port", "ref")]
    assert deltas[0] == deltas[1]


def test_query_range_clip_and_row_groups_match_reference(world):
    q = "{ } | rate() by (name)"
    kw = dict(clip_start_ns=T0_NS + 100 * 10**9, clip_end_ns=T0_NS + 600 * 10**9,
              row_groups=[0])
    a = smap(world["port"].query_range(
        "t", tem.QueryRangeRequest(q, T0_NS, T0_NS + 900 * 10**9, 60 * 10**9),
        **kw))
    b = smap(world["ref"].query_range(
        "t", jem.QueryRangeRequest(q, T0_NS, T0_NS + 900 * 10**9, 60 * 10**9),
        **kw))
    c = smap(world["port_host"].query_range(
        "t", tem.QueryRangeRequest(q, T0_NS, T0_NS + 900 * 10**9, 60 * 10**9),
        **kw))
    assert_series_equal(a, b, q)
    assert_series_equal(a, c, q)


def test_obs_families_match_reference(world):
    t = world["port"].obs.render()
    j = world["ref"].obs.render()
    names = lambda text: sorted({ln.split()[2] for ln in text.splitlines()
                                 if ln.startswith("# TYPE")})
    # the cold tier's families (compaction, backfilled sidecars, the
    # sweep's duration) came with it: the same families as the reference
    assert names(t) == names(j)
    assert "tempo_compaction_blocks_total" in t
    assert "tempo_compactor_cycle_duration_seconds" in t
    assert "tempo_read_plane_fused_metric_blocks_total" in t


def test_poll_drops_dead_planes_and_concurrent_queries(tmp_path):
    path = str(tmp_path / "store")
    port, _, tb, _ = _dbs(path)
    m1 = port.write_block("t", seeded_traces(4, 30))
    port.write_block("t", seeded_traces(5, 30))
    q = tem.QueryRangeRequest("{ } | rate() by (name)", T0_NS,
                              T0_NS + 900 * 10**9, 60 * 10**9)
    want = smap(port.query_range("t", q))
    errors = []

    def run():
        try:
            for _ in range(3):
                assert smap(port.query_range("t", q)).keys() == want.keys()
        except BaseException as e:     # noqa: BLE001 — asserted below
            errors.append(e)

    ths = [threading.Thread(target=run) for _ in range(3)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    assert not errors
    assert port.planes.stats()["entries"] == 2
    tb.delete("meta.json", __import__(
        "tempo_tpu_torch.backend.raw", fromlist=["block_keypath"])
        .block_keypath(m1.block_id, "t"))
    port.poll_now()
    assert len(port.blocks("t")) == 1
    assert port.planes.stats()["entries"] == 1
    assert np.isfinite(sum(v.sum() for v in smap(
        port.query_range("t", q)).values()))
