"""The block-builder, its sketch sidecars and a frontend metrics query over
both writers of RF1 blocks, against the reference.

Held, each side built from the same seeded traces:

- `tests/test_ingest_bus.py:61`: a cycle drains both partitions, commits
  after the flush, and writes RF1 blocks holding every trace; a crash
  replay (partition 0 un-committed and reconsumed) duplicates blocks,
  which `compact_tenant_once` dedupes;
- `tests/test_compact.py:191` (sidecar merge and HLL cardinality) and
  `:303` (a sidecar emitted at each cut);
- the ingest-storage stack at the reference's defaults (a bus, one
  `Generator` with span metrics and local blocks, one `BlockBuilder`, a
  `Frontend` over `Querier` and `TempoDB` with `generator_query_range` =
  `Generator.query_range`): history behind the backend cutoff folded
  from the block-builder's sidecars, the recent window from the
  generator's local blocks. Rate equal to the reference's stack exactly
  and to a `sidecar_folds=False` rescan; quantiles within rtol 1e-2 of
  the reference's (the port's query tier sums moments in float64 where
  the reference's sums in f32: ROADMAP section 3, "Moments quantiles on
  the card"), and over all spans within the moments
  gate of `tests/test_compact.py:246-263` (`min(rel, rank) <= 0.05`, on
  that test's query and duration law: lognormal around 50 ms, sigma 0.5);
  the recent leg equal before and after the local cut;
- the sidecars themselves: HLL registers bit-identical to the
  reference's block for block, counts and bounds exact, sums within rtol
  1e-5; port-written bytes folded by the reference's frontend and the
  reference's bytes by the port's, with the same answers.
"""

from __future__ import annotations

import numpy as np
import pytest

from tempo_tpu.generator.processors.spanmetrics import (
    SpanMetricsConfig as JSmCfg)
import tempo_tpu_torch as tt
from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.ops.hashing import token_for
from tests.test_torch_distributor import T0, tenant_patch
from tests.test_torch_frontend import mod

TENANT = "acme"
LB = ("span-metrics", "local-blocks")
RECENT_S = 1200.0                 # the clock moves 20 minutes between legs
RATE = "{ } | rate() by (resource.service.name)"
QUANT = ("{ } | quantile_over_time(duration, .5, .9) "
         "by (resource.service.name)")
QUANT_ALL = "{ } | quantile_over_time(duration, .5, .9)"


@pytest.fixture(autouse=True)
def _singletons():
    tsched.reset()
    yield
    tsched.reset()


def traces_at(rng, now_s, n_traces=24, spans=4):
    """Seeded traces of `spans` spans ending within 10 s before `now_s`
    (inside the generator's 30 s ingestion slack)."""
    out = []
    for _ in range(n_traces):
        tid = rng.bytes(16)
        end = int((now_s - rng.random() * 10.0) * 1e9)
        sp = []
        for j in range(spans):
            d = int(rng.lognormal(np.log(50e6), 0.5))
            sp.append({"trace_id": tid, "span_id": rng.bytes(8),
                       "name": f"op-{int(rng.integers(0, 3))}",
                       "service": f"svc-{int(rng.integers(0, 3))}",
                       "kind": 2, "status_code": 0,
                       "start_unix_nano": end - d, "end_unix_nano": end,
                       "attrs": {"k": j}})
        out.append((tid, sp))
    return out


def balanced(traces, per_partition=12, n_partitions=2):
    """The first `per_partition` traces that land in each partition: every
    block of a cycle holds the same number of spans, so the reference's
    jitted sidecar build compiles once for all four blocks."""
    from tempo_tpu_torch.ingest.encoding import partition_for

    mat = np.stack([np.frombuffer(t, np.uint8) for t, _ in traces])
    parts = partition_for(token_for(TENANT, mat), n_partitions)
    out = []
    for p in range(n_partitions):
        picked = [tr for tr, q in zip(traces, parts) if q == p]
        assert len(picked) >= per_partition
        out += picked[:per_partition]
    return out


def produce(side, bus, traces):
    mat = np.stack([np.frombuffer(t, np.uint8) for t, _ in traces])
    mod(side, "ingest.encoding").produce_traces(bus, TENANT, traces,
                                                token_for(TENANT, mat))


def drain(fn) -> int:
    total = 0
    while True:
        n = fn()
        if not n:
            return total
        total += n


class Stack:
    """One package's ingest-storage stack on a pinned clock."""

    def __init__(self, side, root, n_partitions=2):
        self.side = side
        self.clock = [T0]
        now = self.now = lambda: self.clock[0]
        kw = {"device": "cpu"} if side == "port" else {}
        self.bus = mod(side, "ingest.bus").Bus(n_partitions)
        ov = mod(side, "overrides").Overrides()
        ov.set_tenant_patch(TENANT, tenant_patch(LB))
        sm = (tt.SpanMetricsConfig(sketch_max_series=256) if side == "port"
              else JSmCfg(kernel="xla", sketch_max_series=256))
        lbm = mod(side, "generator.processors.localblocks")
        cfg = mod(side, "generator.instance").GeneratorConfig(
            spanmetrics=sm,
            localblocks=lbm.LocalBlocksConfig(data_dir=str(root / side)))
        self.gen = mod(side, "generator").Generator(cfg, overrides=ov,
                                                    now=now, **kw)
        self.be = mod(side, "backend.mem").MemBackend()
        bbm = mod(side, "blockbuilder")
        self.bb = bbm.BlockBuilder(self.bus, self.be,
                                   bbm.BlockBuilderConfig(partitions=None),
                                   now=now, **kw)
        self.db = mod(side, "db.tempodb").TempoDB(self.be, self.be, now=now,
                                                  **kw)
        ring = mod(side, "ring").Ring(replication_factor=1, now=now)
        qm = mod(side, "querier")
        self.q = qm.Querier(self.db, ring, {}, cfg=qm.QuerierConfig(rf=1))

    def push(self, traces):
        produce(self.side, self.bus, traces)
        got = drain(lambda: self.gen.consume_bus(self.bus))
        assert drain(self.bb.consume_cycle) == got > 0
        self.db.poll_now()

    def frontend(self, db=None, **cfg):
        fm = mod(self.side, "frontend")
        return fm.Frontend(db or self.db, self.q, cfg=fm.FrontendConfig(**cfg),
                           generator_query_range=self.gen.query_range,
                           now=self.now)

    def sidecars(self, be=None):
        sc = mod(self.side, "block.sidecar")
        return sorted((sc.read_sidecar(be or self.be, TENANT, m.block_id)
                       for m in self.db.blocklist.metas(TENANT)),
                      key=lambda s: (s.total_spans, s.hll.tolist()))


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """Both stacks after the history leg, the 20 minutes and the recent
    leg (the local blocks still uncut)."""
    root = tmp_path_factory.mktemp("bb")
    rng = np.random.default_rng(20261017)
    history = balanced(traces_at(rng, T0, n_traces=48))
    recent = balanced(traces_at(rng, T0 + RECENT_S, n_traces=48))
    out = {side: Stack(side, root) for side in ("ref", "port")}
    for st in out.values():
        st.push(history)
        st.clock[0] += RECENT_S
        st.push(recent)
    durs = np.array([(s["end_unix_nano"] - s["start_unix_nano"]) / 1e9
                     for _, spans in history + recent for s in spans])
    yield out, durs
    for st in out.values():
        st.db.shutdown()


def window(st, end_s=None):
    end = st.clock[0] + 60.0 if end_s is None else end_s
    return dict(start_s=T0 - 600.0, end_s=end, step_s=end - (T0 - 600.0))


def totals(series):
    return {s.labels: float(np.nansum(s.samples)) for s in series}


# ---------------------------------------------------------------------------
# the block-builder (tests/test_ingest_bus.py:61, tests/test_compact.py:303)
# ---------------------------------------------------------------------------

def test_blockbuilder_commit_after_flush():
    from tempo_tpu_torch.backend.mem import MemBackend
    from tempo_tpu_torch.blockbuilder import BlockBuilder, BlockBuilderConfig
    from tempo_tpu_torch.blockbuilder.blockbuilder import (CONSUMER_GROUP,
                                                           produce_traces)
    from tempo_tpu_torch.db.tempodb import TempoDB
    from tempo_tpu_torch.ingest import Bus

    bus = Bus(n_partitions=2)
    be = MemBackend()
    traces = [(bytes([i, i]) * 8, [
        {"trace_id": bytes([i, i]) * 8, "span_id": bytes([j + 1]) * 8,
         "name": f"op-{j}", "service": "svc",
         "start_unix_nano": int((T0 + i) * 1e9),
         "end_unix_nano": int((T0 + i) * 1e9) + 10 ** 6, "attrs": {"k": j}}
        for j in range(2)]) for i in range(1, 21)]
    mat = np.stack([np.frombuffer(t[0], np.uint8) for t in traces])
    produce_traces(bus, "acme", traces, token_for("acme", mat))
    total = bus.high_watermark(0) + bus.high_watermark(1)
    assert bus.high_watermark(0) and bus.high_watermark(1)

    bb = BlockBuilder(bus, be, BlockBuilderConfig(partitions=(0, 1)),
                      device="cpu")
    assert bb.consume_cycle() == total == bb.records_consumed
    assert bus.lag(CONSUMER_GROUP, 0) == bus.lag(CONSUMER_GROUP, 1) == 0
    assert bb.consume_cycle() == 0
    db = TempoDB(be, be, device="cpu")
    db.poll_now()
    metas = db.blocklist.metas("acme")
    assert len(metas) == bb.blocks_flushed == 2
    assert sum(m.total_objects for m in metas) == 20
    assert all(m.replication_factor == 1 and m.sidecar for m in metas)
    # crash-replay: un-commit partition 0 and reconsume — blocks duplicate
    # (at-least-once), compaction dedupes
    bus.commit(CONSUMER_GROUP, 0, 0)
    bb.consume_cycle()
    db.poll_now()
    assert sum(m.total_objects for m in db.blocklist.metas("acme")) > 20
    assert db.compact_tenant_once("acme") == 1
    metas = db.blocklist.metas("acme")
    assert sum(m.total_objects for m in metas) == 20  # deduped again
    assert sum(m.total_spans for m in metas) == 40
    assert all(m.sidecar and m.compaction_level == 1 for m in metas)
    db.shutdown()


def test_blockbuilder_emits_sidecar_at_cut_and_splits_blocks():
    from tempo_tpu_torch.backend.mem import MemBackend
    from tempo_tpu_torch.block.sidecar import read_sidecar
    from tempo_tpu_torch.blockbuilder import BlockBuilder, BlockBuilderConfig
    from tempo_tpu_torch.db.tempodb import TempoDB
    from tempo_tpu_torch.ingest.bus import Bus
    from tempo_tpu_torch.ingest.encoding import produce_traces

    be = MemBackend()
    bus = Bus(n_partitions=1)
    traces = traces_at(np.random.default_rng(3), T0, n_traces=5, spans=1)
    mat = np.stack([np.frombuffer(t, np.uint8) for t, _ in traces])
    produce_traces(bus, "t1", traces, token_for("t1", mat))
    bb = BlockBuilder(bus, be, BlockBuilderConfig(max_block_objects=2),
                      device="cpu")
    assert bb.consume_cycle() == 1
    db = TempoDB(be, be, device="cpu")
    db.poll_now()
    metas = db.blocks("t1")
    assert len(metas) == 3 and all(m.sidecar for m in metas)
    assert sorted(read_sidecar(be, "t1", m.block_id).total_spans
                  for m in metas) == [1, 2, 2]
    off = MemBackend()
    bus2 = Bus(n_partitions=1)
    produce_traces(bus2, "t1", traces, token_for("t1", mat))
    BlockBuilder(bus2, off, BlockBuilderConfig(sidecars=False),
                 device="cpu").consume_cycle()
    db2 = TempoDB(off, off, device="cpu")
    db2.poll_now()
    (m,) = db2.blocks("t1")
    assert not m.sidecar and read_sidecar(off, "t1", m.block_id) is None
    db.shutdown()
    db2.shutdown()


def test_consumer_group_mode_raises_naming_item_14():
    """`BlockBuilderConfig(partitions=None)` on a Kafka bus: the name is
    kept from when the mode raised; since item 14 the block-builder joins
    the consumer group and builds the same blocks as the reference's
    (`tests/test_ingest_bus.py:589`), committing with the generation."""
    import importlib

    from tests.mock_kafka import start_mock_kafka

    rng = np.random.default_rng(14)
    traces = []
    for i in range(6):
        tid = rng.bytes(16)
        traces.append((tid, [{"trace_id": tid, "span_id": rng.bytes(8),
                              "name": f"op-{i}", "service": "svc",
                              "start_unix_nano": int(T0 * 1e9) + i,
                              "end_unix_nano": int(T0 * 1e9) + 10 ** 6 + i,
                              "kind": 2, "status_code": 0}]))
    out = []
    for pkg in ("tempo_tpu", "tempo_tpu_torch"):
        m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        srv, port, _ = start_mock_kafka(n_partitions=2)
        bus = m("ingest.kafka").KafkaBus(f"127.0.0.1:{port}",
                                         n_partitions=2, timeout_s=5.0)
        try:
            for k, (tid, spans) in enumerate(traces):
                bus.produce(k % 2, "t", m("ingest.encoding").encode_push(
                    [(tid, spans)])[0])
            be = m("backend.mem").MemBackend()
            bbm = m("blockbuilder")
            kw = {"device": "cpu"} if pkg == "tempo_tpu_torch" else {}
            bb = bbm.BlockBuilder(bus, be, bbm.BlockBuilderConfig(
                partitions=None, sidecars=False), now=lambda: T0, **kw)
            n = bb.consume_cycle()
            metas = [m("backend.meta").read_block_meta(be, b, "t")
                     for b in m("backend.raw").blocks(be, "t")]
            out.append((n, bb._cg.assignment, bb._cg.generation >= 0,
                        sorted(x.total_objects for x in metas),
                        [bus.committed("blockbuilder", p) for p in (0, 1)],
                        bb.consume_cycle()))
        finally:
            bus.close()
            srv.shutdown()
    assert out[0] == out[1]
    assert out[1] == (6, [0, 1], True, [3, 3], [3, 3], 0)


def test_sidecar_merge_and_cardinality_match_reference():
    """`tests/test_compact.py:191`, each package on the same columns."""
    from tempo_tpu.block import sidecar as jsc
    from tempo_tpu_torch.block import sidecar as tsc

    rng = np.random.default_rng(4)
    tid = rng.integers(0, 256, (400, 16)).astype(np.uint8)
    svc = np.array(["a", "b"] * 200)
    nam = np.array(["x"] * 400)
    dur = rng.integers(10_000, 10_000_000, 400)
    sc = tsc.build_sidecar(svc, nam, dur, tid, device="cpu")
    jsc_ = jsc.build_sidecar(svc, nam, dur, tid)
    assert sc.total_spans == 400 and set(sc.series) == {("a", "x"),
                                                        ("b", "x")}
    np.testing.assert_array_equal(sc.hll, jsc_.hll)
    est = sc.trace_cardinality()
    assert 0.8 * 400 <= est <= 1.2 * 400
    assert est == pytest.approx(jsc_.trace_cardinality(), rel=1e-6)
    both = tsc.merge_sidecars(sc, sc)
    assert both.total_spans == 800
    assert abs(both.trace_cardinality() - est) < 1e-6
    empty = tsc.sidecar_from_traces([], device="cpu")
    assert empty.to_json() == jsc.sidecar_from_traces([]).to_json()


# ---------------------------------------------------------------------------
# both writers behind one frontend
# ---------------------------------------------------------------------------

def test_sidecars_match_reference_block_for_block(stacks):
    sts, _ = stacks
    ref, port = sts["ref"], sts["port"]
    a, b = port.sidecars(), ref.sidecars()
    assert len(a) == len(b) == 4          # 2 partitions x 2 cycles
    k = a[0].k
    for x, y in zip(a, b):
        assert (x.total_spans, x.series, x.k, x.lo, x.hi) == \
            (y.total_spans, y.series, y.k, y.lo, y.hi)
        np.testing.assert_array_equal(x.hll, y.hll)
        np.testing.assert_array_equal(x.rows[:, 0], y.rows[:, 0])
        np.testing.assert_array_equal(x.rows[:, k + 1:], y.rows[:, k + 1:])
        np.testing.assert_allclose(x.rows[:, 1:k + 1], y.rows[:, 1:k + 1],
                                   rtol=1e-5, atol=1e-5 * x.total_spans)
        assert x.trace_cardinality() == pytest.approx(
            y.trace_cardinality(), rel=1e-6)


def test_frontend_rate_over_both_legs_matches_reference(stacks):
    sts, _ = stacks
    got = {}
    for side, st in sts.items():
        fe = st.frontend()
        got[side] = totals(fe.query_range(TENANT, RATE, **window(st)))
        stats = st.db.compaction_stats
        assert stats["sidecar_folds"] > 0 and stats["sidecar_fallbacks"] == 0
        scan = totals(st.frontend(sidecar_folds=False).query_range(
            TENANT, RATE, **window(st)))
        assert set(scan) == set(got[side])
        for key in scan:
            assert got[side][key] == pytest.approx(scan[key], rel=1e-9)
        # the multi-step grid, each side's fold and generator leg
        st_w = dict(start_s=T0 - 600.0, end_s=st.clock[0] + 60.0,
                    step_s=60.0)
        got[side + "-steps"] = {
            s.labels: s.samples for s in fe.query_range(TENANT, RATE, **st_w)}
    assert got["port"] == got["ref"]
    assert len(got["port"]) == 3 and all(v > 0 for v in got["port"].values())
    assert set(got["port-steps"]) == set(got["ref-steps"])
    for key, v in got["port-steps"].items():
        np.testing.assert_array_equal(v, got["ref-steps"][key])


def test_frontend_quantiles_within_the_moments_gate(stacks):
    sts, durs = stacks
    got = {}
    for side, st in sts.items():
        fe = st.frontend()
        for query in (QUANT, QUANT_ALL):
            got[side, query] = totals(fe.query_range(TENANT, query,
                                                     **window(st)))
        assert st.db.compaction_stats["sidecar_fallbacks"] == 0
    for query, n in ((QUANT, 6), (QUANT_ALL, 2)):
        a, b = got["port", query], got["ref", query]
        assert set(a) == set(b) and len(a) == n
        for key in a:
            assert a[key] == pytest.approx(b[key], rel=1e-2)
    for labels, v in got["port", QUANT_ALL].items():
        q = dict(labels)["p"]
        exact = np.quantile(durs, q)
        rel = abs(v - exact) / exact
        rank = abs(np.mean(durs <= v) - q)
        assert min(rel, rank) <= 0.05, (q, v, exact, rel, rank)


def test_recent_leg_equal_before_and_after_the_local_cut(stacks):
    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

    sts, _ = stacks
    st = sts["port"]
    inst = st.gen.instance(TENANT)
    lb = inst.processors["local-blocks"]
    req = QueryRangeRequest(RATE, int((T0 - 600) * 1e9),
                            int((st.clock[0] + 60) * 1e9), 60 * 10**9)
    before = totals(st.gen.query_range(TENANT, req))
    assert not lb.inst.complete_blocks()
    inst.tick(immediate=True)
    assert len(lb.inst.complete_blocks()) == 1
    assert not lb.inst.all_recent_traces()
    after = totals(st.gen.query_range(TENANT, req))
    assert before == after and sum(after.values()) == 2 * 24 * 4
    res = st.gen.get_metrics(TENANT, "{ }", ["resource.service.name"])
    assert sum(s.histogram.count for s in res.results()) == 2 * 24 * 4


def test_sidecar_bytes_fold_across_packages(stacks):
    """The reference's frontend folds the port's sidecar bytes and the
    port's folds the reference's, over the history window (every block
    folds: no block data is read)."""
    sts, _ = stacks
    hist = dict(start_s=T0 - 600.0, end_s=T0 + 200.0, step_s=800.0)
    out = {}
    for reader in ("ref", "port"):
        for writer in ("ref", "port"):
            st = sts[reader]
            be = mod(reader, "backend.mem").MemBackend()
            be._objects.update(sts[writer].be._objects)
            kw = {"device": "cpu"} if reader == "port" else {}
            db = mod(reader, "db.tempodb").TempoDB(be, be, now=st.now, **kw)
            db.poll_now()
            fe = st.frontend(db=db)
            out[reader, writer] = (
                totals(fe.query_range(TENANT, RATE, **hist)),
                totals(fe.query_range(TENANT, QUANT, **hist)))
            assert db.compaction_stats["sidecar_folds"] > 0
            assert db.compaction_stats["sidecar_fallbacks"] == 0
            db.shutdown()
    for writer in ("ref", "port"):
        assert out["ref", writer] == out["port", writer]
    assert out["ref", "ref"][0] == out["ref", "port"][0]
    a, b = out["ref", "ref"][1], out["ref", "port"][1]
    assert set(a) == set(b) and len(a) == 6
    for key in a:
        assert a[key] == pytest.approx(b[key], rel=1e-3)
