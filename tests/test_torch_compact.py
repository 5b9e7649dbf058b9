"""The port's cold tier against the reference: the compaction merge
(`ops/compact.merge_order`), the device and host compaction routes
(`db/compactor.py`), `TempoDB`'s sweeps, the compactor service, the
sidecar backfill and retention.

Mirrors `tests/test_compact.py:45-161,325-393`, the compaction arms of
`tests/test_db.py` and the compactor-ring tests of
`tests/test_ingest_bus.py`, each run on both packages from the same
seeded inputs. The port's merge runs as torch ops on the CPU here (the
chip smoke's phase 14b holds it on the card). Rows are read back through
the reference's pyarrow reader in both packages, since the port's codec
writes gzip blocks that pyarrow reads (the reference's zstd blocks the
port cannot read).

One difference is deliberate (ROADMAP section 3): a failed device
compaction does not fall back to the host merge in the port; it raises
to the compaction loop, which logs it, and leaves its inputs live.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

from tempo_tpu import sched as jsched
from tempo_tpu.backend.mem import MemBackend as JMem
from tempo_tpu.block.reader import BackendBlock as JBlock
from tempo_tpu.compactor import Compactor as JCompactor
from tempo_tpu.db import CompactorConfig as JCompCfg
from tempo_tpu.db import TempoDB as JDB
from tempo_tpu.db import TempoDBConfig as JCfg
from tempo_tpu.db import compactor as jcomp
from tempo_tpu.ops import compact as jcops
from tempo_tpu.ring import KVStore as JKV
from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.backend.mem import MemBackend as TMem
from tempo_tpu_torch.backend.meta import has_meta
from tempo_tpu_torch.block.sidecar import read_sidecar
from tempo_tpu_torch.compactor import Compactor as TCompactor
from tempo_tpu_torch.db import CompactorConfig as TCompCfg
from tempo_tpu_torch.db import TempoDB as TDB
from tempo_tpu_torch.db import TempoDBConfig as TCfg
from tempo_tpu_torch.db import compactor as tcomp
from tempo_tpu_torch.ops import compact as tcops
from tempo_tpu_torch.ring import KVStore as TKV
from tests.test_block import trace
from tests.test_compact import _overlapping_blocks

STATS0 = {"blocks": 0, "spans": 0, "device_seconds": 0.0,
          "sidecars_written": 0}


@pytest.fixture(autouse=True)
def _singletons():
    """The port's process scheduler is reset around each test (the
    reference's is reset by tests/conftest.py)."""
    tsched.reset()
    yield
    tsched.reset()


def merge(tid, sid):
    return tcops.merge_order(tid, sid, device="cpu")


# ---------------------------------------------------------------------------
# the merge against the reference's kernel and its oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trial", range(6))
def test_merge_order_matches_reference_fuzz(trial):
    """`tests/test_compact.py:45`: few distinct ids, so many duplicate
    (trace, span) pairs across rows, equal to both reference orders."""
    rng = np.random.default_rng(11 + trial)
    n = int(rng.integers(1, 400))
    tid = rng.integers(0, 30, (n, 16)).astype(np.uint8)
    sid = rng.integers(0, 4, (n, 8)).astype(np.uint8)
    got = merge(tid, sid)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jcops.merge_order(tid, sid))
    np.testing.assert_array_equal(got, jcops.reference_merge_order(tid, sid))
    np.testing.assert_array_equal(tcops.reference_merge_order(tid, sid),
                                  jcops.reference_merge_order(tid, sid))


@pytest.mark.parametrize("seed", range(4))
def test_merge_order_all_ff_ids_and_sign_bits(seed):
    """Ids of sixteen 0xFF bytes (the reference's pad limbs), ids with
    the top bit of either half set (the int64 keys' sign bits) and the
    all-zero id, mixed with duplicates: the port pads nothing, so every
    such row keeps its place."""
    rng = np.random.default_rng(100 + seed)
    n = 300
    pool = np.array([[0xFF] * 16, [0] * 16, [0x80] + [0] * 15,
                     [0x7F] + [0xFF] * 15, [0] * 8 + [0x80] + [0] * 7,
                     [0xFF] * 8 + [0] * 8], np.uint8)
    tid = np.where(rng.random((n, 1)) < 0.7,
                   pool[rng.integers(0, len(pool), n)],
                   rng.integers(0, 256, (n, 16)).astype(np.uint8))
    spool = np.array([[0xFF] * 8, [0] * 8, [0x80] + [0] * 7], np.uint8)
    sid = spool[rng.integers(0, len(spool), n)]
    got = merge(tid, sid)
    np.testing.assert_array_equal(got, jcops.reference_merge_order(tid, sid))
    np.testing.assert_array_equal(got, jcops.merge_order(tid, sid))
    ff = np.flatnonzero((tid == 0xFF).all(1))
    kept_ff = [i for i in got if i in set(ff)]
    assert kept_ff and got[-len(kept_ff):].tolist() == kept_ff


def test_merge_order_empty_and_single():
    z16 = np.zeros((0, 16), np.uint8)
    z8 = np.zeros((0, 8), np.uint8)
    assert len(merge(z16, z8)) == 0
    one = merge(np.ones((1, 16), np.uint8), np.ones((1, 8), np.uint8))
    np.testing.assert_array_equal(one, [0])
    ff = merge(np.full((1, 16), 0xFF, np.uint8), np.full((1, 8), 0xFF,
                                                         np.uint8))
    np.testing.assert_array_equal(ff, [0])


def test_merge_order_byte_lexicographic():
    """`tests/test_compact.py:67`: byte 0 outranks byte 15, and within a
    half the high byte outranks the sign of a little-endian read."""
    a = np.zeros((4, 16), np.uint8)
    a[0, 15] = 1   # 00..01
    a[1, 0] = 1    # 01..00
    a[2, 7] = 0x80
    a[3, 8] = 0xFF
    sid = np.arange(4, dtype=np.uint8).repeat(8).reshape(4, 8)
    assert merge(a, sid).tolist() == [0, 3, 2, 1]
    assert jcops.merge_order(a, sid).tolist() == [0, 3, 2, 1]


def test_merge_order_defaults_to_cuda():
    """The merge runs on `cuda` unless the CPU is asked for; without a
    card it raises rather than run elsewhere."""
    import torch

    tid = np.zeros((2, 16), np.uint8)
    sid = np.zeros((2, 8), np.uint8)
    if torch.cuda.is_available():
        assert len(tcops.merge_order(tid, sid)) == 1
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcops.merge_order(tid, sid)


# ---------------------------------------------------------------------------
# device route against the host route and against the reference
# ---------------------------------------------------------------------------

def _read_rows(be, metas):
    """Every row of the blocks through the reference's pyarrow reader,
    blocks in trace-id order (`tests/test_compact.py:99`)."""
    rows = []
    for m in sorted(metas, key=lambda m: m.min_trace_id):
        tb = JBlock(be, m).parquet_file().read()
        cols = {c: tb.column(c).to_pylist() for c in tb.schema.names}
        rows.extend(zip(*[cols[c] for c in sorted(cols)]))
    return rows


def _build(pkg, blocks, row_group_rows=16):
    be = TMem() if pkg == "port" else JMem()
    if pkg == "port":
        db = TDB(be, be, TCfg(row_group_rows=row_group_rows), device="cpu")
    else:
        db = JDB(be, be, JCfg(row_group_rows=row_group_rows))
    for blk in blocks:
        db.write_block("t1", blk, replication_factor=1)
    db.poll_now()
    return be, db, sorted(db.blocks("t1"), key=lambda m: m.block_id)


@pytest.mark.parametrize("seed,n_blocks,n_traces,max_objects",
                         [(5, 3, 25, None), (9, 2, 30, 7), (13, 4, 12, 3)])
def test_device_compaction_bit_parity_with_host_and_reference(
        seed, n_blocks, n_traces, max_objects):
    """`tests/test_compact.py:112,138`: the device route's rows equal the
    host route's bit for bit, output blocks cut at the same trace
    boundaries; both equal the reference's device route."""
    blocks = _overlapping_blocks(np.random.default_rng(seed),
                                 n_blocks=n_blocks, n_traces=n_traces)
    kw = {} if max_objects is None else {"max_block_objects": max_objects}
    be_h, _, metas_h = _build("port", blocks)
    be_d, _, metas_d = _build("port", blocks)
    be_j, _, metas_j = _build("ref", blocks)
    out_h = tcomp.compact(be_h, be_h, "t1", metas_h, TCompCfg(**kw))
    stats = dict(STATS0)
    out_d = tcomp.compact_device(be_d, be_d, "t1", metas_d, TCompCfg(**kw),
                                 stats, device="cpu")
    # the reference's route with its sidecar pass off: its jitted pass
    # compiles per block shape (seconds a block on the CPU);
    # test_backfill_skips_done_and_respects_limit holds the port's
    # sidecars against the reference's
    jstats = dict(STATS0)
    out_j = jcomp.compact_device(be_j, be_j, "t1", metas_j,
                                 JCompCfg(sidecars=False, **kw), jstats)
    rows_d = _read_rows(be_d, out_d)
    assert rows_d == _read_rows(be_h, out_h)
    assert len(out_d) == len(out_h) == len(out_j)
    if max_objects is not None:
        assert len(out_d) > 1
    # the reference's rows (its trace_idx is int64 after its set_column,
    # the port's the schema's int32: the values agree)
    assert rows_d == _read_rows(be_j, out_j)
    for key in ("blocks", "spans"):
        assert stats[key] == jstats[key], key
    assert stats["device_seconds"] > 0.0
    # sidecars born with the merged blocks, the meta marker flipped,
    # each equal to the sidecar of its own rows
    assert stats["sidecars_written"] == len(out_d)
    from tempo_tpu_torch.block.reader import BackendBlock as TBlock
    from tempo_tpu_torch.db.compactor import iter_trace_groups
    from tempo_tpu_torch.block.sidecar import sidecar_from_traces
    for m in out_d:
        assert m.sidecar
        got = read_sidecar(be_d, "t1", m.block_id)
        want = sidecar_from_traces(
            list(iter_trace_groups(TBlock(be_d, m))), device="cpu")
        assert got.series == want.series
        assert got.total_spans == want.total_spans
        np.testing.assert_array_equal(got.hll, want.hll)
        np.testing.assert_allclose(got.rows, want.rows, rtol=1e-6)
    for m in metas_d:
        assert has_meta(be_d, m.block_id, "t1") == (False, True)


def test_compaction_merges_and_marks():
    """`tests/test_db.py:72`, on the port's default (device) route and on
    the host route: one level-1 block, the merged trace deduped."""
    for device_route in (True, False):
        be = TMem()
        db = TDB(be, be, device="cpu")
        db.cfg.compactor.device = device_route
        tid, spans = trace(4, n_spans=3)
        m1 = db.write_block("t1", [trace(1), (tid, spans[:2])])
        m2 = db.write_block("t1", [(tid, spans), trace(9)])
        assert db.compact_tenant_once("t1") == 1
        metas = db.blocks("t1")
        assert len(metas) == 1 and metas[0].compaction_level == 1
        assert metas[0].total_objects == 3
        assert metas[0].total_spans == 9
        assert metas[0].sidecar is device_route
        assert has_meta(be, m1.block_id, "t1") == (False, True)
        assert has_meta(be, m2.block_id, "t1") == (False, True)
        assert len(db.find_trace_by_id("t1", tid)) == 3
        assert db.compaction_stats["blocks"] == (2 if device_route else 0)
        db.shutdown()


def test_db_device_route_and_cache_eviction():
    """`tests/test_compact.py:161`: compact_tenant_once through the device
    route evicts the inputs' plane-cache entries and cached folds."""
    be, db, _ = _build("port", _overlapping_blocks(
        np.random.default_rng(2), n_blocks=2, n_traces=10))
    inputs = db.blocks("t1")
    assert len(inputs) >= 2
    for m in inputs:
        db.planes.get(db.backend_block(m))
        db.planes.fold_put("t1", m.block_id, ("win",), [])
        assert db.planes.fold_get("t1", m.block_id, ("win",)) == []
    assert db.compact_tenant_once("t1") >= 1
    assert db.compaction_stats["blocks"] >= 2
    assert db.compaction_stats["device_seconds"] > 0.0
    for m in inputs:
        assert db.planes.peek("t1", m.block_id) is None
        assert db.planes.fold_get("t1", m.block_id, ("win",)) is None
    db.shutdown()


def test_crash_replay_deduped_by_compaction_matches_reference():
    """`tests/test_ingest_bus.py:61`, second half, in both packages: a
    reconsumed partition duplicates blocks, compaction dedupes, and the
    merged blocks hold the same rows."""
    from tempo_tpu.blockbuilder import BlockBuilder as JBB
    from tempo_tpu.blockbuilder import BlockBuilderConfig as JBBCfg
    from tempo_tpu.blockbuilder.blockbuilder import CONSUMER_GROUP
    from tempo_tpu.blockbuilder.blockbuilder import produce_traces as jprod
    from tempo_tpu.ingest import Bus as JBus
    from tempo_tpu_torch.blockbuilder import BlockBuilder as TBB
    from tempo_tpu_torch.blockbuilder import BlockBuilderConfig as TBBCfg
    from tempo_tpu_torch.blockbuilder.blockbuilder import \
        produce_traces as tprod
    from tempo_tpu_torch.ingest import Bus as TBus
    from tests.test_ingest_bus import mktrace, token_for

    traces = [mktrace(i) for i in range(1, 21)]
    mat = np.stack([np.frombuffer(t[0], np.uint8) for t in traces])
    rows = {}
    for pkg in ("port", "ref"):
        bus = TBus(n_partitions=2) if pkg == "port" else JBus(n_partitions=2)
        be = TMem() if pkg == "port" else JMem()
        (tprod if pkg == "port" else jprod)(bus, "acme", traces,
                                            token_for("acme", mat))
        if pkg == "port":
            bb = TBB(bus, be, TBBCfg(partitions=(0, 1)), device="cpu")
            db = TDB(be, be, device="cpu")
        else:
            # the reference's sidecar pass off (a jit compile a block
            # shape); the rows are what the test compares
            bb = JBB(bus, be, JBBCfg(partitions=(0, 1), sidecars=False))
            db = JDB(be, be, JCfg(compactor=JCompCfg(sidecars=False)))
        bb.consume_cycle()
        bus.commit(CONSUMER_GROUP, 0, 0)
        bb.consume_cycle()
        db.poll_now()
        assert sum(m.total_objects for m in db.blocklist.metas("acme")) > 20
        db.compact_tenant_once("acme")
        metas = db.blocklist.metas("acme")
        assert sum(m.total_objects for m in metas) == 20
        rows[pkg] = _read_rows(be, metas)
        db.shutdown()
    assert rows["port"] == rows["ref"]


# ---------------------------------------------------------------------------
# no fallback (a deliberate difference)
# ---------------------------------------------------------------------------

def test_device_failure_raises_without_host_fallback(monkeypatch, caplog):
    """The reference catches a failed device route and runs the host
    merge (warn-once). The port raises: its inputs stay live and
    unmarked, no output is written, and the compaction loop logs the
    failure. Only `compactor.device: false` runs the host merge."""
    blocks = _overlapping_blocks(np.random.default_rng(3), n_blocks=2,
                                 n_traces=8)
    be, db, inputs = _build("port", blocks)

    def boom(*_a, **_k):
        raise RuntimeError("merge failed on the device")

    monkeypatch.setattr(tcops, "merge_order", boom)
    with pytest.raises(RuntimeError, match="merge failed"):
        db.compact_tenant_once("t1")
    assert sorted(m.block_id for m in db.blocks("t1")) == \
        sorted(m.block_id for m in inputs)
    for m in inputs:
        assert has_meta(be, m.block_id, "t1") == (True, False)
    assert db.compaction_stats["blocks"] == 0
    # the loop logs it, as the reference's loop logs a failed cycle
    with caplog.at_level(logging.ERROR, logger="tempo_tpu_torch.db"):
        db.enable_compaction(0.01)
        import time
        deadline = time.time() + 5
        while time.time() < deadline and not any(
                "compaction cycle failed" in r.message for r in caplog.records):
            time.sleep(0.01)
    db.shutdown()
    assert any("compaction cycle failed" in r.message and r.exc_info
               for r in caplog.records)
    # the host route is the configured one only
    db.cfg.compactor.device = False
    db._stop.clear()
    assert db.compact_tenant_once("t1") == 1
    assert len(db.blocks("t1")) == 1 and not db.blocks("t1")[0].sidecar
    # the reference falls back on the same failure
    jbe, jdb, _ = _build("ref", blocks)
    monkeypatch.setattr(jcops, "merge_order", boom)
    assert jdb.compact_tenant_once("t1") == 1
    assert jdb.compaction_stats["blocks"] == 0


# ---------------------------------------------------------------------------
# the sweeps: backfill, retention, the compactor service, the families
# ---------------------------------------------------------------------------

def test_backfill_skips_done_and_respects_limit():
    """`tests/test_compact.py:325`, against the reference's sidecars."""
    blocks = _overlapping_blocks(np.random.default_rng(31), n_blocks=3,
                                 n_traces=6)
    be, db, _ = _build("port", blocks, row_group_rows=50_000)
    jbe, jdb, _ = _build("ref", blocks, row_group_rows=50_000)
    assert db.backfill_sidecars_once("t1", limit=2) == 2
    db.poll_now()
    assert db.backfill_sidecars_once("t1", limit=10) == 2
    db.poll_now()
    assert db.backfill_sidecars_once("t1", limit=10) == 0
    assert db.compaction_stats["sidecars_written"] == 4
    # the reference backfills one block (its jitted pass compiles per
    # block shape): that block's sidecar equals the port's
    assert jdb.backfill_sidecars_once("t1", limit=1) == 1
    jdb.poll_now()
    from tempo_tpu.block.sidecar import read_sidecar as jread
    key = lambda m: (m.min_trace_id, m.total_spans)
    done = [m for m in jdb.blocks("t1") if m.sidecar]
    assert len(done) == 1
    tm = {key(m): m for m in db.blocks("t1")}[key(done[0])]
    st = read_sidecar(be, "t1", tm.block_id)
    sj = jread(jbe, "t1", done[0].block_id)
    assert st.series == sj.series and st.total_spans == sj.total_spans
    np.testing.assert_array_equal(st.hll, sj.hll)
    np.testing.assert_allclose(st.rows, sj.rows, rtol=1e-5, atol=1e-6)
    assert db.backfill_sidecars_once("t1", limit=0) == 0
    db.cfg.compactor.sidecars = False
    assert db.backfill_sidecars_once("t1") == 0


def test_retention_deletes_after_grace():
    """`tests/test_db.py:90` on both packages."""
    for pkg in ("port", "ref"):
        clock = [1000.0]
        be = TMem() if pkg == "port" else JMem()
        db = TDB(be, be, now=lambda: clock[0], device="cpu") \
            if pkg == "port" else JDB(be, be, now=lambda: clock[0])
        db.cfg.compactor.retention_s = 100.0
        db.cfg.compactor.compacted_grace_s = 50.0
        db.write_block("t1", [trace(1)])
        marked, deleted = db.retention_once("t1")
        assert len(marked) == 1 and not deleted
        assert db.blocks("t1") == []
        clock[0] += 60.0
        marked, deleted = db.retention_once("t1")
        assert not marked and len(deleted) == 1
        from tempo_tpu_torch.backend.raw import KeyPath
        assert be.list(KeyPath(("t1",))) == []
        db.shutdown()


def test_compactor_ring_splits_ownership_like_reference():
    """`tests/test_ingest_bus.py:198,131`: two compactors split the job
    keys exactly as the reference's do, and a dead one's share fails
    over to the live one."""
    keys = [f"tenant-{i}/job" for i in range(40)]
    owned = {}
    for pkg, KV, C, DB, Mem in (("port", TKV, TCompactor, TDB, TMem),
                                ("ref", JKV, JCompactor, JDB, JMem)):
        be = Mem()
        db = DB(be, be, device="cpu") if pkg == "port" else DB(be, be)
        kv = KV()
        clock = [1000.0]
        c1 = C(db, kv, "compactor-1", now=lambda: clock[0])
        c2 = C(db, kv, "compactor-2", now=lambda: clock[0])
        o1 = {k for k in keys if c1.owns(k)}
        o2 = {k for k in keys if c2.owns(k)}
        assert o1 | o2 == set(keys) and not (o1 & o2) and o1 and o2
        owned[pkg] = o1
        assert all(C(db, None, "solo").owns(k) for k in keys)
        clock[0] += 30.0
        c1.heartbeat()
        clock[0] += 50.0
        assert all(c1.owns(k) for k in keys)
    assert owned["port"] == owned["ref"]


def test_compactor_run_once_sweeps_compaction_backfill_retention():
    """One `Compactor.run_once` over a tenant with overlapping blocks in
    one window and a lone block in another: the group merges with a
    sidecar, the lone block gets a backfilled sidecar, retention runs
    (the blocks are kept), and the sweep counter advances, as in the
    reference's service (`compactor/compactor.py:51`)."""
    blocks = _overlapping_blocks(np.random.default_rng(41), n_blocks=2,
                                 n_traces=8)
    be, db, inputs = _build("port", blocks)
    far = [(bytes([0xEE] * 16), [dict(
        trace(0xEE)[1][0], start_unix_nano=10 ** 16,
        end_unix_nano=10 ** 16 + 5)])]
    db.write_block("t1", far, replication_factor=1)
    db.cfg.compactor.retention_s = 1e12      # keep the old blocks
    c = TCompactor(db)
    assert c.owns("any") and c.run_once() == 2    # one merge, one backfill
    metas = db.blocks("t1")
    assert len(metas) == 2 and all(m.sidecar for m in metas)
    assert sorted(m.compaction_level for m in metas) == [0, 1]
    assert db.compaction_stats["blocks"] == len(inputs)
    assert db.compaction_stats["sidecars_written"] == 2
    assert "tempo_compactor_sweeps_total 1" in db.obs.render()
    db.cfg.compactor.retention_s = 1.0        # now everything expires
    c.run_once()
    assert db.blocks("t1") == []
    db.shutdown()


def test_compaction_families_registered_and_advance():
    """`tests/test_compact.py:387`: every `tempo_compaction_*` family and
    the cycle histogram render, and a device compaction advances them."""
    be, db, inputs = _build("port", _overlapping_blocks(
        np.random.default_rng(7), n_blocks=2, n_traces=6))
    text = db.obs.render()
    for fam in ("blocks", "spans", "device_seconds", "sidecars_written",
                "sidecar_folds", "sidecar_fallbacks"):
        assert f"tempo_compaction_{fam}_total" in text, fam
    assert "tempo_compactor_cycle_duration_seconds" in text
    db.compact_tenant_once("t1")
    fam = lambda name: dict(db.obs.get(name).fn())[()]
    assert fam("tempo_compaction_blocks_total") == len(inputs)
    assert fam("tempo_compaction_spans_total") == \
        db.compaction_stats["spans"] > 0
    assert fam("tempo_compaction_sidecars_written_total") >= 1
    assert "tempo_compactor_cycle_duration_seconds_count 1" in \
        db.obs.render()
    db.shutdown()


# ---------------------------------------------------------------------------
# the scheduler's compaction class (`tests/test_compact.py:352-385`)
# ---------------------------------------------------------------------------

def _submit_compaction(S, sc, order, tag="compaction"):
    job = S.Job(priority=S.PRIO_COMPACTION, kernel=tag,
                fn=lambda: order.append(tag))
    with sc._cond:
        sc._queues[S.PRIO_COMPACTION].append(job)


@pytest.mark.parametrize("S", [tsched, jsched], ids=["port", "ref"])
def test_compaction_min_share_survives_sustained_ingest(S):
    sc = S.DeviceScheduler(S.SchedConfig(batch_window_ms=0.0,
                                         compaction_min_share=0.25),
                           start_worker=False)
    order = []
    _submit_compaction(S, sc, order)
    for _ in range(8):
        sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4,
                       lambda s: order.append("ingest"), pads=(-1,))
        sc.drain_once()
    assert "compaction" in order
    assert order.index("compaction") <= int(1 / 0.25) + 1
    assert sc.comp_forced_total >= 1
    sc.stop()


@pytest.mark.parametrize("S", [tsched, jsched], ids=["port", "ref"])
def test_compaction_share_zero_starves_under_load(S):
    sc = S.DeviceScheduler(S.SchedConfig(batch_window_ms=0.0,
                                         compaction_min_share=0.0),
                           start_worker=False)
    order = []
    _submit_compaction(S, sc, order)
    for _ in range(40):
        sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4,
                       lambda s: order.append("ingest"), pads=(-1,))
        sc.drain_once()
    assert "compaction" not in order
    sc.drain_once()
    assert order[-1] == "compaction"
    sc.stop()


def test_compaction_rides_the_scheduler_compaction_class():
    """Under a configured scheduler the merge is one compaction-class
    job (kernel `compaction_merge`), as in the reference."""
    sc = tsched.configure(tsched.SchedConfig())
    be, db, _ = _build("port", _overlapping_blocks(
        np.random.default_rng(17), n_blocks=2, n_traces=6))
    seen = []
    inner = sc.run
    sc.run = lambda fn, **kw: (seen.append(kw), inner(fn, **kw))[1]
    assert db.compact_tenant_once("t1") == 1
    assert seen and seen[0]["kernel"] == "compaction_merge"
    assert seen[0]["priority"] == tsched.PRIO_COMPACTION
    assert seen[0]["tenant"] == "t1"
    db.shutdown()
