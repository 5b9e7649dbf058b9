"""The port's generator fleet: checkpoint/restore, placement, handoff.

Mirrors `tests/test_fleet.py` (its 17 tests) on the port's instances on
the CPU: a fresh-instance restore is add-to-zero and bit-identical
(dense, paged, and paged into dense), a restore into an instance that
already took deltas equals an uninterrupted oracle (counts exact, sums
at rtol 1e-5, the reference test's tolerance), mismatched blobs are
refused before any row is written, and two `FleetController`s over one
`KVStore` hand a tenant off with zero loss. The reference's two
App-worker process tests run `python -m tempo_tpu_torch.fleet.worker`,
which runs on the card; here they are mirrored in process (an App built
on the CPU from the same YAML, served, abandoned without shutdown and
booted again over the same directories), and `chip_smoke.py` phase 15c
runs the real processes. The `--kv-only` worker needs no card and runs
as a real process here.

Differentials: a checkpoint blob the reference cut restores into the
port, and the port's into the reference, to equal samples by label
strings (counts exact, sums at rtol 1e-6); and the trace-analytics
checkpoint tests of `tests/test_traceanalytics.py` (aux planes).
"""

from __future__ import annotations

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.backend.mem import MemBackend
from tempo_tpu_torch.fleet import RETRY_CAUSES, STATS, FleetConfig
from tempo_tpu_torch.fleet import checkpoint as ck
from tempo_tpu_torch.fleet.controller import FleetController
from tempo_tpu_torch.fleet.placement import TenantPlacement, tenant_token
from tempo_tpu_torch.generator.generator import Generator
from tempo_tpu_torch.generator.instance import (GeneratorConfig,
                                                GeneratorInstance)
from tempo_tpu_torch.generator.processors.spanmetrics import SpanMetricsConfig
from tempo_tpu_torch.model.span_batch import SpanBatchBuilder
from tempo_tpu_torch.registry import RegistryOverrides
from tempo_tpu_torch.registry import pages as tpages
from tempo_tpu_torch.ring import KVStore, Lifecycler, Ring
from tempo_tpu_torch.utils import faults

NOW = 1700000000.0


@pytest.fixture(autouse=True)
def _singletons():
    """The fleet's process counters, the scheduler, the page pool and the
    fault points reset around each test."""
    def reset():
        tsched.reset()
        tpages.reset()
        faults.reset()
        for k in STATS:
            STATS[k] = type(STATS[k])(0)
        RETRY_CAUSES.clear()
    reset()
    yield
    reset()


def _cfg(sketch: str = "both", max_series: int = 1024,
         moments_k: int = 12) -> GeneratorConfig:
    return GeneratorConfig(
        processors=("span-metrics",),
        registry=RegistryOverrides(max_active_series=max_series),
        spanmetrics=SpanMetricsConfig(sketch=sketch, moments_k=moments_k))


def _inst(tenant="t1", **kw) -> GeneratorInstance:
    return GeneratorInstance(tenant, _cfg(**kw), now=lambda: NOW,
                             device="cpu")


def _spans(seed: int, n: int = 40) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [dict(trace_id=rng.bytes(16), span_id=rng.bytes(8),
                 name=f"op-{i % 5}", service=f"svc-{i % 3}", kind=2,
                 status_code=int(i % 7 == 0) * 2,
                 start_unix_nano=int(NOW * 1e9),
                 end_unix_nano=int(NOW * 1e9) + int(rng.integers(1, 5e8)))
            for i in range(n)]


def _push(inst, seed: int, n: int = 40) -> None:
    b = SpanBatchBuilder(inst.registry.interner)
    for s in _spans(seed, n):
        b.append(**s)
    inst.push_batch(b.build())


def _samples(inst) -> dict:
    inst.drain()
    return {(s.name, s.labels): s.value
            for s in inst.registry.collect(ts_ms=1)
            if not s.is_stale_marker}


def _assert_merge_equal(got: dict, want: dict, rel: float = 1e-5) -> None:
    """Count kinds bit-identical; float sums within f32 add order."""
    assert set(got) == set(want)
    for k, v in want.items():
        if k[0].endswith("_sum") or k[0] == "traces_spanmetrics_size_total":
            assert got[k] == pytest.approx(v, rel=rel), k
        else:
            assert got[k] == v, k


def _pool():
    return tpages.PagePool(tpages.PagePoolConfig(
        enabled=True, page_rows=64, arena_slots=4096), device="cpu")


# ---------------------------------------------------------------------------
# checkpoint round trips
# ---------------------------------------------------------------------------


def test_checkpoint_restore_roundtrip_bit_identical():
    a = _inst()
    _push(a, 1)
    blob = ck.snapshot_instance(a)
    b = _inst()
    stats = ck.restore_instance(b, blob)
    assert stats["dropped"] == 0 and stats["series"] > 0
    assert _samples(b) == _samples(a)
    pa, pb = a.processors["span-metrics"], b.processors["span-metrics"]
    assert pb.quantile(0.99) == pa.quantile(0.99)
    assert pb.dd_quantiles((0.5,)) == pa.dd_quantiles((0.5,))
    meta, _ = ck._decode(blob)
    assert meta["layout"] == "dense" and meta["spanmetrics"]["tier"] == "both"


def test_checkpoint_restore_through_backend_objects():
    be = MemBackend()
    a = _inst("te/nant")                 # path-hostile tenant name
    _push(a, 2)
    blob = ck.snapshot_instance(a)
    name = ck.checkpoint_name(NOW, "gen-a")
    ck.write_checkpoint(be, "fleet-checkpoints", "te/nant", blob, name)
    assert ck.list_checkpoints(be, "fleet-checkpoints") == {"te/nant": [name]}
    got = ck.read_checkpoint(be, "fleet-checkpoints", "te/nant", name)
    b = _inst("te/nant")
    ck.restore_instance(b, got)
    assert _samples(b) == _samples(a)
    ck.delete_checkpoint(be, "fleet-checkpoints", "te/nant", name)
    assert ck.list_checkpoints(be, "fleet-checkpoints") == {}


@pytest.mark.parametrize("compact", [False, True])
def test_checkpoint_restore_roundtrip_paged_and_cross_layout(compact):
    """Paged tenants snapshot backed pages only; the blob is layout-
    neutral (paged → paged and, f32, paged → dense bit for bit); the
    compact tier round-trips its int32 planes exactly and its bf16 sum
    pair into the primary column."""
    pool = _pool()
    with tpages.use(pool):
        cfg = _cfg()
        cfg.spanmetrics = SpanMetricsConfig(sketch="both",
                                            compact_state=compact)
        a = GeneratorInstance("pt", cfg, now=lambda: NOW, device="cpu")
        assert a.state_layout == "paged"
        _push(a, 3)
        blob = ck.snapshot_instance(a)
        b = GeneratorInstance("pt", cfg, now=lambda: NOW, device="cpu")
        ck.restore_instance(b, blob)
        want = _samples(a)
        assert _samples(b) == want
        assert b.processors["span-metrics"].quantile(0.9) == \
            a.processors["span-metrics"].quantile(0.9)
    if compact:
        meta, arrays = ck._decode(blob)
        assert arrays["traces_spanmetrics_calls_total::values"].dtype == \
            np.int32
        return
    dense = _inst("pt")
    ck.restore_instance(dense, blob)
    assert dense.state_layout == "dense"
    assert _samples(dense) == want


def test_restore_merges_inflight_deltas_like_oracle():
    a = _inst()
    _push(a, 1)
    blob = ck.snapshot_instance(a)
    b = _inst()
    _push(b, 2)                          # in-flight deltas land first
    ck.restore_instance(b, blob)
    oracle = _inst()
    _push(oracle, 1)
    _push(oracle, 2)
    _assert_merge_equal(_samples(b), _samples(oracle))
    assert b.processors["span-metrics"].dd_quantiles((0.99,)) == \
        oracle.processors["span-metrics"].dd_quantiles((0.99,))


def test_restore_rejects_mismatched_sketch_meta():
    a = _inst(moments_k=8)
    _push(a, 1)
    blob = ck.snapshot_instance(a)
    b = _inst(moments_k=12)
    with pytest.raises(ValueError):
        b.processors["span-metrics"].sketch_meta_check(
            ck._decode(blob)[0]["spanmetrics"])
    with pytest.raises(ck.CheckpointMismatch):
        ck.restore_instance(b, blob)
    assert _samples(b) == {}             # nothing merged


def test_restore_rejects_changed_label_layout():
    cfg = _cfg()
    cfg.spanmetrics = SpanMetricsConfig(sketch="both",
                                        dimensions=("http.status",))
    a = GeneratorInstance("t1", cfg, now=lambda: NOW, device="cpu")
    _push(a, 1)
    with pytest.raises(ck.CheckpointMismatch):
        ck.restore_instance(_inst(), ck.snapshot_instance(a))


# ---------------------------------------------------------------------------
# placement + controller handoff (an in-process fleet over one KVStore)
# ---------------------------------------------------------------------------


def _member(kv, be, iid):
    g = Generator(_cfg(), instance_id=iid, now=lambda: NOW, device="cpu")
    ring = Ring(kv=kv, key="generator", replication_factor=1,
                now=lambda: NOW)
    lc = Lifecycler(kv, iid, key="generator", now=lambda: NOW)
    fc = FleetController(g, ring, iid, be, be,
                         cfg=FleetConfig(enabled=True), now=lambda: NOW)
    return g, ring, lc, fc


def test_placement_agrees_across_members_and_spills_over():
    kv, be = KVStore(), MemBackend()
    _ga, ra, la, _ = _member(kv, be, "gen-a")
    _gb, rb, _lb, _ = _member(kv, be, "gen-b")
    pa, pb = TenantPlacement(ra, "gen-a"), TenantPlacement(rb, "gen-b")
    tenants = [f"t{i}" for i in range(50)]
    for t in tenants:
        assert pa.owner(t).id == pb.owner(t).id
    owned_a = {t for t in tenants if pa.owns(t)}
    owned_b = {t for t in tenants if pb.owns(t)}
    assert owned_a | owned_b == set(tenants) and not owned_a & owned_b
    assert owned_a and owned_b
    la.leave()
    assert all(pb.owner(t).id == "gen-b" for t in tenants)
    assert tenant_token("t1") == tenant_token("t1")


def test_controller_handoff_and_restore_zero_loss():
    kv, be = KVStore(), MemBackend()
    ga, ra, la, fa = _member(kv, be, "gen-a")
    gb, _rb, lb, fb = _member(kv, be, "gen-b")
    tenant = "handoff-tenant"
    owner_is_a = TenantPlacement(ra, "gen-a").owns(tenant)
    g_own, lc_own, fc_own = (ga, la, fa) if owner_is_a else (gb, lb, fb)
    g_other, fc_other = (gb, fb) if owner_is_a else (ga, fa)

    g_own.push_spans(tenant, _spans(1))
    lc_own.leave()
    fc_own.tick()                        # loss: drain + checkpoint + drop
    assert tenant not in g_own.tenants()
    fc_other.tick()                      # gain: restore + consume blob
    assert tenant in g_other.tenants()
    assert STATS["restores"] == 1 and STATS["handoffs"] == 1
    assert ck.list_checkpoints(be, "fleet-checkpoints") == {}
    g_other.push_spans(tenant, _spans(2))

    oracle = Generator(_cfg(), instance_id="oracle", now=lambda: NOW,
                       device="cpu")
    oracle.push_spans(tenant, _spans(1))
    oracle.push_spans(tenant, _spans(2))
    _assert_merge_equal(_samples(g_other.instance(tenant)),
                        _samples(oracle.instance(tenant)))
    assert g_other.instance(tenant).processors["span-metrics"] \
        .dd_quantiles((0.99,)) == \
        oracle.instance(tenant).processors["span-metrics"] \
        .dd_quantiles((0.99,))
    st = fc_other.status()
    assert st["held_tenants"] == 1 and st["owned_tenants"] == 1


def test_shutdown_checkpoint_then_boot_restore():
    kv, be = KVStore(), MemBackend()
    g1, _r1, _lc1, fc1 = _member(kv, be, "gen-solo")
    g1.push_spans("ta", _spans(4))
    g1.push_spans("tb", _spans(5))
    want_a, want_b = _samples(g1.instance("ta")), _samples(g1.instance("tb"))
    fc1.shutdown()
    assert set(ck.list_checkpoints(be, "fleet-checkpoints")) == {"ta", "tb"}
    g2, _r2, _lc2, fc2 = _member(kv, be, "gen-solo")
    fc2.tick()
    assert _samples(g2.instance("ta")) == want_a
    assert _samples(g2.instance("tb")) == want_b
    assert ck.list_checkpoints(be, "fleet-checkpoints") == {}


def test_quarantine_on_poison_checkpoint():
    kv, be = KVStore(), MemBackend()
    src = _inst("tq", moments_k=8)
    _push(src, 1)
    name = ck.checkpoint_name(NOW, "gen-old")
    ck.write_checkpoint(be, "fleet-checkpoints", "tq",
                        ck.snapshot_instance(src), name)
    g, _r, _lc, fc = _member(kv, be, "gen-q")   # moments_k=12 fleet
    fc.tick()
    assert _samples(g.instance("tq")) == {}
    assert ck.list_checkpoints(be, "fleet-checkpoints") == {"tq": [name]}
    assert fc.status()["quarantined_checkpoints"] == [f"tq/{name}"]
    fc.tick()
    assert fc.status()["quarantined_checkpoints"] == [f"tq/{name}"]


def test_checkpoint_ships_only_referenced_strings():
    a = _inst()
    _push(a, 1)
    a.registry.interner.intern_many([f"dead-string-{i}" for i in range(500)])
    blob = ck.snapshot_instance(a)
    meta, _arrays = ck._decode(blob)
    assert not any(s.startswith("dead-string-") for s in meta["strings"])
    b = _inst()
    ck.restore_instance(b, blob)
    assert _samples(b) == _samples(a)


def test_consumed_marker_prevents_replay():
    kv, be = KVStore(), MemBackend()
    src = _inst("tm")
    _push(src, 3)
    name = ck.checkpoint_name(NOW, "gen-dead")
    ck.write_checkpoint(be, "fleet-checkpoints", "tm",
                        ck.snapshot_instance(src), name)
    ck.mark_consumed(be, "fleet-checkpoints", "tm", name)
    assert ck.is_consumed(be, "fleet-checkpoints", "tm", name)
    assert ck.list_checkpoints(be, "fleet-checkpoints") == {"tm": [name]}
    g, _r, _lc, fc = _member(kv, be, "gen-m")
    fc.tick()
    assert _samples(g.instance("tm")) == {}
    assert STATS["restores"] == 0
    assert ck.list_checkpoints(be, "fleet-checkpoints") == {}
    assert not ck.is_consumed(be, "fleet-checkpoints", "tm", name)


def test_remove_instance_releases_pool_pages():
    pool = _pool()
    with tpages.use(pool):
        g = Generator(_cfg(), instance_id="gen-p", now=lambda: NOW,
                      device="cpu")
        g.push_spans("pp", _spans(6))
        assert g.instance("pp").state_layout == "paged"
        free_before = pool.free_pages()
        assert g.remove_instance("pp") is not None
        assert g.tenants() == []
        assert pool.free_pages() > free_before
        assert pool.free_pages() == pool.total_pages()


def test_snapshot_gathers_with_one_copy_per_dtype():
    """The snapshot selects every family's rows on the device and fetches
    them together: one device-to-host copy per dtype (f32 here; the
    compact tier adds int32)."""
    a = _inst()
    _push(a, 1)
    n0 = ck.D2H_COPIES
    ck.snapshot_instance(a)
    assert ck.D2H_COPIES - n0 == 1


def test_device_failure_in_restore_raises_without_host_retry(monkeypatch):
    """A failing scatter raises out of `restore_instance`: no host retry,
    and the controller keeps the blob (not consumed, not deleted)."""
    kv, be = KVStore(), MemBackend()
    src = _inst("tf")
    _push(src, 1)
    name = ck.checkpoint_name(NOW, "gen-x")
    ck.write_checkpoint(be, "fleet-checkpoints", "tf",
                        ck.snapshot_instance(src), name)

    def boom(*_a, **_k):
        raise RuntimeError("device scatter failed")

    monkeypatch.setattr(ck, "_scatter", boom)
    with pytest.raises(RuntimeError, match="device scatter"):
        ck.restore_instance(_inst("tf"), ck.read_checkpoint(
            be, "fleet-checkpoints", "tf", name))
    _g, _r, _lc, fc = _member(kv, be, "gen-f")
    fc.tick()
    assert STATS["restores"] == 0
    assert ck.list_checkpoints(be, "fleet-checkpoints") == {"tf": [name]}
    assert not ck.is_consumed(be, "fleet-checkpoints", "tf", name)


# ---------------------------------------------------------------------------
# differentials: blobs interchange with the reference
# ---------------------------------------------------------------------------


def _ref_inst(tenant="t1"):
    from tempo_tpu.generator.instance import GeneratorConfig as JCfg
    from tempo_tpu.generator.instance import GeneratorInstance as JInst
    from tempo_tpu.generator.processors.spanmetrics import (
        SpanMetricsConfig as JSm)
    from tempo_tpu.registry import RegistryOverrides as JOv

    return JInst(tenant, JCfg(processors=("span-metrics",),
                              registry=JOv(max_active_series=1024),
                              spanmetrics=JSm(sketch="both", kernel="xla")),
                 now=lambda: NOW)


def _ref_push(inst, seed: int) -> None:
    from tempo_tpu.model.span_batch import SpanBatchBuilder as JB

    b = JB(inst.registry.interner)
    for s in _spans(seed):
        b.append(**s)
    inst.push_batch(b.build())


def _ref_samples(inst) -> dict:
    inst.drain()
    return {(s.name, s.labels): s.value
            for s in inst.registry.collect(ts_ms=1)
            if not s.is_stale_marker}


def test_reference_blob_restores_into_the_port():
    from tempo_tpu.fleet import checkpoint as jck

    ref = _ref_inst()
    _ref_push(ref, 1)
    blob = jck.snapshot_instance(ref)
    port = _inst()
    assert ck.overrides_fingerprint(port) == jck.overrides_fingerprint(ref)
    ck.restore_instance(port, blob)
    assert _samples(port) == _ref_samples(ref)     # add-to-zero: exact
    # the moments rows are the reference's bit for bit, and the solver is
    # its numpy code: the quantiles are equal
    for q in (0.5, 0.99):
        assert port.processors["span-metrics"].quantile(q) == \
            ref.processors["span-metrics"].quantile(q)


def test_port_blob_restores_into_the_reference():
    from tempo_tpu.fleet import checkpoint as jck

    port = _inst()
    _push(port, 2)
    _push(port, 3)
    blob = ck.snapshot_instance(port)
    ref = _ref_inst()
    _ref_push(ref, 4)                    # an instance that took a push
    jck.restore_instance(ref, blob)
    oracle = _inst()
    for seed in (2, 3, 4):
        _push(oracle, seed)
    _assert_merge_equal(_ref_samples(ref), _samples(oracle), rel=1e-6)


def _sharded_inst(shards: int = 4):
    """A port tenant whose span-metrics state is placed on a serving mesh
    of `shards` logical CPU series shards."""
    from tempo_tpu_torch.parallel import serving

    sm = serving.ServingMesh(serving.MeshConfig(enabled=True),
                             devices=["cpu"] * shards)
    with serving.use(sm):
        inst = _inst()
        proc = inst.processors["span-metrics"]
        assert proc._serving_mesh() is sm
    return inst


def test_reference_blob_restores_into_a_sharded_tenant():
    """The reference's blob restores into a tenant sharded over 4 series
    shards exactly; after the next push (the shards' K1 launches) the
    tenant equals the reference to the contract and an unsharded port
    tenant that took the same restore and push bit for bit, quantiles
    included."""
    from tempo_tpu.fleet import checkpoint as jck

    ref = _ref_inst()
    _ref_push(ref, 1)
    blob = jck.snapshot_instance(ref)
    port, plain = _sharded_inst(), _inst()
    for inst in (port, plain):
        ck.restore_instance(inst, blob)
    assert _samples(port) == _ref_samples(ref)
    _ref_push(ref, 2)
    for inst in (port, plain):
        _push(inst, 2)
    _assert_merge_equal(_samples(port), _ref_samples(ref), rel=1e-6)
    assert _samples(port) == _samples(plain)
    for q in (0.5, 0.99):
        assert port.processors["span-metrics"].quantile(q) == \
            plain.processors["span-metrics"].quantile(q)


def test_sharded_snapshot_restores_bit_for_bit():
    """A sharded tenant's snapshot restores bit for bit into an unsharded
    port tenant and into the reference, and equals an unsharded
    tenant's snapshot of the same pushes."""
    from tempo_tpu.fleet import checkpoint as jck

    sharded = _sharded_inst()
    plain = _inst()
    for seed in (2, 3):
        _push(sharded, seed)
        _push(plain, seed)
    blob = ck.snapshot_instance(sharded)
    assert _samples(sharded) == _samples(plain)
    port = _inst()
    ck.restore_instance(port, blob)
    assert _samples(port) == _samples(sharded)
    ref = _ref_inst()
    jck.restore_instance(ref, blob)
    assert _ref_samples(ref) == _samples(sharded)


# ---------------------------------------------------------------------------
# trace-analytics aux planes (tests/test_traceanalytics.py:346-411)
# ---------------------------------------------------------------------------


def _ta_inst(clock, **ta):
    from tempo_tpu_torch.generator.processors.traceanalytics import (
        TraceAnalyticsConfig)

    return GeneratorInstance("t1", GeneratorConfig(
        processors=("span-metrics", "trace-analytics"),
        registry=RegistryOverrides(max_active_series=512),
        traceanalytics=TraceAnalyticsConfig(trace_idle_s=1.0, **ta)),
        now=lambda: clock[0], device="cpu")


def _ta_push(inst, seed: int, clock) -> None:
    rng = np.random.default_rng(seed)
    b = SpanBatchBuilder(inst.registry.interner)
    t0 = int(clock[0] * 1e9) - 10 ** 9
    for _ in range(12):
        tid = rng.bytes(16)
        ids = [rng.bytes(8) for _ in range(5)]
        for i in range(5):
            st = t0 + i * 1000
            b.append(trace_id=tid, span_id=ids[i],
                     parent_span_id=b"" if i == 0 else ids[(i - 1) // 2],
                     name=f"op-{i}", service=f"svc-{i % 3}", kind=2,
                     status_code=2 if rng.random() < 0.3 else 0,
                     start_unix_nano=st,
                     end_unix_nano=st + int(rng.integers(1e5, 1e8)))
    inst.push_batch(b.build())
    clock[0] += 5
    inst.tick(immediate=True)
    inst.drain()


def test_checkpoint_roundtrip_aux_planes_bit_identical():
    clock = [NOW]
    a = _ta_inst(clock)
    _ta_push(a, 1, clock)
    blob = ck.snapshot_instance(a)
    b = _ta_inst(clock)
    stats = ck.restore_instance(b, blob)
    assert stats["dropped"] == 0 and stats["series"] > 0
    assert _samples(b) == _samples(a)
    qa = a.processors["trace-analytics"].quantile(0.9)
    assert qa and b.processors["trace-analytics"].quantile(0.9) == qa


def test_checkpoint_merge_into_nonempty_adds():
    clock = [NOW]
    a = _ta_inst(clock)
    _ta_push(a, 1, clock)
    want = _samples(a)
    blob = ck.snapshot_instance(a)
    c = _ta_inst(clock)
    _ta_push(c, 2, clock)
    before = _samples(c)
    ck.restore_instance(c, blob)
    after = _samples(c)
    for k, v in want.items():
        assert after[k] == pytest.approx(before.get(k, 0.0) + v, rel=1e-5)


def test_checkpoint_refuses_sketch_config_mismatch():
    clock = [NOW]
    a = _ta_inst(clock)
    _ta_push(a, 1, clock)
    blob = ck.snapshot_instance(a)
    with pytest.raises(ck.CheckpointMismatch):
        ck.restore_instance(_ta_inst(clock, enable_latency_share_sketch=False),
                            blob)
    meta, arrays = ck._decode(blob)
    assert meta["aux"]["trace-analytics"]["family"] == \
        "tempo_critical_path_seconds_total"
    assert any(k.startswith("__aux__::trace-analytics::") for k in arrays)


# ---------------------------------------------------------------------------
# the worker: App members in process, the /kv server as a real process
# ---------------------------------------------------------------------------


def _member_yaml(tmp_path, port: int, wal: bool) -> str:
    text = f"""
target: metrics-generator
server: {{http_listen_port: {port}}}
ring_kv_url: local
usage_stats_enabled: false
storage:
  backend: local
  local_path: {tmp_path}/blocks
  wal_path: {tmp_path}/wal
fleet: {{enabled: true, rebalance_interval_s: 5.0}}
distributor: {{generator_placement: tenant}}
generator:
  processors: [span-metrics]
overrides_defaults:
  generator:
    processors: [span-metrics]
    max_active_series: 2048
    ingestion_time_range_slack_s: 0.0
    collection_interval_s: 3600.0
    sketch: dd
"""
    if wal:
        text += f"wal: {{enabled: true, dir: {tmp_path}/gwal}}\n"
    return text


def _boot_member(tmp_path, wal: bool):
    """A fleet member's App as the worker builds it (`load_config` of the
    member's YAML), on the CPU, started and served on a free port."""
    import socket

    from tempo_tpu_torch.app import App, load_config
    from tempo_tpu_torch.app.api import serve

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    app = App(load_config(text=_member_yaml(tmp_path, port, wal)),
              device="cpu")
    app.start_loops()
    srv = serve(app, block=False)
    return app, srv, f"http://127.0.0.1:{port}"


def _abandon(app, srv) -> None:
    """The in-process kill shape: stop serving and every loop of the App
    with no shutdown (no drain, no checkpoint, WAL files left open)."""
    srv.shutdown()
    srv.server_close()
    app._stop.set()
    if app.fleet is not None:
        app.fleet._stop.set()
        app.fleet._wake.set()
    for lc in app._lifecyclers:
        lc.stop_heartbeat()
    app.generator._stop.set()


def test_fleet_worker_process_spawn_and_reap(tmp_path):
    """In process: one fleet member comes up, serves /status with the
    fleet and rings blocks, and shuts down writing its checkpoints."""
    app, srv, base = _boot_member(tmp_path, wal=False)
    try:
        with urllib.request.urlopen(base + "/status", timeout=10) as r:
            st = json.loads(r.read())
        assert st["fleet"] is not None
        assert st["fleet"]["instance"].startswith("generator")
        members = st["rings"]["generator"]["members"]
        assert len(members) == 1 and members[0]["ownership_ratio"] == 1.0
        assert st["wal"] is None
        app.generator.push_spans("t1", _spans(1))
    finally:
        srv.shutdown()
        srv.server_close()
        app.shutdown()
    assert list(ck.list_checkpoints(app.backend, "fleet-checkpoints")) == \
        ["t1"]


def test_sigkill_restart_replays_wal_bit_identically(tmp_path):
    """In process: a member with the WAL takes three pushes over HTTP, is
    abandoned with no drain or checkpoint, and a second member over the
    same directories replays the WAL at its boot tick: collect equals an
    uninterrupted oracle's (counts exact, sums at rtol 1e-5) and the
    DDSketch q99 is the oracle's."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp
    from tempo_tpu_torch.overrides import Overrides
    from tempo_tpu_torch.overrides.limits import Limits
    from tempo_tpu_torch.rpc import RemoteGeneratorClient

    payloads = [encode_spans_otlp(_spans(11 + k, 24)) for k in range(3)]
    app, srv, base = _boot_member(tmp_path, wal=True)
    try:
        client = RemoteGeneratorClient(base, timeout_s=30.0)
        for pl in payloads:
            assert client.push_otlp("t1", pl) == 24
    finally:
        _abandon(app, srv)
    app2, srv2, base2 = _boot_member(tmp_path, wal=True)
    try:
        req = urllib.request.Request(
            base2 + "/internal/generator/collect?ts_ms=1",
            headers={"X-Scope-OrgID": "t1"})
        doc = json.loads(urllib.request.urlopen(req, timeout=30).read())
        got = {(s["name"], tuple(tuple(kv) for kv in s["labels"])):
               s["value"] for s in doc["samples"]}
        req = urllib.request.Request(
            base2 + "/internal/generator/quantile?q=0.99",
            headers={"X-Scope-OrgID": "t1"})
        qdoc = json.loads(urllib.request.urlopen(req, timeout=30).read())
        got_q = {tuple(tuple(kv) for kv in e["labels"]): e["value"]
                 for e in qdoc["quantiles"]}
    finally:
        srv2.shutdown()
        srv2.server_close()
        app2.fleet.cfg.checkpoint_on_shutdown = False
        app2.shutdown()
    lim = Limits()
    lim.generator.processors = ("span-metrics",)
    lim.generator.max_active_series = 2048
    lim.generator.ingestion_time_range_slack_s = 0.0
    lim.generator.collection_interval_s = 3600.0
    lim.generator.sketch = "dd"
    oracle = Generator(GeneratorConfig(), instance_id="oracle",
                       overrides=Overrides(defaults=lim), device="cpu")
    for pl in payloads:
        oracle.push_otlp("t1", pl)
    inst = oracle.instance("t1")
    want = {(n, tuple(l)): v for (n, l), v in _samples(inst).items()}
    # the member's App runs the scheduler, whose windows may merge the
    # replayed pushes otherwise than the live ones: counts exact, sums
    # within f32 add order (the reference test's tolerance)
    _assert_merge_equal(got, want)
    assert got_q == {tuple(k): v for k, v in
                     inst.processors["span-metrics"].quantile(0.99).items()}


def test_kv_only_worker():
    """The standalone /kv CAS server, a real process (it needs no card),
    speaks the RemoteKVStore wire."""
    from tempo_tpu_torch.fleet.worker import reap_workers, spawn_worker
    from tempo_tpu_torch.ring.kv import RemoteKVStore

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = spawn_worker(["--kv-only"], cwd=root, wait_ready_s=30.0)
    kv = RemoteKVStore(f"http://127.0.0.1:{p.ready['port']}",
                       poll_interval_s=0.05)
    try:
        assert kv.get("nope") is None
        kv.cas("k", lambda cur: {"v": (cur or {}).get("v", 0) + 1})
        kv.cas("k", lambda cur: {"v": cur["v"] + 1})
        assert kv.get("k") == {"v": 2}
        kv.delete("k")
        assert kv.get("k") is None
        lc = Lifecycler(kv, "gen-remote", n_tokens=8, now=lambda: NOW)
        ring = Ring(kv=kv, key="ring", replication_factor=1,
                    now=lambda: NOW)
        assert ring.owner_of("x").id == "gen-remote"
        lc.leave()
        assert kv.get("ring") == {}
    finally:
        kv.shutdown()
        reap_workers([p])
    assert p.poll() is not None


def test_entry_points_run_on_cuda_unless_asked(monkeypatch):
    """No CUDA device and no `device="cpu"`: the generator and the App a
    worker builds raise; the checkpoint and the controller take the
    instance's device and never choose one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(_cfg())
    a = _inst()
    _push(a, 1)
    b = _inst()
    ck.restore_instance(b, ck.snapshot_instance(a))
    assert b.processors["span-metrics"].calls.state.values.device.type == \
        "cpu"
    assert _samples(b) == _samples(a)
