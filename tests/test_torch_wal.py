"""The port's generator ingest WAL and fault points, against the reference.

Mirrors `tests/test_wal_faults.py` (its 20 tests) on the port's
`Generator(wal=GeneratorWal(...), device="cpu")`: append before ack,
boot replay past the checkpoint watermark, exactly once, torn tails and
poison records degrading to counted skips and dead letters, push-id
dedupe across replay, the handoff's WAL-skip window, and the fault
registry's points. With no scheduler configured pushes take the direct
route, where kill-and-replay is bit-identical port against port.

Differentials: a WAL directory the reference wrote replays in the port,
and the port's in the reference, to equal samples by label strings
(counts, buckets and DDSketch rows exact, float sums within rtol 1e-6:
the port adds one f32 delta a push and a row, the reference span by
span; ROADMAP North star).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.backend.mem import MemBackend
from tempo_tpu_torch.fleet import RETRY_CAUSES
from tempo_tpu_torch.fleet import STATS as FLEET_STATS
from tempo_tpu_torch.fleet import checkpoint as ck
from tempo_tpu_torch.generator import wal as twal
from tempo_tpu_torch.generator.generator import Generator
from tempo_tpu_torch.generator.instance import GeneratorConfig
from tempo_tpu_torch.generator.wal import (
    STATS,
    GeneratorWal,
    IngestWalConfig,
    decode_record,
)
from tempo_tpu_torch.model.otlp import encode_spans_otlp
from tempo_tpu_torch.overrides import Overrides
from tempo_tpu_torch.overrides.limits import Limits
from tempo_tpu_torch.utils import faults

NOW = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _singletons():
    """The port's scheduler, fault points and the WAL's and fleet's
    process counters reset around each test."""
    def reset():
        tsched.reset()
        faults.reset()
        for d in (STATS, FLEET_STATS):
            for k in d:
                d[k] = type(d[k])(0)
        RETRY_CAUSES.clear()
    reset()
    yield
    reset()


def _limits() -> Limits:
    lim = Limits()
    lim.generator.processors = ("span-metrics",)
    lim.generator.max_active_series = 2048
    lim.generator.ingestion_time_range_slack_s = 0.0
    lim.generator.collection_interval_s = 3600.0
    return lim


def _spans(seed: int, n: int = 24, prefix: str = "") -> list[dict]:
    rng = np.random.default_rng(seed)
    return [dict(trace_id=rng.bytes(16), span_id=rng.bytes(8),
                 name=f"{prefix}op-{i % 4}", service=f"{prefix}svc-{i % 3}",
                 kind=2, status_code=int(i % 5 == 0) * 2,
                 start_unix_nano=int(NOW * 1e9),
                 end_unix_nano=int(NOW * 1e9) + int(rng.integers(1, 5e8)),
                 attrs={"k": f"v{i % 2}"})
            for i in range(n)]


def _payload(seed: int, n: int = 24, prefix: str = "") -> bytes:
    return encode_spans_otlp(_spans(seed, n, prefix))


def _wal(tmp_path, sub: str = "wal", **kw) -> GeneratorWal:
    return GeneratorWal(IngestWalConfig(enabled=True,
                                        dir=str(tmp_path / sub), **kw),
                        now=lambda: NOW)


def _mkgen(tmp_path, iid: str = "m0", sub: str = "wal",
           wal: "GeneratorWal | None" = None) -> Generator:
    return Generator(GeneratorConfig(), instance_id=iid,
                     overrides=Overrides(defaults=_limits()),
                     wal=wal if wal is not None else _wal(tmp_path, sub),
                     now=lambda: NOW, device="cpu")


def _oracle(iid: str = "oracle") -> Generator:
    return Generator(GeneratorConfig(), instance_id=iid,
                     overrides=Overrides(defaults=_limits()),
                     now=lambda: NOW, device="cpu")


def _collect(gen, tenant: str) -> dict:
    inst = gen.instance(tenant)
    inst.drain()
    return {(s.name, s.labels): s.value
            for s in inst.registry.collect(ts_ms=1)
            if not s.is_stale_marker}


def _q99(gen, tenant: str) -> dict:
    return gen.instance(tenant).processors["span-metrics"].quantile(0.99)


# ---------------------------------------------------------------------------
# WAL append + replay
# ---------------------------------------------------------------------------


def test_replay_after_simulated_kill_is_bit_identical(tmp_path):
    """Abandon a generator (no shutdown, no checkpoint: the kill -9
    shape), rebuild over the same WAL dir: replay restores collect() and
    quantile() bit for bit, exactly once (the direct route)."""
    g1 = _mkgen(tmp_path)
    for seed in (1, 2, 3):
        g1.push_otlp("t1", _payload(seed))
    want, want_q = _collect(g1, "t1"), _q99(g1, "t1")

    g2 = _mkgen(tmp_path)
    assert g2.replay_wal_all() == {"tenants": 1, "batches": 3,
                                   "dead_letters": 0}
    assert _collect(g2, "t1") == want
    assert _q99(g2, "t1") == want_q
    assert STATS["replayed_batches"] == 3 and STATS["fsyncs"] >= 3


def test_staged_view_record_round_trips_sample_weights(tmp_path):
    """A sampled push's Horvitz-Thompson weights ride the WAL record."""
    from tempo_tpu_torch.model.otlp_batch import stage_otlp

    g1 = _mkgen(tmp_path)
    inst = g1.instance("t1")
    st = stage_otlp(_payload(7), inst.registry.interner)
    w = np.linspace(1.0, 4.0, st.n).astype(np.float32)
    st.sample_weight = w
    assert g1.push_staged_view("t1", st.view()) == st.n
    want = _collect(g1, "t1")
    calls = [v for (name, _l), v in want.items()
             if name == "traces_spanmetrics_calls_total"]
    assert calls and not np.allclose(sum(calls), st.n)  # weights applied

    g2 = _mkgen(tmp_path)
    assert g2.replay_wal_all()["batches"] == 1
    assert _collect(g2, "t1") == want


def test_checkpoint_watermark_truncates_and_bounds_replay(tmp_path):
    """Records at or below the snapshot watermark live in the blob;
    restore + replay applies each acked batch exactly once and equals the
    uninterrupted oracle bit for bit."""
    be = MemBackend()
    g1 = _mkgen(tmp_path)
    for seed in (1, 2):
        g1.push_otlp("t1", _payload(seed))
    inst = g1.instance("t1")
    blob = ck.snapshot_instance(inst)
    assert inst.checkpointed_wal_seq == 1
    ck.write_checkpoint(be, "fleet-checkpoints", "t1", blob,
                        ck.checkpoint_name(NOW, "m0"))
    g1.truncate_wal("t1", inst.checkpointed_wal_seq)
    assert STATS["truncated_segments"] > 0
    assert g1.wal._tw("t1").segments() == []
    for seed in (3, 4):
        g1.push_otlp("t1", _payload(seed))
    want = _collect(g1, "t1")

    g2 = _mkgen(tmp_path)
    inst2 = g2.instance("t1")
    ck.restore_instance(inst2, blob)
    assert inst2.wal_watermarks == {"m0": [0, 1]}
    assert g2.replay_wal_all()["batches"] == 2   # only seqs 2..3
    assert _collect(g2, "t1") == want
    oracle = _oracle()
    for seed in (1, 2, 3, 4):
        oracle.push_otlp("t1", _payload(seed))
    assert _collect(g2, "t1") == _collect(oracle, "t1")


def test_torn_tail_is_skipped_not_fatal(tmp_path):
    g1 = _mkgen(tmp_path)
    g1.push_otlp("t1", _payload(1))
    want = _collect(g1, "t1")
    tw = g1.wal._tw("t1")
    with open(os.path.join(tw.dir, tw.segments()[-1]), "ab") as f:
        f.write(b"TWR1" + b"\x22" * 9)   # half a header, then nothing
    g2 = _mkgen(tmp_path)
    assert g2.replay_wal_all()["batches"] == 1
    assert STATS["torn_frames"] > 0
    assert _collect(g2, "t1") == want


def test_poison_record_dead_letters_instead_of_crash_looping(tmp_path):
    g1 = _mkgen(tmp_path)
    g1.push_otlp("t1", _payload(1))
    tw = g1.wal._tw("t1")
    tw.append(twal._encode_record({"v": 1, "kind": "bogus", "ts": NOW}, {}))
    g1.push_otlp("t1", _payload(2))
    want = _collect(g1, "t1")

    g2 = _mkgen(tmp_path)
    assert g2.replay_wal_all() == {"tenants": 1, "batches": 2,
                                   "dead_letters": 1}
    assert _collect(g2, "t1") == want
    dl_dir = os.path.join(str(tmp_path / "wal"), "t1", "deadletter")
    files = sorted(os.listdir(dl_dir))
    assert files == ["000000000001.rec", "000000000001.strings.json"]
    with open(os.path.join(dl_dir, files[0]), "rb") as f:
        meta, _arrays = decode_record(f.read())
    assert meta["kind"] == "bogus"


def test_fsync_policies_and_rotation(tmp_path):
    wal = _wal(tmp_path, "w", fsync="off", segment_max_bytes=1 << 20)
    g = _mkgen(tmp_path, wal=wal)
    g.push_otlp("t1", _payload(1))
    assert STATS["fsyncs"] == 0          # off: no per-append fsync
    wal.cfg.fsync = "batch"
    g.push_otlp("t1", _payload(2))
    assert STATS["fsyncs"] == 1
    tw = wal._tw("t1")
    before = len(tw.segments())
    tw._seg_bytes = wal.cfg.segment_max_bytes  # force the size bound
    g.push_otlp("t1", _payload(3))
    assert len(tw.segments()) == before + 1
    assert wal.watermark("t1") == (2, 2)
    st = wal.status()
    assert st["appended_batches"] == 3 and st["segments"] == {"t1": 2}


def test_push_id_dedupe_survives_replay(tmp_path):
    g1 = _mkgen(tmp_path)
    n = g1.push_otlp("t1", _payload(1), push_id="abc")
    assert g1.push_otlp("t1", _payload(1), push_id="abc") == n
    want = _collect(g1, "t1")
    one = _oracle("one")
    one.push_otlp("t1", _payload(1))
    assert want == _collect(one, "t1")   # the second send never scattered

    g2 = _mkgen(tmp_path)
    g2.replay_wal_all()
    assert _collect(g2, "t1") == want
    assert g2.push_otlp("t1", _payload(1), push_id="abc") == n
    assert _collect(g2, "t1") == want


def test_push_otlp_recs_declines_when_wal_enabled(tmp_path):
    assert _mkgen(tmp_path).push_otlp_recs("t1", b"", None) is None


def test_pending_retry_redoes_only_the_append(tmp_path):
    """A push whose scatter landed but whose WAL append failed leaves a
    pending dedupe entry: the retry re-appends without re-scattering."""
    g = _mkgen(tmp_path)
    spec = faults.FaultSpec(point="wal.fsync", probability=1.0, count=1)
    with faults.use([spec]):
        with pytest.raises(OSError):
            g.push_otlp("t1", _payload(1), push_id="r1")
    assert g.instance("t1").seen_push("r1") == ("pending", 24)
    assert g.push_otlp("t1", _payload(1), push_id="r1") == 24
    assert g.instance("t1").seen_push("r1") == 24
    want = _collect(g, "t1")
    one = _oracle("one")
    one.push_otlp("t1", _payload(1))
    assert want == _collect(one, "t1")   # scattered exactly once
    g2 = _mkgen(tmp_path)
    g2.replay_wal_all()
    assert _collect(g2, "t1") == want


def test_checkpoint_floor_bounds_replay_without_blob(tmp_path):
    g1 = _mkgen(tmp_path)
    for seed in (1, 2):
        g1.push_otlp("t1", _payload(seed))
    inst = g1.instance("t1")
    ck.snapshot_instance(inst)           # blob discarded on purpose
    g1.truncate_wal("t1", inst.checkpointed_wal_seq)
    g1.push_otlp("t1", _payload(3))
    assert g1.wal._tw("t1").segments() != []
    assert g1.wal._tw("t1").checkpoint_floor() == 1

    g2 = _mkgen(tmp_path)                # restart, NO blob restored
    assert g2.replay_wal_all()["batches"] == 1   # only seq 2
    oracle = _oracle("o")
    oracle.push_otlp("t1", _payload(3))
    assert _collect(g2, "t1") == _collect(oracle, "t1")


def test_interner_replacement_rotates_segment(tmp_path):
    """A replaced tenant instance brings a fresh interner: appends rotate
    to a fresh segment whose string table starts from zero."""
    g = _mkgen(tmp_path)
    g.push_otlp("t1", _payload(31, 12, "a-"))
    g.remove_instance("t1")
    g.push_otlp("t1", _payload(32, 12, "b-"))
    assert len(g.wal._tw("t1").segments()) == 2

    g2 = _mkgen(tmp_path)
    assert g2.replay_wal_all() == {"tenants": 1, "batches": 2,
                                   "dead_letters": 0}
    got = _collect(g2, "t1")
    names = {dict(labels).get("span_name") for (_n, labels) in got}
    assert any(n and n.startswith("a-op") for n in names)
    assert any(n and n.startswith("b-op") for n in names)
    oracle = _oracle("oi")
    oracle.push_otlp("t1", _payload(31, 12, "a-"))
    oracle.push_otlp("t1", _payload(32, 12, "b-"))
    assert got == _collect(oracle, "t1")


def test_seq_counter_survives_full_truncation_restart(tmp_path):
    g1 = _mkgen(tmp_path)
    for seed in (1, 2):
        g1.push_otlp("t1", _payload(seed))
    inst = g1.instance("t1")
    ck.snapshot_instance(inst)
    g1.truncate_wal("t1", inst.checkpointed_wal_seq)
    assert g1.wal._tw("t1").segments() == []

    g2 = _mkgen(tmp_path)
    g2.push_otlp("t1", _payload(3))
    assert g2.wal.watermark("t1") == (2, 2)    # floor 1 → next seq 2
    want = _collect(g2, "t1")

    g3 = _mkgen(tmp_path)
    assert g3.replay_wal_all()["batches"] == 1
    oracle = _oracle("o2")
    oracle.push_otlp("t1", _payload(3))
    assert _collect(g3, "t1") == _collect(oracle, "t1") == want


def test_handoff_window_skips_wal_and_never_claims_foreign_records(
        tmp_path):
    g = _mkgen(tmp_path)
    g.push_otlp("t1", _payload(1))
    old = g.pop_instance("t1")           # opens the skip window
    n0 = STATS["appended_batches"]
    g.push_otlp("t1", _payload(2))       # straggler → fresh instance
    assert STATS["appended_batches"] == n0
    assert old.wait_pushes_idle(2.0)
    ck.snapshot_instance(old)
    assert old.checkpointed_wal_seq == 0
    g.end_handoff("t1")
    g.push_otlp("t1", _payload(3))       # the WAL resumes
    assert STATS["appended_batches"] == n0 + 1


# ---------------------------------------------------------------------------
# fault-injection registry
# ---------------------------------------------------------------------------


def test_faults_deterministic_and_bounded():
    spec = faults.FaultSpec(point="backend.write", probability=0.5, count=3)
    fired = []
    for _trial in range(2):
        with faults.use([spec], seed=42):
            hits = []
            for _ in range(40):
                try:
                    faults.fire("backend.write")
                    hits.append(0)
                except OSError:
                    hits.append(1)
            fired.append(hits)
            assert faults.stats()["backend.write"] == 3
    assert fired[0] == fired[1]
    assert not faults.ARMED


def test_faults_latency_only_and_after():
    spec = faults.FaultSpec(point="rpc.push", probability=1.0, after=2,
                            latency_s=0.0, error="none")
    with faults.use([spec]):
        for _ in range(3):
            faults.fire("rpc.push")
        assert faults.stats()["rpc.push"] == 1


def test_faults_config_gate(monkeypatch):
    cfg = faults.FaultsConfig(points={"rpc.push": {"probability": 0.1}})
    assert any("faults.allow" in w for w in cfg.check())
    cfg.allow = True
    assert cfg.check() == []
    monkeypatch.setenv("TEMPO_FAULTS",
                       '{"wal.fsync": {"probability": 1.0, "count": 1}}')
    faults.configure(faults.FaultsConfig(allow=False))
    assert not faults.ARMED
    faults.configure(faults.FaultsConfig(allow=True))
    assert faults.ARMED
    with pytest.raises(OSError):
        faults.fire("wal.fsync")


def test_wal_fsync_fault_fails_the_push_but_replay_covers_it(tmp_path):
    """An injected fsync failure errors the push (unacked), but the
    scatter landed and the frame is on disk, so the snapshot watermark
    covers it: no replay double-count."""
    g = _mkgen(tmp_path)
    g.push_otlp("t1", _payload(1))
    spec = faults.FaultSpec(point="wal.fsync", probability=1.0, count=1)
    with faults.use([spec]):
        with pytest.raises(OSError):
            g.push_otlp("t1", _payload(2))
    want = _collect(g, "t1")
    blob = ck.snapshot_instance(g.instance("t1"))
    assert g.instance("t1").checkpointed_wal_seq == 1
    g2 = _mkgen(tmp_path)
    ck.restore_instance(g2.instance("t1"), blob)
    assert g2.replay_wal_all()["batches"] == 0
    assert _collect(g2, "t1") == want


# ---------------------------------------------------------------------------
# the retry paths the fault points exercise
# ---------------------------------------------------------------------------


def test_resilient_backend_retries_transient_and_passes_semantic():
    from tempo_tpu_torch.backend.cloud import ResilientBackend
    from tempo_tpu_torch.backend.raw import DoesNotExist, KeyPath

    be = ResilientBackend(MemBackend(), retries=3, backoff_s=0.001)
    kp = KeyPath(("x",))
    with faults.use([faults.FaultSpec(point="backend.write",
                                      probability=1.0, count=2)]):
        be.write("a", kp, b"payload")
    assert be.read("a", kp) == b"payload"
    with pytest.raises(DoesNotExist):
        be.read("missing", kp)
    with faults.use([faults.FaultSpec(point="backend.read",
                                      probability=1.0)]):
        with pytest.raises(OSError):
            be.read("a", kp)


def test_controller_checkpoint_write_retries_with_cause_metric(tmp_path):
    from tempo_tpu_torch.fleet import FleetConfig
    from tempo_tpu_torch.fleet.controller import FleetController
    from tempo_tpu_torch.obs.runtime import RUNTIME
    from tempo_tpu_torch.ring import KVStore, Lifecycler, Ring

    kv = KVStore()
    be = MemBackend()
    gen = _mkgen(tmp_path)
    Lifecycler(kv, "m0", key="generator", now=lambda: NOW)
    ring = Ring(kv=kv, key="generator", replication_factor=1,
                now=lambda: NOW)
    fc = FleetController(gen, ring, "m0", be, be,
                         cfg=FleetConfig(checkpoint_write_retries=3,
                                         checkpoint_retry_backoff_s=0.001),
                         now=lambda: NOW)
    gen.push_otlp("t1", _payload(1))
    with faults.use([faults.FaultSpec(point="fleet.checkpoint.write",
                                      probability=1.0, count=2)]):
        fc._checkpoint("t1", remove=False)
    assert ck.list_checkpoints(be, "fleet-checkpoints") != {}
    assert sum(RETRY_CAUSES.values()) == 2
    assert "tempo_fleet_checkpoint_retries_total" in RUNTIME.render()
    assert gen.wal._tw("t1").segments() == []


# ---------------------------------------------------------------------------
# block WAL: directory-entry durability + torn-directory rescan
# ---------------------------------------------------------------------------


def test_block_wal_dir_fsync_and_torn_directory_rescan(tmp_path):
    from tempo_tpu_torch.block import wal as bwal

    root = str(tmp_path / "bwal")
    os.makedirs(root)
    blk = bwal.WALBlock(root, "t1")
    blk.append([dict(trace_id=b"\x01" * 16, span_id=b"\x02" * 8, name="op",
                     service="svc", kind=2, status_code=0,
                     start_unix_nano=1, end_unix_nano=2)])
    torn = os.path.join(root, "11111111+t2+vtpu1")
    os.makedirs(torn)
    with open(os.path.join(torn, ".0000001.tmp"), "wb") as f:
        f.write(b"partial parquet")
    os.makedirs(os.path.join(root, "22222222+t3+vtpu1"))
    with open(os.path.join(root, "junk.txt"), "w") as f:
        f.write("not a block")
    by_tenant = {b.tenant: b for b in bwal.rescan_blocks(root)}
    assert set(by_tenant) == {"t1", "t2", "t3"}
    assert by_tenant["t1"].complete()
    assert by_tenant["t2"].complete() == []
    assert by_tenant["t3"].complete() == []
    assert by_tenant["t2"]._next_seg == 0


# ---------------------------------------------------------------------------
# differentials: WAL directories interchange with the reference
# ---------------------------------------------------------------------------


def _ref_gen(d: str, iid: str = "r0", wal: bool = True):
    from tempo_tpu.generator.generator import Generator as JGen
    from tempo_tpu.generator.instance import GeneratorConfig as JCfg
    from tempo_tpu.generator.wal import GeneratorWal as JWal
    from tempo_tpu.generator.wal import IngestWalConfig as JWalCfg
    from tempo_tpu.overrides import Overrides as JOv
    from tempo_tpu.overrides.limits import Limits as JLim

    lim = JLim()
    lim.generator.processors = ("span-metrics",)
    lim.generator.max_active_series = 2048
    lim.generator.ingestion_time_range_slack_s = 0.0
    lim.generator.collection_interval_s = 3600.0
    w = JWal(JWalCfg(enabled=True, dir=d), now=lambda: NOW) if wal else None
    return JGen(JCfg(), instance_id=iid, overrides=JOv(defaults=lim),
                wal=w, now=lambda: NOW)


def _same_by_labels(got: dict, want: dict) -> None:
    """Port samples against the reference's: counts and buckets exact,
    float sums within rtol 1e-6."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k[0].endswith("_sum") or k[0] == "traces_spanmetrics_size_total":
            assert got[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert got[k] == v, k


def test_reference_wal_dir_replays_in_the_port(tmp_path):
    d = str(tmp_path / "ref-wal")
    ref = _ref_gen(d)
    for seed in (1, 2, 3):
        ref.push_otlp("t1", _payload(seed))
    want, want_q = _collect(ref, "t1"), _q99(ref, "t1")
    g = _mkgen(tmp_path, wal=GeneratorWal(IngestWalConfig(enabled=True,
                                                          dir=d),
                                          now=lambda: NOW))
    assert g.replay_wal_all() == {"tenants": 1, "batches": 3,
                                  "dead_letters": 0}
    _same_by_labels(_collect(g, "t1"), want)
    assert _q99(g, "t1") == want_q       # integer DDSketch grids
    # and the port's next append continues the reference's segment seqs
    g.push_otlp("t1", _payload(4))
    assert g.wal.watermark("t1")[1] == 3


def test_port_wal_dir_replays_in_the_reference(tmp_path):
    g = _mkgen(tmp_path)
    for seed in (1, 2, 3):
        g.push_otlp("t1", _payload(seed), push_id=f"p{seed}")
    want, want_q = _collect(g, "t1"), _q99(g, "t1")
    ref = _ref_gen(str(tmp_path / "wal"))
    assert ref.replay_wal_all() == {"tenants": 1, "batches": 3,
                                    "dead_letters": 0}
    _same_by_labels(want, _collect(ref, "t1"))
    assert _q99(ref, "t1") == want_q
    assert ref.instance("t1").seen_push("p2") == 24  # dedupe re-seeded
