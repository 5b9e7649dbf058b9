"""The port's ingesters against the reference's: `tests/test_write_path.py`'s
ingester tests run on both packages' rigs (3 ingesters on a ring behind
a distributor at rf=3, a `MemBackend` as the object store) under one fake
clock, with the results compared between the packages.

Held equal: what `find_trace_by_id` returns at every stage (live, head
WAL, complete block, after replay), the complete blocks' meta fields (but
the id, `encoding`, `size_bytes` and `footer_size`: the port writes gzip
PLAIN pages where the reference writes zstd), the objects flushed, the
discard reasons and counts, the flush queues' retry and abandonment, the
deletion of flushed local blocks, and the exposition of the four
`tempo_ingester_*` families (values exact; the duration histograms by
their counts, since they time this host). The read side's `search`,
`tag_names` and `tag_values` are held in `tests/test_torch_querier.py`.
"""

from __future__ import annotations

import re

import pytest

from tempo_tpu.backend.mem import MemBackend as JMem
from tempo_tpu.backend.meta import read_block_meta as j_read_meta
from tempo_tpu.backend.raw import blocks as j_blocks
from tempo_tpu.distributor import Distributor as JDist
from tempo_tpu.distributor.distributor import DistributorConfig as JDistCfg
from tempo_tpu.ingester import Ingester as JIng
from tempo_tpu.ingester import IngesterConfig as JIngCfg
from tempo_tpu.ingester.instance import InstanceConfig as JInstCfg
from tempo_tpu.ring import ring as jring
from tempo_tpu.utils import flushqueues as jfq

from tempo_tpu_torch.backend.mem import MemBackend as TMem
from tempo_tpu_torch.backend.meta import read_block_meta as t_read_meta
from tempo_tpu_torch.backend.raw import blocks as t_blocks
from tempo_tpu_torch.distributor import Distributor as TDist
from tempo_tpu_torch.distributor.distributor import DistributorConfig as TDistCfg
from tempo_tpu_torch.ingester import Ingester as TIng
from tempo_tpu_torch.ingester import IngesterConfig as TIngCfg
from tempo_tpu_torch.ingester.instance import InstanceConfig as TInstCfg
from tempo_tpu_torch.ring import ring as tring
from tempo_tpu_torch.utils import flushqueues as tfq

T0 = 1000.0
FAMILIES = ("tempo_ingester_live_traces",
            "tempo_ingester_discarded_traces_total",
            "tempo_ingester_cut_duration_seconds",
            "tempo_ingester_flush_duration_seconds")


def mkspan(tid: bytes, sid: bytes, name="op", svc="svc", t0=10**18,
           dur=1_000_000, **kw):
    return {"trace_id": tid, "span_id": sid, "name": name, "service": svc,
            "start_unix_nano": t0, "end_unix_nano": t0 + dur, **kw}


class Side:
    """One package's pieces of the write path."""

    def __init__(self, port: bool):
        self.port = port
        self.Mem = TMem if port else JMem
        self.Ing = TIng if port else JIng
        self.IngCfg = TIngCfg if port else JIngCfg
        self.InstCfg = TInstCfg if port else JInstCfg
        self.Dist = TDist if port else JDist
        self.DistCfg = TDistCfg if port else JDistCfg
        self.ring = tring if port else jring
        self.read_meta = t_read_meta if port else j_read_meta
        self.blocks = t_blocks if port else j_blocks


def sides():
    return Side(False), Side(True)


def make_clock():
    t = [T0]
    return t, lambda: t[0]


class Rig:
    """3 ingesters on a ring + 1 distributor (rf=3), one package, one
    clock (`tests/test_write_path.py::rig`)."""

    def __init__(self, side: Side, path, clock, cfg_kw=None, **inst_kw):
        self.side = side
        self.t, self.now = clock
        inst = dict(trace_idle_s=2.0, trace_live_s=10.0,
                    max_block_duration_s=30.0)
        inst.update(inst_kw)
        cfg = side.IngCfg(instance=side.InstCfg(**inst), **(cfg_kw or {}))
        self.backend = side.Mem()
        ring = side.ring.Ring(replication_factor=3, now=self.now)
        self.ingesters = {}
        for i in range(3):
            iid = f"ing-{i}"
            self.ingesters[iid] = side.Ing(
                str(path / f"ing{i}"), flush_writer=self.backend, cfg=cfg,
                now=self.now, instance_id=iid)
            ring.register(side.ring.InstanceDesc(
                id=iid, state=side.ring.ACTIVE,
                tokens=side.ring._instance_tokens(iid, 64),
                heartbeat_ts=self.now()))
        self.dist = side.Dist(ring, self.ingesters,
                              cfg=side.DistCfg(rf=3), now=self.now)


@pytest.fixture
def rigs(tmp_path):
    """The reference's rig and the port's under ONE clock."""
    clock = make_clock()
    j, t = sides()
    return clock[0], Rig(j, tmp_path / "ref", clock), \
        Rig(t, tmp_path / "port", clock)


def both(rj, rt, fn):
    """`fn(rig)` on each package's rig; returns (reference, port)."""
    return fn(rj), fn(rt)


def norm(spans):
    """Span dicts as both packages read them back, ids padded."""
    if spans is None:
        return None
    return sorted(({**s, "trace_id": bytes(s["trace_id"]).ljust(16, b"\0"),
                    "span_id": bytes(s["span_id"]).ljust(8, b"\0"),
                    "parent_span_id": bytes(s.get("parent_span_id") or b"")
                    .ljust(8, b"\0")}
                   for s in spans),
                  key=lambda s: (s["trace_id"], s["span_id"]))


def meta_fields(meta):
    d = meta.to_json()
    for k in ("block_id", "encoding", "size_bytes", "footer_size"):
        d.pop(k)
    return d


def test_cut_complete_flush_cycle(rigs):
    t, rj, rt = rigs
    spans = [mkspan(bytes([i]) * 16, bytes([j]) * 8)
             for i in range(1, 6) for j in range(1, 3)]
    both(rj, rt, lambda r: r.dist.push_spans("t1", spans))

    def step(r):
        ing = r.ingesters["ing-0"]
        ing.sweep_instance("t1")
        return ing.instance("t1").head is None
    assert both(rj, rt, step) == (True, True)      # nothing idle yet
    t[0] += 5.0

    def idle(r):
        ing = r.ingesters["ing-0"]
        ing.sweep_instance("t1")
        inst = ing.instance("t1")
        return len(inst.live), inst.head is not None, \
            len(inst.head.segments())
    assert both(rj, rt, idle) == ((0, True, 5), (0, True, 5))
    t[0] += 31.0

    def seal(r):
        ing = r.ingesters["ing-0"]
        ing.sweep_instance("t1")
        inst = ing.instance("t1")
        n = ing.flush_tick()
        ing.flush_tick()
        (entry,) = inst.complete.values()
        flushed = r.side.read_meta(r.backend, entry.meta.block_id, "t1")
        return inst.head is None, n, meta_fields(entry.meta), \
            meta_fields(flushed), entry.flushed_ts, \
            sorted(r.backend._objects)[0].split("/")[-1]
    j, p = both(rj, rt, seal)
    assert p == j
    assert p[0] and p[1] == 2 and p[2]["total_objects"] == 5
    assert p[4] == t[0]
    meta = rt.ingesters["ing-0"].instance("t1").complete
    assert next(iter(meta.values())).meta.encoding == "gzip"


def test_find_trace_spans_all_stages(rigs):
    t, rj, rt = rigs
    tid = b"\x07" * 16
    both(rj, rt, lambda r: r.dist.push_spans(
        "t1", [mkspan(tid, b"\x01" * 8, attrs={"a": 1, "b": "x"})]))

    def find(r):
        return norm(r.ingesters["ing-0"].instance("t1").find_trace_by_id(tid))
    live = both(rj, rt, find)
    t[0] += 5.0
    both(rj, rt, lambda r: r.ingesters["ing-0"].sweep_instance("t1"))
    wal = both(rj, rt, find)
    t[0] += 31.0

    def complete(r):
        ing = r.ingesters["ing-0"]
        ing.sweep_instance("t1")
        ing.flush_tick()
        ing.flush_tick()
        return find(r), ing.find_trace_by_id("t1", b"\xff" * 16), \
            ing.find_trace_by_id("nobody", tid)
    blk = both(rj, rt, complete)
    assert live[1] == live[0] and live[1] is not None
    assert wal[1] == wal[0] and len(wal[1]) == 1
    assert blk[1] == blk[0] and len(blk[1][0]) == 1
    assert blk[1][1:] == (None, None)
    assert wal[1][0]["attrs"] == {"a": 1, "b": "x"}


def test_wal_replay_after_crash(tmp_path):
    clock = make_clock()
    t, now = clock
    out = []
    for side in sides():
        backend = side.Mem()
        cfg = side.IngCfg(instance=side.InstCfg(trace_idle_s=1.0))
        path = str(tmp_path / ("port" if side.port else "ref"))
        ing = side.Ing(path, flush_writer=backend, cfg=cfg, now=now,
                       instance_id="ing-0")
        tid = b"\x09" * 16
        ing.push("t1", [(tid, [mkspan(tid, b"\x01" * 8)])])
        t[0] += 2.0
        ing.instance("t1").cut_complete_traces()   # data in WAL, then "crash"
        del ing
        ing2 = side.Ing(path, flush_writer=backend, cfg=cfg, now=now,
                        instance_id="ing-0")
        found = norm(ing2.instance("t1").find_trace_by_id(tid))
        ing2.flush_all()
        out.append((found, len(side.blocks(backend, "t1")),
                    norm(ing2.find_trace_by_id("t1", tid))))
    assert out[1] == out[0]
    assert out[1][0] is not None and out[1][1] == 1


def test_shutdown_flushes_everything(rigs):
    t, rj, rt = rigs
    spans = [mkspan(bytes([i]) * 16, b"\x01" * 8) for i in range(1, 4)]
    both(rj, rt, lambda r: r.dist.push_spans("t1", spans))

    def shut(r):
        for ing in r.ingesters.values():
            ing.shutdown()
        return len(r.side.blocks(r.backend, "t1")), sorted(
            meta_fields(r.side.read_meta(r.backend, b, "t1"))["total_spans"]
            for b in r.side.blocks(r.backend, "t1"))
    j, p = both(rj, rt, shut)
    assert p == j == (3, [3, 3, 3])


def test_push_error_counted_once_across_replicas(rigs):
    t, rj, rt = rigs

    def push(r):
        for ing in r.ingesters.values():
            ing.overrides.set_tenant_patch(
                "t1", {"read": {"max_bytes_per_trace": 10}})
        errs = r.dist.push_spans("t1", [mkspan(b"\x01" * 16, b"\x01" * 8)])
        return errs, dict(r.dist.discarded), [
            dict(ing.instance("t1").discarded)
            for ing in r.ingesters.values()]
    j, p = both(rj, rt, push)
    assert p == j
    assert p[0] == {"trace_too_large": 1} and p[1] == {"trace_too_large": 1}


def test_replay_dedupes_wal_handles(tmp_path):
    clock = make_clock()
    t, now = clock
    out = []
    for side in sides():
        backend = side.Mem()
        cfg = side.IngCfg(instance=side.InstCfg(trace_idle_s=1.0))
        path = str(tmp_path / ("port" if side.port else "ref"))
        ing = side.Ing(path, flush_writer=backend, cfg=cfg, now=now,
                       instance_id="ing-0")
        tid1, tid2 = b"\x01" * 16, b"\x02" * 16
        ing.push("t1", [(tid1, [mkspan(tid1, b"\x01" * 8)])])
        t[0] += 2.0
        ing.sweep_instance("t1")
        sealed = ing.instance("t1").cut_block_if_ready(immediate=True)
        ing.instance("t1").complete_block(sealed)     # a local complete block
        ing.push("t1", [(tid2, [mkspan(tid2, b"\x02" * 8)])])
        t[0] += 2.0
        ing.instance("t1").cut_complete_traces()      # a WAL block, then crash
        del ing
        ing2 = side.Ing(path, flush_writer=backend, cfg=cfg, now=now,
                        instance_id="ing-0")
        inst = ing2.instance("t1")
        ids = [b.block_id for b in inst.completing]
        queued = len(ing2.queues)
        ing2.flush_all()
        out.append((len(ids), len(set(ids)), queued,
                    norm(inst.find_trace_by_id(tid1)),
                    norm(inst.find_trace_by_id(tid2)),
                    len(side.blocks(backend, "t1"))))
    assert out[1] == out[0]
    assert out[1][:3] == (1, 1, 2) and out[1][3] and out[1][4]
    assert out[1][5] == 2


class FailingWriter:
    """An object store whose writes fail `fails` times, then succeed."""

    def __init__(self, mem, fails):
        self.mem = mem
        self.fails = fails
        self.calls = 0

    def write(self, name, keypath, data):
        self.calls += 1
        if self.fails:
            self.fails -= 1
            raise OSError("object store down")
        return self.mem.write(name, keypath, data)


@pytest.mark.parametrize("fails", [2, 100])
def test_flush_backoff_and_abandonment(tmp_path, monkeypatch, fails):
    """A failing flush retries at `backoff_at` (exponential from
    `flush_backoff_base_s`, jitter pinned to 0) and is abandoned after
    `max_flush_attempts`; the block stays local and unflushed."""
    monkeypatch.setattr(jfq.random, "random", lambda: 0.0)
    monkeypatch.setattr(tfq.random, "random", lambda: 0.0)
    clock = make_clock()
    t, now = clock
    trail = []
    for side in sides():
        t[0] = T0
        writer = FailingWriter(side.Mem(), fails)
        cfg = side.IngCfg(instance=side.InstCfg(trace_idle_s=1.0),
                          max_flush_attempts=3, flush_backoff_base_s=10.0)
        ing = side.Ing(str(tmp_path / str(side.port)), flush_writer=writer,
                       cfg=cfg, now=now, instance_id="ing-0")
        tid = b"\x03" * 16
        ing.push("t1", [(tid, [mkspan(tid, b"\x01" * 8)])])
        ing.sweep_instance("t1", immediate=True)
        steps = []
        for dt in (0.0, 5.0, 6.0, 20.0, 1000.0):
            t[0] += dt
            n = ing.flush_tick()
            entry = next(iter(ing.instance("t1").complete.values()))
            steps.append((n, len(ing.queues), writer.calls,
                          entry.flushed_ts > 0))
        trail.append((steps, len(side.blocks(writer.mem, "t1"))))
    assert trail[1] == trail[0]
    steps, flushed = trail[1]
    if fails == 2:      # complete + a failed flush; retry at +10 s, +20 s
        assert steps[0][:2] == (2, 1) and steps[-1][3] and flushed == 1
    else:               # three attempts, then abandoned: nothing queued
        assert steps[-1][1] == 0 and not steps[-1][3] and flushed == 0


def test_delete_old_flushed(rigs):
    t, rj, rt = rigs
    both(rj, rt, lambda r: r.dist.push_spans(
        "t1", [mkspan(b"\x04" * 16, b"\x01" * 8)]))

    def run(r):
        ing = r.ingesters["ing-0"]
        ing.sweep_instance("t1", immediate=True)
        ing.flush_tick()
        inst = ing.instance("t1")
        (bid,) = inst.complete
        early = inst.delete_old_flushed(60.0)
        t_keep = t[0]
        t[0] += 61.0
        gone = inst.delete_old_flushed(60.0)
        t[0] = t_keep
        import os
        on_disk = os.path.isdir(os.path.join(ing.local_root, "t1", bid))
        return early, gone == [bid], on_disk, len(inst.complete), \
            norm(inst.find_trace_by_id(b"\x04" * 16))
    j, p = both(rj, rt, run)
    assert p == j == ([], True, False, 0, None)


def _families(text):
    """The four families' lines, duration histograms as their counts."""
    out = []
    for ln in text.splitlines():
        name = re.split(r"[{ ]", ln.split(" ", 3)[2] if ln.startswith("#")
                        else ln)[0]
        if not any(name.startswith(f) for f in FAMILIES):
            continue
        if "duration_seconds" in name and not ln.startswith("#") and \
                not name.endswith("_count"):
            continue
        out.append(ln)
    return out


def test_obs_families_match_reference(rigs):
    t, rj, rt = rigs
    spans = [mkspan(bytes([i]) * 16, bytes([j]) * 8)
             for i in range(1, 7) for j in range(1, 3)]

    def run(r):
        for ing in r.ingesters.values():
            ing.overrides.set_tenant_patch(
                "t2", {"ingestion": {"max_traces_per_user": 2}})
        r.dist.push_spans("t1", spans)
        r.dist.push_spans("t2", spans)
        ing = r.ingesters["ing-1"]
        ing.sweep_instance("t1", immediate=True)
        ing.flush_tick()
        return _families(ing.obs.render())
    j, p = both(rj, rt, run)
    assert p == j
    text = "\n".join(p)
    assert 'tempo_ingester_live_traces{tenant="t2"} 2' in text
    assert ('tempo_ingester_discarded_traces_total{tenant="t2",'
            'reason="live_traces_exceeded"} 4') in text
    assert 'tempo_ingester_flush_duration_seconds_count{op="complete"} 1' \
        in text


def test_read_side_raises_naming_item_6(tmp_path):
    """The read side came with item 6b and no longer raises: over a
    tenant it has never seen, each call answers empty as the reference's
    does (`tests/test_torch_querier.py` holds the calls over data)."""
    ing = TIng(str(tmp_path / "p"), now=lambda: T0)
    ref = JIng(str(tmp_path / "j"), now=lambda: T0)
    for name, args in (("search", ("t", "{}")), ("tag_names", ("t",)),
                       ("tag_values", ("t", "x"))):
        got = getattr(ing, name)(*args)
        assert got == getattr(ref, name)(*args) and not got
