"""The port's block layer (`tempo_tpu_torch/block/`, `backend/{local,meta}`)
held against the reference's on the same seeded inputs: the arms of
`tests/test_block.py` and `tests/test_backend.py`, on both packages.

- `nested_set` identical on a chain, an orphan and a cycle;
- bloom filter and shard bytes identical;
- `_trace_aligned_slices` and the `index.json` row-group index identical;
- block meta fields equal but for the id, `encoding`, `size_bytes` and
  `footer_size` (the codecs differ: the port writes gzip PLAIN pages and
  no statistics, the reference zstd dictionary pages with statistics);
- cross-reading: the reference's `BackendBlock.find_trace_by_id` on the
  port's block and the port's on the reference's gzip block equal each
  other and the input;
- the WAL: append, `rescan_blocks`, `complete`, each package on the
  other's WAL directory (the reference's segments written with gzip; its
  default zstd segments make the port raise naming the codec);
- `LocalBackend` and `meta` round trips (`tests/test_backend.py:57,67,77,
  89,98,110,120`) on both packages.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import tempo_tpu.backend as jbackend
import tempo_tpu.block as jblock
from tempo_tpu.block import wal as jwal
from tempo_tpu.block import writer as jwriter
from tempo_tpu.model.combine import combine_spans as j_combine
from tempo_tpu.model.combine import sort_spans as j_sort

import tempo_tpu_torch.backend as tbackend
import tempo_tpu_torch.block as tblock
from tempo_tpu_torch.block import parquet as P
from tempo_tpu_torch.block import writer as twriter
from tempo_tpu_torch.model.combine import (combine_spans, sort_spans,
                                           trace_range)

SIDES = {"ref": (jbackend, jblock), "port": (tbackend, tblock)}


def mkspan(tid, sid, parent=b"", name="op", service="svc", start=1_000,
           dur=50, attrs=None, res_attrs=None, **kw):
    return {
        "trace_id": tid, "span_id": sid, "parent_span_id": parent,
        "name": name, "service": service, "kind": 2, "status_code": 0,
        "status_message": "", "start_unix_nano": start,
        "end_unix_nano": start + dur, "attrs": attrs or {},
        "res_attrs": res_attrs or {}, "events": [], "links": [], **kw,
    }


def seeded_traces(n_traces, seed, max_spans=6):
    """Sorted (trace_id, spans) groups with every attribute type, events
    and links; parents point at earlier spans of the trace."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_traces):
        tid = rng.bytes(16)
        sids = [rng.bytes(8) for _ in range(int(rng.integers(1, max_spans)))]
        spans = []
        for j, sid in enumerate(sids):
            spans.append(mkspan(
                tid, sid, b"" if j == 0 else sids[int(rng.integers(0, j))],
                name=f"op-{int(rng.integers(0, 7))}",
                service=f"svc-{int(rng.integers(0, 4))}",
                start=10**18 + int(rng.integers(0, 10**9)),
                dur=int(rng.integers(0, 10**8)),
                attrs={"http.method": ["GET", "PUT"][j % 2],
                       "http.status_code": int(rng.integers(100, 600)),
                       "ratio": float(rng.random()), "cached": bool(j % 2)},
                res_attrs={"service.name": f"svc-{j % 4}", "zone": "z1",
                           "pid": j},
                events=[{"time_unix_nano": 10**18 + k, "name": f"ev{k}"}
                        for k in range(j % 3)],
                links=[{"trace_id": rng.bytes(16), "span_id": rng.bytes(8)}]
                if j % 4 == 3 else []))
        out.append((tid, spans))
    return sorted(out, key=lambda t: t[0])


def canon(spans):
    """Spans as the block read path returns them (ids padded to their
    column widths), in a stable order."""
    out = [{**s, "trace_id": s["trace_id"].ljust(16, b"\0"),
            "span_id": s["span_id"].ljust(8, b"\0"),
            "parent_span_id": (s["parent_span_id"] or b"").ljust(8, b"\0")}
           for s in spans]
    return sorted(out, key=lambda s: (s["trace_id"], s["span_id"]))


# -- nested set, bloom ---------------------------------------------------------


@pytest.mark.parametrize("case", ["chain", "orphan_and_cycle", "seeded"])
def test_nested_set_identical(case):
    if case == "chain":
        sids = [b"r" * 8, b"a" * 8, b"b" * 8]
        pids = [b"", b"r" * 8, b"a" * 8]
    elif case == "orphan_and_cycle":
        sids = [b"a" * 8, b"b" * 8, b"c" * 8, b"d" * 8]
        pids = [b"", b"x" * 8, b"d" * 8, b"c" * 8]
    else:
        rng = np.random.default_rng(5)
        sids = [rng.bytes(8) for _ in range(64)]
        pids = [sids[int(rng.integers(0, 64))] if i % 9 else b""
                for i in range(64)]
    got = tblock.nested_set(sids, pids)
    assert got == jblock.nested_set(sids, pids)
    left, right, parent = got
    assert all(0 < lo < hi for lo, hi in zip(left, right))


def test_bloom_bytes_identical():
    rng = np.random.default_rng(9)
    ids = [rng.bytes(16) for _ in range(500)]
    jb, tb = jblock.BloomFilter(500, 0.01), tblock.BloomFilter(500, 0.01)
    jb.add_many(ids[:250])
    tb.add_many(ids[:250])
    for i in ids[250:]:
        jb.add(i)
        tb.add(i)
    assert tb.to_bytes() == jb.to_bytes()
    assert all(i in tblock.BloomFilter.from_bytes(jb.to_bytes()) for i in ids)
    js, ts = jblock.ShardedBloom(4, 500), tblock.ShardedBloom(4, 500)
    for i in ids:
        js.add(i)
        ts.add(i)
    assert [ts.shard_bytes(k) for k in range(4)] == \
        [js.shard_bytes(k) for k in range(4)]
    assert ts.shard_of(bytes([7] + [0] * 15)) == 3


# -- block write / read ----------------------------------------------------------


def _blocks(traces, **kw):
    """The same traces written by both packages into their MemBackends
    (the reference with gzip, so the port can read it back)."""
    out = {}
    for side, (be_mod, blk) in SIDES.items():
        be = be_mod.MemBackend()
        ded = [be_mod.DedicatedColumn("span", "http.method"),
               be_mod.DedicatedColumn("resource", "zone")]
        meta = blk.write_block(be, "t1", traces, dedicated_columns=ded,
                               compression="gzip", **kw)
        out[side] = (be, meta)
    return out


def test_slices_index_bloom_and_meta_match_reference():
    traces = seeded_traces(60, 1)
    blocks = _blocks(traces, row_group_rows=40, bloom_shard_count=3)
    (jbe, jm), (tbe, tm) = blocks["ref"], blocks["port"]
    table_j = jblock.traces_to_table(traces)
    table_t = tblock.traces_to_table(traces)
    for rows in (1, 7, 40, 10**6):
        assert twriter._trace_aligned_slices(table_t, rows) == \
            jwriter._trace_aligned_slices(table_j, rows)
    jkp = jbackend.block_keypath(jm.block_id, "t1")
    tkp = tbackend.block_keypath(tm.block_id, "t1")
    assert tbe.read("index.json", tkp) == jbe.read("index.json", jkp)
    for k in range(3):
        assert tbe.read(f"bloom-{k}", tkp) == jbe.read(f"bloom-{k}", jkp)
    jd, td = jm.to_json(), tm.to_json()
    assert td["encoding"] == "gzip"
    for d in (jd, td):
        for key in ("block_id", "encoding", "size_bytes", "footer_size"):
            d.pop(key)
    assert td == jd
    assert tm.row_group_count > 1 and tm.size_bytes > 0 and tm.footer_size > 0
    got = tbackend.read_block_meta(tbe, tm.block_id, "t1")
    assert got == tm


def test_cross_reading_find_trace_by_id():
    traces = seeded_traces(80, 2)
    blocks = _blocks(traces, row_group_rows=50)
    (jbe, jm), (tbe, tm) = blocks["ref"], blocks["port"]
    ref_on_port = jblock.BackendBlock(
        tbe, jbackend.BlockMeta.from_json(tm.to_json()))
    port_on_ref = tblock.BackendBlock(
        jbe, tbackend.BlockMeta.from_json(jm.to_json()))
    port_on_port = tblock.BackendBlock(tbe, tm)
    for tid, spans in traces[::7]:
        want = canon(spans)
        a = ref_on_port.find_trace_by_id(tid)
        b = port_on_ref.find_trace_by_id(tid)
        c = port_on_port.find_trace_by_id(tid)
        assert canon(a) == canon(b) == canon(c) == want
    missing = b"\xff" * 16
    assert port_on_port.find_trace_by_id(missing) is None
    assert port_on_ref.find_trace_by_id(missing) is None
    assert port_on_port.dedicated_column_name("span", "http.method") == \
        "ded_s_00"
    # the port's block read back whole through pyarrow equals its own read
    import io
    import pyarrow.parquet as pq
    data = tbe.read("data.parquet", tbackend.block_keypath(tm.block_id, "t1"))
    assert P.read_table(data).to_pylist() == \
        pq.read_table(io.BytesIO(data)).to_pylist()
    # the columnar scan came with the read side: its row groups hold the
    # file's columns in order
    batches = list(port_on_port.column_batches(["name", "duration_ns"]))
    whole = P.read_table(data)
    assert sum(b["_rows"] for b in batches) == whole.num_rows
    assert [n for b in batches for n in b["name"].tolist()] == \
        whole.column("name").tolist()


def test_find_reads_one_row_group_by_range():
    traces = seeded_traces(80, 3)
    (tbe, tm) = _blocks(traces, row_group_rows=30)["port"]
    b = tblock.BackendBlock(tbe, tm)
    reads = []
    inner = tbe.read_range
    tbe.read_range = lambda *a: (reads.append(a[2:]), inner(*a))[1]
    pf = b.parquet_file()                 # the footer: one tail read
    assert len(reads) == 1
    reads.clear()
    tid, spans = traces[40]
    assert canon(b.find_trace_by_id(tid)) == canon(spans)
    # then one range read per column chunk of the one row group named
    assert len(reads) == len(pf.schema)
    assert sum(n for _, n in reads) < tm.size_bytes / 3
    assert len(b.row_group_index()) == tm.row_group_count > 2


def test_empty_block_matches_reference():
    blocks = _blocks([])
    (jbe, jm), (tbe, tm) = blocks["ref"], blocks["port"]
    assert (tm.total_spans, tm.total_objects, tm.row_group_count) == \
        (jm.total_spans, jm.total_objects, jm.row_group_count) == (0, 0, 0)
    assert tblock.BackendBlock(tbe, tm).find_trace_by_id(b"\x01" * 16) is None


# -- WAL ---------------------------------------------------------------------------


def _append_all(wal_cls, path, traces):
    w = wal_cls(path, "t1")
    for tid, spans in traces:
        w.append(spans[:2])
        if spans[2:]:
            w.append(spans[2:])
    return w


def test_wal_port_dir_read_by_reference(tmp_path):
    traces = seeded_traces(12, 4)
    w = _append_all(tblock.WALBlock, str(tmp_path), traces)
    got = jblock.rescan_blocks(str(tmp_path))
    assert [b.block_id for b in got] == [w.block_id]
    assert [(t, canon(s)) for t, s in got[0].complete()] == \
        [(t, canon(s)) for t, s in traces]
    assert canon(got[0].find_trace_by_id(traces[3][0])) == canon(traces[3][1])
    # and the port's own rescan agrees
    mine = tblock.rescan_blocks(str(tmp_path))[0]
    assert [(t, canon(s)) for t, s in mine.complete()] == \
        [(t, canon(s)) for t, s in traces]
    assert canon(mine.find_trace_by_id(traces[3][0])) == canon(traces[3][1])
    assert mine.find_trace_by_id(b"\xee" * 16) is None
    mine.clear()
    assert tblock.rescan_blocks(str(tmp_path)) == []


class _GzipPQ:
    """pyarrow.parquet with `write_table` writing gzip: the reference's
    WAL hard-codes zstd, which the port cannot read."""

    def __init__(self, pq):
        self._pq = pq

    def write_table(self, table, where, compression=None, **kw):
        return self._pq.write_table(table, where, compression="gzip", **kw)

    def __getattr__(self, name):
        return getattr(self._pq, name)


def test_wal_reference_dir_read_by_port(tmp_path, monkeypatch):
    traces = seeded_traces(12, 5)
    zdir = tmp_path / "zstd"
    _append_all(jblock.WALBlock, str(zdir), traces[:2])
    (zb,) = tblock.rescan_blocks(str(zdir))
    with pytest.raises(NotImplementedError, match="ZSTD"):
        zb.complete()
    monkeypatch.setattr(jwal, "pq", _GzipPQ(jwal.pq))
    gdir = tmp_path / "gzip"
    w = _append_all(jblock.WALBlock, str(gdir), traces)
    got = tblock.rescan_blocks(str(gdir))
    assert [(b.block_id, b.tenant) for b in got] == [(w.block_id, "t1")]
    assert [(t, canon(s)) for t, s in got[0].complete()] == \
        [(t, canon(s)) for t, s in traces]
    assert canon(got[0].find_trace_by_id(traces[7][0])) == canon(traces[7][1])
    # appending through the port continues the reference's numbering
    before = got[0].segments()
    got[0].append(traces[0][1])
    assert got[0].segments()[:-1] == before
    assert got[0].segments()[-1] == f"{len(before):07d}.parquet"


def test_wal_skips_torn_segments_and_tmp_files(tmp_path):
    traces = seeded_traces(4, 6)
    w = _append_all(tblock.WALBlock, str(tmp_path), traces)
    seg = os.path.join(w.dir, w.segments()[0])
    with open(seg, "r+b") as f:
        f.truncate(20)
    with open(os.path.join(w.dir, ".0000099.tmp"), "wb") as f:
        f.write(b"partial")
    (b,) = tblock.rescan_blocks(str(tmp_path))
    got = [(t, canon(s)) for t, s in b.complete()]
    ref = [(t, canon(s)) for t, s in
           jblock.rescan_blocks(str(tmp_path))[0].complete()]
    assert got == ref
    n_spans = sum(len(s) for _, s in traces)
    assert sum(len(s) for _, s in got) == n_spans - len(traces[0][1][:2])


def test_wal_to_complete_block_both_ways(tmp_path):
    traces = seeded_traces(10, 7)
    w = _append_all(tblock.WALBlock, str(tmp_path), traces)
    be = tbackend.MemBackend()
    meta = tblock.write_block(be, "t1", w.complete(), block_id=w.block_id)
    assert meta.total_objects == 10 and meta.block_id == w.block_id
    jb = jblock.BackendBlock(be, jbackend.BlockMeta.from_json(meta.to_json()))
    for tid, spans in traces:
        assert canon(jb.find_trace_by_id(tid)) == canon(spans)


# -- combine -------------------------------------------------------------------------


def test_combine_sort_and_range_match_reference():
    traces = seeded_traces(6, 8)
    spans = [s for _, ss in traces for s in ss]
    dup = spans[::2] + spans
    assert combine_spans(dup, spans[:3]) == j_combine(dup, spans[:3])
    assert sort_spans(list(reversed(spans))) == j_sort(list(reversed(spans)))
    assert trace_range(spans) == (
        min(s["start_unix_nano"] for s in spans),
        max(s["end_unix_nano"] for s in spans))
    assert trace_range([]) == (0, 0)


# -- backend: LocalBackend and meta (tests/test_backend.py) ------------------------


@pytest.fixture(params=["ref", "port"])
def backend(request, tmp_path):
    mod = SIDES[request.param][0]
    return mod, mod.LocalBackend(str(tmp_path / "store"))


def test_raw_roundtrip(backend):
    mod, be = backend
    kp = mod.block_keypath("b1", "tenant-a")
    be.write("data.bin", kp, b"hello world")
    assert be.read("data.bin", kp) == b"hello world"
    assert be.read_range("data.bin", kp, 6, 5) == b"world"
    assert be.size("data.bin", kp) == 11
    with pytest.raises(mod.DoesNotExist):
        be.read("nope", kp)


def test_listing_layout(backend):
    mod, be = backend
    for tenant in ("t1", "t2"):
        for b in ("b1", "b2"):
            be.write("meta.json", mod.block_keypath(b, tenant), b"{}")
    assert mod.tenants(be) == ["t1", "t2"]
    assert mod.blocks(be, "t1") == ["b1", "b2"]
    assert be.find(mod.KeyPath(("t1",)), suffix="meta.json") == [
        "b1/meta.json", "b2/meta.json"]


def test_delete(backend):
    mod, be = backend
    kp = mod.block_keypath("b1", "t")
    be.write("a", kp, b"1")
    be.write("b", kp, b"2")
    be.delete("a", kp)
    with pytest.raises(mod.DoesNotExist):
        be.read("a", kp)
    assert be.read("b", kp) == b"2"
    mod.clear_block(be, "b1", "t")
    assert mod.blocks(be, "t") == []


def test_append_stream(backend):
    mod, be = backend
    kp = mod.block_keypath("b1", "t")
    tracker = None
    for chunk in (b"aa", b"bb", b"cc"):
        tracker = be.append("obj", kp, tracker, chunk)
    be.close_append("obj", kp, tracker)
    assert be.read("obj", kp) == b"aabbcc"


def test_block_meta_roundtrip(backend):
    mod, be = backend
    meta = mod.BlockMeta.new(
        "t1", start_time=100.0, end_time=200.0, total_objects=10,
        total_spans=55, size_bytes=1234, compaction_level=1,
        dedicated_columns=[mod.DedicatedColumn("span", "http.status_code",
                                               "int")],
    )
    mod.write_block_meta(be, meta)
    got = mod.read_block_meta(be, meta.block_id, "t1")
    assert got == meta
    assert mod.has_meta(be, meta.block_id, "t1") == (True, False)
    # the other package reads the same meta.json to an equal meta
    other = (tbackend if mod is jbackend else jbackend).read_block_meta(
        be, meta.block_id, "t1")
    assert other.to_json() == meta.to_json()


def test_compaction_marking(backend):
    mod, be = backend
    meta = mod.BlockMeta.new("t1", total_spans=5)
    mod.write_block_meta(be, meta)
    mod.mark_block_compacted(be, be, meta.block_id, "t1")
    assert mod.has_meta(be, meta.block_id, "t1") == (False, True)
    cm = mod.read_compacted_block_meta(be, meta.block_id, "t1")
    assert cm.meta == meta
    assert cm.compacted_time > 0


def test_tenant_index_roundtrip(backend):
    mod, be = backend
    metas = [mod.BlockMeta.new("t1", total_spans=i) for i in range(3)]
    mod.write_tenant_index(be, "t1", metas, [])
    idx = mod.read_tenant_index(be, "t1")
    assert [m.total_spans for m in idx.metas] == [0, 1, 2]
    assert idx.created_at > 0
    other = (tbackend if mod is jbackend else jbackend).read_tenant_index(
        be, "t1")
    assert [m.to_json() for m in other.metas] == \
        [m.to_json() for m in idx.metas]


def test_backend_exports_and_role_caches_match_reference():
    """The package exports the reference's names, `open_backend` (the
    cloud backends, `tests/test_torch_cloud.py`) among them; the role
    caches behave as the reference's (eviction order, hit and miss
    counts, the reads a `CachingReader` serves from its roles)."""
    from tempo_tpu_torch.backend import cloud

    assert sorted(tbackend.__all__) == sorted(jbackend.__all__)
    assert tbackend.open_backend is cloud.open_backend
    from tempo_tpu.backend import cache as jcache
    from tempo_tpu.backend.mem import MemBackend as JMem
    from tempo_tpu.backend.raw import KeyPath as JKey
    from tempo_tpu_torch.backend import KeyPath as TKey
    from tempo_tpu_torch.backend import MemBackend as TMem
    from tempo_tpu_torch.backend import cache as tcache

    assert tbackend.LRUCache is tcache.LRUCache
    got = []
    for cache_mod, mem, key in ((tcache, TMem, TKey), (jcache, JMem, JKey)):
        lru = cache_mod.LRUCache(max_bytes=9)
        for k, v in (("a", b"123"), ("b", b"4567"), ("a", b"89"),
                     ("c", b"xyzw")):
            lru.put(k, v)
        seen = [lru.get(k) for k in ("a", "b", "c", "d")]
        inner = mem()
        kp = key(("t", "blk"))
        inner.write("bloom-0", kp, b"B" * 8)
        inner.write("data.parquet", kp, b"P" * 64)
        provider = cache_mod.CacheProvider()
        rd = cache_mod.CachingReader(inner, provider)
        reads = [rd.read("bloom-0", kp), rd.read("bloom-0", kp),
                 rd.read_range("data.parquet", kp, 8, 4),
                 rd.read_range("data.parquet", kp, 8, 4),
                 rd.read("data.parquet", kp)]
        roles = {r: (provider.cache_for(r).hits, provider.cache_for(r).misses)
                 for r in (cache_mod.ROLE_BLOOM, cache_mod.ROLE_PAGE,
                           cache_mod.ROLE_FOOTER)}
        got.append((seen, lru.hits, lru.misses, reads, roles))
    assert got[0] == got[1]
    assert got[0][0] == [b"89", None, b"xyzw", None]


def test_block_size_against_reference():
    """The port's blocks carry no statistics and no dictionary pages. On
    these seeded traces (chip_smoke's phase-9 trees, 32 spans a trace)
    the port's gzip block stays within 2x of the reference's gzip and
    zstd blocks; `block_sizes` returns the figures ROADMAP section 3
    quotes."""
    sizes = block_sizes()
    assert sizes["port_gzip"] < sizes["port_none"] / 3
    for ref in ("ref_gzip", "ref_zstd"):
        assert 0.5 < sizes["port_gzip"] / sizes[ref] < 2.0, sizes


def block_sizes(n_spans=4096):
    """Bytes of `data.parquet` for the same traces: the port's (gzip,
    none) and the reference's (gzip, zstd)."""
    from chip_smoke import deep_trace_spans
    from tempo_tpu_torch import native
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    spans = native.spans_from_otlp_proto_native(encode_spans_otlp(
        deep_trace_spans(n_spans, seed=7, now_ns=1_700_000_000 * 10**9)))
    traces = tblock.spans_by_trace(spans)
    out = {}
    for name, blk, be_mod, comp in (
            ("port_gzip", tblock, tbackend, "gzip"),
            ("port_none", tblock, tbackend, "none"),
            ("ref_gzip", jblock, jbackend, "gzip"),
            ("ref_zstd", jblock, jbackend, "zstd")):
        out[name] = blk.write_block(be_mod.MemBackend(), "t", traces,
                                    compression=comp).size_bytes
    return out


def test_concurrent_finds_share_the_row_group_cache():
    """Finds from 8 threads over 4 row groups (more than the block keeps
    decoded) all return the trace, while the cache stays bounded."""
    import sys
    import threading

    traces = seeded_traces(60, 10)
    (tbe, tm) = _blocks(traces, row_group_rows=40)["port"]
    b = tblock.BackendBlock(tbe, tm)
    assert tm.row_group_count >= 4
    errors = []

    def work(k):
        try:
            for tid, spans in traces[k::8]:
                if canon(b.find_trace_by_id(tid)) != canon(spans):
                    errors.append(tid)
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(b._groups) <= tblock.reader.CACHED_ROW_GROUPS
