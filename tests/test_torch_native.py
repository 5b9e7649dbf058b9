"""The port's C++ host layer (`tempo_tpu_torch.native`) against the
reference's (`tempo_tpu.native`), on the same seeded payloads.

Both libraries are built from the same C++ with the same flags, so the
records they stage are held byte-equal (every field but the layouts'
`_pad` words, which no entry point writes), the interners' ids and
strings equal, and the row tables' slots equal (first-seen order). Also
held: malformed payloads raise in both, a Resource serialized after its
spans, an int attribute above 2^53, the multi-threaded scan and staging
against the serial ones, and a build into an empty directory.

Both libraries are built (or found) in a module fixture, outside any
test's call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest

from tempo_tpu import native as jnative
from tempo_tpu.model.interner import StringInterner as JInterner
from tempo_tpu.model.otlp import spans_from_otlp_proto as j_spans
from tempo_tpu.registry.series import SeriesBudget as JBudget
from tempo_tpu.registry.series import SeriesTable as JTable

from tempo_tpu_torch import native
from tempo_tpu_torch.model import proto_wire as pw
from tempo_tpu_torch.model.interner import StringInterner
from tempo_tpu_torch.model.otlp import (encode_spans_otlp, spans_from_otlp_proto,
                                        synthetic_spans)
from tempo_tpu_torch.registry.series import SeriesBudget, SeriesTable

NOW_NS = 1_700_000_000 * 10**9


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert jnative.available(), "the reference's native layer must build"
    native.load()


def rich_spans(seed: int, n: int = 400, now_ns: int = NOW_NS) -> list[dict]:
    """Seeded spans over 6 services whose attributes take every AnyValue
    type (string, bool, int incl. above 2^53 and negative, double, array,
    kvlist, bytes), with status messages, parents, events and links on
    some, and resources of one to three attributes."""
    rng = np.random.default_rng(seed)
    spans = synthetic_spans(n, seed=seed, now_ns=now_ns, n_services=6,
                            n_ops=9)
    for i, s in enumerate(spans):
        k = int(rng.integers(0, 8))
        attrs = {"http.method": ("GET", "POST")[k % 2],
                 "http.status_code": 200 + int(rng.integers(0, 5)) * 100}
        if k >= 2:
            attrs["flag"] = bool(k % 3)
            attrs["ratio"] = float(rng.random())
        if k >= 4:
            attrs["big"] = (1 << 53) + int(rng.integers(1, 99))
            attrs["neg"] = -int(rng.integers(1, 1 << 40))
        if k >= 5:
            attrs["list"] = ["a", int(k), 1.5]
            attrs["kv"] = {"x": "y", "n": int(k)}
            attrs["raw"] = bytes([k, 0, 255])
        s["attrs"] = attrs
        s["res_attrs"] = {"service.name": s["service"]}
        if i % 3 == 0:
            s["res_attrs"]["host"] = f"h{i % 4}"
        if i % 5 == 0:
            s["res_attrs"]["zone"] = ("a", "b")[i % 2]
        if s["status_code"] == 2:
            s["status_message"] = f"boom-{i % 7}"
        if i % 4 == 1:
            s["parent_span_id"] = spans[i - 1]["span_id"]
        if i % 9 == 0:
            s["events"] = [{"time_unix_nano": s["start_unix_nano"] + 5,
                            "name": f"ev-{i % 3}"}]
            s["links"] = [{"trace_id": spans[i - 1]["trace_id"],
                           "span_id": spans[i - 1]["span_id"]}]
    return spans


def rich_payload(seed: int, n: int = 400, now_ns: int = NOW_NS) -> bytes:
    return encode_spans_otlp(rich_spans(seed, n, now_ns))


def assert_records_equal(a: np.ndarray, b: np.ndarray, ctx: str = "") -> None:
    """Structured record arrays equal field by field (the `_pad` words of
    the layouts are never written)."""
    assert a.dtype == b.dtype and len(a) == len(b), ctx
    for name in a.dtype.names:
        if name != "_pad":
            assert np.array_equal(a[name], b[name]), f"{ctx}: {name}"


def _kv(k: str, v: bytes) -> bytes:
    return pw.enc_field_str(1, k) + pw.enc_field_msg(2, v)


def test_tokens_crc_and_grouping_match_reference():
    rng = np.random.default_rng(0)
    tids = rng.integers(0, 256, (300, 16), dtype=np.uint8)
    assert np.array_equal(native.token_for("tenant-x", tids),
                          jnative.token_for("tenant-x", tids))
    for data in (b"", b"123456789", rng.bytes(4097)):
        assert native.crc32c(data) == jnative.crc32c(data)
    assert native.crc32c(b"123456789") == 0xE3069283   # the Castagnoli check
    keys = rng.integers(0, 4, size=(2000, 17)).astype(np.uint8)
    for got, want in zip(native.group_keys(keys), jnative.group_keys(keys)):
        assert np.array_equal(got, want)
    payload = rich_payload(1)
    recs = native.otlp_scan(payload)
    valid = np.arange(len(recs)) % 3 != 0
    for got, want in ((native.group_keys_recs(recs, valid),
                       jnative.group_keys_recs(recs, valid)),
                      (native.group_keys_strided(recs, None),
                       jnative.group_keys_strided(recs, None))):
        assert all(np.array_equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("seed", [1, 2])
def test_scan_records_byte_equal(seed):
    payload = rich_payload(seed)
    assert_records_equal(native.otlp_scan(payload), jnative.otlp_scan(payload))
    for a, b in zip(native.otlp_scan2(payload), jnative.otlp_scan2(payload)):
        assert_records_equal(a, b)
    for a, b in zip(native.otlp_events(payload), jnative.otlp_events(payload)):
        assert len(a) and len(b)
        assert_records_equal(a, b)
    nat = native.spans_from_otlp_proto_native(payload)
    assert nat == jnative.spans_from_otlp_proto_native(payload)
    py = list(spans_from_otlp_proto(payload))
    for a, b in zip(nat, py, strict=True):
        for k in ("trace_id", "span_id", "name", "service", "kind",
                  "status_code", "status_message", "start_unix_nano",
                  "end_unix_nano", "attrs", "res_attrs"):
            assert a[k] == b[k], k


@pytest.mark.parametrize("skip_span_attrs", [False, True])
def test_stage_records_and_interner_ids_byte_equal(skip_span_attrs):
    """Three payloads staged in turn into one interner per package: every
    staged record equal, and the interners' ids and strings equal."""
    it, jt = StringInterner(), JInterner()
    it.intern("service.name")
    jt.intern("service.name")
    for seed in (3, 4, 5):
        payload = rich_payload(seed)
        got = native.otlp_stage(it.native_handle(), payload,
                                skip_span_attrs=skip_span_attrs)
        want = jnative.otlp_stage(jt.native_handle(), payload,
                                  skip_span_attrs=skip_span_attrs)
        for a, b, what in zip(got, want, ("spans", "span attrs",
                                          "res attrs", "resources")):
            assert_records_equal(a, b, what)
        assert len(got[0]) == 400 and len(got[2]) and len(got[3])
        assert (len(got[1]) == 0) == skip_span_attrs
    assert len(it) == len(jt) > 20
    assert it.snapshot() == jt.snapshot()
    assert [it.get(s) for s in jt.snapshot()] == list(range(len(jt)))


MALFORMED = {
    "truncated varint": b"\x0a\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff",
    "length past the end": b"\x0a\x10\x12\x02",
    "bad wire type": b"\x0f\x01",
}


@pytest.mark.parametrize("name", sorted(MALFORMED) + ["cut payload"])
def test_malformed_payloads_raise_in_both(name):
    data = MALFORMED.get(name) or rich_payload(6, n=50)[:-5]
    for mod in (native, jnative):
        with pytest.raises(ValueError):
            mod.otlp_scan(data)
        with pytest.raises(ValueError):
            mod.otlp_scan2(data)
        with pytest.raises(ValueError):
            mod.otlp_stage(mod.NativeInterner(), data)
        with pytest.raises(ValueError):
            mod.otlp_stage(mod.NativeInterner(), data, skip_span_attrs=True)


def test_resource_after_spans_and_large_int_attr():
    """A Resource serialized after its ScopeSpans is legal wire order; an
    int attribute above 2^53 stays exact (no double round trip)."""
    big = (1 << 53) + 1
    span = (pw.enc_field_bytes(1, b"\x05" * 16) +
            pw.enc_field_bytes(2, b"\x01" * 8) + pw.enc_field_str(5, "x") +
            pw.enc_field_msg(9, _kv("n", pw.enc_field_varint(3, big))))
    scope_spans = pw.enc_field_msg(2, pw.enc_field_msg(2, span))
    resource = pw.enc_field_msg(1, pw.enc_field_msg(
        1, _kv("service.name", pw.enc_field_str(1, "late"))))
    data = pw.enc_field_msg(1, scope_spans + resource)     # spans first
    nat = native.spans_from_otlp_proto_native(data)
    assert nat == jnative.spans_from_otlp_proto_native(data)
    assert nat[0]["service"] == list(spans_from_otlp_proto(data))[0][
        "service"] == list(j_spans(data))[0]["service"] == "late"
    assert nat[0]["attrs"]["n"] == big
    it, jt = StringInterner(), JInterner()
    got = native.otlp_stage(it.native_handle(), data)
    want = jnative.otlp_stage(jt.native_handle(), data)
    for a, b in zip(got, want):
        assert_records_equal(a, b)
    assert it.lookup(int(got[0]["service_id"][0])) == "late"
    assert int(got[1]["ival"][0]) == big


def test_scan_and_stage_mt_match_serial(monkeypatch):
    """The threaded scan and staging emit the serial passes' records in
    the same order (staging compared by string content: two interners),
    and reject a cut payload."""
    payload = encode_spans_otlp(synthetic_spans(
        4096, seed=7, now_ns=NOW_NS, n_services=13))
    monkeypatch.setattr(native, "_SCAN_MT_BYTES", 1)
    monkeypatch.setattr(native, "_SCAN_THREADS", 4)
    mt = native.otlp_scan(payload)
    it_mt, it_s = StringInterner(), StringInterner()
    a = native.otlp_stage(it_mt.native_handle(), payload, skip_span_attrs=True)
    with pytest.raises(ValueError):
        native.otlp_scan(payload[:-3])
    with pytest.raises(ValueError):
        native.otlp_stage(it_mt.native_handle(), payload[:-5],
                          skip_span_attrs=True)
    monkeypatch.setattr(native, "_SCAN_MT_BYTES", 1 << 60)
    assert_records_equal(mt, native.otlp_scan(payload))
    assert_records_equal(mt, jnative.otlp_scan(payload))
    b = native.otlp_stage(it_s.native_handle(), payload, skip_span_attrs=True)
    sa, sb = a[0], b[0]
    assert len(sa) == len(sb) == 4096
    for col in ("trace_id", "span_id", "start_ns", "end_ns", "kind",
                "status_code", "res_idx", "span_len"):
        assert np.array_equal(sa[col], sb[col]), col
    for col in ("name_id", "service_id"):
        assert it_mt.lookup_many(sa[col]) == it_s.lookup_many(sb[col]), col


def _table_pair(capacity, n_labels, budget=None):
    jb = JBudget(budget) if budget else None
    tb = SeriesBudget(budget) if budget else None
    return (JTable(capacity, n_labels, budget=jb),
            SeriesTable(capacity, n_labels, budget=tb))


def test_row_table_slots_match_reference_first_seen():
    """The same label rows through both series tables, with invalid rows,
    in-batch duplicates, a purge and slot reuse: slots equal push by
    push, handed out in first-seen order."""
    rng = np.random.default_rng(8)
    jt, tt_ = _table_pair(256, 3)
    assert jt._nat is not None
    rows = rng.integers(0, 40, (600, 3)).astype(np.int32)
    rows[:, 0] = rng.integers(0, 4, 600)
    valid = rng.random(600) > 0.1
    got = tt_.lookup_or_create(rows, 1.0, valid=valid)
    want = jt.lookup_or_create(rows, 1.0, valid=valid)
    assert np.array_equal(got, want)
    first = np.unique(got[got >= 0], return_index=True)[1]
    assert np.array_equal(np.sort(first), first)   # slot order = first seen
    assert np.array_equal(tt_.last_seen, jt.last_seen)
    # half the series go stale, then new combos reuse their slots
    again = jt.lookup_or_create(rows[:200], 5.0)
    assert np.array_equal(tt_.lookup_or_create(rows[:200], 5.0), again)
    assert np.array_equal(tt_.purge_stale(3.0), jt.purge_stale(3.0))
    fresh = rows + 1000
    assert np.array_equal(tt_.lookup_or_create(fresh, 6.0),
                          jt.lookup_or_create(fresh, 6.0))
    assert np.array_equal(tt_.slot_keys, jt.slot_keys)
    assert tt_._nat.size() == jt._nat.size() == tt_.active_count


@pytest.mark.parametrize("limit", ["budget", "capacity"])
def test_rejected_series_leave_no_pending_row(limit):
    """A spent budget or a full table rejects new combos (slot -1, counted
    discarded) in both packages alike, and the native table keeps no
    pending entry for them: a later push of the same combo is a miss
    again, and is accepted once a slot is free."""
    cap, budget = (64, 10) if limit == "budget" else (10, None)
    jt, tt_ = _table_pair(cap, 2, budget)
    rows = np.stack([np.arange(30), np.arange(30) % 3], 1).astype(np.int32)
    for t in (1.0, 2.0):
        got = tt_.lookup_or_create(rows, t)
        assert np.array_equal(got, jt.lookup_or_create(rows, t))
        assert (got >= 0).sum() == 10
        assert tt_._nat.size() == jt._nat.size() == 10
    assert tt_.discarded == jt.discarded == 40
    tt_.lookup_or_create(rows[:5], 9.0)
    jt.lookup_or_create(rows[:5], 9.0)
    assert np.array_equal(tt_.purge_stale(5.0), jt.purge_stale(5.0))
    got = tt_.lookup_or_create(rows[20:], 10.0)
    assert np.array_equal(got, jt.lookup_or_create(rows[20:], 10.0))
    assert (got >= 0).sum() == 5 and tt_._nat.size() == 10


def test_spanmetrics_resolve_matches_reference():
    """The fused resolve of the staged route, and of scan records, give
    the reference's slots, packed durations and sizes, label rows,
    validity, misses and slack counts, and stamp the same last_seen."""
    payload = rich_payload(9, n=600)
    it, jt = StringInterner(), JInterner()
    spans = native.otlp_stage(it.native_handle(), payload,
                              skip_span_attrs=True)[0]
    jspans = jnative.otlp_stage(jt.native_handle(), payload,
                                skip_span_attrs=True)[0]
    recs = native.otlp_scan(payload)
    tab, jtab = SeriesTable(1024, 4), JTable(1024, 4)
    dims = np.arange(4, dtype=np.int32)
    luts = [np.asarray(x.intern_many(s), np.int32) for x in (it, jt)
            for s in (("K%d" % i for i in range(6)),
                      ("S%d" % i for i in range(3)))]
    ends = spans["end_ns"].astype(np.int64)
    lo, hi = int(np.percentile(ends, 10)), int(np.percentile(ends, 90))
    cap = 1024
    got = native.spanmetrics_resolve(tab._nat, spans, dims, *luts[:2], lo,
                                     hi, 3.5, tab.last_seen, cap)
    want = jnative.spanmetrics_resolve(jtab._nat, jspans, dims, *luts[2:],
                                       lo, hi, 3.5, jtab.last_seen, cap)
    for a, b in zip(got, want, strict=True):
        assert np.array_equal(a, b)
    assert got[5] + got[6] == 600 and got[6] > 100       # slack filtered
    tab.apply_misses(got[2], got[0], got[4], got[3], 3.5)
    jtab.apply_misses(want[2], want[0], want[4], want[3], 3.5)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(tab.last_seen, jtab.last_seen)
    rgot = native.spanmetrics_from_recs(
        tab._nat, it.native_handle()._h, payload, recs, dims, *luts[:2], lo,
        hi, 4.5, tab.last_seen, cap)
    rwant = jnative.spanmetrics_from_recs(
        jtab._nat, jt.native_handle()._h, payload, recs, dims, *luts[2:],
        lo, hi, 4.5, jtab.last_seen, cap)
    for a, b in zip(rgot, rwant, strict=True):
        assert np.array_equal(a, b)
    assert rgot[4].size == 0                  # every series known already
    assert np.array_equal(rgot[0], got[0])
    assert np.array_equal(rgot[1], got[1])
    with pytest.raises(ValueError, match="StageRec"):
        native.spanmetrics_resolve(tab._nat, recs, dims, *luts[:2], lo, hi,
                                   1.0, tab.last_seen, cap)


@pytest.fixture(scope="module")
def fresh_build(tmp_path_factory):
    """A build into an empty directory, made once for the module."""
    d = tmp_path_factory.mktemp("empty")
    assert not any(d.iterdir())
    return d, native.build(d)


def test_build_in_an_empty_directory(fresh_build):
    """The library builds into an empty directory under a name keyed by
    source, flags, compiler and CPU (the same name the repository's
    `build/` holds), leaves no temporary file, and loads and runs."""
    d, so = fresh_build
    assert [p.name for p in d.iterdir()] == [so.name]
    assert so.name == native.so_path().name
    assert so.name.startswith("tempo_native-") and so.suffix == ".so"
    lib = ctypes.CDLL(str(so))
    lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.crc32c.restype = ctypes.c_uint32
    assert lib.crc32c(b"123456789", 9) == 0xE3069283
    assert native.build(d) == so              # found, not rebuilt
