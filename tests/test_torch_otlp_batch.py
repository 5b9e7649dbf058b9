"""The port's C++-staged SpanBatch (`model/otlp_batch.py`) against the
reference's, column by column, on the same seeded payloads.

Each package stages into a fresh interner of its own; the C++ interners
hand out the same ids in the same order, so every column of the two
batches (ids included) is held equal, as are the wire sizes, the
per-resource service ids, the row-sliced views, the span dicts with
events and links, the trace groups, and `slice_otlp_payload`. service.name
follows dict semantics (the last occurrence wins, whatever its type), and
a non-string service.name is stringified by the Python fixup in both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tempo_tpu import native as jnative
from tempo_tpu.model.interner import StringInterner as JInterner
from tempo_tpu.model.otlp import slice_otlp_payload as j_slice
from tempo_tpu.model.otlp_batch import (batch_from_otlp as j_batch_from_otlp,
                                        stage_otlp as j_stage_otlp)

import tempo_tpu_torch as tt
from tempo_tpu_torch.model import proto_wire as pw
from tempo_tpu_torch.model.interner import StringInterner
from tempo_tpu_torch.model.otlp import slice_otlp_payload, spans_from_otlp_proto
from tests.test_torch_native import _kv, rich_payload


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert jnative.available(), "the reference's native layer must build"
    tt.native.load()


def assert_batches_equal(a, b) -> None:
    """Every column of two SpanBatches equal (ids included)."""
    assert a.n == b.n and a.capacity == b.capacity
    for f in dataclasses.fields(a):
        if f.name == "interner":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        assert np.array_equal(x, y), f.name


@pytest.mark.parametrize("attrs", [(True, True), (False, True), (False, False)],
                         ids=["all", "res-only", "none"])
def test_batch_from_staged_matches_reference(attrs):
    span_attrs, res_attrs = attrs
    it, jt = StringInterner(), JInterner()
    for seed in (11, 12):
        data = rich_payload(seed)
        sb, sizes = tt.batch_from_otlp(
            data, it, return_sizes=True, include_span_attrs=span_attrs,
            include_res_attrs=res_attrs)
        jsb, jsizes = j_batch_from_otlp(
            data, jt, return_sizes=True, include_span_attrs=span_attrs,
            include_res_attrs=res_attrs)
        assert_batches_equal(sb, jsb)
        assert np.array_equal(sizes, jsizes) and sizes[:sb.n].min() > 0
        assert (sb.span_attr_key.shape[1] > 0) == span_attrs
        assert (sb.res_attr_key.shape[1] > 0) == res_attrs
    assert it.snapshot() == jt.snapshot()
    # the staged columns decode to the Python decoder's spans
    py = list(spans_from_otlp_proto(data))
    assert it.lookup_many(sb.name_id[:sb.n]) == [s["name"] for s in py]
    assert it.lookup_many(sb.service_id[:sb.n]) == [s["service"] for s in py]


def _svc_payload(values, t0=1_700_000_000 * 10**9) -> bytes:
    def anyval(v):
        if isinstance(v, bool):
            return pw.enc_field_varint(2, int(v))
        if isinstance(v, int):
            return pw.enc_field_varint(3, v)
        if isinstance(v, float):
            return pw.enc_field_double(4, v)
        if isinstance(v, list):
            return pw.enc_field_msg(5, b"".join(
                pw.enc_field_msg(1, anyval(x)) for x in v))
        return pw.enc_field_str(1, v)

    resource = b"".join(pw.enc_field_msg(1, _kv("service.name", anyval(v)))
                        for v in values)
    span = pw.enc_field_msg(2, (
        pw.enc_field_bytes(1, b"\x01" * 16) + pw.enc_field_bytes(2, b"\x02" * 8)
        + pw.enc_field_str(5, "op") + pw.enc_field_fixed64(7, t0)
        + pw.enc_field_fixed64(8, t0 + 1000)))
    return pw.enc_field_msg(1, pw.enc_field_msg(1, resource) +
                            pw.enc_field_msg(2, span))


@pytest.mark.parametrize("values,want", [
    ([42, "strsvc"], "strsvc"),
    (["strsvc", 42], "42"),
    (["x", True], "True"),
    (["x", 2.5], "2.5"),
    (["x", ["a", 1]], "['a', 1]"),
], ids=["string-last", "int-last", "bool-last", "double-last", "array-last"])
def test_service_name_last_wins_with_fixup(values, want):
    """The last service.name occurrence wins whatever its type; a
    non-string one is stringified by the Python fixup, as in the
    reference and as the Python decoder reads it."""
    data = _svc_payload(values)
    it, jt = StringInterner(), JInterner()
    st, jst = tt.stage_otlp(data, it), j_stage_otlp(data, jt)
    assert st.needs_service_fixup == jst.needs_service_fixup == \
        (not isinstance(values[-1], str) or not all(
            isinstance(v, str) for v in values))
    assert np.array_equal(st.service_ids(), jst.service_ids())
    sb, _ = st.batch()
    assert_batches_equal(sb, jst.batch()[0])
    assert it.lookup(int(sb.service_id[0])) == want
    assert list(spans_from_otlp_proto(data))[0]["service"] == want


def test_staged_views_match_reference():
    """Row-sliced views of one staging (every third row, a ragged tail)
    give the reference's batch slices, sizes, weights, span dicts (with
    events and links) and trace groups; the full view shares the staged
    arrays."""
    data = rich_payload(13, n=300)
    it, jt = StringInterner(), JInterner()
    st, jst = tt.stage_otlp(data, it), j_stage_otlp(data, jt)
    w = np.random.default_rng(13).integers(1, 4, st.n).astype(np.float32)
    st.sample_weight, jst.sample_weight = w, w.copy()
    full = st.view()
    assert full.is_full and full.stage_rows() is st.spans
    assert full.batch_slice()[0] is st.batch()[0]
    for rows in (np.arange(0, 300, 3), np.arange(257, 300), None):
        v, jv = st.view(rows), jst.view(rows)
        assert v.n == jv.n
        (sb, sizes), (jsb, jsizes) = v.batch_slice(), jv.batch_slice()
        assert_batches_equal(sb, jsb)
        assert np.array_equal(sizes, jsizes)
        assert np.array_equal(v.weights(), jv.weights())
        assert np.array_equal(v.stage_rows()["span_len"],
                              jv.stage_rows()["span_len"])
        assert v.to_span_dicts() == jv.to_span_dicts()
        assert v.trace_groups() == jv.trace_groups()
    dicts = full.to_span_dicts()
    assert sum("events" in d for d in dicts) == 34
    assert st.events_links() == jst.events_links()
    skipped = tt.stage_otlp(data, it, include_span_attrs=False)
    with pytest.raises(ValueError, match="include_span_attrs"):
        skipped.view().to_span_dicts()


def test_slice_otlp_payload_matches_reference():
    data = rich_payload(14, n=300)
    recs = tt.native.otlp_scan(data)
    pick = np.flatnonzero(np.arange(len(recs)) % 3 == 1).tolist()
    sliced = slice_otlp_payload(data, recs, pick)
    assert sliced == j_slice(data, recs, pick)
    got = list(spans_from_otlp_proto(sliced))
    whole = list(spans_from_otlp_proto(data))
    assert len(got) == len(pick)
    assert sorted(s["span_id"] for s in got) == \
        sorted(whole[i]["span_id"] for i in pick)
