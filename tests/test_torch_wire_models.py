"""The port's wire models against the reference's, on seeded inputs.

- `model/tempopb`: every encoder's bytes equal the reference's byte for
  byte, and each package decodes the other's bytes to the same values
  (`QueryStats.device_ns` on the wire: `tests/test_devtime.py:355`).
- `model/jaeger`: Thrift `TBinaryProtocol` batches (the collector route),
  `api_v2` protobuf batches (the gRPC `PostSpans` route) and
  `TCompactProtocol` agent datagrams decode to equal spans; malformed
  bytes raise `ValueError` in both (the agent's oversized collection
  counts fast: `tests/test_app.py:620`).
- `model/opencensus`: messages of a stream decode to equal spans, with
  the node and resource carried from message to message as both do.

Inputs come from `numpy.random.default_rng(seed)`; tolerance 0
throughout (host code on both sides).
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from tempo_tpu.model import jaeger as jj
from tempo_tpu.model import opencensus as joc
from tempo_tpu.model import tempopb as jpb
from tempo_tpu.obs import querystats as jqs
from tempo_tpu.traceql import engine as jeng
from tempo_tpu.traceql import engine_metrics as jem
from tempo_tpu_torch.model import jaeger as tj
from tempo_tpu_torch.model import opencensus as toc
from tempo_tpu_torch.model import proto_wire as pw
from tempo_tpu_torch.model import tempopb as tpb
from tempo_tpu_torch.obs import querystats as tqs
from tempo_tpu_torch.traceql import engine as teng
from tempo_tpu_torch.traceql import engine_metrics as tem
from tests.test_app import _agent_datagram, _c_str, _c_varint, _jaeger_batch

SEEDS = (0, 1, 2, 20261017)


def _ids(rng, n):
    return bytes(rng.integers(0, 256, n, dtype=np.uint8))


def _metadata(rng, eng):
    sets = []
    for _ in range(int(rng.integers(0, 3))):
        spans = [{"spanID": _ids(rng, 8).hex(), "name": f"op-{j}",
                  "startTimeUnixNano": str(int(rng.integers(1, 1 << 62))),
                  "durationNanos": str(int(rng.integers(0, 1 << 40))),
                  "attributes": [
                      {"key": "k", "value": {"stringValue": f"v{j}"}},
                      {"key": "n", "value": {"intValue": str(j)}}]}
                 for j in range(int(rng.integers(1, 4)))]
        sets.append({"spans": spans, "matched": int(rng.integers(1, 9))})
    return eng.TraceSearchMetadata(
        trace_id=_ids(rng, 16).hex(),
        root_service_name=f"svc-{int(rng.integers(0, 5))}",
        root_trace_name=f"root-{int(rng.integers(0, 5))}",
        start_time_unix_nano=int(rng.integers(1, 1 << 62)),
        duration_ms=int(rng.integers(0, 100_000)), span_sets=sets)


def _series(rng, em):
    out = []
    for i in range(int(rng.integers(1, 5))):
        labels = (("service", f"s{i}"), ("__bucket", float(rng.random())),
                  ("code", int(rng.integers(-5, 600))), ("flag", bool(i % 2)))
        out.append(em.TimeSeries(labels=labels[:1 + i % 4],
                                 samples=rng.normal(size=int(
                                     rng.integers(1, 9)))))
    return out


def _spans(rng, n=4):
    tid = _ids(rng, 16)
    out = []
    for i in range(n):
        t0 = int(rng.integers(1, 1 << 60))
        out.append({"trace_id": tid, "span_id": _ids(rng, 8),
                    "parent_span_id": b"" if i == 0 else out[0]["span_id"],
                    "name": f"op-{i}", "service": f"svc-{i % 2}",
                    "kind": int(rng.integers(0, 6)),
                    "status_code": int(rng.integers(0, 3)),
                    "start_unix_nano": t0,
                    "end_unix_nano": t0 + int(rng.integers(0, 1 << 30)),
                    "attrs": {"http.status_code": int(rng.integers(100, 600)),
                              "s": f"x{i}", "f": float(rng.random()),
                              "b": bool(i % 2)},
                    "res_attrs": {"service.name": f"svc-{i % 2}"},
                    "events": [{"time_unix_nano": t0 + 1, "name": "ev"}],
                    "links": [{"trace_id": _ids(rng, 16),
                               "span_id": _ids(rng, 8)}]})
    return out


def _stats(qs, rng):
    st = qs.QueryStats()
    st.add(**{f: int(rng.integers(0, 1 << 40)) for f in qs.COUNTER_FIELDS})
    return st


def _series_key(series):
    return [(s.labels, [type(v) for _, v in s.labels],
             np.asarray(s.samples).tolist()) for s in series]


@pytest.mark.parametrize("seed", SEEDS)
def test_tempopb_search_byte_identical(seed):
    """Search requests and responses (metadata, span sets, stats, the
    final flag): the same bytes, and each side decodes the other's."""
    mds = {}
    for p, e in (("t", teng), ("j", jeng)):
        rng = np.random.default_rng(seed)
        mds[p] = [_metadata(rng, e) for _ in range(3)]
    st_t, st_j = (_stats(tqs, np.random.default_rng(seed)),
                  _stats(jqs, np.random.default_rng(seed)))
    for final in (False, True):
        bt = tpb.enc_search_response(mds["t"], inspected=7, final=final,
                                     stats=st_t)
        bj = jpb.enc_search_response(mds["j"], inspected=7, final=final,
                                     stats=st_j)
        assert bt == bj
        dec = []
        for fn, body in ((tpb.dec_search_response, bj),
                         (jpb.dec_search_response, bt)):
            got, fin, insp, st = fn(body)
            # the legacy scalar carries stats.inspected_traces
            assert fin == final and insp == st_t.inspected_traces
            assert [m.trace_id for m in got] == \
                [m.trace_id for m in mds["t"]]
            assert st.to_json() == st_t.to_json()
            dec.append([m.to_json() for m in got])
        assert dec[0] == dec[1]
    req = ("{ .a = 1 }", 20, 1.5, 99.25)
    assert tpb.enc_search_request(*req) == jpb.enc_search_request(*req)
    assert tpb.dec_search_request(jpb.enc_search_request(*req)) == \
        jpb.dec_search_request(tpb.enc_search_request(*req))


@pytest.mark.parametrize("seed", SEEDS)
def test_tempopb_query_range_and_traces_byte_identical(seed):
    """Query-range series (label value types kept), trace by id (events,
    links, attributes), push responses: the same bytes both ways."""
    st = _series(np.random.default_rng(seed), tem)
    sj = _series(np.random.default_rng(seed), jem)
    bt, bj = tpb.enc_query_range_response(st), jpb.enc_query_range_response(sj)
    assert bt == bj
    assert _series_key(tpb.dec_query_range_response(bj)) == \
        _series_key(jpb.dec_query_range_response(bt)) == _series_key(st)
    spans = _spans(np.random.default_rng(seed))
    bt, bj = tpb.enc_trace_by_id_response(spans), \
        jpb.enc_trace_by_id_response(spans)
    assert bt == bj
    assert tpb.dec_trace_by_id_response(bj) == \
        jpb.dec_trace_by_id_response(bt)
    assert tpb.enc_trace_by_id_response(None) == \
        jpb.enc_trace_by_id_response(None)
    tid = spans[0]["trace_id"]
    assert tpb.enc_trace_by_id_request(tid) == jpb.enc_trace_by_id_request(tid)
    assert tpb.dec_trace_by_id_request(jpb.enc_trace_by_id_request(tid)) == tid
    errs = [None if r < 0.6 else "trace_too_large"
            for r in np.random.default_rng(seed).random(9)]
    assert tpb.enc_push_response(errs) == jpb.enc_push_response(errs)
    assert tpb.dec_push_response(jpb.enc_push_response(errs), 9) == errs


def test_querystats_device_ns_round_trips_wire():
    """`tests/test_devtime.py:355` on the port, and the bytes equal the
    reference's."""
    st = tqs.QueryStats()
    st.add(device_ns=123456, inspected_traces=3)
    st2 = tpb.dec_query_stats(tpb.enc_query_stats(st))
    assert st2.device_ns == 123456 and st2.inspected_traces == 3
    assert tqs.QueryStats.from_json(st.to_json()).device_ns == 123456
    js = jqs.QueryStats()
    js.add(device_ns=123456, inspected_traces=3)
    assert tpb.enc_query_stats(st) == jpb.enc_query_stats(js)
    assert jpb.dec_query_stats(tpb.enc_query_stats(st)).device_ns == 123456


def _thrift_spans(rng, n):
    now_us = int(time.time() * 1e6)
    kinds = ["server", "client", "producer", "consumer", "internal"]
    out = []
    for i in range(n):
        tags = {"span.kind": kinds[int(rng.integers(0, 5))],
                "http.status_code": int(rng.integers(100, 600)),
                "peer.address": f"10.0.0.{i}", "ratio": float(rng.random())}
        if rng.random() < 0.3:
            tags["error"] = True
        out.append({"tid_lo": int(rng.integers(0, 1 << 62)),
                    "tid_hi": int(rng.integers(0, 1 << 62)),
                    "sid": int(rng.integers(1, 1 << 62)),
                    "psid": int(rng.integers(0, 1 << 62)) if i else 0,
                    "name": f"op-{i}",
                    "start_us": now_us - int(rng.integers(0, 10**7)),
                    "dur_us": int(rng.integers(0, 10**6)), "tags": tags})
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_jaeger_thrift_batches_decode_alike(seed):
    """Collector batches (TBinaryProtocol): equal spans, span.kind and
    error tags mapped to intrinsics in both."""
    rng = np.random.default_rng(seed)
    body = _jaeger_batch(f"svc-{seed}", _thrift_spans(rng, 6))
    got = tj.spans_from_jaeger_thrift(body)
    assert got == jj.spans_from_jaeger_thrift(body) and len(got) == 6
    assert all("span.kind" not in s["attrs"] for s in got)
    assert all(s["res_attrs"]["hostname"] == "h1" for s in got)


@pytest.mark.parametrize("seed", SEEDS)
def test_jaeger_agent_datagrams_decode_alike(seed):
    """Agent datagrams (TCompactProtocol `emitBatch`): equal spans."""
    rng = np.random.default_rng(seed)
    gram = _agent_datagram(f"udp-{seed}", _thrift_spans(rng, 5))
    got = tj.spans_from_jaeger_agent(gram)
    assert got == jj.spans_from_jaeger_agent(gram) and len(got) == 5


@pytest.mark.parametrize("seed", SEEDS)
def test_jaeger_proto_batches_decode_alike(seed):
    """`api_v2` PostSpans requests, built with the tempo-query encoder of
    each package (equal bytes), decode to equal spans."""
    from tempo_tpu.tempoquery.plugin import _jaeger_span as jspan
    from tempo_tpu_torch.tempoquery.plugin import _jaeger_span as tspan

    spans = _spans(np.random.default_rng(seed), 5)
    for s in spans:
        s["span_id"] = s["span_id"].hex()
        s["parent_span_id"] = s["parent_span_id"].hex()
        del s["links"], s["events"]
    tid = spans[0]["trace_id"]
    enc = [tspan(s, tid) for s in spans]
    assert enc == [jspan(s, tid) for s in spans]
    batch = b"".join(pw.enc_field_msg(1, e) for e in enc) + \
        pw.enc_field_msg(2, pw.enc_field_str(1, "svc-0"))
    request = pw.enc_field_msg(1, batch)
    got = tj.spans_from_jaeger_proto(request)
    assert got == jj.spans_from_jaeger_proto(request) and len(got) == 5
    assert tj.spans_from_jaeger_proto(batch, wrapped=False) == \
        jj.spans_from_jaeger_proto(batch, wrapped=False)


def _oc_stream(rng, n_msgs=4):
    def ts(ns):
        return pw.enc_field_varint(1, ns // 10**9) + \
            pw.enc_field_varint(2, ns % 10**9)

    def attr(k, v):
        if isinstance(v, str):
            av = pw.enc_field_msg(1, pw.enc_field_str(1, v))
        elif isinstance(v, bool):
            av = pw.enc_field_varint(3, int(v))
        elif isinstance(v, float):
            av = pw.enc_field_double(4, v)
        else:
            av = pw.enc_field_varint(2, v)
        return pw.enc_field_msg(1, pw.enc_field_str(1, k) +
                                pw.enc_field_msg(2, av))

    t0 = int(time.time() * 1e9) - 10**9
    msgs = []
    for m in range(n_msgs):
        tid = _ids(rng, 16)
        body = b""
        if m == 0:
            body += pw.enc_field_msg(1, pw.enc_field_msg(
                3, pw.enc_field_str(1, "oc-svc")))
        if m == 2:
            lab = pw.enc_field_msg(2, pw.enc_field_str(1, "zone") +
                                   pw.enc_field_str(2, "z1"))
            body += pw.enc_field_msg(3, pw.enc_field_str(1, "host") + lab)
        for i in range(3):
            start = t0 + int(rng.integers(0, 10**8))
            span = (pw.enc_field_bytes(1, tid) +
                    pw.enc_field_bytes(2, _ids(rng, 8)) +
                    pw.enc_field_msg(5, pw.enc_field_str(1, f"oc-op-{i}")) +
                    pw.enc_field_varint(6, int(rng.integers(0, 3))) +
                    pw.enc_field_msg(7, ts(start)) +
                    pw.enc_field_msg(8, ts(start + int(rng.integers(0, 10**7)))) +
                    pw.enc_field_msg(9, attr("oc.key", f"v{i}") +
                                     attr("n", int(rng.integers(0, 99))) +
                                     attr("b", bool(i % 2)) +
                                     attr("f", float(rng.random()))))
            if rng.random() < 0.5:
                span += pw.enc_field_msg(13, pw.enc_field_varint(
                    1, int(rng.integers(1, 16))))
            body += pw.enc_field_msg(2, span)
        msgs.append(body)
    return msgs


@pytest.mark.parametrize("seed", SEEDS)
def test_opencensus_stream_decodes_alike(seed):
    """A stream of 4 OpenCensus messages: equal spans message by message,
    with the node (first message) and resource (third) carried along."""
    msgs = _oc_stream(np.random.default_rng(seed))
    state = {"t": ("", {}), "j": ("", {})}
    n = 0
    for body in msgs:
        ts_, svc_t, res_t = toc.spans_from_opencensus(body, *state["t"])
        js_, svc_j, res_j = joc.spans_from_opencensus(body, *state["j"])
        assert (ts_, svc_t, res_t) == (js_, svc_j, res_j)
        state = {"t": (svc_t, res_t), "j": (svc_j, res_j)}
        n += len(ts_)
        assert all(s["service"] == "oc-svc" for s in ts_)
    assert n == 12


def test_malformed_payloads_raise_in_both():
    """Truncated and garbled bytes: ValueError from each decoder of both
    packages; the agent's oversized collection counts fail fast."""
    rng = np.random.default_rng(5)
    good_thrift = _jaeger_batch("s", _thrift_spans(rng, 2))
    good_gram = _agent_datagram("s", _thrift_spans(rng, 2))
    good_oc = _oc_stream(rng, 1)[0]
    cases = [(tj.spans_from_jaeger_thrift, jj.spans_from_jaeger_thrift,
              [good_thrift[:n] for n in (5, 17, len(good_thrift) // 2)]
              + [b"\x0b\x00\x01"]),
             (tj.spans_from_jaeger_agent, jj.spans_from_jaeger_agent,
              [good_gram[:n] for n in (20, len(good_gram) // 2, 3)]),
             (tj.spans_from_jaeger_proto, jj.spans_from_jaeger_proto,
              [b"\x0a\x05ab", b"\xff\xfe garbage"]),
             (toc.spans_from_opencensus, joc.spans_from_opencensus,
              [good_oc[:7], b"\x12\x10abc", b"\xff\xfe garbage"])]
    def outcome(fn, bad):
        try:
            return ("ok", fn(bad))
        except ValueError:
            return ("ValueError", None)

    for tdec, jdec, bads in cases:
        got = [outcome(tdec, bad) for bad in bads]
        assert got == [outcome(jdec, bad) for bad in bads]
        # a truncation can end on a field boundary and decode (to the
        # same spans in both); the garbled inputs raise
        assert got[-1][0] == "ValueError"
    for elem in (3, 7, 1):
        evil = (b"\x82" + bytes([(4 << 5) | 1]) + _c_varint(1) +
                _c_str("emitBatch") + bytes([(1 << 4) | 9]) +
                bytes([0xF0 | elem]) + _c_varint(1 << 41) + b"\x00")
        t0 = time.time()
        with pytest.raises(ValueError):
            tj.spans_from_jaeger_agent(evil)
        assert time.time() - t0 < 1.0
