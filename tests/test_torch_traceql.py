"""The port's TraceQL front end and search engine against the reference.

Mirrors `tests/test_traceql.py` (lexer, parser, conditions, eval, search)
and the search arms of `tests/test_engine.py`: both packages take the same
query strings and read the same block. The block is written by the port's
own Parquet codec (`tempo_tpu_torch.block.writer`); the reference reads it
through pyarrow. Row-group views come from each package's
`block.fetch.scan_views`, so results compare row for row.

The shared builders here (`seeded_traces`, `port_block`, `both_views`)
feed the other read-side test files.
"""

from __future__ import annotations

import numpy as np
import pytest

from tempo_tpu.backend.local import LocalBackend as JLocal
from tempo_tpu.block import fetch as jfetch
from tempo_tpu.block.reader import BackendBlock as JBlock
from tempo_tpu.traceql import ParseError as JParseError
from tempo_tpu.traceql import engine as jengine
from tempo_tpu.traceql import eval as jeval
from tempo_tpu.traceql import lexer as jlexer
from tempo_tpu.traceql import parse as jparse
from tempo_tpu.traceql.conditions import extract_conditions as jextract

from tempo_tpu_torch.backend.local import LocalBackend as TLocal
from tempo_tpu_torch.block import fetch as tfetch
from tempo_tpu_torch.block.reader import BackendBlock as TBlock
from tempo_tpu_torch.block.writer import write_block as twrite
from tempo_tpu_torch.traceql import ParseError as TParseError
from tempo_tpu_torch.traceql import engine as tengine
from tempo_tpu_torch.traceql import eval as teval
from tempo_tpu_torch.traceql import lexer as tlexer
from tempo_tpu_torch.traceql import parse as tparse
from tempo_tpu_torch.traceql.conditions import extract_conditions as textract

T0_NS = 1_700_000_000 * 10**9


# ---------------------------------------------------------------------------
# shared builders
# ---------------------------------------------------------------------------

def _span(rng, tid, sid, parent, start, i):
    attrs = {}
    if rng.random() < 0.8:
        attrs["http.status_code"] = int(rng.integers(200, 501))
    if rng.random() < 0.6:
        attrs["ratio"] = float(rng.choice([0.5, 1.5, -2.25, 0.0, 3.0, 0.1]))
    if rng.random() < 0.7:
        attrs["region"] = f"r{int(rng.integers(0, 3))}"
    if rng.random() < 0.3:
        attrs["err"] = bool(rng.random() < 0.5)
    res = {"deployment": f"d{int(rng.integers(0, 2))}"} \
        if rng.random() < 0.5 else {}
    dur = int(rng.choice([1, 50_000_000, 123_000_000, 16_777_216,
                          int(rng.lognormal(16, 1.5))]))
    events = ([{"name": "exception", "time_unix_nano": start + 5}]
              if rng.random() < 0.2 else [])
    links = ([{"trace_id": bytes(16 * [i % 256]), "span_id": bytes(8 * [7])}]
             if rng.random() < 0.1 else [])
    return {"trace_id": tid, "span_id": sid, "parent_span_id": parent,
            "name": f"op-{int(rng.integers(0, 6))}",
            "service": f"svc-{int(rng.integers(0, 4))}",
            "kind": int(rng.integers(0, 6)),
            "status_code": int(rng.integers(0, 3)),
            "status_message": "boom" if rng.random() < 0.1 else "",
            "start_unix_nano": start, "end_unix_nano": start + dur,
            "attrs": attrs, "res_attrs": res, "events": events,
            "links": links}


def seeded_traces(seed: int, n_traces: int, max_spans: int = 4,
                  t0_ns: int = T0_NS, span_s: float = 890.0):
    """(trace_id, spans) sorted by id: small trees with every column
    family the read side adopts (int/float/str/bool attrs, missing attrs,
    resource attrs, events, links, status messages)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_traces):
        tid = rng.bytes(16)
        n = int(rng.integers(1, max_spans + 1))
        sids = [rng.bytes(8) for _ in range(n)]
        spans = []
        for j in range(n):
            parent = sids[int(rng.integers(0, j))] if j else b""
            start = t0_ns + int(float(rng.random()) * span_s * 1e9)
            spans.append(_span(rng, tid, sids[j], parent, start, i))
        out.append((tid, spans))
    out.sort(key=lambda t: t[0])
    return out


def port_block(tmp_path, traces, row_group_rows: int = 64,
               compression: str = "gzip", tenant: str = "t"):
    """Write `traces` with the port's writer; return both packages'
    `BackendBlock` over the same files."""
    path = str(tmp_path / "store")
    meta = twrite(TLocal(path), tenant, traces, row_group_rows=row_group_rows,
                  replication_factor=1, compression=compression)
    from tempo_tpu.backend.meta import BlockMeta as JMeta

    jmeta = JMeta.from_json(meta.to_json())
    return TBlock(TLocal(path), meta), JBlock(JLocal(path), jmeta)


def both_views(tb, jb, req_t=None, req_j=None):
    """Row-group views of one block from both packages' `scan_views`."""
    tv = list(tfetch.scan_views(tb, req_t))
    jv = list(jfetch.scan_views(jb, req_j))
    assert len(tv) == len(jv)
    return tv, jv


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    return port_block(tmp_path_factory.mktemp("traceql"),
                      seeded_traces(11, 240))


# ---------------------------------------------------------------------------
# lexer / parser
# ---------------------------------------------------------------------------

ROUND_TRIPS = [
    "{ }",
    '{ .foo = "bar" }',
    "{ span.http.status_code >= 500 }",
    '{ (resource.service.name = "api") && (duration > 100ms) }',
    "{ (status = error) || (status = unset) }",
    "{ kind = server }",
    '{ name =~ "GET.*" } | count() > 2',
    "{ .a } && { .b }",
    "{ .a } >> { .b } | avg(duration) > 1s",
    "{ } | by(resource.service.name) | count() > 10 | coalesce()",
    "{ parent.span.foo = 1 }",
    '{ (trace:id = "abc") && (span:id != "def") }',
    '{ event:name = "exception" }',
    "{ duration > 1s } | rate() by(span.http.status_code)",
    "{ } | quantile_over_time(duration, 0.5, 0.99) by(span.region)",
    "{ status = error } | count_over_time() with (exemplars=true)",
    "{ } | histogram_over_time(duration)",
    "{ .a = 1 } !>> { .b = 2 }",
    "{ .a = 1 } &~ { .b = 2 }",
    "{ childCount > 3 }",
    '{ span."attr with space" = true }',
    "{ nestedSetParent = -1 }",
    '{ span."x-y" = 1 }',
    "{ duration > 1h30m }",
    "{ } | compare({ status = error })",
    "{ } | avg_over_time(span.ratio) by (kind)",
    '{ name !~ "op-[12]" || span.ratio <= -2.25 }',
    "{ .a + .b * 2 > 3 }",
]

PARSE_ERRORS = [
    "{",
    "{ .foo = }",
    "{ .foo ! 3 }",
    "{ } | frobnicate()",
    "{ } | count(",
    "{ } | rate() by(",
    "{ span: }",
    "{ trace:nope = 1 }",
]


def _tokens(mod, q):
    return [(t.kind.name, t.value, t.pos) for t in mod.lex(q)]


@pytest.mark.parametrize("q", ROUND_TRIPS)
def test_lex_and_parse_match_reference(q):
    assert _tokens(tlexer, q) == _tokens(jlexer, q)
    p = tparse(q)
    assert str(p) == str(jparse(q))
    assert str(tparse(str(p))) == str(p)


@pytest.mark.parametrize("q", PARSE_ERRORS)
def test_parse_errors_match_reference(q):
    with pytest.raises(JParseError):
        jparse(q)
    with pytest.raises(TParseError):
        tparse(q)


def test_duration_units_and_status_order():
    for q, want in (("{ duration > 1h30m }", 90 * 60 * 10**9),
                    ("{ duration > 100ms }", 100_000_000)):
        assert tparse(q).stages[0].expr.rhs.value == want
    for name, want in (("error", 0), ("ok", 1), ("unset", 2)):
        assert tparse(f"{{ status = {name} }}").stages[0].expr.rhs.value \
            == want


CONDITION_QUERIES = [
    '{ .foo = "bar" && duration > 1s }',
    '{ .foo = "bar" || duration > 1s }',
    "{ span.a > span.b }",
    "{ .a = 1 } >> { .b = 2 }",
    "{ .b = 2 } || { }",
    '{ !(name = "x") }',
    '{ name = "op-1" && (resource.service.name = "svc-0" || span.region = "r1") }',
    "{ } | rate() by (resource.service.name)",
    "{ span.ratio != nil } | avg_over_time(span.ratio) by (kind)",
]


@pytest.mark.parametrize("q", CONDITION_QUERIES)
def test_conditions_match_reference(q):
    t = textract(tparse(q), 5, 10**12)
    j = jextract(jparse(q), 5, 10**12)
    assert repr(t) == repr(j)
    assert t.pure_disjunction == j.pure_disjunction


# ---------------------------------------------------------------------------
# eval over the same block
# ---------------------------------------------------------------------------

EVAL_QUERIES = [
    '{ name = "op-1" }',
    "{ span.http.status_code >= 400 }",
    "{ .http.status_code = 200 }",
    "{ status = error }",
    "{ .err }",
    "{ duration > 50ms }",
    "{ span.region = nil }",
    '{ name =~ "op-[12]" }',
    '{ name !~ "op-.*" }',
    '{ .region = 3 }',
    "{ } > { }",
    "{ } >> { }",
    "{ } << { }",
    "{ } ~ { }",
    "{ } !>> { }",
    "{ } &>> { }",
    '{ .region = "r1" } && { .region = "r2" }',
    '{ .region = "r1" } || { status = error }',
    "{ } | count() > 1",
    "{ } | avg(duration) > 20ms",
    "{ } | by(resource.service.name) | count() > 2",
    '{ parent.span.region = "r0" }',
    "{ childCount > 0 }",
    '{ rootName = "op-1" }',
    '{ rootServiceName != "svc-3" }',
    "{ traceDuration > 100ms }",
    "{ span.ratio * 2 > 1 }",
    '{ event:name = "exception" }',
    '{ statusMessage = "boom" }',
    '{ resource.deployment = "d1" }',
    "{ kind = server || kind = client }",
    '{ name > "op-3" }',
    "{ nestedSetParent = -1 }",
    '{ trace:id != "00" && span:id != "00" }',
    '{ link:spanID = "0707070707070707" }',
    '{ span.ratio < 1 } | min(duration) > 1ms',
]


def _spansets(ss):
    return [(int(s.trace_key), sorted(np.asarray(s.rows).tolist()),
             tuple(s.group_attrs), dict(s.scalars)) for s in ss]


@pytest.mark.parametrize("q", EVAL_QUERIES)
def test_eval_matches_reference(blocks, q):
    tb, jb = blocks
    tv, jv = both_views(tb, jb)
    for (v1, _), (v2, _) in zip(tv, jv):
        a = _spansets(teval.evaluate_pipeline(tparse(q), v1))
        b = _spansets(jeval.evaluate_pipeline(jparse(q), v2))
        assert a == b, q


@pytest.mark.parametrize("q", EVAL_QUERIES[:12])
def test_condition_mask_matches_reference(blocks, q):
    tb, jb = blocks
    _, treq = tengine.compile_query(q, T0_NS, T0_NS + 600 * 10**9)
    _, jreq = jengine.compile_query(q, T0_NS, T0_NS + 600 * 10**9)
    tv, jv = both_views(tb, jb)
    for (v1, _), (v2, _) in zip(tv, jv):
        assert np.array_equal(tfetch.condition_mask(v1, treq),
                              jfetch.condition_mask(v2, jreq))


def test_scan_views_prefilter_and_projection_match_reference(blocks):
    tb, jb = blocks
    for q in ('{ span.http.status_code >= 400 && name = "op-2" }',
              '{ event:name = "exception" }', '{ link:traceID != "x" }',
              '{ statusMessage = "boom" }', "{ .b = 2 } || { }"):
        _, treq = tengine.compile_query(q)
        _, jreq = jengine.compile_query(q)
        assert tfetch.columns_for_request(tb, treq) == \
            jfetch.columns_for_request(jb, jreq)
        tv, jv = both_views(tb, jb, treq, jreq)
        assert [c.tolist() for _, c in tv] == [c.tolist() for _, c in jv]


def test_view_columns_match_reference(blocks):
    """Every intrinsic and lazy column of a view, value for value."""
    tb, jb = blocks
    tv, jv = both_views(tb, jb)
    keys = ["duration", "__startTime", "name", "resource.service.name",
            "kind", "status", "nestedSetLeft", "nestedSetRight",
            "nestedSetParent", "trace:id", "span:id", "span:parentID",
            "rootName", "rootServiceName", "traceDuration",
            "span.http.status_code", "span.ratio", "span.region",
            "span.err", "resource.deployment"]
    for (v1, _), (v2, _) in zip(tv, jv):
        for k in keys:
            a, b = v1.col(k), v2.col(k)
            assert (a is None) == (b is None), k
            if a is None:
                continue
            assert a.t == b.t, k
            assert np.array_equal(a.exists, b.exists), k
            assert list(a.values[a.exists]) == list(b.values[b.exists]), k
        assert np.array_equal(v1.parent_row, v2.parent_row)
        assert v1.meta["span_attr_keys"] == v2.meta["span_attr_keys"]
        assert v1.meta["resource_attr_keys"] == v2.meta["resource_attr_keys"]


def test_dictionary_codes_map_to_the_same_strings(blocks):
    """The port's numpy codes (sorted dictionary) differ from Arrow's
    first-seen ones; each row's decoded string does not."""
    tb, jb = blocks
    tv, jv = both_views(tb, jb)
    for (v1, _), (v2, _) in zip(tv, jv):
        for key, meta in (("name", "name_col"), ("service", "service_col")):
            tc, tvals = tfetch._dict_codes(v1, key, v1.meta[meta])
            jc, jvals = jfetch._dict_codes(v2, key, v2.meta[meta])
            assert [tvals[c] for c in tc] == [jvals[c] for c in jc]
            assert tvals == sorted(tvals)


def test_strings_codes_nulls_long_and_empty():
    from tempo_tpu_torch.block import parquet as P

    vals = ["b", None, "", "a", "b", "None", "é" * 40, "a\x00", "a"]
    s = P.Strings.from_list(vals)
    codes, dvals = tfetch.strings_codes(s)
    assert [dvals[c] for i, c in enumerate(codes) if vals[i] is not None] \
        == [v for v in vals if v is not None]
    assert len(set(dvals)) == len(dvals)
    view = teval.ColumnView(len(vals))
    codes, dvals = tfetch._dict_codes(view, "k", s)
    assert [dvals[c] for c in codes] == ["None" if v is None else v
                                         for v in vals]
    assert dvals.count("None") == 1


# ---------------------------------------------------------------------------
# search (execute_search over scan_views) and tags
# ---------------------------------------------------------------------------

SEARCH_QUERIES = [
    "{ }",
    "{ span.http.status_code >= 400 }",
    '{ name =~ "op-[12]" && span.ratio < 1 }',
    "{ } >> { status = error }",
    '{ span.region != "r0" } | count() > 1',
    "{ .b = 2 } || { }",
    '{ resource.service.name = "svc-1" } | by(span.region) | count() > 0',
    "{ duration > 100ms } | select(span.region, status)",
]


@pytest.mark.parametrize("limit", [3, 20, 5000])
@pytest.mark.parametrize("q", SEARCH_QUERIES)
def test_search_matches_reference(blocks, q, limit):
    tb, jb = blocks
    win = (T0_NS + 100 * 10**9, T0_NS + 700 * 10**9)
    for start, end in ((0, 0), win):
        _, treq = tengine.compile_query(q, start, end)
        _, jreq = jengine.compile_query(q, start, end)
        a = tengine.execute_search(q, tfetch.scan_views(tb, treq),
                                   limit=limit, start_ns=start, end_ns=end)
        b = jengine.execute_search(q, jfetch.scan_views(jb, jreq),
                                   limit=limit, start_ns=start, end_ns=end)
        assert [m.to_json() for m in a] == [m.to_json() for m in b], q


def test_metadata_combiner_matches_reference():
    rng = np.random.default_rng(3)
    t, j = tengine.MetadataCombiner(7), jengine.MetadataCombiner(7)
    for i in range(40):
        kw = dict(trace_id=f"{int(rng.integers(0, 15)):02x}",
                  root_service_name="s", root_trace_name="n",
                  start_time_unix_nano=int(rng.integers(0, 10**6)),
                  duration_ms=int(rng.integers(0, 100)),
                  span_sets=[{"matched": i}])
        t.add(tengine.TraceSearchMetadata(**kw))
        j.add(jengine.TraceSearchMetadata(**kw))
    assert [m.to_json() for m in t.results()] == \
        [m.to_json() for m in j.results()]
    assert t.exhausted() == j.exhausted()


def test_tag_names_and_values_match_reference(blocks):
    tb, jb = blocks
    tv, jv = both_views(tb, jb)
    assert tengine.execute_tag_names(tv) == jengine.execute_tag_names(jv)
    for scope in ("span", "resource", "intrinsic"):
        assert tengine.execute_tag_names(tv, scope=scope) == \
            jengine.execute_tag_names(jv, scope=scope)
    assert tfetch.block_tag_names(tb) == jfetch.block_tag_names(jb)
    for attr in ("span.region", "span.http.status_code", "span.ratio",
                 "span.err", "resource.deployment", "name",
                 "resource.service.name", "status", "kind"):
        treq = tengine.tag_values_request(attr)
        jreq = jengine.tag_values_request(attr)
        a = tengine.execute_tag_values(attr, tfetch.scan_views(tb, treq))
        b = jengine.execute_tag_values(attr, jfetch.scan_views(jb, jreq))
        assert a == b, attr


def test_or_with_empty_arm_matches_everything(tmp_path):
    """'{ .b = 2 } || { }' must match every trace even in hint-mode
    prefiltering (has_unconditioned_arm) — `tests/test_traceql.py:306`."""
    traces = []
    for i in range(4):
        tid = bytes([i]) * 16
        traces.append((tid, [{
            "trace_id": tid, "span_id": b"\x01" * 8, "name": "s",
            "start_unix_nano": 10 ** 18, "end_unix_nano": 10 ** 18 + 1000,
            "attrs": ({"b": 2} if i == 0 else {}),
        }]))
    tb, jb = port_block(tmp_path, traces, row_group_rows=1)
    q = "{ .b = 2 } || { }"
    _, req = tengine.compile_query(q)
    res = tengine.execute_search(q, tfetch.scan_views(tb, req), limit=100)
    assert len(res) == 4
    _, jreq = jengine.compile_query(q)
    assert [m.to_json() for m in res] == [m.to_json() for m in jengine.execute_search(
        q, jfetch.scan_views(jb, jreq), limit=100)]


def test_column_batches_yield_codec_columns(blocks):
    from tempo_tpu_torch.block import parquet as P

    tb, jb = blocks
    cols = ["trace_id", "name", "sattr_str_keys", "duration_ns"]
    t = list(tb.column_batches(cols))
    j = list(jb.column_batches(cols))
    assert [(b["_rows"], b["_row_offset"]) for b in t] == \
        [(b["_rows"], b["_row_offset"]) for b in j]
    for a, b in zip(t, j):
        assert isinstance(a["name"], P.Strings)
        assert isinstance(a["sattr_str_keys"], P.Lists)
        assert a["name"].tolist() == list(b["name"])
        assert a["sattr_str_keys"].tolist() == b["sattr_str_keys"].to_pylist()
        assert np.array_equal(a["duration_ns"], b["duration_ns"])
        assert P.column_pylist(a["trace_id"]) == [bytes(x) for x in b["trace_id"]]
    assert len(list(tb.column_batches(row_groups=[1]))) == 1


def test_reference_gzip_block_read_by_port(tmp_path):
    """A block the reference wrote (gzip) answers the same search in the
    port."""
    from tempo_tpu.block.writer import write_block as jwrite
    from tempo_tpu_torch.backend.meta import BlockMeta as TMeta

    path = str(tmp_path / "ref")
    traces = seeded_traces(5, 60)
    jmeta = jwrite(JLocal(path), "t", traces, row_group_rows=16,
                   replication_factor=1, compression="gzip")
    tb = TBlock(TLocal(path), TMeta.from_json(jmeta.to_json()))
    jb = JBlock(JLocal(path), jmeta)
    for q in SEARCH_QUERIES[:4]:
        _, treq = tengine.compile_query(q)
        _, jreq = jengine.compile_query(q)
        a = tengine.execute_search(q, tfetch.scan_views(tb, treq), limit=50)
        b = jengine.execute_search(q, jfetch.scan_views(jb, jreq), limit=50)
        assert [m.to_json() for m in a] == [m.to_json() for m in b], q
