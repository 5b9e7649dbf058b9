"""TraceQL search engine (reference `pkg/traceql/engine.go`).

`execute_search` drives fetchers (block row-group views or in-memory views)
through the two-pass pattern: storage prefilter → full pipeline evaluation →
per-trace search metadata, merged top-N by recency like the reference's
`NewMetadataCombiner` (`pkg/traceql/combine.go`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional

import numpy as np

from tempo_tpu_torch.obs import querystats
from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.conditions import FetchSpansRequest, extract_conditions
from tempo_tpu_torch.traceql.eval import ColumnView, Spanset, evaluate_pipeline
from tempo_tpu_torch.traceql.parser import parse


@dataclasses.dataclass
class SpanResult:
    span_id: str
    name: str
    start_unix_nano: int
    duration_ns: int
    attributes: dict


@dataclasses.dataclass
class TraceSearchMetadata:
    trace_id: str
    root_service_name: str
    root_trace_name: str
    start_time_unix_nano: int
    duration_ms: int
    span_sets: list = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "traceID": self.trace_id,
            "rootServiceName": self.root_service_name,
            "rootTraceName": self.root_trace_name,
            "startTimeUnixNano": str(self.start_time_unix_nano),
            "durationMs": self.duration_ms,
            "spanSets": self.span_sets,
        }

    @classmethod
    def from_json(cls, t: dict) -> "TraceSearchMetadata":
        """Inverse of to_json — the one decoder every RPC transport uses."""
        return cls(
            trace_id=t["traceID"],
            root_service_name=t.get("rootServiceName", ""),
            root_trace_name=t.get("rootTraceName", ""),
            start_time_unix_nano=int(t.get("startTimeUnixNano", "0")),
            duration_ms=t.get("durationMs", 0),
            span_sets=t.get("spanSets", []))


def compile_query(query: str | A.Pipeline,
                  start_ns: int = 0, end_ns: int = 0
                  ) -> tuple[A.Pipeline, FetchSpansRequest]:
    """Parse + extract fetch conditions (`Compile` `engine.go:30-47`)."""
    q = parse(query) if isinstance(query, str) else query
    return q, extract_conditions(q, start_ns, end_ns)


class MetadataCombiner:
    """Top-N traces by start time, deduped by trace id (`combine.go`)."""

    def __init__(self, limit: int = 20):
        self.limit = limit
        self.by_id: dict[str, TraceSearchMetadata] = {}

    def add(self, md: TraceSearchMetadata) -> None:
        cur = self.by_id.get(md.trace_id)
        if cur is None:
            self.by_id[md.trace_id] = md
        else:
            cur.span_sets.extend(md.span_sets)
            cur.start_time_unix_nano = min(cur.start_time_unix_nano,
                                           md.start_time_unix_nano)
            cur.duration_ms = max(cur.duration_ms, md.duration_ms)

    def exhausted(self) -> bool:
        return len(self.by_id) >= self.limit

    def results(self) -> list[TraceSearchMetadata]:
        out = sorted(self.by_id.values(),
                     key=lambda m: -m.start_time_unix_nano)
        return out[: self.limit]


def spanset_to_json(view: ColumnView, ss: Spanset, max_spans: int = 3) -> dict:
    spans = []
    sid = view.col("span:id")
    name = view.col("name")
    st = view.meta.get("start_unix_nano")
    dur = view.meta.get("duration_ns")
    for row in ss.rows[:max_spans]:
        spans.append({
            "spanID": str(sid.values[row]) if sid is not None else "",
            "name": str(name.values[row]) if name is not None else "",
            "startTimeUnixNano": str(int(st[row])) if st is not None else "0",
            "durationNanos": str(int(dur[row])) if dur is not None else "0",
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in ss.group_attrs
            ],
        })
    out = {"spans": spans, "matched": int(len(ss.rows))}
    if ss.group_attrs:
        out["attributes"] = [
            {"key": k, "value": {"stringValue": str(v)}} for k, v in ss.group_attrs
        ]
    return out


def execute_search(
    query: str | A.Pipeline,
    view_iter: Iterable[tuple[ColumnView, np.ndarray]],
    *,
    limit: int = 20,
    start_ns: int = 0,
    end_ns: int = 0,
) -> list[TraceSearchMetadata]:
    """Run a search over an iterator of (view, candidate_rows).

    The iterator is typically `block.fetch.scan_views` chained over blocks
    (querier) or a single in-memory view (ingester live traces). Early-exits
    once the combiner has `limit` traces, like `ExecuteSearch`'s streaming
    second pass (`engine.go:82-155`).
    """
    q = parse(query) if isinstance(query, str) else query
    combiner = MetadataCombiner(limit)
    simple = bool(q.stages) and all(isinstance(s, A.SpansetFilter)
                                    for s in q.stages)
    for view, cand in view_iter:
        if len(cand) == 0:
            continue
        st = querystats.current()
        if st is not None:
            # candidate spans evaluated; trace count via contiguous-run
            # boundaries (spans of one trace are stored adjacent), O(n)
            # instead of a unique() sort
            t = view.trace_idx[cand]
            st.add(inspected_spans=int(len(cand)),
                   inspected_traces=int((np.diff(t) != 0).sum()) + 1)
        with querystats.stage("engine_eval"):
            if simple:
                # all-filter pipeline: one vectorized mask + reduceat
                # ranking replaces the per-trace Spanset loop; only the
                # top-`limit` traces materialize Python objects (the
                # second-pass analog of the pre-pass below, pulled before
                # object construction)
                spansets = _simple_filter_spansets(q, view, limit,
                                                   start_ns, end_ns)
            else:
                spansets = evaluate_pipeline(q, view)
        if not spansets:
            continue
        # Vectorized pre-pass: per-spanset time bounds via one reduceat,
        # window filter, then metadata (hex ids, root names, JSON) is built
        # for the top-`limit` most recent spansets ONLY — everything older
        # could never displace them in the combiner.
        st = view.meta.get("start_unix_nano")
        dur = view.meta.get("duration_ns")
        if st is not None and len(spansets) > limit:
            lens = np.fromiter((len(ss.rows) for ss in spansets), np.int64,
                               len(spansets))
            allrows = np.concatenate([ss.rows for ss in spansets])
            bounds = np.zeros(len(spansets), np.int64)
            np.cumsum(lens[:-1], out=bounds[1:])
            t0s = np.minimum.reduceat(st[allrows], bounds)
            t1s = np.maximum.reduceat(st[allrows] + dur[allrows], bounds)
            ok = np.ones(len(spansets), bool)
            if start_ns:
                ok &= t1s >= start_ns
            if end_ns:
                ok &= t0s < end_ns
            idxs = np.flatnonzero(ok)
            # Rank by the COMBINER's key — a trace's start is the min over
            # its merged spansets — and keep every spanset of each chosen
            # trace, so multi-spanset traces (by() queries) neither rank
            # nor truncate differently than the unfiltered path.
            first_rows = allrows[bounds[idxs]]
            tkeys = view.trace_idx[first_rows]
            ut, inv = np.unique(tkeys, return_inverse=True)
            # int64 accumulator: float64 would round ns epochs (>2^53) and
            # could cut a different trace set than the combiner's exact sort
            tmin = np.full(len(ut), np.iinfo(np.int64).max, np.int64)
            np.minimum.at(tmin, inv, t0s[idxs].astype(np.int64))
            top = np.argsort(-tmin, kind="stable")[:limit]
            chosen_traces = set(ut[top].tolist())
            spansets = [spansets[i]
                        for i, t in zip(idxs.tolist(), tkeys.tolist())
                        if t in chosen_traces]
        for ss in spansets:
            md = _trace_metadata(view, ss, start_ns, end_ns)
            if md is not None:
                combiner.add(md)
        if combiner.exhausted():
            break
    return combiner.results()


def _simple_filter_spansets(q: A.Pipeline, view: ColumnView, limit: int,
                            start_ns: int, end_ns: int) -> list[Spanset]:
    """Top-`limit` spansets of an all-SpansetFilter pipeline, fully
    vectorized: sequential filter stages compose to a mask intersection,
    trace grouping is a reduceat over the (trace-aligned) row order, and
    ranking matches the combiner's most-recent-start key exactly."""
    from tempo_tpu_torch.traceql.eval import eval_expr

    st = view.meta.get("start_unix_nano")
    dur = view.meta.get("duration_ns")
    if st is None or dur is None:
        return evaluate_pipeline(q, view)     # in-memory view: slow path
    mask = None
    for s in q.stages:
        m = eval_expr(view, s.expr).bool_mask()
        mask = m if mask is None else mask & m
    rows = np.flatnonzero(mask)
    if len(rows) == 0:
        return []
    keys = view.trace_idx[rows]
    if len(keys) > 1 and not (np.diff(keys) >= 0).all():
        order = np.argsort(keys, kind="stable")
        rows, keys = rows[order], keys[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(keys)) + 1])
    ends = np.concatenate([starts[1:], [len(rows)]])
    t0s = np.minimum.reduceat(st[rows], starts).astype(np.int64)
    t1s = np.maximum.reduceat(st[rows] + dur[rows], starts).astype(np.int64)
    ok = np.ones(len(starts), bool)
    if start_ns:
        ok &= t1s >= start_ns
    if end_ns:
        ok &= t0s < end_ns
    sel = np.flatnonzero(ok)
    if len(sel) == 0:
        return []
    top = np.sort(sel[np.argsort(-t0s[sel], kind="stable")[:limit]])
    # ascending (scan) order: the combiner breaks equal-start ties by
    # insertion order, so emission order must match the per-trace path
    return [Spanset(int(keys[starts[i]]), rows[starts[i]:ends[i]])
            for i in top.tolist()]


def _trace_metadata(view: ColumnView, ss: Spanset,
                    start_ns: int, end_ns: int) -> Optional[TraceSearchMetadata]:
    st = view.meta.get("start_unix_nano")
    dur = view.meta.get("duration_ns")
    rows = ss.rows
    t0 = int(st[rows].min()) if st is not None and len(rows) else 0
    t1 = int((st[rows] + dur[rows]).max()) if st is not None and len(rows) else 0
    if start_ns and t1 < start_ns:
        return None
    if end_ns and t0 >= end_ns:
        return None
    tid_col = view.col("trace:id")
    tid = str(tid_col.values[rows[0]]) if tid_col is not None and len(rows) else ""
    root_svc, root_name = "", ""
    rs = view.col("rootServiceName")
    rn = view.col("rootName")
    if rs is not None and rs.exists[rows[0]]:
        root_svc = str(rs.values[rows[0]])
    if rn is not None and rn.exists[rows[0]]:
        root_name = str(rn.values[rows[0]])
    return TraceSearchMetadata(
        trace_id=tid,
        root_service_name=root_svc,
        root_trace_name=root_name,
        start_time_unix_nano=t0,
        duration_ms=int((t1 - t0) / 1e6),
        span_sets=[spanset_to_json(view, ss)],
    )


# ---------------------------------------------------------------------------
# tag names / values (`engine.go:157-231`, `block_search_tags.go`)
# ---------------------------------------------------------------------------

def execute_tag_names(view_iter: Iterable[tuple[ColumnView, np.ndarray]],
                      scope: str = "", limit: int = 1000) -> dict[str, list[str]]:
    """Distinct attribute keys by scope. Views must carry tag metadata
    (set by fetch/memview as meta['span_attr_keys'] etc.)."""
    span_keys: set = set()
    res_keys: set = set()
    for view, _ in view_iter:
        span_keys |= set(view.meta.get("span_attr_keys", ()))
        res_keys |= set(view.meta.get("resource_attr_keys", ()))
        if len(span_keys) + len(res_keys) >= limit:
            break
    out: dict[str, list[str]] = {}
    if scope in ("", "span"):
        out["span"] = sorted(span_keys)[:limit]
    if scope in ("", "resource"):
        out["resource"] = sorted(res_keys)[:limit]
    if scope in ("", "intrinsic"):
        out["intrinsic"] = sorted(k for k in A.INTRINSIC_KEYWORDS)
    return out


def tag_values_request(attr: str, start_ns: int = 0,
                       end_ns: int = 0) -> FetchSpansRequest:
    """Fetch request that projects just the one attribute column (the
    autocomplete fetch, `ExecuteTagValues` engine.go:157)."""
    from tempo_tpu_torch.traceql.conditions import Condition

    return FetchSpansRequest(conditions=[Condition(_parse_attr(attr))],
                             all_conditions=False,
                             start_ns=start_ns, end_ns=end_ns)


def execute_tag_values(attr: str,
                       view_iter: Iterable[tuple[ColumnView, np.ndarray]],
                       limit: int = 1000) -> list[dict]:
    """Distinct values of one attribute (autocomplete path)."""
    a = _parse_attr(attr)
    seen: dict = {}
    for view, _ in view_iter:
        from tempo_tpu_torch.traceql.eval import resolve_attr

        c = resolve_attr(view, a)
        vals = c.values[c.exists]
        for v in np.unique(vals.astype(str) if c.t == "str" else vals):
            t = _tag_type(c.t)
            if c.t == "num":
                import math

                f = float(v)
                # integral numerics render as ints ("200", not "200.0"),
                # matching the reference's typed tag values; non-finite
                # floats (valid OTLP doubleValues) stay float-formatted
                if math.isfinite(f) and f == int(f):
                    key, t = str(int(f)), "int"
                else:
                    key = str(f)
            elif c.t == "bool":
                key = "true" if v else "false"
            else:
                key = str(v)
            if key not in seen:
                seen[key] = {"type": t, "value": key}
            if len(seen) >= limit:
                break
        if len(seen) >= limit:
            break
    return list(seen.values())


def _tag_type(t: str) -> str:
    return {"str": "string", "num": "float", "bool": "boolean"}.get(t, "string")


def _parse_attr(attr: str) -> A.Attribute:
    from tempo_tpu_torch.traceql.parser import _Parser
    from tempo_tpu_torch.traceql.lexer import lex

    p = _Parser(lex(attr), attr)
    node = p.parse_primary()
    if not isinstance(node, A.Attribute):
        raise ValueError(f"not an attribute: {attr}")
    return node
