"""Build a ColumnView from in-memory traces (flat span dicts).

Serves the recent-data query paths — ingester live traces and generator
localblocks head blocks — where spans haven't reached parquet yet
(reference `modules/ingester/instance_search.go`,
`modules/generator/processor/localblocks/query_range.go`), plus unit tests.

Counterpart of `tempo_tpu/traceql/memview.py` (host numpy, copied).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from tempo_tpu_torch.block.schema import nested_set
from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.eval import (BOOL, KIND, NUM, NUMLIST, STATUS,
                                          STR, STRLIST, Col, ColumnView)


def view_from_traces(traces: Sequence[tuple[bytes, list[dict]]]) -> ColumnView:
    """[(trace_id, [span dicts])] → ColumnView with all intrinsics + attrs.

    Span dicts use the same shape as block schema ingestion
    (`block/schema.py traces_to_table`): name/service/kind/status_code/
    start_unix_nano/end_unix_nano/attrs/res_attrs/events/links.
    """
    n = sum(len(spans) for _, spans in traces)
    trace_idx = np.empty(max(n, 0), np.int64)
    view = ColumnView(n, trace_idx)

    dur = np.zeros(n)
    start = np.zeros(n)
    name = np.empty(n, object)
    service = np.empty(n, object)
    status = np.zeros(n)
    status_msg = np.empty(n, object)
    kind = np.zeros(n)
    tid_hex = np.empty(n, object)
    sid_hex = np.empty(n, object)
    pid_hex = np.empty(n, object)
    root_name = np.empty(n, object)
    root_service = np.empty(n, object)
    root_exists = np.zeros(n, bool)
    trace_dur = np.zeros(n)
    parent_row = np.full(n, -1, np.int64)
    nleft = np.zeros(n, np.int64)
    nright = np.zeros(n, np.int64)
    events = np.empty(n, object)
    event_times = np.empty(n, object)
    link_tid = np.empty(n, object)
    link_sid = np.empty(n, object)
    attr_cols: dict[str, tuple[str, np.ndarray, np.ndarray]] = {}

    def attr_col(key: str, t: str):
        c = attr_cols.get(key)
        if c is None or c[0] != t:
            if c is None:
                vals = (np.empty(n, object) if t == STR else
                        np.zeros(n) if t == NUM else np.zeros(n, bool))
                c = attr_cols[key] = (t, vals, np.zeros(n, bool))
            else:
                return None  # mixed-type attr: first type wins
        return c

    row = 0
    for t_i, (trace_id, spans) in enumerate(traces):
        sids = [s.get("span_id", b"") or b"" for s in spans]
        pids = [s.get("parent_span_id", b"") or b"" for s in spans]
        left, right, parent_local = nested_set(sids, pids)
        base = row
        t_start, t_end = np.inf, -np.inf
        r_name, r_service = None, None
        for j, s in enumerate(spans):
            trace_idx[row] = t_i
            s0 = int(s.get("start_unix_nano", 0))
            e0 = int(s.get("end_unix_nano", s0))
            start[row] = s0
            dur[row] = max(e0 - s0, 0)
            t_start, t_end = min(t_start, s0), max(t_end, e0)
            name[row] = s.get("name", "")
            service[row] = s.get("service", "")
            status[row] = A.OTLP_STATUS_TO_TRACEQL.get(int(s.get("status_code", 0)), A.STATUS_UNSET)
            status_msg[row] = s.get("status_message", "")
            kind[row] = int(s.get("kind", 0))
            tid_hex[row] = bytes(trace_id).hex()
            sid_hex[row] = bytes(sids[j]).hex()
            pid_hex[row] = bytes(pids[j]).hex()
            parent_row[row] = base + parent_local[j] if parent_local[j] >= 0 else -1
            nleft[row] = left[j]
            nright[row] = right[j]
            if parent_local[j] < 0 and r_name is None:
                r_name, r_service = name[row], service[row]
            evs = s.get("events") or []
            events[row] = [str(e.get("name", "")) for e in evs] or None
            event_times[row] = [int(e.get("time_unix_nano", 0)) - s0 for e in evs] or None
            links = s.get("links") or []
            link_tid[row] = [bytes(l.get("trace_id", b"")).hex() for l in links] or None
            link_sid[row] = [bytes(l.get("span_id", b"")).hex() for l in links] or None
            for k, v in (s.get("attrs") or {}).items():
                _put_attr(attr_col, f"span.{k}", v, row)
            for k, v in (s.get("res_attrs") or {}).items():
                _put_attr(attr_col, f"resource.{k}", v, row)
            row += 1
        for r in range(base, row):
            trace_dur[r] = max(t_end - t_start, 0) if row > base else 0
            if r_name is not None:
                root_name[r] = r_name
                root_service[r] = r_service
                root_exists[r] = True

    ones = np.ones(n, bool)
    view.parent_row = parent_row
    view.nested_left = nleft
    view.nested_right = nright
    view.set_col("duration", Col(NUM, dur, ones))
    view.set_col("__startTime", Col(NUM, start, ones))
    view.set_col("name", Col(STR, name, ones))
    view.set_col("rootName", Col(STR, root_name, root_exists))
    view.set_col("rootServiceName", Col(STR, root_service, root_exists))
    view.set_col("traceDuration", Col(NUM, trace_dur, ones))
    view.set_col("status", Col(STATUS, status, ones))
    view.set_col("statusMessage", Col(STR, status_msg, ones))
    view.set_col("kind", Col(KIND, kind, ones))
    view.set_col("trace:id", Col(STR, tid_hex, ones))
    view.set_col("span:id", Col(STR, sid_hex, ones))
    view.set_col("span:parentID", Col(STR, pid_hex, ones))
    view.set_col("nestedSetLeft", Col(NUM, nleft.astype(float), ones))
    view.set_col("nestedSetRight", Col(NUM, nright.astype(float), ones))
    view.set_col("nestedSetParent",
                 Col(NUM, np.where(parent_row >= 0, nleft[np.maximum(parent_row, 0)], -1).astype(float), ones))
    view.set_col("resource.service.name", Col(STR, service, ones))
    ev_exists = np.fromiter((e is not None for e in events), bool, n) if n else np.zeros(0, bool)
    view.set_col("event:name", Col(STRLIST, events, ev_exists))
    view.set_col("event:timeSinceStart", Col(NUMLIST, event_times, ev_exists))
    lk_exists = np.fromiter((e is not None for e in link_tid), bool, n) if n else np.zeros(0, bool)
    view.set_col("link:traceID", Col(STRLIST, link_tid, lk_exists))
    view.set_col("link:spanID", Col(STRLIST, link_sid, lk_exists))
    for key, (t, vals, exists) in attr_cols.items():
        if key == "resource.service.name":
            continue  # intrinsic service column wins
        view.set_col(key, Col(t, vals, exists))
    view.meta["span_attr_keys"] = {k.partition(".")[2] for k in attr_cols
                                   if k.startswith("span.")}
    view.meta["resource_attr_keys"] = {k.partition(".")[2] for k in attr_cols
                                       if k.startswith("resource.")}
    view.meta["trace_id"] = tid_hex
    view.meta["span_id"] = sid_hex
    view.meta["start_unix_nano"] = start.astype(np.int64)
    view.meta["duration_ns"] = dur.astype(np.int64)
    view.meta["name"] = name
    view.meta["service"] = service
    return view


def _put_attr(attr_col, key: str, v, row: int) -> None:
    if isinstance(v, bool):
        c = attr_col(key, BOOL)
    elif isinstance(v, (int, float)):
        c = attr_col(key, NUM)
    else:
        c = attr_col(key, STR)
        v = str(v)
    if c is None:
        return
    _, vals, exists = c
    vals[row] = float(v) if c[0] == NUM else v
    exists[row] = True
