"""Trace combining/dedup — analog of `pkg/model/trace/combine.go`.

RF3 writes mean the same trace (and often the same spans) arrive from up to
three ingesters, and compaction merges blocks that may both hold a trace.
`combine_spans` merges span lists keeping one span per span-id (first wins,
matching the reference's CombineTraceProtos semantics), and `sort_spans`
orders by start time like `trace/sort.go`.

Counterpart of `tempo_tpu/model/combine.py`, copied whole.
"""

from __future__ import annotations

from typing import Iterable


def combine_spans(*span_lists: Iterable[dict]) -> list[dict]:
    seen: set[bytes] = set()
    out: list[dict] = []
    for spans in span_lists:
        for s in spans:
            sid = bytes(s.get("span_id", b""))
            if sid in seen:
                continue
            seen.add(sid)
            out.append(s)
    return out


def sort_spans(spans: list[dict]) -> list[dict]:
    return sorted(spans, key=lambda s: int(s.get("start_unix_nano", 0)))


def trace_range(spans: Iterable[dict]) -> tuple[int, int]:
    """(min start, max end) nanos over the trace's spans."""
    start = None
    end = None
    for s in spans:
        st = int(s.get("start_unix_nano", 0))
        en = int(s.get("end_unix_nano", st))
        start = st if start is None else min(start, st)
        end = en if end is None else max(end, en)
    return start or 0, end or 0
