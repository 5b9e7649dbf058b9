"""Columnar block schema: flat span rows + nested-set tree coordinates.

Counterpart of `tempo_tpu/block/schema.py`. A block is one row per span
with a `trace_idx` segment key (rows of a trace contiguous, traces sorted
by id) and nested-set coordinates for structural operators; attributes
are per-type parallel list columns (span and resource scope) plus
dedicated string columns named by `BlockMeta.dedicated_columns`.

The reference builds a pyarrow table; the port builds its own
`parquet.ColumnTable`: numpy arrays for fixed-width columns, offsets plus
values for strings and lists. Column names, order and the Parquet types
they are written as are the reference's (`CORE_FIELDS`).
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np

from tempo_tpu_torch.block.parquet import ColumnTable, column_from_pylist

VERSION = "vtpu1"

# Columns every block carries, in schema order, with the port's column
# types (`block/parquet.py`): the reference's pa.binary(16) is fixed16,
# pa.int8() int8, pa.list_(pa.string()) list<string>, and so on.
CORE_FIELDS = [
    ("trace_id", "fixed16"),
    ("trace_idx", "int32"),
    ("span_id", "fixed8"),
    ("parent_span_id", "fixed8"),
    ("parent_row", "int32"),      # parent span's index WITHIN its trace; -1 root
    ("nested_left", "int32"),
    ("nested_right", "int32"),
    ("is_root", "bool"),
    ("name", "string"),
    ("service", "string"),
    ("kind", "int8"),
    ("status_code", "int8"),
    ("status_message", "string"),
    ("start_unix_nano", "int64"),
    ("duration_ns", "int64"),
    # typed generic attributes (span scope)
    ("sattr_str_keys", "list<string>"),
    ("sattr_str_vals", "list<string>"),
    ("sattr_int_keys", "list<string>"),
    ("sattr_int_vals", "list<int64>"),
    ("sattr_f64_keys", "list<string>"),
    ("sattr_f64_vals", "list<double>"),
    ("sattr_bool_keys", "list<string>"),
    ("sattr_bool_vals", "list<bool>"),
    # typed generic attributes (resource scope)
    ("rattr_str_keys", "list<string>"),
    ("rattr_str_vals", "list<string>"),
    ("rattr_int_keys", "list<string>"),
    ("rattr_int_vals", "list<int64>"),
    ("rattr_f64_keys", "list<string>"),
    ("rattr_f64_vals", "list<double>"),
    ("rattr_bool_keys", "list<string>"),
    ("rattr_bool_vals", "list<bool>"),
    # events / links
    ("event_times", "list<int64>"),
    ("event_names", "list<string>"),
    ("link_trace_ids", "list<fixed16>"),
    ("link_span_ids", "list<fixed8>"),
]


def dedicated_field_name(scope: str, index: int) -> str:
    return f"ded_{'s' if scope == 'span' else 'r'}_{index:02d}"


def block_schema(dedicated: Sequence[Any] = ()) -> list[tuple[str, str]]:
    fields = list(CORE_FIELDS)
    for i, col in enumerate(dedicated):
        fields.append((dedicated_field_name(col.scope, i), "string"))
    return fields


# ---------------------------------------------------------------------------
# Nested-set numbering (vparquet4/nested_set_model.go)
# ---------------------------------------------------------------------------

def nested_set(span_ids: list[bytes], parent_ids: list[bytes]) -> tuple[list, list, list]:
    """Assign (left, right, parent_idx) per span of ONE trace.

    Orphans (parent not present) and cycle remnants are treated as roots,
    as the reference does. Iterative DFS; left/right are 1-based within the
    trace; parent_idx is the LOCAL span index (-1 for roots).
    """
    n = len(span_ids)
    row_of = {sid: i for i, sid in enumerate(span_ids)}
    children: list[list[int]] = [[] for _ in range(n)]
    parent_idx = [-1] * n
    for i, pid in enumerate(parent_ids):
        p = row_of.get(pid) if pid and pid != b"\x00" * 8 else None
        if p is not None and p != i:
            parent_idx[i] = p
            children[p].append(i)
    roots = [i for i in range(n) if parent_idx[i] == -1]
    left = [0] * n
    right = [0] * n
    counter = 1
    visited = [False] * n
    for r in roots:
        # stack of (node, child_cursor)
        stack = [(r, 0)]
        visited[r] = True
        left[r] = counter
        counter += 1
        while stack:
            node, cur = stack[-1]
            if cur < len(children[node]):
                stack[-1] = (node, cur + 1)
                c = children[node][cur]
                if not visited[c]:
                    visited[c] = True
                    left[c] = counter
                    counter += 1
                    stack.append((c, 0))
            else:
                right[node] = counter
                counter += 1
                stack.pop()
    # components unreachable from any root contain a parent cycle. Break ONE
    # edge per cycle (making that node a root) and DFS-number the component,
    # preserving every non-cycle parent link.
    for start in range(n):
        if visited[start]:
            continue
        # walk up the parent chain to find the cycle node
        path_set = set()
        node = start
        while node not in path_set and not visited[node] and parent_idx[node] != -1:
            path_set.add(node)
            node = parent_idx[node]
        if not visited[node]:
            # `node` is on the cycle: break its parent edge
            p = parent_idx[node]
            if p != -1:
                children[p].remove(node)
                parent_idx[node] = -1
            stack = [(node, 0)]
            visited[node] = True
            left[node] = counter
            counter += 1
            while stack:
                cur_node, cur = stack[-1]
                if cur < len(children[cur_node]):
                    stack[-1] = (cur_node, cur + 1)
                    c = children[cur_node][cur]
                    if not visited[c]:
                        visited[c] = True
                        left[c] = counter
                        counter += 1
                        stack.append((c, 0))
                else:
                    right[cur_node] = counter
                    counter += 1
                    stack.pop()
    return left, right, parent_idx


# ---------------------------------------------------------------------------
# Trace spans → column table
# ---------------------------------------------------------------------------

def _split_attrs(attrs: dict[str, Any]):
    sk, sv, ik, iv, fk, fv, bk, bv = [], [], [], [], [], [], [], []
    for k, v in (attrs or {}).items():
        if isinstance(v, bool):
            bk.append(k); bv.append(v)
        elif isinstance(v, int):
            ik.append(k); iv.append(v)
        elif isinstance(v, float):
            fk.append(k); fv.append(v)
        elif isinstance(v, str):
            sk.append(k); sv.append(v)
        else:  # arrays/kvlists/bytes stringified, like attrToParquet (schema.go:253)
            sk.append(k); sv.append(str(v))
    return sk, sv, ik, iv, fk, fv, bk, bv


def traces_to_table(traces: Iterable[tuple[bytes, list[dict]]],
                    dedicated: Sequence[Any] = ()) -> ColumnTable:
    """[(trace_id, [span dicts])] → column table in block row order.

    Traces MUST be pre-sorted by trace_id; spans of each trace are laid out
    parent-before-child (DFS order is not required; rows keep input order).
    The rows are gathered per span in Python, as the reference does; each
    column is then built once from its list.
    """
    cols: dict[str, list] = {name: [] for name, _ in CORE_FIELDS}
    ded_names = [dedicated_field_name(c.scope, i) for i, c in enumerate(dedicated)]
    for dn in ded_names:
        cols[dn] = []
    for t_idx, (trace_id, spans) in enumerate(traces):
        sids = [s.get("span_id", b"") for s in spans]
        pids = [s.get("parent_span_id", b"") for s in spans]
        left, right, parent_local = nested_set(sids, pids)
        for j, s in enumerate(spans):
            cols["trace_id"].append(trace_id.ljust(16, b"\0")[:16])
            cols["trace_idx"].append(t_idx)
            cols["span_id"].append((sids[j] or b"").ljust(8, b"\0")[:8])
            cols["parent_span_id"].append((pids[j] or b"").ljust(8, b"\0")[:8])
            cols["parent_row"].append(parent_local[j])
            cols["nested_left"].append(left[j])
            cols["nested_right"].append(right[j])
            cols["is_root"].append(parent_local[j] < 0)
            cols["name"].append(s.get("name", ""))
            cols["service"].append(s.get("service", ""))
            cols["kind"].append(s.get("kind", 0))
            cols["status_code"].append(s.get("status_code", 0))
            cols["status_message"].append(s.get("status_message", ""))
            start = int(s.get("start_unix_nano", 0))
            cols["start_unix_nano"].append(start)
            cols["duration_ns"].append(max(int(s.get("end_unix_nano", start)) - start, 0))
            sk, sv, ik, iv, fk, fv, bk, bv = _split_attrs(s.get("attrs"))
            cols["sattr_str_keys"].append(sk); cols["sattr_str_vals"].append(sv)
            cols["sattr_int_keys"].append(ik); cols["sattr_int_vals"].append(iv)
            cols["sattr_f64_keys"].append(fk); cols["sattr_f64_vals"].append(fv)
            cols["sattr_bool_keys"].append(bk); cols["sattr_bool_vals"].append(bv)
            rk, rv, rik, riv, rfk, rfv, rbk, rbv = _split_attrs(s.get("res_attrs"))
            cols["rattr_str_keys"].append(rk); cols["rattr_str_vals"].append(rv)
            cols["rattr_int_keys"].append(rik); cols["rattr_int_vals"].append(riv)
            cols["rattr_f64_keys"].append(rfk); cols["rattr_f64_vals"].append(rfv)
            cols["rattr_bool_keys"].append(rbk); cols["rattr_bool_vals"].append(rbv)
            evs = s.get("events") or []
            cols["event_times"].append([int(e.get("time_unix_nano", 0)) for e in evs])
            cols["event_names"].append([str(e.get("name", "")) for e in evs])
            links = s.get("links") or []
            cols["link_trace_ids"].append(
                [bytes(l.get("trace_id", b"")).ljust(16, b"\0")[:16] for l in links])
            cols["link_span_ids"].append(
                [bytes(l.get("span_id", b"")).ljust(8, b"\0")[:8] for l in links])
            for dn, dc in zip(ded_names, dedicated):
                src = s.get("attrs") if dc.scope == "span" else s.get("res_attrs")
                v = (src or {}).get(dc.name)
                cols[dn].append(None if v is None else str(v))
    schema = block_schema(dedicated)
    return ColumnTable(schema, {n: column_from_pylist(t, cols[n])
                                for n, t in schema})


def table_stats(table: ColumnTable) -> dict:
    """Aggregates the writer stores in BlockMeta."""
    n = table.num_rows
    if n == 0:
        return {"total_spans": 0, "total_objects": 0, "start_time": 0.0, "end_time": 0.0}
    start = table.column("start_unix_nano")
    dur = table.column("duration_ns")
    tidx = table.column("trace_idx")
    return {
        "total_spans": int(n),
        "total_objects": int(tidx.max()) + 1,
        "start_time": float(start.min() / 1e9),
        "end_time": float((start + dur).max() / 1e9),
    }


def spans_by_trace(spans: Iterable[dict]) -> list[tuple[bytes, list[dict]]]:
    """Group flat span dicts by trace id, sorted by trace id (block order) —
    the regroup the distributor does in `requestsByTraceID`."""
    groups: dict[bytes, list[dict]] = {}
    for s in spans:
        groups.setdefault(bytes(s.get("trace_id", b"")), []).append(s)
    return sorted(groups.items())


def trace_ids(table: ColumnTable) -> np.ndarray:
    """The `trace_id` column as a void array, one 16-byte item a row, so
    rows compare to an id with `==`."""
    return np.ascontiguousarray(table.column("trace_id")).view("V16").reshape(-1)
