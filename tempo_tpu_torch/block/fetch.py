"""Columnar TraceQL fetch over backend blocks.

Counterpart of `tempo_tpu/block/fetch.py`, on the port's own Parquet codec
(`block/parquet.py`) where the reference reads Arrow arrays: each row
group becomes ONE ColumnView of struct-of-arrays columns, pushdown
conditions evaluate as vectorized masks over whole columns (dictionary-
aware for strings), `AllConditions` intersects masks before any
trace-level work, and the engine's second pass
(`traceql.eval.evaluate_pipeline`) runs only on surviving rows.

Columns arrive as numpy arrays, `parquet.Strings` (offsets plus UTF-8
bytes) and `parquet.Lists` (row offsets plus a child column). The port's
blocks hold PLAIN strings (no dictionary pages), so the string codes the
reference takes from Arrow's `dictionary_encode` come from numpy here
(`strings_codes`): one sort over the fixed-width padded bytes. The codes
(and so the order of their dictionary) may differ from the reference's;
every result built on them is the same.

Row groups are trace-aligned (see writer), so structural operators and
per-trace reductions never cross a batch boundary.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from tempo_tpu_torch.block import parquet
from tempo_tpu_torch.block.reader import BackendBlock
from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.conditions import FetchSpansRequest
from tempo_tpu_torch.traceql.eval import (BOOL, KIND, NUM, NUMLIST, STATUS,
                                          STR, STRLIST, Col, ColumnView,
                                          eval_expr)

# parquet columns always loaded (ids, tree, intrinsics — all cheap/dense)
CORE_COLUMNS = [
    "trace_id", "trace_idx", "span_id", "parent_span_id", "parent_row",
    "nested_left", "nested_right", "is_root", "name", "service", "kind",
    "status_code", "start_unix_nano", "duration_ns",
]

_ATTR_LIST_COLS = {
    "span": [("sattr_str_keys", "sattr_str_vals", STR),
             ("sattr_int_keys", "sattr_int_vals", NUM),
             ("sattr_f64_keys", "sattr_f64_vals", NUM),
             ("sattr_bool_keys", "sattr_bool_vals", BOOL)],
    "resource": [("rattr_str_keys", "rattr_str_vals", STR),
                 ("rattr_int_keys", "rattr_int_vals", NUM),
                 ("rattr_f64_keys", "rattr_f64_vals", NUM),
                 ("rattr_bool_keys", "rattr_bool_vals", BOOL)],
}

# padded-matrix ceiling of the numpy factorize (bytes); wider string
# columns factorize through Python strings instead
_PAD_CAP = 256 << 20


def columns_for_request(block: BackendBlock,
                        req: Optional[FetchSpansRequest]) -> list[str]:
    """Parquet column projection for a fetch request (pushdown pruning)."""
    cols = list(CORE_COLUMNS)
    if req is None:
        return None  # all columns
    need_events = need_links = need_msg = False
    for c in req.conditions + req.second_pass_conditions:
        a = c.attr
        if a.intrinsic in (A.Intrinsic.EVENT_NAME,
                           A.Intrinsic.EVENT_TIME_SINCE_START):
            need_events = True
        elif a.intrinsic in (A.Intrinsic.LINK_TRACE_ID, A.Intrinsic.LINK_SPAN_ID):
            need_links = True
        elif a.intrinsic == A.Intrinsic.STATUS_MESSAGE:
            need_msg = True
        elif a.intrinsic == A.Intrinsic.NONE:
            scopes = ([a.scope.value] if a.scope in (A.Scope.SPAN, A.Scope.RESOURCE)
                      else ["span", "resource"])
            for scope in scopes:
                ded = block.dedicated_column_name(scope, a.name)
                if ded:
                    cols.append(ded)
                for kc, vc, _t in _ATTR_LIST_COLS[scope]:
                    cols.extend((kc, vc))
    if need_events:
        cols.extend(("event_times", "event_names"))
    if need_links:
        cols.extend(("link_trace_ids", "link_span_ids"))
    if need_msg:
        cols.append("status_message")
    seen: set = set()
    return [c for c in cols if not (c in seen or seen.add(c))]


# ---------------------------------------------------------------------------
# column helpers
# ---------------------------------------------------------------------------

def strings_codes(s: parquet.Strings) -> tuple[np.ndarray, list[str]]:
    """(codes[int32], distinct values) of a string column, nulls apart
    (their codes point at no value: the caller maps them).

    Each value is padded to the widest one and tagged with its length, so
    one `np.unique` over fixed-width rows factorizes the column without a
    Python string per row; only the distinct values decode."""
    n = len(s)
    if n == 0:
        return np.zeros(0, np.int32), []
    lens = s.lengths()
    w = int(lens.max())
    if n * (w + 8) > _PAD_CAP:
        vals = s.tolist()
        u, inv = np.unique(np.asarray(["" if v is None else v for v in vals],
                                      object).astype("U"),
                           return_inverse=True)
        return inv.astype(np.int32), [str(x) for x in u.tolist()]
    mat = np.zeros((n, w + 8), np.uint8)
    if w:
        base = s.offsets[:-1]
        total = int(s.offsets[-1] - s.offsets[0])
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(total, dtype=np.int64) - np.repeat(
            base - s.offsets[0], lens)
        mat[rows, cols] = s.data[int(s.offsets[0]):int(s.offsets[-1])]
    mat[:, w:] = lens.astype("<i8").view(np.uint8).reshape(n, 8)
    keys = np.ascontiguousarray(mat).view(np.dtype((np.void, w + 8))).ravel()
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    raw = s.data.tobytes()
    o = s.offsets
    vals = [raw[o[i]:o[i + 1]].decode() for i in first.tolist()]
    return inv.reshape(-1).astype(np.int32), vals


def _dict_codes(view, key: str, col):
    """(codes[int32], dict values) — cached on the view. Nulls become the
    dictionary entry "None", matching the numpy plane's astype(str)
    semantics exactly (a null name DOES match `{ name = "None" }` there),
    so negation stays a plain complement. Shared by the device plane's
    dictionary terms and the Col sidecars view_from_table attaches for
    group_slots."""
    cache = view.meta.setdefault("_dict_codes", {})
    got = cache.get(key)
    if got is None:
        codes, vals = strings_codes(col)
        if col.valid is not None and not col.valid.all():
            try:
                none_id = vals.index("None")
            except ValueError:
                none_id = len(vals)
                vals = vals + ["None"]
            codes = np.where(col.valid, codes, none_id).astype(np.int32)
        got = cache[key] = (codes, vals)
    return got


def _np_str(col: parquet.Strings, codes=None, vals=None) -> np.ndarray:
    """Object array of Python strings (None for nulls)."""
    if codes is None:
        out = np.empty(len(col), object)
        out[:] = col.tolist()
        return out
    lut = np.empty(len(vals), object)
    lut[:] = vals
    out = lut[codes]
    if col.valid is not None and not col.valid.all():
        out[~col.valid] = None
    return out


def _list_parts(arr: parquet.Lists):
    """(offsets[int64, n+1], child column) of a list column."""
    return arr.offsets, arr.values


def _flat_codes(meta: dict, key: str, flat: parquet.Strings):
    cache = meta.setdefault("_flat_codes", {})
    got = cache.get(key)
    if got is None:
        got = cache[key] = strings_codes(flat)
    return got


def _attr_col_from_lists(view, tbl_cols: dict, kc: str, vc: str, t: str,
                         key: str, n: int
                         ) -> tuple[np.ndarray, np.ndarray] | None:
    """Materialize attribute `key` from parallel key/val list columns.

    Flat-array search: match the key's code over the flattened keys, map
    hit positions back to rows via offset binary search — no per-row
    Python loop."""
    if kc not in tbl_cols:
        return None
    offsets, flat_keys = _list_parts(tbl_cols[kc])
    if len(flat_keys) == 0:
        return None
    codes, kvals = _flat_codes(view.meta, kc, flat_keys)
    try:
        kid = kvals.index(key)
    except ValueError:
        return None
    hits = np.flatnonzero(codes == kid)
    if len(hits) == 0:
        return None
    _, flat_vals = _list_parts(tbl_cols[vc])
    rows = np.searchsorted(offsets, hits, side="right") - 1
    if t == STR:
        vals = np.empty(n, object)
        got = np.empty(len(hits), object)
        got[:] = flat_vals.take(hits).tolist()
    elif t == BOOL:
        vals = np.zeros(n, bool)
        got = flat_vals[hits]
    else:
        vals = np.zeros(n, float)
        got = flat_vals[hits]
    exists = np.zeros(n, bool)
    # first occurrence wins (reverse so earlier index overwrites later)
    vals[rows[::-1]] = got[::-1]
    exists[rows] = True
    return vals, exists


def _hex_col(arr: np.ndarray, n: int) -> np.ndarray:
    """Hex strings for a fixed-width binary column: one C-level .hex()
    over the bytes, then string slicing."""
    if n == 0:
        return np.empty(0, object)
    w = arr.shape[1]
    hexs = np.ascontiguousarray(arr).tobytes().hex()
    out = np.empty(n, object)
    out[:] = [hexs[2 * w * i: 2 * w * (i + 1)] for i in range(n)]
    return out


# ---------------------------------------------------------------------------
# view construction
# ---------------------------------------------------------------------------

def view_from_table(block: Optional[BackendBlock],
                    tbl: parquet.ColumnTable) -> ColumnView:
    """Build a lazy ColumnView over one trace-aligned row-group table."""
    n = tbl.num_rows
    cols = {name: tbl.column(name) for name in tbl.names}
    trace_idx = np.asarray(cols["trace_idx"], np.int64) if n \
        else np.zeros(0, np.int64)
    view = ColumnView(n, trace_idx)
    ones = np.ones(n, bool)

    start = np.asarray(cols["start_unix_nano"], np.int64)
    dur = np.asarray(cols["duration_ns"], np.int64)
    # tree coordinates: parent_row is trace-local; rebase onto this row
    # group's rows (trace-aligned groups keep whole traces contiguous)
    parent_local = np.asarray(cols["parent_row"], np.int64)
    view.parent_row = _rebase_parent(parent_local, trace_idx)
    view.nested_left = np.asarray(cols["nested_left"], np.int64)
    view.nested_right = np.asarray(cols["nested_right"], np.int64)

    view.set_col("duration", Col(NUM, dur.astype(float), ones))
    view.set_col("__startTime", Col(NUM, start.astype(float), ones))
    # name/service ride their dictionary codes alongside the object
    # values: group_slots factorizes the int32 codes instead of
    # astype("U")-converting the whole object column per query
    ncodes, nvals = _dict_codes(view, "name", cols["name"])
    view.set_col("name", Col(STR, _np_str(cols["name"], ncodes, nvals), ones,
                             codes=ncodes, code_values=nvals))
    scodes, svals = _dict_codes(view, "service", cols["service"])
    view.set_col("resource.service.name",
                 Col(STR, _np_str(cols["service"], scodes, svals), ones,
                     codes=scodes, code_values=svals))
    kind = np.asarray(cols["kind"], float)
    view.set_col("kind", Col(KIND, kind, ones))
    otlp_status = np.asarray(cols["status_code"], np.int64)
    status = np.select([otlp_status == 1, otlp_status == 2],
                       [A.STATUS_OK, A.STATUS_ERROR], A.STATUS_UNSET).astype(float)
    view.set_col("status", Col(STATUS, status, ones))
    view.set_col("nestedSetLeft", Col(NUM, view.nested_left.astype(float), ones))
    view.set_col("nestedSetRight", Col(NUM, view.nested_right.astype(float), ones))
    pr = view.parent_row
    nsp = np.where(pr >= 0, view.nested_left[np.maximum(pr, 0)], -1).astype(float)
    view.set_col("nestedSetParent", Col(NUM, nsp, ones))

    # lazy identity columns
    view.set_resolver("trace:id", lambda: Col(STR, _hex_col(cols["trace_id"], n), ones))
    view.set_resolver("span:id", lambda: Col(STR, _hex_col(cols["span_id"], n), ones))
    view.set_resolver("span:parentID",
                      lambda: Col(STR, _hex_col(cols["parent_span_id"], n), ones))
    if "status_message" in cols:
        view.set_resolver("statusMessage",
                          lambda: Col(STR, _np_str(cols["status_message"]), ones))

    # root intrinsics: broadcast root-row values across each trace segment
    is_root = np.asarray(cols["is_root"], bool)

    def _root_broadcast(src_key: str):
        src = view.col(src_key)
        out = np.empty(n, object)
        exists = np.zeros(n, bool)
        root_rows = np.flatnonzero(is_root)
        if len(root_rows):
            # one root per trace: segment fill via searchsorted on trace_idx
            seg = np.searchsorted(trace_idx[root_rows], trace_idx, side="left")
            seg = np.clip(seg, 0, len(root_rows) - 1)
            src_rows = root_rows[seg]
            match = trace_idx[src_rows] == trace_idx
            out[match] = src.values[src_rows[match]]
            exists = match
        return Col(STR, out, exists)

    view.set_resolver("rootName", lambda: _root_broadcast("name"))
    view.set_resolver("rootServiceName",
                      lambda: _root_broadcast("resource.service.name"))

    def _trace_duration():
        ends = start + dur
        # segment min/max over trace_idx runs
        out = np.zeros(n, float)
        if n:
            bounds = np.flatnonzero(np.diff(trace_idx)) + 1
            firsts = np.concatenate([[0], bounds])
            seg_max = np.maximum.reduceat(ends, firsts)
            seg_min = np.minimum.reduceat(start, firsts)
            lens = np.diff(np.concatenate([firsts, [n]]))
            out = np.repeat((seg_max - seg_min).astype(float), lens)
        return Col(NUM, out, ones)

    view.set_resolver("traceDuration", _trace_duration)

    # events / links
    if "event_names" in cols:
        def _events():
            return Col(STRLIST, *_list_obj(cols["event_names"], n))
        view.set_resolver("event:name", _events)

        def _event_times():
            vals, exists = _list_obj(cols["event_times"], n)
            for i in np.flatnonzero(exists):
                vals[i] = [t - int(start[i]) for t in vals[i]]
            return Col(NUMLIST, vals, exists)
        view.set_resolver("event:timeSinceStart", _event_times)
    if "link_trace_ids" in cols:
        view.set_resolver("link:traceID",
                          lambda: Col(STRLIST, *_list_hex(cols["link_trace_ids"], n)))
        view.set_resolver("link:spanID",
                          lambda: Col(STRLIST, *_list_hex(cols["link_span_ids"], n)))

    # generic + dedicated attribute resolvers, installed per referenced key
    # lazily through a fallback hook
    def attr_resolver(scope: str, key: str):
        def resolve():
            if block is not None:
                ded = block.dedicated_column_name(scope, key)
                if ded and ded in cols:
                    vals = _np_str(cols[ded])
                    exists = np.fromiter((v is not None for v in vals), bool, n) \
                        if n else np.zeros(0, bool)
                    return Col(STR, vals, exists)
            best: tuple | None = None
            for kc, vc, t in _ATTR_LIST_COLS[scope]:
                got = _attr_col_from_lists(view, cols, kc, vc, t, key, n)
                if got is not None:
                    vals, exists = got
                    if best is None or exists.sum() > best[2].sum():
                        best = (t, vals, exists)
            if best is None:
                return None
            return Col(best[0], best[1], best[2])
        return resolve

    view.attr_resolver_factory = attr_resolver  # type: ignore[attr-defined]

    # tag-name listings (when the key list columns were projected)
    def _keys_of(prefix: str) -> set:
        out: set = set()
        for kc in (f"{prefix}attr_str_keys", f"{prefix}attr_int_keys",
                   f"{prefix}attr_f64_keys", f"{prefix}attr_bool_keys"):
            if kc in cols:
                _, flat = _list_parts(cols[kc])
                if len(flat):
                    out |= set(_flat_codes(view.meta, kc, flat)[1])
        return out

    if "sattr_str_keys" in cols:
        view.meta["span_attr_keys"] = _keys_of("s")
        view.meta["resource_attr_keys"] = _keys_of("r")

    # search-result metadata
    view.meta["start_unix_nano"] = start
    view.meta["duration_ns"] = dur
    view.meta["trace_id_raw"] = cols["trace_id"]
    view.meta["span_id_raw"] = cols["span_id"]
    view.meta["name_col"] = cols["name"]
    view.meta["service_col"] = cols["service"]
    view.meta["is_root"] = is_root
    return view


def _list_obj(arr: parquet.Lists, n: int) -> tuple[np.ndarray, np.ndarray]:
    py = arr.tolist()
    vals = np.empty(n, object)
    exists = np.zeros(n, bool)
    for i, v in enumerate(py):
        if v:
            vals[i] = v
            exists[i] = True
    return vals, exists


def _list_hex(arr: parquet.Lists, n: int) -> tuple[np.ndarray, np.ndarray]:
    vals, exists = _list_obj(arr, n)
    for i in np.flatnonzero(exists):
        vals[i] = [bytes(b).hex() for b in vals[i]]
    return vals, exists


def _rebase_parent(parent_local: np.ndarray, trace_idx: np.ndarray) -> np.ndarray:
    """Trace-local parent indices → view-row indices: add each trace's first
    row (traces are contiguous within a trace-aligned row group)."""
    n = len(parent_local)
    if n == 0:
        return parent_local
    local = np.arange(n, dtype=np.int64)
    change = np.diff(trace_idx, prepend=trace_idx[0] - 1) != 0
    seg_first = np.maximum.accumulate(np.where(change, local, -1))
    return np.where(parent_local >= 0, parent_local + seg_first, -1)


# ---------------------------------------------------------------------------
# attr fallback wiring into eval
# ---------------------------------------------------------------------------

def _install_attr_hook(view: ColumnView) -> None:
    """Wrap view.col so span./resource. keys materialize on demand from the
    attr list columns (pushdown: only referenced keys are ever built)."""
    factory = getattr(view, "attr_resolver_factory", None)
    if factory is None:
        return
    orig_col = view.col

    def col(key: str):
        c = orig_col(key)
        if c is None and "." in key:
            scope, _, name = key.partition(".")
            if scope in ("span", "resource"):
                c = factory(scope, name)()
                if c is not None:
                    view.set_col(key, c)
                else:
                    view.set_col(key, view.missing())  # negative-cache
                    return None
        return c

    view.col = col  # type: ignore[method-assign]


# ---------------------------------------------------------------------------
# fetch
# ---------------------------------------------------------------------------

def prefilter_is_noop(req: FetchSpansRequest) -> bool:
    """True when the storage prefilter must pass every row through:
    no predicates, or OR-semantics with a non-pushable sub-expression
    (negation / cross-attribute compare) — any span might match."""
    preds = [c for c in req.conditions if c.op is not None]
    fetch_only = any(c.op is None and c.from_filter for c in req.conditions)
    return not preds or (not req.all_conditions
                         and (fetch_only or req.has_unconditioned_arm))


def condition_mask(view: ColumnView, req: FetchSpansRequest) -> np.ndarray:
    """Storage-level first pass: vectorized mask from pushdown conditions.

    With `TEMPO_TPU_DEVICE_SCAN=1` the predicates go to the per-row-group
    device offload (`device_scan.device_pred_mask`) on the view's device;
    shapes it refuses, as the reference's does, stay on the host."""
    n = view.n
    preds = [c for c in req.conditions if c.op is not None]
    if prefilter_is_noop(req):
        mask = np.ones(n, bool)
    else:
        from tempo_tpu_torch.block.device_scan import device_pred_mask

        mask = device_pred_mask(view, preds, req.all_conditions)
        if mask is None:
            for c in preds:
                expr = A.BinaryOp(c.op, c.attr, c.operands[0])
                m = eval_expr(view, expr).bool_mask()
                if mask is None:
                    mask = m
                elif req.all_conditions:
                    mask &= m
                else:
                    mask |= m
        if mask is None:
            mask = np.ones(n, bool)
    if req.start_ns or req.end_ns:
        st = view.col("__startTime")
        if st is not None:
            s = st.values
            if req.start_ns:
                mask = mask & (s >= req.start_ns)
            if req.end_ns:
                mask = mask & (s < req.end_ns)
    return mask


def block_tag_names(block: BackendBlock, limit: int = 1000,
                    byte_budget: int = 0) -> dict[str, set]:
    """Distinct attr keys of a block, reading ONLY the key-list columns
    (the metadata-endpoint fast path — no data pages decoded). Stops early
    once `limit` names or `byte_budget` bytes of names are collected
    (`max_bytes_per_tag_values_query` semantics)."""
    key_cols = [f"{p}attr_{t}_keys" for p in ("s", "r")
                for t in ("str", "int", "f64", "bool")]
    pf = block.parquet_file()
    avail = set(pf.names)
    use = [c for c in key_cols if c in avail]
    out: dict[str, set] = {"span": set(), "resource": set()}
    used_bytes = 0
    for rg in range(pf.num_row_groups):
        tbl = pf.read_row_group(rg, columns=use)
        for c in use:
            _, flat = _list_parts(tbl.column(c))
            if not len(flat):
                continue
            scope = "span" if c.startswith("s") else "resource"
            for name in sorted(strings_codes(flat)[1]):
                if name not in out[scope]:
                    out[scope].add(name)
                    used_bytes += len(name)
        if (len(out["span"]) + len(out["resource"]) >= limit
                or (byte_budget and used_bytes >= byte_budget)):
            break
    return out


def scan_views(block: BackendBlock, req: Optional[FetchSpansRequest] = None,
               row_groups: Optional[Sequence[int]] = None, device=None
               ) -> Iterator[tuple[ColumnView, np.ndarray]]:
    """Yield (view, candidate_rows) per row group — the SpansetFetcher.

    `candidate_rows` is the storage-level prefilter; the engine's second pass
    (full pipeline) decides final membership, exactly the two-pass split of
    `traceql.Engine.ExecuteSearch` (`engine.go:82-113`). `device` (the
    reader's torch device) rides on each view as `meta["device"]`: the
    per-row-group offload of `condition_mask` runs there.
    """
    from tempo_tpu_torch.obs import querystats

    columns = columns_for_request(block, req)
    pf = block.parquet_file()
    rgs = range(pf.num_row_groups) if row_groups is None else row_groups
    for rg in rgs:
        with querystats.stage("block_fetch"):
            tbl = pf.read_row_group(rg, columns=columns)
        if req is not None:
            # bytes materialized for an actual query scan (req=None is
            # the plane-cache adoption read — CachedBlock.scan accounts
            # resident-view bytes per query instead)
            querystats.add(inspected_bytes=tbl.nbytes)
        view = view_from_table(block, tbl)
        if device is not None:
            view.meta["device"] = device
        _install_attr_hook(view)
        if req is not None:
            mask = condition_mask(view, req)
            cand = np.flatnonzero(mask)
            if len(cand) == 0 and req.all_conditions:
                continue
        else:
            cand = np.arange(view.n)
        yield view, cand
