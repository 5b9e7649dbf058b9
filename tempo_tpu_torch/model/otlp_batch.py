"""Vectorized OTLP protobuf → SpanBatch staging (the ingest hot path).

Counterpart of `tempo_tpu/model/otlp_batch.py`. The whole decode runs in
the C++ staging kernel (`native.otlp_stage`): one pass over the wire
bytes emits fixed columns AND intern ids (names, services, attribute
keys and values are dictionary-encoded inside C++, see native.cpp
Interner); numpy only pads and scatters the id columns. Python touches
no per-span data on this path; only rare non-scalar AnyValues cross back
for stringification. The port has no per-span fallback: the staging
kernel is always built (`tempo_tpu_torch.native`).

`stage_otlp` is the decode-once form: one staging pass whose records
every consumer shares through row-index views (`StagedView`), the
dedicated-spanmetrics fast route reading the StageRec rows directly and
every other processor mix the lazily built SpanBatch columns.
"""

from __future__ import annotations

import numpy as np

from tempo_tpu_torch import native
from tempo_tpu_torch.model.interner import INVALID_ID, StringInterner
from tempo_tpu_torch.model.otlp import _pb_anyvalue
from tempo_tpu_torch.model.span_batch import (
    ATTR_STRING,
    SpanBatch,
    _pad_rows,
    _pad_width,
)

_MAX_SPAN_ATTRS = 64
_MAX_RES_ATTRS = 32


def _staged_service_ids(data: bytes, interner: StringInterner,
                        rattrs, res) -> np.ndarray:
    """Per-resource service.name intern ids with the Python fixup applied.

    Dict semantics are last-occurrence-wins regardless of value type (C++
    recorded the last STRING occurrence only); the fixup runs over the
    per-RESOURCE attr rows (tiny). Shared by full SpanBatch staging and
    the decode-once tee's usage attribution."""
    svc = res["service_id"].astype(np.int32)
    svc_key = interner.get("service.name")
    svc_hits = np.flatnonzero(rattrs["key_id"] == svc_key)
    if svc_hits.size and (rattrs["typ"][svc_hits] != 1).any():
        last: dict[int, int] = {}
        for idx in svc_hits.tolist():
            last[int(rattrs["owner"][idx])] = idx
        for o, idx in last.items():
            t = int(rattrs["typ"][idx])
            if t == 1:
                v = interner.lookup(int(rattrs["sval_id"][idx]))
            elif t == 2:
                v = str(bool(rattrs["fval"][idx]))
            elif t == 3:
                v = str(int(rattrs["ival"][idx]))
            elif t == 4:
                v = str(float(rattrs["fval"][idx]))
            else:   # non-scalar: stringify from its raw range
                so = int(rattrs["sval_off"][idx])
                sl = int(rattrs["sval_len"][idx])
                v = str(_pb_anyvalue(data[so:so + sl]))
            svc[o] = interner.intern(v)
    return svc


def batch_from_otlp(data: bytes, interner: StringInterner,
                    return_sizes: bool = False,
                    include_span_attrs: bool = True,
                    include_res_attrs: bool = True,
                    trusted: bool = False):
    """OTLP ExportTraceServiceRequest bytes → SpanBatch, through the
    one-pass C++ staging kernel (the output contract of the per-span
    decoder and builder, modulo the duplicate-attribute-key note on
    `_batch_from_staged`). With `return_sizes` also returns [cap] f32
    wire bytes per span for the size subprocessor (`spanmetrics.go:27-31`).

    `include_*_attrs=False` skips materializing that attribute matrix
    (the columns come back 0-wide): callers whose processors read only
    intrinsic dimensions, the default spanmetrics config, drop a third of
    the staging work. service.name extraction is unaffected.
    """
    staged = native.otlp_stage(interner.native_handle(), data,
                               skip_span_attrs=not include_span_attrs,
                               trust_attrs=trusted)
    return _batch_from_staged(data, interner, staged, return_sizes,
                              include_span_attrs, include_res_attrs)


def _batch_from_staged(data: bytes, interner: StringInterner, staged,
                       return_sizes: bool,
                       include_span_attrs: bool = True,
                       include_res_attrs: bool = True):
    """C++-staged records → SpanBatch: numpy does only padding/scatter.

    Known divergence from the dict path: duplicate attribute keys within
    one scope keep one column per occurrence instead of last-wins dict
    semantics (`attr_sval_column` reads the first)."""
    spans, sattrs, rattrs, res = staged
    interner.sync()                      # mirror ids created in C++
    n = len(spans)
    cap = _pad_rows(max(n, 1))
    empty_id = interner.intern("")

    name_id = np.full(cap, INVALID_ID, np.int32)
    sm_id = np.full(cap, INVALID_ID, np.int32)
    service_id = np.full(cap, INVALID_ID, np.int32)
    kind = np.zeros(cap, np.int32)
    status_code = np.zeros(cap, np.int32)
    start = np.zeros(cap, np.int64)
    end = np.zeros(cap, np.int64)
    tid = np.zeros((cap, 16), np.uint8)
    sid = np.zeros((cap, 8), np.uint8)
    pid = np.zeros((cap, 8), np.uint8)
    if n:
        name_id[:n] = spans["name_id"]
        sm = spans["status_msg_id"]
        # builder semantics: empty status message → INVALID_ID
        sm_id[:n] = np.where((sm < 0) | (sm == empty_id), INVALID_ID, sm)
        kind[:n] = spans["kind"]
        status_code[:n] = spans["status_code"]
        start[:n] = spans["start_ns"].astype(np.int64)
        end[:n] = spans["end_ns"].astype(np.int64)
        tid[:n] = spans["trace_id"]
        sid[:n] = spans["span_id"]
        pid[:n] = spans["parent_span_id"]

    def _scalar_fvals(a: np.ndarray) -> np.ndarray:
        typ = a["typ"]
        f = np.zeros(len(a), np.float32)
        f[typ == 2] = a["fval"][typ == 2]
        f[typ == 3] = a["ival"][typ == 3]
        f[typ == 4] = a["fval"][typ == 4]
        return f

    def _fix_nonscalar(a: np.ndarray, sval: np.ndarray, typ: np.ndarray):
        """Stringify array/kvlist/bytes AnyValues (rare Python pass)."""
        for i in np.flatnonzero(a["typ"] == 0):
            o, ln = int(a["sval_off"][i]), int(a["sval_len"][i])
            sval[i] = interner.intern(str(_pb_anyvalue(data[o:o + ln])))
            typ[i] = ATTR_STRING

    def _attr_matrix(a: np.ndarray, owners: np.ndarray, starts: np.ndarray,
                     n_rows: int, max_attrs: int):
        """Scatter flat StageAttrs into [n_rows, W] id columns."""
        key = a["key_id"].astype(np.int32)
        sval = a["sval_id"].astype(np.int32)
        typ = a["typ"].astype(np.int8)
        fval = _scalar_fvals(a)
        _fix_nonscalar(a, sval, typ)
        pos = np.arange(len(a), dtype=np.int64) - starts[owners]
        w = _pad_width(int(min((pos.max() if len(a) else -1) + 1, max_attrs)))
        km = np.full((n_rows, w), INVALID_ID, np.int32)
        sm_ = np.full((n_rows, w), INVALID_ID, np.int32)
        fm = np.zeros((n_rows, w), np.float32)
        tm = np.zeros((n_rows, w), np.int8)
        if len(a) and w:
            keep = pos < min(max_attrs, w)
            oi, pi = owners[keep], pos[keep]
            km[oi, pi] = key[keep]
            sm_[oi, pi] = sval[keep]
            fm[oi, pi] = fval[keep]
            tm[oi, pi] = typ[keep]
        return km, sm_, fm, tm, sval

    # -- resources ---------------------------------------------------------
    nres = len(res)
    if nres and n:
        svc = _staged_service_ids(data, interner, rattrs, res)
        res_idx = spans["res_idx"].astype(np.int64)
        service_id[:n] = svc[res_idx]
        if include_res_attrs:
            r_owner = rattrs["owner"].astype(np.int64)
            u_rkey, u_rsval, u_rfval, u_rtyp, _ = _attr_matrix(
                rattrs, r_owner, res["attr_start"].astype(np.int64), nres,
                _MAX_RES_ATTRS)
            r_w = u_rkey.shape[1]
            res_attr_key = np.full((cap, r_w), INVALID_ID, np.int32)
            res_attr_sval = np.full((cap, r_w), INVALID_ID, np.int32)
            res_attr_fval = np.zeros((cap, r_w), np.float32)
            res_attr_typ = np.zeros((cap, r_w), np.int8)
            res_attr_key[:n] = u_rkey[res_idx]
            res_attr_sval[:n] = u_rsval[res_idx]
            res_attr_fval[:n] = u_rfval[res_idx]
            res_attr_typ[:n] = u_rtyp[res_idx]
        else:
            res_attr_key = np.full((cap, 0), INVALID_ID, np.int32)
            res_attr_sval = np.full((cap, 0), INVALID_ID, np.int32)
            res_attr_fval = np.zeros((cap, 0), np.float32)
            res_attr_typ = np.zeros((cap, 0), np.int8)
    else:
        if n:
            service_id[:n] = empty_id
        res_attr_key = np.full((cap, 0), INVALID_ID, np.int32)
        res_attr_sval = np.full((cap, 0), INVALID_ID, np.int32)
        res_attr_fval = np.zeros((cap, 0), np.float32)
        res_attr_typ = np.zeros((cap, 0), np.int8)

    # -- span attrs --------------------------------------------------------
    na = len(sattrs) if include_span_attrs else 0
    if na and n:
        span_idx = sattrs["owner"].astype(np.int64)
        counts = np.bincount(span_idx, minlength=n)
        starts = np.zeros(n, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        u_k, u_s, u_f, u_t, _ = _attr_matrix(
            sattrs, span_idx, starts, n, _MAX_SPAN_ATTRS)
        k_w = u_k.shape[1]
        span_attr_key = np.full((cap, k_w), INVALID_ID, np.int32)
        span_attr_sval = np.full((cap, k_w), INVALID_ID, np.int32)
        span_attr_fval = np.zeros((cap, k_w), np.float32)
        span_attr_typ = np.zeros((cap, k_w), np.int8)
        span_attr_key[:n] = u_k
        span_attr_sval[:n] = u_s
        span_attr_fval[:n] = u_f
        span_attr_typ[:n] = u_t
    else:
        span_attr_key = np.full((cap, 0), INVALID_ID, np.int32)
        span_attr_sval = np.full((cap, 0), INVALID_ID, np.int32)
        span_attr_fval = np.zeros((cap, 0), np.float32)
        span_attr_typ = np.zeros((cap, 0), np.int8)

    valid = np.zeros(cap, bool)
    valid[:n] = True
    sb = SpanBatch(
        n=n,
        trace_id=tid, span_id=sid, parent_span_id=pid,
        name_id=name_id, service_id=service_id,
        kind=kind, status_code=status_code, status_message_id=sm_id,
        start_unix_nano=start, end_unix_nano=end,
        span_attr_key=span_attr_key, span_attr_sval=span_attr_sval,
        span_attr_fval=span_attr_fval, span_attr_typ=span_attr_typ,
        res_attr_key=res_attr_key, res_attr_sval=res_attr_sval,
        res_attr_fval=res_attr_fval, res_attr_typ=res_attr_typ,
        valid=valid, interner=interner,
    )
    if return_sizes:
        sizes = np.zeros(cap, np.float32)
        if n:
            sizes[:n] = spans["span_len"]
        return sb, sizes
    return sb


# ---------------------------------------------------------------------------
# decode-once staging: one OTLP payload, shared by every tee target
# ---------------------------------------------------------------------------


def stage_otlp(data: bytes, interner: StringInterner, *,
               trusted: bool = False, include_span_attrs: bool = True,
               include_res_attrs: bool = True) -> "StagedIngest":
    """OTLP wire bytes → a `StagedIngest`: ONE C++ staging pass whose
    product every consumer shares through row-index views. Raises
    ValueError on a malformed payload: the staging pass IS the
    validation pass."""
    staged = native.otlp_stage(interner.native_handle(), data,
                               skip_span_attrs=not include_span_attrs,
                               trust_attrs=trusted)
    interner.sync()
    return StagedIngest(data, interner, staged,
                        has_span_attrs=include_span_attrs,
                        include_res_attrs=include_res_attrs)


class StagedIngest:
    """The decode-once product of one OTLP payload.

    Holds the C++-staged record arrays (fixed columns + intern ids), the
    interner they were staged against, and the raw payload; materializes
    the columnar SpanBatch LAZILY (a dedicated-spanmetrics generator
    consumes the StageRec rows directly and never pays the numpy
    padding/scatter). `view(rows)` hands out per-target row-index slices
    over the shared arrays — the distributor's tee unit: no
    re-serialization, no second staging pass, no per-target decode."""

    __slots__ = ("raw", "interner", "spans", "sattrs", "rattrs", "res",
                 "has_span_attrs", "include_res_attrs", "sample_weight",
                 "_batch", "_sizes", "_events", "_fixup", "_svc_ids")

    def __init__(self, raw: bytes, interner: StringInterner, staged,
                 has_span_attrs: bool = True,
                 include_res_attrs: bool = True) -> None:
        self.raw = raw
        self.interner = interner
        self.spans, self.sattrs, self.rattrs, self.res = staged
        self.has_span_attrs = has_span_attrs
        self.include_res_attrs = include_res_attrs
        # per-row Horvitz-Thompson weights set by the distributor's
        # overload sampling stage (None = unsampled, every weight 1.0);
        # views slice it so the generator can upscale sampled rates
        self.sample_weight: "np.ndarray | None" = None
        self._batch = None
        self._sizes = None
        self._events = None
        self._fixup: "bool | None" = None
        self._svc_ids: "np.ndarray | None" = None

    @property
    def n(self) -> int:
        return len(self.spans)

    @property
    def needs_service_fixup(self) -> bool:
        """True when some resource carries a non-string service.name (the
        staged service_id column then needs the Python stringify fixup —
        the StageRec fast consumers bail to the SpanBatch route, where
        `_staged_service_ids` applies it)."""
        if self._fixup is None:
            svc_key = self.interner.get("service.name")
            hits = self.rattrs["key_id"] == svc_key
            self._fixup = bool(hits.any()
                               and (self.rattrs["typ"][hits] != 1).any())
        return self._fixup

    def service_ids(self) -> np.ndarray:
        """Per-RESOURCE service.name intern ids, fixup applied (usage
        attribution reads these without materializing the batch)."""
        if self._svc_ids is None:
            self._svc_ids = _staged_service_ids(
                self.raw, self.interner, self.rattrs, self.res)
        return self._svc_ids

    def batch(self) -> tuple["SpanBatch", np.ndarray]:
        """The staged columnar SpanBatch + per-span wire sizes, built on
        first use and shared by every subsequent view."""
        if self._batch is None:
            self._batch, self._sizes = _batch_from_staged(
                self.raw, self.interner,
                (self.spans, self.sattrs, self.rattrs, self.res),
                return_sizes=True,
                include_span_attrs=self.has_span_attrs,
                include_res_attrs=self.include_res_attrs)
        return self._batch, self._sizes

    def events_links(self) -> tuple[dict, dict]:
        """{span_idx: [event dicts]}, {span_idx: [link dicts]} — one lazy
        native pass over the payload; events/links are persistence-only
        fields (the metrics plane never columnizes them)."""
        if self._events is None:
            ev_by: dict[int, list] = {}
            ln_by: dict[int, list] = {}
            evs, links = native.otlp_events(self.raw)
            raw = self.raw
            for rec in evs:
                off, ln = int(rec["name_off"]), int(rec["name_len"])
                ev_by.setdefault(int(rec["span_idx"]), []).append({
                    "time_unix_nano": int(rec["time_ns"]),
                    "name": raw[off:off + ln].decode("utf-8", "replace"),
                })
            for rec in links:
                ln_by.setdefault(int(rec["span_idx"]), []).append({
                    "trace_id": bytes(rec["trace_id"])[:int(rec["tid_len"])],
                    "span_id": bytes(rec["span_id"])[:int(rec["sid_len"])],
                })
            self._events = (ev_by, ln_by)
        return self._events

    def view(self, rows: "np.ndarray | None" = None) -> "StagedView":
        """A row-index slice over this staging (None = every row)."""
        return StagedView(self, rows)


class StagedView:
    """One tee target's slice of a `StagedIngest`: row indices over the
    shared staged arrays. The full-coverage view (the common single-target
    ring case) is genuinely zero-copy — consumers receive the shared
    arrays themselves."""

    __slots__ = ("staged", "rows")

    def __init__(self, staged: StagedIngest,
                 rows: "np.ndarray | None" = None) -> None:
        self.staged = staged
        self.rows = None if rows is None else np.asarray(rows, np.int64)

    @property
    def n(self) -> int:
        return self.staged.n if self.rows is None else int(len(self.rows))

    @property
    def is_full(self) -> bool:
        return self.rows is None or len(self.rows) == self.staged.n

    def row_indices(self) -> np.ndarray:
        if self.rows is None:
            return np.arange(self.staged.n, dtype=np.int64)
        return self.rows

    def stage_rows(self) -> np.ndarray:
        """This view's StageRec rows — the SHARED array when full (zero
        copy), an 88B/row gather otherwise."""
        if self.is_full:
            return self.staged.spans
        return self.staged.spans[self.rows]

    def weights(self) -> "np.ndarray | None":
        """This view's sampling weights (None when the push was not
        sampled — the common case; consumers then use weight 1.0)."""
        w = self.staged.sample_weight
        if w is None or self.is_full:
            return w
        return w[self.rows]

    def batch_slice(self) -> tuple["SpanBatch", np.ndarray]:
        """(SpanBatch, sizes) for this view's rows — the shared staged
        batch when full, a column gather (`SpanBatch.take_rows`)
        otherwise. Never re-decodes wire bytes."""
        sb, sizes = self.staged.batch()
        if self.is_full:
            return sb, sizes
        out = sb.take_rows(self.rows)
        out_sizes = np.zeros(out.capacity, np.float32)
        out_sizes[:len(self.rows)] = sizes[self.rows]
        return out, out_sizes

    def trace_groups(self) -> list[tuple[bytes, list[int]]]:
        """(exact trace-id bytes, row indices) in first-seen order — the
        ingester's live-trace grouping straight off the columns."""
        spans = self.staged.spans
        rows = self.row_indices()
        tids = spans["trace_id"]
        tls = spans["tid_len"]
        groups: dict[bytes, list[int]] = {}
        for i in rows.tolist():
            tid = bytes(tids[i])[:int(tls[i])]
            groups.setdefault(tid, []).append(i)
        return list(groups.items())

    def to_span_dicts(self, rows: "np.ndarray | list[int] | None" = None
                      ) -> list[dict]:
        """Wire-parity span dicts for this view's rows (or a sub-slice):
        the shape `spans_from_otlp_proto` yields, with exact id byte
        lengths restored from the staged records and events/links merged
        from the lazy payload pass."""
        st = self.staged
        if not st.has_span_attrs:
            raise ValueError(
                "staged without span attrs: dict conversion would drop "
                "attributes (stage with include_span_attrs=True)")
        sb, _ = st.batch()
        spans = st.spans
        ev_by, ln_by = st.events_links()
        it = st.interner
        out = []
        idx = self.row_indices() if rows is None else np.asarray(rows)
        k_has = sb.span_attr_key.shape[1] > 0
        r_has = sb.res_attr_key.shape[1] > 0
        for i in idx.tolist():
            rec = spans[i]
            sm = int(sb.status_message_id[i])
            s: dict = {
                "trace_id": bytes(rec["trace_id"])[:int(rec["tid_len"])],
                "span_id": bytes(rec["span_id"])[:int(rec["sid_len"])],
                "parent_span_id":
                    bytes(rec["parent_span_id"])[:int(rec["pid_len"])],
                "name": it.lookup(int(sb.name_id[i]))
                    if int(sb.name_id[i]) != INVALID_ID else "",
                "service": it.lookup(int(sb.service_id[i]))
                    if int(sb.service_id[i]) != INVALID_ID else "",
                "kind": int(sb.kind[i]),
                "status_code": int(sb.status_code[i]),
                "status_message": it.lookup(sm) if sm != INVALID_ID else "",
                "start_unix_nano": int(sb.start_unix_nano[i]),
                "end_unix_nano": int(sb.end_unix_nano[i]),
                "attrs": sb._decode_attrs(
                    sb.span_attr_key[i], sb.span_attr_sval[i],
                    sb.span_attr_fval[i], sb.span_attr_typ[i])
                    if k_has else {},
                "res_attrs": sb._decode_attrs(
                    sb.res_attr_key[i], sb.res_attr_sval[i],
                    sb.res_attr_fval[i], sb.res_attr_typ[i])
                    if r_has else {},
            }
            if i in ev_by:
                s["events"] = ev_by[i]
            if i in ln_by:
                s["links"] = ln_by[i]
            out.append(s)
        return out
