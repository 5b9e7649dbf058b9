"""ColumnView over a SpanBatch — the matview appender's ingest-side view.

Counterpart of `tempo_tpu/matview/batchview.py`, host numpy over the
port's `traceql/eval.py` and `model/span_batch.py`. The recompute path evaluates TraceQL over views built from stored spans
(`traceql/memview.py view_from_traces`, block scans); the materializer
evaluates the SAME expressions over the ingest batch *before* it is
stored. This module builds that view straight from the SpanBatch SoA
columns — vectorized id→string decodes, lazy per-attribute resolvers,
no per-span dicts — so a 4k-span batch costs a handful of numpy ops,
not 4k dict materializations.

Trace-structural coordinates (nested set, parent rows, roots) are NOT
available on a single ingest batch (a trace's spans arrive across many
batches), so queries needing them are refused at subscribe time
(`matview.materializer.query_supported`) and never reach this view.
Label formatting and type mapping mirror `view_from_traces` exactly —
the bit-identity contract of the materialized tier depends on both
views minting identical group keys.
"""

from __future__ import annotations

import numpy as np

from tempo_tpu_torch.model.interner import INVALID_ID
from tempo_tpu_torch.model.span_batch import (ATTR_BOOL, ATTR_DOUBLE,
                                              ATTR_INT, ATTR_STRING,
                                              SpanBatch)
from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.eval import (BOOL, KIND, NUM, STATUS, STR,
                                          Col, ColumnView)


def _decode_ids_coded(interner, ids: np.ndarray):
    """[n] int32 interned ids → (values, codes, code_values): object
    strings plus the dictionary view (codes int32 into code_values,
    INVALID_ID → ""). The dictionary rides the Col so `group_slots`
    takes its code fast path instead of re-uniquing strings per view."""
    uniq, inv = np.unique(ids, return_inverse=True)
    strs = np.empty(len(uniq), object)
    for i, sid in enumerate(uniq.tolist()):
        strs[i] = "" if sid == INVALID_ID else interner.lookup(int(sid))
    return strs[inv], inv.astype(np.int32), strs.tolist()


def _decode_ids(interner, ids: np.ndarray) -> np.ndarray:
    """[n] int32 interned ids → [n] object strings (INVALID_ID → "")."""
    return _decode_ids_coded(interner, ids)[0]


def _hex_rows(b: np.ndarray) -> np.ndarray:
    out = np.empty(len(b), object)
    for i in range(len(b)):
        out[i] = b[i].tobytes().hex()
    return out


def _attr_resolver(interner, keys, svals, fvals, typs, kid):
    """Lazy Col builder for one attribute key over [n, K] attr matrices.
    First-seen type wins, like `view_from_traces`'s mixed-type rule."""

    def build():
        hit = keys == kid                         # [n, K]
        has = hit.any(axis=1)
        j = hit.argmax(axis=1)
        rows = np.flatnonzero(has)
        if len(rows) == 0:
            return None
        t0 = int(typs[rows[0], j[rows[0]]])
        n = keys.shape[0]
        if t0 == ATTR_STRING:
            vals = np.empty(n, object)
            sel = svals[rows, j[rows]]
            tmask = typs[rows, j[rows]] == ATTR_STRING
            vals[rows[tmask]] = _decode_ids(interner, sel[tmask])
            exists = np.zeros(n, bool)
            exists[rows[tmask]] = True
            return Col(STR, vals, exists)
        if t0 == ATTR_BOOL:
            vals = np.zeros(n, bool)
            tmask = typs[rows, j[rows]] == ATTR_BOOL
            vals[rows[tmask]] = fvals[rows, j[rows]][tmask] != 0
            exists = np.zeros(n, bool)
            exists[rows[tmask]] = True
            return Col(BOOL, vals, exists)
        vals = np.zeros(n)
        tmask = np.isin(typs[rows, j[rows]], (ATTR_INT, ATTR_DOUBLE))
        vals[rows[tmask]] = fvals[rows, j[rows]][tmask]
        exists = np.zeros(n, bool)
        exists[rows[tmask]] = True
        return Col(NUM, vals, exists)

    return build


def view_from_span_batch(sb: SpanBatch) -> ColumnView:
    """Valid rows of a SpanBatch as a ColumnView (intrinsics + lazy
    span./resource. attribute columns)."""
    rows = np.flatnonzero(sb.valid[: sb.n])
    n = len(rows)
    view = ColumnView(n)
    it = sb.interner
    ones = np.ones(n, bool)

    start = sb.start_unix_nano[rows].astype(np.int64)
    end = sb.end_unix_nano[rows].astype(np.int64)
    view.set_col("__startTime", Col(NUM, start.astype(np.float64), ones))
    # the difference in int64, as `view_from_traces` takes it: a float64
    # difference of two epoch-ns timestamps rounds to their 256 ns spacing
    view.set_col("duration", Col(NUM, np.maximum(end - start, 0).astype(
        np.float64), ones))
    nvals, ncodes, ndict = _decode_ids_coded(it, sb.name_id[rows])
    view.set_col("name", Col(STR, nvals, ones,
                             codes=ncodes, code_values=ndict))
    svals_, scodes, sdict = _decode_ids_coded(it, sb.service_id[rows])
    view.set_col("resource.service.name",
                 Col(STR, svals_, ones, codes=scodes, code_values=sdict))
    # OTLP wire status → traceql enum, vectorized (0/1/2 → unset/ok/error)
    sc = sb.status_code[rows]
    status = np.full(n, float(A.STATUS_UNSET))
    status[sc == 1] = float(A.STATUS_OK)
    status[sc == 2] = float(A.STATUS_ERROR)
    view.set_col("status", Col(STATUS, status, ones))
    mvals, mcodes, mdict = _decode_ids_coded(it, sb.status_message_id[rows])
    view.set_col("statusMessage",
                 Col(STR, mvals, ones, codes=mcodes, code_values=mdict))
    view.set_col("kind", Col(KIND, sb.kind[rows].astype(np.float64), ones))
    view.set_resolver("trace:id", lambda: Col(
        STR, _hex_rows(sb.trace_id[rows]), np.ones(n, bool)))
    view.set_resolver("span:id", lambda: Col(
        STR, _hex_rows(sb.span_id[rows]), np.ones(n, bool)))
    view.set_resolver("span:parentID", lambda: Col(
        STR, _hex_rows(sb.parent_span_id[rows]), np.ones(n, bool)))

    for scope, keys, svals, fvals, typs in (
            ("span", sb.span_attr_key[rows], sb.span_attr_sval[rows],
             sb.span_attr_fval[rows], sb.span_attr_typ[rows]),
            ("resource", sb.res_attr_key[rows], sb.res_attr_sval[rows],
             sb.res_attr_fval[rows], sb.res_attr_typ[rows])):
        if keys.shape[1] == 0:
            continue
        for kid in np.unique(keys).tolist():
            if kid == INVALID_ID:
                continue
            key = f"{scope}.{it.lookup(int(kid))}"
            if key == "resource.service.name":
                continue          # intrinsic service column wins
            view.set_resolver(key, _attr_resolver(
                it, keys, svals, fvals, typs, kid))
    return view


__all__ = ["view_from_span_batch"]
