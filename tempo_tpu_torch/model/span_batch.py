"""SpanBatch: padded structure-of-arrays span tensors.

The reference regroups incoming spans trace-by-trace with per-span Go loops
(`modules/distributor/distributor.go:694-801` `requestsByTraceID`) and walks
spans one at a time in its hot aggregation paths
(`modules/generator/processor/spanmetrics/spanmetrics.go:158` and
`pkg/traceql/engine_metrics.go` `GroupingAggregator.Observe`). On TPU the
unit of work is instead a *batch tensor*: fixed-width numeric columns plus
dictionary-coded attribute id columns, padded to size buckets so jitted
kernels see a small set of static shapes.

Layout (N = padded span count, K/R = padded span/resource attr width):

    trace_id      [N,16] uint8   span_id/parent_span_id [N,8] uint8  (host)
    name_id, service_id, kind, status_code, status_message_id  [N] int32
    start_unix_nano [N] int64 (host) / start_rel_s [N] f32 + base (device)
    duration_ns   [N] f32 device view (int64 host)
    span_attr_{key,sval,typ} [N,K] int32/int32/int8, fval [N,K] f32
    res_attr_{...}           [N,R] likewise
    valid         [N] bool  — padding mask; every kernel threads it through

Attr value typing follows the OTLP AnyValue scalar kinds (string/bool/int/
double); non-scalar values are stringified, as the reference does when it
flattens attributes into parquet columns (vparquet4 `schema.go:253`
`attrToParquet`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from tempo_tpu_torch.model.interner import INVALID_ID, StringInterner

# OTLP span kinds (trace.proto SpanKind).
KIND_UNSPECIFIED, KIND_INTERNAL, KIND_SERVER, KIND_CLIENT, KIND_PRODUCER, KIND_CONSUMER = range(6)
# OTLP status codes (trace.proto Status.StatusCode).
STATUS_UNSET, STATUS_OK, STATUS_ERROR = range(3)

ATTR_NONE, ATTR_STRING, ATTR_BOOL, ATTR_INT, ATTR_DOUBLE = range(5)

_PAD_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072, 262144)
_ATTR_WIDTHS = (0, 4, 8, 16, 32, 64)


def _pad_rows(n: int) -> int:
    for b in _PAD_BUCKETS:
        if n <= b:
            return b
    # beyond the bucket table: round up to the next multiple of the largest bucket
    top = _PAD_BUCKETS[-1]
    return ((n + top - 1) // top) * top


def _pad_width(k: int) -> int:
    for b in _ATTR_WIDTHS:
        if k <= b:
            return b
    return k


def void_keys(*cols: np.ndarray) -> np.ndarray:
    """One opaque fixed-width key per row over [n, w] byte columns.

    Concatenates the columns and reinterprets each row as a single
    `np.void` scalar — the vectorized replacement for per-row
    `tobytes()` concatenation loops (the trace-analytics live-trace
    index). Void rows sort / unique /
    searchsorted byte-lexicographically; `keys[i].item()` yields the
    exact bytes the old per-row concatenation produced, for dict keys
    (numpy 2 void SCALARS are unhashable, their `.item()` bytes are)."""
    mats = [np.asarray(c) for c in cols]
    mat = mats[0] if len(mats) == 1 else np.concatenate(mats, axis=1)
    mat = np.ascontiguousarray(mat)
    return mat.view(np.dtype((np.void, mat.shape[1]))).ravel()


@dataclasses.dataclass
class SpanBatch:
    """Host-resident SoA span batch. `n` real spans, arrays padded beyond."""

    n: int
    trace_id: np.ndarray          # [N,16] u8
    span_id: np.ndarray           # [N,8] u8
    parent_span_id: np.ndarray    # [N,8] u8
    name_id: np.ndarray           # [N] i32
    service_id: np.ndarray        # [N] i32
    kind: np.ndarray              # [N] i32
    status_code: np.ndarray       # [N] i32
    status_message_id: np.ndarray # [N] i32
    start_unix_nano: np.ndarray   # [N] i64
    end_unix_nano: np.ndarray     # [N] i64
    span_attr_key: np.ndarray     # [N,K] i32 (INVALID_ID = empty slot)
    span_attr_sval: np.ndarray    # [N,K] i32
    span_attr_fval: np.ndarray    # [N,K] f32
    span_attr_typ: np.ndarray     # [N,K] i8
    res_attr_key: np.ndarray      # [N,R] i32
    res_attr_sval: np.ndarray     # [N,R] i32
    res_attr_fval: np.ndarray     # [N,R] f32
    res_attr_typ: np.ndarray      # [N,R] i8
    valid: np.ndarray             # [N] bool
    interner: StringInterner

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def duration_ns(self) -> np.ndarray:
        return (self.end_unix_nano - self.start_unix_nano).astype(np.int64)

    def device_view(self) -> dict[str, np.ndarray]:
        """Numeric columns destined for the device, as a plain dict pytree.

        start times are rebased to the batch minimum so float32 holds
        nanosecond-scale offsets losslessly enough for step bucketing.
        """
        base = int(self.start_unix_nano[: self.n].min()) if self.n else 0
        return {
            "name_id": self.name_id,
            "service_id": self.service_id,
            "kind": self.kind,
            "status_code": self.status_code,
            "start_rel_s": ((self.start_unix_nano - base) / 1e9).astype(np.float32),
            "duration_ns": self.duration_ns.astype(np.float32),
            "span_attr_key": self.span_attr_key,
            "span_attr_sval": self.span_attr_sval,
            "span_attr_fval": self.span_attr_fval,
            "res_attr_key": self.res_attr_key,
            "res_attr_sval": self.res_attr_sval,
            "res_attr_fval": self.res_attr_fval,
            "valid": self.valid,
        }, base

    # -- host-side helpers -------------------------------------------------

    def attr_sval_column(self, key: str, scope: str = "span") -> np.ndarray:
        """[N] int32 of interned string values for `key` (INVALID_ID absent).

        The SpanBatch analog of a parquet dedicated attribute column
        (vparquet4 `dedicated_columns.go`): materialize one attribute as a
        dense column for grouping/filtering.
        """
        kid = self.interner.get(key)
        keys, svals = (
            (self.span_attr_key, self.span_attr_sval)
            if scope == "span"
            else (self.res_attr_key, self.res_attr_sval)
        )
        out = np.full(self.capacity, INVALID_ID, np.int32)
        if kid == INVALID_ID or keys.shape[1] == 0:
            return out
        hit = keys == kid  # [N,K]
        has = hit.any(axis=1)
        idx = hit.argmax(axis=1)
        out[has] = svals[np.arange(self.capacity), idx][has]
        return out

    def take_rows(self, rows: np.ndarray) -> "SpanBatch":
        """Row-gathered copy of `rows` (indices into [0, n)), re-padded to
        the bucket table. The materialization step of a tee VIEW: every
        column gathers from the shared arrays — no wire re-decode, no
        re-serialization. Full-coverage callers should skip this entirely
        and use the shared batch (see `otlp_batch.StagedView`)."""
        rows = np.asarray(rows, np.int64)
        n = len(rows)
        cap = _pad_rows(max(n, 1))
        pad = cap - n

        def g1(a, fill=0):
            out = np.full(cap, fill, a.dtype) if pad else np.empty(cap, a.dtype)
            out[:n] = a[rows]
            return out

        def g2(a, fill=0):
            out = (np.full((cap, a.shape[1]), fill, a.dtype) if pad
                   else np.empty((cap, a.shape[1]), a.dtype))
            out[:n] = a[rows]
            return out

        valid = np.zeros(cap, bool)
        valid[:n] = self.valid[rows]
        return SpanBatch(
            n=n,
            trace_id=g2(self.trace_id), span_id=g2(self.span_id),
            parent_span_id=g2(self.parent_span_id),
            name_id=g1(self.name_id, INVALID_ID),
            service_id=g1(self.service_id, INVALID_ID),
            kind=g1(self.kind), status_code=g1(self.status_code),
            status_message_id=g1(self.status_message_id, INVALID_ID),
            start_unix_nano=g1(self.start_unix_nano),
            end_unix_nano=g1(self.end_unix_nano),
            span_attr_key=g2(self.span_attr_key, INVALID_ID),
            span_attr_sval=g2(self.span_attr_sval, INVALID_ID),
            span_attr_fval=g2(self.span_attr_fval),
            span_attr_typ=g2(self.span_attr_typ),
            res_attr_key=g2(self.res_attr_key, INVALID_ID),
            res_attr_sval=g2(self.res_attr_sval, INVALID_ID),
            res_attr_fval=g2(self.res_attr_fval),
            res_attr_typ=g2(self.res_attr_typ),
            valid=valid, interner=self.interner,
        )

    def to_span_dicts(self, rows: "np.ndarray | None" = None) -> list[dict]:
        """Valid rows as flat span dicts (the WAL/storage span form).

        The bridge from the device-friendly SoA back to durable storage —
        used by the localblocks processor, whose job is persistence
        (`modules/generator/processor/localblocks/processor.go:151`) and
        by the ingester's staged-view push. `rows` restricts the
        conversion to a view's row subset (order preserved)."""
        it = self.interner
        out = []
        k_has = self.span_attr_key.shape[1] > 0
        r_has = self.res_attr_key.shape[1] > 0
        if rows is None:
            rows = np.flatnonzero(self.valid[: self.n])
        else:
            rows = np.asarray(rows, np.int64)
            rows = rows[self.valid[rows]]
        for i in rows:
            s: dict = {
                "trace_id": self.trace_id[i].tobytes(),
                "span_id": self.span_id[i].tobytes(),
                "parent_span_id": self.parent_span_id[i].tobytes(),
                "name": it.lookup(int(self.name_id[i])),
                "service": it.lookup(int(self.service_id[i])),
                "kind": int(self.kind[i]),
                "status_code": int(self.status_code[i]),
                "start_unix_nano": int(self.start_unix_nano[i]),
                "end_unix_nano": int(self.end_unix_nano[i]),
            }
            if int(self.status_message_id[i]) != INVALID_ID:
                s["status_message"] = it.lookup(int(self.status_message_id[i]))
            if k_has:
                a = self._decode_attrs(self.span_attr_key[i], self.span_attr_sval[i],
                                       self.span_attr_fval[i], self.span_attr_typ[i])
                if a:
                    s["attrs"] = a
            if r_has:
                a = self._decode_attrs(self.res_attr_key[i], self.res_attr_sval[i],
                                       self.res_attr_fval[i], self.res_attr_typ[i])
                if a:
                    s["res_attrs"] = a
            out.append(s)
        return out

    def _decode_attrs(self, keys, svals, fvals, typs) -> dict:
        it = self.interner
        out = {}
        for j in range(len(keys)):
            kid = int(keys[j])
            if kid == INVALID_ID:
                continue
            t = int(typs[j])
            if t == ATTR_STRING:
                out[it.lookup(kid)] = it.lookup(int(svals[j]))
            elif t == ATTR_BOOL:
                out[it.lookup(kid)] = bool(fvals[j])
            elif t == ATTR_INT:
                out[it.lookup(kid)] = int(fvals[j])
            elif t == ATTR_DOUBLE:
                out[it.lookup(kid)] = float(fvals[j])
        return out

    def tid_hash64(self) -> tuple[np.ndarray, np.ndarray]:
        """Two uint32 trace-id hash columns (device grouping / HLL keys)."""
        v = self.trace_id.view(np.uint32).reshape(self.capacity, 4)
        return (v[:, 0] ^ v[:, 2], v[:, 1] ^ v[:, 3])


class SpanBatchBuilder:
    """Row-append builder producing padded SpanBatches.

    The write-path staging area: receivers append decoded spans, services cut
    a batch per push (distributor) or per tick (generator), analogous to the
    rebatching in `requestsByTraceID` but emitting tensors instead of
    per-trace proto slices.
    """

    def __init__(self, interner: StringInterner | None = None,
                 max_span_attrs: int = 64, max_res_attrs: int = 32) -> None:
        self.interner = interner if interner is not None else StringInterner()
        self.max_span_attrs = max_span_attrs
        self.max_res_attrs = max_res_attrs
        self._rows: list[tuple] = []

    def __len__(self) -> int:
        return len(self._rows)

    def _code_attrs(self, attrs: dict[str, Any] | None, cap: int):
        out = []
        if attrs:
            it = self.interner
            for k, v in attrs.items():
                if len(out) >= cap:
                    break  # truncation, like distributor attr limits
                kid = it.intern(k)
                if isinstance(v, bool):
                    out.append((kid, INVALID_ID, 1.0 if v else 0.0, ATTR_BOOL))
                elif isinstance(v, (int, np.integer)):
                    out.append((kid, INVALID_ID, float(v), ATTR_INT))
                elif isinstance(v, (float, np.floating)):
                    out.append((kid, INVALID_ID, float(v), ATTR_DOUBLE))
                else:
                    out.append((kid, it.intern(str(v)), 0.0, ATTR_STRING))
        return out

    def append(
        self,
        *,
        trace_id: bytes,
        span_id: bytes,
        parent_span_id: bytes = b"",
        name: str = "",
        service: str = "",
        kind: int = KIND_UNSPECIFIED,
        status_code: int = STATUS_UNSET,
        status_message: str = "",
        start_unix_nano: int = 0,
        end_unix_nano: int = 0,
        attrs: dict[str, Any] | None = None,
        res_attrs: dict[str, Any] | None = None,
        events: list | None = None,   # accepted, not columnized: SpanBatch
        links: list | None = None,    # is the metrics plane; the block
    ) -> None:                        # schema persists events/links
        it = self.interner
        self._rows.append((
            trace_id.ljust(16, b"\0")[:16],
            span_id.ljust(8, b"\0")[:8],
            parent_span_id.ljust(8, b"\0")[:8],
            it.intern(name),
            it.intern(service),
            kind,
            status_code,
            it.intern(status_message) if status_message else INVALID_ID,
            start_unix_nano,
            end_unix_nano,
            self._code_attrs(attrs, self.max_span_attrs),
            self._code_attrs(res_attrs, self.max_res_attrs),
        ))

    def build(self) -> SpanBatch:
        rows = self._rows
        self._rows = []
        n = len(rows)
        cap = _pad_rows(max(n, 1))
        k = _pad_width(max((len(r[10]) for r in rows), default=0))
        r_ = _pad_width(max((len(r[11]) for r in rows), default=0))

        def attr_mats(col: int, width: int):
            key = np.full((cap, width), INVALID_ID, np.int32)
            sval = np.full((cap, width), INVALID_ID, np.int32)
            fval = np.zeros((cap, width), np.float32)
            typ = np.zeros((cap, width), np.int8)
            for i, row in enumerate(rows):
                for j, (kk, sv, fv, tt) in enumerate(row[col]):
                    key[i, j], sval[i, j], fval[i, j], typ[i, j] = kk, sv, fv, tt
            return key, sval, fval, typ

        sk, ss, sf, st = attr_mats(10, k)
        rk, rs, rf, rt = attr_mats(11, r_)
        u8 = lambda col, w: np.frombuffer(
            b"".join(r[col] for r in rows) or b"", dtype=np.uint8
        ).reshape(n, w) if n else np.zeros((0, w), np.uint8)

        def pad2(a, w):
            out = np.zeros((cap, w), np.uint8)
            out[:n] = a
            return out

        i32 = lambda col: np.pad(np.array([r[col] for r in rows], np.int32), (0, cap - n))
        i64 = lambda col: np.pad(np.array([r[col] for r in rows], np.int64), (0, cap - n))
        valid = np.zeros(cap, bool)
        valid[:n] = True
        return SpanBatch(
            n=n,
            trace_id=pad2(u8(0, 16), 16),
            span_id=pad2(u8(1, 8), 8),
            parent_span_id=pad2(u8(2, 8), 8),
            name_id=i32(3), service_id=i32(4), kind=i32(5),
            status_code=i32(6), status_message_id=i32(7),
            start_unix_nano=i64(8), end_unix_nano=i64(9),
            span_attr_key=sk, span_attr_sval=ss, span_attr_fval=sf, span_attr_typ=st,
            res_attr_key=rk, res_attr_sval=rs, res_attr_fval=rf, res_attr_typ=rt,
            valid=valid,
            interner=self.interner,
        )


def synthetic_batch(
    n: int,
    *,
    interner: StringInterner | None = None,
    n_services: int = 10,
    n_names: int = 50,
    error_rate: float = 0.02,
    seed: int = 0,
) -> SpanBatch:
    """Fast vectorized synthetic batch for tests and benches (k6-style load)."""
    rng = np.random.default_rng(seed)
    it = interner if interner is not None else StringInterner()
    svc_ids = it.intern_many([f"service-{i}" for i in range(n_services)])
    name_ids = it.intern_many([f"op-{i}" for i in range(n_names)])
    cap = _pad_rows(max(n, 1))
    valid = np.zeros(cap, bool)
    valid[:n] = True
    start = np.zeros(cap, np.int64)
    start[:n] = 1_700_000_000_000_000_000 + rng.integers(0, 60_000_000_000, n)
    dur = np.zeros(cap, np.int64)
    dur[:n] = rng.lognormal(mean=17.0, sigma=1.5, size=n).astype(np.int64)  # ~24ms median
    e = np.zeros((cap, 0))
    return SpanBatch(
        n=n,
        trace_id=rng.integers(0, 256, (cap, 16), dtype=np.uint8),
        span_id=rng.integers(0, 256, (cap, 8), dtype=np.uint8),
        parent_span_id=np.zeros((cap, 8), np.uint8),
        name_id=np.where(valid, name_ids[rng.integers(0, n_names, cap)], 0).astype(np.int32),
        service_id=np.where(valid, svc_ids[rng.integers(0, n_services, cap)], 0).astype(np.int32),
        kind=np.full(cap, KIND_SERVER, np.int32),
        status_code=np.where(rng.random(cap) < error_rate, STATUS_ERROR, STATUS_UNSET).astype(np.int32),
        status_message_id=np.full(cap, INVALID_ID, np.int32),
        start_unix_nano=start,
        end_unix_nano=start + dur,
        span_attr_key=np.zeros((cap, 0), np.int32),
        span_attr_sval=np.zeros((cap, 0), np.int32),
        span_attr_fval=np.zeros((cap, 0), np.float32),
        span_attr_typ=np.zeros((cap, 0), np.int8),
        res_attr_key=np.zeros((cap, 0), np.int32),
        res_attr_sval=np.zeros((cap, 0), np.int32),
        res_attr_fval=np.zeros((cap, 0), np.float32),
        res_attr_typ=np.zeros((cap, 0), np.int8),
        valid=valid,
        interner=it,
    )
