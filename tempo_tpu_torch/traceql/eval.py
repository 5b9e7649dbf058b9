"""Vectorized TraceQL evaluation: mask algebra over span columns.

The reference walks spans one at a time through an interpreter
(`pkg/traceql/ast_execute.go`); here every filter expression evaluates over
ALL rows of a column batch at once (numpy ufuncs — and, on the block scan
path, these same masks compile into device kernels). Trace-level semantics
(structural operators, spanset combine, aggregates) then touch only traces
that still have candidate rows.

Type semantics follow the reference lattice (`enum_statics.go`): comparisons
between incomparable types are false, missing attributes never match (except
`= nil`), regex is fully anchored (prometheus FastRegexMatcher semantics,
`pkg/regexp/regexp.go`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Sequence

import numpy as np

from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.conditions import _flip as _flip_op

# column type tags
NUM, STR, BOOL, STATUS, KIND = "num", "str", "bool", "status", "kind"
STRLIST, NUMLIST = "strlist", "numlist"  # per-span lists (events/links): "any element matches"
MIXED = "mixed"  # unscoped attr with different span/resource types (object values)

_STATIC_T = {
    A.StaticType.INT: NUM, A.StaticType.FLOAT: NUM, A.StaticType.DURATION: NUM,
    A.StaticType.STRING: STR, A.StaticType.BOOL: BOOL,
    A.StaticType.STATUS: STATUS, A.StaticType.KIND: KIND,
}


@dataclasses.dataclass
class Col:
    """One evaluated column: typed values + existence mask.

    String columns that originate dictionary- or interner-encoded MAY
    carry their integer codes alongside the materialized values:
    `codes[i]` indexes `code_values` and `str(code_values[codes[i]])`
    equals `values[i].astype("U")` row-for-row. Group factorization
    (`engine_metrics.group_slots`) then runs np.unique over int32 codes
    instead of paying an O(n) per-query object→unicode conversion; every
    other consumer ignores the sidecar fields."""
    t: str
    values: np.ndarray
    exists: np.ndarray
    codes: Optional[np.ndarray] = None        # int32, parallel to values
    code_values: Optional[list] = None        # code id → string

    @staticmethod
    def const(t: str, value, n: int) -> "Col":
        if t == STR:
            v = np.empty(n, object)
            v[:] = value
        elif t == BOOL:
            v = np.full(n, bool(value))
        else:
            v = np.full(n, float(value))
        return Col(t, v, np.ones(n, bool))

    def bool_mask(self) -> np.ndarray:
        """Boolean filter view: missing → false."""
        if self.t == MIXED:
            # object column: rows whose value is a true bool pass
            out = np.zeros(len(self.values), bool)
            for i in np.flatnonzero(self.exists):
                v = self.values[i]
                if isinstance(v, (bool, np.bool_)) and v:
                    out[i] = True
            return out
        if self.t != BOOL:
            return np.zeros(len(self.values), bool)
        return self.values & self.exists


class ColumnView:
    """Span columns for one scan batch (a row group, a WAL block slice, or
    an in-memory spanset) plus trace/tree coordinates.

    Attribute columns are registered under scoped keys ("span.foo",
    "resource.foo") and intrinsics under their names. Lazy resolvers let the
    fetch layer materialize parquet columns only when an expression touches
    them (the pushdown analog of `AllConditions` column pruning).
    """

    def __init__(self, n: int, trace_idx: np.ndarray | None = None):
        self.n = n
        self.trace_idx = trace_idx if trace_idx is not None else np.zeros(n, np.int64)
        self._cols: dict[str, Col] = {}
        self._resolvers: dict[str, Callable[[], Optional[Col]]] = {}
        # tree coordinates (global row indices; -1 = root). Optional: only
        # needed for structural ops / childCount / parent. attrs.
        self.parent_row: np.ndarray | None = None
        self.nested_left: np.ndarray | None = None
        self.nested_right: np.ndarray | None = None
        # identity/meta (search results)
        self.meta: dict[str, np.ndarray] = {}

    def set_col(self, key: str, col: Col) -> None:
        self._cols[key] = col

    def set_resolver(self, key: str, fn: Callable[[], Optional[Col]]) -> None:
        self._resolvers[key] = fn

    def col(self, key: str) -> Optional[Col]:
        c = self._cols.get(key)
        if c is None and key in self._resolvers:
            c = self._resolvers.pop(key)()
            if c is not None:
                self._cols[key] = c
        return c

    def missing(self) -> Col:
        return Col(NUM, np.zeros(self.n), np.zeros(self.n, bool))

    # -- intrinsic helpers --------------------------------------------------

    def child_count(self) -> Col:
        pr = self.parent_row
        if pr is None:
            return self.missing()
        counts = np.bincount(pr[pr >= 0], minlength=self.n).astype(float)
        return Col(NUM, counts, np.ones(self.n, bool))


def static_col(s: A.Static, n: int) -> Col:
    if s.type == A.StaticType.NIL:
        return Col(NUM, np.zeros(n), np.zeros(n, bool))
    t = _STATIC_T[s.type]
    v = s.value
    if t in (STATUS, KIND, NUM):
        v = float(v) if not isinstance(v, bool) else float(v)
    return Col.const(t, v, n)


# ---------------------------------------------------------------------------
# Attribute resolution
# ---------------------------------------------------------------------------

_INTRINSIC_KEYS = {
    A.Intrinsic.DURATION: "duration",
    A.Intrinsic.NAME: "name",
    A.Intrinsic.STATUS: "status",
    A.Intrinsic.STATUS_MESSAGE: "statusMessage",
    A.Intrinsic.KIND: "kind",
    A.Intrinsic.ROOT_NAME: "rootName",
    A.Intrinsic.ROOT_SERVICE: "rootServiceName",
    A.Intrinsic.TRACE_DURATION: "traceDuration",
    A.Intrinsic.NESTED_SET_LEFT: "nestedSetLeft",
    A.Intrinsic.NESTED_SET_RIGHT: "nestedSetRight",
    A.Intrinsic.NESTED_SET_PARENT: "nestedSetParent",
    A.Intrinsic.TRACE_ID: "trace:id",
    A.Intrinsic.SPAN_ID: "span:id",
    A.Intrinsic.PARENT_ID: "span:parentID",
    A.Intrinsic.EVENT_NAME: "event:name",
    A.Intrinsic.EVENT_TIME_SINCE_START: "event:timeSinceStart",
    A.Intrinsic.LINK_TRACE_ID: "link:traceID",
    A.Intrinsic.LINK_SPAN_ID: "link:spanID",
    A.Intrinsic.INSTRUMENTATION_NAME: "instrumentation:name",
    A.Intrinsic.INSTRUMENTATION_VERSION: "instrumentation:version",
    A.Intrinsic.SPAN_START_TIME: "__startTime",
}


def attr_key(a: A.Attribute) -> str:
    """Canonical column key for an attribute (ignoring unscoped fallback)."""
    if a.intrinsic != A.Intrinsic.NONE:
        return _INTRINSIC_KEYS.get(a.intrinsic, a.intrinsic.value)
    scope = a.scope.value or "span"
    return f"{scope}.{a.name}"


def resolve_attr(view: ColumnView, a: A.Attribute) -> Col:
    if a.parent:
        base = A.Attribute(a.name, a.scope, a.intrinsic, parent=False)
        child = resolve_attr(view, base)
        pr = view.parent_row
        if pr is None:
            return view.missing()
        has_parent = pr >= 0
        gather = np.where(has_parent, pr, 0)
        vals = child.values[gather]
        exists = child.exists[gather] & has_parent
        return Col(child.t, vals, exists)
    if a.intrinsic == A.Intrinsic.CHILD_COUNT:
        return view.child_count()
    if a.intrinsic != A.Intrinsic.NONE:
        c = view.col(_INTRINSIC_KEYS.get(a.intrinsic, a.intrinsic.value))
        return c if c is not None else view.missing()
    if a.scope == A.Scope.NONE:
        s = view.col(f"span.{a.name}")
        r = view.col(f"resource.{a.name}")
        if s is None and r is None:
            return view.missing()
        if s is None:
            return r  # type: ignore[return-value]
        if r is None:
            return s
        if s.t == r.t:
            vals = np.where(s.exists, s.values, r.values)
            return Col(s.t, vals, s.exists | r.exists)
        # mixed span/resource types: per-row precedence into an object
        # column; comparisons take the scoped-variant path (_eval_binary)
        vals = np.empty(len(s.values), object)
        vals[r.exists] = r.values[r.exists]
        vals[s.exists] = s.values[s.exists]
        return Col(MIXED, vals, s.exists | r.exists)
    c = view.col(attr_key(a))
    return c if c is not None else view.missing()


# ---------------------------------------------------------------------------
# Expression evaluation
# ---------------------------------------------------------------------------

_REGEX_CACHE: dict[str, "re.Pattern"] = {}


def _regex(pattern: str) -> "re.Pattern":
    p = _REGEX_CACHE.get(pattern)
    if p is None:
        p = _REGEX_CACHE[pattern] = re.compile(pattern)
        if len(_REGEX_CACHE) > 4096:
            _REGEX_CACHE.clear()
    return p


def regex_match_col(values: np.ndarray, exists: np.ndarray,
                    pattern: str) -> np.ndarray:
    """Anchored regex over an object/str column, evaluated once per unique
    value (the memoization in `pkg/regexp/regexp.go` becomes a unique+take)."""
    p = _regex(pattern)
    uniq, inv = np.unique(values.astype(str), return_inverse=True)
    hits = np.fromiter((p.fullmatch(u) is not None for u in uniq),
                       bool, count=len(uniq))
    return hits[inv] & exists


_NUM_LIKE = (NUM, STATUS, KIND)


def _comparable(lt: str, rt: str) -> bool:
    if lt == rt:
        return True
    return False  # status/kind/num are distinct lattices, like the reference


def eval_expr(view: ColumnView, e) -> Col:
    n = view.n
    if isinstance(e, A.Static):
        return static_col(e, n)
    if isinstance(e, A.Attribute):
        return resolve_attr(view, e)
    if isinstance(e, A.UnaryOp):
        inner = eval_expr(view, e.expr)
        if e.op == A.Op.NOT:
            return Col(BOOL, ~inner.bool_mask(), np.ones(n, bool))
        if e.op == A.Op.NEG:
            if inner.t != NUM:
                return view.missing()
            return Col(NUM, -inner.values, inner.exists)
    if isinstance(e, A.BinaryOp):
        return _eval_binary(view, e)
    raise TypeError(f"cannot evaluate {e!r}")


def _eval_binary(view: ColumnView, e: A.BinaryOp) -> Col:
    n = view.n
    op = e.op
    if op == A.Op.AND:
        l, r = eval_expr(view, e.lhs), eval_expr(view, e.rhs)
        return Col(BOOL, l.bool_mask() & r.bool_mask(), np.ones(n, bool))
    if op == A.Op.OR:
        l, r = eval_expr(view, e.lhs), eval_expr(view, e.rhs)
        return Col(BOOL, l.bool_mask() | r.bool_mask(), np.ones(n, bool))

    # nil comparisons (x = nil / x != nil)
    if isinstance(e.rhs, A.Static) and e.rhs.type == A.StaticType.NIL:
        l = eval_expr(view, e.lhs)
        if op == A.Op.EQ:
            return Col(BOOL, ~l.exists, np.ones(n, bool))
        if op == A.Op.NEQ:
            return Col(BOOL, l.exists.copy(), np.ones(n, bool))
        return Col(BOOL, np.zeros(n, bool), np.ones(n, bool))

    l = eval_expr(view, e.lhs)
    r = eval_expr(view, e.rhs)

    if op in (A.Op.REGEX, A.Op.NOT_REGEX):
        if not isinstance(e.rhs, A.Static) or e.rhs.type != A.StaticType.STRING:
            return Col(BOOL, np.zeros(n, bool), np.ones(n, bool))
        pattern = str(e.rhs.value)
        if l.t == STRLIST:
            hits = _strlist_match(l, lambda s: _regex(pattern).fullmatch(s) is not None)
        elif l.t == STR:
            hits = regex_match_col(l.values, l.exists, pattern)
        elif l.t == MIXED:
            p = _regex(pattern)
            hits = np.zeros(n, bool)
            for i in np.flatnonzero(l.exists):
                v = l.values[i]
                if isinstance(v, str) and p.fullmatch(v):
                    hits[i] = True
        else:
            hits = np.zeros(n, bool)
        if op == A.Op.NOT_REGEX:
            hits = ~hits & l.exists
        return Col(BOOL, hits, np.ones(n, bool))

    if op in (A.Op.EQ, A.Op.NEQ, A.Op.GT, A.Op.GTE, A.Op.LT, A.Op.LTE):
        return _compare(n, op, l, r)

    # arithmetic
    if l.t != NUM or r.t != NUM:
        return view.missing()
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        lv, rv = l.values.astype(float), r.values.astype(float)
        if op == A.Op.ADD:
            v = lv + rv
        elif op == A.Op.SUB:
            v = lv - rv
        elif op == A.Op.MULT:
            v = lv * rv
        elif op == A.Op.DIV:
            v = lv / rv
        elif op == A.Op.MOD:
            v = np.mod(lv, rv)
        elif op == A.Op.POW:
            v = lv ** rv
        else:
            raise ValueError(op)
    return Col(NUM, v, l.exists & r.exists)


def _strlist_match(c: Col, pred) -> np.ndarray:
    out = np.zeros(len(c.values), bool)
    for i in np.flatnonzero(c.exists):
        vals = c.values[i]
        if vals is not None and any(pred(str(v)) for v in vals):
            out[i] = True
    return out


_LIST_CMP = {A.Op.EQ: lambda a, b: a == b, A.Op.NEQ: lambda a, b: a != b,
             A.Op.GT: lambda a, b: a > b, A.Op.GTE: lambda a, b: a >= b,
             A.Op.LT: lambda a, b: a < b, A.Op.LTE: lambda a, b: a <= b}

def _py_cmp(op: A.Op, v, rv, rt: str) -> bool:
    if isinstance(v, (bool, np.bool_)):
        ok = rt == BOOL
        v = bool(v)
    elif isinstance(v, (int, float, np.integer, np.floating)):
        ok = rt == NUM
    else:
        ok = rt == STR
        v = str(v)
    if not ok:
        return False
    return bool(_LIST_CMP[op](v, rv))


def _compare(n: int, op: A.Op, l: Col, r: Col) -> Col:
    if r.t == MIXED and l.t != MIXED:
        return _compare(n, _flip_op(op), r, l)
    if l.t == MIXED:
        # per-row typed compare over the object column (mixed-type unscoped
        # attrs are rare; correctness over vectorization here)
        out = np.zeros(n, bool)
        if r.t in (NUM, STR, BOOL):
            for i in np.flatnonzero(l.exists & r.exists):
                out[i] = _py_cmp(op, l.values[i], r.values[i], r.t)
        return Col(BOOL, out, np.ones(n, bool))
    # list columns: "any element matches" (event:name, event:timeSinceStart)
    if l.t == STRLIST and r.t == STR:
        rv0 = r.values[0] if len(r.values) else ""
        if op in (A.Op.EQ, A.Op.NEQ):
            hits = _strlist_match(l, lambda s, f=_LIST_CMP[op]: f(s, rv0))
        else:
            hits = np.zeros(n, bool)
        return Col(BOOL, hits, np.ones(n, bool))
    if l.t == NUMLIST and r.t == NUM:
        rv0 = float(r.values[0]) if len(r.values) else 0.0
        fn = _LIST_CMP[op]
        out = np.zeros(n, bool)
        for i in np.flatnonzero(l.exists):
            vals = l.values[i]
            if vals is not None and any(fn(float(v), rv0) for v in vals):
                out[i] = True
        return Col(BOOL, out, np.ones(n, bool))
    if not _comparable(l.t, r.t):
        return Col(BOOL, np.zeros(n, bool), np.ones(n, bool))
    lv, rv = l.values, r.values
    ok = l.exists & r.exists
    if l.t == STR:
        lv = lv.astype(str)
        rv = rv.astype(str)
    with np.errstate(invalid="ignore"):
        if op == A.Op.EQ:
            v = lv == rv
        elif op == A.Op.NEQ:
            v = lv != rv
        elif op == A.Op.GT:
            v = lv > rv
        elif op == A.Op.GTE:
            v = lv >= rv
        elif op == A.Op.LT:
            v = lv < rv
        else:
            v = lv <= rv
    return Col(BOOL, np.asarray(v, bool) & ok, np.ones(n, bool))


# ---------------------------------------------------------------------------
# Structural operators (nested-set interval algebra)
# ---------------------------------------------------------------------------

def structural_combine(op: A.StructuralOp, view: ColumnView,
                       a_rows: np.ndarray, b_rows: np.ndarray) -> np.ndarray:
    """Row indices (within one trace slice) selected from B given A.

    nested-set containment: ancestor(a,b) ⟺ left[a] < left[b] ∧ right[a] >
    right[b] (`vparquet4/nested_set_model.go`); child via parent_row; sibling
    via parent_row equality. All as broadcast compares — O(|A|·|B|) vector ops
    on trace-sized sets.
    """
    L, R, P = view.nested_left, view.nested_right, view.parent_row
    if L is None or P is None:
        return np.empty(0, np.int64)
    neg = op in (A.StructuralOp.NOT_CHILD, A.StructuralOp.NOT_PARENT,
                 A.StructuralOp.NOT_DESCENDANT, A.StructuralOp.NOT_ANCESTOR,
                 A.StructuralOp.NOT_SIBLING)
    union = op in (A.StructuralOp.UNION_CHILD, A.StructuralOp.UNION_PARENT,
                   A.StructuralOp.UNION_DESCENDANT,
                   A.StructuralOp.UNION_ANCESTOR, A.StructuralOp.UNION_SIBLING)
    base = {
        A.StructuralOp.CHILD: "child", A.StructuralOp.NOT_CHILD: "child",
        A.StructuralOp.UNION_CHILD: "child",
        A.StructuralOp.PARENT: "parent", A.StructuralOp.NOT_PARENT: "parent",
        A.StructuralOp.UNION_PARENT: "parent",
        A.StructuralOp.DESCENDANT: "desc", A.StructuralOp.NOT_DESCENDANT: "desc",
        A.StructuralOp.UNION_DESCENDANT: "desc",
        A.StructuralOp.ANCESTOR: "ance", A.StructuralOp.NOT_ANCESTOR: "ance",
        A.StructuralOp.UNION_ANCESTOR: "ance",
        A.StructuralOp.SIBLING: "sib", A.StructuralOp.NOT_SIBLING: "sib",
        A.StructuralOp.UNION_SIBLING: "sib",
    }[op]

    if len(a_rows) == 0:
        hit_b = np.zeros(len(b_rows), bool)
        hit_a = np.zeros(0, bool)
    elif base == "child":
        hit_b = np.isin(P[b_rows], a_rows)
        hit_a = np.isin(a_rows, P[b_rows]) if union else None
    elif base == "parent":
        hit_b = np.isin(b_rows, P[a_rows])
        hit_a = np.isin(P[a_rows], b_rows) if union else None
    elif base == "desc":
        la, ra = L[a_rows][:, None], R[a_rows][:, None]
        lb, rb = L[b_rows][None, :], R[b_rows][None, :]
        m = (la < lb) & (ra > rb)          # a is ancestor of b
        hit_b = m.any(axis=0)
        hit_a = m.any(axis=1) if union else None
    elif base == "ance":
        la, ra = L[a_rows][:, None], R[a_rows][:, None]
        lb, rb = L[b_rows][None, :], R[b_rows][None, :]
        m = (lb < la) & (rb > ra)          # b is ancestor of a
        hit_b = m.any(axis=0)
        hit_a = m.any(axis=1) if union else None
    else:  # sibling
        pa, pb = P[a_rows][:, None], P[b_rows][None, :]
        m = (pa == pb) & (pa >= 0) & (a_rows[:, None] != b_rows[None, :])
        hit_b = m.any(axis=0)
        hit_a = m.any(axis=1) if union else None

    if neg:
        return b_rows[~hit_b]
    if union:
        out = b_rows[hit_b]
        if hit_a is not None and len(a_rows):
            out = np.union1d(out, a_rows[hit_a])
        return out
    return b_rows[hit_b]


# ---------------------------------------------------------------------------
# Pipeline evaluation over a batch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Spanset:
    trace_key: int              # trace_idx within the batch
    rows: np.ndarray            # global row indices into the view
    group_attrs: tuple = ()     # ((attr_str, value), ...) from by()
    scalars: dict = dataclasses.field(default_factory=dict)  # agg results


def _trace_slices(trace_idx: np.ndarray, candidates: np.ndarray):
    """Yield (trace_key, rows) for candidate rows grouped by trace."""
    if len(candidates) == 0:
        return
    keys = trace_idx[candidates]
    order = np.argsort(keys, kind="stable")
    cand = candidates[order]
    keys = keys[order]
    bounds = np.flatnonzero(np.diff(keys)) + 1
    for chunk in np.split(cand, bounds):
        yield int(trace_idx[chunk[0]]), chunk


def eval_spanset_expr(node, view: ColumnView, trace_rows: np.ndarray,
                      filter_masks: dict) -> np.ndarray:
    """Rows of one trace surviving a spanset expression."""
    if isinstance(node, A.SpansetFilter):
        m = filter_masks[id(node)]
        return trace_rows[m[trace_rows]]
    if isinstance(node, A.StructuralExpr):
        a = eval_spanset_expr(node.lhs, view, trace_rows, filter_masks)
        b = eval_spanset_expr(node.rhs, view, trace_rows, filter_masks)
        return structural_combine(node.op, view, a, b)
    if isinstance(node, A.SpansetCombine):
        a = eval_spanset_expr(node.lhs, view, trace_rows, filter_masks)
        b = eval_spanset_expr(node.rhs, view, trace_rows, filter_masks)
        if node.op == A.SpansetOp.AND:
            if len(a) == 0 or len(b) == 0:
                return np.empty(0, np.int64)
            return np.union1d(a, b)
        return np.union1d(a, b)
    raise TypeError(f"not a spanset expr: {node!r}")


def _collect_filters(node, out: list) -> None:
    if isinstance(node, A.SpansetFilter):
        out.append(node)
    elif isinstance(node, (A.StructuralExpr, A.SpansetCombine)):
        _collect_filters(node.lhs, out)
        _collect_filters(node.rhs, out)


def _agg_value(kind: A.AggregateKind, vals: np.ndarray) -> float:
    if kind == A.AggregateKind.COUNT:
        return float(len(vals))
    if len(vals) == 0:
        return float("nan")
    return {A.AggregateKind.AVG: np.mean, A.AggregateKind.MAX: np.max,
            A.AggregateKind.MIN: np.min, A.AggregateKind.SUM: np.sum}[kind](vals)


def evaluate_pipeline(q: A.Pipeline, view: ColumnView) -> list[Spanset]:
    """Run the spanset pipeline over one batch → surviving spansets."""
    spansets: list[Spanset] | None = None
    for stage in q.stages:
        if isinstance(stage, (A.SpansetFilter, A.StructuralExpr, A.SpansetCombine)):
            filters: list = []
            _collect_filters(stage, filters)
            masks = {id(f): eval_expr(view, f.expr).bool_mask() for f in filters}
            new: list[Spanset] = []
            if spansets is None:
                any_mask = np.zeros(view.n, bool)
                for m in masks.values():
                    any_mask |= m
                # structural ops need the full trace, not just matched rows
                if isinstance(stage, A.SpansetFilter):
                    candidates = np.flatnonzero(any_mask)
                    for key, rows in _trace_slices(view.trace_idx, candidates):
                        new.append(Spanset(key, rows))
                else:
                    # structural ops need the whole trace: one grouped pass
                    # over all rows, visiting only traces with a hit
                    hit_traces = set(np.unique(view.trace_idx[any_mask]).tolist())
                    for key, trace_rows in _trace_slices(view.trace_idx,
                                                         np.arange(view.n)):
                        if key not in hit_traces:
                            continue
                        rows = eval_spanset_expr(stage, view, trace_rows, masks)
                        if len(rows):
                            new.append(Spanset(int(key), rows))
            else:
                for ss in spansets:
                    rows = eval_spanset_expr(stage, view, ss.rows, masks)
                    if len(rows):
                        new.append(dataclasses.replace(ss, rows=rows))
            spansets = new
        elif isinstance(stage, A.ScalarFilter):
            spansets = _apply_scalar_filter(stage, view, _ensure(spansets, view))
        elif isinstance(stage, A.GroupOp):
            spansets = _apply_group(stage, view, _ensure(spansets, view))
        elif isinstance(stage, A.CoalesceOp):
            merged: dict = {}
            for ss in _ensure(spansets, view):
                cur = merged.get(ss.trace_key)
                if cur is None:
                    merged[ss.trace_key] = dataclasses.replace(ss, group_attrs=())
                else:
                    cur.rows = np.union1d(cur.rows, ss.rows)
            spansets = list(merged.values())
        elif isinstance(stage, A.SelectOp):
            for e in stage.attrs:  # force-materialize selected columns
                if isinstance(e, A.Attribute):
                    resolve_attr(view, e)
        else:
            raise TypeError(f"unsupported stage {stage!r}")
    return _ensure(spansets, view)


def _ensure(spansets, view: ColumnView) -> list[Spanset]:
    if spansets is not None:
        return spansets
    # pipeline with no initial filter: every trace, all rows
    out = []
    for key, rows in _trace_slices(view.trace_idx, np.arange(view.n)):
        out.append(Spanset(key, rows))
    return out


def _scalar_operand(side, view: ColumnView, ss: Spanset) -> float:
    if isinstance(side, A.Static):
        return side.as_float()
    if isinstance(side, A.AggregateExpr):
        if side.kind == A.AggregateKind.COUNT:
            return float(len(ss.rows))
        c = eval_expr(view, side.expr)
        vals = c.values[ss.rows][c.exists[ss.rows]]
        return _agg_value(side.kind, vals.astype(float))
    raise TypeError(side)


_CMP_FN = {A.Op.EQ: np.equal, A.Op.NEQ: np.not_equal, A.Op.GT: np.greater,
           A.Op.GTE: np.greater_equal, A.Op.LT: np.less, A.Op.LTE: np.less_equal}


def _apply_scalar_filter(stage: A.ScalarFilter, view, spansets) -> list[Spanset]:
    out = []
    for ss in spansets:
        lv = _scalar_operand(stage.lhs, view, ss)
        rv = _scalar_operand(stage.rhs, view, ss)
        if not (np.isnan(lv) or np.isnan(rv)) and bool(_CMP_FN[stage.op](lv, rv)):
            name = str(stage.lhs)
            ss.scalars[name] = lv
            out.append(ss)
    return out


def _apply_group(stage: A.GroupOp, view, spansets) -> list[Spanset]:
    out = []
    cols = [(str(e), eval_expr(view, e)) for e in stage.by]
    for ss in spansets:
        keys: dict[tuple, list] = {}
        for row in ss.rows:
            kv = []
            skip = False
            for name, c in cols:
                if not c.exists[row]:
                    skip = True
                    break
                kv.append((name, c.values[row]))
            if skip:
                continue
            keys.setdefault(tuple(kv), []).append(row)
        for kv, rows in keys.items():
            out.append(Spanset(ss.trace_key, np.asarray(rows),
                               group_attrs=kv, scalars=dict(ss.scalars)))
    return out
