"""Condition pushdown: AST → FetchSpansRequest (reference
`pkg/traceql/ast_conditions.go`, `storage.go`).

The fetch layer receives a flat list of per-attribute predicates plus the
`all_conditions` flag: when True every condition must hold on a span for it
to be a candidate (pure AND tree → storage can intersect masks and skip the
second pass for simple queries); when False conditions are hints (OR
semantics) and the engine's second pass decides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tempo_tpu_torch.traceql import ast as A


@dataclasses.dataclass(frozen=True)
class Condition:
    attr: A.Attribute
    op: Optional[A.Op] = None        # None = fetch the column only (select)
    operands: tuple = ()             # tuple[Static]
    # True when this fetch-only condition came from a filter expression the
    # storage layer can't evaluate (negation / cross-attribute compare): the
    # prefilter must not exclude rows based on sibling predicates then
    from_filter: bool = False

    def __str__(self) -> str:
        ops = ",".join(str(o) for o in self.operands)
        return f"{self.attr}{'' if self.op is None else self.op.value}{ops}"


@dataclasses.dataclass
class FetchSpansRequest:
    conditions: list
    all_conditions: bool
    start_ns: int = 0
    end_ns: int = 0
    second_pass_conditions: list = dataclasses.field(default_factory=list)
    # True when some pipeline arm matches spans unconditionally (`{ }` in an
    # OR, rhs of a structural op, ...): the storage prefilter must pass every
    # row through, since any span may participate in the second pass
    has_unconditioned_arm: bool = False
    # True when the single filter stage is a pure OR-tree whose every leaf
    # pushed down: the OR of the per-condition masks is then EXACT (not a
    # hint superset), so the fused metrics plane may serve the query even
    # though all_conditions is False (round 5)
    pure_disjunction: bool = False

    def add(self, c: Condition) -> None:
        if c not in self.conditions:
            self.conditions.append(c)


_ALWAYS_SECOND_PASS = {A.Op.NOT}  # negations can't prune at storage


def _pushable_compare(e) -> "tuple | None":
    """(attr, op, static) when `e` is a storage-pushable compare
    (attribute <op> literal, either side order) — the single source of
    pushability shared by the extractor and the pure-disjunction check,
    so the two can never disagree on what 'pushed' means."""
    if not isinstance(e, A.BinaryOp):
        return None
    lhs, rhs, op = e.lhs, e.rhs, e.op
    if isinstance(rhs, A.Attribute) and isinstance(lhs, A.Static):
        lhs, rhs = rhs, lhs
        op = _flip(op)
    if isinstance(lhs, A.Attribute) and isinstance(rhs, A.Static) and \
            op in (A.Op.EQ, A.Op.NEQ, A.Op.REGEX, A.Op.NOT_REGEX,
                   A.Op.GT, A.Op.GTE, A.Op.LT, A.Op.LTE):
        return lhs, op, rhs
    return None


def _is_pure_disjunction(e) -> bool:
    """True when `e` is an OR-tree whose EVERY leaf is itself a single
    pushable compare — the structural guarantee that the OR of the pushed
    masks equals the filter exactly. A count heuristic is NOT enough: an
    AND leaf can push net-one condition via dedup, or a boolean literal
    can push nothing, silently turning the mask into a superset."""
    if not (isinstance(e, A.BinaryOp) and e.op == A.Op.OR):
        return False

    def ok(x) -> bool:
        if isinstance(x, A.BinaryOp) and x.op == A.Op.OR:
            return ok(x.lhs) and ok(x.rhs)
        return _pushable_compare(x) is not None

    return ok(e)


def extract_conditions(q: A.Pipeline, start_ns: int = 0,
                       end_ns: int = 0) -> FetchSpansRequest:
    req = FetchSpansRequest(conditions=[], all_conditions=True,
                            start_ns=start_ns, end_ns=end_ns)
    # all_conditions only survives a single-filter pipeline with a pure AND
    # tree (ast_conditions.go SpansetFilter.extractConditions)
    filters = [s for s in q.stages if isinstance(s, A.SpansetFilter)]
    non_filters = [s for s in q.stages if not isinstance(s, A.SpansetFilter)]
    structural = any(isinstance(s, (A.StructuralExpr, A.SpansetCombine))
                     for s in q.stages)
    if len(filters) != 1 or structural:
        req.all_conditions = False
    for stage in q.stages:
        before = len(req.conditions)
        _extract_stage(stage, req)
        if isinstance(stage, A.SpansetFilter) and len(filters) == 1 \
                and not structural and _is_pure_disjunction(stage.expr):
            # structurally verified: every OR leaf is ONE pushable
            # compare, so the OR of the pushed masks IS the filter
            assert any(c.op is not None for c in req.conditions[before:])
            req.pure_disjunction = True
    if q.metrics is not None:
        if q.metrics.attr is not None:
            _collect_columns(q.metrics.attr, req)
        for e in q.metrics.by:
            _collect_columns(e, req)
        if q.metrics.compare_filter is not None:
            _collect_columns(q.metrics.compare_filter, req)
        # metrics need span start time for step bucketing
        req.add(Condition(A.Attribute.intrinsic_of(A.Intrinsic.SPAN_START_TIME)))
    # aggregates/scalar filters pull their referenced columns too
    for s in non_filters:
        if isinstance(s, A.ScalarFilter):
            for side in (s.lhs, s.rhs):
                if isinstance(side, A.AggregateExpr) and side.expr is not None:
                    _collect_columns(side.expr, req)
        elif isinstance(s, (A.GroupOp,)):
            for e in s.by:
                _collect_columns(e, req)
        elif isinstance(s, A.SelectOp):
            for e in s.attrs:
                _collect_columns(e, req)
    return req


def _extract_stage(stage, req: FetchSpansRequest) -> None:
    if isinstance(stage, A.SpansetFilter):
        before = len(req.conditions)
        _extract_expr(stage.expr, req, top_level=True)
        pushed = any(c.op is not None for c in req.conditions[before:])
        if not pushed:
            req.has_unconditioned_arm = True
    elif isinstance(stage, (A.StructuralExpr, A.SpansetCombine)):
        _extract_stage(stage.lhs, req)
        _extract_stage(stage.rhs, req)


def _extract_expr(e, req: FetchSpansRequest, top_level: bool = False) -> None:
    """Walk a boolean field expression, emitting Conditions.

    AND keeps all_conditions; OR flips it off (conditions become hints);
    anything non-extractable (cross-attribute compare, arithmetic) also
    clears the flag but still registers column fetches.
    """
    if isinstance(e, A.Static):
        # a literal `true` is an AND-identity (and a bare `{ true }` arm
        # registers via has_unconditioned_arm); anything else — `false`,
        # or a non-boolean literal — cannot be expressed as a pushed-down
        # condition, so the condition set is no longer exhaustive: clear
        # all_conditions to force the engine's exact second pass (and the
        # fused-metrics gate off) instead of silently matching everything
        if not (getattr(e, "type", None) == A.StaticType.BOOL
                and e.value is True):
            req.all_conditions = False
        return
    if isinstance(e, A.BinaryOp):
        if e.op == A.Op.AND:
            _extract_expr(e.lhs, req, top_level)
            _extract_expr(e.rhs, req, top_level)
            return
        if e.op == A.Op.OR:
            req.all_conditions = False
            _extract_expr(e.lhs, req)
            _extract_expr(e.rhs, req)
            return
        # comparison attr <op> static (either side)
        got = _pushable_compare(e)
        if got is not None:
            attr, op, static = got
            req.add(Condition(attr, op, (static,)))
            return
        # non-pushable comparison: fetch referenced columns, clear the flag
        req.all_conditions = False
        _collect_columns(e.lhs, req, from_filter=True)
        _collect_columns(e.rhs, req, from_filter=True)
        return
    if isinstance(e, A.UnaryOp):
        req.all_conditions = False
        _collect_columns(e.expr, req, from_filter=True)
        return
    if isinstance(e, A.Attribute):
        # bare boolean attribute `{ .error }`
        req.add(Condition(e, A.Op.EQ, (A.Static(A.StaticType.BOOL, True),)))
        return


def _collect_columns(e, req: FetchSpansRequest, from_filter: bool = False) -> None:
    if isinstance(e, A.Attribute):
        req.add(Condition(e, from_filter=from_filter))
    elif isinstance(e, A.BinaryOp):
        _collect_columns(e.lhs, req, from_filter)
        _collect_columns(e.rhs, req, from_filter)
    elif isinstance(e, A.UnaryOp):
        _collect_columns(e.expr, req, from_filter)


def _flip(op: A.Op) -> A.Op:
    return {A.Op.GT: A.Op.LT, A.Op.GTE: A.Op.LTE,
            A.Op.LT: A.Op.GT, A.Op.LTE: A.Op.GTE}.get(op, op)
