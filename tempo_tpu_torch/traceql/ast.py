"""TraceQL AST: statics with the type lattice, attributes, expressions,
pipeline stages (reference `pkg/traceql/ast.go`, `enum_attributes.go`,
`enum_operators.go`, `enum_statics.go`).

Nodes are frozen dataclasses; `str()` round-trips to valid TraceQL (the
stringer used by sharders to re-serialize sub-queries, like the reference's
`stringer.go`).
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Optional, Sequence, Union


# ---------------------------------------------------------------------------
# Static value types (enum_statics.go type lattice)
# ---------------------------------------------------------------------------

class StaticType(enum.Enum):
    NIL = "nil"
    INT = "int"
    FLOAT = "float"
    STRING = "string"
    BOOL = "bool"
    DURATION = "duration"   # nanoseconds, int-valued
    STATUS = "status"       # 0=error 1=ok 2=unset (reference enum order)
    KIND = "kind"

    def is_numeric(self) -> bool:
        return self in (StaticType.INT, StaticType.FLOAT, StaticType.DURATION)

    def comparable_with(self, other: "StaticType") -> bool:
        if self == other:
            return True
        return self.is_numeric() and other.is_numeric()


# Status enum values follow the reference (`enum_statics.go`: error=0, ok=1,
# unset=2 — NOT otlp order) so cross-shard proto payloads compare equal.
STATUS_ERROR, STATUS_OK, STATUS_UNSET = 0, 1, 2
STATUS_NAMES = {STATUS_ERROR: "error", STATUS_OK: "ok", STATUS_UNSET: "unset"}
KIND_NAMES = {0: "unspecified", 1: "internal", 2: "server", 3: "client",
              4: "producer", 5: "consumer"}
# OTLP wire order (trace.proto Status.StatusCode) → traceql order
OTLP_STATUS_TO_TRACEQL = {0: STATUS_UNSET, 1: STATUS_OK, 2: STATUS_ERROR}


@dataclasses.dataclass(frozen=True)
class Static:
    type: StaticType
    value: object = None

    @staticmethod
    def nil() -> "Static":
        return Static(StaticType.NIL, None)

    @staticmethod
    def of(v) -> "Static":
        if v is None:
            return Static.nil()
        if isinstance(v, bool):
            return Static(StaticType.BOOL, v)
        if isinstance(v, int):
            return Static(StaticType.INT, v)
        if isinstance(v, float):
            return Static(StaticType.FLOAT, v)
        if isinstance(v, str):
            return Static(StaticType.STRING, v)
        raise TypeError(f"no static type for {v!r}")

    def as_float(self) -> float:
        if self.type == StaticType.NIL:
            return float("nan")
        if self.type == StaticType.BOOL:
            return 1.0 if self.value else 0.0
        return float(self.value)

    def __str__(self) -> str:
        t, v = self.type, self.value
        if t == StaticType.NIL:
            return "nil"
        if t == StaticType.STRING:
            return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'
        if t == StaticType.BOOL:
            return "true" if v else "false"
        if t == StaticType.DURATION:
            return format_duration(int(v))
        if t == StaticType.STATUS:
            return STATUS_NAMES.get(int(v), "unset")
        if t == StaticType.KIND:
            return KIND_NAMES.get(int(v), "unspecified")
        return repr(v) if t == StaticType.FLOAT else str(v)


def format_duration(ns: int) -> str:
    for unit, scale in (("h", 3_600_000_000_000), ("m", 60_000_000_000),
                        ("s", 1_000_000_000), ("ms", 1_000_000), ("us", 1_000)):
        if ns >= scale and ns % scale == 0:
            return f"{ns // scale}{unit}"
    return f"{ns}ns"


# ---------------------------------------------------------------------------
# Attributes: scopes + intrinsics (enum_attributes.go)
# ---------------------------------------------------------------------------

class Scope(enum.Enum):
    NONE = ""            # unscoped `.attr` — resolves span then resource
    SPAN = "span"
    RESOURCE = "resource"
    PARENT = "parent"
    EVENT = "event"
    LINK = "link"
    INSTRUMENTATION = "instrumentation"


class Intrinsic(enum.Enum):
    NONE = ""
    DURATION = "duration"
    NAME = "name"
    STATUS = "status"
    STATUS_MESSAGE = "statusMessage"
    KIND = "kind"
    CHILD_COUNT = "childCount"
    ROOT_NAME = "rootName"
    ROOT_SERVICE = "rootServiceName"
    TRACE_DURATION = "traceDuration"
    NESTED_SET_LEFT = "nestedSetLeft"
    NESTED_SET_RIGHT = "nestedSetRight"
    NESTED_SET_PARENT = "nestedSetParent"
    TRACE_ID = "trace:id"
    SPAN_ID = "span:id"
    PARENT_ID = "span:parentID"
    EVENT_NAME = "event:name"
    EVENT_TIME_SINCE_START = "event:timeSinceStart"
    LINK_TRACE_ID = "link:traceID"
    LINK_SPAN_ID = "link:spanID"
    INSTRUMENTATION_NAME = "instrumentation:name"
    INSTRUMENTATION_VERSION = "instrumentation:version"
    # fetch-layer-only intrinsics (IntrinsicSpanStartTime — not parseable)
    SPAN_START_TIME = "__spanStartTime"
    # structural capabilities (resolved by the fetch layer)
    STRUCTURAL_DESCENDANT = "__descendant"
    STRUCTURAL_CHILD = "__child"
    STRUCTURAL_SIBLING = "__sibling"


# keyword → intrinsic for bare identifiers inside filters
INTRINSIC_KEYWORDS = {
    "duration": Intrinsic.DURATION,
    "name": Intrinsic.NAME,
    "status": Intrinsic.STATUS,
    "statusMessage": Intrinsic.STATUS_MESSAGE,
    "kind": Intrinsic.KIND,
    "childCount": Intrinsic.CHILD_COUNT,
    "rootName": Intrinsic.ROOT_NAME,
    "rootServiceName": Intrinsic.ROOT_SERVICE,
    "rootService": Intrinsic.ROOT_SERVICE,
    "traceDuration": Intrinsic.TRACE_DURATION,
    "nestedSetLeft": Intrinsic.NESTED_SET_LEFT,
    "nestedSetRight": Intrinsic.NESTED_SET_RIGHT,
    "nestedSetParent": Intrinsic.NESTED_SET_PARENT,
}

# "<scope>:<name>" scoped intrinsics (lexer.go trace:/span:/event:/link:)
SCOPED_INTRINSICS = {
    ("trace", "id"): Intrinsic.TRACE_ID,
    ("trace", "duration"): Intrinsic.TRACE_DURATION,
    ("trace", "rootName"): Intrinsic.ROOT_NAME,
    ("trace", "rootService"): Intrinsic.ROOT_SERVICE,
    ("span", "id"): Intrinsic.SPAN_ID,
    ("span", "parentID"): Intrinsic.PARENT_ID,
    ("span", "duration"): Intrinsic.DURATION,
    ("span", "name"): Intrinsic.NAME,
    ("span", "status"): Intrinsic.STATUS,
    ("span", "statusMessage"): Intrinsic.STATUS_MESSAGE,
    ("span", "kind"): Intrinsic.KIND,
    ("event", "name"): Intrinsic.EVENT_NAME,
    ("event", "timeSinceStart"): Intrinsic.EVENT_TIME_SINCE_START,
    ("link", "traceID"): Intrinsic.LINK_TRACE_ID,
    ("link", "spanID"): Intrinsic.LINK_SPAN_ID,
    ("instrumentation", "name"): Intrinsic.INSTRUMENTATION_NAME,
    ("instrumentation", "version"): Intrinsic.INSTRUMENTATION_VERSION,
}


@dataclasses.dataclass(frozen=True)
class Attribute:
    name: str
    scope: Scope = Scope.NONE
    intrinsic: Intrinsic = Intrinsic.NONE
    parent: bool = False  # parent.<scope>.<attr>

    @staticmethod
    def intrinsic_of(i: Intrinsic) -> "Attribute":
        return Attribute(name=i.value, intrinsic=i)

    def __str__(self) -> str:
        if self.intrinsic != Intrinsic.NONE:
            return self.intrinsic.value
        p = "parent." if self.parent else ""
        name = self.name
        # quote unless the lexer's raw-attr scanner would re-read it intact
        if not re.fullmatch(r'[^\s{}()|,=!<>~&+\-*/%^"]+', name):
            name = '"' + name.replace("\\", "\\\\").replace('"', '\\"') + '"'
        if self.scope == Scope.NONE:
            return f"{p}.{name}"
        return f"{p}{self.scope.value}.{name}"


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

class Op(enum.Enum):
    AND = "&&"
    OR = "||"
    EQ = "="
    NEQ = "!="
    REGEX = "=~"
    NOT_REGEX = "!~"
    GT = ">"
    GTE = ">="
    LT = "<"
    LTE = "<="
    ADD = "+"
    SUB = "-"
    MULT = "*"
    DIV = "/"
    MOD = "%"
    POW = "^"
    NOT = "!"
    NEG = "-u"  # unary minus

    def is_boolean(self) -> bool:
        return self in (Op.AND, Op.OR, Op.EQ, Op.NEQ, Op.REGEX, Op.NOT_REGEX,
                        Op.GT, Op.GTE, Op.LT, Op.LTE, Op.NOT)


class StructuralOp(enum.Enum):
    CHILD = ">"
    PARENT = "<"
    DESCENDANT = ">>"
    ANCESTOR = "<<"
    SIBLING = "~"
    NOT_CHILD = "!>"
    NOT_PARENT = "!<"
    NOT_DESCENDANT = "!>>"
    NOT_ANCESTOR = "!<<"
    NOT_SIBLING = "!~"
    UNION_CHILD = "&>"
    UNION_PARENT = "&<"
    UNION_DESCENDANT = "&>>"
    UNION_ANCESTOR = "&<<"
    UNION_SIBLING = "&~"


class SpansetOp(enum.Enum):
    AND = "&&"      # both match within trace
    OR = "||"       # union


# ---------------------------------------------------------------------------
# Expressions (within a spanset filter)
# ---------------------------------------------------------------------------

FieldExpr = Union["BinaryOp", "UnaryOp", Static, Attribute]


@dataclasses.dataclass(frozen=True)
class BinaryOp:
    op: Op
    lhs: FieldExpr
    rhs: FieldExpr

    def __str__(self) -> str:
        return f"{paren(self.lhs)} {self.op.value} {paren(self.rhs)}"


@dataclasses.dataclass(frozen=True)
class UnaryOp:
    op: Op
    expr: FieldExpr

    def __str__(self) -> str:
        sym = "-" if self.op == Op.NEG else self.op.value
        return f"{sym}{paren(self.expr)}"


def paren(e) -> str:
    if isinstance(e, (BinaryOp,)):
        return f"({e})"
    return str(e)


# ---------------------------------------------------------------------------
# Pipeline elements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpansetFilter:
    expr: FieldExpr  # boolean-typed

    def __str__(self) -> str:
        return "{ " + str(self.expr) + " }" if not _is_true(self.expr) else "{ }"


def _is_true(e) -> bool:
    return isinstance(e, Static) and e.type == StaticType.BOOL and e.value is True


@dataclasses.dataclass(frozen=True)
class ScalarFilter:
    """`| avg(duration) > 1s` — scalar condition over a spanset."""
    op: Op
    lhs: "AggregateExpr | Static"
    rhs: "AggregateExpr | Static"

    def __str__(self) -> str:
        return f"{self.lhs} {self.op.value} {self.rhs}"


class AggregateKind(enum.Enum):
    COUNT = "count"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    SUM = "sum"


@dataclasses.dataclass(frozen=True)
class AggregateExpr:
    kind: AggregateKind
    expr: Optional[FieldExpr] = None  # None for count()

    def __str__(self) -> str:
        inner = "" if self.expr is None else str(self.expr)
        return f"{self.kind.value}({inner})"


@dataclasses.dataclass(frozen=True)
class StructuralExpr:
    op: StructuralOp
    lhs: "SpansetExpr"
    rhs: "SpansetExpr"

    def __str__(self) -> str:
        return f"{self.lhs} {self.op.value} {self.rhs}"


@dataclasses.dataclass(frozen=True)
class SpansetCombine:
    op: SpansetOp
    lhs: "SpansetExpr"
    rhs: "SpansetExpr"

    def __str__(self) -> str:
        return f"{self.lhs} {self.op.value} {self.rhs}"


SpansetExpr = Union[SpansetFilter, StructuralExpr, SpansetCombine, "GroupOp",
                    "SelectOp", "CoalesceOp", "ScalarFilter", "Pipeline"]


@dataclasses.dataclass(frozen=True)
class GroupOp:
    by: tuple  # tuple[FieldExpr]

    def __str__(self) -> str:
        return "by(" + ", ".join(str(e) for e in self.by) + ")"


@dataclasses.dataclass(frozen=True)
class SelectOp:
    attrs: tuple  # tuple[FieldExpr]

    def __str__(self) -> str:
        return "select(" + ", ".join(str(e) for e in self.attrs) + ")"


@dataclasses.dataclass(frozen=True)
class CoalesceOp:
    def __str__(self) -> str:
        return "coalesce()"


# ---------------------------------------------------------------------------
# Metrics (engine_metrics.go second-stage grammar)
# ---------------------------------------------------------------------------

class MetricsKind(enum.Enum):
    RATE = "rate"
    COUNT_OVER_TIME = "count_over_time"
    MIN_OVER_TIME = "min_over_time"
    MAX_OVER_TIME = "max_over_time"
    AVG_OVER_TIME = "avg_over_time"
    SUM_OVER_TIME = "sum_over_time"
    QUANTILE_OVER_TIME = "quantile_over_time"
    HISTOGRAM_OVER_TIME = "histogram_over_time"
    COMPARE = "compare"


@dataclasses.dataclass(frozen=True)
class MetricsAggregate:
    kind: MetricsKind
    attr: Optional[FieldExpr] = None          # measured attribute
    params: tuple = ()                        # quantiles for quantile_over_time
    by: tuple = ()                            # group-by attributes
    # compare() extras
    compare_filter: Optional[FieldExpr] = None
    compare_start_ns: int = 0
    compare_end_ns: int = 0

    def __str__(self) -> str:
        args = []
        if self.kind == MetricsKind.COMPARE:
            args.append("{" + str(self.compare_filter) + "}")
            if self.params:
                args.append(str(self.params[0]))
            if self.compare_start_ns or self.compare_end_ns:
                args += [str(self.compare_start_ns), str(self.compare_end_ns)]
        else:
            if self.attr is not None:
                args.append(str(self.attr))
            args += [repr(p) for p in self.params]
        s = f"{self.kind.value}({', '.join(args)})"
        if self.by:
            s += " by(" + ", ".join(str(e) for e in self.by) + ")"
        return s


@dataclasses.dataclass(frozen=True)
class Hint:
    name: str
    value: Static

    def __str__(self) -> str:
        return f"{self.name}={self.value}"


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """A full root query: spanset pipeline + optional metrics stage + hints."""
    stages: tuple            # tuple[SpansetExpr | ScalarFilter | GroupOp | ...]
    metrics: Optional[MetricsAggregate] = None
    hints: tuple = ()

    def __str__(self) -> str:
        s = " | ".join(str(st) for st in self.stages)
        if self.metrics is not None:
            s += " | " + str(self.metrics)
        if self.hints:
            s += " with (" + ", ".join(str(h) for h in self.hints) + ")"
        return s


def walk(node, fn) -> None:
    """Pre-order traversal over every AST node."""
    fn(node)
    children = ()
    if isinstance(node, Pipeline):
        children = node.stages + ((node.metrics,) if node.metrics else ())
    elif isinstance(node, (StructuralExpr, SpansetCombine)):
        children = (node.lhs, node.rhs)
    elif isinstance(node, SpansetFilter):
        children = (node.expr,)
    elif isinstance(node, BinaryOp):
        children = (node.lhs, node.rhs)
    elif isinstance(node, UnaryOp):
        children = (node.expr,)
    elif isinstance(node, ScalarFilter):
        children = (node.lhs, node.rhs)
    elif isinstance(node, AggregateExpr):
        children = (node.expr,) if node.expr is not None else ()
    elif isinstance(node, MetricsAggregate):
        children = tuple(x for x in (node.attr, node.compare_filter) if x is not None) + node.by
    elif isinstance(node, (GroupOp,)):
        children = node.by
    elif isinstance(node, SelectOp):
        children = node.attrs
    for c in children:
        walk(c, fn)
