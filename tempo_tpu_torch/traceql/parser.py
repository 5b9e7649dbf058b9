"""TraceQL recursive-descent parser (reference grammar `pkg/traceql/expr.y`).

Produces `ast.Pipeline`. Operator precedence inside field expressions follows
the reference: || < && < comparison < +- < */% < ^ < unary. Spanset-level
combinators (structural ops, && , ||) are left-associative at one level, as
in the yacc grammar.
"""

from __future__ import annotations

from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.lexer import LexError, T, Token, lex


class ParseError(ValueError):
    pass


_CMP = {T.EQ: A.Op.EQ, T.NEQ: A.Op.NEQ, T.REGEX: A.Op.REGEX,
        T.NOT_REGEX: A.Op.NOT_REGEX, T.GT: A.Op.GT, T.GTE: A.Op.GTE,
        T.LT: A.Op.LT, T.LTE: A.Op.LTE}

_STRUCT = {T.GT: A.StructuralOp.CHILD, T.LT: A.StructuralOp.PARENT,
           T.DESC: A.StructuralOp.DESCENDANT, T.ANCE: A.StructuralOp.ANCESTOR,
           T.TILDE: A.StructuralOp.SIBLING,
           T.NOT_CHILD: A.StructuralOp.NOT_CHILD,
           T.NOT_PARENT: A.StructuralOp.NOT_PARENT,
           T.NOT_DESC: A.StructuralOp.NOT_DESCENDANT,
           T.NOT_ANCE: A.StructuralOp.NOT_ANCESTOR,
           T.NOT_REGEX: A.StructuralOp.NOT_SIBLING,
           T.UNION_CHILD: A.StructuralOp.UNION_CHILD,
           T.UNION_PARENT: A.StructuralOp.UNION_PARENT,
           T.UNION_DESC: A.StructuralOp.UNION_DESCENDANT,
           T.UNION_ANCE: A.StructuralOp.UNION_ANCESTOR,
           T.UNION_SIBLING: A.StructuralOp.UNION_SIBLING}

_AGG = {"count": A.AggregateKind.COUNT, "avg": A.AggregateKind.AVG,
        "max": A.AggregateKind.MAX, "min": A.AggregateKind.MIN,
        "sum": A.AggregateKind.SUM}

_METRICS = {m.value: m for m in A.MetricsKind}

_STATUS_WORDS = {"ok": A.STATUS_OK, "error": A.STATUS_ERROR,
                 "unset": A.STATUS_UNSET}
_KIND_WORDS = {"unspecified": 0, "internal": 1, "server": 2, "client": 3,
               "producer": 4, "consumer": 5}


class _Parser:
    def __init__(self, toks: list[Token], src: str):
        self.toks = toks
        self.i = 0
        self.src = src

    # -- token plumbing ----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != T.EOF:
            self.i += 1
        return t

    def accept(self, kind: T) -> Token | None:
        if self.peek().kind == kind:
            return self.next()
        return None

    def expect(self, kind: T) -> Token:
        t = self.peek()
        if t.kind != kind:
            raise ParseError(
                f"parse error at {t.pos}: expected {kind.value!r}, got "
                f"{t.text!r} in {self.src!r}")
        return self.next()

    # -- entry -------------------------------------------------------------

    def parse_root(self) -> A.Pipeline:
        stages: list = [self.parse_spanset_expr()]
        metrics = None
        while self.accept(T.PIPE):
            t = self.peek()
            if t.kind == T.IDENT and t.text in _METRICS:
                metrics = self.parse_metrics()
                break
            stages.append(self.parse_stage())
        hints = self.parse_hints()
        self.expect(T.EOF)
        return A.Pipeline(tuple(stages), metrics=metrics, hints=tuple(hints))

    def parse_hints(self) -> list[A.Hint]:
        out: list[A.Hint] = []
        t = self.peek()
        if t.kind == T.IDENT and t.text == "with":
            self.next()
            self.expect(T.OPEN_PAREN)
            while True:
                name = self.expect(T.IDENT).text
                self.expect(T.EQ)
                out.append(A.Hint(name, self.parse_static()))
                if not self.accept(T.COMMA):
                    break
            self.expect(T.CLOSE_PAREN)
        return out

    # -- pipeline stages ---------------------------------------------------

    def parse_stage(self):
        t = self.peek()
        if t.kind == T.IDENT:
            if t.text == "by":
                self.next()
                self.expect(T.OPEN_PAREN)
                exprs = self.parse_expr_list()
                self.expect(T.CLOSE_PAREN)
                return A.GroupOp(tuple(exprs))
            if t.text == "select":
                self.next()
                self.expect(T.OPEN_PAREN)
                exprs = self.parse_expr_list()
                self.expect(T.CLOSE_PAREN)
                return A.SelectOp(tuple(exprs))
            if t.text == "coalesce":
                self.next()
                self.expect(T.OPEN_PAREN)
                self.expect(T.CLOSE_PAREN)
                return A.CoalesceOp()
            if t.text in _AGG:
                return self.parse_scalar_filter()
        if t.kind in (T.INT, T.FLOAT, T.DURATION):
            return self.parse_scalar_filter()
        return self.parse_spanset_expr()

    def parse_scalar_filter(self) -> A.ScalarFilter:
        lhs = self.parse_scalar_operand()
        t = self.peek()
        if t.kind not in _CMP:
            raise ParseError(f"parse error at {t.pos}: expected comparison in "
                             f"scalar filter, got {t.text!r}")
        op = _CMP[self.next().kind]
        rhs = self.parse_scalar_operand()
        return A.ScalarFilter(op, lhs, rhs)

    def parse_scalar_operand(self):
        t = self.peek()
        if t.kind == T.IDENT and t.text in _AGG:
            self.next()
            kind = _AGG[t.text]
            self.expect(T.OPEN_PAREN)
            inner = None
            if self.peek().kind != T.CLOSE_PAREN:
                inner = self.parse_field_expr()
            self.expect(T.CLOSE_PAREN)
            if kind != A.AggregateKind.COUNT and inner is None:
                raise ParseError(f"{t.text}() requires an argument")
            return A.AggregateExpr(kind, inner)
        return self.parse_static()

    # -- spanset expressions (structural / && / || over filters) ------------

    def parse_spanset_expr(self):
        lhs = self.parse_spanset_primary()
        while True:
            t = self.peek()
            if t.kind in _STRUCT and t.kind != T.NOT_REGEX:
                op = _STRUCT[self.next().kind]
                rhs = self.parse_spanset_primary()
                lhs = A.StructuralExpr(op, lhs, rhs)
            elif t.kind == T.NOT_REGEX and self._spanset_follows():
                self.next()
                rhs = self.parse_spanset_primary()
                lhs = A.StructuralExpr(A.StructuralOp.NOT_SIBLING, lhs, rhs)
            elif t.kind == T.AND:
                self.next()
                lhs = A.SpansetCombine(A.SpansetOp.AND, lhs,
                                       self.parse_spanset_primary())
            elif t.kind == T.OR:
                self.next()
                lhs = A.SpansetCombine(A.SpansetOp.OR, lhs,
                                       self.parse_spanset_primary())
            else:
                return lhs

    def _spanset_follows(self) -> bool:
        return self.peek(1).kind in (T.OPEN_BRACE, T.OPEN_PAREN)

    def parse_spanset_primary(self):
        if self.accept(T.OPEN_PAREN):
            inner = self.parse_spanset_expr()
            self.expect(T.CLOSE_PAREN)
            return inner
        self.expect(T.OPEN_BRACE)
        if self.accept(T.CLOSE_BRACE):
            return A.SpansetFilter(A.Static(A.StaticType.BOOL, True))
        expr = self.parse_field_expr()
        self.expect(T.CLOSE_BRACE)
        return A.SpansetFilter(expr)

    # -- field expressions --------------------------------------------------

    def parse_expr_list(self) -> list:
        out = [self.parse_field_expr()]
        while self.accept(T.COMMA):
            out.append(self.parse_field_expr())
        return out

    def parse_field_expr(self):
        return self.parse_or()

    def parse_or(self):
        lhs = self.parse_and()
        while self.accept(T.OR):
            lhs = A.BinaryOp(A.Op.OR, lhs, self.parse_and())
        return lhs

    def parse_and(self):
        lhs = self.parse_cmp()
        while self.accept(T.AND):
            lhs = A.BinaryOp(A.Op.AND, lhs, self.parse_cmp())
        return lhs

    def parse_cmp(self):
        lhs = self.parse_add()
        t = self.peek()
        if t.kind in _CMP:
            self.next()
            return A.BinaryOp(_CMP[t.kind], lhs, self.parse_add())
        return lhs

    def parse_add(self):
        lhs = self.parse_mul()
        while True:
            if self.accept(T.ADD):
                lhs = A.BinaryOp(A.Op.ADD, lhs, self.parse_mul())
            elif self.accept(T.SUB):
                lhs = A.BinaryOp(A.Op.SUB, lhs, self.parse_mul())
            else:
                return lhs

    def parse_mul(self):
        lhs = self.parse_pow()
        while True:
            t = self.peek()
            if t.kind == T.MULT:
                self.next()
                lhs = A.BinaryOp(A.Op.MULT, lhs, self.parse_pow())
            elif t.kind == T.DIV:
                self.next()
                lhs = A.BinaryOp(A.Op.DIV, lhs, self.parse_pow())
            elif t.kind == T.MOD:
                self.next()
                lhs = A.BinaryOp(A.Op.MOD, lhs, self.parse_pow())
            else:
                return lhs

    def parse_pow(self):
        lhs = self.parse_unary()
        if self.accept(T.POW):  # right-assoc
            return A.BinaryOp(A.Op.POW, lhs, self.parse_pow())
        return lhs

    def parse_unary(self):
        if self.accept(T.SUB):
            inner = self.parse_unary()
            if isinstance(inner, A.Static) and inner.type in (
                    A.StaticType.INT, A.StaticType.FLOAT, A.StaticType.DURATION):
                return A.Static(inner.type, -inner.value)
            return A.UnaryOp(A.Op.NEG, inner)
        if self.accept(T.NOT):
            return A.UnaryOp(A.Op.NOT, self.parse_unary())
        return self.parse_primary()

    def parse_primary(self):
        t = self.peek()
        if t.kind == T.OPEN_PAREN:
            self.next()
            inner = self.parse_field_expr()
            self.expect(T.CLOSE_PAREN)
            return inner
        if t.kind in (T.STRING, T.INT, T.FLOAT, T.DURATION):
            return self.parse_static()
        if t.kind == T.DOT:       # unscoped attribute
            self.next()
            name = self.expect(T.IDENT)
            return A.Attribute(str(name.value), scope=A.Scope.NONE)
        if t.kind == T.SCOPE:
            self.next()
            name = self.expect(T.IDENT)
            # dot-scoped names stay plain attributes; only the colon form
            # (`span:id`, `event:name`, ...) resolves to intrinsics
            return A.Attribute(str(name.value), scope=A.Scope(t.value))
        if t.kind == T.SCOPE_COLON:
            self.next()
            name = self.expect(T.IDENT)
            key = (t.value, str(name.value))
            if key not in A.SCOPED_INTRINSICS:
                raise ParseError(f"unknown intrinsic {t.value}:{name.value}")
            return A.Attribute.intrinsic_of(A.SCOPED_INTRINSICS[key])
        if t.kind == T.PARENT_DOT:
            self.next()
            nxt = self.peek()
            if nxt.kind == T.SCOPE:
                self.next()
                name = self.expect(T.IDENT)
                return A.Attribute(str(name.value), scope=A.Scope(nxt.value),
                                   parent=True)
            name = self.expect(T.IDENT)
            return A.Attribute(str(name.value), scope=A.Scope.NONE, parent=True)
        if t.kind == T.IDENT:
            word = t.text
            if word in ("true", "false"):
                self.next()
                return A.Static(A.StaticType.BOOL, word == "true")
            if word == "nil":
                self.next()
                return A.Static.nil()
            if word in _STATUS_WORDS:
                self.next()
                return A.Static(A.StaticType.STATUS, _STATUS_WORDS[word])
            if word in _KIND_WORDS:
                self.next()
                return A.Static(A.StaticType.KIND, _KIND_WORDS[word])
            if word in A.INTRINSIC_KEYWORDS:
                self.next()
                return A.Attribute.intrinsic_of(A.INTRINSIC_KEYWORDS[word])
        raise ParseError(
            f"parse error at {t.pos}: unexpected {t.text or 'eof'!r} in "
            f"{self.src!r}")

    def parse_static(self) -> A.Static:
        t = self.next()
        if t.kind == T.STRING:
            return A.Static(A.StaticType.STRING, t.value)
        if t.kind == T.INT:
            return A.Static(A.StaticType.INT, t.value)
        if t.kind == T.FLOAT:
            return A.Static(A.StaticType.FLOAT, t.value)
        if t.kind == T.DURATION:
            return A.Static(A.StaticType.DURATION, t.value)
        if t.kind == T.SUB:
            inner = self.parse_static()
            return A.Static(inner.type, -inner.value)
        if t.kind == T.IDENT:
            if t.text in ("true", "false"):
                return A.Static(A.StaticType.BOOL, t.text == "true")
            if t.text == "nil":
                return A.Static.nil()
            if t.text in _STATUS_WORDS:
                return A.Static(A.StaticType.STATUS, _STATUS_WORDS[t.text])
            if t.text in _KIND_WORDS:
                return A.Static(A.StaticType.KIND, _KIND_WORDS[t.text])
        raise ParseError(f"parse error at {t.pos}: expected literal, got {t.text!r}")

    # -- metrics ------------------------------------------------------------

    def parse_metrics(self) -> A.MetricsAggregate:
        t = self.next()
        kind = _METRICS[t.text]
        self.expect(T.OPEN_PAREN)
        attr = None
        params: list = []
        cmp_filter = None
        cmp_start = cmp_end = 0
        if kind == A.MetricsKind.COMPARE:
            self.expect(T.OPEN_BRACE)
            cmp_filter = (A.Static(A.StaticType.BOOL, True)
                          if self.peek().kind == T.CLOSE_BRACE
                          else self.parse_field_expr())
            self.expect(T.CLOSE_BRACE)
            if self.accept(T.COMMA):
                params.append(self.parse_static().as_float())
                if self.accept(T.COMMA):
                    cmp_start = int(self.parse_static().value)
                    self.expect(T.COMMA)
                    cmp_end = int(self.parse_static().value)
        elif kind in (A.MetricsKind.RATE, A.MetricsKind.COUNT_OVER_TIME):
            pass  # no args
        else:
            attr = self.parse_field_expr()
            while self.accept(T.COMMA):
                params.append(self.parse_static().as_float())
        self.expect(T.CLOSE_PAREN)
        by: tuple = ()
        nt = self.peek()
        if nt.kind == T.IDENT and nt.text == "by":
            self.next()
            self.expect(T.OPEN_PAREN)
            by = tuple(self.parse_expr_list())
            self.expect(T.CLOSE_PAREN)
        return A.MetricsAggregate(
            kind, attr=attr, params=tuple(params), by=by,
            compare_filter=cmp_filter, compare_start_ns=cmp_start,
            compare_end_ns=cmp_end)


def parse(src: str) -> A.Pipeline:
    """Parse a TraceQL query string into a Pipeline AST."""
    try:
        toks = lex(src)
    except LexError as e:
        raise ParseError(str(e)) from e
    return _Parser(toks, src).parse_root()
