"""Recurring-query fingerprint: the shared "same query" identity.

Counterpart of `tempo_tpu/obs/queryfp.py`, over the port's TraceQL AST;
`canonical_query` and `query_fingerprint` give the reference's strings.

The query log (obs/qlog.py) wants to notice that 10k dashboards are
polling the same handful of TraceQL-metrics queries, and the
materialized-view tier (`matview`) wants to serve exactly those
queries from standing device grids — both need to agree, byte for
byte, on what "the same query" means, so the identity lives here and
nowhere else.

A fingerprint covers (op, canonical query text, step) and deliberately
EXCLUDES the time window: a dashboard re-polling `rate()` every 10s
shifts start/end on every request but is still the same recurring
query (the whole point of materializing it). Canonicalization re-prints
the parsed AST — whitespace, quoting, and duration formatting normalize
for free — and additionally sorts the operands of commutative boolean
operators (`&&`/`||` inside filters, `&&`/`||` between spansets), so
`{a && b}` and `{b && a}` fingerprint identically. Queries that fail to
parse fall back to a whitespace-collapsed raw string: they still get a
stable (if weaker) identity instead of an exception on the log path.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import re

from tempo_tpu_torch.traceql import ast as A

_WS = re.compile(r"\s+")

_COMMUTATIVE = (A.Op.AND, A.Op.OR)


def _canon_node(node):
    """Recursively canonicalize an AST node: rebuild frozen dataclasses
    with canonicalized children, flattening + sorting commutative
    boolean chains by their printed form."""
    if isinstance(node, A.BinaryOp) and node.op in _COMMUTATIVE:
        ops = _flatten(node, node.op)
        ops = sorted((_canon_node(o) for o in ops), key=str)
        out = ops[0]
        for o in ops[1:]:
            out = A.BinaryOp(node.op, out, o)
        return out
    if isinstance(node, A.SpansetCombine):
        lhs, rhs = _canon_node(node.lhs), _canon_node(node.rhs)
        if node.op in (A.SpansetOp.AND, A.SpansetOp.OR) \
                and str(rhs) < str(lhs):
            lhs, rhs = rhs, lhs
        return dataclasses.replace(node, lhs=lhs, rhs=rhs)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, (list, tuple)):
                nv = type(v)(_canon_node(x) for x in v)
                if nv != v:
                    changes[f.name] = nv
            else:
                nv = _canon_node(v)
                if nv is not v:
                    changes[f.name] = nv
        return dataclasses.replace(node, **changes) if changes else node
    return node


def _flatten(node, op) -> list:
    if isinstance(node, A.BinaryOp) and node.op == op:
        return _flatten(node.lhs, op) + _flatten(node.rhs, op)
    return [node]


@functools.lru_cache(maxsize=4096)
def canonical_query(query: str) -> str:
    """Whitespace/order-normalized form of a TraceQL query (parse →
    canonicalize → re-print); unparseable input collapses whitespace.
    Memoized — the matview read path fingerprints every poll of the
    same few hundred dashboard queries."""
    from tempo_tpu_torch.traceql.parser import parse

    try:
        q = parse(query)
    except Exception:
        return _WS.sub(" ", (query or "").strip())
    return str(_canon_node(q))


def query_fingerprint(op: str, query: str,
                      step_s: "float | None" = None) -> str:
    """The recurring-query identity: 16 hex chars over
    (op, canonical query, step-in-ms). Time-window independent by
    construction — start/end never enter the hash."""
    step_ms = "" if step_s is None else str(int(round(step_s * 1e3)))
    raw = "\x00".join((op, canonical_query(query), step_ms))
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


__all__ = ["canonical_query", "query_fingerprint"]
