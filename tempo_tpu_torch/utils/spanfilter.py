"""Vectorized span filter policies.

The analog of `pkg/spanfilter` (`spanfilter.go:19,53`): include/exclude
policies with strict or regex matching over intrinsics (kind, status, name)
and span/resource attributes. A policy set compiles to a single callable
producing a keep-mask over a SpanBatch — string comparisons become id
comparisons (strict) or a per-id boolean lookup table built from the
interner snapshot (regex), so no per-span Python runs.
"""

from __future__ import annotations

import dataclasses
import re
import weakref
from typing import Callable, Sequence

import numpy as np

from tempo_tpu_torch.model.interner import INVALID_ID
from tempo_tpu_torch.model.span_batch import SpanBatch

_KIND_STRS = ("SPAN_KIND_UNSPECIFIED", "SPAN_KIND_INTERNAL", "SPAN_KIND_SERVER",
              "SPAN_KIND_CLIENT", "SPAN_KIND_PRODUCER", "SPAN_KIND_CONSUMER")
_STATUS_STRS = ("STATUS_CODE_UNSET", "STATUS_CODE_OK", "STATUS_CODE_ERROR")


@dataclasses.dataclass(frozen=True)
class AttributeMatch:
    key: str          # "kind", "status", "name", "span.<attr>", "resource.<attr>"
    value: object     # str (or compiled pattern source for regex)


@dataclasses.dataclass(frozen=True)
class PolicyMatch:
    match_type: str   # "strict" | "regex"
    attributes: tuple[AttributeMatch, ...]


@dataclasses.dataclass(frozen=True)
class FilterPolicy:
    include: PolicyMatch | None = None
    exclude: PolicyMatch | None = None


def _intrinsic_str_col(sb: SpanBatch, key: str) -> np.ndarray | None:
    """Return an int32 'interned string id' column for intrinsic string keys."""
    it = sb.interner
    if key in ("kind", "span.kind"):
        lut = it.intern_many(_KIND_STRS)
        return lut[np.clip(sb.kind, 0, 5)]
    if key in ("status", "span.status", "status.code"):
        lut = it.intern_many(_STATUS_STRS)
        return lut[np.clip(sb.status_code, 0, 2)]
    if key in ("name", "span.name"):
        return sb.name_id
    return None


# interner (weak) → {pattern: boolean LUT}. The interner only appends, so a
# cached LUT stays valid for ids it covers; each batch only the newly
# interned tail is regex-matched instead of the whole string table. Weak keys
# let dead interners' LUTs be collected (and make id-reuse aliasing
# impossible).
_regex_luts: "weakref.WeakKeyDictionary[object, dict[str, np.ndarray]]" = None  # type: ignore[assignment]


def _regex_lut(pattern: str, interner) -> np.ndarray:
    global _regex_luts
    if _regex_luts is None:
        _regex_luts = weakref.WeakKeyDictionary()
    per = _regex_luts.setdefault(interner, {})
    strs = interner.snapshot()
    lut = per.get(pattern)
    start = 0 if lut is None else len(lut)
    if start >= len(strs):
        # A LUT longer than this snapshot (concurrent intern) is still
        # correct for every id the snapshot covers.
        return lut if lut is not None else np.zeros(0, bool)
    pat = re.compile(pattern)
    tail = np.fromiter((bool(pat.fullmatch(s)) for s in strs[start:]), bool,
                       len(strs) - start)
    lut = tail if lut is None else np.concatenate([lut, tail])
    per[pattern] = lut
    return lut


def _match_one(sb: SpanBatch, am: AttributeMatch, match_type: str) -> np.ndarray:
    col = _intrinsic_str_col(sb, am.key)
    if col is None:
        key = am.key
        scope = "span"
        if key.startswith("resource."):
            scope, key = "resource", key[len("resource."):]
        elif key.startswith("span."):
            key = key[len("span."):]
        col = sb.attr_sval_column(key, scope=scope)
    if match_type == "strict":
        want = sb.interner.get(str(am.value))
        return (col == want) & (col != INVALID_ID)
    # regex: incrementally-maintained id→bool LUT over the interner
    lut = _regex_lut(str(am.value), sb.interner)
    safe = np.clip(col, 0, max(len(lut) - 1, 0))
    return np.where((col >= 0) & (col < len(lut)), lut[safe] if len(lut) else False, False)


def _match_policy(sb: SpanBatch, pm: PolicyMatch) -> np.ndarray:
    mask = np.ones(sb.capacity, bool)
    for am in pm.attributes:
        mask &= _match_one(sb, am, pm.match_type)
    return mask


def compile_policies(policies: Sequence[FilterPolicy]) -> Callable[[SpanBatch], np.ndarray] | None:
    """Compile to keep-mask fn. Reference semantics (`spanfilter.go:53`):
    a span is kept if, for every policy, (include absent or matched) and
    (exclude absent or not matched)."""
    pols = tuple(policies)
    if not pols:
        return None

    def keep(sb: SpanBatch) -> np.ndarray:
        mask = np.ones(sb.capacity, bool)
        for p in pols:
            if p.include is not None:
                mask &= _match_policy(sb, p.include)
            if p.exclude is not None:
                mask &= ~_match_policy(sb, p.exclude)
        return mask

    return keep
