"""Device scan plane for backend blocks.

Counterpart of `tempo_tpu/block/device_scan.py`. The storage-level first
pass (`condition_mask`) and the whole metrics first pass run over
block-resident device columns:

- string columns stay dictionary-coded: codes are an int32 device column;
  a predicate becomes a small boolean lookup table built on host over the
  DICTIONARY (|dict| entries, not |rows|) — equality, ordered compares
  and full regex all cost O(|dict|) host work — then one device gather;
- integer columns (duration, kind, status, nested-set coords, int/bool
  attributes, timestamps) compare EXACTLY on device as int64. The
  reference splits each value into (hi, lo) int32 halves because the TPU
  has no int64 (`_split_i64`, `_icmp`); CUDA has it, so the port keeps
  the int64 column and compares it with the int64 literal, which is the
  same order. Non-integral literals are normalized on host (`duration >
  1.5` ⇒ `>= 2`); float-valued attribute columns ride the order-
  preserving int64 encoding of their float64 bits (`_sortable_f64`);
- masks AND/OR-combine on device; one transfer returns the bit-packed
  final mask.

`BlockScanPlane` — the production plane: per immutable block, columns are
adopted lazily (first query referencing a column pays one host factorize
+ upload; blocks are immutable so adoption is permanent), and a query's
whole first pass — predicates, time clip, row-group shard selection,
step bucketing, group-by, metric scatter — runs as one fused sequence of
torch ops on the block's device with no host sync and no boolean
selection: rejected rows aim at a trash row past the last group (the
reference's `mode="drop"` index) and every read slices it off.
`db/tempodb.py` routes search and query_range through it via
`db/plane_cache.py`.

`device_pred_mask` — the per-row-group sync offload of `condition_mask`,
OPT-IN via TEMPO_TPU_DEVICE_SCAN=1 as in the reference: one fused
expression per predicate signature (`_compiled_mask`) over float32
numeric columns and int32 dictionary codes with a LUT gather, on the
view's device (`view.meta["device"]`), with the columns cached on the
view. It keeps the reference's float32 compares and refuses (None → the
host plane) the shapes the reference refuses.

Over a mesh (`mesh=`, a `parallel.mesh.Mesh`) the plane's span-dimension
columns split over the 'data' axis in contiguous chunks (whole bytes of
the packed mask): each data shard runs the mask or grid over its chunk
on its device, and the grids reduce in shard order onto the (0, 0)
device (sums and counts add, min/max take the min/max, the moments
grid's two bound planes the max), the counterpart of the reference's
`P("data")` column sharding and XLA-inserted reduce.
"""

from __future__ import annotations

import functools
import math
import os
import re
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tempo_tpu_torch.block.fetch import _dict_codes
from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.eval import (BOOL, KIND, NUM, STATUS, STR, Col,
                                          eval_expr)

_NUM_OPS = {A.Op.EQ, A.Op.NEQ, A.Op.GT, A.Op.GTE, A.Op.LT, A.Op.LTE}

_NUM_INTRINSICS = {
    A.Intrinsic.DURATION: "duration",
    A.Intrinsic.KIND: "kind",
    A.Intrinsic.STATUS: "status",
    A.Intrinsic.NESTED_SET_LEFT: "nestedSetLeft",
    A.Intrinsic.NESTED_SET_RIGHT: "nestedSetRight",
    A.Intrinsic.NESTED_SET_PARENT: "nestedSetParent",
}

# static type → column type tag, for the reference's comparability lattice
# (`enum_statics.go`: status/kind/num are distinct; see eval._comparable)
_STATIC_T = {
    A.StaticType.INT: NUM, A.StaticType.FLOAT: NUM,
    A.StaticType.DURATION: NUM, A.StaticType.STRING: STR,
    A.StaticType.BOOL: BOOL, A.StaticType.STATUS: STATUS,
    A.StaticType.KIND: KIND,
}

# |values| beyond this take the float encoding, as in the reference (whose
# hi/lo split needs it); the int64 compares here would hold beyond it
_INT_MAX = 1 << 62

def enabled() -> bool:
    """Per-row-group sync offload policy for `condition_mask` — OPT-IN
    (TEMPO_TPU_DEVICE_SCAN=1): each synchronous mask pays a full device
    round trip and compares in float32. The block-level `BlockScanPlane`
    (one fused dispatch per block, exact int compares) is the production
    device plane."""
    return os.environ.get("TEMPO_TPU_DEVICE_SCAN", "") == "1"


# ---------------------------------------------------------------------------
# shared host-side predicate compilation
# ---------------------------------------------------------------------------

_STR_ORD = {A.Op.GT: lambda a, b: a > b, A.Op.GTE: lambda a, b: a >= b,
            A.Op.LT: lambda a, b: a < b, A.Op.LTE: lambda a, b: a <= b}


def _dict_term(op: A.Op, v, dvals: list):
    """Compile a string predicate over dictionary values into a (sig
    entry, lut) pair; None when the shape is unsupported. Regexes are
    ANCHORED (fullmatch), matching `eval.regex_match_col` / pkg/regexp.
    Ordered compares are lexicographic like the numpy plane's astype(str)
    compare."""
    if not isinstance(v, str):
        return None
    if op in (A.Op.EQ, A.Op.NEQ):
        matched = [i for i, s in enumerate(dvals) if s == v]
    elif op in _STR_ORD:
        f = _STR_ORD[op]
        matched = [i for i, s in enumerate(dvals) if f(s, v)]
    elif op in (A.Op.REGEX, A.Op.NOT_REGEX):
        try:
            rx = re.compile(v)
        except re.error:
            return None
        matched = [i for i, s in enumerate(dvals) if rx.fullmatch(s)]
    else:
        return None
    lut = np.zeros(len(dvals), bool)
    if matched:
        lut[np.asarray(matched)] = True
    return ("lut", None, op in (A.Op.NEQ, A.Op.NOT_REGEX)), lut


def _int_literal(op: A.Op, v) -> tuple:
    """Normalize (op, literal) for the exact integer plane.

    Returns ("const", bool) when the comparison is decidable on host
    (non-integral EQ, out-of-range literals) or ("icmp", op', int_lit).
    Non-integral range literals shift to the nearest integer bound:
    `v > 1.5` over ints ⟺ `v >= 2`; `v < 1.5` ⟺ `v <= 1`.
    """
    try:
        f = float(v)
    except (TypeError, ValueError):
        return ("const", False)
    if f != f:                                   # NaN compares are false
        return ("const", False)
    if float(f).is_integer() and abs(f) < _INT_MAX:
        return ("icmp", op, int(f))
    if op == A.Op.EQ:
        return ("const", False)
    if op == A.Op.NEQ:
        return ("const", True)
    if abs(f) >= _INT_MAX:
        big = f > 0
        if op in (A.Op.GT, A.Op.GTE):
            return ("const", not big)
        return ("const", big)                    # LT / LTE
    if op in (A.Op.GT, A.Op.GTE):
        return ("icmp", A.Op.GTE, int(math.ceil(f)))
    return ("icmp", A.Op.LTE, int(math.floor(f)))


def _sortable_f64(v: np.ndarray) -> np.ndarray:
    """float64 → order-preserving int64 (no NaN): non-negative floats keep
    their bit pattern (already increasing); negative floats reflect so
    more-negative maps lower. -0.0 and +0.0 both map to 0 — equal floats
    must encode equal."""
    b = np.asarray(v, np.float64).view(np.int64)
    return np.where(b >= 0, b, np.int64(-2**63) - b)


# ---------------------------------------------------------------------------
# fused mask
# ---------------------------------------------------------------------------

def _icmp(op: A.Op, col: torch.Tensor, lit: torch.Tensor) -> torch.Tensor:
    """Exact int64 compare of a resident column with a device literal."""
    if op == A.Op.EQ:
        return col == lit
    if op == A.Op.NEQ:
        return col != lit
    if op == A.Op.GT:
        return col > lit
    if op == A.Op.GTE:
        return col >= lit
    if op == A.Op.LT:
        return col < lit
    return col <= lit


def _term_masks(sig: tuple, args, n: int, ivec: torch.Tensor, ibase: int,
                device):
    """Evaluate each term of a plan signature → list of bool vectors.

    Device tensors ride in `args` (consumed left to right); EVERY scalar
    literal is an element of the single packed int64 vector `ivec`
    (starting at `ibase`) — one H2D transfer per call however many
    predicates the plan holds. Term shapes:
      ("lut", neg, has_ex)    args: codes, lut, [exists]
      ("icmp", op, has_ex)    args: col, [exists]; ivec: lit
      ("nil", want, has_ex)   args: [exists]   (x = nil / x != nil)
      ("const", val)          —
    Missing attributes never match (exists ANDs after negation), matching
    `Col.bool_mask` in the numpy plane.
    """
    out = []
    i = 0
    k = ibase
    for term in sig:
        kind = term[0]
        if kind == "lut":
            _, neg, has_ex = term
            codes, lut = args[i], args[i + 1]
            i += 2
            m = lut.index_select(0, codes)
            if neg:
                m = ~m
            if has_ex:
                m = m & args[i]
                i += 1
        elif kind == "icmp":
            _, op, has_ex = term
            m = _icmp(op, args[i], ivec[k])
            i += 1
            k += 1
            if has_ex:
                m = m & args[i]
                i += 1
        elif kind == "nil":
            _, want, has_ex = term
            if has_ex:
                ex = args[i]
                i += 1
                m = ex if want else ~ex
            else:
                m = torch.full((n,), bool(want), device=device)
        else:                                    # ("const", val)
            m = torch.full((n,), bool(term[1]), device=device)
        out.append(m)
    return out, i, k


def _combine(pred_masks, extra_masks, all_conditions: bool, n: int, device):
    mask = None
    for m in pred_masks:
        mask = m if mask is None else (mask & m if all_conditions
                                       else mask | m)
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=device)
    for m in extra_masks:
        mask = mask & m
    return mask


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


@functools.lru_cache(maxsize=128)
def _block_mask_kernel(n: int, pred_sig: tuple, extra_sig: tuple,
                       all_conditions: bool):
    """Fused block mask: predicate terms combine per all_conditions;
    extra terms (time clip, row-group shard) always AND. Returns the mask
    bit-packed (big-endian bit order) so the D2H is n/8 bytes."""
    def fn(ivec, *args):
        device = ivec.device
        pred_masks, used, k = _term_masks(pred_sig, args, n, ivec, 0, device)
        extra_masks, _, _ = _term_masks(extra_sig, args[used:], n, ivec, k,
                                        device)
        mask = _combine(pred_masks, extra_masks, all_conditions, n, device)
        pad = (-n) % 8
        mp = torch.cat([mask.to(torch.uint8),
                        torch.zeros(pad, dtype=torch.uint8, device=device)])
        weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=device)
        return (mp.view(-1, 8) * weights).sum(dim=1).to(torch.uint8)

    return fn


# ---------------------------------------------------------------------------
# per-row-group opt-in plane (diagnostic; float32 numerics)
# ---------------------------------------------------------------------------

def _num_term(op: A.Op, v):
    """(sig entry, float literal) for a numeric compare; None otherwise."""
    if op not in _NUM_OPS or isinstance(v, (str, bytes)):
        return None
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return ("cmp", op, False), f


_CMP = {A.Op.EQ: torch.eq, A.Op.NEQ: torch.ne, A.Op.GT: torch.gt,
        A.Op.GTE: torch.ge, A.Op.LT: torch.lt, A.Op.LTE: torch.le}


@functools.lru_cache(maxsize=64)
def _compiled_mask(sig: tuple, all_conditions: bool):
    """One fused expression per predicate-plan shape: the whole
    conjunction/disjunction is one sequence of device ops per row group
    (float32 numeric path — the per-row-group opt-in plane only)."""
    def fn(*args):
        mask = None
        for t, (kind, op, neg) in enumerate(sig):
            a, b = args[2 * t], args[2 * t + 1]
            if kind == "lut":
                m = b.index_select(0, a)        # codes → LUT bit
                if neg:
                    m = ~m
            else:
                m = _CMP[op](a, b)              # f32 column vs f32 literal
            mask = m if mask is None else (mask & m if all_conditions
                                           else mask | m)
        return mask

    return fn


def _col_for(view, attr: A.Attribute):
    """("dict", key, codes, dictvals) | ("num", key, values) | None."""
    if attr.intrinsic == A.Intrinsic.NAME:
        c = view.meta.get("name_col")
        if c is not None:
            return ("dict", "name") + _dict_codes(view, "name", c)
    if (attr.intrinsic == A.Intrinsic.NONE and attr.name == "service.name"
            and attr.scope in (A.Scope.RESOURCE, A.Scope.NONE)):
        c = view.meta.get("service_col")
        if c is not None:
            return ("dict", "service") + _dict_codes(view, "service", c)
    key = _NUM_INTRINSICS.get(attr.intrinsic)
    if key:
        col = view.col(key)
        if col is not None:
            return ("num", key, col.values)
    return None


def _dev_array(view, key: str, values: np.ndarray, dtype, device):
    """Device-resident copy of a scan column, cached on the view so a
    multi-query/multi-pass scan transfers each column once."""
    cache = view.meta.setdefault("_dev_arrays", {})
    arr = cache.get(key)
    if arr is None:
        arr = cache[key] = torch.as_tensor(np.asarray(values, dtype),
                                           device=device)
    return arr


_launch_lock = threading.Lock()


def device_pred_mask(view, preds: Sequence, all_conditions: bool
                     ) -> Optional[np.ndarray]:
    """Evaluate pushdown predicates on the view's device (its reader's
    `meta["device"]`, else `cuda`); None when unsupported.
    `device_pred_mask.launches` counts the masks it dispatched (a
    refusal dispatches none)."""
    if not enabled() or not preds:
        return None
    from tempo_tpu_torch.device import resolve_device

    device = resolve_device(view.meta.get("device"))
    sig = []
    args = []
    for c in preds:
        if not c.operands:
            return None
        info = _col_for(view, c.attr)
        if info is None:
            return None
        v = c.operands[0].value
        if info[0] == "dict":
            _, key, codes, dvals = info
            term = _dict_term(c.op, v, dvals)
            if term is None:
                return None
            sig.append(term[0])
            args.append(_dev_array(view, f"dict:{key}", codes, np.int32,
                                   device))
            args.append(torch.as_tensor(term[1], device=device))
        else:
            _, key, values = info
            term = _num_term(c.op, v)
            if term is None:
                return None
            sig.append(term[0])
            args.append(_dev_array(view, f"num:{key}", values, np.float32,
                                   device))
            args.append(torch.as_tensor(np.float32(term[1]), device=device))
    if not sig:
        return None
    fn = _compiled_mask(tuple(sig), all_conditions)
    with _launch_lock:
        device_pred_mask.launches += 1
    return fn(*args).cpu().numpy()


device_pred_mask.launches = 0


# ---------------------------------------------------------------------------
# the production block plane
# ---------------------------------------------------------------------------

class GridHandle:
    """An in-flight fused metrics grid: the dispatch is async; fetch()
    performs the single packed D2H and unpacks (labels, main, cnt, vcnt).
    Callers launch every block's grid before fetching any, so N blocks
    pipeline their device work instead of serializing it."""

    __slots__ = ("labels", "_packed", "_main_shape", "_cnt_shape")

    def __init__(self, labels, packed, main_shape, cnt_shape):
        self.labels = labels
        self._packed = packed
        self._main_shape = main_shape
        self._cnt_shape = cnt_shape

    def fetch(self):
        flat = self._packed.cpu().numpy()
        m = int(np.prod(self._main_shape))
        c = int(np.prod(self._cnt_shape))
        main = flat[:m].reshape(self._main_shape)
        cnt = flat[m:m + c].reshape(self._cnt_shape)
        vcnt = flat[m + c:].reshape(self._cnt_shape)
        return self.labels, main, cnt, vcnt


def _fmt_group_labels(values: np.ndarray, t: str) -> tuple[np.ndarray, list]:
    """Factorize a host column into int32 codes + formatted label strings,
    matching `engine_metrics._group_slots` label semantics exactly (object
    arrays go through astype("U"): None → "None")."""
    from tempo_tpu_torch.traceql.engine_metrics import _fmt_label

    if values.dtype == object:
        values = values.astype("U")
    u, inv = np.unique(values, return_inverse=True)
    labels = [_fmt_label(v, t) for v in u]
    return inv.reshape(-1).astype(np.int32), labels


class BlockScanPlane:
    """Device-resident scan cache for one immutable block.

    Columns adopt LAZILY: the first query touching a column pays one host
    materialization (via the same `eval_expr` path the numpy engine uses,
    so scoping/parent/intrinsic semantics are identical by construction)
    plus one upload; every later query reuses the device copy. A query's
    whole first pass then costs one fused sequence of device ops over the
    whole block, one packed literal upload and one small D2H.

    Numeric columns compare as exact int64 when integral (all intrinsics
    are); float-valued attribute columns ride the order-preserving int64
    encoding of their float64 bits; NaN-holding columns are refused
    (caller falls back to the float64 host plane).
    """

    def __init__(self, views: Sequence, mesh=None, device=None) -> None:
        from tempo_tpu_torch.device import resolve_device

        if mesh is not None:
            device = mesh.device(0, 0)     # the grid reduce's owner
        self.device = resolve_device(device)
        self.mesh = mesh
        # id() of the resident span-dimension columns (the ones a mesh
        # splits over 'data'); LUTs and literals replicate
        self._span_ids: set[int] = set()
        self._span_chunks: dict[int, list] = {}
        self.views = list(views)
        self.sizes = [int(v.n) for v in self.views]
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.sizes)]).astype(np.int64)
        self.n = int(self.offsets[-1])
        self.time_base_ns = 0
        self._cols: dict = {}          # (kind, key) → entry | None
        self._qr_cache: dict = {}
        self._lock = threading.RLock()
        self.device_bytes = 0
        self.host_bytes = 0            # adoption-side host copies (budget)
        # why the last metrics_grid call refused, + running cause counts
        self.last_fallback: "str | None" = None
        self.fallback_causes: dict = {}

    def _bail(self, reason: str) -> str:
        """Record a fused-path refusal cause and return it; `metrics_grid`
        surfaces the cause in its return value so callers never read it
        back off shared plane state (a concurrent query on the same
        cached plane could overwrite it in between)."""
        with self._lock:
            self.last_fallback = reason
            self.fallback_causes[reason] = \
                self.fallback_causes.get(reason, 0) + 1
        return reason

    # -- adoption ----------------------------------------------------------

    def _up(self, arr: np.ndarray, is_span_dim: bool = True):
        """One adoption upload (budget-accounted). `is_span_dim` names
        span-dimension columns, which a mesh splits over 'data': the
        shards on other devices than the owner's keep their chunk there."""
        d = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if self.mesh is not None and is_span_dim and \
                getattr(arr, "ndim", 0) >= 1 and arr.shape[0] == self.n:
            self._span_ids.add(id(d))
            self._span_chunks[id(d)] = [
                d[sl] if dev == self.device else d[sl].to(dev)
                for sl, dev in self._data_shards()]
        self.device_bytes += int(arr.nbytes)
        from tempo_tpu_torch.obs.runtime import record_device_put
        record_device_put(int(arr.nbytes), "plane_column")
        # per-request attribution: the query that forced this adoption
        # pays the upload — later queries ride the resident copy for free
        from tempo_tpu_torch.obs import querystats
        querystats.add(device_scan_bytes=int(arr.nbytes))
        return d

    def _data_shards(self) -> list[tuple[slice, torch.device]]:
        """(span slice, device) of each non-empty 'data' shard: chunks of
        whole bytes of the packed mask, the last one shorter."""
        dd = self.mesh.shape["data"]
        per = -(-self.n // dd)
        per = -(-per // 8) * 8
        return [(slice(d * per, min((d + 1) * per, self.n)),
                 self.mesh.device(d, 0))
                for d in range(dd) if d * per < self.n]

    def _shard_args(self, args, d: int, sl: slice, dev) -> list:
        """Data shard d's operands: its chunk of each span column, every
        other tensor on its device."""
        return [None if a is None else
                self._span_chunks[id(a)][d] if id(a) in self._span_ids
                else a.to(dev) for a in args]

    def _literals(self, ivals: list) -> torch.Tensor:
        """The one packed int64 literal vector of a call (one H2D)."""
        arr = np.asarray(ivals, np.int64)
        from tempo_tpu_torch.obs.runtime import record_device_put
        record_device_put(int(arr.nbytes), "plane_literals")
        return torch.from_numpy(arr).to(self.device)

    def _host_col(self, attr: A.Attribute) -> Optional[Col]:
        with self._lock:
            key = ("host", attr)
            if key in self._cols:
                return self._cols[key]
            cols = [eval_expr(v, attr) for v in self.views]
            t = cols[0].t if cols else NUM
            if not cols or any(c.t != t for c in cols):
                ent = None
            else:
                ent = Col(t, np.concatenate([c.values for c in cols]),
                          np.concatenate([c.exists for c in cols]))
                self.host_bytes += int(ent.values.nbytes + ent.exists.nbytes)
            self._cols[key] = ent
            return ent

    def _dict_fast(self, attr: A.Attribute):
        """(codes[int32], labels) for name/service straight from the
        views' dictionary codes (`fetch._dict_codes`) — an index remap
        instead of the generic object-array factorize (the hottest two
        columns). The reference reads Arrow's dictionary here
        (`_arrow_dict_fast`); codes may differ, labels may not."""
        if attr.intrinsic == A.Intrinsic.NAME:
            meta_key, ckey = "name_col", "name"
        elif (attr.intrinsic == A.Intrinsic.NONE
                and attr.name == "service.name"
                and attr.scope in (A.Scope.RESOURCE, A.Scope.NONE)):
            meta_key, ckey = "service_col", "service"
        else:
            return None
        parts = []
        block_ids: dict = {}
        for v in self.views:
            c = v.meta.get(meta_key)
            if c is None:
                return None
            codes, dvals = _dict_codes(v, ckey, c)
            lut = np.empty(len(dvals), np.int32)
            for i, s in enumerate(dvals):
                lut[i] = block_ids.setdefault(s, len(block_ids))
            parts.append(lut[codes] if len(dvals) else codes)
        labels = [s for s, _ in sorted(block_ids.items(),
                                       key=lambda kv: kv[1])]
        cat = (np.concatenate(parts) if parts
               else np.zeros(0, np.int32)).astype(np.int32)
        return cat, labels

    def _ensure_dict(self, attr: A.Attribute):
        """("dict", codes_dev, labels, exists_dev|None) for a STR column."""
        with self._lock:
            key = ("dict", attr)
            if key in self._cols:
                return self._cols[key]
            ent = None
            fast = self._dict_fast(attr)
            if fast is not None:
                codes, labels = fast
                ent = ("dict", self._up(codes), labels, None)
            else:
                c = self._host_col(attr)
                if c is not None and c.t == STR:
                    codes, labels = _fmt_group_labels(c.values, STR)
                    ex = None if c.exists.all() else self._up(c.exists)
                    ent = ("dict", self._up(codes), labels, ex)
            self._cols[key] = ent
            return ent

    def _ensure_int(self, attr: A.Attribute):
        """("int"|"flt", col_dev int64, exists|None, t) — exact numeric
        column.

        Integral columns keep their int64 value; genuinely FLOAT-valued
        columns are encoded as ORDER-PRESERVING int64 — the float64 bit
        pattern, with negatives reflected so the int order equals the
        float order (`_sortable_f64`). Literals map through the same
        encoding, so the int64 compare is bit-identical to the host
        engine's float64 compare. NaN values (no consistent order) fall
        back."""
        with self._lock:
            key = ("int", attr)
            if key in self._cols:
                return self._cols[key]
            c = self._host_col(attr)
            ent = None
            if c is not None and c.t in (NUM, STATUS, KIND, BOOL):
                vals = np.asarray(c.values)
                kind = "int"
                if vals.dtype == bool:
                    iv = vals.astype(np.int64)
                elif vals.dtype == object:
                    iv = None
                else:
                    v = vals.astype(np.float64)
                    chk = v[c.exists]
                    if np.isnan(chk).any():
                        iv = None              # NaN has no order: fallback
                    elif (np.isfinite(chk).all()
                            and (np.floor(chk) == chk).all()
                            and (np.abs(chk) < _INT_MAX).all()):
                        iv = np.where(c.exists, v, 0.0).astype(np.int64)
                    else:
                        kind = "flt"
                        iv = _sortable_f64(np.where(c.exists, v, 0.0))
                if iv is not None:
                    ex = None if c.exists.all() else self._up(c.exists)
                    ent = (kind, self._up(iv), ex, c.t)
            self._cols[key] = ent
            return ent

    def _host_group_codes(self, expr):
        """(codes[int32], labels, host_exists|None) for one by()-able key —
        ONE factorization (dictionary fast path or host np.unique), cached
        host-side (budget-accounted) and shared by the single-key upload
        and the multi-key composition."""
        with self._lock:
            key = ("hgroup", expr)
            if key in self._cols:
                return self._cols[key]
            ent = None
            if isinstance(expr, A.Attribute):
                fast = self._dict_fast(expr)
                if fast is not None:
                    ent = (fast[0], fast[1], None)
                else:
                    c = self._host_col(expr)
                    if c is not None and c.t in (STR, NUM, STATUS, KIND,
                                                 BOOL):
                        codes, labels = _fmt_group_labels(
                            np.asarray(c.values), c.t)
                        ent = (codes, labels,
                               None if c.exists.all() else c.exists)
            if ent is not None:
                self.host_bytes += int(ent[0].nbytes)
                if ent[2] is not None:
                    self.host_bytes += int(ent[2].nbytes)
            self._cols[key] = ent
            return ent

    def _ensure_group(self, expr):
        """("group", codes_dev int64, labels, exists_dev|None) for any
        by()-able column type (STR dict, status/kind/num/bool
        factorized)."""
        with self._lock:
            key = ("group", expr)
            if key in self._cols:
                return self._cols[key]
            h = self._host_group_codes(expr)
            ent = None
            if h is not None:
                codes, labels, hex_ = h
                ex = None if hex_ is None else self._up(hex_)
                ent = ("group", self._up(codes.astype(np.int64)), labels, ex)
            self._cols[key] = ent
            return ent

    # hard construction bound for composed multi-key grids: label lists
    # and code composition stay sane; the caller's max_groups applies per
    # query
    _GROUP2_BUILD_CAP = 1 << 20

    def _ensure_groupn(self, exprs):
        """("groupn", codes_dev, labels, exists|None) for a multi-key
        by() (2 or 3 keys): codes compose mixed-radix on host at adoption
        (c1*|d2|*|d3| + c2*|d3| + c3 — the engine's `group_slots`
        composition), labels are value tuples in the same slot order
        (itertools.product iterates the last key fastest, matching the
        composition). Unobserved combos cost grid rows but never emit
        (the obs-count gate)."""
        import itertools

        with self._lock:
            key = ("groupn",) + tuple(exprs)
            if key in self._cols:
                return self._cols[key]
            ent = None
            hs = [self._host_group_codes(e) for e in exprs]
            if all(h is not None for h in hs):
                prod = 1
                for h in hs:
                    prod *= len(h[1])
                if 0 < prod <= self._GROUP2_BUILD_CAP:
                    codes = np.zeros(self.n, np.int64)
                    for h in hs:
                        codes = codes * len(h[1]) + h[0]
                    labels = [tuple(p) for p in
                              itertools.product(*[h[1] for h in hs])]
                    ex = None
                    if any(h[2] is not None for h in hs):
                        both = np.ones(self.n, bool)
                        for h in hs:
                            if h[2] is not None:
                                both &= h[2]
                        ex = self._up(both)
                    ent = ("groupn", self._up(codes), labels, ex)
            self._cols[key] = ent
            return ent

    def _ensure_value(self, attr):
        """("val", f32_dev, bucket_dev, exists|None): the measured column of
        a metrics aggregate — f32 values (seconds for duration intrinsics,
        mirroring the engine's ns→s divide) + precomputed log2 buckets
        (exact: host float64 bucketing at adoption, ref `Log2Bucketize`
        engine_metrics.go:1392)."""
        from tempo_tpu_torch.traceql.engine_metrics import (_is_duration_attr,
                                                            log2_bucket_np)

        with self._lock:
            key = ("val", attr)
            if key in self._cols:
                return self._cols[key]
            ent = None
            c = self._host_col(attr) if isinstance(attr, A.Attribute) else None
            if c is not None and c.t == NUM and c.values.dtype != object:
                v = np.asarray(c.values, np.float64)
                buckets = log2_bucket_np(np.where(c.exists, v, 1.0))
                scaled = v / 1e9 if _is_duration_attr(attr) else v
                ex = None if c.exists.all() else self._up(c.exists)
                ent = ("val", self._up(scaled.astype(np.float32)),
                       self._up(buckets.astype(np.int64)), ex)
            self._cols[key] = ent
            return ent

    def _ensure_value_log(self, attr):
        """("vlog", z_dev, exists|None): clipped log values (ns domain)
        for the moments-tier quantile grid — host float64 log at
        adoption, f32 cast, the SAME computation MetricsEvaluator's
        dispatch applies to its staged values, so fused and host moment
        sums agree up to f32 scatter order (inside the moments error
        gate). Missing rows log a placeholder 1.0; the value-exists
        mask drops them before they reach the grid."""
        from tempo_tpu_torch.ops import moments as msk

        with self._lock:
            key = ("vlog", attr)
            if key in self._cols:
                return self._cols[key]
            ent = None
            c = self._host_col(attr) if isinstance(attr, A.Attribute) else None
            if c is not None and c.t == NUM and c.values.dtype != object:
                v = np.asarray(c.values, np.float64)
                z = np.log(np.clip(np.where(c.exists, v, 1.0),
                                   math.exp(msk.QUERY_LO),
                                   math.exp(msk.QUERY_HI))
                           ).astype(np.float32)
                ex = None if c.exists.all() else self._up(c.exists)
                ent = ("vlog", self._up(z), ex)
            self._cols[key] = ent
            return ent

    def _ensure_times(self) -> bool:
        """The block's start times as one resident int64 column."""
        with self._lock:
            if ("times",) in self._cols:
                return self._cols[("times",)] is not None
            cols = [v.col("__startTime") for v in self.views]
            if not cols or any(c is None for c in cols):
                self._cols[("times",)] = None
                return False
            starts = np.concatenate([np.asarray(c.values, np.float64)
                                     for c in cols]).astype(np.int64)
            self.time_base_ns = int(starts.min()) if len(starts) else 0
            self._cols[("times",)] = self._up(starts)
            return True

    def _ensure_rgids(self):
        with self._lock:
            if ("rgids",) in self._cols:
                return self._cols[("rgids",)]
            ids = np.repeat(np.arange(len(self.sizes), dtype=np.int32),
                            self.sizes)
            ent = self._cols[("rgids",)] = self._up(ids)
            return ent

    # -- plan compilation ---------------------------------------------------

    def _plan_pred(self, c) -> Optional[tuple]:
        """One Condition → (sig entry, args list, int literals) or None
        (unsupported)."""
        if not c.operands or not isinstance(c.attr, A.Attribute):
            return None
        static = c.operands[0]
        v = static.value
        # nil comparisons prune on the existence mask alone
        if getattr(static, "type", None) == A.StaticType.NIL:
            if c.op not in (A.Op.EQ, A.Op.NEQ):
                return (("const", False), [], [])
            host = self._host_col(c.attr)
            if host is None:
                return None
            want = c.op == A.Op.NEQ
            if host.exists.all():
                return (("const", want), [], [])
            with self._lock:
                ex = self._cols.get(("ex", c.attr))
                if ex is None:
                    ex = self._cols[("ex", c.attr)] = self._up(host.exists)
            return (("nil", want, True), [ex], [])
        lit_t = _STATIC_T.get(getattr(static, "type", None))
        if lit_t is None:
            return None
        if lit_t == STR:
            ent = self._ensure_dict(c.attr)
            if ent is None:
                # a scalar non-STR column compared to a string is
                # incomparable → constant false (the type lattice); list
                # and mixed columns fall back to the host plane
                host = self._host_col(c.attr)
                if host is not None and host.t in (NUM, STATUS, KIND, BOOL):
                    return (("const", False), [], [])
                return None
            # the uploaded lut is cached per (attr, op, value): repeated
            # queries pay ZERO H2D transfers for their predicates. The
            # cache stores (neg, lut) so _dict_term stays the single
            # source of negation truth; entries are budget-accounted and
            # capacity-capped
            lkey = ("plut", c.attr, c.op, v)
            with self._lock:
                cached = self._cols.get(lkey)
            if cached is None:
                term = _dict_term(c.op, v, ent[2])
                if term is None:
                    return None
                (kind, _, neg), lut = term
                lut_dev = self._up(lut, is_span_dim=False)
                with self._lock:
                    # re-check under the lock: a racing thread may have
                    # inserted the same key while we uploaded — keep its
                    # entry and refund our duplicate's budget accounting
                    again = self._cols.get(lkey)
                    if again is not None:
                        self.device_bytes -= int(lut.nbytes)
                        neg, lut_dev = again
                    else:
                        pluts = [k for k in self._cols if k[0] == "plut"]
                        if len(pluts) >= 256:
                            for k in pluts[:128]:
                                arr = self._cols.pop(k)[1]
                                self.device_bytes -= int(arr.nbytes)
                        self._cols[lkey] = (neg, lut_dev)
            else:
                neg, lut_dev = cached
            has_ex = ent[3] is not None
            args = [ent[1], lut_dev]
            if has_ex:
                args.append(ent[3])
            return (("lut", neg, has_ex), args, [])
        # numeric-family literal
        if c.op not in _NUM_OPS:
            return None
        ent = self._ensure_int(c.attr)
        if ent is None:
            host = self._host_col(c.attr)
            if host is not None and host.t == STR:
                return (("const", False), [], [])  # str col vs num literal
            return None                          # NaN column → host fallback
        ekind, col, ex, col_t = ent
        if col_t != lit_t:                       # distinct lattices → false
            return (("const", False), [], [])
        has_ex = ex is not None
        args = [col] + ([ex] if has_ex else [])
        if ekind == "flt":
            # float-valued column: the literal rides the same
            # order-preserving encoding, ops unchanged (monotone map)
            f = float(v if not isinstance(v, bool) else int(v))
            if f != f:                           # NaN literal: host plane
                return None
            lit = int(_sortable_f64(np.asarray([f]))[0])
            return (("icmp", c.op, has_ex), args, [lit])
        norm = _int_literal(c.op, v if not isinstance(v, bool) else int(v))
        if norm[0] == "const":
            if not norm[1] or ex is None:
                return (("const", norm[1]), [], [])
            # the literal-compare is constant-TRUE for every present value
            # (e.g. `.x != 1.5` on an int column), but spans missing the
            # attribute must still be excluded — the host plane ANDs
            # l.exists (eval._compare) — so emit the existence mask, not
            # a bare const
            return (("nil", True, True), [ex], [])
        _, op2, lit = norm
        return (("icmp", op2, has_ex), args, [lit])

    def _plan(self, preds: Sequence, all_conditions: bool):
        sig, args, ints = [], [], []
        for c in preds:
            got = self._plan_pred(c)
            if got is None:
                return None
            sig.append(got[0])
            args.extend(got[1])
            ints.extend(got[2])
        return tuple(sig), args, ints

    def _ensure_rg_lut(self, row_groups):
        key = ("rglut", tuple(row_groups))
        with self._lock:
            got = self._cols.get(key)
        if got is None:
            lut = np.zeros(len(self.sizes), bool)
            sel = [g for g in row_groups if 0 <= g < len(self.sizes)]
            if sel:
                lut[np.asarray(sel)] = True
            got = self._up(lut, is_span_dim=False)
            with self._lock:
                again = self._cols.get(key)
                if again is not None:         # lost an upload race: refund
                    self.device_bytes -= int(lut.nbytes)
                    got = again
                else:
                    rgluts = [k for k in self._cols if k[0] == "rglut"]
                    if len(rgluts) >= 64:
                        for k in rgluts[:32]:
                            self.device_bytes -= int(
                                self._cols.pop(k).numel())
                    self._cols[key] = got
        return got

    def _extra_terms(self, time_range, row_groups):
        """Always-AND terms: exact time clip + row-group shard selection.
        Returns (sig, device args, int literals)."""
        sig, args, ints = [], [], []
        if time_range is not None and any(time_range):
            lo_ns, hi_ns = time_range
            if not self._ensure_times():
                return None
            times = self._cols[("times",)]
            # the host plane compares float64 start values against the
            # literal PROMOTED to float64; round the clip bounds the same
            # way so boundary spans classify identically on both paths
            if lo_ns:
                sig.append(("icmp", A.Op.GTE, False))
                args.append(times)
                ints.append(int(np.float64(lo_ns)))
            if hi_ns:
                sig.append(("icmp", A.Op.LT, False))
                args.append(times)
                ints.append(int(np.float64(hi_ns)))
        if row_groups is not None:
            sig.append(("lut", None, False))
            args.extend([self._ensure_rgids(),
                         self._ensure_rg_lut(row_groups)])
        return tuple(sig), args, ints

    # -- masks --------------------------------------------------------------

    def mask_async(self, preds: Sequence, all_conditions: bool,
                   time_range=None, row_groups=None):
        """Launch the fused block mask; returns a BIT-PACKED device tensor
        (uint8, big-endian bit order — unpack with `unpack_mask`) or None
        when a predicate shape is unsupported. No sync, no D2H; a single
        packed-literal H2D rides along with the call."""
        plan = self._plan(list(preds), all_conditions)
        if plan is None:
            return None
        extra = self._extra_terms(time_range, row_groups)
        if extra is None:
            return None
        sig, args, ints = plan
        esig, eargs, eints = extra
        ivec = self._literals(ints + eints)
        # query-class job on the shared device scheduler: live-ingest
        # batches order ahead of scans, the dispatch is accounted, and
        # the launch stays async (the handle returns without a sync)
        from tempo_tpu_torch import sched
        if self.mesh is not None:
            return sched.run(lambda: self._mask_mesh(
                sig, esig, all_conditions, ivec, (*args, *eargs)),
                kernel="plane_packed_mask")
        fn = _block_mask_kernel(self.n, sig, esig, all_conditions)
        return sched.run(lambda: fn(ivec, *args, *eargs),
                         kernel="plane_packed_mask")

    def _mask_mesh(self, sig, esig, all_conditions, ivec, args):
        """The packed mask over the 'data' shards: each shard's chunk
        masked on its device, the packed bytes joined on the owner."""
        parts = []
        for d, (sl, dev) in enumerate(self._data_shards()):
            fn = _block_mask_kernel(sl.stop - sl.start, sig, esig,
                                    all_conditions)
            parts.append(fn(ivec.to(dev),
                            *self._shard_args(args, d, sl, dev))
                         .to(self.device))
        return torch.cat(parts)

    def mask(self, preds: Sequence, all_conditions: bool,
             time_range=None, row_groups=None) -> Optional[np.ndarray]:
        from tempo_tpu_torch.obs import querystats

        m = self.mask_async(preds, all_conditions, time_range, row_groups)
        if m is None:
            return None
        t0 = time.perf_counter_ns()
        with querystats.stage("device_scan"):
            packed = m.cpu().numpy()      # the sync point: device → host
        querystats.add(kernel_wall_ns=time.perf_counter_ns() - t0)
        return self.unpack_mask(packed)

    def unpack_mask(self, packed) -> np.ndarray:
        """Bit-packed device mask → bool[n]."""
        if isinstance(packed, torch.Tensor):
            packed = packed.cpu().numpy()
        return np.unpackbits(np.asarray(packed, np.uint8))[:self.n] \
            .astype(bool)

    def split_mask(self, packed) -> list[np.ndarray]:
        """Bit-packed block mask → per-row-group candidate row arrays."""
        mask = self.unpack_mask(packed)
        return [np.flatnonzero(mask[self.offsets[i]:self.offsets[i + 1]])
                for i in range(len(self.sizes))]

    # -- fused metrics grid -------------------------------------------------

    def metrics_grid(self, m, preds: Sequence, all_conditions: bool,
                     start_ns: int, end_ns: int, step_ns: int,
                     clip_start_ns: int | None = None,
                     clip_end_ns: int | None = None,
                     row_groups=None, max_groups: int = 65536,
                     moments: bool = False):
        """The FULL device metrics path: predicate mask → exact time clip →
        step bucketing → per-group scatter into device grids, over the
        resident block with zero host work per span. Covers every
        `*_over_time` kind including the log2-bucket histogram axis behind
        `quantile_over_time` / `histogram_over_time` (ref `Log2Bucketize`
        engine_metrics.go:1392) and the moments tier.

        `m` is the A.MetricsAggregate. Returns `(handle, cause)`:
        `(None, cause)` when any shape is unsupported (caller falls back
        to the host engine; `cause` is the refusal reason), else
        `(handle, None)` — a GridHandle whose fetch() yields
        (group_label_list, main_grid, obs_count_grid, value_count_grid):
          count/rate       main [G, steps] counts
          min/max/sum/avg  main [G, steps]
          quantile/hist    main [G, steps, 64] bucket counts
          moments tier     main [G, steps, k+3]
        obs counts gate series emission (group matched the filter);
        value counts back avg's companion `__meta: count` series.

        Per call, H2D is ONE packed int64 literal vector; D2H is ONE
        packed grid (the three grids concatenate raveled). Launches are
        async — the caller launches every block's grid before fetching
        any (`db/tempodb.py`).

        The step index is the exact integer floor((t_ns - start_ns) /
        step_ns) on int64, for every window: the reference needs its
        16-bit-limb snap (and an `exact` guard on the window's size) only
        because the TPU has no int64.
        """
        kind_tag = {
            A.MetricsKind.RATE: "count",
            A.MetricsKind.COUNT_OVER_TIME: "count",
            A.MetricsKind.MIN_OVER_TIME: "min",
            A.MetricsKind.MAX_OVER_TIME: "max",
            A.MetricsKind.SUM_OVER_TIME: "sum",
            A.MetricsKind.AVG_OVER_TIME: "avg",
            A.MetricsKind.QUANTILE_OVER_TIME: "hist",
            A.MetricsKind.HISTOGRAM_OVER_TIME: "hist",
        }.get(m.kind)
        if moments and m.kind == A.MetricsKind.QUANTILE_OVER_TIME:
            # moments query tier: quantile accumulates a [G, steps, k+3]
            # moment grid (k+1 Chebyshev sums + the two support-bound
            # planes) instead of the log2 bucket axis
            kind_tag = "mom"
        if kind_tag is None or step_ns <= 0 or end_ns <= start_ns:
            return None, self._bail("shape")
        if len(m.by) > 3:
            return None, self._bail("group")
        if not self._ensure_times():
            return None, self._bail("times")

        plan = self._plan(list(preds), all_conditions)
        if plan is None:
            return None, self._bail("predicate")
        clip_lo = max(start_ns, clip_start_ns or start_ns)
        clip_hi = min(end_ns, clip_end_ns or end_ns)
        extra = self._extra_terms((clip_lo, clip_hi), row_groups)
        if extra is None:
            return None, self._bail("times")
        sig, args, ints = plan
        esig, eargs, eints = extra

        if len(m.by) >= 2:
            gent = self._ensure_groupn(tuple(m.by))
            if gent is None or len(gent[2]) > max_groups:
                return None, self._bail("group")
            _, gcodes, glabels, gex = gent
        elif m.by:
            gent = self._ensure_group(m.by[0])
            if gent is None or len(gent[2]) > max_groups:
                return None, self._bail("group")
            _, gcodes, glabels, gex = gent
        else:
            gcodes, glabels, gex = None, [None], None

        from tempo_tpu_torch.ops import moments as _mom
        mom_k = _mom.QUERY_K
        mom_cols = mom_k + 3
        needs_value = kind_tag in ("min", "max", "sum", "avg", "hist", "mom")
        vcol = vex = None
        if needs_value:
            if m.attr is None:
                return None, self._bail("value")
            if kind_tag == "mom":
                vent = self._ensure_value_log(m.attr)
                if vent is None:
                    return None, self._bail("value")
                _, vcol, vex = vent
            else:
                vent = self._ensure_value(m.attr)
                if vent is None:
                    return None, self._bail("value")
                _, vvals, vbuckets, vex = vent
                vcol = vbuckets if kind_tag == "hist" else vvals

        n_steps = max(int(-(-(end_ns - start_ns) // step_ns)), 1)
        n_groups = len(glabels)
        grid_width = {"hist": 64, "mom": mom_cols}.get(kind_tag, 1)
        if n_groups * n_steps * grid_width * 4 > 1 << 28:
            return None, self._bail("grid_size")
        # the reference refuses windows whose whole-step offset from the
        # block's first span overflows its int32 step math; the port's
        # int64 step would not, but refuses the same shapes so that both
        # packages fall back on the same queries
        delta_ns = self.time_base_ns - start_ns
        if abs(delta_ns // step_ns) > 1 << 30:
            return None, self._bail("window")

        key = (sig, esig, all_conditions, kind_tag, n_groups, n_steps,
               gcodes is not None, gex is not None, vex is not None)
        with self._lock:
            fn = self._qr_cache.get(key)
        if fn is None:
            fn = _grid_fn(self.n, sig, esig, all_conditions, kind_tag,
                          n_groups, n_steps, mom_k)
            with self._lock:
                if len(self._qr_cache) >= 64:
                    self._qr_cache.pop(next(iter(self._qr_cache)))
                fn = self._qr_cache.setdefault(key, fn)

        ivec = self._literals([start_ns, step_ns] + ints + eints)
        times = self._cols[("times",)]
        main_shape = ((n_groups, n_steps, 64) if kind_tag == "hist"
                      else (n_groups, n_steps, mom_cols)
                      if kind_tag == "mom" else (n_groups, n_steps))
        # fused grid launch rides the scheduler's query class (async —
        # the GridHandle fetch is the only sync point)
        from tempo_tpu_torch import sched
        if self.mesh is not None:
            packed = sched.run(lambda: self._grid_mesh(
                key, (sig, esig, all_conditions, kind_tag, n_groups,
                      n_steps, mom_k), main_shape,
                (times, ivec, gcodes, gex, vcol, vex, *args, *eargs)),
                kernel="plane_query_range_grid")
        else:
            packed = sched.run(
                lambda: fn(times, ivec, gcodes, gex, vcol, vex, *args,
                           *eargs),
                kernel="plane_query_range_grid")
        return GridHandle(glabels, packed, main_shape,
                          (n_groups, n_steps)), None

    def _grid_mesh(self, key, shape_args, main_shape, args):
        """The packed grid over the 'data' shards: each shard's grid from
        its chunk on its device, reduced on the owner in shard order —
        counts and sums add, min/max grids take the min/max, the moments
        grid's sums add and its two bound planes take the max."""
        kind_tag, mom_k = shape_args[3], shape_args[6]
        m = int(np.prod(main_shape))
        acc = None
        for d, (sl, dev) in enumerate(self._data_shards()):
            n_d = sl.stop - sl.start
            ck = key + ("mesh", n_d)
            with self._lock:
                fn = self._qr_cache.get(ck)
            if fn is None:
                fn = _grid_fn(n_d, *shape_args)
                with self._lock:
                    fn = self._qr_cache.setdefault(ck, fn)
            part = fn(*self._shard_args(args, d, sl, dev)).to(self.device)
            if acc is None:
                acc = part
                continue
            main, rest = acc[:m], acc[m:] + part[m:]
            if kind_tag == "min":
                main = torch.minimum(main, part[:m])
            elif kind_tag == "max":
                main = torch.maximum(main, part[:m])
            elif kind_tag == "mom":
                a, b = main.view(-1, mom_k + 3), part[:m].view(-1, mom_k + 3)
                main = torch.cat([a[:, :mom_k + 1] + b[:, :mom_k + 1],
                                  torch.maximum(a[:, mom_k + 1:],
                                                b[:, mom_k + 1:])],
                                 dim=1).reshape(-1)
            else:
                main = main + part[:m]
            acc = torch.cat([main, rest])
        return acc

    # -- back-compat wrapper (bench/tests of the reference) -----------------

    def query_range_grid(self, preds: Sequence, all_conditions: bool,
                         group: str | None, start_ns: int, end_ns: int,
                         step_ns: int):
        """rate/count grid keyed by the legacy "name"/"service" group
        names; returns (labels, grid ndarray) or None."""
        by = ()
        if group == "name":
            by = (A.Attribute.intrinsic_of(A.Intrinsic.NAME),)
        elif group == "service":
            by = (A.Attribute("service.name", A.Scope.RESOURCE),)
        m = A.MetricsAggregate(kind=A.MetricsKind.COUNT_OVER_TIME, by=by)
        got, _cause = self.metrics_grid(m, preds, all_conditions, start_ns,
                                        end_ns, step_ns)
        if got is None:
            return None
        labels, main, _cnt, _vcnt = got.fetch()
        return labels, main


def _grid_fn(n: int, sig: tuple, esig: tuple, all_conditions: bool,
             kind_tag: str, n_groups: int, n_steps: int, mom_k: int):
    """The fused metrics grid of one plan shape: mask → exact step →
    group scatter → one packed f32 vector [main | obs counts | value
    counts]. Every grid carries a trash row (index `n_groups`) that
    rejected rows hit; no op selects by a boolean mask or reads back."""
    G1 = n_groups + 1
    f32 = torch.float32

    def build(times, ivec, gcodes, gex, vcol, vex, *margs):
        device = times.device
        pred_masks, used, k = _term_masks(sig, margs, n, ivec, 2, device)
        extra_masks, _, _ = _term_masks(esig, margs[used:], n, ivec, k,
                                        device)
        mask = _combine(pred_masks, extra_masks, all_conditions, n, device)
        # the exact integer step: floor((t_ns - start_ns) / step_ns)
        step_idx = torch.div(times - ivec[0], ivec[1], rounding_mode="floor")
        ok = mask & (step_idx >= 0) & (step_idx < n_steps)
        if gcodes is not None:
            slots = gcodes
            if gex is not None:
                ok = ok & gex
        else:
            slots = torch.zeros(n, dtype=torch.int64, device=device)
        steps = torch.clamp(step_idx, 0, n_steps - 1)
        trash = torch.full_like(slots, n_groups)
        # obs counts IGNORE the value-exists mask: the host engine
        # registers a group's series when any span matches the filter,
        # even if the measured attribute is missing on all of them
        obs_cells = torch.where(ok, slots, trash) * n_steps + steps
        cnt = torch.zeros(G1 * n_steps, dtype=f32, device=device)
        cnt.index_add_(0, obs_cells, ok.to(f32))

        def pack(main, vcnt):
            # one dtype for the packed D2H: the moments grid's float64
            return torch.cat([main.reshape(G1, -1)[:n_groups].reshape(-1),
                              cnt.view(G1, n_steps)[:n_groups].reshape(-1)
                              .to(main.dtype),
                              vcnt.view(G1, n_steps)[:n_groups].reshape(-1)
                              .to(main.dtype)])

        if kind_tag == "count":
            return pack(cnt, cnt)
        okv = ok & vex if vex is not None else ok
        cells = torch.where(okv, slots, trash) * n_steps + steps
        ones = okv.to(f32)
        if kind_tag == "hist":
            grid = torch.zeros(G1 * n_steps * 64, dtype=f32, device=device)
            grid.index_add_(0, cells * 64 + vcol, ones)
            return pack(grid, cnt)
        if kind_tag == "mom":
            # vcol is the clipped log-ns value; the Chebyshev recurrence
            # runs on device — the SAME basis the host evaluator scatters
            # — and the two support-bound planes ride the last two columns
            # (add-merge sums, max-merge bounds)
            from tempo_tpu_torch.ops import moments as _mom
            c0 = torch.tensor((_mom.QUERY_LO + _mom.QUERY_HI) / 2.0,
                              dtype=f32, device=device)
            h0 = torch.tensor((_mom.QUERY_HI - _mom.QUERY_LO) / 2.0,
                              dtype=f32, device=device)
            sb = torch.clamp((vcol - c0) / h0, -1.0, 1.0)
            basis = torch.stack(_mom.chebyshev_basis(sb, mom_k), dim=-1)
            # float64 sums: atomic order then moves a sum by ~1e-16 of
            # its size instead of f32 rounding, which the maxent solve
            # amplifies (ROADMAP section 3, "Moments quantiles")
            f64 = torch.float64
            sums = torch.zeros(G1 * n_steps, mom_k + 1, dtype=f64,
                               device=device)
            sums.index_add_(0, cells, basis.to(f64))
            hi = torch.zeros(G1 * n_steps, dtype=f32, device=device)
            hi.scatter_reduce_(0, cells, vcol - torch.tensor(
                _mom.QUERY_LO, dtype=f32, device=device), "amax",
                include_self=True)
            lo = torch.zeros(G1 * n_steps, dtype=f32, device=device)
            lo.scatter_reduce_(0, cells, torch.tensor(
                _mom.QUERY_HI, dtype=f32, device=device) - vcol, "amax",
                include_self=True)
            grid = torch.cat([sums, hi[:, None].to(f64),
                              lo[:, None].to(f64)], dim=1)
            return pack(grid, cnt)
        if kind_tag in ("min", "max"):
            fill = math.inf if kind_tag == "min" else -math.inf
            grid = torch.full((G1 * n_steps,), fill, dtype=f32, device=device)
            grid.scatter_reduce_(0, cells, vcol,
                                 "amin" if kind_tag == "min" else "amax",
                                 include_self=True)
            return pack(grid, cnt)
        grid = torch.zeros(G1 * n_steps, dtype=f32, device=device)
        grid.index_add_(0, cells, torch.where(okv, vcol, torch.zeros_like(vcol)))
        if kind_tag == "avg":
            # avg's companion count series counts VALUED spans only
            vcnt = torch.zeros(G1 * n_steps, dtype=f32, device=device)
            vcnt.index_add_(0, cells, ones)
            return pack(grid, vcnt)
        return pack(grid, cnt)

    return build
