"""Per-block sketch sidecars: mergeable summaries next to each block.

A sidecar (`sidecar.json` under the block's keypath) holds one moments
row (`ops/moments.py`, k+3 floats, QUERY domain) per (service, name)
series over span durations, plus one HLL register row over trace ids
(`ops/sketches.py`). Both planes merge across blocks elementwise
(sums add, bounds/registers max), so a historical
`quantile_over_time`/`rate` over N blocks is an O(series) fold of N
tiny JSON objects instead of N span re-scans.

The fold emits **job-level TimeSeries in the exact shape
`MetricsEvaluator.results()` produces** — `__moment`-labeled moment
columns + "hi"/"lo" bound series for quantiles, plain count series for
rate — so the frontend's `SeriesCombiner` and the maxent final pass
(`_quantile_series`) consume them unchanged alongside scanned-block
and generator sub-results. The per-step placement assumes the block's
spans are uniformly distributed over `[meta.start_time,
meta.end_time]` (exact when a block falls inside one step, the normal
shape for historical dashboard steps ≫ block duration); the runbook
documents the approximation.

Only queries the sidecar can answer are eligible (`eligible_plan`):
`rate()` / `quantile_over_time(duration, ...)` with no span filters
and `by()` restricted to the two label axes the sidecar keys on.
Everything else — and any block without a readable, domain-matching
sidecar — falls back to the host scan path, counted by the caller.

Counterpart of `tempo_tpu/block/sidecar.py`; the two packages read and
write the same `sidecar.json` bytes. The read half (decode, the
eligibility plan, the per-block fold, the merge) is host numpy, copied.
The write half (`build_sidecar`, `sidecar_from_traces`) runs its sketch
pass on a device (`ops.compact.build_sidecar_arrays`: `cuda` unless
`device="cpu"`): HLL registers bit-identical to the reference's, moment
counts and bounds exact, moment sums within f32 reduction order.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from tempo_tpu_torch.ops import moments as msk
from tempo_tpu_torch.ops.compact import SIDECAR_HLL_PRECISION, build_sidecar_arrays

SIDECAR_NAME = "sidecar.json"
SIDECAR_VERSION = 1

_SERVICE_LABEL = "resource.service.name"
_NAME_LABEL = "name"
_LABEL_MOMENT = "__moment"   # mirror of engine_metrics._LABEL_MOMENT


@dataclasses.dataclass
class Sidecar:
    """Decoded sidecar: series label keys + their moment rows + the
    block-level HLL trace-cardinality registers."""

    k: int
    lo: float
    hi: float
    total_spans: int
    series: list            # [(service, name), ...]
    rows: np.ndarray        # [len(series), k+3] float64
    hll: np.ndarray         # [2^precision] int32
    hll_precision: int = SIDECAR_HLL_PRECISION

    def to_json(self) -> bytes:
        return json.dumps({
            "version": SIDECAR_VERSION,
            "k": self.k, "lo": self.lo, "hi": self.hi,
            "total_spans": self.total_spans,
            "series": [
                {"service": s, "name": n,
                 "row": [float(v) for v in self.rows[i]]}
                for i, (s, n) in enumerate(self.series)],
            "hll": {"precision": self.hll_precision,
                    "registers": [int(v) for v in self.hll]},
        }).encode()

    @staticmethod
    def from_json(data: bytes) -> "Sidecar":
        d = json.loads(data)
        if d.get("version") != SIDECAR_VERSION:
            raise ValueError(f"unknown sidecar version {d.get('version')!r}")
        series = [(s["service"], s["name"]) for s in d["series"]]
        k = int(d["k"])
        rows = np.zeros((len(series), msk.n_cols(k)), np.float64)
        for i, s in enumerate(d["series"]):
            rows[i] = np.asarray(s["row"], np.float64)
        return Sidecar(
            k=k, lo=float(d["lo"]), hi=float(d["hi"]),
            total_spans=int(d["total_spans"]), series=series, rows=rows,
            hll=np.asarray(d["hll"]["registers"], np.int32),
            hll_precision=int(d["hll"]["precision"]))

    def trace_cardinality(self) -> float:
        """HLL distinct-trace estimate for this block (or a merged row).
        It reads the decoded JSON's registers, not device state: the
        port's `hll_estimate` runs on them as a CPU tensor."""
        import torch

        from tempo_tpu_torch.ops import sketches as sk

        state = sk.HyperLogLog(
            registers=torch.from_numpy(
                np.ascontiguousarray(self.hll[None, :], np.int32)),
            precision=self.hll_precision)
        return float(sk.hll_estimate(state)[0])


def build_sidecar(service: np.ndarray, name: np.ndarray,
                  duration_ns: np.ndarray, trace_id: np.ndarray,
                  device=None) -> Sidecar:
    """One sketch pass on `device` over block-resident label/duration/
    trace columns.

    `service`/`name` are per-span label arrays (any dtype castable to
    str); rows are keyed by the dense (service, name) set.
    """
    n = len(duration_ns)
    if n == 0:
        return Sidecar(k=msk.QUERY_K, lo=msk.QUERY_LO, hi=msk.QUERY_HI,
                       total_spans=0, series=[],
                       rows=np.zeros((0, msk.n_cols(msk.QUERY_K)), np.float64),
                       hll=np.zeros(1 << SIDECAR_HLL_PRECISION, np.int32))
    svc = np.asarray(service).astype("U")
    nam = np.asarray(name).astype("U")
    su, si = np.unique(svc, return_inverse=True)
    nu, ni = np.unique(nam, return_inverse=True)
    comp = si.astype(np.int64) * len(nu) + ni
    ucomp, inv = np.unique(comp, return_inverse=True)
    series = [(str(su[c // len(nu)]), str(nu[c % len(nu)]))
              for c in ucomp.tolist()]
    rows, hll = build_sidecar_arrays(
        inv.astype(np.int32), np.asarray(duration_ns, np.int64),
        len(series), trace_id, msk.QUERY_K, msk.QUERY_LO, msk.QUERY_HI,
        device=device)
    return Sidecar(k=msk.QUERY_K, lo=msk.QUERY_LO, hi=msk.QUERY_HI,
                   total_spans=n, series=series,
                   rows=np.asarray(rows, np.float64), hll=hll)


def sidecar_from_traces(traces, device=None) -> Sidecar:
    """Build from writer-shaped input: [(trace_id bytes, [span dict])]."""
    svc, nam, dur, tid = [], [], [], []
    for t, spans in traces:
        for s in spans:
            svc.append(s.get("service", ""))
            nam.append(s.get("name", ""))
            dur.append(int(s.get("end_unix_nano", 0))
                       - int(s.get("start_unix_nano", 0)))
            tid.append(np.frombuffer(t, np.uint8))
    if not dur:
        return build_sidecar(np.zeros(0, "U1"), np.zeros(0, "U1"),
                             np.zeros(0, np.int64), np.zeros((0, 16), np.uint8),
                             device=device)
    return build_sidecar(np.asarray(svc), np.asarray(nam),
                         np.asarray(dur, np.int64), np.stack(tid),
                         device=device)


# ---------------------------------------------------------------------------
# object-store I/O
# ---------------------------------------------------------------------------

def write_sidecar(w, tenant: str, block_id: str, sc: Sidecar) -> None:
    from tempo_tpu_torch.backend.raw import block_keypath

    w.write(SIDECAR_NAME, block_keypath(block_id, tenant), sc.to_json())


def read_sidecar(r, tenant: str, block_id: str) -> Sidecar | None:
    """None when absent or unreadable — callers fall back to the scan."""
    from tempo_tpu_torch.backend.raw import DoesNotExist, block_keypath

    try:
        data = r.read(SIDECAR_NAME, block_keypath(block_id, tenant))
    except DoesNotExist:
        return None
    try:
        return Sidecar.from_json(data)
    except (ValueError, KeyError, TypeError):
        return None


# ---------------------------------------------------------------------------
# query eligibility + the per-block fold
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FoldPlan:
    quantile: bool            # quantile_over_time(duration, ...) vs rate()
    group_names: tuple        # str(by-expr) per by() key, in order
    group_axes: tuple         # matching axis per key: "service" | "name"


def eligible_plan(query: str) -> FoldPlan | None:
    """A FoldPlan when the sidecar planes can answer `query` exactly
    as grouped/keyed; None sends every block to the scan path."""
    from tempo_tpu_torch.traceql import ast as A
    from tempo_tpu_torch.traceql.conditions import extract_conditions
    from tempo_tpu_torch.traceql.engine_metrics import _is_duration_attr
    from tempo_tpu_torch.traceql.parser import parse

    try:
        q = parse(query)
    except Exception:
        return None
    m = q.metrics
    if m is None:
        return None
    if m.kind == A.MetricsKind.QUANTILE_OVER_TIME:
        if not _is_duration_attr(m.attr):
            return None
        quantile = True
    elif m.kind == A.MetricsKind.RATE:
        quantile = False
    else:
        return None
    fetch = extract_conditions(q)
    # only the unfiltered selection: any real span predicate (op set)
    # or a pipeline the pushdown can't cover means the sidecar's
    # all-spans rows are the wrong population
    if not fetch.all_conditions:
        return None
    if any(c.op is not None for c in fetch.conditions):
        return None
    axes = []
    for e in m.by:
        name = str(e)
        if name == _SERVICE_LABEL:
            axes.append("service")
        elif name == _NAME_LABEL:
            axes.append("name")
        else:
            return None
    return FoldPlan(quantile=quantile,
                    group_names=tuple(str(e) for e in m.by),
                    group_axes=tuple(axes))


def _step_fractions(req, meta, clip_end_ns: int | None) -> np.ndarray:
    """Per-step fraction of the block's span mass, assuming uniform
    distribution over [meta.start_time, meta.end_time], clipped to the
    request's observation window. Sums to ≤ 1."""
    bs = meta.start_time * 1e9
    be = max(meta.end_time * 1e9, bs)
    w0 = float(req.start_ns)
    w1 = float(min(req.end_ns, clip_end_ns) if clip_end_ns else req.end_ns)
    n = req.n_steps
    frac = np.zeros(n, np.float64)
    if w1 <= w0:
        return frac
    if be <= bs:   # zero-duration block: all mass at the bs instant
        if w0 <= bs < w1:
            i = min(int((bs - req.start_ns) // req.step_ns), n - 1)
            frac[i] = 1.0
        return frac
    edges = req.start_ns + np.arange(n + 1, dtype=np.float64) * req.step_ns
    s0 = np.maximum(np.maximum(edges[:-1], bs), w0)
    s1 = np.minimum(np.minimum(edges[1:], be), w1)
    np.maximum(s1 - s0, 0.0, out=s0)
    return s0 / (be - bs)


def fold_series(sc: Sidecar, meta, req, plan: FoldPlan,
                clip_end_ns: int | None = None) -> "list | None":
    """One block's sidecar → job-level TimeSeries for the combiner.

    None when the sidecar's sketch domain doesn't match the query tier
    (caller falls back to the scan); an empty list is a valid answer
    (block contributes nothing to the window).
    """
    from tempo_tpu_torch.traceql.engine_metrics import TimeSeries

    if plan.quantile and (sc.k != msk.QUERY_K
                          or not math.isclose(sc.lo, msk.QUERY_LO)
                          or not math.isclose(sc.hi, msk.QUERY_HI)):
        return None
    frac = _step_fractions(req, meta, clip_end_ns)
    if not frac.any() or not len(sc.series):
        return []
    touched = frac > 0.0

    # group the sidecar rows by the plan's axes (merge = add + bound max)
    groups: dict[tuple, np.ndarray] = {}
    for i, (svc, nam) in enumerate(sc.series):
        vals = {"service": svc, "name": nam}
        key = tuple((gn, vals[ax])
                    for gn, ax in zip(plan.group_names, plan.group_axes))
        cur = groups.get(key)
        groups[key] = (sc.rows[i].copy() if cur is None
                       else msk.moments_merge_rows(cur, sc.rows[i], sc.k))

    out: list = []
    for key, row in sorted(groups.items()):
        if row[0] <= 0.0:
            continue
        if not plan.quantile:
            out.append(TimeSeries(key, row[0] * frac))
            continue
        for j in range(sc.k + 1):
            if row[j] != 0.0:
                out.append(TimeSeries(key + ((_LABEL_MOMENT, str(j)),),
                                      row[j] * frac))
        out.append(TimeSeries(key + ((_LABEL_MOMENT, "hi"),),
                              np.where(touched, row[sc.k + 1], 0.0)))
        out.append(TimeSeries(key + ((_LABEL_MOMENT, "lo"),),
                              np.where(touched, row[sc.k + 2], 0.0)))
    return out


def merge_sidecars(a: Sidecar, b: Sidecar) -> Sidecar:
    """Elementwise fold of two sidecars (backfill/compaction roll-up):
    rows add (bounds max) per series key, HLL registers max."""
    if (a.k, a.lo, a.hi) != (b.k, b.lo, b.hi) \
            or a.hll_precision != b.hll_precision:
        raise ValueError("sidecar merge: mismatched sketch domains")
    idx = {key: i for i, key in enumerate(a.series)}
    series = list(a.series)
    rows = [a.rows[i].copy() for i in range(len(a.series))]
    for j, key in enumerate(b.series):
        i = idx.get(key)
        if i is None:
            idx[key] = len(series)
            series.append(key)
            rows.append(b.rows[j].copy())
        else:
            rows[i] = msk.moments_merge_rows(rows[i], b.rows[j], a.k)
    return Sidecar(
        k=a.k, lo=a.lo, hi=a.hi,
        total_spans=a.total_spans + b.total_spans, series=series,
        rows=(np.stack(rows) if rows
              else np.zeros((0, msk.n_cols(a.k)), np.float64)),
        hll=np.maximum(a.hll, b.hll), hll_precision=a.hll_precision)


__all__ = ["Sidecar", "SIDECAR_NAME", "build_sidecar", "sidecar_from_traces",
           "write_sidecar", "read_sidecar", "eligible_plan", "FoldPlan",
           "fold_series", "merge_sidecars"]
