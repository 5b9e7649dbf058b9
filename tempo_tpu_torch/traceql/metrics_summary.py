"""Span-metrics summary: the second metrics engine (`pkg/traceqlmetrics`).

Powers `GetMetrics` / the span-metrics-summary API: per-series fixed
64-bucket power-of-two latency histograms (`LatencyHistogram`
`pkg/traceqlmetrics/metrics.go:17-98`), series keyed by up to 5 group-by
attributes (`metrics.go:100-130`), driven by a TraceQL filter with a
second-pass fetch (`GetMetrics` `metrics.go:182-330`).

Vectorized: bucket = ceil(log2(duration_ns)) for a whole column at once;
per-series accumulation is one bincount per series into 64 buckets —
the vectorized analog of the per-span `Record` loop.

Counterpart of `tempo_tpu/traceql/metrics_summary.py` (host numpy,
copied).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.engine import compile_query
from tempo_tpu_torch.traceql.eval import (ColumnView, attr_key, eval_expr,
                                          resolve_attr)

N_BUCKETS = 64
MAX_GROUP_BY = 5


def bucketize_ns(duration_ns: np.ndarray) -> np.ndarray:
    """Power-of-2 bucket index: smallest b with 2^b >= d (0 for d<=1),
    matching `Record` `metrics.go:41-57`."""
    d = np.maximum(np.asarray(duration_ns, np.float64), 1.0)
    return np.clip(np.ceil(np.log2(d)), 0, N_BUCKETS - 1).astype(np.int64)


@dataclasses.dataclass
class LatencyHistogram:
    buckets: np.ndarray  # [64] int64

    @staticmethod
    def empty() -> "LatencyHistogram":
        return LatencyHistogram(np.zeros(N_BUCKETS, np.int64))

    @property
    def count(self) -> int:
        return int(self.buckets.sum())

    def combine(self, other: "LatencyHistogram") -> None:
        self.buckets += other.buckets

    def percentile(self, p: float) -> int:
        """Exponential-interpolated percentile in ns (`Percentile`
        `metrics.go:64-98`)."""
        total = self.buckets.sum()
        if total == 0 or p <= 0:
            return 0
        target = p * total
        cum = np.cumsum(self.buckets)
        b = int(np.searchsorted(cum, target, side="left"))
        if b >= N_BUCKETS:
            b = N_BUCKETS - 1
        in_bucket = self.buckets[b]
        if b == 0 or in_bucket == 0:
            return 1 << b
        before = cum[b] - in_bucket
        frac = (target - before) / in_bucket
        lo, hi = float(1 << (b - 1)), float(1 << b)
        return int(lo * (hi / lo) ** frac)


@dataclasses.dataclass
class SeriesMetrics:
    labels: tuple                    # ((attr, value), ...)
    histogram: LatencyHistogram
    error_count: int = 0

    def to_json(self) -> dict:
        return {
            "series": [{"key": k, "value": str(v)} for k, v in self.labels],
            "spanCount": self.histogram.count,
            "errorSpanCount": self.error_count,
            "p50": self.histogram.percentile(0.5),
            "p90": self.histogram.percentile(0.9),
            "p99": self.histogram.percentile(0.99),
        }


class MetricsResults:
    """Accumulation across scan batches + shards (`MetricsResults.Combine`)."""

    def __init__(self, max_series: int = 1000):
        self.max_series = max_series
        self.series: dict[tuple, SeriesMetrics] = {}
        self.span_count = 0
        self.estimated = False  # truncated at max_series

    def record(self, labels: tuple, hist: LatencyHistogram, errors: int) -> None:
        s = self.series.get(labels)
        if s is None:
            if len(self.series) >= self.max_series:
                self.estimated = True
                return
            s = self.series[labels] = SeriesMetrics(labels, LatencyHistogram.empty())
        s.histogram.combine(hist)
        s.error_count += errors
        self.span_count += hist.count

    def combine(self, other: "MetricsResults") -> None:
        for labels, s in other.series.items():
            self.record(labels, s.histogram, s.error_count)
        self.estimated |= other.estimated

    def results(self) -> list[SeriesMetrics]:
        return sorted(self.series.values(),
                      key=lambda s: -s.histogram.count)


def get_metrics(query: str, group_by: Sequence[str],
                view_iter: Iterable[tuple[ColumnView, np.ndarray]],
                max_series: int = 1000) -> MetricsResults:
    """Filter spans with `query`, group by up to 5 attributes, aggregate
    latency histograms + error counts per series — vectorized per batch."""
    if len(group_by) > MAX_GROUP_BY:
        raise ValueError(f"at most {MAX_GROUP_BY} group-by attributes")
    q, _ = compile_query(query or "{ }")
    flt = _filter_expr(q)
    attrs = [_parse_groupby(g) for g in group_by]
    res = MetricsResults(max_series)

    for view, cand in view_iter:
        if len(cand) == 0:
            continue
        if flt is not None:
            mask = eval_expr(view, flt).bool_mask()
        else:
            mask = np.ones(view.n, bool)
        rows = cand[mask[cand]]
        if len(rows) == 0:
            continue
        dur = view.col("duration")
        if dur is None:
            continue
        buckets = bucketize_ns(dur.values[rows])  # duration col is ns
        status = view.col("status")
        errors = (status.values[rows] == A.STATUS_ERROR) if status is not None \
            else np.zeros(len(rows), bool)

        # group key per row: tuple of stringified label values
        label_cols = []
        for a in attrs:
            c = resolve_attr(view, a)
            vals = np.where(c.exists[rows],
                            c.values[rows].astype(str), "nil")
            label_cols.append(vals)
        if label_cols:
            stacked = np.stack(label_cols, axis=1)
            keys, inverse = np.unique(stacked, axis=0, return_inverse=True)
            for ki in range(len(keys)):
                sel = inverse == ki
                hist = LatencyHistogram(
                    np.bincount(buckets[sel], minlength=N_BUCKETS)
                    .astype(np.int64))
                labels = tuple((attr_key(a), keys[ki][j])
                               for j, a in enumerate(attrs))
                res.record(labels, hist, int(errors[sel].sum()))
        else:
            hist = LatencyHistogram(
                np.bincount(buckets, minlength=N_BUCKETS).astype(np.int64))
            res.record((), hist, int(errors.sum()))
    return res


def _filter_expr(q: A.Pipeline):
    for stage in q.stages:
        if isinstance(stage, A.SpansetFilter):
            return stage.expr
    return None


def _parse_groupby(g: str) -> A.Attribute:
    from tempo_tpu_torch.traceql.engine import _parse_attr
    return _parse_attr(g)
