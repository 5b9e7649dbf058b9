"""The numbers that decide `correct` in a generator cell.

The program's side comes in as plain data: `series`, {metric name:
{labels without `__name__`: value}} as its collection emits them, and
`quantiles`, {span-metrics labels: [value a q]} from its DDSketch read.
Each number is compared with a limit of its own (`configs/*.json`,
`limits`); how each limit was set is in PERF.md.

- `count_gap`: the largest difference in a count (calls, histogram
  counts, requests, failed requests) over every series of either side;
  a series on one side only counts whole. Counts are exact integers.
- `sum_rel`: the largest relative difference of a sum (latency seconds,
  span bytes, client and server seconds).
- `bucket_moved`: the share of histogram observations in another bucket
  than the reference's.
- `dd_flip_share`: the share of the expected (series, q) sketch answers
  that are missing or differ from the reference's sketch by more than a
  millionth.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.generator import EDGES, TenantReference

SM = "traces_spanmetrics_"
SG = "traces_service_graph_request_"


def _le_sorted(series: dict, name: str) -> dict:
    """{base labels: non-cumulative bucket counts} of a histogram family
    from its `_bucket` samples."""
    rows: dict = {}
    for labels, v in series.get(name + "_bucket", {}).items():
        le = labels[-1][1] if labels[-1][0] == "le" else dict(labels)["le"]
        base = tuple(kv for kv in labels if kv[0] != "le")
        rows.setdefault(base, []).append(
            (float("inf") if le == "+Inf" else float(le), v))
    if not rows:
        return {}
    keys = list(rows)
    cum = np.array([[v for _, v in sorted(rows[k])] for k in keys],
                   np.float64)
    return dict(zip(keys, np.diff(cum, axis=1, prepend=0.0)))


class Tally:
    """Running maxima and shares over tenants."""

    def __init__(self) -> None:
        self.count_gap = 0.0
        self.sum_rel = 0.0
        self.moved = 0.0
        self.observed = 0.0
        self.flips = 0
        self.answers = 0
        self.worst: dict = {}        # number -> (reading, family, key, got, want)

    def _note(self, number: str, reading: float, family: str, key, got,
              want) -> None:
        if reading > self.worst.get(number, (0.0,))[0]:
            self.worst[number] = (reading, family, key, got, want)

    def _counts(self, got: dict, keys, want, family: str = "") -> None:
        exp = dict(zip(keys, want.tolist()))
        for k in set(got) | set(exp):
            g, w = got.get(k, 0.0), exp.get(k, 0.0)
            self.count_gap = max(self.count_gap, abs(g - w))
            self._note("count_gap", abs(g - w), family, k, g, w)

    def _sums(self, got: dict, keys, want, family: str = "") -> None:
        for k, w in zip(keys, want.tolist()):
            if k in got:
                r = abs(got[k] - w) / max(abs(w), 1e-9)
                self.sum_rel = max(self.sum_rel, r)
                self._note("sum_rel", r, family, k, got[k], w)

    def _buckets(self, got: dict, keys, want) -> None:
        nb = len(EDGES) + 1
        for k, w in zip(keys, want):
            g = got.get(k, np.zeros(nb))
            self.moved += 0.5 * float(np.abs(g - w).sum())
            self.observed += float(w.sum())

    def add(self, series: dict, quantiles: dict, ref: TenantReference,
            qs, sketch_rows: int) -> None:
        sm = ref.spanmetrics
        self._counts(series.get(SM + "calls_total", {}), sm.keys, sm.count,
                     "calls_total")
        self._counts(series.get(SM + "latency_count", {}), sm.keys, sm.count,
                     "latency_count")
        self._sums(series.get(SM + "latency_sum", {}), sm.keys, sm.sums,
                   "latency_sum")
        self._sums(series.get(SM + "size_total", {}), sm.keys, ref.sizes,
                   "size_total")
        self._buckets(_le_sorted(series, SM + "latency"), sm.keys, sm.buckets)
        for side, fam in ref.edges.items():
            name = f"{SG}{side}_seconds"
            self._counts(series.get(name + "_count", {}), fam.keys, fam.count,
                         name)
            self._sums(series.get(name + "_sum", {}), fam.keys, fam.sums, name)
            self._buckets(_le_sorted(series, name), fam.keys, fam.buckets)
        fam = ref.edges["client"]
        self._counts(series.get(SG + "total", {}), fam.keys, fam.count,
                     "request_total")
        self._counts(series.get(SG + "failed_total", {}), fam.keys,
                     fam.failed, "request_failed_total")
        want = ref.dd_quantiles(qs)
        expected = min(sketch_rows, len(want)) * len(qs)
        got_pairs = 0
        for key, vals in quantiles.items():
            exp = want.get(key)
            for j, v in enumerate(vals):
                got_pairs += 1
                if exp is None or abs(v - exp[j]) > 1e-6 * max(exp[j], 1e-12):
                    self.flips += 1
        self.flips += max(expected - got_pairs, 0)
        self.answers += max(expected, got_pairs)

    def describe(self) -> list[str]:
        """The series behind each number's worst reading."""
        return [f"worst {n}: {r!r} in {fam} {dict(k)} got {g!r} want {w!r}"
                for n, (r, fam, k, g, w) in sorted(self.worst.items())]

    def numbers(self) -> dict:
        return {
            "count_gap": self.count_gap,
            "sum_rel": self.sum_rel,
            "bucket_moved": self.moved / max(self.observed, 1.0),
            "dd_flip_share": self.flips / max(self.answers, 1),
        }
