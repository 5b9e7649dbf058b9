"""A frozen copy of the DDSketch that Tempo's span-metrics sidecar keeps.

Buckets of relative width gamma = (1 + a) / (1 - a) over [min, max]
seconds: a value v > min lands in bucket ceil(log(v / min) / log gamma),
clipped to [0, nb - 1]; values at or below `min` count as zeros, which
sort first. A quantile q reads the first bucket whose cumulative count
reaches q * total and answers that bucket's gamma-midpoint
min * 2 * gamma^b / (gamma + 1). The sidecar's state and read are
float32, so the target q * total and the midpoints are formed in float32
here too; the bucket of each value is worked out in float64 from the
exact duration.
"""

from __future__ import annotations

import math

import numpy as np


class DDSketchParams:
    def __init__(self, rel_err: float, min_value: float, max_value: float):
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self.min = min_value
        self.nb = int(math.ceil(math.log(max_value / min_value)
                                / math.log(self.gamma))) + 2
        b = np.arange(self.nb, dtype=np.float64)
        g32 = float(np.float32(self.gamma))
        self.values = (np.float32(min_value * 2.0)
                       * np.power(np.float32(g32), b.astype(np.float32))
                       / np.float32(self.gamma + 1.0)).astype(np.float32)

    def index(self, v: np.ndarray) -> np.ndarray:
        """Bucket of each value, -1 for a zero."""
        v = np.asarray(v, np.float64)
        idx = np.ceil(np.log(np.maximum(v, self.min) / self.min)
                      / math.log(self.gamma))
        idx = np.clip(idx, 0, self.nb - 1).astype(np.int64)
        return np.where(v <= self.min, -1, idx)

    def quantiles(self, idx: np.ndarray, counts: np.ndarray,
                  starts: np.ndarray, ends: np.ndarray, q: float) -> np.ndarray:
        """Quantile `q` of every row. Row r holds the occupied buckets
        idx[starts[r]:ends[r]] in ascending order (-1, the zeros, first)
        with their counts; an empty row answers 0."""
        cum = np.cumsum(counts.astype(np.float64))
        base = np.where(starts > 0, cum[np.maximum(starts - 1, 0)], 0.0)
        total = np.where(ends > starts, cum[np.maximum(ends - 1, 0)], 0.0) - base
        target = (np.float32(q) * total.astype(np.float32)).astype(np.float64)
        at = np.searchsorted(cum, base + target, side="left")
        at = np.clip(np.minimum(at, ends - 1), 0, max(idx.size - 1, 0))
        b = idx[at] if idx.size else np.zeros(starts.size, np.int64)
        val = np.where(b < 0, 0.0, self.values[np.maximum(b, 0)])
        return np.where(ends > starts, val, 0.0)
