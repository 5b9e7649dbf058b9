"""Cost-attribution usage tracker.

Counterpart of `tempo_tpu/utils/usage.py`, host code copied with its imports
moved to the port.

Analog of `modules/distributor/usage` (`usage.NewTracker`, handler
`/usage_metrics` `modules.go:272-274`): per-tenant byte counters broken
down by configurable span/resource dimensions, with a max-cardinality
guard that buckets overflow series into an `__overflow__` label.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

OVERFLOW = "__overflow__"
MISSING = "__missing__"

# canonical escaping lives in the obs registry; re-exported for callers
# that predate it
from tempo_tpu_torch.obs import escape_label  # noqa: E402,F401


@dataclasses.dataclass
class UsageTrackerConfig:
    dimensions: tuple[str, ...] = ("service",)   # span-dict keys or attrs
    max_cardinality: int = 10_000                # per tenant


class UsageTracker:
    def __init__(self, cfg: UsageTrackerConfig | None = None) -> None:
        self.cfg = cfg or UsageTrackerConfig()
        self._lock = threading.Lock()
        # tenant -> {(dim values...) -> [bytes, spans]}; the cardinality cap
        # is per tenant, so one noisy tenant can't overflow its neighbours
        self._series: dict[str, dict[tuple, list]] = {}

    def observe(self, tenant: str, spans: Sequence[dict],
                size_bytes: int | None = None) -> None:
        dims = self.cfg.dimensions
        per_span = ((size_bytes / max(len(spans), 1))
                    if size_bytes is not None else None)
        with self._lock:
            tseries = self._series.setdefault(tenant, {})
            for s in spans:
                vals = []
                for d in dims:
                    v = s.get(d)
                    if v is None:
                        v = (s.get("attrs") or {}).get(d)
                    if v is None:
                        v = (s.get("res_attrs") or {}).get(d)
                    vals.append(str(v) if v is not None else MISSING)
                key = tuple(vals)
                ent = tseries.get(key)
                if ent is None:
                    if len(tseries) >= self.cfg.max_cardinality:
                        key = (OVERFLOW,) * len(dims)
                        ent = tseries.setdefault(key, [0, 0])
                    else:
                        ent = tseries[key] = [0, 0]
                sz = per_span if per_span is not None else _span_size(s)
                ent[0] += sz
                ent[1] += 1

    def observe_grouped(self, tenant: str,
                        groups: "Sequence[tuple[tuple, int, float]]") -> None:
        """Pre-aggregated observation: (dim-value tuple, span count, byte
        sum) per distinct combo — the columnar distributor path computes
        these with numpy and crosses into Python once per combo."""
        with self._lock:
            tseries = self._series.setdefault(tenant, {})
            ndims = len(self.cfg.dimensions)
            for key, n, nbytes in groups:
                ent = tseries.get(key)
                if ent is None:
                    if len(tseries) >= self.cfg.max_cardinality:
                        key = (OVERFLOW,) * ndims
                        ent = tseries.setdefault(key, [0, 0])
                    else:
                        ent = tseries[key] = [0, 0]
                ent[0] += nbytes
                ent[1] += n

    def snapshot(self) -> list[tuple[tuple, int, int]]:
        """[(label values (tenant, *dims), bytes, spans)] under the lock."""
        out = []
        with self._lock:
            for tenant in sorted(self._series):
                for vals, (nbytes, nspans) in sorted(
                        self._series[tenant].items()):
                    out.append(((tenant, *vals), int(nbytes), int(nspans)))
        return out

    def prometheus_text(self) -> str:
        """`/usage_metrics` exposition — rendered by the same obs writer
        as `/metrics` (one escaping/HELP/TYPE implementation, not two
        hand-rolled ones)."""
        from tempo_tpu_torch.obs import Registry

        reg = Registry()
        labels = ("tenant",) + self.cfg.dimensions
        snap = self.snapshot()      # one lock + sort, feeding both families
        reg.counter_func(
            "tempo_usage_tracker_bytes_received_total",
            lambda: [(vals, nbytes) for vals, nbytes, _ in snap],
            help="Cost-attributed bytes received, by tenant and dimension",
            labels=labels)
        reg.counter_func(
            "tempo_usage_tracker_spans_received_total",
            lambda: [(vals, nspans) for vals, _, nspans in snap],
            help="Cost-attributed spans received, by tenant and dimension",
            labels=labels)
        return reg.render()


def _span_size(s: dict) -> int:
    return 200 + 32 * (len(s.get("attrs") or {}) + len(s.get("res_attrs") or {}))
