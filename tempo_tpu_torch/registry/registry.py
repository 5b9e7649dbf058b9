"""ManagedRegistry: per-tenant metric families over paged device state.

Counterpart of `tempo_tpu/registry/registry.py`, reproducing the
reference's `modules/generator/registry/registry.go`:

- counters, gauges and histograms share one per-tenant active-series
  budget (`max_active_series`, `registry.go:184-197`);
- the collection tick (`registry.go:206-256`) walks active series and
  emits samples at one timestamp; histograms expand to cumulative
  `_bucket`/`_sum`/`_count`; exemplars carry trace ids;
- the stale-series purge (`registry.go:258-277`) evicts idle series,
  zeroes their device rows and queues one NaN staleness marker each;
- per-tenant external labels join every series.

The classes here are the host halves (series tables, exemplars,
staleness markers, collect formatting). Their device halves live in the
page pool (`registry/paged.py`): this slice of the port runs the paged
layout only, so a registry needs an active pool.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from tempo_tpu_torch.device import bucket_rows
from tempo_tpu_torch.model.interner import StringInterner
from tempo_tpu_torch.registry.series import Exemplar, Sample, SeriesBudget, SeriesTable

STALE_NAN = float("nan")

DEFAULT_HISTOGRAM_EDGES = (0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.128,
                           0.256, 0.512, 1.024, 2.048, 4.096, 8.192, 16.384)


@dataclasses.dataclass
class RegistryOverrides:
    """Per-tenant knobs (subset of `modules/overrides/config.go:71-200`)."""

    max_active_series: int = 65536
    collection_interval_s: float = 15.0
    stale_duration_s: float = 900.0
    external_labels: dict[str, str] = dataclasses.field(default_factory=dict)
    disable_collection: bool = False


class _MetricBase:
    def __init__(self, registry: "ManagedRegistry", name: str,
                 label_names: Sequence[str], capacity: int):
        self.registry = registry
        self.name = name
        self.label_names = tuple(label_names)
        self.table = SeriesTable(capacity, len(self.label_names),
                                 budget=registry.budget)
        self.exemplars: dict[int, Exemplar] = {}  # slot -> last exemplar
        self._stale_pending: list[tuple[tuple[tuple[str, str], ...], float]] = []
        self._ex_cursor = 0   # rotating exemplar-sampling window offset
        # processor-owned sidecar planes keyed to this family's slots (the
        # span-metrics DDSketch) register here so the purge zeroes their
        # rows too; called with the padded eviction batch under the lock
        self.evict_hooks: list = []

    def resolve_slots(self, label_rows: np.ndarray,
                      valid: np.ndarray | None = None) -> np.ndarray:
        """[n, L] interned label-value rows → [n] slots (-1 = discarded)."""
        return self.table.lookup_or_create(label_rows, self.registry.now(), valid=valid)

    def labels_of(self, slot: int) -> tuple[tuple[str, str], ...]:
        it = self.registry.interner
        vals = it.lookup_many(self.table.slot_keys[slot])
        pairs = dict(zip(self.label_names, vals))
        pairs.update(self.registry.overrides.external_labels)
        pairs["__name__"] = self.name
        return tuple(sorted(pairs.items()))

    def note_exemplars(self, slots: np.ndarray, trace_ids: np.ndarray,
                       values: np.ndarray, ts_ms: int, max_new: int = 16) -> None:
        """Record up to max_new last-seen exemplars per push, one per
        distinct series, from a rotating window of the batch so tail
        series of a stably ordered batch get their turn across pushes."""
        ok = np.flatnonzero(slots >= 0)
        if len(ok) == 0:
            return
        win = max_new * 16
        start = self._ex_cursor % len(ok)
        self._ex_cursor = start + win
        head = ok[start:start + win]
        if len(head) < win and start:
            head = np.concatenate([head, ok[:win - len(head)]])
        _, first = np.unique(slots[head], return_index=True)
        for i in head[np.sort(first)[:max_new]].tolist():
            tid = trace_ids[i].tobytes().hex()
            self.exemplars[int(slots[i])] = Exemplar(tid, float(values[i]), ts_ms)

    def note_stale(self, slots: np.ndarray) -> None:
        """Capture label sets before slot_keys are wiped (markers emitted on
        the next collect) and forget exemplars for evicted slots."""
        for slot in slots.tolist():
            self._stale_pending.append((self.labels_of(slot), self.registry.now()))
            self.exemplars.pop(slot, None)

    def _drain_stale_markers(self, ts_ms: int) -> list[Sample]:
        out = [Sample(self.name, labels, STALE_NAN, ts_ms, is_stale_marker=True)
               for labels, _ in self._stale_pending]
        self._stale_pending = []
        return out

    def share_table(self, other: "_MetricBase") -> None:
        """Adopt `other`'s series table so the families stay slot-aligned
        (the span-metrics calls/latency/size trio); the shared table's
        backing adopts this family's planes, so one slot allocation backs
        every co-tabled plane."""
        mine = self.table
        if mine is other.table:
            return
        if getattr(other.table, "backing", None) is not None and \
                getattr(mine, "backing", None) is not None:
            other.table.backing.adopt(mine.backing)
        self.table = other.table


class Counter(_MetricBase):
    """Counter host half; `_snap()` returns (values,)."""

    def collect(self, ts_ms: int, snap: tuple | None = None) -> list[Sample]:
        (vals,) = snap if snap is not None else self._snap()
        out = [Sample(self.name, self.labels_of(s), float(vals[s]), ts_ms,
                      exemplar=self.exemplars.get(s))
               for s in self.table.active_slots().tolist()]
        return out + self._drain_stale_markers(ts_ms)


class Gauge(_MetricBase):
    """Gauge host half; `_device_set` is the device half."""

    def set_batch(self, label_rows: np.ndarray, values: np.ndarray,
                  valid: np.ndarray | None = None) -> None:
        slots = self.resolve_slots(label_rows, valid)
        # last-wins per slot, resolved on the host
        keep = {}
        for i in range(slots.shape[0]):
            if slots[i] >= 0:
                keep[int(slots[i])] = i
        if not keep:
            return
        idx = np.fromiter(keep.values(), int)
        self._device_set(slots[idx].astype(np.int32),
                         np.asarray(values, np.float32)[idx])

    def collect(self, ts_ms: int, snap: tuple | None = None) -> list[Sample]:
        (vals,) = snap if snap is not None else self._snap()
        out = [Sample(self.name, self.labels_of(s), float(vals[s]), ts_ms)
               for s in self.table.active_slots().tolist()]
        return out + self._drain_stale_markers(ts_ms)


class Histogram(_MetricBase):
    """Classic histogram host half → `_count`/`_sum`/`_bucket{le=...}`;
    `_snap()` returns (bucket_counts, sums, counts)."""

    def hist_edges(self) -> tuple:
        return self.edges

    def collect(self, ts_ms: int, snap: tuple | None = None) -> list[Sample]:
        bc, sums, counts = snap if snap is not None else self._snap()
        out: list[Sample] = []
        edges = self.hist_edges()
        for s in self.table.active_slots().tolist():
            base = self.labels_of(s)
            ex = self.exemplars.get(s)
            cum = np.cumsum(bc[s])
            out.append(Sample(self.name + "_count", base, float(counts[s]), ts_ms))
            out.append(Sample(self.name + "_sum", base, float(sums[s]), ts_ms))
            for i, e in enumerate(edges):
                le = (("le", _fmt_le(e)),)
                out.append(Sample(self.name + "_bucket", base + le, float(cum[i]),
                                  ts_ms, exemplar=ex if ex and ex.value <= e else None))
            out.append(Sample(self.name + "_bucket", base + (("le", "+Inf"),),
                              float(cum[-1]), ts_ms, exemplar=ex))
        return out + self._drain_stale_markers(ts_ms)


def _fmt_le(e: float) -> str:
    return repr(round(e, 9)) if e != int(e) else str(int(e))


class ManagedRegistry:
    """Per-tenant registry: metric families + limits + collection."""

    def __init__(self, tenant: str = "single-tenant",
                 overrides: RegistryOverrides | None = None,
                 interner: StringInterner | None = None,
                 now: Callable[[], float] = time.time):
        from tempo_tpu_torch.registry import pages as pages_mod

        self.tenant = tenant
        self.overrides = overrides or RegistryOverrides()
        self.interner = interner if interner is not None else StringInterner()
        self.now = now
        self.budget = SeriesBudget(self.overrides.max_active_series)
        self._metrics: dict[str, _MetricBase] = {}
        self.pages = pages_mod.active()
        if self.pages is None:
            raise NotImplementedError(
                "the dense state layout (no page pool) comes with a later "
                "slice of the port; configure a pool with "
                "registry.pages.configure(PagePoolConfig(enabled=True))")
        if self.overrides.max_active_series % self.pages.page_rows:
            raise NotImplementedError(
                f"max_active_series {self.overrides.max_active_series} is "
                f"not a multiple of page_rows {self.pages.page_rows}: such "
                "a tenant needs the dense layout, which comes with a later "
                "slice of the port")
        # arenas are cross-tenant state updated in place: every tenant
        # serializes its device reads and updates on the pool's lock
        self.state_lock = self.pages.lock

    def new_counter(self, name: str, label_names: Sequence[str],
                    compact: bool = False):
        """A paged counter; `compact` keeps its rows as int32."""
        from tempo_tpu_torch.registry.paged import PagedCounter
        c = self._metrics[name] = PagedCounter(
            self, name, label_names, self.overrides.max_active_series,
            compact=compact)
        return c

    def new_gauge(self, name: str, label_names: Sequence[str]):
        from tempo_tpu_torch.registry.paged import PagedGauge
        g = self._metrics[name] = PagedGauge(
            self, name, label_names, self.overrides.max_active_series)
        return g

    def new_histogram(self, name: str, label_names: Sequence[str],
                      edges: tuple[float, ...] = DEFAULT_HISTOGRAM_EDGES,
                      compact: bool = False):
        """A paged classic histogram; `compact` keeps int32 buckets and
        counts and the sum as a bf16 Kahan pair."""
        from tempo_tpu_torch.registry.paged import PagedHistogram
        h = self._metrics[name] = PagedHistogram(
            self, name, label_names, self.overrides.max_active_series, edges,
            compact=compact)
        return h

    @property
    def active_series(self) -> int:
        # families may share a SeriesTable (the span-metrics trio): count
        # each table once
        seen: dict[int, int] = {}
        for mt in self._metrics.values():
            seen[id(mt.table)] = mt.table.active_count
        return sum(seen.values())

    @property
    def discarded_series(self) -> int:
        return sum(mt.table.discarded for mt in self._metrics.values())

    def collect(self, ts_ms: int | None = None) -> list[Sample]:
        """The collection tick: one timestamp across all families, device
        state gathered once each under the lock, formatting outside it."""
        if self.overrides.disable_collection:
            return []
        ts = int(self.now() * 1000) if ts_ms is None else ts_ms
        with self.state_lock:
            snaps = [(mt, mt._snap()) for mt in self._metrics.values()]
        out: list[Sample] = []
        for mt, snap in snaps:
            out.extend(mt.collect(ts, snap))
        return out

    def purge_stale(self) -> int:
        """Evict idle series and zero their device rows; returns the
        eviction count. Eviction is computed once per shared table, and
        every family on that table zeroes its rows and queues markers."""
        cutoff = self.now() - self.overrides.stale_duration_s
        by_table: dict[int, list[_MetricBase]] = {}
        for mt in self._metrics.values():
            by_table.setdefault(id(mt.table), []).append(mt)
        total = 0
        for fams in by_table.values():
            table = fams[0].table
            stale = np.flatnonzero(table.active & (table.last_seen < cutoff))
            if not stale.size:
                continue
            padded = np.full(_pad_len(stale.size), table.capacity, np.int32)
            padded[: stale.size] = stale
            # one lock over the whole shared-table eviction: a concurrent
            # collect must never see the slot-aligned trio half-zeroed
            with self.state_lock:
                for mt in fams:
                    mt.note_stale(stale)
                    mt.zero_evicted(padded)
                    for hook in mt.evict_hooks:
                        hook(padded)
                table.purge_stale(cutoff)
            total += stale.size
        return total

    def device_state_bytes(self) -> int:
        """Device bytes of this registry's families (backed pages only)."""
        return sum(mt.device_state_bytes() for mt in self._metrics.values())

    def metric(self, name: str) -> _MetricBase:
        return self._metrics[name]


def _pad_len(n: int) -> int:
    return bucket_rows(max(n, 1), lo=16)
