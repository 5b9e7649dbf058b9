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

The families here are the dense layout: each holds its rows in a
`registry/metrics.py` state on the registry's device. With a page pool
active and a capacity that splits into whole pages, the registry builds
the paged families of `registry/paged.py` instead, which keep these
classes' host halves (series tables, exemplars, staleness markers,
collect formatting) and swap the device half. Native histograms
(`new_native_histogram`, `native_histograms()`) keep the log2 sketch of
`ops/sketches.py`; no processor makes one, as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from tempo_tpu_torch.device import bucket_rows, resolve_device
from tempo_tpu_torch.model.interner import StringInterner
from tempo_tpu_torch.ops.pages import arena_of, dense_page_rows
from tempo_tpu_torch.registry import metrics as m
from tempo_tpu_torch.registry.series import Exemplar, Sample, SeriesBudget, SeriesTable

STALE_NAN = float("nan")

_LOG = logging.getLogger("tempo_tpu_torch.registry")

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

    # -- the dense device half (paged families override) --------------------

    def _dense(self, compact: bool) -> dict:
        """Keyword arguments of the dense state inits; dense state has no
        compact tier."""
        if compact:
            raise ValueError(
                f"{self.name}: compact state needs the paged layout (a page "
                "pool whose page_rows divides max_active_series)")
        return dict(device=self.registry.device,
                    page_rows=self.registry.dense_page_rows)

    def zero_evicted(self, padded_slots: np.ndarray) -> None:
        """Zero the device rows of evicted slots (the registry pads the
        batch with `capacity`, which drops)."""
        m.zero_slots(self.state, padded_slots)

    def device_state_bytes(self) -> int:
        """Device bytes of this family's arenas, trash pages included."""
        return _state_bytes(self.state, self.registry.dense_page_rows)


def _state_bytes(state, page_rows: int) -> int:
    """Bytes of the arenas behind a dense state's tensors."""
    total = 0
    for t in m.state_tensors(state):
        a = arena_of(t, page_rows)
        total += a.numel() * a.element_size()
    return total


def _host(t) -> np.ndarray:
    """A host copy of a state tensor (never a view of live CPU state)."""
    return t.cpu().numpy().copy()


class Counter(_MetricBase):
    """Counter: `_snap()` returns (values,)."""

    def __init__(self, registry, name, label_names, capacity,
                 compact: bool = False):
        super().__init__(registry, name, label_names, capacity)
        self.state = m.counter_init(capacity, **self._dense(compact))

    def inc_batch(self, label_rows: np.ndarray,
                  weights: np.ndarray | None = None,
                  valid: np.ndarray | None = None) -> np.ndarray:
        slots = self.resolve_slots(label_rows, valid)
        self.add_slots(slots, weights)
        return slots

    def add_slots(self, slots: np.ndarray,
                  weights: np.ndarray | None = None) -> None:
        """Device half with slots already resolved (processors that share
        one resolve across families: service graphs); -1 drops."""
        with self.registry.state_lock:
            m.counter_update(self.state, slots, weights)

    def inc(self, label_values: Sequence[str], value: float = 1.0) -> None:
        row = self.registry.interner.intern_many(label_values)[None, :]
        self.inc_batch(row, np.array([value], np.float32))

    def _snap(self) -> tuple:
        return (_host(self.state.values),)

    def collect(self, ts_ms: int, snap: tuple | None = None) -> list[Sample]:
        (vals,) = snap if snap is not None else self._snap()
        out = [Sample(self.name, self.labels_of(s), float(vals[s]), ts_ms,
                      exemplar=self.exemplars.get(s))
               for s in self.table.active_slots().tolist()]
        return out + self._drain_stale_markers(ts_ms)


class Gauge(_MetricBase):
    """Gauge: `set_batch` resolves last-wins on the host, `_device_set`
    writes the rows."""

    def __init__(self, registry, name, label_names, capacity):
        super().__init__(registry, name, label_names, capacity)
        self.state = m.gauge_init(capacity, **self._dense(False))

    def _device_set(self, slots: np.ndarray, values: np.ndarray) -> None:
        with self.registry.state_lock:
            m.gauge_set(self.state, slots, values)

    def _snap(self) -> tuple:
        return (_host(self.state.values),)

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
        # padded to a pow-2 bucket as in the reference (padding slots -1
        # drop on the device)
        n = len(idx)
        s = np.full(_pad_len(n), -1, np.int32)
        s[:n] = slots[idx]
        v = np.zeros(s.size, np.float32)
        v[:n] = np.asarray(values, np.float32)[idx]
        self._device_set(s, v)

    def set(self, label_values: Sequence[str], value: float) -> None:
        row = self.registry.interner.intern_many(label_values)[None, :]
        self.set_batch(row, np.array([value], np.float32))

    def collect(self, ts_ms: int, snap: tuple | None = None) -> list[Sample]:
        (vals,) = snap if snap is not None else self._snap()
        out = [Sample(self.name, self.labels_of(s), float(vals[s]), ts_ms)
               for s in self.table.active_slots().tolist()]
        return out + self._drain_stale_markers(ts_ms)


class Histogram(_MetricBase):
    """Classic histogram → `_count`/`_sum`/`_bucket{le=...}`; `_snap()`
    returns (bucket_counts, sums, counts)."""

    def __init__(self, registry, name, label_names, capacity,
                 edges: tuple[float, ...] = DEFAULT_HISTOGRAM_EDGES,
                 compact: bool = False):
        super().__init__(registry, name, label_names, capacity)
        self.edges = tuple(edges)
        self.state = m.histogram_init(capacity, self.edges,
                                      **self._dense(compact))

    def observe_batch(self, label_rows: np.ndarray, values: np.ndarray,
                      weights: np.ndarray | None = None,
                      valid: np.ndarray | None = None) -> np.ndarray:
        slots = self.resolve_slots(label_rows, valid)
        self.observe_slots(slots, values, weights)
        return slots

    def observe_slots(self, slots: np.ndarray, values: np.ndarray,
                      weights: np.ndarray | None = None) -> None:
        """Device half with slots already resolved; -1 drops."""
        with self.registry.state_lock:
            m.histogram_update(self.state, slots, values, weights)

    def observe(self, label_values: Sequence[str], value: float) -> None:
        row = self.registry.interner.intern_many(label_values)[None, :]
        self.observe_batch(row, np.array([value], np.float32))

    def _snap(self) -> tuple:
        st = self.state
        return (_host(st.bucket_counts), _host(st.sums), _host(st.counts))

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


class NativeHistogram(_MetricBase):
    """Exponential histogram family (remote-write native histogram
    payloads); `_snap()` returns (sums, counts)."""

    def __init__(self, registry, name, label_names, capacity):
        super().__init__(registry, name, label_names, capacity)
        self.state = m.native_histogram_init(capacity, **self._dense(False))

    def observe_batch(self, label_rows: np.ndarray, values: np.ndarray,
                      weights: np.ndarray | None = None,
                      valid: np.ndarray | None = None) -> np.ndarray:
        slots = self.resolve_slots(label_rows, valid)
        self.observe_slots(slots, values, weights)
        return slots

    def observe_slots(self, slots: np.ndarray, values: np.ndarray,
                      weights: np.ndarray | None = None) -> None:
        """Device half with slots already resolved; -1 drops."""
        with self.registry.state_lock:
            m.native_histogram_update(self.state, slots, values, weights)

    def _snap(self) -> tuple:
        return (_host(self.state.sums), _host(self.state.counts))

    def collect(self, ts_ms: int, snap: tuple | None = None) -> list[Sample]:
        # scalar samples for visibility; the remote-write encoder reads
        # `native_payload()` for the native-histogram protos
        sums, counts = snap if snap is not None else self._snap()
        out = []
        for s in self.table.active_slots().tolist():
            base = self.labels_of(s)
            out.append(Sample(self.name + "_count", base, float(counts[s]),
                              ts_ms))
            out.append(Sample(self.name + "_sum", base, float(sums[s]),
                              ts_ms))
        return out + self._drain_stale_markers(ts_ms)

    def hist_offset(self) -> int:
        return self.state.hist.offset

    def native_payload(self):
        """(slots, labels, log2 counts, sums, counts, zeros) of the active
        series, host arrays; the rows are selected on the device."""
        slots = self.table.active_slots()
        idx = torch.from_numpy(slots.astype(np.int64)).to(
            self.state.sums.device)
        st = self.state
        return (slots, [self.labels_of(s) for s in slots.tolist()],
                *(t[idx].cpu().numpy()
                  for t in (st.hist.counts, st.sums, st.counts, st.zeros)))


def _fmt_le(e: float) -> str:
    return repr(round(e, 9)) if e != int(e) else str(int(e))


class ManagedRegistry:
    """Per-tenant registry: metric families + limits + collection.

    Its families are paged when a page pool is active and the tenant's
    `max_active_series` splits into whole pages, dense otherwise (with
    the reference's warning when a pool is active). Paged state lives on
    the pool's device and serialises on the pool's lock; dense state on
    `device` (`cuda` unless `"cpu"` is asked for; the pool's device when
    a pool is active) under the registry's own lock."""

    def __init__(self, tenant: str = "single-tenant",
                 overrides: RegistryOverrides | None = None,
                 interner: StringInterner | None = None,
                 now: Callable[[], float] = time.time, device=None):
        from tempo_tpu_torch.registry import pages as pages_mod

        self.tenant = tenant
        self.overrides = overrides or RegistryOverrides()
        self.interner = interner if interner is not None else StringInterner()
        self.now = now
        self.budget = SeriesBudget(self.overrides.max_active_series)
        self._metrics: dict[str, _MetricBase] = {}
        pool = self.pages = pages_mod.active()
        cap = self.overrides.max_active_series
        if pool is not None and cap % pool.page_rows:
            _LOG.warning(
                "registry %s: max_active_series %d not divisible by "
                "pages.page_rows %d — tenant stays on the dense layout",
                tenant, cap, pool.page_rows)
            self.pages = None
        if device is None and pool is not None:
            device = pool.device
        self.device = resolve_device(device)
        if self.pages is not None:
            if self.device != self.pages.device:
                raise ValueError(f"the active page pool is on "
                                 f"{self.pages.device}, this registry on "
                                 f"{self.device}")
            # arenas are cross-tenant state updated in place: every tenant
            # serializes its device reads and updates on the pool's lock
            self.state_lock = self.pages.lock
            self.dense_page_rows = None
        else:
            self.state_lock = threading.RLock()
            self.dense_page_rows = dense_page_rows(cap)

    def shard_dense_pages(self, rows, shards: int) -> None:
        """Under the serving mesh: shrink the dense page, before any
        family exists, until each of `shards` equal ranges of every row
        count in `rows` is whole pages (the shard windows K1 addresses),
        as long as K1's page tables still fit. Pages never grow."""
        from tempo_tpu_torch.ops.cuda_kernels import (MAX_ROLES,
                                                      MAX_TABLE_BYTES)

        if self.pages is not None or self._metrics or shards <= 1:
            return
        cap = self.overrides.max_active_series
        pr = self.dense_page_rows
        for r in rows:
            while pr > 1 and (r // shards) % pr and \
                    MAX_ROLES * 4 * -(-cap // (pr >> 1)) <= MAX_TABLE_BYTES:
                pr >>= 1
        self.dense_page_rows = pr

    def _family_types(self) -> tuple:
        if self.pages is not None:
            from tempo_tpu_torch.registry import paged
            return (paged.PagedCounter, paged.PagedGauge,
                    paged.PagedHistogram, paged.PagedNativeHistogram)
        return Counter, Gauge, Histogram, NativeHistogram

    def new_counter(self, name: str, label_names: Sequence[str],
                    compact: bool = False) -> Counter:
        """A counter; `compact` (paged only) keeps its rows as int32."""
        c = self._metrics[name] = self._family_types()[0](
            self, name, label_names, self.overrides.max_active_series,
            compact=compact)
        return c

    def new_gauge(self, name: str, label_names: Sequence[str]) -> Gauge:
        g = self._metrics[name] = self._family_types()[1](
            self, name, label_names, self.overrides.max_active_series)
        return g

    def new_histogram(self, name: str, label_names: Sequence[str],
                      edges: tuple[float, ...] = DEFAULT_HISTOGRAM_EDGES,
                      compact: bool = False) -> Histogram:
        """A classic histogram; `compact` (paged only) keeps int32 buckets
        and counts and the sum as a bf16 Kahan pair."""
        h = self._metrics[name] = self._family_types()[2](
            self, name, label_names, self.overrides.max_active_series, edges,
            compact=compact)
        return h

    def new_native_histogram(self, name: str,
                             label_names: Sequence[str]) -> NativeHistogram:
        h = self._metrics[name] = self._family_types()[3](
            self, name, label_names, self.overrides.max_active_series)
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
        """Device bytes of this registry's families (dense: whole arenas,
        trash pages included; paged: backed pages only)."""
        return sum(mt.device_state_bytes() for mt in self._metrics.values())

    def native_histograms(self, ts_ms: int | None = None) -> list[tuple]:
        """(labels, log2_counts, sum, count, zeros, ts, offset) per active
        native-histogram series, the shape `encode_write_request` takes."""
        ts = int(self.now() * 1000) if ts_ms is None else ts_ms
        with self.state_lock:
            payloads = [(mt, mt.native_payload())
                        for mt in self._metrics.values()
                        if hasattr(mt, "native_payload")]
        out = []
        for mt, (_slots, labels, hists, sums, counts, zeros) in payloads:
            offset = mt.hist_offset()
            for i in range(len(labels)):
                out.append((labels[i], hists[i], float(sums[i]),
                            float(counts[i]), float(zeros[i]), ts, offset))
        return out

    def metric(self, name: str) -> _MetricBase:
        return self._metrics[name]

    def load_reference_state(self, states: dict) -> None:
        """Install dense family state taken from the JAX reference.

        `states` maps a family name to {field: numpy array}, the fields of
        the reference family's state (`values`, or `bucket_counts`,
        `sums`, `counts`), e.g. `np.asarray(family.state.values)`. Each
        array is copied into the rows of this registry's family of that
        name (trash pages untouched). The series tables are not carried:
        the caller aligns them (the same label rows resolved in the same
        order give the same slots). Paged state carries through
        `registry.pages.load_reference_state`. Raises on an unknown
        family or field, or a shape or dtype mismatch."""
        if self.pages is not None:
            raise ValueError("paged families carry through "
                             "registry.pages.load_reference_state")
        with self.state_lock:
            for name, fields in states.items():
                state = self._metrics[name].state
                for field, data in fields.items():
                    dst = getattr(state, field, None)
                    if not isinstance(dst, torch.Tensor):
                        raise ValueError(f"{name}: no state tensor {field!r}")
                    src = torch.from_numpy(np.array(data, copy=True))
                    if src.dtype != dst.dtype or src.shape != dst.shape:
                        raise ValueError(
                            f"{name}.{field}: reference {src.dtype} "
                            f"{tuple(src.shape)} vs {dst.dtype} "
                            f"{tuple(dst.shape)}")
                    dst.copy_(src)


def _pad_len(n: int) -> int:
    return bucket_rows(max(n, 1), lo=16)
