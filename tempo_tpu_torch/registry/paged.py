"""Paged metric families: the registry's families over pooled pages.

Counterpart of `tempo_tpu/registry/paged.py`. Each class keeps the
family's host half (series table, exemplars, staleness markers, collect
formatting — inherited) and supplies the device half: rows live in the
page pool's arenas behind a per-family indirection table, updates go
through the paged updates of `ops/pages.py` in place, and snapshots
gather the active slots back through the same table into
capacity-shaped host arrays. On a mesh-split pool each update runs once
a series shard over its arena and its localized table
(`PagedPlane.operands`). Every device op runs under the registry state
lock, which is the pool's lock.

Under the compact-state tier (`compact=True`) counts and histogram
buckets are int32 and a histogram's sum is a [2]-wide bf16 Kahan pair
(sum, compensation); snapshots upcast to f32 and fold the pair. Such
families are written only by the span-metrics processor, through the
paged fused update (one rounding per cell per dispatch); their own
non-fused writes raise.
"""

from __future__ import annotations

import numpy as np
import torch

from tempo_tpu_torch.ops import pages as op
from tempo_tpu_torch.registry import metrics as m
from tempo_tpu_torch.registry.pages import PageBacking, PagedPlane
from tempo_tpu_torch.registry.registry import (
    DEFAULT_HISTOGRAM_EDGES,
    Counter,
    Gauge,
    Histogram,
    NativeHistogram,
    _MetricBase,
    _pad_len,
)


class _PagedBase(_MetricBase):
    """Shared paged plumbing: planes + backing + gather snapshots."""

    def __init__(self, registry, name, label_names, capacity) -> None:
        # the host half only: the dense families' own __init__ would
        # allocate dense state
        _MetricBase.__init__(self, registry, name, label_names, capacity)
        self.pool = registry.pages
        self.planes: dict[str, PagedPlane] = {}
        self.table.backing = PageBacking(self.pool)

    def _plane(self, role: str, width: int,
               dtype: str = "float32") -> PagedPlane:
        p = PagedPlane(self.pool, dtype, width, self.table.capacity,
                       self.registry.tenant, role=f"{self.name}/{role}")
        self.planes[role] = p
        self.table.backing.add_plane(p)
        return p

    def _padded_active(self) -> tuple[np.ndarray, int]:
        """Active slots padded to a pow-2 bucket with -1 rows (read 0)."""
        slots = self.table.active_slots()
        padded = np.full(_pad_len(max(slots.size, 1)), -1, np.int32)
        padded[:slots.size] = slots
        return padded, slots.size

    def _gather_full(self, plane: PagedPlane) -> np.ndarray:
        """Capacity-shaped f32 host array with the active rows filled
        (int32 planes upcast: counts below 2^24 are exact in f32)."""
        padded, n = self._padded_active()
        shape = (self.table.capacity,) if plane.width == 1 \
            else (self.table.capacity, plane.width)
        full = np.zeros(shape, np.float32)
        if n:
            full[padded[:n]] = plane.gather(padded)[:n].astype(np.float32)
        return full

    def zero_evicted(self, padded_slots: np.ndarray) -> None:
        for p in self.planes.values():
            # the registry pads eviction batches with `capacity`; the paged
            # discard encoding is a negative slot
            p.zero_slots(np.where(padded_slots < p.capacity,
                                  padded_slots, -1))

    def device_state_bytes(self) -> int:
        return sum(p.device_state_bytes() for p in self.planes.values())

    def _dev(self, a, dtype) -> torch.Tensor:
        """`a` (host array or tensor) as `dtype` on the pool's device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.pool.device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.pool.device)


def _compact_write(name: str) -> None:
    raise NotImplementedError(
        f"{name}: the port has no per-span compact tier (a deliberate "
        "difference, ROADMAP section 3, \"Compact tier\": compact families "
        "are written only through ops.pages.fused_step, K1's compact "
        "branch)")


class PagedCounter(_PagedBase, Counter):
    def __init__(self, registry, name, label_names, capacity,
                 compact: bool = False):
        super().__init__(registry, name, label_names, capacity)
        self.compact = compact
        self.values = self._plane("values", 1,
                                  "int32" if compact else "float32")

    def add_slots(self, slots: np.ndarray,
                  weights: np.ndarray | None = None) -> None:
        if self.compact:
            _compact_write(self.name)
        w = torch.ones(len(slots), device=self.pool.device) \
            if weights is None else weights
        with self.registry.state_lock:
            s, w = self._dev(slots, torch.int32), self._dev(w, torch.float32)
            for a, t in self.values.operands():
                op.counter_add_step(a, t, s.to(a.device), w.to(a.device),
                                    page_shift=self.pool.page_shift)

    def _snap(self) -> tuple:
        return (self._gather_full(self.values),)


class PagedGauge(_PagedBase, Gauge):
    def __init__(self, registry, name, label_names, capacity):
        super().__init__(registry, name, label_names, capacity)
        self.values = self._plane("values", 1)

    def _device_set(self, slots: np.ndarray, values: np.ndarray) -> None:
        with self.registry.state_lock:
            s = self._dev(slots, torch.int32)
            v = self._dev(values, torch.float32)
            for a, t in self.values.operands():
                op.gauge_set_step(a, t, s.to(a.device), v.to(a.device),
                                  page_shift=self.pool.page_shift)

    def _snap(self) -> tuple:
        return (self._gather_full(self.values),)


class PagedHistogram(_PagedBase, Histogram):
    def __init__(self, registry, name, label_names, capacity,
                 edges: tuple[float, ...] = DEFAULT_HISTOGRAM_EDGES,
                 compact: bool = False):
        super().__init__(registry, name, label_names, capacity)
        self.edges = tuple(edges)
        self.compact = compact
        count_dt = "int32" if compact else "float32"
        self.buckets = self._plane("buckets", len(self.edges) + 1, count_dt)
        self.sums = self._plane("sums", 2 if compact else 1,
                                "bfloat16" if compact else "float32")
        self.counts = self._plane("counts", 1, count_dt)

    def observe_slots(self, slots: np.ndarray, values: np.ndarray,
                      weights: np.ndarray | None = None) -> None:
        if self.compact:
            _compact_write(self.name)
        w = torch.ones(len(slots), device=self.pool.device) \
            if weights is None else weights
        with self.registry.state_lock:
            cols = (self._dev(slots, torch.int32),
                    self._dev(values, torch.float32),
                    self._dev(w, torch.float32))
            for (a_s, t_s), (a_c, t_c), (a_b, t_b) in zip(
                    self.sums.operands(), self.counts.operands(),
                    self.buckets.operands()):
                op.histogram_observe_step(
                    a_s, a_c, a_b, t_b, t_s, t_c,
                    *(c.to(a_b.device) for c in cols),
                    edges=self.edges, page_shift=self.pool.page_shift)

    def _snap(self) -> tuple:
        if not self.compact:
            return (self._gather_full(self.buckets),
                    self._gather_full(self.sums),
                    self._gather_full(self.counts))
        # the pair folds to sum + compensation in f32
        padded, n = self._padded_active()
        full = np.zeros((self.table.capacity,), np.float32)
        if n:
            pair = self.sums.gather(padded)[:n]
            full[padded[:n]] = pair[:, 0] + pair[:, 1]
        return (self._gather_full(self.buckets), full,
                self._gather_full(self.counts))


class PagedNativeHistogram(_PagedBase, NativeHistogram):
    def __init__(self, registry, name, label_names, capacity):
        super().__init__(registry, name, label_names, capacity)
        self.offset = m.NATIVE_HISTOGRAM_OFFSET
        self.hist = self._plane("hist", op.NUM_LOG2_BUCKETS)
        self.sums = self._plane("sums", 1)
        self.counts = self._plane("counts", 1)
        self.zeros = self._plane("zeros", 1)

    def hist_offset(self) -> int:
        return self.offset

    def observe_slots(self, slots: np.ndarray, values: np.ndarray,
                      weights: np.ndarray | None = None) -> None:
        w = np.ones(len(slots), np.float32) if weights is None else weights
        with self.registry.state_lock:
            cols = (self._dev(slots, torch.int32),
                    self._dev(values, torch.float32),
                    self._dev(w, torch.float32))
            for (a_s, t_s), (a_c, t_c), (a_z, t_z), (a_h, t_h) in zip(
                    self.sums.operands(), self.counts.operands(),
                    self.zeros.operands(), self.hist.operands()):
                op.native_hist_step(
                    a_s, a_c, a_z, a_h, t_h, t_s, t_c, t_z,
                    *(c.to(a_h.device) for c in cols),
                    offset=self.offset, page_shift=self.pool.page_shift)

    def _snap(self) -> tuple:
        return (self._gather_full(self.sums), self._gather_full(self.counts))

    def native_payload(self):
        padded, n = self._padded_active()
        slots = padded[:n]
        return (slots, [self.labels_of(s) for s in slots.tolist()],
                *(p.gather(padded)[:n]
                  for p in (self.hist, self.sums, self.counts, self.zeros)))


__all__ = ["PagedCounter", "PagedGauge", "PagedHistogram",
           "PagedNativeHistogram"]
