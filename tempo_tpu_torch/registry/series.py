"""Host-side series tables: label combos → dense device slot ids.

Replaces the reference's per-series hash map (`modules/generator/registry/
registry.go:139-144`) with a vectorized staging step: a batch of label-id
rows is uniqued once (numpy), unseen combos get slots from a free list,
and every span row resolves to a dense int32 slot usable as a device
scatter index.

Slot lifecycle mirrors the reference's active-series accounting
(`registry.go:184-197`) and staleness purge (`registry.go:258-277`): a
full table rejects new combos (slot -1, counted as discarded); idle
series are evicted and their device rows zeroed. This is the numpy path
only; the C++ row table of the reference comes with a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Exemplar:
    trace_id_hex: str
    value: float
    ts_ms: int


@dataclasses.dataclass(frozen=True)
class Sample:
    name: str
    labels: tuple[tuple[str, str], ...]  # sorted (name, value) pairs
    value: float
    ts_ms: int
    exemplar: Exemplar | None = None
    is_stale_marker: bool = False


class SeriesBudget:
    """Cross-family active-series budget shared by all tables of a tenant
    registry (`registry.go:184-197` onAddSeries/max_active_series)."""

    def __init__(self, limit: int):
        self.limit = limit
        self.used = 0

    def take(self) -> bool:
        if self.used >= self.limit:
            return False
        self.used += 1
        return True

    def release(self, n: int = 1) -> None:
        self.used = max(0, self.used - n)


class SeriesTable:
    """Fixed-capacity table of label-value-id rows → slot ids."""

    def __init__(self, capacity: int, n_labels: int,
                 budget: "SeriesBudget | None" = None, backing=None):
        self.capacity = capacity
        self.n_labels = n_labels
        self.budget = budget
        # a PageBacking (registry/pages.py) that must back a slot's device
        # pages before the slot is handed out; pool exhaustion rejects the
        # combo exactly like a spent budget
        self.backing = backing
        self._slots: dict[bytes, int] = {}
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self.slot_keys = np.full((capacity, n_labels), -1, np.int32)
        self.active = np.zeros(capacity, bool)
        self.last_seen = np.zeros(capacity, np.float64)
        self.discarded = 0  # combos rejected because the table was full

    @property
    def active_count(self) -> int:
        return self.capacity - len(self._free)

    def lookup_or_create(self, rows: np.ndarray, now: float,
                         valid: np.ndarray | None = None) -> np.ndarray:
        """Resolve [n, n_labels] int32 label rows to [n] int32 slots.
        Rows that cannot be allocated resolve to -1."""
        n = rows.shape[0]
        out = np.full(n, -1, np.int32)
        if n == 0:
            return out
        if valid is None:
            valid = np.ones(n, bool)
        uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        uslots = np.full(uniq.shape[0], -1, np.int32)
        # only unique rows that appear in valid positions allocate
        used = np.zeros(uniq.shape[0], bool)
        np.logical_or.at(used, inverse, valid)
        for i in np.flatnonzero(used).tolist():
            key = uniq[i].tobytes()
            slot = self._slots.get(key)
            if slot is None:
                if not self._free or (self.budget is not None
                                      and not self.budget.take()):
                    self.discarded += 1
                    continue
                slot = self._free.pop()
                if self.backing is not None and \
                        not self.backing.ensure_slot(slot):
                    self._free.append(slot)
                    if self.budget is not None:
                        self.budget.release()
                    self.discarded += 1
                    continue
                self._slots[key] = slot
                self.slot_keys[slot] = uniq[i]
                self.active[slot] = True
            self.last_seen[slot] = now
            uslots[i] = slot
        out = uslots[inverse]
        out[~valid] = -1
        return out

    def purge_stale(self, older_than: float) -> np.ndarray:
        """Evict series idle since before `older_than`; returns evicted slots."""
        stale = np.flatnonzero(self.active & (self.last_seen < older_than))
        for slot in stale.tolist():
            self._slots.pop(self.slot_keys[slot].tobytes(), None)
            self.active[slot] = False
            self.slot_keys[slot] = -1
            self._free.append(slot)
        if self.budget is not None and stale.size:
            self.budget.release(stale.size)
        if self.backing is not None and stale.size:
            # after the families zeroed the evicted rows (registry purge
            # order): pages that emptied return to the free list
            self.backing.release(stale)
        return stale

    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self.active)
