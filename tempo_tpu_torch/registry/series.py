"""Host-side series tables: label combos → dense device slot ids.

Replaces the reference's per-series hash map (`modules/generator/registry/
registry.go:139-144`) with the C++ row table of `tempo_tpu_torch.native`
(`NativeRowTable`), as `tempo_tpu/registry/series.py` does when its
library loads: one native pass resolves every known label row of a batch
to its slot, and only the first occurrence of each new combo crosses back
into Python for slot allocation and budget accounting, so slots are
handed out in first-seen order.

Slot lifecycle mirrors the reference's active-series accounting
(`registry.go:184-197`) and staleness purge (`registry.go:258-277`): a
full table, a spent budget or an exhausted page pool rejects new combos
(slot -1, counted as discarded, the pending row removed from the native
table); idle series are evicted and their device rows zeroed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tempo_tpu_torch import native


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
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self.slot_keys = np.full((capacity, n_labels), -1, np.int32)
        self.active = np.zeros(capacity, bool)
        self.last_seen = np.zeros(capacity, np.float64)
        self.discarded = 0  # combos rejected because the table was full
        self._nat = native.NativeRowTable(n_labels)

    @property
    def active_count(self) -> int:
        return self.capacity - len(self._free)

    def lookup_or_create(self, rows: np.ndarray, now: float,
                         valid: np.ndarray | None = None) -> np.ndarray:
        """Resolve [n, n_labels] int32 label rows to [n] int32 slots.
        Rows that cannot be allocated resolve to -1."""
        n = rows.shape[0]
        if n == 0:
            return np.full(0, -1, np.int32)
        if valid is None:
            valid = np.ones(n, bool)
        return self._lookup_native(rows, now, valid)

    def _lookup_native(self, rows: np.ndarray, now: float,
                       valid: np.ndarray) -> np.ndarray:
        """One native pass resolves every known combo; only new combos
        (first occurrence per batch) come back for `apply_misses`."""
        rows = np.ascontiguousarray(rows, np.int32)
        out, miss = self._nat.lookup(rows, valid)
        if miss.size:
            self.apply_misses(rows, out, miss, valid, now)
        live = out[out >= 0]
        if live.size:
            self.last_seen[live] = now
        return out

    def apply_misses(self, rows: np.ndarray, out: np.ndarray,
                     miss: np.ndarray, valid: np.ndarray,
                     now: float) -> None:
        """Resolve the PENDING entries a native lookup reported: allocate
        slots (budget- and page-gated) for first occurrences, then fix
        in-batch duplicates on the host. `out` is updated in place;
        `rows`/`valid` cover out[:len(rows)] (out may be padded longer).
        A rejected combo's pending entry is removed, so none lingers."""
        n = len(rows)
        pend: dict[bytes, int] = {}
        for i in miss.tolist():
            row = rows[i]
            key = row.tobytes()
            if not self._free or (self.budget is not None
                                  and not self.budget.take()):
                self.discarded += 1
                self._nat.remove(row)
                pend[key] = -1
                continue
            slot = self._free.pop()
            if self.backing is not None and \
                    not self.backing.ensure_slot(slot):
                self._free.append(slot)
                if self.budget is not None:
                    self.budget.release()
                self.discarded += 1
                self._nat.remove(row)
                pend[key] = -1
                continue
            self._nat.insert(row, slot)
            self.slot_keys[slot] = row
            self.active[slot] = True
            self.last_seen[slot] = now
            pend[key] = slot
            out[i] = slot
        # duplicates of new combos within this batch, resolved here
        unres = np.flatnonzero((out[:n] < 0) & valid[:n])
        for i in unres.tolist():
            out[i] = pend.get(rows[i].tobytes(), -1)

    def purge_stale(self, older_than: float) -> np.ndarray:
        """Evict series idle since before `older_than`; returns evicted slots."""
        stale = np.flatnonzero(self.active & (self.last_seen < older_than))
        for slot in stale.tolist():
            self._nat.remove(self.slot_keys[slot])
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
