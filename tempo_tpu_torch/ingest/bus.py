"""In-memory partitioned record log with consumer-group offsets.

Counterpart of `tempo_tpu/ingest/bus.py`, host code copied with its imports
moved to the port.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class Record:
    offset: int
    tenant: str
    value: bytes


class Bus:
    """N partitions of (tenant, bytes) records; committed offsets per
    (group, partition). Thread-safe."""

    def __init__(self, n_partitions: int = 2) -> None:
        self.n_partitions = n_partitions
        self._logs: list[list[Record]] = [[] for _ in range(n_partitions)]
        self._commits: dict[tuple[str, int], int] = {}
        self._lock = threading.Lock()

    def produce(self, partition: int, tenant: str, value: bytes) -> int:
        with self._lock:
            log = self._logs[partition % self.n_partitions]
            rec = Record(len(log), tenant, value)
            log.append(rec)
            return rec.offset

    def fetch(self, partition: int, offset: int, max_records: int = 100
              ) -> list[Record]:
        with self._lock:
            log = self._logs[partition % self.n_partitions]
            return log[offset: offset + max_records]

    def commit(self, group: str, partition: int, offset: int) -> None:
        """Commit = next offset to consume (kafka semantics)."""
        with self._lock:
            self._commits[(group, partition)] = offset

    def committed(self, group: str, partition: int) -> int:
        with self._lock:
            return self._commits.get((group, partition), 0)

    def high_watermark(self, partition: int) -> int:
        with self._lock:
            return len(self._logs[partition % self.n_partitions])

    def lag(self, group: str, partition: int) -> int:
        return self.high_watermark(partition) - self.committed(group, partition)
