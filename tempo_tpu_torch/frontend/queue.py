"""Tenant-fair request queue with worker pull.

Analog of `modules/frontend/queue/queue.go:59-211`: one FIFO per tenant,
round-robin dispatch across tenants (shard-fairness), a per-tenant
outstanding cap (`v1/frontend.go:40-41` default 2000), and batch dequeue
for workers (`max_batch_size` batching `v1/frontend.go:35`).

Counterpart of `tempo_tpu/frontend/queue.py` (copied).
"""

from __future__ import annotations

import collections
import threading
from typing import Any


class QueueFull(RuntimeError):
    pass


class RequestQueue:
    def __init__(self, max_outstanding_per_tenant: int = 2000) -> None:
        self.max_outstanding = max_outstanding_per_tenant
        self._queues: dict[str, collections.deque] = {}
        self._tenants: collections.deque[str] = collections.deque()  # RR order
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False

    def enqueue(self, tenant: str, job: Any) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("queue closed")
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = collections.deque()
                self._tenants.append(tenant)
            if len(q) >= self.max_outstanding:
                raise QueueFull(f"tenant {tenant} has {len(q)} outstanding")
            q.append(job)
            self._cv.notify()

    def dequeue_batch(self, max_batch: int = 1,
                      timeout_s: float | None = None) -> list[Any]:
        """Pop up to max_batch jobs from ONE tenant (the next in round-robin
        order), like the frontend's per-tenant job batches."""
        with self._cv:
            if not self._wait_nonempty(timeout_s):
                return []
            # rotate to the next tenant with work
            for _ in range(len(self._tenants)):
                tenant = self._tenants[0]
                self._tenants.rotate(-1)
                q = self._queues.get(tenant)
                if q:
                    out = []
                    while q and len(out) < max_batch:
                        out.append(q.popleft())
                    if not q:
                        self._drop_tenant(tenant)
                    return out
            return []

    def _wait_nonempty(self, timeout_s: float | None) -> bool:
        if any(self._queues.values()):
            return True
        if timeout_s is None or timeout_s <= 0:
            return False
        self._cv.wait(timeout_s)
        return any(self._queues.values())

    def _drop_tenant(self, tenant: str) -> None:
        self._queues.pop(tenant, None)
        try:
            self._tenants.remove(tenant)
        except ValueError:
            pass

    def lengths(self) -> dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items()}

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
