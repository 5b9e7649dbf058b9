"""Priority flush queues with dedupe and retry backoff.

Analog of `pkg/flushqueues` + the ingester's retry discipline
(`modules/ingester/flush.go:64-73,249-427`): operations are keyed (dedupe —
re-enqueueing an in-flight key is a no-op), ordered by an `at` timestamp
(retries push `at` into the future with exponential backoff + jitter), and
sharded across N queues by key hash so tenants don't serialize behind each
other.

Counterpart of `tempo_tpu/utils/flushqueues.py`, copied whole.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
import threading
import time
from typing import Any, Callable


@dataclasses.dataclass(order=True)
class _Item:
    at: float
    seq: int
    key: str = dataclasses.field(compare=False)
    op: Any = dataclasses.field(compare=False)


class FlushQueues:
    """N keyed priority queues. Thread-safe; pollers call `dequeue`."""

    def __init__(self, n_queues: int = 1,
                 now: Callable[[], float] = time.time) -> None:
        self.now = now
        self._qs: list[list[_Item]] = [[] for _ in range(n_queues)]
        self._keys: set[str] = set()
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._qs)

    def enqueue(self, key: str, op: Any, at: float | None = None) -> bool:
        """False if the key is already queued/in-flight (dedupe)."""
        with self._lock:
            if self._closed or key in self._keys:
                return False
            self._keys.add(key)
            self._seq += 1
            q = self._qs[hash(key) % len(self._qs)]
            heapq.heappush(q, _Item(at if at is not None else self.now(),
                                    self._seq, key, op))
        return True

    def requeue(self, key: str, op: Any, at: float) -> None:
        """Re-add a failed op (key stays claimed between dequeue & requeue)."""
        with self._lock:
            if self._closed:
                self._keys.discard(key)
                return
            self._seq += 1
            self._keys.add(key)
            q = self._qs[hash(key) % len(self._qs)]
            heapq.heappush(q, _Item(at, self._seq, key, op))

    def dequeue(self, queue_idx: int = 0) -> tuple[str, Any] | None:
        """Pop the due head of queue `queue_idx`; None if empty/not due.
        The key remains claimed until `done` or `requeue`."""
        with self._lock:
            q = self._qs[queue_idx % len(self._qs)]
            if not q or q[0].at > self.now():
                return None
            it = heapq.heappop(q)
            return it.key, it.op

    def done(self, key: str) -> None:
        with self._lock:
            self._keys.discard(key)

    def close(self) -> None:
        with self._lock:
            self._closed = True

    def drain(self, handle: Callable[[str, Any], bool]) -> int:
        """Synchronously process everything due-or-not (shutdown flush /
        tests). `handle` owns the op lifecycle — it must `done` or `requeue`
        each key itself (the Ingester._handle_op contract), so a transient
        failure's requeued copy is the ONLY copy and gets popped again here
        until the handler succeeds or abandons. Returns successful ops."""
        ok = 0
        progress = True
        while progress:
            progress = False
            for qi in range(len(self._qs)):
                while True:
                    with self._lock:
                        q = self._qs[qi]
                        if not q:
                            break
                        it = heapq.heappop(q)
                    progress = True
                    ok += 1 if handle(it.key, it.op) else 0
        return ok


def backoff_at(now: float, attempt: int, base_s: float = 30.0,
               max_s: float = 300.0, jitter: float = 0.25) -> float:
    """Next retry time: exponential with decorrelated jitter
    (`flush.go:213` retry with backoff + the queue's jitter)."""
    d = min(max_s, base_s * (2 ** max(0, attempt - 1)))
    return now + d * (1.0 + random.random() * jitter)
