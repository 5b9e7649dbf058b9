"""Hedged requests: duplicate a slow call after a delay, first reply wins.

Analog of the reference's hedgedhttp wrapping of object-store reads
(`tempodb/backend/s3/s3.go:25,129`) + `pkg/hedgedmetrics`: tail latency on
remote reads is cut by firing a second attempt once the first exceeds the
hedge delay. `HedgedReader` wraps any RawReader (wired by the App when
`storage.hedge_delay_s` is set — meaningful for remote backends).

Counterpart of `tempo_tpu/utils/hedging.py` (host code), copied with
its imports moved to the port.
"""

from __future__ import annotations

import threading
from typing import Callable, TypeVar

from tempo_tpu_torch.backend.raw import KeyPath, RawReader

T = TypeVar("T")


class HedgedMetrics:
    def __init__(self) -> None:
        self.requests_total = 0
        self.hedged_total = 0
        self._lock = threading.Lock()


def hedged_call(fn: Callable[[], T], delay_s: float = 0.5,
                max_hedges: int = 1,
                metrics: HedgedMetrics | None = None) -> T:
    """Run fn; while nothing has finished after delay_s, race duplicates
    (up to max_hedges extra). Returns the first completed result; raises
    the first error only once every launched attempt has failed."""
    if metrics is not None:
        with metrics._lock:
            metrics.requests_total += 1
    cv = threading.Condition()
    state = {"launched": 0, "finished": 0, "results": [], "error": None}

    def attempt():
        try:
            r = fn()
        except Exception as e:
            with cv:
                state["finished"] += 1
                if state["error"] is None:
                    state["error"] = e
                cv.notify_all()
            return
        with cv:
            state["finished"] += 1
            state["results"].append(r)
            cv.notify_all()

    def launch():
        state["launched"] += 1
        threading.Thread(target=attempt, daemon=True).start()

    with cv:
        launch()
        while True:
            if state["results"]:
                return state["results"][0]
            if state["finished"] == state["launched"]:
                # every launched attempt failed; hedging more can't help a
                # deterministic error, so propagate (hedgedhttp semantics:
                # hedges target latency, not retries)
                raise state["error"]
            timed_out = not cv.wait(delay_s)
            if state["results"]:
                return state["results"][0]
            if timed_out and state["launched"] <= max_hedges:
                if metrics is not None:
                    with metrics._lock:
                        metrics.hedged_total += 1
                launch()


class HedgedReader(RawReader):
    """RawReader wrapper hedging `read`/`read_range` (the latency-sensitive
    object fetches); listings pass through."""

    def __init__(self, inner: RawReader, delay_s: float = 0.5,
                 max_hedges: int = 1,
                 metrics: HedgedMetrics | None = None) -> None:
        self.inner = inner
        self.delay_s = delay_s
        self.max_hedges = max_hedges
        self.metrics = metrics or HedgedMetrics()

    def list(self, keypath: KeyPath) -> list[str]:
        return self.inner.list(keypath)

    def find(self, keypath: KeyPath, suffix: str = "") -> list[str]:
        return self.inner.find(keypath, suffix)

    def size(self, name: str, keypath: KeyPath) -> int:
        return self.inner.size(name, keypath)

    def read(self, name: str, keypath: KeyPath) -> bytes:
        return hedged_call(lambda: self.inner.read(name, keypath),
                           self.delay_s, self.max_hedges, self.metrics)

    def read_range(self, name: str, keypath: KeyPath, offset: int,
                   length: int) -> bytes:
        return hedged_call(
            lambda: self.inner.read_range(name, keypath, offset, length),
            self.delay_s, self.max_hedges, self.metrics)
