"""Bounded worker pool for fan-out block queries.

Analog of `tempodb/pool/pool.go:49-210` (`RunJobs`): run N jobs over a
bounded thread pool, collect results, support stop-on-first-result (the
trace-by-ID path stops once a quorum of results arrives).
"""

from __future__ import annotations

from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Iterable, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class Pool:
    def __init__(self, max_workers: int = 30, queue_depth: int = 10_000):
        self.max_workers = max_workers
        self.queue_depth = queue_depth
        self._ex = ThreadPoolExecutor(max_workers=max_workers,
                                      thread_name_prefix="tempodb-pool")

    def run_jobs(self, payloads: Iterable[T], fn: Callable[[T], R],
                 stop_when: Callable[[list[R]], bool] | None = None) -> tuple[list[R], list[Exception]]:
        """Run fn over payloads; returns (results, errors). `stop_when`
        short-circuits remaining jobs once satisfied on collected results."""
        payloads = list(payloads)
        if len(payloads) > self.queue_depth:
            raise RuntimeError(f"too many jobs: {len(payloads)} > {self.queue_depth}")
        futures = {self._ex.submit(fn, p) for p in payloads}
        results: list[R] = []
        errors: list[Exception] = []
        try:
            while futures:
                done, futures = wait(futures, return_when=FIRST_COMPLETED)
                for f in done:
                    try:
                        r = f.result()
                        if r is not None:
                            results.append(r)
                    except Exception as e:  # collect, don't abort the fan-out
                        errors.append(e)
                if stop_when is not None and stop_when(results):
                    for f in futures:
                        f.cancel()
                    break
        finally:
            for f in futures:
                f.cancel()
        return results, errors

    def shutdown(self) -> None:
        self._ex.shutdown(wait=False, cancel_futures=True)
