"""Anonymous usage-stats reporter (ref `pkg/usagestats/reporter.go`).

Counterpart of `tempo_tpu/utils/usagestats.py`, copied with its imports
moved to the port.

The reference elects a leader via KV CAS, persists a cluster seed to the
object store, and periodically writes an anonymized report (version,
uptime, feature counters). Same shape here, minus any egress: the
"report" goes to the backend under `usage-stats/` where an operator can
inspect exactly what WOULD be reported — this build never phones home.

Leader election (`reporter.go:58,239`): members CAS a lease with an
expiry into the shared KV; the holder renews, others take over when the
lease lapses. The same election primitive the blocklist index builder
uses, exercised here against the replicated KV."""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Any, Callable

SEED_KEY = "usage-stats/seed"
LEADER_KEY = "usage-stats/leader"
REPORT_NAME = "report.json"


class UsageReporter:
    def __init__(self, kv, writer, *, instance_id: str,
                 interval_s: float = 3600.0, lease_s: float = 90.0,
                 now: Callable[[], float] = time.time) -> None:
        self.kv = kv
        self.writer = writer
        self.id = instance_id
        self.interval_s = interval_s
        self.lease_s = lease_s
        self.now = now
        self.started = now()
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.reports_written = 0

    # -- stats registry (usagestats.NewInt/NewString analogs) --------------

    def set_stat(self, name: str, value) -> None:
        with self._lock:
            self._metrics[name] = value

    def inc_stat(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._metrics[name] = self._metrics.get(name, 0) + n

    # -- cluster seed ------------------------------------------------------

    def _cas(self, key: str, update):
        """Election-style CAS: against a replicated KV this must hit ONE
        member (per-member CAS could crown two leaders / mint two seeds);
        `cas_primary` provides that, plain stores use their normal cas."""
        fn = getattr(self.kv, "cas_primary", None) or self.kv.cas
        return fn(key, update)

    def get_or_create_seed(self) -> str:
        """One anonymous UUID per cluster, agreed via KV CAS
        (`reporter.go` seed file + kv coordination)."""
        want = str(uuid.uuid4())

        def update(cur):
            return cur if cur else {"uuid": want,
                                    "created": self.now()}
        got = self._cas(SEED_KEY, update)
        return got["uuid"] if isinstance(got, dict) else want

    # -- leader election ---------------------------------------------------

    def try_acquire_leadership(self) -> bool:
        """CAS the leader lease; True when this member holds it."""
        now = self.now()

        def update(cur):
            if (isinstance(cur, dict) and cur.get("id") != self.id
                    and cur.get("expires", 0) > now):
                return None        # live leader elsewhere: no-op
            return {"id": self.id, "expires": now + self.lease_s}

        got = self._cas(LEADER_KEY, update)
        return isinstance(got, dict) and got.get("id") == self.id \
            and got.get("expires", 0) > now

    # -- reporting ---------------------------------------------------------

    def cached_seed(self) -> str:
        """The cluster seed, resolved once and memoized: read paths
        (the /status/usage-stats endpoint) must not pay a KV CAS — or
        mutate cluster state — per poll."""
        got = getattr(self, "_seed_cache", None)
        if got is None:
            got = self._seed_cache = self.get_or_create_seed()
        return got

    def build_report(self, seed: str) -> dict:
        with self._lock:
            metrics = dict(self._metrics)
        return {
            "clusterID": seed,
            "createdAt": self.now(),
            "interval": self.interval_s,
            "target": metrics.pop("target", ""),
            "uptimeS": round(self.now() - self.started, 1),
            "metrics": metrics,
        }

    def report_once(self) -> bool:
        """Write one report if this member is (or becomes) the leader."""
        if not self.try_acquire_leadership():
            return False
        seed = self.get_or_create_seed()
        from tempo_tpu_torch.backend.raw import KeyPath
        body = json.dumps(self.build_report(seed), sort_keys=True).encode()
        self.writer.write(REPORT_NAME, KeyPath(("usage-stats",)), body)
        self.reports_written += 1
        return True

    # -- loop --------------------------------------------------------------

    def start(self) -> None:
        def loop():
            # renew/contend at a fraction of the lease, report at interval
            next_report = self.now()
            while not self._stop.wait(min(self.lease_s / 3,
                                          self.interval_s)):
                try:
                    if self.now() >= next_report:
                        if self.report_once():
                            next_report = self.now() + self.interval_s
                    else:
                        self.try_acquire_leadership()
                except Exception:
                    pass           # stats must never hurt the service
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


__all__ = ["UsageReporter", "SEED_KEY", "LEADER_KEY", "REPORT_NAME"]
