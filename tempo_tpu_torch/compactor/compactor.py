"""The compactor service (counterpart of `tempo_tpu/compactor/compactor.py`).

Each sweep compacts, backfills sidecars and applies retention through the
`TempoDB` it wraps (the merge on that db's device)."""

from __future__ import annotations

import time
from typing import Callable

from tempo_tpu_torch.db.tempodb import TempoDB
from tempo_tpu_torch.obs import Registry
from tempo_tpu_torch.ring import KVStore, Lifecycler, Ring

COMPACTOR_RING = "compactor"


class Compactor:
    def __init__(self, db: TempoDB, kv: KVStore | None = None,
                 instance_id: str = "compactor-0",
                 registry: Registry | None = None,
                 now: Callable[[], float] = time.time) -> None:
        self.db = db
        self.id = instance_id
        self.now = now
        # share the db's registry by default so a compactor target's
        # /metrics carries both the service sweep and the per-tenant
        # cycle histogram the db records
        self.obs = registry if registry is not None else db.obs
        self.sweeps = self.obs.counter(
            "tempo_compactor_sweeps_total",
            "Full compactor sweeps over all tenants")
        self.kv = kv
        self.ring: Ring | None = None
        self.lifecycler: Lifecycler | None = None
        if kv is not None:
            self.ring = Ring(kv=kv, key=COMPACTOR_RING, replication_factor=1,
                             now=now)
            self.lifecycler = Lifecycler(kv, instance_id, key=COMPACTOR_RING,
                                         now=now)

    def owns(self, key: str) -> bool:
        """Hash the job key onto the compactor ring (`Owns`
        `compactor.go:190`); single-instance mode owns everything."""
        if self.ring is None or len(self.ring) <= 1:
            return True
        return self.ring.owns(self.id, key)

    def run_once(self) -> int:
        """One sweep over all tenants; returns jobs executed. Retention is
        ring-gated per tenant too — N compactors must not race the same
        delete/mark writes — and the sweep keeps our heartbeat fresh so a
        caller-driven loop can't age itself out of the ring."""
        self.heartbeat()
        self.sweeps.inc()
        done = 0
        for tenant in self.db.blocklist.tenants():
            try:
                done += self.db.compact_tenant_once(tenant, owns=self.owns)
                # low-priority sidecar backfill for pre-sidecar blocks —
                # rides the compaction sched class so sustained ingest
                # only reaches it via the min-share valve
                if self.owns(f"sidecars/{tenant}"):
                    done += self.db.backfill_sidecars_once(tenant)
                if self.owns(f"retention/{tenant}"):
                    self.db.retention_once(tenant)
            except Exception:
                continue  # a failed tenant must not stall the sweep
        return done

    def enable(self, interval_s: float = 30.0) -> None:
        self.db.enable_compaction(interval_s, owns=self.owns)

    def heartbeat(self) -> None:
        if self.lifecycler:
            self.lifecycler.heartbeat()

    def shutdown(self) -> None:
        if self.lifecycler:
            self.lifecycler.leave()
