"""Multi-host generator fleet: N processes as ONE logical metrics-generator.

Counterpart of `tempo_tpu/fleet/`:

- **Placement** (`placement.py`): tenants hash onto the generator ring
  (RF1 with spillover past unhealthy members); the distributor's
  `generator_placement="tenant"` routes a tenant's whole stream to its
  owner.
- **Checkpoint/restore** (`checkpoint.py`): a tenant's device state
  (every family's active rows and the sketch sidecars, gathered on the
  card) snapshots to the object store as one mergeable blob in the
  reference's format; restore scatter-merges it into the receiving
  instance's device planes.
- **Drain/handoff** (`controller.py`): on an ownership change the losing
  process drains, checkpoints and drops the tenant; the gaining process
  restores and merges, then replays its WAL past the blob's watermark.
  Shutdown checkpoints and boot restores are the same two code paths.
- **Worker** (`worker.py`): `python -m tempo_tpu_torch.fleet.worker
  --config fleet.yaml` (one fleet member, on the card) and `--kv-only`
  (a standalone /kv CAS server).

`app.config` imports this module: the heavy siblings load lazily (the
exports below). Importing it registers the `tempo_fleet_*` families in
the process runtime registry.
"""

from __future__ import annotations

import dataclasses

from tempo_tpu_torch.fleet.placement import TenantPlacement, tenant_token


@dataclasses.dataclass
class FleetConfig:
    """The `fleet:` config block (generator targets only)."""

    enabled: bool = False
    # ownership re-check cadence: the membership watch fires on KV
    # updates, but heartbeat EXPIRY is a clock event no KV write
    # announces — the controller re-walks held tenants this often
    rebalance_interval_s: float = 2.0
    # snapshot every held tenant to the backend on shutdown (the
    # restart-without-data-loss half of the protocol)
    checkpoint_on_shutdown: bool = True
    # consume checkpoints addressed to this member on boot and on
    # ownership gain (restore + merge)
    restore_on_boot: bool = True
    # object-store prefix the checkpoint blobs live under
    checkpoint_prefix: str = "fleet-checkpoints"
    # transient blob-write failures retry with jittered exponential
    # backoff before the handoff falls back to reattach/orphan; retries
    # are counted in tempo_fleet_checkpoint_retries_total{cause}
    checkpoint_write_retries: int = 3
    checkpoint_retry_backoff_s: float = 0.2

    def check(self) -> list[str]:
        problems = []
        if self.rebalance_interval_s <= 0:
            problems.append(
                f"fleet.rebalance_interval_s ({self.rebalance_interval_s}) "
                "must be > 0: the ownership watch would spin")
        if not self.checkpoint_prefix or "/" in self.checkpoint_prefix:
            problems.append(
                f"fleet.checkpoint_prefix {self.checkpoint_prefix!r} must "
                "be a single non-empty path segment")
        if self.checkpoint_write_retries < 0 or \
                self.checkpoint_retry_backoff_s <= 0:
            problems.append(
                "fleet.checkpoint_write_retries must be >= 0 and "
                "checkpoint_retry_backoff_s > 0")
        return ["fleet: " + p for p in problems] if problems else []


# mutated by checkpoint.py / controller.py under their own locks; plain
# int/float adds are atomic enough for counters
STATS = {
    "checkpoint_bytes": 0,
    "checkpoint_seconds": 0.0,
    "checkpoints": 0,
    "restores": 0,
    "restore_merged_series": 0,
    "restore_dropped_series": 0,
    "handoffs": 0,
}

# checkpoint blob-write retries by exception class (the controller's
# backoff loop; a rising rate means the object store flaps under handoffs)
RETRY_CAUSES: dict = {}

from tempo_tpu_torch.obs.runtime import RUNTIME  # noqa: E402

RUNTIME.counter_func(
    "tempo_fleet_checkpoint_bytes_total",
    lambda: [((), float(STATS["checkpoint_bytes"]))],
    help="Bytes of tenant device-state checkpoints written to the "
         "object store (runbook 'Operating a generator fleet')")
RUNTIME.counter_func(
    "tempo_fleet_checkpoint_seconds_total",
    lambda: [((), float(STATS["checkpoint_seconds"]))],
    help="Wall seconds spent cutting tenant checkpoints (drain + "
         "gather + encode + backend write)")
RUNTIME.counter_func(
    "tempo_fleet_checkpoints_total",
    lambda: [((), float(STATS["checkpoints"]))],
    help="Tenant checkpoints written (handoffs + shutdown snapshots)")
RUNTIME.counter_func(
    "tempo_fleet_checkpoint_restores_total",
    lambda: [((), float(STATS["restores"]))],
    help="Tenant checkpoints restored-and-merged into this process "
         "(boot restores + handoff receives)")
RUNTIME.counter_func(
    "tempo_fleet_checkpoint_retries_total",
    lambda: [((cause,), float(n)) for cause, n in RETRY_CAUSES.items()],
    help="Checkpoint blob-write retries by failure cause (jittered "
         "backoff before reattach/orphan fallback; runbook 'Operating "
         "a generator fleet')",
    labels=("cause",))
RUNTIME.counter_func(
    "tempo_fleet_handoffs_total",
    lambda: [((), float(STATS["handoffs"]))],
    help="Tenants this process drained, checkpointed, and released "
         "because ring ownership moved elsewhere")


def __getattr__(name: str):
    """Lazy exports: the heavy halves import torch and the generator."""
    if name in ("snapshot_instance", "restore_instance",
                "CheckpointMismatch", "write_checkpoint",
                "list_checkpoints", "read_checkpoint", "delete_checkpoint"):
        from tempo_tpu_torch.fleet import checkpoint
        return getattr(checkpoint, name)
    if name == "FleetController":
        from tempo_tpu_torch.fleet.controller import FleetController
        return FleetController
    raise AttributeError(name)


__all__ = ["FleetConfig", "FleetController", "TenantPlacement", "STATS",
           "RETRY_CAUSES", "tenant_token", "snapshot_instance",
           "restore_instance", "CheckpointMismatch"]
