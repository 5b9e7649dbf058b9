"""Multi-host generator fleet: tenant placement over the generator ring.

Counterpart of `tempo_tpu/fleet/`. This slice of the port carries
`placement.py` (`tenant_token`, `TenantPlacement`), which the
distributor's `generator_placement="tenant"` routes by, and the `fleet:`
config block the App reads (`FleetConfig`). Checkpoints, the handoff
controller, the worker and the fleet's obs families come with durability
and fleet (ROADMAP section 1, item 12): their names raise
`NotImplementedError` until then, and so does the App with
`fleet.enabled` set.
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


_LATER = {
    "FleetController", "STATS", "RETRY_CAUSES",
    "snapshot_instance", "restore_instance", "CheckpointMismatch",
    "write_checkpoint", "list_checkpoints", "read_checkpoint",
    "delete_checkpoint",
}


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"tempo_tpu_torch.fleet.{name} comes with durability and fleet "
            f"(ROADMAP section 1, item 12)")
    raise AttributeError(name)


__all__ = ["FleetConfig", "TenantPlacement", "tenant_token"]
