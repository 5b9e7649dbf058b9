"""Multi-host generator fleet: tenant placement over the generator ring.

Counterpart of `tempo_tpu/fleet/`. This slice of the port carries
`placement.py` (`tenant_token`, `TenantPlacement`), which the
distributor's `generator_placement="tenant"` routes by. Checkpoints, the
handoff controller, the worker and the fleet's obs families come with
durability and fleet (ROADMAP section 1, item 12): their names raise
`NotImplementedError` until then.
"""

from tempo_tpu_torch.fleet.placement import TenantPlacement, tenant_token

_LATER = {
    "FleetConfig", "FleetController", "STATS", "RETRY_CAUSES",
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


__all__ = ["TenantPlacement", "tenant_token"]
