"""Tenant placement over the generator ring.

Counterpart of `tempo_tpu/fleet/placement.py`, host code copied with its imports
moved to the port.

One tenant = one token = one healthy owner (RF1 with spillover past
unhealthy members — `Ring.owner_of`). The distributor and every fleet
member hash tenants the SAME way, so routing and ownership agree from
independent ring views; disagreement during convergence windows is
resolved by the checkpoint/merge protocol (controller.py), never by
dropping state.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable

from tempo_tpu_torch.ring.ring import _hash_str

if TYPE_CHECKING:  # pragma: no cover
    from tempo_tpu_torch.ring import InstanceDesc, Ring


def tenant_token(tenant: str) -> int:
    """The ring token a tenant's whole series space hashes to. Shared by
    the distributor's tenant-placement routing and the fleet ownership
    watch — the two MUST agree or a tenant's spans and its checkpoints
    would land on different members."""
    return _hash_str("fleet-tenant/" + tenant)


class TenantPlacement:
    """This member's view of tenant→owner over a live ring."""

    def __init__(self, ring: "Ring", instance_id: str) -> None:
        self.ring = ring
        self.id = instance_id

    def owner(self, tenant: str) -> "InstanceDesc | None":
        return self.ring.owner_of(tenant_token(tenant))

    def owns(self, tenant: str) -> bool:
        return self.ring.owns(self.id, tenant_token(tenant))

    def lost(self, tenants: Iterable[str]) -> list[tuple[str, str]]:
        """(tenant, new_owner_id) for held tenants this member no longer
        owns. Tenants with NO resolvable owner (empty/all-dead ring) are
        not reported — releasing state with nowhere to send it would
        strand the checkpoint until the ring heals anyway, and the local
        instance keeps serving meanwhile."""
        out = []
        for t in tenants:
            owner = self.owner(t)
            if owner is not None and owner.id != self.id:
                out.append((t, owner.id))
        return out
