"""Consistent-hash ring + in-memory gossip KV: the distribution backbone.

CPU-side analog of the vendored dskit ring/memberlist layer the reference
builds on (`cmd/tempo/app/modules.go:154-203,593-625`, `pkg/ring/ring.go`):
write-path replication sets (RF quorum), per-tenant shuffle sharding,
ring-owned background jobs (compactor `modules/compactor/compactor.go:190`),
and partition rings for the ingest-bus path.

Counterpart of `tempo_tpu/ring/`.
"""

from tempo_tpu_torch.ring.kv import KVStore
from tempo_tpu_torch.ring.ring import (
    ACTIVE,
    JOINING,
    LEAVING,
    UNHEALTHY,
    InstanceDesc,
    Lifecycler,
    ReplicationSet,
    Ring,
    do_batch,
)

__all__ = [
    "ACTIVE", "JOINING", "LEAVING", "UNHEALTHY",
    "InstanceDesc", "Lifecycler", "ReplicationSet", "Ring",
    "do_batch", "KVStore",
]
