"""Blockbuilder: partition consumer that builds backend blocks directly.

Counterpart of `tempo_tpu/blockbuilder/`, the analog of
`modules/blockbuilder`: replaces the ingester on the ingest-storage path
— consumes its partitions from the bus, accumulates per-tenant live
traces, writes RF1 blocks straight to object storage with a sketch
sidecar each, and commits consumed offsets only AFTER the flush succeeds
so a crash replays rather than loses (`consumePartition`
`blockbuilder.go:266`, commit-after-flush `blockbuilder.go:209-265`).
"""

from tempo_tpu_torch.blockbuilder.blockbuilder import BlockBuilder, BlockBuilderConfig

__all__ = ["BlockBuilder", "BlockBuilderConfig"]
