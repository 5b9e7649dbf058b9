"""Compactor service: ring-sharded ownership over tempodb compaction.

Counterpart of `tempo_tpu/compactor/` (`modules/compactor`): the service
joins a compactor ring and only runs compaction jobs whose hash it owns
(`Owns` `compactor.go:190`), so N compactors split tenants' job space
with no coordination beyond the ring. Trace dedupe during merge
(`Combine` `compactor.go:220`) lives in `tempo_tpu_torch.model.combine`
and the block compactor (`db/compactor.py`).
"""

from tempo_tpu_torch.compactor.compactor import Compactor

__all__ = ["Compactor"]
