"""Ingester: live-trace accumulation → WAL → complete blocks → backend flush.

Analog of `modules/ingester`: per-tenant instances accumulate spans in live
traces (`instance.go:145,199`), cut complete traces to a head WAL block
(`CutCompleteTraces` `instance.go:237`), cut the head block when full
(`CutBlockIfReady` `instance.go:272`), convert WAL→columnar complete blocks
(`CompleteBlock` `instance.go:316`), and flush them to object storage
through retrying flush queues (`flush.go:213-427`). WAL replay on restart
(`instance.go:601`, `ingester.go:159`) restores in-flight data.

Counterpart of `tempo_tpu/ingester/`.
"""

from tempo_tpu_torch.ingester.ingester import Ingester, IngesterConfig
from tempo_tpu_torch.ingester.instance import PUSH_ERRORS, TenantInstance

__all__ = ["Ingester", "IngesterConfig", "TenantInstance", "PUSH_ERRORS"]
