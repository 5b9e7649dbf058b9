"""Per-op SLO accounting.

Analog of `modules/frontend/slos.go:29-38`: a query is `within_slo` when
its latency beat the threshold OR its bytes/sec throughput beat the
throughput floor (slow-but-huge queries still count as good).
Counters follow the `tempo_query_frontend_queries_within_slo_total` shape.

Counterpart of `tempo_tpu/frontend/slos.py` (copied).
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class SLOConfig:
    duration_slo_s: float = 0.0        # 0 disables the latency criterion
    throughput_bytes_slo: float = 0.0  # 0 disables the throughput criterion


class SLORecorder:
    def __init__(self, per_op: dict[str, SLOConfig] | None = None) -> None:
        self.per_op = per_op or {}
        self._lock = threading.Lock()
        self.total: dict[tuple[str, str], int] = {}
        self.within: dict[tuple[str, str], int] = {}

    def record(self, op: str, tenant: str, latency_s: float,
               bytes_processed: int) -> bool:
        cfg = self.per_op.get(op, SLOConfig())
        good = False
        if cfg.duration_slo_s and latency_s < cfg.duration_slo_s:
            good = True
        if (cfg.throughput_bytes_slo and latency_s > 0
                and bytes_processed / latency_s > cfg.throughput_bytes_slo):
            good = True
        if not cfg.duration_slo_s and not cfg.throughput_bytes_slo:
            good = True
        key = (op, tenant)
        with self._lock:
            self.total[key] = self.total.get(key, 0) + 1
            if good:
                self.within[key] = self.within.get(key, 0) + 1
        return good
