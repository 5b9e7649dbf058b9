"""tempo_tpu_torch.obs — the process self-telemetry of the port.

- `registry`: Counter/Gauge/Histogram families, callback collectors,
  HELP/TYPE text exposition, conformance parser (byte-compatible with
  the reference's `tempo_tpu/obs/registry.py`).
- `runtime`: the process-wide `RUNTIME` registry (device transfers,
  kernel times, K1 launch plans and kernel launches).
- `devtime`: the device-time ledger and the online dispatch cost model
  the scheduler records into.
- `querystats`: contextvar-scoped per-request statistics.
"""

from tempo_tpu_torch.obs.registry import (
    DEFAULT_DURATION_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    escape_label,
    exponential_buckets,
    parse_exposition,
)
from tempo_tpu_torch.obs.querystats import QueryStats

__all__ = ["Registry", "Counter", "Gauge", "Histogram", "escape_label",
           "exponential_buckets", "parse_exposition",
           "DEFAULT_DURATION_BUCKETS", "QueryStats"]
