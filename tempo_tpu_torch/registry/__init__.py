"""Metrics registry: series tables, dense or paged device state,
collection."""

from tempo_tpu_torch.registry.registry import (DEFAULT_HISTOGRAM_EDGES,
                                               Counter, Gauge, Histogram,
                                               ManagedRegistry,
                                               RegistryOverrides)
from tempo_tpu_torch.registry.series import Exemplar, Sample

__all__ = ["DEFAULT_HISTOGRAM_EDGES", "Counter", "Gauge", "Histogram",
           "ManagedRegistry", "RegistryOverrides", "Exemplar", "Sample"]
