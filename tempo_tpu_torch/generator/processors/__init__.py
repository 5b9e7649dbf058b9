"""Generator processors: spanmetrics, servicegraphs, localblocks.

Counterpart of `tempo_tpu/generator/processors/__init__.py`, with the same
exports. Processor contract: `push_batch(SpanBatch)` ingests spans, and
the instance enables and disables processors by name per tenant.
"""

from tempo_tpu_torch.generator.processors.spanmetrics import SpanMetricsConfig, SpanMetricsProcessor
from tempo_tpu_torch.generator.processors.servicegraphs import ServiceGraphsConfig, ServiceGraphsProcessor

__all__ = [k for k in dir() if not k.startswith("_")]
