"""tempo_tpu_torch — the PyTorch/CUDA port of tempo_tpu.

The port mirrors the module paths of `tempo_tpu/` so each counterpart is
easy to find, and imports neither JAX nor anything of `tempo_tpu`. Its
entry points run on `cuda` unless the caller passes `device="cpu"`.

The port carries the span-metrics write path over dense state (the
reference's default: no page pool) and over paged state, with the
DDSketch and moments quantile tiers and, on paged state, the compact
state tier:

    otlp_proto_to_batch(bytes) → GeneratorInstance.push_batch(SpanBatch)
      → SpanMetricsProcessor → ops.pages.fused_step
      → ops.cuda_kernels.paged_fused_update (CUDA kernel on the card,
        plain PyTorch version on the host; dense state through identity
        page tables)
    GeneratorInstance.collect_and_push() → remote write
    SpanMetricsProcessor.quantile(q) / quantiles(qs)

`ops.cuda_kernels.fused_spanmetrics_matmul` is the dense fused delta, a
kernel no path of the system runs.
"""

from tempo_tpu_torch import device  # noqa: F401  (sets the TF32 policy)
from tempo_tpu_torch.generator import GeneratorConfig, GeneratorInstance
from tempo_tpu_torch.generator.processors.spanmetrics import (
    SpanMetricsConfig, SpanMetricsProcessor)
from tempo_tpu_torch.model import SpanBatchBuilder, otlp_proto_to_batch
from tempo_tpu_torch.registry import ManagedRegistry, RegistryOverrides
from tempo_tpu_torch.registry.pages import PagePoolConfig

__all__ = ["GeneratorConfig", "GeneratorInstance", "SpanMetricsConfig",
           "SpanMetricsProcessor", "SpanBatchBuilder", "otlp_proto_to_batch",
           "ManagedRegistry", "RegistryOverrides", "PagePoolConfig"]
