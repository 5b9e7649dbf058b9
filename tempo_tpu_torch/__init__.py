"""tempo_tpu_torch — the PyTorch/CUDA port of tempo_tpu.

The port mirrors the module paths of `tempo_tpu/` so each counterpart is
easy to find, and imports neither JAX nor anything of `tempo_tpu`. Its
entry points run on `cuda` unless the caller passes `device="cpu"`.

The port carries the span-metrics write path over paged state, with the
DDSketch and moments quantile tiers and the compact state tier:

    otlp_proto_to_batch(bytes) → GeneratorInstance.push_batch(SpanBatch)
      → SpanMetricsProcessor → ops.pages.fused_step
      → ops.cuda_kernels.paged_fused_update (CUDA kernel on the card,
        plain PyTorch version on the host)
    GeneratorInstance.collect_and_push() → remote write
    SpanMetricsProcessor.quantile(q) / quantiles(qs)

`ops.cuda_kernels.fused_spanmetrics_matmul` is the dense fused delta, a
kernel no path of the system runs yet.
"""

from tempo_tpu_torch import device  # noqa: F401  (sets the TF32 policy)
from tempo_tpu_torch.generator import GeneratorConfig, GeneratorInstance
from tempo_tpu_torch.generator.processors.spanmetrics import SpanMetricsConfig
from tempo_tpu_torch.model import SpanBatchBuilder, otlp_proto_to_batch
from tempo_tpu_torch.registry import RegistryOverrides
from tempo_tpu_torch.registry.pages import PagePoolConfig

__all__ = ["GeneratorConfig", "GeneratorInstance", "SpanMetricsConfig",
           "SpanBatchBuilder", "otlp_proto_to_batch", "RegistryOverrides",
           "PagePoolConfig"]
