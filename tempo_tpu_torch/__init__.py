"""tempo_tpu_torch — the PyTorch/CUDA port of tempo_tpu.

The port mirrors the module paths of `tempo_tpu/` so each counterpart is
easy to find, and imports neither JAX nor anything of `tempo_tpu`. Its
entry points run on `cuda` unless the caller passes `device="cpu"`.

The port carries the reference's default generator, span metrics and
service graphs, over dense state (the reference's default: no page pool)
and over paged state, with the DDSketch and moments quantile tiers and,
on paged state, the compact state tier; span-metrics updates ride the
process device scheduler when one is configured (`sched.configure`):

    otlp_proto_to_batch(bytes) → GeneratorInstance.push_batch(SpanBatch)
      → SpanMetricsProcessor → sched.DeviceScheduler.submit_rows (merged
        [4, bucket] windows; the direct route without a scheduler)
      → ops.pages.fused_step
      → ops.cuda_kernels.paged_fused_update (CUDA kernel on the card,
        plain PyTorch version on the host; dense state through identity
        page tables)
      → ServiceGraphsProcessor (host edge matching) → Counter.add_slots /
        Histogram.observe_slots (index_add_ on the device)
    GeneratorInstance.collect_and_push() → sched.flush() → remote write
    SpanMetricsProcessor.quantile(q) / quantiles(qs)

`ops.cuda_kernels.fused_spanmetrics_matmul` is the dense fused delta, a
kernel no path of the system runs.
"""

from tempo_tpu_torch import device  # noqa: F401  (sets the TF32 policy)
from tempo_tpu_torch import sched
from tempo_tpu_torch.generator import GeneratorConfig, GeneratorInstance
from tempo_tpu_torch.generator.processors.servicegraphs import (
    ServiceGraphsConfig, ServiceGraphsProcessor)
from tempo_tpu_torch.generator.processors.spanmetrics import (
    SpanMetricsConfig, SpanMetricsProcessor)
from tempo_tpu_torch.model import SpanBatchBuilder, otlp_proto_to_batch
from tempo_tpu_torch.registry import ManagedRegistry, RegistryOverrides
from tempo_tpu_torch.registry.pages import PagePoolConfig
from tempo_tpu_torch.sched import DeviceScheduler, SchedConfig

__all__ = ["GeneratorConfig", "GeneratorInstance", "SpanMetricsConfig",
           "SpanMetricsProcessor", "SpanBatchBuilder", "otlp_proto_to_batch",
           "ManagedRegistry", "RegistryOverrides", "PagePoolConfig",
           "sched", "SchedConfig", "DeviceScheduler", "ServiceGraphsConfig",
           "ServiceGraphsProcessor"]
