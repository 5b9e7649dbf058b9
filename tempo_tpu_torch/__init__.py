"""tempo_tpu_torch — the PyTorch/CUDA port of tempo_tpu.

The port mirrors the module paths of `tempo_tpu/` so each counterpart is
easy to find, and imports neither JAX nor anything of `tempo_tpu`. Its
entry points run on `cuda` unless the caller passes `device="cpu"`.

The port carries the reference's default generator, span metrics and
service graphs, over dense state (the reference's default: no page pool)
and over paged state, with the DDSketch and moments quantile tiers and,
on paged state, the compact state tier; span-metrics updates ride the
process device scheduler when one is configured (`sched.configure`).
The main path starts where the reference's users enter:

    distributor.Distributor.push_otlp(tenant, OTLP bytes)
      → admission (scheduler backpressure, the tenant's rate limit),
        validation, overload sampling, grouping by trace, ring
        replication to the ingesters (ingester.Ingester: live traces →
        a fsynced WAL segment a trace → a complete Parquet block written
        by the port's own codec, block/parquet.py → flush to the object
        store; find_trace_by_id over all three)
      → the generator tee: one decode-once staging shared by row views
        when every generator is in process with one interner, else scan
        records or payload slices per generator
      → generator.Generator (tenants under their overrides) → the
        tenant's GeneratorInstance, as below

    OTLP bytes → stage_otlp (C++ staging, `native`) → StagedIngest.view()
      → GeneratorInstance.push_staged_view
      → span metrics alone: SpanMetricsProcessor.push_staged (C++ resolve
        in the native row table; the ingest pipeline's buffer ring on the
        scheduler route) → K1 as below
      → any other processor mix: the staged SpanBatch → push_batch
    (also push_otlp_staged(bytes), push_otlp_recs(bytes, otlp_scan records),
    and the Python decoder's otlp_proto_to_batch(bytes) → push_batch)

    GeneratorInstance.push_batch(SpanBatch)
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

The read side over backend blocks (the blocks the ingesters flush):

    db.TempoDB(reader, writer) (the device plane on, `cuda` by default)
      → find_trace_by_id (bloom → row-group index → one row group a block,
        rf copies combined)
      → search(tenant, TraceQL) → db.PlaneCache → block.device_scan
        .BlockScanPlane.mask (the fused first pass on the device) →
        traceql.engine.execute_search (the second pass on the host)
      → query_range(tenant, QueryRangeRequest) → BlockScanPlane
        .metrics_grid (mask, exact int64 step, group scatter into torch
        grids, one packed fetch a block), or the host engine
        traceql.engine_metrics.MetricsEvaluator where the plane refuses
        (counted under the reference's fallback_<cause> names)
        → SeriesCombiner

Users reach the read side through the query frontend, as in the
reference (SURVEY §3.4: frontend sharder → querier → TempoDB → combiner):

    frontend.Frontend(db, querier.Querier(db, ingester ring, ingesters))
      → search / find_trace / query_range / tag_names / tag_values
      → time windows at the backend cutoff: the ingesters' recent data
        (Ingester.search over traceql.memview views) and backend block
        jobs of ~target bytes (frontend.sharders), run inline or by the
        worker pool (start_workers), cached per job (backend.cache),
        combined (MetadataCombiner, SeriesCombiner); metrics read RF1
        blocks only, and blocks behind the cutoff with a sketch sidecar
        fold on the request thread (block.sidecar)

The recent window and the history of a metrics query at the frontend's
defaults (RF1 blocks only, sketch sidecars folded) come from the
ingest-storage path, as in the reference:

    distributor.Distributor(..., bus=ingest.Bus(n)).push_otlp → records
      → generator.Generator.consume_bus → the tenant's GeneratorInstance
        with processors ("span-metrics", "local-blocks"): the SpanBatch
        route (push_batch) → span metrics (K1) and
        generator.processors.localblocks.LocalBlocksProcessor (live
        traces → WAL → complete RF1 blocks on `tick`) → Generator.
        query_range, the frontend's generator_query_range
      → blockbuilder.BlockBuilder.consume_cycle → an RF1 block a tenant
        a cycle, with a sketch sidecar built on the device
        (ops.compact.build_sidecar_arrays: moments_update and the
        HyperLogLog hll_update) → the frontend's sidecar fold

The read side's device code is plain torch ops (no hand kernel): the
reference's is jitted jnp, not Pallas. That includes the opt-in
per-row-group offload of `condition_mask` (`TEMPO_TPU_DEVICE_SCAN=1`)
and the sidecar's sketch pass. The object-store plane has the
reference's cloud backends (`backend.open_backend`: mem, local, s3, gcs,
azure), hedged reads (`utils.hedging`) and the shared memcached/redis
cache tier (`backend.memcached`), all host code.

A deployment starts at `python -m tempo_tpu_torch` (`__main__.py`): the
App (`app.App`, on the card) wires every module above at its default
target `all`, serves the reference's HTTP API (`app.api`) and runs the
loops, the cold tier's among them: `TempoDB.enable_compaction` merges
blocks with the merge order computed on the device
(`ops.compact.merge_order`, torch ops) and writes sketch sidecars beside
the outputs (`db.compactor`, `compactor.Compactor`).

`ops.cuda_kernels.fused_spanmetrics_matmul` is the dense fused delta, a
kernel no path of the system runs.
"""

__version__ = "0.1.0"

from tempo_tpu_torch import device  # noqa: F401  (sets the TF32 policy)
from tempo_tpu_torch import native, sched
from tempo_tpu_torch.generator import GeneratorConfig, GeneratorInstance
from tempo_tpu_torch.generator.processors.servicegraphs import (
    ServiceGraphsConfig, ServiceGraphsProcessor)
from tempo_tpu_torch.generator.processors.spanmetrics import (
    SpanMetricsConfig, SpanMetricsProcessor)
from tempo_tpu_torch.model import SpanBatchBuilder, otlp_proto_to_batch
from tempo_tpu_torch.model.otlp_batch import (StagedIngest, batch_from_otlp,
                                              stage_otlp)
from tempo_tpu_torch.registry import ManagedRegistry, RegistryOverrides
from tempo_tpu_torch.registry.pages import PagePoolConfig
from tempo_tpu_torch.sched import DeviceScheduler, SchedConfig

__all__ = ["GeneratorConfig", "GeneratorInstance", "SpanMetricsConfig",
           "SpanMetricsProcessor", "SpanBatchBuilder", "otlp_proto_to_batch",
           "ManagedRegistry", "RegistryOverrides", "PagePoolConfig",
           "sched", "SchedConfig", "DeviceScheduler", "ServiceGraphsConfig",
           "ServiceGraphsProcessor", "native", "stage_otlp",
           "batch_from_otlp", "StagedIngest"]
