"""The per-tenant limit record.

Counterpart of `tempo_tpu/overrides/limits.py`, host code copied with its imports
moved to the port.

Field-for-field analog of the reference's limit surface
(`modules/overrides/config.go:71-200`), grouped the way its new-style YAML
config groups them (ingestion / read / compaction / metrics-generator /
global). All byte quantities are ints, durations are float seconds.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class IngestionLimits:
    rate_strategy: str = "local"            # local | global (Tempo default local)
    rate_limit_bytes: int = 15_000_000
    burst_size_bytes: int = 20_000_000
    max_traces_per_user: int = 10_000       # live traces per tenant per ingester
    max_attribute_bytes: int = 0            # 0 = unlimited; truncate past this
    tenant_shard_size: int = 0              # shuffle-shard size (0 = whole ring)


@dataclasses.dataclass
class ReadLimits:
    max_bytes_per_tag_values_query: int = 1_000_000
    max_blocks_per_tag_values_query: int = 0
    max_search_duration_s: float = 0.0      # 0 = unlimited
    max_metrics_duration_s: float = 0.0
    max_bytes_per_trace: int = 50_000_000   # enforced at ingest + combine


@dataclasses.dataclass
class CompactionLimits:
    block_retention_s: float = 0.0          # 0 = use compactor default
    compaction_disabled: bool = False


@dataclasses.dataclass
class GeneratorLimits:
    processors: tuple[str, ...] = ()        # enabled processors for the tenant
    max_active_series: int = 65536
    collection_interval_s: float = 15.0
    disable_collection: bool = False
    ingestion_time_range_slack_s: float = 30.0
    remote_write_headers: dict[str, str] = dataclasses.field(default_factory=dict)
    # spanmetrics knobs
    # quantile sketch tier: "" = the process default
    # (generator.spanmetrics.sketch); "dd" | "moments" | "both" override
    # per tenant — a high-cardinality tenant can ride the ~15-float
    # moments rows while others keep the DDSketch plane
    sketch: str = ""
    sketch_moments_k: int = 0               # 0 = process default (moments_k)
    # update-kernel tier: "" = the process default
    # (generator.spanmetrics.kernel); "xla" | "pallas" override per
    # tenant — per-tenant arenas share the pool, so tiers can mix
    kernel: str = ""
    histogram_buckets: tuple[float, ...] = ()
    intrinsic_dimensions: dict[str, bool] = dataclasses.field(default_factory=dict)
    dimensions: tuple[str, ...] = ()
    span_multiplier_key: str = ""
    target_info_enabled: bool = True
    native_histograms: str = "classic"      # classic | native | both
    # service-graphs knobs
    sg_histogram_buckets: tuple[float, ...] = ()
    sg_dimensions: tuple[str, ...] = ()
    sg_peer_attributes: tuple[str, ...] = ()
    sg_wait_s: float = 10.0
    sg_max_items: int = 10_000
    # localblocks knobs
    lb_max_live_traces: int = 0
    lb_max_block_duration_s: float = 60.0
    lb_max_block_bytes: int = 500_000_000
    lb_flush_to_storage: bool = False
    # trace-analytics knobs (0 = the process default from
    # generator.traceanalytics)
    ta_trace_idle_s: float = 0.0
    ta_late_window_s: float = 0.0
    ta_max_live_traces: int = 0
    ta_max_spans_per_trace: int = 0


@dataclasses.dataclass
class SamplingLimits:
    """Per-tenant graceful-overload sampling policy (the `sampling:`
    group): how this tenant's spans behave when the process-wide
    overload controller (`sched.keep_fraction`) is below 1.0. The
    controller decides WHEN to sample and how hard; the policy decides
    how far this tenant may be sampled and what is never dropped."""

    enabled: bool = True          # False: tenant opts out → old hard-429 cliff
    floor: float = 0.25           # effective keep-fraction never drops below
    keep_errors: bool = True      # error-status spans always kept (exact)
    # latency-tail always-keep: spans whose duration sits above this
    # quantile of the tenant's own recent duration distribution are
    # kept at weight 1 (exact tail). 0 disables tail protection.
    tail_quantile: float = 0.99
    # observations the host duration sketch needs before the tail
    # threshold arms (an unwarmed threshold would force-keep everything)
    tail_min_spans: int = 1024


@dataclasses.dataclass
class Limits:
    """Everything a tenant can override. Defaults mirror the reference's
    (`config.go` RegisterFlagsAndApplyDefaults defaults)."""

    ingestion: IngestionLimits = dataclasses.field(default_factory=IngestionLimits)
    read: ReadLimits = dataclasses.field(default_factory=ReadLimits)
    compaction: CompactionLimits = dataclasses.field(default_factory=CompactionLimits)
    generator: GeneratorLimits = dataclasses.field(default_factory=GeneratorLimits)
    sampling: SamplingLimits = dataclasses.field(default_factory=SamplingLimits)

    def merged_with(self, patch: dict) -> "Limits":
        """New Limits with `patch` (nested dict) applied over self."""
        out = dataclasses.replace(self)
        for group, fields in (patch or {}).items():
            if not hasattr(out, group) or not isinstance(fields, dict):
                continue
            sub = dataclasses.replace(getattr(out, group))
            for k, v in fields.items():
                if hasattr(sub, k):
                    if isinstance(v, list):
                        v = tuple(v)
                    setattr(sub, k, v)
            setattr(out, group, sub)
        return out


def limits_from_dict(d: dict) -> Limits:
    return Limits().merged_with(d)
