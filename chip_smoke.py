#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`tempo_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, all on `cuda`, at the repository's default deployment widths
(max_active_series 65,536, DDSketch 1,269 buckets and a 12-moment row
over 16,384 series, 15 latency buckets; paged state in a page pool of
256-row pages and 131,072 usable rows per role arena, dense state in
64-row pages, one trash page per arena):

1. the card's name and power limit (nvidia-smi);
2. build of every kernel source in `tempo_tpu_torch/csrc`, one `nvcc`
   per source, all started together;
3. each kernel against its plain PyTorch version on the card:
   a. K1 (`paged_fused_update`) with f32 `sketch: dd` state, 7 roles,
      8 dispatches of 16,384 spans; then K1 on durations placed on the
      DDSketch bucket edges, against the host;
   b. K1 with `sketch: both` and compact state, 8 roles (int32 counts,
      a bf16 Kahan pair, f32 sizes and moments), from non-zero state:
      3 dispatches of 16,384 Zipf-skewed spans with dyadic durations and
      weights, one of no spans, and one after a logical page of two
      roles moved to a reused physical page; the persistent scratch all
      zero after each;
   c. K2 (`fused_spanmetrics_matmul`) at two shapes, each driven over 8
      batches with its launches held against `k2_layout`, then a batch
      of no spans and one of only discards (each all zero): the
      reference benchmark's (262,144 uniform spans, 4,096 series, 12
      edges) and the deployment's (one push of 16,384 Zipf-skewed spans
      into 65,536 series, the 14 default edges);
   d. K1 on dense state, `sketch: both` f32 (8 roles), over identity
      page tables through the main path's call (`ops.pages.fused_step`),
      from non-zero state: 3 Zipf-skewed pushes of 16,384 spans (slots
      below and past the 16,384 sketch rows, 5% discards) and one of no
      spans; launches one per push with spans; trash pages and a guard
      page past each arena's rows left zero;
4. the span-metrics main paths on the direct route through the entry
   points, each on the card against the same path on the host (plain
   versions), with kernel launch counts zeroed just before and read just
   after: 3 seeded OTLP payloads of 16,384 spans → `otlp_proto_to_batch` →
   `GeneratorInstance.push_batch` → `registry.collect()` (every family's
   rows compared with the host's by label set) → quantiles;
   a. `sketch: dd` with f32 state (quantiles exactly equal);
   b. `sketch: both` with compact state (DDSketch quantiles exactly
      equal, every series' moments row within the moments tolerance of
      phase 3b, moments quantiles compared and the series outside rtol
      1e-3 counted);
   c. `sketch: dd` with f32 state and no page pool: dense state, K1 over
      identity page tables (quantiles exactly equal);
   K1's launch plans built on each card path (one: the processor's
   tables, arenas and scratch are the same tensors at every push); then
   device state bytes per active series of the dd-f32, both-compact,
   moments and dense dd-f32 tiers, and the compact tier's scratch bytes
   (working memory, not state);
5. times: per-dispatch kernel and plain times (CUDA events, min /
   median / max of 30); K1 timed two ways side by side, through the call
   the main path makes (`ops.pages.fused_step` on the packed [4, N]
   batch) and through the wrapper with the batch sliced on each call
   (the yardstick of K1's earlier times in PERF.md); K1's host time per call (1,000 calls with no
   synchronisation) both ways, and K2's at both shapes; device time
   (torch.profiler: K1 by kernel, K2 every device event of the call);
   the least time the card could take, the library yardstick where one
   exists (`index_add_` for K2, at both shapes), and end-to-end spans/s;
   on dense state K1 (`sketch: dd`, 7 roles) and the composed twin of
   the reference's dense step (`_fused_update_impl`) on the same push,
   each with its device time (every device event) and its time with the
   host;
6. the reference's default deployment, on dense state and then on paged
   state (one page pool of the default config): the process device
   scheduler at its default config (`sched.configure(SchedConfig())`,
   worker thread, 2 ms windows) and 8 tenants of the default generator
   (span metrics and service graphs, 65,536 series, DDSketch over 16,384),
   each sent 4 pushes of 1,024 seeded trace-tree spans (client/server
   pairs, 1/16 db clients with no server side; 32 services x 32
   operations) by 2 producer threads, then the clock stepped past the
   service graphs' wait and one empty push each; the same pushes through
   direct-route twins (`use_scheduler=False`). Checks: every family's
   rows and the DDSketch rows equal between the routes (counts exact,
   sums within rtol 1e-5), more pushes than merged dispatches, K1
   launches equal to dispatches, one launch plan per processor, nothing
   shed, no dispatch or job error, and a tenant on a 60 s window whose
   pushes `collect_and_push` flushes. Printed: spans/s on both routes,
   occupancy and pushes per dispatch, the devtime ledger's host wall per
   dispatch, K1 at a merged window's shape against its plain version with
   its device time (torch.profiler), and the service-graphs emit's host
   and device time;
7. the staged main path, the reference's default ingest: OTLP wire bytes
   staged by the C++ host layer (`tempo_tpu_torch.native`, built with
   g++ at import) into interned columns, at the widths above, on the
   card against a CPU twin taking the same path on the plain versions:
   a. the span-metrics fast route, on dense and on paged state, on the
      direct route and under the default `SchedConfig` (pipeline depth
      2): 2 seeded payloads of 16,384 spans, pushed twice (every series
      new, then every series known) → `stage_otlp` →
      `StagedIngest` (its `sample_weight` integer weights 1-3) → `view()`
      → `push_staged_view` → `push_staged` → C++ resolve → K1. Checks:
      every family's rows equal the twin's (counts and buckets exact,
      sums within rtol 1e-5), DDSketch rows and q50/q99 exact, K1
      launched once a push on the direct route and once a merged window
      under the scheduler, one launch plan a processor, the pipeline's
      staging buffers reused; K1 held against its plain version and timed
      at the direct route's last push;
   b. the recs route: `push_otlp_recs` with `native.otlp_scan` records,
      whole and a sharded third, against the payload route
      (`push_otlp_staged` of the payload, and of `slice_otlp_payload` of
      the same third) on every plane (dense state, direct route);
   c. the default instance (span metrics and service graphs) under the
      default scheduler, on phase 6's trace-tree traffic as OTLP:
      `push_staged_view` → `batch_slice` → `push_batch`, against the same
      payloads through `otlp_proto_to_batch` + `push_batch`, every
      collected sample compared by label set (counts exact, sums within
      rtol 1e-5);
   printed: staging seconds a payload, resolve seconds a push, spans/s
   from wire bytes on each route beside phase 4's Python-decode spans/s,
   the pipeline's overlap ratio and stall seconds, K1's device time a
   staged push;
8. the distributor main path, where the reference's users enter:
   `Distributor.push_otlp` with OTLP wire bytes → admission, validation,
   grouping by trace, ring replication to 3 real `Ingester`s (each with
   its own data directory, at the default rf=3; the tenants' live-trace
   limit raised above the traces sent) → the generator tee → the multi-tenant
   `Generator` → the scheduler (default `SchedConfig`) → K1 → state, at
   the widths above on dense state (the reference's default), for 4
   tenants: 2 span-metrics-only tenants sent phase 7a's 2 payloads of
   16,384 spans twice (every series new, then known) and 2 of the default
   processors sent phase 6's trace-tree payloads of one tenant each; each
   run against a CPU twin (the same `Distributor` config feeding
   `Generator(device="cpu")`):
   a. the decode-once staged tee into one generator on the card: errs
      empty, every trace live on all 3 ingesters (the staging now carries
      span attributes, which real ingesters keep), `find_trace_by_id` on
      each ingester for 256 seeded trace ids equal to the host decode of
      the payloads (`spans_from_otlp_proto_native`, combined and sorted),
      no ingester discard, the distributor's
      spans-received family equal to the spans sent, every family of
      every tenant equal to the twin's by label strings (counts and
      buckets exact, sums within rtol 1e-5), DDSketch q50/q99 exact, K1
      launches equal to merged dispatches, one launch plan a processor;
      K1 at a captured merged window against its plain version;
   b. the columnar tee into two generators on the card (two interners, so
      no shared staging; the ingesters take payload slices through
      `Ingester.push_otlp`, with 8a's ingester checks), the span-metrics
      tenants sent their payloads once (every series new): they take
      `push_otlp_recs`, the default ones payload slices; every span
      reaches exactly one generator, each generator's spans equal its
      twin's, and every family summed over the two generators by label
      set equals 8a's (after 8a's first pass for the span-metrics
      tenants);
   c. overload: one span-metrics tenant with sampling floor 0.25 and tail
      protection off under a keep fraction of 0.5: spans discarded as
      `sampled`, hash-kept weights exactly 2.0 (error spans 1.0), the
      HT-weighted calls within 5% of the spans sent, the state equal to
      the twin's; then an injected backpressure of 2 s: `RateLimited`
      with reason `sched_backpressure` and `retry_after_s` 2.0, and the
      tenant's interner unchanged;
   the CPU twins' ingesters are stubs that keep nothing (they check the
   generators); printed: spans/s through `Distributor.push_otlp` (series
   new and known) on 8a and 8b beside phase 7a's on the same payloads,
   the distributor's host ms a push (its `push_duration` histogram) with
   the ingester leg's share, K1's device time a push;
9. the ingester's own cycle at the reference's default `IngesterConfig`
   and `InstanceConfig`: one tenant through one `Distributor` into 3 real
   ingesters (rf=3, no generator tee), one payload of 16,384 spans of
   seeded trace trees of 32 spans (512 traces; span and resource
   attributes of every type, events and links), then
   `sweep_all(immediate=True)` (cut: one fsynced WAL segment a trace,
   then seal) and `flush_tick()` (complete: the WAL read back, combined
   and written as a gzip Parquet block of one row group; flush: the
   block's files copied to a `LocalBackend` playing the object store).
   Checks: `find_trace_by_id` for 256 seeded ids at each stage (live, WAL,
   complete local block, the flushed copy through `BackendBlock`) equal
   to the host decode; every span of a flushed block read back through
   the port's reader equal to what was sent, by trace; an ingester
   abandoned with one head WAL block (the second half of the traces
   sent) and one complete unflushed block (the first half), then a
   fresh `Ingester` over its data
   directory: `replay()` and
   `flush_tick()` find the same traces and flush each block once; 10,001
   one-span traces to a fresh tenant at the default limits: each
   ingester holds 10,000 live and counts one `live_traces_exceeded`
   discard, which the distributor counts once. Printed: push spans/s and
   `push_duration`, cut seconds and WAL segments/s with fsync ms, complete
   seconds and spans/s of block writing, block bytes a span (gzip, and
   uncompressed on the same input), flush seconds, `find_trace_by_id` ms
   at each stage, replay seconds;
10. the read side over backend blocks (`TempoDB` at the reference's
   default `TempoDBConfig`: the device plane on, a 1 GiB plane budget,
   64 blocks, 30 pool workers, 50,000-row groups):
   a. push to query: a `TempoDB` on the card polls phase 9's flushed
      object store (the 3 ingesters' blocks of the same traces and the
      replayed ingester's two) and answers `find_trace_by_id` for phase
      9's 256 seeded ids (each equal to the host decode, rf copies
      combined), two searches on span and resource attributes, and
      `rate() by (resource.service.name)` and `quantile_over_time(
      duration, .5, .99)` by service over a 900 s window; every result
      equal to a CPU twin and to a host-engine twin (`device_plane=
      False`), every metrics block fused with no fallback;
   b. the reference's query benchmark (`bench.py` `bench_query`) at its
      size: `TempoDB.write_block` of 100,000 one-span traces (its
      generator and seed) into a `LocalBackend` under `build/`; rate by
      service, quantile_over_time(duration, .99) by service and the
      search `{ span.http.status_code >= 400 }` (limit 20), the plane on
      and off, each equal on and off, the plane-on ones timed after one
      warm-up; the
      quantile under the moments tier (fused; its moment rows equal to
      the host engine's within ROADMAP section 3's row tolerance; each
      cell's q99 equal to the host engine's at the reference's rtol 5e-2
      and, as to the same fused query run again, beyond rtol 1e-3 in no
      more cells than ROADMAP section 3's 40 of 16,384; within the
      reference's tier bound of the exact quantile; within one log2
      bucket of the log2 tier's host answer); then `_bench_scan_plane`'s
      shape: the block's views repeated to >= 1,000,000 resident spans,
      `{ name =~ "op-1." && duration > 20ms }` as a device mask equal to
      `condition_mask` on every row, and `metrics_grid` rate by service
      equal to the host engine row by row. Printed: ms a query with the
      plane on, adoption seconds and bytes, mask ms and spans/s against numpy,
      grid ms, device time and device ops of a grid and of a mask
      dispatch (torch.profiler), H2D bytes a warm query, the plane
      cache's device bytes against its budget, and the card's idle share
      across a warm query_range, the plane on and off. The profiler readings come from a second
      process (`chip_smoke.py --phase10-profiles`, the bench block again
      in memory), which the smoke starts and waits for: in the smoke's
      own process, after the earlier phases' profiler sessions, the
      trace lost most device events;
11. the query frontend and the querier (`Frontend` at the reference's
   default `FrontendConfig` over a `Querier` at its default
   `QuerierConfig`, rf 3, and a `TempoDB` on the card):
   a. run in phase 9's `then=` after 10a: phase 9's flushed blocks
      behind the backend cutoff and one fresh ingester holding an uncut
      16,384-span payload of the same traffic in the recent window;
      256 finds of phase 9's ids and 64 of the payload's, 2 searches
      (limit 20, and every match), `tag_names` and `tag_values` of
      `resource.service.name`, inline and through `start_workers(2)`,
      each equal to a CPU twin of the stack (inline); every match of a
      search equal to `TempoDB.search` over the backend window with
      `Ingester.search` over the recent one, every find to phase 9's
      host decode and `TempoDB.find_trace_by_id` (or
      `Ingester.find_trace_by_id`);
   b. run in 10b's process over its RF1 block, the cutoff 300 s into
      the block: rate and quantile_over_time(duration, .99) by service,
      each equal to `TempoDB.query_range` clipped at the cutoff after
      `SeriesCombiner.final` and to a CPU twin, one fused job each with
      no fallback, no sidecar fold or fallback (no block has a
      sidecar); under the real clock with a `CacheProvider` the second
      query hits the job cache with the same series. Printed: a warm
      frontend rate query's ms against `TempoDB`'s, the queue wait and
      stages of the merged `QueryStats` through the worker pool, and
      (in 10b's profiling process) its device time, ops and idle share;
   c. `TEMPO_TPU_DEVICE_SCAN=1` with the plane off over 10b's block:
      the search `{ span.http.status_code >= 400 }` (which the offload
      refuses, as the reference's does) and the mask `{ name =~ "op-1."
      && duration > 20ms }` as a search, each equal with the offload and
      without, every row group's mask on the card bit-equal to the CPU
      path's; printed: launches a search, the mask's device time and
      ops (the profiling process) and its bound by bytes;
12. the ingest-storage path at the frontend's defaults: one span-metrics
   + local-blocks tenant behind a `Distributor` onto a 4-partition bus,
   drained by `Generator.consume_bus` and a `BlockBuilder` (sidecars on
   the card), one push of 16,384 spans a leg (history, then the clock
   +20 min, recent), against a CPU twin fed the same records; rate and
   quantiles by service through the frontend over both legs;
13. the materialized grids and trace analytics:
   a. the process materializer at `MatViewConfig()` on the card and a
      `Frontend` at `FrontendConfig()` over the generator leg; a
      span-metrics + local-blocks tenant fed 3 pushes of 16,384
      `deep_trace_spans` spans (the clock +15 s a push, 10 s steps) with
      explicit grids (rate and quantile by service, histogram), one
      subscribed after 2 pushes (built from the live traces), one
      auto-subscribed after 32 frontend misses; then the quantile on the
      moments tier (a fresh materializer, built at a fourth push); and a
      span-metrics-only tenant with a grid. Checks: the served reads
      equal the recompute (the materializer reset) bit for bit, the
      moments read within 0.02; every grid equal to a CPU twin's fed the
      same payloads; no staged fast push; K1 launches equal to merged
      dispatches. Printed: a warm hit read against the recompute, the
      grids' device bytes, an append's device time and ops (in a process
      of its own) against its bound;
   b. a span-metrics + trace-analytics tenant at `TraceAnalyticsConfig()`
      on the default scheduler, 2 pushes of 16,384 spans (a third
      errored), one cut of 32,768 spans in 1,024 traces, against a CPU
      twin: root-cause counters exact, critical-path seconds within rtol
      1e-5, share rows under the moments rule, cycle, late and orphan
      counters equal; `structure.analyze` on the card equal to the
      pure-Python oracle at 4,096 spans (an orphan subtree, a cycle and a
      duplicate id included) and to its CPU run at 262,144 spans in 8,192
      traces. Printed: spans/s through `cut_tick`, the analysis's ms with
      the host, its device time and ops (the profiling process) and its
      bound by bytes.

14. the App on the card, `python -m tempo_tpu_torch`'s object: `App(Config())`
   at target `all` (the `local` backend and its data under `build/`, a
   free loopback port, `start_loops()`, `serve(app, block=False)`, a
   pinned clock, the compaction loop's interval raised to an hour so it
   does not race the phase's own sweep), its tenant given span metrics
   and local blocks:
   a. 3 pushes of 16,384 `deep_trace_spans` spans (32-span traces) as
      OTLP protobuf through `POST /v1/traces` (the default limits hold),
      then 64 finds, a search, the tags and a tag's values, a rate and
      a `quantile_over_time` by service, the span-metrics summary and
      `/metrics` over HTTP, every answer equal to a CPU twin's
      (`App(device="cpu")`, the same payloads and clock; /metrics by
      family names) and the finds and rate to the payloads; K1 launches
      equal to merged dispatches; K1 at a captured window against its
      plain version;
   b. the cold tier of the same App: the ingester's traces cut,
      completed and flushed into a block, a find and the two queries
      through `TempoDB` directly, the first payload pushed again and
      flushed (duplicate (trace, span) pairs across blocks), one
      `db.compact_tenant_once` on the device route: the merge's order
      equal to `reference_merge_order` and to its CPU run row for row,
      every output block at level 1 with a sidecar, the finds and
      queries over it equal to those over the first block; the merge's
      device time and ops from a process of its own (phase 12's);
   c. `python3 -m tempo_tpu_torch -config.file ... -server.http-listen-port
      <free>`, started with the phase: `/ready`, one push, one find
      equal to the payload, then SIGINT and its exit within 15 s.

15. durability and fleet, on the card against CPU twins:
   a. `App(Config())` at target `all` with `wal.enabled` (fsync batch)
      and the default processors on dense state: 3 pushes of 16,384
      `deep_trace_spans` spans over HTTP, then the App abandoned with no
      shutdown; a second App over the same directories replays the WAL
      at its boot through the scheduler and K1 (launches equal to the
      replayed dispatches); its state equal to the live App's and to a
      CPU twin App's (counts, buckets, DDSketch rows and q50/q99 exact,
      sums at rtol 1e-5); the WAL append's and its fsync's ms a push,
      bytes a record, replay spans/s;
   b. `snapshot_instance` of that tenant, of a paged `sketch: both` f32
      tenant and of a compact one, each restored into a fresh instance
      (bit for bit; compact: counts exact, sums within 1e-2), the dense
      blob into an instance that took a push of other traces (its span
      metrics equal to the oracle that took every push), the paged blob
      into a dense instance (bit for bit); ms with the host, blob bytes,
      device-to-host copies;
   c. two `FleetController`s on one `KVStore` and a `local` backend hand
      a tenant off with zero loss; `python3 -m tempo_tpu_torch.fleet.
      worker` with the WAL takes 2 pushes, is SIGKILLed, restarted over
      the same directories, and answers the oracle's samples and q99;
   d. a native histogram on dense and paged state, card against host,
      and `send_native_histograms`' payload, card against host.

16. the rest of the App's surface, on the card against a CPU twin:
   a. `App(Config())` at target `all` with `server.grpc_listen_port` and
      the default processors on dense state: 3 pushes of 16,384 k6-like
      spans over OTLP/gRPC `Export`, the first again over `POST
      /v1/traces`, its spans over Jaeger `PostSpans` (gRPC), over `POST
      /api/traces` (Jaeger Thrift, one batch a service) and over one
      OpenCensus stream of 4 messages; K1 launches equal to the merged
      dispatches on each route; every family equal to a CPU twin App's
      that took the same bytes over the same routes (counts and buckets
      exact, sums at rtol 1e-5, DDSketch q50/q99 equal); K1 at the last
      window of the Export and the PostSpans routes against its plain
      version, with its bound;
   b. `FindTraceByID`, the streaming search, the streaming metrics
      `query_range` and the streaming tags over gRPC, each equal to the
      HTTP API's answer from the same App;
   c. a query-frontend App and a querier App joined by
      `querier_worker.frontend_address: grpc://...` over the same store:
      a backend `query_range` through the remote worker equal to the
      single binary's; one `vulture` cycle against the card's App;
   d. an App with `selftrace.enabled`: its own spans through loopback
      into the reserved tenant, whose span metrics run K1 (launches
      equal to dispatches), found by that tenant's search, and
      `tempo_selftrace_*` nonzero.
17. Kafka ingest and the Jaeger agent, on the card against CPU twins,
   over the repository's mock broker (`tests/mock_kafka.py`, loaded by
   its path; it checks every batch's CRC32C):
   a. 3 OTLP payloads of 16,384 k6-like spans produced to a topic and
      consumed by `KafkaReceiver` into `App(Config())` at target `all`
      (default processors, dense state);
   b. the ingest-storage path over a 4-partition `KafkaBus`: a
      `Distributor` produces two of those payloads, a `Generator` and a
      `BlockBuilder` consume in consumer-group mode, a second generator
      joins between them and the group rebalances; every record is
      consumed once (the members' state
      summed equals a CPU twin's over an in-memory bus, the blocks hold
      every trace);
   c. 64 Jaeger agent datagrams of 64 spans over loopback UDP into the
      same App;
   K1 launches equal to merged dispatches on each route, every family
   equal to the twin's; K1 at each route's last window;
   d. `App(Config())` at target `all` with `ingest.kafka_bootstrap`,
      `distributor.jaeger_agent_port` and `mesh.enabled` together: one
      payload through the distributor, the bus and the App's group-mode
      consume loop into K1 on the mesh.
18. the serving mesh at the default widths (`sketch: both`), 3 pushes of
   16,384 k6-like spans under the default scheduler, on logical shards
   (`ServingMesh(cfg, devices=[cuda:0] * 4)`): a. 4 series shards on
   dense state; b. 2 data x 2 series shards; c. a page pool split over 4
   series shards; each with K1 launches equal to shards x dispatches,
   `collect()` equal to the unsharded card's (counts, buckets, DDSketch
   rows and quantiles exact; sums within 1e-6, 1e-5 on the data axis)
   and to a CPU twin's, and one shard's K1 on the last window; d. a rate
   and a quantile `query_range` through `TempoDB(plane_mesh=...)` with
   the in-mesh combine, equal to the same queries with the mesh off.
   Then one process of its own takes every captured K1 window's device
   time (`--final-profiles`: the windows are saved under `build/`; read
   in the smoke's own process after other profiles, the trace lost
   events) and phase 15's device readings (the snapshot's gather, the
   restore's scatters, `sketch_restore`, the native update, each with
   its ops and bound). Their numbers are printed in place: the output
   is held until the end.

`python3 chip_smoke.py --phase14` builds as above and runs phase 14
alone (about 100 s); `--phase15` runs phase 15 alone, then its final
profiles; `--phase16`, `--phase17` and `--phase18` run that phase
alone, then K1's device time on its windows.

Before phase 1 a line reports whether `pyarrow`, `zstandard` and `yaml`
can be imported on the machine; nothing branches on it (the port reads
and writes Parquet with its own codec and loads PyYAML only for a
runtime-config file).

The last line is `{"ok": true, "device": {...}}`; any failed check
raises and the script exits non-zero without it. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
N_SPANS = 16384
N_DISPATCH = 8
N_MAIN_PUSHES = 3                # each main path of phase 4 and of 7b
                                 # (4 before phase 13, cut to make room)
N_7A_PUSHES = 2                  # phase 7a (phase 8 drives the same traffic)
N_DIST_PUSHES = 2                # phase 8's span-metrics tenants, a pass
N_TIMED = 30
SEED = 20261016
PAGE_ROWS, PAGE_SHIFT = 256, 8
N_SERIES, DD_ROWS = 65536, 16384
ARENA_SLOTS = 131072             # usable rows per role arena
MOM_K = 12
K2_SPANS, K2_SERIES = 262144, 4096
# moments quantiles, card against host, outside rtol 1e-3 (of 16,384
# series): 876-917 at q50 and 11-15 at q99 in the smoke's runs on an H100
# (PERF.md); a run above these limits has drifted further
MOM_OUTSIDE_MAX = {0.5: 1200, 0.99: 40}
K2_EDGES = (0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.128, 0.256, 0.512,
            1.024, 2.048, 4.096)   # benchmarks/bench_kernels.py:22-23


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def zipf_slots(rng, n, n_series, discard=0.05, a=1.1):
    """Zipf-skewed slots over `n_series` (random rank → slot map), with a
    `discard` share of -1."""
    p = 1.0 / np.arange(1, n_series + 1) ** a
    ranks = rng.choice(n_series, size=n, p=p / p.sum())
    slots = rng.permutation(n_series)[ranks].astype(np.float32)
    slots[rng.random(n) < discard] = -1.0
    return slots


def _dd_meta():
    from tempo_tpu_torch.ops.sketches import dd_params
    gamma, nb = dd_params(0.01, 1e-6, 1e5)
    return gamma, 1e-6, nb


def _mom_meta():
    from tempo_tpu_torch.ops.moments import moments_params
    return moments_params(MOM_K, 1e-6, 1e5)


def touched_cells(mat, tables, *, dd_rows, nb, edges, mom_rows=0,
                  page_shift=PAGE_SHIFT):
    """{role: distinct arena cells on backed pages that the batch adds
    to}; a touched moments row counts its k+3 cells."""
    import torch

    from tempo_tpu_torch.ops.pages import dd_index, hist_bucket

    gamma, minv, _ = _dd_meta()
    slots = mat[0].astype(np.int64)
    dur = torch.from_numpy(mat[1].copy())
    hb = hist_bucket(dur, edges).numpy()
    ddi = dd_index(dur, gamma, minv, nb).numpy() if dd_rows else None
    zero = mat[1] <= np.float32(minv)
    lp = slots >> page_shift
    ok = (slots >= 0) & (lp < tables.shape[1])
    n_roles = tables.shape[0]
    out = {}
    for r in range(n_roles):
        phys = np.where(ok, tables[r][np.clip(lp, 0, tables.shape[1] - 1)], -1)
        keep = phys > 0
        is_mom = mom_rows and r == n_roles - 1
        if is_mom:
            keep &= slots < mom_rows
        elif r >= 5:
            keep &= slots < dd_rows
            keep &= zero if r == 5 else ~zero
        rows = (phys.astype(np.int64) << page_shift) | \
            (slots & ((1 << page_shift) - 1))
        rows = rows[keep]
        if r == 4:
            rows = rows * (len(edges) + 1) + hb[keep]
        elif r == 6 and not is_mom:
            rows = rows * nb + ddi[keep]
        out[r] = np.unique(rows).size * ((MOM_K + 3) if is_mom else 1)
    return out


def bound_bytes(mat, tables, *, dd_rows, nb, edges, mom_rows=0, compact=False,
                page_shift=PAGE_SHIFT):
    """Bytes K1 must move for this batch: the batch and the tables read
    once; every distinct touched arena cell read and written once (4 B
    each; a touched moments row is its k+3 cells); under compact, every
    row of every backed page of the latency-sum pair read and written
    (4 B), since the fold re-normalises each of them."""
    cells = touched_cells(mat, tables, dd_rows=dd_rows, nb=nb, edges=edges,
                          mom_rows=mom_rows, page_shift=page_shift)
    nbytes = mat.nbytes + tables.nbytes + 2 * 4 * sum(
        k for r, k in cells.items() if not (compact and r == 1))
    if compact:
        nbytes += 2 * 4 * int((tables[1] > 0).sum()) << page_shift
    return nbytes


def bound(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def cuda_time_ms(fn, runs):
    """(min, median, max) per-call time from CUDA events, after three
    warm-up calls, with Python's garbage collector paused."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    gc.disable()
    try:
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    finally:
        gc.enable()
    return min(times), statistics.median(times), max(times)


def host_ms(fn, runs=1000):
    """Host time per call over `runs` calls with no synchronisation
    between them: what the wrapper costs the calling thread."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    out = (time.perf_counter() - t0) / runs * 1e3
    torch.cuda.synchronize()
    return out


def host_floor_ms():
    """`host_ms` of one PyTorch op on the card (an add_ on one element):
    the yardstick for a wrapper's host time, taken beside it."""
    import torch

    one = torch.zeros(1, device="cuda")
    return host_ms(lambda: one.add_(1.0))


def profiled_device_ms(fn, runs, by_name=None):
    """Mean device time per call from torch.profiler's CUPTI trace: every
    device event (kernels, memsets, copies); None when the trace shows no
    device time. `by_name`, a dict, receives every device event's mean
    time per call by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if not ev.count or ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "device_time_total", 0) or \
            getattr(ev, "cuda_time_total", 0)
        if by_name is not None:
            by_name[ev.key] = t / runs / 1e3
        total += t
    return total / runs / 1e3 if total else None


def spread(t):
    return f"min {t[0]:.4f} / median {t[1]:.4f} / max {t[2]:.4f} ms"


def _tables(rng, n_roles, dd_rows, n_pages):
    """Stacked [R, P] tables: a quarter of each role's pages unbacked; the
    sketch roles cover only the dd_rows prefix."""
    p_pages = N_SERIES // PAGE_ROWS
    tables = np.full((n_roles, p_pages), -1, np.int32)
    for r in range(n_roles):
        lps = p_pages if r < 5 else dd_rows // PAGE_ROWS
        backed = rng.random(lps) < 0.75
        tables[r, :lps] = np.where(
            backed, rng.permutation(np.arange(1, n_pages))[:lps], -1)
    return tables


def _check_planes(k_ar, p_ar, base, sum_roles, tol_roles, ctx,
                  page_rows=PAGE_ROWS, idle_roles=()):
    """Kernel arenas vs plain arenas: `sum_roles` at rtol 1e-5 / atol 1e-6,
    `tol_roles` {role: check(k, p) -> bool}, the rest exact; page 0 zero;
    every arena but `idle_roles` updated. Returns the max abs error."""
    import torch

    max_abs = 0.0
    for r, (k, p) in enumerate(zip(k_ar, p_ar)):
        kf, pf = k.float(), p.float()
        diff = (kf - pf).abs()
        max_abs = max(max_abs, float(diff.max()))
        if r in tol_roles:
            ok = tol_roles[r](kf, pf)
        elif r in sum_roles:
            ok = torch.allclose(kf, pf, rtol=1e-5, atol=1e-6)
        else:
            ok = torch.equal(k, p)
        if not ok:
            raise AssertionError(f"{ctx}: K1 disagrees with its plain version "
                                 f"on arena {r} (max abs {float(diff.max())})")
        if bool(k[:page_rows].any()):
            raise AssertionError(f"{ctx}: K1 wrote the trash page of arena {r}")
        if torch.equal(k, base[r]) and r not in idle_roles:
            raise AssertionError(f"{ctx}: arena {r} was not updated")
    return max_abs


def phase_k1_dd():
    """Phase 3a (and its phase-5 times): K1 with f32 dd state vs its plain
    version on the card at full width."""
    import torch

    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.registry.registry import DEFAULT_HISTOGRAM_EDGES

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    gamma, minv, nb = _dd_meta()
    edges = tuple(DEFAULT_HISTOGRAM_EDGES)
    n_pages = -(-ARENA_SLOTS // PAGE_ROWS) + 1      # + the trash page
    rows = n_pages * PAGE_ROWS
    tables = _tables(rng, 7, DD_ROWS, n_pages)
    batches = []
    for _ in range(N_DISPATCH):
        mat = np.empty((4, N_SPANS), np.float32)
        mat[0] = zipf_slots(rng, N_SPANS, N_SERIES)
        mat[1] = rng.lognormal(-3.0, 2.0, N_SPANS)
        mat[1, :64] = 0.0                            # DDSketch zero counts
        mat[2] = rng.integers(100, 5000, N_SPANS)
        mat[3] = rng.integers(1, 4, N_SPANS)
        batches.append(mat)
    print(f"phase 3a: slots >= dd_rows: "
          f"{int((batches[0][0] >= DD_ROWS).sum())}, discards: "
          f"{int((batches[0][0] < 0).sum())}, backed pages per role: "
          f"{(tables > 0).sum(axis=1).tolist()}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(rows,)] * 4 + [(rows, len(edges) + 1), (rows,), (rows, nb)]
    base = []
    for shape in shapes:
        a = torch.randint(0, 4, shape, generator=gen, device=dev).float()
        a[:PAGE_ROWS] = 0                            # the trash page
        base.append(a)
    t_dev = torch.from_numpy(tables).to(dev)
    b_dev = [torch.from_numpy(m).to(dev) for m in batches]
    kw = dict(page_rows=PAGE_ROWS, edges=edges, gamma=gamma, min_value=minv,
              dd_rows=DD_ROWS)
    k_ar = [a.clone() for a in base]
    p_ar = [a.clone() for a in base]
    for b in b_dev:
        ck.paged_fused_update(t_dev, b[0], b[1:4], k_ar, **kw)
        ck.paged_fused_update_plain(t_dev, b[0], b[1:4], p_ar, **kw)
    torch.cuda.synchronize()
    max_abs = _check_planes(k_ar, p_ar, base, (1, 3), {}, "phase 3a")
    print("phase 3a kernel-vs-plain: " + json.dumps({
        "name": "paged_fused_update", "tier": "dd f32",
        "dispatches": N_DISPATCH, "max_abs_err": max_abs, "pass": True}))
    b0 = b_dev[0]
    calls = k1_calls(t_dev, b0, k_ar, kw)
    times = {how: (cuda_time_ms(fn, N_TIMED), host_ms(fn))
             for how, fn in calls.items()}
    plain_ms = cuda_time_ms(lambda: ck.paged_fused_update_plain(
        t_dev, b0[0], b0[1:4], p_ar, **kw), N_TIMED)
    device_ms = _k1_device_job(
        "phase 3a (sketch dd, f32, paged)", k_ar, t_dev, batches[0],
        dict(edges=edges, gamma=gamma, min_value=minv, dd_rows=DD_ROWS),
        PAGE_SHIFT)[0]
    nbytes = bound_bytes(batches[0], tables, dd_rows=DD_ROWS, nb=nb,
                         edges=edges)
    bound_ms, bound_by = bound(nbytes, N_SPANS * (40 + len(edges)))
    del k_ar, p_ar, base, calls
    torch.cuda.empty_cache()
    return {
        "name": "paged_fused_update (sketch dd, f32 state)", "route": "cuda",
        "source": "tempo_tpu_torch/csrc/paged_fused_update.cu",
        "replaces": "tempo_tpu/ops/pallas_kernels.py:196",
        "launches": None, "max_abs_err": max_abs,
        "ms": times["sliced"][0][1], "times": times,
        "plain_ms": plain_ms[1], "device_ms": device_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
        "library_ms": None,
    }


def k1_calls(t_dev, b, arenas, kw, **extra):
    """K1 on the packed [4, N] batch `b`, two ways: "fused_step", the call
    the main path makes (`ops.pages.fused_step`, which slices the batch
    on each call), and "sliced", the wrapper with the batch sliced on
    each call, as K1's earlier times in PERF.md were taken."""
    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.ops import pages as op

    step_kw = dict(kw, **extra)
    step_kw["page_shift"] = step_kw.pop("page_rows").bit_length() - 1
    return {
        "fused_step": lambda: op.fused_step(arenas, t_dev, b, **step_kw),
        "sliced": lambda: ck.paged_fused_update(t_dev, b[0], b[1:4], arenas,
                                                **kw, **extra),
    }


def edge_probe_on_card():
    """Durations on the DDSketch bucket edges min·γ^i and on the f32
    values next to them, one span per arena row, through K1 on the card;
    each row's bucket is held against the host's (torch CPU) `dd_index`.
    Returns (probes, spans whose bucket differs)."""
    import torch

    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.ops.pages import dd_index
    from tempo_tpu_torch.registry.registry import DEFAULT_HISTOGRAM_EDGES

    gamma, minv, nb = _dd_meta()
    e = (minv * gamma ** np.arange(nb + 1)).astype(np.float32)
    dur = np.unique(np.concatenate([
        e, np.nextafter(e, np.float32(0)), np.nextafter(e, np.float32(np.inf))]))
    n = dur.size
    p_pages = -(-n // PAGE_ROWS)
    rows = (p_pages + 1) * PAGE_ROWS
    tables = np.tile(np.arange(1, p_pages + 1, dtype=np.int32), (7, 1))
    mat = np.zeros((4, n), np.float32)
    mat[0] = np.arange(n)
    mat[1] = dur
    mat[3] = 1.0
    dev = torch.device("cuda")
    shapes = [(rows,)] * 4 + [(rows, 15), (rows,), (rows, nb)]
    arenas = [torch.zeros(s, device=dev) for s in shapes]
    b = torch.from_numpy(mat).to(dev)
    ck.paged_fused_update(torch.from_numpy(tables).to(dev), b[0], b[1:4],
                          arenas, page_rows=PAGE_ROWS,
                          edges=tuple(DEFAULT_HISTOGRAM_EDGES), gamma=gamma,
                          min_value=minv, dd_rows=n)
    at = np.arange(n) + PAGE_ROWS                  # one row per probe
    zero = arenas[5].cpu().numpy()[at] > 0
    card = arenas[6].cpu().numpy()[at].argmax(axis=1)
    host = dd_index(torch.from_numpy(dur), gamma, minv, nb).numpy()
    host_zero = dur <= np.float32(minv)
    if not np.array_equal(zero, host_zero):
        raise AssertionError("edge probe: zero counts differ from the host")
    if (arenas[6].cpu().numpy()[at].sum(axis=1)[~zero] != 1).any():
        raise AssertionError("edge probe: a probe did not land in one bucket")
    shifted = int((card != host)[~zero].sum())
    if np.abs(card - host)[~zero].max(initial=0) > 1:
        raise AssertionError("edge probe: a probe moved more than one bucket")
    return n, shifted


def _moments_ok(kf, pf):
    """Moment sums within rtol 1e-5 + 2e-5 per unit of the row's weight
    (each basis term is in [-1, 1]; CUDA `logf` and torch's CUDA `log` may
    differ by an ulp); the two bound columns at atol 2e-6 (one ulp of a
    value in [16, 32)); the count column exact."""
    import torch

    k = MOM_K
    if not torch.equal(kf[:, 0], pf[:, 0]):
        return False
    sums_ok = ((kf[:, 1:k + 1] - pf[:, 1:k + 1]).abs()
               <= 1e-5 * pf[:, 1:k + 1].abs() + 2e-5 * pf[:, :1]).all()
    bounds_ok = ((kf[:, k + 1:] - pf[:, k + 1:]).abs() <= 2e-6).all()
    return bool(sums_ok and bounds_ok)


def phase_k1_compact():
    """Phase 3b (and its phase-5 times): K1 with `sketch: both` and compact
    state vs its plain version on the card, five dispatches from non-zero
    state: three of dyadic durations (multiples of 1/256 s below 2 s) and
    weights (0.25, 0.5, 1, 1.5, 2.5), so every per-dispatch delta is exact
    (the hottest cell's latency sum stays far below 2^24 units of 2^-10);
    a fourth of no spans (only the pair rows are folded); a fifth after a
    logical page of the histogram and pair roles moved to a reused
    physical page. The int32 planes and the pair must be bit-identical,
    and the persistent scratch all zero after every dispatch."""
    import torch

    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.registry.registry import DEFAULT_HISTOGRAM_EDGES

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 7)
    gamma, minv, nb = _dd_meta()
    mom_meta = _mom_meta()
    edges = tuple(DEFAULT_HISTOGRAM_EDGES)
    n_pages = -(-ARENA_SLOTS // PAGE_ROWS) + 1
    rows = n_pages * PAGE_ROWS
    tables = _tables(rng, 8, DD_ROWS, n_pages)
    batches = []
    for _ in range(4):
        mat = np.empty((4, N_SPANS), np.float32)
        mat[0] = zipf_slots(rng, N_SPANS, N_SERIES)
        mat[1] = rng.integers(1, 2 * 256, N_SPANS) / 256
        in_dd = np.flatnonzero((mat[0] >= 0) & (mat[0] < DD_ROWS))
        mat[1, in_dd[:64]] = 0.0                     # DDSketch zero counts
        mat[2] = rng.integers(100, 5000, N_SPANS)
        mat[3] = rng.choice([0.25, 0.5, 1.0, 1.5, 2.5], N_SPANS)
        batches.append(mat)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    i32, f32 = torch.int32, torch.float32
    specs = [((rows,), i32), ((rows, 2), torch.bfloat16), ((rows,), i32),
             ((rows,), f32), ((rows, len(edges) + 1), i32), ((rows,), i32),
             ((rows, nb), i32), ((rows, MOM_K + 3), f32)]
    base = []
    for shape, dt in specs:
        a = torch.randint(0, 4, shape, generator=gen, device=dev)
        if dt == torch.bfloat16:                     # (sum, compensation)
            a = torch.stack([a[:, 0] / 8.0, (a[:, 1] - 2.0) / 1024.0], 1)
        a = a.to(dt)
        a[:PAGE_ROWS] = 0                            # the trash page
        base.append(a)
    t_dev = torch.from_numpy(tables).to(dev)
    b_dev = [torch.from_numpy(m).to(dev) for m in batches]
    kw = dict(page_rows=PAGE_ROWS, edges=edges, gamma=gamma, min_value=minv,
              dd_rows=DD_ROWS, mom_rows=DD_ROWS, mom_meta=mom_meta)
    k_ar = [a.clone() for a in base]
    p_ar = [a.clone() for a in base]
    scratch = ck.compact_scratch(t_dev, k_ar, page_rows=PAGE_ROWS,
                                 edges=edges, dd_rows=DD_ROWS)

    def k1(ar, b):
        ck.paged_fused_update(t_dev, b[0], b[1:4], ar, **kw, compact=True,
                              scratch=scratch)
        nz = int(torch.count_nonzero(scratch))
        if nz:
            raise AssertionError(f"phase 3b: {nz} scratch cells not zero "
                                 f"after a dispatch")

    ck.reset_launch_counts()
    for b in b_dev[:3]:
        k1(k_ar, b)
        ck.paged_fused_update_plain(t_dev, b[0], b[1:4], p_ar, **kw)
    launches = ck.paged_fused_update.launches
    # a dispatch of no spans: only the pair rows are folded
    before = [a.clone() for a in k_ar]
    ck.reset_launch_counts()
    empty = torch.zeros((4, 0), device=dev)
    k1(k_ar, empty)
    ck.paged_fused_update_plain(t_dev, empty[0], empty[1:4], p_ar, **kw)
    launches_empty = ck.paged_fused_update.launches
    if not torch.equal(k_ar[1], p_ar[1]) or any(
            not torch.equal(a, b) for r, (a, b) in enumerate(zip(k_ar, before))
            if r != 1):
        raise AssertionError("phase 3b: a dispatch of no spans changed more "
                             "than the pair, or the pair differs")
    # page reuse: the hottest slot's logical page of the histogram and the
    # pair moves to a free physical page; both pages are zeroed, as the
    # pool zeroes a page it releases and hands out zeroed pages
    hot = np.bincount(batches[3][0][batches[3][0] >= 0].astype(np.int64))
    lp = next(int(s) >> PAGE_SHIFT for s in np.argsort(-hot, kind="stable")
              if (tables[(1, 4), int(s) >> PAGE_SHIFT] > 0).all())
    moved = {}
    for r in (1, 4):
        old = int(tables[r, lp])
        new = int(np.setdiff1d(np.arange(1, n_pages), tables[r])[0])
        for ar in (k_ar, p_ar):
            for page in (old, new):
                if page > 0:
                    ar[r][page * PAGE_ROWS:(page + 1) * PAGE_ROWS] = 0
        tables[r, lp] = new
        moved[r] = (old, new)
    t_dev.copy_(torch.from_numpy(tables))
    ck.reset_launch_counts()
    k1(k_ar, b_dev[3])
    ck.paged_fused_update_plain(t_dev, b_dev[3][0], b_dev[3][1:4], p_ar, **kw)
    launches += ck.paged_fused_update.launches
    torch.cuda.synchronize()
    if launches != 2 * 4 or launches_empty != 1:
        raise AssertionError(f"phase 3b: {launches} launches for 4 "
                             f"dispatches of spans (want 2 each), "
                             f"{launches_empty} for the empty one (want 1)")
    max_abs = _check_planes(k_ar, p_ar, base, (3,), {7: _moments_ok},
                            "phase 3b")
    print("phase 3b kernel-vs-plain: " + json.dumps({
        "name": "paged_fused_update", "tier": "both, compact",
        "dispatches": 5, "launches": launches + launches_empty,
        "empty_dispatch": "only the pair changed, bit-identical",
        "moved_pages": {f"role {r}": f"logical page {lp}: {o} -> {n}"
                        for r, (o, n) in moved.items()},
        "scratch_zero_after_each": True, "max_abs_err": max_abs,
        "pass": True}))
    b0 = b_dev[0]
    calls = k1_calls(t_dev, b0, k_ar, kw, compact=True, scratch=scratch)
    times = {how: (cuda_time_ms(fn, N_TIMED), host_ms(fn))
             for how, fn in calls.items()}
    plain_ms = cuda_time_ms(lambda: ck.paged_fused_update_plain(
        t_dev, b0[0], b0[1:4], p_ar, **kw), N_TIMED)
    skw = {k: v for k, v in kw.items() if k != "page_rows"}
    device_ms, _, events = _k1_device_job(
        "phase 3b (sketch both, compact, paged)", k_ar, t_dev, batches[0],
        dict(skw, compact=True), PAGE_SHIFT)
    n = len(_K1_JOBS) - 1
    print(f"phase 5: compact K1 device time per dispatch {device_ms} ms, of "
          f"which span pass {_Later(f'k1-{n}-span')} ms and fold "
          f"{_Later(f'k1-{n}-fold')} ms; every device event per dispatch: "
          f"{events} (no memset: the final profiles check it)")
    nbytes = bound_bytes(batches[0], tables, dd_rows=DD_ROWS, nb=nb,
                         edges=edges, mom_rows=DD_ROWS, compact=True)
    cells = touched_cells(batches[0], tables, dd_rows=DD_ROWS, nb=nb,
                          edges=edges, mom_rows=DD_ROWS)
    int_cells = sum(cells[r] for r in (0, 2, 4, 5, 6))
    pair_rows = int((tables[1] > 0).sum()) * PAGE_ROWS
    bound_ms, bound_by = bound(nbytes, N_SPANS * (80 + len(edges)))
    scratch_bytes = scratch.numel() * 4
    del k_ar, p_ar, base, scratch, calls
    torch.cuda.empty_cache()
    return {
        "name": "paged_fused_update (sketch both, compact state)",
        "route": "cuda", "source": "tempo_tpu_torch/csrc/paged_fused_update.cu",
        "replaces": "tempo_tpu/ops/pallas_kernels.py:196",
        "launches": None, "max_abs_err": max_abs,
        "ms": times["sliced"][0][1], "times": times,
        "plain_ms": plain_ms[1], "device_ms": device_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
        "library_ms": None, "int_cells": int_cells, "pair_rows": pair_rows,
        "scratch_bytes": scratch_bytes,
    }


def phase_k1_dense():
    """Phase 3d (and the dense times of phase 5): K1 on dense state vs its
    plain version on the card at full width, `sketch: both` f32 (8 roles,
    so the span pass stages the [8, P] identity tables), through the main
    path's call (`ops.pages.fused_step`). Each role's arena is a trash
    page, its rows (65,536, or 16,384 for the sketch roles) and one guard
    page past them. Then, on the `sketch: dd` roles (7), K1 against the
    composed twin of the reference's dense step on the same push."""
    import torch

    from tempo_tpu_torch.generator.processors.spanmetrics import \
        _fused_update_impl
    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.ops import pages as op
    from tempo_tpu_torch.ops.sketches import DDSketch
    from tempo_tpu_torch.registry import metrics as tm
    from tempo_tpu_torch.registry.registry import DEFAULT_HISTOGRAM_EDGES

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 13)
    gamma, minv, nb = _dd_meta()
    mom_meta = _mom_meta()
    edges = tuple(DEFAULT_HISTOGRAM_EDGES)
    pr = op.dense_page_rows(N_SERIES)
    shift = pr.bit_length() - 1
    rows = [N_SERIES] * 5 + [DD_ROWS] * 3
    widths = [None] * 4 + [len(edges) + 1, None, nb, MOM_K + 3]
    tables = op.identity_tables(rows, pr, "cpu").numpy()
    batches = []
    for _ in range(3):
        mat = np.empty((4, N_SPANS), np.float32)
        mat[0] = zipf_slots(rng, N_SPANS, N_SERIES)
        mat[1] = rng.lognormal(-3.0, 2.0, N_SPANS)
        mat[1, :64] = 0.0                            # DDSketch zero counts
        mat[2] = rng.integers(100, 5000, N_SPANS)
        mat[3] = rng.integers(1, 4, N_SPANS)
        batches.append(mat)
    s0 = batches[0][0]
    print(f"phase 3d: dense page rows {pr}, tables {tables.shape}; slots < "
          f"dd_rows: {int(((s0 >= 0) & (s0 < DD_ROWS)).sum())}, >= dd_rows: "
          f"{int((s0 >= DD_ROWS).sum())}, discards: {int((s0 < 0).sum())}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    base = []
    for n, w in zip(rows, widths):
        shape = (pr + n + pr,) if w is None else (pr + n + pr, w)
        a = torch.randint(0, 4, shape, generator=gen, device=dev).float()
        a[:pr] = 0                                   # the trash page
        a[pr + n:] = 0                               # the guard page
        base.append(a)
    t_dev = torch.from_numpy(tables).to(dev)
    b_dev = [torch.from_numpy(m).to(dev) for m in batches]
    skw = dict(edges=edges, gamma=gamma, min_value=minv, dd_rows=DD_ROWS,
               mom_rows=DD_ROWS, mom_meta=mom_meta)
    kw = dict(skw, page_rows=pr)

    def step(ar, b, t=t_dev, skw=skw):
        """The main path's call (`ops.pages.fused_step`)."""
        op.fused_step(ar, t, b, page_shift=shift, **skw)

    k_ar = [a.clone() for a in base]
    p_ar = [a.clone() for a in base]
    ck.reset_launch_counts()
    for b in b_dev:
        step(k_ar, b)
        ck.paged_fused_update_plain(t_dev, b[0], b[1:4], p_ar, **kw)
    launches = ck.paged_fused_update.launches
    empty = torch.zeros((4, 0), device=dev)
    before = [a.clone() for a in k_ar]
    step(k_ar, empty)
    torch.cuda.synchronize()
    if launches != 3 or ck.paged_fused_update.launches != 3:
        raise AssertionError(f"phase 3d: {launches} launches for 3 pushes "
                             f"of spans (want 3), "
                             f"{ck.paged_fused_update.launches - launches} "
                             f"for the push of none (want 0)")
    if any(not torch.equal(a, b) for a, b in zip(k_ar, before)):
        raise AssertionError("phase 3d: a push of no spans changed state")
    max_abs = _check_planes(k_ar, p_ar, base, (1, 3), {7: _moments_ok},
                            "phase 3d", page_rows=pr)
    for r, (a, n) in enumerate(zip(k_ar, rows)):
        if bool(a[pr + n:].any()):
            raise AssertionError(f"phase 3d: K1 wrote past the {n} rows of "
                                 f"arena {r}")
    print("phase 3d kernel-vs-plain: " + json.dumps({
        "name": "paged_fused_update", "tier": "dense, both f32",
        "pushes": 4, "launches": launches, "max_abs_err": max_abs,
        "trash_and_guard_pages": "zero", "pass": True}))
    both_ms = _k1_device_job("phase 3d (dense, sketch both, f32)", k_ar,
                             t_dev, batches[0], skw, shift)[0]
    # sketch: dd (the dense main path's tier): 7 roles, the same push
    t7, skw7 = t_dev[:7], dict(skw, mom_rows=0, mom_meta=None)
    kw7 = dict(skw7, page_rows=pr)
    b0 = b_dev[0]
    calls = k1_calls(t7, b0, k_ar[:7], kw7)
    times = {how: (cuda_time_ms(calls[how], N_TIMED), host_ms(calls[how]))
             for how in ("fused_step", "sliced")}
    plain_ms = cuda_time_ms(lambda: ck.paged_fused_update_plain(
        t7, b0[0], b0[1:4], p_ar[:7], **kw7), N_TIMED)
    device_ms = _k1_device_job("phase 5 (dense, sketch dd, f32)", k_ar[:7],
                               t7, batches[0], skw7, shift)[0]
    # the composed twin on row views of a copy of the same state
    tw = [a.clone() for a in base[:7]]
    v = [a[pr:pr + n] for a, n in zip(tw, rows)]
    states = (tm.CounterState(v[0]),
              tm.HistogramState(v[4], v[1], v[2], edges),
              tm.CounterState(v[3]), DDSketch(v[6], v[5], gamma, minv), None)
    twin = lambda: _fused_update_impl(*states, b0[0], b0[1], b0[2],  # noqa
                                      b0[3])
    once = [a.clone() for a in base[:7]]
    step(once, b0, t7, skw7)
    twin()
    torch.cuda.synchronize()
    _check_planes(once, tw, base[:7], (1, 3), {}, "phase 5 twin vs K1",
                  page_rows=pr)
    twin_ms = cuda_time_ms(twin, N_TIMED)
    twin_host = host_ms(twin, 200)
    events = {}
    twin_device_ms = _device_ms(twin, events)
    top = dict(sorted(events.items(), key=lambda kv: -kv[1])[:6])
    nbytes = bound_bytes(batches[0], tables[:7], dd_rows=DD_ROWS, nb=nb,
                         edges=edges, page_shift=shift)
    bound_ms, bound_by = bound(nbytes, N_SPANS * (40 + len(edges)))
    both_bytes = bound_bytes(batches[0], tables, dd_rows=DD_ROWS, nb=nb,
                             edges=edges, mom_rows=DD_ROWS, page_shift=shift)
    both_bound = bound(both_bytes, N_SPANS * (80 + len(edges)))
    print(f"phase 5: dense K1, sketch both (8 roles, tables staged): device "
          f"time per push {both_ms} ms, bound {both_bound[0]:.6f} ms by "
          f"{both_bound[1]} ({both_bytes} bytes); the composed twin (sketch "
          f"dd): "
          f"{spread(twin_ms)} with the host, host {twin_host:.4f} ms a call "
          f"over 200 unsynchronised calls, device time per push (every "
          f"device event) {twin_device_ms} ms, of which the six longest "
          f"events: {json.dumps(top)}")
    del k_ar, p_ar, base, tw, once, states, calls
    torch.cuda.empty_cache()
    return {
        "name": "paged_fused_update (dense state, identity tables, sketch "
                "dd, f32)", "route": "cuda",
        "source": "tempo_tpu_torch/csrc/paged_fused_update.cu",
        "replaces": "tempo_tpu/ops/pallas_kernels.py:196",
        "launches": None, "max_abs_err": max_abs,
        "ms": times["fused_step"][0][1], "times": times,
        "plain_ms": plain_ms[1], "device_ms": device_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
        "library_ms": None, "twin_ms": twin_ms[1],
        "twin_device_ms": twin_device_ms, "twin_host_ms": twin_host,
    }


def _device_ms(fn, by_name=None):
    """`profiled_device_ms` of every device event of `fn`, profiled a
    second time when the first trace shows no device time."""
    got = profiled_device_ms(fn, N_TIMED, by_name=by_name)
    return got if got is not None else \
        profiled_device_ms(fn, N_TIMED, by_name=by_name)


def _k2_shape(shape):
    """(spans, series, edges) of K2's two shapes: "bench", the reference
    benchmark's (benchmarks/bench_kernels.py:22); "deployment", one push
    into the tenant's whole series table at the registry's defaults."""
    from tempo_tpu_torch.registry.registry import DEFAULT_HISTOGRAM_EDGES

    if shape == "bench":
        return K2_SPANS, K2_SERIES, K2_EDGES
    return N_SPANS, N_SERIES, tuple(DEFAULT_HISTOGRAM_EDGES)


def _k2_batch(rng, shape, bad=0.0):
    """K2 inputs at `shape`. bench: the reference benchmark's (uniform
    slots, lognormal durations, integer sizes, unit weights), `bad` the
    share of slots replaced by -1 or an id past the series range.
    deployment: Zipf-skewed slots (a = 1.1, 5% discards), lognormal
    durations, integer sizes, integer weights 1-3."""
    n, n_series, _ = _k2_shape(shape)
    if shape == "bench":
        slots = rng.integers(0, n_series, n).astype(np.int32)
        nbad = int(bad * n)
        slots[:nbad] = rng.choice([-1, n_series, n_series + 5], nbad)
        dur = rng.lognormal(-3, 1.5, n).astype(np.float32)
        w = np.ones(n, np.float32)
    else:
        slots = zipf_slots(rng, n, n_series).astype(np.int32)
        dur = rng.lognormal(-3.0, 2.0, n).astype(np.float32)
        w = rng.integers(1, 4, n).astype(np.float32)
    sizes = rng.integers(100, 5000, n).astype(np.float32)
    return slots, dur, sizes, w


def phase_k2(shape):
    """Phase 3c (and its phase-5 times): K2 at `shape` driven over 8
    batches (launch counts zeroed before, read after, held against
    `k2_layout`), its summed state held against the plain version's:
    count and histogram columns exact, sums at rtol 1e-5, the count total
    equal to the kept weight; then a batch of no spans and one of only
    discards, each all zero."""
    import torch

    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.ops.pages import hist_bucket

    dev = torch.device("cuda")
    n, n_series, edges = _k2_shape(shape)
    f = 4 + len(edges)
    rng = np.random.default_rng(SEED + 11)
    batches = [[torch.from_numpy(x).to(dev) for x in _k2_batch(rng, shape, bad)]
               for bad in [0.05] + [0.0] * (N_DISPATCH - 1)]
    kw = dict(n_series=n_series, edges=edges)
    ck.reset_launch_counts()
    state = torch.zeros((n_series, f), device=dev)
    for b in batches:
        state += ck.fused_spanmetrics_matmul(*b, **kw)
    torch.cuda.synchronize()
    launches = ck.fused_spanmetrics_matmul.launches
    want_launches = sum(ck.k2_layout(b[0].numel(), n_series, len(edges))
                        .launches for b in batches)
    if launches != want_launches:
        raise AssertionError(f"K2 {shape}: {launches} launches for "
                             f"{len(batches)} batches (k2_layout: "
                             f"{want_launches})")
    plain = torch.zeros_like(state)
    for b in batches:
        plain += ck.fused_spanmetrics_scatter(*b, **kw)
    exact = [0] + list(range(3, f))
    if not torch.equal(state[:, exact], plain[:, exact]) or not \
            torch.allclose(state[:, 1:3], plain[:, 1:3], rtol=1e-5, atol=1e-6):
        raise AssertionError(f"K2 {shape} disagrees with its plain version")
    want = sum(float(b[3][(b[0] >= 0) & (b[0] < n_series)].double().sum())
               for b in batches)
    if float(state[:, 0].double().sum()) != want:
        raise AssertionError(f"K2 {shape}: count total "
                             f"{float(state[:, 0].double().sum())} != the "
                             f"kept weight {want}")
    max_abs = float((state - plain).abs().max())
    empty = [x[:0].contiguous() for x in batches[0]]
    discards = [x.clone() for x in batches[0]]
    discards[0].fill_(-1)
    for what, b in (("no spans", empty), ("only discards", discards)):
        got = ck.fused_spanmetrics_matmul(*b, **kw)
        torch.cuda.synchronize()
        if tuple(got.shape) != (n_series, f) or bool(got.any()):
            raise AssertionError(f"K2 {shape}: a batch of {what} did not "
                                 f"give an all-zero [{n_series}, {f}] delta")
    print(f"phase 3c kernel-vs-plain ({shape} shape): " + json.dumps({
        "name": "fused_spanmetrics_matmul", "spans": n, "series": n_series,
        "edges": len(edges), "batches": len(batches), "launches": launches,
        "max_abs_err": max_abs, "empty_and_discards": "all zero",
        "pass": True}))
    b = batches[1]
    call = lambda: ck.fused_spanmetrics_matmul(*b, **kw)  # noqa: E731
    ms = cuda_time_ms(call, N_TIMED)
    host = host_ms(call)
    plain_ms = cuda_time_ms(lambda: ck.fused_spanmetrics_scatter(*b, **kw),
                            N_TIMED)
    events = {}
    device_ms = profiled_device_ms(call, N_TIMED, by_name=events)
    # the library yardstick: one index_add_ of a prebuilt [N, F] feature
    # matrix (built outside the timed region; discards sent to a spare row)
    # into a zeroed state
    slots, dur, sizes, w = b
    feats = torch.zeros((n, f), device=dev)
    feats[:, 0] = w
    feats[:, 1] = dur * w
    feats[:, 2] = sizes * w
    feats[torch.arange(n, device=dev), 3 + hist_bucket(dur, edges)] = w
    idx = torch.where((slots >= 0) & (slots < n_series), slots,
                      n_series).long()
    lib_out = torch.zeros((n_series + 1, f), device=dev)
    library = lambda: lib_out.index_add_(0, idx, feats)  # noqa: E731
    library_ms = cuda_time_ms(library, N_TIMED)
    library_device_ms = profiled_device_ms(library, N_TIMED)
    print(f"phase 5: K2 ({shape} shape) device time per call, every device "
          f"event: {device_ms} ms {json.dumps(events)}; index_add_ device "
          f"time per call {library_device_ms} ms")
    if shape == "deployment":
        # the same push with uniform slots (5% discards): the share of the
        # Zipf push's time that its hot series cost
        u = [x.clone() for x in b]
        u[0].copy_(torch.from_numpy(np.where(
            rng.random(n) < 0.05, -1, rng.integers(0, n_series, n)).astype(
                np.int32)))
        got = ck.fused_spanmetrics_matmul(*u, **kw)
        ref = ck.fused_spanmetrics_scatter(*u, **kw)
        if not torch.equal(got[:, exact], ref[:, exact]) or not \
                torch.allclose(got[:, 1:3], ref[:, 1:3], rtol=1e-5, atol=1e-6):
            raise AssertionError("K2 deployment, uniform slots: disagrees "
                                 "with its plain version")
        print(f"phase 5: K2 (deployment shape, uniform slots) device time "
              f"per call, every device event: "
              f"{profiled_device_ms(lambda: ck.fused_spanmetrics_matmul(*u, **kw), N_TIMED)} ms")
    nbytes = n * 16 + n_series * f * 4
    bound_ms, bound_by = bound(nbytes, n * (6 + len(edges)))
    return {
        "name": f"fused_spanmetrics_matmul ({shape} shape)", "route": "cuda",
        "source": "tempo_tpu_torch/csrc/fused_spanmetrics.cu",
        "replaces": "tempo_tpu/ops/pallas_kernels.py:141",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms[1], "times": {"call": (ms, host)}, "plain_ms": plain_ms[1],
        "device_ms": device_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_bytes": nbytes, "library_ms": library_ms[1],
        "library_device_ms": library_device_ms,
    }


def _payloads(now, n_payloads):
    """Seeded k6-like OTLP payloads, per-span sizes, and the sample
    weights of overload sampling: integer, or dyadic for compact state."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

    rng = np.random.default_rng(SEED + 1)
    payloads = [encode_spans_otlp(synthetic_spans(
        N_SPANS, seed=SEED + k, now_ns=int(now * 1e9)))
        for k in range(n_payloads)]
    sizes = [rng.integers(200, 2000, N_SPANS).astype(np.float32)
             for _ in payloads]
    int_w = [rng.integers(1, 4, N_SPANS).astype(np.float32) for _ in payloads]
    dyadic_w = [rng.choice([1.0, 1.25, 1.5, 2.0, 4.0], N_SPANS).astype(
        np.float32) for _ in payloads]
    return payloads, sizes, int_w, dyadic_w


DB_SYSTEMS = ("postgresql", "redis", "mysql", "mongodb")


def trace_tree_spans(n, *, seed, now_ns, n_services=32, n_ops=32,
                     db_share=1 / 16):
    """`n` span dicts of seeded two-span trace trees, in shuffled order: a
    CLIENT span in service A and a SERVER span in service B whose
    `parent_span_id` is the client's `span_id`; a `db_share` of the
    client spans instead carry `db.system` and have no server side (they
    become virtual-node edges when they expire). Durations lognormal
    around 24 ms (the server's inside the client's), statuses uniform
    over unset / ok / error, end times within 10 s before `now_ns`."""
    rng = np.random.default_rng(seed)
    spans = []
    while len(spans) < n:
        tid, cid = rng.bytes(16), rng.bytes(8)
        a, b, x, y, sc, ss, db = rng.integers(0, 1 << 30, 7)
        end = now_ns - int(rng.random() * 10e9)
        dur = max(int(rng.lognormal(17.0, 1.5)), 2)
        client = {"trace_id": tid, "span_id": cid,
                  "service": f"service-{a % n_services}",
                  "name": f"op-{x % n_ops}", "kind": 3,
                  "status_code": int(sc % 3),
                  "start_unix_nano": end - dur, "end_unix_nano": end}
        if len(spans) == n - 1 or rng.random() < db_share:
            client["attrs"] = {"db.system": DB_SYSTEMS[db % len(DB_SYSTEMS)]}
            spans.append(client)
            continue
        sdur = max(int(dur * rng.uniform(0.3, 0.95)), 1)
        start = end - dur + (dur - sdur) // 2
        spans += [client, {
            "trace_id": tid, "span_id": rng.bytes(8), "parent_span_id": cid,
            "service": f"service-{b % n_services}", "name": f"op-{y % n_ops}",
            "kind": 2, "status_code": int(ss % 3),
            "start_unix_nano": start, "end_unix_nano": start + sdur}]
    order = rng.permutation(len(spans))
    return [spans[i] for i in order]


def _instances(now, sm, names, paged=True):
    """One generator instance per (name, device), each on its own pool
    (`paged`) or on dense state, with no remote write."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.registry import pages

    insts = {}
    for name, device in names:
        pool = pages.PagePool(tt.PagePoolConfig(enabled=True), device=device) \
            if paged else None
        with pages.use(pool):
            insts[name] = tt.GeneratorInstance(
                "smoke", tt.GeneratorConfig(
                    processors=("span-metrics",),
                    spanmetrics=tt.SpanMetricsConfig(**sm)),
                now=lambda: now, device=device)
        if insts[name].state_layout != ("paged" if paged else "dense"):
            raise AssertionError(f"{name}: {insts[name].state_layout} state")
    return insts


def _push_all(inst, payloads, sizes, weights):
    """Decode and push every payload; returns (seconds, decode seconds),
    the seconds closed by a synchronize on the card."""
    import torch

    import tempo_tpu_torch as tt

    t0 = time.perf_counter()
    decode_s = 0.0
    for data, size, weight in zip(payloads, sizes, weights):
        td = time.perf_counter()
        sb = tt.otlp_proto_to_batch(data, tt.SpanBatchBuilder(inst.registry.interner))
        decode_s += time.perf_counter() - td
        span_sizes = np.zeros(sb.capacity, np.float32)
        span_sizes[:sb.n] = size[:sb.n]
        inst.push_batch(sb, span_sizes, sample_weights=weight[:sb.n])
    if inst.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, decode_s


def _moment_rows(proc):
    """{labels: moments row} of the processor's active sketch slots,
    gathered through the moments plane's page table."""
    mp, limit = proc._pmom[0], proc._pmom[4]
    with proc.registry.state_lock:
        slots = proc.calls.table.active_slots()
        slots = slots[slots < limit].astype(np.int32)
        rows = mp.gather(slots)
    return {proc.calls.labels_of(int(s)): rows[i] for i, s in enumerate(slots)}


def _compare_moment_rows(card, host, tier):
    """The card's moments rows against the host's, series by series, under
    `_moments_ok`. Returns (rows, max abs error)."""
    import torch

    if card.keys() != host.keys() or not card:
        raise AssertionError(f"{tier}: moments rows of different series sets")
    keys = list(card)
    kf = torch.from_numpy(np.stack([card[k] for k in keys]))
    pf = torch.from_numpy(np.stack([host[k] for k in keys]))
    if not _moments_ok(kf, pf):
        raise AssertionError(f"{tier}: the card's moments rows disagree with "
                             f"the host's (max abs "
                             f"{float((kf - pf).abs().max())})")
    return len(keys), float((kf - pf).abs().max())


def phase_main_path(tier, n_payloads=N_DISPATCH):
    """Phase 4: one main path on the card against the same path on the
    host (plain versions). `tier` "dd": f32 state, integer sample weights,
    q50/q99 exactly equal. `tier` "both_compact": `sketch: both` with
    compact state, dyadic sample weights; DDSketch q50/q99 exactly equal,
    moments q50/q99 (one solve per row for both) compared and the series
    outside rtol 1e-3 counted. `tier` "dense_dd": as "dd" with no page
    pool, on dense state. Each tier compares the card's collected rows
    with the host's by label set. Returns a result dict."""
    from tempo_tpu_torch.ops import cuda_kernels as ck

    compact = tier == "both_compact"
    sm = dict(sketch="both", compact_state=True) if compact else {}
    paged = not tier.startswith("dense")
    now = time.time()
    payloads, sizes, int_w, dyadic_w = _payloads(now, n_payloads)
    weights = dyadic_w if compact else int_w
    res = {}
    # no remote write here: its encode of 516,325 samples took 15-20 s
    # (the smoke's time, ROADMAP "The smoke's time"); phase 6's far
    # window runs `collect_and_push` on the card
    names = ((f"{tier}-card", "cuda"), (f"{tier}-host", "cpu"))
    insts = _instances(now, sm, names, paged=paged)
    for name, inst in insts.items():
        on_card = name.endswith("card")
        if on_card:
            ck.reset_launch_counts()
            ck.paged_fused_update.plans = 0
        push_s, decode_s = _push_all(inst, payloads, sizes, weights)
        if on_card:
            launches = ck.paged_fused_update.launches
            plans = ck.paged_fused_update.plans
        tc = time.perf_counter()
        inst.drain()
        n_samples = len(inst.registry.collect())
        collect_s = time.perf_counter() - tc
        proc = inst.processors["span-metrics"]
        tq = time.perf_counter()
        dd_q = proc.dd_quantiles((0.5, 0.99))
        dd_s = time.perf_counter() - tq
        tq = time.perf_counter()
        mom_q = proc.quantiles((0.5, 0.99)) if compact else None
        mom_s = time.perf_counter() - tq
        res[name] = {"push_s": push_s, "dd_q": dd_q, "mom_q": mom_q,
                     "mom_rows": _moment_rows(proc) if compact else None,
                     "series": inst.registry.active_series,
                     "state_bytes": inst.device_state_bytes(),
                     "scratch_bytes": proc.scratch_bytes()}
        print(f"phase 4 {name}: {len(payloads)} pushes of {N_SPANS} spans "
              f"in {push_s:.3f} s (OTLP decode {decode_s:.3f} s, "
              f"push_batch {push_s - decode_s:.3f} s), "
              f"{res[name]['series']} series; collect {n_samples} "
              f"samples in {collect_s:.3f} s; DDSketch q50+q99 in "
              f"{dd_s:.3f} s"
              + (f"; moments q50+q99 in {mom_s:.3f} s" if compact else ""))
    rows = [_family_rows([insts[n]]) for n, _ in names]
    n_sets, _ = _compare_rows(*rows, tier,
                              hist_rtol=1e-2 if compact else None)
    total = float(sum(
        v[0].sum() for v in
        rows[0]["traces_spanmetrics_calls_total"].values()))
    card, host = res[f"{tier}-card"], res[f"{tier}-host"]
    want = float(sum(w.sum() for w in weights))
    if not compact and total != want:
        raise AssertionError(f"calls total {total} != {want}, the weighted "
                             f"spans pushed")
    for i, q in enumerate((0.5, 0.99)):
        a, b = card["dd_q"][i], host["dd_q"][i]
        if a != b or not a:
            bad = sum(a.get(k) != b.get(k) for k in a.keys() | b.keys())
            raise AssertionError(f"{tier}: DDSketch q{q}: {bad} series differ "
                                 f"between card and host")
    outside = {}
    if compact:
        n_rows, rows_err = _compare_moment_rows(card["mom_rows"],
                                                host["mom_rows"], tier)
        for i, q in enumerate((0.5, 0.99)):
            a, b = card["mom_q"][i], host["mom_q"][i]
            if a.keys() != b.keys() or not a:
                raise AssertionError(f"{tier}: moments q{q} series differ")
            vals = np.array([a[k] for k in a])
            if not np.isfinite(vals).all() or (vals <= 0).any():
                raise AssertionError(f"{tier}: moments q{q} not finite positive")
            outside[q] = int(sum(abs(a[k] - b[k]) > 1e-3 * abs(b[k]) for k in a))
        lo = card["mom_q"][0]
        if any(card["mom_q"][1][k] < lo[k] for k in lo):
            raise AssertionError(f"{tier}: a moments q99 below its q50")
        if any(outside[q] > MOM_OUTSIDE_MAX[q] for q in outside):
            raise AssertionError(f"{tier}: moments quantiles outside rtol 1e-3 "
                                 f"{outside}, above the limits "
                                 f"{MOM_OUTSIDE_MAX}")
    n_q = len(card["dd_q"][0])
    print(f"phase 4 {tier} checks: {n_sets} label sets in the card's "
          f"largest family equal the host's collected ones under the "
          f"stated tolerances; calls "
          f"total {total} (weighted spans {want}); DDSketch q50/q99 of "
          f"{n_q} series equal"
          + (f"; moments rows of {n_rows} series within the moments "
             f"tolerance (max abs {rows_err}); moments quantiles outside "
             f"rtol 1e-3 of {len(card['mom_q'][0])} series: q50 "
             f"{outside[0.5]}, q99 {outside[0.99]} (limits "
             f"{MOM_OUTSIDE_MAX[0.5]}, {MOM_OUTSIDE_MAX[0.99]})"
             if compact else "")
          + f"; K1 launch plans built over the pushes: {plans}")
    kernels_per_push = 2 if compact else 1
    if launches != kernels_per_push * len(payloads):
        raise AssertionError(f"{tier}: K1 launched {launches} times for "
                             f"{len(payloads)} pushes")
    if plans != 1:
        raise AssertionError(f"{tier}: K1 built {plans} launch plans over "
                             f"{len(payloads)} pushes (want 1: the same "
                             f"tables, arenas and scratch every push)")
    if compact:
        print(f"phase 4 {tier}-card: K1's compact scratch, working memory "
              f"outside the state bytes: {card['scratch_bytes']} bytes")
    return {"launches": launches, "push_s": card["push_s"],
            "pushes": len(payloads),
            "spans_per_s": len(payloads) * N_SPANS / card["push_s"],
            "state_bytes": card["state_bytes"],
            "bytes_per_series": card["state_bytes"] / card["series"],
            "series": card["series"], "outside": outside}


# ---------------------------------------------------------------------------
# phase 6: the reference's default deployment through the device scheduler
# ---------------------------------------------------------------------------

N_TENANTS, N_TREE_PUSHES, N_TREE_SPANS, N_PRODUCERS = 8, 8, 1024, 2
N_PHASE6_PUSHES = 4              # phase 6's pushes a tenant (8 before 13)
SCHED_KERNEL = "spanmetrics_fused_update"


def _tree_traffic(now_ns, n_tenants=N_TENANTS, n_pushes=N_TREE_PUSHES):
    """Per tenant, `n_pushes` OTLP payloads of 1,024 trace-tree spans (32
    services x 32 operations), with per-span sizes of 200-2,000 B and
    integer sample weights 1-3."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    rng = np.random.default_rng(SEED + 6)
    return [[(encode_spans_otlp(trace_tree_spans(
        N_TREE_SPANS, seed=SEED + 100 * t + k, now_ns=now_ns)),
        rng.integers(200, 2001, N_TREE_SPANS).astype(np.float32),
        rng.integers(1, 4, N_TREE_SPANS).astype(np.float32))
        for k in range(n_pushes)] for t in range(n_tenants)]


def _tree_set(traffic, clock, paged, use_scheduler):
    """The 8 tenants of one run on the card, default `GeneratorConfig`
    (span metrics and service graphs; `use_scheduler` as given), in one
    page pool of the default config when `paged`, else on dense state;
    and every push decoded with its tenant's interner, before any is
    timed."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.registry import pages

    pool = pages.PagePool(tt.PagePoolConfig(enabled=True), device="cuda") \
        if paged else None
    insts = []
    with pages.use(pool):
        for t in range(N_TENANTS):
            insts.append(tt.GeneratorInstance(f"tenant-{t}", tt.GeneratorConfig(
                spanmetrics=tt.SpanMetricsConfig(use_scheduler=use_scheduler)),
                now=lambda: clock[0], device="cuda"))
    for g in insts:
        if g.state_layout != ("paged" if paged else "dense") or \
                tuple(g.processors) != ("span-metrics", "service-graphs"):
            raise AssertionError(f"{g.tenant}: {g.state_layout} state, "
                                 f"processors {tuple(g.processors)}")
    batches = [[(tt.otlp_proto_to_batch(
        data, tt.SpanBatchBuilder(g.registry.interner)), size, w)
        for data, size, w in pushes] for g, pushes in zip(insts, traffic)]
    return insts, batches


def _drive(insts, batches):
    """Two producer threads, thread j owning tenants j, j+2, ...: each
    pushes runs of 4 consecutive pushes of a tenant, tenant after tenant.
    Returns the seconds until every push has landed on the card (the
    scheduler flushed, the card synchronised)."""
    import threading

    import torch

    from tempo_tpu_torch import sched

    errors = []

    def producer(j):
        try:
            for k0 in range(0, len(batches[0]), 4):
                for t in range(j, N_TENANTS, N_PRODUCERS):
                    for sb, size, w in batches[t][k0:k0 + 4]:
                        sizes = np.zeros(sb.capacity, np.float32)
                        sizes[:sb.n] = size[:sb.n]
                        insts[t].push_batch(sb, sizes, sample_weights=w[:sb.n])
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(j,))
               for j in range(N_PRODUCERS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    sched.flush()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return secs


def _expire_all(insts, clock):
    """Step the clock past the service graphs' `wait_s` and push one empty
    batch a tenant: the unmatched db clients become virtual-node edges."""
    import torch

    import tempo_tpu_torch as tt
    from tempo_tpu_torch import sched
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    clock[0] += insts[0].cfg.servicegraphs.wait_s + 1.0
    for g in insts:
        g.push_batch(tt.otlp_proto_to_batch(
            encode_spans_otlp([]), tt.SpanBatchBuilder(g.registry.interner)))
    sched.flush()
    torch.cuda.synchronize()


def _timed_emits(insts):
    """Wrap each service-graphs processor's `_emit` to sum its host time
    (no synchronisation) and keep the last edge list and the original."""
    import threading

    acc = {"s": 0.0, "calls": 0, "edges": 0, "last": None, "inner": None}
    lock = threading.Lock()
    for g in insts:
        sg = g.processors["service-graphs"]

        def timed(edges, inner=sg._emit):
            t0 = time.perf_counter()
            inner(edges)
            dt = time.perf_counter() - t0
            with lock:
                acc["s"] += dt
                acc["calls"] += 1
                acc["edges"] += len(edges)
                acc["last"], acc["inner"] = list(edges), inner
        sg._emit = timed
    return acc


def _compare_sets(sched_insts, direct_insts, ctx):
    """Tenant by tenant, the scheduler route's state against its direct
    twin's on the card: the same series in the same slots, compared by
    their label strings (each instance has its own interner, and the
    threaded staging of a large payload hands out ids in the order its
    threads reach new strings), every family's
    rows (span metrics and service graphs) with counts and buckets exact
    and sums (latency and edge `_sum`, size) at rtol 1e-5, and the
    DDSketch rows exact. Returns (families, series, max relative sum
    error)."""
    from tempo_tpu_torch.generator.processors.spanmetrics import (_DD_COUNTS,
                                                                  _DD_ZEROS)

    n_fams = n_series = 0
    max_rel = 0.0
    for ga, gb in zip(sched_insts, direct_insts):
        for name, fa in ga.registry._metrics.items():
            fb = gb.registry._metrics[name]
            live = fa.table.active_slots().tolist()
            if not (np.array_equal(fa.table.active, fb.table.active) and
                    [fa.labels_of(s) for s in live] ==
                    [fb.labels_of(s) for s in live]):
                raise AssertionError(f"{ctx} {ga.tenant} {name}: the series "
                                     f"tables differ")
            with ga.registry.state_lock:
                sa = fa._snap()
            with gb.registry.state_lock:
                sb = fb._snap()
            for i, (x, y) in enumerate(zip(sa, sb)):
                is_sum = name == "traces_spanmetrics_size_total" or \
                    (len(sa) == 3 and i == 1)
                if is_sum:
                    ok = np.allclose(x, y, rtol=1e-5, atol=1e-6)
                    rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-30)
                    max_rel = max(max_rel, float(rel.max()))
                else:
                    ok = np.array_equal(x, y)
                if not ok:
                    raise AssertionError(f"{ctx} {ga.tenant} {name}[{i}]: the "
                                         f"scheduler route disagrees with the "
                                         f"direct route")
            n_fams += 1
        n_series += ga.registry.active_series
        pa = ga.processors["span-metrics"]
        pb = gb.processors["span-metrics"]
        with ga.registry.state_lock:
            slots = pa._sketch_slots()
            rows = [pa._rows(slots, r).cpu() for r in (_DD_COUNTS, _DD_ZEROS)]
        with gb.registry.state_lock:
            twin = [pb._rows(slots, r).cpu() for r in (_DD_COUNTS, _DD_ZEROS)]
        if not all(bool((x == y).all()) for x, y in zip(rows, twin)):
            raise AssertionError(f"{ctx} {ga.tenant}: DDSketch rows differ")
    return n_fams, n_series, max_rel


def _merged_window(proc, rows, bucket, seed):
    """A packed [4, bucket] window like the coalescer's: `rows` spans on
    the processor's active series (a few at zero duration), lognormal
    durations around 24 ms, sizes 200-2,000, weights 1-3, pad rows -1."""
    rng = np.random.default_rng(seed)
    live = proc.calls.table.active_slots()
    mat = np.zeros((4, bucket), np.float32)
    mat[0] = -1.0
    mat[0, :rows] = rng.choice(live, rows)
    mat[1, :rows] = rng.lognormal(np.log(0.024), 1.5, rows)
    mat[1, :8] = 0.0
    mat[2, :rows] = rng.integers(200, 2001, rows)
    mat[3, :rows] = rng.integers(1, 4, rows)
    return mat


class _Later:
    """A reading that a later process takes: it formats as a token that
    `main()` replaces in the output once `_resolve_later` has the value
    (each K1 window's device time, phase 15's profiles)."""

    def __init__(self, key):
        self.key = key

    def __format__(self, spec):
        return f"@@{self.key}@@"

    __str__ = __repr__ = lambda self: self.__format__("")


_K1_JOBS: list = []        # saved K1 windows whose device time is pending
_LATER: dict = {}          # token key -> its text, once resolved


def _k1_device_job(ctx, arenas, tables, mat, skw, shift):
    """Save a K1 window (the packed spans, the tables, the arenas' shapes
    and the step's parameters) for `k1_device_times`; returns the
    pending (device ms, device ms with the copy, device events)."""
    d = os.path.join(ROOT, "build", f"k1-jobs-{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    n = len(_K1_JOBS)
    meta = {"ctx": ctx, "shift": shift,
            "shapes": [list(a.shape) for a in arenas],
            "dtypes": [str(a.dtype).split(".")[-1] for a in arenas],
            "skw": {k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in skw.items()}}
    path = os.path.join(d, f"{n}.npz")
    np.savez(path, mat=mat, tables=tables.cpu().numpy(),
             meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    _K1_JOBS.append(path)
    return (_Later(f"k1-{n}-device"), _Later(f"k1-{n}-dispatch"),
            _Later(f"k1-{n}-events"))


def k1_device_times(paths) -> dict:
    """Each saved K1 window's device time, torch.profiler in this
    process: the dispatch as the scheduler makes it (the window's copy to
    the card, then K1), K1's own events (the span pass, and the fold
    under compact state, with the persistent scratch it needs) and every
    event, on zero arenas of the window's shapes (K1's work does not
    depend on the values it adds to)."""
    import torch

    from tempo_tpu_torch.ops import pages as op

    out = {}
    for n, path in enumerate(paths):
        with np.load(path) as z:
            mat, tables = z["mat"], torch.from_numpy(z["tables"]).cuda()
            meta = json.loads(bytes(z["meta"]).decode())
        skw = dict(meta["skw"], edges=tuple(meta["skw"]["edges"]))
        if skw.get("mom_meta") is not None:
            skw["mom_meta"] = tuple(skw["mom_meta"])
        arenas = [torch.zeros(shape, dtype=getattr(torch, dt), device="cuda")
                  for shape, dt in zip(meta["shapes"], meta["dtypes"])]
        shift = meta["shift"]
        if skw.get("compact"):
            from tempo_tpu_torch.ops import cuda_kernels as ck

            skw["scratch"] = ck.compact_scratch(
                tables, arenas, page_rows=1 << shift, edges=skw["edges"],
                dd_rows=skw["dd_rows"])

        def dispatch():
            op.fused_step(arenas, tables, torch.from_numpy(mat).to("cuda"),
                          page_shift=shift, **skw)

        events = {}
        disp = _device_ms(dispatch, events)
        split = {part: sum(t for name, t in events.items()
                           if f"pfu_{part}_kernel" in name)
                 for part in ("span", "fold")}
        out[f"k1-{n}-device"] = sum(split.values()) or None
        out[f"k1-{n}-span"] = split["span"] or None
        out[f"k1-{n}-fold"] = split["fold"] or None
        out[f"k1-{n}-memsets"] = [k for k in events if "emset" in k]
        out[f"k1-{n}-dispatch"] = disp
        out[f"k1-{n}-events"] = {k: round(v, 6) for k, v in events.items()}
        out[f"k1-{n}-ctx"] = meta["ctx"]
        del arenas
        torch.cuda.empty_cache()
    return out


def _fmt_later(v) -> str:
    if v is None:
        return "not measured"
    if isinstance(v, float):
        return f"{v:.6f}" if v < 0.01 else f"{v:.4f}"
    return json.dumps(v) if isinstance(v, (dict, list)) else str(v)


_PHASE18_PROFILES: list = []   # set when phase 18 ran: its profiles are due


def _resolve_later(phase15: bool) -> None:
    """Run `chip_smoke.py --final-profiles` in a process of its own: every
    saved K1 window's device time and, with `phase15`, phase 15's
    profiles; their tokens' texts go to `_LATER`, and one line a window
    is printed."""
    if not _K1_JOBS and not phase15 and not _PHASE18_PROFILES:
        return
    listing = os.path.join(ROOT, "build", f"k1-jobs-{os.getpid()}.json")
    os.makedirs(os.path.dirname(listing), exist_ok=True)
    with open(listing, "w") as f:
        json.dump({"k1": _K1_JOBS, "phase15": phase15,
                   "phase18": bool(_PHASE18_PROFILES)}, f)
    got = _profiles_in_child("the final profiles", "--final-profiles",
                             listing)
    os.remove(listing)
    for path in _K1_JOBS:
        os.remove(path)
    _LATER.update({k: _fmt_later(v) for k, v in got.items()})
    for n in range(len(_K1_JOBS)):
        if got[f"k1-{n}-memsets"]:
            raise AssertionError(f"{got[f'k1-{n}-ctx']}: K1 runs memsets "
                                 f"{got[f'k1-{n}-memsets']}")
        print(f"K1 device time, its own process: {got[f'k1-{n}-ctx']}: K1 "
              f"{_LATER[f'k1-{n}-device']} ms, with the window's copy "
              f"{_LATER[f'k1-{n}-dispatch']} ms")


def final_profiles(listing) -> dict:
    with open(listing) as f:
        want = json.load(f)
    out = k1_device_times(want["k1"])
    if want["phase15"]:
        out.update(phase15_profiles())
    if want.get("phase18"):
        out.update({f"p18-{k}": v for k, v in phase18_profiles().items()})
    return out


def _k1_on_window(proc, mat, ctx, operands=None):
    """K1 at a merged window's shape on a copy of the processor's state
    (or of `operands`, one mesh shard's (arenas, tables, page rows)):
    held against its plain version on the card, timed through the main
    path's call (`ops.pages.fused_step`, the window already on the card)
    and as the scheduler's dispatch makes it (host matrix → card, then
    K1), with device times from torch.profiler and its bound."""
    import torch

    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.ops import pages as op

    skw = proc._step_kw
    with proc.registry.state_lock:
        if operands is not None:
            arenas, tables, pr = operands
            tables = tables.clone()
        elif proc._paged:
            planes = proc._paged_planes()
            arenas = tuple(p.data for p in planes)
            tables = proc._stacked_tables(planes).clone()
            pr = proc._pool.page_rows
        else:
            arenas, tables = proc._dense_arenas, proc._dense_tables
            pr = proc.registry.dense_page_rows
        base = [a.clone() for a in arenas]
    shift = pr.bit_length() - 1
    k_ar = [a.clone() for a in base]
    p_ar = [a.clone() for a in base]
    b = torch.from_numpy(mat).cuda()
    kw = dict(skw, page_rows=pr)
    op.fused_step(k_ar, tables, b, page_shift=shift, **skw)
    ck.paged_fused_update_plain(tables, b[0], b[1:4], p_ar, **kw)
    torch.cuda.synchronize()
    # a batch with no duration at or below the sketch's minimum leaves the
    # DDSketch zeros alone (both versions; equality is still held)
    live = mat[0] >= 0
    idle = (5,) if skw["dd_rows"] and not (
        mat[1][live & (mat[0] < skw["dd_rows"])] <= skw["min_value"]).any() \
        else ()
    # a window whose every series lies past the sketch planes (new series
    # of a tenant that already holds more than their rows) touches neither
    if skw["dd_rows"] and not (live & (mat[0] < skw["dd_rows"])).any():
        idle += (6,)
    mom = {}
    if skw.get("mom_rows"):
        mom = {len(base) - 1: _moments_ok}
        if not (live & (mat[0] < skw["mom_rows"])).any():
            idle += (len(base) - 1,)
    # a window of pushes without span sizes (the dict route's
    # `push_spans`) adds nothing to the size counter, role 3
    if not mat[2][live].any():
        idle += (3,)
    max_abs = _check_planes(k_ar, p_ar, base, (1, 3), mom, ctx, page_rows=pr,
                            idle_roles=idle)

    def k1():
        op.fused_step(k_ar, tables, b, page_shift=shift, **skw)

    def dispatch():
        op.fused_step(k_ar, tables, torch.from_numpy(mat).to("cuda"),
                      page_shift=shift, **skw)

    ms = cuda_time_ms(k1, N_TIMED)
    dispatch_ms = cuda_time_ms(dispatch, N_TIMED)
    plain_ms = cuda_time_ms(lambda: ck.paged_fused_update_plain(
        tables, b[0], b[1:4], p_ar, **kw), N_TIMED)
    # K1's device time at this window comes from a process of its own
    # (`k1_device_times`): read here, after other phases' profiles, the
    # trace loses events
    device_ms, dispatch_device_ms, events = _k1_device_job(
        ctx, arenas, tables, mat, skw, shift)
    gamma, minv, nb = _dd_meta()
    nbytes = bound_bytes(mat, tables.cpu().numpy(), dd_rows=skw["dd_rows"],
                         nb=nb, edges=skw["edges"], page_shift=shift)
    rows = int((mat[0] >= 0).sum())
    bound_ms, bound_by = bound(nbytes, rows * (40 + len(skw["edges"])))
    del k_ar, p_ar, base
    torch.cuda.empty_cache()
    return dict(max_abs=max_abs, ms=ms, dispatch_ms=dispatch_ms,
                plain_ms=plain_ms, device_ms=device_ms,
                dispatch_device_ms=dispatch_device_ms, events=events,
                bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes)


def _far_window_collect(pool, traffic, now):
    """A tenant on a scheduler with a far window (60 s): two pushes stay
    queued until `collect_and_push`, whose drain flushes them; the
    remote-written calls total is every weighted span pushed."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch import sched
    from tempo_tpu_torch.generator.remote_write import (LocalReceiver,
                                                        RemoteWriteConfig,
                                                        decode_write_request)
    from tempo_tpu_torch.registry import pages

    sc = sched.configure(sched.SchedConfig(batch_window_ms=60_000.0))
    try:
        with LocalReceiver() as rx:
            with pages.use(pool):
                g = tt.GeneratorInstance("far", tt.GeneratorConfig(
                    remote_write=RemoteWriteConfig(url=f"{rx.url}/far")),
                    now=lambda: now, device="cuda")
            want = 0.0
            for data, size, w in traffic[0][:2]:
                sb = tt.otlp_proto_to_batch(
                    data, tt.SpanBatchBuilder(g.registry.interner))
                g.push_batch(sb, sample_weights=w[:sb.n])
                want += float(w[:sb.n].sum())
            queued = sc.pending()
            n = g.collect_and_push()
            left = sc.pending()
            body = decode_write_request(rx.bodies["/far"])
        total = sum(v[0] for k, v in body.items()
                    if dict(k)["__name__"] == "traces_spanmetrics_calls_total")
        if queued != 2 or left != 0 or total != want:
            raise AssertionError(f"far window: {queued} queued before the "
                                 f"collection (want 2), {left} after (want "
                                 f"0), calls total {total} (want {want})")
        return n, total
    finally:
        sched.configure(sched.SchedConfig())


def _latency_ms(before, after):
    """(p50, p99) in ms of the ingest-visible latency histogram's
    observations between two snapshots of one series."""
    from tempo_tpu_torch.obs import devtime

    counts = [b - a for a, b in zip(
        before["buckets"] if before else [0] * len(after["buckets"]),
        after["buckets"])]
    edges = devtime.INGEST_LATENCY.edges
    return tuple(devtime.quantile_from_counts(edges, counts, q) * 1e3
                 for q in (0.5, 0.99))


def _sched_counts(sc):
    """(K1 launches, merged dispatches, pushes dispatched, mean occupancy,
    {ledger key: cell}) of the span-metrics kernel so far."""
    from tempo_tpu_torch.obs import devtime
    from tempo_tpu_torch.ops import cuda_kernels as ck

    return (ck.paged_fused_update.launches,
            sc.batches_total.get(SCHED_KERNEL, 0),
            sc.coalesced_total.get(SCHED_KERNEL, 0),
            sc.mean_occupancy(SCHED_KERNEL),
            {k: c for k, c in devtime.LEDGER.snapshot().items()
             if k[0] == SCHED_KERNEL})


def phase_default_deployment(paged, card):
    """Phase 6: the reference's default deployment on the card, through
    the device scheduler (default `SchedConfig`) and through direct-route
    twins, on dense (`paged` False) or paged state. Returns a result dict
    with K1's kernel entry on this route."""
    import torch

    from tempo_tpu_torch import sched
    from tempo_tpu_torch.obs import devtime
    from tempo_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    layout = "paged" if paged else "dense"
    now = time.time()
    traffic = _tree_traffic(int(now * 1e9), n_pushes=N_PHASE6_PUSHES)
    sched.reset()
    sc = sched.configure(sched.SchedConfig())
    if sc._worker is None or not sc.cfg.enabled or sc.cfg.pipeline_depth != 2:
        raise AssertionError(f"phase 6: scheduler {sc.cfg}")
    clock_s, clock_d = [now], [now]
    s_insts, s_batches = _tree_set(traffic, clock_s, paged, True)
    d_insts, d_batches = _tree_set(traffic, clock_d, paged, False)
    emits = _timed_emits(s_insts)
    jobs = []
    submit = sc.submit_rows
    sc.submit_rows = lambda *a, **k: jobs.append(submit(*a, **k)) or jobs[-1]
    ck.reset_launch_counts()
    plans0 = ck.paged_fused_update.plans
    lat0 = devtime.INGEST_LATENCY.snapshot((SCHED_KERNEL,))
    try:
        sched_s = _drive(s_insts, s_batches)
        _expire_all(s_insts, clock_s)
        sched_counts = _sched_counts(sc)
        lat = _latency_ms(lat0, devtime.INGEST_LATENCY.snapshot(
            (SCHED_KERNEL,)))
        plans = ck.paged_fused_update.plans - plans0
        # a tenant on a 60 s window: its pushes wait for the collection's
        # flush, which dispatches them as one merged window
        n_far, far_total = _far_window_collect(
            s_insts[0].registry.pages, traffic, clock_s[0])
    finally:
        del sc.submit_rows
    launches, batches, coalesced, occupancy, cells = sched_counts
    wall_ns = sum(c["wall_ns"] for c in cells.values())
    rows = sum(c["rows"] for c in cells.values())
    # the bucket that carried the most rows, and its mean rows a window
    top = max(cells, key=lambda k: cells[k]["rows"])
    top_bucket = top[1]
    top_rows = cells[top]["rows"] // cells[top]["batches"]
    all_launches, all_batches, all_coalesced, _, _ = _sched_counts(sc)
    shed, errors = sum(sc.shed_total.values()), sc.dispatch_errors
    failed = [j.error for j in jobs if j.error is not None]
    ck.reset_launch_counts()
    direct_s = _drive(d_insts, d_batches)
    _expire_all(d_insts, clock_d)
    direct_launches = ck.paged_fused_update.launches
    n_fams, n_series, max_rel = _compare_sets(s_insts, d_insts, layout)
    n_pushes = N_TENANTS * N_PHASE6_PUSHES
    spans = n_pushes * N_TREE_SPANS
    print(f"phase 6 {layout} [{card}]: {N_TENANTS} tenants x "
          f"{N_PHASE6_PUSHES} pushes of {N_TREE_SPANS} trace-tree spans "
          f"({spans} spans) from {N_PRODUCERS} producer threads: scheduler "
          f"route {spans / sched_s:.0f} spans/s ({sched_s:.3f} s), direct "
          f"route {spans / direct_s:.0f} spans/s ({direct_s:.3f} s); "
          f"{batches} merged dispatches of {coalesced} pushes "
          f"({coalesced / max(batches, 1):.3f} pushes per dispatch), mean "
          f"occupancy {occupancy:.4f}, the bucket with the most rows "
          f"{top_bucket} ({top_rows} rows a window); "
          f"devtime ledger host wall per dispatch "
          f"{wall_ns / max(batches, 1) / 1e6:.4f} ms ({rows} rows); "
          f"ingest-visible latency a push (enqueue to its dispatch call "
          f"returned, host clock) p50 {lat[0]:.3f} ms, p99 {lat[1]:.3f} "
          f"ms; K1 "
          f"launches {launches} (direct route {direct_launches}), launch "
          f"plans built {plans} for {N_TENANTS} processors; shed {shed}, "
          f"dispatch errors {errors}, job errors {len(failed)}")
    print(f"phase 6 {layout} checks: a tenant on a 60 s window kept its 2 "
          f"pushes queued until collect_and_push flushed them as one "
          f"dispatch: {n_far} samples, calls total {far_total}; the phase's "
          f"scheduler: {all_coalesced} pushes in {all_batches} merged "
          f"dispatches, {all_launches} K1 launches")
    if not all_coalesced > all_batches:
        raise AssertionError(f"phase 6 {layout}: no coalescing "
                             f"({all_coalesced} pushes in {all_batches} "
                             f"dispatches)")
    if launches != batches or all_launches != all_batches:
        raise AssertionError(f"phase 6 {layout}: K1 launched {launches} / "
                             f"{all_launches} times for {batches} / "
                             f"{all_batches} merged dispatches")
    if plans != N_TENANTS:
        raise AssertionError(f"phase 6 {layout}: {plans} K1 launch plans for "
                             f"{N_TENANTS} span-metrics processors")
    if shed or errors or failed or all_coalesced != len(jobs):
        raise AssertionError(f"phase 6 {layout}: shed {shed}, dispatch errors "
                             f"{errors}, job errors {failed[:3]}, "
                             f"{all_coalesced} of {len(jobs)} jobs dispatched")
    if direct_launches != n_pushes + N_TENANTS:
        raise AssertionError(f"phase 6 {layout}: the direct route launched K1 "
                             f"{direct_launches} times for "
                             f"{n_pushes + N_TENANTS} pushes")
    virtual = sum(g.processors["service-graphs"].expired for g in s_insts)
    print(f"phase 6 {layout} checks: {n_fams} families of {n_series} series "
          f"over {N_TENANTS} tenants equal between the scheduler route and "
          f"its direct twins (counts and buckets exact, sums within rtol 1e-5, "
          f"max relative {max_rel:.3g}), DDSketch rows exact; "
          f"{virtual} expired half-edges; K1 launches == merged dispatches; "
          f"one launch plan per processor")
    proc = s_insts[0].processors["span-metrics"]
    mat = _merged_window(proc, top_rows, top_bucket,
                         SEED + 60 + paged)
    k1 = _k1_on_window(proc, mat, f"phase 6 {layout} merged window")
    sg = s_insts[0].processors["service-graphs"]
    edges = emits["last"]
    sg_events = {}
    sg_device_ms = _device_ms(lambda: emits["inner"](edges), sg_events)
    print(f"phase 6 {layout} [{card}]: K1 at a merged window of "
          f"{int((mat[0] >= 0).sum())} spans in a {top_bucket} bucket: "
          f"{spread(k1['ms'])} with the host (window on the card), "
          f"{spread(k1['dispatch_ms'])} as the scheduler dispatches it (host "
          f"matrix to the card, then K1); device time per merged dispatch "
          f"(torch.profiler) K1 {k1['device_ms']} ms, with the copy "
          f"{k1['dispatch_device_ms']} ms ({k1['events']}); plain "
          f"version {k1['plain_ms'][1]:.4f} ms; bound {k1['bound_ms']:.6f} ms "
          f"by {k1['bound_by']}; max abs err against the plain version "
          f"{k1['max_abs']}")
    print(f"phase 6 {layout} [{card}]: service-graphs emit: "
          f"{emits['s'] / (n_pushes + N_TENANTS) * 1e3:.4f} ms of host a push "
          f"({emits['calls']} emits of {emits['edges']} edges, "
          f"{emits['s']:.3f} s in all, no synchronisation); device time of "
          f"one emit of {len(edges)} edges (torch.profiler, every device "
          f"event) {sg_device_ms} ms")
    sched.reset()
    del s_insts, d_insts, s_batches, d_batches, proc, sg
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"phase 6 {layout}: {secs:.1f} s")
    return {
        "name": f"paged_fused_update (scheduler route, merged windows, "
                f"{layout} state, sketch dd, f32)", "route": "cuda",
        "source": "tempo_tpu_torch/csrc/paged_fused_update.cu",
        "replaces": "tempo_tpu/ops/pallas_kernels.py:196",
        "launches": launches, "max_abs_err": k1["max_abs"],
        "ms": k1["ms"][1], "plain_ms": k1["plain_ms"][1],
        "device_ms": k1["device_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "sched_spans_per_s": spans / sched_s,
        "direct_spans_per_s": spans / direct_s, "seconds": secs,
    }


# ---------------------------------------------------------------------------
# phase 7: the staged main path (C++ staging, the native resolve, pipeline)
# ---------------------------------------------------------------------------


def _fast_inst(device, paged, now, name="staged"):
    """A span-metrics-only instance of the default config (eligible for
    the staged fast route) on `device`, on its own pool of the default
    config when `paged`, else on dense state."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.registry import pages

    pool = pages.PagePool(tt.PagePoolConfig(enabled=True), device=device) \
        if paged else None
    with pages.use(pool):
        g = tt.GeneratorInstance(name, tt.GeneratorConfig(
            processors=("span-metrics",)), now=lambda: now, device=device)
    if g.state_layout != ("paged" if paged else "dense") or \
            g._fast_spanmetrics() is None:
        raise AssertionError(f"{name}: {g.state_layout} state, fast route "
                             f"{g._fast_spanmetrics()}")
    return g


def _staged_push_all(inst, payloads, weights):
    """Every payload from wire bytes: `stage_otlp` (span attributes
    skipped, as the default config reads none) → `StagedIngest` with its
    sample weights → `push_staged_view` of the full view. Returns
    (seconds until every push has landed: the drain and, on the card, a
    synchronize; staging seconds)."""
    import torch

    import tempo_tpu_torch as tt

    t0 = time.perf_counter()
    stage_s = 0.0
    for data, w in zip(payloads, weights):
        ts = time.perf_counter()
        st = tt.stage_otlp(data, inst.registry.interner,
                           include_span_attrs=False)
        stage_s += time.perf_counter() - ts
        st.sample_weight = w[:st.n]
        if inst.push_staged_view(st.view()) != st.n:
            raise AssertionError(f"{inst.tenant}: push_staged_view refused")
    inst.drain()
    if inst.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, stage_s


def _timed_resolve():
    """Wrap `native.spanmetrics_resolve` to sum its seconds and calls;
    returns (the sums, the original to restore)."""
    from tempo_tpu_torch import native

    acc = {"s": 0.0, "calls": 0}
    inner = native.spanmetrics_resolve

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        acc["s"] += time.perf_counter() - t0
        acc["calls"] += 1
        return out

    native.spanmetrics_resolve = timed
    return acc, inner


def _same_dd_quantiles(card, host, ctx):
    qa = card.processors["span-metrics"].dd_quantiles((0.5, 0.99))
    qb = host.processors["span-metrics"].dd_quantiles((0.5, 0.99))
    for q, a, b in zip((0.5, 0.99), qa, qb):
        if a != b or not a:
            bad = sum(a.get(k) != b.get(k) for k in a.keys() | b.keys())
            raise AssertionError(f"{ctx}: DDSketch q{q}: {bad} series differ")
    return len(qa[0])


def phase_staged_fast(paged, card):
    """Phase 7a on `paged` (else dense) state: the fast route on the
    direct route and under the default scheduler, each on the card
    against a CPU twin; then K1 at the direct route's last push. Returns
    a result dict with K1's kernel entry."""
    import torch

    from tempo_tpu_torch import native, sched
    from tempo_tpu_torch.ops import cuda_kernels as ck

    layout = "paged" if paged else "dense"
    now = time.time()
    payloads, _, int_w, _ = _payloads(now, N_7A_PUSHES)
    spans = N_7A_PUSHES * N_SPANS
    runs, k1 = {}, None
    for route in ("direct", "sched"):
        ctx = f"phase 7a {layout} {route}"
        sched.reset()
        sc = sched.configure(sched.SchedConfig()) if route == "sched" \
            else None
        if sc is not None and sc.cfg.pipeline_depth != 2:
            raise AssertionError(f"{ctx}: scheduler {sc.cfg}")
        g = _fast_inst("cuda", paged, now)
        twin = _fast_inst("cpu", paged, now)
        proc = g.processors["span-metrics"]
        mats = []
        inner_dispatch = proc._dispatch_packed
        proc._dispatch_packed = lambda mat: (mats.append(mat.copy()),
                                             inner_dispatch(mat))[1]
        acc, inner_resolve = _timed_resolve()
        b0 = sc.batches_total.get(SCHED_KERNEL, 0) if sc else 0
        ck.reset_launch_counts()
        plans0 = ck.paged_fused_update.plans
        try:
            # cold: every series new; warm: the same payloads again
            secs, stage_s = _staged_push_all(g, payloads, int_w)
            warm_s, warm_stage_s = _staged_push_all(g, payloads, int_w)
            launches = ck.paged_fused_update.launches
            plans = ck.paged_fused_update.plans - plans0
        finally:
            native.spanmetrics_resolve = inner_resolve
            del proc._dispatch_packed
        dispatches = (sc.batches_total.get(SCHED_KERNEL, 0) - b0) if sc \
            else len(mats)
        resolve_s, n_resolve = acc["s"], acc["calls"]
        for _ in range(2):
            _staged_push_all(twin, payloads, int_w)
        n_fams, n_series, max_rel = _compare_sets([g], [twin], ctx)
        n_q = _same_dd_quantiles(g, twin, ctx)
        want = 2.0 * float(sum(w.sum() for w in int_w))
        with g.registry.state_lock:
            (calls,) = proc.calls._snap()
        total = float(calls[proc.calls.table.active_slots()].sum())
        pipe = proc._pipe
        if total != want:
            raise AssertionError(f"{ctx}: calls total {total} != {want}")
        pushes = 2 * N_7A_PUSHES
        if n_resolve != pushes:
            raise AssertionError(f"{ctx}: {n_resolve} resolves")
        if launches != dispatches or plans != 1 or \
                (route == "direct" and launches != pushes):
            raise AssertionError(f"{ctx}: K1 launched {launches} times for "
                                 f"{dispatches} dispatches of {pushes} "
                                 f"pushes, {plans} plans")
        if (route == "sched") != (pipe is not None) or \
                (pipe is not None and (pipe.reuse_total < 1
                                       or pipe.in_flight())):
            raise AssertionError(f"{ctx}: pipeline {pipe and vars(pipe)}")
        runs[route] = dict(
            spans_per_s=spans / secs, secs=secs,
            warm_spans_per_s=spans / warm_s,
            stage_s=(stage_s + warm_stage_s) / pushes,
            resolve_s=resolve_s / n_resolve, launches=launches,
            dispatches=dispatches,
            pipe=None if pipe is None else dict(
                submitted=pipe.submitted_total, reuse=pipe.reuse_total,
                alloc=pipe.alloc_total, overlap=pipe.overlap_ratio(),
                stall_s=pipe.stall_ns / 1e9, decode_s=pipe.decode_ns / 1e9))
        print(f"phase 7a {layout} {route} [{card}]: {N_7A_PUSHES} payloads "
              f"of {N_SPANS} spans from wire bytes in {secs:.3f} s "
              f"({spans / secs:.0f} spans/s, every series new), again in "
              f"{warm_s:.3f} s ({spans / warm_s:.0f} spans/s, every series "
              f"known): staging "
              f"{(stage_s + warm_stage_s) / pushes * 1e3:.3f} ms a payload "
              f"(stage_otlp), "
              f"resolve {resolve_s / n_resolve * 1e3:.3f} ms a push "
              f"(native.spanmetrics_resolve); {n_series} series; K1 launches "
              f"{launches} for {dispatches} dispatches, {plans} launch plan"
              + ("" if pipe is None else
                 f"; pipeline: {pipe.submitted_total} batches, buffer sets "
                 f"reused {pipe.reuse_total} / fresh {pipe.alloc_total}, "
                 f"decode {pipe.decode_ns / 1e9:.4f} s, overlap ratio "
                 f"{pipe.overlap_ratio():.4f}, stall "
                 f"{pipe.stall_ns / 1e9:.4f} s"))
        print(f"phase 7a {layout} {route} checks: {n_fams} families of "
              f"{n_series} series equal the CPU twin's (counts and buckets "
              f"exact, sums within rtol 1e-5, max relative {max_rel:.3g}), "
              f"DDSketch rows and q50/q99 of {n_q} series exact; calls total "
              f"{total} (weighted spans {want})")
        if route == "direct":
            k1 = _k1_on_window(proc, mats[-1], f"{ctx} push")
        sched.reset()
        del g, twin, proc, mats
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 7a {layout} [{card}]: K1 at a staged push of "
          f"{N_SPANS} spans: {spread(k1['ms'])} with the host (batch on the "
          f"card), {spread(k1['dispatch_ms'])} as the direct route makes it "
          f"(host matrix to the card, then K1); device time (torch.profiler) "
          f"K1 {k1['device_ms']} ms, with the copy {k1['dispatch_device_ms']} "
          f"ms; plain version {k1['plain_ms'][1]:.4f} ms; bound "
          f"{k1['bound_ms']:.6f} ms by {k1['bound_by']}; max abs err against "
          f"the plain version {k1['max_abs']}")
    return {
        "name": f"paged_fused_update (staged fast route, {layout} state, "
                f"sketch dd, f32)", "route": "cuda",
        "source": "tempo_tpu_torch/csrc/paged_fused_update.cu",
        "replaces": "tempo_tpu/ops/pallas_kernels.py:196",
        "launches": runs["direct"]["launches"], "max_abs_err": k1["max_abs"],
        "ms": k1["ms"][1], "plain_ms": k1["plain_ms"][1],
        "device_ms": k1["device_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None, "runs": runs,
    }


def phase_recs_route(card):
    """Phase 7b: `push_otlp_recs` with scan records, whole and a sharded
    third, against the payload route (`push_otlp_staged`, of the payload
    and of `slice_otlp_payload` of the third), on the card, dense state,
    direct route. Returns {route: spans/s from wire bytes}."""
    import torch

    from tempo_tpu_torch import native, sched
    from tempo_tpu_torch.model.otlp import slice_otlp_payload
    from tempo_tpu_torch.ops import cuda_kernels as ck

    sched.reset()
    now = time.time()
    payloads = _payloads(now, N_MAIN_PUSHES)[0]
    recs = [native.otlp_scan(d) for d in payloads]
    picks = [np.flatnonzero(np.arange(len(r)) % 3 == 0) for r in recs]
    sliced = [slice_otlp_payload(d, r, p.tolist())
              for d, r, p in zip(payloads, recs, picks)]
    out = {}

    def timed(g, push):
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        n = sum(push(g, k) for k in range(len(payloads)))
        g.drain()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if ck.paged_fused_update.launches != len(payloads):
            raise AssertionError(f"phase 7b: K1 launched "
                                 f"{ck.paged_fused_update.launches} times "
                                 f"for {len(payloads)} pushes")
        return n, secs

    for sharded in (False, True):
        ctx = f"phase 7b {'sharded' if sharded else 'whole'}"
        ga, gb = (_fast_inst("cuda", False, now, name) for name in
                  ("recs", "payload"))
        na, sa = timed(ga, lambda g, k: g.push_otlp_recs(
            payloads[k], native.otlp_scan(payloads[k])[picks[k]] if sharded
            else native.otlp_scan(payloads[k])))
        nb, sb = timed(gb, lambda g, k: g.push_otlp_staged(
            sliced[k] if sharded else payloads[k]))
        if na != nb or na != sum(len(p) if sharded else len(r)
                                 for p, r in zip(picks, recs)):
            raise AssertionError(f"{ctx}: {na} / {nb} spans")
        # the two routes intern the payload's strings in different orders
        n_fams, n_series, max_rel = _compare_by_labels(ga, gb, ctx)
        n_q = _same_dd_quantiles(ga, gb, ctx)
        key = "sharded" if sharded else "whole"
        out[f"recs_{key}"], out[f"payload_{key}"] = na / sa, nb / sb
        print(f"{ctx} [{card}]: {na} spans from wire bytes: recs route "
              f"(otlp_scan + push_otlp_recs) {na / sa:.0f} spans/s, payload "
              f"route (push_otlp_staged{' of the sliced payload' if sharded else ''}) "
              f"{nb / sb:.0f} spans/s; {n_fams} families and the DDSketch "
              f"rows of {n_series} series equal by label set (counts exact, "
              f"sums within rtol 1e-5, max relative {max_rel:.3g}), DDSketch "
              f"q50/q99 of {n_q} series exact")
        del ga, gb
        gc.collect()
    torch.cuda.empty_cache()
    return out


def _family_rows(insts):
    """Every registry family's rows by label set, summed over `insts`
    (each tenant's instances on the generator ring)."""
    out = {}
    for inst in insts:
        for name, fam in inst.registry._metrics.items():
            with inst.registry.state_lock:
                snap = [np.asarray(x) for x in fam._snap()]
            rows = out.setdefault(name, {})
            for s in fam.table.active_slots().tolist():
                key = fam.labels_of(s)
                vals = [x[s].astype(np.float64) for x in snap]
                if key in rows:
                    vals = [a + b for a, b in zip(rows[key], vals)]
                rows[key] = vals
    return out


def _compare_rows(got, want, ctx, rtol=1e-5, hist_rtol=None):
    """Family rows by label set: counts and buckets exact, sums (a
    histogram's sums, the size counter) within `rtol` (0: exact; a
    histogram's sums within `hist_rtol` when given). Returns (series of
    the largest family, max relative sum error)."""
    max_rel, n = 0.0, 0
    if got.keys() != want.keys():
        raise AssertionError(f"{ctx}: families {sorted(got)} vs "
                             f"{sorted(want)}")
    for name, rows in got.items():
        if rows.keys() != want[name].keys():
            raise AssertionError(f"{ctx} {name}: label sets differ "
                                 f"({len(rows)} / {len(want[name])})")
        for key, xs in rows.items():
            for i, (x, y) in enumerate(zip(xs, want[name][key], strict=True)):
                is_hist = len(xs) == 3 and i == 1
                if name == "traces_spanmetrics_size_total" or is_hist:
                    max_rel = max(max_rel, float(np.max(
                        np.abs(x - y) / np.maximum(np.abs(y), 1e-30))))
                    tol = hist_rtol if is_hist and hist_rtol else rtol
                    ok = np.allclose(x, y, rtol=tol, atol=1e-6) if tol \
                        else np.array_equal(x, y)
                else:
                    ok = np.array_equal(x, y)
                if not ok:
                    raise AssertionError(f"{ctx} {name} {key}[{i}]: {x} vs "
                                         f"{y}")
        n = max(n, len(rows))
    return n, max_rel


def _compare_by_labels(ga, gb, ctx, rtol=1e-5, prefix=""):
    """Two instances whose interners gave out ids in different orders:
    every family's rows (those whose name starts with `prefix`) and the
    DDSketch rows compared series by series through the label sets,
    counts and buckets exact, sums (a histogram's sums, the size counter)
    at `rtol` (0: exact). Returns (families, series, max relative sum
    error)."""
    return _compare_states(_label_state(ga, prefix),
                           _label_state(gb, prefix), ctx, rtol)


def _label_state(g, prefix=""):
    """(every family's rows whose name starts with `prefix`, the DDSketch
    rows) of an instance by label set, for `_compare_states`."""
    from tempo_tpu_torch.generator.processors.spanmetrics import (_DD_COUNTS,
                                                                  _DD_ZEROS)

    proc = g.processors["span-metrics"]
    with g.registry.state_lock:
        slots = proc._sketch_slots()
        rows = [proc._rows(slots, r).cpu().numpy()
                for r in (_DD_COUNTS, _DD_ZEROS)]
    dd = {proc.calls.labels_of(int(s)): (rows[0][i], rows[1][i])
          for i, s in enumerate(slots)}
    return ({k: v for k, v in _family_rows([g]).items()
             if k.startswith(prefix)}, dd)


def _compare_states(sa, sb, ctx, rtol=1e-5):
    """`_compare_by_labels` over two `_label_state`s."""
    (fa, da), (fb, db) = sa, sb
    n_series, max_rel = _compare_rows(fa, fb, ctx, rtol)
    if da.keys() != db.keys() or not all(
            np.array_equal(x, y) for k, xs in da.items()
            for x, y in zip(xs, db[k])):
        raise AssertionError(f"{ctx}: DDSketch rows differ")
    return len(fa), n_series, max_rel


def _durations_differ(payload):
    """Spans whose f32 duration differs between the C++ resolve's
    `(float)((double)(end - start) * 1e-9)` and `push_batch`'s
    `(duration_ns / 1e9).astype(float32)`."""
    from tempo_tpu_torch import native

    r = native.otlp_scan(payload)
    ns = r["end_ns"].astype(np.int64) - r["start_ns"].astype(np.int64)
    cxx = (ns.astype(np.float64) * 1e-9).astype(np.float32)
    py = (ns / 1e9).astype(np.float32)
    return int((cxx != py).sum())


def phase_staged_default(card):
    """Phase 7c: the default instance (span metrics and service graphs)
    under the default scheduler, on phase 6's trace-tree traffic of one
    tenant: staged views through `push_staged_view` (the SpanBatch route)
    against the same payloads through `otlp_proto_to_batch` + `push_batch`,
    every collected sample compared by label set. Returns spans/s."""
    import torch

    import tempo_tpu_torch as tt
    from tempo_tpu_torch import native, sched
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    sched.reset()
    sched.configure(sched.SchedConfig())
    now = time.time()
    traffic = _tree_traffic(int(now * 1e9), 1)[0]
    clock = [now]
    gs, gp = (tt.GeneratorInstance(name, tt.GeneratorConfig(),
                                   now=lambda: clock[0], device="cuda")
              for name in ("staged", "python"))
    if tuple(gs.processors) != ("span-metrics", "service-graphs") or \
            gs._fast_spanmetrics() is not None:
        raise AssertionError(f"phase 7c: processors {tuple(gs.processors)}")
    t0 = time.perf_counter()
    for data, _, w in traffic:
        st = tt.stage_otlp(data, gs.registry.interner)
        st.sample_weight = w[:st.n]
        if gs.push_staged_view(st.view()) != st.n:
            raise AssertionError("phase 7c: push_staged_view refused")
    gs.drain()
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    # the staged route's per-span sizes are the wire bytes of each span
    wire = [native.otlp_scan(data)["span_len"] for data, _, _ in traffic]
    t0 = time.perf_counter()
    for (data, _, w), span_len in zip(traffic, wire):
        sb = tt.otlp_proto_to_batch(data, tt.SpanBatchBuilder(
            gp.registry.interner))
        sizes = np.zeros(sb.capacity, np.float32)
        sizes[:sb.n] = span_len
        gp.push_batch(sb, sizes, sample_weights=w[:sb.n])
    gp.drain()
    torch.cuda.synchronize()
    python_s = time.perf_counter() - t0
    clock[0] += gs.cfg.servicegraphs.wait_s + 1.0
    gs.push_staged_view(tt.stage_otlp(encode_spans_otlp([]),
                                      gs.registry.interner).view())
    gp.push_batch(tt.otlp_proto_to_batch(encode_spans_otlp([]),
                                         tt.SpanBatchBuilder(gp.registry.interner)))
    samples = []
    for g in (gs, gp):
        g.drain()
        samples.append({(s.name, s.labels): s.value
                        for s in g.registry.collect(1)})
    a, b = samples
    if a.keys() != b.keys() or not a:
        raise AssertionError(f"phase 7c: label sets differ "
                             f"({len(a)} / {len(b)})")
    max_rel = 0.0
    for k, v in a.items():
        is_sum = k[0].endswith("_sum") or k[0] == "traces_spanmetrics_size_total"
        if is_sum:
            rel = abs(v - b[k]) / max(abs(b[k]), 1e-30)
            max_rel = max(max_rel, rel)
            ok = abs(v - b[k]) <= 1e-5 * abs(b[k]) + 1e-6
        else:
            ok = v == b[k]
        if not ok:
            raise AssertionError(f"phase 7c {k}: staged {v} vs python {b[k]}")
    families = {k[0] for k in a}
    if not {"traces_spanmetrics_calls_total",
            "traces_service_graph_request_total"} <= families:
        raise AssertionError(f"phase 7c: families {sorted(families)}")
    spans = sum(len(w) for _, _, w in traffic)
    ulp = sum(_durations_differ(data) for data, _, _ in traffic)
    print(f"phase 7c [{card}]: default instance, {len(traffic)} trace-tree "
          f"payloads of {N_TREE_SPANS} spans under the default scheduler: "
          f"staged route (stage_otlp → push_staged_view → push_batch) "
          f"{spans / staged_s:.0f} spans/s, Python decode "
          f"(otlp_proto_to_batch → push_batch) {spans / python_s:.0f} "
          f"spans/s; {len(a)} samples of {len(families)} families equal by "
          f"label set (counts exact, sums within rtol 1e-5, max relative "
          f"{max_rel:.3g}); spans whose f32 duration differs between the C++ "
          f"resolve and push_batch (off this route): {ulp} of {spans}")
    sched.reset()
    del gs, gp
    gc.collect()
    torch.cuda.empty_cache()
    return {"staged_spans_per_s": spans / staged_s,
            "python_spans_per_s": spans / python_s}


# ---------------------------------------------------------------------------
# phase 8: the distributor main path (Distributor.push_otlp → Generator)
# ---------------------------------------------------------------------------

SM_TENANTS = ("sm-0", "sm-1")
DEFAULT_TENANTS = ("default-0", "default-1")
N_FIND = 256                     # trace ids found at each ingester check
UNLIMITED = {"rate_limit_bytes": 1 << 40, "burst_size_bytes": 1 << 40}


class _TwinIngester:
    """The CPU twins' ingesters: they take every push and keep nothing
    (the twins check the generators). They want span attributes staged,
    as real ingesters do, so the twin's distributor stages as the card's
    does."""

    staged_needs_attrs = True

    def push(self, tenant, traces):
        raise AssertionError("phase 8: the dict route reached an ingester")

    def push_otlp(self, tenant, data):
        return {}

    def push_staged(self, tenant, view):
        return {}


def _dist_rig(device, n_gen, now, patches=None, data_dir=None):
    """The distributor of the default deployment: 3 ingesters at the
    default rf=3 (real `Ingester`s, each with its own directory under
    `data_dir`; the twins' stubs without one), a generator ring of `n_gen`
    `Generator`s of the default config on `device` (dense state), 2
    span-metrics-only tenants and 2 of the default processors, every
    tenant unlimited in rate and in live traces."""
    from tempo_tpu_torch.distributor import Distributor
    from tempo_tpu_torch.generator import Generator
    from tempo_tpu_torch.ingester import Ingester
    from tempo_tpu_torch.overrides import Overrides
    from tempo_tpu_torch.ring import ACTIVE, InstanceDesc, Ring
    from tempo_tpu_torch.ring.ring import _instance_tokens

    ov = Overrides()
    for t in SM_TENANTS + DEFAULT_TENANTS:
        procs = ["span-metrics"] if t in SM_TENANTS else \
            ["span-metrics", "service-graphs"]
        ov.set_tenant_patch(t, {"generator": {"processors": procs},
                                "ingestion": dict(UNLIMITED,
                                                  max_traces_per_user=1 << 20),
                                **(patches or {}).get(t, {})})

    def ring(ids, rf):
        r = Ring(replication_factor=rf, now=lambda: now)
        for iid in ids:
            r.register(InstanceDesc(id=iid, state=ACTIVE,
                                    tokens=_instance_tokens(iid, 128),
                                    heartbeat_ts=now))
        return r

    gens = {f"generator-{k}": Generator(overrides=ov,
                                         instance_id=f"generator-{k}",
                                         now=lambda: now, device=device)
            for k in range(n_gen)}
    ings = {f"ingester-{k}": _TwinIngester() if data_dir is None else
            Ingester(os.path.join(data_dir, f"ingester-{k}"), overrides=ov,
                     now=lambda: now, instance_id=f"ingester-{k}")
            for k in range(3)}
    dist = Distributor(ring(ings, 3), ings, overrides=ov,
                       generator_ring=ring(gens, 1), generator_clients=gens,
                       now=lambda: now)
    for g in gens.values():
        for t in SM_TENANTS + DEFAULT_TENANTS:
            inst = g.instance(t)
            if inst.state_layout != "dense" or \
                    inst.registry.budget.limit != N_SERIES:
                raise AssertionError(f"phase 8: {t}: {inst.state_layout} "
                                     f"state, {inst.registry.budget.limit} "
                                     f"series")
    return dist, gens, ings


def _host_traces(payloads):
    """{trace id: spans} of OTLP payloads as the host decodes them
    (`spans_from_otlp_proto_native`), each trace's spans combined and
    sorted as an ingester's `find_trace_by_id` returns them."""
    from tempo_tpu_torch import native
    from tempo_tpu_torch.model.combine import combine_spans, sort_spans

    by: dict = {}
    for data in payloads:
        for sp in native.spans_from_otlp_proto_native(data):
            by.setdefault(sp["trace_id"], []).append(sp)
    return {t: sort_spans(combine_spans(v)) for t, v in by.items()}


def _check_ingesters(ings, host, ctx, n_find=N_FIND):
    """Every trace of `host` ({tenant: {trace id: spans}}) live on every
    ingester, no discard, and `find_trace_by_id` for `n_find` seeded ids
    (spread over the tenants) equal to the host decode. Returns the ms a
    find."""
    rng = np.random.default_rng(SEED + 9)
    picks = []
    per = max(1, n_find // len(host))
    for t, traces in host.items():
        tids = sorted(traces)
        picks += [(t, tids[int(i)]) for i in
                  rng.choice(len(tids), min(per, len(tids)), replace=False)]
    secs = 0.0
    for iid, ing in ings.items():
        for t, traces in host.items():
            inst = ing.instance(t)
            if len(inst.live) != len(traces) or inst.discarded:
                raise AssertionError(f"{ctx}: {iid} holds {len(inst.live)} "
                                     f"live traces of {t}'s {len(traces)}, "
                                     f"discarded {inst.discarded}")
        text = ing.obs.render()
        if "tempo_ingester_discarded_traces_total{" in text:
            raise AssertionError(f"{ctx}: {iid} discarded traces")
        t0 = time.perf_counter()
        got = [ing.find_trace_by_id(t, tid) for t, tid in picks]
        secs += time.perf_counter() - t0
        for (t, tid), g in zip(picks, got):
            if g != host[t][tid]:
                raise AssertionError(f"{ctx}: {iid} {t} trace {tid.hex()}: "
                                     f"find_trace_by_id differs from the "
                                     f"host decode")
    return secs / (len(ings) * len(picks)) * 1e3, len(picks)


def _settle(gens):
    """Every push landed: the scheduler flushed, the pipelines reaped, the
    card synchronised."""
    import torch

    for g in gens.values():
        for inst in g.instances.values():
            inst.drain()
        if g.device.type == "cuda":
            torch.cuda.synchronize()


def _capture_windows(proc):
    """Keep a copy of every packed [4, bucket] window the processor
    dispatches (the scheduler's merged windows)."""
    mats = []
    inner = proc._dispatch_packed
    proc._dispatch_packed = lambda mat: (mats.append(mat.copy()),
                                         inner(mat))[1]
    return mats


def _timed(obj, name, acc):
    """Wrap `obj.name` to add its seconds to `acc[name]`; returns the
    original, for `setattr(obj, name, original)`."""
    inner = getattr(obj, name)
    setattr(obj, name, _acc_wrap(inner, acc, name))
    return inner


def _dist_drive(dist, gens, traffic, ctx, acc=None,
                passes=("new", "known", "default"), after=None):
    """Every tenant's payloads through `Distributor.push_otlp`, pass by
    pass: the span-metrics tenants' in "new" (every series new) and
    "known" (every series known), the default tenants' in "default",
    payload by payload across the tenants; `after(pass)` runs once each
    pass has settled. Returns ({pass: seconds, each pass ending
    settled}, {pass: {"push": the distributor's host ms a push from its
    `push_duration` histogram, and per key of `acc` (seconds that
    wrappers add up) its ms a push}})."""
    acc = {} if acc is None else acc
    secs, ms = {}, {}
    tenants_of = {"new": SM_TENANTS, "known": SM_TENANTS,
                  "default": DEFAULT_TENANTS}
    for what in passes:
        tenants = tenants_of[what]
        h0 = dist.push_duration.snapshot() or {"sum": 0.0, "count": 0}
        a0 = dict(acc)
        t0 = time.perf_counter()
        for k in range(max(len(traffic[t]) for t in tenants)):
            for t in tenants:
                errs = dist.push_otlp(t, traffic[t][k])
                if errs:
                    raise AssertionError(f"{ctx}: {t} push {k}: {errs}")
        _settle(gens)
        secs[what] = time.perf_counter() - t0
        h1 = dist.push_duration.snapshot()
        n = h1["count"] - h0["count"]
        ms[what] = {"push": (h1["sum"] - h0["sum"]) / n * 1e3}
        ms[what].update({k: (v - a0.get(k, 0.0)) / n * 1e3
                         for k, v in acc.items()})
        if after is not None:
            after(what)
    return secs, ms


def _dist_k1_row(name, proc, mat, launches, ctx):
    k1 = _k1_on_window(proc, mat, ctx)
    return k1, {
        "name": name, "route": "cuda",
        "source": "tempo_tpu_torch/csrc/paged_fused_update.cu",
        "replaces": "tempo_tpu/ops/pallas_kernels.py:196",
        "launches": launches, "max_abs_err": k1["max_abs"],
        "ms": k1["ms"][1], "plain_ms": k1["plain_ms"][1],
        "device_ms": k1["device_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
    }


def phase_distributor(card):
    """Phase 8: the distributor main path at the default deployment's
    widths under the default scheduler, on the card against CPU twins
    (the same `Distributor` config feeding `Generator(device="cpu")`):
    8a the decode-once staged tee into one generator, 8b the columnar tee
    into two, 8c overload sampling and backpressure; the ingesters' data
    directories live under `build/` for the phase. Returns (results, K1's
    kernel entries)."""
    from tempo_tpu_torch.registry import pages

    t_phase = time.perf_counter()
    if pages.active() is not None:
        raise AssertionError("phase 8: a page pool is active")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase8-",
                                     dir=os.path.join(ROOT, "build")) as root:
        return _phase_distributor(card, root, t_phase)


def _phase_distributor(card, root, t_phase):
    import torch

    from tempo_tpu_torch import native, sched
    from tempo_tpu_torch.distributor.distributor import (REASON_BACKPRESSURE,
                                                         REASON_SAMPLED,
                                                         RateLimited)
    from tempo_tpu_torch.distributor.limiter import IngestBackpressure
    from tempo_tpu_torch.distributor.sampler import SpanSampler
    from tempo_tpu_torch.model import otlp_batch
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
    from tempo_tpu_torch.ops import cuda_kernels as ck

    sched.reset()
    sc = sched.configure(sched.SchedConfig())
    now = time.time()
    sm_payloads = _payloads(now, N_DIST_PUSHES)[0]
    trees = _tree_traffic(int(now * 1e9), len(DEFAULT_TENANTS))
    traffic = {t: sm_payloads for t in SM_TENANTS}
    traffic.update({t: [p for p, _, _ in trees[i]]
                    for i, t in enumerate(DEFAULT_TENANTS)})
    sent = {t: sum(N_SPANS if t in SM_TENANTS else N_TREE_SPANS
                   for _ in traffic[t]) * (2 if t in SM_TENANTS else 1)
            for t in traffic}
    n_sent = sum(sent.values())
    out, rows = {}, []
    host = {t: _host_traces(traffic[t]) for t in traffic}

    # -- 8a: the decode-once staged tee into one generator ---------------
    ctx = "phase 8a"
    dist, gens, ings = _dist_rig("cuda", 1, now,
                                 data_dir=os.path.join(root, "8a"))
    (g,) = gens.values()
    if any(dist._staging_plan(t, dist.overrides.for_tenant(t)) is None
           for t in traffic):
        raise AssertionError(f"{ctx}: the staged tee does not engage")
    mats = _capture_windows(g.instance("sm-0").processors["span-metrics"])
    # host time split: staging (before `push_duration` starts) and the
    # generator tee (inside it: the resolve and the scheduler submit)
    acc = {}
    inner_stage = _timed(otlp_batch, "stage_otlp", acc)
    _timed(g, "push_staged_view", acc)
    for ing in ings.values():            # the ingester leg: all three
        _timed(ing, "push_staged", acc)
    b0 = sc.batches_total.get(SCHED_KERNEL, 0)
    ck.reset_launch_counts()
    plans0 = ck.paged_fused_update.plans
    # 8b runs its span-metrics tenants one pass: their rows after 8a's
    # first pass are what 8b's must equal
    single_new = {}

    def after(what):
        if what == "new":
            single_new.update({t: _family_rows([g.instance(t)])
                               for t in SM_TENANTS})
    try:
        secs, push_ms = _dist_drive(dist, gens, traffic, ctx, acc,
                                    after=after)
    finally:
        otlp_batch.stage_otlp = inner_stage
    launches = ck.paged_fused_update.launches
    plans = ck.paged_fused_update.plans - plans0
    dispatches = sc.batches_total.get(SCHED_KERNEL, 0) - b0
    if launches != dispatches or plans != len(traffic) or not launches:
        raise AssertionError(f"{ctx}: K1 launched {launches} times for "
                             f"{dispatches} merged dispatches, {plans} "
                             f"plans for {len(traffic)} processors")
    if dist.discarded or dist.metrics.get("push_failures_total"):
        raise AssertionError(f"{ctx}: discarded {dist.discarded}, "
                             f"{dist.metrics}")
    find_ms, n_find = _check_ingesters(ings, host, ctx)
    text = dist.obs.render()
    line = f"tempo_distributor_spans_received_total {n_sent}"
    if line not in text.splitlines():
        raise AssertionError(f"{ctx}: no '{line}' in the exposition")
    twin, tgens, _ = _dist_rig("cpu", 1, now)
    _dist_drive(twin, tgens, traffic, f"{ctx} twin")
    (tg,) = tgens.values()
    n_fams = n_series = n_q = 0
    max_rel = 0.0
    single = {}
    for t in traffic:
        a, b = g.instance(t), tg.instance(t)
        if a.spans_received != sent[t] or b.spans_received != sent[t]:
            raise AssertionError(f"{ctx} {t}: {a.spans_received} / "
                                 f"{b.spans_received} of {sent[t]} spans")
        f, n, r = _compare_by_labels(a, b, f"{ctx} {t}")
        n_q += _same_dd_quantiles(a, b, f"{ctx} {t}")
        n_fams, n_series, max_rel = n_fams + f, n_series + n, max(max_rel, r)
        single[t] = _family_rows([a])
    k1, row = _dist_k1_row(
        "paged_fused_update (distributor staged tee, scheduler route, dense "
        "state, sketch dd, f32)", g.instance("sm-0").processors["span-metrics"],
        mats[-1], launches, f"{ctx} window")
    rows.append(row)
    out["8a"] = dict(secs=secs, push_ms=push_ms, launches=launches,
                     dispatches=dispatches, device_ms=k1["device_ms"],
                     find_ms=find_ms)
    spans_sm = N_DIST_PUSHES * N_SPANS * len(SM_TENANTS)
    print(f"phase 8a [{card}]: Distributor.push_otlp → staged tee → one "
          f"Generator on the card, default SchedConfig: "
          f"{len(SM_TENANTS)} span-metrics tenants x {N_DIST_PUSHES} "
          f"payloads of {N_SPANS} spans {spans_sm / secs['new']:.0f} spans/s "
          f"(every series new), {spans_sm / secs['known']:.0f} spans/s "
          f"(every series known); {len(DEFAULT_TENANTS)} default tenants x "
          f"{N_TREE_PUSHES} trace-tree payloads of {N_TREE_SPANS} spans "
          f"{len(DEFAULT_TENANTS) * N_TREE_PUSHES * N_TREE_SPANS / secs['default']:.0f} "
          f"spans/s; host ms a push by pass, "
          + "; ".join(f"{k}: staging {v['stage_otlp']:.3f} (before "
                      f"push_duration), push_duration {v['push']:.3f} of which "
                      f"the generator tee {v['push_staged_view']:.3f}, the "
                      f"ingester leg (3 Ingester.push_staged) "
                      f"{v['push_staged']:.3f}"
                      for k, v in push_ms.items())
          + f"; K1 launches {launches} for "
          f"{dispatches} merged dispatches, {plans} launch plans")
    print(f"phase 8a checks: errs {{}} on every push, nothing discarded; each "
          f"of 3 ingesters holds every trace sent live (rf=3), no ingester "
          f"discard, find_trace_by_id of {n_find} seeded ids on each equal "
          f"to the host decode ({find_ms:.3f} ms a find); "
          f"tempo_distributor_spans_received_total {n_sent}; {n_fams} "
          f"families of {n_series} series over {len(traffic)} tenants equal "
          f"the CPU twin's by label strings (counts and buckets exact, sums "
          f"within rtol 1e-5, max relative {max_rel:.3g}), DDSketch rows and "
          f"q50/q99 of {n_q} series exact")
    print(f"phase 8a [{card}]: K1 at a merged window of "
          f"{int((mats[-1][0] >= 0).sum())} spans: {spread(k1['ms'])} with "
          f"the host, {spread(k1['dispatch_ms'])} as dispatched; device time "
          f"(torch.profiler) {k1['device_ms']} ms, with the copy "
          f"{k1['dispatch_device_ms']} ms; plain {k1['plain_ms'][1]:.4f} ms; "
          f"bound {k1['bound_ms']:.6f} ms by {k1['bound_by']}; max abs err "
          f"{k1['max_abs']}")
    del dist, gens, g, twin, tgens, tg, mats
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8b: the columnar tee into two generators ------------------------
    ctx = "phase 8b"
    dist, gens, ings = _dist_rig("cuda", 2, now,
                                 data_dir=os.path.join(root, "8b"))
    if any(dist._staging_plan(t, dist.overrides.for_tenant(t)) is not None
           for t in traffic):
        raise AssertionError(f"{ctx}: the staged tee engaged")
    took = {t: {"recs": 0, "payload": 0} for t in traffic}
    for gg in gens.values():
        recs_fn, otlp_fn = gg.push_otlp_recs, gg.push_otlp

        def recs(t, raw, rr, inner=recs_fn):
            got = inner(t, raw, rr)
            took[t]["recs"] += got is not None
            return got

        def otlp(t, data, trusted=False, inner=otlp_fn):
            took[t]["payload"] += 1
            return inner(t, data, trusted=trusted)
        gg.push_otlp_recs, gg.push_otlp = recs, otlp
    mats = _capture_windows(
        gens["generator-0"].instance("sm-0").processors["span-metrics"])
    b0 = sc.batches_total.get(SCHED_KERNEL, 0)
    ck.reset_launch_counts()
    acc = {}
    inner_scan = _timed(native, "otlp_scan", acc)
    for gg in gens.values():
        _timed(gg, "push_otlp_recs", acc)
        _timed(gg, "push_otlp", acc)
    ing_acc = {}
    for ing in ings.values():            # the ingester leg: all three
        _timed(ing, "push_otlp", ing_acc)
    passes_b = ("new", "default")        # one pass of the span-metrics tenants
    try:
        secs_b, push_ms_b = _dist_drive(dist, gens, traffic, ctx, acc,
                                        passes=passes_b)
    finally:
        native.otlp_scan = inner_scan
    launches_b = ck.paged_fused_update.launches
    dispatches_b = sc.batches_total.get(SCHED_KERNEL, 0) - b0
    if launches_b != dispatches_b or not launches_b:
        raise AssertionError(f"{ctx}: K1 launched {launches_b} times for "
                             f"{dispatches_b} merged dispatches")
    n_push_t = {t: len(traffic[t]) for t in traffic}
    sent_b = {t: sent[t] // (2 if t in SM_TENANTS else 1) for t in traffic}
    if dist.discarded or dist.metrics.get("push_failures_total"):
        raise AssertionError(f"{ctx}: discarded {dist.discarded}, "
                             f"{dist.metrics}")
    find_ms_b, _ = _check_ingesters(ings, host, ctx)
    n_pushes_b = sum(n_push_t.values())
    ing_ms_b = ing_acc["push_otlp"] / n_pushes_b * 1e3
    for t, c in took.items():
        want = {"recs": 2 * n_push_t[t], "payload": 0} if t in SM_TENANTS \
            else {"recs": 0, "payload": 2 * n_push_t[t]}
        if c != want:
            raise AssertionError(f"{ctx}: {t} took {c}, want {want}")
    twin, tgens, _ = _dist_rig("cpu", 2, now)
    _dist_drive(twin, tgens, traffic, f"{ctx} twin", passes=passes_b)
    n_b = 0
    max_rel_b = 0.0
    for t in traffic:
        got = [gens[k].instance(t).spans_received for k in gens]
        want = [tgens[k].instance(t).spans_received for k in gens]
        if got != want or sum(got) != sent_b[t] or min(got) == 0:
            raise AssertionError(f"{ctx} {t}: spans by generator {got}, "
                                 f"twins {want}, sent {sent_b[t]}")
        n, r = _compare_rows(_family_rows([gg.instance(t) for gg in
                                           gens.values()]),
                             single_new.get(t, single[t]),
                             f"{ctx} {t} against 8a")
        n_b, max_rel_b = n_b + n, max(max_rel_b, r)
    k1b, row = _dist_k1_row(
        "paged_fused_update (distributor columnar tee, scheduler route, dense "
        "state, sketch dd, f32)",
        gens["generator-0"].instance("sm-0").processors["span-metrics"],
        mats[-1], launches_b, f"{ctx} window")
    rows.append(row)
    out["8b"] = dict(secs=secs_b, push_ms=push_ms_b, launches=launches_b,
                     ingester_ms=ing_ms_b, find_ms=find_ms_b)
    print(f"phase 8b [{card}]: Distributor.push_otlp → columnar tee → two "
          f"Generators on the card: span-metrics tenants (one pass) "
          f"{spans_sm / secs_b['new']:.0f} spans/s (series new), default "
          f"tenants "
          f"{len(DEFAULT_TENANTS) * N_TREE_PUSHES * N_TREE_SPANS / secs_b['default']:.0f} "
          f"spans/s; host ms a push by pass, "
          + "; ".join(f"{k}: push_duration {v['push']:.3f} of which the "
                      f"scan {v.get('otlp_scan', 0.0):.3f}, the generator "
                      f"tee {v.get('push_otlp_recs', 0.0) + v.get('push_otlp', 0.0):.3f}"
                      for k, v in push_ms_b.items())
          + f"; the ingester leg (3 Ingester.push_otlp of payload slices) "
          f"{ing_ms_b:.3f} ms a push over every pass"
          + f"; K1 "
          f"launches {launches_b} for {dispatches_b} merged dispatches; K1 at "
          f"a window device time {k1b['device_ms']} ms, max abs err "
          f"{k1b['max_abs']}")
    print(f"phase 8b checks: nothing discarded, each of 3 ingesters holds "
          f"every trace sent live, find_trace_by_id of {n_find} seeded ids "
          f"on each equal to the host decode ({find_ms_b:.3f} ms a find); "
          f"span-metrics tenants took "
          f"push_otlp_recs and "
          f"default tenants payload slices on every push; every span reached "
          f"exactly one generator, spans_received per generator equal to the "
          f"CPU twins'; {n_b} series of every family, summed over the two "
          f"generators by label set, equal phase 8a's one generator (after "
          f"its first pass for the span-metrics tenants; counts exact, sums "
          f"within rtol 1e-5, max relative {max_rel_b:.3g})")
    del dist, gens, twin, tgens, mats, single, single_new
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8c: overload sampling, then backpressure -------------------------
    ctx = "phase 8c"
    samp = {"sm-0": {"sampling": {"floor": 0.25, "tail_quantile": 0.0}}}
    runs = []
    views = []
    for device in ("cuda", "cpu"):
        dist, gens, ings = _dist_rig(
            device, 1, now, samp,
            data_dir=os.path.join(root, "8c") if device == "cuda" else None)
        dist.sampler = SpanSampler(fraction_source=lambda: 0.5,
                                   now=lambda: now)
        if device == "cuda":
            ing0 = ings["ingester-0"]
            inner_push = ing0.push_staged
            ing0.push_staged = lambda t, v: (views.append(v),
                                             inner_push(t, v))[1]
        (gg,) = gens.values()
        for data in sm_payloads:
            if dist.push_otlp("sm-0", data):
                raise AssertionError(f"{ctx}: errs on a sampled push")
        _settle(gens)
        runs.append((dist, gg, ings))
    (dist, gg, ings), (tdist, tgg, _) = runs
    truth = N_DIST_PUSHES * N_SPANS
    dropped = dist.discarded.get(REASON_SAMPLED, 0)
    if not dropped or tdist.discarded != dist.discarded:
        raise AssertionError(f"{ctx}: discarded {dist.discarded} / twin "
                             f"{tdist.discarded}")
    last = views[-1]
    w, status = last.weights(), last.stage_rows()["status_code"]
    n_kept = sum(len(v.trace_groups()) for v in views)
    live = [len(i.instance("sm-0").live) for i in ings.values()]
    if live != [n_kept] * 3 or any(i.instance("sm-0").discarded
                                   for i in ings.values()):
        raise AssertionError(f"{ctx}: ingesters hold {live} live traces of "
                             f"the {n_kept} kept")
    if not ((w[status != 2] == 2.0).all() and (w[status == 2] == 1.0).all()):
        raise AssertionError(f"{ctx}: weights {np.unique(w)}")
    f, n, r = _compare_by_labels(gg.instance("sm-0"), tgg.instance("sm-0"),
                                 ctx)
    _same_dd_quantiles(gg.instance("sm-0"), tgg.instance("sm-0"), ctx)
    proc = gg.instance("sm-0").processors["span-metrics"]
    with gg.instance("sm-0").registry.state_lock:
        (calls,) = proc.calls._snap()
    total = float(calls[proc.calls.table.active_slots()].sum())
    if abs(total - truth) > 0.05 * truth:
        raise AssertionError(f"{ctx}: HT-weighted calls {total} against "
                             f"{truth} spans")
    dist.backpressure = IngestBackpressure(retry_after_fn=lambda: 2.0)
    fresh = synthetic_spans(1024, seed=SEED + 8, now_ns=int(now * 1e9))
    for s in fresh:
        s["service"] = "backpressure-" + s["service"]
    interner = gg.instance("sm-0").registry.interner
    before = len(interner)
    try:
        dist.push_otlp("sm-0", encode_spans_otlp(fresh))
        raise AssertionError(f"{ctx}: the push was admitted")
    except RateLimited as e:
        if e.reason != REASON_BACKPRESSURE or e.retry_after_s != 2.0:
            raise AssertionError(f"{ctx}: {e.reason}, {e.retry_after_s}")
    if len(interner) != before:
        raise AssertionError(f"{ctx}: the interner grew on a rejected push")
    out["8c"] = dict(dropped=dropped, total=total)
    print(f"phase 8c checks: keep fraction 0.5 (floor 0.25, tail off): "
          f"{dropped} of {truth} spans discarded as sampled (the twin the "
          f"same), hash-kept weights exactly 2.0 and error spans 1.0, "
          f"HT-weighted calls {total:.0f} against {truth} spans "
          f"({(total - truth) / truth * 100:+.2f}%), {f} families of {n} "
          f"series equal the CPU twin's (max relative {r:.3g}); backpressure: "
          f"RateLimited reason {REASON_BACKPRESSURE} retry_after_s 2.0, the "
          f"interner unchanged at {before} strings")
    sched.reset()
    del runs, dist, gens, tdist, gg, tgg, proc
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8: {out['seconds']:.1f} s")
    return out, rows


# ---------------------------------------------------------------------------
# phase 9: the ingester's cycle (live traces → WAL → complete block → flush)
# ---------------------------------------------------------------------------

N_INGEST_PAYLOADS = 1            # cut from 4, then 2, for the smoke's time
SPANS_PER_TRACE = 32
INGEST_TENANT = "ingest-0"
LIMIT_TENANT = "ingest-limits"


def deep_trace_spans(n, *, seed, now_ns, spans_per_trace=SPANS_PER_TRACE,
                     n_services=16, n_ops=32):
    """`n` span dicts of seeded trace trees of `spans_per_trace` spans:
    each span's parent an earlier span of its trace (the first the root),
    each child inside its parent's interval; services and operations
    uniform; span attributes of every type (string, int, double, bool),
    resource attributes per service, an event on every 4th span and a
    link on every 8th; ends within 10 s before `now_ns`."""
    rng = np.random.default_rng(seed)
    spans = []
    while len(spans) < n:
        tid = rng.bytes(16)
        k = min(spans_per_trace, n - len(spans))
        sids = [rng.bytes(8) for _ in range(k)]
        parent = [-1] + [int(rng.integers(0, j)) for j in range(1, k)]
        end = now_ns - int(rng.random() * 10e9)
        dur = max(int(rng.lognormal(18.0, 1.0)), k * 4)
        ivals = [(end - dur, end)]
        for j in range(1, k):
            lo, hi = ivals[parent[j]]
            a = lo + int((hi - lo) * rng.uniform(0.0, 0.5))
            ivals.append((a, a + max(int((hi - a) * rng.uniform(0.1, 0.9)), 1)))
        for j in range(k):
            svc = int(rng.integers(0, n_services))
            sp = {
                "trace_id": tid, "span_id": sids[j],
                "parent_span_id": b"" if j == 0 else sids[parent[j]],
                "name": f"op-{int(rng.integers(0, n_ops))}",
                "service": f"service-{svc}",
                "kind": int(rng.integers(1, 6)),
                "status_code": int(rng.integers(0, 3)),
                "start_unix_nano": ivals[j][0], "end_unix_nano": ivals[j][1],
                "attrs": {"http.method": ("GET", "POST", "PUT")[j % 3],
                          "http.status_code": int(rng.integers(200, 600)),
                          "retry.ratio": float(rng.random()),
                          "cache.hit": bool(j % 2)},
                "res_attrs": {"service.name": f"service-{svc}",
                              "host.name": f"host-{svc % 4}",
                              "process.pid": svc},
            }
            if j % 4 == 3:
                sp["events"] = [{"time_unix_nano": ivals[j][0] + 1,
                                 "name": "retry"}]
            if j % 8 == 7:
                sp["links"] = [{"trace_id": rng.bytes(16),
                                "span_id": rng.bytes(8)}]
            spans.append(sp)
    return spans


def _ingest_rig(root, now_fn):
    """One `Distributor` (no generator tee) over 3 `Ingester`s of the
    reference's default `IngesterConfig`, each in its own data directory
    under `root`, flushing to one `LocalBackend` store under `root`."""
    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.distributor import Distributor
    from tempo_tpu_torch.ingester import Ingester, IngesterConfig
    from tempo_tpu_torch.overrides import Overrides
    from tempo_tpu_torch.ring import ACTIVE, InstanceDesc, Ring
    from tempo_tpu_torch.ring.ring import _instance_tokens

    ov = Overrides()
    ov.set_tenant_patch(INGEST_TENANT, {"ingestion": dict(UNLIMITED)})
    store = LocalBackend(os.path.join(root, "store"))
    ring = Ring(replication_factor=3, now=now_fn)
    ings = {}
    for k in range(3):
        iid = f"ingester-{k}"
        ings[iid] = Ingester(os.path.join(root, iid), flush_writer=store,
                             cfg=IngesterConfig(), overrides=ov, now=now_fn,
                             instance_id=iid)
        ring.register(InstanceDesc(id=iid, state=ACTIVE,
                                   tokens=_instance_tokens(iid, 128),
                                   heartbeat_ts=now_fn()))
    return Distributor(ring, ings, overrides=ov, now=now_fn), ings, store, ov


def _find_all(fn, picks, want, ctx):
    """`fn(tid)` for every picked id equal to `want[tid]`; ms a find, and
    the first find's ms."""
    times = []
    for tid in picks:
        t0 = time.perf_counter()
        got = fn(tid)
        times.append((time.perf_counter() - t0) * 1e3)
        if got != want[tid]:
            raise AssertionError(f"{ctx}: trace {tid.hex()} differs from the "
                                 f"host decode")
    return statistics.median(times), times[0]


def _as_read(spans):
    """Span dicts as a block or WAL read returns them: ids padded to their
    column widths, every key present."""
    return [{**s,
             "trace_id": s["trace_id"].ljust(16, b"\0"),
             "span_id": s["span_id"].ljust(8, b"\0"),
             "parent_span_id": (s.get("parent_span_id") or b"").ljust(
                 8, b"\0"),
             "events": [{"time_unix_nano": e["time_unix_nano"],
                         "name": e["name"]} for e in s.get("events") or []],
             "links": [{"trace_id": ln["trace_id"].ljust(16, b"\0"),
                        "span_id": ln["span_id"].ljust(8, b"\0")}
                       for ln in s.get("links") or []]}
            for s in spans]


def phase_ingester(card, then=None):
    """Phase 9: the ingester's cycle at the reference's default config,
    on real ingesters behind the distributor; the data directories and
    the object store live under `build/` for the phase. `then(store,
    handoff)`, when given, runs on the flushed object store before it is
    removed (phase 10a). Returns the results (and `then`'s)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase9-",
                                     dir=os.path.join(ROOT, "build")) as root:
        out = _phase_ingester(card, root)
        handoff = out.pop("_handoff")
        return out, (None if then is None else then(*handoff))


def _phase_ingester(card, root):
    from tempo_tpu_torch.backend import MemBackend, read_block_meta
    from tempo_tpu_torch.block import BackendBlock, write_block
    from tempo_tpu_torch.block import reader as block_reader
    from tempo_tpu_torch.ingester import Ingester, IngesterConfig
    from tempo_tpu_torch.ingester import instance as inst_mod
    from tempo_tpu_torch.model.combine import sort_spans
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    t_phase = time.perf_counter()
    ctx = "phase 9"
    now_ns = time.time_ns()
    sent = [deep_trace_spans(N_SPANS, seed=SEED + 90 + k, now_ns=now_ns)
            for k in range(N_INGEST_PAYLOADS)]
    payloads = [encode_spans_otlp(spans) for spans in sent]
    host = _host_traces(payloads)
    n_traces = len(host)
    n_spans = N_INGEST_PAYLOADS * N_SPANS
    if n_traces != n_spans // SPANS_PER_TRACE:
        raise AssertionError(f"{ctx}: {n_traces} traces")
    rng = np.random.default_rng(SEED + 91)
    ids = sorted(host)
    picks = [ids[int(i)] for i in rng.choice(n_traces, min(N_FIND, n_traces),
                                             replace=False)]
    n_groups = -(-n_spans // IngesterConfig().instance.row_group_rows)
    read_want = {t: _as_read(v) for t, v in host.items()}
    out = {}
    clock = [time.time()]
    now_fn = lambda: clock[0]  # noqa: E731
    dist, ings, store, ov = _ingest_rig(root, now_fn)
    t = INGEST_TENANT

    # 1. push
    h0 = dist.push_duration.snapshot() or {"sum": 0.0, "count": 0}
    t0 = time.perf_counter()
    for data in payloads:
        errs = dist.push_otlp(t, data)
        if errs:
            raise AssertionError(f"{ctx}: push: {errs}")
    push_s = time.perf_counter() - t0
    h1 = dist.push_duration.snapshot()
    out["push_spans_per_s"] = n_spans / push_s
    out["push_duration_ms"] = (h1["sum"] - h0["sum"]) / (
        h1["count"] - h0["count"]) * 1e3
    if dist.discarded or dist.metrics.get("push_failures_total"):
        raise AssertionError(f"{ctx}: {dist.discarded} {dist.metrics}")
    out["find_live_ms"], _ = _check_ingesters(ings, {t: host}, f"{ctx} live")

    # 2. cut: every trace to the head WAL block, one segment a trace; seal
    fs = {"s": 0.0, "calls": 0}
    inner_fsync = os.fsync

    def fsync(fd):
        t1 = time.perf_counter()
        try:
            return inner_fsync(fd)
        finally:
            fs["s"] += time.perf_counter() - t1
            fs["calls"] += 1
    os.fsync = fsync
    t0 = time.perf_counter()
    try:
        for ing in ings.values():
            ing.sweep_all(immediate=True)
    finally:
        os.fsync = inner_fsync
    cut_s = time.perf_counter() - t0
    segs = 0
    for iid, ing in ings.items():
        inst = ing.instance(t)
        (wb,) = inst.completing
        segs += len(wb.segments())
        if len(inst.live) or inst.head is not None or \
                len(wb.segments()) != n_traces or len(ing.queues) != 1:
            raise AssertionError(f"{ctx}: {iid} after the cut: "
                                 f"{len(inst.live)} live, "
                                 f"{len(wb.segments())} segments")
    out.update(cut_s=cut_s, segments_per_s=segs / cut_s,
               fsync_ms=fs["s"] / fs["calls"] * 1e3, fsync_calls=fs["calls"])
    wal_ms = []
    for iid, ing in ings.items():
        wal_ms.append(_find_all(lambda tid: ing.find_trace_by_id(t, tid),
                                picks, read_want, f"{ctx} {iid} WAL")[0])
    out["find_wal_ms"] = statistics.median(wal_ms)

    # 3. complete + flush
    acc = {}
    inner_write = _timed(inst_mod, "write_block", acc)
    flush_ms = {}
    t0 = time.perf_counter()
    try:
        for iid, ing in ings.items():
            c0 = {op: (ing.flush_duration.snapshot((op,)) or {"sum": 0.0})
                  ["sum"] for op in ("complete", "flush")}
            if ing.flush_tick() != 2 or len(ing.queues):
                raise AssertionError(f"{ctx}: {iid} flush_tick left "
                                     f"{len(ing.queues)} ops")
            for op in ("complete", "flush"):
                flush_ms[op] = flush_ms.get(op, 0.0) + \
                    ing.flush_duration.snapshot((op,))["sum"] - c0[op]
    finally:
        inst_mod.write_block = inner_write
    out.update(tick_s=time.perf_counter() - t0,
               complete_s=flush_ms["complete"] / 3,
               flush_s=flush_ms["flush"] / 3,
               write_spans_per_s=3 * n_spans / acc["write_block"])
    blocks = []
    for iid, ing in ings.items():
        inst = ing.instance(t)
        (entry,) = inst.complete.values()
        m = entry.meta
        if inst.completing or not entry.flushed_ts or \
                m.row_group_count != n_groups or m.total_spans != n_spans or \
                m.total_objects != n_traces or m.encoding != "gzip":
            raise AssertionError(f"{ctx}: {iid} block {m.to_json()}")
        flushed = read_block_meta(store, m.block_id, t)
        if flushed.to_json() != m.to_json():
            raise AssertionError(f"{ctx}: {iid} flushed meta differs")
        blocks.append(BackendBlock(store, flushed))
        ms, first = _find_all(lambda tid: ing.find_trace_by_id(t, tid),
                              picks, read_want, f"{ctx} {iid} complete block")
        out.setdefault("find_block_ms", []).append((ms, first))
    out["bytes_per_span"] = blocks[0].meta.size_bytes / n_spans
    sorted_traces = [(tid, host[tid]) for tid in ids]
    plain = write_block(MemBackend(), t, sorted_traces, compression="none")
    out["bytes_per_span_none"] = plain.size_bytes / n_spans
    out["find_flushed_ms"] = _find_all(
        lambda tid: blocks[0].find_trace_by_id(tid), picks, read_want,
        f"{ctx} flushed copy")

    # 4. every span of a flushed block, read back through the port's reader
    pf = blocks[0].parquet_file()
    got: dict = {}
    for rg in range(pf.num_row_groups):
        tbl = pf.read_row_group(rg)
        for sp in block_reader._rows_to_spans(tbl, np.arange(tbl.num_rows)):
            got.setdefault(sp["trace_id"], []).append(sp)
    if len(got) != n_traces or sum(map(len, got.values())) != n_spans:
        raise AssertionError(f"{ctx}: the block holds {len(got)} traces")
    for tid in ids:
        if sort_spans(got[tid]) != read_want[tid]:
            raise AssertionError(f"{ctx}: block trace {tid.hex()} differs")
    del got, pf

    # 5. an ingester abandoned mid-cycle, then replayed
    rdir = os.path.join(root, "abandoned")
    counts = {}

    class CountingStore:
        def write(self, name, keypath, data):
            if name == "data.parquet":
                counts[keypath.parts[-1]] = counts.get(
                    keypath.parts[-1], 0) + 1
            return store.write(name, keypath, data)

    # the traces sent, in two halves: the first ends in a complete block,
    # the second in the head WAL block
    spans = [s for ss in sent for s in ss]
    first = set(ids[:len(ids) // 2])
    halves = [encode_spans_otlp([s for s in spans
                                 if (s["trace_id"] in first) == h])
              for h in (True, False)]
    taken = _host_traces(halves)
    r_picks = [tid for tid in picks if tid in taken]
    late = next(bytes([b]) * 16 for b in range(256)
                if bytes([b]) * 16 not in host)
    ing = Ingester(rdir, flush_writer=CountingStore(), cfg=IngesterConfig(),
                   overrides=ov, now=now_fn, instance_id="ingester-r")
    if ing.push_otlp(t, halves[0]):
        raise AssertionError(f"{ctx}: abandoned ingester push")
    inst = ing.instance(t)
    inst.cut_complete_traces(immediate=True)
    inst.complete_block(inst.cut_block_if_ready(immediate=True))
    if ing.push_otlp(t, halves[1]):
        raise AssertionError(f"{ctx}: abandoned ingester push")
    inst.cut_complete_traces(immediate=True)       # the head WAL block
    if len(inst.complete) != 1 or inst.head is None:
        raise AssertionError(f"{ctx}: abandoned ingester state")
    del ing, inst                                  # no shutdown
    gc.collect()
    t0 = time.perf_counter()
    ing = Ingester(rdir, flush_writer=CountingStore(), cfg=IngesterConfig(),
                   overrides=ov, now=now_fn, instance_id="ingester-r")
    replay_s = time.perf_counter() - t0
    inst = ing.instance(t)
    if len(inst.completing) != 1 or len(inst.complete) != 1 or \
            len(ing.queues) != 2:
        raise AssertionError(f"{ctx}: replay adopted {len(inst.completing)} "
                             f"WAL / {len(inst.complete)} complete blocks")
    _find_all(lambda tid: ing.find_trace_by_id(t, tid), r_picks, read_want,
              f"{ctx} replayed")
    t0 = time.perf_counter()
    ing.flush_tick()
    out["replay_s"] = replay_s
    out["replay_flush_s"] = time.perf_counter() - t0
    if len(ing.queues) or len(inst.complete) != 2 or \
            sorted(counts.values()) != [1, 1] or \
            set(counts) != set(inst.complete) or \
            any(not e.flushed_ts for e in inst.complete.values()):
        raise AssertionError(f"{ctx}: after replay: flushed {counts}, "
                             f"{len(inst.complete)} blocks")
    _find_all(lambda tid: ing.find_trace_by_id(t, tid), r_picks, read_want,
              f"{ctx} replayed and flushed")
    if not r_picks or ing.find_trace_by_id(t, late) is not None:
        raise AssertionError(f"{ctx}: replayed ingester finds "
                             f"{len(r_picks)} picks, or a trace it never took")
    del ing, inst

    # 6. the live-trace limit at the default limits, on a fresh tenant
    from tempo_tpu_torch.model.otlp import synthetic_spans
    one = synthetic_spans(10_001, seed=SEED + 92, now_ns=now_ns)
    errs = dist.push_otlp(LIMIT_TENANT, encode_spans_otlp(one))
    if errs != {"live_traces_exceeded": 1} or \
            dist.discarded.get("live_traces_exceeded") != 1:
        raise AssertionError(f"{ctx}: limits: errs {errs}, distributor "
                             f"discarded {dist.discarded}")
    for iid, ing in ings.items():
        inst = ing.instance(LIMIT_TENANT)
        line = (f'tempo_ingester_discarded_traces_total{{tenant='
                f'"{LIMIT_TENANT}",reason="live_traces_exceeded"}} 1')
        if len(inst.live) != 10_000 or \
                inst.discarded != {"live_traces_exceeded": 1} or \
                line not in ing.obs.render().splitlines():
            raise AssertionError(f"{ctx}: {iid} limits: {len(inst.live)} "
                                 f"live, discarded {inst.discarded}")
    out["seconds"] = time.perf_counter() - t_phase
    fb = out["find_block_ms"]
    print(f"phase 9 [{card}]: {N_INGEST_PAYLOADS} payloads of {N_SPANS} spans "
          f"({n_traces} traces of {SPANS_PER_TRACE}) through "
          f"Distributor.push_otlp into 3 ingesters (rf=3, default "
          f"IngesterConfig): push {out['push_spans_per_s']:.0f} spans/s, "
          f"push_duration {out['push_duration_ms']:.3f} ms a push; cut "
          f"(sweep_all immediate, 3 ingesters) {cut_s:.3f} s, "
          f"{out['segments_per_s']:.1f} WAL segments/s, fsync "
          f"{out['fsync_ms']:.3f} ms a call over {fs['calls']} calls (a "
          f"file and its directory a segment); flush_tick {out['tick_s']:.3f} s: complete "
          f"{out['complete_s']:.3f} s an ingester, block writing "
          f"{out['write_spans_per_s']:.0f} spans/s, flush "
          f"{out['flush_s']:.4f} s an ingester; block "
          f"{blocks[0].meta.size_bytes} bytes, "
          f"{out['bytes_per_span']:.2f} bytes a span gzip, "
          f"{out['bytes_per_span_none']:.2f} uncompressed on the same input; "
          f"find_trace_by_id ms (median of {N_FIND}): live "
          f"{out['find_live_ms']:.4f}, WAL {out['find_wal_ms']:.4f}, "
          f"complete block "
          + ", ".join(f"{m:.4f} (first {f:.1f})" for m, f in fb)
          + f", flushed copy {out['find_flushed_ms'][0]:.4f} (first "
          f"{out['find_flushed_ms'][1]:.1f}); replay {replay_s:.3f} s, then "
          f"flush_tick {out['replay_flush_s']:.3f} s; phase "
          f"{out['seconds']:.1f} s")
    print(f"phase 9 checks: every trace live on each ingester and no discard; "
          f"find_trace_by_id of {N_FIND} seeded ids equal to the host decode "
          f"live, in the WAL ({n_traces} segments an ingester), in each "
          f"complete block ({n_groups} row groups, {n_spans} spans, gzip) "
          f"and in its "
          f"flushed copy through BackendBlock; every span of a flushed block "
          f"read back equal to what was sent, by trace; an abandoned "
          f"ingester (one head WAL block, one complete unflushed block) "
          f"replayed: both blocks flushed once, the same traces found; "
          f"10,001 one-span traces at the default limits: 10,000 live on "
          f"each ingester, one live_traces_exceeded discard each, counted "
          f"once by the distributor")
    out["_handoff"] = (store, dict(tenant=t, read_want=read_want, picks=picks,
                                   n_blocks=len(blocks) + len(counts),
                                   now_ns=now_ns,
                                   n_spans=n_spans))
    return out


# ---------------------------------------------------------------------------
# phase 10: the read side over backend blocks (TempoDB, the device plane)
# ---------------------------------------------------------------------------

BENCH_TENANT = "bench"
N_BENCH_SPANS = 100_000          # the reference's bench_query block
SCAN_SPANS = 1_000_000           # _bench_scan_plane's resident spans
MOM_Q99_RTOL = 1e-3              # ROADMAP section 3, "Moments quantiles"
MOM_Q99_OUTSIDE_SHARE = 40 / 16384   # ... of cells beyond it, at most
MOM_PARITY_RTOL = 5e-2           # the reference's fused vs host parity


def _series_map(series) -> dict:
    return {tuple(sorted((str(k), str(v)) for k, v in s.labels)):
            np.nan_to_num(np.asarray(s.samples, np.float64))
            for s in series}


def _same_series(a, b, exact, ctx):
    if set(a) != set(b):
        raise AssertionError(f"{ctx}: series differ (only first "
                             f"{sorted(set(a) - set(b))[:3]}, only second "
                             f"{sorted(set(b) - set(a))[:3]})")
    for k in b:
        ok = np.array_equal(a[k], b[k]) if exact else np.allclose(
            a[k], b[k], rtol=1e-5, atol=1e-4)
        if not ok:
            raise AssertionError(f"{ctx}: series {k} differs: {a[k]} vs "
                                 f"{b[k]}")


def _fallbacks(db) -> dict:
    return {k: v for k, v in db.plane_stats.items()
            if k.startswith("fallback_")}


def _final(series, req):
    """The frontend's final pass over job-level series (rates divided,
    quantiles solved)."""
    from tempo_tpu_torch.traceql.engine_metrics import (SeriesCombiner,
                                                        metrics_kind)

    comb = SeriesCombiner(metrics_kind(req.query), req.n_steps)
    comb.add_all(series)
    return comb.final(req)


def _h2d_bytes() -> int:
    from tempo_tpu_torch.obs.runtime import DEVICE_PUT_BYTES

    return int(sum(DEVICE_PUT_BYTES.value((site,)) for site in (
        "plane_column", "plane_literals", "engine_metrics")))


def _timed_ms(fn, iters=3):
    """ms a call after one warm-up (the card synchronised around each)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _profile(fn, runs=3):
    """(device ms a call, device ops a call, wall ms a call, the longest
    op's name and ms a call) of a warm `fn` under torch.profiler: every
    device event (kernels, memsets, copies) on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, launches, top = 0.0, 0, ("", 0.0)
    for ev in prof.key_averages():
        if not ev.count or ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "device_time_total", 0) or \
            getattr(ev, "cuda_time_total", 0)
        dev += t
        launches += ev.count
        if t > top[1]:
            top = (ev.key, t)
    top = (top[0][:80], top[1] / runs / 1e3)
    if not dev:
        return None, launches / runs, wall / runs * 1e3, top
    return dev / runs / 1e3, launches / runs, wall / runs * 1e3, top


def _moment_rows_agree(a, b, ctx):
    """Job-level moment series of two planes within ROADMAP section 3's
    row tolerance: the count column exact, each sum within rtol 1e-5
    plus 2e-5 per unit of weight, the support bounds within rtol 2e-6."""
    if set(a) != set(b):
        raise AssertionError(f"{ctx}: series sets differ")
    for k in b:
        d = dict(k)
        m = d["__moment"]
        base = tuple(x for x in k if x[0] != "__moment")
        if m == "0":
            ok = np.array_equal(a[k], b[k])
        elif m in ("hi", "lo"):
            ok = np.allclose(a[k], b[k], rtol=2e-6, atol=0)
        else:
            w = b[tuple(sorted(base + (("__moment", "0"),)))]
            ok = bool(np.all(np.abs(a[k] - b[k])
                             <= 1e-5 * np.abs(b[k]) + 2e-5 * w))
        if not ok:
            raise AssertionError(f"{ctx}: {k}: {a[k]} vs {b[k]}")


def _moments_tier_checks(mom, mom_again, mom_host, log2_host, cols, t_base,
                         step_ns, ctx):
    """The moments tier's q99 a (service, step) cell, held four ways:
    the fused plane against the host engine at the reference's parity
    (rtol 5e-2 every cell) and at ROADMAP section 3's limit (rtol 1e-3
    on at most 40 cells in 16,384); the fused query run twice, at the
    same limit; against the exact quantile within the reference's tier
    bound (`tests/test_plane_fuzz.py:750`: relative or rank error at
    most max(0.08, 2.5/sqrt(n))); against the host engine's log2-tier
    answer within one power-of-two bucket (that tier's resolution)."""
    mom, mom_again, mom_host, log2_host = (_series_map(x) for x in (
        mom, mom_again, mom_host, log2_host))
    if not (set(mom) == set(mom_again) == set(mom_host) == set(log2_host)):
        raise AssertionError(f"{ctx}: moments / log2 series sets differ")
    steps = (cols["start"] - t_base) // step_ns
    host, again, exact, log2 = [], [], [], []
    for k, v in mom.items():
        if dict(k)["p"] != "0.99":
            raise AssertionError(f"{ctx}: moments series {k}")
        svc = int(dict(k)["resource.service.name"][4:])
        for si in range(len(v)):
            durs = np.sort(cols["dur"][(cols["service"] == svc)
                                       & (steps == si)]) / 1e9
            if not len(durs):
                continue
            q = v[si]
            host.append(abs(q - mom_host[k][si]) / mom_host[k][si])
            again.append(abs(q - mom_again[k][si]) / mom_again[k][si])
            ex = np.quantile(durs, 0.99)
            rank = abs(np.searchsorted(durs, q) / len(durs) - 0.99)
            exact.append((abs(q - ex) / ex, rank,
                          max(0.08, 2.5 / np.sqrt(len(durs)))))
            log2.append(abs(np.log2(q / log2_host[k][si])))
    host, again, log2 = (np.asarray(x) for x in (host, again, log2))
    cells = len(host)
    limit = int(cells * MOM_Q99_OUTSIDE_SHARE)
    if host.max() > MOM_PARITY_RTOL:
        raise AssertionError(f"{ctx}: moments q99 plane vs host engine "
                             f"{host.max():.6f} beyond rtol "
                             f"{MOM_PARITY_RTOL}")
    for name, errs in (("plane vs host engine", host),
                       ("plane run twice", again)):
        over = int((errs > MOM_Q99_RTOL).sum())
        if over > limit:
            raise AssertionError(f"{ctx}: moments q99 {name} beyond rtol "
                                 f"{MOM_Q99_RTOL} in {over} of {cells} "
                                 f"cells (limit {limit}; max "
                                 f"{errs.max():.6f})")
    bad = [e for e in exact if min(e[0], e[1]) > e[2]]
    if bad:
        raise AssertionError(f"{ctx}: moments q99 off the exact quantile "
                             f"beyond the tier bound in {len(bad)} of "
                             f"{cells} cells (first {bad[0]})")
    if log2.max() > 1.0:
        raise AssertionError(f"{ctx}: moments q99 more than one log2 "
                             f"bucket from the log2 tier's host answer "
                             f"({log2.max():.4f})")
    rel = np.asarray([e[0] for e in exact])
    return {"moments_cells": cells,
            "moments_vs_host_max": float(host.max()),
            "moments_vs_host_over": int((host > MOM_Q99_RTOL).sum()),
            "moments_again_max": float(again.max()),
            "moments_err_median": float(np.median(rel)),
            "moments_err_max": float(rel.max()),
            "moments_vs_log2_max": float(2.0 ** log2.max())}


def _check_fused(db, before, n_blocks, ctx):
    got = db.plane_stats["fused_metric_blocks"] - before
    if got != n_blocks or _fallbacks(db):
        raise AssertionError(f"{ctx}: fused blocks {got} of {n_blocks}, "
                             f"fallbacks {_fallbacks(db)}")


def phase_read_push(store, handoff, card):
    """Phase 10a: push to query. A port TempoDB at the reference's default
    config on the card polls phase 9's flushed object store and answers
    find_trace_by_id, a search and two metrics queries; each result is
    held against a CPU twin and a host-engine twin on the same store."""
    import torch

    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.combine import sort_spans
    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

    ctx = "phase 10a"
    t_phase = time.perf_counter()
    t, want, picks = handoff["tenant"], handoff["read_want"], handoff["picks"]
    from tempo_tpu_torch.device import resolve_device

    card_db = TempoDB(store, store)
    if card_db.device != resolve_device() or not card_db.cfg.device_plane:
        raise AssertionError(f"{ctx}: TempoDB on {card_db.device}")
    cpu_db = TempoDB(store, store, device="cpu")
    host_db = TempoDB(store, store, TempoDBConfig(device_plane=False),
                      device="cpu")
    for db in (card_db, cpu_db, host_db):
        db.poll_now()
    n_blocks = len(card_db.blocks(t))
    if n_blocks != handoff["n_blocks"]:
        raise AssertionError(f"{ctx}: polled {n_blocks} blocks, flushed "
                             f"{handoff['n_blocks']}")
    out = {"blocks": n_blocks}
    # find_trace_by_id: the blocks hold each trace rf times; combine_spans
    # answers it once
    times = []
    for tid in picks:
        t0 = time.perf_counter()
        got = card_db.find_trace_by_id(t, tid)
        times.append((time.perf_counter() - t0) * 1e3)
        if got is None or sort_spans(got) != want[tid]:
            raise AssertionError(f"{ctx}: trace {tid.hex()} differs from the "
                                 f"host decode")
    out["find_ms"] = statistics.median(times)
    searches = ("{ span.http.status_code >= 500 }",
                '{ span.cache.hit = true && resource.host.name = "host-1" '
                '&& duration > 1ms }')
    for q in searches:
        got = [[m.to_json() for m in db.search(t, q, limit=20)]
               for db in (card_db, cpu_db, host_db)]
        if not got[0] or got[0] != got[1] or got[0] != got[2]:
            raise AssertionError(f"{ctx}: search {q!r}: {len(got[0])} card "
                                 f"results, equal to the CPU twin "
                                 f"{got[0] == got[1]}, to the host engine "
                                 f"{got[0] == got[2]}")
    out["search_ms"] = _timed_ms(lambda: card_db.search(t, searches[0],
                                                        limit=20))
    start = handoff["now_ns"] - 600 * 10**9
    queries = ("{ } | rate() by (resource.service.name)",
               "{ } | quantile_over_time(duration, .5, .99) by "
               "(resource.service.name)")
    total = 0.0
    for q in queries:
        req = QueryRangeRequest(q, start, start + 900 * 10**9, 60 * 10**9)
        f0 = card_db.plane_stats["fused_metric_blocks"]
        t0 = time.perf_counter()
        a = _series_map(card_db.query_range(t, req))
        out.setdefault("first_query_s", time.perf_counter() - t0)
        _check_fused(card_db, f0, n_blocks, f"{ctx} {q}")
        b = _series_map(cpu_db.query_range(t, req))
        c = _series_map(host_db.query_range(t, req))
        _same_series(a, b, True, f"{ctx} {q}: card vs CPU twin")
        _same_series(a, c, True, f"{ctx} {q}: card vs host engine")
        if "rate" in q:              # job-level series: raw counts
            total = sum(v.sum() for v in a.values())
    stored = sum(m.total_spans for m in card_db.blocks(t))
    if round(total) != stored:
        raise AssertionError(f"{ctx}: rate counted {total} spans, the "
                             f"{n_blocks} blocks hold {stored}")
    req = QueryRangeRequest(queries[0], start, start + 900 * 10**9,
                            60 * 10**9)
    out["query_range_ms"] = _timed_ms(lambda: card_db.query_range(t, req))
    for db in (card_db, cpu_db, host_db):
        db.shutdown()
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10a [{card}]: TempoDB (default TempoDBConfig, device plane "
          f"on the card) over phase 9's flushed store: {n_blocks} blocks; "
          f"find_trace_by_id {out['find_ms']:.3f} ms (median of "
          f"{len(picks)}), search {out['search_ms']:.3f} ms, rate by service "
          f"{out['query_range_ms']:.3f} ms warm, first query (adoption of "
          f"{n_blocks} blocks) {out['first_query_s']:.3f} s; phase "
          f"{out['seconds']:.1f} s")
    print(f"phase 10a checks: {len(picks)} traces equal to phase 9's host "
          f"decode (rf copies combined); {len(searches)} searches and "
          f"{len(queries)} metrics queries equal to a CPU twin and to the "
          f"host engine (device_plane=False); every metrics block fused, no "
          f"fallback; rate counted every span of every block")
    return out


def _scan_setup(db):
    """`_bench_scan_plane`'s inputs: the bench block's views repeated to
    >= SCAN_SPANS resident spans, the mask query, the rate grid query."""
    from tempo_tpu_torch.block.fetch import scan_views
    from tempo_tpu_torch.block.reader import BackendBlock
    from tempo_tpu_torch.traceql.engine import compile_query
    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

    meta = db.blocklist.metas(BENCH_TENANT)[0]
    views = [v for v, _ in scan_views(BackendBlock(db.r, meta))]
    reps = max(1, -(-SCAN_SPANS // sum(v.n for v in views)))
    scan = views * reps
    _, mreq = compile_query('{ name =~ "op-1." && duration > 20ms }')
    preds = [c for c in mreq.conditions if c.op is not None]
    start_ns = int(scan[0].col("__startTime").values.min())
    greq = QueryRangeRequest("{ } | rate() by (resource.service.name)",
                             start_ns, start_ns + 900 * 10**9, 60 * 10**9)
    return scan, reps, mreq, preds, greq, compile_query(greq.query)[0].metrics


def _grid_call(plane, m, greq, ctx):
    def grid():
        h, cause = plane.metrics_grid(m, [], True, greq.start_ns,
                                      greq.end_ns, greq.step_ns)
        if cause is not None:
            raise AssertionError(f"{ctx}: the 1M grid refused: {cause}")
        return h.fetch()
    return grid


def phase10_profiles() -> dict:
    """Phase 10b's torch.profiler readings, run by `_profiles_in_child` in
    a process of its own: in the whole smoke's process, after the earlier
    phases' profiler sessions, the trace lost most device events on an
    H100 (8 of a grid's 22 ops, none of the mask's). The bench block
    again (in memory), then a warm rate query_range with the plane on and
    off, the 1M mask and the 1M grid under the profiler."""
    from tempo_tpu_torch.backend import MemBackend
    from tempo_tpu_torch.block.device_scan import BlockScanPlane
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

    t_base = int((time.time() - 1800) * 1e9)
    be = MemBackend()
    db = TempoDB(be, be)
    db.write_block(BENCH_TENANT, _bench_traces(N_BENCH_SPANS, t_base)[0],
                   replication_factor=1)
    db_host = TempoDB(be, be, TempoDBConfig(device_plane=False))
    db_host.poll_now()
    req = QueryRangeRequest("{ } | rate() by (resource.service.name)",
                            t_base, t_base + 900 * 10**9, 60 * 10**9)
    out = {}
    (out["qr_device_ms"], out["qr_launches"], out["qr_wall_ms"],
     out["qr_top"]) = _profile(lambda: db.query_range(BENCH_TENANT, req))
    if db.plane_stats["fused_metric_blocks"] < 4 or _fallbacks(db):
        raise AssertionError(f"phase 10b profiles: {db.plane_stats}")
    # the host engine's grids (the plane off): the batched flush's dense
    # add on the card
    (out["qr_host_device_ms"], out["qr_host_launches"],
     out["qr_host_wall_ms"], out["qr_host_top"]) = _profile(
        lambda: db_host.query_range(BENCH_TENANT, req))
    db_host.shutdown()
    scan, _, mreq, preds, greq, m = _scan_setup(db)
    plane = BlockScanPlane(scan)
    (out["mask_device_ms"], out["mask_launches"], _,
     out["mask_top"]) = _profile(lambda: plane.mask(preds, mreq.all_conditions))
    (out["grid_device_ms"], out["grid_launches"], _,
     out["grid_top"]) = _profile(_grid_call(plane, m, greq,
                                            "phase 10b profiles"))
    # phase 11b: a warm frontend rate query, the cutoff inside the block
    w0 = t_base / 1e9
    fe = _frontend(db, None, lambda: w0 + 1200.0)
    (out["fe_device_ms"], out["fe_launches"], out["fe_wall_ms"],
     out["fe_top"]) = _profile(lambda: fe.query_range(
        BENCH_TENANT, req.query, start_s=w0, end_s=w0 + 900.0, step_s=60.0))
    fe.shutdown()
    # phase 11c: one query's per-row-group offload masks on the card
    from tempo_tpu_torch.block.fetch import scan_views
    from tempo_tpu_torch.block.reader import BackendBlock

    meta = db.blocklist.metas(BENCH_TENANT)[0]
    views = [v for v, _ in scan_views(BackendBlock(db.r, meta),
                                      device=db.device)]
    (out["offload_device_ms"], out["offload_launches"],
     out["offload_wall_ms"], out["offload_top"]) = offload_profile(
        views, OFFLOAD_QUERIES[1])
    db.shutdown()
    return out


def _profiles_in_child(ctx, *args) -> dict:
    """`chip_smoke.py --phase10-profiles` (or the flag and arguments
    given) in a process of its own; its PROFILES line."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                          *(args or ("--phase10-profiles",))], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("PROFILES ")]
    if out.returncode != 0 or not lines:
        raise AssertionError(f"{ctx}: the profiling process failed "
                             f"({out.returncode}): {out.stderr[-2000:]}")
    return json.loads(lines[-1][len("PROFILES "):])


def _bench_traces(n, t_base):
    """bench_query's block (`bench.py:352-371`, the same generator and
    seed): n one-span traces over 600 s; also (service, start, duration)
    columns for the exact-quantile oracle."""
    rng = np.random.default_rng(1)
    cols = {"service": np.empty(n, np.int64), "start": np.empty(n, np.int64),
            "dur": np.empty(n, np.int64)}
    traces = []
    for i in range(n):
        tid = rng.bytes(16)
        start = t_base + int(rng.integers(0, int(600 * 1e9)))
        span = {
            "trace_id": tid, "span_id": rng.bytes(8),
            "name": f"op-{int(rng.integers(0, 64))}",
            "service": f"svc-{int(rng.integers(0, 16))}",
            "kind": int(rng.integers(1, 6)),
            "status_code": int(rng.integers(0, 3)),
            "start_unix_nano": start,
            "end_unix_nano": start + int(rng.lognormal(16, 1.0)),
            "attrs": {"http.status_code": int(rng.integers(200, 500))},
            "res_attrs": {"service.name": f"svc-{int(rng.integers(0, 16))}"},
        }
        traces.append((tid, [span]))
        cols["service"][i] = int(span["service"][4:])
        cols["start"][i] = start
        cols["dur"][i] = span["end_unix_nano"] - start
    return traces, cols


def phase_query_bench(card):
    """Phase 10b: the reference's own query benchmark (`bench_query`) at its
    size, then `_bench_scan_plane`'s shape over >= 1M resident spans; the
    block lives under `build/` for the phase."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase10-",
                                     dir=os.path.join(ROOT, "build")) as root:
        return _phase_query_bench(card, root)


def _phase_query_bench(card, root):
    import torch

    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.block.device_scan import BlockScanPlane
    from tempo_tpu_torch.block.fetch import condition_mask
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.ops.moments import use_query_tier
    from tempo_tpu_torch.traceql.engine_metrics import (MetricsEvaluator,
                                                        QueryRangeRequest)

    ctx = "phase 10b"
    t_phase = time.perf_counter()
    out = {}
    now_s = time.time()
    t_base = int((now_s - 1800) * 1e9)
    traces, cols = _bench_traces(N_BENCH_SPANS, t_base)
    be = LocalBackend(root)
    db = TempoDB(be, be)
    t0 = time.perf_counter()
    db.write_block(BENCH_TENANT, traces, replication_factor=1)
    out["write_s"] = time.perf_counter() - t0
    del traces
    db.poll_now()
    db_host = TempoDB(be, be, TempoDBConfig(device_plane=False))
    db_host.poll_now()
    out["row_groups"] = db.blocks(BENCH_TENANT)[0].row_group_count
    win = (t_base, t_base + 900 * 10**9, 60 * 10**9)
    req = QueryRangeRequest("{ } | rate() by (resource.service.name)", *win)
    qreq = QueryRangeRequest("{ } | quantile_over_time(duration, .99) by "
                             "(resource.service.name)", *win)
    search = "{ span.http.status_code >= 400 }"
    B = BENCH_TENANT

    def run_search(d):
        return d.search(B, search, limit=20, start_s=t_base / 1e9,
                        end_s=now_s)

    # adoption: the first query reads the block and uploads its columns
    h0 = _h2d_bytes()
    t0 = time.perf_counter()
    first = db.query_range(B, req)
    out["adopt_s"] = time.perf_counter() - t0
    out["adopt_h2d_bytes"] = _h2d_bytes() - h0
    f0 = db.plane_stats["fused_metric_blocks"]
    for r, name in ((req, "rate"), (qreq, "quantile")):
        a = _series_map(db.query_range(B, r))
        b = _series_map(db_host.query_range(B, r))
        _same_series(a, b, True, f"{ctx} {name}: plane on vs off")
    _same_series(_series_map(first), _series_map(db.query_range(B, req)),
                 True, f"{ctx} rate: adoption vs warm")
    s_on = [m.to_json() for m in run_search(db)]
    s_off = [m.to_json() for m in run_search(db_host)]
    if len(s_on) != 20 or s_on != s_off:
        raise AssertionError(f"{ctx}: search on/off differ ({len(s_on)})")
    _check_fused(db, f0, 3, f"{ctx} plane-on queries")
    h0 = _h2d_bytes()
    f0 = db.plane_stats["fused_metric_blocks"]
    out["rate_ms"] = _timed_ms(lambda: db.query_range(B, req))
    out["h2d_bytes_per_query"] = (_h2d_bytes() - h0) / 4
    out["quantile_ms"] = _timed_ms(lambda: db.query_range(B, qreq))
    out["search_ms"] = _timed_ms(lambda: run_search(db))
    _check_fused(db, f0, 8, f"{ctx} timed plane-on queries")
    # the plane-off queries are checked above and not timed here (the
    # smoke's time, ROADMAP "The smoke's time"); the profiling process
    # times the plane-off rate query
    # the moments query tier rides the fused moments grid
    f0 = db.plane_stats["fused_metric_blocks"]
    with use_query_tier("moments"):
        out["quantile_moments_ms"] = _timed_ms(
            lambda: db.query_range(B, qreq))
        raw = db.query_range(B, qreq)
        raw_again = db.query_range(B, qreq)
        raw_host = db_host.query_range(B, qreq)
    _check_fused(db, f0, 6, f"{ctx} moments tier")
    _moment_rows_agree(_series_map(raw), _series_map(raw_host),
                       f"{ctx} moments rows, plane vs host engine")
    out.update(_moments_tier_checks(
        _final(raw, qreq), _final(raw_again, qreq), _final(raw_host, qreq),
        _final(db_host.query_range(B, qreq), qreq), cols, t_base, win[2],
        ctx))
    out["plane_stats"] = dict(db.plane_stats)
    out["cache"] = db.planes.stats()
    # _bench_scan_plane: the block's views repeated to >= 1M resident spans
    scan, reps, mreq, preds, greq, m = _scan_setup(db)
    out["scan_spans"] = sum(v.n for v in scan)
    [condition_mask(v, mreq) for v in scan]                    # warm-up
    t0 = time.perf_counter()
    np_mask = np.concatenate([condition_mask(v, mreq) for v in scan])
    out["mask_numpy_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plane = BlockScanPlane(scan)
    dev_mask = plane.mask(preds, mreq.all_conditions)        # adoption
    out["scan_adopt_s"] = time.perf_counter() - t0
    out["mask_ms"] = _timed_ms(lambda: plane.mask(preds, mreq.all_conditions))
    dev_mask = plane.mask(preds, mreq.all_conditions)
    if dev_mask is None or not np.array_equal(dev_mask, np_mask):
        raise AssertionError(f"{ctx}: device mask over {out['scan_spans']} "
                             f"spans differs from condition_mask")
    out["mask_rows_matched"] = int(dev_mask.sum())
    out["mask_spans_per_s"] = out["scan_spans"] / (out["mask_ms"] / 1e3)
    grid = _grid_call(plane, m, greq, ctx)
    out["grid_ms"] = _timed_ms(grid)
    labels, main, _cnt, _vcnt = grid()
    ev = MetricsEvaluator(greq, batched=True)
    t0 = time.perf_counter()
    for v in scan:
        ev.observe(v)
    eng = {dict(s.labels)["resource.service.name"]: s.samples
           for s in ev.results()}
    out["engine_1m_ms"] = (time.perf_counter() - t0) * 1e3
    for gi, lbl in enumerate(labels):
        if not np.array_equal(main[gi].astype(np.float64),
                              eng.get(lbl, np.zeros(main.shape[1]))):
            raise AssertionError(f"{ctx}: 1M grid row {lbl} differs from "
                                 f"the host engine")
    if int(main.sum()) != out["scan_spans"]:
        raise AssertionError(f"{ctx}: the 1M grid counted {main.sum()}")
    out["scan_plane_device_bytes"] = plane.device_bytes
    del plane, scan
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    s11b = _phase_frontend_metrics(db, be, t_base)
    s11c = _phase_offload(db_host, be)
    t11 = time.perf_counter() - t11
    db.shutdown()
    db_host.shutdown()
    out.update(_profiles_in_child(ctx))
    out["qr_idle_share"] = None if out["qr_device_ms"] is None else \
        1.0 - out["qr_device_ms"] / out["qr_wall_ms"]
    out["seconds"] = time.perf_counter() - t_phase - t11
    c = out["cache"]
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"  # noqa: E731
    print(f"phase 10b [{card}]: bench_query's block ({N_BENCH_SPANS} one-span "
          f"traces, {out['row_groups']} row groups) written in "
          f"{out['write_s']:.2f} s; "
          f"adoption (first rate query: block read + column uploads of "
          f"{out['adopt_h2d_bytes']} bytes) {out['adopt_s']:.3f} s; ms a "
          f"query, plane on: rate by service {out['rate_ms']:.3f}, "
          f"quantile_over_time(duration, .99) {out['quantile_ms']:.3f}, "
          f"search (span.http.status_code >= 400, limit 20) "
          f"{out['search_ms']:.3f}; moments tier quantile "
          f"{out['quantile_moments_ms']:.3f} ms (fused), q99 against the "
          f"exact quantile median rel err {out['moments_err_median']:.4f}, "
          f"max {out['moments_err_max']:.4f}, against the log2 tier's "
          f"host answer within a factor {out['moments_vs_log2_max']:.4f}; "
          f"moment rows equal to the host engine's within ROADMAP's row "
          f"tolerance, q99 beyond rtol 1e-3 of the host engine's in "
          f"{out['moments_vs_host_over']} of {out['moments_cells']} cells "
          f"(max rel {out['moments_vs_host_max']:.3e}), of the same fused "
          f"query run again max rel {out['moments_again_max']:.3e}; H2D a "
          f"warm rate query "
          f"{out['h2d_bytes_per_query']:.0f} bytes; PlaneCache device bytes "
          f"{c['device_bytes']} of a {c['device_budget_bytes']} budget "
          f"({c['entries']} entries); warm rate query_range (torch.profiler, "
          f"a process of its own): device {fmt(out['qr_device_ms'])} ms of "
          f"{out['qr_wall_ms']:.3f} ms wall, {out['qr_launches']:.0f} device "
          f"ops, idle share {fmt(out['qr_idle_share'])}; the plane off "
          f"(host engine): device {fmt(out['qr_host_device_ms'])} ms of "
          f"{out['qr_host_wall_ms']:.3f} ms wall, "
          f"{out['qr_host_launches']:.0f} device ops (longest "
          f"{out['qr_host_top'][0]} {out['qr_host_top'][1]:.4f} ms)")
    print(f"phase 10b [{card}]: >= 1M resident spans ({out['scan_spans']}, "
          f"the block's views x{reps}, adoption {out['scan_adopt_s']:.2f} s, "
          f"{out['scan_plane_device_bytes']} device bytes): mask "
          f'{{ name =~ "op-1." && duration > 20ms }} {out["mask_ms"]:.3f} ms '
          f"({out['mask_spans_per_s']:.0f} spans/s; numpy condition_mask "
          f"{out['mask_numpy_ms']:.1f} ms), {out['mask_rows_matched']} rows, "
          f"device {fmt(out['mask_device_ms'])} ms in "
          f"{out['mask_launches']:.0f} device ops (longest "
          f"{out['mask_top'][0]} {out['mask_top'][1]:.4f} ms); metrics_grid "
          f"rate by service {out['grid_ms']:.3f} ms with its fetch (host "
          f"engine {out['engine_1m_ms']:.1f} ms), device "
          f"{fmt(out['grid_device_ms'])} ms in {out['grid_launches']:.0f} "
          f"device ops (longest {out['grid_top'][0]} "
          f"{out['grid_top'][1]:.4f} ms); phase {out['seconds']:.1f} s")
    print(f"phase 10b checks: rate and quantile equal plane on and off; the "
          f"search's 20 results equal; every plane-on query fused, no "
          f"fallback ({out['plane_stats']}); the moments tier fused; the 1M "
          f"device mask equal to condition_mask on every row; the 1M grid "
          f"equal to the host engine row by row")
    fe_idle = None if out["fe_device_ms"] is None else \
        1.0 - out["fe_device_ms"] / out["fe_wall_ms"]
    print(f"phase 11b [{card}]: Frontend.query_range (default "
          f"FrontendConfig, the backend cutoff 300 s into the block) over "
          f"10b's RF1 block, rate by service: "
          f"{s11b['frontend_ms']:.3f} ms warm against "
          f"{s11b['tempodb_ms']:.3f} ms for TempoDB.query_range clipped at "
          f"the cutoff with the final pass (the frontend's own cost "
          f"{s11b['frontend_ms'] - s11b['tempodb_ms']:.3f} ms); through "
          f"start_workers(2): queue_wait {s11b['queue_wait_ms']:.4f} ms, "
          f"stages (ms, merged QueryStats) {json.dumps(s11b['stages_ms'])}; "
          f"warm frontend rate query (torch.profiler, the profiling "
          f"process): device {fmt(out['fe_device_ms'])} ms of "
          f"{out['fe_wall_ms']:.3f} ms wall, {out['fe_launches']:.0f} device "
          f"ops, idle share {fmt(fe_idle)}; phase {s11b['seconds']:.1f} s")
    print(f"phase 11b checks: rate and quantile_over_time(duration, .99) by "
          f"service through the frontend equal to TempoDB.query_range "
          f"clipped at the cutoff after SeriesCombiner.final and to a CPU "
          f"twin; one fused job each, no fallback; compaction_stats 0 folds "
          f"and 0 fallbacks (no sidecar); with a CacheProvider the second "
          f"query hit the job cache and gave the same series; the rate "
          f"counted {s11b['rate_spans']} spans before the cutoff")
    q_mask = OFFLOAD_QUERIES[1]
    print(f"phase 11c [{card}]: TEMPO_TPU_DEVICE_SCAN=1 with the plane off "
          f"over 10b's block ({s11c['row_groups']} row groups): "
          + "; ".join(f"{q} {v['launches']} mask launches in a search, "
                      f"{v['masks']} of {s11c['row_groups']} row groups "
                      f"offloaded" for q, v in s11c.items()
                      if q in OFFLOAD_QUERIES)
          + f"; the mask {q_mask} over every row group (torch.profiler): "
          f"device {fmt(out['offload_device_ms'])} ms, "
          f"{out['offload_launches']:.0f} device ops, wall "
          f"{out['offload_wall_ms']:.3f} ms, longest {out['offload_top'][0]} "
          f"{out['offload_top'][1]:.4f} ms; bound {s11c['bound_ms']:.6f} ms "
          f"by bytes ({s11c['bound_bytes']} bytes at 3.35 TB/s); phase "
          f"{s11c['seconds']:.1f} s")
    print(f"phase 11c checks: each search equal with the offload and "
          f"without; every row-group mask on the card bit-equal to the CPU "
          f"path's; the attribute search refused by the offload (the "
          f"reference's refusal), the name/duration mask offloaded on every "
          f"row group")
    out["11b"], out["11c"], out["11_seconds"] = s11b, s11c, t11
    return out


# ---------------------------------------------------------------------------
# phase 11: the query frontend and the querier over the port's TempoDB
# ---------------------------------------------------------------------------

N_FIND_RECENT = 64               # recent trace ids found through 11a


def _frontend(db, ing, now_fn, cache=False):
    """`Frontend` over a `Querier` (the reference's default configs: rf 3)
    whose ring holds one ingester, or none."""
    from tempo_tpu_torch.backend import CacheProvider
    from tempo_tpu_torch.frontend import Frontend
    from tempo_tpu_torch.querier import Querier
    from tempo_tpu_torch.ring import ACTIVE, InstanceDesc, Ring
    from tempo_tpu_torch.ring.ring import _instance_tokens

    ring, clients = None, {}
    if ing is not None:
        ring = Ring(replication_factor=3, now=now_fn)
        ring.register(InstanceDesc(id=ing.id, state=ACTIVE,
                                   tokens=_instance_tokens(ing.id, 128),
                                   heartbeat_ts=now_fn()))
        clients = {ing.id: ing}
    return Frontend(db, Querier(db, ring, clients, now=now_fn),
                    cache_provider=CacheProvider() if cache else None,
                    now=now_fn)


def _md(res):
    return [m.to_json() for m in res]


def phase_frontend_search(store, handoff, card):
    """Phase 11a: search, find and tags through `Frontend` over phase 9's
    flushed store (RF3 ingester blocks) and one fresh ingester holding an
    uncut 16,384-span payload of the same traffic; the data directory
    lives under `build/` for the phase."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase11-",
                                     dir=os.path.join(ROOT, "build")) as root:
        return _phase_frontend_search(store, handoff, card, root)


def _phase_frontend_search(store, handoff, card, root):
    import torch

    from tempo_tpu_torch.db import TempoDB
    from tempo_tpu_torch.device import resolve_device
    from tempo_tpu_torch.frontend.sharders import time_windows
    from tempo_tpu_torch.ingester import Ingester
    from tempo_tpu_torch.model.combine import combine_spans, sort_spans
    from tempo_tpu_torch.overrides import Overrides

    ctx = "phase 11a"
    t_phase = time.perf_counter()
    t, want, picks = handoff["tenant"], handoff["read_want"], handoff["picks"]
    # the clock sits 1,000 s after phase 9's spans: its blocks lie behind
    # the backend cutoff (now - 900 s), the recent payload inside the
    # ingesters' window (now - 1,800 s onwards)
    clock = handoff["now_ns"] / 1e9 + 1000.0
    now = lambda: clock  # noqa: E731
    ov = Overrides()
    ov.set_tenant_patch(t, {"ingestion": dict(UNLIMITED)})
    ing = Ingester(os.path.join(root, "recent"), overrides=ov, now=now,
                   instance_id="recent-0")
    recent = deep_trace_spans(N_SPANS, seed=SEED + 110,
                              now_ns=int((clock - 100.0) * 1e9))
    by_trace = {}
    for s in recent:
        by_trace.setdefault(s["trace_id"], []).append(s)
    errs = [e for e in ing.push(t, list(by_trace.items())) if e is not None]
    if errs:
        raise AssertionError(f"{ctx}: the recent payload was refused: {errs}")
    card_db = TempoDB(store, store)
    cpu_db = TempoDB(store, store, device="cpu")
    if card_db.device != resolve_device():
        raise AssertionError(f"{ctx}: TempoDB on {card_db.device}")
    for db in (card_db, cpu_db):
        db.poll_now()
    fe, twin = _frontend(card_db, ing, now), _frontend(cpu_db, ing, now)
    start, end = handoff["now_ns"] / 1e9 - 600.0, clock
    ing_win, be_win = time_windows(clock, start, end)
    searches = ("{ span.http.status_code >= 500 }",
                '{ span.cache.hit = true && resource.host.name = "host-1" '
                '&& duration > 1ms }')
    rng = np.random.default_rng(SEED + 111)
    recent_ids = [list(by_trace)[int(i)] for i in rng.choice(
        len(by_trace), N_FIND_RECENT, replace=False)]
    recent_want = {tid: sort_spans(combine_spans(
        ing.find_trace_by_id(t, tid))) for tid in recent_ids}
    for tid, got in recent_want.items():
        if sorted(s["span_id"] for s in got) != \
                sorted(s["span_id"] for s in by_trace[tid]):
            raise AssertionError(f"{ctx}: the ingester lost spans of "
                                 f"{tid.hex()}")
    out = {"blocks": len(card_db.blocks(t))}
    # every match of each search, from TempoDB.search over the backend
    # window and Ingester.search over the recent one, called directly
    direct = {q: {m.trace_id for m in card_db.search(
        t, q, limit=1 << 20, start_s=be_win[0], end_s=be_win[1])}
        | {m.trace_id for m in ing.search(t, q, 1 << 20, *ing_win)}
        for q in searches}

    def run(f, label, times=None):
        res = {}
        for q in searches:
            got = f.search(t, q, limit=20, start_s=start, end_s=end)
            if len(got) != 20:
                raise AssertionError(f"{ctx} {label}: {q!r} gave "
                                     f"{len(got)} of 20")
            res[q] = _md(got)
            every = {m.trace_id for m in f.search(
                t, q, limit=1 << 20, start_s=start, end_s=end)}
            if every != direct[q] or not every & {
                    tid.hex() for tid in recent_want}:
                raise AssertionError(
                    f"{ctx} {label}: {q!r}: {len(every)} traces through the "
                    f"frontend, {len(direct[q])} from TempoDB.search and "
                    f"Ingester.search called directly")
        for tid in picks:
            t0 = time.perf_counter()
            got = f.find_trace(t, tid)
            if times is not None:
                times.append((time.perf_counter() - t0) * 1e3)
            if got != want[tid] or \
                    sort_spans(card_db.find_trace_by_id(t, tid)) != want[tid]:
                raise AssertionError(f"{ctx} {label}: trace {tid.hex()} "
                                     f"differs from phase 9's host decode")
        for tid in recent_ids:
            if f.find_trace(t, tid) != recent_want[tid]:
                raise AssertionError(f"{ctx} {label}: recent trace "
                                     f"{tid.hex()} differs from "
                                     f"Ingester.find_trace_by_id")
        res["tags"] = f.tag_names(t)
        res["values"] = f.tag_values(t, "resource.service.name")
        if not res["tags"].get("span") or len(res["values"]) != 16:
            raise AssertionError(f"{ctx} {label}: tags {res['tags']}, "
                                 f"{len(res['values'])} service values")
        return res

    inline = run(fe, "inline")
    if run(twin, "CPU twin") != inline:
        raise AssertionError(f"{ctx}: the card stack and its CPU twin differ")
    fe.start_workers(2)
    times = []
    if run(fe, "workers", times) != inline:
        raise AssertionError(f"{ctx}: the worker pool's answers differ from "
                             f"the inline ones")
    out["find_ms"] = statistics.median(times)
    out["search_ms"] = _timed_ms(lambda: fe.search(
        t, searches[0], limit=20, start_s=start, end_s=end))
    out["tags_ms"] = _timed_ms(lambda: fe.tag_names(t))
    out["values_ms"] = _timed_ms(
        lambda: fe.tag_values(t, "resource.service.name"))
    for f in (fe, twin):
        f.shutdown()
    for db in (card_db, cpu_db):
        db.shutdown()
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11a [{card}]: Frontend (default FrontendConfig) over a "
          f"Querier (rf 3) and TempoDB on the card: phase 9's "
          f"{out['blocks']} flushed blocks behind the cutoff and one "
          f"ingester holding {N_SPANS} uncut spans ({len(by_trace)} "
          f"traces); ms through the frontend, workers on: find "
          f"{out['find_ms']:.3f} (median of {len(picks)}), search "
          f"{out['search_ms']:.3f} (limit 20, both legs), tag_names "
          f"{out['tags_ms']:.3f}, tag_values(resource.service.name) "
          f"{out['values_ms']:.3f}; phase {out['seconds']:.1f} s")
    print(f"phase 11a checks: {len(searches)} searches (limit 20) and "
          f"{len(picks)} + {N_FIND_RECENT} finds, tag_names and tag_values "
          f"equal inline, through start_workers(2) and on a CPU twin of the "
          f"stack (inline); each search's every match equal to TempoDB.search over "
          f"the backend window with Ingester.search over the recent one; "
          f"each find equal to phase 9's host decode and "
          f"TempoDB.find_trace_by_id (a recent one: to "
          f"Ingester.find_trace_by_id, every span of the payload)")
    return out


def _phase_frontend_metrics(db, be, t_base):
    """Phase 11b: TraceQL metrics through `Frontend` over 10b's RF1 block,
    the backend cutoff inside the window and inside the block."""
    from tempo_tpu_torch.db import TempoDB
    from tempo_tpu_torch.obs import querystats
    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

    ctx = "phase 11b"
    t_phase = time.perf_counter()
    B = BENCH_TENANT
    w0, w1, step = t_base / 1e9, t_base / 1e9 + 900.0, 60.0
    clock = w0 + 300.0 + 900.0          # the cutoff: 300 s into the block
    now = lambda: clock  # noqa: E731
    cutoff_ns = int((clock - 900.0) * 1e9)
    cpu_db = TempoDB(be, be, device="cpu")
    cpu_db.poll_now()
    fe, twin = _frontend(db, None, now), _frontend(cpu_db, None, now)
    queries = ("{ } | rate() by (resource.service.name)",
               "{ } | quantile_over_time(duration, .99) by "
               "(resource.service.name)")
    out = {}
    for q in queries:
        req = QueryRangeRequest(q, int(w0 * 1e9), int(w1 * 1e9),
                                int(step * 1e9))
        f0 = db.plane_stats["fused_metric_blocks"]
        got = _series_map(fe.query_range(B, q, start_s=w0, end_s=w1,
                                         step_s=step))
        if db.plane_stats["fused_metric_blocks"] != f0 + 1 or _fallbacks(db):
            raise AssertionError(f"{ctx} {q}: not one fused job "
                                 f"({db.plane_stats})")
        want = _series_map(_final(db.query_range(B, req,
                                                 clip_end_ns=cutoff_ns), req))
        _same_series(got, want, True, f"{ctx} {q}: frontend vs TempoDB "
                     f"clipped at the cutoff")
        _same_series(got, _series_map(twin.query_range(
            B, q, start_s=w0, end_s=w1, step_s=step)), True,
            f"{ctx} {q}: card vs CPU twin")
        if "rate" in q:
            n = sum(v.sum() for v in got.values()) * step
            out["rate_spans"] = int(round(n))
    if any(db.compaction_stats.values()):
        raise AssertionError(f"{ctx}: the fold tier (or the cold tier) "
                             f"moved with no sidecar: {db.compaction_stats}")
    # the job cache: under the real clock the block lies behind the cutoff
    # (cacheable); the second query is a hit and gives the same series
    cached = _frontend(db, None, time.time, cache=True)
    a = cached.query_range(B, queries[0], start_s=w0, end_s=w1, step_s=step)
    hits = cached.cache_stats["hits"]
    b = cached.query_range(B, queries[0], start_s=w0, end_s=w1, step_s=step)
    if cached.cache_stats["hits"] != hits + 1:
        raise AssertionError(f"{ctx}: the second query missed the job cache "
                             f"({cached.cache_stats})")
    _same_series(_series_map(a), _series_map(b), True,
                 f"{ctx}: cached vs computed")
    cached.shutdown()
    req = QueryRangeRequest(queries[0], int(w0 * 1e9), int(w1 * 1e9),
                            int(step * 1e9))
    out["frontend_ms"] = _timed_ms(lambda: fe.query_range(
        B, queries[0], start_s=w0, end_s=w1, step_s=step))
    out["tempodb_ms"] = _timed_ms(lambda: _final(db.query_range(
        B, req, clip_end_ns=cutoff_ns), req))
    fe.start_workers(2)
    fe.query_range(B, queries[0], start_s=w0, end_s=w1, step_s=step)
    with querystats.scope() as st:
        fe.query_range(B, queries[0], start_s=w0, end_s=w1, step_s=step)
    out["queue_wait_ms"] = st.stage_ns.get("queue_wait", 0) / 1e6
    out["stages_ms"] = {k: v / 1e6 for k, v in sorted(st.stage_ns.items())}
    if "queue_wait" not in st.stage_ns or st.completed_jobs != 1:
        raise AssertionError(f"{ctx}: worker-pool stats {st.to_json()}")
    fe.shutdown()
    twin.shutdown()
    cpu_db.shutdown()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _phase_offload(db_host, be):
    """Phase 11c: the opt-in per-row-group offload of `condition_mask`
    (TEMPO_TPU_DEVICE_SCAN=1) with the plane off, on and off."""
    from tempo_tpu_torch.block import device_scan
    from tempo_tpu_torch.block.fetch import scan_views
    from tempo_tpu_torch.block.reader import BackendBlock
    from tempo_tpu_torch.traceql.engine import compile_query

    ctx = "phase 11c"
    t_phase = time.perf_counter()
    B = BENCH_TENANT
    meta = db_host.blocks(B)[0]
    views_card = [v for v, _ in scan_views(BackendBlock(be, meta),
                                           device=db_host.device)]
    views_cpu = [v for v, _ in scan_views(BackendBlock(be, meta),
                                          device="cpu")]
    out = {"row_groups": len(views_card)}
    prev = os.environ.pop("TEMPO_TPU_DEVICE_SCAN", None)
    try:
        for q in OFFLOAD_QUERIES:
            off = [m.to_json() for m in db_host.search(B, q, limit=20)]
            os.environ["TEMPO_TPU_DEVICE_SCAN"] = "1"
            n0 = device_scan.device_pred_mask.launches
            on = [m.to_json() for m in db_host.search(B, q, limit=20)]
            launches = device_scan.device_pred_mask.launches - n0
            _, req = compile_query(q)
            preds = [c for c in req.conditions if c.op is not None]
            masks = 0
            for vc, vh in zip(views_card, views_cpu):
                a = device_scan.device_pred_mask(vc, preds,
                                                 req.all_conditions)
                b = device_scan.device_pred_mask(vh, preds,
                                                 req.all_conditions)
                if (a is None) != (b is None) or (
                        a is not None and not np.array_equal(a, b)):
                    raise AssertionError(f"{ctx} {q!r}: a row-group mask on "
                                         f"the card differs from the CPU "
                                         f"path")
                masks += a is not None
            del os.environ["TEMPO_TPU_DEVICE_SCAN"]
            if on != off or not on:
                raise AssertionError(f"{ctx} {q!r}: {len(on)} results with "
                                     f"the offload, {len(off)} without")
            out[q] = {"launches": launches, "masks": masks}
    finally:
        if prev is None:
            os.environ.pop("TEMPO_TPU_DEVICE_SCAN", None)
        else:
            os.environ["TEMPO_TPU_DEVICE_SCAN"] = prev
    if out[OFFLOAD_QUERIES[0]]["masks"] or \
            out[OFFLOAD_QUERIES[1]]["masks"] != len(views_card):
        raise AssertionError(f"{ctx}: offload coverage {out}")
    n = sum(v.n for v in views_card)
    # bytes the mask must move a query: the int32 name codes and float32
    # durations read once, one bool a row written, the name LUT read
    n_dict = sum(len(v.meta["_dict_codes"]["name"][1]) for v in views_card)
    out["bound_bytes"] = n * (4 + 4 + 1) + n_dict
    out["bound_ms"] = out["bound_bytes"] / HBM_BYTES_PER_S * 1e3
    out["seconds"] = time.perf_counter() - t_phase
    return out


OFFLOAD_QUERIES = ("{ span.http.status_code >= 400 }",
                   '{ name =~ "op-1." && duration > 20ms }')


def offload_profile(views, q) -> tuple:
    """(device ms, device ops, wall ms, longest op) of one query's
    per-row-group offload masks over `views`, warm, under torch.profiler."""
    from tempo_tpu_torch.block import device_scan
    from tempo_tpu_torch.traceql.engine import compile_query

    _, req = compile_query(q)
    preds = [c for c in req.conditions if c.op is not None]
    prev = os.environ.get("TEMPO_TPU_DEVICE_SCAN")
    os.environ["TEMPO_TPU_DEVICE_SCAN"] = "1"
    try:
        return _profile(lambda: [device_scan.device_pred_mask(
            v, preds, req.all_conditions) for v in views])
    finally:
        if prev is None:
            del os.environ["TEMPO_TPU_DEVICE_SCAN"]
        else:
            os.environ["TEMPO_TPU_DEVICE_SCAN"] = prev


# ---------------------------------------------------------------------------
# phase 12: the ingest-storage path — the generator's local blocks (the
# recent window) and the block-builder's sketch sidecars (the history)
# ---------------------------------------------------------------------------

LB_TENANT = "lb-0"
N_BUS_PARTITIONS = 4
N_LB_PUSHES = 1                  # history pushes, then as many recent ones
                                 # (2 before phase 13, cut to make room)
LB_RECENT_S = 1200.0             # the clock moves 20 minutes between legs
LB_RATE = "{ } | rate() by (resource.service.name)"
LB_QUANT = ("{ } | quantile_over_time(duration, .5, .99) by "
            "(resource.service.name)")
HLL_REL_MAX = 0.10               # about 3 sigma of the estimate at p = 10
QUANT_GATE = 0.05                # tests/test_compact.py:246-263


def _lb_payloads(t0):
    """[history, recent] lists of OTLP payloads of `deep_trace_spans`,
    stamped within 10 s before `t0` and before `t0 + LB_RECENT_S`."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    return [[encode_spans_otlp(deep_trace_spans(
        N_SPANS, seed=SEED + 120 + 2 * leg + k, now_ns=int(at * 1e9)))
        for k in range(N_LB_PUSHES)]
        for leg, at in enumerate((t0, t0 + LB_RECENT_S))]


class _LbRig:
    """The ingest-storage deployment of one tenant on `device`, on its own
    clock: an in-memory `Bus` of 4 partitions; one `Generator` of the
    default config whose tenant runs span metrics and local blocks (kept
    under `root/gen`); one `BlockBuilder` owning every partition, sidecars
    on, writing a `LocalBackend` store under `root/store`; a `TempoDB`
    over the store (the reference's default config) and a `Querier` (rf
    1, no ingester: the bus replaces them)."""

    def __init__(self, device, root, t0):
        from tempo_tpu_torch.backend import LocalBackend
        from tempo_tpu_torch.blockbuilder import (BlockBuilder,
                                                  BlockBuilderConfig)
        from tempo_tpu_torch.db import TempoDB
        from tempo_tpu_torch.generator import Generator, GeneratorConfig
        from tempo_tpu_torch.generator.processors.localblocks import \
            LocalBlocksConfig
        from tempo_tpu_torch.ingest import Bus
        from tempo_tpu_torch.overrides import Overrides
        from tempo_tpu_torch.querier import Querier
        from tempo_tpu_torch.querier.querier import QuerierConfig
        from tempo_tpu_torch.ring import Ring

        self.t0 = t0
        self.clock = [t0]
        now = self.now = lambda: self.clock[0]
        self.ov = Overrides()
        self.ov.set_tenant_patch(LB_TENANT, {
            "generator": {"processors": ["span-metrics", "local-blocks"]},
            "ingestion": dict(UNLIMITED)})
        self.bus = Bus(N_BUS_PARTITIONS)
        self.gen = Generator(GeneratorConfig(localblocks=LocalBlocksConfig(
            data_dir=os.path.join(root, "gen"))), overrides=self.ov, now=now,
            device=device)
        self.store = LocalBackend(os.path.join(root, "store"))
        self.bb = BlockBuilder(self.bus, self.store,
                               BlockBuilderConfig(partitions=None), now=now,
                               device=device)
        self.db = TempoDB(self.store, self.store, now=now, device=device)
        self.querier = Querier(self.db, Ring(replication_factor=1, now=now),
                               {}, cfg=QuerierConfig(rf=1))

    def drain(self):
        """Both consumers drain the bus (each reads at most 1,000 records a
        partition a call): (the generator's seconds, settled; the
        block-builder's)."""
        t0 = time.perf_counter()
        while self.gen.consume_bus(self.bus):
            pass
        _settle({"g": self.gen})
        t1 = time.perf_counter()
        while self.bb.consume_cycle():
            pass
        t2 = time.perf_counter()
        self.db.poll_now()
        return t1 - t0, t2 - t1

    def frontend(self, **cfg):
        from tempo_tpu_torch.frontend import Frontend, FrontendConfig

        return Frontend(self.db, self.querier, cfg=FrontendConfig(**cfg),
                        generator_query_range=self.gen.query_range,
                        now=self.now)

    def window(self):
        """One step over both legs: 600 s before the history to 60 s past
        the recent leg (the frontend's cutoff, 900 s back, lies between
        them)."""
        start, end = self.t0 - 600.0, self.clock[0] + 60.0
        return dict(start_s=start, end_s=end, step_s=end - start)

    def metas(self):
        return sorted(self.db.blocklist.metas(LB_TENANT),
                      key=lambda m: (m.start_time, m.end_time,
                                     m.total_objects))


def _sidecar_input(spans_by_trace):
    """`sidecar_from_traces`' columns of [(trace id, spans)]: per-span
    series ids of the dense (service, name) set, durations, trace ids."""
    svc, nam, dur, tid = [], [], [], []
    for t, spans in spans_by_trace:
        for s in spans:
            svc.append(s["service"])
            nam.append(s["name"])
            dur.append(s["end_unix_nano"] - s["start_unix_nano"])
            tid.append(np.frombuffer(t, np.uint8))
    comp = np.unique(np.char.add(np.char.add(np.asarray(svc), "\0"),
                                 np.asarray(nam)), return_inverse=True)[1]
    return (comp.astype(np.int32), np.asarray(dur, np.int64),
            int(comp.max()) + 1, np.stack(tid))


def _sidecar_bound(n_spans, n_series):
    """Bytes the sidecar pass must move on the card (each span's series
    id, f32 duration and two 32-bit hashes read once; the moment rows and
    the 1,024 registers written once) and its bound."""
    from tempo_tpu_torch.ops import moments as msk

    nbytes = n_spans * 16 + n_series * msk.n_cols(msk.QUERY_K) * 4 + 1024 * 4
    return (nbytes, *bound(nbytes, n_spans * (8 + 4 * msk.QUERY_K)))


def phase12_profiles(root, t0, clock) -> dict:
    """Phase 12's torch.profiler readings, in a process of its own as
    phase 10b's are: the card's stack reopened from phase 12's directory
    (the block-builder's store; the generator's local blocks replayed
    from its data directory) on the clock where the phase left it, then
    a warm frontend rate query over both legs, and the sidecar pass at
    the first history block's shape (its traces rebuilt from the seed and
    partitioned as the distributor does)."""
    from tempo_tpu_torch import native
    from tempo_tpu_torch.ingest.encoding import partition_for
    from tempo_tpu_torch.ops import compact
    from tempo_tpu_torch.ops import moments as msk
    from tempo_tpu_torch.ops.hashing import token_for

    t0, clock = float(t0), float(clock)
    rig = _LbRig("cuda", root, t0)
    rig.clock[0] = clock
    rig.db.poll_now()
    lb = rig.gen.instance(LB_TENANT).processors["local-blocks"]
    if len(lb.inst.complete_blocks()) != 1:
        raise AssertionError("phase 12 profiles: the local block did not "
                             "replay")
    fe = rig.frontend()
    w = rig.window()
    out = {}
    (out["fe_device_ms"], out["fe_launches"], out["fe_wall_ms"],
     out["fe_top"]) = _profile(lambda: fe.query_range(LB_TENANT, LB_RATE,
                                                      **w))
    if not rig.db.compaction_stats["sidecar_folds"]:
        raise AssertionError("phase 12 profiles: no sidecar fold")
    fe.shutdown()
    by: dict = {}
    for data in _lb_payloads(t0)[0]:
        for sp in native.spans_from_otlp_proto_native(data):
            by.setdefault(sp["trace_id"], []).append(sp)
    tids = sorted(by)
    mat = np.stack([np.frombuffer(t, np.uint8) for t in tids])
    part = partition_for(token_for(LB_TENANT, mat), N_BUS_PARTITIONS)
    block = [(t, by[t]) for t, p in zip(tids, part) if p == 0]
    sids, dur, n_series, tid = _sidecar_input(block)
    lo = min(s["start_unix_nano"] for _, sp in block for s in sp) / 1e9
    hi = max(s["end_unix_nano"] for _, sp in block for s in sp) / 1e9
    if len([m for m in rig.metas() if m.total_spans == len(dur)
            and m.total_objects == len(block)
            and abs(m.start_time - lo) < 1e-3
            and abs(m.end_time - hi) < 1e-3]) != 1:
        raise AssertionError("phase 12 profiles: the rebuilt block of "
                             "partition 0 matches no history block")
    (out["sc_device_ms"], out["sc_launches"], out["sc_wall_ms"],
     out["sc_top"]) = _profile(lambda: compact.build_sidecar_arrays(
        sids, dur, n_series, tid, msk.QUERY_K, msk.QUERY_LO, msk.QUERY_HI,
        device="cuda"))
    out["sc_spans"], out["sc_series"] = len(dur), n_series
    (out["sc_bound_bytes"], out["sc_bound_ms"],
     out["sc_bound_by"]) = _sidecar_bound(len(dur), n_series)
    rig.db.shutdown()
    return out


def _print_phase12(r, card):
    p = r["prof"]
    n = 2 * N_LB_PUSHES * N_SPANS
    sec = r["secs"]

    def dev(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"
    print(f"phase 12a [{card}]: Distributor.push_otlp onto a {N_BUS_PARTITIONS}"
          f"-partition Bus ({r['records']} records, {n} spans in "
          f"{2 * N_LB_PUSHES} pushes) {n / sec['push']:.0f} spans/s; "
          f"Generator.consume_bus into span metrics and local blocks "
          f"{n / sec['generator']:.0f} spans/s ({sec['generator']:.3f} s); "
          f"BlockBuilder.consume_cycle with sidecars on the card "
          f"{n / sec['blockbuilder']:.0f} spans/s ({sec['blockbuilder']:.3f} "
          f"s); the local cut (tick, immediate) {r['cut_s']:.3f} s; K1 "
          f"launches {r['launches']} for {r['dispatches']} merged dispatches, "
          f"device time at a window {r['k1_device_ms']} ms")
    print(f"phase 12a checks: {2 * N_BUS_PARTITIONS} RF1 blocks with a "
          f"sidecar each, HLL registers equal bit for bit to the CPU twin's, "
          f"moment counts exact, bounds within rtol 2e-6 "
          f"({r['bounds_off'][0]} of {r['bounds_off'][1]} bound cells one "
          f"f32 log apart) and sums within the rows' tolerance; HLL "
          f"estimates within {r['hll_worst'] * 100:.2f}% of "
          f"each block's distinct traces (limit {HLL_REL_MAX * 100:.0f}%), "
          f"the merged history {r['hll_hist']:.1f} of {r['n_hist']}; every "
          f"span received, none filtered by the slack")
    print(f"phase 12b checks: Frontend (default FrontendConfig) over both "
          f"legs: {r['folds']} sidecar folds, 0 fallbacks; rate by service "
          f"equal to a sidecar_folds=False rescan and to the CPU twin, every "
          f"span counted; quantile_over_time(duration, .5, .99) over "
          f"{r['n_series']} services within the moments gate (largest "
          f"min(rel, rank) {r['q_err']:.4f}, limit {QUANT_GATE}), "
          f"{r['q_rel']:.3g} relative from the twin; rate and quantiles the "
          f"same before and after the local cut")
    print(f"phase 12b [{card}]: a warm Frontend.query_range rate by service "
          f"over both legs {r['fe_ms']:.3f} ms; in the profiling process "
          f"{p['fe_wall_ms']:.3f} ms of wall, device {dev(p['fe_device_ms'])} "
          f"in {p['fe_launches']:.0f} ops, idle share "
          + ("not measured" if p["fe_device_ms"] is None else
             f"{1 - p['fe_device_ms'] / p['fe_wall_ms']:.4f}")
          + f"; the sidecar pass (moments_update + hll_update) over a block "
          f"of {p['sc_spans']} spans, {p['sc_series']} series: device "
          f"{dev(p['sc_device_ms'])} in {p['sc_launches']:.0f} ops, "
          f"{p['sc_wall_ms']:.3f} ms with the host, bound "
          f"{p['sc_bound_ms']:.6f} ms by {p['sc_bound_by']} "
          f"({p['sc_bound_bytes']} bytes at 3.35 TB/s), longest op "
          f"{p['sc_top'][0]} {p['sc_top'][1]:.4f} ms")


def phase_ingest_storage(card):
    """Phase 12: the ingest-storage path at the reference's defaults, on
    the card against a CPU twin; the stores and the local blocks live
    under `build/` for the phase. Returns (results, K1's kernel
    entry)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase12-",
                                     dir=os.path.join(ROOT, "build")) as root:
        return _phase_ingest_storage(card, root)


def _check_sidecars(rig, twin, n_traces, ctx):
    """Every block of the card's store against the twin's (the same
    records, so the same blocks): RF1 with a sidecar; HLL registers equal
    bit for bit; moment counts exact, bounds within rtol 2e-6 and sums
    within rtol 1e-5 plus 2e-5 a unit of weight (ROADMAP section 3); each
    block's HLL estimate, and the merged history's, within HLL_REL_MAX of
    the exact distinct traces. Returns the largest relative estimate
    error, the history blocks' merged estimate, and (bound cells that
    differ, bound cells)."""
    from tempo_tpu_torch.block import sidecar as scm
    from tempo_tpu_torch.ops import moments as msk

    metas, tmetas = rig.metas(), twin.metas()
    if len(metas) != 2 * N_BUS_PARTITIONS or [
            (m.start_time, m.end_time, m.total_objects, m.total_spans)
            for m in metas] != [(m.start_time, m.end_time, m.total_objects,
                                 m.total_spans) for m in tmetas]:
        raise AssertionError(f"{ctx}: {len(metas)} blocks, the twin "
                             f"{len(tmetas)}, or they differ")
    k = msk.QUERY_K
    worst, hist = 0.0, None
    bounds_off = n_bounds = 0
    cutoff = rig.clock[0] - 900.0
    for m, tm in zip(metas, tmetas):
        a = scm.read_sidecar(rig.store, LB_TENANT, m.block_id)
        b = scm.read_sidecar(twin.store, LB_TENANT, tm.block_id)
        if not (m.sidecar and m.replication_factor == 1 and a and b):
            raise AssertionError(f"{ctx}: block {m.block_id} rf "
                                 f"{m.replication_factor}, sidecar "
                                 f"{m.sidecar}")
        if (a.total_spans, a.series) != (b.total_spans, b.series) or \
                a.total_spans != m.total_spans:
            raise AssertionError(f"{ctx}: block {m.block_id}: sidecar "
                                 f"series or spans differ from the twin's")
        if not np.array_equal(a.hll, b.hll):
            raise AssertionError(f"{ctx}: block {m.block_id}: HLL registers "
                                 f"differ from the twin's in "
                                 f"{int((a.hll != b.hll).sum())} places")
        if not np.array_equal(a.rows[:, 0], b.rows[:, 0]):
            raise AssertionError(f"{ctx}: block {m.block_id}: moment counts "
                                 f"differ from the twin's")
        # the bounds take the device's f32 log: one ulp apart between the
        # card and the host (ROADMAP section 3: bounds within 2e-6)
        bd = np.abs(a.rows[:, k + 1:] - b.rows[:, k + 1:])
        bounds_off += int((bd > 0).sum())
        if (bd > 2e-6 * np.abs(b.rows[:, k + 1:])).any():
            raise AssertionError(f"{ctx}: block {m.block_id}: moment bounds "
                                 f"beyond rtol 2e-6 of the twin's "
                                 f"(max {float(bd.max())})")
        tol = 1e-5 * np.abs(b.rows[:, 1:k + 1]) + 2e-5 * b.rows[:, :1]
        if (np.abs(a.rows[:, 1:k + 1] - b.rows[:, 1:k + 1]) > tol).any():
            raise AssertionError(f"{ctx}: block {m.block_id}: moment sums "
                                 f"beyond the rows' tolerance")
        n_bounds += bd.size
        rel = abs(a.trace_cardinality() - m.total_objects) / m.total_objects
        if rel > HLL_REL_MAX:
            raise AssertionError(f"{ctx}: block {m.block_id}: HLL estimate "
                                 f"{a.trace_cardinality():.1f} of "
                                 f"{m.total_objects} traces")
        worst = max(worst, rel)
        if m.end_time < cutoff:
            hist = a if hist is None else scm.merge_sidecars(hist, a)
    est = hist.trace_cardinality()
    if abs(est - n_traces) / n_traces > HLL_REL_MAX:
        raise AssertionError(f"{ctx}: merged history HLL {est:.1f} of "
                             f"{n_traces} traces")
    return worst, est, (bounds_off, n_bounds)


def _quantile_gate(series, durs, ctx):
    """Each (service, p) cell within the reference's moments gate of the
    exact quantile of the spans sent: min(relative error, rank error) <=
    0.05. Returns the largest such error."""
    worst = 0.0
    for key, v in series.items():
        d = dict(key)
        svc, q = d["resource.service.name"], float(d["p"])
        x = durs[svc]
        got = float(v.sum())
        exact = float(np.quantile(x, q))
        err = min(abs(got - exact) / exact, abs(float(np.mean(x <= got)) - q))
        if err > QUANT_GATE:
            raise AssertionError(f"{ctx}: {svc} q{q}: {got} against the "
                                 f"exact {exact} (error {err:.4f})")
        worst = max(worst, err)
    return worst


def _phase_ingest_storage(card, root):
    import torch

    from tempo_tpu_torch import sched
    from tempo_tpu_torch.distributor import Distributor
    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.ring import Ring

    ctx = "phase 12"
    t_phase = time.perf_counter()
    t0 = time.time()
    legs = _lb_payloads(t0)
    host = _host_traces(legs[0] + legs[1])
    n_spans = 2 * N_LB_PUSHES * N_SPANS
    n_hist = len(_host_traces(legs[0]))
    durs: dict = {}
    for spans in host.values():
        for s in spans:
            durs.setdefault(s["service"], []).append(
                (s["end_unix_nano"] - s["start_unix_nano"]) / 1e9)
    durs = {k: np.asarray(v) for k, v in durs.items()}
    sched.reset()
    sc = sched.configure(sched.SchedConfig())
    rig = _LbRig("cuda", os.path.join(root, "card"), t0)
    dist = Distributor(Ring(replication_factor=1, now=rig.now), {},
                       overrides=rig.ov, bus=rig.bus, now=rig.now)
    inst = rig.gen.instance(LB_TENANT)
    if set(inst.processors) != {"span-metrics", "local-blocks"} or \
            inst._fast_spanmetrics() is not None or \
            inst.state_layout != "dense":
        raise AssertionError(f"{ctx}: {sorted(inst.processors)}, "
                             f"{inst.state_layout} state")
    proc = inst.processors["span-metrics"]
    mats = _capture_windows(proc)
    secs = {"push": 0.0, "generator": 0.0, "blockbuilder": 0.0}
    marks = [[0] * N_BUS_PARTITIONS]
    b0 = sc.batches_total.get(SCHED_KERNEL, 0)
    ck.reset_launch_counts()
    for leg, payloads in enumerate(legs):
        if leg:
            rig.clock[0] += LB_RECENT_S
        t1 = time.perf_counter()
        for data in payloads:
            errs = dist.push_otlp(LB_TENANT, data)
            if errs:
                raise AssertionError(f"{ctx}: push: {errs}")
        secs["push"] += time.perf_counter() - t1
        g_s, b_s = rig.drain()
        secs["generator"] += g_s
        secs["blockbuilder"] += b_s
        marks.append([rig.bus.high_watermark(p)
                      for p in range(N_BUS_PARTITIONS)])
    launches = ck.paged_fused_update.launches
    dispatches = sc.batches_total.get(SCHED_KERNEL, 0) - b0
    if launches != dispatches or not launches:
        raise AssertionError(f"{ctx}: K1 launched {launches} times for "
                             f"{dispatches} merged dispatches")
    if inst.spans_received != n_spans or inst.spans_filtered_slack or \
            dist.discarded:
        raise AssertionError(f"{ctx}: {inst.spans_received} spans received, "
                             f"{inst.spans_filtered_slack} filtered, "
                             f"discarded {dist.discarded}")
    n_records = sum(marks[-1])

    # the twin: the same records on the CPU, leg by leg on its own clock
    twin = _LbRig("cpu", os.path.join(root, "twin"), t0)
    for leg in range(2):
        if leg:
            twin.clock[0] += LB_RECENT_S
        for p in range(N_BUS_PARTITIONS):
            for rec in rig.bus.fetch(p, marks[leg][p],
                                     marks[leg + 1][p] - marks[leg][p]):
                twin.bus.produce(p, rec.tenant, rec.value)
        twin.drain()
    hll_worst, hll_hist, bounds_off = _check_sidecars(rig, twin, n_hist, ctx)

    # 12b: the frontend at its defaults over both legs
    fe, tfe = rig.frontend(), twin.frontend()
    w = rig.window()
    before = {q: _series_map(fe.query_range(LB_TENANT, q, **w))
              for q in (LB_RATE, LB_QUANT)}
    stats = dict(rig.db.compaction_stats)
    if not stats["sidecar_folds"] or stats["sidecar_fallbacks"]:
        raise AssertionError(f"{ctx}: {stats}")
    scan = _series_map(rig.frontend(sidecar_folds=False).query_range(
        LB_TENANT, LB_RATE, **w))
    _same_series(before[LB_RATE], scan, True, f"{ctx}: rate folded vs "
                 f"rescanned")
    twin_q = {q: _series_map(tfe.query_range(LB_TENANT, q, **w))
              for q in (LB_RATE, LB_QUANT)}
    _same_series(before[LB_RATE], twin_q[LB_RATE], True,
                 f"{ctx}: rate card vs CPU twin")
    total = sum(float(v.sum()) for v in before[LB_RATE].values()) * w["step_s"]
    if round(total) != n_spans:
        raise AssertionError(f"{ctx}: the rate counts {total} of {n_spans} "
                             f"spans")
    q_err = _quantile_gate(before[LB_QUANT], durs, f"{ctx} card")
    _quantile_gate(twin_q[LB_QUANT], durs, f"{ctx} twin")
    q_rel = max(float(np.max(np.abs(before[LB_QUANT][k] - v)
                             / np.maximum(np.abs(v), 1e-30)))
                for k, v in twin_q[LB_QUANT].items())
    # the local cut: live traces → WAL (a fsynced segment a trace) → one
    # complete RF1 block; the recent leg answers the same
    lb = inst.processors["local-blocks"]
    t1 = time.perf_counter()
    inst.tick(immediate=True)
    cut_s = time.perf_counter() - t1
    if len(lb.inst.complete_blocks()) != 1 or lb.inst.all_recent_traces():
        raise AssertionError(f"{ctx}: after the local cut "
                             f"{len(lb.inst.complete_blocks())} blocks")
    after = {q: _series_map(fe.query_range(LB_TENANT, q, **w))
             for q in (LB_RATE, LB_QUANT)}
    _same_series(after[LB_RATE], before[LB_RATE], True,
                 f"{ctx}: rate after the local cut")
    _same_series(after[LB_QUANT], before[LB_QUANT], False,
                 f"{ctx}: quantiles after the local cut")
    fe_ms = _timed_ms(lambda: fe.query_range(LB_TENANT, LB_RATE, **w))
    prof = _profiles_in_child(ctx, "--phase12-profiles",
                              os.path.join(root, "card"), repr(t0),
                              repr(rig.clock[0]))
    k1, row = _dist_k1_row(
        "paged_fused_update (local-blocks tenant: consume_bus → push_spans "
        "→ push_batch, scheduler route, dense state, sketch dd, f32)", proc,
        mats[-1], launches, f"{ctx} window")
    for fr in (fe, tfe):
        fr.shutdown()
    for r in (rig, twin):
        r.db.shutdown()
    sched.reset()
    del rig, twin, inst, proc, mats, lb
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(secs=secs, records=n_records, launches=launches,
               dispatches=dispatches, hll_worst=hll_worst, hll_hist=hll_hist,
               bounds_off=bounds_off,
               n_hist=n_hist, folds=stats["sidecar_folds"], q_err=q_err,
               q_rel=q_rel, cut_s=cut_s, fe_ms=fe_ms, prof=prof,
               k1_device_ms=k1["device_ms"], n_series=len(durs))
    out["seconds"] = time.perf_counter() - t_phase
    return out, row


# ---------------------------------------------------------------------------
# phase 13: the materialized query grids and trace analytics
# ---------------------------------------------------------------------------

MV_TENANT = "mv-0"               # span metrics + local blocks, grids
MV_SM_TENANT = "mv-sm"           # span metrics only, with a grid
N_MV_PUSHES = 3                  # on the log2 tier; one more on moments
MV_STEP_S = 10.0
MV_CLOCK_S = 15.0                # the clock's move between pushes
MV_READ_STEPS = 12               # a read's window, all after the cutoff
MV_AUTO_AFTER = 32               # MatViewConfig().auto_subscribe_after
MV_RATE = LB_RATE
MV_QUANT = LB_QUANT
MV_HIST = "{ } | histogram_over_time(duration)"
MV_LATE = "{ status = error } | count_over_time() by (resource.service.name)"
MV_AUTO = "{ kind = server } | rate() by (name)"
MV_MOM_REL = 0.02                # tests/test_matview.py:281
TA_TENANT = "ta-0"
N_TA_PUSHES = 2
# share quantiles beyond rtol 1e-3 of the twin's, as a share of the
# series: ROADMAP section 3's envelope for moment rows of few
# observations (q50 on up to 43 of 256 series), its 40 of 16,384 for q99
SHARE_OUTSIDE_MAX = {0.5: 43 / 256, 0.99: 40 / 16384}
STRUCT_SMALL = (128, 32)         # traces, spans a trace: 4,096 spans
STRUCT_BIG = (8192, 32)          # 262,144 spans, n_pad 2^18


def _mv_payloads(t0, n=N_MV_PUSHES + 1):
    """`n` OTLP payloads of `deep_trace_spans`, one a push, each stamped
    within 10 s before the clock of its push (the clock moves
    MV_CLOCK_S between pushes)."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    return [encode_spans_otlp(deep_trace_spans(
        N_SPANS, seed=SEED + 130 + k,
        now_ns=int((t0 + k * MV_CLOCK_S) * 1e9)))
        for k in range(n)]


class _MvRig:
    """Phase 13a's deployment on `device`: a `Generator` of the default
    config whose tenant MV_TENANT runs span metrics and local blocks (its
    data under `root`) and MV_SM_TENANT span metrics only; the process
    materializer at `MatViewConfig()` on the same device; a `Frontend` at
    `FrontendConfig()` over the generator leg (reads stay within the last
    900 s, so no backend job)."""

    def __init__(self, device, root, t0):
        from tempo_tpu_torch import matview
        from tempo_tpu_torch.backend import MemBackend
        from tempo_tpu_torch.db import TempoDB
        from tempo_tpu_torch.frontend import Frontend, FrontendConfig
        from tempo_tpu_torch.generator import Generator, GeneratorConfig
        from tempo_tpu_torch.generator.processors.localblocks import \
            LocalBlocksConfig
        from tempo_tpu_torch.overrides import Overrides
        from tempo_tpu_torch.querier import Querier
        from tempo_tpu_torch.querier.querier import QuerierConfig
        from tempo_tpu_torch.ring import Ring

        self.device = device
        self.clock = [t0]
        now = self.now = lambda: self.clock[0]
        ov = Overrides()
        ov.set_tenant_patch(MV_TENANT, {"generator": {
            "processors": ["span-metrics", "local-blocks"]}})
        ov.set_tenant_patch(MV_SM_TENANT, {"generator": {
            "processors": ["span-metrics"]}})
        self.gen = Generator(GeneratorConfig(localblocks=LocalBlocksConfig(
            data_dir=os.path.join(root, "gen"))), overrides=ov, now=now,
            device=device)
        self.mv = self.configure()
        be = MemBackend()
        self.db = TempoDB(be, be, now=now, device=device)
        self.fe = Frontend(self.db, Querier(
            self.db, Ring(replication_factor=1, now=now), {},
            cfg=QuerierConfig(rf=1)), cfg=FrontendConfig(),
            generator_query_range=self.gen.query_range, now=now)
        self.inst = self.gen.instance(MV_TENANT)
        self.sm = self.gen.instance(MV_SM_TENANT)

    def configure(self):
        from tempo_tpu_torch import matview

        self.mv = matview.configure(matview.MatViewConfig(), now=self.now,
                                    device=self.device)
        return self.mv

    def window(self):
        """MV_READ_STEPS aligned steps ending with the clock's step."""
        hi = int(self.clock[0] // MV_STEP_S)
        start = (hi - MV_READ_STEPS + 1) * MV_STEP_S
        return dict(start_s=start, end_s=start + MV_READ_STEPS * MV_STEP_S,
                    step_s=MV_STEP_S)

    def read(self, query):
        return _series_map(self.fe.query_range(MV_TENANT, query,
                                               **self.window()))

    def grids(self):
        """{query: {grid name: host copy}} of every subscription."""
        return {s.query: {k: g.cpu().numpy().copy()
                          for k, g in s.grids.items()}
                for s in self.mv.subscriptions()}

    def shutdown(self):
        self.fe.shutdown()
        self.db.shutdown()


def _mv_timeline(rig, payloads, card):
    """Both sides' pushes and subscriptions, in order: explicit grids
    (rate, quantile on the bucket tier, histogram) for MV_TENANT and a
    rate grid for MV_SM_TENANT; MV_AUTO read 32 times through the
    frontend (the card; the twin's materializer is told the same
    recurrence count), so it auto-subscribes; push 1, which builds every
    grid; push 2; MV_LATE subscribed, built from the live traces of both
    at push 3. Returns the frontend's seconds for the 32 misses (None on
    the twin)."""
    for q in (MV_RATE, MV_QUANT, MV_HIST):
        ok, why = rig.fe.subscribe_query(MV_TENANT, q, MV_STEP_S)
        if not ok:
            raise AssertionError(f"phase 13a: subscribe {q}: {why}")
    rig.fe.subscribe_query(MV_SM_TENANT, MV_RATE, MV_STEP_S)
    miss_s = None
    if card:
        t1 = time.perf_counter()
        for _ in range(MV_AUTO_AFTER):
            rig.read(MV_AUTO)
        miss_s = time.perf_counter() - t1
    else:
        rig.mv.consider_auto_subscribe(MV_TENANT, MV_AUTO, MV_STEP_S,
                                       MV_AUTO_AFTER)
    for k in range(N_MV_PUSHES):
        if k:
            rig.clock[0] += MV_CLOCK_S
        if k == 2:
            rig.fe.subscribe_query(MV_TENANT, MV_LATE, MV_STEP_S)
        rig.gen.push_otlp(MV_TENANT, payloads[k])
        if k < 2:
            rig.gen.push_otlp(MV_SM_TENANT, payloads[k])
    _settle({"g": rig.gen})
    return miss_s


def _mv_moments(rig, payloads):
    """The moments tier: a fresh materializer, the quantile subscribed
    under `use_query_tier("moments")` and built from the live traces of
    the N_MV_PUSHES pushes at the next push, then appended to."""
    rig.configure()
    ok, why = rig.fe.subscribe_query(MV_TENANT, MV_QUANT, MV_STEP_S)
    if not ok:
        raise AssertionError(f"phase 13a: subscribe moments: {why}")
    rig.clock[0] += MV_CLOCK_S
    rig.gen.push_otlp(MV_TENANT, payloads[N_MV_PUSHES])
    _settle({"g": rig.gen})


def _mom_close(a, b, ctx):
    """Quantile series within MV_MOM_REL of each other."""
    if set(a) != set(b):
        raise AssertionError(f"{ctx}: series differ")
    worst = 0.0
    for k, v in b.items():
        rel = float(np.max(np.abs(a[k] - v) / np.maximum(np.abs(v), 1e-12)))
        worst = max(worst, rel)
        if rel > MV_MOM_REL:
            raise AssertionError(f"{ctx}: {k}: {a[k]} against {v}")
    return worst


def _same_grids(card, twin, ctx):
    """Each subscription's grids, card against CPU twin: count, bucket and
    bound planes bit for bit; float64 moment sums within 1e-12 relative
    (the card's atomics add them in another order)."""
    if set(card) != set(twin):
        raise AssertionError(f"{ctx}: subscriptions differ")
    cells = 0
    for q, grids in twin.items():
        for name, g in grids.items():
            c = card[q][name]
            ok = c.shape == g.shape and (
                np.allclose(c, g, rtol=1e-12, atol=1e-9) if name == "mmt"
                else np.array_equal(c, g))
            if not ok:
                raise AssertionError(f"{ctx}: {q} grid {name} differs")
            cells += int(np.count_nonzero(g))
    return cells


def phase_matview(card):
    """Phase 13a: the materialized grids at the reference's defaults on
    the card, against a CPU twin fed the same payloads; the generators'
    local blocks live under `build/` for the phase. Returns (results,
    K1's kernel entry)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase13-",
                                     dir=os.path.join(ROOT, "build")) as root:
        return _phase_matview(card, root)


def _phase_matview(card, root):
    import torch

    from tempo_tpu_torch import matview, sched
    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.ops import moments as msk

    import logging

    from tempo_tpu_torch.obs import qlog

    ctx = "phase 13a"
    t_phase = time.perf_counter()
    # on the phase's pinned clock every query takes 0 s, which the query
    # log's warmed slow threshold (0 s) reports, one line a query
    logging.getLogger(qlog.LOGGER_NAME).setLevel(logging.ERROR)
    t0 = float(int(time.time()))
    payloads = _mv_payloads(t0)
    sched.reset()
    sc = sched.configure(sched.SchedConfig())
    rig = _MvRig("cuda", os.path.join(root, "card"), t0)
    proc = rig.inst.processors["span-metrics"]
    sm_proc = rig.sm.processors["span-metrics"]
    fast = {"n": 0}
    for p in (proc, sm_proc):
        for name in ("push_staged", "push_from_recs"):
            inner = getattr(p, name)
            setattr(p, name, lambda *a, _f=inner, **k: (
                fast.__setitem__("n", fast["n"] + 1), _f(*a, **k))[1])
    mats = _capture_windows(proc)
    b0 = sc.batches_total.get(SCHED_KERNEL, 0)
    ck.reset_launch_counts()
    miss_s = _mv_timeline(rig, payloads, card=True)
    if rig.inst._fast_spanmetrics() is not None or \
            rig.sm._fast_spanmetrics() is not None or fast["n"]:
        raise AssertionError(f"{ctx}: a tenant with a grid took the staged "
                             f"fast route ({fast['n']} fast pushes)")
    subs = {s.query: s for s in rig.mv.subscriptions()
            if s.tenant == MV_TENANT}
    if set(subs) != {MV_RATE, MV_QUANT, MV_HIST, MV_LATE, MV_AUTO} or \
            subs[MV_AUTO].origin != "auto" or rig.mv.auto_subscribed != 1:
        raise AssertionError(f"{ctx}: subscriptions {sorted(subs)}")
    sm_sub = [s for s in rig.mv.subscriptions()
              if s.tenant == MV_SM_TENANT][0]
    if sm_sub.appends != 2 or sm_sub.append_spans != 2 * N_SPANS:
        raise AssertionError(f"{ctx}: the span-metrics-only tenant's grid "
                             f"took {sm_sub.appends} appends")
    grids = rig.grids()
    state_bytes = rig.mv.status()["state_bytes"]
    h0 = rig.mv.reads.get("hit", 0)
    served = {q: rig.read(q) for q in (MV_RATE, MV_QUANT, MV_HIST, MV_LATE,
                                       MV_AUTO)}
    hits = rig.mv.reads.get("hit", 0) - h0
    if hits != len(served):
        raise AssertionError(f"{ctx}: {hits} hits for {len(served)} reads "
                             f"({rig.mv.reads})")
    hit_ms = _timed_ms(lambda: rig.read(MV_RATE))
    saved = rig.mv
    matview.reset()
    recomputed = {q: rig.read(q) for q in served}
    for q in served:
        _same_series(served[q], recomputed[q], True,
                     f"{ctx}: {q} served against the recompute")
    total = sum(float(v.sum()) for v in served[MV_RATE].values()) * MV_STEP_S
    if round(total) != N_MV_PUSHES * N_SPANS:
        raise AssertionError(f"{ctx}: the served rate counts {total} spans")
    recompute_ms = _timed_ms(lambda: rig.read(MV_RATE), iters=1)
    with msk.use_query_tier("moments"):
        _mv_moments(rig, payloads)
        mom_sub = rig.mv.subscriptions()[0]
        if mom_sub.grids["mmt"].dtype != torch.float64:
            raise AssertionError(f"{ctx}: moments grid "
                                 f"{mom_sub.grids['mmt'].dtype}")
        mom_grids = rig.grids()
        mom_served = rig.read(MV_QUANT)
        if rig.mv.reads.get("hit") != 1:
            raise AssertionError(f"{ctx}: moments read {rig.mv.reads}")
        mom_mv = rig.mv
        matview.reset()
        mom_worst = _mom_close(mom_served, rig.read(MV_QUANT),
                               f"{ctx}: moments served against recompute")
    launches = ck.paged_fused_update.launches
    dispatches = sc.batches_total.get(SCHED_KERNEL, 0) - b0
    if launches != dispatches or not launches:
        raise AssertionError(f"{ctx}: K1 launched {launches} times for "
                             f"{dispatches} merged dispatches")
    k1, row = _dist_k1_row(
        "paged_fused_update (a tenant with materialized grids: push_otlp → "
        "the SpanBatch route → push_batch, scheduler, dense state, sketch "
        "dd, f32)", proc, mats[-1], launches, f"{ctx} window")
    appends = sum(s.appends for s in saved.subscriptions()) + \
        mom_sub.appends
    rig.shutdown()
    del rig, proc, sm_proc, mats, saved, mom_mv, subs, sm_sub, mom_sub
    gc.collect()
    torch.cuda.empty_cache()

    # the twin: the same payloads and timeline on the CPU
    twin = _MvRig("cpu", os.path.join(root, "twin"), t0)
    _mv_timeline(twin, payloads, card=False)
    cells = _same_grids(grids, twin.grids(), f"{ctx}: card against twin")
    with msk.use_query_tier("moments"):
        _mv_moments(twin, payloads)
        cells += _same_grids(mom_grids, twin.grids(),
                             f"{ctx}: moments, card against twin")
    twin.shutdown()
    matview.reset()
    sched.reset()
    out = dict(hit_ms=hit_ms, recompute_ms=recompute_ms, miss_s=miss_s,
               state_bytes=state_bytes, hits=hits, mom_worst=mom_worst,
               launches=launches, dispatches=dispatches, appends=appends,
               cells=cells, k1_device_ms=k1["device_ms"],
               n_series=len(served[MV_RATE]))
    out["seconds"] = time.perf_counter() - t_phase
    return out, row


def _structure_batch(n_traces, per, seed, corrupt=True):
    """Seeded trees of `per` spans (each span's parent an earlier span of
    its trace), about a third errored, ends anywhere in a second (so
    children may outlive their parents). With `corrupt`: trace 1 holds
    an orphan subtree, trace 2 a two-span parent cycle, trace 3 a
    duplicate span id. Returns (grp, span ids [n, 8], parent ids, start,
    end, err)."""
    rng = np.random.default_rng(seed)
    n = n_traces * per
    grp = np.repeat(np.arange(n_traces, dtype=np.int32), per)
    sid = rng.integers(1, 2 ** 63 - 1, size=n, dtype=np.int64)
    j = np.tile(np.arange(per, dtype=np.int64), n_traces)
    par = grp.astype(np.int64) * per + (rng.random(n) * j).astype(np.int64)
    pid = np.where(j == 0, 0, sid[par])
    if corrupt:
        pid[1 * per + 1] = rng.integers(1, 2 ** 62)      # orphan subtree
        a, b = 2 * per + 1, 2 * per + 2                   # 2-span cycle
        pid[a], pid[b] = sid[b], sid[a]
        sid[3 * per + 5] = sid[3 * per + 4]               # duplicate id
    end = 1_700_000_000 * 10 ** 9 + rng.integers(1, 10 ** 9, n)
    start = end - rng.integers(1, 10 ** 8, n)
    err = rng.random(n) < 1 / 3
    as_bytes = lambda v: np.ascontiguousarray(v).view(np.uint8).reshape(n, 8)
    return grp, as_bytes(sid), as_bytes(pid), start, end, err


def _structure_bound(n, n_traces):
    """Bytes `analyze` must move: per span its trace (4 B), span and
    parent ids (8 + 8), end (8) and error flag (1) read once, parent,
    bounding child, errored bounding child and root cause (4 each) and
    two flags written once; per trace its anchor (4)."""
    nbytes = n * (29 + 18) + n_traces * 4
    return (nbytes, *bound(nbytes, n * 32))


def _structure_checks(ctx):
    """`structure.analyze` on the card: at 4,096 spans against the
    pure-Python oracle (every output; root causes on the settled mask, as
    the processor attributes), and at a busy tenant's cut (262,144 spans
    in 8,192 traces) against its own run on the CPU, bit for bit. Returns
    the card call's ms with the host at the big shape."""
    from tempo_tpu_torch.ops import structure

    nt, per = STRUCT_SMALL
    grp, sid, pid, start, end, err = _structure_batch(nt, per, SEED + 140)
    n = len(grp)
    res = structure.analyze(grp, sid, pid, end, err, nt, n, nt,
                            device="cuda")
    ref = structure.reference_analysis(grp, sid, pid, end, err)
    for k in ("parent_row", "on_path", "bc", "ebc", "cyclic", "anchor"):
        if not np.array_equal(res[k], ref[k]):
            raise AssertionError(f"{ctx}: analyze {k} differs from the "
                                 f"oracle at {n} spans")
    ok = err & ~res["cyclic"] & (res["ebc"][np.clip(res["rc"], 0, n - 1)]
                                 < 0)
    if not np.array_equal(res["rc"][ok], ref["rc"][ok]) or \
            not (res["parent_row"] == structure.ORPHAN).any() or \
            not res["cyclic"].any():
        raise AssertionError(f"{ctx}: analyze root causes or corruption "
                             f"flags differ from the oracle")
    nt, per = STRUCT_BIG
    big = _structure_batch(nt, per, SEED + 141)
    n = len(big[0])
    args = (big[0], big[1], big[2], big[4], big[5], nt, n, nt)
    got = structure.analyze(*args, device="cuda")
    want = structure.analyze(*args, device="cpu")
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{ctx}: analyze {k} differs card against "
                                 f"CPU at {n} spans")
    return _timed_ms(lambda: structure.analyze(*args, device="cuda"))


def _ta_collect(inst):
    from tempo_tpu_torch import sched

    sched.flush()
    return {(s.name, s.labels): s.value for s in inst.registry.collect(1)
            if not s.is_stale_marker and s.name.startswith(
                ("tempo_critical_path", "tempo_error_root_cause"))}


def _ta_shares(inst):
    """{cp label set: share moment row} and {q: {label set: quantile}}."""
    p = inst.processors["trace-analytics"]
    slots = p.cp.table.active_slots()
    slots = slots[slots < p.cfg.sketch_max_series]
    _, rows = p.aux_checkpoint(slots)
    by = {p.cp.labels_of(int(slots[i])): r
          for i, r in zip(rows["mom_sel"].tolist(), rows["mom_rows"])}
    return by, {q: p.quantile(q) for q in (0.5, 0.99)}


def phase_traceanalytics(card):
    """Phase 13b: a span-metrics + trace-analytics tenant at
    `TraceAnalyticsConfig()` on the default scheduler route, dense state,
    2 pushes of 16,384 `deep_trace_spans` spans (about a third errored),
    then one cut of 32,768 spans in 1,024 traces, against a CPU twin; and
    `structure.analyze` on the card against the oracle and the CPU.
    Returns (results, K1's kernel entry)."""
    import torch

    from tempo_tpu_torch import sched
    from tempo_tpu_torch.generator import Generator
    from tempo_tpu_torch.generator.processors import traceanalytics as ta
    from tempo_tpu_torch.model.otlp import encode_spans_otlp
    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.overrides import Overrides
    from tempo_tpu_torch.utils import dataquality

    ctx = "phase 13b"
    t_phase = time.perf_counter()
    t0 = float(int(time.time()))
    payloads = [encode_spans_otlp(deep_trace_spans(
        N_SPANS, seed=SEED + 150 + k, now_ns=int(t0 * 1e9)))
        for k in range(N_TA_PUSHES)]
    sched.reset()
    sc = sched.configure(sched.SchedConfig())
    ta.reset_counters()
    dataquality.reset_orphan_spans()
    runs = {}
    for side, dev in (("card", "cuda"), ("twin", "cpu")):
        tenant = TA_TENANT if side == "card" else TA_TENANT + "-twin"
        ov = Overrides()
        ov.set_tenant_patch(tenant, {"generator": {
            "processors": ["span-metrics", "trace-analytics"]}})
        gen = Generator(overrides=ov, now=lambda: t0, device=dev)
        inst = gen.instance(tenant)
        proc = inst.processors["span-metrics"]
        mats = _capture_windows(proc) if side == "card" else None
        b0 = sc.batches_total.get(SCHED_KERNEL, 0)
        ck.reset_launch_counts()
        for data in payloads:
            gen.push_otlp(tenant, data)
        _settle({"g": gen})
        launches = ck.paged_fused_update.launches
        dispatches = sc.batches_total.get(SCHED_KERNEL, 0) - b0
        t1 = time.perf_counter()
        inst.tick(immediate=True)
        sched.flush()
        if dev == "cuda":
            torch.cuda.synchronize()
        cut_s = time.perf_counter() - t1
        p = inst.processors["trace-analytics"]
        if p._live or inst.state_layout != "dense" or \
                ta._cut_spans.get(tenant) != N_TA_PUSHES * N_SPANS or \
                ta._cut_traces.get(tenant) != \
                N_TA_PUSHES * N_SPANS // SPANS_PER_TRACE:
            raise AssertionError(f"{ctx} {side}: cut {ta._cut_spans} spans, "
                                 f"{ta._cut_traces} traces")
        runs[side] = dict(
            samples=_ta_collect(inst), shares=_ta_shares(inst),
            counters=(ta._cycle_spans.get(tenant, 0.0),
                      ta._late_spans.get(tenant, 0.0),
                      dataquality.orphan_spans_snapshot().get(tenant, 0)),
            cut_s=cut_s, launches=launches, dispatches=dispatches,
            proc=proc, mats=mats, inst=inst)
    c, tw = runs["card"], runs["twin"]
    if c["launches"] != c["dispatches"] or not c["launches"]:
        raise AssertionError(f"{ctx}: K1 launched {c['launches']} times for "
                             f"{c['dispatches']} merged dispatches")
    if set(c["samples"]) != set(tw["samples"]):
        raise AssertionError(f"{ctx}: series differ from the twin")
    n_rc = n_cp = 0
    for k, v in tw["samples"].items():
        if k[0] == "tempo_error_root_cause_total":
            n_rc += 1
            if c["samples"][k] != v:
                raise AssertionError(f"{ctx}: root cause {k}: "
                                     f"{c['samples'][k]} against {v}")
        else:
            n_cp += 1
            if abs(c["samples"][k] - v) > 1e-5 * abs(v):
                raise AssertionError(f"{ctx}: critical path {k}: "
                                     f"{c['samples'][k]} against {v}")
    if c["counters"] != tw["counters"]:
        raise AssertionError(f"{ctx}: cycle, late and orphan counters "
                             f"{c['counters']} against {tw['counters']}")
    rows_c, q_c = c["shares"]
    rows_t, q_t = tw["shares"]
    if set(rows_c) != set(rows_t):
        raise AssertionError(f"{ctx}: share series differ")
    k = 8
    for lab, r in rows_t.items():
        d = rows_c[lab]
        w = float(r[0])
        if not (np.allclose(d[:k + 1], r[:k + 1], rtol=1e-5, atol=2e-5 * w)
                and np.allclose(d[k + 1:], r[k + 1:], rtol=2e-6, atol=0)):
            raise AssertionError(f"{ctx}: share row {lab} outside the "
                                 f"moments rule")
    outside = {}
    for q, share in SHARE_OUTSIDE_MAX.items():
        want = q_t[q]
        got = q_c[q]
        if set(got) != set(want):
            raise AssertionError(f"{ctx}: share quantile series differ")
        outside[q] = sum(1 for lab, v in want.items()
                         if abs(got[lab] - v) > 1e-3 * abs(v))
        cap = max(1, int(np.ceil(share * len(want))))
        if outside[q] > cap:
            raise AssertionError(f"{ctx}: q{q} outside rtol 1e-3 on "
                                 f"{outside[q]} of {len(want)} series "
                                 f"(limit {cap})")
    k1, row = _dist_k1_row(
        "paged_fused_update (a span-metrics + trace-analytics tenant: "
        "push_otlp → the SpanBatch route, scheduler, dense state, sketch "
        "dd, f32)", c["proc"], c["mats"][-1], c["launches"],
        f"{ctx} window")
    analyze_ms = _structure_checks(ctx)
    out = dict(cut_s=c["cut_s"], twin_cut_s=tw["cut_s"], n_rc=n_rc,
               n_cp=n_cp, counters=c["counters"], outside=outside,
               n_share=len(rows_t), analyze_ms=analyze_ms,
               launches=c["launches"], dispatches=c["dispatches"],
               k1_device_ms=k1["device_ms"])
    for r in runs.values():
        r.clear()
    ta.reset_counters()
    dataquality.reset_orphan_spans()
    sched.reset()
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out, row


def phase13_profiles() -> dict:
    """Phase 13's torch.profiler readings, in a process of its own as
    phase 10b's are (the smoke runs them in phase 12's profiling
    process, `--phase12-profiles`; `--phase13-profiles` alone): one warm
    append (`Materializer.observe_batch` of a
    16,384-span batch into the rate, quantile and histogram grids of a
    local-blocks tenant) and `structure.analyze` at STRUCT_BIG's shape."""
    import torch

    from tempo_tpu_torch import matview
    from tempo_tpu_torch.model.otlp_batch import batch_from_otlp
    from tempo_tpu_torch.ops import structure

    out = {}
    t0 = float(int(time.time()))
    payloads = _mv_payloads(t0, 2)
    with tempfile.TemporaryDirectory(prefix="phase13p-",
                                     dir=os.path.join(ROOT, "build")) as root:
        rig = _MvRig("cuda", root, t0)
        for q in (MV_RATE, MV_QUANT, MV_HIST):
            rig.fe.subscribe_query(MV_TENANT, q, MV_STEP_S)
        rig.gen.push_otlp(MV_TENANT, payloads[0])     # builds the grids
        rig.clock[0] += MV_CLOCK_S
        sb = batch_from_otlp(payloads[1], rig.inst.registry.interner)
        lb = rig.inst.processors["local-blocks"]
        subs = rig.mv.subscriptions()
        before = {s.query: ({k: g.clone() for k, g in s.grids.items()},
                            s.append_spans) for s in subs}
        rig.mv.observe_batch(MV_TENANT, sb, lb=lb)
        torch.cuda.synchronize()
        # read once: each appended row's int64 slot and ring column, and
        # its bucket (histogram grids); written once: every touched f32
        # cell
        rows = cells = nbytes = 0
        for s in subs:
            grids0, spans0 = before[s.query]
            n_s = s.append_spans - spans0
            changed = sum(int((g != grids0[k]).sum())
                          for k, g in s.grids.items())
            rows += n_s
            cells += changed
            nbytes += n_s * (16 if "count" in s.grids else 24) + changed * 4
        append = lambda: rig.mv.observe_batch(MV_TENANT, sb, lb=lb)
        (out["app_device_ms"], out["app_ops"], out["app_wall_ms"],
         out["app_top"]) = _profile(append)
        out["app_ms"] = _timed_ms(append)
        out["app_rows"], out["app_cells"] = rows, cells
        (out["app_bound_bytes"], out["app_bound_ms"],
         out["app_bound_by"]) = (nbytes, *bound(nbytes, rows))
        rig.shutdown()
        matview.reset()
    nt, per = STRUCT_BIG
    big = _structure_batch(nt, per, SEED + 141)
    n = len(big[0])
    args = (big[0], big[1], big[2], big[4], big[5], nt, n, nt)
    (out["st_device_ms"], out["st_ops"], out["st_wall_ms"],
     out["st_top"]) = _profile(lambda: structure.analyze(*args,
                                                         device="cuda"))
    (out["st_bound_bytes"], out["st_bound_ms"],
     out["st_bound_by"]) = _structure_bound(n, nt)
    out["st_spans"] = n
    return out


def _print_phase13(a, b, p, card):
    def dev(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"
    print(f"phase 13a checks: {a['hits']} frontend reads served from grids "
          f"(rate, quantile on the bucket tier, histogram, a grid built from "
          f"the live traces after 2 pushes, one auto-subscribed after "
          f"{MV_AUTO_AFTER} misses) equal bit for bit to the recompute "
          f"(materializer reset); the moments tier within "
          f"{a['mom_worst']:.2e} relative (limit {MV_MOM_REL}); every grid "
          f"equal to the CPU twin's ({a['cells']} non-zero cells; moment "
          f"sums within 1e-12); no staged fast push; K1 {a['launches']} "
          f"launches for {a['dispatches']} merged dispatches")
    print(f"phase 13a [{card}]: a warm hit read (Frontend.query_range, rate "
          f"by service over {MV_READ_STEPS} steps) {a['hit_ms']:.3f} ms "
          f"against the recompute {a['recompute_ms']:.3f} ms; {MV_AUTO_AFTER} "
          f"misses {a['miss_s']:.3f} s; grids' device bytes "
          f"{a['state_bytes']} ({a['n_series']} services); {a['appends']} "
          f"appends; an append of {p['app_rows']} rows into 3 grids "
          f"(profiling process): {p['app_ms']:.3f} ms with the host, device "
          f"{dev(p['app_device_ms'])} in {p['app_ops']:.0f} ops, bound "
          f"{p['app_bound_ms']:.6f} ms by {p['app_bound_by']} "
          f"({p['app_bound_bytes']} bytes, {p['app_cells']} cells)")
    print(f"phase 13b checks: root-cause counters ({b['n_rc']} series) equal "
          f"to the CPU twin's, critical-path seconds ({b['n_cp']} series) "
          f"within rtol 1e-5, share rows ({b['n_share']}) within the moments "
          f"rule, share quantiles outside rtol 1e-3 on {b['outside']} "
          f"(limits, of the series: q50 43/256, q99 40/16,384, at least "
          f"1); "
          f"cycle / late / orphan counters {b['counters']} equal; "
          f"structure.analyze equal to the oracle at "
          f"{STRUCT_SMALL[0] * STRUCT_SMALL[1]} spans (an orphan subtree, a "
          f"cycle, a duplicate id) and to its CPU run at {p['st_spans']}; K1 "
          f"{b['launches']} launches for {b['dispatches']} merged dispatches")
    n = N_TA_PUSHES * N_SPANS
    print(f"phase 13b [{card}]: one cut of {n} spans through cut_tick "
          f"{b['cut_s']:.3f} s ({n / b['cut_s']:.0f} spans/s; the CPU twin "
          f"{b['twin_cut_s']:.3f} s); structure.analyze at {p['st_spans']} "
          f"spans {b['analyze_ms']:.3f} ms with the host, device "
          f"{dev(p['st_device_ms'])} in {p['st_ops']:.0f} ops (longest "
          f"{p['st_top'][0]} {p['st_top'][1]:.4f} ms), bound "
          f"{p['st_bound_ms']:.6f} ms by {p['st_bound_by']} "
          f"({p['st_bound_bytes']} bytes)")


# ---------------------------------------------------------------------------
# phase 14: the App on the card (python -m tempo_tpu_torch's object)
# ---------------------------------------------------------------------------

APP_TENANT = "single-tenant"       # the HTTP API's tenant without a header
N_APP_PUSHES = 3
N_APP_FIND = 64                    # trace ids found over HTTP and direct
APP_RATE = LB_RATE
APP_QUANT = ("{ } | quantile_over_time(duration, .5, .9) by "
             "(resource.service.name)")
APP_SEARCH = '{ resource.service.name = "service-3" && span.http.status_code >= 500 }'
APP_WINDOW_S = 600.0               # [t0 - 600, t0], 60 s steps: the recent window


def _app_payloads(t0):
    """(span lists, OTLP payloads) of `N_APP_PUSHES` pushes of
    `deep_trace_spans` (32-span traces), stamped within 10 s before t0."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    spans = [deep_trace_spans(N_SPANS, seed=SEED + 140 + k,
                              now_ns=int(t0 * 1e9))
             for k in range(N_APP_PUSHES)]
    return spans, [encode_spans_otlp(s) for s in spans]


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _http_errors:
    """Turn an HTTP error answer into an AssertionError carrying its
    body (the API's error message)."""

    def __init__(self, what):
        self.what = what

    def __enter__(self):
        return self

    def __exit__(self, typ, e, tb):
        import urllib.error

        if isinstance(e, urllib.error.HTTPError):
            raise AssertionError(f"phase 14: {self.what} answered {e.code}: "
                                 f"{e.read()[:2000]!r}") from e
        return False


class _AppRig:
    """`App(Config())` at target `all` on `device`, on a pinned clock `t0`
    (traces stay live until the phase cuts them): the `local` backend
    and every data directory under `root`, a free loopback port,
    `start_loops()` and `serve(app, block=False)`; the tenant given the
    span-metrics and local-blocks processors (tests/test_app.py:79-80)
    unless `processors` says otherwise, and with `wal` the generator's
    ingest WAL under `root`. The compaction loop's interval is raised
    from 30 s to an hour so the loop does not race the phase's own
    `compact_tenant_once` over the same blocks; the loop is started all
    the same."""

    def __init__(self, device, root, t0,
                 processors=("span-metrics", "local-blocks"), wal=False,
                 grpc=False, selftrace=False, patch=None, agent=False):
        from tempo_tpu_torch.app import App
        from tempo_tpu_torch.app.api import serve
        from tempo_tpu_torch.app.config import Config

        cfg = Config()
        cfg.storage.local_path = os.path.join(root, "blocks")
        cfg.storage.wal_path = os.path.join(root, "data", "wal")
        cfg.generator.localblocks.data_dir = os.path.join(root, "lb")
        cfg.server.http_listen_port = _free_port()
        cfg.compaction_interval_s = 3600.0
        if wal:
            cfg.wal.enabled = True
            cfg.wal.dir = os.path.join(root, "generator-wal")
        if grpc:
            cfg.server.grpc_listen_port = _free_port()
        if agent:
            # the UDP Jaeger agent receiver on its loopback default
            cfg.distributor.jaeger_agent_port = _free_port()
        if selftrace:
            # loopback into this App's distributor, flushed by hand; the
            # reserved tenant takes the default limits' processors
            cfg.selftrace.enabled = True
            cfg.selftrace.flush_interval_s = 3600.0
            cfg.overrides_defaults.generator.processors = tuple(processors)
        if grpc or selftrace or agent:
            # phases 16 and 17 read their traces live and drops them at shutdown:
            # no cut loop writes WAL segments during the phase (16c moves
            # the clock to the wall's, which would make every trace idle)
            cfg.ingester.flush_check_period_s = 3600.0
        self.clock = [t0]
        # t0 None: the wall clock
        self.app = App(cfg, now=(time.time if t0 is None
                                 else lambda: self.clock[0]), device=device)
        # the default limits hold: 4 pushes of ~2.8 MB stay within the
        # 20 MB ingestion burst (`patch` raises them where a phase needs)
        self.app.overrides.set_tenant_patch(APP_TENANT, {
            "generator": {"processors": list(processors)}, **(patch or {})})
        self.app.start_loops()
        self.srv = serve(self.app, block=False)
        self.base = f"http://127.0.0.1:{cfg.server.http_listen_port}"
        self.grpc = f"127.0.0.1:{self.app.grpc_port}" if grpc else None
        self.inst = self.app.generator.instance(APP_TENANT)

    def post(self, payload) -> float:
        """One OTLP protobuf push through `/v1/traces`; ms with the reply."""
        import urllib.request

        req = urllib.request.Request(
            self.base + "/v1/traces", data=payload,
            headers={"Content-Type": "application/x-protobuf"})
        t = time.perf_counter()
        with _http_errors("POST /v1/traces"):
            with urllib.request.urlopen(req, timeout=120) as r:
                body = json.loads(r.read() or b"{}")
                if r.status != 200 or body:
                    raise AssertionError(f"phase 14: push answered "
                                         f"{r.status} {body}")
        return (time.perf_counter() - t) * 1e3

    def get(self, path, tenant=None):
        """(ms, decoded body) of one GET (as `tenant` when given): JSON, or
        the text of /metrics."""
        import urllib.request

        req = urllib.request.Request(
            self.base + path,
            headers={"X-Scope-OrgID": tenant} if tenant else {})
        t = time.perf_counter()
        with _http_errors(f"GET {path}"):
            with urllib.request.urlopen(req, timeout=120) as r:
                raw = r.read()
        ms = (time.perf_counter() - t) * 1e3
        return ms, (raw.decode() if path == "/metrics" else json.loads(raw))

    def settle(self):
        import torch

        self.app.sched.flush()
        self.inst.drain()
        if self.app.device.type == "cuda":
            torch.cuda.synchronize()

    def shutdown(self, keep_live=True):
        """Stop the server and the App. With `keep_live` false the
        ingester's live traces are dropped instead of cut and flushed
        (App.shutdown's `flush_all`): the CPU twin holds 14a's reads only,
        and the card's App flushed the same traces in 14b."""
        self.srv.shutdown()
        self.srv.server_close()
        if not keep_live:
            self.app.ingester.flush_all = lambda: None
        self.app.shutdown()
        # App.shutdown waits 5 s a loop; a cut still writing WAL segments
        # after that would race the removal of the phase's directory
        for t in self.app.ingester._threads:
            t.join()


def _app_paths(spans, t0):
    """The reads of phase 14a: finds, a search, the tags, a rate and a
    quantile query_range by service, the span-metrics summary and
    /metrics."""
    import urllib.parse

    tids = sorted({s["trace_id"] for sp in spans for s in sp})
    picks = tids[::len(tids) // N_APP_FIND][:N_APP_FIND]
    q = urllib.parse.quote
    win = f"&start={t0 - APP_WINDOW_S}&end={t0}&step=60"
    return picks, {
        **{f"find {i}": f"/api/traces/{t.hex()}" for i, t in enumerate(picks)},
        "search": f"/api/search?limit=20&q={q(APP_SEARCH)}"
                  f"&start={t0 - APP_WINDOW_S}&end={t0}",
        "tags": "/api/search/tags",
        "rate": f"/api/metrics/query_range?q={q(APP_RATE)}{win}",
        "quantile": f"/api/metrics/query_range?q={q(APP_QUANT)}{win}",
        "summary": f"/api/metrics/summary?q={q('{ }')}"
                   f"&groupBy=resource.service.name",
        "metrics": "/metrics",
    }


def _canon(key, body):
    """An answer in a form two Apps can be compared by: spans sorted by
    span id, traces by id, series by labels, /metrics by family names
    (its values are timings)."""
    if key == "metrics":
        return sorted({ln.split()[2] for ln in body.splitlines()
                       if ln.startswith("# TYPE")})
    if key.startswith("find"):
        return sorted(body["spans"], key=lambda s: s["span_id"])
    if key == "search":
        return sorted(body["traces"], key=lambda t: t["traceID"])
    if key in ("rate", "quantile"):
        return sorted((json.dumps(s["labels"], sort_keys=True), s["samples"])
                      for s in body["series"])
    if key == "summary":
        return sorted(body["summaries"],
                      key=lambda s: json.dumps(s["series"]))
    return body


def _app_reads(rig, paths):
    """Every read of `paths` → ({key: canonical answer}, {key: ms})."""
    got, ms = {}, {}
    for key, path in paths.items():
        ms[key], body = rig.get(path)
        got[key] = _canon(key, body)
    return got, ms


def _check_app_answers(got, spans, t0, ctx):
    """The card's answers against the payloads themselves: every find the
    sent trace, the rate counting every span, every service present."""
    sent: dict = {}
    for sp in spans:
        for s in sp:
            sent.setdefault(s["trace_id"].hex(), set()).add(s["span_id"].hex())
    for key, val in got.items():
        if key.startswith("find"):
            tid = val[0]["trace_id"]
            if {s["span_id"] for s in val} != sent[tid]:
                raise AssertionError(f"{ctx}: {key} found {len(val)} spans "
                                     f"of {len(sent[tid])}")
    total = sum(x["value"] for _, samples in got["rate"] for x in samples
                if x["value"] == x["value"]) * 60
    if round(total) != N_APP_PUSHES * N_SPANS:
        raise AssertionError(f"{ctx}: the rate counts {total} spans")
    if len(got["quantile"]) != 2 * len(got["rate"]) or not got["search"]:
        raise AssertionError(f"{ctx}: {len(got['quantile'])} quantile "
                             f"series, {len(got['search'])} traces found")


def _merge_input(spans_by_block):
    """The compaction input of phase 14b as the merge sees it: each
    block's rows in trace-id order (the ingester writes traces sorted),
    spans of a trace in the order the ingester combined them, blocks in
    order; only the ids matter to the merge."""
    tid, sid = [], []
    for spans in spans_by_block:
        by: dict = {}
        for s in spans:
            by.setdefault(s["trace_id"], []).append(s["span_id"])
        for t in sorted(by):
            tid += [t] * len(by[t])
            sid += by[t]
    return (np.frombuffer(b"".join(tid), np.uint8).reshape(-1, 16),
            np.frombuffer(b"".join(sid), np.uint8).reshape(-1, 8))


def _merge_bound(n_in, n_out):
    """The merge's least time: 24 bytes of ids read a row (trace and span
    id), 8 bytes of order written a kept row; no arithmetic to speak of
    (a sort's compares are not counted as flops)."""
    nbytes = 24 * n_in + 8 * n_out
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def phase14_profiles() -> dict:
    """The merge's device time and ops (torch.profiler) at phase 14b's
    shape, rebuilt from the seed: 3 pushes' rows then the first push's
    again, 65,536 rows, 49,152 kept."""
    from tempo_tpu_torch.ops import compact as cops

    spans, _ = _app_payloads(float(int(time.time())))
    tid, sid = _merge_input([[s for sp in spans for s in sp], spans[0]])
    out = {}
    (out["merge_device_ms"], out["merge_launches"], out["merge_wall_ms"],
     out["merge_top"]) = _profile(lambda: cops.merge_order(tid, sid,
                                                           device="cuda"))
    order = cops.merge_order(tid, sid, device="cuda")
    out["merge_rows"], out["merge_kept"] = len(tid), len(order)
    (out["merge_bound_bytes"], out["merge_bound_ms"],
     out["merge_bound_by"]) = _merge_bound(len(tid), len(order))
    return out


def _flush_blocks(rig, want, ctx):
    """Cut every live trace of the App's ingester, complete and flush the
    block, and poll until the store lists `want` blocks of the tenant
    (the ingester's own flush loops may take an op: wait for it)."""
    ing = rig.app.ingester
    t = time.perf_counter()
    ing.sweep_all(immediate=True)
    deadline = time.time() + 120
    while True:
        ing.flush_tick()
        rig.app.db.poll_now()
        metas = rig.app.db.blocklist.metas(APP_TENANT)
        if len(metas) >= want:
            break
        if time.time() > deadline:
            raise AssertionError(f"{ctx}: {len(metas)} blocks flushed, "
                                 f"{want} wanted")
        time.sleep(0.05)
    return metas, time.perf_counter() - t


def _db_reads(db, picks, t0):
    """TempoDB direct: finds, the rate and the quantile (after the
    combiner's final pass) over the tenant's blocks; ({key: answer},
    {key: ms})."""
    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

    got, ms = {}, {}
    t = time.perf_counter()
    for i, tid in enumerate(picks):
        spans = db.find_trace_by_id(APP_TENANT, tid)
        got[f"find {i}"] = sorted(
            (s["span_id"], s["name"], s["start_unix_nano"],
             s["end_unix_nano"]) for s in spans)
    ms["find"] = (time.perf_counter() - t) / len(picks) * 1e3
    for key, q in (("rate", APP_RATE), ("quantile", APP_QUANT)):
        req = QueryRangeRequest(
            query=q, start_ns=int((t0 - APP_WINDOW_S) * 1e9),
            end_ns=int(t0 * 1e9), step_ns=int(60e9))
        t = time.perf_counter()
        got[key] = _series_map(_final(db.query_range(APP_TENANT, req), req))
        ms[key] = (time.perf_counter() - t) * 1e3
    return got, ms


def _same_db_reads(a, b, ctx):
    for key in a:
        if key in ("rate", "quantile"):
            _same_series(a[key], b[key], True, f"{ctx}: {key}")
        elif a[key] != b[key]:
            raise AssertionError(f"{ctx}: {key} differs")


def _entry_point(root, port):
    """Start `python3 -m tempo_tpu_torch` (the repo's binary, the default
    config but for its storage paths, on the card) with its stderr in a
    file; the process is waited for in `_entry_point_check`."""
    cfg = os.path.join(root, "tempo.yaml")
    with open(cfg, "w") as f:
        f.write(f"storage:\n  local_path: {root}/blocks\n"
                f"  wal_path: {root}/data/wal\n"
                f"generator:\n  localblocks: {{data_dir: {root}/lb}}\n")
    err = open(os.path.join(root, "stderr.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tempo_tpu_torch", "-config.file", cfg,
         "-server.http-listen-port", str(port)], cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=err)
    proc.ready_s = None
    threading.Thread(target=_watch_ready, args=(proc, port),
                     daemon=True).start()
    return proc, err


def _watch_ready(proc, port):
    """Poll `/ready` from the process's start; keep the seconds it took."""
    import urllib.error
    import urllib.request

    t = time.perf_counter()
    while proc.poll() is None and time.perf_counter() - t < 120:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/ready",
                                        timeout=5) as r:
                if r.status == 200:
                    proc.ready_s = time.perf_counter() - t
                    return
        except (urllib.error.URLError, OSError):
            pass
        time.sleep(0.1)


def _entry_point_check(proc, err, root, port, payload, spans, ctx):
    """Phase 14c: wait for `/ready`, push one payload, find one of its
    traces, then stop the process with SIGINT (15 s, then it fails)."""
    import signal
    import urllib.request

    base = f"http://127.0.0.1:{port}"
    t = time.perf_counter()
    try:
        deadline = time.time() + 120
        while proc.ready_s is None:
            if proc.poll() is not None:
                raise AssertionError(f"{ctx}: the process exited "
                                     f"{proc.returncode}")
            if time.time() > deadline:
                raise AssertionError(f"{ctx}: not ready in 120 s")
            time.sleep(0.1)
        ready_s = proc.ready_s
        req = urllib.request.Request(
            base + "/v1/traces", data=payload,
            headers={"Content-Type": "application/x-protobuf"})
        t1 = time.perf_counter()
        with _http_errors("14c POST /v1/traces"), \
                urllib.request.urlopen(req, timeout=120) as r:
            if r.status != 200:
                raise AssertionError(f"{ctx}: push answered {r.status}")
        push_ms = (time.perf_counter() - t1) * 1e3
        tid = spans[0]["trace_id"]
        with _http_errors("14c GET /api/traces"), urllib.request.urlopen(
                f"{base}/api/traces/{tid.hex()}", timeout=60) as r:
            doc = json.loads(r.read())
        want = sorted(s["span_id"].hex() for s in spans
                      if s["trace_id"] == tid)
        if sorted(s["span_id"] for s in doc["spans"]) != want:
            raise AssertionError(f"{ctx}: the find returned "
                                 f"{len(doc['spans'])} spans of {len(want)}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=15)
        if rc != 0:
            raise AssertionError(f"{ctx}: exit {rc} after SIGINT")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    with open(os.path.join(root, "stderr.txt")) as f:
        log = f.read()
    if "tempo_tpu_torch starting: target=all" not in log:
        raise AssertionError(f"{ctx}: no start line: {log[-1000:]}")
    return dict(ready_s=ready_s, push_ms=push_ms, rc=rc,
                seconds=time.perf_counter() - t)


def phase_app(card):
    """Phase 14: the App on the card (14a, 14b) against a CPU twin, and
    `python3 -m tempo_tpu_torch` (14c). Returns (results, K1's kernel
    entry)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase14-",
                                     dir=os.path.join(ROOT, "build")) as root:
        return _phase_app(card, root)


def _reset_singletons():
    from tempo_tpu_torch import matview, sched
    from tempo_tpu_torch.ops import moments as msk
    from tempo_tpu_torch.parallel import serving
    from tempo_tpu_torch.registry import pages

    sched.reset()
    matview.reset()
    pages.reset()
    serving.reset()
    msk.set_query_tier("log2")


def _phase_app(card, root):
    ctx = "phase 14"
    t_phase = time.perf_counter()
    t0 = float(int(time.time()))
    if t0 % 3600 < 30:
        t0 += 30   # both blocks of 14b in one compaction window (an hour)
    spans, payloads = _app_payloads(t0)
    # 14c's process starts first, so its start-up overlaps 14a and 14b
    port = _free_port()
    os.makedirs(os.path.join(root, "bin"))
    proc, err = _entry_point(os.path.join(root, "bin"), port)
    try:
        out = _phase_app_in(card, root, t0, spans, payloads, ctx)
    except BaseException:
        proc.kill()
        proc.wait()
        err.close()
        raise
    out["c"] = _entry_point_check(proc, err, os.path.join(root, "bin"),
                                  port, payloads[0], spans[0], f"{ctx}c")
    out["seconds"] = time.perf_counter() - t_phase
    return out, out.pop("row")


def _phase_app_in(card, root, t0, spans, payloads, ctx):
    import torch

    from tempo_tpu_torch.block.sidecar import read_sidecar
    from tempo_tpu_torch.ops import compact as cops
    from tempo_tpu_torch.ops import cuda_kernels as ck

    # 14a: the App on the card through its HTTP API
    _reset_singletons()
    rig = _AppRig("cuda", os.path.join(root, "card"), t0)
    proc = rig.inst.processors["span-metrics"]
    mats = _capture_windows(proc)
    sc = rig.app.sched
    b0 = sc.batches_total.get(SCHED_KERNEL, 0)
    ck.reset_launch_counts()
    push_ms = [rig.post(p) for p in payloads]
    rig.settle()
    launches = ck.paged_fused_update.launches
    dispatches = sc.batches_total.get(SCHED_KERNEL, 0) - b0
    if launches != dispatches or not launches:
        raise AssertionError(f"{ctx}a: K1 launched {launches} times for "
                             f"{dispatches} merged dispatches")
    picks, paths = _app_paths(spans, t0)
    card_got, read_ms = _app_reads(rig, paths)
    _check_app_answers(card_got, spans, t0, f"{ctx}a")
    k1, row = _dist_k1_row(
        "paged_fused_update (the App: POST /v1/traces → Distributor."
        "push_otlp → the generator's SpanBatch route, scheduler, dense "
        "state, sketch dd, f32)", proc, mats[-1], launches, f"{ctx}a window")

    # 14b: the cold tier of the same App
    db = rig.app.db
    metas_a, flush_a_s = _flush_blocks(rig, 1, f"{ctx}b")
    before, db_ms = _db_reads(db, picks, t0)
    dup_ms = rig.post(payloads[0])
    rig.settle()
    metas_ab, flush_b_s = _flush_blocks(rig, len(metas_a) + 1, f"{ctx}b")
    seen = []
    inner = cops.merge_order

    def capture(tid, sid, device=None):
        order = inner(tid, sid, device=device)
        seen.append((tid, sid, order, device))
        return order

    cops.merge_order = capture
    try:
        t = time.perf_counter()
        n_groups = db.compact_tenant_once(APP_TENANT)
        compact_s = time.perf_counter() - t
    finally:
        cops.merge_order = inner
    if n_groups != 1 or len(seen) != 1:
        raise AssertionError(f"{ctx}b: {n_groups} groups, {len(seen)} merges")
    tid, sid, order, dev = seen[0]
    n_in = len(tid)
    if dev is None or torch.device(dev) != db.device or \
            n_in != (N_APP_PUSHES + 1) * N_SPANS or \
            len(order) != N_APP_PUSHES * N_SPANS:
        raise AssertionError(f"{ctx}b: merge of {n_in} rows on {dev} kept "
                             f"{len(order)}")
    if not np.array_equal(order, cops.reference_merge_order(tid, sid)):
        raise AssertionError(f"{ctx}b: the merge differs from "
                             f"reference_merge_order")
    if not np.array_equal(order, cops.merge_order(tid, sid, device="cpu")):
        raise AssertionError(f"{ctx}b: the merge differs from the CPU's")
    stats = db.compaction_stats
    outs = db.blocklist.metas(APP_TENANT)
    if stats["blocks"] != len(metas_ab) or stats["spans"] != n_in or \
            not outs or not all(m.sidecar and m.compaction_level == 1
                                for m in outs) or \
            stats["sidecars_written"] != len(outs) or \
            sum(m.total_spans for m in outs) != len(order):
        raise AssertionError(f"{ctx}b: after compaction {stats}, "
                             f"{[(m.compaction_level, m.sidecar) for m in outs]}")
    for m in outs:
        if read_sidecar(db.r, APP_TENANT, m.block_id) is None:
            raise AssertionError(f"{ctx}b: block {m.block_id} has no sidecar")
    after, _ = _db_reads(db, picks, t0)
    _same_db_reads(after, before, f"{ctx}b: compacted against its inputs")
    rig.shutdown()
    del rig, proc, mats, db
    gc.collect()
    torch.cuda.empty_cache()

    # the CPU twin of 14a: the same payloads on the same clock
    _reset_singletons()
    twin = _AppRig("cpu", os.path.join(root, "twin"), t0)
    for p in payloads:
        twin.post(p)
    twin.settle()
    twin_got, _ = _app_reads(twin, paths)
    twin.shutdown(keep_live=False)
    _reset_singletons()
    for key in paths:
        if card_got[key] != twin_got[key]:
            raise AssertionError(f"{ctx}a: {key} differs between the card "
                                 f"and its CPU twin")
    return dict(push_ms=push_ms, dup_ms=dup_ms, read_ms=read_ms,
                db_ms=db_ms, launches=launches, dispatches=dispatches,
                k1_device_ms=k1["device_ms"], flush_s=(flush_a_s, flush_b_s),
                compact_s=compact_s,
                device_seconds=stats["device_seconds"], merge_rows=n_in,
                merge_kept=len(order), blocks_in=len(metas_ab),
                blocks_out=len(outs), n_reads=len(paths), row=row)


def _print_phase14(r, p, card):
    a = r["read_ms"]
    finds = [v for k, v in a.items() if k.startswith("find")]
    print(f"phase 14a [{card}]: the App at target all on the card, "
          f"{N_APP_PUSHES} pushes of {N_SPANS} spans through POST "
          f"/v1/traces: {', '.join(f'{m:.1f}' for m in r['push_ms'])} ms a "
          f"push; {r['n_reads']} reads equal to the CPU twin's; K1 launches "
          f"{r['launches']} = merged dispatches {r['dispatches']}, device "
          f"{r['k1_device_ms']} ms a window")
    print(f"phase 14a [{card}]: HTTP ms: find median "
          f"{statistics.median(finds):.2f}, search {a['search']:.2f}, tags "
          f"{a['tags']:.2f}, rate "
          f"{a['rate']:.2f}, quantile {a['quantile']:.2f}, summary "
          f"{a['summary']:.2f}, /metrics {a['metrics']:.2f}; TempoDB direct "
          f"over the flushed block: find {r['db_ms']['find']:.2f}, rate "
          f"{r['db_ms']['rate']:.2f}, quantile {r['db_ms']['quantile']:.2f}")
    print(f"phase 14b [{card}]: flush (cut, complete, flush, poll) "
          f"{r['flush_s'][0]:.2f} s for {N_APP_PUSHES * N_SPANS} spans, "
          f"{r['flush_s'][1]:.2f} s for the repeated push ({r['dup_ms']:.1f} "
          f"ms); compact_tenant_once {r['compact_s']:.3f} s with the host "
          f"({r['blocks_in']} blocks, {r['merge_rows']} rows → "
          f"{r['blocks_out']} block(s), {r['merge_kept']} rows, sidecars "
          f"on), the merge's dispatch {r['device_seconds'] * 1e3:.2f} ms; the "
          f"merge alone (its own process): device "
          + (f"{p['merge_device_ms']:.4f} ms" if p["merge_device_ms"]
             else "not measured")
          + f" in {p['merge_launches']:.0f} ops, wall {p['merge_wall_ms']:.3f} "
          f"ms, longest {p['merge_top'][0]} {p['merge_top'][1]:.4f} ms; bound "
          f"{p['merge_bound_ms']:.6f} ms by {p['merge_bound_by']} "
          f"({p['merge_bound_bytes']} bytes)")
    c = r["c"]
    print(f"phase 14c [{card}]: python3 -m tempo_tpu_torch ready "
          f"{c['ready_s']:.1f} s after its start (with the phase's), a push "
          f"{c['push_ms']:.1f} ms, a find equal to the payload, SIGINT exit "
          f"{c['rc']}; phase 14 {r['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: the generator's durability and fleet (ingest WAL, checkpoints,
# the handoff controller and its worker) and native histograms
# ---------------------------------------------------------------------------

DEFAULT_PROCESSORS = ("span-metrics", "service-graphs")
N_WAL_PUSHES = 3
N_WORKER_PUSHES = 2
N_CKPT_PUSHES = 2
FLEET_TENANT = "handoff-0"
NATIVE_OBS = N_SPANS


def _abandon(rig):
    """The kill shape in process: stop an App's server and every loop it
    started with no shutdown (no drain, no flush, no checkpoint; the WAL
    segment left open)."""
    rig.srv.shutdown()
    rig.srv.server_close()
    app = rig.app
    app._stop.set()
    for part in (app.ingester, app.generator, app.db):
        if part is not None:
            part._stop.set()
    if app.fleet is not None:
        app.fleet._stop.set()
        app.fleet._wake.set()
    if getattr(app, "usage_reporter", None) is not None:
        app.usage_reporter.shutdown()
    for lc in app._lifecyclers:
        lc.stop_heartbeat()


def _quantiles(inst):
    """The span-metrics DDSketch quantiles q50 and q99 by label set."""
    proc = inst.processors["span-metrics"]
    return [proc.dd_quantiles((q,))[0] for q in (0.5, 0.99)]


def _same_quantiles(a, b, ctx):
    if _quantiles(a) != _quantiles(b):
        raise AssertionError(f"{ctx}: DDSketch q50/q99 differ")


def _acc_wrap(inner, acc, key):
    """`inner` with its seconds added to `acc[key]`."""
    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
    return timed


def _class_patch(cls, name, wrap):
    """Replace `cls.name` by `wrap(original)`; returns an undo."""
    inner = getattr(cls, name)
    setattr(cls, name, wrap(inner))
    return lambda: setattr(cls, name, inner)


def phase_durability(card, device="cuda"):
    """Phase 15 on `device` (`cpu` only for a rehearsal) against CPU
    twins: 15a kill and replay of the App's ingest WAL, 15b checkpoint and
    restore, 15c the handoff and the fleet worker, 15d native histograms.
    Returns (results, K1's kernel entry)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase15-",
                                     dir=os.path.join(ROOT, "build")) as root:
        t_phase = time.perf_counter()
        out, row = _phase_wal_app(card, root, device)
        out["seconds_a"] = time.perf_counter() - t_phase
        _print_15a(out, card)
        t = time.perf_counter()
        out["b"] = _phase_checkpoints(out.pop("inst"), device)
        out["b"]["seconds"] = time.perf_counter() - t
        _print_15b(out["b"], card)
        _reset_singletons()
        t = time.perf_counter()
        out["c"] = _phase_fleet(root, device)
        out["c"]["seconds"] = time.perf_counter() - t
        _print_15c(out["c"], card)
        t = time.perf_counter()
        out["d"] = _phase_native(device)
        out["d"]["seconds"] = time.perf_counter() - t
        out["seconds"] = time.perf_counter() - t_phase
        _print_15d(out["d"], card, out["seconds"])
        return out, row


def _phase_wal_app(card, root, device):
    """15a: the App at target `all` with `wal.enabled` (default fsync) and
    the default processors on dense state takes `N_WAL_PUSHES` pushes of
    `deep_trace_spans` over HTTP and is abandoned; a second App over the
    same directories replays the WAL at its boot through the scheduler
    and K1; its state equals the first App's and a CPU twin's."""
    import torch

    from tempo_tpu_torch.generator import wal as twal
    from tempo_tpu_torch.generator.generator import Generator
    from tempo_tpu_torch.generator.processors.spanmetrics import (
        SpanMetricsProcessor)
    from tempo_tpu_torch.ops import cuda_kernels as ck

    ctx = "phase 15a"
    t0 = float(int(time.time()))
    spans = [deep_trace_spans(N_SPANS, seed=SEED + 150 + k,
                              now_ns=int(t0 * 1e9))
             for k in range(N_WAL_PUSHES)]
    from tempo_tpu_torch.model.otlp import encode_spans_otlp
    payloads = [encode_spans_otlp(s) for s in spans]
    dirs = os.path.join(root, "app")

    _reset_singletons()
    for k in twal.STATS:
        twal.STATS[k] = type(twal.STATS[k])(0)
    rig = _AppRig(device, dirs, t0, processors=DEFAULT_PROCESSORS, wal=True)
    if rig.inst.state_layout != "dense":
        raise AssertionError(f"{ctx}: {rig.inst.state_layout} state")
    acc = {}
    wal = rig.app.generator.wal
    _timed(wal, "append_view", acc)
    undo = _class_patch(twal._TenantWal, "_sync_to",
                        lambda inner: _acc_wrap(inner, acc, "fsync"))
    try:
        push_ms = [rig.post(p) for p in payloads]
    finally:
        undo()
    rig.settle()
    appended = twal.STATS["appended_batches"]
    if appended != N_WAL_PUSHES:
        raise AssertionError(f"{ctx}: {appended} WAL records for "
                             f"{N_WAL_PUSHES} acked pushes")
    rec_bytes = twal.STATS["appended_bytes"] / appended
    first = rig.inst
    _abandon(rig)

    # the second App over the same directories: boot replay
    _reset_singletons()
    mats, replay = [], {}
    undo_w = _class_patch(
        SpanMetricsProcessor, "_dispatch_packed",
        lambda inner: lambda self, mat: (mats.append(mat.copy()),
                                         inner(self, mat))[1])
    undo_r = _class_patch(Generator, "replay_wal_all",
                          lambda inner: _acc_wrap(inner, replay, "replay"))
    ck.reset_launch_counts()
    t = time.perf_counter()
    try:
        rig2 = _AppRig(device, dirs, t0, processors=DEFAULT_PROCESSORS,
                       wal=True)
    finally:
        undo_w()
        undo_r()
    boot_s = time.perf_counter() - t
    rig2.settle()
    launches = ck.paged_fused_update.launches
    dispatches = rig2.app.sched.batches_total.get(SCHED_KERNEL, 0)
    replayed = twal.STATS["replayed_batches"]
    if replayed != N_WAL_PUSHES or twal.STATS["dead_letters"]:
        raise AssertionError(f"{ctx}: replayed {replayed} records, "
                             f"{twal.STATS['dead_letters']} dead letters")
    if device == "cuda" and (launches != dispatches or not launches):
        raise AssertionError(f"{ctx}: K1 launched {launches} times for "
                             f"{dispatches} replayed dispatches")
    inst = rig2.inst
    n_fams, n_series, rel = _compare_by_labels(inst, first,
                                               f"{ctx} replay vs live")
    _same_quantiles(inst, first, f"{ctx} replay vs live")
    k1 = row = None
    if device == "cuda":
        k1, row = _dist_k1_row(
            "paged_fused_update (WAL replay at the App's boot: Generator."
            "replay_wal_all → push_staged_view → the SpanBatch route, "
            "scheduler, dense state, sketch dd, f32)",
            inst.processors["span-metrics"], mats[-1], launches,
            f"{ctx} replayed window")
    # the second App's loops stop too (its instance stays for 15b)
    _abandon(rig2)
    del first
    gc.collect()

    # the CPU twin: the same payloads into an App on the host
    _reset_singletons()
    twin = _AppRig("cpu", os.path.join(root, "twin"), t0,
                   processors=DEFAULT_PROCESSORS)
    for p in payloads:
        twin.post(p)
    twin.settle()
    _compare_by_labels(inst, twin.inst, f"{ctx} card vs CPU twin")
    _same_quantiles(inst, twin.inst, f"{ctx} card vs CPU twin")
    twin.shutdown(keep_live=False)
    _reset_singletons()
    n_spans = N_WAL_PUSHES * N_SPANS
    return dict(push_ms=push_ms,
                append_ms=acc["append_view"] / N_WAL_PUSHES * 1e3,
                fsync_ms=acc["fsync"] / N_WAL_PUSHES * 1e3,
                rec_bytes=rec_bytes, boot_s=boot_s,
                replay_s=replay["replay"],
                replay_spans_per_s=n_spans / replay["replay"],
                launches=launches, dispatches=dispatches,
                k1_device_ms=k1["device_ms"] if k1 else None,
                n_fams=n_fams, n_series=n_series, sum_rel=rel,
                inst=inst), row


def _snap_restore(inst, fresh, ctx, rtol=0.0):
    """Snapshot `inst`, restore into `fresh()` on the same device; the
    restored instance equals `inst` by labels (`rtol` 0: bit for bit).
    Returns the timings, blob bytes and device-to-host copies."""
    import torch

    from tempo_tpu_torch.fleet import checkpoint as fck

    inst.drain()
    sync = torch.cuda.synchronize if inst.device.type == "cuda" \
        else (lambda: None)
    sync()
    c0 = fck.D2H_COPIES
    t = time.perf_counter()
    blob = fck.snapshot_instance(inst)
    snap_ms = (time.perf_counter() - t) * 1e3
    copies = fck.D2H_COPIES - c0
    dst = fresh()
    t = time.perf_counter()
    stats = fck.restore_instance(dst, blob)
    sync()
    restore_ms = (time.perf_counter() - t) * 1e3
    if stats["dropped"] or not stats["series"]:
        raise AssertionError(f"{ctx}: restore {stats}")
    _compare_by_labels(dst, inst, ctx, rtol=rtol)
    if rtol == 0.0:
        _same_quantiles(dst, inst, ctx)
    return dict(blob=blob, blob_bytes=len(blob), snap_ms=snap_ms,
                restore_ms=restore_ms, copies=copies,
                series=stats["series"]), dst


def _phase_checkpoints(inst, device):
    """15b: `snapshot_instance` of 15a's replayed tenant (dense, default
    processors), restored into a fresh instance (bit for bit) and into
    one that took a push (equal to the oracle that took every push); a
    paged `sketch: both` f32 tenant restored into a fresh paged instance
    and into a dense one (bit for bit); a compact tenant restored into a
    fresh compact instance (counts exact, the latency sum within the
    compact tier's 1%)."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.fleet import checkpoint as fck
    from tempo_tpu_torch.model.otlp_batch import stage_otlp
    from tempo_tpu_torch.registry import pages

    ctx = "phase 15b"
    out = {}
    clock = inst.now

    def like(src):
        return lambda: tt.GeneratorInstance(src.tenant, src.cfg, now=clock,
                                            device=device)

    out["dense"], _ = _snap_restore(inst, like(inst), f"{ctx} dense")
    # into an instance that took a push of other traces: the oracle took
    # every push. Span metrics only: the service-graph families follow
    # the processor's store of unpaired edges (its capacity and expiry),
    # which is host state and not in a checkpoint, as in the reference
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    t0 = clock()
    payloads = [encode_spans_otlp(deep_trace_spans(
        N_SPANS, seed=SEED + 150 + k, now_ns=int(t0 * 1e9)))
        for k in range(N_WAL_PUSHES + 1)]
    took = like(inst)()
    took.push_staged_view(stage_otlp(payloads[-1], took.registry.interner)
                          .view())
    fck.restore_instance(took, out["dense"]["blob"])
    oracle = like(inst)()
    for p in payloads:
        oracle.push_staged_view(stage_otlp(p, oracle.registry.interner).view())
    took.drain()
    oracle.drain()
    _compare_by_labels(took, oracle, f"{ctx} into a pushed instance",
                       prefix="traces_spanmetrics")
    _same_quantiles(took, oracle, f"{ctx} into a pushed instance")

    # paged tenants: `sketch: both` f32, then compact
    now = time.time()
    k6, sizes, int_w, _ = _payloads(now, N_CKPT_PUSHES)
    for tier, sm in (("paged", dict(sketch="both")),
                     ("compact", dict(sketch="both", compact_state=True))):
        pool = pages.PagePool(tt.PagePoolConfig(
            enabled=True, page_rows=PAGE_ROWS, arena_slots=ARENA_SLOTS),
            device=device)
        cfg = tt.GeneratorConfig(processors=("span-metrics",),
                                 spanmetrics=tt.SpanMetricsConfig(**sm))
        with pages.use(pool):
            src = tt.GeneratorInstance("ckpt", cfg, now=lambda: now,
                                       device=device)
            if src.state_layout != "paged":
                raise AssertionError(f"{ctx} {tier}: {src.state_layout}")
            _push_all(src, k6, sizes, int_w)
            out[tier], _ = _snap_restore(
                src, lambda: tt.GeneratorInstance("ckpt", cfg,
                                                  now=lambda: now,
                                                  device=device),
                f"{ctx} {tier} → paged", rtol=0.0 if tier == "paged"
                else 1e-2)
        if tier == "paged":
            dense = tt.GeneratorInstance("ckpt", cfg, now=lambda: now,
                                         device=device)
            t = time.perf_counter()
            fck.restore_instance(dense, out[tier]["blob"])
            out["to_dense_ms"] = (time.perf_counter() - t) * 1e3
            if dense.state_layout != "dense":
                raise AssertionError(f"{ctx}: paged → {dense.state_layout}")
            _compare_by_labels(dense, src, f"{ctx} paged → dense", rtol=0.0)
            _same_quantiles(dense, src, f"{ctx} paged → dense")
        del src
    for v in out.values():
        if isinstance(v, dict):
            v.pop("blob", None)
    return out


def _worker_yaml(root, port):
    return (f"target: metrics-generator\n"
            f"server: {{http_listen_port: {port}}}\n"
            f"ring_kv_url: local\nusage_stats_enabled: false\n"
            f"storage:\n  backend: local\n  local_path: {root}/blocks\n"
            f"  wal_path: {root}/wal\n"
            f"wal: {{enabled: true, dir: {root}/gwal}}\n"
            f"fleet: {{enabled: true, rebalance_interval_s: 5.0}}\n"
            f"distributor: {{generator_placement: tenant}}\n"
            f"generator:\n  processors: [span-metrics]\n"
            f"overrides_defaults:\n  generator:\n"
            f"    processors: [span-metrics]\n"
            f"    ingestion_time_range_slack_s: 0.0\n"
            f"    collection_interval_s: 3600.0\n")


def _worker_collect(base, tenant):
    """(samples {(name, labels): value}, q99 {labels: value}) over HTTP."""
    import urllib.request

    def get(path):
        req = urllib.request.Request(base + path,
                                     headers={"X-Scope-OrgID": tenant})
        with _http_errors(f"GET {path}"), \
                urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    doc = get("/internal/generator/collect?ts_ms=1")
    samples = {(s["name"], tuple(tuple(kv) for kv in s["labels"])):
               s["value"] for s in doc["samples"]}
    q = get("/internal/generator/quantile?q=0.99")
    return samples, {tuple(tuple(kv) for kv in e["labels"]): e["value"]
                     for e in q["quantiles"]}


def _same_samples(got, want, ctx):
    """Samples by label set: counts exact, `_sum`s and the size counter
    within rtol 1e-5."""
    if got.keys() != want.keys():
        raise AssertionError(f"{ctx}: {len(got)} / {len(want)} samples")
    for k, v in want.items():
        if k[0].endswith("_sum") or k[0] == "traces_spanmetrics_size_total":
            ok = abs(got[k] - v) <= 1e-5 * abs(v) + 1e-6
        else:
            ok = got[k] == v
        if not ok:
            raise AssertionError(f"{ctx}: {k}: {got[k]} vs {v}")


def _phase_fleet(root, device):
    """15c: two `FleetController`s on one `KVStore` and a `local` backend
    hand a tenant off with zero loss; then `python3 -m tempo_tpu_torch.
    fleet.worker` with the WAL takes `N_WORKER_PUSHES` pushes, is
    SIGKILLed, restarted over the same directories, and answers the
    oracle's samples and q99."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.fleet import STATS as FSTATS
    from tempo_tpu_torch.fleet import FleetConfig
    from tempo_tpu_torch.fleet import checkpoint as fck
    from tempo_tpu_torch.fleet.controller import FleetController
    from tempo_tpu_torch.fleet.placement import TenantPlacement
    from tempo_tpu_torch.fleet.worker import reap_workers, spawn_worker
    from tempo_tpu_torch.generator import Generator
    from tempo_tpu_torch.overrides import Limits, Overrides
    from tempo_tpu_torch.ring import KVStore, Lifecycler, Ring
    from tempo_tpu_torch.rpc import RemoteGeneratorClient

    ctx = "phase 15c"
    out = {}
    now = time.time()
    k6, _, _, _ = _payloads(now, 3)
    be = LocalBackend(os.path.join(root, "fleet-store"))
    kv = KVStore()
    cfg = tt.GeneratorConfig(processors=("span-metrics",))
    members = {}
    for iid in ("gen-a", "gen-b"):
        g = Generator(cfg, instance_id=iid, now=lambda: now,
                         device=device)
        ring = Ring(kv=kv, key="generator", replication_factor=1,
                    now=lambda: now)
        lc = Lifecycler(kv, iid, key="generator", now=lambda: now)
        members[iid] = (g, lc, FleetController(
            g, ring, iid, be, be, cfg=FleetConfig(enabled=True),
            now=lambda: now))
    own = "gen-a" if TenantPlacement(members["gen-a"][2].ring,
                                     "gen-a").owns(FLEET_TENANT) else "gen-b"
    other = "gen-b" if own == "gen-a" else "gen-a"
    h0, r0 = FSTATS["handoffs"], FSTATS["restores"]
    members[own][0].push_otlp(FLEET_TENANT, k6[0])
    members[own][0].push_otlp(FLEET_TENANT, k6[1])
    members[own][1].leave()
    t = time.perf_counter()
    members[own][2].tick()               # drain, checkpoint, release
    out["handoff_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    members[other][2].tick()             # restore, consume the blob
    out["receive_ms"] = (time.perf_counter() - t) * 1e3
    if FLEET_TENANT in members[own][0].tenants() or \
            FLEET_TENANT not in members[other][0].tenants() or \
            FSTATS["handoffs"] - h0 != 1 or FSTATS["restores"] - r0 != 1 or \
            fck.list_checkpoints(be, "fleet-checkpoints"):
        raise AssertionError(f"{ctx}: the handoff did not conclude")
    members[other][0].push_otlp(FLEET_TENANT, k6[2])
    oracle = Generator(cfg, instance_id="oracle", now=lambda: now,
                          device=device)
    for p in k6:
        oracle.push_otlp(FLEET_TENANT, p)
    got = members[other][0].instance(FLEET_TENANT)
    want = oracle.instance(FLEET_TENANT)
    got.drain()
    want.drain()
    _compare_by_labels(got, want, f"{ctx} handoff")
    _same_quantiles(got, want, f"{ctx} handoff")
    out["blob_bytes"] = FSTATS["checkpoint_bytes"]
    del members, oracle, got, want

    # the worker: SIGKILL after the acked pushes, restart, the same answers
    wroot = os.path.join(root, "worker")
    os.makedirs(wroot)
    port = _free_port()
    cfg_path = os.path.join(wroot, "member.yaml")
    with open(cfg_path, "w") as f:
        f.write(_worker_yaml(wroot, port))
    procs = []
    try:
        t = time.perf_counter()
        p = spawn_worker(["--config", cfg_path], cwd=ROOT,
                         wait_ready_s=120.0)
        procs.append(p)
        out["worker_ready_s"] = time.perf_counter() - t
        base = f"http://127.0.0.1:{p.ready['port']}"
        client = RemoteGeneratorClient(base, timeout_s=120.0)
        from tempo_tpu_torch.model.otlp import encode_spans_otlp

        wl = [encode_spans_otlp(deep_trace_spans(
            N_SPANS, seed=SEED + 155 + k, now_ns=int(now * 1e9)))
            for k in range(N_WORKER_PUSHES)]
        for pl in wl:
            if client.push_otlp(FLEET_TENANT, pl) != N_SPANS:
                raise AssertionError(f"{ctx}: a worker push was not acked")
        p.kill()                          # SIGKILL: nothing drains
        p.wait(timeout=30)
        t = time.perf_counter()
        p2 = spawn_worker(["--config", cfg_path], cwd=ROOT,
                          wait_ready_s=120.0)
        procs.append(p2)
        out["restart_ready_s"] = time.perf_counter() - t
        samples, q99 = _worker_collect(
            f"http://127.0.0.1:{p2.ready['port']}", FLEET_TENANT)
    finally:
        reap_workers(procs)
    lim = Limits()
    lim.generator.processors = ("span-metrics",)
    lim.generator.ingestion_time_range_slack_s = 0.0
    lim.generator.collection_interval_s = 3600.0
    og = Generator(tt.GeneratorConfig(), instance_id="oracle-w",
                      overrides=Overrides(defaults=lim), device=device)
    for pl in wl:
        og.push_otlp(FLEET_TENANT, pl)
    oi = og.instance(FLEET_TENANT)
    oi.drain()
    want = {(s.name, tuple(s.labels)): s.value
            for s in oi.registry.collect(ts_ms=1) if not s.is_stale_marker}
    _same_samples(samples, want, f"{ctx} the restarted worker")
    want_q = {tuple(k): v for k, v in
              oi.processors["span-metrics"].quantile(0.99).items()}
    if q99 != want_q:
        raise AssertionError(f"{ctx}: the restarted worker's q99 differs")
    out["worker_samples"] = len(samples)
    return out


def _phase_native(device):
    """15d: a native histogram on dense and on paged state, card against
    host (log2 counts, counts and zero counts exact, sums at rtol 1e-6),
    and `remote_write.send_native_histograms`' payload, card against
    host."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.generator.remote_write import RemoteWriteConfig
    from tempo_tpu_torch.registry import pages
    from tempo_tpu_torch.registry.registry import (ManagedRegistry,
                                                   RegistryOverrides)

    ctx = "phase 15d"
    rng = np.random.default_rng(SEED + 15)
    vals = np.concatenate([np.zeros(64), rng.lognormal(-4, 2, NATIVE_OBS - 64)
                           ]).astype(np.float32)
    names = [f"svc-{i}" for i in rng.integers(0, 512, NATIVE_OBS)]
    out = {}

    def payload(reg):
        nh = reg.new_native_histogram("native_latency", ("service",))
        rows = reg.interner.intern_many(names).reshape(-1, 1)
        nh.observe_batch(rows, vals)
        return {labels: (np.asarray(h), s, c, z)
                for labels, h, s, c, z, _ts, _off in reg.native_histograms(1)}

    def same(a, b, what):
        if a.keys() != b.keys() or not a:
            raise AssertionError(f"{ctx} {what}: series differ")
        for k, (h, s, c, z) in a.items():
            h2, s2, c2, z2 = b[k]
            if not (np.array_equal(h, h2) and c == c2 and z == z2 and
                    abs(s - s2) <= 1e-6 * abs(s2) + 1e-9):
                raise AssertionError(f"{ctx} {what}: {k} differs")

    for layout in ("dense", "paged"):
        got = {}
        for dev in (device, "cpu"):
            pool = pages.PagePool(tt.PagePoolConfig(
                enabled=True, page_rows=PAGE_ROWS, arena_slots=ARENA_SLOTS),
                device=dev) if layout == "paged" else None
            with pages.use(pool):
                got[dev] = payload(ManagedRegistry(
                    "nh", RegistryOverrides(), device=dev))
        same(got[device], got["cpu"], layout)
        out[layout] = len(got["cpu"])
    sent = {}
    for dev in (device, "cpu"):
        inst = tt.GeneratorInstance("nh", tt.GeneratorConfig(
            processors=("span-metrics",), remote_write=RemoteWriteConfig(
                send_native_histograms=True)), now=lambda: 1000.0,
            device=dev)
        box = []
        inst.remote_write.send = lambda s, n=(), box=box: box.append(n) or True
        nh = inst.registry.new_native_histogram("native_latency",
                                                ("service",))
        nh.observe_batch(inst.registry.interner.intern_many(names)
                         .reshape(-1, 1), vals)
        inst.collect_and_push(ts_ms=1)
        sent[dev] = {lab: (np.asarray(h), s, c, z)
                     for lab, h, s, c, z, _ts, _off in box[0]}
    same(sent[device], sent["cpu"], "send_native_histograms")
    out["sent"] = len(sent["cpu"])
    return out


def phase15_profiles() -> dict:
    """Phase 15's device readings in this process (torch.profiler): the
    snapshot's gather and the restore's scatters of a dense default
    tenant fed 15a's payloads, `sketch_restore` alone, and the native
    histogram update on dense and paged state; each with its bound by
    bytes."""
    import torch

    import tempo_tpu_torch as tt
    from tempo_tpu_torch.fleet import checkpoint as fck
    from tempo_tpu_torch.model.otlp import encode_spans_otlp
    from tempo_tpu_torch.model.otlp_batch import stage_otlp
    from tempo_tpu_torch.registry import pages
    from tempo_tpu_torch.registry.registry import (ManagedRegistry,
                                                   RegistryOverrides)

    out = {}
    t0 = float(int(time.time()))
    cfg = tt.GeneratorConfig(processors=DEFAULT_PROCESSORS)
    src = tt.GeneratorInstance("p15", cfg, now=lambda: t0, device="cuda")
    for k in range(N_WAL_PUSHES):
        data = encode_spans_otlp(deep_trace_spans(
            N_SPANS, seed=SEED + 150 + k, now_ns=int(t0 * 1e9)))
        src.push_staged_view(stage_otlp(data, src.registry.interner).view())
    src.drain()
    torch.cuda.synchronize()
    blob = fck.snapshot_instance(src)
    meta, arrays = fck._decode(blob)
    moved = sum(v.nbytes for k, v in arrays.items()
                if not k.endswith("::keys") and not k.endswith("_sel"))
    out["p15_blob_bytes"] = len(blob)
    out["p15_moved_bytes"] = moved
    out["p15_series"] = int(src.processors["span-metrics"].calls.table
                            .active_count)
    c0 = fck.D2H_COPIES
    dev, ops, wall, top = _profile(lambda: fck.snapshot_instance(src))
    out.update(p15_snap_device_ms=dev, p15_snap_ops=int(ops),
               p15_snap_wall_ms=wall, p15_snap_top=top,
               p15_snap_copies=(fck.D2H_COPIES - c0) // 4)
    # the gather: each row read once and written once on the card
    out["p15_snap_bound_ms"] = 2 * moved / HBM_BYTES_PER_S * 1e3
    dst = tt.GeneratorInstance("p15", cfg, now=lambda: t0, device="cuda")
    fck.restore_instance(dst, blob)
    dev, ops, wall, top = _profile(lambda: fck.restore_instance(dst, blob))
    out.update(p15_restore_device_ms=dev, p15_restore_ops=int(ops),
               p15_restore_wall_ms=wall, p15_restore_top=top)
    # the scatter: the rows uploaded, the state rows read and written
    out["p15_restore_bound_ms"] = 3 * moved / HBM_BYTES_PER_S * 1e3
    proc = dst.processors["span-metrics"]
    srows = {k[len("__sketch__::"):]: v for k, v in arrays.items()
             if k.startswith("__sketch__::")}
    slots = proc.calls.table.active_slots()
    ok = np.ones(slots.size, bool)
    sk_bytes = sum(v.nbytes for k, v in srows.items() if not k.endswith("_sel"))

    def sk():
        with dst.registry.state_lock:
            proc.sketch_restore(meta["spanmetrics"], slots, ok, srows)
    dev, ops, wall, top = _profile(sk)
    out.update(p15_sketch_device_ms=dev, p15_sketch_ops=int(ops),
               p15_sketch_wall_ms=wall, p15_sketch_top=top,
               p15_sketch_bound_ms=3 * sk_bytes / HBM_BYTES_PER_S * 1e3)
    # native histograms: one batch of NATIVE_OBS observations
    rng = np.random.default_rng(SEED + 15)
    vals = rng.lognormal(-4, 2, NATIVE_OBS).astype(np.float32)
    sid = rng.integers(0, 512, NATIVE_OBS)
    for layout in ("dense", "paged"):
        pool = pages.PagePool(tt.PagePoolConfig(
            enabled=True, page_rows=PAGE_ROWS, arena_slots=ARENA_SLOTS),
            device="cuda") if layout == "paged" else None
        with pages.use(pool):
            reg = ManagedRegistry("nh", RegistryOverrides(), device="cuda")
        nh = reg.new_native_histogram("native_latency", ("service",))
        slots = nh.resolve_slots(reg.interner.intern_many(
            [f"svc-{i}" for i in sid]).reshape(-1, 1), None)
        dev, ops, wall, top = _profile(lambda: nh.observe_slots(slots, vals))
        cells = np.unique(slots.astype(np.int64) * 64 + np.minimum(
            np.floor(np.log2(vals) + 1e-4) + 33, 63).astype(np.int64)).size
        # slot, value and weight read once; each touched cell (a log2
        # bucket, and the slot's sum, count and zeros) read and written
        nbytes = 12 * NATIVE_OBS + 8 * (cells + 3 * np.unique(slots).size)
        out.update({f"p15_native_{layout}_device_ms": dev,
                    f"p15_native_{layout}_ops": int(ops),
                    f"p15_native_{layout}_wall_ms": wall,
                    f"p15_native_{layout}_bound_ms":
                        nbytes / HBM_BYTES_PER_S * 1e3})
    return out


_P15_LATER = {k: _Later(k) for k in (
    "p15_snap_device_ms", "p15_snap_ops", "p15_snap_wall_ms",
    "p15_snap_copies", "p15_snap_bound_ms", "p15_restore_device_ms",
    "p15_restore_ops", "p15_restore_wall_ms", "p15_restore_bound_ms",
    "p15_sketch_device_ms", "p15_sketch_ops", "p15_sketch_bound_ms",
    "p15_native_dense_device_ms", "p15_native_dense_ops",
    "p15_native_dense_bound_ms", "p15_native_paged_device_ms",
    "p15_native_paged_ops", "p15_native_paged_bound_ms",
    "p15_moved_bytes", "p15_series", "p15_snap_top", "p15_restore_top",
    "p15_sketch_top")}


def _print_15a(a, card):
    print(f"phase 15a [{card}]: the App with wal.enabled (fsync batch) and "
          f"the default processors, {N_WAL_PUSHES} pushes of {N_SPANS} "
          f"spans over HTTP: {', '.join(f'{m:.1f}' for m in a['push_ms'])} "
          f"ms a push, of it the WAL append {a['append_ms']:.3f} ms (fsync "
          f"{a['fsync_ms']:.3f} ms), {a['rec_bytes']:.0f} bytes a record; "
          f"abandoned; the second App ready {a['boot_s']:.2f} s after its "
          f"start, replay {a['replay_s']:.3f} s ({a['replay_spans_per_s']:.0f}"
          f" spans/s); K1 launches {a['launches']} = replayed dispatches "
          f"{a['dispatches']}, device {a['k1_device_ms']} ms a window; "
          f"{a['n_fams']} families, {a['n_series']} series equal to the live "
          f"App's and the CPU twin's (counts, buckets, DDSketch rows, "
          f"q50/q99 exact; max sum rel {a['sum_rel']:.2e}); 15a "
          f"{a['seconds_a']:.1f} s")


def _print_15b(b, card):
    later = _P15_LATER
    for tier in ("dense", "paged", "compact"):
        t = b[tier]
        print(f"phase 15b [{card}]: {tier} tenant ({t['series']} series): "
              f"snapshot {t['snap_ms']:.2f} ms with the host "
              f"({t['copies']} device-to-host copies), blob "
              f"{t['blob_bytes']} bytes, restore into a fresh instance "
              f"{t['restore_ms']:.2f} ms, "
              + ("bit for bit" if tier != "compact"
                 else "counts exact, sums within 1e-2"))
    print(f"phase 15b [{card}]: paged → dense {b['to_dense_ms']:.2f} ms, bit "
          f"for bit; a restore into an instance that took a push equals "
          f"the oracle; the snapshot's gather (its own process, dense "
          f"default tenant, {later['p15_series']} span-metrics series, "
          f"{later['p15_moved_bytes']} bytes of rows): device "
          f"{later['p15_snap_device_ms']} ms in {later['p15_snap_ops']} ops "
          f"(longest {later['p15_snap_top']}), "
          f"{later['p15_snap_copies']} copies to the host, wall "
          f"{later['p15_snap_wall_ms']} ms, bound "
          f"{later['p15_snap_bound_ms']} ms by bytes; the restore: device "
          f"{later['p15_restore_device_ms']} ms in "
          f"{later['p15_restore_ops']} ops (longest "
          f"{later['p15_restore_top']}), wall "
          f"{later['p15_restore_wall_ms']} ms, bound "
          f"{later['p15_restore_bound_ms']} ms; sketch_restore alone "
          f"{later['p15_sketch_device_ms']} ms in {later['p15_sketch_ops']} "
          f"ops (longest {later['p15_sketch_top']}), bound "
          f"{later['p15_sketch_bound_ms']} ms; 15b {b['seconds']:.1f} s")


def _print_15c(c, card):
    print(f"phase 15c [{card}]: handoff of a tenant between two "
          f"FleetControllers: the owner's tick {c['handoff_ms']:.1f} ms "
          f"(drain, snapshot, blob write), the receiver's "
          f"{c['receive_ms']:.1f} ms (read, restore), blob {c['blob_bytes']} "
          f"bytes, zero loss; python3 -m tempo_tpu_torch.fleet.worker ready "
          f"{c['worker_ready_s']:.1f} s, SIGKILLed after "
          f"{N_WORKER_PUSHES} pushes, ready again {c['restart_ready_s']:.1f} "
          f"s (boot replay included), {c['worker_samples']} samples and q99 "
          f"equal to the oracle's; 15c {c['seconds']:.1f} s")


def _print_15d(d, card, seconds):
    later = _P15_LATER
    print(f"phase 15d [{card}]: native histograms card = host on dense "
          f"({d['dense']} series) and paged ({d['paged']}) state, "
          f"send_native_histograms' payload equal ({d['sent']}); the update "
          f"of {NATIVE_OBS} observations (its own process): dense "
          f"{later['p15_native_dense_device_ms']} ms in "
          f"{later['p15_native_dense_ops']} ops (bound "
          f"{later['p15_native_dense_bound_ms']} ms), paged "
          f"{later['p15_native_paged_device_ms']} ms in "
          f"{later['p15_native_paged_ops']} ops (bound "
          f"{later['p15_native_paged_bound_ms']} ms); 15d {d['seconds']:.1f} "
          f"s; phase 15 {seconds:.1f} s")


def moments_state_bytes(n_payloads=N_DISPATCH):
    """Device state bytes per active series of the `sketch: moments` tier
    (f32 state) after the same pushes, on the card."""
    now = time.time()
    payloads, sizes, int_w, _ = _payloads(now, n_payloads)
    inst = _instances(now, dict(sketch="moments"),
                      (("moments-card", "cuda"),))["moments-card"]
    _push_all(inst, payloads, sizes, int_w)
    return inst.device_state_bytes() / inst.registry.active_series


# ---------------------------------------------------------------------------
# phase 16: the rest of the App's surface: the gRPC plane (OTLP, Jaeger and
# OpenCensus receivers, the query streams, the frontend worker), the
# Jaeger Thrift collector route, the vulture and self-tracing
# ---------------------------------------------------------------------------

N_GRPC_PUSHES = 3
N_OC_MESSAGES = 4
N_PULL_BLOCKS = 6
PULL_TENANT = "pull"
# 16,384 one-span traces a push: the ingester's live-trace limit and the
# ingestion rate are raised for the tenant, as phase 8 does
GRPC_PATCH = {"ingestion": {"rate_limit_bytes": 1 << 40,
                            "burst_size_bytes": 1 << 40,
                            "max_traces_per_user": 1 << 20}}
EXPORT = "/opentelemetry.proto.collector.trace.v1.TraceService/Export"
JAEGER_KIND = {1: "internal", 2: "server", 3: "client", 4: "producer",
               5: "consumer"}


def _jaeger_thrift_batches(spans):
    """`jaeger.thrift` Batches in TBinaryProtocol, one a service (a Batch
    carries one Process): the collector route's bodies for `spans`."""
    import struct

    def field(fid, typ, body):
        return struct.pack(">bh", typ, fid) + body

    def tstr(v):
        b = v.encode()
        return struct.pack(">i", len(b)) + b

    def tag(key, v):
        if isinstance(v, bool):
            val = field(2, 8, struct.pack(">i", 2)) + \
                field(5, 2, b"\x01" if v else b"\x00")
        else:
            val = field(2, 8, struct.pack(">i", 0)) + field(3, 11, tstr(v))
        return field(1, 11, tstr(key)) + val + b"\x00"

    by_service = {}
    for s in spans:
        by_service.setdefault(s["service"], []).append(s)
    out = []
    for service, group in by_service.items():
        enc = []
        for s in group:
            hi, lo = struct.unpack(">qq", s["trace_id"])
            (sid,) = struct.unpack(">q", s["span_id"])
            tags = [tag("span.kind", JAEGER_KIND[s["kind"]])]
            if s["status_code"] == 2:
                tags.append(tag("error", True))
            start = s["start_unix_nano"]
            enc.append(field(1, 10, struct.pack(">q", lo)) +
                       field(2, 10, struct.pack(">q", hi)) +
                       field(3, 10, struct.pack(">q", sid)) +
                       field(4, 10, struct.pack(">q", 0)) +
                       field(5, 11, tstr(s["name"])) +
                       field(7, 8, struct.pack(">i", 1)) +
                       field(8, 10, struct.pack(">q", start // 1000)) +
                       field(9, 10, struct.pack(
                           ">q", (s["end_unix_nano"] - start) // 1000)) +
                       field(10, 15, struct.pack(">bi", 12, len(tags)) +
                             b"".join(tags)) + b"\x00")
        process = field(1, 11, tstr(service)) + b"\x00"
        out.append(field(1, 12, process) +
                   field(2, 15, struct.pack(">bi", 12, len(enc)) +
                         b"".join(enc)) + b"\x00")
    return out


def _jaeger_proto_request(spans):
    """`jaeger.api_v2.PostSpansRequest` of `spans`, each with its own
    process (the tempo-query plugin's encoder)."""
    from tempo_tpu_torch.model import proto_wire as pw
    from tempo_tpu_torch.tempoquery.plugin import _jaeger_span

    batch = b"".join(pw.enc_field_msg(1, _jaeger_span(s, s["trace_id"]))
                     for s in spans)
    return pw.enc_field_msg(1, batch)


def _opencensus_messages(spans, n_messages=N_OC_MESSAGES):
    """One OpenCensus agent stream: `n_messages` ExportTraceServiceRequests
    of consecutive slices of `spans`, the node on the first, each span's
    service in its own resource."""
    from tempo_tpu_torch.model import proto_wire as pw

    def ts(ns):
        return pw.enc_field_varint(1, ns // 10**9) + \
            pw.enc_field_varint(2, ns % 10**9)

    def span(s):
        kind = {2: 1, 3: 2}.get(s["kind"], 0)      # OC SERVER, CLIENT
        label = pw.enc_field_str(1, "service.name") + \
            pw.enc_field_str(2, s["service"])
        out = (pw.enc_field_bytes(1, s["trace_id"]) +
               pw.enc_field_bytes(2, s["span_id"]) +
               pw.enc_field_msg(5, pw.enc_field_str(1, s["name"])) +
               pw.enc_field_varint(6, kind) +
               pw.enc_field_msg(7, ts(s["start_unix_nano"])) +
               pw.enc_field_msg(8, ts(s["end_unix_nano"])) +
               pw.enc_field_msg(14, pw.enc_field_msg(2, label)))
        if s["status_code"] == 2:
            out += pw.enc_field_msg(13, pw.enc_field_varint(1, 2))
        return out

    node = pw.enc_field_msg(1, pw.enc_field_msg(
        3, pw.enc_field_str(1, "opencensus")))
    per = -(-len(spans) // n_messages)
    return [(node if k == 0 else b"") + b"".join(
        pw.enc_field_msg(2, span(s)) for s in spans[k * per:(k + 1) * per])
        for k in range(n_messages)]


def _grpc_payloads(t0):
    """The k6-like spans of phase 16a and their bytes on every route: the
    OTLP payloads, and the first payload's spans as a Jaeger proto
    request, Jaeger Thrift batches and an OpenCensus stream."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

    spans = [synthetic_spans(N_SPANS, seed=SEED + 160 + k,
                             now_ns=int(t0 * 1e9))
             for k in range(N_GRPC_PUSHES)]
    return dict(spans=spans, otlp=[encode_spans_otlp(s) for s in spans],
                jaeger=_jaeger_proto_request(spans[0]),
                thrift=_jaeger_thrift_batches(spans[0]),
                oc=_opencensus_messages(spans[0]))


def _post_raw(rig, path, body, ctype, want):
    """One POST of `body` to the App; ms with the reply."""
    import urllib.request

    req = urllib.request.Request(rig.base + path, data=body,
                                 headers={"Content-Type": ctype})
    t = time.perf_counter()
    with _http_errors(f"POST {path}"):
        with urllib.request.urlopen(req, timeout=120) as r:
            if r.status != want:
                raise AssertionError(f"phase 16: POST {path} answered "
                                     f"{r.status}")
            r.read()
    return (time.perf_counter() - t) * 1e3


def _grpc_routes(rig, p):
    """Every route of phase 16a into `rig`'s App, in order: the OTLP
    payloads over gRPC `Export`, the first again over HTTP, the Jaeger
    proto request over gRPC `PostSpans`, the Thrift batches over `POST
    /api/traces`, the OpenCensus stream over its bidirectional `Export`.
    Each route settles before the next. Returns {route: ms} and {route:
    (captured windows before it, after it)} (`rig.mats`)."""
    import grpc

    ms, marks = {}, {}
    mats = rig.mats

    def route(name, fn):
        n0 = len(mats)
        t = time.perf_counter()
        fn()
        ms[name] = (time.perf_counter() - t) * 1e3
        rig.settle()
        marks[name] = (n0, len(mats))

    with grpc.insecure_channel(rig.grpc) as ch:
        export = ch.unary_unary(EXPORT)
        post = ch.unary_unary("/jaeger.api_v2.CollectorService/PostSpans")
        oc = ch.stream_stream(
            "/opencensus.proto.agent.trace.v1.TraceService/Export")

        def otlp_grpc():
            ms["otlp_each"] = []
            for body in p["otlp"]:
                t = time.perf_counter()
                if export(body, timeout=120) != b"":
                    raise AssertionError("phase 16a: Export answered a body")
                ms["otlp_each"].append((time.perf_counter() - t) * 1e3)

        route("otlp_grpc", otlp_grpc)
        route("otlp_http", lambda: _post_raw(
            rig, "/v1/traces", p["otlp"][0], "application/x-protobuf", 200))
        route("jaeger_grpc", lambda: post(p["jaeger"], timeout=120))
        route("jaeger_thrift", lambda: [
            _post_raw(rig, "/api/traces", b, "application/x-thrift", 202)
            for b in p["thrift"]])

        def oc_stream():
            got = list(oc(iter(p["oc"]), timeout=120))
            if len(got) != len(p["oc"]):
                raise AssertionError(f"phase 16a: OpenCensus answered "
                                     f"{len(got)} of {len(p['oc'])} messages")

        route("opencensus_grpc", oc_stream)
    return ms, marks


def _grpc_reads(rig, p, t_base):
    """16b: FindTraceByID, the streaming search, the streaming metrics
    query_range (over `PULL_TENANT`'s backend blocks: the default
    processors keep no local blocks, so the generators answer no recent
    window) and the streaming tags over gRPC, each against the HTTP
    API's answer from the same App."""
    import urllib.parse

    from tempo_tpu_torch.grpcplane.client import (
        GrpcIngesterClient, streaming_metrics_query_range, streaming_search,
        streaming_search_tags)
    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

    ctx = "phase 16b"
    ms = {}

    def span_key(s, hexed):
        sid = s["span_id"] if hexed else s["span_id"].hex()
        return (sid, s["name"], s["service"], int(s["start_unix_nano"]),
                int(s["end_unix_nano"]))

    ing = GrpcIngesterClient(rig.grpc)
    try:
        picks = [s["trace_id"] for s in p["spans"][1][::4096]]
        t = time.perf_counter()
        got = [ing.find_trace_by_id(APP_TENANT, tid) for tid in picks]
        ms["find"] = (time.perf_counter() - t) * 1e3 / len(picks)
    finally:
        ing.close()
    for tid, spans in zip(picks, got):
        _, doc = rig.get(f"/api/traces/{tid.hex()}")
        if not spans or sorted(span_key(s, False) for s in spans) != \
                sorted(span_key(s, True) for s in doc["spans"]):
            raise AssertionError(f"{ctx}: FindTraceByID {tid.hex()} differs "
                                 f"from GET /api/traces")
    q = '{ resource.service.name = "service-3" && span:status = error }'
    t = time.perf_counter()
    msgs = list(streaming_search(rig.grpc, APP_TENANT, q, limit=100))
    ms["search"] = (time.perf_counter() - t) * 1e3
    _, doc = rig.get("/api/search?limit=100&q=" + urllib.parse.quote(q))
    final = msgs[-1]

    def norm(mds):
        # protobuf drops an empty repeated field: a span with no
        # attributes comes back without the key
        for md in mds:
            for ss in md.get("spanSets", []):
                for sp in ss.get("spans", []):
                    sp.setdefault("attributes", [])
        return sorted(mds, key=lambda md: md["traceID"])

    a = norm([md.to_json() for md in final[0]])
    b = norm(doc["traces"])
    if not final[1] or not b or a != b:
        diff = next(((x, y) for x, y in zip(a, b) if x != y), None)
        raise AssertionError(f"{ctx}: the streaming search differs from GET "
                             f"/api/search ({len(a)} / {len(b)} traces; "
                             f"first difference {diff})")
    ms["search_messages"] = len(msgs)
    qr = "{ } | rate() by (resource.service.name)"
    start, end, step = t_base - 60, t_base + 3600, 300.0
    t = time.perf_counter()
    msgs = list(streaming_metrics_query_range(
        rig.grpc, PULL_TENANT, qr, start_s=start, end_s=end, step_s=step))
    ms["query_range"] = (time.perf_counter() - t) * 1e3
    _, doc = rig.get(f"/api/metrics/query_range?q={urllib.parse.quote(qr)}"
                     f"&start={start}&end={end}&step={step}",
                     tenant=PULL_TENANT)
    ts_ms = QueryRangeRequest(qr, int(start * 1e9), int(end * 1e9),
                              int(step * 1e9)).step_timestamps_ms()
    # the wire's QueryRangeResponse carries labels and samples; the HTTP
    # answer adds the exemplars
    mine = [{k: v for k, v in s.items() if k != "exemplars"} for s in
            json.loads(json.dumps([s.to_json(ts_ms) for s in msgs[-1]]))]
    http = [{k: v for k, v in s.items() if k != "exemplars"}
            for s in doc["series"]]
    key = lambda s: json.dumps(s["labels"], sort_keys=True)  # noqa: E731
    if not mine or sorted(mine, key=key) != sorted(http, key=key):
        raise AssertionError(f"{ctx}: the streaming query_range differs from "
                             f"GET /api/metrics/query_range: "
                             f"{sorted(mine, key=key)[:1]} vs "
                             f"{sorted(http, key=key)[:1]}")
    ms["query_range_messages"] = len(msgs)
    t = time.perf_counter()
    msgs = list(streaming_search_tags(rig.grpc, APP_TENANT))
    ms["tags"] = (time.perf_counter() - t) * 1e3
    _, doc = rig.get("/api/v2/search/tags")
    want = {sc["name"]: sorted(sc["tags"]) for sc in doc["scopes"]}
    if not msgs[-1][1] or {k: sorted(v) for k, v in msgs[-1][0].items()} \
            != want:
        raise AssertionError(f"{ctx}: the streaming tags differ from GET "
                             f"/api/v2/search/tags")
    return ms


def _pull_blocks(rig):
    """`N_PULL_BLOCKS` blocks of 64 one-span traces, two hours back, into
    the App's store (RF1, as metrics read); returns their base time."""
    t_base = time.time() - 7200
    for traces in _pull_traces(t_base):
        rig.app.db.write_block(PULL_TENANT, traces, replication_factor=1)
    rig.app.db.poll_now()
    return t_base


def _pull_traces(t_base):
    """`N_PULL_BLOCKS` blocks of 64 one-span traces from `t_base`."""
    rng = np.random.default_rng(SEED + 16)
    blocks = []
    for b in range(N_PULL_BLOCKS):
        traces = []
        for i in range(64):
            tid = rng.bytes(16)
            start = int((t_base + b * 300 + i) * 1e9)
            traces.append((tid, [{
                "trace_id": tid, "span_id": rng.bytes(8), "name": f"op-{b % 3}",
                "service": f"svc-{i % 4}", "kind": 2, "status_code": 0,
                "start_unix_nano": start,
                "end_unix_nano": start + int(rng.integers(1, 50)) * 10**6}]))
        blocks.append(sorted(traces, key=lambda t: t[0]))
    return blocks


def _worker_pull(rig, root, t_base):
    """16c: a query-frontend App and a querier App joined by
    `querier_worker.frontend_address: grpc://…` over the card App's
    store: a backend query_range through the remote worker equals the
    single binary's; one vulture cycle against the card's App."""
    import contextlib
    import io

    from tempo_tpu_torch.app import App
    from tempo_tpu_torch.app.config import Config
    from tempo_tpu_torch.vulture.__main__ import main as vulture_main

    ctx = "phase 16c"
    tenant = PULL_TENANT
    store = rig.app.cfg.storage.local_path
    apps = []
    try:
        fe_cfg = Config(target="query-frontend")
        fe_cfg.storage.local_path = store
        fe_cfg.storage.wal_path = os.path.join(root, "fe-wal")
        fe_cfg.server.grpc_listen_port = _free_port()
        fe = App(fe_cfg, device="cuda")
        apps.append(fe)
        fe.start_loops()
        fe.db.poll_now()
        q_cfg = Config(target="querier")
        q_cfg.storage.local_path = store
        q_cfg.storage.wal_path = os.path.join(root, "q-wal")
        q_cfg.querier_worker.frontend_address = \
            f"grpc://127.0.0.1:{fe.grpc_port}"
        qa = App(q_cfg, device="cuda")
        apps.append(qa)
        qa.start_loops()
        qa.db.poll_now()
        deadline = time.time() + 30
        while fe.frontend.remote_workers < 1 and time.time() < deadline:
            time.sleep(0.05)
        if fe.frontend.remote_workers < 1:
            raise AssertionError(f"{ctx}: no querier worker attached")
        q = "{ } | rate() by (name)"
        args = dict(start_s=t_base - 60, end_s=t_base + 3600, step_s=300.0)
        t = time.perf_counter()
        got = fe.frontend.query_range(tenant, q, **args)
        pull_ms = (time.perf_counter() - t) * 1e3
        jobs = qa.frontend_worker.jobs_executed
        t = time.perf_counter()
        want = rig.app.frontend.query_range(tenant, q, **args)
        single_ms = (time.perf_counter() - t) * 1e3
    finally:
        for a in reversed(apps):
            a.shutdown()
    if not jobs:
        raise AssertionError(f"{ctx}: the remote querier ran no job")
    a = {s.labels: np.asarray(s.samples) for s in got}
    b = {s.labels: np.asarray(s.samples) for s in want}
    if len(a) != 3 or a.keys() != b.keys() or not all(
            np.array_equal(a[k], b[k], equal_nan=True) for k in a):
        raise AssertionError(f"{ctx}: the worker-pull query_range differs "
                             f"from the single binary's")
    # the vulture writes at the wall clock: the App's pinned clock
    # catches up so its search window holds those traces
    rig.clock[0] = time.time()
    report = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(report):
        rc = vulture_main(["--url", rig.base, "--tenant", "vulture",
                           "--cycles", "1", "--interval", "0",
                           "--read-delay", "0", "--seed", str(SEED)])
    vulture_ms = (time.perf_counter() - t) * 1e3
    cycle = json.loads(report.getvalue())
    if rc or not cycle["ok"] or cycle["read_ok"] != cycle["written"]:
        raise AssertionError(f"{ctx}: the vulture cycle failed: {cycle}")
    return dict(jobs=jobs, pull_ms=pull_ms, single_ms=single_ms,
                vulture_ms=vulture_ms, series=len(a),
                vulture_traces=cycle["written"])


def _self_tracing(root):
    """16d: an App with `selftrace.enabled`, on the wall clock (its own
    spans are stamped by it), takes a push and a search; its tracer's
    flush goes through loopback into its own distributor under the
    reserved tenant, whose span metrics run K1; the `tempo_selftrace_*`
    families count the spans."""
    import urllib.parse

    import torch

    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.utils import tracing

    ctx = "phase 16d"
    payload = encode_spans_otlp(synthetic_spans(
        N_SPANS // 8, seed=SEED + 169, now_ns=time.time_ns()))
    _reset_singletons()
    rig = _AppRig("cuda", os.path.join(root, "self"), None,
                  processors=DEFAULT_PROCESSORS, selftrace=True,
                  patch=GRPC_PATCH)
    try:
        tr = tracing.tracer()
        if not isinstance(tr, tracing.SelfTracer) or not tr.loopback:
            raise AssertionError(f"{ctx}: no loopback tracer installed")
        rig.post(payload)
        rig.settle()
        rig.get("/api/search?q=" + urllib.parse.quote("{ }"))
        sc = rig.app.sched
        b0 = sc.batches_total.get(SCHED_KERNEL, 0)
        ck.reset_launch_counts()
        before = tr.stats["spans"]
        exported = tr.flush()
        sc.flush()
        inst = rig.app.generator.instances.get(tr.tenant)
        if inst is None or not exported:
            raise AssertionError(f"{ctx}: {exported} spans exported, tenant "
                                 f"{tr.tenant} not on the generator")
        inst.drain()
        torch.cuda.synchronize()
        launches = ck.paged_fused_update.launches
        dispatches = sc.batches_total.get(SCHED_KERNEL, 0) - b0
        if tr.stats["spans"] != before or not launches or \
                launches != dispatches:
            raise AssertionError(f"{ctx}: {tr.stats['spans'] - before} spans "
                                 f"made while self-ingesting, K1 {launches} "
                                 f"launches for {dispatches} dispatches")
        received = inst.spans_received
        _, text = rig.get("/metrics")
        fams = {ln.split()[0]: float(ln.split()[1])
                for ln in text.splitlines()
                if ln.startswith("tempo_selftrace_")}
        if not fams.get("tempo_selftrace_spans_total") or \
                not fams.get("tempo_selftrace_loopback_batches_total"):
            raise AssertionError(f"{ctx}: tempo_selftrace_* {fams}")
        q = urllib.parse.quote('{ name = "distributor.PushSpans" }')
        found = rig.get(f"/api/search?q={q}", tenant=tr.tenant)[1]["traces"]
        if not found:
            raise AssertionError(f"{ctx}: the reserved tenant's search found "
                                 f"none of the App's own push spans")
        return dict(exported=exported, received=received, launches=launches,
                    families=fams, found=len(found))
    finally:
        rig.shutdown(keep_live=False)
        _reset_singletons()


def phase_grpc(card):
    """Phase 16: the gRPC plane and the rest of the App's surface on the
    card (16a-16d) against a CPU twin. Returns (results, [K1's kernel
    entries for the Export and the push_spans routes])."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase16-",
                                     dir=os.path.join(ROOT, "build")) as root:
        return _phase_grpc(card, root)


def _phase_grpc(card, root):
    import torch

    from tempo_tpu_torch.ops import cuda_kernels as ck

    ctx = "phase 16a"
    t_phase = time.perf_counter()
    t0 = float(int(time.time()))
    p = _grpc_payloads(t0)
    _reset_singletons()
    rig = _AppRig("cuda", os.path.join(root, "card"), t0,
                  processors=DEFAULT_PROCESSORS, grpc=True, patch=GRPC_PATCH)
    try:
        if rig.inst.state_layout != "dense":
            raise AssertionError(f"{ctx}: {rig.inst.state_layout} state")
        proc = rig.inst.processors["span-metrics"]
        rig.mats = _capture_windows(proc)
        sc = rig.app.sched
        counts = {}
        inner_settle = rig.settle

        def settle():
            inner_settle()
            counts.setdefault("launches", []).append(
                ck.paged_fused_update.launches)
            counts.setdefault("dispatches", []).append(
                sc.batches_total.get(SCHED_KERNEL, 0))

        rig.settle = settle
        ck.reset_launch_counts()
        b0 = sc.batches_total.get(SCHED_KERNEL, 0)
        push_ms, marks = _grpc_routes(rig, p)
        launches = [b - a for a, b in zip([0] + counts["launches"][:-1],
                                          counts["launches"])]
        dispatches = [b - a for a, b in zip([b0] + counts["dispatches"][:-1],
                                            counts["dispatches"])]
        for name, n, d in zip(marks, launches, dispatches):
            if n != d or not n:
                raise AssertionError(f"{ctx}: {name}: K1 launched {n} times "
                                     f"for {d} merged dispatches")
        rows = []
        for name, route, label in (
                ("otlp_grpc", "gRPC TraceService/Export → Distributor."
                 "push_otlp", "Export"),
                ("jaeger_grpc", "gRPC CollectorService/PostSpans → "
                 "Distributor.push_spans", "push_spans")):
            a, b = marks[name]
            k1, row = _dist_k1_row(
                f"paged_fused_update (the App's {route} → the generator's "
                f"SpanBatch route, scheduler, dense state, default "
                f"processors, sketch dd, f32)", proc, rig.mats[b - 1],
                launches[list(marks).index(name)], f"{ctx} {label} window")
            rows.append((label, k1, row))
        t_base = _pull_blocks(rig)
        reads = _grpc_reads(rig, p, t_base)
        pull = _worker_pull(rig, root, t_base)
        card_inst = rig.inst
        rig.shutdown(keep_live=False)
        rig.inst = None
    except BaseException:
        rig.shutdown(keep_live=False)
        raise
    del proc
    gc.collect()
    torch.cuda.empty_cache()

    # the CPU twin: the same bytes over the same routes
    _reset_singletons()
    twin = _AppRig("cpu", os.path.join(root, "twin"), t0,
                   processors=DEFAULT_PROCESSORS, grpc=True, patch=GRPC_PATCH)
    try:
        twin.mats = []
        _grpc_routes(twin, p)
        n_fams, n_series, rel = _compare_by_labels(card_inst, twin.inst,
                                                   f"{ctx} card vs CPU twin")
        _same_quantiles(card_inst, twin.inst, f"{ctx} card vs CPU twin")
    finally:
        twin.shutdown(keep_live=False)
        _reset_singletons()
    del card_inst
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    selftrace = _self_tracing(root)
    selftrace["seconds"] = time.perf_counter() - t
    out = dict(push_ms=push_ms, launches=dict(zip(marks, launches)),
               rows=[(label, k1["ms"][1], k1["device_ms"], k1["bound_ms"],
                      k1["bound_by"], k1["bound_bytes"], k1["plain_ms"][1])
                     for label, k1, _ in rows],
               reads=reads, pull=pull, selftrace=selftrace,
               families=n_fams, series=n_series, max_rel=rel,
               payload_bytes={"otlp": len(p["otlp"][0]),
                              "jaeger": len(p["jaeger"]),
                              "thrift": sum(map(len, p["thrift"])),
                              "thrift_posts": len(p["thrift"]),
                              "opencensus": sum(map(len, p["oc"]))})
    out["seconds"] = time.perf_counter() - t_phase
    return out, [row for _, _, row in rows]


def _print_phase16(r, card):
    ms, n = r["push_ms"], r["launches"]
    print(f"phase 16a [{card}]: the App at target all, default processors "
          f"on dense state, {N_GRPC_PUSHES} pushes of {N_SPANS} k6-like spans "
          f"over gRPC Export: "
          f"{', '.join(f'{m:.1f}' for m in ms['otlp_each'])} ms a push "
          f"({r['payload_bytes']['otlp']} bytes); the first again over POST "
          f"/v1/traces {ms['otlp_http']:.1f} ms; its spans over Jaeger "
          f"PostSpans {ms['jaeger_grpc']:.1f} ms "
          f"({r['payload_bytes']['jaeger']} bytes), over POST /api/traces "
          f"(Thrift, {r['payload_bytes']['thrift_posts']} batches, one a "
          f"service) {ms['jaeger_thrift']:.1f} ms, over one OpenCensus "
          f"stream of {N_OC_MESSAGES} messages {ms['opencensus_grpc']:.1f} ms")
    print(f"phase 16a [{card}]: K1 launches = merged dispatches on every "
          f"route: {json.dumps(n)}; {r['families']} families, "
          f"{r['series']} series equal to the CPU twin's (counts and buckets "
          f"exact, DDSketch quantiles equal, sums within rtol 1e-5, largest "
          f"{r['max_rel']:.2e})")
    for label, k1_ms, dev, bms, by, nbytes, plain in r["rows"]:
        print(f"phase 16a [{card}]: K1 on the {label} route's last window: "
              f"{k1_ms:.4f} ms with the host (CUDA events), device {dev} ms, "
              f"plain {plain:.4f} ms, bound {bms:.6f} ms by {by} ({nbytes} "
              f"bytes)")
    b = r["reads"]
    print(f"phase 16b [{card}]: over gRPC, each equal to the HTTP API's "
          f"answer: FindTraceByID {b['find']:.2f} ms a trace, streaming "
          f"search {b['search']:.2f} ms ({b['search_messages']} messages), "
          f"streaming query_range {b['query_range']:.2f} ms "
          f"({b['query_range_messages']} messages), streaming tags "
          f"{b['tags']:.2f} ms")
    c = r["pull"]
    print(f"phase 16c [{card}]: a query-frontend App and a querier App "
          f"over querier_worker.frontend_address (gRPC): query_range of "
          f"{N_PULL_BLOCKS} backend blocks {c['pull_ms']:.1f} ms through the "
          f"remote worker ({c['jobs']} jobs), equal to the single binary's "
          f"({c['single_ms']:.1f} ms, {c['series']} series); one vulture "
          f"cycle {c['vulture_ms']:.1f} ms ({c['vulture_traces']} traces "
          f"written, read back and found)")
    d = r["selftrace"]
    print(f"phase 16d [{card}]: selftrace.enabled: {d['exported']} own spans "
          f"through loopback into the reserved tenant ({d['received']} "
          f"received, {d['found']} traces found by its search), K1 "
          f"{d['launches']} launches for them; {json.dumps(d['families'])}; "
          f"{d['seconds']:.1f} s")
    print(f"phase 16 [{card}]: {r['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: Kafka ingest and the Jaeger agent receiver
# ---------------------------------------------------------------------------

N_KAFKA_PUSHES = 3
N_AGENT_DATAGRAMS = 64
AGENT_SPANS = 64                   # spans a datagram (one service each)
AGENT_GROUP = 8                    # datagrams sent before waiting on them
KAFKA_TENANT = "kafka-0"
ALL_RECORDS = 1 << 20              # a consumer's fetch: a partition's tail
N_STORAGE_PUSHES = 2               # 17b: one before the join, one after
KAFKA_PATCH = {"generator": {"processors": list(DEFAULT_PROCESSORS),
                             # the group's heartbeats move the clock
                             "ingestion_time_range_slack_s": 600.0},
               "ingestion": dict(UNLIMITED)}


def _mock_kafka():
    """The repository's mock broker (`tests/mock_kafka.py`, standard
    library only), loaded by its path: it checks every batch's CRC32C
    with its own table."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_mock_kafka", os.path.join(ROOT, "tests", "mock_kafka.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _c_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        x = v & 0x7F
        v >>= 7
        if v:
            out.append(x | 0x80)
        else:
            out.append(x)
            return bytes(out)


def _c_zig(v: int) -> bytes:
    return _c_varint((v << 1) ^ (v >> 63))


def _c_field(last: int, fid: int, ctype: int) -> bytes:
    return bytes([((fid - last) << 4) | ctype])


def _c_str(s: str) -> bytes:
    b = s.encode()
    return _c_varint(len(b)) + b


def _c_list(structs: list) -> bytes:
    n = len(structs)
    hdr = bytes([(n << 4) | 12]) if n < 15 else \
        bytes([0xF0 | 12]) + _c_varint(n)
    return hdr + b"".join(structs)


def _c_tag(key: str, v) -> bytes:
    out = _c_field(0, 1, 8) + _c_str(key)
    if isinstance(v, int):
        return out + _c_field(1, 2, 5) + _c_zig(3) + \
            _c_field(2, 6, 6) + _c_zig(v) + b"\x00"     # LONG
    return out + _c_field(1, 2, 5) + _c_zig(0) + \
        _c_field(2, 3, 8) + _c_str(v) + b"\x00"         # STRING


def _agent_datagram(service: str, spans: list) -> bytes:
    """One `Agent.emitBatch` call in the Thrift compact protocol: a
    Batch of one Process (`service`) and its spans."""
    structs = []
    for sp in spans:
        b = (_c_field(0, 1, 6) + _c_zig(sp["tid_lo"]) +
             _c_field(1, 2, 6) + _c_zig(sp["tid_hi"]) +
             _c_field(2, 3, 6) + _c_zig(sp["sid"]) +
             _c_field(3, 4, 6) + _c_zig(sp["psid"]) +
             _c_field(4, 5, 8) + _c_str(sp["name"]) +
             _c_field(5, 8, 6) + _c_zig(sp["start_us"]) +
             _c_field(8, 9, 6) + _c_zig(sp["dur_us"]) +
             _c_field(9, 10, 9) + _c_list([_c_tag(k, v) for k, v in
                                           sp["tags"].items()]))
        structs.append(b + b"\x00")
    process = (_c_field(0, 1, 8) + _c_str(service) +
               _c_field(1, 2, 9) + _c_list([_c_tag("hostname", "agent-h")]) +
               b"\x00")
    batch = (_c_field(0, 1, 12) + process +
             _c_field(1, 2, 9) + _c_list(structs) + b"\x00")
    return (b"\x82" + bytes([(4 << 5) | 1]) + _c_varint(7) +
            _c_str("emitBatch") + _c_field(0, 1, 12) + batch + b"\x00")


def _agent_datagrams(t0) -> list:
    """`N_AGENT_DATAGRAMS` seeded datagrams of `AGENT_SPANS` spans each,
    one service a datagram, ending within 10 s before t0."""
    rng = np.random.default_rng(SEED + 170)
    kinds = ("server", "client", "internal")
    out = []
    for i in range(N_AGENT_DATAGRAMS):
        spans = []
        for j in range(AGENT_SPANS):
            dur = max(int(rng.lognormal(10.0, 1.0)), 1)
            end = int(t0 * 1e6) - int(rng.random() * 10e6)
            spans.append(dict(
                tid_lo=int(rng.integers(1, 1 << 62)),
                tid_hi=int(rng.integers(0, 1 << 62)),
                sid=int(rng.integers(1, 1 << 62)), psid=0,
                name=f"agent-op-{int(rng.integers(0, 32))}",
                start_us=end - dur, dur_us=dur,
                tags={"span.kind": kinds[j % 3],
                      "http.status_code": int(rng.choice([200, 404, 500]))}))
        out.append(_agent_datagram(f"agent-svc-{i % 16}", spans))
    return out


def _kafka_payloads(t0):
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

    return [encode_spans_otlp(synthetic_spans(
        N_SPANS, seed=SEED + 175 + k, now_ns=int(t0 * 1e9)))
        for k in range(N_KAFKA_PUSHES)]


def _receiver_routes(rig, payloads, grams, port):
    """17a and 17c into `rig`'s App: the OTLP payloads produced to a topic
    of the mock broker at `port` and consumed by a `KafkaReceiver` into
    the App's distributor, record by record, then the agent's datagrams
    over loopback UDP (`AGENT_GROUP` at a time, each group received
    before the next leaves: the receiver pushes each datagram while the
    socket buffers the rest). Each route settles. Returns ({route: ms},
    {route: (windows before, after)}, the receiver)."""
    import socket

    from tempo_tpu_torch.distributor.receiver_kafka import (
        KafkaReceiver, KafkaReceiverConfig)
    from tempo_tpu_torch.ingest.kafka import KafkaBus

    ms, marks = {}, {}
    topic = KafkaBus(f"127.0.0.1:{port}", topic="otlp",
                     n_partitions=1, timeout_s=30.0)
    try:
        n0 = len(rig.mats)
        t = time.perf_counter()
        for body in payloads:
            topic.produce(0, APP_TENANT, body)
        ms["kafka_produce"] = (time.perf_counter() - t) * 1e3
        rx = KafkaReceiver(topic, rig.app.distributor, KafkaReceiverConfig(
            partitions=(0,)))
        t = time.perf_counter()
        while rx.run_once():
            pass
        ms["kafka_receiver"] = (time.perf_counter() - t) * 1e3
        rig.settle()
        marks["kafka_receiver"] = (n0, len(rig.mats))
        if (rx.records_consumed, rx.errors) != (len(payloads), 0) or \
                topic.committed(rx.cfg.group, 0) != len(payloads):
            raise AssertionError(
                f"phase 17a: the receiver consumed {rx.records_consumed} "
                f"records ({rx.errors} errors), committed "
                f"{topic.committed(rx.cfg.group, 0)} of {len(payloads)}")
    finally:
        topic.close()
    agent = rig.app.jaeger_agent
    n0 = len(rig.mats)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t = time.perf_counter()
    try:
        for lo in range(0, len(grams), AGENT_GROUP):
            for g in grams[lo:lo + AGENT_GROUP]:
                s.sendto(g, ("127.0.0.1", agent.port))
            want = min(lo + AGENT_GROUP, len(grams))
            deadline = time.time() + 60
            while agent.batches_received + agent.errors < want:
                if time.time() > deadline:
                    raise AssertionError(
                        f"phase 17c: the agent received "
                        f"{agent.batches_received} of {want} datagrams")
                time.sleep(0.002)
    finally:
        s.close()
    ms["agent"] = (time.perf_counter() - t) * 1e3
    rig.settle()
    marks["agent"] = (n0, len(rig.mats))
    if agent.errors or agent.spans_received != len(grams) * AGENT_SPANS:
        raise AssertionError(f"phase 17c: {agent.spans_received} agent spans, "
                             f"{agent.errors} errors")
    return ms, marks, rx


class _KafkaStorage:
    """17b on `device`: the ingest-storage path over a 4-partition
    `KafkaBus` of the mock broker: a `Distributor` producing to it, a
    `Generator` (span metrics and service graphs on dense state) and a
    `BlockBuilder` (a `LocalBackend` store) consuming in group mode, and a
    second generator that joins the group later; on a clock that moves
    16 s a round, past the group's heartbeat gate."""

    def __init__(self, device, root, broker, t0):
        from tempo_tpu_torch.backend import LocalBackend
        from tempo_tpu_torch.blockbuilder import (BlockBuilder,
                                                  BlockBuilderConfig)
        from tempo_tpu_torch.distributor import Distributor
        from tempo_tpu_torch.generator import Generator
        from tempo_tpu_torch.ingest.kafka import KafkaBus
        from tempo_tpu_torch.overrides import Overrides
        from tempo_tpu_torch.ring import Ring

        self.clock = [t0]
        now = self.now = lambda: self.clock[0]
        self.device = device
        self.ov = Overrides()
        self.ov.set_tenant_patch(KAFKA_TENANT, KAFKA_PATCH)
        srv, port, self.broker = broker
        self.bus = KafkaBus(f"127.0.0.1:{port}", topic="tempo-ingest",
                            n_partitions=N_BUS_PARTITIONS, timeout_s=30.0)
        self.dist = Distributor(Ring(replication_factor=1, now=now), {},
                                overrides=self.ov, bus=self.bus, now=now)
        self.gens = [Generator(overrides=self.ov, now=now, device=device,
                               instance_id="generator-0")]
        self.store = LocalBackend(os.path.join(root, "store"))
        # each consumer reads a partition's whole tail a call: the mock
        # broker encodes and CRCs that tail in Python on every fetch
        self.bb = BlockBuilder(self.bus, self.store, BlockBuilderConfig(
            partitions=None, consume_cycle_records=ALL_RECORDS), now=now,
            device=device)

    def join(self):
        from tempo_tpu_torch.generator import Generator

        self.gens.append(Generator(overrides=self.ov, now=self.now,
                                   device=self.device,
                                   instance_id="generator-1"))

    def round(self):
        """One consume round of every member; returns records consumed."""
        n = sum(g.consume_bus(self.bus, max_records=ALL_RECORDS)
                for g in self.gens)
        n += self.bb.consume_cycle()
        _settle({g.id: g for g in self.gens})
        self.clock[0] += 16.0
        return n

    def lag(self):
        """Each group's lag a partition, the high watermarks read off the
        mock broker's logs (the client's `high_watermark` is a fetch the
        mock encodes and CRCs in Python)."""
        logs = self.broker.cluster.logs
        return [len(logs.get((self.bus.topic, p), ())) -
                self.bus.committed(grp, p)
                for grp in ("metrics-generator", "blockbuilder")
                for p in range(N_BUS_PARTITIONS)]

    def close(self):
        self.bus.close()


def _kafka_storage(rig, payloads, ctx):
    """17b's drive: payload 0 produced and consumed by the first
    generator and the block-builder alone; the second generator joins
    and rounds run until the group has rebalanced (both members own
    partitions); the other payloads are produced and rounds run until
    every partition is drained. Returns (ms of the first produce,
    rounds, the members' assignments)."""
    def push(body):
        if rig.dist.push_otlp(KAFKA_TENANT, body):
            raise AssertionError(f"{ctx}: push refused")

    t = time.perf_counter()
    push(payloads[0])
    produce_ms = (time.perf_counter() - t) * 1e3
    rounds = 0
    while rig.round():
        rounds += 1
    rig.join()

    def parts():
        return [g._cgroups["metrics-generator"].assignment
                for g in rig.gens if "metrics-generator" in g._cgroups]

    for _ in range(8):
        rounds += 1
        rig.round()
        if len(parts()) == 2 and all(parts()):
            break
    else:
        raise AssertionError(f"{ctx}: no rebalance: {parts()}")
    for body in payloads[1:]:
        push(body)
    while rig.round():
        rounds += 1
    got = parts()
    if any(rig.lag()) or sorted(got[0] + got[1]) != \
            list(range(N_BUS_PARTITIONS)):
        raise AssertionError(f"{ctx}: lag {rig.lag()}, assignments {got}")
    return produce_ms, rounds, got


def _app_new_configs(root, t0, body, port):
    """17d: `App(Config())` at target `all` on the card with the three
    configurations this slice brought, together: `ingest.kafka_bootstrap`
    (the mock broker at `port`; the App's consume loop runs the
    block-builder and the generator in consumer-group mode),
    `distributor.jaeger_agent_port` and `mesh.enabled` (a mesh over the
    visible cards). One payload pushed through the distributor lands in
    the generator through Kafka and K1. Returns its readings."""
    import torch

    from tempo_tpu_torch.app import App
    from tempo_tpu_torch.app.config import Config
    from tempo_tpu_torch.ingest.kafka import KafkaBus
    from tempo_tpu_torch.ops import cuda_kernels as ck

    cfg = Config()
    cfg.storage.local_path = os.path.join(root, "blocks")
    cfg.storage.wal_path = os.path.join(root, "data", "wal")
    cfg.generator.localblocks.data_dir = os.path.join(root, "lb")
    cfg.server.http_listen_port = _free_port()
    cfg.ingester.flush_check_period_s = 3600.0
    cfg.ingest.enabled = True
    cfg.ingest.kafka_bootstrap = f"127.0.0.1:{port}"
    cfg.ingest.n_partitions = N_BUS_PARTITIONS
    cfg.ingest.consume_interval_s = 0.2
    cfg.distributor.jaeger_agent_port = _free_port()
    cfg.mesh.enabled = True
    _reset_singletons()
    app = App(cfg, now=lambda: t0, device="cuda")
    try:
        sm = app.mesh
        if not isinstance(app.bus, KafkaBus) or sm is None or \
                app.jaeger_agent is not None or \
                app.db.planes.mesh is not sm.plane_mesh:
            raise AssertionError("phase 17d: the App did not build its "
                                 "Kafka bus, mesh or plane mesh")
        app.overrides.set_tenant_patch(APP_TENANT, {
            "generator": {"processors": ["span-metrics"]},
            "ingestion": dict(UNLIMITED)})
        ck.reset_launch_counts()
        app.start_loops()
        if app.jaeger_agent is None or \
                app.jaeger_agent.cfg.host != "127.0.0.1":
            raise AssertionError("phase 17d: no agent on loopback")
        t = time.perf_counter()
        if app.distributor.push_otlp(APP_TENANT, body):
            raise AssertionError("phase 17d: push refused")
        deadline = time.time() + 120
        while True:
            inst = app.generator.instances.get(APP_TENANT)
            if inst is not None and inst.spans_received >= N_SPANS:
                break
            if time.time() > deadline:
                raise AssertionError("phase 17d: the generator took "
                                     f"{inst and inst.spans_received} of "
                                     f"{N_SPANS} spans off the bus")
            time.sleep(0.05)
        ms = (time.perf_counter() - t) * 1e3
        app.sched.flush()
        inst.drain()
        torch.cuda.synchronize()
        proc = inst.processors["span-metrics"]
        launches = ck.paged_fused_update.launches
        if proc._mesh is not sm or not launches or \
                app.bus_consume_errors:
            raise AssertionError(f"phase 17d: mesh {proc._mesh}, K1 "
                                 f"{launches} launches, "
                                 f"{app.bus_consume_errors} consume errors")
        return dict(ms=ms, launches=launches,
                    mesh=(sm.n_devices, sm.data_shards, sm.series_shards),
                    spans=inst.spans_received)
    finally:
        app.ingester.flush_all = lambda: None
        app.shutdown()
        for th in app.ingester._threads:
            th.join()
        _reset_singletons()


def _spanmetrics_rows(insts):
    return {k: v for k, v in _family_rows(insts).items()
            if k.startswith("traces_spanmetrics")}


def _bus_twin(t0, payloads):
    """17b's CPU twin: the same pushes through a `Distributor` onto an
    in-memory `Bus` of the same partitions, drained by one generator
    (the group's members' state, summed, must equal its own)."""
    from tempo_tpu_torch.distributor import Distributor
    from tempo_tpu_torch.generator import Generator
    from tempo_tpu_torch.ingest import Bus
    from tempo_tpu_torch.overrides import Overrides
    from tempo_tpu_torch.ring import Ring

    now = lambda: t0  # noqa: E731
    ov = Overrides()
    ov.set_tenant_patch(KAFKA_TENANT, KAFKA_PATCH)
    bus = Bus(N_BUS_PARTITIONS)
    dist = Distributor(Ring(replication_factor=1, now=now), {},
                       overrides=ov, bus=bus, now=now)
    gen = Generator(overrides=ov, now=now, device="cpu")
    for body in payloads:
        if dist.push_otlp(KAFKA_TENANT, body):
            raise AssertionError("phase 17b twin: push refused")
    while gen.consume_bus(bus, max_records=ALL_RECORDS):
        pass
    _settle({"g": gen})
    return gen.instance(KAFKA_TENANT)


def phase_kafka(card):
    """Phase 17: Kafka ingest and the Jaeger agent on the card (17a-17c)
    against CPU twins. Returns (results, [K1's kernel entries for the
    Kafka receiver, the group-mode consume_bus and the agent routes])."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase17-",
                                     dir=os.path.join(ROOT, "build")) as root:
        return _phase_kafka(card, root)


def _phase_kafka(card, root):
    import torch

    from tempo_tpu_torch import sched
    from tempo_tpu_torch.backend.meta import read_block_meta
    from tempo_tpu_torch.backend.raw import blocks as list_blocks
    from tempo_tpu_torch.ops import cuda_kernels as ck

    ctx = "phase 17"
    t_phase = time.perf_counter()
    t0 = float(int(time.time()))
    payloads = _kafka_payloads(t0)
    grams = _agent_datagrams(t0)
    mk = _mock_kafka()
    # one broker for each side and stage: the card's and the twin's
    # consumer groups and offsets must not meet
    brokers = [mk.start_mock_kafka(n_partitions=N_BUS_PARTITIONS)
               for _ in range(4)]
    try:
        # 17a + 17c: the receivers into the App at target all
        _reset_singletons()
        rig = _AppRig("cuda", os.path.join(root, "card"), t0,
                      processors=DEFAULT_PROCESSORS, agent=True,
                      patch={"ingestion": dict(UNLIMITED)})
        try:
            if rig.inst.state_layout != "dense":
                raise AssertionError(f"{ctx}: {rig.inst.state_layout} state")
            proc = rig.inst.processors["span-metrics"]
            rig.mats = _capture_windows(proc)
            sc = rig.app.sched
            counts = {}
            inner_settle = rig.settle

            def settle():
                inner_settle()
                counts.setdefault("launches", []).append(
                    ck.paged_fused_update.launches)
                counts.setdefault("dispatches", []).append(
                    sc.batches_total.get(SCHED_KERNEL, 0))

            rig.settle = settle
            ck.reset_launch_counts()
            b0 = sc.batches_total.get(SCHED_KERNEL, 0)
            ms, marks, _ = _receiver_routes(rig, payloads, grams,
                                            brokers[0][1])
            launches = [b - a for a, b in zip(
                [0] + counts["launches"][:-1], counts["launches"])]
            dispatches = [b - a for a, b in zip(
                [b0] + counts["dispatches"][:-1], counts["dispatches"])]
            for name, n, d in zip(marks, launches, dispatches):
                if n != d or not n:
                    raise AssertionError(f"{ctx}: {name}: K1 launched {n} "
                                         f"times for {d} merged dispatches")
            rows = []
            for (name, (a, b)), n, route in zip(
                    marks.items(), launches,
                    ("Kafka topic → KafkaReceiver → Distributor.push_otlp",
                     "UDP Agent.emitBatch → JaegerAgentReceiver → "
                     "Distributor.push_spans")):
                k1, row = _dist_k1_row(
                    f"paged_fused_update ({route} → the generator's "
                    f"SpanBatch route, scheduler, dense state, default "
                    f"processors, sketch dd, f32)", proc, rig.mats[b - 1], n,
                    f"{ctx} {name} window")
                rows.append((name, k1, row))
            card_inst = rig.inst
            rig.shutdown(keep_live=False)
            rig.inst = None
        except BaseException:
            rig.shutdown(keep_live=False)
            raise
        del proc
        gc.collect()
        torch.cuda.empty_cache()
        _reset_singletons()
        twin = _AppRig("cpu", os.path.join(root, "twin"), t0,
                       processors=DEFAULT_PROCESSORS, agent=True,
                       patch={"ingestion": dict(UNLIMITED)})
        try:
            twin.mats = []
            _receiver_routes(twin, payloads, grams, brokers[1][1])
            n_fams, n_series, rel = _compare_by_labels(
                card_inst, twin.inst, f"{ctx}a/c card vs CPU twin")
            _same_quantiles(card_inst, twin.inst,
                            f"{ctx}a/c card vs CPU twin")
        finally:
            twin.shutdown(keep_live=False)
            _reset_singletons()
        del card_inst
        gc.collect()
        torch.cuda.empty_cache()

        # 17b: the ingest-storage path over Kafka, group mode
        t17b = time.perf_counter()
        sc = sched.configure(sched.SchedConfig())
        ks = _KafkaStorage("cuda", os.path.join(root, "17b-card"),
                           brokers[2], t0)
        try:
            caps = []
            b0 = sc.batches_total.get(SCHED_KERNEL, 0)
            ck.reset_launch_counts()
            inst0 = ks.gens[0].instance(KAFKA_TENANT)
            caps.append(_capture_windows(inst0.processors["span-metrics"]))
            inner_join = ks.join

            def join():
                inner_join()
                caps.append(_capture_windows(ks.gens[1].instance(
                    KAFKA_TENANT).processors["span-metrics"]))

            ks.join = join
            produce_ms, rounds, parts = _kafka_storage(
                ks, payloads[:N_STORAGE_PUSHES], f"{ctx}b")
            _settle({g.id: g for g in ks.gens})
            launches_b = ck.paged_fused_update.launches
            dispatches_b = sc.batches_total.get(SCHED_KERNEL, 0) - b0
            if launches_b != dispatches_b or not launches_b:
                raise AssertionError(f"{ctx}b: K1 launched {launches_b} "
                                     f"times for {dispatches_b} dispatches")
            insts = [g.instance(KAFKA_TENANT) for g in ks.gens]
            spans = sum(i.spans_received for i in insts)
            if spans != N_STORAGE_PUSHES * N_SPANS or not all(
                    i.spans_received for i in insts):
                raise AssertionError(f"{ctx}b: {[i.spans_received for i in insts]}"
                                     f" spans over the members")
            objs = sum(read_block_meta(ks.store, b, KAFKA_TENANT).total_objects
                       for b in list_blocks(ks.store, KAFKA_TENANT))
            n_traces = len(_host_traces(payloads[:N_STORAGE_PUSHES]))
            if objs != n_traces:
                raise AssertionError(f"{ctx}b: the block-builder wrote "
                                     f"{objs} of {n_traces} traces")
            # span metrics only: the service graphs' unpaired edges
            # expire on the members' clock, which the rounds move
            card_rows = _spanmetrics_rows(insts)
            mat = next(m[-1] for m in reversed(caps) if m)
            proc1 = insts[-1].processors["span-metrics"]
            k1b, rowb = _dist_k1_row(
                "paged_fused_update (Distributor → KafkaBus (4 partitions) "
                "→ Generator.consume_bus in consumer-group mode → "
                "push_spans, scheduler, dense state, default processors, "
                "sketch dd, f32)", proc1, mat, launches_b,
                f"{ctx}b window")
        finally:
            ks.close()
        del ks, insts, proc1
        gc.collect()
        torch.cuda.empty_cache()
        _reset_singletons()
        sched.configure(sched.SchedConfig())
        try:
            n_b, rel_b = _compare_rows(
                card_rows, _spanmetrics_rows([_bus_twin(
                    t0, payloads[:N_STORAGE_PUSHES])]),
                f"{ctx}b card vs CPU twin")
        finally:
            _reset_singletons()
        t17b = time.perf_counter() - t17b
        gc.collect()
        torch.cuda.empty_cache()
        t17d = time.perf_counter()
        new_cfgs = _app_new_configs(os.path.join(root, "17d"), t0,
                                    payloads[-1], brokers[3][1])
        new_cfgs["seconds"] = time.perf_counter() - t17d
    finally:
        for srv, _, _ in brokers:
            srv.shutdown()
            srv.server_close()
    out = dict(ms=ms, launches=dict(zip(marks, launches)),
               rows=[(name, k1["ms"][1], k1["device_ms"], k1["bound_ms"],
                      k1["bound_by"], k1["bound_bytes"], k1["plain_ms"][1])
                     for name, k1, _ in rows + [("consume_bus", k1b, None)]],
               families=n_fams, series=n_series, max_rel=rel,
               storage=dict(produce_ms=produce_ms, rounds=rounds,
                            assignments=parts, launches=launches_b,
                            series=n_b, max_rel=rel_b, traces=n_traces,
                            seconds=t17b),
               app=new_cfgs,
               batches=sum(b.produce_batches for _, _, b in brokers),
               payload_bytes=sum(map(len, payloads)),
               datagram_bytes=sum(map(len, grams)))
    out["seconds"] = time.perf_counter() - t_phase
    return out, [row for _, _, row in rows] + [rowb]


def _print_phase17(r, card):
    ms, n = r["ms"], r["launches"]
    print(f"phase 17a [{card}]: {N_KAFKA_PUSHES} OTLP payloads of {N_SPANS} "
          f"k6-like spans ({r['payload_bytes']} bytes) produced to a topic "
          f"of the mock broker in {ms['kafka_produce']:.1f} ms, consumed by "
          f"the KafkaReceiver into the App (target all, default processors, "
          f"dense state) in {ms['kafka_receiver']:.1f} ms")
    print(f"phase 17c [{card}]: {N_AGENT_DATAGRAMS} Jaeger agent datagrams "
          f"of {AGENT_SPANS} spans ({r['datagram_bytes']} bytes) over "
          f"loopback UDP in {ms['agent']:.1f} ms")
    print(f"phase 17a/c [{card}]: K1 launches = merged dispatches on each "
          f"route: {json.dumps(n)}; {r['families']} families, "
          f"{r['series']} series equal to the CPU twin's (counts and buckets "
          f"exact, DDSketch quantiles equal, sums within rtol 1e-5, largest "
          f"{r['max_rel']:.2e})")
    b = r["storage"]
    print(f"phase 17b [{card}]: Distributor → KafkaBus ({N_BUS_PARTITIONS} "
          f"partitions): the first push produced in {b['produce_ms']:.1f} ms; "
          f"a second generator joined the group and {b['rounds']} consume "
          f"rounds rebalanced it to {json.dumps(b['assignments'])} with "
          f"every record consumed once: {b['traces']} traces in the "
          f"block-builder's blocks, K1 {b['launches']} launches = merged "
          f"dispatches, the two members' span-metrics series "
          f"({b['series']}) summed equal the CPU twin's (largest sum error "
          f"{b['max_rel']:.2e}); "
          f"{b['seconds']:.1f} s")
    for name, k1_ms, dev, bms, by, nbytes, plain in r["rows"]:
        print(f"phase 17 [{card}]: K1 on the {name} route's last window: "
              f"{k1_ms:.4f} ms with the host (CUDA events), device {dev} ms, "
              f"plain {plain:.4f} ms, bound {bms:.6f} ms by {by} ({nbytes} "
              f"bytes)")
    d = r["app"]
    print(f"phase 17d [{card}]: App(Config()) at target all with "
          f"ingest.kafka_bootstrap, distributor.jaeger_agent_port and "
          f"mesh.enabled (devices, data, series = {d['mesh']}): a push of "
          f"{d['spans']} spans reached the generator through Kafka in "
          f"{d['ms']:.1f} ms, K1 {d['launches']} launches on the mesh; "
          f"{d['seconds']:.1f} s")
    print(f"phase 17 [{card}]: {r['batches']} record batches CRC-checked by "
          f"the broker; {r['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 18: the serving mesh at the reference's default widths
# ---------------------------------------------------------------------------

N_MESH_PUSHES = 3
MESH_SHARDS = 4
MESH_TENANT = "mesh-0"
MESH_SM = dict(sketch="both", moments_k=MOM_K)   # every other width default
MESH_RATE = LB_RATE
MESH_QUANT = "{ } | quantile_over_time(duration, .5, .99) by (resource.service.name)"
MESH_WINDOW_S = 600.0


def _mesh_devices() -> list:
    """The mesh's logical shards: the card, `MESH_SHARDS` times."""
    from tempo_tpu_torch.parallel.mesh import device_of

    return [device_of("cuda")] * MESH_SHARDS


def _mesh_payloads(t0):
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

    spans = [synthetic_spans(N_SPANS, seed=SEED + 180 + k,
                             now_ns=int(t0 * 1e9))
             for k in range(N_MESH_PUSHES)]
    return spans, [encode_spans_otlp(s) for s in spans]


def _mesh_rows(proc):
    """{labels: moments row} of the dense moments plane's active slots."""
    with proc.registry.state_lock:
        slots = proc._sketch_slots()
        rows = proc.mom.data[torch_index(slots, proc.mom.data)].cpu().numpy()
    return {proc.calls.labels_of(int(s)): rows[i]
            for i, s in enumerate(slots)}


def torch_index(slots, like):
    import torch

    return torch.from_numpy(np.asarray(slots, np.int64)).to(like.device)


def _mesh_layout(device, t0, payloads, sm, paged=False):
    """One tenant (span metrics, `sketch: both`, the default widths) on
    `device` under the default scheduler, on the serving mesh `sm` (None:
    unsharded), dense or on a page pool made under the mesh; every
    payload pushed through the staged fast route. Returns (instance,
    processor, K1 launches, merged dispatches, the captured windows,
    push seconds)."""
    import torch

    import tempo_tpu_torch as tt
    from tempo_tpu_torch import sched
    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.parallel import serving
    from tempo_tpu_torch.registry import pages

    _reset_singletons()
    sc = sched.configure(sched.SchedConfig())
    with serving.use(sm):
        pool = pages.PagePool(tt.PagePoolConfig(enabled=True),
                              device=device) if paged else None
        with pages.use(pool):
            inst = tt.GeneratorInstance(
                MESH_TENANT, tt.GeneratorConfig(
                    processors=("span-metrics",),
                    spanmetrics=tt.SpanMetricsConfig(**MESH_SM)),
                now=lambda: t0, device=device)
        proc = inst.processors["span-metrics"]
        if paged != proc._paged or (paged and pool.mesh is not sm):
            raise AssertionError(f"phase 18: {inst.state_layout} state, "
                                 f"pool mesh {pool and pool.mesh}")
        mats = _capture_windows(proc)
        ck.reset_launch_counts()
        b0 = sc.batches_total.get(SCHED_KERNEL, 0)
        t = time.perf_counter()
        for body in payloads:
            if inst.push_otlp_staged(body) != N_SPANS:
                raise AssertionError("phase 18: the staged route refused "
                                     "a payload")
        inst.drain()
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        if sm is not None and not paged and proc._mesh is not sm:
            raise AssertionError("phase 18: the tenant is not on the mesh")
    launches = ck.paged_fused_update.launches
    dispatches = sc.batches_total.get(SCHED_KERNEL, 0) - b0
    sched.reset()
    return inst, proc, launches, dispatches, mats, secs


def _mesh_k1_row(name, proc, mat, launches, ctx, data_shards):
    """K1 on the last window as one shard's launch makes it: series shard
    0's windows and localized tables; on the data axis, a zeroed delta
    window and the first data shard's chunk of the window."""
    import torch

    with proc.registry.state_lock:
        if proc._paged:
            planes = proc._paged_planes()
            plan = proc._pool_shards(tuple(p.data for p in planes),
                                     proc._stacked_tables(planes))
        else:
            plan = proc._mesh_plan
    arenas = plan.arenas[0]
    if data_shards > 1:
        mat = np.ascontiguousarray(mat[:, :mat.shape[1] // data_shards])
        arenas = tuple(torch.zeros_like(a) for a in arenas)
    k1 = _k1_on_window(proc, mat, ctx,
                       operands=(arenas, plan.tables[0], plan.page_rows))
    return k1, {
        "name": name, "route": "cuda",
        "source": "tempo_tpu_torch/csrc/paged_fused_update.cu",
        "replaces": "tempo_tpu/ops/pallas_kernels.py:196",
        "launches": launches, "max_abs_err": k1["max_abs"],
        "ms": k1["ms"][1], "plain_ms": k1["plain_ms"][1],
        "device_ms": k1["device_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
    }


def _mesh_queries(root, spans, t0, sm_read):
    """18d: the payloads' traces written as one backend block a payload,
    then a rate and a quantile_over_time `query_range` by service through
    `TempoDB(plane_mesh=...)` with the in-mesh combine (`sm_read` active,
    every fold on the device), against the same queries with the mesh
    off. Returns {query: (ms mesh, ms off, series, combines)}."""
    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.block.schema import spans_by_trace
    from tempo_tpu_torch.db import TempoDB
    from tempo_tpu_torch.db.tempodb import TempoDBConfig
    from tempo_tpu_torch.parallel import serving
    from tempo_tpu_torch.traceql.engine_metrics import (QueryRangeRequest,
                                                        metrics_kind)

    be = LocalBackend(os.path.join(root, "mesh-store"))
    db_off = TempoDB(be, be, device="cuda")
    for s in spans:
        db_off.write_block(MESH_TENANT, spans_by_trace(s),
                           replication_factor=1)
    db_mesh = TempoDB(be, be, TempoDBConfig(plane_mesh=sm_read.plane_mesh),
                      device="cuda")
    combines = [0]
    inner = sm_read.combine

    def counted(stacked, op):
        combines[0] += 1
        return inner(stacked, op)

    sm_read.combine = counted
    out = {}
    try:
        for db in (db_off, db_mesh):
            db.poll_now()
        for q in (MESH_RATE, MESH_QUANT):
            req = QueryRangeRequest(query=q,
                                    start_ns=int((t0 - MESH_WINDOW_S) * 1e9),
                                    end_ns=int((t0 + 60) * 1e9),
                                    step_ns=int(60e9))
            got = {}
            for name, db, sm in (("off", db_off, None),
                                 ("mesh", db_mesh, sm_read)):
                with serving.use(sm):
                    db.query_range(MESH_TENANT, req)     # adopt the columns
                    c0 = combines[0]
                    t = time.perf_counter()
                    final = _final(db.query_range(MESH_TENANT, req), req)
                    ms = (time.perf_counter() - t) * 1e3
                got[name] = (ms, _series_map(final), combines[0] - c0)
                if db.plane_stats.get("host_metric_blocks") or \
                        _fallbacks(db):
                    raise AssertionError(f"phase 18d {name}: {q}: the "
                                         f"plane fell back: "
                                         f"{db.plane_stats}")
            if not got["off"][1]:
                raise AssertionError(f"phase 18d: {q}: no series")
            _same_series(got["mesh"][1], got["off"][1], True,
                         f"phase 18d: {q}: mesh vs mesh off")
            if not got["mesh"][2] or got["off"][2]:
                raise AssertionError(f"phase 18d: {q}: in-mesh combines "
                                     f"{got['mesh'][2]} / {got['off'][2]}")
            out[q] = (got["mesh"][0], got["off"][0], len(got["off"][1]),
                      got["mesh"][2])
    finally:
        sm_read.combine = inner
        for db in (db_off, db_mesh):
            db.shutdown()
    return out


def phase18_profiles() -> dict:
    """The mesh's device code besides K1, torch.profiler in the final
    profiles' process: (1) a merged window's shape (16,384 Zipf-skewed
    spans) through `ServingMesh.fused_update` on 2 data x 2 series
    logical shards of a dense `sketch: both` tenant at the default
    widths, K1's events apart from the rest (each delta window's
    zeroing, the reduce over 'data' in shard order, the fold into the
    base); (2)
    `ServingMesh.combine` of a [series, contributions, steps] matrix of
    18d's quantile fold's size (4,096 bucket series x 4 x 11 steps)."""
    import torch

    import tempo_tpu_torch as tt
    from tempo_tpu_torch.parallel import serving

    sm = serving.ServingMesh(serving.MeshConfig(enabled=True,
                                                series_shards=2),
                             devices=_mesh_devices())
    out = {}
    with serving.use(sm):
        inst = tt.GeneratorInstance(
            MESH_TENANT, tt.GeneratorConfig(
                processors=("span-metrics",),
                spanmetrics=tt.SpanMetricsConfig(**MESH_SM)),
            device="cuda")
        proc = inst.processors["span-metrics"]
        if proc._serving_mesh() is not sm:
            raise AssertionError("phase 18 profiles: the tenant is not on "
                                 "the mesh")
        plan = proc._mesh_plan
    # a merged window's shape: 16,384 Zipf-skewed spans over the series
    rng = np.random.default_rng(SEED + 182)
    mat = np.stack([zipf_slots(rng, N_SPANS, proc.calls.table.capacity),
                    rng.lognormal(-3.7, 1.0, N_SPANS),
                    rng.integers(200, 2000, N_SPANS),
                    np.ones(N_SPANS)]).astype(np.float32)
    b = torch.from_numpy(mat).cuda()

    def update():
        sm.fused_update(plan, b, **proc._step_kw)

    events = {}
    (out["reduce_total_ms"], out["reduce_ops"], out["reduce_wall_ms"],
     _top) = _profile(update)
    _device_ms(update, events)
    out["reduce_ops"] = int(round(out["reduce_ops"]))
    k1 = sum(t for name, t in events.items() if "pfu_" in name)
    out["reduce_k1_ms"] = k1
    out["reduce_rest_ms"] = None if out["reduce_total_ms"] is None \
        else out["reduce_total_ms"] - k1
    out["reduce_events"] = {k[:60]: round(v, 6)
                            for k, v in events.items()}
    pr = plan.page_rows
    window = sum(a[pr:].numel() * a.element_size()
                 for a in plan.arenas[0])
    nbytes = (sm.data_shards * sm.series_shards
              + 2 * sm.series_shards) * window
    out["reduce_bound_bytes"] = nbytes
    out["reduce_bound_ms"], out["reduce_bound_by"] = bound(nbytes, 0)
    rng = np.random.default_rng(SEED + 181)
    stacked = rng.integers(0, 50, (4096, 4, 11)).astype(np.float32)
    comb = serving.ServingMesh(serving.MeshConfig(
        enabled=True, combine_min_elements=1), devices=_mesh_devices())
    (out["combine_ms"], out["combine_ops"], out["combine_wall_ms"],
     _top) = _profile(lambda: comb.combine(stacked, "sum"))
    out["combine_ops"] = int(round(out["combine_ops"]))
    nbytes = stacked.nbytes + stacked.shape[0] * stacked.shape[2] * 4
    out["combine_bound_bytes"] = nbytes
    out["combine_bound_ms"], out["combine_bound_by"] = bound(nbytes, 0)
    if not np.array_equal(comb.combine(stacked, "sum"),
                          stacked.sum(axis=1)):
        raise AssertionError("phase 18 profiles: the in-mesh combine "
                             "disagrees with numpy")
    return out


def phase_mesh(card):
    """Phase 18: the serving mesh on the card at the reference's default
    widths (65,536 series, DDSketch over 16,384, 15 latency buckets,
    moments k 12): 18a 4 series shards, 18b 2 data x 2 series shards,
    18c paged arenas over 4 shards (each over `[cuda:0] * 4`, logical
    shards on the one card), each against the unsharded tenant on the
    card and a CPU twin; 18d the read plane and the in-mesh combine.
    Returns (results, [K1's kernel entries, one a layout])."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase18-",
                                     dir=os.path.join(ROOT, "build")) as root:
        return _phase_mesh(card, root)


def _phase_mesh(card, root):
    import torch

    from tempo_tpu_torch.parallel import serving

    ctx = "phase 18"
    t_phase = time.perf_counter()
    t0 = float(int(time.time()))
    spans, payloads = _mesh_payloads(t0)

    def mesh(series, **cfg):
        return serving.ServingMesh(serving.MeshConfig(
            enabled=True, series_shards=series, **cfg),
            devices=_mesh_devices())

    base, bproc, bl, bd, _, base_s = _mesh_layout("cuda", t0, payloads, None)
    if bl != bd:
        raise AssertionError(f"{ctx}: unsharded K1 {bl} launches for {bd}")
    twin, tproc, *_ = _mesh_layout("cpu", t0, payloads, None)
    # each instance's rows by label set, read once
    s_base, s_twin = _label_state(base), _label_state(twin)
    q_base = _quantiles(base)
    m_twin = _mesh_rows(tproc)
    n_fams, n_series, rel_twin = _compare_states(
        s_base, s_twin, f"{ctx} unsharded card vs CPU twin")
    if q_base != _quantiles(twin):
        raise AssertionError(f"{ctx} unsharded card vs CPU twin: DDSketch "
                             f"q50/q99 differ")
    _compare_moment_rows(_mesh_rows(bproc), m_twin,
                         f"{ctx} unsharded card vs CPU twin")
    layouts = []
    for label, sm, paged, rtol in (
            ("4 series shards, dense", mesh(MESH_SHARDS), False, 1e-6),
            ("2 data x 2 series shards, dense", mesh(2), False, 1e-5),
            ("4 series shards, paged", mesh(MESH_SHARDS), True, 1e-6)):
        lctx = f"{ctx} {label}"
        inst, proc, launches, dispatches, mats, secs = _mesh_layout(
            "cuda", t0, payloads, sm, paged=paged)
        shards = sm.data_shards * sm.series_shards
        if not dispatches or launches != shards * dispatches:
            raise AssertionError(f"{lctx}: K1 launched {launches} times for "
                                 f"{dispatches} dispatches on {shards} "
                                 f"shards")
        s_lay = _label_state(inst)
        _, _, rel_base = _compare_states(s_lay, s_base,
                                         f"{lctx} vs unsharded", rtol=rtol)
        if _quantiles(inst) != q_base:
            raise AssertionError(f"{lctx} vs unsharded: DDSketch q50/q99 "
                                 f"differ")
        _, _, rel_cpu = _compare_states(s_lay, s_twin, f"{lctx} vs CPU twin")
        if not paged:
            _compare_moment_rows(_mesh_rows(proc), m_twin,
                                 f"{lctx} vs CPU twin")
        del s_lay
        k1, row = _mesh_k1_row(
            f"paged_fused_update (the serving mesh, {label} over "
            f"[cuda:0] * {MESH_SHARDS}: one launch a shard a merged window, "
            f"scheduler, staged route, sketch both, f32, default widths)",
            proc, mats[-1], launches, f"{lctx} shard window",
            sm.data_shards)
        layouts.append(dict(label=label, launches=launches,
                            dispatches=dispatches, shards=shards,
                            push_s=secs, rel_base=rel_base,
                            rel_cpu=rel_cpu, k1=k1, row=row))
        del inst, proc, mats
        gc.collect()
        torch.cuda.empty_cache()
    del base, bproc, twin, tproc
    gc.collect()
    torch.cuda.empty_cache()
    t18d = time.perf_counter()
    queries = _mesh_queries(root, spans, t0,
                            mesh(MESH_SHARDS, combine_min_elements=1))
    _PHASE18_PROFILES.append(True)
    out = dict(families=n_fams, series=n_series, rel_twin=rel_twin,
               base_s=base_s, layouts=[{k: v for k, v in lay.items()
                                        if k != "row"} for lay in layouts],
               queries=queries, query_s=time.perf_counter() - t18d)
    out["seconds"] = time.perf_counter() - t_phase
    return out, [lay["row"] for lay in layouts]


def _print_phase18(r, card):
    print(f"phase 18 [{card}]: {N_MESH_PUSHES} pushes of {N_SPANS} k6-like "
          f"spans, `sketch: both` at the default widths, unsharded on the "
          f"card in {r['base_s']:.3f} s; {r['families']} families, "
          f"{r['series']} series equal to the CPU twin's (largest sum error "
          f"{r['rel_twin']:.2e})")
    for lay in r["layouts"]:
        k1 = lay["k1"]
        print(f"phase 18 [{card}]: {lay['label']}: K1 {lay['launches']} "
              f"launches = {lay['shards']} shards x {lay['dispatches']} "
              f"merged dispatches; pushes {lay['push_s']:.3f} s; counts, "
              f"buckets, DDSketch rows and quantiles equal the unsharded "
              f"card's, sums within {lay['rel_base']:.2e} of it and "
              f"{lay['rel_cpu']:.2e} of the CPU twin's; one shard's K1 on "
              f"the last window {k1['ms'][1]:.4f} ms with the host, device "
              f"{k1['device_ms']} ms, plain {k1['plain_ms'][1]:.4f} ms, "
              f"bound {k1['bound_ms']:.6f} ms by {k1['bound_by']} "
              f"({k1['bound_bytes']} bytes)")
    for q, (m, off, n, comb) in r["queries"].items():
        print(f"phase 18d [{card}]: {q}: {m:.2f} ms through TempoDB("
              f"plane_mesh) over {MESH_SHARDS} data shards and the in-mesh "
              f"combine ({comb} device folds), {off:.2f} ms with the mesh "
              f"off; {n} series, equal")
    p = {k: _Later(f"p18-{k}") for k in (
        "reduce_total_ms", "reduce_ops", "reduce_wall_ms", "reduce_k1_ms",
        "reduce_rest_ms", "reduce_bound_ms", "reduce_bound_by",
        "reduce_bound_bytes", "combine_ms", "combine_ops",
        "combine_wall_ms", "combine_bound_ms", "combine_bound_by",
        "reduce_events")}
    print(f"phase 18 [{card}]: in the final profiles' process, a window "
          f"through 2 x 2 shards: {p['reduce_total_ms']} ms device in "
          f"{p['reduce_ops']} ops ({p['reduce_wall_ms']} ms with the host), "
          f"of it K1 {p['reduce_k1_ms']} ms and the deltas' zeroing, the "
          f"reduce over 'data' and the fold {p['reduce_rest_ms']} ms (bound "
          f"{p['reduce_bound_ms']} ms by {p['reduce_bound_by']}, "
          f"{p['reduce_bound_bytes']} bytes); the in-mesh combine of [4096, "
          f"4, 11] {p['combine_ms']} ms device in {p['combine_ops']} ops "
          f"({p['combine_wall_ms']} ms with the host; bound "
          f"{p['combine_bound_ms']} ms by {p['combine_bound_by']}); device "
          f"ms by op {p['reduce_events']}")
    print(f"phase 18 [{card}]: 18d {r['query_s']:.1f} s; {r['seconds']:.1f} s")


def main() -> int:
    """`_main` with its standard output held until the end: the readings
    taken in a later process (`_Later`) replace their tokens first, or
    read "not measured" when the run stopped before them."""
    import contextlib
    import io
    import re

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return _main()
    finally:
        text = buf.getvalue()
        for key, val in _LATER.items():
            text = text.replace(f"@@{key}@@", val)
        sys.stdout.write(re.sub(r"@@[a-z0-9_-]+@@", "not measured", text))
        sys.stdout.flush()


def _main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from tempo_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--phase10-profiles"]:
        print("PROFILES " + json.dumps(phase10_profiles()))
        return 0
    if sys.argv[1:2] == ["--phase12-profiles"]:
        # phase 13's readings ride the same process: one interpreter and
        # one CUDA context fewer in the smoke's time
        out = phase12_profiles(*sys.argv[2:])
        out["phase13"] = phase13_profiles()
        out["phase14"] = phase14_profiles()
        print("PROFILES " + json.dumps(out))
        return 0
    if sys.argv[1:] == ["--phase13-profiles"]:
        print("PROFILES " + json.dumps(phase13_profiles()))
        return 0
    if sys.argv[1:] == ["--phase14-profiles"]:
        print("PROFILES " + json.dumps(phase14_profiles()))
        return 0
    if sys.argv[1:2] == ["--final-profiles"]:
        for src in ck.SOURCES:
            ck._lib(src)
        print("PROFILES " + json.dumps(final_profiles(sys.argv[2])))
        return 0
    if sys.argv[1:] not in ([], ["--phase14"], ["--phase15"],
                            ["--phase16"], ["--phase17"], ["--phase18"]):
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    import importlib.util
    print("modules on this machine (reported only): " + ", ".join(
        f"{m} {'importable' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("pyarrow", "zstandard", "yaml")))
    t0 = time.perf_counter()
    ck.build_all()                  # one nvcc per source, all together
    for src in ck.SOURCES:
        ck._lib(src)
    build_s = time.perf_counter() - t0
    for what, info in ck.BUILD_INFO.items():
        print(f"build: {what} in {info['seconds']:.2f} s -> "
              f"{os.path.relpath(info['path'], ROOT)}\n{info['log']}")
    from tempo_tpu_torch import native
    print(f"build: the C++ host layer at import "
          + (f"in {native.BUILD_INFO['seconds']:.2f} s" if native.BUILD_INFO
             else "(found built)")
          + f" -> {os.path.relpath(native.library_path(), ROOT)}")
    print(f"build: {len(ck.BUILD_INFO)} builds in {build_s:.2f} s (one nvcc "
          f"each, together)")
    if sys.argv[1:] == ["--phase15"]:
        # phase 15 alone, its profiles and K1's device time from a
        # process of its own
        s15, k15 = phase_durability(card)
        _resolve_later(phase15=True)
        print(json.dumps(k15, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--phase16"]:
        # phase 16 alone, K1's device time on its windows from a process
        # of its own
        s16, k16 = phase_grpc(card)
        _print_phase16(s16, card)
        _resolve_later(phase15=False)
        print(json.dumps(k16, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] in (["--phase17"], ["--phase18"]):
        # phase 17 or 18 alone, K1's device time on its windows from a
        # process of its own
        if sys.argv[1:] == ["--phase17"]:
            s, k = phase_kafka(card)
            _print_phase17(s, card)
        else:
            s, k = phase_mesh(card)
            _print_phase18(s, card)
        _resolve_later(phase15=False)
        print(json.dumps(k, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--phase14"]:
        # phase 14 alone, its merge profile from a process of its own
        s14, k14 = phase_app(card)
        _print_phase14(s14, _profiles_in_child("phase 14",
                                               "--phase14-profiles"), card)
        _resolve_later(phase15=False)
        print(json.dumps(k14, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    k1 = phase_k1_dd()
    n_probe, shifted = edge_probe_on_card()
    print(f"phase 3a edge probe: {shifted} of {n_probe} DDSketch edge "
          f"durations land one bucket apart between K1 (CUDA logf) and the "
          f"host (torch CPU log)")
    k1c = phase_k1_compact()
    k1d = phase_k1_dense()
    k2 = phase_k2("bench")
    k2d = phase_k2("deployment")
    dd = phase_main_path("dd", N_MAIN_PUSHES)
    bc = phase_main_path("both_compact", N_MAIN_PUSHES)
    dn = phase_main_path("dense_dd", N_MAIN_PUSHES)
    k1["launches"], k1c["launches"] = dd["launches"], bc["launches"]
    k1d["launches"] = dn["launches"]
    mom_bytes = moments_state_bytes()
    print(f"phase 4 [{card}]: device state bytes per active series: "
          f"dd f32 {dd['bytes_per_series']:.1f} ({dd['series']} series), "
          f"both compact {bc['bytes_per_series']:.1f}, moments f32 "
          f"{mom_bytes:.1f}; dense dd f32 {dn['bytes_per_series']:.1f} "
          f"({dn['state_bytes']} bytes in all, {dn['series']} series; paged "
          f"dd f32 {dd['state_bytes']} bytes)")
    floor = host_floor_ms()
    for k in (k1, k1c, k1d, k2, k2d):
        dms = k["device_ms"]
        lib = k["library_ms"]
        print(f"phase 5 [{card}]: {k['name']}: per call ({N_TIMED} calls, "
              f"CUDA events, host included): "
              + "; ".join(f"{how} {spread(t)}" + (
                  "" if host is None else f", host {host:.4f} ms a call over "
                  f"1000 unsynchronised calls")
                  for how, (t, host) in k["times"].items())
              + f"; device time per call (torch.profiler): "
              f"{'not measured' if dms is None else f'{dms:.4f} ms'}; plain "
              f"version {k['plain_ms']:.4f} ms; bound {k['bound_ms']:.6f} ms "
              f"by {k['bound_by']} ({k['bound_bytes']} bytes at 3.35 TB/s); "
              f"library call "
              f"{'none' if lib is None else f'{lib:.4f} ms (index_add_)'}; "
              f"launches on its path {k['launches']}")
    print(f"phase 5 [{card}]: host yardstick, one PyTorch op on the card (a "
          f"1-element add_), 1000 unsynchronised calls: {floor:.4f} ms a call")
    traffic = 8 * (k1c["int_cells"] + k1c["pair_rows"])
    print(f"phase 5 [{card}]: compact K1 scratch traffic per dispatch "
          f"{traffic} bytes: {k1c['int_cells']} touched int32 cells, each "
          f"added to by the span pass and exchanged once by the fold, and "
          f"{k1c['pair_rows']} backed pair rows, each delta read and cleared "
          f"({traffic / HBM_BYTES_PER_S * 1e3:.6f} ms at 3.35 TB/s); the "
          f"scratch holds {k1c['scratch_bytes']} bytes and is never cleared "
          f"whole")
    print(f"phase 5 [{card}]: dense state, the same push: K1 through "
          f"fused_step {spread(k1d['times']['fused_step'][0])} with the host, "
          f"device {k1d['device_ms']} ms; the composed twin of the "
          f"reference's dense step {k1d['twin_ms']:.4f} ms with the host "
          f"(median), device {k1d['twin_device_ms']} ms")
    for tier, r in (("dd f32", dd), ("both compact", bc), ("dense dd f32", dn)):
        print(f"phase 5 [{card}]: end to end {tier} {r['spans_per_s']:.0f} "
              f"spans/s (decode + push of {r['pushes']} x {N_SPANS} spans in "
              f"{r['push_s']:.3f} s)")
    s6 = [phase_default_deployment(paged, card) for paged in (False, True)]
    for r in s6:
        print(f"phase 6 [{card}]: {r['name']}: scheduler route "
              f"{r['sched_spans_per_s']:.0f} spans/s, direct route "
              f"{r['direct_spans_per_s']:.0f} spans/s; K1 per merged window "
              f"{r['ms']:.4f} ms with the host, device {r['device_ms']} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms by "
              f"{r['bound_by']}; launches {r['launches']}; phase "
              f"{r['seconds']:.1f} s")
    t7 = time.perf_counter()
    s7 = [phase_staged_fast(paged, card) for paged in (False, True)]
    recs = phase_recs_route(card)
    s7c = phase_staged_default(card)
    for r, py in zip(s7, (dn, dd)):
        d, sc = r["runs"]["direct"], r["runs"]["sched"]
        print(f"phase 7 [{card}]: {r['name']}: spans/s from wire bytes, "
              f"direct route {d['spans_per_s']:.0f} (series known: "
              f"{d['warm_spans_per_s']:.0f}), scheduler route "
              f"{sc['spans_per_s']:.0f} ({sc['warm_spans_per_s']:.0f}) "
              f"(phase 4's Python decode + push_batch "
              f"on this state: {py['spans_per_s']:.0f}); staging "
              f"{d['stage_s'] * 1e3:.3f} / {sc['stage_s'] * 1e3:.3f} ms a "
              f"payload, resolve {d['resolve_s'] * 1e3:.3f} / "
              f"{sc['resolve_s'] * 1e3:.3f} ms a push; pipeline overlap ratio "
              f"{sc['pipe']['overlap']:.4f}, stall {sc['pipe']['stall_s']:.4f} "
              f"s; K1 device time a staged push {r['device_ms']} ms")
    print(f"phase 7 [{card}]: recs route spans/s {json.dumps(recs)}; default "
          f"instance staged {s7c['staged_spans_per_s']:.0f} spans/s against "
          f"Python decode {s7c['python_spans_per_s']:.0f}; phase 7 "
          f"{time.perf_counter() - t7:.1f} s")
    s8, k8 = phase_distributor(card)
    sm_spans = N_DIST_PUSHES * N_SPANS * len(SM_TENANTS)
    sc7 = s7[0]["runs"]["sched"]
    print(f"phase 8 [{card}]: span-metrics tenants through "
          f"Distributor.push_otlp, spans/s with every series new / known: "
          f"8a {sm_spans / s8['8a']['secs']['new']:.0f} / "
          f"{sm_spans / s8['8a']['secs']['known']:.0f}; 8b (one pass) "
          f"{sm_spans / s8['8b']['secs']['new']:.0f} / -"
          + f"; phase 7a's staged fast route on the same payloads (dense, "
          f"scheduler, no distributor) {sc7['spans_per_s']:.0f} / "
          f"{sc7['warm_spans_per_s']:.0f}; distributor host time a "
          f"16,384-span push, series new / known: "
          f"8a {s8['8a']['push_ms']['new']['push']:.3f} / "
          f"{s8['8a']['push_ms']['known']['push']:.3f} ms; 8b "
          f"{s8['8b']['push_ms']['new']['push']:.3f} / - ms"
          + f"; of it the ingester leg (3 real ingesters), series new / "
          f"known: 8a {s8['8a']['push_ms']['new']['push_staged']:.3f} / "
          f"{s8['8a']['push_ms']['known']['push_staged']:.3f} ms, 8b "
          f"{s8['8b']['ingester_ms']:.3f} ms over every pass; K1 device time "
          f"a push {s8['8a']['device_ms']} ms; phase 8 "
          f"{s8['seconds']:.1f} s")
    s9, (s10a, s11a) = phase_ingester(
        card, then=lambda store, handoff: (
            phase_read_push(store, handoff, card),
            phase_frontend_search(store, handoff, card)))
    print(f"phase 9 [{card}]: push {s9['push_spans_per_s']:.0f} spans/s, cut "
          f"{s9['segments_per_s']:.1f} WAL segments/s (fsync "
          f"{s9['fsync_ms']:.3f} ms), complete {s9['complete_s']:.3f} s an "
          f"ingester, {s9['bytes_per_span']:.2f} bytes a span; phase 9 "
          f"{s9['seconds']:.1f} s")
    s10b = phase_query_bench(card)
    print(f"phase 10 [{card}]: 10a {s10a['seconds']:.1f} s, 10b "
          f"{s10b['seconds']:.1f} s")
    print(f"phase 11 [{card}]: 11a {s11a['seconds']:.1f} s, 11b "
          f"{s10b['11b']['seconds']:.1f} s, 11c {s10b['11c']['seconds']:.1f} "
          f"s, phase 11 {s11a['seconds'] + s10b['11_seconds']:.1f} s")
    s12, k12 = phase_ingest_storage(card)
    _print_phase12(s12, card)
    print(f"phase 12 [{card}]: {s12['seconds']:.1f} s")
    s13a, k13a = phase_matview(card)
    s13b, k13b = phase_traceanalytics(card)
    _print_phase13(s13a, s13b, s12["prof"]["phase13"], card)
    print(f"phase 13 [{card}]: 13a {s13a['seconds']:.1f} s, 13b "
          f"{s13b['seconds']:.1f} s")
    s14, k14 = phase_app(card)
    _print_phase14(s14, s12["prof"]["phase14"], card)
    print(f"phase 14 [{card}]: {s14['seconds']:.1f} s")
    s15, k15 = phase_durability(card)
    s16, k16 = phase_grpc(card)
    _print_phase16(s16, card)
    s17, k17 = phase_kafka(card)
    _print_phase17(s17, card)
    s18, k18 = phase_mesh(card)
    _print_phase18(s18, card)
    t_late = time.perf_counter()
    _resolve_later(phase15=True)
    print(f"the final profiles (every K1 window's device time, phase 15's "
          f"readings) {time.perf_counter() - t_late:.1f} s in a process of "
          f"their own; the whole smoke {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in (k1, k1c, k1d, k2, k2d, *s6, *s7,
                                            *k8, k12, k13a, k13b, k14,
                                            k15, *k16, *k17, *k18)]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
