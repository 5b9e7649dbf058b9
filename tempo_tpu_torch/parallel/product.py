"""Product paths under a device mesh.

Counterpart of `tempo_tpu/parallel/product.py`: a `SpanMetricsProcessor`
push run through the sharded step of `parallel.mesh` over the
processor's own state, with its own host staging (`_label_rows` and
`resolve_slots` on the tenant's interner and series table, so the
single-device and sharded paths agree on slots). `collect()` then reads
the state as always. Multi-device `query_range` needs no helper: pass a
mesh through `TempoDBConfig(plane_mesh=...)`.
"""

from __future__ import annotations

import numpy as np
import torch

_STEP_CACHE: dict = {}


def _cached_step(mesh, edges, gamma, min_value):
    """The sharded step memoized per (mesh, hyperparameters), keyed by the
    mesh's VALUE identity (shape and devices), never `id(mesh)`: ids are
    reused after garbage collection."""
    from tempo_tpu_torch.parallel.mesh import mesh_fingerprint

    key = (mesh_fingerprint(mesh), edges, float(gamma), float(min_value))
    fn = _STEP_CACHE.get(key)
    if fn is None:
        from tempo_tpu_torch.parallel.mesh import sharded_spanmetrics_step

        if len(_STEP_CACHE) >= 16:
            _STEP_CACHE.clear()
        fn = _STEP_CACHE[key] = sharded_spanmetrics_step(
            mesh, edges, gamma, min_value)
    return fn


def shard_processor_state(proc, mesh) -> None:
    """Place a SpanMetricsProcessor's dense state for `mesh`: every plane
    a row view of a trash-paged arena on the mesh's device. Idempotent;
    call once before `sharded_push_batch`. The mesh's shards must share
    one device (item 13b)."""
    from tempo_tpu_torch.ops.sketches import dd_place
    from tempo_tpu_torch.parallel.serving import MULTI_DEVICE_STATE
    from tempo_tpu_torch.registry import metrics as rm

    dev = mesh.single_device
    if dev is None:
        raise NotImplementedError(MULTI_DEVICE_STATE)
    pr = proc.registry.dense_page_rows
    proc.calls.state = rm.place_state(proc.calls.state, dev, pr)
    proc.latency.state = rm.place_state(proc.latency.state, dev, pr)
    proc.sizes.state = rm.place_state(proc.sizes.state, dev, pr)
    if proc.dd is not None:
        proc.dd = dd_place(proc.dd, dev, pr)


def sharded_push_batch(proc, mesh, sb, span_sizes=None) -> None:
    """One span-metrics push under the mesh: the processor's host staging,
    then `parallel.mesh.sharded_spanmetrics_step` over its state (K1 once
    per shard), written back into the processor's planes; exemplars ride
    the same `note_exemplars`."""
    from tempo_tpu_torch.ops import sketches

    if sb.interner is not proc.registry.interner:
        raise ValueError("SpanBatch must use the tenant registry's interner")
    valid = sb.valid.copy()
    if proc._policies:
        keep = proc._policies(sb)
        proc.spans_discarded += int((valid & ~keep).sum())
        valid &= keep
    rows = proc._label_rows(sb)
    slots = proc.calls.resolve_slots(rows, valid=valid)
    dur_s = (sb.duration_ns / 1e9).astype(np.float32)
    if span_sizes is None:
        span_sizes = np.zeros(sb.capacity, np.float32)
    weights = np.ones(sb.capacity, np.float32)

    dd = proc.dd
    step = _cached_step(
        mesh, tuple(proc.latency.state.edges),
        dd.gamma if dd is not None else sketches.dd_params(0.01)[0],
        dd.min_value if dd is not None else 1e-9)
    cs, hs, zs = proc.calls.state, proc.latency.state, proc.sizes.state
    dd_counts = dd.counts if dd is not None else \
        torch.zeros((cs.values.shape[0], 1), device=cs.values.device)
    dd_zeros = dd.zeros if dd is not None else \
        torch.zeros((cs.values.shape[0],), device=cs.values.device)
    out = step(cs.values, hs.bucket_counts, hs.sums, hs.counts, zs.values,
               dd_counts, dd_zeros, np.ascontiguousarray(slots, np.int32),
               dur_s, span_sizes.astype(np.float32), weights)
    with proc.registry.state_lock:
        targets = (cs.values, hs.bucket_counts, hs.sums, hs.counts,
                   zs.values) + ((dd.counts, dd.zeros) if dd is not None
                                 else ())
        for t, new in zip(targets, out):
            t.copy_(new)
    ts_ms = int(proc.registry.now() * 1000)
    proc.calls.note_exemplars(slots, sb.trace_id, dur_s, ts_ms)
    proc.latency.exemplars = proc.calls.exemplars


__all__ = ["shard_processor_state", "sharded_push_batch"]
