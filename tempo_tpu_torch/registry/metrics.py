"""Metric states as dataclasses of tensors + batched in-place updates.

One row per series slot. These are the composable device halves of the
reference registry's metric types (`modules/generator/registry/
{counter,gauge,histogram}.go`), counterparts of
`tempo_tpu/registry/metrics.py`.

All updates accept slot ids with -1 = "discard" (series-limited or
padding); slots outside [0, capacity) and masked spans drop. The JAX
reference drops them with `mode="drop"` scatters. Here each add is one
`index_add_` over every span with the dropped spans aimed at row 0 and
a zero addend (`ops.pages.add_rows` / `add_cells`), and a gauge set
writes the dropped spans' zero into the trash row just before the
state's rows: no boolean selection, no `nonzero`, no host sync. The JAX
reference returns new states; these update the state's tensors in place
(PyTorch has no donation) and return the same state object.

Every state tensor is a row view of an arena with one leading trash page
(`ops.pages.dense_zeros`), so the span-metrics processor can hand the
dense families to the paged fused update (K1) over identity page tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ops import sketches
from tempo_tpu_torch.ops.pages import (DENSE_PAGE_ROWS, add_cells, add_rows,
                                      dense_zeros, hist_bucket, log2_bucket)


def _kept_slots(slots, mask, capacity: int, device):
    """(slots int64, keep): which spans land in [0, capacity), unmasked."""
    s = torch.as_tensor(slots, device=device).to(torch.int64)
    keep = (s >= 0) & (s < capacity)
    if mask is not None:
        keep &= torch.as_tensor(mask, device=device)
    return s, keep


def _weights(weights, like: torch.Tensor, device) -> torch.Tensor:
    if weights is None:
        return torch.ones(like.shape, dtype=torch.float32, device=device)
    return torch.as_tensor(weights, dtype=torch.float32, device=device)


@dataclasses.dataclass
class CounterState:
    values: torch.Tensor  # [S] f32


def counter_init(capacity: int, device=None,
                 page_rows: int = DENSE_PAGE_ROWS) -> CounterState:
    """Zero rows on `device` (`cuda` unless `"cpu"` is asked for)."""
    return CounterState(values=dense_zeros(
        capacity, None, page_rows=page_rows, device=resolve_device(device)))


def counter_update(state: CounterState, slots, weights=None,
                   mask=None) -> CounterState:
    dev = state.values.device
    s, keep = _kept_slots(slots, mask, state.values.shape[0], dev)
    add_rows(state.values, s, keep, _weights(weights, s, dev))
    return state


@dataclasses.dataclass
class GaugeState:
    values: torch.Tensor  # [S] f32


def gauge_init(capacity: int, device=None,
               page_rows: int = DENSE_PAGE_ROWS) -> GaugeState:
    """Zero rows on `device` (`cuda` unless `"cpu"` is asked for)."""
    return GaugeState(values=dense_zeros(
        capacity, None, page_rows=page_rows, device=resolve_device(device)))


def gauge_set(state: GaugeState, slots, values, mask=None) -> GaugeState:
    """Set semantics; the host stages at most one row per slot per batch
    (last-wins resolved during staging), so the kept rows are distinct.
    The set runs on the arena behind the state's rows: a dropped span
    sets zero into its trash page, which stays zero."""
    vals = state.values
    dev = vals.device
    s, keep = _kept_slots(slots, mask, vals.shape[0], dev)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    arena, off = _arena_rows(vals)
    arena.index_put_((torch.where(keep, s + off, 0),),
                     torch.where(keep, v, v.new_zeros(())))
    return state


def _arena_rows(view: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(arena, row offset) of a 1-D row view of a trash-paged arena: rows
    [0, offset) of the arena are trash. Raises for any other tensor."""
    base = view._base
    if base is None or base.dim() != 1 or base.dtype != view.dtype:
        raise ValueError("gauge state must be a row view of a trash-paged "
                         "arena (gauge_init)")
    off = (view.data_ptr() - base.data_ptr()) // base.element_size()
    if off < 1:
        raise ValueError("gauge state has no trash row before its rows")
    return base, off


def gauge_add(state: GaugeState, slots, values, mask=None) -> GaugeState:
    """Add `values` into the slots' rows, in place (a scatter-add: rows
    repeated in the batch accumulate); masked and out-of-range slots
    drop."""
    vals = state.values
    dev = vals.device
    s, keep = _kept_slots(slots, mask, vals.shape[0], dev)
    add_rows(vals, s, keep, torch.as_tensor(values, dtype=torch.float32,
                                            device=dev))
    return state


@dataclasses.dataclass
class HistogramState:
    """Classic histogram rows (`registry/histogram.go:107-189`): device
    keeps per-bucket increments; cumulative `le` buckets are built at
    collect. `edges` are the upper bounds in seconds, +Inf implicit."""

    bucket_counts: torch.Tensor  # [S, B+1] f32 (last = +Inf overflow)
    sums: torch.Tensor           # [S] f32
    counts: torch.Tensor         # [S] f32
    edges: tuple


def histogram_init(capacity: int, edges: tuple, device=None,
                   page_rows: int = DENSE_PAGE_ROWS) -> HistogramState:
    """Zero rows on `device` (`cuda` unless `"cpu"` is asked for)."""
    dev = resolve_device(device)

    def z(width=None):
        return dense_zeros(capacity, width, page_rows=page_rows, device=dev)

    return HistogramState(bucket_counts=z(len(edges) + 1), sums=z(),
                          counts=z(), edges=tuple(edges))


def histogram_update(state: HistogramState, slots, values, weights=None,
                     mask=None) -> HistogramState:
    dev = state.sums.device
    s, keep = _kept_slots(slots, mask, state.sums.shape[0], dev)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    w = _weights(weights, s, dev)
    add_cells(state.bucket_counts, s, hist_bucket(v, state.edges), keep, w)
    add_rows(state.sums, s, keep, v * w)
    add_rows(state.counts, s, keep, w)
    return state


# -- native (exponential) histogram -----------------------------------------

@dataclasses.dataclass
class NativeHistogramState:
    """Exponential-bucket histogram (`registry/native_histogram.go:85,195`):
    the log2 sketch (Prometheus native histogram schema 0, one bucket per
    power of two) plus sum, count and zero count. The sketch's bucket
    offset (default 32) keeps sub-second resolution for second-scale
    latencies; the exporter shifts bucket indices back by it."""

    hist: sketches.Log2Histogram  # [S, 64]
    sums: torch.Tensor            # [S]
    counts: torch.Tensor          # [S]
    zeros: torch.Tensor           # [S]


NATIVE_HISTOGRAM_OFFSET = 32


def native_histogram_init(capacity: int,
                          offset: int = NATIVE_HISTOGRAM_OFFSET, device=None,
                          page_rows: int = DENSE_PAGE_ROWS
                          ) -> NativeHistogramState:
    """Zero rows on `device` (`cuda` unless `"cpu"` is asked for)."""
    dev = resolve_device(device)
    return NativeHistogramState(
        hist=sketches.log2_hist_init(capacity, offset=offset, device=dev,
                                     page_rows=page_rows),
        sums=dense_zeros(capacity, None, page_rows=page_rows, device=dev),
        counts=dense_zeros(capacity, None, page_rows=page_rows, device=dev),
        zeros=dense_zeros(capacity, None, page_rows=page_rows, device=dev))


def native_histogram_update(state: NativeHistogramState, slots, values,
                            weights=None, mask=None) -> NativeHistogramState:
    """Observe values into the slots' rows, in place; -1, out-of-range
    and masked slots drop."""
    dev = state.sums.device
    s, keep = _kept_slots(slots, mask, state.sums.shape[0], dev)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    w = _weights(weights, s, dev)
    add_cells(state.hist.counts, s, log2_bucket(v, state.hist.offset), keep,
              w)
    add_rows(state.sums, s, keep, v * w)
    add_rows(state.counts, s, keep, w)
    add_rows(state.zeros, s, keep, torch.where(v == 0, w, w.new_zeros(())))
    return state


def state_tensors(state):
    """Every plane of a metric state (a tensor, or a
    `parallel.mesh.ShardedPlane` once placed on the serving mesh),
    nested sketch states included."""
    from tempo_tpu_torch.parallel.mesh import ShardedPlane

    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if isinstance(t, (torch.Tensor, ShardedPlane)):
            yield t
        elif dataclasses.is_dataclass(t):
            yield from state_tensors(t)


def place_state(state, device, page_rows: int):
    """A metric state with every tensor a row view of a trash-paged arena
    on `device`, or over the serving mesh's series devices one arena a
    shard (`ops.pages.place_view`); static meta (histogram edges) rides
    along. Idempotent: a state already placed comes back unchanged."""
    from tempo_tpu_torch.ops.pages import place_view
    from tempo_tpu_torch.parallel.mesh import ShardedPlane

    return dataclasses.replace(state, **{
        f.name: place_view(getattr(state, f.name), device, page_rows)
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), (torch.Tensor, ShardedPlane))})


def zero_slots(state, slots):
    """Zero the rows of evicted slots in every plane of a metric state;
    slots outside [0, capacity) are ignored (the registry pads eviction
    batches with `capacity`)."""
    from tempo_tpu_torch.parallel.mesh import zero_rows

    for arr in state_tensors(state):
        zero_rows(arr, np.asarray(slots))
    return state
