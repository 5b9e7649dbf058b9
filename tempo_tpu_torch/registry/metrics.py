"""Metric states as dataclasses of tensors + batched in-place updates.

One row per series slot. These are the composable device halves of the
reference registry's metric types (`modules/generator/registry/
{counter,gauge,histogram}.go`), counterparts of
`tempo_tpu/registry/metrics.py`.

All updates accept slot ids with -1 = "discard" (series-limited or
padding): `_mask_slots` redirects discards to `capacity`, one past the
last row, and the scatters drop every out-of-range row. The JAX
reference returns new states; these update the state's tensors in place
(PyTorch has no donation) and return the same state object.

Every state tensor is a row view of an arena with one leading trash page
(`ops.pages.dense_zeros`), so the span-metrics processor can hand the
dense families to the paged fused update (K1) over identity page tables.
"""

from __future__ import annotations

import dataclasses

import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ops.pages import DENSE_PAGE_ROWS, dense_zeros, hist_bucket


def _mask_slots(slots: torch.Tensor, mask: "torch.Tensor | None",
                capacity: int) -> torch.Tensor:
    """Slot ids with discards redirected out of range (== capacity)."""
    s = torch.as_tensor(slots).to(torch.int64)
    if mask is not None:
        s = torch.where(torch.as_tensor(mask, device=s.device), s, -1)
    return torch.where(s < 0, capacity, s)


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
    cap = state.values.shape[0]
    s = _mask_slots(torch.as_tensor(slots, device=dev), mask, cap)
    w = _weights(weights, s, dev)
    keep = s < cap
    state.values.index_put_((s[keep],), w[keep], accumulate=True)
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
    (last-wins resolved during staging)."""
    dev = state.values.device
    cap = state.values.shape[0]
    s = _mask_slots(torch.as_tensor(slots, device=dev), mask, cap)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    keep = s < cap
    state.values[s[keep]] = v[keep]
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
    cap = state.sums.shape[0]
    s = _mask_slots(torch.as_tensor(slots, device=dev), mask, cap)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    w = _weights(weights, s, dev)
    b = hist_bucket(v, state.edges)
    keep = s < cap
    s, v, w, b = s[keep], v[keep], w[keep], b[keep]
    state.bucket_counts.index_put_((s, b), w, accumulate=True)
    state.sums.index_put_((s,), v * w, accumulate=True)
    state.counts.index_put_((s,), w, accumulate=True)
    return state


def zero_slots(state, slots):
    """Zero the rows of evicted slots in every tensor of a metric state;
    slots outside [0, capacity) are ignored (the registry pads eviction
    batches with `capacity`)."""
    for f in dataclasses.fields(state):
        arr = getattr(state, f.name)
        if not isinstance(arr, torch.Tensor):
            continue
        s = torch.as_tensor(slots, device=arr.device).to(torch.int64)
        s = s[(s >= 0) & (s < arr.shape[0])]
        arr[s] = 0.0
    return state
