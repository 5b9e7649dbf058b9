"""DDSketch: the per-series relative-error quantile sketch, on tensors.

Counterpart of the DDSketch half of `tempo_tpu/ops/sketches.py`. Bucket
i (i ≥ 0) covers (min·γ^(i-1), min·γ^i]; quantile estimates use the
γ-midpoint, giving relative error ≤ (γ-1)/(γ+1). With the default
γ ≈ 1.0202 the guarantee is 1%. Mergeable by addition.

Numerics. The reference computes the estimate in f32 as
`min*2 * γ^b / (γ+1)`, and its CPU backend takes γ^b from the C
library's `powf`. PyTorch's `pow` rounds differently in the last place
for some exponents, and the card's `powf` differs again, so the port
turns the estimate into a per-bucket value table computed once on the
host with the C library's `powf` and the same f32 op order, and the
device only gathers from it. The answer is then the same on the CPU and
on the card, and bit-identical to the reference on the CPU.

`dd_init` / `dd_update` are the dense layout's sketch plane and the
update its composed twin runs; on the write path the paged fused update
(K1) adds into the same rows.

Log2, HyperLogLog and Count-Min sketches come with later slices.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ops.pages import (DENSE_PAGE_ROWS, add_cells, add_rows,
                                      dd_index, dense_zeros)


@dataclasses.dataclass
class DDSketch:
    """Per-series log-γ bucket histograms: counts[S, B] f32 plus zero
    counts[S]; `gamma` and `min_value` are the static hyperparameters."""

    counts: torch.Tensor
    zeros: torch.Tensor
    gamma: float
    min_value: float


def dd_params(rel_err: float = 0.01, min_value: float = 1e-9,
              max_value: float = 1e12):
    gamma = (1.0 + rel_err) / (1.0 - rel_err)
    nbuckets = int(math.ceil(math.log(max_value / min_value) / math.log(gamma))) + 2
    return gamma, nbuckets


def dd_init(num_series: int, rel_err: float = 0.01, min_value: float = 1e-9,
            max_value: float = 1e12, device=None,
            page_rows: int = DENSE_PAGE_ROWS) -> DDSketch:
    """Empty rows on `device` (`cuda` unless `"cpu"` is asked for), each
    tensor a row view of a trash-paged arena (`ops.pages.dense_zeros`)."""
    gamma, nb = dd_params(rel_err, min_value, max_value)
    dev = resolve_device(device)
    return DDSketch(
        counts=dense_zeros(num_series, nb, page_rows=page_rows, device=dev),
        zeros=dense_zeros(num_series, None, page_rows=page_rows, device=dev),
        gamma=gamma, min_value=min_value)


def dd_update(state: DDSketch, series_ids, values, mask=None,
              weights=None) -> DDSketch:
    """Add a batch of observations into the series' rows, in place. As in
    the reference, a masked span goes to row 0 with weight 0; ids outside
    [0, S) drop. The bucket is `ops.pages.dd_index` (the reference's f32
    op order)."""
    counts = state.counts
    dev = counts.device
    sids = torch.as_tensor(series_ids, device=dev).to(torch.int64)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    w = torch.ones_like(v) if weights is None \
        else torch.as_tensor(weights, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if mask is not None:
        m = torch.as_tensor(mask, device=dev)
        w = torch.where(m, w, zero)
        sids = torch.where(m, sids, 0)
    is_zero = v <= torch.tensor(state.min_value, dtype=torch.float32,
                                device=dev)
    idx = dd_index(v, state.gamma, state.min_value, counts.shape[-1])
    keep = (sids >= 0) & (sids < counts.shape[0])
    add_cells(counts, sids, idx, keep, torch.where(is_zero, zero, w))
    add_rows(state.zeros, sids, keep, torch.where(is_zero, w, zero))
    return state


def _merge_check(kind: str, a_meta: tuple, b_meta: tuple,
                 a_shape: tuple, b_shape: tuple) -> None:
    """Merge-compatibility guard: a real ValueError (not an assert, which
    `python -O` strips) so a mismatched merge fails instead of corrupting
    quantiles."""
    if a_meta != b_meta or a_shape != b_shape:
        raise ValueError(
            f"{kind}: incompatible sketches (meta {a_meta} vs {b_meta}, "
            f"shape {a_shape} vs {b_shape})")


def dd_merge(a: DDSketch, b: DDSketch) -> DDSketch:
    _merge_check("dd_merge",
                 ("gamma", a.gamma, "min_value", a.min_value),
                 ("gamma", b.gamma, "min_value", b.min_value),
                 tuple(a.counts.shape), tuple(b.counts.shape))
    return dataclasses.replace(a, counts=a.counts + b.counts,
                               zeros=a.zeros + b.zeros)


@functools.lru_cache(maxsize=None)
def _libm_powf():
    path = ctypes.util.find_library("m")
    if path is None:
        raise RuntimeError("the C math library (libm) was not found")
    fn = ctypes.CDLL(path).powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


@functools.lru_cache(maxsize=None)
def dd_value_table(gamma: float, min_value: float, nb: int) -> np.ndarray:
    """[nb] f32 quantile estimate of each bucket: f32(min*2) * powf(γ, b)
    / f32(γ+1), in the reference's op order."""
    powf = _libm_powf()
    g = float(np.float32(gamma))
    p = np.array([powf(g, float(b)) for b in range(nb)], np.float32)
    return np.float32(min_value * 2.0) * p / np.float32(gamma + 1.0)


def dd_quantile(state: DDSketch, q: float) -> torch.Tensor:
    """γ-midpoint quantile per series, [S] f32, on the sketch's device.
    Zeros sort first; an empty row reads 0."""
    counts = state.counts
    nb = counts.shape[-1]
    total = state.zeros + counts.sum(dim=-1)
    target = torch.tensor(q, dtype=torch.float32, device=counts.device) * total
    hit_zero = state.zeros >= target
    cum = state.zeros[..., None] + torch.cumsum(counts, dim=-1)
    b = torch.argmax((cum >= target[..., None]).to(torch.uint8), dim=-1)
    table = torch.from_numpy(dd_value_table(state.gamma, state.min_value,
                                            nb)).to(counts.device)
    val = table[b]
    zero = torch.zeros((), dtype=torch.float32, device=counts.device)
    val = torch.where(hit_zero, zero, val)
    return torch.where(total > 0, val, zero)


__all__ = ["DDSketch", "dd_params", "dd_init", "dd_update", "dd_merge",
           "dd_quantile", "dd_value_table", "_merge_check"]
