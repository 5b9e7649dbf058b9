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

The HyperLogLog half (`hll_init`, `hll_update`, `hll_merge`,
`hll_estimate`) is the reference's jnp code as torch ops on the state's
device: registers are int32 and bit-identical to the reference's (hashes
ride in int64, rho comes from an integer bit length, the update is a
`scatter_reduce_` max), the estimate is float32 as the reference's is.
The log2 half (`Log2Histogram`, `log2_bucket`, `log2_hist_init`,
`log2_hist_update`, `log2_hist_merge`, `log2_quantile`) is the
per-series power-of-two histogram that native histograms keep: the
reference's f32 `log2` with its 1e-4 nudge (`ops.pages.log2_bucket`)
and a scatter-add into the series' row. torch's f32 `log2` and XLA's can
differ by one ulp, so within one ulp below a nudged edge a value may
land one bucket apart from the reference's; exact powers of two land
where the reference's do. Count-Min comes with a later slice.
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
from tempo_tpu_torch.ops.pages import (DENSE_PAGE_ROWS, NUM_LOG2_BUCKETS,
                                      add_cells, add_rows, dd_index,
                                      dense_zeros, hll_cells, log2_bucket,
                                      max_rows, u32_on)


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


def dd_place(state: DDSketch, device, page_rows: int) -> DDSketch:
    """Place the sketch plane (`ops.pages.place_view`): its tensors as
    row views of trash-paged arenas on `device`, or, given the serving
    mesh's series devices, one arena a shard on each, which the shards'
    K1 launches update. Idempotent."""
    from tempo_tpu_torch.ops.pages import place_view

    return dataclasses.replace(
        state, counts=place_view(state.counts, device, page_rows),
        zeros=place_view(state.zeros, device, page_rows))


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


# ---------------------------------------------------------------------------
# Log2 histogram (power-of-two buckets)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Log2Histogram:
    """Per-series power-of-two histograms: counts[S, 64] f32.

    Bucket 0 holds zeros (and underflow below 2^-offset); bucket b > 0
    holds values in [2^(b-1-offset), 2^(b-offset)), i.e. b = floor(log2
    v) + 1 + offset clipped to 63. `offset` (static) shifts the covered
    range down so second-scale floats keep sub-second resolution."""

    counts: torch.Tensor
    offset: int = 0


def log2_hist_init(num_series: int, offset: int = 0, device=None,
                   page_rows: int = DENSE_PAGE_ROWS) -> Log2Histogram:
    """Empty rows on `device` (`cuda` unless `"cpu"` is asked for), a row
    view of a trash-paged arena."""
    return Log2Histogram(
        counts=dense_zeros(num_series, NUM_LOG2_BUCKETS, page_rows=page_rows,
                           device=resolve_device(device)),
        offset=offset)


def log2_hist_update(state: Log2Histogram, series_ids, values, mask=None,
                     weights=None) -> Log2Histogram:
    """Add a batch of observations into the series' rows, in place: one
    `index_add_` over (row, bucket) cells. A masked span goes to row 0
    with weight 0, as in the reference; ids outside [0, S) drop (the
    reference's scatter wraps a negative id to the last rows)."""
    counts = state.counts
    dev = counts.device
    sids = torch.as_tensor(series_ids, device=dev).to(torch.int64)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    w = torch.ones_like(v) if weights is None \
        else torch.as_tensor(weights, dtype=torch.float32, device=dev)
    if mask is not None:
        m = torch.as_tensor(mask, device=dev)
        w = torch.where(m, w, w.new_zeros(()))
        sids = torch.where(m, sids, 0)
    keep = (sids >= 0) & (sids < counts.shape[0])
    add_cells(counts, sids, log2_bucket(v, state.offset), keep, w)
    return state


def log2_hist_merge(a: Log2Histogram, b: Log2Histogram) -> Log2Histogram:
    """Combine = elementwise add."""
    _merge_check("log2_hist_merge", ("offset", a.offset),
                 ("offset", b.offset), tuple(a.counts.shape),
                 tuple(b.counts.shape))
    return dataclasses.replace(a, counts=a.counts + b.counts)


def log2_quantile(state: Log2Histogram, q: float) -> torch.Tensor:
    """Interpolated quantile per series, [S] f32: the position within the
    selected bucket interpolates the exponent, value = 2^(b-1-offset+frac)
    for bucket b spanning [2^(b-1-offset), 2^(b-offset)); an empty row
    or bucket 0 reads 0."""
    counts = state.counts
    f32 = dict(dtype=torch.float32, device=counts.device)
    total = counts.sum(dim=-1)
    target = torch.tensor(q, **f32) * total
    cum = torch.cumsum(counts, dim=-1)
    b = torch.argmax((cum >= target[..., None]).to(torch.uint8), dim=-1)
    before = torch.gather(cum, -1, (b - 1).clamp(min=0)[..., None])[..., 0]
    zero = torch.zeros((), **f32)
    cum_before = torch.where(b > 0, before, zero)
    in_bucket = torch.gather(counts, -1, b[..., None])[..., 0]
    frac = torch.where(in_bucket > 0, (target - cum_before)
                       / torch.clamp(in_bucket, min=1e-30),
                       torch.ones((), **f32))
    val = torch.exp2(b.to(torch.float32) - torch.tensor(
        1.0 + state.offset, **f32) + frac)
    val = torch.where(b == 0, zero, val)
    return torch.where(total > 0, val, zero)


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


# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HyperLogLog:
    """Per-series HLL registers [S, m] int32, m = 2^precision. Update is
    a scatter-max, merge an elementwise max."""

    registers: torch.Tensor
    precision: int


def hll_init(num_series: int, precision: int = 14,
             device=None) -> HyperLogLog:
    """Empty registers on `device` (`cuda` unless `"cpu"` is asked for)."""
    return HyperLogLog(
        registers=torch.zeros((num_series, 1 << precision), dtype=torch.int32,
                              device=resolve_device(device)),
        precision=precision)


def hll_update(state: HyperLogLog, series_ids, h1, h2,
               mask=None) -> HyperLogLog:
    """Insert pre-hashed items (two uint32 hashes each), in place: h1's
    top bits pick the register, rho = clz(h2) + 1 (<= 33) goes in by max
    (`ops.pages.hll_cells`). A masked item maxes 0 into register 0 of
    series 0, as in the reference. Ids outside [0, S) drop; the
    reference's scatter wraps a negative id to the last rows."""
    regs = state.registers
    dev = regs.device
    sids = torch.as_tensor(series_ids, device=dev).to(torch.int64)
    idx, rho = hll_cells(u32_on(h1, dev), u32_on(h2, dev), state.precision)
    if mask is not None:
        m = torch.as_tensor(mask, device=dev)
        rho = torch.where(m, rho, 0)
        sids = torch.where(m, sids, 0)
        idx = torch.where(m, idx, 0)
    keep = (sids >= 0) & (sids < regs.shape[0])
    max_rows(regs.view(-1), sids * regs.shape[1] + idx, keep, rho)
    return state


def hll_merge(a: HyperLogLog, b: HyperLogLog) -> HyperLogLog:
    _merge_check("hll_merge", ("precision", a.precision),
                 ("precision", b.precision),
                 tuple(a.registers.shape), tuple(b.registers.shape))
    return dataclasses.replace(
        a, registers=torch.maximum(a.registers, b.registers))


def hll_estimate(state: HyperLogLog) -> torch.Tensor:
    """Cardinality estimate per series, [S] float32: the Flajolet alpha_m
    raw estimate, linear counting in the small range (E <= 2.5 m with
    empty registers), each step in f32 as the reference's."""
    m = float(1 << state.precision)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    f32 = dict(dtype=torch.float32, device=state.registers.device)
    regs = state.registers.to(torch.float32)
    raw = torch.tensor(alpha * m * m, **f32) / torch.exp2(-regs).sum(dim=-1)
    zeros = (regs == 0).sum(dim=-1).to(torch.float32)
    mt = torch.tensor(m, **f32)
    linear = mt * torch.log(mt / torch.clamp(zeros, min=1e-30))
    use_linear = (raw <= torch.tensor(2.5 * m, **f32)) & (zeros > 0)
    return torch.where(use_linear, linear, raw)


# ---------------------------------------------------------------------------
# Count-min (per-series heavy-hitter frequency plane)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CountMinSketch:
    """Per-series count-min tables [S, d, w] f32. Kirsch-Mitzenmacher
    double hashing: row i uses (h1 + i * h2) & (w - 1). Merge = add."""

    table: torch.Tensor
    depth: int
    width: int        # a power of two


def cms_init(num_series: int, depth: int = 4, width: int = 2048,
             device=None) -> CountMinSketch:
    if width & (width - 1):
        raise ValueError("width must be a power of two")
    return CountMinSketch(
        table=torch.zeros((num_series, depth, width), dtype=torch.float32,
                          device=resolve_device(device)),
        depth=depth, width=width)


def _cms_flat(state: CountMinSketch, series_ids, h1, h2) -> torch.Tensor:
    """[n, d] flat table indices from two uint32 hashes (int64 lanes)."""
    dev = state.table.device
    h1, h2 = u32_on(h1, dev)[:, None], u32_on(h2, dev)[:, None]
    i = torch.arange(state.depth, dtype=torch.int64, device=dev)[None, :]
    cols = ((h1 + i * h2) & 0xFFFFFFFF) & (state.width - 1)
    sids = torch.as_tensor(series_ids, device=dev).to(torch.int64)
    return (sids[:, None] * state.depth + i) * state.width + cols


def cms_update(state: CountMinSketch, series_ids, h1, h2, counts=None,
               mask=None) -> CountMinSketch:
    """Add each observation at its `depth` hashed columns, in place; a
    masked observation adds zero to row 0, ids outside [0, S) drop."""
    dev = state.table.device
    sids = torch.as_tensor(series_ids, device=dev).to(torch.int64)
    n = sids.shape[0]
    w = torch.ones(n, dtype=torch.float32, device=dev) if counts is None \
        else torch.as_tensor(counts, dtype=torch.float32, device=dev)
    keep = (sids >= 0) & (sids < state.table.shape[0])
    if mask is not None:
        m = torch.as_tensor(mask, device=dev)
        w = torch.where(m, w, torch.zeros((), device=dev))
        sids = torch.where(m, sids, 0)
        keep = (sids >= 0) & (sids < state.table.shape[0])
    flat = _cms_flat(state, torch.where(keep, sids, 0), h1, h2)
    add = torch.where(keep, w, torch.zeros((), device=dev))
    state.table.view(-1).index_add_(
        0, flat.reshape(-1), add[:, None].expand(n, state.depth).reshape(-1))
    return state


def cms_merge(a: CountMinSketch, b: CountMinSketch) -> CountMinSketch:
    _merge_check("cms_merge", ("depth", a.depth, "width", a.width),
                 ("depth", b.depth, "width", b.width),
                 tuple(a.table.shape), tuple(b.table.shape))
    return dataclasses.replace(a, table=a.table + b.table)


def cms_estimate(state: CountMinSketch, series_ids, h1, h2) -> torch.Tensor:
    """Point frequency estimates, [n] f32 (min over depth rows)."""
    flat = _cms_flat(state, series_ids, h1, h2)
    return state.table.reshape(-1)[flat].amin(dim=-1)


__all__ = ["Log2Histogram", "NUM_LOG2_BUCKETS", "log2_bucket",
           "log2_hist_init", "log2_hist_update", "log2_hist_merge",
           "log2_quantile", "DDSketch", "dd_params", "dd_init", "dd_update",
           "dd_merge", "dd_quantile", "dd_value_table", "_merge_check",
           "HyperLogLog", "hll_init", "hll_update", "hll_merge",
           "hll_estimate", "CountMinSketch", "cms_init", "cms_update",
           "cms_merge", "cms_estimate", "dd_place"]
