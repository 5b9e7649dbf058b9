"""Moments sketch: ~15-float mergeable quantiles per series.

Counterpart of `tempo_tpu/ops/moments.py` (Gan et al., "Moment-Based
Quantile Sketches"). A row holds

    data[S, k+3]
      col 0        weighted count  Σ w
      col 1..k     Chebyshev-basis log-moment sums  Σ w·T_i(s),
                   s = clip((log x − c) / h, −1, 1) over the static
                   domain [lo, hi] = [log min_value, log max_value],
                   c = (lo+hi)/2, h = (hi−lo)/2
      col k+1      running max of (log x − lo)  (≥ 0)  → data max bound
      col k+2      running max of (hi − log x)  (≥ 0)  → data min bound

Counts and sums merge by ADD, the two bound columns by MAX; a zero row is
the empty sketch.

The device half (basis, update, zeroing) is torch; on the paged write
path the basis is computed inside the paged fused update
(`ops.cuda_kernels.paged_fused_update`), whose plain version calls
`moments_basis` here. The host half — the maximum-entropy solver that
turns a row into quantiles — is numpy in f64, a copy of the reference's
(`_newton`, `_solve_cdf`, `solve_quantiles`, `quantiles_for_rows`, the
per-row solution cache and its counters), so the same row gives the same
quantiles in both packages.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ops.pages import DENSE_PAGE_ROWS, dense_zeros

DEFAULT_K = 12


def n_cols(k: int) -> int:
    """Row width of a k-moment sketch: count + k sums + 2 bounds."""
    return k + 3


# ---------------------------------------------------------------------------
# device sketch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MomentsSketch:
    """Per-series moment rows: data[S, k+3] f32 (see module docstring)."""

    data: torch.Tensor
    k: int
    lo: float
    hi: float


def moments_params(k: int = DEFAULT_K, min_value: float = 1e-6,
                   max_value: float = 1e5) -> tuple[int, float, float]:
    if not (0 < min_value < max_value):
        raise ValueError(
            f"moments domain needs 0 < min_value ({min_value}) < "
            f"max_value ({max_value})")
    return int(k), math.log(min_value), math.log(max_value)


def moments_init(num_series: int, k: int = DEFAULT_K, min_value: float = 1e-6,
                 max_value: float = 1e5, device=None,
                 page_rows: int = DENSE_PAGE_ROWS) -> MomentsSketch:
    """Empty rows on `device` (`cuda` unless `"cpu"` is asked for), a row
    view of a trash-paged arena (`ops.pages.dense_zeros`)."""
    k, lo, hi = moments_params(k, min_value, max_value)
    return MomentsSketch(
        data=dense_zeros(num_series, n_cols(k), page_rows=page_rows,
                         device=resolve_device(device)), k=k, lo=lo, hi=hi)


def chebyshev_basis(s, k: int) -> list:
    """T_0..T_k of s (torch on the device, numpy in the solver), by the
    recurrence T_j = (2·s)·T_{j-1} − T_{j-2}. Returns k+1 arrays shaped
    like `s`."""
    out = [torch.ones_like(s) if isinstance(s, torch.Tensor)
           else np.ones_like(s)]
    if k >= 1:
        out.append(s)
    for _ in range(2, k + 1):
        out.append(2.0 * s * out[-1] - out[-2])
    return out


def basis_constants(lo: float, hi: float) -> tuple[float, float, float, float]:
    """(exp(lo), exp(hi), c, h) in Python double; each becomes f32 where
    it meets an f32 tensor, as the reference's weak-typed constants do."""
    return math.exp(lo), math.exp(hi), (lo + hi) / 2.0, (hi - lo) / 2.0


def moments_basis(values: torch.Tensor, k: int, lo: float, hi: float):
    """(z, basis[n, k+1]) for raw positive f32 values: z = clipped log,
    the columns [1, T_1(s), ..., T_k(s)]. The constants are f32 device
    tensors: CUDA division by a host scalar multiplies by its reciprocal,
    which is not IEEE division."""
    v = torch.as_tensor(values, dtype=torch.float32)
    vmin, vmax, c, h = basis_constants(lo, hi)
    f32 = dict(dtype=torch.float32, device=v.device)
    z = torch.log(torch.clamp(v, torch.tensor(vmin, **f32),
                              torch.tensor(vmax, **f32)))
    s = torch.clamp((z - torch.tensor(c, **f32)) / torch.tensor(h, **f32),
                    -1.0, 1.0)
    return z, torch.stack(chebyshev_basis(s, k), dim=-1)


def moments_update(state: MomentsSketch, series_ids, values, mask=None,
                   weights=None) -> MomentsSketch:
    """Scatter a batch of observations into per-series rows, in place.
    Negative (or masked) ids drop. Weights scale the count and every
    moment sum; the bound columns take the unweighted value."""
    k, data = state.k, state.data
    dev = data.device
    sids = torch.as_tensor(series_ids, device=dev).to(torch.int64)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    w = torch.ones_like(v) if weights is None \
        else torch.as_tensor(weights, dtype=torch.float32, device=dev)
    keep = (sids >= 0) & (sids < data.shape[0])
    if mask is not None:
        keep &= torch.as_tensor(mask, device=dev)
    moments_scatter(data, sids, keep, v, w, k, state.lo, state.hi)
    return state


def moments_scatter(data: torch.Tensor, rows: torch.Tensor,
                    keep: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    k: int, lo: float, hi: float) -> None:
    """Add the observations `v` (weights `w`) of the kept spans into the
    moments rows `rows` of `data` [R, k+3], in place: the count and the
    Chebyshev log-moment sums add into columns 0..k, the two shifted
    bound columns take the max, unweighted. No boolean selection: a
    dropped span adds and maxes zero into row 0."""
    from tempo_tpu_torch.ops.pages import add_cells, max_rows

    dev = data.device
    z, basis = moments_basis(v, k, lo, hi)
    add_cells(data, rows, torch.arange(k + 1, device=dev), keep,
              basis * w[:, None])
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros((), **f32)
    max_rows(data[:, k + 1], rows, keep,
             torch.maximum(z - torch.tensor(lo, **f32), zero))
    max_rows(data[:, k + 2], rows, keep,
             torch.maximum(torch.tensor(hi, **f32) - z, zero))


def merge_meta_check(a: MomentsSketch, b: MomentsSketch) -> None:
    if (a.k, a.lo, a.hi) != (b.k, b.lo, b.hi) or \
            tuple(a.data.shape) != tuple(b.data.shape):
        raise ValueError(
            "moments_merge: incompatible sketches "
            f"(k={a.k}/{b.k}, lo={a.lo:.6g}/{b.lo:.6g}, "
            f"hi={a.hi:.6g}/{b.hi:.6g}, "
            f"shape={tuple(a.data.shape)}/{tuple(b.data.shape)})")


def moments_merge(a: MomentsSketch, b: MomentsSketch) -> MomentsSketch:
    """Combine: ADD for the count and moment sums, MAX for the two bound
    columns (the cross-shard merge)."""
    merge_meta_check(a, b)
    k = a.k
    return dataclasses.replace(a, data=torch.cat(
        [a.data[..., :k + 1] + b.data[..., :k + 1],
         torch.maximum(a.data[..., k + 1:], b.data[..., k + 1:])], dim=-1))


def moments_merge_rows(a: np.ndarray, b: np.ndarray, k: int) -> np.ndarray:
    """Host-side row merge (frontend combine, sidecar folds): [.., k+3]
    f64 rows; sums add, the two bound columns take the max."""
    out = a + b
    out[..., k + 1:] = np.maximum(a[..., k + 1:], b[..., k + 1:])
    return out


def moments_merge_into(data: torch.Tensor, rows: torch.Tensor,
                       vals: torch.Tensor, k: int) -> None:
    """Merge moments rows `vals` [n, k+3] into `data` at the distinct
    physical rows `rows` (int64), in place on `data`'s device: the count
    and sums add (`index_add_`), the two bound columns take the max
    (`scatter_reduce_` amax) — the cross-shard combine, as a restore."""
    data[:, :k + 1].index_add_(0, rows, vals[:, :k + 1])
    bounds = vals[:, k + 1:]
    data[:, k + 1:].scatter_reduce_(0, rows[:, None].expand_as(bounds),
                                    bounds, "amax", include_self=True)


def moments_zero_slots(state: MomentsSketch, slots) -> MomentsSketch:
    """Zero evicted slots' rows in place (ids outside the plane drop)."""
    s = torch.as_tensor(slots, device=state.data.device).to(torch.int64)
    state.data[s[(s >= 0) & (s < state.data.shape[0])]] = 0.0
    return state


# ---------------------------------------------------------------------------
# host solver: maximum-entropy quantiles from one moment row
# ---------------------------------------------------------------------------

_GRID = 512          # quadrature points over the data support
_MAX_ITER = 40
_CACHE_MAX = 4096
_NOISE_FLOOR = 1e-6  # f32 moment accumulation noise (order-cap input)

_stats_lock = threading.Lock()
solves_total = 0
fallbacks_total = 0
cache_hits_total = 0
solve_seconds_total = 0.0

_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()


def reset_solver_cache() -> None:
    """Drop the solution cache and zero the solve counters."""
    global solves_total, fallbacks_total, cache_hits_total
    global solve_seconds_total
    with _stats_lock:
        _CACHE.clear()
        solves_total = fallbacks_total = cache_hits_total = 0
        solve_seconds_total = 0.0


def _newton(T: np.ndarray, w: np.ndarray, mu: np.ndarray,
            lam0: np.ndarray) -> tuple[np.ndarray, bool]:
    """Damped Newton on the maxent dual; returns (λ, converged)."""
    lam = lam0.copy()

    def dual(l):
        return float(np.sum(np.exp(np.minimum(T.T @ l, 500.0)) * w)
                     - l @ mu)

    g = None
    for _ in range(_MAX_ITER):
        p = np.exp(np.minimum(T.T @ lam, 500.0))
        pw = p * w
        g = T @ pw - mu
        if np.max(np.abs(g)) < 1e-8:
            return lam, True
        H = (T * pw) @ T.T
        try:
            d = np.linalg.lstsq(H, g, rcond=1e-12)[0]
        except np.linalg.LinAlgError:
            return lam, False
        f0 = dual(lam)
        step, stepped = 1.0, False
        while step > 1e-7:
            cand = lam - step * d
            if dual(cand) < f0 - 1e-14:
                lam, stepped = cand, True
                break
            step *= 0.5
        if not stepped:
            break
    return lam, bool(g is not None and np.max(np.abs(g)) < 1e-4)


def _solve_cdf(vec: np.ndarray, k: int, lo: float, hi: float):
    """One moment row [k+3] → (s_grid, cdf, c, h) or None (no converged
    order). Degenerate supports return a point CDF."""
    n = float(vec[0])
    if n <= 0:
        return None
    c, h = (lo + hi) / 2.0, (hi - lo) / 2.0
    zmax = lo + max(float(vec[k + 1]), 0.0)
    zmin = hi - max(float(vec[k + 2]), 0.0)
    zmin, zmax = max(min(zmin, zmax), lo), min(max(zmin, zmax), hi)
    smin, smax = (zmin - c) / h, (zmax - c) / h
    if smax - smin < 1e-7:
        s0 = (smin + smax) / 2.0
        return (np.array([s0, s0]), np.array([0.0, 1.0]), c, h)
    pad = 0.005 * (smax - smin)
    a, b = smin - pad, smax + pad
    s = np.linspace(a, b, _GRID)
    w = np.full(_GRID, (b - a) / (_GRID - 1))
    w[0] *= 0.5
    w[-1] *= 0.5
    # noise-floor order cap: trust only the moments whose
    # support-localized signal r^j clears the f32 noise floor
    r = max((smax - smin) / 2.0, 1e-9)
    if r >= 1.0:
        k_eff = k
    else:
        j = int(math.log(_NOISE_FLOOR) / math.log(r))
        k_eff = max(2, min(k, j - (j % 2)))
    T = np.stack(chebyshev_basis(s, k_eff))       # [k_eff+1, grid]
    mu = np.asarray(vec[:k_eff + 1], np.float64) / n
    mu[0] = 1.0
    lam = np.zeros(k_eff + 1)
    lam[0] = -math.log(b - a)
    converged = False
    # warm-started order escalation: the order-2 fit (≈ lognormal) is
    # the safety net; each further pair of moments refines it
    for kk in range(2, k_eff + 1, 2):
        lam_kk, ok = _newton(T[:kk + 1], w, mu[:kk + 1], lam[:kk + 1])
        if not ok:
            break
        lam[:kk + 1] = lam_kk
        lam[kk + 1:] = 0.0
        converged = True
    if not converged:
        return None
    p = np.exp(np.minimum(T.T @ lam, 500.0)) * w
    cdf = np.cumsum(p)
    tot = cdf[-1]
    if not np.isfinite(tot) or tot <= 0:
        return None
    return (s, cdf / tot, c, h)


def solve_quantiles(vec: np.ndarray, k: int, lo: float, hi: float,
                    qs) -> "np.ndarray | None":
    """Quantile values for every q in `qs` from one moment row [k+3],
    all read off one solved CDF (monotone in q). None when the solver
    failed or the row is empty."""
    global solves_total, fallbacks_total, cache_hits_total
    global solve_seconds_total
    row = np.asarray(vec, np.float64)
    if row[0] <= 0:
        return None
    key = (int(k), float(lo), float(hi), row.tobytes())
    with _stats_lock:
        got = _CACHE.get(key)
        if got is not None:
            _CACHE.move_to_end(key)
            cache_hits_total += 1
    if got is None:
        t0 = time.perf_counter()
        got = _solve_cdf(row, k, lo, hi)
        dt = time.perf_counter() - t0
        with _stats_lock:
            solves_total += 1
            solve_seconds_total += dt
            if got is None:
                fallbacks_total += 1
            else:
                _CACHE[key] = got
                while len(_CACHE) > _CACHE_MAX:
                    _CACHE.popitem(last=False)
    if got is None:
        return None
    s, cdf, c, h = got
    zq = np.interp(np.asarray(qs, np.float64), cdf, s) * h + c
    return np.exp(zq)


def quantiles_for_rows(rows: np.ndarray, k: int, lo: float, hi: float,
                       qs) -> tuple[np.ndarray, np.ndarray]:
    """Batched solve: rows [m, k+3] → (values [m, len(qs)], failed [m]).
    Failed rows get NaN; empty rows (count 0) are not failures and read
    0.0."""
    rows = np.asarray(rows, np.float64)
    m = rows.shape[0]
    out = np.zeros((m, len(qs)), np.float64)
    failed = np.zeros(m, bool)
    for i in range(m):
        if rows[i, 0] <= 0:
            continue
        vals = solve_quantiles(rows[i], k, lo, hi, qs)
        if vals is None:
            failed[i] = True
            out[i] = np.nan
        else:
            out[i] = vals
    return out, failed


# ---------------------------------------------------------------------------
# TraceQL query tier (reference `tempo_tpu/ops/moments.py:88-90,417-447`)
# ---------------------------------------------------------------------------

# quantile_over_time domain: raw values clamped to [1, 1e14] (nanoseconds:
# 1ns .. ~28h), mirroring log2_bucket_np's max(v, 1) clamp and the
# 64-bucket grid's 2^63-ish ceiling
QUERY_K = 12
QUERY_LO = 0.0
QUERY_HI = math.log(1e14)

_query_tier = "log2"


def set_query_tier(tier: str) -> None:
    """Select the quantile_over_time accumulation axis: "log2" (the
    [series, steps, 64] bucket grid, the default) or "moments" ([series,
    steps, k+1] moment grids + bound planes). Process-wide."""
    global _query_tier
    _query_tier = "moments" if tier == "moments" else "log2"


def query_moments_active() -> bool:
    return _query_tier == "moments"


class use_query_tier:
    """Install a query tier for a with-block (tests, smoke phases)."""

    def __init__(self, tier: str) -> None:
        self.tier = tier
        self._prev = "log2"

    def __enter__(self):
        global _query_tier
        self._prev = _query_tier
        set_query_tier(self.tier)
        return self

    def __exit__(self, *exc) -> None:
        global _query_tier
        _query_tier = self._prev


def moments_place(state: MomentsSketch, device,
                  page_rows: int) -> MomentsSketch:
    """Place the plane for the serving mesh: its rows as a row view of a
    trash-paged arena on `device` (series shards take row windows of
    it). Idempotent."""
    from tempo_tpu_torch.ops.pages import place_view

    return dataclasses.replace(
        state, data=place_view(state.data, device, page_rows))


# ---------------------------------------------------------------------------
# obs: moments-solver families in the process-wide runtime registry
# ---------------------------------------------------------------------------

from tempo_tpu_torch.obs.runtime import RUNTIME  # noqa: E402

RUNTIME.counter_func(
    "tempo_moments_solves_total",
    lambda: [((), float(solves_total))],
    help="Maximum-entropy solves of moments-sketch rows (cache misses; "
         "steady-state collects re-solve only changed series)")
RUNTIME.counter_func(
    "tempo_moments_solver_fallback_total",
    lambda: [((), float(fallbacks_total))],
    help="Moments-sketch solves that failed to converge at every order "
         "— the caller served its bucket-sketch fallback instead. "
         "Nonzero in steady state means the tier is misconfigured for "
         "this workload (runbook 'Choosing a quantile sketch tier')")
RUNTIME.counter_func(
    "tempo_moments_solve_cache_hits_total",
    lambda: [((), float(cache_hits_total))],
    help="Moments quantile reads served from the per-row solution cache")
RUNTIME.counter_func(
    "tempo_moments_solve_seconds_total",
    lambda: [((), float(solve_seconds_total))],
    help="Host wall seconds spent in the maxent quantile solver")


__all__ = ["MomentsSketch", "moments_params", "moments_init",
           "moments_update", "moments_merge", "moments_merge_rows",
           "moments_zero_slots",
           "moments_basis",
           "basis_constants", "chebyshev_basis", "merge_meta_check",
           "solve_quantiles", "quantiles_for_rows", "reset_solver_cache",
           "n_cols", "DEFAULT_K", "QUERY_K", "QUERY_LO", "QUERY_HI",
           "set_query_tier", "query_moments_active", "use_query_tier",
           "moments_place"]
