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
   after: seeded OTLP payloads of 16,384 spans (4 on the two paged paths,
   8 on the dense one) → `otlp_proto_to_batch` →
   `GeneratorInstance.push_batch` → `collect_and_push()` to a local
   remote-write receiver → quantiles;
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
   each sent 16 pushes of 1,024 seeded trace-tree spans (client/server
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
   and device time.

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
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
N_SPANS = 16384
N_DISPATCH = 8
N_PAGED_PUSHES = 4               # the two paged main paths (phase 4a, 4b)
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


def profiled_device_ms(fn, runs, kernel_names=None, by_name=None):
    """Mean device time per call from torch.profiler's CUPTI trace: the
    device events (kernels, memsets) whose name contains one of
    `kernel_names`, or all of them when None; None when the trace shows
    no device time. `by_name`, a dict, receives every device event's mean
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
        if kernel_names is None or any(n in ev.key for n in kernel_names):
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
                  page_rows=PAGE_ROWS):
    """Kernel arenas vs plain arenas: `sum_roles` at rtol 1e-5 / atol 1e-6,
    `tol_roles` {role: check(k, p) -> bool}, the rest exact; page 0 zero;
    every arena updated. Returns the max abs error."""
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
        if torch.equal(k, base[r]):
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
    device_ms = profiled_device_ms(calls["fused_step"], N_TIMED,
                                   ["pfu_span_kernel"])
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
    events = {}
    device_ms = profiled_device_ms(calls["fused_step"], N_TIMED,
                                   by_name=events)
    memsets = [k for k in events if "emset" in k]
    if memsets:
        raise AssertionError(f"phase 5: compact K1 runs memsets {memsets}")
    split = {name: sum(t for k, t in events.items() if name in k)
             for name in ("pfu_span_kernel", "pfu_fold_kernel")}
    print(f"phase 5: compact K1 device time per dispatch {device_ms} ms, of "
          f"which span pass {split['pfu_span_kernel']} ms and fold "
          f"{split['pfu_fold_kernel']} ms; every device event per dispatch: "
          f"{json.dumps(events)}")
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
    both_ms = _device_ms(lambda: step(k_ar, b_dev[0]))
    # sketch: dd (the dense main path's tier): 7 roles, the same push
    t7, skw7 = t_dev[:7], dict(skw, mom_rows=0, mom_meta=None)
    kw7 = dict(skw7, page_rows=pr)
    b0 = b_dev[0]
    calls = k1_calls(t7, b0, k_ar[:7], kw7)
    times = {how: (cuda_time_ms(calls[how], N_TIMED), host_ms(calls[how]))
             for how in ("fused_step", "sliced")}
    plain_ms = cuda_time_ms(lambda: ck.paged_fused_update_plain(
        t7, b0[0], b0[1:4], p_ar[:7], **kw7), N_TIMED)
    device_ms = _device_ms(calls["fused_step"])
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
    print(f"phase 5: dense K1, sketch both (8 roles, tables staged): device "
          f"time per push {both_ms} ms; the composed twin (sketch dd): "
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


def _instances(rx, now, sm, names, paged=True):
    """One generator instance per (name, device), each on its own pool
    (`paged`) or on dense state, remote-writing to `rx` under /<name>."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.generator.remote_write import RemoteWriteConfig
    from tempo_tpu_torch.registry import pages

    insts = {}
    for name, device in names:
        pool = pages.PagePool(tt.PagePoolConfig(enabled=True), device=device) \
            if paged else None
        with pages.use(pool):
            insts[name] = tt.GeneratorInstance(
                "smoke", tt.GeneratorConfig(
                    processors=("span-metrics",),
                    spanmetrics=tt.SpanMetricsConfig(**sm),
                    remote_write=RemoteWriteConfig(url=f"{rx.url}/{name}")),
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


def _compare_samples(rx, compact, ctx):
    """The card's WriteRequest against the host's: counts exact, the size
    counter at rtol 1e-5, the latency `_sum` at rtol 1e-5 (f32) or 1e-2
    (folded from the bf16 pair under compact). Returns (label sets,
    calls total)."""
    from tempo_tpu_torch.generator.remote_write import decode_write_request

    bodies = rx.bodies
    card, host = bodies.get(f"/{ctx}-card"), bodies.get(f"/{ctx}-host")
    if not card or not host:
        raise AssertionError(f"{ctx}: remote write received {list(bodies)}")
    gpu, cpu = decode_write_request(card), decode_write_request(host)
    if not gpu or set(gpu) != set(cpu):
        raise AssertionError(f"{ctx}: card and host wrote different series sets")
    for k, vs in gpu.items():
        labels = dict(k)
        for i, (v, h) in enumerate(zip(vs, cpu[k], strict=True)):
            # float sums: the size counter and the latency `_sum` (second
            # sample of a bucketless latency label set); the rest count
            size = labels["__name__"] == "traces_spanmetrics_size_total"
            lat_sum = labels["__name__"] == "traces_spanmetrics_latency" \
                and "le" not in labels and i == 1
            if lat_sum and compact:
                ok = abs(v - h) <= 1e-2 * abs(h) + 1e-6
            elif size or lat_sum:
                ok = abs(v - h) <= 1e-5 * abs(h) + 1e-6
            else:
                ok = v == h
            if not ok:
                raise AssertionError(f"{ctx} sample {k}[{i}]: card {v} vs host {h}")
    total = sum(v[0] for k, v in gpu.items()
                if dict(k)["__name__"] == "traces_spanmetrics_calls_total")
    return len(gpu), total


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
    pool, on dense state. Returns a result dict."""
    import torch

    from tempo_tpu_torch.generator.remote_write import LocalReceiver
    from tempo_tpu_torch.ops import cuda_kernels as ck

    compact = tier == "both_compact"
    sm = dict(sketch="both", compact_state=True) if compact else {}
    paged = not tier.startswith("dense")
    now = time.time()
    payloads, sizes, int_w, dyadic_w = _payloads(now, n_payloads)
    weights = dyadic_w if compact else int_w
    res = {}
    with LocalReceiver() as rx:
        names = ((f"{tier}-card", "cuda"), (f"{tier}-host", "cpu"))
        insts = _instances(rx, now, sm, names, paged=paged)
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
            n_samples = inst.collect_and_push()
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
                  f"{res[name]['series']} series; collect_and_push "
                  f"{n_samples} samples in {collect_s:.3f} s; DDSketch "
                  f"q50+q99 in {dd_s:.3f} s"
                  + (f"; moments q50+q99 in {mom_s:.3f} s" if compact else ""))
        n_sets, total = _compare_samples(rx, compact, tier)
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
          f"WriteRequest equal the host's under the stated tolerances; calls "
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

N_TENANTS, N_TREE_PUSHES, N_TREE_SPANS, N_PRODUCERS = 8, 16, 1024, 2
SCHED_KERNEL = "spanmetrics_fused_update"


def _tree_traffic(now_ns):
    """Per tenant, 16 OTLP payloads of 1,024 trace-tree spans (32 services
    x 32 operations), with per-span sizes of 200-2,000 B and integer
    sample weights 1-3."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    rng = np.random.default_rng(SEED + 6)
    return [[(encode_spans_otlp(trace_tree_spans(
        N_TREE_SPANS, seed=SEED + 100 * t + k, now_ns=now_ns)),
        rng.integers(200, 2001, N_TREE_SPANS).astype(np.float32),
        rng.integers(1, 4, N_TREE_SPANS).astype(np.float32))
        for k in range(N_TREE_PUSHES)] for t in range(N_TENANTS)]


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
            for k0 in range(0, N_TREE_PUSHES, 4):
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
    twin's on the card: the same series in the same slots, every family's
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
            if not (np.array_equal(fa.table.active, fb.table.active) and
                    np.array_equal(fa.table.slot_keys, fb.table.slot_keys)):
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


def _k1_on_window(proc, mat, ctx):
    """K1 at a merged window's shape on a copy of the processor's state:
    held against its plain version on the card, timed through the main
    path's call (`ops.pages.fused_step`, the window already on the card)
    and as the scheduler's dispatch makes it (host matrix → card, then
    K1), with device times from torch.profiler and its bound."""
    import torch

    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.ops import pages as op

    skw = proc._step_kw
    with proc.registry.state_lock:
        if proc._paged:
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
    max_abs = _check_planes(k_ar, p_ar, base, (1, 3), {}, ctx, page_rows=pr)

    def k1():
        op.fused_step(k_ar, tables, b, page_shift=shift, **skw)

    def dispatch():
        op.fused_step(k_ar, tables, torch.from_numpy(mat).to("cuda"),
                      page_shift=shift, **skw)

    ms = cuda_time_ms(k1, N_TIMED)
    dispatch_ms = cuda_time_ms(dispatch, N_TIMED)
    plain_ms = cuda_time_ms(lambda: ck.paged_fused_update_plain(
        tables, b[0], b[1:4], p_ar, **kw), N_TIMED)
    # one trace of the dispatch gives both: every device event (the copy
    # and K1) and K1's own
    events = {}
    dispatch_device_ms = _device_ms(dispatch, events)
    device_ms = sum(t for name, t in events.items()
                    if "pfu_span_kernel" in name) or None
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
    traffic = _tree_traffic(int(now * 1e9))
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
    n_pushes = N_TENANTS * N_TREE_PUSHES
    spans = n_pushes * N_TREE_SPANS
    print(f"phase 6 {layout} [{card}]: {N_TENANTS} tenants x "
          f"{N_TREE_PUSHES} pushes of {N_TREE_SPANS} trace-tree spans "
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
          f"{k1['dispatch_device_ms']} ms ({json.dumps(k1['events'])}); plain "
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


def moments_state_bytes(n_payloads=N_DISPATCH):
    """Device state bytes per active series of the `sketch: moments` tier
    (f32 state) after the same pushes, on the card."""
    from tempo_tpu_torch.generator.remote_write import LocalReceiver

    now = time.time()
    payloads, sizes, int_w, _ = _payloads(now, n_payloads)
    with LocalReceiver() as rx:
        inst = _instances(rx, now, dict(sketch="moments"),
                          (("moments-card", "cuda"),))["moments-card"]
        _push_all(inst, payloads, sizes, int_w)
    return inst.device_state_bytes() / inst.registry.active_series


def main() -> int:
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
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build_all()                  # one nvcc per source, all together
    for src in ck.SOURCES:
        ck._lib(src)
    build_s = time.perf_counter() - t0
    for what, info in ck.BUILD_INFO.items():
        print(f"build: {what} in {info['seconds']:.2f} s -> "
              f"{os.path.relpath(info['path'], ROOT)}\n{info['log']}")
    print(f"build: {len(ck.BUILD_INFO)} builds in {build_s:.2f} s (one nvcc "
          f"each, together)")
    k1 = phase_k1_dd()
    n_probe, shifted = edge_probe_on_card()
    print(f"phase 3a edge probe: {shifted} of {n_probe} DDSketch edge "
          f"durations land one bucket apart between K1 (CUDA logf) and the "
          f"host (torch CPU log)")
    k1c = phase_k1_compact()
    k1d = phase_k1_dense()
    k2 = phase_k2("bench")
    k2d = phase_k2("deployment")
    dd = phase_main_path("dd", N_PAGED_PUSHES)
    bc = phase_main_path("both_compact", N_PAGED_PUSHES)
    dn = phase_main_path("dense_dd")
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
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in (k1, k1c, k1d, k2, k2d, *s6)]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
