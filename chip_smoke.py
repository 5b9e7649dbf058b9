#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`tempo_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, all on `cuda`, at the repository's default deployment widths
(max_active_series 65,536, DDSketch 1,269 buckets and a 12-moment row
over 16,384 series, 15 latency buckets, page pool of 256-row pages and
131,072 usable rows per role arena):

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
4. the main paths through the entry points, each on the card against the
   same path on the host (plain versions), with kernel launch counts
   zeroed just before and read just after: seeded OTLP payloads →
   `otlp_proto_to_batch` → `GeneratorInstance.push_batch` →
   `collect_and_push()` to a local remote-write receiver → quantiles;
   a. `sketch: dd` with f32 state (quantiles exactly equal);
   b. `sketch: both` with compact state (DDSketch quantiles exactly
      equal, every series' moments row within the moments tolerance of
      phase 3b, moments quantiles compared and the series outside rtol
      1e-3 counted);
   K1's launch plans built on each card path (one: the processor's
   tables, arenas and scratch are the same tensors at every push); then
   device state bytes per active series of the dd-f32, both-compact and
   moments tiers, and the compact tier's scratch bytes (working memory,
   not state);
5. times: per-dispatch kernel and plain times (CUDA events, min /
   median / max of 30); K1 timed two ways side by side, through the call
   the main path makes (`ops.pages.fused_step` on the packed [4, N]
   batch) and through the wrapper with the batch sliced on each call
   (the yardstick of K1's earlier times in PERF.md); K1's host time per call (1,000 calls with no
   synchronisation) both ways, and K2's at both shapes; device time
   (torch.profiler: K1 by kernel, K2 every device event of the call);
   the least time the card could take, the library yardstick where one
   exists (`index_add_` for K2, at both shapes), and end-to-end spans/s.

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


def touched_cells(mat, tables, *, dd_rows, nb, edges, mom_rows=0):
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
    lp = slots >> PAGE_SHIFT
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
        rows = (phys.astype(np.int64) << PAGE_SHIFT) | (slots & (PAGE_ROWS - 1))
        rows = rows[keep]
        if r == 4:
            rows = rows * (len(edges) + 1) + hb[keep]
        elif r == 6 and not is_mom:
            rows = rows * nb + ddi[keep]
        out[r] = np.unique(rows).size * ((MOM_K + 3) if is_mom else 1)
    return out


def bound_bytes(mat, tables, *, dd_rows, nb, edges, mom_rows=0, compact=False):
    """Bytes K1 must move for this batch: the batch and the tables read
    once; every distinct touched arena cell read and written once (4 B
    each; a touched moments row is its k+3 cells); under compact, every
    row of every backed page of the latency-sum pair read and written
    (4 B), since the fold re-normalises each of them."""
    cells = touched_cells(mat, tables, dd_rows=dd_rows, nb=nb, edges=edges,
                          mom_rows=mom_rows)
    nbytes = mat.nbytes + tables.nbytes + 2 * 4 * sum(
        k for r, k in cells.items() if not (compact and r == 1))
    if compact:
        nbytes += 2 * 4 * int((tables[1] > 0).sum()) * PAGE_ROWS
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


def _check_planes(k_ar, p_ar, base, sum_roles, tol_roles, ctx):
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
        if bool(k[:PAGE_ROWS].any()):
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

    step_kw = dict(kw, page_shift=PAGE_SHIFT)
    del step_kw["page_rows"]
    return {
        "fused_step": lambda: op.fused_step(arenas, t_dev, b, **step_kw,
                                            **extra),
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


def _instances(rx, now, sm, names):
    """One generator instance per (name, device), each on its own pool,
    remote-writing to `rx` under /<name>."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.generator.remote_write import RemoteWriteConfig
    from tempo_tpu_torch.registry import pages

    insts = {}
    for name, device in names:
        pool = pages.PagePool(tt.PagePoolConfig(enabled=True), device=device)
        with pages.use(pool):
            insts[name] = tt.GeneratorInstance(
                "smoke", tt.GeneratorConfig(
                    spanmetrics=tt.SpanMetricsConfig(**sm),
                    remote_write=RemoteWriteConfig(url=f"{rx.url}/{name}")),
                now=lambda: now, device=device)
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
    outside rtol 1e-3 counted. Returns a result dict."""
    import torch

    from tempo_tpu_torch.generator.remote_write import LocalReceiver
    from tempo_tpu_torch.ops import cuda_kernels as ck

    compact = tier == "both_compact"
    sm = dict(sketch="both", compact_state=True) if compact else {}
    now = time.time()
    payloads, sizes, int_w, dyadic_w = _payloads(now, n_payloads)
    weights = dyadic_w if compact else int_w
    res = {}
    with LocalReceiver() as rx:
        names = ((f"{tier}-card", "cuda"), (f"{tier}-host", "cpu"))
        insts = _instances(rx, now, sm, names)
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
            "spans_per_s": len(payloads) * N_SPANS / card["push_s"],
            "bytes_per_series": card["state_bytes"] / card["series"],
            "series": card["series"], "outside": outside}


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
    k2 = phase_k2("bench")
    k2d = phase_k2("deployment")
    dd = phase_main_path("dd")
    bc = phase_main_path("both_compact")
    k1["launches"], k1c["launches"] = dd["launches"], bc["launches"]
    mom_bytes = moments_state_bytes()
    print(f"phase 4 [{card}]: device state bytes per active series: "
          f"dd f32 {dd['bytes_per_series']:.1f} ({dd['series']} series), "
          f"both compact {bc['bytes_per_series']:.1f}, moments f32 "
          f"{mom_bytes:.1f}")
    floor = host_floor_ms()
    for k in (k1, k1c, k2, k2d):
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
    for tier, r in (("dd f32", dd), ("both compact", bc)):
        print(f"phase 5 [{card}]: end to end {tier} {r['spans_per_s']:.0f} "
              f"spans/s (decode + push of {N_DISPATCH} x {N_SPANS} spans in "
              f"{r['push_s']:.3f} s)")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in (k1, k1c, k2, k2d)]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
