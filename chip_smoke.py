#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`tempo_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, all on `cuda`, at the repository's default deployment widths
(max_active_series 65,536, DDSketch 1,269 buckets over 16,384 series,
15 latency buckets, page pool of 256-row pages and 131,072 usable rows
per role arena):

1. the card's name and power limit (nvidia-smi);
2. build of every kernel of the path from `tempo_tpu_torch/csrc`;
3. each kernel against its plain PyTorch version on the card, on copies
   of the same arenas over 8 dispatches of 16,384 spans; then K1 on
   durations placed on the DDSketch bucket edges, against the host;
4. the main path through the entry points: seeded OTLP payloads →
   `otlp_proto_to_batch` → `GeneratorInstance.push_batch` on the card →
   `collect_and_push()` to a local remote-write receiver → `quantile()`,
   with per-span sizes and sample weights, held against the same path
   on the host (plain versions; quantiles exactly equal); kernel
   launch counts are zeroed just before and read just after;
5. times: per-dispatch kernel and plain times (CUDA events, median),
   the least time the card could take, and end-to-end spans/s.

The last line is `{"ok": true, "device": {...}}`; any failed check
raises and the script exits non-zero without it. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

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


def touched_bytes(mat, tables, page_shift, dd_rows, nb, edges, gamma, minv):
    """Bytes the fused update must move for this batch: the batch and the
    tables read once, and every distinct touched arena cell read and
    written once."""
    import torch

    from tempo_tpu_torch.ops.pages import dd_index, hist_bucket

    slots = mat[0].astype(np.int64)
    dur = torch.from_numpy(mat[1].copy())
    hb = hist_bucket(dur, edges).numpy()
    ddi = dd_index(dur, gamma, minv, nb).numpy()
    zero = mat[1] <= np.float32(minv)
    lp = slots >> page_shift
    ok = (slots >= 0) & (lp < tables.shape[1])
    cells = 0
    for r in range(tables.shape[0]):
        phys = np.where(ok, tables[r][np.clip(lp, 0, tables.shape[1] - 1)], -1)
        keep = phys > 0
        if r >= 5:
            keep &= slots < dd_rows
            keep &= zero if r == 5 else ~zero
        rows = (phys.astype(np.int64) << page_shift) | (slots & ((1 << page_shift) - 1))
        rows = rows[keep]
        if r == 4:
            rows = rows * (len(edges) + 1) + hb[keep]
        elif r == 6:
            rows = rows * nb + ddi[keep]
        cells += np.unique(rows).size
    return mat.nbytes + tables.nbytes + 2 * 4 * cells


def cuda_time_ms(fn, runs):
    """Median per-call time from CUDA events, after three warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled_device_ms(fn, runs, kernel_name):
    """Mean device time per launch of `kernel_name` from torch.profiler's
    CUPTI trace, or None when the trace shows no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel_name in ev.key and ev.count:
            total = getattr(ev, "device_time_total", 0) or \
                getattr(ev, "cuda_time_total", 0)
            return total / ev.count / 1e3 if total else None
    return None


def phase_kernel_vs_plain(card):
    """Phase 3 (and the kernel times of phase 5): K1 vs its plain version
    on the card at full width."""
    import torch

    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.ops.sketches import dd_params
    from tempo_tpu_torch.registry.registry import DEFAULT_HISTOGRAM_EDGES

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    page_rows, page_shift = 256, 8
    n_series, dd_rows = 65536, 16384
    gamma, nb = dd_params(0.01, 1e-6, 1e5)
    edges = tuple(DEFAULT_HISTOGRAM_EDGES)
    n_pages = -(-131072 // page_rows) + 1          # + the trash page
    rows = n_pages * page_rows
    p_pages = n_series // page_rows
    tables = np.full((7, p_pages), -1, np.int32)
    for r in range(7):
        lps = p_pages if r < 5 else dd_rows // page_rows
        backed = rng.random(lps) < 0.75              # a quarter unbacked
        tables[r, :lps] = np.where(
            backed, rng.permutation(np.arange(1, n_pages))[:lps], -1)
    batches = []
    for _ in range(N_DISPATCH):
        mat = np.empty((4, N_SPANS), np.float32)
        mat[0] = zipf_slots(rng, N_SPANS, n_series)
        mat[1] = rng.lognormal(-3.0, 2.0, N_SPANS)
        mat[1, :64] = 0.0                            # DDSketch zero counts
        mat[2] = rng.integers(100, 5000, N_SPANS)
        mat[3] = rng.integers(1, 4, N_SPANS)
        batches.append(mat)
    print(f"phase 3: slots >= dd_rows: "
          f"{int((batches[0][0] >= dd_rows).sum())}, discards: "
          f"{int((batches[0][0] < 0).sum())}, backed pages per role: "
          f"{(tables > 0).sum(axis=1).tolist()}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(rows,)] * 4 + [(rows, len(edges) + 1), (rows,), (rows, nb)]
    base = []
    for shape in shapes:
        a = torch.randint(0, 4, shape, generator=gen, device=dev).float()
        a[:page_rows] = 0                            # the trash page
        base.append(a)
    t_dev = torch.from_numpy(tables).to(dev)
    b_dev = [torch.from_numpy(m).to(dev) for m in batches]
    kw = dict(page_rows=page_rows, edges=edges, gamma=gamma, min_value=1e-6,
              dd_rows=dd_rows)
    k_ar = [a.clone() for a in base]
    p_ar = [a.clone() for a in base]
    for b in b_dev:
        ck.paged_fused_update(t_dev, b[0], b[1:4], k_ar, **kw)
        ck.paged_fused_update_plain(t_dev, b[0], b[1:4], p_ar, **kw)
    torch.cuda.synchronize()
    max_abs = max_rel = 0.0
    for r, (k, p) in enumerate(zip(k_ar, p_ar)):
        diff = (k - p).abs()
        max_abs = max(max_abs, float(diff.max()))
        max_rel = max(max_rel, float((diff / p.abs().clamp_min(1e-30)).max()))
        if r in (1, 3):          # float sums: atomics add in no fixed order
            ok = torch.allclose(k, p, rtol=1e-5, atol=1e-6)
        else:                    # integer-count planes: exact
            ok = torch.equal(k, p)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"arena {r} (max abs {float(diff.max())})")
        if bool(k[:page_rows].any()):
            raise AssertionError(f"K1 wrote the trash page of arena {r}")
        if torch.equal(k, base[r]):
            raise AssertionError(f"arena {r} was not updated")
    print("phase 3 kernel-vs-plain: " + json.dumps({
        "name": "paged_fused_update", "launches": N_DISPATCH,
        "max_abs_err": max_abs, "max_rel_err": max_rel, "pass": True}))
    # phase 5 times, on the same full-width arenas and batch
    b0 = b_dev[0]
    ms = cuda_time_ms(lambda: ck.paged_fused_update(
        t_dev, b0[0], b0[1:4], k_ar, **kw), N_TIMED)
    plain_ms = cuda_time_ms(lambda: ck.paged_fused_update_plain(
        t_dev, b0[0], b0[1:4], p_ar, **kw), N_TIMED)
    device_ms = profiled_device_ms(lambda: ck.paged_fused_update(
        t_dev, b0[0], b0[1:4], k_ar, **kw), N_TIMED,
        "paged_fused_update_kernel")
    nbytes = touched_bytes(batches[0], tables, page_shift, dd_rows, nb, edges,
                           gamma, 1e-6)
    ops = N_SPANS * (40 + len(edges))   # translate, products, bucket search
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    del k_ar, p_ar, base
    torch.cuda.empty_cache()
    return {
        "name": "paged_fused_update", "route": "cuda",
        "source": "tempo_tpu_torch/csrc/paged_fused_update.cu",
        "replaces": "tempo_tpu/ops/pallas_kernels.py:196",
        "launches": None, "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_bytes": nbytes, "library_ms": None,
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
    n, page_rows = dur.size, 256
    p_pages = -(-n // page_rows)
    rows = (p_pages + 1) * page_rows
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
                          arenas, page_rows=page_rows,
                          edges=tuple(DEFAULT_HISTOGRAM_EDGES), gamma=gamma,
                          min_value=minv, dd_rows=n)
    at = np.arange(n) + page_rows                  # one row per probe
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


def phase_main_path():
    """Phase 4: the main path on the card against the same path on the
    host (plain versions), with per-span sizes and integer sample
    weights; returns (launches, spans/s, seconds)."""
    import torch

    import tempo_tpu_torch as tt
    from tempo_tpu_torch.generator.remote_write import (
        LocalReceiver, RemoteWriteConfig, decode_write_request)
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
    from tempo_tpu_torch.ops import cuda_kernels as ck
    from tempo_tpu_torch.registry import pages

    now = time.time()
    rng = np.random.default_rng(SEED + 1)
    payloads = [encode_spans_otlp(synthetic_spans(
        N_SPANS, seed=SEED + k, now_ns=int(now * 1e9)))
        for k in range(N_DISPATCH)]
    # bytes per span in the range of k6-tracing's spans, and the
    # upscale factors of overload sampling
    sizes = [rng.integers(200, 2000, N_SPANS).astype(np.float32)
             for _ in payloads]
    weights = [rng.integers(1, 4, N_SPANS).astype(np.float32)
               for _ in payloads]
    with LocalReceiver() as rx:
        insts = {}
        for name, device in (("card", "cuda"), ("host", "cpu")):
            pool = pages.PagePool(tt.PagePoolConfig(enabled=True),
                                  device=device)
            with pages.use(pool):
                insts[name] = tt.GeneratorInstance(
                    "smoke", tt.GeneratorConfig(remote_write=RemoteWriteConfig(
                        url=f"{rx.url}/{name}")), now=lambda: now, device=device)
        results = {}
        for name, inst in insts.items():
            if name == "card":
                ck.reset_launch_counts()
            t0 = time.perf_counter()
            decode_s = 0.0
            for data, size, weight in zip(payloads, sizes, weights):
                td = time.perf_counter()
                sb = tt.otlp_proto_to_batch(
                    data, tt.SpanBatchBuilder(inst.registry.interner))
                decode_s += time.perf_counter() - td
                span_sizes = np.zeros(sb.capacity, np.float32)
                span_sizes[:sb.n] = size[:sb.n]
                inst.push_batch(sb, span_sizes, sample_weights=weight[:sb.n])
            if name == "card":
                torch.cuda.synchronize()
                launches = ck.paged_fused_update.launches
            push_s = time.perf_counter() - t0
            tc = time.perf_counter()
            n_samples = inst.collect_and_push()
            collect_s = time.perf_counter() - tc
            proc = inst.processors["span-metrics"]
            tq = time.perf_counter()
            q50, q99 = proc.quantile(0.5), proc.quantile(0.99)
            quantile_s = time.perf_counter() - tq
            results[name] = {
                "push_s": push_s, "samples": n_samples, "q50": q50,
                "q99": q99, "series": inst.registry.active_series}
            print(f"phase 4 {name}: {len(payloads)} pushes of {N_SPANS} spans "
                  f"in {push_s:.3f} s (OTLP decode {decode_s:.3f} s, "
                  f"push_batch {push_s - decode_s:.3f} s), "
                  f"{results[name]['series']} series; collect_and_push "
                  f"{n_samples} samples in {collect_s:.3f} s; two quantile "
                  f"reads in {quantile_s:.3f} s")
    bodies = rx.bodies
    if not bodies.get("/card") or not bodies.get("/host"):
        raise AssertionError(f"remote write received {list(bodies)}")
    gpu = decode_write_request(bodies["/card"])
    cpu = decode_write_request(bodies["/host"])
    if not gpu or set(gpu) != set(cpu):
        raise AssertionError("card and host wrote different series sets")
    total = sum(v[0] for k, v in gpu.items()
                if dict(k)["__name__"] == "traces_spanmetrics_calls_total")
    want = float(sum(w.sum() for w in weights))
    if total != want:
        raise AssertionError(f"calls total {total} != {want}, the weighted "
                             f"spans pushed")
    for k, vs in gpu.items():
        labels = dict(k)
        for i, (v, h) in enumerate(zip(vs, cpu[k], strict=True)):
            # float sums: the size counter and the latency `_sum` (second
            # sample of a bucketless latency label set); the rest count
            is_sum = labels["__name__"] == "traces_spanmetrics_size_total" \
                or ("le" not in labels and i == 1)
            ok = abs(v - h) <= 1e-5 * abs(h) + 1e-6 if is_sum else v == h
            if not ok:
                raise AssertionError(f"sample {k}[{i}]: card {v} vs host {h}")
    for q in ("q50", "q99"):
        a, b = results["card"][q], results["host"][q]
        if a != b:
            bad = sum(a.get(k) != b.get(k) for k in a.keys() | b.keys())
            raise AssertionError(f"{q}: {bad} series differ between card "
                                 f"and host")
    print(f"phase 4 checks: {len(gpu)} label sets in the card's WriteRequest "
          f"equal the host's; calls total {int(total)} (weighted spans); "
          f"quantiles q50/q99 of {len(results['card']['q50'])} series equal")
    if launches != len(payloads):
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{len(payloads)} pushes")
    spans_per_s = len(payloads) * N_SPANS / results["card"]["push_s"]
    return launches, spans_per_s, results["card"]["push_s"]


def _dd_meta():
    from tempo_tpu_torch.ops.sketches import dd_params
    gamma, nb = dd_params(0.01, 1e-6, 1e5)
    return gamma, 1e-6, nb


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
    name = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    path = ck.build("paged_fused_update")
    ck._lib("paged_fused_update")
    build_s = time.perf_counter() - t0
    log = ck.BUILD_INFO.get("paged_fused_update", {}).get("log", "cached")
    print(f"build: paged_fused_update in {build_s:.2f} s -> "
          f"{os.path.relpath(path, ROOT)}\n{log}")
    kern = phase_kernel_vs_plain(card)
    n_probe, shifted = edge_probe_on_card()
    print(f"phase 3 edge probe: {shifted} of {n_probe} DDSketch edge "
          f"durations land one bucket apart between K1 (CUDA logf) and the "
          f"host (torch CPU log)")
    launches, spans_per_s, push_s = phase_main_path()
    kern["launches"] = launches
    print(f"phase 5 [{card}]: paged_fused_update {kern['ms']:.4f} ms per "
          f"dispatch of {N_SPANS} spans (median of {N_TIMED}, CUDA events)")
    dms = kern["device_ms"]
    print(f"phase 5 [{card}]: paged_fused_update device time per launch "
          f"(torch.profiler): "
          f"{'not measured' if dms is None else f'{dms:.4f} ms'}")
    print(f"phase 5 [{card}]: plain version on the card "
          f"{kern['plain_ms']:.4f} ms")
    print(f"phase 5 [{card}]: bound {kern['bound_ms']:.6f} ms by "
          f"{kern['bound_by']} ({kern['bound_bytes']} bytes at 3.35 TB/s)")
    print(f"phase 5 [{card}]: end to end {spans_per_s:.0f} spans/s "
          f"(decode + push of {N_DISPATCH} x {N_SPANS} spans in "
          f"{push_s:.3f} s)")
    print(json.dumps({"kernels": [kern]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
