"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

K1, `paged_fused_update`, replaces the Pallas TPU kernel of the same name
(`tempo_tpu/ops/pallas_kernels.py:196`, `pl.pallas_call` at :404): one
pass over a span batch updates the whole span-metrics plane family
(calls, latency sum, latency count, size, latency histogram, DDSketch
zeros and buckets, moments row) in the page pool's arenas, in place.
Source and design note: `tempo_tpu_torch/csrc/paged_fused_update.cu`.
With f32 state it is one launch: one thread per span, f32 atomics into
the arena cells. Under the compact tier (int32 counts, a bf16 Kahan pair
for the latency sum) it is two: the span pass adds each role's f32 delta
into a zeroed logical-row scratch the wrapper allocates, and a fold pass
rounds every cell's whole-dispatch delta once and runs the Kahan step on
every row of every backed page, as the TPU kernel does.

K2, `fused_spanmetrics_matmul`, replaces the dense one-hot kernel of the
same name (`pallas_kernels.py:141`, `pl.pallas_call` at :156): the
[S, 3 + buckets] delta of a span batch (count, duration sum, size sum,
latency histogram). Source: `tempo_tpu_torch/csrc/fused_spanmetrics.cu`.

Build: at first use each source is compiled with `nvcc` for `sm_90a`
into `build/` at the repository root, keyed by a hash of the source and
the flags, and loaded with `ctypes`; `build_all` starts every compile at
once. Each C launch function returns `cudaGetLastError()` and the wrapper
raises on anything but 0.

Dispatch: a wrapper runs its plain PyTorch version only for tensors on
the CPU. For tensors on the card it launches the kernel or raises; it
never falls back. Each wrapper's `launches` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              # IEEE logf / division and no contraction: the DDSketch bucket
              # and the moments basis follow the reference's f32 op order
              "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
              "-fmad=false", "-Xptxas", "-v")
SOURCES = ("paged_fused_update", "fused_spanmetrics")
MAX_EDGES = 64
MAX_ROLES = 8

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"path", "seconds", "log"} of builds made by this process
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME)")


def _target(name: str) -> tuple[Path, Path]:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> dict[str, Path]:
    """Compile each `csrc/<name>.cu` into `build/<name>-<hash>.so` unless
    that exact build exists, one `nvcc` per source, all started together;
    return the libraries' paths."""
    out, procs = {}, {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        src, so = _target(name)
        out[name] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out[name])
        BUILD_INFO[name] = {"path": str(out[name]),
                            "seconds": time.perf_counter() - t0,
                            "log": log.strip()}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """Build one source (see `build_all`)."""
    return build_all((name,))[name]


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
            p, i = ctypes.c_void_p, ctypes.c_int
            if name == "paged_fused_update":
                fn = lib.paged_fused_update_launch
                fn.argtypes = [p, i, p, p, p, p, p, p]
                fn.restype = i
                fn = lib.paged_fused_update_fold_launch
                fn.argtypes = [p, p, p, p, p, i, i, i, i, p, p]
                fn.restype = i
            else:
                fn = lib.fused_spanmetrics_launch
                fn.argtypes = [p, p, p, p, i, i, p, i, p, p]
                fn.restype = i
            lib.kernel_error.argtypes = [i]
            lib.kernel_error.restype = ctypes.c_char_p
        return lib


def _ptr(t: "torch.Tensor | None") -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {code} "
                           f"{lib.kernel_error(code).decode()}")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# K1: the paged fused span-metrics update
# ---------------------------------------------------------------------------

def _roles(dd_rows: int, mom_rows: int) -> int:
    return 5 + (2 if dd_rows else 0) + (1 if mom_rows else 0)


def paged_fused_update_plain(tables: torch.Tensor, slots: torch.Tensor,
                             vals: torch.Tensor, arenas: Sequence[torch.Tensor],
                             *, page_rows: int, edges: tuple, gamma: float,
                             min_value: float, dd_rows: int, mom_rows: int = 0,
                             mom_meta: "tuple | None" = None) -> None:
    """The plain PyTorch version, with the reference Pallas kernel's
    semantics: every role's whole-dispatch f32 delta per logical row
    (composed scatters in the f32 op order of `ops.pages._fused_body`),
    then one fold into every backed page under each arena's storage rule
    (`ops.pages.fold_deltas`, which reads the rule off the arena's
    dtype), in place."""
    from tempo_tpu_torch.ops import pages as op

    shift = page_rows.bit_length() - 1
    deltas = op.dispatch_deltas(
        slots, vals, n_lrows=tables.shape[1] * page_rows, edges=tuple(edges),
        gamma=gamma, min_value=min_value, dd_rows=dd_rows,
        nb_dd=arenas[6].shape[1] if dd_rows else 0, mom_rows=mom_rows,
        mom_meta=mom_meta, page_shift=shift)
    op.fold_deltas(arenas, tables, deltas, page_shift=shift,
                   mom_k=mom_meta[0] if mom_rows else None)


def _arena_spec(r: int, dd: bool, mom: bool, compact: bool, n_hist: int,
                nb_dd: int, mom_w: int) -> tuple[torch.dtype, "int | None"]:
    """(dtype, width or None for 1-D) that role r's arena must have."""
    f32, i32 = torch.float32, torch.int32
    if mom and r == _roles(dd, mom) - 1:
        return f32, mom_w
    if r == 1:
        return (torch.bfloat16, 2) if compact else (f32, None)
    if r == 3:                       # sizes stay f32 in the compact tier
        return f32, None
    dt = i32 if compact else f32
    return dt, {4: n_hist, 6: nb_dd}.get(r)


def _check(tables, slots, vals, arenas, page_rows, edges, dd_rows, mom_rows,
           mom_meta, compact) -> None:
    n_roles = len(arenas)
    want = _roles(dd_rows, mom_rows)
    if n_roles != want:
        raise ValueError(f"paged_fused_update: {n_roles} arenas for "
                         f"dd_rows={dd_rows} mom_rows={mom_rows} (want {want})")
    if mom_rows and (mom_meta is None or not 1 <= mom_meta[0] <= 32):
        raise ValueError(f"mom_meta (k, lo, hi) with 1 <= k <= 32, got "
                         f"{mom_meta}")
    if page_rows < 1 or page_rows & (page_rows - 1):
        raise ValueError(f"page_rows {page_rows} must be a power of two")
    if len(edges) > MAX_EDGES:
        raise ValueError(f"{len(edges)} histogram edges (at most {MAX_EDGES})")
    dev = arenas[0].device
    tensors = [tables, slots, vals, *arenas]
    if any(t.device != dev for t in tensors):
        raise ValueError("paged_fused_update: tensors on different devices")
    if tables.dtype != torch.int32 or tables.ndim != 2 \
            or tables.shape[0] != n_roles:
        raise ValueError(f"tables must be int32 [{n_roles}, P], got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    n = slots.shape[0]
    if slots.ndim != 1 or slots.dtype not in (torch.int32, torch.float32):
        raise ValueError("slots must be a 1-D int32 or float32 tensor")
    if vals.dtype != torch.float32 or tuple(vals.shape) != (3, n):
        raise ValueError(f"vals must be f32 [3, {n}]")
    rows = arenas[0].shape[0]
    nb_dd = arenas[6].shape[-1] if dd_rows else 0
    mom_w = mom_meta[0] + 3 if mom_rows else 0
    for r, a in enumerate(arenas):
        dt, width = _arena_spec(r, bool(dd_rows), bool(mom_rows), compact,
                                len(edges) + 1, nb_dd, mom_w)
        shape = (rows,) if width is None else (rows, width)
        if a.dtype != dt or tuple(a.shape) != shape:
            raise ValueError(f"arena {r}: want {dt} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
    if rows % page_rows:
        raise ValueError(f"arena rows {rows} not a multiple of {page_rows}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_fused_update: tensors must be contiguous")


def _pfu_params(n, n_roles, p_pages, page_rows, edges, gamma, min_value,
                dd_rows, nb_dd, mom_rows, mom_meta, compact):
    """The kernel's parameter block (`PfuParams` in the source) as bytes.
    Constants are computed as the reference does: Python double, then
    f32 where they meet f32 data."""
    import struct

    from tempo_tpu_torch.ops.moments import basis_constants

    mk, mlo, mhi = mom_meta if mom_rows else (0, 0.0, 0.0)
    vmin, vmax, c, h = basis_constants(mlo, mhi) if mom_rows \
        else (0.0, 0.0, 0.0, 1.0)
    ints = (n, n_roles, p_pages, page_rows.bit_length() - 1, dd_rows, nb_dd,
            len(edges), mom_rows, mk, int(compact))
    floats = (min_value, math.log(gamma) if dd_rows else 1.0, vmin, vmax, c, h,
              mlo, mhi)
    e = list(edges) + [0.0] * (MAX_EDGES - len(edges))
    return struct.pack(f"{len(ints)}i{len(floats)}f{MAX_EDGES}f", *ints,
                       *floats, *e)


def paged_fused_update(tables: torch.Tensor, slots: torch.Tensor,
                       vals: torch.Tensor, arenas: Sequence[torch.Tensor], *,
                       page_rows: int, edges: tuple, gamma: float,
                       min_value: float, dd_rows: int, mom_rows: int = 0,
                       mom_meta: "tuple | None" = None,
                       compact: bool = False) -> None:
    """Update the span-metrics plane family in place.

      tables  [R, P] int32 — per-role page tables, padded with -1; R is 5
              (calls, hist_sums, hist_counts, sizes, hist_buckets), +2
              with dd_rows > 0 (dd_zeros, dd_counts), +1 with mom_rows > 0
              (moments [rows, k+3], mom_meta = (k, lo, hi)).
      slots   [N] int32, or f32 (a row of the packed [4, N] batch);
              negative = discard.
      vals    [3, N] f32 — dur_s, size, weight.
      arenas  the role arenas; all share one row count. f32, or under
              `compact` int32 counts, the latency sum as a bf16 [rows, 2]
              Kahan pair, sizes and moments f32.

    CPU tensors run `paged_fused_update_plain`; CUDA tensors launch the
    kernels on the current stream (no synchronisation) or raise."""
    edges = tuple(float(e) for e in edges)
    _check(tables, slots, vals, arenas, page_rows, edges, dd_rows, mom_rows,
           mom_meta, compact)
    dev = arenas[0].device
    kw = dict(page_rows=page_rows, edges=edges, gamma=gamma,
              min_value=min_value, dd_rows=dd_rows, mom_rows=mom_rows,
              mom_meta=mom_meta)
    if dev.type == "cpu":
        paged_fused_update_plain(tables, slots, vals, arenas, **kw)
        return
    if dev.type != "cuda":
        raise ValueError(f"paged_fused_update: unsupported device {dev}")
    n = slots.shape[0]
    if not n and not compact:
        return
    lib = _lib("paged_fused_update")
    n_roles, p_pages = tables.shape
    nb_dd = arenas[6].shape[1] if dd_rows else 0
    params = _pfu_params(n, n_roles, p_pages, page_rows, edges, gamma,
                         min_value, dd_rows, nb_dd, mom_rows, mom_meta,
                         compact)
    host_params = ctypes.create_string_buffer(params, len(params))
    if compact:
        # the dispatch's f32 delta of every role, by logical row
        from tempo_tpu_torch.ops.pages import delta_shapes

        shapes = delta_shapes(p_pages * page_rows, len(edges), dd_rows, nb_dd,
                              mom_rows, mom_meta[0] if mom_rows else 0)
        rows, widths = [r for r, _ in shapes], [w for _, w in shapes]
        sizes = [r * w for r, w in shapes]
        scratch = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
        begins = [sum(sizes[:r]) for r in range(n_roles)]
        dst = [scratch[b:] for b in begins]
    else:
        dst = list(arenas)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        code = lib.paged_fused_update_launch(
            ctypes.cast(host_params, ctypes.c_void_p), len(params),
            _ptr(tables),
            _ptr(slots) if slots.dtype == torch.float32 else None,
            _ptr(slots) if slots.dtype == torch.int32 else None,
            _ptr(vals), _ptr_array([t.data_ptr() for t in dst]), stream)
        _raise_on(lib, code, "paged_fused_update")
        if n:
            paged_fused_update.launches += 1
        if not compact:
            return
        kinds = [_FOLD_KIND[a.dtype] for a in arenas]
        if mom_rows:
            kinds[-1] = _FOLD_MOMENTS
        code = lib.paged_fused_update_fold_launch(
            _ptr_array([a.data_ptr() for a in arenas]),
            _ptr_array([t.data_ptr() for t in dst]), _i64_array(rows),
            _i64_array(widths), _i64_array(kinds), n_roles, p_pages,
            page_rows.bit_length() - 1, mom_meta[0] if mom_rows else 0,
            _ptr(tables), stream)
        _raise_on(lib, code, "paged_fused_update fold")
        paged_fused_update.launches += 1


def _ptr_array(ptrs: list) -> ctypes.Array:
    return (ctypes.c_void_p * MAX_ROLES)(*ptrs,
                                         *[None] * (MAX_ROLES - len(ptrs)))


def _i64_array(xs: list) -> ctypes.Array:
    return (ctypes.c_longlong * MAX_ROLES)(*xs, *[0] * (MAX_ROLES - len(xs)))


# fold kinds of the compact write-back (`FOLD_*` in the source)
_FOLD_KIND = {torch.int32: 0, torch.bfloat16: 1, torch.float32: 2}
_FOLD_MOMENTS = 3

paged_fused_update.launches = 0


# ---------------------------------------------------------------------------
# K2: the dense fused span-metrics delta
# ---------------------------------------------------------------------------

def fused_spanmetrics_scatter(slots: torch.Tensor, dur_s: torch.Tensor,
                              sizes: torch.Tensor, weights: torch.Tensor, *,
                              n_series: int, edges: tuple) -> torch.Tensor:
    """The plain PyTorch version of K2, the reference's scatter twin
    (`pallas_kernels.py:167`): [n_series, 3 + len(edges) + 1] f32 —
    count | duration sum | size sum | latency histogram. Slots < 0 or
    >= n_series drop."""
    from tempo_tpu_torch.ops.pages import hist_bucket

    dev = dur_s.device
    f = 4 + len(edges)
    s = slots.to(torch.int64)
    keep = (s >= 0) & (s < n_series)
    s, v, sz, w = s[keep], dur_s[keep], sizes[keep], weights[keep]
    out = torch.zeros((n_series, f), dtype=torch.float32, device=dev)
    for col, x in ((0, w), (1, v * w), (2, sz * w)):
        out.index_put_((s, torch.full_like(s, col)), x, accumulate=True)
    out.index_put_((s, 3 + hist_bucket(v, tuple(edges))), w, accumulate=True)
    return out


def fused_spanmetrics_matmul(slots: torch.Tensor, dur_s: torch.Tensor,
                             sizes: torch.Tensor, weights: torch.Tensor, *,
                             n_series: int, edges: tuple) -> torch.Tensor:
    """The fused span-metrics delta of one batch, [n_series, 3 +
    len(edges) + 1] f32 (see `fused_spanmetrics_scatter`). `slots` int32
    [N], the rest f32 [N]. CPU tensors run the plain version; CUDA
    tensors launch the kernel into a zeroed output or raise."""
    edges = tuple(float(e) for e in edges)
    n = slots.shape[0]
    tensors = (slots, dur_s, sizes, weights)
    if slots.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in tensors[1:]) or any(
            tuple(t.shape) != (n,) for t in tensors):
        raise ValueError("fused_spanmetrics_matmul: int32 slots and f32 "
                         "values, all 1-D of one length")
    if len(edges) > MAX_EDGES:
        raise ValueError(f"{len(edges)} histogram edges (at most {MAX_EDGES})")
    dev = dur_s.device
    if any(t.device != dev for t in tensors) or \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_spanmetrics_matmul: contiguous tensors on "
                         "one device")
    if dev.type == "cpu":
        return fused_spanmetrics_scatter(slots, dur_s, sizes, weights,
                                         n_series=n_series, edges=edges)
    if dev.type != "cuda":
        raise ValueError(f"fused_spanmetrics_matmul: unsupported device {dev}")
    out = torch.zeros((n_series, 4 + len(edges)), dtype=torch.float32,
                      device=dev)
    if not n:
        return out
    lib = _lib("fused_spanmetrics")
    host_edges = (ctypes.c_float * max(len(edges), 1))(*edges)
    with torch.cuda.device(dev):
        code = lib.fused_spanmetrics_launch(
            _ptr(slots), _ptr(dur_s), _ptr(sizes), _ptr(weights), n,
            n_series, ctypes.cast(host_edges, ctypes.c_void_p), len(edges),
            _ptr(out), _stream(dev))
    _raise_on(lib, code, "fused_spanmetrics_matmul")
    fused_spanmetrics_matmul.launches += 1
    return out


fused_spanmetrics_matmul.launches = 0

# every kernel wrapper of the package, for launch accounting
WRAPPERS = (paged_fused_update, fused_spanmetrics_matmul)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


__all__ = ["paged_fused_update", "paged_fused_update_plain",
           "fused_spanmetrics_matmul", "fused_spanmetrics_scatter", "build",
           "build_all", "BUILD_INFO", "BUILD_DIR", "SOURCES", "WRAPPERS",
           "reset_launch_counts"]
