"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

`paged_fused_update` replaces the Pallas TPU kernel of the same name
(`tempo_tpu/ops/pallas_kernels.py:196`, `pl.pallas_call` at :404): one
pass over a span batch updates the whole span-metrics plane family
(calls, latency sum, latency count, size, latency histogram, DDSketch
zeros and buckets) in the page pool's arenas, in place. The source and
its design note are in `tempo_tpu_torch/csrc/paged_fused_update.cu`: the
work is bound by bytes (the batch plus a read-modify-write of every
touched cell), and the first design is one thread per span adding into
the arena cells with f32 atomics, skipping unbacked roles so the trash
page 0 stays zero.

Build: at first use the source is compiled with `nvcc` for `sm_90a` into
`build/` at the repository root, keyed by a hash of the source and the
flags, and loaded with `ctypes`; the C function returns
`cudaGetLastError()` and the wrapper raises on anything but 0.

Dispatch: the wrapper runs the plain PyTorch version only for tensors on
the CPU. For tensors on the card it launches the kernel or raises; it
never falls back. `paged_fused_update.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              # IEEE logf / division and no contraction: the DDSketch bucket
              # must follow the reference's f32 op order
              "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
              "-fmad=false", "-Xptxas", "-v")
MAX_EDGES = 64

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


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` into `build/<name>-<hash>.so` unless that
    exact build exists; return the library's path."""
    import time

    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"path": str(out), "seconds": time.perf_counter() - t0,
                        "log": (proc.stdout + proc.stderr).strip()}
    return out


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
            if name == "paged_fused_update":
                p, i = ctypes.c_void_p, ctypes.c_int
                fn = lib.paged_fused_update_launch
                fn.argtypes = [p, i, i, p, p, p, i, p, p, p, p, p, p, p,
                               i, i, i, p, i, ctypes.c_float, ctypes.c_float,
                               p]
                fn.restype = i
                lib.paged_fused_update_error.argtypes = [i]
                lib.paged_fused_update_error.restype = ctypes.c_char_p
        return lib


# ---------------------------------------------------------------------------
# paged fused span-metrics update
# ---------------------------------------------------------------------------

def paged_fused_update_plain(tables: torch.Tensor, slots: torch.Tensor,
                             vals: torch.Tensor, arenas: Sequence[torch.Tensor],
                             *, page_rows: int, edges: tuple, gamma: float,
                             min_value: float, dd_rows: int) -> None:
    """The plain PyTorch version: one `index_put_(accumulate=True)` per
    role, in the f32 op order of `ops.pages._fused_body`, in place."""
    from tempo_tpu_torch.ops.pages import _fused_body

    _fused_body(arenas, [tables[r] for r in range(tables.shape[0])],
                slots, vals[0], vals[1], vals[2], edges=tuple(edges),
                gamma=gamma, min_value=min_value, dd_rows=dd_rows,
                page_shift=page_rows.bit_length() - 1)


def _check(tables, slots, vals, arenas, page_rows, edges, dd_rows) -> None:
    n_roles = len(arenas)
    if n_roles != (7 if dd_rows else 5):
        raise ValueError(f"paged_fused_update: {n_roles} arenas for "
                         f"dd_rows={dd_rows} (want {7 if dd_rows else 5})")
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
    # the latency histogram has len(edges)+1 columns, the DDSketch grid
    # any width; the other roles are 1-D
    for r, a in enumerate(arenas):
        want_ndim = 2 if r in (4, 6) else 1
        if a.dtype != torch.float32 or a.shape[0] != rows \
                or a.ndim != want_ndim:
            raise ValueError(f"arena {r}: want a {want_ndim}-D f32 arena "
                             f"with {rows} rows")
    if arenas[4].shape[1] != len(edges) + 1:
        raise ValueError(f"arena 4: want {len(edges) + 1} histogram columns")
    if rows % page_rows:
        raise ValueError(f"arena rows {rows} not a multiple of {page_rows}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_fused_update: tensors must be contiguous")


def paged_fused_update(tables: torch.Tensor, slots: torch.Tensor,
                       vals: torch.Tensor, arenas: Sequence[torch.Tensor], *,
                       page_rows: int, edges: tuple, gamma: float,
                       min_value: float, dd_rows: int) -> None:
    """Update the span-metrics plane family in place.

      tables  [R, P] int32 — per-role page tables, padded with -1; R is 7
              (calls, hist_sums, hist_counts, sizes, hist_buckets,
              dd_zeros, dd_counts), or 5 with dd_rows == 0.
      slots   [N] int32, or f32 (a row of the packed [4, N] batch);
              negative = discard.
      vals    [3, N] f32 — dur_s, size, weight.
      arenas  the role arenas; all share one row count.

    CPU tensors run `paged_fused_update_plain`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise."""
    edges = tuple(float(e) for e in edges)
    _check(tables, slots, vals, arenas, page_rows, edges, dd_rows)
    dev = arenas[0].device
    if dev.type == "cpu":
        paged_fused_update_plain(tables, slots, vals, arenas,
                                 page_rows=page_rows, edges=edges,
                                 gamma=gamma, min_value=min_value,
                                 dd_rows=dd_rows)
        return
    if dev.type != "cuda":
        raise ValueError(f"paged_fused_update: unsupported device {dev}")
    lib = _lib("paged_fused_update")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    null = ctypes.c_void_p(None)
    dd = bool(dd_rows)
    host_edges = (ctypes.c_float * max(len(edges), 1))(*edges)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.paged_fused_update_launch(
            ptr(tables), tables.shape[0], tables.shape[1],
            ptr(slots) if slots.dtype == torch.float32 else null,
            ptr(slots) if slots.dtype == torch.int32 else null,
            ptr(vals), slots.shape[0],
            *(ptr(a) for a in arenas[:5]),
            ptr(arenas[5]) if dd else null, ptr(arenas[6]) if dd else null,
            page_rows.bit_length() - 1, int(dd_rows),
            arenas[6].shape[1] if dd else 0,
            ctypes.cast(host_edges, ctypes.c_void_p), len(edges),
            float(min_value), float(math.log(gamma)) if dd else 1.0,
            ctypes.c_void_p(stream))
    if code != 0:
        msg = lib.paged_fused_update_error(code).decode()
        raise RuntimeError(f"paged_fused_update launch failed: {code} {msg}")
    if slots.shape[0]:
        paged_fused_update.launches += 1


paged_fused_update.launches = 0

# every kernel wrapper of the package, for launch accounting
WRAPPERS = (paged_fused_update,)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


__all__ = ["paged_fused_update", "paged_fused_update_plain", "build",
           "BUILD_INFO", "BUILD_DIR", "WRAPPERS", "reset_launch_counts"]
