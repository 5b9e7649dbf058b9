"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

K1, `paged_fused_update`, replaces the Pallas TPU kernel of the same name
(`tempo_tpu/ops/pallas_kernels.py:196`, `pl.pallas_call` at :404): one
pass over a span batch updates the whole span-metrics plane family
(calls, latency sum, latency count, size, latency histogram, DDSketch
zeros and buckets, moments row) in place, in the page pool's arenas or,
through identity page tables, in dense state's own arenas.
Source and design note: `tempo_tpu_torch/csrc/paged_fused_update.cu`.
With f32 state it is one launch: one thread per span, f32 atomics into
the arena cells. Under the compact tier (int32 counts, a bf16 Kahan pair
for the latency sum) it is two: the span pass adds the int32 roles' and
the pair's f32 deltas into a persistent logical-row scratch that the
caller owns (`compact_scratch`), and a fold pass takes each touched
cell's whole-dispatch delta out of it once (rounded half to even) and
runs the Kahan step on every row of every backed page, as the TPU kernel
does, leaving the scratch all zero.

K2, `fused_spanmetrics_matmul`, replaces the dense one-hot kernel of the
same name (`pallas_kernels.py:141`, `pl.pallas_call` at :156): the
[S, 3 + buckets] delta of a span batch (count, duration sum, size sum,
latency histogram). Source: `tempo_tpu_torch/csrc/fused_spanmetrics.cu`.
Two device operations a call: the output is zeroed, then one pass of one
or four spans a thread adds each span with float4 atomics on the 16 B
quads of the output that hold its cells (two atomic operations a span
where four scalar ones were; `k2_layout`).

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
import struct
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import NamedTuple, Sequence

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
# with the moments row, K1's span pass stages the [R, P] tables in 227 KB
MAX_TABLE_BYTES = 232448

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
    lib = _libs.get(name)        # the hot path: loaded, no lock
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            p, i = ctypes.c_void_p, ctypes.c_int
            if name == "paged_fused_update":
                fn = lib.paged_fused_update_launch
                fn.argtypes = [p, i, i, p, p, p, p]
                fn.restype = i
            else:
                fn = lib.fused_spanmetrics_launch
                fn.argtypes = [p, i, i, i, p, p, p, p, p, p]
                fn.restype = i
            lib.kernel_error.argtypes = [i]
            lib.kernel_error.restype = ctypes.c_char_p
            _libs[name] = lib    # published only once it is set up
        return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {code} "
                           f"{lib.kernel_error(code).decode()}")


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


def _scratch_roles(n_lrows: int, n_edges: int, dd_rows: int,
                   nb_dd: int) -> list[tuple[int, int]]:
    """(role, elements) of the compact scratch, in its order: the f32
    deltas by logical row (`ops.pages.delta_shapes`) of calls, the latency
    sum (the pair), latency count, the histogram, and the DDSketch zeros
    and grid. Sizes (role 3) and the moments row have none: their atomics
    go straight into the arena."""
    from tempo_tpu_torch.ops.pages import delta_shapes

    shapes = delta_shapes(n_lrows, n_edges, dd_rows, nb_dd, 0, 0)
    return [(r, rows * w) for r, (rows, w) in enumerate(shapes) if r != 3]


def _scratch_numel(tables, arenas, page_rows, n_edges, dd_rows) -> int:
    nb_dd = arenas[6].shape[-1] if dd_rows else 0
    return sum(k for _, k in _scratch_roles(tables.shape[1] * page_rows,
                                            n_edges, dd_rows, nb_dd))


def compact_scratch(tables: torch.Tensor, arenas: Sequence[torch.Tensor], *,
                    page_rows: int, edges: tuple, dd_rows: int) -> torch.Tensor:
    """The zeroed f32 working memory K1 needs under compact state on the
    card, allocated once by the owner of the arenas and passed to every
    `paged_fused_update` call (`scratch=`). K1 leaves it all zero after
    each dispatch. It is indexed by logical row, so page eviction or reuse
    between dispatches needs nothing (~88 MB at the default widths)."""
    return torch.zeros(_scratch_numel(tables, arenas, page_rows, len(edges),
                                      dd_rows),
                       dtype=torch.float32, device=arenas[0].device)


def _check_state(tables, arenas, page_rows, edges, dd_rows, mom_rows,
                 mom_meta, compact, scratch) -> None:
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
    tensors = [tables, *arenas]
    if any(t.device != dev for t in tensors):
        raise ValueError("paged_fused_update: tensors on different devices")
    if tables.dtype != torch.int32 or tables.ndim != 2 \
            or tables.shape[0] != n_roles:
        raise ValueError(f"tables must be int32 [{n_roles}, P], got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    nb_dd = arenas[6].shape[-1] if dd_rows else 0
    mom_w = mom_meta[0] + 3 if mom_rows else 0
    # each role's arena may have its own row count (dense state sizes the
    # sketch arenas to dd_rows); its table must name only its own pages
    last = tables.cpu().amax(dim=1).tolist() if tables.shape[1] else \
        [-1] * n_roles
    for r, a in enumerate(arenas):
        dt, width = _arena_spec(r, bool(dd_rows), bool(mom_rows), compact,
                                len(edges) + 1, nb_dd, mom_w)
        rows = a.shape[0] if a.ndim else 0
        shape = (rows,) if width is None else (rows, width)
        if a.dtype != dt or tuple(a.shape) != shape:
            raise ValueError(f"arena {r}: want {dt} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if rows % page_rows:
            raise ValueError(f"arena {r}: rows {rows} not a multiple of "
                             f"{page_rows}")
        if last[r] >= rows // page_rows:
            raise ValueError(f"table of role {r} names physical page "
                             f"{last[r]}, past its arena's last page "
                             f"{rows // page_rows - 1}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_fused_update: tensors must be contiguous")
    if compact and scratch is not None:
        numel = _scratch_numel(tables, arenas, page_rows, len(edges), dd_rows)
        if scratch.dtype != torch.float32 or tuple(scratch.shape) != (numel,) \
                or scratch.device != dev or not scratch.is_contiguous():
            raise ValueError(f"scratch: want contiguous torch.float32 "
                             f"({numel},) on {dev}, got {scratch.dtype} "
                             f"{tuple(scratch.shape)} on {scratch.device}")


def _check_batch(slots, vals, dev) -> None:
    if slots.device != dev or vals.device != dev:
        raise ValueError("paged_fused_update: tensors on different devices")
    n = slots.shape[0]
    if slots.ndim != 1 or slots.dtype not in (torch.int32, torch.float32):
        raise ValueError("slots must be a 1-D int32 or float32 tensor")
    if vals.dtype != torch.float32 or tuple(vals.shape) != (3, n):
        raise ValueError(f"vals must be f32 [3, {n}]")
    if not (slots.is_contiguous() and vals.is_contiguous()):
        raise ValueError("paged_fused_update: tensors must be contiguous")


# the kernel's parameter block, `PfuParams` in the source, field by field
_PFU_FIELDS = (("n_roles", "i"), ("p_pages", "i"), ("page_shift", "i"),
               ("dd_rows", "i"), ("nb_dd", "i"), ("n_edges", "i"),
               ("mom_rows", "i"), ("mom_k", "i"), ("compact", "i"),
               ("min_value", "f"), ("log_gamma", "f"), ("mom_vmin", "f"),
               ("mom_vmax", "f"), ("mom_c", "f"), ("mom_h", "f"),
               ("mom_lo", "f"), ("mom_hi", "f"), ("edges", f"{MAX_EDGES}f"))
_PFU_FORMAT = "=" + "".join(t for _, t in _PFU_FIELDS)


def _pfu_params(n_roles, p_pages, page_rows, edges, gamma, min_value,
                dd_rows, nb_dd, mom_rows, mom_meta, compact) -> bytes:
    """The kernel's parameter block (`PfuParams` in the source) as bytes.
    Constants are computed as the reference does: Python double, then
    f32 where they meet f32 data."""
    from tempo_tpu_torch.ops.moments import basis_constants

    mk, mlo, mhi = mom_meta if mom_rows else (0, 0.0, 0.0)
    vmin, vmax, c, h = basis_constants(mlo, mhi) if mom_rows \
        else (0.0, 0.0, 0.0, 1.0)
    e = list(edges) + [0.0] * (MAX_EDGES - len(edges))
    return struct.pack(
        _PFU_FORMAT, n_roles, p_pages, page_rows.bit_length() - 1, dd_rows,
        nb_dd, len(edges), mom_rows, mk, int(compact), min_value,
        math.log(gamma) if dd_rows else 1.0, vmin, vmax, c, h, mlo, mhi, *e)


class _Plan:
    """What a K1 launch needs that does not change between dispatches on
    one set of tables, arenas and scratch, packed as the launch function
    reads it: the tables pointer, the arena and scratch pointers and the
    parameter block. Built (and the set validated) once per key."""

    def __init__(self, tables, arenas, scratch, page_rows, edges, gamma,
                 min_value, dd_rows, mom_rows, mom_meta, compact):
        n_roles, p_pages = tables.shape
        nb_dd = arenas[6].shape[1] if dd_rows else 0
        scr = [0] * MAX_ROLES
        if compact:
            at = scratch.data_ptr()
            for r, k in _scratch_roles(p_pages * page_rows, len(edges),
                                       dd_rows, nb_dd):
                scr[r] = at
                at += 4 * k
        arena = [a.data_ptr() for a in arenas]
        block = struct.pack(f"={1 + 2 * MAX_ROLES}Q", tables.data_ptr(),
                            *arena, *[0] * (MAX_ROLES - n_roles), *scr) \
            + _pfu_params(n_roles, p_pages, page_rows, edges, gamma,
                          min_value, dd_rows, nb_dd, mom_rows, mom_meta,
                          compact)
        self.buf = ctypes.create_string_buffer(block, len(block))
        self.block = ctypes.addressof(self.buf)
        self.block_bytes = len(block)


_plans: dict[tuple, _Plan] = {}


def paged_fused_update(tables: torch.Tensor, slots: torch.Tensor,
                       vals: torch.Tensor, arenas: Sequence[torch.Tensor], *,
                       page_rows: int, edges: tuple, gamma: float,
                       min_value: float, dd_rows: int, mom_rows: int = 0,
                       mom_meta: "tuple | None" = None,
                       compact: bool = False,
                       scratch: "torch.Tensor | None" = None) -> None:
    """Update the span-metrics plane family in place.

      tables  [R, P] int32 — per-role page tables, padded with -1; R is 5
              (calls, hist_sums, hist_counts, sizes, hist_buckets), +2
              with dd_rows > 0 (dd_zeros, dd_counts), +1 with mom_rows > 0
              (moments [rows, k+3], mom_meta = (k, lo, hi)).
      slots   [N] int32, or f32 (a row of the packed [4, N] batch);
              negative = discard.
      vals    [3, N] f32 — dur_s, size, weight.
      arenas  the role arenas, each a whole number of pages (its own row
              count: the pool's arenas share one, dense state's sketch
              arenas cover only dd_rows) that holds every page its table
              row names. f32, or under `compact` int32 counts, the latency
              sum as a bf16 [rows, 2] Kahan pair, sizes and moments f32.
      scratch under `compact` on the card: the caller's all-zero working
              memory from `compact_scratch`, left all zero (checked when
              given; the plain version needs none).

    CPU tensors run `paged_fused_update_plain`; CUDA tensors launch the
    kernels on the current stream (no synchronisation) or raise. The
    tables, arenas and scratch are validated once per set of tensor
    objects (the port never changes a tensor's storage, dtype or shape in
    place), the tables' entries against the arenas on a host copy of the
    tables as they are then (a caller that rewrites its tables in place,
    as the page pool's processors do, keeps them within the arenas); the
    batch on every call."""
    edges = edges if type(edges) is tuple else tuple(edges)
    dev = arenas[0].device
    if dev.type == "cpu":
        _check_state(tables, arenas, page_rows, edges, dd_rows, mom_rows,
                     mom_meta, compact, scratch)
        _check_batch(slots, vals, dev)
        paged_fused_update_plain(
            tables, slots, vals, arenas, page_rows=page_rows, edges=edges,
            gamma=gamma, min_value=min_value, dd_rows=dd_rows,
            mom_rows=mom_rows, mom_meta=mom_meta)
        return
    # a plan is keyed by the tensors' identities and holds weak references
    # to them: a tensor that died cannot lend its id to a stale plan
    tensors = (tables, *arenas) if scratch is None else \
        (tables, *arenas, scratch)
    key = (page_rows, edges, gamma, min_value, dd_rows, mom_rows, mom_meta,
           compact, *map(id, tensors))
    plan = _plans.get(key)
    if plan is None or not all(r() is t for r, t in zip(plan.refs, tensors)):
        if dev.type != "cuda":
            raise ValueError(f"paged_fused_update: unsupported device {dev}")
        _check_state(tables, arenas, page_rows, edges, dd_rows, mom_rows,
                     mom_meta, compact, scratch)
        if compact and scratch is None:
            raise ValueError("paged_fused_update: compact state on the card "
                             "needs the caller's scratch (compact_scratch)")
        if mom_rows and tables.numel() * 4 > MAX_TABLE_BYTES:
            raise ValueError(f"tables {tuple(tables.shape)} take "
                             f"{tables.numel() * 4} B of shared memory (at "
                             f"most {MAX_TABLE_BYTES} with the moments row)")
        if len(_plans) >= 64:
            _plans.clear()
        plan = _plans[key] = _Plan(tables, arenas, scratch, page_rows, edges,
                                   gamma, min_value, dd_rows, mom_rows,
                                   mom_meta, compact)
        plan.refs = [weakref.ref(t) for t in tensors]
        paged_fused_update.plans += 1
    _check_batch(slots, vals, dev)
    n = slots.shape[0]
    if not n and not compact:
        return
    lib = _lib("paged_fused_update")
    f32_slots = slots.dtype == torch.float32
    args = (plan.block, plan.block_bytes, n,
            slots.data_ptr() if f32_slots else None,
            None if f32_slots else slots.data_ptr(), vals.data_ptr())
    if dev.index == torch.cuda.current_device():
        code = lib.paged_fused_update_launch(
            *args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            code = lib.paged_fused_update_launch(
                *args, torch._C._cuda_getCurrentRawStream(dev.index))
    if code != 0:
        if compact:   # a pass may have run: restore the all-zero invariant
            scratch.zero_()
        _raise_on(lib, code, "paged_fused_update")
    paged_fused_update.launches += (1 if n else 0) + (1 if compact else 0)


paged_fused_update.launches = 0
paged_fused_update.plans = 0     # launch plans built (validated sets)


# ---------------------------------------------------------------------------
# K2: the dense fused span-metrics delta
# ---------------------------------------------------------------------------

K2_BLOCK = 256             # FSM_BLOCK in the source
K2_VECTOR = 4              # floats in one vector atomic (a 16 B quad)
# four spans a thread (16 B loads) from a batch that still gives each of
# an H100's 132 SMs a block that way; below it one, so that a small batch
# spreads over the card
K2_SPT4_MIN_SPANS = 4 * K2_BLOCK * 132


class K2Layout(NamedTuple):
    """What K2's launch function does for a batch (`k2_layout`)."""
    row_stride: int        # floats per output row, len(edges) + 4
    vector: int            # floats per vector atomic, on 16 B quads of the
                           # flat output (a row need not start on one)
    spans_per_thread: int
    block: int             # threads per block
    blocks: int            # blocks of the span pass (0: no pass)
    smem_bytes: int        # shared memory per block
    launches: int          # device operations: the zeroing, the span pass


def _k2_spans_per_thread(n: int) -> int:
    return 4 if n >= K2_SPT4_MIN_SPANS else 1


def k2_layout(n: int, n_series: int, n_edges: int) -> K2Layout:
    """The choices K2 makes for `n` spans into [n_series, n_edges + 4]:
    one zeroing of the whole output, then, when there are spans, one pass
    of 1 or 4 spans a thread (the wrapper passes the count to
    `fused_spanmetrics_launch`, which sizes its grid from it) that may
    add into any row: no series tiles, so no tile split."""
    spt = _k2_spans_per_thread(n)
    blocks = -(-n // (spt * K2_BLOCK))
    return K2Layout(row_stride=n_edges + 4, vector=K2_VECTOR,
                    spans_per_thread=spt, block=K2_BLOCK, blocks=blocks,
                    smem_bytes=0, launches=1 + (blocks > 0))


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


# the kernel's parameter block, `FsmParams` in the source, field by field
_K2_FIELDS = (("n_series", "i"), ("n_edges", "i"), ("edges", f"{MAX_EDGES}f"))
_K2_FORMAT = "=" + "".join(t for _, t in _K2_FIELDS)
# (n_series, edges) -> (buffer, address, bytes) of a packed FsmParams
_k2_params: dict[tuple, tuple] = {}


def _k2_params_of(n_series: int, edges: tuple) -> tuple:
    key = (n_series, edges)
    got = _k2_params.get(key)
    if got is None:
        if n_series < 0 or len(edges) > MAX_EDGES:
            raise ValueError(f"fused_spanmetrics_matmul: n_series {n_series} "
                             f"and {len(edges)} histogram edges (at most "
                             f"{MAX_EDGES})")
        e = [float(x) for x in edges] + [0.0] * (MAX_EDGES - len(edges))
        block = struct.pack(_K2_FORMAT, n_series, len(edges), *e)
        buf = ctypes.create_string_buffer(block, len(block))
        if len(_k2_params) >= 64:
            _k2_params.clear()
        got = _k2_params[key] = (buf, ctypes.addressof(buf), len(block))
    return got


def fused_spanmetrics_matmul(slots: torch.Tensor, dur_s: torch.Tensor,
                             sizes: torch.Tensor, weights: torch.Tensor, *,
                             n_series: int, edges: tuple) -> torch.Tensor:
    """The fused span-metrics delta of one batch, a fresh [n_series, 3 +
    len(edges) + 1] f32 tensor (see `fused_spanmetrics_scatter`). `slots`
    int32 [N], the rest f32 [N]. CPU tensors run the plain version; CUDA
    tensors launch K2 (the zeroing and the span pass, `k2_layout`) on the
    current stream, with no synchronisation, or raise. The parameter
    block is packed and checked once per (n_series, edges); the batch is
    checked on every call."""
    f32 = torch.float32
    shape = slots.shape
    if slots.dtype is not torch.int32 or dur_s.dtype is not f32 or \
            sizes.dtype is not f32 or weights.dtype is not f32 or \
            len(shape) != 1 or not (dur_s.shape == sizes.shape ==
                                    weights.shape == shape):
        raise ValueError("fused_spanmetrics_matmul: int32 slots and f32 "
                         "values, all 1-D of one length")
    dev = dur_s.device
    if slots.device != dev or sizes.device != dev or weights.device != dev \
            or not (slots.is_contiguous() and dur_s.is_contiguous()
                    and sizes.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fused_spanmetrics_matmul: contiguous tensors on "
                         "one device")
    edges = edges if type(edges) is tuple else tuple(edges)
    if dev.type == "cpu":
        if len(edges) > MAX_EDGES:
            raise ValueError(f"{len(edges)} histogram edges (at most "
                             f"{MAX_EDGES})")
        return fused_spanmetrics_scatter(slots, dur_s, sizes, weights,
                                         n_series=n_series, edges=edges)
    if dev.type != "cuda":
        raise ValueError(f"fused_spanmetrics_matmul: unsupported device {dev}")
    _, params, params_bytes = _k2_params_of(n_series, edges)
    out = torch.empty((n_series, len(edges) + 4), dtype=f32, device=dev)
    lib = _lib("fused_spanmetrics")
    n = shape[0]
    args = (params, params_bytes, n, _k2_spans_per_thread(n),
            slots.data_ptr(), dur_s.data_ptr(), sizes.data_ptr(),
            weights.data_ptr(), out.data_ptr())
    if dev.index == torch.cuda.current_device():
        code = lib.fused_spanmetrics_launch(
            *args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            code = lib.fused_spanmetrics_launch(
                *args, torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_on(lib, code, "fused_spanmetrics_matmul")
    # k2_layout(n, ...).launches: the zeroing, and the span pass if n > 0
    fused_spanmetrics_matmul.launches += 2 if n else 1
    return out


fused_spanmetrics_matmul.launches = 0

# every kernel wrapper of the package, for launch accounting
WRAPPERS = (paged_fused_update, fused_spanmetrics_matmul)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


__all__ = ["paged_fused_update", "paged_fused_update_plain", "compact_scratch",
           "fused_spanmetrics_matmul", "fused_spanmetrics_scatter", "k2_layout",
           "K2Layout", "build",
           "build_all", "BUILD_INFO", "BUILD_DIR", "SOURCES",
           "WRAPPERS", "reset_launch_counts"]
