"""The C++ host layer: builds `native.cpp` with g++ and binds it with ctypes.

Counterpart of `tempo_tpu/native/__init__.py`, with the same record
dtypes and entry points over the same C ABI, so both packages stage the
same OTLP bytes into the same records. The port has no Python fallback
and no switch to one: the library is built when this module is imported
(`import tempo_tpu_torch` imports it), and a failed build raises with
the compiler's log.

Build: `g++ -O3 -march=native -pthread -shared -fPIC`, the reference's
flags (the duration column is computed in C++, so its bits follow them),
into `build/` at the repository root. The file name is keyed by a hash
of the source, the flags, the compiler's version and the host CPU, so a
build made for one CPU never loads on another; the compiler writes a
pid-unique temporary file that is renamed into place, so processes that
build at once do not race.

Locks: every entry point is bound through `ctypes.CDLL`, which releases
the interpreter lock for the call, so staging in one thread runs beside
Python in the others (`otlp_stage_mt` and `otlp_scan_mt` also fan a
large payload's ResourceSpans over threads of their own).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-march=native", "-pthread", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: "ctypes.CDLL | None" = None
# the path and seconds of the build this process made ({} when it found one)
BUILD_INFO: dict = {}

# numpy mirror of SpanRec (padding-free C layout, see native.cpp)
SPAN_REC_DTYPE = np.dtype([
    ("trace_id", np.uint8, 16),
    ("span_id", np.uint8, 8),
    ("parent_span_id", np.uint8, 8),
    ("start_ns", np.uint64),
    ("end_ns", np.uint64),
    ("name_off", np.int64),
    ("status_msg_off", np.int64),
    ("res_off", np.int64),
    ("span_off", np.int64),
    ("name_len", np.int32),
    ("status_msg_len", np.int32),
    ("res_len", np.int32),
    ("span_len", np.int32),
    ("kind", np.int32),
    ("status_code", np.int32),
    ("tid_len", np.int32),
    ("sid_len", np.int32),
    ("pid_len", np.int32),
    ("_pad", np.int32),
])
assert SPAN_REC_DTYPE.itemsize == 120

ATTR_REC_DTYPE = np.dtype([
    ("key_off", np.int64),
    ("sval_off", np.int64),
    ("ival", np.int64),
    ("fval", np.float64),
    ("key_len", np.int32),
    ("sval_len", np.int32),
    ("typ", np.int32),
    ("span_idx", np.int32),
])
assert ATTR_REC_DTYPE.itemsize == 48

# numpy mirrors of the otlp_stage output records (see native.cpp)
STAGE_REC_DTYPE = np.dtype([
    ("trace_id", np.uint8, 16),
    ("span_id", np.uint8, 8),
    ("parent_span_id", np.uint8, 8),
    ("start_ns", np.uint64),
    ("end_ns", np.uint64),
    ("name_id", np.int32),
    ("status_msg_id", np.int32),
    ("service_id", np.int32),
    ("res_idx", np.int32),
    ("kind", np.int32),
    ("status_code", np.int32),
    ("span_len", np.int32),
    ("tid_len", np.int32),
    ("sid_len", np.int32),
    ("pid_len", np.int32),
])
assert STAGE_REC_DTYPE.itemsize == 88

STAGE_ATTR_DTYPE = np.dtype([
    ("sval_off", np.int64),
    ("ival", np.int64),
    ("fval", np.float64),
    ("sval_len", np.int32),
    ("key_id", np.int32),
    ("sval_id", np.int32),
    ("typ", np.int32),
    ("owner", np.int32),
    ("_pad", np.int32),
])
assert STAGE_ATTR_DTYPE.itemsize == 48

STAGE_RES_DTYPE = np.dtype([
    ("service_id", np.int32),
    ("attr_start", np.int32),
    ("attr_count", np.int32),
    ("_pad", np.int32),
])
assert STAGE_RES_DTYPE.itemsize == 16

EV_REC_DTYPE = np.dtype([
    ("name_off", np.int64),
    ("time_ns", np.uint64),
    ("name_len", np.int32),
    ("span_idx", np.int32),
])
assert EV_REC_DTYPE.itemsize == 24

LINK_REC_DTYPE = np.dtype([
    ("trace_id", np.uint8, 16),
    ("span_id", np.uint8, 8),
    ("span_idx", np.int32),
    ("tid_len", np.int32),
    ("sid_len", np.int32),
    ("_pad", np.int32),
])
assert LINK_REC_DTYPE.itemsize == 40


# -- build -------------------------------------------------------------------

_CPU_KEYS = ("vendor_id", "cpu family", "model", "model name", "stepping",
             "flags", "Features", "CPU implementer", "CPU architecture",
             "CPU variant", "CPU part")


def _host_cpu() -> str:
    """The first processor's identity and feature flags, which decide what
    `-march=native` emits."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    first = text.split("\n\n", 1)[0]
    return "\n".join(line for line in first.splitlines()
                     if line.split(":", 1)[0].strip() in _CPU_KEYS)


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the port's C++ host layer "
                           "(tempo_tpu_torch/native/native.cpp) needs it")
    return found


def so_path(build_dir: "Path | str" = BUILD_DIR) -> Path:
    """The library's path for this source, these flags, this compiler and
    this host CPU."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    digest = hashlib.sha256(b"\0".join((
        _SRC.read_bytes(), " ".join(CXX_FLAGS).encode(), version.encode(),
        _host_cpu().encode())))
    return Path(build_dir) / f"tempo_native-{digest.hexdigest()[:16]}.so"


def build(build_dir: "Path | str" = BUILD_DIR) -> Path:
    """Compile `native.cpp` into `build_dir` unless this exact build is
    there; return its path. Raises with the compiler's log on failure."""
    import time

    so = so_path(build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")   # concurrent builds race
    t0 = time.perf_counter()
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {_SRC}:\n{proc.stdout}")
    os.replace(tmp, so)
    BUILD_INFO.update(path=str(so), seconds=time.perf_counter() - t0)
    return so


def load() -> ctypes.CDLL:
    """The bound library, built and loaded on the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def library_path() -> str:
    """The path of the loaded library."""
    return load()._name


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    u8p, i32p, i64p = (c.POINTER(c.c_uint8), c.POINTER(c.c_int32),
                       c.POINTER(c.c_int64))
    lib.fnv1_tokens.argtypes = [
        c.c_char_p, c.c_int64, u8p, c.c_int64, c.c_int64,
        c.POINTER(c.c_uint32)]
    lib.fnv1_tokens.restype = None
    lib.crc32c.argtypes = [c.c_char_p, c.c_int64]
    lib.crc32c.restype = c.c_uint32
    lib.group_keys.argtypes = [u8p, c.c_int64, c.c_int32, i32p, i32p]
    lib.group_keys.restype = c.c_int64
    lib.otlp_scan.argtypes = [u8p, c.c_int64, c.c_void_p, c.c_int64]
    lib.otlp_scan.restype = c.c_int64
    lib.otlp_scan_mt.argtypes = [
        u8p, c.c_int64, c.c_void_p, c.c_int64, c.c_int32]
    lib.otlp_scan_mt.restype = c.c_int64
    lib.otlp_scan2.argtypes = [
        u8p, c.c_int64, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_int64, i64p]
    lib.otlp_scan2.restype = c.c_int64
    # interner
    lib.interner_new.restype = c.c_void_p
    lib.interner_free.argtypes = [c.c_void_p]
    lib.interner_intern.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.interner_intern.restype = c.c_int32
    lib.interner_find.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.interner_find.restype = c.c_int32
    lib.interner_count.argtypes = [c.c_void_p]
    lib.interner_count.restype = c.c_int64
    lib.interner_dump.argtypes = [
        c.c_void_p, c.c_int32, c.c_int32, u8p, c.c_int64, i32p]
    lib.interner_dump.restype = c.c_int64
    # row table
    lib.rowtable_new.argtypes = [c.c_int32]
    lib.rowtable_new.restype = c.c_void_p
    lib.rowtable_free.argtypes = [c.c_void_p]
    lib.rowtable_lookup.argtypes = [
        c.c_void_p, i32p, c.c_int64, u8p, i32p, i64p, c.c_int64]
    lib.rowtable_lookup.restype = c.c_int64
    lib.rowtable_insert.argtypes = [c.c_void_p, i32p, c.c_int32]
    lib.rowtable_insert.restype = None
    lib.rowtable_remove.argtypes = [c.c_void_p, i32p]
    lib.rowtable_remove.restype = None
    lib.rowtable_size.argtypes = [c.c_void_p]
    lib.rowtable_size.restype = c.c_int64
    lib.otlp_events.argtypes = [
        u8p, c.c_int64, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_int64, i64p]
    lib.otlp_events.restype = c.c_int32
    # full staging
    lib.otlp_stage.argtypes = [
        c.c_void_p, u8p, c.c_int64,
        c.c_void_p, c.c_int64, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_int64, c.c_void_p, c.c_int64,
        c.c_int32, i64p]
    lib.otlp_stage.restype = c.c_int32
    lib.otlp_stage_mt.argtypes = [
        c.c_void_p, u8p, c.c_int64,
        c.c_void_p, c.c_int64, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_int64,
        c.c_int32, i64p, c.c_int32]
    lib.otlp_stage_mt.restype = c.c_int32
    lib.spanmetrics_resolve.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64,      # table, spans, n
        i32p, c.c_int32, i32p, i32p,            # dims, kind/status
        c.c_int64, c.c_int64, c.c_double,       # slack lo/hi, now
        c.POINTER(c.c_double),                  # last_seen
        i32p, c.c_void_p, c.c_void_p,           # slots, dur, size
        i32p, u8p, i64p, c.c_int64, i64p]       # rows, valid, miss
    lib.spanmetrics_resolve.restype = c.c_int64
    lib.spanmetrics_from_recs.argtypes = [
        c.c_void_p, c.c_void_p, u8p, c.c_int64,  # table, it, buf
        c.c_void_p, c.c_int64,                   # recs, n
        i32p, c.c_int32, i32p, i32p,             # dims, kind/status
        c.c_int64, c.c_int64, c.c_double,        # slack, now
        c.POINTER(c.c_double),                   # last_seen
        i32p, c.c_void_p, c.c_void_p,            # slots, dur, size
        i32p, u8p, i64p, c.c_int64, i64p]        # rows, valid, miss
    lib.spanmetrics_from_recs.restype = c.c_int64
    lib.group_keys_recs.argtypes = [
        c.c_void_p, c.c_int64, u8p, i32p, i32p]
    lib.group_keys_recs.restype = c.c_int64
    lib.group_keys_strided.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_int64,
        u8p, i32p, i32p]
    lib.group_keys_strided.restype = c.c_int64
    # service-graph edge store
    lib.sg_store_new.restype = c.c_void_p
    lib.sg_store_free.argtypes = [c.c_void_p]
    lib.sg_store_size.argtypes = [c.c_void_p]
    lib.sg_store_size.restype = c.c_int64
    lib.sg_store_pending.argtypes = [c.c_void_p]
    lib.sg_store_pending.restype = c.c_int64
    lib.sg_match.argtypes = [
        c.c_void_p, c.c_int64, u8p, u8p, u8p,   # store, n, ids
        i32p, u8p, i32p, i64p, i64p, i32p,      # kind .. status
        i32p, c.c_double, c.c_int64,            # peer, expire_at, max
        i32p, i32p, u8p, c.c_void_p, c.c_void_p,  # edge columns
        u8p, c.c_void_p, i64p]                  # failed, delay, dropped
    lib.sg_match.restype = c.c_int64
    lib.sg_expire.argtypes = [
        c.c_void_p, c.c_double, c.c_int64,
        u8p, i32p, i32p, c.c_void_p, u8p]
    lib.sg_expire.restype = c.c_int64
    return lib


def crc32c(data: bytes) -> int:
    """Castagnoli CRC (kafka record batches)."""
    return int(_LIB.crc32c(data, len(data)))


# -- fnv tokens --------------------------------------------------------------

def token_for(tenant: str, trace_ids: np.ndarray) -> np.ndarray:
    """`TokenFor` over a batch of trace ids: fnv1-32 of tenant ‖ id."""
    tids = np.ascontiguousarray(trace_ids, np.uint8)
    if tids.ndim == 1:
        tids = tids[None, :]
    out = np.empty(tids.shape[0], np.uint32)
    tb = tenant.encode()
    _LIB.fnv1_tokens(
        tb, len(tb),
        tids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tids.shape[0], tids.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


# -- OTLP scan ---------------------------------------------------------------

def group_keys(keys: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Group [n, k] uint8 fixed-width keys in first-occurrence order.

    Returns (first_idx[int32, n_uniq], inverse[int32, n]): the O(n) hash
    replacement for `np.unique` over void views (which argsorts)."""
    keys = np.ascontiguousarray(keys, np.uint8)
    n, k = keys.shape
    inverse = np.empty(n, np.int32)
    first = np.empty(max(n, 1), np.int32)
    got = _LIB.group_keys(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, k,
        inverse.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return first[:got], inverse


_SCAN_THREADS = min(8, os.cpu_count() or 1)
_SCAN_MT_BYTES = 256 << 10        # payloads below this stay single-thread
# adaptive capacity hints: start where the last payload ended so steady
# traffic never pays the scan-twice-regrow pass
_CAP_HINTS: dict = {}


def otlp_scan(data: bytes, cap_hint: "int | None" = None) -> np.ndarray:
    """Single-pass OTLP proto scan → SpanRec structured array.

    Large payloads fan ResourceSpans ranges across threads (the
    interpreter lock is released inside the ctypes call); output order
    matches the sequential scan exactly. Raises ValueError on malformed
    input."""
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    # an EXPLICIT cap_hint is honored exactly (tests exercise the regrow
    # branch with it); only the default consults the adaptive hint
    cap = cap_hint if cap_hint is not None else max(
        _CAP_HINTS.get("scan", 4096), 16)
    cap = max(cap, 16)
    mt = len(data) >= _SCAN_MT_BYTES and _SCAN_THREADS > 1
    while True:
        recs = np.empty(cap, SPAN_REC_DTYPE)   # scan fills every used rec
        if mt:
            n = _LIB.otlp_scan_mt(bp, len(data), recs.ctypes.data, cap,
                                  _SCAN_THREADS)
        else:
            n = _LIB.otlp_scan(bp, len(data), recs.ctypes.data, cap)
        if n < 0:
            raise ValueError("malformed OTLP protobuf payload")
        if n <= cap:
            # 25% headroom + a floor: size jitter must not re-trigger
            # the scan-twice regrow this hint exists to kill
            _CAP_HINTS["scan"] = max(4096, int(n) * 5 // 4)
            if n * 4 < cap:
                # don't let a small result pin a hint-inflated buffer
                return recs[:n].copy()
            return recs[:n]
        cap = int(n)


def otlp_scan2(data: bytes, cap_hint: int = 4096
               ) -> tuple[np.ndarray, np.ndarray]:
    """Single-pass scan → (SpanRec array, AttrRec array); ValueError on
    malformed input."""
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    cap, attr_cap = max(cap_hint, 16), max(cap_hint * 4, 64)
    while True:
        recs = np.zeros(cap, SPAN_REC_DTYPE)
        attrs = np.zeros(attr_cap, ATTR_REC_DTYPE)
        n_attrs = ctypes.c_int64(0)
        n = _LIB.otlp_scan2(bp, len(data), recs.ctypes.data, cap,
                            attrs.ctypes.data, attr_cap,
                            ctypes.byref(n_attrs))
        if n < 0:
            raise ValueError("malformed OTLP protobuf payload")
        if n <= cap and n_attrs.value <= attr_cap:
            return recs[:n], attrs[: n_attrs.value]
        cap = max(cap, int(n))
        attr_cap = max(attr_cap, int(n_attrs.value))


# -- persistent interner / row table ----------------------------------------

class NativeInterner:
    """Handle on the C++ string intern table (bytes → dense int32 id).

    The Python StringInterner fronts this with a str-keyed cache and a
    lazily synced id → str mirror; see tempo_tpu_torch.model.interner."""

    __slots__ = ("_h", "_lib")

    def __init__(self) -> None:
        self._lib = _LIB
        self._h = ctypes.c_void_p(_LIB.interner_new())

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.interner_free(h)

    def intern_bytes(self, b: bytes) -> int:
        return int(self._lib.interner_intern(self._h, b, len(b)))

    def find_bytes(self, b: bytes) -> int:
        return int(self._lib.interner_find(self._h, b, len(b)))

    def count(self) -> int:
        return int(self._lib.interner_count(self._h))

    def dump(self, first: int, n: int) -> list[bytes]:
        """Strings [first, first+n) as raw bytes (mirror sync)."""
        if n <= 0:
            return []
        cap = max(n * 16, 1024)
        lens = np.empty(n, np.int32)
        while True:
            out = np.empty(cap, np.uint8)
            got = self._lib.interner_dump(
                self._h, first, n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if got == -1:
                raise IndexError(f"interner_dump [{first}, {first + n})")
            if got < 0:
                cap = -got
                continue
            buf = out.tobytes()
            res, o = [], 0
            for ln in lens.tolist():
                res.append(buf[o:o + ln])
                o += ln
            return res


class NativeRowTable:
    """Handle on the C++ label-row → slot table (series resolution)."""

    __slots__ = ("_h", "_lib", "n_labels")

    def __init__(self, n_labels: int) -> None:
        self._lib = _LIB
        self.n_labels = n_labels
        self._h = ctypes.c_void_p(_LIB.rowtable_new(n_labels))

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.rowtable_free(h)

    def lookup(self, rows: np.ndarray, valid: np.ndarray | None
               ) -> tuple[np.ndarray, np.ndarray]:
        """(slots [n] int32 with -1 unresolved, miss first-occurrence idx).

        Every reported miss MUST be resolved via insert() or remove()
        before the next lookup (pending entries are not re-reported)."""
        rows = np.ascontiguousarray(rows, np.int32)
        n = rows.shape[0]
        out = np.empty(n, np.int32)
        miss = np.empty(n, np.int64)
        vp = None
        if valid is not None:
            vbuf = np.ascontiguousarray(valid, np.uint8)
            vp = vbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        n_miss = self._lib.rowtable_lookup(
            self._h, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            vp, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            miss.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
        return out, miss[:n_miss]

    def insert(self, row: np.ndarray, slot: int) -> None:
        row = np.ascontiguousarray(row, np.int32)
        self._lib.rowtable_insert(
            self._h, row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            slot)

    def remove(self, row: np.ndarray) -> None:
        row = np.ascontiguousarray(row, np.int32)
        self._lib.rowtable_remove(
            self._h, row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    def size(self) -> int:
        return int(self._lib.rowtable_size(self._h))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _column(a: np.ndarray, dtype, n: int, width: int = 0) -> np.ndarray:
    """`a` as a C-contiguous `dtype` array of at least n rows (of `width`
    bytes when given), or ValueError."""
    a = np.ascontiguousarray(a, dtype)
    if a.shape[0] < n or (width and a.shape[1:] != (width,)):
        raise ValueError(f"column of shape {a.shape} for {n} rows"
                         + (f" of width {width}" if width else ""))
    return a


class EdgeStore:
    """Handle on the C++ service-graph half-edge store (`sg_match`,
    `sg_expire` in native.cpp): 24-byte span keys -> the half-edge waiting
    for its other side, and the FIFO of their expiry times. `len()` is the
    number of half-edges held, and may be read from any thread; the caller
    serialises `match` and `expire`."""

    __slots__ = ("_h", "_lib")

    def __init__(self) -> None:
        self._lib = _LIB
        self._h = ctypes.c_void_p(_LIB.sg_store_new())

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.sg_store_free(h)

    def __len__(self) -> int:
        return int(self._lib.sg_store_size(self._h))

    def pending(self) -> int:
        """Expiry entries queued, those of keys matched since included."""
        return int(self._lib.sg_store_pending(self._h))

    def match(self, trace_id, span_id, parent_span_id, kind, valid, service,
              start_ns, end_ns, status, peer, expire_at: float,
              max_items: int):
        """Pairs the spans of one batch (columns of its rows) through the
        store. Returns (client, server, conn, client_s, server_s, failed,
        delay) over the completed edges, conn 1 for a messaging pair and
        0 otherwise, and the count of spans dropped."""
        n = int(np.shape(kind)[0])
        cols = (_column(trace_id, np.uint8, n, 16),
                _column(span_id, np.uint8, n, 8),
                _column(parent_span_id, np.uint8, n, 8))
        kind, service, status, peer = (_column(a, np.int32, n) for a in (
            kind, service, status, peer))
        valid = _column(valid, np.bool_, n)
        start_ns, end_ns = (_column(a, np.int64, n) for a in (start_ns,
                                                              end_ns))
        client, server = np.empty(n, np.int32), np.empty(n, np.int32)
        conn, failed = np.empty(n, np.uint8), np.empty(n, np.bool_)
        client_s, server_s, delay = (np.empty(n, np.float32)
                                     for _ in range(3))
        dropped = np.zeros(1, np.int64)
        u8, i32, i64 = ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64
        m = self._lib.sg_match(
            self._h, n, *(_ptr(a, u8) for a in cols), _ptr(kind, i32),
            _ptr(valid, u8), _ptr(service, i32), _ptr(start_ns, i64),
            _ptr(end_ns, i64), _ptr(status, i32), _ptr(peer, i32),
            float(expire_at), int(max_items), _ptr(client, i32),
            _ptr(server, i32), _ptr(conn, u8), client_s.ctypes.data,
            server_s.ctypes.data, _ptr(failed, u8), delay.ctypes.data,
            _ptr(dropped, i64))
        edges = tuple(a[:m] for a in (client, server, conn, client_s,
                                       server_s, failed, delay))
        return edges, int(dropped[0])

    def expire(self, now: float):
        """Evicts the half-edges whose expiry is due at `now`. Returns
        (is_client, service, peer, seconds, failed) over them, in the
        order their expiry entries were queued."""
        cap = len(self)
        is_client, failed = np.empty(cap, np.bool_), np.empty(cap, np.bool_)
        service, peer = np.empty(cap, np.int32), np.empty(cap, np.int32)
        dur_s = np.empty(cap, np.float32)
        u8, i32 = ctypes.c_uint8, ctypes.c_int32
        m = self._lib.sg_expire(
            self._h, float(now), cap, _ptr(is_client, u8),
            _ptr(service, i32), _ptr(peer, i32), dur_s.ctypes.data,
            _ptr(failed, u8))
        return is_client[:m], service[:m], peer[:m], dur_s[:m], failed[:m]


def otlp_stage(interner: "NativeInterner", data: bytes,
               cap_hint: "int | None" = None, skip_span_attrs: bool = False,
               trust_attrs: bool = False):
    """One-pass OTLP bytes → interned columns.

    Returns (spans StageRec[], span_attrs StageAttr[], res_attrs
    StageAttr[], resources StageRes[]). Raises ValueError on malformed
    input. With `skip_span_attrs` the scan validates span attributes but
    neither interns nor emits them (intrinsic-dims-only callers);
    `trust_attrs` additionally skips that validation: ONLY for bytes
    already validated in this process."""
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    flags = (1 if skip_span_attrs else 0) | \
        (2 if trust_attrs and skip_span_attrs else 0)
    hint_key = "stage_skip" if skip_span_attrs else "stage_full"
    cap = cap_hint if cap_hint is not None else max(
        _CAP_HINTS.get(hint_key, 4096), 16)
    cap = max(cap, 16)
    acap = 16 if skip_span_attrs else max(
        cap * 4, _CAP_HINTS.get("stage_attrs", 64))
    rcap, rescap = 256, 64
    mt = (skip_span_attrs and len(data) >= _SCAN_MT_BYTES
          and _SCAN_THREADS > 1)
    while True:
        # stage fills every record it emits: empty alloc, no MB memsets
        spans = np.empty(cap, STAGE_REC_DTYPE)
        sattrs = np.empty(acap, STAGE_ATTR_DTYPE)
        rattrs = np.empty(rcap, STAGE_ATTR_DTYPE)
        res = np.empty(rescap, STAGE_RES_DTYPE)
        n_out = np.zeros(4, np.int64)
        if mt:
            # parallel staging (skip-attrs shapes): ResourceSpans ranges
            # fan across threads with thread-local intern memos
            rc = _LIB.otlp_stage_mt(
                interner._h, bp, len(data),
                spans.ctypes.data, cap,
                rattrs.ctypes.data, rcap, res.ctypes.data, rescap,
                flags, n_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                _SCAN_THREADS)
        else:
            rc = _LIB.otlp_stage(
                interner._h, bp, len(data),
                spans.ctypes.data, cap, sattrs.ctypes.data, acap,
                rattrs.ctypes.data, rcap, res.ctypes.data, rescap,
                flags, n_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            raise ValueError("malformed OTLP protobuf payload")
        ns, na, nr, nres = (int(x) for x in n_out)
        if ns <= cap and na <= acap and nr <= rcap and nres <= rescap:
            _CAP_HINTS[hint_key] = max(4096, ns * 5 // 4)
            if not skip_span_attrs:
                _CAP_HINTS["stage_attrs"] = max(256, na * 5 // 4)
            out = (spans[:ns], sattrs[:na], rattrs[:nr], res[:nres])
            if ns * 4 < cap:
                out = tuple(a.copy() for a in out)
            return out
        cap, acap = max(cap, ns), max(acap, na)
        rcap, rescap = max(rcap, nr), max(rescap, nres)


def otlp_events(data: bytes, ev_hint: int = 256, link_hint: int = 64
                ) -> tuple[np.ndarray, np.ndarray]:
    """Span events + links keyed by span index (EvRec/LinkRec arrays)."""
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    ecap, lcap = max(ev_hint, 16), max(link_hint, 16)
    while True:
        evs = np.zeros(ecap, EV_REC_DTYPE)
        links = np.zeros(lcap, LINK_REC_DTYPE)
        n_out = np.zeros(2, np.int64)
        rc = _LIB.otlp_events(
            bp, len(data), evs.ctypes.data, ecap, links.ctypes.data, lcap,
            n_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            raise ValueError("malformed OTLP protobuf payload")
        ne, nl = int(n_out[0]), int(n_out[1])
        if ne <= ecap and nl <= lcap:
            return evs[:ne], links[:nl]
        ecap, lcap = max(ecap, ne), max(lcap, nl)


def spans_from_otlp_proto_native(data: bytes, return_recs: bool = False):
    """Native scan → flat span dicts (the wire-entry contract of
    `model.otlp.spans_from_otlp_proto`). The C pass extracts every fixed
    field and attribute range; Python only slices strings and builds
    dicts. With `return_recs` returns (dicts, SpanRec array) so the
    caller can reuse the wire offsets without a second scan."""
    from tempo_tpu_torch.model import proto_wire as pw
    from tempo_tpu_torch.model.otlp import _pb_anyvalue, _pb_attrs

    recs, attrs = otlp_scan2(data)

    # columnar extraction (bulk .tolist() beats per-row structured access)
    tid = recs["trace_id"].tobytes()
    sid = recs["span_id"].tobytes()
    pid = recs["parent_span_id"].tobytes()
    name_off = recs["name_off"].tolist(); name_len = recs["name_len"].tolist()
    sm_off = recs["status_msg_off"].tolist(); sm_len = recs["status_msg_len"].tolist()
    res_off = recs["res_off"].tolist(); res_len = recs["res_len"].tolist()
    start = recs["start_ns"].tolist(); end = recs["end_ns"].tolist()
    kind = recs["kind"].tolist(); code = recs["status_code"].tolist()

    res_cache: dict[tuple[int, int], dict] = {}

    def resource_attrs(ro: int, rl: int) -> dict:
        if ro < 0:
            return {}
        key = (ro, rl)
        cached = res_cache.get(key)
        if cached is None:
            cached = res_cache[key] = _pb_attrs(
                [v for f, _, v in pw.iter_fields(data[ro:ro + rl]) if f == 1])
        return cached

    n = len(recs)
    tid_len = recs["tid_len"].tolist()
    sid_len = recs["sid_len"].tolist()
    pid_len = recs["pid_len"].tolist()
    # wire lengths preserved: an absent id slices to b"" and an oversized
    # one to its (uncopied, zeroed) declared size; both match the python
    # decoder's contract so invalid-id validation fires identically on
    # either path
    out = [{
        "trace_id": tid[i * 16: i * 16 + min(tid_len[i], 16)]
        if tid_len[i] <= 16 else b"\x00" * tid_len[i],
        "span_id": sid[i * 8: i * 8 + min(sid_len[i], 8)]
        if sid_len[i] <= 8 else b"\x00" * sid_len[i],
        "parent_span_id": pid[i * 8: i * 8 + min(pid_len[i], 8)]
        if pid_len[i] <= 8 else b"\x00" * pid_len[i],
        "name": data[name_off[i]: name_off[i] + name_len[i]].decode("utf-8", "replace"),
        "service": "",
        "kind": kind[i],
        "status_code": code[i],
        "status_message": data[sm_off[i]: sm_off[i] + sm_len[i]].decode("utf-8", "replace"),
        "start_unix_nano": start[i],
        "end_unix_nano": end[i],
        "attrs": {},
        "res_attrs": None,
    } for i in range(n)]
    for i in range(n):
        ra = resource_attrs(res_off[i], res_len[i])
        out[i]["res_attrs"] = ra
        out[i]["service"] = str(ra.get("service.name", ""))

    # span attrs from the flat attr table
    a_key_off = attrs["key_off"].tolist(); a_key_len = attrs["key_len"].tolist()
    a_sval_off = attrs["sval_off"].tolist(); a_sval_len = attrs["sval_len"].tolist()
    a_fval = attrs["fval"].tolist(); a_ival = attrs["ival"].tolist()
    a_typ = attrs["typ"].tolist(); a_span = attrs["span_idx"].tolist()
    for j in range(len(attrs)):
        ko = a_key_off[j]
        k = data[ko: ko + a_key_len[j]].decode("utf-8", "replace") \
            if ko >= 0 else ""
        t = a_typ[j]
        if t == 1:
            v = data[a_sval_off[j]: a_sval_off[j] + a_sval_len[j]].decode("utf-8", "replace")
        elif t == 2:
            v = bool(a_fval[j])
        elif t == 3:
            v = a_ival[j]  # exact int64 (no double round-trip)
        elif t == 4:
            v = a_fval[j]
        else:
            v = _pb_anyvalue(data[a_sval_off[j]: a_sval_off[j] + a_sval_len[j]]) \
                if a_sval_off[j] >= 0 else None
        out[a_span[j]]["attrs"][k] = v

    # events/links (separate native pass; same span traversal order,
    # which keeps the output contract aligned with the python decoder)
    evs, links = otlp_events(data)
    e_off = evs["name_off"].tolist(); e_len = evs["name_len"].tolist()
    e_t = evs["time_ns"].tolist(); e_s = evs["span_idx"].tolist()
    for j in range(len(evs)):
        o = e_off[j]
        out[e_s[j]].setdefault("events", []).append({
            "time_unix_nano": e_t[j],
            "name": data[o:o + e_len[j]].decode("utf-8", "replace")
            if o >= 0 else ""})
    l_tid = links["trace_id"].tobytes(); l_sid = links["span_id"].tobytes()
    l_tl = links["tid_len"].tolist(); l_sl = links["sid_len"].tolist()
    l_s = links["span_idx"].tolist()
    for j in range(len(links)):
        out[l_s[j]].setdefault("links", []).append({
            "trace_id": l_tid[j * 16: j * 16 + min(l_tl[j], 16)],
            "span_id": l_sid[j * 8: j * 8 + min(l_sl[j], 8)]})
    return (out, recs) if return_recs else out


class ResolveBuffers:
    """One pre-allocated staging-buffer set for the fused spanmetrics
    resolve: the arrays the C++ pass fills and the device dispatch later
    reads. The ingest pipeline recycles these once the dispatch that
    reads them has landed: steady state allocates no new staging memory
    per push."""

    __slots__ = ("cap", "n_labels", "slots", "packed", "rows", "valid",
                 "miss", "counts")

    def __init__(self, cap: int, n_labels: int) -> None:
        self.cap = cap
        self.n_labels = n_labels
        self.slots = np.full(cap, -1, np.int32)
        self.packed = np.zeros((3, cap), np.float32)
        self.rows = np.empty((max(cap, 1), n_labels), np.int32)
        self.valid = np.zeros(cap, np.uint8)
        self.miss = np.empty(max(cap, 1), np.int64)
        self.counts = np.zeros(2, np.int64)

    def reset(self) -> None:
        """Restore the fill values a fresh allocation would carry (the
        previous push's rows beyond the new n must read as padding)."""
        self.slots.fill(-1)
        self.packed.fill(0.0)
        self.valid.fill(0)


def _resolve_arrays(cap: int, n_labels: int, n: int,
                    out: "ResolveBuffers | None"):
    """(slots, packed, rows, valid, miss, counts): from the reusable
    buffer set when one of the right shape is offered, else fresh."""
    if out is not None and out.cap == cap and out.n_labels == n_labels:
        out.reset()
        return (out.slots, out.packed, out.rows[:max(n, 1)], out.valid,
                out.miss, out.counts)
    return (np.full(cap, -1, np.int32), np.zeros((3, cap), np.float32),
            np.empty((max(n, 1), n_labels), np.int32),
            np.zeros(cap, np.uint8), np.empty(max(n, 1), np.int64),
            np.zeros(2, np.int64))


def _check_last_seen(last_seen: "np.ndarray | None"):
    if last_seen is None:
        return None
    if last_seen.dtype != np.float64 or not last_seen.flags.c_contiguous:
        raise ValueError("last_seen must be a C-contiguous float64 array")
    return last_seen.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def spanmetrics_resolve(table: "NativeRowTable", spans: np.ndarray,
                        dims: np.ndarray, kind_lut: np.ndarray,
                        status_lut: np.ndarray, slack_lo: int, slack_hi: int,
                        now: float, last_seen: "np.ndarray | None",
                        cap: int, out: "ResolveBuffers | None" = None):
    """Fused staged-records → device-ready arrays (see native.cpp
    `spanmetrics_resolve`). Returns (slots, packed, rows, valid, miss_idx,
    n_valid, n_filtered): `packed` is the [3, cap] f32 buffer whose rows
    1/2 hold dur_s/sizes (row 0 is left for the caller's f32 slot copy);
    slots/valid are cap-padded (slot tail -1, dropped by the update);
    rows is [n, L] for the miss-resolution pass."""
    n = len(spans)
    if cap < n:
        raise ValueError("cap must be >= len(spans)")
    spans = np.ascontiguousarray(spans)
    if spans.dtype != STAGE_REC_DTYPE:
        raise ValueError(f"spans must be StageRec records, not {spans.dtype}")
    dims = np.ascontiguousarray(dims, np.int32)
    kind_lut = np.ascontiguousarray(kind_lut, np.int32)
    status_lut = np.ascontiguousarray(status_lut, np.int32)
    slots, packed, rows, valid, miss, counts = _resolve_arrays(
        cap, int(dims.shape[0]), n, out)
    dur = packed[1]
    sizes = packed[2]
    i32 = ctypes.POINTER(ctypes.c_int32)
    nm = _LIB.spanmetrics_resolve(
        table._h, spans.ctypes.data, n,
        dims.ctypes.data_as(i32), int(dims.shape[0]),
        kind_lut.ctypes.data_as(i32), status_lut.ctypes.data_as(i32),
        slack_lo, slack_hi, now, _check_last_seen(last_seen),
        slots.ctypes.data_as(i32), dur.ctypes.data, sizes.ctypes.data,
        rows.ctypes.data_as(i32),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(miss),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return (slots, packed, rows, valid, miss[:nm],
            int(counts[0]), int(counts[1]))


def spanmetrics_from_recs(table: "NativeRowTable", interner_h, data: bytes,
                          recs: np.ndarray, dims: np.ndarray,
                          kind_lut: np.ndarray, status_lut: np.ndarray,
                          slack_lo: int, slack_hi: int, now: float,
                          last_seen: "np.ndarray | None", cap: int,
                          out: "ResolveBuffers | None" = None):
    """Scan records (`otlp_scan`) over `data` → device-ready spanmetrics
    arrays (see native.cpp `spanmetrics_from_recs`): the in-process tee
    route skips the second protobuf walk. Same return shape as
    `spanmetrics_resolve`; None when the payload is malformed or needs
    the Python service.name fixup (the caller then takes the full
    staging route, which validates)."""
    n = len(recs)
    if cap < n:
        raise ValueError("cap must be >= len(recs)")
    recs = np.ascontiguousarray(recs)
    if recs.dtype != SPAN_REC_DTYPE:
        raise ValueError(f"recs must be SpanRec records, not {recs.dtype}")
    buf = np.frombuffer(data, np.uint8)
    dims = np.ascontiguousarray(dims, np.int32)
    kind_lut = np.ascontiguousarray(kind_lut, np.int32)
    status_lut = np.ascontiguousarray(status_lut, np.int32)
    slots, packed, rows, valid, miss, counts = _resolve_arrays(
        cap, int(dims.shape[0]), n, out)
    dur = packed[1]
    sizes = packed[2]
    i32 = ctypes.POINTER(ctypes.c_int32)
    nm = _LIB.spanmetrics_from_recs(
        table._h, interner_h, buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), len(data),
        recs.ctypes.data, n,
        dims.ctypes.data_as(i32), int(dims.shape[0]),
        kind_lut.ctypes.data_as(i32), status_lut.ctypes.data_as(i32),
        slack_lo, slack_hi, now, _check_last_seen(last_seen),
        slots.ctypes.data_as(i32), dur.ctypes.data, sizes.ctypes.data,
        rows.ctypes.data_as(i32),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(miss),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if nm < 0:
        return None      # -1 malformed / -2 fixup: the full route re-stages
    return (slots, packed, rows, valid, miss[:nm],
            int(counts[0]), int(counts[1]))


def _grouped(recs: np.ndarray, valid: "np.ndarray | None", call
             ) -> "tuple[np.ndarray, np.ndarray]":
    n = len(recs)
    nv = n if valid is None else int(valid.sum())
    inverse = np.empty(max(nv, 1), np.int32)
    first = np.empty(max(nv, 1), np.int32)
    vp = None
    if valid is not None:
        vbuf = np.ascontiguousarray(valid, np.uint8)
        vp = vbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    i32 = ctypes.POINTER(ctypes.c_int32)
    ng = call(n, vp, inverse.ctypes.data_as(i32), first.ctypes.data_as(i32))
    return first[:ng], inverse[:nv]


def group_keys_recs(recs: np.ndarray, valid: "np.ndarray | None"
                    ) -> "tuple[np.ndarray, np.ndarray]":
    """`group_keys` over (trace_id ‖ tid_len) read straight from SpanRec
    rows, with no key matrix: inverse/first index over the sequence of
    VALID rows."""
    recs = np.ascontiguousarray(recs)
    if recs.dtype != SPAN_REC_DTYPE:
        raise ValueError(f"recs must be SpanRec records, not {recs.dtype}")
    return _grouped(recs, valid, lambda n, vp, inv, first:
                    _LIB.group_keys_recs(recs.ctypes.data, n, vp, inv, first))


def group_keys_strided(recs: np.ndarray, valid: "np.ndarray | None"
                       ) -> "tuple[np.ndarray, np.ndarray]":
    """`group_keys_recs` over any structured dtype carrying `trace_id`
    ([16] u8) and `tid_len` (i32) fields (StageRec rows too)."""
    recs = np.ascontiguousarray(recs)
    fields = recs.dtype.fields
    tid_off = int(fields["trace_id"][1])
    tidlen_off = int(fields["tid_len"][1])
    return _grouped(recs, valid, lambda n, vp, inv, first:
                    _LIB.group_keys_strided(recs.ctypes.data, n,
                                            recs.dtype.itemsize, tid_off,
                                            tidlen_off, vp, inv, first))


load()
