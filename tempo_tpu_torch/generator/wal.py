"""Generator ingest WAL: acked means durable on the metrics write path.

Counterpart of `tempo_tpu/generator/wal.py`, host code copied with its
imports pointed at the port. The generator's span-metrics planes live on
the device; without this log a `kill -9`, OOM or device fault loses
every acked span since the last fleet checkpoint.

- **Append before ack.** Each successful generator push appends ONE
  record to a per-tenant local segment log before the ack returns: the
  staged batch as compact StageRec columns (+ attribute and resource
  records, sample weights, the referenced interner strings; no pickle
  anywhere), or the raw payload for routes that never stage. The fsync
  policy is configurable (`batch` = every record, `interval` =
  time-batched, `off` = OS page cache); segments rotate on size and age.
- **Watermarked truncation.** Fleet checkpoints embed the WAL watermark
  `(segment, seq)` at snapshot time; once the blob is written, segments
  at or below the watermark are deleted, and a persisted floor
  (`CHECKPOINTED`) keeps replay from re-applying covered records.
- **Exactly-once replay.** Boot or restore replays only records past the
  watermark through the normal `push_staged_view` path, so each record
  goes through the scheduler and K1 on the generator's device once. A
  record that raises during replay is quarantined to the tenant's
  `deadletter/` directory and counted instead of crash-looping boot;
  a failure of the device itself raises from the push like any other.

Record wire format: `TWR1 | seq u64 | len u32 | adler32 u32 | payload`,
the payload a flat binary container (JSON meta + raw numpy array
buffers). Torn tails fail the length/checksum gate and replay stops at
the last complete record. The segment layout and the record codec are
the reference's, so a WAL directory written by either package replays
in the other.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import struct
import threading
import time
import urllib.parse
import weakref
import zlib

import numpy as np

from tempo_tpu_torch.utils import faults, tracing

_LOG = logging.getLogger("tempo_tpu_torch.generator.wal")

_MAGIC = b"TWR1"
_HDR = struct.Struct("<QII")            # seq, payload len, crc32
_META_KEY = "__meta__"
RECORD_VERSION = 1
SEGMENT_SUFFIX = ".wal"


@dataclasses.dataclass
class IngestWalConfig:
    """The `wal:` config block (generator targets only)."""

    enabled: bool = False
    # per-tenant segment logs live under <dir>/<quoted tenant>/
    dir: str = "./tempo-data/generator-wal"
    # durability point for the ack: "batch" fsyncs every appended record
    # (acked == on disk), "interval" fsyncs at most every
    # fsync_interval_s (bounded loss window, much cheaper on slow
    # disks), "off" leaves flushing to the OS page cache (process-crash
    # safe, power-loss unsafe)
    fsync: str = "batch"
    fsync_interval_s: float = 0.5
    # segment rotation: a new segment file past either bound (whole
    # segments are the truncation unit — smaller segments truncate
    # sooner after a checkpoint, more files otherwise)
    segment_max_bytes: int = 64 << 20
    segment_max_age_s: float = 300.0

    def check(self) -> list[str]:
        problems = []
        if self.fsync not in ("batch", "interval", "off"):
            problems.append(f"wal.fsync {self.fsync!r} unknown: use "
                            "'batch' (fsync per acked record), 'interval' "
                            "(time-batched), or 'off' (OS page cache)")
        if self.fsync == "interval" and self.fsync_interval_s <= 0:
            problems.append("wal.fsync_interval_s must be > 0 with "
                            "fsync: interval")
        if self.segment_max_bytes < (1 << 20):
            problems.append(f"wal.segment_max_bytes "
                            f"({self.segment_max_bytes}) < 1MB: rotation "
                            "would thrash one file per handful of records")
        if self.segment_max_age_s <= 0:
            problems.append("wal.segment_max_age_s must be > 0")
        if self.enabled and not self.dir:
            problems.append("wal.enabled needs wal.dir")
        return ["wal: " + p for p in problems] if problems else []


# mutated under the tenant/segment locks; plain int/float adds are
# atomic enough for counters (the fleet STATS pattern)
STATS = {
    "appended_batches": 0,
    "appended_bytes": 0,
    "fsyncs": 0,
    "replayed_batches": 0,
    "truncated_segments": 0,
    "dead_letters": 0,
    "torn_frames": 0,
    "replay_lag_seconds": 0.0,          # gauge: 0 outside replay
}


from tempo_tpu_torch.utils import fsync_dir as _fsync_dir  # noqa: E402


def _tenant_seg(tenant: str) -> str:
    return urllib.parse.quote(tenant, safe="")


# ---------------------------------------------------------------------------
# record payloads
#
# The append is ON the ack path, so the record layer is built to be
# memcpy-cheap: arrays ship with their RAW per-tenant interner ids (no
# per-record remap/unique/searchsorted), and the strings those ids name
# travel as per-SEGMENT deltas — each record carries only the interner
# strings added since the segment's last record, so a segment is fully
# self-contained (truncation stays whole-segment) while steady-state
# records carry no strings at all. Replay accumulates the deltas per
# segment and remaps id columns once, off the hot path. The container
# is a flat binary layout (meta JSON + raw array buffers), not an npz —
# a zip member table and per-member CRCs cost more than the frame CRC
# already paid.
# ---------------------------------------------------------------------------

# (array, id field) pairs carrying per-tenant interner ids: recorded
# raw, remapped at replay through the segment string table (interner
# ids do not survive a restart). sval_id is meaningful only for string
# values (typ == 1) — replay masks the rest.
_ID_COLS = (("spans", "name_id"), ("spans", "status_msg_id"),
            ("spans", "service_id"), ("sattrs", "key_id"),
            ("sattrs", "sval_id"), ("rattrs", "key_id"),
            ("rattrs", "sval_id"), ("res", "service_id"))


def view_record(view, ts: float, push_id: str | None = None
                ) -> tuple[dict, dict[str, np.ndarray]]:
    """One staged view → (meta, arrays) with raw interner ids: the
    view's StageRec rows, attr/resource records, and sample weights.
    The raw payload bytes ride along only when the staging needs them
    (non-scalar AnyValues, non-string service.name fixup) — rare, and
    the columns alone cannot reproduce those."""
    st = view.staged
    rows = view.rows
    spans = st.spans if rows is None else st.spans[rows]
    if rows is None or not len(st.sattrs):
        sattrs = st.sattrs
    else:
        # keep only attrs owned by the view's rows, owner re-indexed to
        # the gathered row positions (the record IS a full staging)
        pos = np.full(st.n, -1, np.int64)
        pos[rows] = np.arange(len(rows), dtype=np.int64)
        own = st.sattrs["owner"].astype(np.int64)
        keep = pos[own] >= 0
        sattrs = np.array(st.sattrs[keep])
        sattrs["owner"] = pos[own[keep]]
    needs_raw = bool(st.needs_service_fixup
                     or (len(sattrs) and (sattrs["typ"] == 0).any())
                     or (len(st.rattrs) and (st.rattrs["typ"] == 0).any()))
    arrays = {"spans": spans, "sattrs": sattrs,
              "rattrs": st.rattrs,      # resources are tiny: keep all,
              "res": st.res}            # spans["res_idx"] stays valid
    w = view.weights()
    if w is not None:
        arrays["weights"] = np.asarray(w, np.float32)
    if needs_raw:
        arrays["raw"] = np.frombuffer(st.raw, np.uint8)
    meta = {"v": RECORD_VERSION, "kind": "staged", "ts": float(ts),
            "n": int(view.n),
            "has_span_attrs": bool(st.has_span_attrs),
            "include_res_attrs": bool(st.include_res_attrs)}
    if push_id:
        meta["push_id"] = push_id
    return meta, arrays


def rebuild_view(interner, meta: dict, arrays: dict[str, np.ndarray],
                 seg_strings: list[str], idmap: np.ndarray):
    """A replayable `StagedView` over a recorded staging: map every id
    column through `idmap` (the segment string table interned into the
    LIVE interner, `len(seg_strings)` entries). Ids outside the table —
    garbage in non-string sval slots, pre-record interner growth that
    never got referenced — become INVALID_ID; string-valued sval ids
    keep their typ gate. The result consumes through the normal
    `push_staged_view` path, fast StageRec route included."""
    from tempo_tpu_torch.model.otlp_batch import StagedIngest


    local = {k: np.array(arrays[k]) for k in ("spans", "sattrs",
                                              "rattrs", "res")}
    nmap = len(idmap)
    for k, f in _ID_COLS:
        arr = local[k]
        if not len(arr):
            continue
        col = arr[f]
        ok = (col >= 0) & (col < nmap)
        if f == "sval_id":
            ok &= arr["typ"] == 1
        out = np.full(col.shape, -1, col.dtype)
        out[ok] = idmap[col[ok]].astype(col.dtype)
        arr[f] = out
    raw = arrays["raw"].tobytes() if "raw" in arrays else b""
    st = StagedIngest(
        raw, interner,
        (local["spans"], local["sattrs"], local["rattrs"], local["res"]),
        has_span_attrs=bool(meta.get("has_span_attrs", True)),
        include_res_attrs=bool(meta.get("include_res_attrs", True)))
    if "weights" in arrays:
        st.sample_weight = np.asarray(arrays["weights"], np.float32)
    return st.view()


def _descr_tuples(d):
    """JSON round-trip turns dtype descr tuples into lists; restore."""
    if isinstance(d, list):
        return [tuple(_descr_tuples(x) for x in f) if isinstance(f, list)
                else f for f in d]
    return tuple(d) if isinstance(d, (list, tuple)) else d


# dtype → encoded descr JSON; the record stream reuses a handful of
# dtypes (StageRec/StageAttr/StageRes/f32/u8) and numpy's
# dtype_to_descr walk is ~half the encode cost uncached
_DESCR_CACHE: dict = {}


def _descr_bytes(dt: np.dtype) -> bytes:
    got = _DESCR_CACHE.get(dt)
    if got is None:
        got = _DESCR_CACHE[dt] = json.dumps(
            np.lib.format.dtype_to_descr(dt)).encode()
    return got


def _encode_parts(meta: dict, arrays: dict[str, np.ndarray]) -> list:
    """Flat binary container as scatter-gather PARTS: u32 meta_len |
    meta JSON | per array (u16 name_len | name | u16 descr_len | descr
    JSON | u8 ndim | u64 dims | u64 nbytes | raw buffer). Array bodies
    are memoryviews over the live arrays — zero copies on the ack path;
    the CRC and the writev consume the buffers directly."""
    parts: list = []
    m = json.dumps(meta).encode()
    parts.append(struct.pack("<I", len(m)))
    parts.append(m)
    parts.append(struct.pack("<H", len(arrays)))
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        descr = _descr_bytes(arr.dtype)
        raw = memoryview(arr).cast("B") if arr.size else b""
        parts.append(struct.pack("<H", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<H", len(descr)))
        parts.append(descr)
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}Q", *arr.shape))
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return parts


def _encode_record(meta: dict, arrays: dict[str, np.ndarray]) -> bytes:
    return b"".join(bytes(p) if isinstance(p, memoryview) else p
                    for p in _encode_parts(meta, arrays))


def decode_record(payload: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    pos = 0
    (mlen,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    meta = json.loads(payload[pos:pos + mlen].decode())
    pos += mlen
    (narr,) = struct.unpack_from("<H", payload, pos)
    pos += 2
    arrays: dict[str, np.ndarray] = {}
    for _ in range(narr):
        (nlen,) = struct.unpack_from("<H", payload, pos)
        pos += 2
        name = payload[pos:pos + nlen].decode()
        pos += nlen
        (dlen,) = struct.unpack_from("<H", payload, pos)
        pos += 2
        descr = _descr_tuples(json.loads(payload[pos:pos + dlen].decode()))
        pos += dlen
        (ndim,) = struct.unpack_from("<B", payload, pos)
        pos += 1
        shape = struct.unpack_from(f"<{ndim}Q", payload, pos)
        pos += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", payload, pos)
        pos += 8
        dt = np.lib.format.descr_to_dtype(descr)
        arrays[name] = np.frombuffer(
            payload, dtype=dt, count=int(np.prod(shape)) if shape
            else nbytes // max(dt.itemsize, 1),
            offset=pos).reshape(shape).copy()
        pos += nbytes
    return meta, arrays


# ---------------------------------------------------------------------------
# per-tenant segment log
# ---------------------------------------------------------------------------


class _TenantWal:
    """One tenant's append-only segment log. Segment files are named by
    their FIRST record seq (`{seq:012d}.wal`), which makes truncation
    index-free: segment k holds exactly [first_k, first_{k+1}) — a
    segment is dead once its last seq is ≤ the checkpoint watermark. A
    restart never appends to an existing segment (a torn tail must stay
    the LAST thing in its file), it opens a fresh one."""

    def __init__(self, root: str, tenant: str, cfg: IngestWalConfig,
                 now) -> None:
        self.cfg = cfg
        self.now = now
        self.dir = os.path.join(root, _tenant_seg(tenant))
        created = not os.path.isdir(self.dir)
        os.makedirs(self.dir, exist_ok=True)
        if created:
            # a crash must not lose the dirent of a durable segment
            _fsync_dir(os.path.dirname(self.dir))
        self._lock = threading.Lock()
        # group commit (fsync: batch): appends write their frame under
        # the lock, then wait for a SYNC that covers it — one appender
        # becomes the leader, releases the lock, and fsyncs once for
        # every frame written so far (os.fsync drops the GIL, so the
        # sync overlaps other handlers' staging/scatter work). One
        # physical fsync acks a whole burst instead of one push.
        self._sync_cv = threading.Condition(self._lock)
        self._written = 0               # frames written to the OS
        self._synced = 0                # frames covered by an fsync
        self._syncing = False
        self._f = None
        self._seg_first = -1
        self._seg_bytes = 0
        self._seg_opened = 0.0
        self._str_mark = 0
        # the interner whose id space the open segment's string table
        # mirrors (weakref: never pins a replaced instance's interner).
        # If the tenant's instance — and thus its interner — is replaced
        # mid-segment (orphaned handoff, remove + re-push), appends MUST
        # rotate to a fresh segment: raw ids from the new interner under
        # the old segment's string table would replay as the wrong
        # strings, silently misattributing series
        self._seg_interner = None
        self._last_fsync = 0.0
        self.next_seq = self._scan_next_seq()

    # -- disk layout -------------------------------------------------------

    def segments(self) -> list[str]:
        try:
            return sorted(f for f in os.listdir(self.dir)
                          if f.endswith(SEGMENT_SUFFIX)
                          and f.split(".")[0].isdigit())
        except FileNotFoundError:
            return []

    def _scan_next_seq(self) -> int:
        # the persisted checkpoint floor ALSO seeds the counter: after a
        # full truncation + restart there are no segments, but reusing
        # seqs at or below the floor would make replay silently skip the
        # new records (acked, on disk, never applied)
        last = self.checkpoint_floor()
        segs = self.segments()
        if segs:
            last = max(last, int(segs[-1].split(".")[0]))
            for seq, _payload in self._read_segment(segs[-1]):
                last = max(last, seq)
        return last + 1

    def _read_segment(self, name: str):
        try:
            with open(os.path.join(self.dir, name), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        pos, size = 0, len(data)
        hdr = 4 + _HDR.size
        while pos + hdr <= size:
            if data[pos:pos + 4] != _MAGIC:
                STATS["torn_frames"] += 1
                return                  # unreadable from here: torn tail
            seq, ln, crc = _HDR.unpack_from(data, pos + 4)
            if pos + hdr + ln > size:
                STATS["torn_frames"] += 1
                return
            payload = data[pos + hdr:pos + hdr + ln]
            if zlib.adler32(payload) != crc:
                STATS["torn_frames"] += 1
                return
            pos += hdr + ln
            yield seq, payload
        if pos != size:
            STATS["torn_frames"] += 1   # trailing partial header

    def read_records(self):
        """(seq, payload) over every complete record, oldest first."""
        for name in self.segments():
            yield from self._read_segment(name)

    # -- append ------------------------------------------------------------

    def _open_segment(self, first_seq: int) -> None:
        path = os.path.join(self.dir, f"{first_seq:012d}{SEGMENT_SUFFIX}")
        # buffering=0: frames reach the OS at write() so a concurrent
        # replay bound by an older seq never sees a half-buffered file
        self._f = open(path, "ab", buffering=0)
        self._seg_first = first_seq
        self._seg_bytes = 0
        self._seg_opened = self.now()
        # per-segment string table: a fresh segment starts from zero, so
        # its first record re-ships the tenant's interner vocabulary and
        # the segment is self-contained (whole-segment truncation can
        # never strand a later record's string references)
        self._str_mark = 0
        _fsync_dir(self.dir)            # the dirent itself must survive

    def _close_segment(self) -> None:
        if self._f is None:
            return
        # a batch-mode leader may hold this fd outside the lock: wait
        # for its sync to land before closing under it
        while self._syncing:
            self._sync_cv.wait(timeout=1.0)
        if self.cfg.fsync != "off":
            self._fsync()               # a rotated-away segment is final
        self._f.close()
        self._f = None

    def _fsync(self) -> None:
        if faults.ARMED:
            faults.fire("wal.fsync")
        os.fsync(self._f.fileno())
        STATS["fsyncs"] += 1
        self._last_fsync = self.now()

    def _sync_to(self, ticket: int) -> None:
        """Group commit: block until an fsync covers frame `ticket`.
        Caller holds the lock. The first waiter becomes the leader,
        releases the lock, fsyncs ONCE (covering everything written so
        far), and wakes the rest — a concurrent burst of acked pushes
        shares one physical fsync instead of paying one each."""
        while self._synced < ticket:
            if self._syncing:
                self._sync_cv.wait(timeout=5.0)
                continue
            self._syncing = True
            cover = self._written
            f = self._f
            self._lock.release()
            try:
                if faults.ARMED:
                    faults.fire("wal.fsync")
                os.fsync(f.fileno())
            finally:
                self._lock.acquire()
                self._syncing = False
                self._sync_cv.notify_all()
            # only on success: a failed fsync leaves _synced where it
            # was, and the next waiter retries leadership
            STATS["fsyncs"] += 1
            self._last_fsync = self.now()
            self._synced = max(self._synced, cover)

    def append(self, payload, interner=None) -> tuple[int, int]:
        """Durably append one record; returns (segment_first, seq).

        `payload` is either ready bytes, or (meta, arrays) to encode
        here — under the lock — so the segment string delta
        (`interner` strings past this segment's mark) lands in the SAME
        record atomically with the mark advance: two concurrent appends
        can never both claim the same delta (replay order would
        misalign the implicit string ids)."""
        with self._lock:
            now = self.now()
            seq = self.next_seq
            if interner is not None:
                cur = self._seg_interner() \
                    if self._seg_interner is not None else None
                if cur is not interner:
                    if self._f is not None:
                        self._close_segment()   # new id space: rotate
                    self._seg_interner = weakref.ref(interner)
            if self._f is not None and (
                    self._seg_bytes >= self.cfg.segment_max_bytes
                    or now - self._seg_opened > self.cfg.segment_max_age_s):
                self._close_segment()
            if self._f is None:
                self._open_segment(seq)
            if isinstance(payload, (bytes, bytearray)):
                parts = [payload]
            else:
                meta, arrays = payload
                if interner is not None and len(interner) > self._str_mark:
                    snap = interner.snapshot()
                    meta["smark"] = self._str_mark
                    meta["new_strings"] = snap[self._str_mark:]
                    self._str_mark = len(snap)
                parts = _encode_parts(meta, arrays)
            plen = sum(len(p) for p in parts)
            ck = 1
            for p in parts:
                # adler32, not crc32: the frame checksum detects TORN
                # writes (truncation, unordered partial blocks), not
                # bit-rot — adler is 3-5x cheaper on the ack path and
                # catches every truncation-class corruption
                ck = zlib.adler32(p, ck)
            frame = b"".join([_MAGIC + _HDR.pack(seq, plen, ck), *parts])
            self._f.write(frame)        # ONE syscall; join is one memcpy
            self.next_seq = seq + 1
            self._seg_bytes += len(frame)
            self._written += 1
            ticket = self._written
            STATS["appended_batches"] += 1
            STATS["appended_bytes"] += len(frame)
            if self.cfg.fsync == "batch":
                self._sync_to(ticket)
            elif self.cfg.fsync == "interval" and \
                    now - self._last_fsync >= self.cfg.fsync_interval_s:
                self._fsync()
            return self._seg_first, seq

    # -- watermark / truncation --------------------------------------------

    def watermark(self) -> tuple[int, int]:
        """(segment_first, last appended seq); (-1, -1) when empty."""
        with self._lock:
            if self.next_seq == 0:
                return -1, -1
            if self._seg_first >= 0:
                return self._seg_first, self.next_seq - 1
            segs = self.segments()
            first = int(segs[-1].split(".")[0]) if segs else -1
            return first, self.next_seq - 1

    # -- persistent checkpoint floor ---------------------------------------
    #
    # Truncation is whole-segment, so a checkpoint watermark landing
    # mid-segment leaves covered records on disk; and a crash between
    # the blob write and the truncation leaves whole covered segments.
    # The CHECKPOINTED marker pins the floor locally: replay never
    # re-applies a record at or below it, whether or not the blob that
    # covers it is ever restored back into this member (it may have
    # been consumed by a peer). Written AFTER the blob write confirms.

    _MARKER = "CHECKPOINTED"

    def checkpoint_floor(self) -> int:
        try:
            with open(os.path.join(self.dir, self._MARKER)) as f:
                return int(f.read().strip() or -1)
        except (FileNotFoundError, ValueError):
            return -1

    def set_checkpoint_floor(self, seq: int) -> None:
        if seq < 0 or seq <= self.checkpoint_floor():
            return
        tmp = os.path.join(self.dir, f".{self._MARKER}.tmp")
        with open(tmp, "w") as f:
            f.write(str(int(seq)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, self._MARKER))
        # the rename itself must survive power loss: a floor that
        # rolls back re-replays records a peer-consumed blob already
        # holds (truncate() only fsyncs the dir when it deletes)
        _fsync_dir(self.dir)

    def truncate(self, upto_seq: int) -> int:
        """Delete whole segments whose every record is ≤ `upto_seq`
        (records at or below a checkpoint watermark are IN the blob)."""
        if upto_seq < 0:
            return 0
        removed = 0
        with self._lock:
            names = [(int(f.split(".")[0]), f) for f in self.segments()]
            for i, (first, fname) in enumerate(names):
                # segment i spans [first, next segment's first) — the
                # open segment's bound is next_seq
                bound = names[i + 1][0] if i + 1 < len(names) \
                    else self.next_seq
                if bound - 1 > upto_seq:
                    break               # sorted: later segments newer
                if first == self._seg_first and self._f is not None:
                    self._close_segment()
                    self._seg_first = -1
                try:
                    os.unlink(os.path.join(self.dir, fname))
                    removed += 1
                except FileNotFoundError:
                    pass
            if removed:
                _fsync_dir(self.dir)
                STATS["truncated_segments"] += removed
        return removed

    def close(self) -> None:
        with self._lock:
            self._close_segment()


# ---------------------------------------------------------------------------
# process-level WAL: the Generator's durability sidecar
# ---------------------------------------------------------------------------


class GeneratorWal:
    """Per-tenant ingest WALs under one root dir. Thread-safe; owned by
    the process Generator (App wires it when `wal.enabled`)."""

    def __init__(self, cfg: IngestWalConfig,
                 now=time.time) -> None:
        self.cfg = cfg
        self.now = now
        self.root = cfg.dir
        created = not os.path.isdir(self.root)
        os.makedirs(self.root, exist_ok=True)
        if created:
            parent = os.path.dirname(os.path.abspath(self.root))
            try:
                _fsync_dir(parent)
            except OSError:
                pass                    # e.g. parent on a weird mount
        self._tenants: dict[str, _TenantWal] = {}
        self._lock = threading.Lock()

    def _tw(self, tenant: str) -> _TenantWal:
        tw = self._tenants.get(tenant)
        if tw is None:
            with self._lock:
                tw = self._tenants.get(tenant)
                if tw is None:
                    tw = self._tenants[tenant] = _TenantWal(
                        self.root, tenant, self.cfg, self.now)
        return tw

    def tenants_on_disk(self) -> list[str]:
        """Tenants with any WAL segment under the root (boot replay)."""
        out = []
        try:
            entries = sorted(os.listdir(self.root))
        except FileNotFoundError:
            return out
        for d in entries:
            p = os.path.join(self.root, d)
            if not os.path.isdir(p):
                continue
            if any(f.endswith(SEGMENT_SUFFIX) for f in os.listdir(p)):
                out.append(urllib.parse.unquote(d))
        return out

    # -- append (called inside the generator's tracked push) ---------------

    def append_view(self, tenant: str, view,
                    push_id: str | None = None) -> tuple[int, int]:
        # appends are spans (part of the request's tree via the ambient
        # context): the acked-is-durable fsync IS request latency, and a
        # kept SLO-miss trace shows exactly which append stalled it.
        # Reserved-tenant ingest arrives inside the suppression guard,
        # so self-ingest appends go untraced by construction.
        with tracing.span("wal.append", kind="view", tenant=tenant):
            meta, arrays = view_record(view, self.now(), push_id=push_id)
            return self._tw(tenant).append((meta, arrays),
                                           interner=view.staged.interner)

    def append_otlp(self, tenant: str, data: bytes, trusted: bool = False,
                    push_id: str | None = None) -> tuple[int, int]:
        """Raw-payload record for routes with no staged product (native
        staging unavailable): replay re-runs the normal OTLP push."""
        with tracing.span("wal.append", kind="otlp", tenant=tenant,
                          n_bytes=len(data)):
            meta = {"v": RECORD_VERSION, "kind": "otlp", "ts": self.now(),
                    "n": 0, "trusted": bool(trusted)}
            if push_id:
                meta["push_id"] = push_id
            arrays = {"raw": np.frombuffer(data, np.uint8)}
            return self._tw(tenant).append((meta, arrays))

    def append_spans(self, tenant: str, spans,
                     push_id: str | None = None) -> tuple[int, int]:
        """Dict-route record (push_spans without a staged product): the
        span dicts as wire-parity JSON (`rpc.spans_to_json` shape)."""
        from tempo_tpu_torch.rpc import spans_to_json

        with tracing.span("wal.append", kind="spans", tenant=tenant,
                          n_spans=len(spans)):
            meta = {"v": RECORD_VERSION, "kind": "spans", "ts": self.now(),
                    "n": len(spans), "spans": spans_to_json(list(spans))}
            if push_id:
                meta["push_id"] = push_id
            return self._tw(tenant).append((meta, {}))

    # -- watermark / truncation / replay -----------------------------------

    def watermark(self, tenant: str) -> tuple[int, int]:
        return self._tw(tenant).watermark()

    def truncate(self, tenant: str, upto_seq: int) -> int:
        """Persist the checkpoint floor FIRST, then drop covered whole
        segments. The floor marker is what keeps replay exactly-once
        when truncation is partial (a watermark landing mid-segment) or
        skipped entirely (crash between blob write and truncation, or a
        restart that no longer owns the tenant and so never restores
        the covering blob)."""
        tw = self._tw(tenant)
        tw.set_checkpoint_floor(upto_seq)
        return tw.truncate(upto_seq)

    def replay(self, tenant: str, apply_fn, past_seq: int = -1) -> dict:
        """Apply every record with seq in (past_seq, bound] through
        `apply_fn(meta, arrays, seg_strings)`; `bound` is the last seq
        at call time so records appended DURING replay (live traffic)
        are left alone. Each segment's string deltas accumulate as its
        records stream — skipped records (≤ watermark) still contribute
        their deltas, since a later record's ids may reference them. A
        raising record is quarantined to `deadletter/` and counted —
        boot must make progress past a poison batch."""
        tw = self._tw(tenant)
        bound = tw.next_seq - 1
        past_seq = max(past_seq, tw.checkpoint_floor())
        stats = {"batches": 0, "dead_letters": 0}
        with tracing.span("wal.replay", tenant=tenant,
                          past_seq=past_seq, bound=bound) as _sp:
            self._replay_segments(tw, tenant, apply_fn, past_seq, bound,
                                  stats)
            if _sp is not None:
                _sp.attrs["batches"] = stats["batches"]
                _sp.attrs["dead_letters"] = stats["dead_letters"]
        STATS["replay_lag_seconds"] = 0.0
        return stats

    def _replay_segments(self, tw, tenant: str, apply_fn, past_seq: int,
                         bound: int, stats: dict) -> None:
        for name in tw.segments():
            seg_strings: list[str] = []
            for seq, payload in tw._read_segment(name):
                try:
                    meta, arrays = decode_record(payload)
                except Exception:
                    _LOG.exception("wal replay: record %s/%d undecodable",
                                   tenant, seq)
                    if past_seq < seq <= bound:
                        self._dead_letter(tenant, seq, payload, [])
                        stats["dead_letters"] += 1
                    continue
                if meta.get("new_strings"):
                    seg_strings.extend(meta["new_strings"])
                if seq <= past_seq or seq > bound:
                    continue
                try:
                    STATS["replay_lag_seconds"] = max(
                        0.0, self.now() - float(meta.get("ts",
                                                         self.now())))
                    apply_fn(meta, arrays, seg_strings)
                    stats["batches"] += 1
                    STATS["replayed_batches"] += 1
                except Exception:
                    _LOG.exception("wal replay: record %s/%d quarantined",
                                   tenant, seq)
                    self._dead_letter(tenant, seq, payload, seg_strings)
                    stats["dead_letters"] += 1

    def _dead_letter(self, tenant: str, seq: int, payload: bytes,
                     seg_strings: list[str]) -> None:
        """Quarantine the record payload plus the segment string
        context it needs (a dead letter must stay re-applyable after
        its segment truncates)."""
        d = os.path.join(self.root, _tenant_seg(tenant), "deadletter")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{seq:012d}.rec"), "wb") as f:
            f.write(payload)
        with open(os.path.join(d, f"{seq:012d}.strings.json"), "w") as f:
            json.dump(seg_strings, f)
        STATS["dead_letters"] += 1

    def status(self) -> dict:
        with self._lock:
            tws = dict(self._tenants)
        return {
            "dir": self.root,
            "fsync": self.cfg.fsync,
            "tenants": len(tws),
            "appended_batches": STATS["appended_batches"],
            "appended_bytes": STATS["appended_bytes"],
            "replayed_batches": STATS["replayed_batches"],
            "dead_letters": STATS["dead_letters"],
            "segments": {t: len(tw.segments()) for t, tw in tws.items()},
        }

    def close(self) -> None:
        with self._lock:
            for tw in self._tenants.values():
                tw.close()


# ---------------------------------------------------------------------------
# obs: registered at import (App._build imports this module) so the
# dashboards/alerts drift gate sees the families on every deployment
# ---------------------------------------------------------------------------

from tempo_tpu_torch.obs.runtime import RUNTIME  # noqa: E402

RUNTIME.counter_func(
    "tempo_wal_appended_batches_total",
    lambda: [((), float(STATS["appended_batches"]))],
    help="Acked generator pushes appended to the ingest WAL (runbook "
         "'Crash recovery and fault injection')")
RUNTIME.counter_func(
    "tempo_wal_appended_bytes_total",
    lambda: [((), float(STATS["appended_bytes"]))],
    help="Bytes appended to the generator ingest WAL (frames incl. "
         "headers)")
RUNTIME.counter_func(
    "tempo_wal_fsyncs_total",
    lambda: [((), float(STATS["fsyncs"]))],
    help="WAL segment fsyncs (policy 'batch': one per acked push; "
         "'interval': time-batched; 'off': rotation-only)")
RUNTIME.counter_func(
    "tempo_wal_replayed_batches_total",
    lambda: [((), float(STATS["replayed_batches"]))],
    help="WAL records replayed into generator state after a restart "
         "(each applies exactly once past the checkpoint watermark)")
RUNTIME.counter_func(
    "tempo_wal_truncated_segments_total",
    lambda: [((), float(STATS["truncated_segments"]))],
    help="WAL segments deleted below a checkpoint watermark")
RUNTIME.counter_func(
    "tempo_wal_dead_letters_total",
    lambda: [((), float(STATS["dead_letters"]))],
    help="WAL records quarantined to the dead-letter dir because replay "
         "raised (inspect <wal>/<tenant>/deadletter/, runbook 'Crash "
         "recovery and fault injection')")
RUNTIME.gauge_func(
    "tempo_wal_replay_lag_seconds",
    lambda: [((), float(STATS["replay_lag_seconds"]))],
    help="Age of the WAL record currently being replayed (0 outside "
         "replay; stuck high = TempoWalReplayStuck)")
