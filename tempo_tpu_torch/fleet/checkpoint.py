"""Tenant device-state checkpoint/restore through the object store.

Counterpart of `tempo_tpu/fleet/checkpoint.py`, with the reference's blob
format: a blob from either package restores into the other. A
checkpoint is ONE blob per tenant: for every registry family the active
series' label rows (interner ids remapped into the strings they
reference) and the family's plane rows, plus the span-metrics sketch
rows and the processors' aux rows with their metadata.

The snapshot reads the card. Every family's rows are selected on the
tenant's device (indexed in dense state, gathered through each plane's
page table in paged state; real rows only, no padding) and queued; one
copy per dtype then brings the whole tenant to the host (`D2H_COPIES`
counts them). That gather is the handoff's pause.

Restore is a MERGE, not an overwrite: label rows re-intern into the live
registry, slots allocate through the normal series-table path (budget-
and page-backed), and plane rows scatter into the device state on the
instance's device: `index_add_` for count-like planes, `index_copy_` for
gauges (last wins), and for the moments rows an add of the count and
sums with an amax of the two bound columns. Physical rows of paged
planes come from the host page map (`_paged_phys`), so only real rows
are scattered. Restoring into a fresh instance is add-to-zero, exact in
every plane. Metadata guards (fingerprint, family layout, sketch
parameters) run before any row is written. A device failure raises; it
is never retried on the host.

Wire format: `np.savez_compressed` (a zip of .npy members, no pickle)
with one JSON metadata member.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import time
import urllib.parse

import numpy as np
import torch

from tempo_tpu_torch.backend.raw import (DoesNotExist, KeyPath, RawReader,
                                         RawWriter)
from tempo_tpu_torch.fleet import STATS
from tempo_tpu_torch.parallel.mesh import gather_rows, scatter_rows

_LOG = logging.getLogger("tempo_tpu_torch.fleet")

CHECKPOINT_VERSION = 1
CHECKPOINT_SUFFIX = ".ckpt"
_META_KEY = "__meta__"

# device-to-host copies made by snapshots in this process (one per dtype
# a snapshot holds: the handoff's pause is these copies)
D2H_COPIES = 0


class CheckpointMismatch(ValueError):
    """The checkpoint was cut under an incompatible tenant config
    (overrides fingerprint / family shapes / sketch metadata). Restoring
    it would corrupt state, so the caller must skip it loudly."""


# ---------------------------------------------------------------------------
# fingerprint: the config surface a checkpoint's state layout depends on
# ---------------------------------------------------------------------------

def overrides_fingerprint(inst) -> str:
    """Stable digest of everything that shapes this tenant's series and
    plane layout (the reference's document, byte for byte)."""
    reg = inst.registry
    sm = inst.cfg.spanmetrics
    doc = {
        "max_active_series": reg.overrides.max_active_series,
        "external_labels": sorted(reg.overrides.external_labels.items()),
        "processors": sorted(inst.processors),
        "spanmetrics": {
            "dimensions": list(sm.dimensions),
            "intrinsic_dimensions": list(sm.intrinsic_dimensions),
            "histogram_buckets": [float(e) for e in sm.histogram_buckets],
            "sketch": sm.sketch,
            "enable_quantile_sketch": bool(sm.enable_quantile_sketch),
            "sketch_rel_err": float(sm.sketch_rel_err),
            "sketch_min_s": float(sm.sketch_min_s),
            "sketch_max_s": float(sm.sketch_max_s),
            "sketch_max_series": int(sm.sketch_max_series),
            "moments_k": int(sm.moments_k),
            "enable_target_info": bool(sm.enable_target_info),
            # the compact tier changes plane dtypes (int32 grids, bf16
            # Kahan sums): cross-compact merges would silently truncate
            "compact_state": bool(sm.compact_state),
        },
    }
    if "trace-analytics" in inst.processors:
        ta = inst.cfg.traceanalytics
        doc["traceanalytics"] = {
            "enable_latency_share_sketch":
                bool(ta.enable_latency_share_sketch),
            "moments_k": int(ta.moments_k),
            "sketch_max_series": int(ta.sketch_max_series),
            "share_min": float(ta.share_min),
            "share_max": float(ta.share_max),
        }
    raw = json.dumps(doc, sort_keys=True).encode()
    return hashlib.sha256(raw).hexdigest()[:16]


# ---------------------------------------------------------------------------
# device reads: queue selected rows, fetch them with one copy per dtype
# ---------------------------------------------------------------------------

class _Fetch:
    """Device tensors queued under names, brought to the host together:
    one flat buffer per dtype, one copy each (bf16 rows are f32 by then,
    numpy has no bfloat16)."""

    def __init__(self) -> None:
        self._queued: dict[str, torch.Tensor] = {}

    def put(self, name: str, t: torch.Tensor) -> None:
        self._queued[name] = t

    def fetch(self) -> dict[str, np.ndarray]:
        global D2H_COPIES
        by_dtype: dict = {}
        for name, t in self._queued.items():
            by_dtype.setdefault(t.dtype, []).append((name, t))
        out: dict[str, np.ndarray] = {}
        for items in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for _, t in items])
            host = flat.cpu().numpy()
            D2H_COPIES += 1
            pos = 0
            for name, t in items:
                n = t.numel()
                out[name] = host[pos:pos + n].reshape(tuple(t.shape))
                pos += n
        return out


def _plane_rows(plane, slots: np.ndarray) -> torch.Tensor:
    """The slots' rows of a paged plane on its device (real rows only)."""
    rows = plane.gather_dev(np.ascontiguousarray(slots, np.int32))
    return rows.float() if rows.dtype == torch.bfloat16 else rows


# ---------------------------------------------------------------------------
# family plane access (dense + paged)
# ---------------------------------------------------------------------------

def _family_kind(mt) -> str:
    from tempo_tpu_torch.registry.registry import (Counter, Gauge, Histogram,
                                                   NativeHistogram)
    if isinstance(mt, Histogram):
        return "histogram"
    if isinstance(mt, NativeHistogram):
        return "native"
    if isinstance(mt, Gauge):
        return "gauge"
    if isinstance(mt, Counter):
        return "counter"
    raise CheckpointMismatch(f"unknown family type {type(mt).__name__}")


_KIND_ROLES = {
    "counter": ("values",),
    "gauge": ("values",),
    "histogram": ("buckets", "sums", "counts"),
    "native": ("hist", "sums", "counts", "zeros"),
}


def _dense_tensors(mt, kind: str) -> dict[str, torch.Tensor]:
    st = mt.state
    if kind in ("counter", "gauge"):
        return {"values": st.values}
    if kind == "histogram":
        return {"buckets": st.bucket_counts, "sums": st.sums,
                "counts": st.counts}
    return {"hist": st.hist.counts, "sums": st.sums, "counts": st.counts,
            "zeros": st.zeros}


def _family_rows(mt, slots: np.ndarray) -> dict[str, torch.Tensor]:
    """{role: [n(, width)] device rows} of the active slots. Caller holds
    the registry state lock."""
    kind = _family_kind(mt)
    if hasattr(mt, "planes"):            # paged family
        out = {}
        for role in _KIND_ROLES[kind]:
            rows = _plane_rows(mt.planes[role], slots)
            if kind == "histogram" and role == "sums" and rows.ndim == 2:
                # compact tier: the bf16 Kahan pair folds at the boundary,
                # as the collect snapshot folds it
                rows = rows[:, 0] + rows[:, 1]
            out[role] = rows
        return out
    # dense planes: indexed on the device, shard by shard on the serving
    # mesh, every role's rows landing on the registry's device
    return {role: gather_rows(t, slots, mt.registry.device)
            for role, t in _dense_tensors(mt, kind).items()}


def _paged_phys(plane, slots: np.ndarray) -> np.ndarray:
    """Arena row index per slot through the host page map (restore runs
    right after ensure_slot backed these pages)."""
    shift = plane.pool.page_shift
    pages = plane.page_map[np.asarray(slots, np.int64) >> shift] \
        .astype(np.int64)
    if (pages < 0).any():
        raise CheckpointMismatch("restore hit an unbacked page")
    return (pages << shift) | (np.asarray(slots, np.int64)
                               & (plane.pool.page_rows - 1))


def _scatter(data, rows: np.ndarray, vals: np.ndarray, op: str) -> None:
    """Merge host rows into a plane at distinct physical rows, in place
    on its device (each row on its owner shard of a sharded plane):
    "add" (`index_add_`) or "set" (`index_copy_`)."""
    scatter_rows(data, rows, vals,
                 (lambda t, i, v: t.index_add_(0, i, v)) if op == "add"
                 else (lambda t, i, v: t.index_copy_(0, i, v)))


def _family_restore(mt, slots: np.ndarray, rows: dict[str, np.ndarray]
                    ) -> None:
    """Scatter-merge checkpoint rows into the family's device planes.
    Count-like planes ADD, so merge order never matters; gauges SET (last
    write wins in restore order). Caller holds the registry state lock."""
    kind = _family_kind(mt)
    op = "set" if kind == "gauge" else "add"
    if hasattr(mt, "planes"):            # paged family
        for role in _KIND_ROLES[kind]:
            vals = rows[role]
            plane = mt.planes[role]
            if kind == "histogram" and role == "sums" and plane.width == 2:
                # compact pair plane: merge into the primary column (the
                # compensation restarts at 0, within the compact tier's
                # tolerance)
                pair = np.zeros((len(vals), 2), np.float32)
                pair[:, 0] = vals
                vals = pair
            if kind == "counter" and getattr(mt, "compact", False):
                vals = np.round(vals)
            _scatter(plane.data, _paged_phys(plane, slots), vals, op)
        return
    for role, t in _dense_tensors(mt, kind).items():
        _scatter(t, slots, rows[role], op)


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------

def snapshot_instance(inst) -> bytes:
    """One tenant's full metric state as a checkpoint blob.

    Drains the device scheduler first (updates accepted before the
    snapshot must be in it), then selects every family's active rows on
    the device under the registry state lock, so the cut is consistent
    across the slot-aligned families and their sketch sidecars, and
    fetches them with one copy per dtype.

    CALLER CONTRACT: no push may be in flight on this instance (the
    handoff fences with `wait_pushes_idle` after `pop_instance`; the
    shutdown path joins the HTTP handlers first). The WAL watermark read
    here claims every record appended so far."""
    t0 = time.perf_counter()
    inst.drain()
    reg = inst.registry
    host: dict[str, np.ndarray] = {}
    dev = _Fetch()

    def put(name: str, v) -> None:
        if isinstance(v, torch.Tensor):
            dev.put(name, v)
        else:
            host[name] = v

    # WAL watermark map {member instance id: [segment, seq]}: restored
    # watermarks carry forward, and the live one is read after the
    # caller's push fence, so it covers every record gathered here
    wal_meta = {k: [int(v[0]), int(v[1])]
                for k, v in getattr(inst, "wal_watermarks", {}).items()}
    mark = getattr(inst, "_wal_mark", None)
    if mark is not None:
        iid, seg, seq = mark()
        wal_meta[iid] = [int(seg), int(seq)]
        inst.checkpointed_wal_seq = int(seq)
    meta: dict = {
        "version": CHECKPOINT_VERSION,
        "tenant": inst.tenant,
        "created_ts": reg.now(),
        "fingerprint": overrides_fingerprint(inst),
        "layout": inst.state_layout,
        "wal": wal_meta,
        "families": {},
        "spanmetrics": None,
    }
    with reg.state_lock:
        snap = reg.interner.snapshot()
        # one slots/keys resolve per TABLE: share_table-merged families
        # (the span-metrics trio, service-graph edges) ship their keys once
        tables: dict[int, dict] = {}
        for name, mt in reg._metrics.items():
            t = tables.get(id(mt.table))
            if t is None:
                slots = mt.table.active_slots()
                t = tables[id(mt.table)] = {
                    "owner": name, "slots": slots,
                    "keys": mt.table.slot_keys[slots]}
            kind = _family_kind(mt)
            meta["families"][name] = {
                "kind": kind,
                "label_names": list(mt.label_names),
                "n": int(t["slots"].size),
                "roles": list(_KIND_ROLES[kind]),
                "keys_of": t["owner"],
            }
            for role, rows in _family_rows(mt, t["slots"]).items():
                put(f"{name}::{role}", rows)
        # ship ONLY the strings the keys reference, keys remapped into
        # that list: the interner holds every string the tenant ever saw
        if tables:
            ref = np.unique(np.concatenate(
                [t["keys"].ravel() for t in tables.values()]))
        else:
            ref = np.zeros(0, np.int64)
        meta["strings"] = [snap[int(i)] for i in ref]
        for t in tables.values():
            host[f"{t['owner']}::keys"] = np.searchsorted(
                ref, t["keys"]).astype(np.int32)
        for proc in inst.processors.values():
            fn = getattr(proc, "sketch_checkpoint", None)
            if fn is None:
                continue
            smeta, srows = fn(proc.calls.table.active_slots())
            if smeta is None:
                continue
            meta["spanmetrics"] = smeta
            meta["spanmetrics"]["family"] = proc.calls.name
            for k, v in srows.items():
                put(f"__sketch__::{k}", v)
        # processor-keyed aux sidecars tied to one family's slot order
        # (the trace-analytics latency-share moments)
        for pname, proc in inst.processors.items():
            fn = getattr(proc, "aux_checkpoint", None)
            if fn is None:
                continue
            fam = proc.aux_family()
            ameta, arows = fn(fam.table.active_slots())
            if ameta is None:
                continue
            ameta["family"] = fam.name
            meta.setdefault("aux", {})[pname] = ameta
            for k, v in arows.items():
                put(f"__aux__::{pname}::{k}", v)
        host.update(dev.fetch())
    blob = _encode(meta, host)
    STATS["checkpoint_seconds"] += time.perf_counter() - t0
    STATS["checkpoint_bytes"] += len(blob)
    STATS["checkpoints"] += 1
    return blob


def restore_instance(inst, blob: bytes) -> dict:
    """Merge a checkpoint into a live (fresh or already ingesting) tenant
    instance on its device; returns {"series", "dropped"} counts.

    Raises CheckpointMismatch (a ValueError) when the checkpoint's
    fingerprint, family layout or sketch metadata is incompatible,
    before any row is written."""
    meta, arrays = _decode(blob)
    if meta.get("version") != CHECKPOINT_VERSION:
        raise CheckpointMismatch(
            f"checkpoint version {meta.get('version')} != "
            f"{CHECKPOINT_VERSION}")
    reg = inst.registry
    want_fp = overrides_fingerprint(inst)
    if meta.get("fingerprint") != want_fp:
        raise CheckpointMismatch(
            f"overrides fingerprint {meta.get('fingerprint')} does not "
            f"match this instance's {want_fp} (tenant config changed "
            "since the checkpoint was cut)")
    sk_proc = None
    if meta.get("spanmetrics") is not None:
        for proc in inst.processors.values():
            if getattr(proc, "sketch_restore", None) is not None:
                sk_proc = proc
                proc.sketch_meta_check(meta["spanmetrics"])  # ValueError
                break
        if sk_proc is None:
            raise CheckpointMismatch(
                "checkpoint carries sketch planes but this instance has "
                "no span-metrics processor")
    aux_meta = meta.get("aux") or {}
    aux_procs: dict = {}
    for pname, ameta in aux_meta.items():
        proc = inst.processors.get(pname)
        if proc is None or getattr(proc, "aux_restore", None) is None:
            raise CheckpointMismatch(
                f"checkpoint carries aux planes for processor {pname!r} "
                "which is not enabled on this instance")
        proc.aux_meta_check(ameta)  # ValueError on layout mismatch
        aux_procs[pname] = proc
    strings = meta.get("strings", [])
    idmap = reg.interner.intern_many(strings) if strings \
        else np.zeros(0, np.int32)
    stats = {"series": 0, "dropped": 0}
    now = reg.now()
    with reg.state_lock:
        # per-family layout guards, before any row is written
        for name, fam in meta["families"].items():
            mt = reg._metrics.get(name)
            if mt is None:
                _LOG.warning("fleet restore %s: family %s not present "
                             "live — skipped", inst.tenant, name)
                continue
            if tuple(fam["label_names"]) != mt.label_names or \
                    fam["kind"] != _family_kind(mt):
                raise CheckpointMismatch(
                    f"family {name}: checkpoint layout "
                    f"({fam['kind']}, {fam['label_names']}) != live "
                    f"({_family_kind(mt)}, {list(mt.label_names)})")
        calls_live_slots = calls_ok = None
        aux_slots: dict = {}
        resolved: dict[str, tuple] = {}  # keys_of -> (slots, ok)
        for name, fam in meta["families"].items():
            mt = reg._metrics.get(name)
            if mt is None:
                continue
            n = int(fam["n"])
            if n == 0:
                continue
            owner = fam.get("keys_of", name)
            got = resolved.get(owner)
            if got is None:
                # one lookup_or_create per shared table: the series
                # budget debits once for the slot-aligned trio, as live
                keys = arrays[f"{owner}::keys"]
                live_rows = np.ascontiguousarray(idmap[keys], np.int32)
                slots = mt.table.lookup_or_create(live_rows, now)
                ok = slots >= 0
                got = resolved[owner] = (slots, ok)
                stats["dropped"] += int(n - ok.sum())
                stats["series"] += int(ok.sum())
            slots, ok = got
            rows = {role: arrays[f"{name}::{role}"][ok]
                    for role in fam["roles"]}
            _family_restore(mt, slots[ok], rows)
            if sk_proc is not None and name == sk_proc.calls.name:
                calls_live_slots, calls_ok = slots, ok
            for pname in aux_procs:
                if name == aux_meta[pname]["family"]:
                    aux_slots[pname] = (slots, ok)
        if sk_proc is not None and calls_live_slots is not None:
            srows = {k[len("__sketch__::"):]: v for k, v in arrays.items()
                     if k.startswith("__sketch__::")}
            sk_proc.sketch_restore(meta["spanmetrics"], calls_live_slots,
                                   calls_ok, srows)
        for pname, proc in aux_procs.items():
            got = aux_slots.get(pname)
            if got is None:
                continue  # anchor family empty in the blob
            prefix = f"__aux__::{pname}::"
            arows = {k[len(prefix):]: v for k, v in arrays.items()
                     if k.startswith(prefix)}
            proc.aux_restore(aux_meta[pname], got[0], got[1], arows)
    # merge WAL watermarks (max seq per member): local replay skips what
    # this blob's lineage already holds
    marks = getattr(inst, "wal_watermarks", None)
    if marks is not None:
        for iid, wm in (meta.get("wal") or {}).items():
            cur = marks.get(iid)
            if cur is None or int(wm[1]) > int(cur[1]):
                marks[iid] = [int(wm[0]), int(wm[1])]
    STATS["restores"] += 1
    STATS["restore_merged_series"] += stats["series"]
    STATS["restore_dropped_series"] += stats["dropped"]
    return stats


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

def _encode(meta: dict, arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    payload = {_META_KEY: np.frombuffer(
        json.dumps(meta).encode(), np.uint8)}
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.dtype not in (np.float32, np.float64, np.int32, np.int64):
            v = v.astype(np.float32)     # other dtypes normalize at the wire
        payload[k] = v
    np.savez_compressed(buf, **payload)
    return buf.getvalue()


def _decode(blob: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
    return meta, arrays


# ---------------------------------------------------------------------------
# object-store layout: <prefix>/<quoted tenant>/<ts>-<instance>.ckpt
# ---------------------------------------------------------------------------

def _tenant_seg(tenant: str) -> str:
    return urllib.parse.quote(tenant, safe="")


def checkpoint_name(now: float, instance_id: str) -> str:
    # zero-padded nanoseconds sort lexically = chronologically; the
    # writer id makes concurrent cuts collision-free
    return (f"{int(now * 1e9):020d}-"
            f"{urllib.parse.quote(instance_id, safe='')}{CHECKPOINT_SUFFIX}")


def write_checkpoint(writer: RawWriter, prefix: str, tenant: str,
                     blob: bytes, name: str) -> None:
    from tempo_tpu_torch.utils import faults
    if faults.ARMED:
        faults.fire("fleet.checkpoint.write")
    writer.write(name, KeyPath((prefix, _tenant_seg(tenant))), blob)


def list_checkpoints(reader: RawReader, prefix: str
                     ) -> dict[str, list[str]]:
    """{tenant: sorted checkpoint object names} under the prefix."""
    out: dict[str, list[str]] = {}
    try:
        found = reader.find(KeyPath((prefix,)), CHECKPOINT_SUFFIX)
    except (DoesNotExist, FileNotFoundError):
        return out
    for rel in found:
        rel = rel.replace("\\", "/")
        if "/" not in rel:
            continue
        seg, name = rel.rsplit("/", 1)
        out.setdefault(urllib.parse.unquote(seg), []).append(name)
    for names in out.values():
        names.sort()
    return out


def read_checkpoint(reader: RawReader, prefix: str, tenant: str,
                    name: str) -> bytes:
    return reader.read(name, KeyPath((prefix, _tenant_seg(tenant))))


def delete_checkpoint(writer: RawWriter, prefix: str, tenant: str,
                      name: str) -> None:
    writer.delete(name, KeyPath((prefix, _tenant_seg(tenant))))


# -- store-side consumed markers --------------------------------------------
#
# Restore is a scatter-ADD, so restoring a blob twice double-counts. A
# marker written AFTER the merge lands and BEFORE the blob's delete makes
# consumption visible to every process; markers do not end in
# CHECKPOINT_SUFFIX, so list_checkpoints never surfaces them.

CONSUMED_SUFFIX = ".consumed"


def mark_consumed(writer: RawWriter, prefix: str, tenant: str,
                  name: str) -> None:
    writer.write(name + CONSUMED_SUFFIX,
                 KeyPath((prefix, _tenant_seg(tenant))), b"1")


def is_consumed(reader: RawReader, prefix: str, tenant: str,
                name: str) -> bool:
    try:
        reader.read(name + CONSUMED_SUFFIX,
                    KeyPath((prefix, _tenant_seg(tenant))))
        return True
    except (DoesNotExist, FileNotFoundError):
        return False


def delete_consumed_marker(writer: RawWriter, prefix: str, tenant: str,
                           name: str) -> None:
    writer.delete(name + CONSUMED_SUFFIX,
                  KeyPath((prefix, _tenant_seg(tenant))))
