"""FleetController: the per-process half of the fleet protocol.

Counterpart of `tempo_tpu/fleet/controller.py`, host code copied with its
imports pointed at the port. It owns this member's reaction to a
membership change:

- **watch loop**: re-walks the ownership of every held tenant each tick
  (ticks fire on KV ring updates and on a timer: heartbeat expiry is a
  clock event no KV write announces), and scans the checkpoint prefix
  for blobs addressed to tenants this member now owns.
- **drain/handoff**: a lost tenant is popped, fenced, drained and
  snapshotted (`checkpoint.snapshot_instance` gathers its rows on the
  card), written to the object store with jittered retries, its WAL
  truncated below the blob's watermark and its pages released.
- **restore**: on boot and on ownership gain, blobs for owned tenants
  scatter-merge into the live instance on its device, then the consumed
  blob is marked and deleted. Incompatible blobs are quarantined in place
  and surfaced on /status. The first tick replays every local WAL past
  the restored watermarks.

The reference's semantic fallbacks stay: a failed blob write reattaches
or orphans the instance, an incompatible blob is quarantined. A device
failure in a gather or a scatter raises like any other failure of the
step and is retried by the next tick on the device, never on the host.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable

from tempo_tpu_torch.fleet import RETRY_CAUSES, STATS, FleetConfig
from tempo_tpu_torch.fleet import checkpoint as ck
from tempo_tpu_torch.fleet.placement import TenantPlacement
from tempo_tpu_torch.utils import tracing

_LOG = logging.getLogger("tempo_tpu_torch.fleet")

# a checkpoint that failed to restore N times is quarantined (kept in
# the store for inspection, skipped by the watch loop)
_RESTORE_ATTEMPTS = 3


class FleetController:
    def __init__(self, generator, ring, instance_id: str, reader, writer,
                 cfg: FleetConfig | None = None,
                 now: Callable[[], float] = time.time) -> None:
        self.generator = generator
        self.ring = ring
        self.id = instance_id
        self.reader = reader
        self.writer = writer
        self.cfg = cfg or FleetConfig()
        self.now = now
        self.placement = TenantPlacement(ring, instance_id)
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        # (tenant, name) -> consecutive restore failures; at
        # _RESTORE_ATTEMPTS the blob is quarantined
        self._restore_fails: dict[tuple[str, str], int] = {}
        # blobs restored whose DELETE failed: the restore is a
        # scatter-ADD, so replaying one double-counts every series —
        # these are never restored again by this process, only the
        # delete is retried. (In-memory: a crash between restore and
        # delete still replays on the next boot — closing that window
        # needs a restore marker in the store itself.)
        self._consumed: set[tuple[str, str]] = set()
        # instances popped for handoff whose checkpoint write failed
        # AND whose tenant slot was already re-occupied by a straggler
        # push: invisible to the lost() walk, retried every tick until
        # the snapshot lands (state + pool pages must not leak)
        self._orphans: dict[str, list] = {}
        self._lock = threading.Lock()   # serializes tick/shutdown
        self.last_tick_ts = 0.0
        # boot-time ingest-WAL replay runs exactly once, AFTER the boot
        # restore pass populated the per-member watermarks (a second
        # pass would re-apply scatter-adds)
        self._wal_replayed = False
        # ring updates should react faster than the poll interval:
        # a KV publish nudges the loop awake
        kv = getattr(ring, "kv", None)
        if kv is not None:
            try:
                kv.watch_key(ring.key, lambda _v: self._wake.set())
            except Exception:
                pass

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        if self.cfg.restore_on_boot:
            try:
                self.tick()          # boot restore before traffic builds
            except Exception:
                _LOG.exception("fleet %s: boot restore failed", self.id)
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                self._wake.wait(self.cfg.rebalance_interval_s)
                self._wake.clear()
                if self._stop.is_set():
                    return
                try:
                    self.tick()
                except Exception:
                    _LOG.exception("fleet %s: tick failed", self.id)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"fleet-{self.id}")
        self._thread.start()

    def shutdown(self) -> None:
        """Stop the watch loop, then snapshot every held tenant so a
        restart (or the next owner) restores without data loss."""
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        self._thread = None
        if self.cfg.checkpoint_on_shutdown:
            with self._lock:
                self._retry_orphans()
                for tenant in self._held():
                    try:
                        self._checkpoint(tenant, remove=False)
                    except Exception:
                        _LOG.exception("fleet %s: shutdown checkpoint of "
                                       "%s failed", self.id, tenant)

    def _shutdown_fence(self, inst) -> None:
        """Best-effort in-flight fence for the shutdown (non-remove)
        snapshot. The supported deployment entry (fleet.worker) JOINS
        its HTTP handler threads before App.shutdown, so nothing is in
        flight here; an embedding that keeps pushing through shutdown
        still gets the bounded wait, shrinking the watermark-vs-gather
        race snapshot_instance's caller contract describes."""
        if not inst.wait_pushes_idle(5.0):
            _LOG.warning("fleet %s: pushes still in flight for %s at "
                         "shutdown snapshot — join handler threads "
                         "before App.shutdown (fleet.worker does)",
                         self.id, inst.tenant)

    # -- the watch tick ----------------------------------------------------

    def _held(self) -> list[str]:
        # the selftrace loopback tenant never participates in placement:
        # its spans describe THIS process and must stay local to it —
        # handing it off would interleave two processes' self-traces in
        # one instance and checkpoint state the source can't replay
        reserved = tracing.reserved_tenant()
        return [t for t in self.generator.tenants() if t != reserved]

    def tick(self) -> None:
        """One ownership pass: hand off lost tenants, restore gained
        checkpoints. Safe to call concurrently with ingest — every state
        mutation rides the registry/sched locks."""
        with self._lock:
            self.last_tick_ts = self.now()
            self._retry_orphans()
            for tenant, new_owner in self.placement.lost(self._held()):
                try:
                    self._handoff(tenant, new_owner)
                except Exception:
                    _LOG.exception("fleet %s: handoff of %s to %s failed "
                                   "(state retained; retried next tick)",
                                   self.id, tenant, new_owner)
            if self.cfg.restore_on_boot:
                self._restore_owned()
            if not self._wal_replayed:
                # ingest-WAL replay: every tenant with local segments,
                # past the watermark the restore pass (above) merged in.
                # Owned or not — these acked records exist nowhere else;
                # a non-owned tenant's replayed state hands off next tick.
                self._wal_replayed = True
                try:
                    got = self.generator.replay_wal_all()
                    if got["batches"] or got["dead_letters"]:
                        _LOG.info(
                            "fleet %s: WAL replay recovered %d batches "
                            "across %d tenants (%d dead-lettered)",
                            self.id, got["batches"], got["tenants"],
                            got["dead_letters"])
                except Exception:
                    _LOG.exception("fleet %s: WAL replay failed", self.id)

    def _write_checkpoint_blob(self, tenant: str, blob: bytes) -> None:
        """Write one checkpoint blob with bounded jittered-backoff
        retries: a transient store failure during a handoff otherwise
        forces the whole reattach/orphan dance for nothing."""
        delay = self.cfg.checkpoint_retry_backoff_s
        for attempt in range(self.cfg.checkpoint_write_retries + 1):
            try:
                ck.write_checkpoint(
                    self.writer, self.cfg.checkpoint_prefix, tenant, blob,
                    ck.checkpoint_name(self.now(), self.id))
                return
            except Exception as e:
                if attempt >= self.cfg.checkpoint_write_retries:
                    raise
                cause = type(e).__name__
                RETRY_CAUSES[cause] = RETRY_CAUSES.get(cause, 0) + 1
                _LOG.warning(
                    "fleet %s: checkpoint write of %s failed (%s: %s), "
                    "retry %d/%d", self.id, tenant, cause, e,
                    attempt + 1, self.cfg.checkpoint_write_retries)
                time.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2, 5.0)

    def _truncate_wal(self, tenant: str, inst) -> None:
        """Drop WAL segments the just-written blob covers (the snapshot
        recorded its own watermark on the instance)."""
        try:
            self.generator.truncate_wal(
                tenant, getattr(inst, "checkpointed_wal_seq", None))
        except Exception:
            _LOG.exception("fleet %s: WAL truncation of %s failed "
                           "(replay stays watermark-guarded)",
                           self.id, tenant)

    def _retry_orphans(self) -> None:
        """Re-attempt checkpoints of handoff-popped instances whose
        snapshot/write failed while a replacement instance occupied the
        tenant slot (see _checkpoint): they are in nobody's tenant map,
        so only this loop can flush their state and free their pages."""
        for tenant, insts in list(self._orphans.items()):
            left = []
            for inst in insts:
                if not inst.wait_pushes_idle(2.0):
                    # detached: no new pushes can enter, so this drains
                    # eventually — snapshotting past the fence could
                    # lose the straggler (see _checkpoint)
                    left.append(inst)
                    continue
                try:
                    blob = ck.snapshot_instance(inst)
                    self._write_checkpoint_blob(tenant, blob)
                    self._truncate_wal(tenant, inst)
                    self.generator.release_instance_pages(inst)
                except Exception:
                    _LOG.exception("fleet %s: orphan checkpoint of %s "
                                   "still failing", self.id, tenant)
                    left.append(inst)
            if left:
                self._orphans[tenant] = left
            else:
                self._orphans.pop(tenant, None)

    def _handoff(self, tenant: str, new_owner: str) -> None:
        _LOG.info("fleet %s: handing off tenant %s to %s",
                  self.id, tenant, new_owner)
        with tracing.span_for_tenant("fleet.handoff", tenant,
                                     new_owner=new_owner):
            self._checkpoint(tenant, remove=True)
        STATS["handoffs"] += 1

    def _orphan(self, tenant: str, inst) -> None:
        """Stash a popped instance the tenant slot already replaced.
        Its eventual checkpoint must NOT claim the tenant's WAL
        watermark: the replacement instance owns the live WAL stream
        now, and a claim here would truncate records whose state lives
        only in the replacement."""
        inst._wal_mark = None
        self._orphans.setdefault(tenant, []).append(inst)

    def _checkpoint(self, tenant: str, remove: bool) -> None:
        if remove:
            # handoff order matters: POP first (later pushes build a
            # fresh instance that the next tick hands off again — and,
            # with the WAL on, skip appends for the duration of the cut
            # so the snapshot's watermark claim can never cover a
            # replacement instance's records), fence in-flight handler
            # threads, and only then cut the snapshot — an acked push
            # must always be in SOME checkpoint
            inst = self.generator.pop_instance(tenant)
            if inst is None:
                self.generator.end_handoff(tenant)
                return
            try:
                if not inst.wait_pushes_idle(5.0):
                    # NEVER checkpoint past the fence: a straggler
                    # scatter landing after the snapshot would be lost
                    # outright when the pages release below (acked push,
                    # zeroed page). The instance is detached, so no NEW
                    # push can enter it — put it back (or orphan it) and
                    # retry once it drains.
                    _LOG.warning("fleet %s: pushes still in flight for "
                                 "%s after 5s fence; handoff retried "
                                 "next tick", self.id, tenant)
                    if not self.generator.reattach_instance(tenant, inst):
                        self._orphan(tenant, inst)
                    return
                try:
                    with tracing.span_for_tenant("fleet.checkpoint",
                                                 tenant, remove=True):
                        blob = ck.snapshot_instance(inst)
                        self._write_checkpoint_blob(tenant, blob)
                except Exception:
                    # the pop already happened: a failed snapshot/write
                    # must not lose the accrued state or leak its pages
                    # — put the instance back (the lost() walk retries
                    # next tick), or stash it for the orphan loop if a
                    # straggler push already rebuilt the tenant slot
                    if not self.generator.reattach_instance(tenant, inst):
                        self._orphan(tenant, inst)
                    raise
                self._truncate_wal(tenant, inst)
                self.generator.release_instance_pages(inst)
            finally:
                self.generator.end_handoff(tenant)
            return
        inst = self.generator.instances.get(tenant)
        if inst is None:
            return
        self._shutdown_fence(inst)
        with tracing.span_for_tenant("fleet.checkpoint", tenant,
                                     remove=False):
            blob = ck.snapshot_instance(inst)
            self._write_checkpoint_blob(tenant, blob)
        self._truncate_wal(tenant, inst)

    def _restore_owned(self) -> None:
        all_ckpts = ck.list_checkpoints(self.reader,
                                        self.cfg.checkpoint_prefix)
        for tenant, names in all_ckpts.items():
            if not self.placement.owns(tenant):
                continue
            for name in names:
                key = (tenant, name)
                if key in self._consumed:
                    # already restored; only the delete failed. NEVER
                    # restore again (scatter-add replay double-counts) —
                    # just retry the delete
                    self._delete_consumed(tenant, name, key)
                    continue
                if self._restore_fails.get(key, 0) >= _RESTORE_ATTEMPTS:
                    continue            # quarantined
                try:
                    consumed = ck.is_consumed(self.reader,
                                              self.cfg.checkpoint_prefix,
                                              tenant, name)
                except Exception:
                    continue            # store unreachable: next tick
                if consumed:
                    # another process (or a prior crashed run of this
                    # one) merged this blob and died before deleting it:
                    # clean up, never replay
                    _LOG.info("fleet %s: checkpoint %s/%s carries a "
                              "consumed marker — deleting without "
                              "restore", self.id, tenant, name)
                    self._delete_consumed(tenant, name, key)
                    continue
                try:
                    blob = ck.read_checkpoint(
                        self.reader, self.cfg.checkpoint_prefix, tenant,
                        name)
                except Exception:
                    continue            # listed-then-consumed race: skip
                inst = self.generator.instance(tenant)
                try:
                    with tracing.span_for_tenant("fleet.restore", tenant,
                                                 blob=name):
                        stats = ck.restore_instance(inst, blob)
                except ValueError as e:
                    # CheckpointMismatch / sketch merge guard: poison —
                    # quarantine immediately, keep the blob for forensics
                    self._restore_fails[key] = _RESTORE_ATTEMPTS
                    _LOG.error("fleet %s: checkpoint %s/%s incompatible, "
                               "quarantined: %s", self.id, tenant, name, e)
                    continue
                except Exception:
                    self._restore_fails[key] = \
                        self._restore_fails.get(key, 0) + 1
                    _LOG.exception("fleet %s: restore of %s/%s failed "
                                   "(attempt %d/%d)", self.id, tenant, name,
                                   self._restore_fails[key],
                                   _RESTORE_ATTEMPTS)
                    continue
                _LOG.info("fleet %s: restored %s/%s (%d series, %d "
                          "dropped)", self.id, tenant, name,
                          stats["series"], stats["dropped"])
                self._consumed.add(key)
                try:
                    # marker BEFORE delete: a crash between the two
                    # strands a tiny marker, never a replayable blob
                    ck.mark_consumed(self.writer,
                                     self.cfg.checkpoint_prefix, tenant,
                                     name)
                except Exception:
                    _LOG.exception("fleet %s: consumed marker for %s/%s "
                                   "failed (in-memory guard still held)",
                                   self.id, tenant, name)
                self._delete_consumed(tenant, name, key)
                self._restore_fails.pop(key, None)

    def _delete_consumed(self, tenant: str, name: str,
                         key: tuple[str, str]) -> None:
        """Delete a restored blob + its consumed marker; key leaves the
        in-memory consumed set only once the blob is really gone."""
        from tempo_tpu_torch.backend.raw import DoesNotExist

        try:
            ck.delete_checkpoint(self.writer, self.cfg.checkpoint_prefix,
                                 tenant, name)
        except (DoesNotExist, FileNotFoundError):
            pass                        # a peer already deleted it
        except Exception:
            self._consumed.add(key)
            _LOG.exception("fleet %s: delete of consumed checkpoint "
                           "%s/%s failed (retried next tick)",
                           self.id, tenant, name)
            return
        self._consumed.discard(key)
        try:
            ck.delete_consumed_marker(self.writer,
                                      self.cfg.checkpoint_prefix, tenant,
                                      name)
        except (DoesNotExist, FileNotFoundError):
            pass
        except Exception:
            _LOG.warning("fleet %s: stale consumed marker left for "
                         "%s/%s", self.id, tenant, name)

    # -- observability -----------------------------------------------------

    def status(self) -> dict:
        held = self._held()
        owned = [t for t in held if self.placement.owns(t)]
        # dict/set .copy() are atomic under the GIL; iterating the LIVE
        # containers would race the tick thread's inserts (RuntimeError:
        # changed size during iteration → intermittent /status 500s)
        fails = self._restore_fails.copy()
        orphans = self._orphans.copy()
        quarantined = [f"{t}/{n}" for (t, n), c in fails.items()
                       if c >= _RESTORE_ATTEMPTS]
        return {
            "instance": self.id,
            "held_tenants": len(held),
            "owned_tenants": len(owned),
            "foreign_tenants": sorted(set(held) - set(owned))[:20],
            "last_tick_age_s": round(self.now() - self.last_tick_ts, 3)
            if self.last_tick_ts else None,
            "quarantined_checkpoints": quarantined,
            "orphaned_instances": sum(len(v) for v in orphans.values()),
            "pending_checkpoint_deletes": len(self._consumed),
            "checkpoints_written": STATS["checkpoints"],
            "restores": STATS["restores"],
            "handoffs": STATS["handoffs"],
        }
