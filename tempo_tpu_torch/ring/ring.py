"""Consistent-hash ring with RF replication sets and shuffle sharding.

Counterpart of `tempo_tpu/ring/ring.py`, host code copied with its imports
moved to the port.

Analog of the dskit ring the reference leans on for every placement
decision: distributor→ingester replication (`distributor.go:511-547`
`ring.DoBatchWithOptions`), per-tenant shuffle shards
(`distributor.go:511,567,622`), compactor job ownership
(`modules/compactor/compactor.go:190`), and read-path quorum
(`modules/querier/querier.go:318` `forIngesterRings`).

Token math is numpy-vectorized: a batch of span tokens resolves to
replication sets with one `searchsorted` over the token array — the TPU-era
answer to dskit's per-key ring walks.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np

from tempo_tpu_torch.ops.hashing import fnv1a_32

def _hash_str(s: str) -> int:
    import numpy as _np
    return int(fnv1a_32(_np.frombuffer(s.encode(), _np.uint8))[0])


ACTIVE = "ACTIVE"
JOINING = "JOINING"
LEAVING = "LEAVING"
UNHEALTHY = "UNHEALTHY"

RING_KEY = "ring"


def _instance_tokens(instance_id: str, n_tokens: int) -> np.ndarray:
    """Deterministic pseudo-random tokens for an instance (uint32 space)."""
    seed = _hash_str(instance_id)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n_tokens, dtype=np.uint64).astype(np.uint32)


@dataclasses.dataclass
class InstanceDesc:
    id: str
    addr: str = ""
    zone: str = ""
    state: str = ACTIVE
    tokens: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.uint32))
    heartbeat_ts: float = 0.0
    registered_ts: float = 0.0


@dataclasses.dataclass
class ReplicationSet:
    instances: list[InstanceDesc]
    max_errors: int

    @property
    def quorum(self) -> int:
        return len(self.instances) - self.max_errors


class _RingState:
    """One immutable membership snapshot: instance map + derived token
    tables + lazily built walk tables. Readers grab `ring._state` once and
    work off a consistent view — the KV poller thread publishes a NEW
    snapshot with a single attribute assignment, so a lookup can never see
    fresh ids with stale owners (ADVICE r2 #1)."""

    __slots__ = ("instances", "ids", "tokens", "owners", "walk_cache",
                 "shuffle_ids", "shuffle_rings", "fingerprint", "set_cache")

    def __init__(self, instances: dict[str, InstanceDesc]) -> None:
        self.instances = instances
        ids, toks, owners = [], [], []
        for idx, inst in enumerate(sorted(instances.values(),
                                          key=lambda i: i.id)):
            ids.append(inst.id)
            toks.append(inst.tokens)
            owners.append(np.full(len(inst.tokens), idx, np.int64))
        self.ids = ids
        if toks and sum(len(t) for t in toks):
            all_t = np.concatenate(toks)
            all_o = np.concatenate(owners)
            order = np.argsort(all_t, kind="stable")
            self.tokens = all_t[order]
            self.owners = all_o[order]
        else:
            self.tokens = np.zeros(0, np.uint32)
            self.owners = np.zeros(0, np.int64)
        # walk/shuffle results depend only on membership (ids, zones,
        # tokens) — NOT on heartbeats — so snapshots with an identical
        # fingerprint share them (a heartbeat-only KV update must not
        # re-derive O(total-tokens * rf) walk tables)
        # the tuple itself, not its hash: equality must be exact — a hash
        # collision would silently share walk tables across memberships
        self.fingerprint = tuple(
            (i, instances[i].zone, instances[i].tokens.tobytes())
            for i in ids)
        # rf -> {ring position -> replication member ids}, built lazily
        # per touched position (health-agnostic)
        self.walk_cache: dict[int, dict[int, list[str]]] = {}
        # (tenant, size) -> picked member ids (reusable across snapshots
        # with the same fingerprint)
        self.shuffle_ids: dict[tuple[str, int], tuple[str, ...]] = {}
        # (tenant, size) -> sub-Ring built from THIS snapshot's descs
        # (never shared: health reads the current heartbeat_ts)
        self.shuffle_rings: dict[tuple[str, int], "Ring"] = {}
        # (pos, rf) -> (built_at, ReplicationSet): health-FILTERED sets,
        # so entries expire on a short TTL (heartbeat timeouts are
        # seconds-granular; rebuilding per batch_lookup call was the
        # distributor hot path's biggest python cost)
        self.set_cache: dict[tuple[int, int], tuple[float, object]] = {}

    def walk_from(self, start: int, rf: int) -> list[InstanceDesc]:
        """Clockwise walk from ring position `start` collecting rf distinct
        instances (distinct zones first when zones are in play, like dskit
        zone-awareness)."""
        picked: list[InstanceDesc] = []
        seen_ids: set[str] = set()
        seen_zones: set[str] = set()
        distinct = len({i.zone for i in self.instances.values()})
        for off in range(len(self.tokens)):
            idx = (start + off) % len(self.tokens)
            inst = self.instances[self.ids[int(self.owners[idx])]]
            if inst.id in seen_ids:
                continue
            if inst.zone and distinct >= rf and inst.zone in seen_zones:
                continue
            seen_ids.add(inst.id)
            seen_zones.add(inst.zone)
            picked.append(inst)
            if len(picked) == rf:
                break
        return picked

    def walk_members(self, pos: int, rf: int) -> list[str]:
        """Replication member ids for one ring position, cached lazily:
        replica sets depend only on WHERE a token lands, so a batch of any
        size resolves with one searchsorted plus a unique over at most
        len(self.tokens) positions — and only positions actually hit ever
        pay the walk. Racing builders may duplicate work; the dict write
        is atomic either way."""
        tab = self.walk_cache.setdefault(rf, {})
        got = tab.get(pos)
        if got is None:
            got = tab[pos] = [i.id for i in self.walk_from(pos, rf)]
        return got

    def walk(self, token: int, rf: int) -> list[InstanceDesc]:
        if len(self.tokens) == 0:
            return []
        start = int(np.searchsorted(self.tokens, token, side="left")) \
            % len(self.tokens)
        return self.walk_from(start, rf)


class Ring:
    """The ring view: sorted token table → owning instances."""

    def __init__(self, kv: "Any | None" = None, key: str = RING_KEY,
                 replication_factor: int = 3,
                 heartbeat_timeout_s: float = 60.0,
                 now: Callable[[], float] = time.time) -> None:
        self.kv = kv
        self.key = key
        self.rf = replication_factor
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.now = now
        self._state = _RingState({})
        self._wlock = threading.Lock()   # writers only; readers are lockless
        if kv is not None:
            kv.watch_key(key, self._on_update)
            cur = kv.get(key)
            if cur:
                self._on_update(cur)

    # -- membership --------------------------------------------------------

    @property
    def _instances(self) -> dict[str, InstanceDesc]:
        return self._state.instances

    def _publish(self, m: dict[str, InstanceDesc]) -> None:
        """Build + swap a snapshot; heartbeat-only updates (identical
        membership fingerprint) inherit the previous snapshot's walk
        tables and shuffle picks instead of re-deriving them."""
        st = _RingState(m)
        old = self._state
        if old is not None and old.fingerprint == st.fingerprint:
            st.walk_cache = old.walk_cache
            st.shuffle_ids = old.shuffle_ids
        self._state = st

    def _on_update(self, desc_map: dict[str, InstanceDesc]) -> None:
        with self._wlock:
            self._publish(dict(desc_map))

    def register(self, inst: InstanceDesc) -> None:
        """Local registration (tests / single-binary); Lifecycler for KV."""
        with self._wlock:
            m = dict(self._state.instances)
            m[inst.id] = inst
            self._publish(m)

    def unregister(self, instance_id: str) -> None:
        with self._wlock:
            m = dict(self._state.instances)
            m.pop(instance_id, None)
            self._publish(m)

    def healthy(self, inst: InstanceDesc) -> bool:
        if inst.state != ACTIVE:
            return False
        if self.heartbeat_timeout_s <= 0 or inst.heartbeat_ts <= 0:
            return True
        return self.now() - inst.heartbeat_ts <= self.heartbeat_timeout_s

    def instances(self) -> list[InstanceDesc]:
        st = self._state
        return [st.instances[i] for i in st.ids]

    def instance(self, instance_id: str) -> InstanceDesc | None:
        return self._state.instances.get(instance_id)

    def healthy_instances(self) -> list[InstanceDesc]:
        return [i for i in self.instances() if self.healthy(i)]

    def ownership(self) -> dict[str, float]:
        """Fraction of the uint32 token space each instance owns (RF1
        view — the tenant/job-placement share). searchsorted(side=left)
        maps a key to the first ring token >= it, so the arc
        (prev_token, token] belongs to that token's registrant; the
        wrap-around arc goes to the first token. Sums to 1.0 over a
        non-empty ring."""
        st = self._state
        n = len(st.tokens)
        if n == 0:
            return {}
        toks = st.tokens.astype(np.float64)
        gaps = np.empty(n, np.float64)
        gaps[1:] = np.diff(toks)
        gaps[0] = toks[0] + (2.0 ** 32 - toks[-1])
        out = {iid: 0.0 for iid in st.ids}
        share = np.bincount(st.owners, weights=gaps, minlength=len(st.ids))
        for idx, iid in enumerate(st.ids):
            out[iid] = float(share[idx]) / 2.0 ** 32
        return out

    def oldest_heartbeat_age(self) -> float:
        """Seconds since the stalest ACTIVE member's heartbeat (0.0 when
        the ring is empty or no member has ever heartbeated) — the
        /status + TempoRingMemberStale signal."""
        beats = [i.heartbeat_ts for i in self.instances()
                 if i.state == ACTIVE and i.heartbeat_ts > 0]
        if not beats:
            return 0.0
        return max(0.0, self.now() - min(beats))

    def __len__(self) -> int:
        return len(self._state.instances)

    # -- lookups -----------------------------------------------------------

    def _walk(self, token: int, rf: int) -> list[InstanceDesc]:
        return self._state.walk(token, rf)

    def _set_at(self, st: _RingState, pos: int, rf: int) -> ReplicationSet:
        """ReplicationSet for ring position `pos`, health-filtered (cached
        on the snapshot for 0.5s — see _RingState.set_cache)."""
        key = (pos, rf)
        cached = st.set_cache.get(key)
        now = self.now()
        if cached is not None and now - cached[0] < 0.5:
            return cached[1]
        rs = self._set_at_uncached(st, pos, rf)
        st.set_cache[key] = (now, rs)
        return rs

    def _set_at_uncached(self, st: _RingState, pos: int,
                         rf: int) -> ReplicationSet:
        full = [st.instances[iid] for iid in st.walk_members(pos, rf)]
        if not full:
            # an empty ring can never satisfy quorum — failing loudly beats
            # a ReplicationSet of nobody that "succeeds" while dropping data
            raise RuntimeError("ring is empty: no instances registered")
        healthy = [i for i in full if self.healthy(i)]
        # quorum over the ACTUAL replica count: a 1-instance ring under RF3
        # must require that one write to succeed, not tolerate its failure
        eff = min(rf, len(full))
        max_errors = eff - (eff // 2 + 1) - (len(full) - len(healthy))
        if max_errors < 0:
            raise RuntimeError(
                f"too many unhealthy instances ({len(full) - len(healthy)}/{len(full)})")
        return ReplicationSet(healthy, max_errors)

    def get(self, token: int, rf: int | None = None) -> ReplicationSet:
        """Replication set for one token, filtered to healthy instances.

        max_errors follows dskit: tolerate (rf - quorum) failures where
        quorum = rf//2 + 1; unhealthy instances eat into the error budget
        (`distributor.go:826-887` per-trace quorum accounting).
        """
        rf = rf or self.rf
        st = self._state
        if len(st.tokens) == 0:
            raise RuntimeError("ring is empty: no instances registered")
        pos = int(np.searchsorted(st.tokens, token, side="left")) \
            % len(st.tokens)
        return self._set_at(st, pos, rf)

    def batch_lookup(self, tokens: np.ndarray, rf: int | None = None
                     ) -> tuple[list[ReplicationSet], np.ndarray]:
        """Vectorized: one searchsorted maps every token to its ring
        position; replica sets materialize per unique POSITION (≤ total
        token count of the ring, independent of batch size). Returns
        per-unique-position ReplicationSets + inverse index [len(tokens)]."""
        rf = rf or self.rf
        st = self._state
        tokens = np.asarray(tokens, np.uint32)
        if len(st.tokens) == 0:
            if len(tokens):
                raise RuntimeError("ring is empty: no instances registered")
            return [], np.zeros(0, np.int64)
        if len(tokens) == 0:
            return [], np.zeros(0, np.int64)
        if len(st.instances) == 1:
            # one registrant owns every token: no per-token position math
            return ([self._set_at(st, 0, rf)],
                    np.zeros(len(tokens), np.int64))
        pos = np.searchsorted(st.tokens, tokens, side="left") \
            % len(st.tokens)
        if len(tokens) * 4 >= len(st.tokens):
            # large batch: O(ring tokens) bincount beats the sort
            hit = np.bincount(pos, minlength=len(st.tokens)) > 0
            uniq = np.flatnonzero(hit)
            remap = np.zeros(len(st.tokens), np.int64)
            remap[uniq] = np.arange(len(uniq))
            inverse = remap[pos]
        else:
            # small batch on a big ring: sorting the handful of positions
            # is cheaper than touching every ring token
            uniq, inverse = np.unique(pos, return_inverse=True)
        return [self._set_at(st, int(p), rf) for p in uniq], inverse

    def owner_of(self, key: str | int) -> InstanceDesc | None:
        """The single healthy owner of hash(key) (RF1 with spillover):
        the clockwise walk skips UNHEALTHY instances, so a crashed
        member's share fails over to the next live instance. None on an
        empty/all-dead ring."""
        st = self._state
        token = key if isinstance(key, int) else _hash_str(str(key))
        for inst in st.walk(token, len(st.instances) or 1):
            if self.healthy(inst):
                return inst
        return None

    def owns(self, member_id: str, key: str | int) -> bool:
        """Ring-job ownership: does member_id own hash(key)?  The compactor
        pattern (`modules/compactor/compactor.go:190`): single owner = RF 1.

        Ownership walks past UNHEALTHY instances: a crashed peer's job
        share fails over to the next live instance instead of black-holing
        until the stale descriptor is removed."""
        owner = self.owner_of(key)
        return owner is not None and owner.id == member_id

    # -- shuffle sharding --------------------------------------------------

    def shuffle_shard(self, tenant: str, size: int) -> "Ring":
        """Deterministic per-tenant sub-ring of `size` instances.

        Mirrors dskit shuffle sharding (used at `distributor.go:511,567`):
        seed tokens derived from the tenant pick spread-out instances, so a
        tenant's blast radius is its shard, not the whole ring.
        """
        st = self._state
        if size <= 0 or size >= len(st.instances):
            return self
        key = (tenant, size)
        cached = st.shuffle_rings.get(key)
        if cached is not None:
            return cached
        picked = st.shuffle_ids.get(key)
        if picked is None:
            seed = _hash_str(tenant)
            rng = np.random.default_rng(seed)
            sel: set[str] = set()
            # walk only returns token-owning instances: cap the target at
            # that count (a zero-token registrant would otherwise never be
            # picked and the loop would spin forever) and bound iterations
            owners = {i.id for i in st.instances.values() if len(i.tokens)}
            target = min(size, len(owners))
            for _ in range(64 * max(target, 1)):
                if len(sel) >= target:
                    break
                tok = int(rng.integers(0, 2**32))
                for inst in st.walk(tok, len(st.instances)):
                    if inst.id not in sel:
                        sel.add(inst.id)
                        break
            picked = st.shuffle_ids[key] = tuple(sorted(sel))
        sub = Ring(replication_factor=self.rf,
                   heartbeat_timeout_s=self.heartbeat_timeout_s, now=self.now)
        # built from THIS snapshot's descs: health must read fresh
        # heartbeats; the picked-ids layer is what survives heartbeats
        sub._state = _RingState({iid: st.instances[iid] for iid in picked})
        st.shuffle_rings[key] = sub
        return sub


class Lifecycler:
    """Instance lifecycle against the KV ring: join, heartbeat, leave.

    The dskit lifecycler analog (`modules.go:154-173` ingester ring wiring):
    owns this process's tokens and keeps its heartbeat fresh so peers'
    `Ring.healthy` sees it.
    """

    def __init__(self, kv: Any, instance_id: str, *, addr: str = "",
                 zone: str = "", n_tokens: int = 128, key: str = RING_KEY,
                 now: Callable[[], float] = time.time) -> None:
        self.kv = kv
        self.id = instance_id
        self.key = key
        self.now = now
        self.desc = InstanceDesc(
            id=instance_id, addr=addr, zone=zone, state=JOINING,
            tokens=_instance_tokens(instance_id, n_tokens),
            heartbeat_ts=now(), registered_ts=now())
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self._publish()
        self.desc.state = ACTIVE
        self._publish()

    def _publish(self) -> None:
        def update(cur):
            m = dict(cur or {})
            m[self.id] = dataclasses.replace(self.desc)
            return m
        self.kv.cas(self.key, update)

    def heartbeat(self) -> None:
        self.desc.heartbeat_ts = self.now()
        self._publish()

    # -- background heartbeat loop -----------------------------------------

    def start_heartbeat(self, interval_s: float = 15.0,
                        jitter: float = 0.2) -> None:
        """Heartbeat on a background thread at `interval_s` ± jitter
        (fractional, deterministic per instance id — a fleet started in
        lockstep must not CAS-storm the KV on every beat). Idempotent;
        `stop_heartbeat()` / `leave()` stops and joins it. A failed
        publish (KV transiently unreachable) is retried next beat —
        peers only mark this instance unhealthy after the full
        heartbeat timeout."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._hb_stop.clear()
        # spread instances across the interval without randomness in the
        # loop: a per-instance phase offset in [-jitter, +jitter]
        phase = ((_hash_str(self.id) % 1000) / 1000.0 * 2.0 - 1.0) * jitter
        wait_s = max(0.05, interval_s * (1.0 + phase))

        def loop() -> None:
            while not self._hb_stop.wait(wait_s):
                try:
                    self.heartbeat()
                except Exception:
                    pass
        self._hb_thread = threading.Thread(
            target=loop, daemon=True, name=f"lifecycler-hb-{self.id}")
        self._hb_thread.start()

    def stop_heartbeat(self, timeout_s: float = 2.0) -> None:
        self._hb_stop.set()
        t = self._hb_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout_s)
        self._hb_thread = None

    def leave(self) -> None:
        self.stop_heartbeat()
        self.desc.state = LEAVING
        self._publish()
        def update(cur):
            m = dict(cur or {})
            m.pop(self.id, None)
            return m
        self.kv.cas(self.key, update)


def do_batch(ring: Ring, tokens: np.ndarray, indexes: Sequence[Any],
             send: Callable[[InstanceDesc, list[Any]], None],
             rf: int | None = None) -> None:
    """Quorum batch write: group items by replication set, call `send` once
    per instance with its item list, succeed iff every item reaches quorum.

    The `ring.DoBatchWithOptions` analog (`distributor.go:513`): an item
    (trace) succeeds when quorum instances took it; the whole batch errors
    if any item cannot reach quorum (`distributor.go:826-887`).
    """
    sets, inverse = ring.batch_lookup(tokens, rf)
    by_instance: dict[str, tuple[InstanceDesc, list[Any]]] = {}
    item_maxerr = np.array([rs.max_errors for rs in sets], np.int64)
    for ui, rs in enumerate(sets):
        for inst in rs.instances:
            by_instance.setdefault(inst.id, (inst, []))[1].append(ui)

    # group item positions by unique ring position once (argsort), instead
    # of one O(n) scan per unique position per replica — computed lazily:
    # an instance covering every position takes the whole batch directly
    order = bounds = None

    def _regroup():
        nonlocal order, bounds
        if order is None:
            order = np.argsort(inverse, kind="stable")
            counts = np.bincount(inverse, minlength=len(sets))
            bounds = np.zeros(len(sets) + 1, np.int64)
            np.cumsum(counts, out=bounds[1:])

    failures = np.zeros(len(sets), np.int64)
    errs: list[Exception] = []
    for iid, (inst, uis) in by_instance.items():
        if len(uis) == len(sets):
            # item order is not part of the send contract
            flat = list(indexes)
        else:
            _regroup()
            flat = [indexes[j]
                    for ui in uis
                    for j in order[bounds[ui]:bounds[ui + 1]].tolist()]
        try:
            send(inst, flat)
        except Exception as e:  # instance failed: charge every item it held
            errs.append(e)
            for ui in uis:
                failures[ui] += 1
    bad = failures > item_maxerr
    if bad.any():
        raise RuntimeError(
            f"{int(bad.sum())} item group(s) failed quorum "
            f"(first error: {errs[0] if errs else 'n/a'})")
