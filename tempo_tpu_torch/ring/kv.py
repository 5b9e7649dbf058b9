"""CAS key-value stores standing in for memberlist gossip.

Counterpart of `tempo_tpu/ring/kv.py`, host code copied with its imports
moved to the port.

The reference propagates ring state via dskit memberlist gossip KV
(`cmd/tempo/app/modules.go:593-625`). Within one process (the single-binary
target, `modules.go:711,742`) every module shares one `KVStore`;
multi-process deployments point every process's `RemoteKVStore` at one
process's `/kv/*` HTTP CAS routes — same `get/cas/watch_key` semantics as
dskit's `kv.Client`, with polling watches replacing gossip push.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable

from tempo_tpu_torch.utils import faults


class KVStore:
    """Thread-safe CAS store with key watches (dskit `kv.Client` analog)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: dict[str, tuple[int, Any]] = {}  # key -> (version, value)
        self._watches: dict[str, list[Callable[[Any], None]]] = {}

    def get(self, key: str) -> Any:
        with self._lock:
            v = self._data.get(key)
            return v[1] if v else None

    def get_versioned(self, key: str) -> tuple[int, Any]:
        with self._lock:
            return self._data.get(key, (0, None))

    def cas_versioned(self, key: str, expect_version: int,
                      value: Any) -> tuple[bool, int]:
        """Conditional put for the HTTP KV service: succeeds only when the
        stored version matches. Returns (ok, current_version)."""
        if faults.ARMED:
            faults.fire("ring.kv.cas")
        with self._lock:
            ver, _ = self._data.get(key, (0, None))
            if ver != expect_version:
                return False, ver
            self._data[key] = (ver + 1, value)
            watchers = list(self._watches.get(key, ()))
        for w in watchers:
            w(value)
        return True, expect_version + 1

    def cas(self, key: str, update: Callable[[Any], Any],
            retries: int = 10) -> Any:
        """Read-modify-write with optimistic concurrency, like kv CAS loops
        (usage-stats leader election `pkg/usagestats/reporter.go:239`)."""
        if faults.ARMED:
            faults.fire("ring.kv.cas")
        for _ in range(retries):
            with self._lock:
                ver, cur = self._data.get(key, (0, None))
            new = update(cur)
            if new is None:
                return cur
            with self._lock:
                ver2, _ = self._data.get(key, (0, None))
                if ver2 != ver:
                    continue  # raced; retry with fresh value
                self._data[key] = (ver + 1, new)
                watchers = list(self._watches.get(key, ()))
            for w in watchers:
                w(new)
            return new
        raise RuntimeError(f"CAS contention on {key!r}")

    def watch_key(self, key: str, cb: Callable[[Any], None]) -> None:
        with self._lock:
            self._watches.setdefault(key, []).append(cb)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._data)


# ---------------------------------------------------------------------------
# Cross-process KV: HTTP CAS client with polling watches
# ---------------------------------------------------------------------------

# backoff cap: 32x the poll interval (a 1s poller degrades to one probe
# every ~30s against a dead host), bounded to a minute outright
_POLL_BACKOFF_MAX_FACTOR = 32


def _poll_backoff(interval_s: float, fail_streak: int) -> float:
    """Watch-poll wait for the current consecutive-failure streak."""
    factor = min(2 ** min(fail_streak, 16), _POLL_BACKOFF_MAX_FACTOR)
    return min(interval_s * factor, max(interval_s, 60.0))

def _value_to_json(value: Any) -> Any:
    """Ring desc-maps (the KV's dominant payload) serialize explicitly;
    everything else must already be JSON-safe."""
    from tempo_tpu_torch.ring.ring import InstanceDesc

    if isinstance(value, dict) and value and \
            all(isinstance(v, InstanceDesc) for v in value.values()):
        return {"__ring__": {
            iid: {"id": d.id, "addr": d.addr, "zone": d.zone,
                  "state": d.state, "tokens": [int(t) for t in d.tokens],
                  "heartbeat_ts": d.heartbeat_ts,
                  "registered_ts": d.registered_ts}
            for iid, d in value.items()}}
    return value


def _value_from_json(value: Any) -> Any:
    import numpy as np

    from tempo_tpu_torch.ring.ring import InstanceDesc

    if isinstance(value, dict) and "__ring__" in value:
        return {
            iid: InstanceDesc(
                id=d["id"], addr=d.get("addr", ""), zone=d.get("zone", ""),
                state=d.get("state", "ACTIVE"),
                tokens=np.asarray(d.get("tokens", []), np.uint32),
                heartbeat_ts=d.get("heartbeat_ts", 0.0),
                registered_ts=d.get("registered_ts", 0.0))
            for iid, d in value["__ring__"].items()}
    return value


class RemoteKVStore:
    """`kv.Client` over another process's `/kv/*` HTTP CAS routes.

    The deployment analog of pointing every service at the memberlist
    cluster (`modules.go:593-625`): rings and lifecyclers consume this
    exactly like the in-process `KVStore`. Watches poll (default 1s) —
    the latency envelope of gossip convergence, without the protocol.
    """

    def __init__(self, base_url: str, poll_interval_s: float = 1.0,
                 timeout_s: float = 5.0) -> None:
        self._ep = _HttpEndpoint(base_url, timeout_s)
        self.base = self._ep.base
        self.poll_interval_s = poll_interval_s
        self.timeout = timeout_s
        self._watches: dict[str, list[Callable[[Any], None]]] = {}
        self._versions: dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poller: threading.Thread | None = None

    # -- http (shared endpoint plumbing: _HttpEndpoint) --------------------

    def _fetch(self, key: str) -> tuple[int, Any]:
        return self._ep.fetch(key)

    def get(self, key: str) -> Any:
        return self._fetch(key)[1]

    def cas(self, key: str, update: Callable[[Any], Any],
            retries: int = 10) -> Any:
        if faults.ARMED:
            faults.fire("ring.kv.cas")
        for _ in range(retries):
            ver, cur = self._fetch(key)
            new = update(cur)
            if new is None:
                return cur
            ok, newver = self._ep.cas_versioned(key, ver, new)
            if not ok:
                continue                # raced; retry with fresh value
            self._notify(key, new, newver)
            return new
        raise RuntimeError(f"CAS contention on {key!r}")

    # -- watches (polling) --------------------------------------------------

    def watch_key(self, key: str, cb: Callable[[Any], None]) -> None:
        with self._lock:
            self._watches.setdefault(key, []).append(cb)
            if self._poller is None:
                self._poller = threading.Thread(target=self._poll_loop,
                                                daemon=True)
                self._poller.start()

    def _notify(self, key: str, value: Any, version: int) -> None:
        with self._lock:
            # dedupe on equality, not monotonicity: a restarted KV host
            # resets versions to 0, and a >= watermark would freeze every
            # watcher until the counter climbed back past its old value
            if self._versions.get(key) == version:
                return
            self._versions[key] = version
            watchers = list(self._watches.get(key, ()))
        for w in watchers:
            try:
                w(value)
            except Exception:
                pass

    def _poll_loop(self) -> None:
        # exponential backoff on repeated fetch errors: a dead KV host
        # must not burn a poll-interval of connect timeouts forever —
        # the wait doubles per all-failed pass (capped) and snaps back
        # to the configured interval on the first success
        fail_streak = 0
        while not self._stop.wait(_poll_backoff(self.poll_interval_s,
                                                fail_streak)):
            with self._lock:
                keys = list(self._watches)
            ok = not keys       # an idle poller has nothing to fail at
            for k in keys:
                try:
                    ver, val = self._fetch(k)
                except Exception:
                    continue            # KV briefly unreachable: keep view
                ok = True
                if val is not None:
                    self._notify(k, val, ver)
            fail_streak = 0 if ok else fail_streak + 1

    def delete(self, key: str) -> None:
        self._ep.delete(key)

    def shutdown(self, timeout_s: float = 2.0) -> None:
        """Stop and JOIN the poller (bounded): embedded/test reuse must
        not leak a watch thread per KV client instance."""
        self._stop.set()
        t = self._poller
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout_s)
        self._poller = None


# ---------------------------------------------------------------------------
# Replicated KV: per-member CAS over N hosts (the memberlist de-SPOF)
# ---------------------------------------------------------------------------

class _HttpEndpoint:
    """One peer's /kv/* CAS surface."""

    def __init__(self, base_url: str, timeout_s: float = 2.0) -> None:
        self.base = base_url.rstrip("/")
        self.timeout = timeout_s

    def __repr__(self) -> str:
        return f"kv@{self.base}"

    def fetch(self, key: str) -> tuple[int, Any]:
        url = f"{self.base}/kv/{urllib.parse.quote(key)}"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                d = json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return 0, None
            raise
        return d["version"], _value_from_json(d["value"])

    def cas_versioned(self, key: str, expect_version: int,
                      value: Any) -> tuple[bool, int]:
        body = json.dumps({"expect_version": expect_version,
                           "value": _value_to_json(value)}).encode()
        req = urllib.request.Request(
            f"{self.base}/kv/{urllib.parse.quote(key)}", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                d = json.loads(r.read())
            return True, int(d.get("version", expect_version + 1))
        except urllib.error.HTTPError as e:
            if e.code == 409:
                return False, -1
            raise

    def delete(self, key: str) -> None:
        req = urllib.request.Request(
            f"{self.base}/kv/{urllib.parse.quote(key)}", method="DELETE")
        try:
            urllib.request.urlopen(req, timeout=self.timeout).close()
        except urllib.error.HTTPError:
            pass


class _LocalEndpoint:
    """The member store this process hosts (also served on its /kv/*)."""

    def __init__(self, store: KVStore) -> None:
        self.store = store

    def __repr__(self) -> str:
        return "kv@local"

    def fetch(self, key: str) -> tuple[int, Any]:
        return self.store.get_versioned(key)

    def cas_versioned(self, key: str, expect_version: int,
                      value: Any) -> tuple[bool, int]:
        return self.store.cas_versioned(key, expect_version, value)

    def delete(self, key: str) -> None:
        self.store.delete(key)


def _merge_values(vals: list[Any]) -> Any:
    """Merge the reachable members' views of one key.

    Ring desc maps merge entry-wise with the freshest heartbeat winning —
    the convergence rule of gossip: a member that missed a write catches
    up at the next publish, and a cleanly-left instance lingers only on
    members that missed the removal (where staleness marks it unhealthy,
    as with memberlist tombstones). Non-ring values: first non-None view
    (callers needing linearizable semantics should not fan out)."""
    from tempo_tpu_torch.ring.ring import InstanceDesc

    ring_maps = [v for v in vals if isinstance(v, dict) and v
                 and all(isinstance(x, InstanceDesc) for x in v.values())]
    if ring_maps:
        out: dict[str, InstanceDesc] = {}
        for m in ring_maps:
            for iid, d in m.items():
                cur = out.get(iid)
                if cur is None or d.heartbeat_ts > cur.heartbeat_ts:
                    out[iid] = d
        return out
    for v in vals:
        if v is not None:
            return v
    return None


class ReplicatedKVStore:
    """Client-side replication over N KV members: per-member CAS loops;
    reads and polled watches merge all reachable views. AP like the
    memberlist gossip it stands in for (`modules.go:593-625`): a write
    succeeds when ANY member accepts (a cluster must be able to bootstrap
    from its first member, and a partitioned member re-converges through
    merge-on-read plus the heartbeat republish cycle); it fails only when
    no member is reachable. De-SPOFs hosting ring state in one process —
    any minority of members can die with writes and reads still green."""

    def __init__(self, endpoints: list, poll_interval_s: float = 1.0) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self.endpoints = endpoints
        self.poll_interval_s = poll_interval_s
        # members are contacted CONCURRENTLY: one hung (not dead) member
        # must cost the cluster max(latency), not sum — a serial loop
        # would stall every heartbeat and watch poll by its timeout
        self._pool = ThreadPoolExecutor(
            max_workers=max(len(endpoints), 1),
            thread_name_prefix="kv-member")
        self._watches: dict[str, list[Callable[[Any], None]]] = {}
        self._last: dict[str, str] = {}      # key -> merged-content marker
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poller: threading.Thread | None = None

    def _fan_out(self, fn) -> list:
        """Run fn(endpoint) on every member concurrently; returns the
        per-member results with exceptions captured in place."""
        futs = [self._pool.submit(fn, ep) for ep in self.endpoints]
        out = []
        for f in futs:
            try:
                out.append(f.result())
            except Exception as e:
                out.append(e)
        return out

    # -- reads ---------------------------------------------------------------

    def _fetch_merged(self, key: str, raise_unreachable: bool = False) -> Any:
        got = self._fan_out(lambda ep: ep.fetch(key)[1])
        views = [v for v in got if not isinstance(v, Exception)]
        if raise_unreachable and not views and got:
            # every member errored (distinct from "key absent everywhere")
            raise RuntimeError(f"no KV member reachable for {key!r}: {got[0]!r}")
        return _merge_values(views)

    def get(self, key: str) -> Any:
        return self._fetch_merged(key)

    # -- writes --------------------------------------------------------------

    def cas(self, key: str, update: Callable[[Any], Any],
            retries: int = 10) -> Any:
        """Apply `update` on every reachable member via its own CAS loop;
        succeed when any member accepted (AP, see class docstring). Each
        member converges from ITS current value, so a member that missed
        earlier writes still ends up consistent for merge-friendly state
        (ring maps); last-write-wins for everything else. NOTE: `update`
        runs once per member, concurrently — it must be a pure function
        of its argument."""
        if faults.ARMED:
            faults.fire("ring.kv.cas")

        def member_cas(ep):
            for _ in range(retries):
                ver, cur = ep.fetch(key)
                new = update(cur)
                if new is None:
                    return ("noop", cur)
                accepted, _v = ep.cas_versioned(key, ver, new)
                if accepted:
                    return ("ok", new)
            raise RuntimeError(f"CAS contention on {ep!r}")

        got = self._fan_out(member_cas)
        result: Any = None
        ok = 0
        errs = [g for g in got if isinstance(g, Exception)]
        for g in got:
            if isinstance(g, Exception):
                continue
            ok += 1
            status, val = g
            if status == "ok" or result is None:
                result = val
        if ok == 0:
            raise RuntimeError(
                f"KV write failed on {key!r}: 0/{len(self.endpoints)} "
                f"members accepted (first error: {errs[0] if errs else 'n/a'})")
        self._notify(key, result)
        return result

    def cas_primary(self, key: str, update: Callable[[Any], Any],
                    retries: int = 10) -> Any:
        """CAS against the FIRST reachable member only (deterministic
        endpoint order). Election-style state (leases, cluster seeds)
        must not run the update once per member — per-member CAS can
        hand two contenders different winners. Merged reads prefer the
        first reachable member's view, so this is consistent while that
        member is up; a partition can still elect twice (at-least-once
        semantics, like gossip-backed election in the reference)."""
        errs: list[Exception] = []
        for ep in self.endpoints:
            contended = False
            try:
                for _ in range(retries):
                    ver, cur = ep.fetch(key)
                    new = update(cur)
                    if new is None:
                        return cur
                    ok, _v = ep.cas_versioned(key, ver, new)
                    if ok:
                        self._notify(key, new)
                        return new
                contended = True       # reachable but raced out: surface,
            except Exception as e:     # don't fail over to another member
                errs.append(e)
                continue
            if contended:
                raise RuntimeError(f"CAS contention on {key!r} via {ep!r}")
        raise RuntimeError(
            f"KV cas_primary failed on {key!r}: no member reachable "
            f"(first error: {errs[0] if errs else 'n/a'})")

    def delete(self, key: str) -> None:
        self._fan_out(lambda ep: ep.delete(key))

    # -- watches (polling + merge) -------------------------------------------

    def watch_key(self, key: str, cb: Callable[[Any], None]) -> None:
        with self._lock:
            self._watches.setdefault(key, []).append(cb)
            if self._poller is None:
                self._poller = threading.Thread(target=self._poll_loop,
                                                daemon=True)
                self._poller.start()

    def _marker(self, value: Any) -> str:
        try:
            return json.dumps(_value_to_json(value), sort_keys=True,
                              default=str)
        except Exception:
            return repr(value)

    def _notify(self, key: str, value: Any) -> None:
        if value is None:
            return
        mark = self._marker(value)
        with self._lock:
            if self._last.get(key) == mark:
                return
            self._last[key] = mark
            watchers = list(self._watches.get(key, ()))
        for w in watchers:
            try:
                w(value)
            except Exception:
                pass

    def _poll_loop(self) -> None:
        # same error backoff as RemoteKVStore: a pass where NO member was
        # reachable doubles the wait (capped); any reachable member
        # resets it — a minority of dead members never slows the watch
        fail_streak = 0
        while not self._stop.wait(_poll_backoff(self.poll_interval_s,
                                                fail_streak)):
            with self._lock:
                keys = list(self._watches)
            ok = not keys
            for k in keys:
                try:
                    val = self._fetch_merged(k, raise_unreachable=True)
                except Exception:
                    continue
                ok = True
                if val is not None:
                    self._notify(k, val)
            fail_streak = 0 if ok else fail_streak + 1

    def shutdown(self, timeout_s: float = 2.0) -> None:
        """Stop, join the poller (bounded), release the member pool."""
        self._stop.set()
        t = self._poller
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout_s)
        self._poller = None
        self._pool.shutdown(wait=False)


def make_kv(spec: str) -> tuple[Any, KVStore | None]:
    """Build the KV client for a `ring_kv_url` spec.

    Returns (kv, hosted_store): "local" → one in-process store (this
    process hosts the shared KV on its /kv routes); a single URL → remote
    client of that host; a comma list mixing "local" and peer URLs →
    replicated KV (each listed member hosts its own store)."""
    parts = [p.strip() for p in (spec or "").split(",") if p.strip()]
    if not parts:
        kv = KVStore()
        return kv, None
    if len(parts) == 1:
        if parts[0] == "local":
            kv = KVStore()
            return kv, kv
        return RemoteKVStore(parts[0]), None
    host: KVStore | None = None
    eps: list = []
    for p in parts:
        if p == "local":
            if host is None:
                host = KVStore()
            eps.append(_LocalEndpoint(host))
        else:
            eps.append(_HttpEndpoint(p))
    return ReplicatedKVStore(eps), host
