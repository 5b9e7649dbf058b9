"""SDK-free memcached client + write-behind queue: the SHARED cache tier.

The in-process role LRUs (`backend/cache.py`) keep one replica warm; the
reference additionally parks bloom/footer/page/frontend-search entries in
memcached or redis so N queriers/frontends share one working set
(`pkg/cache/memcached_client.go`, `redis_client.go`). This module speaks
the memcached TEXT protocol directly (get/set/touch semantics — the same
subset the reference's client uses through gomemcache), with:

- a server LIST and FNV-keyed server selection
  (`memcached_client.go:74` ServerList semantics: a key lives on exactly
  one server, so replicas agree without coordination),
- key sanitization: memcached keys are ≤250 printable bytes; longer or
  unsafe keys are replaced by their sha1 (the reference hashes through
  its `cache.HashKey`),
- a WRITE-BEHIND queue (`pkg/cache/background.go`): puts enqueue and
  return; worker threads drain to the network, and a full queue DROPS the
  write (counted) instead of stalling the read path.

`MemcachedCache` matches the LRUCache get/put surface, so a CacheProvider
can map any role to the shared tier (`app/config.py
storage.memcached_addrs`); misses simply fall through to the backend.

Counterpart of `tempo_tpu/backend/memcached.py` (host code, standard
library only), without two of its faults: `close()` drops what is still
queued and joins every worker, so a full queue cannot leave a worker
behind, and a socket is closed and forgotten when its thread exits
rather than when the next connection happens to prune it.
"""

from __future__ import annotations

import hashlib
import queue
import socket
import threading
import weakref

_FNV_OFF = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _fnv64(b: bytes) -> int:
    h = _FNV_OFF
    for c in b:
        h = ((h ^ c) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def sanitize_key(key: str) -> bytes:
    """Memcached-legal key: ≤250 bytes, no spaces/control chars."""
    b = key.encode()
    if len(b) <= 250 and all(33 <= c <= 126 for c in b):
        return b
    return hashlib.sha1(b).hexdigest().encode()


class _Holder:
    """A thread's token for its socket (see `_ServerConn._connect`)."""


class _ServerConn:
    """Connections to one memcached server, ONE PER CALLING THREAD (via
    threading.local): a 30-worker read pool must not head-of-line block
    on a single mutex-serialized socket — the reference client pools
    connections for the same reason."""

    def __init__(self, addr: str, timeout_s: float) -> None:
        host, _, port = addr.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self.timeout_s = timeout_s
        self._tls = threading.local()
        # every open socket, for close(). A socket leaves the set when
        # its thread exits: the thread-local holder dies with the thread
        # and its finalizer closes the socket, so a process that
        # recreates its read pools keeps no socket of an exited thread
        self._all: set[socket.socket] = set()
        self._all_lock = threading.Lock()

    def _connect(self) -> socket.socket:
        t = self._tls
        if getattr(t, "sock", None) is None:
            s = socket.create_connection(self.addr, timeout=self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t.sock = s
            t.buf = b""
            t.holder = _Holder()
            weakref.finalize(t.holder, self._forget, s)
            with self._all_lock:
                self._all.add(s)
        return t.sock

    def _forget(self, s: socket.socket) -> None:
        with self._all_lock:
            self._all.discard(s)
        try:
            s.close()
        except OSError:
            pass

    def _reset(self) -> None:
        t = self._tls
        if getattr(t, "sock", None) is not None:
            t.sock = None
            t.holder = None          # its finalizer closes the socket
        t.buf = b""

    def _read_line(self, s: socket.socket) -> bytes:
        t = self._tls
        while b"\r\n" not in t.buf:
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed")
            t.buf += chunk
        line, t.buf = t.buf.split(b"\r\n", 1)
        return line

    def _read_n(self, s: socket.socket, n: int) -> bytes:
        t = self._tls
        while len(t.buf) < n:
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed")
            t.buf += chunk
        out, t.buf = t.buf[:n], t.buf[n:]
        return out

    def get(self, key: bytes) -> bytes | None:
        try:
            s = self._connect()
            s.sendall(b"get " + key + b"\r\n")
            line = self._read_line(s)
            if line == b"END":
                return None
            if not line.startswith(b"VALUE "):
                raise ConnectionError(f"bad get response {line[:80]!r}")
            n = int(line.rsplit(b" ", 1)[1])
            val = self._read_n(s, n)
            self._read_n(s, 2)              # trailing \r\n
            if self._read_line(s) != b"END":
                raise ConnectionError("missing END")
            return val
        except (OSError, ValueError, ConnectionError):
            self._reset()
            return None

    def set(self, key: bytes, value: bytes, exp_s: int) -> bool:
        try:
            s = self._connect()
            s.sendall(b"set " + key + b" 0 " +
                      str(exp_s).encode() + b" " +
                      str(len(value)).encode() + b"\r\n" +
                      value + b"\r\n")
            return self._read_line(s) == b"STORED"
        except (OSError, ConnectionError):
            self._reset()
            return False

    def close(self) -> None:
        with self._all_lock:
            socks, self._all = list(self._all), set()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


class MemcachedCache:
    """LRUCache-shaped client over a memcached server list with a
    write-behind queue. Network failures degrade to misses — the cache
    tier must never take the read path down."""

    _conn_cls = _ServerConn          # RedisCache swaps the protocol

    def __init__(self, servers: "list[str] | str",
                 timeout_s: float = 0.5, expiration_s: int = 0,
                 write_back_buffer: int = 1024,
                 write_back_workers: int = 1) -> None:
        if isinstance(servers, str):
            servers = [s for s in servers.split(",") if s]
        self._conns = [self._conn_cls(a, timeout_s) for a in servers]
        self.expiration_s = expiration_s
        self.hits = 0
        self.misses = 0
        self.dropped_writes = 0          # background.go droppedWriteBack
        self.stored = 0
        self._q: "queue.Queue[tuple[bytes, bytes] | None]" = queue.Queue(
            maxsize=write_back_buffer)
        self._closing = threading.Event()
        self._workers = []
        for _ in range(max(write_back_workers, 1)):
            t = threading.Thread(target=self._drain, daemon=True)
            t.start()
            self._workers.append(t)

    def _conn_for(self, key: bytes) -> _ServerConn:
        if len(self._conns) == 1:
            return self._conns[0]
        return self._conns[_fnv64(key) % len(self._conns)]

    def get(self, key: str) -> bytes | None:
        k = sanitize_key(key)
        v = self._conn_for(k).get(k)
        if v is None:
            self.misses += 1
        else:
            self.hits += 1
        return v

    def put(self, key: str, value: bytes) -> None:
        """Write-behind: enqueue and return; a full queue drops (counted)
        rather than blocking the caller (`background.go:45-60`)."""
        try:
            self._q.put_nowait((sanitize_key(key), bytes(value)))
        except queue.Full:
            self.dropped_writes += 1

    def _drain(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                # the stop flag (not only the sentinel) ends the loop: a
                # FULL queue at close() cannot hand every worker a
                # sentinel, and a worker left blocked on q.get() would
                # leak with its socket closed underneath it
                if self._closing.is_set():
                    return
                continue
            try:
                if item is None:
                    return
                k, v = item
                if self._conn_for(k).set(k, v, self.expiration_s):
                    self.stored += 1
            finally:
                self._q.task_done()

    def flush(self, timeout_s: float = 5.0) -> None:
        """Test/shutdown helper: wait until every enqueued write has
        COMPLETED (task_done-tracked — q.empty() turns true while the
        last write is still on the socket)."""
        import time

        deadline = time.time() + timeout_s
        while self._q.unfinished_tasks and time.time() < deadline:
            time.sleep(0.01)

    def close(self) -> None:
        """Stop every worker before closing their sockets. The writes
        still queued are dropped (counted, as a full queue's are), so a
        full queue cannot keep a worker busy or a sentinel out; the stop
        flag ends a worker whose sentinel still did not fit. Each worker
        is then joined: it finishes at most the write it holds, which
        the socket timeout bounds, so no worker outlives `close()` or
        owns a socket when the connections close."""
        self._closing.set()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self.dropped_writes += 1
            self._q.task_done()
        for _ in self._workers:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                continue
        for t in self._workers:
            t.join()
        self._workers = []
        for c in self._conns:
            c.close()


# -- redis (RESP2) variant ----------------------------------------------------
#
# The reference ships both shared-cache clients (`pkg/cache/redis_client.go`
# via go-redis); this is the RESP2 subset the cache roles need — GET/SET
# (with EX expiry) — over the same per-thread connections and write-behind
# queue as the memcached client. Cluster-mode redis is out of scope (the
# reference's client also defaults to single-endpoint/ring).


class _RedisConn(_ServerConn):
    """RESP2 framing over the per-thread connection machinery."""

    def _cmd(self, s: socket.socket, *parts: bytes) -> None:
        out = b"*" + str(len(parts)).encode() + b"\r\n"
        for p in parts:
            out += b"$" + str(len(p)).encode() + b"\r\n" + p + b"\r\n"
        s.sendall(out)

    def _reply(self, s: socket.socket):
        line = self._read_line(s)
        t, body = line[:1], line[1:]
        if t == b"+":
            return body
        if t == b"-":
            raise ConnectionError(f"redis error: {body[:120]!r}")
        if t == b":":
            return int(body)
        if t == b"$":
            n = int(body)
            if n < 0:
                return None
            v = self._read_n(s, n)
            self._read_n(s, 2)
            return v
        raise ConnectionError(f"unexpected RESP type {t!r}")

    def get(self, key: bytes) -> bytes | None:
        try:
            s = self._connect()
            self._cmd(s, b"GET", key)
            v = self._reply(s)
            return v if isinstance(v, bytes) else None
        except (OSError, ValueError, ConnectionError):
            self._reset()
            return None

    def set(self, key: bytes, value: bytes, exp_s: int) -> bool:
        try:
            s = self._connect()
            if exp_s > 0:
                self._cmd(s, b"SET", key, value, b"EX", str(exp_s).encode())
            else:
                self._cmd(s, b"SET", key, value)
            return self._reply(s) == b"OK"
        except (OSError, ValueError, ConnectionError):
            self._reset()
            return False


class RedisCache(MemcachedCache):
    """LRUCache-shaped client over a redis server list; shares the
    write-behind queue, key hashing, and degradation semantics with
    `MemcachedCache` (keys need no sanitization — redis keys are binary
    safe — but the shared sha1 form keeps the two tiers swappable)."""

    _conn_cls = _RedisConn
