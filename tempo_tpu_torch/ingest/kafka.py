"""Kafka wire-protocol client: the external half of pkg/ingest.

Counterpart of `tempo_tpu/ingest/kafka.py`, host code copied with its imports
moved to the port. The CRC32C runs in the port's C++ layer only: a missing
native layer raises, as everywhere in the port.

The reference's ingest-storage path speaks to real Kafka through franz-go
(`pkg/ingest/writer_client.go:168-325`, `reader_client.go`); the
in-memory `Bus` covered only the testkafka half. This is an SDK-free
client of the Kafka binary protocol — the subset the bus seam needs:

- Metadata v1 (broker list + per-partition leaders)
- Produce v3 with v2 RecordBatches (varint records, CRC32C integrity)
- Fetch v4 (record batches decoded back into `Record`s)
- FindCoordinator v1 (consumer-group coordinator discovery)
- OffsetCommit v2 / OffsetFetch v1 (consumer-group offsets)
- ListOffsets v1 (high watermark)

Requests route to the PARTITION LEADER (produce/fetch) or the GROUP
COORDINATOR (offsets) from a cached metadata map, refreshed once on
NOT_LEADER/NOT_COORDINATOR class errors before the retry — the franz-go
behavior (`writer_client.go:168-325`) a multi-broker cluster requires;
against a single broker the bootstrap connection answers everything.

`KafkaBus` exposes the same surface as `ingest.bus.Bus`, so the
blockbuilder and the generator's consume loop run unchanged against a
real broker (or the signature-verifying mock in tests — the minio-style
pattern used for S3/Azure). Tenant rides the record KEY, as the
reference encodes it.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from tempo_tpu_torch.ingest.bus import Record

# -- crc32c (Castagnoli) ------------------------------------------------------

def crc32c(data: bytes) -> int:
    from tempo_tpu_torch import native

    return native.crc32c(data)


# -- primitive encoders -----------------------------------------------------

def _i8(v: int) -> bytes:
    return struct.pack(">b", v)


def _i16(v: int) -> bytes:
    return struct.pack(">h", v)


def _i32(v: int) -> bytes:
    return struct.pack(">i", v)


def _i64(v: int) -> bytes:
    return struct.pack(">q", v)


def _string(s: "str | None") -> bytes:
    if s is None:
        return _i16(-1)
    b = s.encode()
    return _i16(len(b)) + b


def _bytes(b: "bytes | None") -> bytes:
    if b is None:
        return _i32(-1)
    return _i32(len(b)) + b


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        x = v & 0x7F
        v >>= 7
        if v:
            out.append(x | 0x80)
        else:
            out.append(x)
            return bytes(out)


def _varint(v: int) -> bytes:
    return _uvarint((v << 1) ^ (v >> 63))       # zigzag


class _R:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def i8(self):
        v = struct.unpack_from(">b", self.b, self.i)[0]; self.i += 1; return v

    def i16(self):
        v = struct.unpack_from(">h", self.b, self.i)[0]; self.i += 2; return v

    def i32(self):
        v = struct.unpack_from(">i", self.b, self.i)[0]; self.i += 4; return v

    def i64(self):
        v = struct.unpack_from(">q", self.b, self.i)[0]; self.i += 8; return v

    def u32(self):
        v = struct.unpack_from(">I", self.b, self.i)[0]; self.i += 4; return v

    def string(self) -> "str | None":
        n = self.i16()
        if n < 0:
            return None
        v = self.b[self.i:self.i + n]; self.i += n
        return v.decode()

    def bytes_(self) -> "bytes | None":
        n = self.i32()
        if n < 0:
            return None
        v = self.b[self.i:self.i + n]; self.i += n
        return v

    def uvarint(self) -> int:
        out = shift = 0
        while True:
            b = self.b[self.i]; self.i += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def varint(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)              # un-zigzag


# -- record batches (message format v2) -------------------------------------

def encode_record_batch(base_offset: int, records: "list[tuple[bytes, bytes]]",
                        first_ts_ms: int = 0) -> bytes:
    """One v2 RecordBatch of (key, value) records."""
    recs = bytearray()
    for i, (key, value) in enumerate(records):
        body = (_i8(0) + _varint(0) + _varint(i) +
                _varint(len(key)) + key +
                _varint(len(value)) + value + _uvarint(0))
        recs += _varint(len(body)) + body
    n = len(records)
    after_crc = (_i16(0) +                       # attributes
                 _i32(n - 1) +                   # lastOffsetDelta
                 _i64(first_ts_ms) + _i64(first_ts_ms) +
                 _i64(-1) + _i16(-1) + _i32(-1) +  # producer id/epoch/seq
                 _i32(n) + bytes(recs))
    crc = crc32c(after_crc)
    body = (_i32(0) +                            # partitionLeaderEpoch
            _i8(2) +                             # magic
            struct.pack(">I", crc) + after_crc)
    return _i64(base_offset) + _i32(len(body)) + body


def decode_record_batches(buf: bytes, *, verify_crc: bool = True
                          ) -> "list[tuple[int, bytes, bytes]]":
    """[(offset, key, value)] from concatenated v2 RecordBatches."""
    out = []
    r = _R(buf)
    while r.i + 61 <= len(buf):
        base = r.i64()
        blen = r.i32()
        if r.i + blen > len(buf):
            break                               # truncated trailing batch
        end = r.i + blen
        r.i32()                                 # partitionLeaderEpoch
        magic = r.i8()
        if magic != 2:
            raise ValueError(f"unsupported magic {magic}")
        crc = r.u32()
        if verify_crc and crc32c(buf[r.i:end]) != crc:
            raise ValueError("record batch crc32c mismatch")
        r.i16()                                 # attributes
        r.i32()                                 # lastOffsetDelta
        r.i64(); r.i64()                        # timestamps
        r.i64(); r.i16(); r.i32()               # producer id/epoch/seq
        n = r.i32()
        for _ in range(n):
            r.varint()                          # record length
            r.i8()                              # attributes
            r.varint()                          # timestampDelta
            od = r.varint()
            klen = r.varint()
            key = buf[r.i:r.i + max(klen, 0)]; r.i += max(klen, 0)
            vlen = r.varint()
            value = buf[r.i:r.i + max(vlen, 0)]; r.i += max(vlen, 0)
            for _h in range(r.uvarint()):       # headers
                hk = r.varint(); r.i += max(hk, 0)
                hv = r.varint(); r.i += max(hv, 0)
            out.append((base + od, bytes(key), bytes(value)))
        r.i = end
    return out


# -- connection -------------------------------------------------------------

class _Conn:
    """One broker connection with lazy (re)connect across a bootstrap
    list: a socket fault or stream desync closes the socket and the next
    request redials — one broker restart must not brick the bus for the
    life of the process."""

    def __init__(self, bootstrap: str, client_id: str,
                 timeout_s: float = 10.0):
        self.addrs = []
        for part in bootstrap.split(","):
            host, _, port = part.strip().partition(":")
            if host:
                self.addrs.append((host, int(port or 9092)))
        if not self.addrs:
            raise ValueError(f"no kafka bootstrap address in {bootstrap!r}")
        self.client_id = client_id
        self.timeout = timeout_s
        self.sock: "socket.socket | None" = None
        self._corr = 0
        self._lock = threading.Lock()

    def _connect(self) -> None:
        errs = []
        for host, port in self.addrs:
            try:
                self.sock = socket.create_connection(
                    (host, port), timeout=self.timeout)
                return
            except OSError as e:
                errs.append(e)
        raise ConnectionError(
            f"no kafka broker reachable ({self.addrs}): {errs[-1]}")

    def _reset(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        self.sock = None

    def request(self, api_key: int, api_version: int, body: bytes) -> bytes:
        with self._lock:
            last: Exception | None = None
            for _attempt in (0, 1):      # one transparent redial
                try:
                    return self._request_locked(api_key, api_version, body)
                except (OSError, ConnectionError, RuntimeError) as e:
                    last = e
                    self._reset()        # desynced/dead stream: redial
            raise KafkaError(f"kafka request failed: {last}")

    def _request_locked(self, api_key: int, api_version: int,
                        body: bytes) -> bytes:
        if self.sock is None:
            self._connect()
        self._corr += 1
        corr = self._corr
        msg = (_i16(api_key) + _i16(api_version) + _i32(corr) +
               _string(self.client_id) + body)
        self.sock.sendall(_i32(len(msg)) + msg)
        raw = self._read(4)
        (n,) = struct.unpack(">i", raw)
        resp = self._read(n)
        r = _R(resp)
        got = r.i32()
        if got != corr:
            raise RuntimeError(f"kafka correlation mismatch {got} != {corr}")
        return resp[r.i:]

    def _read(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("kafka broker closed connection")
            out += chunk
        return out

    def close(self) -> None:
        self._reset()


class KafkaError(RuntimeError):
    def __init__(self, msg: str, code: "int | None" = None):
        super().__init__(msg)
        self.code = code


def _check(code: int, what: str) -> None:
    if code != 0:
        raise KafkaError(f"kafka {what} error code {code}", code)


# error classes that mean "your routing map is stale, refresh and retry":
# UNKNOWN_TOPIC_OR_PARTITION(3), LEADER_NOT_AVAILABLE(5),
# NOT_LEADER_FOR_PARTITION(6); COORDINATOR_NOT_AVAILABLE(15),
# NOT_COORDINATOR(16)
_STALE_LEADER = {3, 5, 6}
_STALE_COORD = {15, 16}


class KafkaBus:
    """The `ingest.bus.Bus` surface over a real Kafka cluster."""

    def __init__(self, bootstrap: str, *, topic: str = "tempo-ingest",
                 n_partitions: int = 2, client_id: str = "tempo-tpu",
                 timeout_s: float = 10.0) -> None:
        self.topic = topic
        self.n_partitions = n_partitions
        self._client_id = client_id
        self._timeout = timeout_s
        self._conn = _Conn(bootstrap, client_id, timeout_s)
        self._meta_lock = threading.Lock()
        self._brokers: dict[int, tuple[str, int]] = {}   # node → addr
        self._leaders: dict[int, int] = {}               # partition → node
        self._coord: "tuple[str, int] | None" = None
        self._conns: dict[tuple[str, int], _Conn] = {}

    # -- routing ------------------------------------------------------------

    def _conn_to(self, addr: "tuple[str, int] | None") -> _Conn:
        if addr is None:
            return self._conn
        with self._meta_lock:
            c = self._conns.get(addr)
            if c is None:
                c = self._conns[addr] = _Conn(
                    f"{addr[0]}:{addr[1]}", self._client_id, self._timeout)
        return c

    def refresh_metadata(self) -> None:
        """Metadata v1 → broker addresses + per-partition leaders, asked
        of the bootstrap connection first and then any previously-known
        broker (the bootstrap broker itself may be the dead one). Total
        failure leaves the maps unchanged."""
        for conn in self._candidate_conns():
            try:
                self._refresh_via(conn)
                return
            except Exception:
                continue             # keep old maps; next candidate

    def _candidate_conns(self) -> "list[_Conn]":
        """Bootstrap connection first, then every known broker (deduped
        against the bootstrap address) — shared by metadata refresh and
        coordinator discovery so both heal around any single dead
        broker."""
        with self._meta_lock:
            fallbacks = list(self._brokers.values())
        boot = set(self._conn.addrs)
        return [self._conn] + [self._conn_to(a) for a in fallbacks
                               if a not in boot]

    def _refresh_via(self, conn: _Conn) -> None:
        r = _R(conn.request(3, 1, _i32(1) + _string(self.topic)))
        brokers: dict[int, tuple[str, int]] = {}
        for _b in range(r.i32()):
            nid = r.i32()
            host = r.string() or ""
            port = r.i32()
            r.string()                           # rack
            brokers[nid] = (host, port)
        r.i32()                                  # controller id
        leaders: dict[int, int] = {}
        for _t in range(r.i32()):
            r.i16()                              # topic error
            name = r.string()
            r.i8()                               # is_internal
            for _p in range(r.i32()):
                r.i16()                          # partition error
                pid = r.i32()
                leader = r.i32()
                for _x in range(max(r.i32(), 0)):
                    r.i32()                      # replicas
                for _x in range(max(r.i32(), 0)):
                    r.i32()                      # isr
                if name == self.topic:
                    leaders[pid] = leader
        with self._meta_lock:
            self._brokers = brokers
            self._leaders = leaders

    def _leader_conn(self, partition: int) -> _Conn:
        with self._meta_lock:
            known = partition in self._leaders
        if not known:
            self.refresh_metadata()
        with self._meta_lock:
            addr = self._brokers.get(self._leaders.get(partition, -1))
        return self._conn_to(addr)

    def _coord_conn(self, group: str, force: bool = False) -> _Conn:
        with self._meta_lock:
            addr = self._coord
        if addr is None or force:
            addr = None
            # same candidate order as refresh_metadata: the bootstrap
            # broker may be the dead one (blockbuilder offsets survive)
            for conn in self._candidate_conns():
                try:
                    r = _R(conn.request(10, 1, _string(group) + _i8(0)))
                    r.i32()                      # throttle
                    err = r.i16()
                    r.string()                   # error message
                    r.i32()                      # coordinator node id
                    host = r.string() or ""
                    port = r.i32()
                    if err == 0:
                        addr = (host, port)
                        break
                except Exception:
                    continue
            with self._meta_lock:
                self._coord = addr
        return self._conn_to(addr)

    # -- produce ------------------------------------------------------------

    def produce(self, partition: int, tenant: str, value: bytes) -> int:
        partition %= self.n_partitions
        batch = encode_record_batch(0, [(tenant.encode(), value)])
        body = (_string(None) + _i16(-1) + _i32(30_000) +   # acks=all
                _i32(1) + _string(self.topic) +
                _i32(1) + _i32(partition) + _bytes(batch))
        for attempt in (0, 1):
            try:
                return self._produce_once(self._leader_conn(partition), body)
            except KafkaError as e:
                # code=None = connection-level failure (dead broker): the
                # leader may have MOVED — remap before giving up, else a
                # crashed leader bricks its partitions forever
                if attempt or (e.code is not None
                               and e.code not in _STALE_LEADER):
                    raise
                self.refresh_metadata()          # stale leader: remap once
        raise AssertionError("unreachable")

    def _produce_once(self, conn: _Conn, body: bytes) -> int:
        r = _R(conn.request(0, 3, body))
        base = -1
        for _t in range(r.i32()):
            r.string()
            for _p in range(r.i32()):
                r.i32()                          # partition
                _check(r.i16(), "produce")
                base = r.i64()
                r.i64()                          # log append time
        r.i32()                                  # throttle
        if base < 0:
            raise KafkaError("produce: no partition response")
        return base

    # -- fetch --------------------------------------------------------------

    def _fetch_raw(self, partition: int, offset: int,
                   max_bytes: int = 1 << 20) -> tuple[bytes, int]:
        body = (_i32(-1) + _i32(200) + _i32(1) + _i32(max_bytes) +
                _i8(0) +                         # isolation: read uncommitted
                _i32(1) + _string(self.topic) +
                _i32(1) + _i32(partition) + _i64(offset) + _i32(max_bytes))
        for attempt in (0, 1):
            try:
                return self._fetch_once(self._leader_conn(partition), body)
            except KafkaError as e:
                if attempt or (e.code is not None
                               and e.code not in _STALE_LEADER):
                    raise
                self.refresh_metadata()          # incl. dead-broker remap
        raise AssertionError("unreachable")

    def _fetch_once(self, conn: _Conn, body: bytes) -> tuple[bytes, int]:
        r = _R(conn.request(1, 4, body))
        r.i32()                                  # throttle
        batches = b""
        hw = 0
        for _t in range(r.i32()):
            r.string()
            for _p in range(r.i32()):
                r.i32()                          # partition
                _check(r.i16(), "fetch")
                hw = r.i64()
                r.i64()                          # last stable offset
                for _a in range(max(r.i32(), 0)):   # aborted txns
                    r.i64(); r.i64()
                batches = r.bytes_() or b""
        return batches, hw

    def fetch(self, partition: int, offset: int, max_records: int = 100
              ) -> list[Record]:
        partition %= self.n_partitions
        max_bytes = 1 << 20
        while True:
            batches, hw = self._fetch_raw(partition, offset, max_bytes)
            out = []
            for off, key, value in decode_record_batches(batches):
                if off < offset:
                    continue                     # batch overlaps the ask
                out.append(Record(off, key.decode("utf-8", "replace"),
                                  value))
                if len(out) >= max_records:
                    break
            if out or hw <= offset or not batches:
                return out
            # data exists but one batch exceeds max_bytes (truncated by
            # the broker): grow and retry instead of livelocking the
            # partition at this offset forever
            if max_bytes >= 1 << 26:
                raise KafkaError(
                    f"record batch at {self.topic}/{partition}@{offset} "
                    f"exceeds {max_bytes} bytes")
            max_bytes *= 8

    # -- offsets ------------------------------------------------------------

    def commit(self, group: str, partition: int, offset: int) -> None:
        body = (_string(group) + _i32(-1) + _string("") +
                _i64(-1) +                       # retention
                _i32(1) + _string(self.topic) +
                _i32(1) + _i32(partition % self.n_partitions) +
                _i64(offset) + _string(None))
        for attempt in (0, 1):
            try:
                r = _R(self._coord_conn(group, force=bool(attempt))
                       .request(8, 2, body))
                for _t in range(r.i32()):
                    r.string()
                    for _p in range(r.i32()):
                        r.i32()
                        _check(r.i16(), "offset commit")
                return
            except KafkaError as e:
                if attempt or (e.code is not None
                               and e.code not in _STALE_COORD):
                    raise                        # retry re-finds coordinator
        raise AssertionError("unreachable")

    def committed(self, group: str, partition: int) -> int:
        body = (_string(group) + _i32(1) + _string(self.topic) +
                _i32(1) + _i32(partition % self.n_partitions))
        for attempt in (0, 1):
            try:
                r = _R(self._coord_conn(group, force=bool(attempt))
                       .request(9, 1, body))
                off = 0
                for _t in range(r.i32()):
                    r.string()
                    for _p in range(r.i32()):
                        r.i32()
                        off = r.i64()
                        r.string()               # metadata
                        _check(r.i16(), "offset fetch")
                return max(off, 0)               # -1 = no commit yet
            except KafkaError as e:
                if attempt or (e.code is not None
                               and e.code not in _STALE_COORD):
                    raise                        # retry re-finds coordinator
        raise AssertionError("unreachable")

    def high_watermark(self, partition: int) -> int:
        _b, hw = self._fetch_raw(partition % self.n_partitions, 0,
                                 max_bytes=64)
        return hw

    def lag(self, group: str, partition: int) -> int:
        return self.high_watermark(partition) - self.committed(group, partition)

    def close(self) -> None:
        self._conn.close()
        with self._meta_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()

    # -- consumer-group seam (used by ConsumerGroup; coordinator-routed) ---

    def group_request(self, group: str, api_key: int, api_version: int,
                      body: bytes) -> bytes:
        """One coordinator-routed request with a single re-discovery retry
        (the same healing commit/committed use)."""
        for attempt in (0, 1):
            conn = self._coord_conn(group, force=bool(attempt))
            try:
                return conn.request(api_key, api_version, body)
            except Exception:
                if attempt:
                    raise
        raise AssertionError("unreachable")


# error codes the group state machine reacts to
_E_ILLEGAL_GENERATION = 22
_E_UNKNOWN_MEMBER = 25
_E_REBALANCE_IN_PROGRESS = 27
_E_MEMBER_ID_REQUIRED = 79
_REJOIN_CODES = {_E_ILLEGAL_GENERATION, _E_UNKNOWN_MEMBER,
                 _E_REBALANCE_IN_PROGRESS}


class ConsumerGroup:
    """Kafka consumer-group membership over the SDK-free wire client:
    JoinGroup v5 / SyncGroup v3 / Heartbeat v3 / LeaveGroup v1, with
    range assignment computed client-side by the elected leader — the
    franz-go group management the reference consumes via
    `pkg/ingest/reader_client.go` + partition balancing `balancer.go`,
    rebuilt on the raw protocol.

    Drive it with `ensure_active()` from the consume loop: it (re)joins
    when needed, heartbeats at half the session timeout, and returns the
    CURRENT partition assignment (possibly [] mid-rebalance — the loop
    simply owns nothing that tick; offsets replay on the next owner, so a
    member death moves partitions without message loss). Commits carry
    the generation + member id so zombies are fenced
    (ILLEGAL_GENERATION)."""

    def __init__(self, bus: KafkaBus, group: str, *,
                 session_timeout_ms: int = 30_000,
                 rebalance_timeout_ms: int = 60_000,
                 now=time.time) -> None:
        self.bus = bus
        self.group = group
        self.session_timeout_ms = session_timeout_ms
        self.rebalance_timeout_ms = rebalance_timeout_ms
        self.now = now
        self.member_id = ""
        self.generation = -1
        self.assignment: list[int] = []
        self._joined = False
        self._last_hb = 0.0

    # -- wire bodies -------------------------------------------------------

    def _subscription(self) -> bytes:
        # ConsumerProtocolSubscription v0: topics + user data
        return (_i16(0) + _i32(1) + _string(self.bus.topic) + _bytes(None))

    @staticmethod
    def _parse_subscription(meta: bytes) -> list[str]:
        r = _R(meta)
        r.i16()                                  # version
        return [r.string() or "" for _ in range(max(r.i32(), 0))]

    def _assignment_bytes(self, parts: list[int]) -> bytes:
        return (_i16(0) + _i32(1) + _string(self.bus.topic) +
                _i32(len(parts)) + b"".join(_i32(p) for p in parts) +
                _bytes(None))

    @staticmethod
    def _parse_assignment(body: bytes) -> list[int]:
        if not body:
            return []
        r = _R(body)
        r.i16()                                  # version
        parts: list[int] = []
        for _t in range(max(r.i32(), 0)):
            r.string()                           # topic
            for _p in range(max(r.i32(), 0)):
                parts.append(r.i32())
        return sorted(parts)

    # -- protocol steps ----------------------------------------------------

    def _coord_call(self, api_key: int, api_version: int,
                    body: bytes) -> bytes:
        """Coordinator-routed exchange healing BOTH failure shapes: dead
        connections (group_request re-discovers on transport errors) and
        NOT_COORDINATOR/LOAD_IN_PROGRESS responses after the coordinator
        MOVES to another broker — the join/sync/heartbeat/leave responses
        all carry (throttle i32, error i16) up front, so one peek decides
        the forced re-discovery retry."""
        for attempt in (0, 1):
            raw = self.bus.group_request(self.group, api_key, api_version,
                                         body)
            if attempt == 0 and len(raw) >= 6 and \
                    struct.unpack(">h", raw[4:6])[0] in _STALE_COORD:
                self.bus._coord_conn(self.group, force=True)
                continue
            return raw
        raise AssertionError("unreachable")

    def _join_once(self) -> "tuple[int, str, list[tuple[str, bytes]]] | None":
        """One JoinGroup v5 exchange. Returns (error, leader, members) —
        members only for the leader; None-equivalent via error code."""
        body = (_string(self.group) + _i32(self.session_timeout_ms) +
                _i32(self.rebalance_timeout_ms) + _string(self.member_id) +
                _string(None) +                  # group instance id
                _string("consumer") +
                _i32(1) + _string("range") + _bytes(self._subscription()))
        r = _R(self._coord_call(11, 5, body))
        r.i32()                                  # throttle
        err = r.i16()
        gen = r.i32()
        r.string()                               # protocol
        leader = r.string() or ""
        member_id = r.string() or ""
        members: list[tuple[str, bytes]] = []
        for _m in range(max(r.i32(), 0)):
            mid = r.string() or ""
            r.string()                           # instance id
            members.append((mid, r.bytes_() or b""))
        if member_id:
            self.member_id = member_id
        if err == 0:
            self.generation = gen
        return err, leader, members

    def _sync(self, assignments: "list[tuple[str, bytes]]") -> int:
        body = (_string(self.group) + _i32(self.generation) +
                _string(self.member_id) + _string(None) +
                _i32(len(assignments)) +
                b"".join(_string(m) + _bytes(a) for m, a in assignments))
        r = _R(self._coord_call(14, 3, body))
        r.i32()                                  # throttle
        err = r.i16()
        assignment = r.bytes_() or b""
        if err == 0:
            self.assignment = self._parse_assignment(assignment)
            self._joined = True
            self._last_hb = self.now()
        return err

    def _range_assign(self, members: "list[tuple[str, bytes]]"
                      ) -> "list[tuple[str, bytes]]":
        """Range assignment over the topic's partitions (balancer.go's
        default shape): contiguous runs, first members get the remainder.
        Members whose subscription metadata names other topics only get
        nothing (the group may mix consumers of different topics)."""
        n = self.bus.n_partitions
        ids = sorted(m for m, meta in members
                     if not meta
                     or self.bus.topic in self._parse_subscription(meta))
        out = []
        base, rem = divmod(n, max(len(ids), 1))
        start = 0
        for i, mid in enumerate(ids):
            take = base + (1 if i < rem else 0)
            out.append((mid, self._assignment_bytes(
                list(range(start, start + take)))))
            start += take
        return out

    def _rejoin(self) -> None:
        self._joined = False
        self.assignment = []
        for _attempt in range(3):
            err, leader, members = self._join_once()
            if err == _E_MEMBER_ID_REQUIRED:
                continue                         # retry WITH the new id
            if err != 0:
                return                           # next tick retries
            if leader == self.member_id:
                self._sync(self._range_assign(members))
            else:
                self._sync([])
            return

    def heartbeat(self) -> bool:
        """One Heartbeat v3; False = membership lost/rebalancing (caller's
        next ensure_active rejoins)."""
        body = (_string(self.group) + _i32(self.generation) +
                _string(self.member_id) + _string(None))
        r = _R(self._coord_call(12, 3, body))
        r.i32()
        err = r.i16()
        if err in _REJOIN_CODES:
            self._joined = False
            if err == _E_UNKNOWN_MEMBER:
                self.member_id = ""
            return False
        self._last_hb = self.now()
        return err == 0

    def ensure_active(self) -> list[int]:
        """Join/heartbeat as needed; returns the current assignment."""
        if not self._joined:
            self._rejoin()
        elif (self.now() - self._last_hb) * 1000 >= \
                self.session_timeout_ms / 2:
            if not self.heartbeat():
                self._rejoin()
        return list(self.assignment)

    def leave(self) -> None:
        if not self.member_id:
            return
        body = _string(self.group) + _string(self.member_id)
        try:
            self._coord_call(13, 1, body)
        except Exception:
            pass
        self._joined = False
        self.assignment = []
        self.member_id = ""
        self.generation = -1

    # -- generation-fenced offsets ----------------------------------------

    def commit(self, partition: int, offset: int) -> None:
        """OffsetCommit v2 carrying generation + member id: a commit from
        a fenced zombie (dead member, stale generation) is REJECTED by
        the coordinator instead of clobbering the new owner's offsets."""
        body = (_string(self.group) + _i32(self.generation) +
                _string(self.member_id) + _i64(-1) +
                _i32(1) + _string(self.bus.topic) +
                _i32(1) + _i32(partition % self.bus.n_partitions) +
                _i64(offset) + _string(None))
        for attempt in (0, 1):
            r = _R(self.bus.group_request(self.group, 8, 2, body))
            try:
                for _t in range(r.i32()):
                    r.string()
                    for _p in range(r.i32()):
                        r.i32()
                        _check(r.i16(), "group offset commit")
                return
            except KafkaError as e:
                # coordinator moved: per-partition NOT_COORDINATOR —
                # re-discover and retry once (same healing bus.commit has)
                if attempt or e.code not in _STALE_COORD:
                    raise
                self.bus._coord_conn(self.group, force=True)

    def committed(self, partition: int) -> int:
        return self.bus.committed(self.group, partition)


__all__ = ["KafkaBus", "KafkaError", "ConsumerGroup", "crc32c",
           "encode_record_batch", "decode_record_batches"]
