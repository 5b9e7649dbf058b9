"""servicegraphs processor: client/server span pairing → edge metrics.

Counterpart of `tempo_tpu/generator/processors/servicegraphs.py`, with
the reference semantics (`modules/generator/processor/servicegraphs/`):

- `consume` (`servicegraphs.go:172-255`): CLIENT/PRODUCER spans register an
  edge keyed by (trace id, span id); SERVER/CONSUMER spans match on
  (trace id, parent span id). A completed edge emits:
  `traces_service_graph_request_total`, `_failed_total` (either side errored),
  `_client_seconds` / `_server_seconds` histograms (+ messaging-system delay
  for PRODUCER/CONSUMER pairs), labeled (client, server) service names.
- expiring edge store (`store/store.go:29,78,119`): TTL ring; expired
  half-edges infer virtual nodes (`servicegraphs.go:390-421`): an unmatched
  SERVER span with a remote parent gets client="user"; an unmatched CLIENT
  span pointing at a known peer (db/messaging attrs, `servicegraphs.go:
  287-343` heuristics) gets a server node named from peer attributes.

Split: edge *matching* is pointer-chasing and stays on the host (a dict
keyed by 24-byte trace+span ids, vectorized staging in/out, the TTL
ring); the metric updates of matched edges are one padded batch of
device writes per push through the families' `add_slots` /
`observe_slots`: on dense state one `index_add_` per plane, on paged
state the same through the page tables, with no boolean selection and
no host sync (`registry/metrics.py`, `ops/pages.py`).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from tempo_tpu_torch.device import bucket_rows
from tempo_tpu_torch.model.interner import INVALID_ID
from tempo_tpu_torch.model.span_batch import (
    KIND_CLIENT,
    KIND_CONSUMER,
    KIND_PRODUCER,
    KIND_SERVER,
    STATUS_ERROR,
    SpanBatch,
    void_keys,
)
from tempo_tpu_torch.registry.registry import (DEFAULT_HISTOGRAM_EDGES,
                                               ManagedRegistry)
from tempo_tpu_torch.utils import tracing

_PEER_ATTRS = ("peer.service", "db.name", "db.system", "messaging.system",
               "net.peer.name")  # `servicegraphs.go:287-343` heuristics


@dataclasses.dataclass
class ServiceGraphsConfig:
    histogram_buckets: tuple[float, ...] = DEFAULT_HISTOGRAM_EDGES
    wait_s: float = 10.0                 # edge TTL before expiry
    max_items: int = 10000               # store capacity
    enable_client_server_prefix: bool = False
    enable_messaging_system_latency_histogram: bool = False
    enable_virtual_node_label: bool = False


@dataclasses.dataclass
class _HalfEdge:
    service_id: int
    duration_s: float
    failed: bool
    is_client: bool
    is_messaging: bool
    peer_id: int          # interned peer-attr value (client side), or INVALID_ID
    start_ns: int
    expire_at: float


class ServiceGraphsProcessor:
    def __init__(self, registry: ManagedRegistry, config: ServiceGraphsConfig | None = None):
        self.cfg = config or ServiceGraphsConfig()
        self.registry = registry
        labels = ("client", "server", "connection_type")
        edges = self.cfg.histogram_buckets
        self.total = registry.new_counter("traces_service_graph_request_total", labels)
        self.failed = registry.new_counter("traces_service_graph_request_failed_total", labels)
        self.client_hist = registry.new_histogram(
            "traces_service_graph_request_client_seconds", labels, edges=edges)
        self.server_hist = registry.new_histogram(
            "traces_service_graph_request_server_seconds", labels, edges=edges)
        for fam in (self.failed, self.client_hist, self.server_hist):
            fam.share_table(self.total)  # edge families stay slot-aligned
        if self.cfg.enable_messaging_system_latency_histogram:
            self.messaging_hist = registry.new_histogram(
                "traces_service_graph_request_messaging_system_seconds", labels, edges=edges)
            self.messaging_hist.share_table(self.total)
        else:
            self.messaging_hist = None
        self._store: dict[bytes, _HalfEdge] = {}
        self._ttl: collections.deque[tuple[float, bytes]] = collections.deque()
        self.dropped = 0  # store-full drops (`store.go` max_items)
        self.expired = 0

    def name(self) -> str:
        return "service-graphs"

    # -- ingestion ---------------------------------------------------------

    def push_batch(self, sb: SpanBatch) -> None:
        if sb.interner is not self.registry.interner:
            raise ValueError(
                "SpanBatch must be built with the tenant registry's interner")
        with tracing.span("processor.service-graphs", spans=sb.n):
            now = self.registry.now()
            completed = self._match(sb, now)
            if completed:
                self._emit(completed)
            self._expire(now)

    def _match(self, sb: SpanBatch, now: float) -> list[tuple]:
        """Pairs the batch's client and server spans through the edge
        store; returns the completed edges."""
        kinds = sb.kind
        client_like = (kinds == KIND_CLIENT) | (kinds == KIND_PRODUCER)
        server_like = (kinds == KIND_SERVER) | (kinds == KIND_CONSUMER)
        interesting = np.flatnonzero(sb.valid & (client_like | server_like))
        if interesting.size == 0:
            return []
        with tracing.span("servicegraphs.match",
                          spans=int(interesting.size)) as sp:
            # the matching walks Python lists of the interesting rows,
            # read out of the columns once per batch (per-span numpy
            # scalar reads cost more than the dict work); `keys[i]` is the
            # exact 24-byte trace+span id concatenation the reference
            # keys on
            rows = interesting
            is_cli = client_like[rows].tolist()
            is_msg = ((kinds[rows] == KIND_PRODUCER)
                      | (kinds[rows] == KIND_CONSUMER)).tolist()
            keys = np.where(client_like[rows],
                            void_keys(sb.trace_id, sb.span_id)[rows],
                            void_keys(sb.trace_id, sb.parent_span_id)[rows]
                            ).tolist()
            svc = sb.service_id[rows].tolist()
            dur = (sb.duration_ns[rows] / 1e9).tolist()
            fail = (sb.status_code[rows] == STATUS_ERROR).tolist()
            peer = self._peer_col(sb)[rows].tolist()
            start = sb.start_unix_nano[rows].tolist()
            expire_at = now + self.cfg.wait_s
            store, ttl = self._store, self._ttl
            completed: list[tuple[int, int, str, float, float, bool]] = []
            for j, key in enumerate(keys):
                is_client = is_cli[j]
                other = store.pop(key, None)
                if other is not None and other.is_client != is_client:
                    if is_client:
                        cli = _HalfEdge(svc[j], dur[j], fail[j], True,
                                        is_msg[j], peer[j], start[j], 0)
                        srv = other
                    else:
                        cli = other
                        srv = _HalfEdge(svc[j], dur[j], fail[j], False,
                                        is_msg[j], INVALID_ID, start[j], 0)
                    conn = ("messaging_system"
                            if (cli.is_messaging or srv.is_messaging)
                            else "")
                    completed.append((cli.service_id, srv.service_id, conn,
                                      cli.duration_s, srv.duration_s,
                                      cli.failed or srv.failed,
                                      max(0.0, (srv.start_ns - cli.start_ns)
                                          / 1e9)))
                else:
                    if other is not None:
                        store[key] = other  # same side dup; put back
                    if len(store) >= self.cfg.max_items:
                        self.dropped += 1
                        continue
                    store[key] = _HalfEdge(svc[j], dur[j], fail[j],
                                           is_client, is_msg[j], peer[j],
                                           start[j], expire_at)
                    ttl.append((expire_at, key))
            if sp is not None:
                sp.attrs["edges"] = len(completed)
        return completed

    def _peer_col(self, sb: SpanBatch) -> np.ndarray:
        col = np.full(sb.capacity, INVALID_ID, np.int32)
        for key in _PEER_ATTRS:
            nxt = sb.attr_sval_column(key)
            col = np.where(col != INVALID_ID, col, nxt)
        return col

    # -- emission ----------------------------------------------------------

    def _emit(self, edges: list[tuple]) -> None:
        with tracing.span("servicegraphs.emit", edges=len(edges)):
            it = self.registry.interner
            conn_ids = {c: it.intern(c) for c in ("", "messaging_system", "virtual_node")}
            n = len(edges)
            # pad the edge batch to a pow-2 shape bucket, as the reference
            # does (padding rows ride slot -1 → dropped)
            cap = bucket_rows(max(n, 1), lo=16)
            rows = np.zeros((n, 3), np.int32)
            # the whole batch in one host matrix and one copy to the device:
            # slots and the messaging slots as int32 bits, failed, client and
            # server seconds, messaging delay
            mat = np.zeros((6, cap), np.float32)
            bits = mat.view(np.int32)
            cdur, sdur, fail, mdur = mat[2], mat[3], mat[1], mat[4]
            for j, (cid, sid, conn, cd, sd, failed, msg_delay) in enumerate(edges):
                rows[j] = (cid, sid, conn_ids[conn])
                cdur[j], sdur[j], fail[j] = cd, sd, 1.0 if failed else 0.0
                mdur[j] = msg_delay
            bits[0] = -1
            bits[0, :n] = self.total.resolve_slots(rows)
            msg = np.zeros(cap, bool)
            msg[:n] = [e[2] == "messaging_system" for e in edges]
            bits[5] = np.where(msg, bits[0], -1)
            dev = torch.from_numpy(mat).to(self.registry.device)
            slots, mslots = dev[0].view(torch.int32), dev[5].view(torch.int32)
            # family-level slot updates: the families own the device half,
            # dense or paged
            self.total.add_slots(slots)
            self.failed.add_slots(slots, dev[1])
            self.client_hist.observe_slots(slots, dev[2])
            self.server_hist.observe_slots(slots, dev[3])
            if self.messaging_hist is not None:
                self.messaging_hist.observe_slots(mslots, dev[4])

    def _expire(self, now: float) -> None:
        """Expired half-edges become virtual-node edges (`servicegraphs.go:390-421`)."""
        with tracing.span("servicegraphs.expire") as sp:
            it = self.registry.interner
            expired_edges = []
            while self._ttl and self._ttl[0][0] <= now:
                _, key = self._ttl.popleft()
                he = self._store.get(key)
                if he is None:   # already matched
                    continue
                if he.expire_at > now:
                    # key was reused by a newer half-edge; re-queue, don't evict
                    self._ttl.append((he.expire_at, key))
                    continue
                del self._store[key]
                self.expired += 1
                if he.is_client:
                    # client → peer-derived virtual server node (db, queue, ...)
                    peer = it.lookup(he.peer_id) if he.peer_id != INVALID_ID else None
                    if peer:
                        expired_edges.append((he.service_id, it.intern(peer),
                                              "virtual_node", he.duration_s, 0.0,
                                              he.failed, 0.0))
                else:
                    # unmatched server with remote parent → synthetic "user" client
                    expired_edges.append((it.intern("user"), he.service_id,
                                          "virtual_node", 0.0, he.duration_s,
                                          he.failed, 0.0))
            if expired_edges:
                self._emit(expired_edges)
            if sp is not None:
                sp.attrs["edges"] = len(expired_edges)
