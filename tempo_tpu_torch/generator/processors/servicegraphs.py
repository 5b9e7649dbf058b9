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

Split: edge *matching* is pointer-chasing and stays on the host, in the
C++ host layer (`native.EdgeStore`: a table keyed by the 24-byte trace +
span ids and the TTL ring, one call a push to pair and store, one to
expire); the metric updates of matched edges are one padded batch of
device writes per push through the families' `add_slots` /
`observe_slots`: on dense state one `index_add_` per plane, on paged
state the same through the page tables, with no boolean selection and
no host sync (`registry/metrics.py`, `ops/pages.py`). Edges travel as
columns from the store to the device copy; no Python loop walks spans
or edges.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple

import numpy as np
import torch

from tempo_tpu_torch import native
from tempo_tpu_torch.device import bucket_rows
from tempo_tpu_torch.model.interner import INVALID_ID
from tempo_tpu_torch.model.span_batch import (
    KIND_CLIENT,
    KIND_CONSUMER,
    KIND_PRODUCER,
    KIND_SERVER,
    SpanBatch,
)
from tempo_tpu_torch.obs.runtime import RUNTIME
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


# the reference's self-metrics (`servicegraphs.go`), by tenant
_EDGES = RUNTIME.counter(
    "tempo_metrics_generator_processor_service_graphs_edges",
    "Edges completed by a client and a server span that met in the store",
    labels=("tenant",))
_EXPIRED = RUNTIME.counter(
    "tempo_metrics_generator_processor_service_graphs_expired_edges",
    "Half-edges that expired before their other side arrived",
    labels=("tenant",))
_DROPPED = RUNTIME.counter(
    "tempo_metrics_generator_processor_service_graphs_dropped_spans",
    "Spans dropped because the edge store held max_items half-edges",
    labels=("tenant",))

# connection_type label values, by the code an edge carries: the store's
# 0 (plain) and 1 (messaging), and the expiry's virtual nodes
_CONNECTIONS = ("", "messaging_system", "virtual_node")
_CONN_MESSAGING, _CONN_VIRTUAL = 1, 2


class _Edges(NamedTuple):
    """Edges as columns: client and server service ids, connection code
    (an index into `_CONNECTIONS`), client and server seconds, failed,
    messaging delay in seconds."""
    client: np.ndarray
    server: np.ndarray
    conn: np.ndarray
    client_s: np.ndarray
    server_s: np.ndarray
    failed: np.ndarray
    delay: np.ndarray


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
        self._store = native.EdgeStore()
        # pushes into one tenant may run at once; the store and the counts
        # beside it change together
        self._lock = threading.Lock()
        self.dropped = 0  # store-full drops (`store.go` max_items)
        self.expired = 0
        self._labels = (registry.tenant,)
        for fam in (_EDGES, _EXPIRED, _DROPPED):
            fam.inc(0.0, self._labels)

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
            if completed is not None and len(completed.client):
                self._emit(completed)
            self._expire(now)

    def _match(self, sb: SpanBatch, now: float) -> "_Edges | None":
        """Pairs the batch's client and server spans through the edge
        store; returns the completed edges."""
        kinds = sb.kind
        n = int(np.count_nonzero(sb.valid & (
            (kinds == KIND_CLIENT) | (kinds == KIND_PRODUCER)
            | (kinds == KIND_SERVER) | (kinds == KIND_CONSUMER))))
        if n == 0:
            return None
        with tracing.span("servicegraphs.match", spans=n) as sp:
            peer = self._peer_col(sb)
            with self._lock:
                cols, dropped = self._store.match(
                    sb.trace_id, sb.span_id, sb.parent_span_id, kinds,
                    sb.valid, sb.service_id, sb.start_unix_nano,
                    sb.end_unix_nano, sb.status_code, peer,
                    now + self.cfg.wait_s, self.cfg.max_items)
                self.dropped += dropped
            edges = _Edges(*cols)
            _EDGES.inc(len(edges.client), self._labels)
            if dropped:
                _DROPPED.inc(dropped, self._labels)
            if sp is not None:
                sp.attrs["edges"] = len(edges.client)
        return edges

    def _peer_col(self, sb: SpanBatch) -> np.ndarray:
        col = np.full(sb.capacity, INVALID_ID, np.int32)
        for key in _PEER_ATTRS:
            nxt = sb.attr_sval_column(key)
            col = np.where(col != INVALID_ID, col, nxt)
        return col

    # -- emission ----------------------------------------------------------

    def _emit(self, edges: _Edges) -> None:
        n = len(edges.client)
        with tracing.span("servicegraphs.emit", edges=n):
            it = self.registry.interner
            conn_ids = np.array([it.intern(c) for c in _CONNECTIONS],
                                np.int32)
            # pad the edge batch to a pow-2 shape bucket, as the reference
            # does (padding rows ride slot -1 → dropped)
            cap = bucket_rows(max(n, 1), lo=16)
            rows = np.stack([edges.client, edges.server,
                             conn_ids[edges.conn]], axis=1)
            # the whole batch in one host matrix and one copy to the device:
            # slots and the messaging slots as int32 bits, failed, client and
            # server seconds, messaging delay
            mat = np.zeros((6, cap), np.float32)
            bits = mat.view(np.int32)
            mat[1, :n] = edges.failed
            mat[2, :n] = edges.client_s
            mat[3, :n] = edges.server_s
            mat[4, :n] = edges.delay
            bits[0] = -1
            bits[0, :n] = self.total.resolve_slots(rows)
            bits[5] = -1
            bits[5, :n] = np.where(edges.conn == _CONN_MESSAGING,
                                   bits[0, :n], -1)
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
            with self._lock:
                is_client, service, peer, dur_s, failed = \
                    self._store.expire(now)
                self.expired += len(service)
            n_edges = 0
            if len(service):
                _EXPIRED.inc(len(service), self._labels)
                edges = self._virtual_edges(is_client, service, peer, dur_s,
                                            failed)
                n_edges = len(edges.client)
                if n_edges:
                    self._emit(edges)
            if sp is not None:
                sp.attrs["edges"] = n_edges

    def _virtual_edges(self, is_client, service, peer, dur_s,
                       failed) -> _Edges:
        """An expired client side → (service, its peer, a virtual server
        node: a db, a queue, ...) where the peer attribute names one; an
        expired server side → ("user", service), its caller outside the
        traces."""
        it = self.registry.interner
        # the peer's interned name as the reference interns it again:
        # `intern(lookup(id))`, one call per distinct peer id. It is the id
        # itself unless the peer's wire bytes are not UTF-8 and decode like
        # an earlier string's, whose id it then is; "" names no node.
        named = is_client & (peer != INVALID_ID)
        ids, inverse = np.unique(peer[named], return_inverse=True)
        again = np.array([it.intern(s) if s else INVALID_ID
                          for s in it.lookup_many(ids)], np.int32)
        server = np.full(len(service), INVALID_ID, np.int32)
        server[named] = again[inverse]
        keep = ~is_client | (server != INVALID_ID)
        user = it.intern("user") if (~is_client).any() else INVALID_ID
        m = int(np.count_nonzero(keep))
        return _Edges(
            client=np.where(is_client, service, user)[keep],
            server=np.where(is_client, server, service)[keep],
            conn=np.full(m, _CONN_VIRTUAL, np.uint8),
            client_s=np.where(is_client, dur_s, 0)[keep],
            server_s=np.where(is_client, 0, dur_s)[keep],
            failed=failed[keep], delay=np.zeros(m, np.float32))
