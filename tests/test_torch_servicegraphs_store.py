"""The service-graph edge store in the C++ host layer against the Python
loop it replaced.

`native.EdgeStore` pairs a batch's client and server spans in one call
and expires half-edges in another; `ServiceGraphsProcessor` builds its
edge batches from the columns they return. The loop that did this before,
a dict keyed by the 24-byte trace + span ids and a deque of expiry times
walked span by span, is kept here as the oracle (`_LoopProcessor`). Both
meet the same seeded batches, case by case:

- at the store: the completed edges' columns bit-identical and in the
  same order, the expired half-edges likewise, and `dropped`, `expired`
  and `len(_store)` equal after every push;
- at the processor: every collected sample bit-identical, and the
  interner's strings in the same order.

Besides: the three `tempo_metrics_generator_processor_service_graphs_*`
counters count what they name, and two threads pushing self-contained
payloads into one processor lose no edge against the same payloads pushed
one after another.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import tempo_tpu_torch as tt
from tempo_tpu_torch.device import bucket_rows
from tempo_tpu_torch.model.interner import INVALID_ID
from tempo_tpu_torch.model.span_batch import (KIND_CLIENT, KIND_CONSUMER,
                                              KIND_PRODUCER, KIND_SERVER,
                                              STATUS_ERROR, void_keys)
from tempo_tpu_torch.utils import tracing

T0 = 1_700_000_000.0
SERVICES = tuple(f"svc-{i}" for i in range(6))
PEERS = ({}, {"db.system": ""}, {"peer.service": "billing"},
         {"db.name": "orders", "db.system": "postgresql"},
         {"messaging.system": "kafka"}, {"net.peer.name": "cache"})


# ---------------------------------------------------------------------------
# the oracle: the processor's former per-span loop, as it was
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HalfEdge:
    service_id: int
    duration_s: float
    failed: bool
    is_client: bool
    is_messaging: bool
    peer_id: int
    start_ns: int
    expire_at: float


class _LoopProcessor(tt.ServiceGraphsProcessor):
    """`ServiceGraphsProcessor` with its former dict store, deque and
    per-span and per-edge loops."""

    def __init__(self, registry, config=None):
        super().__init__(registry, config)
        self._store = {}
        self._ttl = collections.deque()

    def push_batch(self, sb):
        now = self.registry.now()
        completed = self._match(sb, now)
        if completed:
            self._emit(completed)
        self._expire(now)

    def _match(self, sb, now):
        kinds = sb.kind
        client_like = (kinds == KIND_CLIENT) | (kinds == KIND_PRODUCER)
        server_like = (kinds == KIND_SERVER) | (kinds == KIND_CONSUMER)
        interesting = np.flatnonzero(sb.valid & (client_like | server_like))
        if interesting.size == 0:
            return []
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
        completed = []
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
                        if (cli.is_messaging or srv.is_messaging) else "")
                completed.append((cli.service_id, srv.service_id, conn,
                                  cli.duration_s, srv.duration_s,
                                  cli.failed or srv.failed,
                                  max(0.0, (srv.start_ns - cli.start_ns)
                                      / 1e9)))
            else:
                if other is not None:
                    store[key] = other
                if len(store) >= self.cfg.max_items:
                    self.dropped += 1
                    continue
                store[key] = _HalfEdge(svc[j], dur[j], fail[j], is_client,
                                       is_msg[j], peer[j], start[j],
                                       expire_at)
                ttl.append((expire_at, key))
        return completed

    def _emit(self, edges):
        it = self.registry.interner
        conn_ids = {c: it.intern(c)
                    for c in ("", "messaging_system", "virtual_node")}
        n = len(edges)
        cap = bucket_rows(max(n, 1), lo=16)
        rows = np.zeros((n, 3), np.int32)
        mat = np.zeros((6, cap), np.float32)
        bits = mat.view(np.int32)
        cdur, sdur, fail, mdur = mat[2], mat[3], mat[1], mat[4]
        for j, (cid, sid, conn, cd, sd, failed, msg_delay) in \
                enumerate(edges):
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
        self.total.add_slots(slots)
        self.failed.add_slots(slots, dev[1])
        self.client_hist.observe_slots(slots, dev[2])
        self.server_hist.observe_slots(slots, dev[3])
        if self.messaging_hist is not None:
            self.messaging_hist.observe_slots(mslots, dev[4])

    def expire_half_edges(self, now):
        """The former `_expire`'s sweep: the half-edges it evicts, in
        order, as (is_client, service, peer, seconds, failed)."""
        out = []
        while self._ttl and self._ttl[0][0] <= now:
            _, key = self._ttl.popleft()
            he = self._store.get(key)
            if he is None:
                continue
            if he.expire_at > now:
                self._ttl.append((he.expire_at, key))
                continue
            del self._store[key]
            self.expired += 1
            out.append(he)
        return out

    def _expire(self, now):
        it = self.registry.interner
        expired_edges = []
        for he in self.expire_half_edges(now):
            if he.is_client:
                peer = (it.lookup(he.peer_id) if he.peer_id != INVALID_ID
                        else None)
                if peer:
                    expired_edges.append((he.service_id, it.intern(peer),
                                          "virtual_node", he.duration_s, 0.0,
                                          he.failed, 0.0))
            else:
                expired_edges.append((it.intern("user"), he.service_id,
                                      "virtual_node", 0.0, he.duration_s,
                                      he.failed, 0.0))
        if expired_edges:
            self._emit(expired_edges)


# ---------------------------------------------------------------------------
# seeded cases: a list of pushes, each (seconds the clock steps first, spans)
# ---------------------------------------------------------------------------

class _Spans:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def key(self):
        """A fresh (trace id, span id); the trace ids share a prefix, as a
        client stamping its payloads does."""
        return b"\x01" * 8 + bytes(self.rng.integers(0, 256, 8,
                                                     dtype=np.uint8)), \
            bytes(self.rng.integers(0, 256, 8, dtype=np.uint8))

    def span(self, trace, span_id, parent, kind, attrs=None, start_off=None):
        r = self.rng
        start = int(T0 * 1e9) + int(r.integers(0, 10**9)
                                    if start_off is None else start_off)
        return dict(trace_id=trace, span_id=span_id, parent_span_id=parent,
                    name="op", service=SERVICES[int(r.integers(0, 6))],
                    kind=kind, status_code=int(r.choice([0, 1, 2])),
                    start_unix_nano=start,
                    end_unix_nano=start + int(r.integers(1, 3 * 10**9)),
                    attrs=dict(PEERS[int(r.integers(0, len(PEERS)))]
                               if attrs is None else attrs))

    def pair(self, client_kind=KIND_CLIENT, server_kind=KIND_SERVER):
        trace, sid = self.key()
        own = bytes(self.rng.integers(0, 256, 8, dtype=np.uint8))
        return (self.span(trace, sid, b"", client_kind),
                self.span(trace, own, sid, server_kind))


def _case(name, seed):
    """(config overrides, pushes) of one case."""
    g = _Spans(seed)
    rng = g.rng
    if name == "pairs_in_batch":
        spans = [s for _ in range(60) for s in g.pair()]
        rng.shuffle(spans)
        return {}, [(0.0, spans), (11.0, [])]
    if name == "pairs_across_batches":
        pairs = [g.pair() for _ in range(60)]
        first = [c for c, _ in pairs[:30]] + [s for _, s in pairs[30:]]
        second = [s for _, s in pairs[:30]] + [c for c, _ in pairs[30:]]
        return {}, [(0.0, first), (1.0, second), (11.0, [])]
    if name == "same_side_dups":
        pairs = [g.pair() for _ in range(20)]
        dups = [dict(c, end_unix_nano=c["end_unix_nano"] + 7,
                     service=SERVICES[-1]) for c, _ in pairs[:10]]
        sdups = [dict(s, start_unix_nano=s["start_unix_nano"] - 5)
                 for _, s in pairs[10:]]
        return {}, [(0.0, [c for c, _ in pairs[:10]] + dups
                     + [s for _, s in pairs[10:]] + sdups),
                    (1.0, [s for _, s in pairs[:10]]
                     + [c for c, _ in pairs[10:]] + dups[:3]),
                    (11.0, [])]
    if name == "key_reused":
        pairs = [g.pair() for _ in range(12)]
        flat = [s for p in pairs for s in p]
        return {}, [(0.0, flat), (1.0, [c for c, _ in pairs]),
                    (1.0, [s for _, s in pairs[:6]]),
                    (1.0, [s for _, s in pairs]), (11.0, [])]
    if name == "max_items_overflow":
        pairs = [g.pair() for _ in range(30)]
        clients = [c for c, _ in pairs]
        again = [dict(c, service=SERVICES[0]) for c in clients[:4]]
        return {"max_items": 8}, [
            (0.0, clients[:20] + again), (1.0, [s for _, s in pairs[:12]]),
            (1.0, clients[20:] + [s for _, s in pairs[12:]]), (11.0, [])]
    if name == "expiry_requeue":
        pairs = [g.pair() for _ in range(10)]
        clients = [c for c, _ in pairs]
        lone = [s for _, s in (g.pair() for _ in range(5))]
        return {"wait_s": 5.0}, [
            (0.0, clients + lone), (3.0, [dict(c, service=SERVICES[1])
                                          for c in clients[:5]]),
            (3.0, []), (1.0, [s for _, s in pairs[:2]]), (3.0, [])]
    if name == "producer_consumer":
        pairs = [g.pair(KIND_PRODUCER, KIND_CONSUMER) for _ in range(25)]
        pairs += [g.pair(KIND_CLIENT, KIND_CONSUMER) for _ in range(5)]
        pairs += [g.pair(KIND_PRODUCER, KIND_SERVER) for _ in range(5)]
        spans = [s for p in pairs for s in p]
        rng.shuffle(spans)
        return {"enable_messaging_system_latency_histogram": True}, [
            (0.0, spans), (11.0, [])]
    if name == "peer_invalid_and_empty":
        clients = [dict(c, attrs=dict(PEERS[i % len(PEERS)]))
                   for i, (c, _) in enumerate(g.pair() for _ in range(24))]
        servers = [s for _, s in (g.pair() for _ in range(8))]
        return {}, [(0.0, clients + servers), (11.0, [])]
    raise KeyError(name)


CASES = ("pairs_in_batch", "pairs_across_batches", "same_side_dups",
         "key_reused", "max_items_overflow", "expiry_requeue",
         "producer_consumer", "peer_invalid_and_empty")


class Clock:
    def __init__(self):
        self.t = T0

    def __call__(self):
        return self.t


def _processor(cls, clock, tenant="t", **cfg):
    reg = tt.ManagedRegistry(tenant, tt.RegistryOverrides(
        max_active_series=512), now=clock, device="cpu")
    return cls(reg, tt.ServiceGraphsConfig(**cfg))


def _batch(proc, spans):
    b = tt.SpanBatchBuilder(proc.registry.interner)
    for sp in spans:
        b.append(**sp)
    return b.build()


def _bits(cols):
    """Columns as raw bytes, so float columns compare bit for bit."""
    return [np.ascontiguousarray(c).tobytes() for c in cols]


def _loop_edges(completed):
    """The oracle's edge tuples as the store's columns."""
    codes = {"": 0, "messaging_system": 1}
    return (np.array([e[0] for e in completed], np.int32),
            np.array([e[1] for e in completed], np.int32),
            np.array([codes[e[2]] for e in completed], np.uint8),
            np.array([e[3] for e in completed], np.float32),
            np.array([e[4] for e in completed], np.float32),
            np.array([e[5] for e in completed], bool),
            np.array([e[6] for e in completed], np.float32))


@pytest.mark.parametrize("case", CASES)
def test_store_matches_loop(case):
    """Each push's completed edges and expired half-edges, bit for bit and
    in order, and `dropped`, `expired` and `len(_store)` after it."""
    cfg, pushes = _case(case, seed=CASES.index(case))
    clock = Clock()
    new = _processor(tt.ServiceGraphsProcessor, clock, **cfg)
    old = _processor(_LoopProcessor, clock, **cfg)
    n_edges = n_expired = 0
    for step, spans in pushes:
        clock.t += step
        now = clock()
        got = new._match(_batch(new, spans), now)
        want = _loop_edges(old._match(_batch(old, spans), now))
        got = tuple(got) if got is not None else _loop_edges([])
        assert _bits(got) == _bits(want), (case, step)
        got_x = new._store.expire(now)
        want_x = old.expire_half_edges(now)
        assert _bits(got_x) == _bits((
            np.array([h.is_client for h in want_x], bool),
            np.array([h.service_id for h in want_x], np.int32),
            np.array([h.peer_id for h in want_x], np.int32),
            np.array([h.duration_s for h in want_x], np.float32),
            np.array([h.failed for h in want_x], bool))), (case, step)
        new.expired += len(got_x[0])
        assert (new.dropped, new.expired, len(new._store),
                new._store.pending()) == \
            (old.dropped, old.expired, len(old._store), len(old._ttl)), \
            (case, step)
        n_edges += len(want[0])
        n_expired += len(want_x)
    assert n_edges + n_expired > 0
    if case == "max_items_overflow":
        assert old.dropped > 0
    if case == "expiry_requeue":
        # 10 at the third push (5 clients queued again, stored anew at the
        # second), then 3 of those 5 (2 met their servers meanwhile)
        assert n_expired == 13


def _samples(reg):
    return {(s.name, s.labels): np.float64(s.value).tobytes()
            for s in reg.collect(1)}


@pytest.mark.parametrize("case", CASES)
def test_processor_matches_loop(case):
    """Whole processors, the new one against the loop, over the same
    pushes: every collected sample bit-identical, the interner's strings
    in the same order, and the same `dropped`, `expired` and
    `len(_store)`."""
    cfg, pushes = _case(case, seed=100 + CASES.index(case))
    clock = Clock()
    new = _processor(tt.ServiceGraphsProcessor, clock, **cfg)
    old = _processor(_LoopProcessor, clock, **cfg)
    for step, spans in pushes:
        clock.t += step
        new.push_batch(_batch(new, spans))
        old.push_batch(_batch(old, spans))
        assert (new.dropped, new.expired, len(new._store),
                new._store.pending()) == \
            (old.dropped, old.expired, len(old._store), len(old._ttl)), \
            (case, step)
    got, want = _samples(new.registry), _samples(old.registry)
    assert got == want
    assert new.registry.interner.snapshot() == old.registry.interner.snapshot()
    assert any(name == "traces_service_graph_request_total"
               for name, _ in got)
    if case == "peer_invalid_and_empty":
        virtual = [dict(labels) for name, labels in got
                   if name == "traces_service_graph_request_total"
                   and dict(labels)["connection_type"] == "virtual_node"]
        assert {"billing", "orders", "kafka", "cache"} <= \
            {v["server"] for v in virtual}
        assert "user" in {v["client"] for v in virtual}
        assert "" not in {v["server"] for v in virtual}


def test_match_span_and_drained_queue():
    """The match span keeps its name and attributes, and the expiry queue
    drains when its entries fall due even where every stored half-edge
    has met its other side and the store is empty."""
    clock = Clock()
    proc = _processor(tt.ServiceGraphsProcessor, clock)
    g = _Spans(7)
    pairs = [g.pair() for _ in range(5)]
    rec = tracing.SpanRecorder()
    prev = tracing.tracer()
    tracing.install(rec)
    try:
        proc.push_batch(_batch(proc, [c for c, _ in pairs]
                               + [pairs[0][1]]))
    finally:
        tracing.install(prev)
    (match,) = [s for s in rec.spans if s.name == "servicegraphs.match"]
    assert match.attrs == {"spans": 6, "edges": 1}
    assert (len(proc._store), proc._store.pending()) == (4, 5)
    proc.push_batch(_batch(proc, [s for _, s in pairs[1:]]))
    assert (len(proc._store), proc._store.pending()) == (0, 5)
    clock.t += 11.0
    proc.push_batch(_batch(proc, []))
    assert (len(proc._store), proc._store.pending(), proc.expired) == \
        (0, 0, 0)


def _counter(name, tenant):
    from tempo_tpu_torch.obs.runtime import RUNTIME
    return RUNTIME.get(name).value((tenant,))


def test_counters_count_what_they_name():
    """`_edges` counts completed edges, `_expired_edges` expired
    half-edges and `_dropped_spans` the spans a full store refused, by
    tenant, and all three are exported at 0 once the processor exists."""
    from tempo_tpu_torch.obs.runtime import RUNTIME
    tenant = "counters-tenant"
    clock = Clock()
    proc = _processor(tt.ServiceGraphsProcessor, clock, tenant=tenant,
                      max_items=6)
    prefix = "tempo_metrics_generator_processor_service_graphs_"
    names = {k: prefix + k for k in ("edges", "expired_edges",
                                     "dropped_spans")}
    text = RUNTIME.render()
    for name in names.values():
        assert f'{name}{{tenant="{tenant}"}} 0' in text
    g = _Spans(11)
    pairs = [g.pair() for _ in range(12)]
    # 4 pairs meet; 8 clients wait, of which the store takes 6 and drops 2
    proc.push_batch(_batch(proc, [s for p in pairs[:4] for s in p]
                           + [c for c, _ in pairs[4:]]))
    clock.t += 11.0
    proc.push_batch(_batch(proc, []))
    got = {k: _counter(n, tenant) for k, n in names.items()}
    assert got == {"edges": 4.0, "expired_edges": 6.0, "dropped_spans": 2.0}
    assert (proc.dropped, proc.expired, len(proc._store)) == (2, 6, 0)


def test_two_threads_lose_no_edge():
    """Two threads push self-contained payloads (every pair inside one
    payload) into one processor at once, under a short switch interval:
    no error, and every edge count equals that of the same payloads
    pushed one after another; sums within float32 reduction order."""
    clock = Clock()
    g = _Spans(13)
    payloads = [[s for _ in range(40) for s in g.pair()] for _ in range(16)]
    serial = _processor(tt.ServiceGraphsProcessor, clock, tenant="serial")
    for spans in payloads:
        serial.push_batch(_batch(serial, spans))
    shared = _processor(tt.ServiceGraphsProcessor, clock, tenant="shared")
    batches = [_batch(shared, spans) for spans in payloads]
    errors = []

    def push(part):
        try:
            for sb in part:
                shared.push_batch(sb)
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=push, args=(batches[i::2],))
               for i in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert not errors, errors
    want = {(s.name, s.labels): s.value for s in serial.registry.collect(1)}
    got = {(s.name, s.labels): s.value for s in shared.registry.collect(1)}
    assert got.keys() == want.keys()
    for key, v in want.items():
        if key[0].endswith("_sum"):
            assert got[key] == pytest.approx(v, rel=1e-6), key
        else:
            assert got[key] == v, key
    total = sum(v for (name, _), v in got.items()
                if name == "traces_service_graph_request_total")
    assert total == 40 * 16
    assert len(shared._store) == shared.dropped == 0
