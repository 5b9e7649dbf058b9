"""Seeded two-span trace trees over a Zipf-skewed label space.

Each trace is a CLIENT span in one service and a SERVER span in another
whose parent is the client span, or, for a `db_share` of the traces, a
lone CLIENT span that carries `db.system` and has no server side (the
service-graphs processor turns it into a virtual-node edge when it
expires). A span's label set is (service, span name, kind, status); the
client and the server label sets are each drawn by Zipf rank over the
services x names x statuses of their kind, through a permutation drawn
from the seed, so that every seed has the same skew over other keys.

Columns only: the encoder (`traffic/otlp.py`) writes the wire bytes and
the references (`reference/`) read these same columns. Times are
relative: every span's `end_ns` lies in [-end_spread_ns, 0], each drawn
on its own, as an exporter sends spans shortly after they end, and the
client stamps each push's base time in (`otlp.Payload.stamp`). So no
span comes near the generator's ingestion time-range slack, which would
drop it by the time it is pushed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

KIND_SERVER, KIND_CLIENT = 2, 3
DB_SYSTEMS = ("postgresql", "redis", "mysql", "mongodb")


@dataclasses.dataclass(frozen=True)
class LabelSpace:
    """The label sets of one tenant: `services` x `names` x 2 kinds x
    `statuses`, with Zipf exponent `zipf_a` over each kind's ranks."""

    services: int
    names: int
    statuses: int = 3
    zipf_a: float = 1.1

    @property
    def per_kind(self) -> int:
        return self.services * self.names * self.statuses

    @property
    def size(self) -> int:
        return 2 * self.per_kind

    def service_name(self, i) -> str:
        return f"service-{int(i):02d}"

    def span_name(self, i) -> str:
        return f"op-{int(i):03d}"


@dataclasses.dataclass
class SpanColumns:
    """One payload's spans as aligned columns."""

    trace_id: np.ndarray        # [n, 16] uint8
    span_id: np.ndarray         # [n, 8] uint8
    parent_span_id: np.ndarray  # [n, 8] uint8, zeros where there is none
    has_parent: np.ndarray      # [n] bool
    service: np.ndarray         # [n] int64
    name: np.ndarray            # [n] int64
    kind: np.ndarray            # [n] int64 (2 server, 3 client)
    status: np.ndarray          # [n] int64 (0 unset, 1 ok, 2 error)
    db: np.ndarray              # [n] int64, index into DB_SYSTEMS or -1
    start_ns: np.ndarray        # [n] int64, relative
    end_ns: np.ndarray          # [n] int64, relative
    peer: np.ndarray            # [n] int64: the row of a span's pair, or -1

    @property
    def n(self) -> int:
        return int(self.kind.size)

    @property
    def duration_ns(self) -> np.ndarray:
        return self.end_ns - self.start_ns


def zipf_ranks(rng: np.random.Generator, n: int, size: int,
               a: float) -> np.ndarray:
    """`n` ranks in [0, size) with P(r) proportional to 1 / (r + 1)^a."""
    p = 1.0 / np.arange(1, size + 1, dtype=np.float64) ** a
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(n), side="right"),
                      size - 1)


def label_permutations(space: LabelSpace, seed: list) -> np.ndarray:
    """[2, per_kind] map from Zipf rank to (service, name, status) code,
    one row a kind (0 server, 1 client); fixed by the `seed` sequence."""
    rng = np.random.default_rng([*seed, 7])
    return np.stack([rng.permutation(space.per_kind) for _ in range(2)])


def trace_trees(n: int, *, space: LabelSpace, perms: np.ndarray,
                rng: np.random.Generator, db_share: float,
                end_spread_ns: int = 10_000_000_000) -> SpanColumns:
    """`n` spans of two-span trees (see the module docstring), shuffled."""
    is_db = rng.random(n) < db_share
    width = np.where(is_db, 1, 2)
    ends = np.cumsum(width)
    t = int(np.searchsorted(ends, n, side="left")) + 1   # traces that cover n
    is_db, width = is_db[:t], width[:t]
    if int(width.sum()) > n:             # one slot left: the last is a db call
        is_db[-1], width[-1] = True, 1
    pair = ~is_db
    # client side of every trace, server side of the pairs
    c_code = perms[1][zipf_ranks(rng, t, space.per_kind, space.zipf_a)]
    s_code = perms[0][zipf_ranks(rng, t, space.per_kind, space.zipf_a)]
    dur = np.maximum(rng.lognormal(17.0, 1.5, t), 2.0).astype(np.int64)
    c_end = -(rng.random(t) * end_spread_ns).astype(np.int64)
    sdur = np.maximum((dur * rng.uniform(0.3, 0.95, t)).astype(np.int64), 1)
    s_start = -(rng.random(t) * end_spread_ns).astype(np.int64) - sdur
    db = rng.integers(0, len(DB_SYSTEMS), t)
    tid = rng.integers(0, 256, (t, 16), dtype=np.uint8)
    cid = rng.integers(0, 256, (t, 8), dtype=np.uint8)
    sid = rng.integers(0, 256, (t, 8), dtype=np.uint8)

    ps = np.flatnonzero(pair)
    nc, npair = t, ps.size

    def cols(code):
        st = code % space.statuses
        rest = code // space.statuses
        return rest // space.names, rest % space.names, st

    c_svc, c_name, c_st = cols(c_code)
    s_svc, s_name, s_st = cols(s_code[ps])
    # client rows 0..t-1, then server rows t..t+npair-1
    trace_id = np.concatenate([tid, tid[ps]])
    span_id = np.concatenate([cid, sid[ps]])
    parent = np.concatenate([np.zeros((nc, 8), np.uint8), cid[ps]])
    has_parent = np.concatenate([np.zeros(nc, bool), np.ones(npair, bool)])
    peer = np.full(nc + npair, -1, np.int64)
    peer[ps] = nc + np.arange(npair)
    peer[nc:] = ps
    order = rng.permutation(nc + npair)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    peer = np.where(peer >= 0, inv[np.maximum(peer, 0)], -1)[order]
    return SpanColumns(
        trace_id=trace_id[order], span_id=span_id[order],
        parent_span_id=parent[order], has_parent=has_parent[order],
        service=np.concatenate([c_svc, s_svc])[order],
        name=np.concatenate([c_name, s_name])[order],
        kind=np.concatenate([np.full(nc, KIND_CLIENT),
                             np.full(npair, KIND_SERVER)])[order],
        status=np.concatenate([c_st, s_st])[order],
        db=np.concatenate([np.where(is_db, db, -1),
                           np.full(npair, -1)])[order],
        start_ns=np.concatenate([c_end - dur, s_start[ps]])[order],
        end_ns=np.concatenate([c_end, s_start[ps] + sdur[ps]])[order],
        peer=peer)


def label_ids(cols: SpanColumns, space: LabelSpace) -> np.ndarray:
    """Dense label-set id of each span in [0, space.size)."""
    k = np.where(cols.kind == KIND_CLIENT, 1, 0)
    return ((k * space.services + cols.service) * space.names
            + cols.name) * space.statuses + cols.status
