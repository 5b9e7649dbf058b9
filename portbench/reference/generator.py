"""Plain reference of the metrics-generator's default processors.

What Grafana Tempo's `span-metrics` and `service-graphs` processors emit
for a set of spans, worked out again from the span columns of the
payloads a tenant acknowledged (`traffic/trees.py`), each with how many
times it was pushed. Nothing here reads the program or its state.

- span metrics, by (service, span_name, span_kind, status_code):
  `traces_spanmetrics_calls_total`, `traces_spanmetrics_size_total`
  (the span message's wire bytes), `traces_spanmetrics_latency` (the 15
  classic buckets, `le` inclusive, its sum and count, in seconds), and
  the DDSketch quantile sidecar (`reference/ddsketch.py`);
- service graphs, by (client, server, connection_type): a client span
  and the server span whose parent it is make one request; `failed` when
  either side has status error; client and server seconds observed in
  their histograms. A database call (a client span with `db.system`)
  finds no server and, once it expires, is an edge to a virtual node
  named by its `db.system` whose server side observes 0 s.

Sums accumulate in `dtype` with `torch.index_add_`: float64 for the
reference, a lower precision for the control (`CONTROL_DTYPE`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import ddsketch
from portbench.traffic.trees import (DB_SYSTEMS, KIND_CLIENT, KIND_SERVER,
                                     LabelSpace, SpanColumns, label_ids)

EDGES = (0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.128, 0.256, 0.512,
         1.024, 2.048, 4.096, 8.192, 16.384)
KIND_STR = {1: "SPAN_KIND_INTERNAL", KIND_SERVER: "SPAN_KIND_SERVER",
            KIND_CLIENT: "SPAN_KIND_CLIENT"}
STATUS_STR = ("STATUS_CODE_UNSET", "STATUS_CODE_OK", "STATUS_CODE_ERROR")
CONTROL_DTYPE = torch.bfloat16


@dataclasses.dataclass
class Pushed:
    """A payload's columns, its spans' wire sizes, and how many times the
    tenant acknowledged it."""

    cols: SpanColumns
    span_bytes: np.ndarray
    times: int


@dataclasses.dataclass
class Family:
    """Per-series state: counts, sums and bucket counts (non-cumulative)."""

    keys: list                 # label tuples, sorted by name
    count: np.ndarray          # [S]
    sums: np.ndarray           # [S] (seconds, or bytes for size_total)
    buckets: np.ndarray | None = None   # [S, len(EDGES) + 1]
    failed: np.ndarray | None = None    # [S] (service-graph edges)


def _bucket(dur_s: torch.Tensor) -> torch.Tensor:
    e = torch.tensor(EDGES, dtype=dur_s.dtype)
    return (dur_s[:, None] > e[None, :]).sum(1)


def _accumulate(ids, n_keys, values, dtype, times) -> torch.Tensor:
    """Per-key sums of `values`, each span added `times` times. The
    control adds push by push, as a program does."""
    out = torch.zeros(n_keys, dtype=dtype)
    ids = torch.as_tensor(ids, dtype=torch.int64)
    v = torch.as_tensor(values).to(dtype)
    if dtype == torch.float64:
        out.index_add_(0, ids, v * times)
    else:
        for _ in range(times):
            out.index_add_(0, ids, v)
    return out


class TenantReference:
    """The expected series of one tenant."""

    def __init__(self, space: LabelSpace, pushed: list[Pushed],
                 dtype=torch.float64, rel_err: float = 0.01,
                 min_s: float = 1e-6, max_s: float = 1e5) -> None:
        self.space = space
        self.dtype = dtype
        self.dd = ddsketch.DDSketchParams(rel_err, min_s, max_s)
        self._spanmetrics(pushed)
        self._servicegraphs(pushed)

    # -- span metrics ---------------------------------------------------

    def _sm_key(self, svc, name, kind, status) -> tuple:
        sp = self.space
        return (("service", sp.service_name(svc)),
                ("span_kind", KIND_STR[kind]),
                ("span_name", sp.span_name(name) if kind != 1 else "close"),
                ("status_code", STATUS_STR[status]))

    def _spanmetrics(self, pushed) -> None:
        sp = self.space
        n_lab = sp.size + 1                 # + the closing internal span
        cnt = torch.zeros(n_lab, dtype=self.dtype)
        lat = torch.zeros(n_lab, dtype=self.dtype)
        size = torch.zeros(n_lab, dtype=self.dtype)
        nb = len(EDGES) + 1
        bk = torch.zeros(n_lab * nb, dtype=self.dtype)
        dd_keys, dd_w = [], []
        for p in pushed:
            c = p.cols
            lab = np.where(c.kind == 1, sp.size, label_ids(c, sp))
            dur = torch.from_numpy(c.duration_ns.astype(np.float64) / 1e9)
            durd = dur.to(self.dtype)
            ones = torch.ones(c.n, dtype=self.dtype)
            cnt += _accumulate(lab, n_lab, ones, self.dtype, p.times)
            lat += _accumulate(lab, n_lab, durd, self.dtype, p.times)
            size += _accumulate(lab, n_lab, p.span_bytes.astype(np.float64),
                                self.dtype, p.times)
            cell = torch.from_numpy(lab) * nb + _bucket(durd.to(torch.float64))
            bk += _accumulate(cell, n_lab * nb, ones, self.dtype, p.times)
            idx = self.dd.index(durd.to(torch.float64).numpy()) + 1
            dd_keys.append(lab.astype(np.int64) * (self.dd.nb + 1) + idx)
            dd_w.append(np.full(c.n, p.times, np.int64))
        self.sm_count = cnt.double().numpy()
        live = np.flatnonzero(self.sm_count > 0) if self.dtype == torch.float64 \
            else np.flatnonzero(cnt.double().numpy() != 0)
        keys = []
        for lab in live.tolist():
            if lab == sp.size:
                keys.append(self._sm_key(0, 0, 1, 0))
                continue
            st = lab % sp.statuses
            rest = lab // sp.statuses
            name = rest % sp.names
            rest //= sp.names
            svc = rest % sp.services
            kind = KIND_CLIENT if rest // sp.services else KIND_SERVER
            keys.append(self._sm_key(svc, name, kind, st))
        self.sm_live = live
        self.spanmetrics = Family(
            keys=keys, count=cnt.double().numpy()[live],
            sums=lat.double().numpy()[live],
            buckets=bk.double().numpy().reshape(n_lab, nb)[live])
        self.sizes = size.double().numpy()[live]
        # DDSketch rows of every live label set: (label * nb + index) keys
        k = np.concatenate(dd_keys) if dd_keys else np.zeros(0, np.int64)
        w = np.concatenate(dd_w) if dd_w else np.zeros(0, np.int64)
        uk, inv = np.unique(k, return_inverse=True)
        self._dd_cells = (uk, np.bincount(inv, weights=w))

    def dd_quantiles(self, qs) -> dict:
        """{span-metrics key: [value a q]} from the reference's sketch."""
        uk, cw = self._dd_cells
        lab, idx = uk // (self.dd.nb + 1), uk % (self.dd.nb + 1) - 1
        starts = np.searchsorted(lab, self.sm_live)
        ends = np.searchsorted(lab, self.sm_live, side="right")
        vals = np.stack([self.dd.quantiles(idx, cw, starts, ends, q)
                         for q in qs], 1)
        return dict(zip(self.spanmetrics.keys, vals.tolist()))

    # -- service graphs -------------------------------------------------

    def _servicegraphs(self, pushed) -> None:
        sp = self.space
        keys: dict[tuple, int] = {}
        rows_k, rows_f, rows_c, rows_s, rows_t = [], [], [], [], []
        for p in pushed:
            c = p.cols
            cli = np.flatnonzero((c.kind == KIND_CLIENT) & (c.peer >= 0))
            srv = c.peer[cli]
            db = np.flatnonzero((c.kind == KIND_CLIENT) & (c.db >= 0))
            pairs = [(sp.service_name(a), sp.service_name(b), "")
                     for a, b in zip(c.service[cli].tolist(),
                                     c.service[srv].tolist())]
            pairs += [(sp.service_name(a), DB_SYSTEMS[d], "virtual_node")
                      for a, d in zip(c.service[db].tolist(),
                                      c.db[db].tolist())]
            ids = np.array([keys.setdefault(t, len(keys)) for t in pairs],
                           np.int64)
            fail = np.concatenate([(c.status[cli] == 2) | (c.status[srv] == 2),
                                   c.status[db] == 2]).astype(np.float64)
            dur = c.duration_ns.astype(np.float64) / 1e9
            rows_k.append(ids)
            rows_f.append(fail)
            rows_c.append(np.concatenate([dur[cli], dur[db]]))
            rows_s.append(np.concatenate([dur[srv], np.zeros(db.size)]))
            rows_t.append(np.full(ids.size, p.times, np.int64))
        n = len(keys)
        nb = len(EDGES) + 1
        total = torch.zeros(n, dtype=self.dtype)
        failed = torch.zeros(n, dtype=self.dtype)
        fams = {}
        for side, rows in (("client", rows_c), ("server", rows_s)):
            sums = torch.zeros(n, dtype=self.dtype)
            bk = torch.zeros(n * nb, dtype=self.dtype)
            for ids, v, times in zip(rows_k, rows, rows_t):
                if not ids.size:
                    continue
                t = int(times[0])
                vd = torch.from_numpy(v).to(self.dtype)
                sums += _accumulate(ids, n, vd, self.dtype, t)
                cell = torch.from_numpy(ids) * nb + _bucket(vd.double())
                bk += _accumulate(cell, n * nb, torch.ones(ids.size),
                                  self.dtype, t)
            fams[side] = (sums, bk)
        for ids, f, times in zip(rows_k, rows_f, rows_t):
            if not ids.size:
                continue
            t = int(times[0])
            total += _accumulate(ids, n, torch.ones(ids.size), self.dtype, t)
            failed += _accumulate(ids, n, torch.from_numpy(f), self.dtype, t)
        klist = [(("client", a), ("connection_type", ct), ("server", b))
                 for (a, b, ct) in keys]
        tot = total.double().numpy()
        self.edges = {
            side: Family(keys=klist, count=tot, sums=s.double().numpy(),
                         buckets=b.double().numpy().reshape(n, nb),
                         failed=failed.double().numpy())
            for side, (s, b) in fams.items()}
