"""The plain references on cases small enough to work out by hand."""

import numpy as np
import pytest

from portbench.reference import ddsketch, generator
from portbench.reference.generator import Pushed, TenantReference
from portbench.traffic import trees

SPACE = trees.LabelSpace(2, 2)


def _cols(rows):
    """Columns from (service, name, kind, status, db, dur_ns, peer)."""
    n = len(rows)
    a = np.array(rows, np.int64).reshape(n, 7)
    z8 = np.zeros((n, 8), np.uint8)
    return trees.SpanColumns(
        trace_id=np.zeros((n, 16), np.uint8), span_id=z8, parent_span_id=z8,
        has_parent=a[:, 6] >= 0, service=a[:, 0], name=a[:, 1], kind=a[:, 2],
        status=a[:, 3], db=a[:, 4], start_ns=np.zeros(n, np.int64),
        end_ns=a[:, 5], peer=a[:, 6])


def test_spanmetrics_and_edges_by_hand():
    # a client (service 0) calls a server (service 1); a db call from
    # service 1; the client failed
    c = _cols([(0, 1, 3, 2, -1, 3_000_000, 1),      # client, 3 ms, error
               (1, 0, 2, 1, -1, 1_000_000, 0),      # server, 1 ms, ok
               (1, 1, 3, 0, 2, 20_000_000, -1)])    # db call, 20 ms
    ref = TenantReference(SPACE, [Pushed(c, np.array([50, 60, 70]), 3)])
    sm = ref.spanmetrics
    by = dict(zip(sm.keys, range(len(sm.keys))))
    cli = (("service", "service-00"), ("span_kind", "SPAN_KIND_CLIENT"),
           ("span_name", "op-001"), ("status_code", "STATUS_CODE_ERROR"))
    i = by[cli]
    assert sm.count[i] == 3 and sm.sums[i] == pytest.approx(0.009)
    assert ref.sizes[i] == 150
    # 3 ms lies in (0.002, 0.004]: bucket 1
    assert sm.buckets[i].tolist() == [0, 3] + [0] * 13
    edges = ref.edges["client"]
    e = dict(zip(edges.keys, range(len(edges.keys))))
    pair = (("client", "service-00"), ("connection_type", ""),
            ("server", "service-01"))
    db = (("client", "service-01"), ("connection_type", "virtual_node"),
          ("server", "mysql"))
    assert edges.count[e[pair]] == 3 and edges.failed[e[pair]] == 3
    assert edges.sums[e[pair]] == pytest.approx(0.009)
    assert ref.edges["server"].sums[e[pair]] == pytest.approx(0.003)
    assert edges.count[e[db]] == 3 and edges.failed[e[db]] == 0
    assert ref.edges["server"].buckets[e[db]][0] == 3   # 0 s observed


def test_ddsketch_by_hand():
    p = ddsketch.DDSketchParams(0.01, 1e-6, 1e5)
    v = np.array([0.001, 0.002, 0.004, 0.1])
    idx = p.index(v)
    assert np.all(np.diff(idx) > 0)
    # each answer lies within the sketch's 1% of the value it stands for
    q = p.quantiles(idx, np.ones(4), np.array([0]), np.array([4]), 0.5)
    assert q[0] == pytest.approx(0.002, rel=0.0101)
    q = p.quantiles(idx, np.ones(4), np.array([0]), np.array([4]), 0.99)
    assert q[0] == pytest.approx(0.1, rel=0.0101)
    assert p.index(np.array([1e-7]))[0] == -1          # a zero
    q = p.quantiles(np.array([-1, idx[3]]), np.array([3.0, 1.0]),
                    np.array([0]), np.array([2]), 0.5)
    assert q[0] == 0.0


def test_control_dtype_loses_counts():
    c = _cols([(0, 0, 2, 0, -1, 1_000_000, -1)] * 300)
    ref = TenantReference(SPACE, [Pushed(c, np.full(300, 10), 2)])
    ctl = TenantReference(SPACE, [Pushed(c, np.full(300, 10), 2)],
                          dtype=generator.CONTROL_DTYPE)
    assert ref.spanmetrics.count[0] == 600
    assert ctl.spanmetrics.count[0] != 600
