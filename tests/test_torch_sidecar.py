"""The sketch sidecars (`block/sidecar.py`) and the frontend's sidecar
fold tier, against the reference.

The fold tests take the reference's bytes:
`tempo_tpu.block.sidecar.sidecar_from_traces(...).to_json()` over each
block's traces, written under `sidecar.json` next
to the block in each package's backend, with the block's meta marked
`sidecar`. Both frontends then fold the same bytes. Held:

- decoding, `eligible_plan`, `_step_fractions`, `fold_series` and
  `merge_sidecars` equal to the reference's;
- `tests/test_compact.py:246-300`: the quantile fold within the
  reference's 5% gate of the exact quantile and equal to the reference
  frontend's fold; the rate fold equal to the rescan at rel 1e-9; a
  block without its sidecar mark falls back to the scan; the second
  query is a fold-cache hit;
- the write half (`build_sidecar`, `sidecar_from_traces`,
  `write_sidecar`) and the HLL estimate against the reference's
  (`tests/test_torch_blockbuilder.py` holds the port-written sidecars
  folded by the reference's frontend).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tempo_tpu.block import sidecar as jsc
from tempo_tpu_torch.block import sidecar as tsc
from tests.test_torch_frontend import T0, block_id, mkspan, mod

SIDECAR_QUERIES = [
    "{ } | rate()",
    "{ } | rate() by (resource.service.name)",
    "{ } | rate() by (name, resource.service.name)",
    "{ } | quantile_over_time(duration, .5)",
    "{ } | quantile_over_time(duration, .5, .9) by (resource.service.name)",
    '{ span.foo = "x" } | rate()',
    "{ } | quantile_over_time(span.bytes, .5)",
    "{ } | rate() by (span.foo)",
    "{ } | histogram_over_time(duration)",
    "{ } | count_over_time()",
    "{ duration > 1s } | rate()",
    "{ }",
    "not a query",
]


def fold_blocks(rng, n_blocks=3, spans_per_block=60):
    """`tests/test_compact.py::_fold_stack`'s blocks, draw for draw."""
    blocks, durs = [], []
    for blk in range(n_blocks):
        traces = []
        for i in range(spans_per_block):
            tid = bytes([blk * 64 + (i % 50), 9] + [0] * 14)
            d = float(rng.lognormal(np.log(50), 0.5))
            durs.append(d)
            traces.append((tid, [mkspan(tid, bytes(
                rng.integers(0, 256, 8).astype(np.uint8)),
                name=f"op-{i % 3}", svc=f"svc-{blk % 2}", t0_s=T0 + i * 3,
                dur_ms=d)]))
        blocks.append(sorted(traces, key=lambda t: t[0]))
    return blocks, np.array(durs)


class FoldStack:
    """Blocks + the reference's sidecar bytes in one package's backend."""

    def __init__(self, side: str, blocks, mark=None):
        self.side = side
        self.clock = [T0 + 3600.0]
        now = self.now = lambda: self.clock[0]
        self.be = mod(side, "backend.mem").MemBackend()
        tdb = mod(side, "db.tempodb")
        kw = {"device": "cpu"} if side == "port" else {}
        self.db = tdb.TempoDB(self.be, self.be, now=now, **kw)
        raw = mod(side, "backend.raw")
        for i, traces in enumerate(blocks):
            bid = block_id(i)
            self.db.write_block("t1", traces, block_id=bid,
                                replication_factor=1)
            self.be.write(jsc.SIDECAR_NAME, raw.block_keypath(bid, "t1"),
                          jsc.sidecar_from_traces(traces).to_json())
        self.db.poll_now()
        for i, m in enumerate(self.db.blocklist.metas("t1")):
            m.sidecar = True if mark is None else mark(m)
        ring = mod(side, "ring").Ring(replication_factor=1, now=now)
        qm = mod(side, "querier")
        self.q = qm.Querier(self.db, ring, {}, cfg=qm.QuerierConfig(rf=1))

    def frontend(self, **cfg):
        fm = mod(self.side, "frontend")
        return fm.Frontend(self.db, self.q, cfg=fm.FrontendConfig(**cfg),
                           now=self.now)

    def close(self):
        self.db.shutdown()


def totals(series):
    return {s.labels: float(np.nansum(s.samples)) for s in series}


# ---------------------------------------------------------------------------
# the module, piece by piece
# ---------------------------------------------------------------------------

def test_sidecar_json_roundtrip_matches_reference():
    blocks, _ = fold_blocks(np.random.default_rng(3), n_blocks=2)
    for traces in blocks:
        raw = jsc.sidecar_from_traces(traces).to_json()
        t, j = tsc.Sidecar.from_json(raw), jsc.Sidecar.from_json(raw)
        assert t.to_json() == j.to_json() == raw
        assert (t.k, t.lo, t.hi, t.total_spans, t.series,
                t.hll_precision) == (j.k, j.lo, j.hi, j.total_spans,
                                     j.series, j.hll_precision)
        np.testing.assert_array_equal(t.rows, j.rows)
        np.testing.assert_array_equal(t.hll, j.hll)
    assert tsc.SIDECAR_HLL_PRECISION == j.hll_precision
    with pytest.raises(ValueError, match="version"):
        tsc.Sidecar.from_json(b'{"version": 9}')


def test_read_sidecar_absent_or_unreadable_is_none():
    from tempo_tpu_torch.backend.mem import MemBackend
    from tempo_tpu_torch.backend.raw import block_keypath

    be = MemBackend()
    assert tsc.read_sidecar(be, "t", "b") is None
    be.write(tsc.SIDECAR_NAME, block_keypath("b", "t"), b"{not json")
    assert tsc.read_sidecar(be, "t", "b") is None
    be.write(tsc.SIDECAR_NAME, block_keypath("b", "t"), b'{"version": 1}')
    assert tsc.read_sidecar(be, "t", "b") is None


@pytest.mark.parametrize("query", SIDECAR_QUERIES)
def test_eligible_plan_matches_reference(query):
    t, j = tsc.eligible_plan(query), jsc.eligible_plan(query)
    assert (t is None) == (j is None)
    if t is not None:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_fold_series_matches_reference():
    """`_step_fractions` and `fold_series` over one sidecar, for every
    eligible plan, windows inside, across and outside the block, with and
    without the cutoff clip, and a zero-duration block."""
    from tempo_tpu.backend.meta import BlockMeta as JMeta
    from tempo_tpu.traceql.engine_metrics import QueryRangeRequest as JReq
    from tempo_tpu_torch.backend.meta import BlockMeta as TMeta
    from tempo_tpu_torch.traceql.engine_metrics import (
        QueryRangeRequest as TReq)

    blocks, _ = fold_blocks(np.random.default_rng(5), n_blocks=1)
    raw = jsc.sidecar_from_traces(blocks[0]).to_json()
    t_sc, j_sc = tsc.Sidecar.from_json(raw), jsc.Sidecar.from_json(raw)
    n = 0
    for start, end in ((T0, T0 + 177), (T0 + 50, T0 + 50)):
        tm = TMeta(block_id="b", tenant_id="t1", start_time=start,
                   end_time=end)
        jm = JMeta.from_json(tm.to_json())
        for w0, w1, step in ((T0 - 60, T0 + 600, 660), (T0, T0 + 180, 30),
                             (T0 + 40, T0 + 100, 7), (T0 + 500, T0 + 900,
                                                      60)):
            for clip in (None, int((T0 + 90) * 1e9)):
                for q in SIDECAR_QUERIES:
                    plan = jsc.eligible_plan(q)
                    if plan is None:
                        continue
                    kw = dict(query=q, start_ns=int(w0 * 1e9),
                              end_ns=int(w1 * 1e9), step_ns=int(step * 1e9))
                    tr, jr = TReq(**kw), JReq(**kw)
                    np.testing.assert_array_equal(
                        tsc._step_fractions(tr, tm, clip),
                        jsc._step_fractions(jr, jm, clip))
                    a = tsc.fold_series(t_sc, tm, tr, tsc.eligible_plan(q),
                                        clip)
                    b = jsc.fold_series(j_sc, jm, jr, plan, clip)
                    assert [s.labels for s in a] == [s.labels for s in b]
                    for x, y in zip(a, b):
                        np.testing.assert_array_equal(x.samples, y.samples)
                    n += len(a)
    assert n > 100


def test_merge_sidecars_matches_reference():
    blocks, _ = fold_blocks(np.random.default_rng(7), n_blocks=3)
    raws = [jsc.sidecar_from_traces(t).to_json() for t in blocks]
    t = tsc.merge_sidecars(tsc.Sidecar.from_json(raws[0]),
                           tsc.Sidecar.from_json(raws[1]))
    t = tsc.merge_sidecars(t, tsc.Sidecar.from_json(raws[2]))
    j = jsc.merge_sidecars(jsc.Sidecar.from_json(raws[0]),
                           jsc.Sidecar.from_json(raws[1]))
    j = jsc.merge_sidecars(j, jsc.Sidecar.from_json(raws[2]))
    assert t.to_json() == j.to_json()
    other = tsc.Sidecar.from_json(raws[0])
    other.k = 6
    with pytest.raises(ValueError, match="mismatched"):
        tsc.merge_sidecars(t, other)
    a = np.array([[1.0, 2.0, 3.0, 0.5, 0.1]])
    b = np.array([[2.0, 1.0, 1.0, 0.2, 0.7]])
    from tempo_tpu.ops.moments import moments_merge_rows as jmerge
    from tempo_tpu_torch.ops.moments import moments_merge_rows as tmerge
    np.testing.assert_array_equal(tmerge(a, b, 2), jmerge(a, b, 2))


def test_write_half_matches_reference():
    """`sidecar_from_traces` on the CPU against the reference's: the same
    series, spans and HLL registers, moment counts and bounds exact, sums
    within rtol 1e-5; `write_sidecar` writes what `read_sidecar` reads in
    both packages; `trace_cardinality` equal within rtol 1e-6."""
    from tempo_tpu.backend.mem import MemBackend as JMem
    from tempo_tpu_torch.backend.mem import MemBackend as TMem

    for traces in fold_blocks(np.random.default_rng(1), n_blocks=2)[0]:
        t = tsc.sidecar_from_traces(traces, device="cpu")
        j = jsc.sidecar_from_traces(traces)
        assert (t.k, t.lo, t.hi, t.total_spans, t.series) == \
            (j.k, j.lo, j.hi, j.total_spans, j.series)
        np.testing.assert_array_equal(t.hll, j.hll)
        k = t.k
        np.testing.assert_array_equal(t.rows[:, 0], j.rows[:, 0])
        np.testing.assert_array_equal(t.rows[:, k + 1:], j.rows[:, k + 1:])
        np.testing.assert_allclose(t.rows[:, 1:k + 1], j.rows[:, 1:k + 1],
                                   rtol=1e-5, atol=1e-5 * t.total_spans)
        assert t.trace_cardinality() == pytest.approx(
            j.trace_cardinality(), rel=1e-6)
        tbe, jbe = TMem(), JMem()
        tsc.write_sidecar(tbe, "t", "b", t)
        jbe._objects.update(tbe._objects)
        assert jsc.read_sidecar(jbe, "t", "b").to_json() == t.to_json()
        assert tsc.read_sidecar(tbe, "t", "b").to_json() == t.to_json()


# ---------------------------------------------------------------------------
# the fold tier through the frontend (tests/test_compact.py:246-300)
# ---------------------------------------------------------------------------

QQ = "{ } | quantile_over_time(duration, .5, .9)"
WIN = dict(start_s=T0 - 60, end_s=T0 + 600, step_s=660.0)


def test_sidecar_fold_quantile_within_moments_gate():
    blocks, durs = fold_blocks(np.random.default_rng(17))
    p, r = FoldStack("port", blocks), FoldStack("ref", blocks)
    try:
        a = p.frontend().query_range("t1", QQ, **WIN)
        b = r.frontend().query_range("t1", QQ, **WIN)
        assert p.db.compaction_stats["sidecar_folds"] == 3
        assert p.db.compaction_stats["sidecar_fallbacks"] == 0
        got = {dict(s.labels)["p"]: float(np.nansum(s.samples)) for s in a}
        want = {dict(s.labels)["p"]: float(np.nansum(s.samples)) for s in b}
        assert got == want          # the same rows through the same solver
        for qv in (0.5, 0.9):
            exact = np.quantile(durs, qv) / 1e3
            rel = abs(got[qv] - exact) / exact
            rank = abs(np.mean(durs / 1e3 <= got[qv]) - qv)
            assert min(rel, rank) <= 0.05, (qv, got[qv], exact, rel, rank)
        # the second query is served from the fold cache
        p.frontend().query_range("t1", QQ, **WIN)
        assert p.db.planes.fold_hits == 3
        assert p.db.compaction_stats["sidecar_folds"] == 6
        fams = dict(p.db.obs.get(
            "tempo_compaction_sidecar_folds_total").fn())
        assert fams[()] == 6
    finally:
        p.close()
        r.close()


def test_sidecar_fold_rate_matches_rescan_exactly():
    blocks, _ = fold_blocks(np.random.default_rng(23), n_blocks=2,
                            spans_per_block=40)
    p, r = FoldStack("port", blocks), FoldStack("ref", blocks)
    try:
        for query in ("{ } | rate()",
                      "{ } | rate() by (resource.service.name)",
                      "{ } | rate() by (name)"):
            a = totals(p.frontend().query_range("t1", query, **WIN))
            b = totals(p.frontend(sidecar_folds=False).query_range(
                "t1", query, **WIN))
            c = totals(r.frontend().query_range("t1", query, **WIN))
            assert set(a) == set(b) == set(c)
            for k in a:
                assert a[k] == pytest.approx(b[k], rel=1e-9), (query, k)
                assert a[k] == pytest.approx(c[k], rel=1e-9), (query, k)
        # the cold tier's keys are the reference's; only the folds moved
        assert p.db.compaction_stats == {
            "blocks": 0, "spans": 0, "device_seconds": 0.0,
            "sidecars_written": 0, "sidecar_folds": 6,
            "sidecar_fallbacks": 0}
        assert set(p.db.compaction_stats) == set(r.db.compaction_stats)
    finally:
        p.close()
        r.close()


def test_fold_ineligible_block_falls_back_to_scan():
    blocks, _ = fold_blocks(np.random.default_rng(29), n_blocks=3,
                            spans_per_block=30)
    first = block_id(0)
    p = FoldStack("port", blocks, mark=lambda m: m.block_id != first)
    r = FoldStack("ref", blocks, mark=lambda m: m.block_id != first)
    try:
        a = p.frontend().query_range("t1", "{ } | rate()", **WIN)
        b = p.frontend(sidecar_folds=False).query_range(
            "t1", "{ } | rate()", **WIN)
        c = r.frontend().query_range("t1", "{ } | rate()", **WIN)
        assert float(np.nansum(a[0].samples)) == pytest.approx(
            float(np.nansum(b[0].samples)), rel=1e-9)
        assert float(np.nansum(a[0].samples)) == pytest.approx(
            float(np.nansum(c[0].samples)), rel=1e-9)
        assert p.db.compaction_stats["sidecar_folds"] == 2
        # a marked block whose sidecar is gone re-scans and is counted
        from tempo_tpu_torch.backend.raw import block_keypath

        p.be.delete(tsc.SIDECAR_NAME, block_keypath(block_id(1), "t1"))
        d = p.frontend().query_range("t1", "{ } | rate()",
                                     start_s=T0 - 120, end_s=T0 + 600,
                                     step_s=720.0)
        assert p.db.compaction_stats["sidecar_fallbacks"] == 1
        assert float(np.nansum(d[0].samples)) * 720 == pytest.approx(90.0)
    finally:
        p.close()
        r.close()


def test_fold_tier_stays_out_of_the_way_without_sidecars():
    """No block carries a sidecar: the plan is dropped, every block scans
    and neither counter moves (the chip smoke's phase 11b holds the same
    on the card)."""
    blocks, _ = fold_blocks(np.random.default_rng(31), n_blocks=2,
                            spans_per_block=20)
    p = FoldStack("port", blocks, mark=lambda m: False)
    try:
        s = p.frontend().query_range("t1", QQ, **WIN)
        assert s and p.db.compaction_stats == {
            "blocks": 0, "spans": 0, "device_seconds": 0.0,
            "sidecars_written": 0, "sidecar_folds": 0,
            "sidecar_fallbacks": 0}
        assert p.db.plane_stats["fused_metric_blocks"] == 2
        # folds are dropped with their block
        p.db.planes.fold_put("t1", block_id(0), ("k",), [])
        p.db.planes.drop_dead("t1", {block_id(1)})
        assert p.db.planes.fold_get("t1", block_id(0), ("k",)) is None
    finally:
        p.close()
