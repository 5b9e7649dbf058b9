"""The port's TraceQL metrics engine against the reference.

Mirrors `tests/test_engine.py` and `tests/test_plane_arith.py`: the same
block (written by the port's codec, read by the reference through
pyarrow) goes through both packages' `MetricsEvaluator` (the host engine)
and `SeriesCombiner`, for every metrics kind. The numerics contract:
counts, min/max and log2 buckets (so quantiles and histograms) are
bit-identical; float sums are within rtol 1e-5; moments-tier quantiles
within the tier's error gate (rtol 5e-2, `tests/test_plane_fuzz.py:229`).
The port's grids are torch tensors on the CPU here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tempo_tpu.backend.local import LocalBackend as JLocal
from tempo_tpu.block import fetch as jfetch
from tempo_tpu.db.tempodb import TempoDB as JDB, TempoDBConfig as JCfg
from tempo_tpu.ops import moments as jmom
from tempo_tpu.traceql import engine_metrics as jem

from tempo_tpu_torch.backend.local import LocalBackend as TLocal
from tempo_tpu_torch.block import fetch as tfetch
from tempo_tpu_torch.db.tempodb import TempoDB as TDB, TempoDBConfig as TCfg
from tempo_tpu_torch.ops import moments as tmom
from tempo_tpu_torch.traceql import engine_metrics as tem

from tests.test_torch_traceql import T0_NS, port_block, seeded_traces

STEP = 60 * 10**9
WIN = (T0_NS, T0_NS + 900 * 10**9)

COUNT_KINDS = ("rate()", "count_over_time()", "histogram_over_time",
               "quantile_over_time", "min_over_time", "max_over_time",
               "compare(")


def smap(series) -> dict:
    return {tuple(sorted((str(k), str(v)) for k, v in s.labels)):
            np.nan_to_num(np.asarray(s.samples, np.float64))
            for s in series}


def assert_series_equal(a: dict, b: dict, query: str, ctx: str = ""):
    assert set(a) == set(b), f"{ctx} {query}: only-port={set(a) - set(b)}, " \
        f"only-ref={set(b) - set(a)}"
    exact = any(k in query for k in COUNT_KINDS) and "__moment" not in \
        "".join(str(k) for k in a)
    for k in b:
        if exact:
            assert np.array_equal(a[k], b[k]), f"{ctx} {query} {k}"
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-4,
                                       err_msg=f"{ctx} {query} {k}")


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    return port_block(tmp_path_factory.mktemp("engine"),
                      seeded_traces(23, 300), row_group_rows=128)


def _views(blocks):
    tb, jb = blocks
    return ([v for v, _ in tfetch.scan_views(tb)],
            [v for v, _ in jfetch.scan_views(jb)])


def _run(mod, views, query, win=WIN, step=STEP, clip=(None, None),
         batched=True, **kw):
    req = mod.QueryRangeRequest(query=query, start_ns=win[0], end_ns=win[1],
                                step_ns=step)
    ev = mod.MetricsEvaluator(req, clip[0], clip[1], batched=batched, **kw)
    for v in views:
        ev.observe(v)
    raw = ev.results()
    comb = mod.SeriesCombiner(ev.m.kind, req.n_steps)
    comb.add_all(raw)
    return raw, comb.final(req)


# ---------------------------------------------------------------------------
# pure helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log2_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.lognormal(16, 3, 500), [0, 1, 2, 3, 1 << 40,
                                                    2.0 ** 63]])
    assert np.array_equal(tem.log2_bucket_np(v), jem.log2_bucket_np(v))
    g = rng.integers(0, 5, (7, tem.HBUCKETS)).astype(float)
    qs = (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)
    assert np.array_equal(tem.log2_quantiles_multi(qs, g),
                          jem.log2_quantiles_multi(qs, g))
    for q in qs:
        assert tem.log2_quantile(q, g[0]) == jem.log2_quantile(q, g[0])


def test_request_steps_and_labels_match_reference():
    for args in ((0, 10**9, 7 * 10**7), (5, 901 * 10**9, 60 * 10**9),
                 (T0_NS, T0_NS + 10**12, 3 * 10**9)):
        t = tem.QueryRangeRequest("{ } | rate()", *args)
        j = jem.QueryRangeRequest("{ } | rate()", *args)
        assert t.n_steps == j.n_steps
        assert t.step_timestamps_ms() == j.step_timestamps_ms()
    for v, ty in ((2.0, "num"), (2.5, "num"), (0, "status"), (3, "kind"),
                  (True, "bool"), ("x", "str")):
        assert tem._fmt_label(v, ty) == jem._fmt_label(v, ty)
    for q in KIND_QUERIES:
        assert tem.metrics_kind(q).name == jem.metrics_kind(q).name


# ---------------------------------------------------------------------------
# the host engine, every kind
# ---------------------------------------------------------------------------

KIND_QUERIES = [
    "{ } | rate()",
    "{ } | rate() by (resource.service.name)",
    "{ } | count_over_time() by (name, span.region)",
    "{ span.http.status_code >= 400 } | count_over_time() by (kind)",
    "{ } | min_over_time(duration) by (name)",
    "{ } | max_over_time(duration) by (status)",
    "{ } | sum_over_time(duration) by (resource.service.name)",
    "{ } | avg_over_time(duration) by (span.region)",
    "{ } | sum_over_time(span.http.status_code)",
    "{ } | avg_over_time(span.ratio) by (kind)",
    "{ } | quantile_over_time(duration, .5, .9, .99) by (resource.service.name)",
    "{ } | histogram_over_time(duration) by (name)",
    '{ name =~ "op-[12]" && duration > 50ms } | rate() by (name)',
    '{ span.region = "r1" || name = "op-2" } | max_over_time(duration)',
    "{ } >> { status = error } | rate() by (name)",
    '{ span.region != "r0" } | count() > 1 | count_over_time()',
    "{ } | compare({ status = error })",
    "{ status = error } | compare({ span.region = \"r1\" })",
    "{ } | min_over_time(span.ratio) by (resource.deployment)",
    "{ } | max_over_time(traceDuration) by (rootServiceName)",
]


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("query", KIND_QUERIES)
def test_evaluator_matches_reference(blocks, query, batched):
    tv, jv = _views(blocks)
    traw, tfin = _run(tem, tv, query, batched=batched, device="cpu")
    jraw, jfin = _run(jem, jv, query, batched=batched)
    assert_series_equal(smap(traw), smap(jraw), query, "raw")
    assert_series_equal(smap(tfin), smap(jfin), query, "final")
    for t, j in ((traw, jraw), (tfin, jfin)):
        assert sorted(len(s.exemplars) for s in t) == \
            sorted(len(s.exemplars) for s in j)


@pytest.mark.parametrize("query", [KIND_QUERIES[1], KIND_QUERIES[7],
                                   KIND_QUERIES[10], KIND_QUERIES[4]])
def test_clipped_sub_requests_match_reference(blocks, query):
    """Clip bounds restrict observation without changing the step grid
    (the frontend's backend/generator split)."""
    tv, jv = _views(blocks)
    clip = (T0_NS + 125 * 10**9, T0_NS + 611 * 10**9 + 7)
    for win, step in ((WIN, STEP), ((T0_NS - 37 * 10**9,
                                     T0_NS + 1200 * 10**9), 7 * 10**9)):
        t = _run(tem, tv, query, win, step, clip, device="cpu")[1]
        j = _run(jem, jv, query, win, step, clip)[1]
        assert_series_equal(smap(t), smap(j), query)


def test_query_range_convenience_matches_reference(blocks):
    tb, jb = blocks
    q = "{ } | quantile_over_time(duration, .5, .99) by (span.region)"
    treq = tem.QueryRangeRequest(q, *WIN, STEP)
    jreq = jem.QueryRangeRequest(q, *WIN, STEP)
    t = tem.query_range(treq, tfetch.scan_views(tb), device="cpu")
    j = jem.query_range(jreq, jfetch.scan_views(jb))
    assert_series_equal(smap(t), smap(j), q)


@pytest.mark.parametrize("query", [
    "{ } | quantile_over_time(duration, .5, .99) by (resource.service.name)",
    "{ span.http.status_code >= 300 } | quantile_over_time(duration, .9)",
    "{ } | quantile_over_time(span.http.status_code, .5) by (kind)",
])
def test_moments_tier_matches_reference(blocks, query):
    """Under `use_query_tier("moments")` quantile_over_time ships moment
    series: the count column is bit-identical, the sums and bounds within
    f32 order, and the quantiles are the reference solver's on the
    port's rows."""
    tv, jv = _views(blocks)
    with tmom.use_query_tier("moments"), jmom.use_query_tier("moments"):
        assert tmom.query_moments_active()
        traw, tfin = _run(tem, tv, query, device="cpu")
        jraw, jfin = _run(jem, jv, query)
    assert not tmom.query_moments_active()
    a, b = smap(traw), smap(jraw)
    assert set(a) == set(b) and any("__moment" in str(k) for k in a)
    for k in b:
        if ("__moment", "0") in k:
            assert np.array_equal(a[k], b[k]), k
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-4,
                                       err_msg=str(k))
    a, b = smap(tfin), smap(jfin)
    assert set(a) == set(b)
    # the solver is the reference's numpy code: the reference's combiner
    # fed the port's moment rows answers the port's quantiles exactly
    req = jem.QueryRangeRequest(query, *WIN, STEP)
    comb = jem.SeriesCombiner(jem.A.MetricsKind.QUANTILE_OVER_TIME,
                              req.n_steps)
    comb.add_all([jem.TimeSeries(s.labels, s.samples.copy()) for s in traw])
    assert set(smap(comb.final(req))) == set(a)
    for k, v in smap(comb.final(req)).items():
        assert np.array_equal(a[k], v), k
    # the rows differ from the reference's by f32 rounding, and a maxent
    # fit to a few observations can move a quantile across a gap (ROADMAP
    # section 3, "Moments quantiles"), so the quantiles are held through
    # the rows above and the solver identity, not value for value
    assert (tmom.QUERY_K, tmom.QUERY_LO, tmom.QUERY_HI) == \
        (jmom.QUERY_K, jmom.QUERY_LO, jmom.QUERY_HI)


def test_moment_sums_accumulate_in_float64(blocks):
    """The moments grid sums in float64, so the order the card's atomics
    add in moves a sum by ~1e-16 of its size; the maxent solve then keeps
    every q50 and q99 within ROADMAP section 3's rtol 1e-3 ("Moments
    quantiles"; f32 sums moved q99 by percents on the card)."""
    query = ("{ } | quantile_over_time(duration, .5, .99) by "
             "(resource.service.name)")
    tv, _ = _views(blocks)
    req = tem.QueryRangeRequest(query=query, start_ns=WIN[0], end_ns=WIN[1],
                                step_ns=STEP)
    with tmom.use_query_tier("moments"):
        ev = tem.MetricsEvaluator(req, batched=True, device="cpu")
        for v in tv:
            ev.observe(v)
        raw = ev.results()
    assert ev._grids["mmt"].dtype == torch.float64
    rng = np.random.default_rng(7)

    def final(series):
        comb = tem.SeriesCombiner(ev.m.kind, req.n_steps)
        comb.add_all(series)
        return smap(comb.final(req))

    jittered = []
    for s in raw:
        v = np.asarray(s.samples, np.float64)
        if dict(s.labels)["__moment"] not in ("0", "hi", "lo"):
            v = v * (1 + 1e-15 * rng.standard_normal(v.shape))
        jittered.append(tem.TimeSeries(s.labels, v))
    a, b = final(raw), final(jittered)
    assert set(a) == set(b) and a
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-3, atol=0,
                                   err_msg=str(k))


def test_series_combiner_merges_match_reference():
    """Cross-job merges: sums add, min/max fold, moment bounds max-merge
    (`SeriesCombiner._merge_host`), then the final pass."""
    rng = np.random.default_rng(5)
    for kind, query in ((tem.A.MetricsKind.RATE, "{ } | rate()"),
                        (tem.A.MetricsKind.MIN_OVER_TIME,
                         "{ } | min_over_time(duration)"),
                        (tem.A.MetricsKind.MAX_OVER_TIME,
                         "{ } | max_over_time(duration)"),
                        (tem.A.MetricsKind.AVG_OVER_TIME,
                         "{ } | avg_over_time(duration)")):
        t = tem.SeriesCombiner(kind, 5)
        j = jem.SeriesCombiner(jem.A.MetricsKind[kind.name], 5)
        for part in range(3):
            lst = []
            for key in ("a", "b"):
                s = rng.random(5) * (part + 1)
                if kind == tem.A.MetricsKind.MIN_OVER_TIME:
                    s[part] = np.inf
                lst.append((((("k", key),)), s))
                lst.append((((("k", key), ("__meta", "count")),),
                            rng.integers(0, 3, 5).astype(float)))
            t.add_all([tem.TimeSeries(lbl, s.copy()) for lbl, s in lst])
            j.add_all([jem.TimeSeries(lbl, s.copy()) for lbl, s in lst])
        req_t = tem.QueryRangeRequest(query, 0, 5 * STEP, STEP)
        req_j = jem.QueryRangeRequest(query, 0, 5 * STEP, STEP)
        assert_series_equal(smap(t.final(req_t)), smap(j.final(req_j)),
                            query)


def test_avg_with_no_valued_span_answers_zero_series(tmp_path):
    """`avg_over_time(x) by (...)` where no matching span carries `x`:
    the reference's host engine raises KeyError 'sum'
    (`engine_metrics.py:821`); the port answers what the reference's
    fused plane answers — every matched group, zero samples."""
    traces = seeded_traces(29, 80)
    for _, spans in traces:
        for s in spans:
            s["attrs"].pop("ratio", None)
    tb, jb = port_block(tmp_path, traces)
    q = "{ } | avg_over_time(span.ratio) by (kind)"
    tv = [v for v, _ in tfetch.scan_views(tb)]
    jv = [v for v, _ in jfetch.scan_views(jb)]
    with pytest.raises(KeyError, match="sum"):
        _run(jem, jv, q)
    t = smap(_run(tem, tv, q, device="cpu")[0])
    be = JLocal(str(tmp_path / "store"))
    jdev = JDB(be, be, JCfg(device_plane=True))
    jdev.poll_now()
    j = smap(jdev.query_range("t", jem.QueryRangeRequest(q, *WIN, STEP)))
    assert jdev.plane_stats["fused_metric_blocks"] == 1
    assert_series_equal(t, j, q)
    assert len(t) == 2 * 6 and all(not v.any() for v in t.values())


# ---------------------------------------------------------------------------
# exact step boundaries
# ---------------------------------------------------------------------------

def _boundary_traces(start_ns, step_ns, n_steps):
    spans = []
    edges = [start_ns + q * step_ns for q in range(n_steps + 1)]
    ts = sorted({t + d for t in edges for d in (-1, 0, 1)}
                | {start_ns, start_ns + n_steps * step_ns - 1})
    for i, t in enumerate(ts):
        tid = i.to_bytes(16, "big")
        spans.append((tid, [{
            "trace_id": tid, "span_id": (i + 1).to_bytes(8, "big"),
            "name": f"op-{i % 3}", "service": "svc", "kind": 2,
            "start_unix_nano": t, "end_unix_nano": t + 1000 + i}]))
    return spans


@pytest.mark.parametrize("start_ns,step_ns", [
    (10**15, 60 * 10**9),            # float64-exact timestamps (< 2^53)
    (10**15 + 3, 7 * 10**9 + 1),
    (T0_NS, 60 * 10**9),             # realistic: beyond 2^53
    (T0_NS + 333, 30 * 10**9 + 17),
])
def test_exact_step_boundaries(tmp_path, start_ns, step_ns):
    """Spans on start + q·step, one ns either side, and at the window's
    ends land in the same step on the port's plane and the reference's
    (both exact integer floors). The host engines of both packages
    bucket in float64, which is exact below 2^53 ns: there all four
    agree; beyond it the two host engines agree with each other."""
    n_steps = 6
    traces = _boundary_traces(start_ns, step_ns, n_steps)
    tb, jb = port_block(tmp_path, traces, row_group_rows=16)
    be_t, be_j = TLocal(str(tmp_path / "store")), JLocal(str(tmp_path / "store"))
    dbs = {"port_plane": TDB(be_t, be_t, TCfg(), device="cpu"),
           "port_host": TDB(be_t, be_t, TCfg(device_plane=False),
                            device="cpu"),
           "ref_plane": JDB(be_j, be_j, JCfg()),
           "ref_host": JDB(be_j, be_j, JCfg(device_plane=False))}
    q = "{ } | count_over_time() by (name)"
    got = {}
    for name, db in dbs.items():
        db.poll_now()
        mod = tem if name.startswith("port") else jem
        req = mod.QueryRangeRequest(q, start_ns, start_ns + n_steps * step_ns,
                                    step_ns)
        got[name] = smap(db.query_range("t", req))
    assert dbs["port_plane"].plane_stats["fused_metric_blocks"] == 1
    assert dbs["ref_plane"].plane_stats["fused_metric_blocks"] == 1
    assert_series_equal(got["port_plane"], got["ref_plane"], q, "planes")
    assert_series_equal(got["port_host"], got["ref_host"], q, "hosts")
    if start_ns + (n_steps + 1) * step_ns < 2**53:
        assert_series_equal(got["port_plane"], got["port_host"], q,
                            "plane-host")
        total = sum(v.sum() for v in got["port_plane"].values())
        inside = sum(1 for _, s in traces
                     if start_ns <= s[0]["start_unix_nano"]
                     < start_ns + n_steps * step_ns)
        assert total == inside


def test_evaluator_runs_on_cuda_by_default():
    req = tem.QueryRangeRequest("{ } | rate()", *WIN, STEP)
    if torch.cuda.is_available():
        assert tem.MetricsEvaluator(req).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tem.MetricsEvaluator(req)
    assert tem.MetricsEvaluator(req, device="cpu").device.type == "cpu"


def test_grid_scatters_drop_into_the_trash_row():
    """The torch scatters: pad rows aimed at the trash row (index = cap)
    never reach a series row; min/max fold with include_self."""
    g = torch.zeros(3, 4)
    tem._scatter_add2(g, torch.tensor([0, 2, 2, 1]), torch.tensor([1, 3, 3, 0]),
                      torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert g[0, 1] == 1 and g[2, 3] == 5 and g[1, 0] == 4
    m = torch.full((3, 2), float("inf"))
    tem._scatter_min2(m, torch.tensor([0, 0, 2]), torch.tensor([1, 1, 0]),
                      torch.tensor([5.0, 2.0, -1.0]))
    assert m[0, 1] == 2 and torch.isinf(m[1]).all()
    h = torch.zeros(2, 2, 4)
    tem._scatter_add3(h, torch.tensor([0, 1]), torch.tensor([1, 0]),
                      torch.tensor([3, 2]), torch.tensor([1.0, 1.0]))
    assert h[0, 1, 3] == 1 and h[1, 0, 2] == 1 and h.sum() == 2
