"""The port's device read plane (`BlockScanPlane`, `PlaneCache`, the
fused/host split of `TempoDB.query_range`) against the reference.

Mirrors `tests/test_device_scan.py`, `tests/test_read_plane.py`,
`tests/test_plane_arith.py` and the query arms of
`tests/test_plane_fuzz.py` (`:149,175,239,265,299`) at fixed seeds,
757988082 among them. Every block is written by the port's codec and
read by both packages over one `LocalBackend` directory; the port runs
on the CPU (`device="cpu"`), where its torch ops are the same ones the
card runs.

Where the reference checks "zero steady-state recompiles" (`:265`), the
port checks that a warm query adds no new dispatch shape, and that the
grid build makes no boolean selection and no host read
(`TorchDispatchMode`).
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tempo_tpu.backend.local import LocalBackend as JLocal
from tempo_tpu.block import device_scan as jds
from tempo_tpu.db.plane_cache import CachedBlock as JCached
from tempo_tpu.db.tempodb import TempoDB as JDB, TempoDBConfig as JCfg
from tempo_tpu.ops import moments as jmom
from tempo_tpu.traceql import ast as JA
from tempo_tpu.traceql import engine as jengine
from tempo_tpu.traceql import engine_metrics as jem

from tempo_tpu_torch.backend.local import LocalBackend as TLocal
from tempo_tpu_torch.block import device_scan as tds
from tempo_tpu_torch.block.fetch import condition_mask
from tempo_tpu_torch.db.plane_cache import CachedBlock as TCached
from tempo_tpu_torch.db.plane_cache import PlaneCache
from tempo_tpu_torch.db.tempodb import TempoDB as TDB, TempoDBConfig as TCfg
from tempo_tpu_torch.ops import moments as tmom
from tempo_tpu_torch.traceql import ast as TA
from tempo_tpu_torch.traceql import engine as tengine
from tempo_tpu_torch.traceql import engine_metrics as tem

from tests.test_torch_engine_metrics import smap
from tests.test_torch_traceql import port_block, seeded_traces

T0 = 1_700_000_000
COUNT_KINDS = ("rate()", "count_over_time()", "histogram_over_time")


# ---------------------------------------------------------------------------
# worlds: one backend directory, four TempoDBs
# ---------------------------------------------------------------------------

class World:
    def __init__(self, path: str):
        tb, jb = TLocal(path), JLocal(path)
        self.port = TDB(tb, tb, TCfg(), device="cpu")
        self.port_host = TDB(tb, tb, TCfg(device_plane=False), device="cpu")
        self.ref = JDB(jb, jb, JCfg())
        self.ref_host = JDB(jb, jb, JCfg(device_plane=False))
        self.path = path

    def poll(self):
        for db in (self.port, self.port_host, self.ref, self.ref_host):
            db.poll_now()
        return self

    def query(self, db, q, w0, w1, step):
        mod = tem if isinstance(db, TDB) else jem
        return db.query_range("t", mod.QueryRangeRequest(
            query=q, start_ns=int(w0 * 1e9), end_ns=int(w1 * 1e9),
            step_ns=int(step)))


def fuzz_traces(seed: int, n_blocks: int = 2, n_traces: int = 1500):
    """The reference fuzz fixture's blocks, draw for draw
    (`tests/test_plane_fuzz.py:106`)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        traces = []
        for i in range(n_traces):
            tid = rng.bytes(16)
            start = int((T0 + b * 400 + float(rng.random()) * 390) * 1e9)
            attrs = {}
            if rng.random() < 0.8:
                attrs["http.status_code"] = int(rng.integers(200, 501))
            if rng.random() < 0.6:
                attrs["ratio"] = float(rng.choice(
                    [0.5, 1.5, -2.25, 0.0, 3.0, 0.1, 2.0]))
            if rng.random() < 0.7:
                attrs["region"] = f"r{int(rng.integers(0, 3))}"
            traces.append((tid, [{
                "trace_id": tid, "span_id": rng.bytes(8),
                "name": f"op-{int(rng.integers(0, 6))}",
                "service": f"svc-{int(rng.integers(0, 4))}",
                "kind": int(rng.integers(0, 6)),
                "status_code": int(rng.integers(0, 3)),
                "start_unix_nano": start,
                "end_unix_nano": start + int(rng.choice(
                    [1, 50_000_000, 123_000_000, 16_777_216, 16_777_217,
                     int(rng.lognormal(16, 1.5))])),
                "attrs": attrs}]))
        traces.sort(key=lambda t: t[0])
        out.append(traces)
    return out


_WORLDS: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    def get(seed: int) -> World:
        if seed not in _WORLDS:
            path = str(tmp_path_factory.mktemp(f"fuzz{seed}") / "store")
            w = World(path)
            for traces in fuzz_traces(seed):
                w.port.write_block("t", traces, replication_factor=1)
            _WORLDS[seed] = w.poll()
        return _WORLDS[seed]
    yield get
    _WORLDS.clear()


# the reference's random grammar, drawn the reference's way
from tests.test_plane_fuzz import _filter, _metrics  # noqa: E402

SEEDS = (757988082, 171915439, 20261017)
N_CASES = 10


def metric_cases(seed: int, n: int):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        q = _metrics(rng)
        w0 = T0 + rng.choice([0, -120, 37, 333, 701])
        w1 = w0 + rng.choice([900, 301, 1500, 83])
        step = int(rng.choice([30, 60, 300, 7]) * 1e9)
        out.append((q, w0, w1, step))
    return out


# seed 757988082's case 36 is the reference's KeyError 'sum'
PINNED = (757988082, 36)
FUZZ_PARAMS = [(s, c) for s in SEEDS for c in range(N_CASES)] + [PINNED]


def _fallbacks(db) -> dict:
    return {k: v for k, v in db.plane_stats.items() if k.startswith("fallback_")}


def _assert_close(a, b, q, ctx, exact=None):
    assert set(a) == set(b), f"{ctx} {q}: only-a={set(a) - set(b)}, " \
        f"only-b={set(b) - set(a)}"
    if exact is None:
        exact = any(k in q for k in COUNT_KINDS)
    for k in b:
        if exact:
            assert np.array_equal(a[k], b[k]), f"{ctx} {q} {k}"
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-4,
                                       err_msg=f"{ctx} {q} {k}")


@pytest.mark.parametrize("seed,case", FUZZ_PARAMS)
def test_fuzz_query_range_parity(world, seed, case):
    """`tests/test_plane_fuzz.py:149` at a fixed seed and case: the port's
    fused plane against its host engine (the reference's own parity),
    against the reference's fused plane, and its host engine against the
    reference's host engine — or, where that raises KeyError 'sum', against
    the reference's fused plane. Refusals carry the reference's causes."""
    w = world(seed)
    q, w0, w1, step = metric_cases(seed, case + 1)[case]
    ctx = f"seed={seed} case={case}"
    f_port, f_ref = _fallbacks(w.port), _fallbacks(w.ref)
    a = smap(w.query(w.port, q, w0, w1, step))
    b = smap(w.query(w.port_host, q, w0, w1, step))
    c = smap(w.query(w.ref, q, w0, w1, step))
    _assert_close(a, b, q, ctx + " port plane vs port host")
    _assert_close(a, c, q, ctx + " port plane vs reference plane")
    try:
        d = smap(w.query(w.ref_host, q, w0, w1, step))
    except KeyError as e:
        assert "sum" in str(e) and "avg_over_time" in q
        d = c
    _assert_close(b, d, q, ctx + " port host vs reference")
    dp = {k: v - f_port.get(k, 0) for k, v in _fallbacks(w.port).items()}
    dr = {k: v - f_ref.get(k, 0) for k, v in _fallbacks(w.ref).items()}
    assert {k: v for k, v in dp.items() if v} == \
        {k: v for k, v in dr.items() if v}, ctx


def test_pinned_seed_757988082_avg_without_values(world):
    """The query the reference's host engine raises `KeyError: 'sum'` on
    (ROADMAP section 3): the port's host engine answers what the
    reference's fused plane answers."""
    w = world(PINNED[0])
    q, w0, w1, step = metric_cases(PINNED[0], PINNED[1] + 1)[PINNED[1]]
    assert q == ("{ span.ratio = nil && span.region = nil && status = error }"
                 " | avg_over_time(span.ratio) by (kind)")
    with pytest.raises(KeyError, match="sum"):
        w.query(w.ref_host, q, w0, w1, step)
    ref_plane = smap(w.query(w.ref, q, w0, w1, step))
    port_host = smap(w.query(w.port_host, q, w0, w1, step))
    port_plane = smap(w.query(w.port, q, w0, w1, step))
    assert len(ref_plane) == 12
    _assert_close(port_host, ref_plane, q, "host vs reference plane")
    _assert_close(port_plane, ref_plane, q, "plane vs reference plane")


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_search_parity(world, seed):
    """`tests/test_plane_fuzz.py:299`: searches over the device first pass
    against the host engine and the reference."""
    w = world(seed)
    rng = random.Random(seed + 1)
    for case in range(12):
        q = _filter(rng)
        got = [sorted(m.trace_id for m in db.search("t", q, limit=5000))
               for db in (w.port, w.port_host, w.ref)]
        assert got[0] == got[1] == got[2], f"seed={seed} case={case} {q}"


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_moments_tier_parity(world, seed):
    """`tests/test_plane_fuzz.py:175`: under the moments tier the fused
    plane rides the moments grid; count kinds stay bit-identical with the
    host engine, quantiles within the tier's gate, and the moment rows
    match the reference's plane."""
    w = world(seed)
    rng = random.Random(seed + 11)
    pinned = ("{ } | quantile_over_time(duration, .5, .99)"
              " by (resource.service.name)")
    fused0 = w.port.plane_stats["fused_metric_blocks"]
    with tmom.use_query_tier("moments"), jmom.use_query_tier("moments"):
        for case in range(4):
            q = pinned if case == 0 else _metrics(rng)
            w0 = T0 + rng.choice([0, -120, 37, 333])
            w1 = w0 + rng.choice([900, 301, 1500])
            step = int(rng.choice([30, 60, 300]) * 1e9)
            a = smap(w.query(w.port, q, w0, w1, step))
            b = smap(w.query(w.port_host, q, w0, w1, step))
            assert set(a) == set(b), q
            for k in b:
                if "quantile_over_time" in q:
                    np.testing.assert_allclose(a[k], b[k], rtol=5e-2,
                                               atol=1e-6, err_msg=f"{q} {k}")
                elif any(x in q for x in COUNT_KINDS):
                    assert np.array_equal(a[k], b[k]), f"{q} {k}"
                else:
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                               atol=1e-4, err_msg=f"{q} {k}")
            if case == 0:
                # job-level moment rows against the reference's plane
                dev_req = tem.QueryRangeRequest(q, int(w0 * 1e9),
                                                int(w1 * 1e9), step)
                ref_req = jem.QueryRangeRequest(q, int(w0 * 1e9),
                                                int(w1 * 1e9), step)
                assert w.port.plane_stats["fused_metric_blocks"] > fused0
                ra = _raw_rows(w.port, dev_req)
                rb = _raw_rows(w.ref, ref_req)
                _assert_close(ra, rb, q, "moment rows", exact=False)
                for k in rb:
                    if ("__moment", "0") in k:
                        assert np.array_equal(ra[k], rb[k]), k


def _raw_rows(db, req):
    """Job-level series of one query straight off the plane grids."""
    mod = tem if isinstance(db, TDB) else jem
    ev = mod.MetricsEvaluator(req, batched=True,
                              **({"device": "cpu"} if mod is tem else {}))
    out = []
    for m in db.blocks("t"):
        cb = db.planes.get(db.backend_block(m))
        h, cause = cb.plane.metrics_grid(
            ev.m, [c for c in ev.fetch_req.conditions if c.op is not None],
            ev.fetch_req.all_conditions, req.start_ns, req.end_ns,
            req.step_ns, moments=ev._moments)
        assert cause is None
        out.append(mod.grid_series(ev.m, *h.fetch(), moments=ev._moments))
    comb = mod.SeriesCombiner(ev.m.kind, req.n_steps)
    for part in out:
        comb.add_all(part)
    return smap(comb.series.values())


def test_forced_refusal_exercises_batched_fallback(world):
    """`tests/test_plane_fuzz.py:239`: a mixed AND/OR filter refuses with
    `fallback_query_shape` and the batched host fallback answers exactly."""
    w = world(SEEDS[0])
    q = ('{ name = "op-1" && (resource.service.name = "svc-0" '
         '|| span.region = "r1") } | rate() by (name)')
    before = dict(w.port.plane_stats)
    a = smap(w.query(w.port, q, T0, T0 + 900, 60e9))
    b = smap(w.query(w.ref, q, T0, T0 + 900, 60e9))
    assert w.port.plane_stats["fallback_query_shape"] - \
        before.get("fallback_query_shape", 0) == 2
    assert w.port.plane_stats["host_metric_blocks"] - \
        before["host_metric_blocks"] == 2
    _assert_close(a, b, q, "refusal", exact=True)


def test_warm_queries_add_no_dispatch_shapes(world, monkeypatch):
    """`tests/test_plane_fuzz.py:265`: warm repeats of the fused moments
    grid, the batched host fallback and the block mask build no new
    fused function and dispatch no new padded shape."""
    w = world(SEEDS[0])
    qs = ["{ } | quantile_over_time(duration, .5, .99) by "
          "(resource.service.name)",
          '{ name = "op-1" && (resource.service.name = "svc-0" '
          '|| span.region = "r1") } | rate() by (name)',
          "{ } | rate() by (resource.service.name)"]
    shapes = set()
    scatter = tem._sched_scatter

    def recording(fn, *args, kernel="engine_metrics_scatter"):
        shapes.add((kernel,) + tuple(tuple(a.shape) for a in args
                                     if isinstance(a, torch.Tensor)))
        return scatter(fn, *args, kernel=kernel)

    monkeypatch.setattr(tem, "_sched_scatter", recording)

    mq, mreq = tengine.compile_query("{ span.http.status_code >= 400 }",
                                     T0 * 10**9, (T0 + 900) * 10**9)
    preds = [c for c in mreq.conditions if c.op is not None]

    def run():
        for q in qs:
            w.query(w.port, q, T0, T0 + 900, 60e9)
        for m in w.port.blocks("t"):
            w.port.planes.get(w.port.backend_block(m)).plane.mask(
                preds, mreq.all_conditions)

    def built():
        return ([frozenset(w.port.planes.get(w.port.backend_block(m)).plane
                           ._qr_cache) for m in w.port.blocks("t")],
                tds._block_mask_kernel.cache_info().misses, frozenset(shapes))

    with tmom.use_query_tier("moments"):
        for _ in range(2):
            run()
        warm = built()
        assert warm[0][0] and warm[1] and warm[2], \
            "no fused grid, block mask or host dispatch ran"
        for _ in range(3):
            run()
        assert built() == warm


class _Ops(TorchDispatchMode):
    """Records every aten op and flags boolean-mask indexing."""

    def __init__(self):
        super().__init__()
        self.names: list[str] = []
        self.bool_index = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket.__name__)
        self.names.append(name)
        if name in ("index", "index_put", "index_put_"):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in (idx or ())):
                self.bool_index = True
        return func(*args, **(kwargs or {}))


GRID_QUERIES = [
    "{ } | rate() by (resource.service.name)",
    '{ name =~ "op-1." && duration > 20ms } | count_over_time() by (name, kind)',
    "{ span.ratio > 0.5 } | min_over_time(duration) by (span.region)",
    "{ } | max_over_time(duration)",
    "{ } | sum_over_time(span.http.status_code) by (status)",
    "{ } | avg_over_time(span.ratio) by (kind)",
    "{ } | quantile_over_time(duration, .5, .99) by (resource.service.name)",
    "{ } | histogram_over_time(duration)",
]


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("query", GRID_QUERIES)
def test_grid_build_has_no_host_sync_or_boolean_selection(world, query,
                                                          moments):
    """A warm `metrics_grid` launch makes no nonzero, masked_select,
    boolean index or host read (`.item()`); only GridHandle.fetch syncs."""
    w = world(SEEDS[0])
    m = w.port.blocks("t")[0]
    cb = w.port.planes.get(w.port.backend_block(m))
    q, freq = tengine.compile_query(query, T0 * 10**9, (T0 + 900) * 10**9)
    preds = [c for c in freq.conditions if c.op is not None]
    args = (q.metrics, preds, freq.all_conditions, T0 * 10**9,
            (T0 + 900) * 10**9, 60 * 10**9)
    cb.plane.metrics_grid(*args, moments=moments)        # adopt (warm)
    with _Ops() as ops:
        handle, cause = cb.plane.metrics_grid(*args, moments=moments)
    assert cause is None and handle is not None
    bad = {"nonzero", "masked_select", "_local_scalar_dense", "item",
           "nonzero_static", "unique", "_unique2"}
    assert not bad & set(ops.names), sorted(bad & set(ops.names))
    assert not ops.bool_index
    assert "index_add_" in ops.names or "scatter_reduce_" in ops.names


# ---------------------------------------------------------------------------
# the plane against the reference's plane, term by term
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    traces = seeded_traces(41, 400, t0_ns=T0 * 10**9)
    tb, jb = port_block(tmp_path_factory.mktemp("plane"), traces,
                        row_group_rows=128)
    return TCached(tb, device="cpu"), JCached(jb)


MASK_QUERIES = [
    '{ name = "op-1" }',
    '{ name =~ "op-1." && duration > 20ms }',
    '{ name !~ "op-[12]" || span.ratio <= -2.25 }',
    '{ resource.service.name != "svc-0" }',
    "{ span.http.status_code >= 400 && span.http.status_code < 450.5 }",
    "{ span.ratio > 0.5 }",
    "{ span.ratio = 0.0 || span.ratio = -2.25 }",
    "{ span.ratio != 0.1 }",
    "{ span.region = nil }",
    "{ span.nothere != nil }",
    "{ span.err = true }",
    "{ kind = server || status = error }",
    '{ name > "op-3" }',
    '{ span.region = 3 }',
    "{ span.http.status_code = 1.5 }",
    "{ span.http.status_code != 1.5 }",
    "{ duration > 100000h }",
    "{ nestedSetParent = -1 }",
    '{ resource.deployment = "d1" && span.region =~ "r[01]" }',
]


@pytest.mark.parametrize("query", MASK_QUERIES)
def test_block_mask_matches_reference_and_condition_mask(planes, query):
    tc, jc = planes
    for start, end, rgs in ((0, 0, None),
                            (T0 * 10**9 + 100 * 10**9 + 3,
                             T0 * 10**9 + 700 * 10**9, None),
                            (0, 0, [0, 2])):
        _, treq = tengine.compile_query(query, start, end)
        _, jreq = jengine.compile_query(query, start, end)
        tp = [c for c in treq.conditions if c.op is not None]
        jp = [c for c in jreq.conditions if c.op is not None]
        a = tc.plane.mask(tp, treq.all_conditions, (start, end), rgs)
        b = jc.plane.mask(jp, jreq.all_conditions, (start, end), rgs)
        assert (a is None) == (b is None), query
        if a is None:
            continue
        assert np.array_equal(a, b), query
        host = np.concatenate([condition_mask(v, treq) for v in tc.views])
        if rgs is not None:
            keep = np.zeros(tc.plane.n, bool)
            for g in rgs:
                keep[tc.plane.offsets[g]:tc.plane.offsets[g + 1]] = True
            host &= keep
        assert np.array_equal(a, host), query
        split = tc.plane.split_mask(tc.plane.mask_async(
            tp, treq.all_conditions, (start, end), rgs))
        assert [s.tolist() for s in split] == \
            [np.flatnonzero(a[tc.plane.offsets[i]:tc.plane.offsets[i + 1]])
             .tolist() for i in range(len(tc.views))]


def _grid_map(labels, main, cnt, vcnt):
    out = {}
    for i, lbl in enumerate(labels):
        out[str(lbl)] = (main[i], cnt[i], vcnt[i])
    return out


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("query", GRID_QUERIES + [
    '{ span.region = "r1" || name = "op-2" } | rate() by (span.region, name, kind)',
    "{ } | count_over_time() by (span.err)",
])
def test_metrics_grid_matches_reference(planes, query, moments):
    """`metrics_grid` group for group: obs counts and count/bucket grids
    bit-identical, float grids within f32 order. Labels come from each
    package's dictionary, so groups compare by label."""
    tc, jc = planes
    for (w0, w1, step) in ((T0, T0 + 900, 60), (T0 - 37, T0 + 1200, 7),
                           (T0 + 333, T0 + 634, 30)):
        tq, treq = tengine.compile_query(query, w0 * 10**9, w1 * 10**9)
        jq, jreq = jengine.compile_query(query, w0 * 10**9, w1 * 10**9)
        a = tc.plane.metrics_grid(
            tq.metrics, [c for c in treq.conditions if c.op is not None],
            treq.all_conditions, w0 * 10**9, w1 * 10**9, step * 10**9,
            clip_start_ns=(w0 + 11) * 10**9, moments=moments)
        b = jc.plane.metrics_grid(
            jq.metrics, [c for c in jreq.conditions if c.op is not None],
            jreq.all_conditions, w0 * 10**9, w1 * 10**9, step * 10**9,
            clip_start_ns=(w0 + 11) * 10**9, moments=moments)
        assert (a[0] is None) == (b[0] is None) and a[1] == b[1], query
        if a[0] is None:
            continue
        fetched = a[0].fetch()
        # the moments grid's sums are float64 (ROADMAP section 3)
        assert fetched[1].dtype == (np.float64 if moments and "quantile"
                                    in query else np.float32), query
        ga, gb = _grid_map(*fetched), _grid_map(*b[0].fetch())
        assert set(ga) == set(gb)
        exact = not moments and any(k in query for k in (
            "rate()", "count_over_time", "quantile", "histogram", "min_",
            "max_"))
        for k in gb:
            for x, y in zip(ga[k][1:], gb[k][1:]):
                assert np.array_equal(x, y), (query, k)
            if exact:
                assert np.array_equal(ga[k][0], gb[k][0]), (query, k)
            else:
                np.testing.assert_allclose(ga[k][0], gb[k][0], rtol=1e-5,
                                           atol=1e-4, err_msg=f"{query} {k}")


def test_refusal_causes_match_reference(tmp_path):
    """Every `_bail` cause the reference names, on the same shapes."""
    rng = np.random.default_rng(23)
    traces = []
    for i in range(40):
        tid = rng.bytes(16)
        start = int((T0 + i) * 1e9)
        traces.append((tid, [{
            "trace_id": tid, "span_id": rng.bytes(8), "name": f"op-{i % 3}",
            "service": "svc", "kind": 2, "status_code": 0,
            "start_unix_nano": start, "end_unix_nano": start + 1_000_000,
            "attrs": {"x": float("nan") if i % 2 else 1.5, "s": "v",
                      "n": i}}]))
    tb, jb = port_block(tmp_path, traces)
    tc, jc = TCached(tb, device="cpu"), JCached(jb)
    S = 10**9
    shapes = [
        ("{ span.x > 1.0 } | rate()", T0, T0 + 100, 50, "predicate"),
        ("{ } | rate() by (name, kind, status, span.s)", T0, T0 + 100, 50,
         "group"),
        ("{ } | sum_over_time(span.s)", T0, T0 + 100, 50, "value"),
        ("{ } | quantile_over_time(duration, .5) by (span.n)", T0,
         T0 + 400_000, 1, "grid_size"),
        ("{ } | rate()", T0 + 2 * 10**9, T0 + 2 * 10**9 + 10, 1, "window"),
        ("{ } | compare({ })", T0, T0 + 100, 50, "shape"),
        ("{ } | rate()", T0, T0 + 100, 50, None),
    ]
    for q, w0, w1, step, want in shapes:
        for c, mod in ((tc, tengine), (jc, jengine)):
            pq, req = mod.compile_query(q, w0 * S, w1 * S)
            _, cause = c.plane.metrics_grid(
                pq.metrics, [x for x in req.conditions if x.op is not None],
                req.all_conditions, w0 * S, w1 * S, step * S)
            assert cause == want, (q, mod.__name__, cause)
    assert tc.plane.fallback_causes == jc.plane.fallback_causes
    assert tc.plane.last_fallback == jc.plane.last_fallback


def test_plane_literal_helpers_match_reference():
    """`tests/test_plane_arith.py`: the int-literal normalization, the
    order-preserving float encoding and the dictionary terms."""
    for op in (TA.Op.EQ, TA.Op.NEQ, TA.Op.GT, TA.Op.GTE, TA.Op.LT, TA.Op.LTE):
        jop = JA.Op[op.name]
        for v in (0, 1.5, -1.5, 2.0, float("nan"), 1e300, -1e300, 2**62,
                  2**62 - 1, "x", True):
            a, b = tds._int_literal(op, v), jds._int_literal(jop, v)
            assert a[0] == b[0] and a[1:] == b[1:] or \
                (a[0] == "icmp" and a[1].name == b[1].name and a[2] == b[2])
    v = np.array([-np.inf, -1e300, -2.25, -0.0, 0.0, 1e-300, 0.1, 1.5, 3,
                  16777217.5, 1e300, np.inf])
    enc = tds._sortable_f64(v)
    assert np.array_equal(enc, jds._sortable_f64(v))
    assert np.all(np.diff(enc) >= 0) and enc[3] == enc[4]
    d = ["op-1", "op-10", "op-2", "", "None", "ä"]
    for op, lit in ((TA.Op.EQ, "op-1"), (TA.Op.NEQ, "op-2"),
                    (TA.Op.REGEX, "op-1."), (TA.Op.NOT_REGEX, "op-.*"),
                    (TA.Op.GT, "op-1"), (TA.Op.LTE, "op-10"),
                    (TA.Op.REGEX, "["), (TA.Op.EQ, 3)):
        a, b = tds._dict_term(op, lit, d), jds._dict_term(JA.Op[op.name],
                                                          lit, d)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0] and np.array_equal(a[1], b[1])


def test_query_range_grid_back_compat(planes):
    tc, jc = planes
    for group in (None, "name", "service"):
        a = tc.plane.query_range_grid([], True, group, T0 * 10**9,
                                      (T0 + 900) * 10**9, 60 * 10**9)
        b = jc.plane.query_range_grid([], True, group, T0 * 10**9,
                                      (T0 + 900) * 10**9, 60 * 10**9)
        assert dict(zip(map(str, a[0]), a[1].tolist())) == \
            dict(zip(map(str, b[0]), b[1].tolist()))


def test_float_attribute_columns_on_fused_path(tmp_path):
    """`tests/test_read_plane.py:411`: float columns ride the fused plane
    bit-for-bit on boundary literals, never a predicate fallback."""
    rng = np.random.default_rng(21)
    vals = [0.5, 1.5, -2.25, 0.1, 16777217.5, -0.0, 3.0, 1e300]
    traces = []
    for i in range(400):
        tid = rng.bytes(16)
        start = int((T0 + i) * 1e9)
        attrs = {"ratio": vals[i % len(vals)]} if i % 3 != 1 else {}
        traces.append((tid, [{
            "trace_id": tid, "span_id": rng.bytes(8), "name": f"op-{i % 3}",
            "service": f"svc-{i % 2}", "kind": 2, "status_code": 0,
            "start_unix_nano": start, "end_unix_nano": start + 2_000_000,
            "attrs": attrs}]))
    w = World(str(tmp_path / "store"))
    w.port.write_block("t", traces, replication_factor=1)
    w.poll()
    for q in ('{ span.ratio > 0.5 } | rate() by (name)',
              '{ span.ratio >= 1.5 } | count_over_time()',
              '{ span.ratio < 0 } | rate() by (name)',
              '{ span.ratio = -2.25 } | count_over_time()',
              '{ span.ratio = 0.0 } | rate()',
              '{ span.ratio != 0.1 } | rate() by (name)',
              '{ span.ratio = 16777217.5 } | count_over_time()',
              '{ span.ratio > 2 } | rate()'):
        a = smap(w.query(w.port, q, T0, T0 + 500, 100e9))
        b = smap(w.query(w.port_host, q, T0, T0 + 500, 100e9))
        c = smap(w.query(w.ref, q, T0, T0 + 500, 100e9))
        _assert_close(a, b, q, "plane vs host", exact=True)
        _assert_close(a, c, q, "port vs reference", exact=True)
    assert w.port.plane_stats["fused_metric_blocks"] == 8
    assert not _fallbacks(w.port)


def test_many_blocks_bounded_grid_drain(tmp_path):
    """More fused blocks than `MAX_INFLIGHT` (8): the drain path sums as
    the host engine does (`tests/test_read_plane.py:283`)."""
    rng = np.random.default_rng(11)
    w = World(str(tmp_path / "store"))
    for b in range(12):
        traces = []
        for i in range(40):
            tid = rng.bytes(16)
            start = int((T0 + b * 40 + i) * 1e9)
            traces.append((tid, [{
                "trace_id": tid, "span_id": rng.bytes(8),
                "name": f"op-{i % 3}", "service": f"svc-{b % 2}",
                "kind": 2, "status_code": 0, "start_unix_nano": start,
                "end_unix_nano": start + 5_000_000}]))
        w.port.write_block("t", traces, replication_factor=1)
    w.poll()
    q = "{ } | rate() by (resource.service.name)"
    a = smap(w.query(w.port, q, T0, T0 + 600, 60e9))
    b = smap(w.query(w.port_host, q, T0, T0 + 600, 60e9))
    _assert_close(a, b, q, "drain", exact=True)
    assert w.port.plane_stats["fused_metric_blocks"] == 12


def test_plane_cache_lru_budget(tmp_path):
    """`tests/test_read_plane.py:224`: a starvation device budget keeps
    only the last block; stats carry the reference's keys."""
    from tempo_tpu.db.plane_cache import PlaneCache as JPlaneCache

    rng = np.random.default_rng(3)
    w = World(str(tmp_path / "store"))
    for b in range(3):
        traces = []
        for i in range(50):
            tid = rng.bytes(16)
            start = int((T0 + i) * 1e9)
            traces.append((tid, [{
                "trace_id": tid, "span_id": rng.bytes(8),
                "name": f"op-{i % 3}", "service": "svc", "kind": 2,
                "status_code": 0, "start_unix_nano": start,
                "end_unix_nano": start + 1_000_000}]))
        w.port.write_block("t", traces, replication_factor=1)
    w.poll()
    w.port.planes = PlaneCache(budget_bytes=1, max_blocks=64, device="cpu")
    w.query(w.port, "{ } | rate() by (name)", T0, T0 + 100, 50e9)
    stats = w.port.planes.stats()
    assert stats["entries"] == 1 and stats["misses"] >= 3
    assert set(stats) == set(JPlaneCache().stats())
    big = PlaneCache(device="cpu")
    assert (big.budget_bytes, big.max_blocks, big.host_budget_bytes) == \
        (1 << 30, 64, 4 << 30)
    # a plane cache over a mesh (item 13) builds its planes on the
    # mesh's 'data' shards and answers as the single-device cache does
    from tempo_tpu_torch.parallel import make_mesh
    want = w.query(w.port, "{ } | rate() by (name)", T0, T0 + 100, 50e9)
    w.port.planes = PlaneCache(mesh=make_mesh(4, devices=["cpu"] * 4),
                               device="cpu")
    got = w.query(w.port, "{ } | rate() by (name)", T0, T0 + 100, 50e9)
    assert sorted((s.labels, s.samples.tolist()) for s in got) == \
        sorted((s.labels, s.samples.tolist()) for s in want)
    assert all(e.plane.mesh is not None
               for e in w.port.planes._entries.values())


def test_search_rides_the_device_first_pass(world):
    """`tests/test_read_plane.py:195`: a warm search's first pass is the
    plane's mask (device_scans advance, host_scans do not)."""
    w = world(SEEDS[0])
    q = '{ name =~ "op-1." && duration > 20ms }'
    w.port.search("t", q, limit=5)
    cbs = [w.port.planes.get(w.port.backend_block(m))
           for m in w.port.blocks("t")]
    before = [(c.device_scans, c.host_scans) for c in cbs]
    a = [m.to_json() for m in w.port.search("t", q, limit=50)]
    b = [m.to_json() for m in w.ref.search("t", q, limit=50)]
    assert a == b
    after = [(c.device_scans, c.host_scans) for c in cbs]
    assert all(x[0] > y[0] and x[1] == y[1] for x, y in zip(after, before))


def test_per_row_group_offload_raises_until_6b(planes, monkeypatch):
    """`TEMPO_TPU_DEVICE_SCAN=1` runs the reference's opt-in per-row-group
    offload on the view's device (the CPU here): `condition_mask` gives
    the host plane's answer through it (the differential cases are
    `test_offload_mask_*` below). The name is kept from when a plane
    over a mesh raised: since item 13 its mask, run per 'data' shard,
    equals the single-device plane's."""
    tc, _ = planes
    _, req = tengine.compile_query('{ name = "op-1" }')
    host = condition_mask(tc.views[0], req)
    assert host.any()
    monkeypatch.setenv("TEMPO_TPU_DEVICE_SCAN", "1")
    before = tds.device_pred_mask.launches
    np.testing.assert_array_equal(condition_mask(tc.views[0], req), host)
    assert tds.device_pred_mask.launches == before + 1
    assert tc.views[0].meta["device"].type == "cpu"
    from tempo_tpu_torch.parallel import make_mesh
    one = tds.BlockScanPlane(tc.views, device="cpu")
    for n in (2, 8):
        sharded = tds.BlockScanPlane(
            tc.views, mesh=make_mesh(n, devices=["cpu"] * n), device="cpu")
        np.testing.assert_array_equal(
            sharded.mask(req.conditions, req.all_conditions),
            one.mask(req.conditions, req.all_conditions))


# ---------------------------------------------------------------------------
# the per-row-group offload against the reference's jnp masks
# ---------------------------------------------------------------------------

OFFLOAD_QUERIES = [
    '{ name = "op-1" }', '{ name != "op-1" }', '{ name > "op-3" }',
    '{ name >= "op-3" }', '{ name < "op-2" }', '{ name <= "op-2" }',
    '{ name =~ "op-[12]" }', '{ name !~ "op-[12]" }', '{ name =~ "(" }',
    '{ resource.service.name = "svc-2" }',
    '{ resource.service.name !~ "svc-[01]" }',
    '{ .service.name = "svc-1" }', '{ name = "op-9" }',
    "{ duration = 50ms }", "{ duration != 50ms }", "{ duration > 20ms }",
    "{ duration >= 50ms }", "{ duration < 1.5ms }", "{ duration <= 123ms }",
    "{ kind = server || status = error }", "{ status != ok }",
    "{ nestedSetParent = -1 }", "{ nestedSetLeft > 2 }",
    "{ nestedSetRight <= 3 }",
    '{ name =~ "op-1." && duration > 20ms }',
    '{ name !~ "op-[12]" || duration <= 5ms }',
    '{ resource.service.name != "svc-0" && kind != client }',
    # shapes the reference refuses (None → the host plane)
    "{ span.http.status_code >= 400 }", '{ name = 3 }', "{ duration = \"x\" }",
    '{ name = "op-1" && span.region = "r1" }', "{ duration > 1 + 2 }",
]


def _offload_both(tviews, jviews, query, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_DEVICE_SCAN", "1")
    _, tr = tengine.compile_query(query)
    _, jr = jengine.compile_query(query)
    tp = [c for c in tr.conditions if c.op is not None]
    jp = [c for c in jr.conditions if c.op is not None]
    out = []
    for tv, jv in zip(tviews, jviews):
        a = tds.device_pred_mask(tv, tp, tr.all_conditions)
        b = jds.device_pred_mask(jv, jp, jr.all_conditions)
        assert (a is None) == (b is None), query
        if a is not None:
            assert a.dtype == b.dtype == bool
            np.testing.assert_array_equal(a, b, err_msg=query)
        out.append(a)
    return out


@pytest.mark.parametrize("query", OFFLOAD_QUERIES)
def test_offload_mask_matches_reference(planes, query, monkeypatch):
    tc, jc = planes
    masks = _offload_both(tc.views, jc.views, query, monkeypatch)
    if any(m is not None for m in masks) and "=~ \"(\"" not in query:
        assert all(m is not None for m in masks)
    monkeypatch.delenv("TEMPO_TPU_DEVICE_SCAN")
    assert tds.device_pred_mask(tc.views[0], [object()], True) is None


@pytest.fixture(scope="module")
def edge_views(tmp_path_factory):
    """Durations on the float32 edges of the literals (20 ms, 2^24 ns and
    1.5 ms): values one ns either side of them round to the same float32
    as the literal, so the reference's float32 compare and the exact host
    compare part there."""
    rng = np.random.default_rng(12)
    edges = []
    for lit in (20_000_000, 1 << 24, 1_500_000):
        edges += [lit + d for d in range(-3, 4)]
    traces = []
    for i, dur in enumerate(edges * 4):
        tid = bytes([i // 256, i % 256]) + bytes(14)
        start = T0 * 10**9 + i * 10**6
        traces.append((tid, [{
            "trace_id": tid, "span_id": rng.bytes(8),
            "name": f"op-{i % 4}", "service": f"svc-{i % 3}",
            "start_unix_nano": start, "end_unix_nano": start + dur,
            "kind": i % 6, "status_code": i % 3}]))
    traces.sort(key=lambda t: t[0])
    tb, jb = port_block(tmp_path_factory.mktemp("edges"), traces,
                        row_group_rows=32)
    tviews = [v for v, _ in tfetch_scan(tb)]
    jviews = [v for v, _ in jfetch_scan(jb)]
    return tviews, jviews


def tfetch_scan(tb):
    from tempo_tpu_torch.block.fetch import scan_views

    return scan_views(tb, device="cpu")


def jfetch_scan(jb):
    from tempo_tpu.block.fetch import scan_views

    return scan_views(jb)


@pytest.mark.parametrize("query", [
    "{ duration > 20ms }", "{ duration >= 20ms }", "{ duration = 20ms }",
    "{ duration != 20ms }", "{ duration < 20ms }", "{ duration <= 20ms }",
    "{ duration > 16777216ns }", "{ duration = 16777217ns }",
    "{ duration < 1.5ms || duration > 20.000001ms }",
    '{ duration >= 1500001ns && name != "op-1" }',
])
def test_offload_mask_float32_edges_match_reference(edge_views, query,
                                                     monkeypatch):
    tviews, jviews = edge_views
    masks = _offload_both(tviews, jviews, query, monkeypatch)
    assert all(m is not None for m in masks)
    monkeypatch.delenv("TEMPO_TPU_DEVICE_SCAN")
    _, tr = tengine.compile_query(query)
    exact = np.concatenate([condition_mask(v, tr) for v in tviews])
    f32 = np.concatenate(masks)
    if query in ("{ duration = 20ms }", "{ duration > 16777216ns }"):
        assert (exact != f32).any()   # the edges do part the two planes


def test_offload_caches_device_columns_on_the_view(edge_views, monkeypatch):
    tviews, _ = edge_views
    monkeypatch.setenv("TEMPO_TPU_DEVICE_SCAN", "1")
    _, tr = tengine.compile_query('{ name = "op-1" && duration > 20ms }')
    preds = [c for c in tr.conditions if c.op is not None]
    view = tviews[0]
    tds.device_pred_mask(view, preds, True)
    cached = dict(view.meta["_dev_arrays"])
    assert set(cached) == {"dict:name", "num:duration"}
    assert cached["dict:name"].dtype == torch.int32
    assert cached["num:duration"].dtype == torch.float32
    tds.device_pred_mask(view, preds, True)
    assert all(view.meta["_dev_arrays"][k] is cached[k] for k in cached)
