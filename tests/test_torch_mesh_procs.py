"""The port's mesh across processes, against the reference's single device.

A two-rank gloo group on the CPU: each test forks two processes (the
`fork` start method: a rank is up in milliseconds, where `spawn` pays a
fresh interpreter and torch import each), which meet through a
`FileStore` under the test's `tmp_path` (xdist workers never share a
port) with a group timeout of a few seconds. Each rank enlists two
logical CPU devices, so `make_multihost_mesh(series_shards=2)` gives 2
data x 2 series shards, rank r owning data row r. The ranks run only the
port; the reference runs in the test's own process, on one device (its
own mesh steps fail under jax 0.9.0 where the port's comparisons need a
mesh, and a single device is what they must equal).

Counts, histogram buckets, DDSketch rows and HLL registers are exact;
float sums within rtol 1e-5 (the data-axis reduce changes their
association, as the reference's psum does); every rank ends with the
same state.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import time
import traceback

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")
SUM_RTOL = 1e-5
GROUP_TIMEOUT_S = 4.0


def _rank_main(rank, world, store, conn, fn, timeout_s):
    """A forked rank: join the gloo group, run fn(rank), send back
    ("ok", result) or ("err", traceback), and leave without running the
    parent's exit handlers."""
    try:
        torch.set_num_threads(1)
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        out = ("ok", fn(rank))
    except Exception:  # noqa: BLE001 — reported to the parent
        out = ("err", f"rank {rank}: {traceback.format_exc()}")
    try:
        conn.send(out)
    finally:
        os._exit(0)


def run_ranks(tmp_path, fn, world: int = 2,
              timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """fn(rank) in `world` forked ranks of a gloo group; their results in
    rank order. A rank that raises, or that has not answered within
    twice the group timeout, fails the caller; every rank is reaped."""
    ctx = multiprocessing.get_context("fork")
    store = tmp_path / "store"
    ranks = []
    for r in range(world):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main,
                        args=(r, world, str(store), send, fn, timeout_s))
        p.start()
        send.close()
        ranks.append((p, recv))
    deadline = time.monotonic() + 2 * timeout_s
    got, errors = [], []
    try:
        for r, (_p, recv) in enumerate(ranks):
            if not recv.poll(max(deadline - time.monotonic(), 0.0)):
                errors.append(f"rank {r}: no answer within "
                              f"{2 * timeout_s} s")
                got.append(None)
                continue
            try:
                status, val = recv.recv()
            except EOFError:
                errors.append(f"rank {r}: exited without an answer")
                got.append(None)
                continue
            if status != "ok":
                errors.append(val)
            got.append(val)
    finally:
        for p, _ in ranks:
            p.join(1.0)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return got


def _multihost_mesh(series_shards: int = 2, local: int = 2):
    from tempo_tpu_torch.parallel import make_multihost_mesh

    return make_multihost_mesh(series_shards=series_shards,
                               devices=[CPU] * local)


def count_k1(calls: list):
    """Count K1 dispatches (`ops.pages.fused_step`) in this process."""
    from tempo_tpu_torch.ops import pages as op

    real = op.fused_step

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    op.fused_step = counted


# -- mesh construction -------------------------------------------------------

@pytest.mark.parametrize("local,series,shape", [(2, 2, (2, 2)),
                                                (2, 1, (4, 1))])
def test_multihost_mesh_spans_the_ranks(tmp_path, local, series, shape):
    """`make_multihost_mesh` in a 2-rank group: 'data' spans the ranks
    (world x local / series rows), 'series' stays within each; rank r
    owns its rows, its home devices are its own, and the mesh keeps the
    group."""
    from tempo_tpu_torch.parallel.mesh import make_mesh, mesh_fingerprint

    def fn(rank):
        m = _multihost_mesh(series, local)
        flat = make_mesh(series_shards=series, devices=[CPU] * (2 * local))
        return (m.devices.shape, m.owners, m.local_rows, m.rank,
                m.group is not None, [str(d) for d in m.homes],
                m.axis_names,
                mesh_fingerprint(m) != mesh_fingerprint(flat)
                and flat.devices.shape == m.devices.shape)

    per = local // series
    for rank, got in enumerate(run_ranks(tmp_path, fn)):
        assert got[0] == shape
        assert got[1] == [0] * per + [1] * per
        assert got[2] == list(range(rank * per, (rank + 1) * per))
        assert got[3] == rank and got[4]
        assert got[5] == ["cpu"] * series
        assert got[6] == ("data", "series") and got[7]


# -- the steps across ranks ------------------------------------------------------

def _spans(seed: int, n: int, n_series: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, n_series, n).astype(np.int32),
            rng.lognormal(-3, 1.0, n).astype(np.float32),
            rng.integers(100, 1000, n).astype(np.float32),
            rng.choice([1.0, 2.0], n).astype(np.float32))


def _assert_planes(got, want, sum_roles, ctx=""):
    for r, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if r in sum_roles:
            np.testing.assert_allclose(a, b, rtol=SUM_RTOL, atol=1e-6,
                                       err_msg=f"{ctx} role {r}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} role {r}")


def test_sharded_spanmetrics_step_across_ranks(tmp_path):
    """`sharded_spanmetrics_step` on 2 data x 2 series shards across two
    ranks, two iterations, against the reference's step on one device:
    calls, buckets, counts and DDSketch rows exact, the latency and size
    sums within rtol 1e-5; both ranks hold the same state; K1 launched
    once per series shard of the rank per iteration."""
    import jax.numpy as jnp

    from tempo_tpu.ops import sketches as jsk
    from tempo_tpu.parallel import make_mesh as jmake
    from tempo_tpu.parallel import sharded_spanmetrics_step as jstep

    edges = (0.002, 0.032, 0.512, 8.192)
    gamma, nb = jsk.dd_params(0.01, 1e-9, 1e6)
    n_series, n = 32, 256
    shapes = ((n_series,), (n_series, len(edges) + 1), (n_series,),
              (n_series,), (n_series,), (n_series, nb), (n_series,))
    batches = [_spans(s, n, n_series) for s in (1, 2)]

    def fn(rank):
        from tempo_tpu_torch.parallel import sharded_spanmetrics_step

        k1: list = []
        count_k1(k1)
        step = sharded_spanmetrics_step(_multihost_mesh(), edges, gamma,
                                        1e-9)
        st = tuple(torch.zeros(s) for s in shapes)
        for b in batches:
            st = step(*st, *b)
        return [t.numpy() for t in st], len(k1)

    js = jstep(jmake(1, series_shards=1), edges, gamma, 1e-9)
    jst = tuple(jnp.zeros(s, jnp.float32) for s in shapes)
    for b in batches:
        jst = js(*jst, *(jnp.asarray(x) for x in b))
    out = run_ranks(tmp_path, fn)
    for rank, (st, launches) in enumerate(out):
        assert launches == 2 * len(batches)
        _assert_planes(st, jst, (2, 4), f"rank {rank}")
        for a, b in zip(st, out[0][0]):
            np.testing.assert_array_equal(a, b)
    assert float(out[0][0][0].sum()) == float(np.asarray(jst[0]).sum()) > 0


def test_sharded_serving_step_with_moments_across_ranks(tmp_path):
    """`sharded_serving_step` with the DDSketch and moments planes on 2
    data x 2 series shards across two ranks, against the reference's
    dense step (`_fused_update_impl`) on one device: counts, buckets and
    DDSketch rows exact, the moments bounds (maxima of f32 logs) within
    an ulp, the float sums and moment sums within rtol 1e-5."""
    import jax.numpy as jnp

    from tempo_tpu.generator.processors import spanmetrics as jspm
    from tempo_tpu.ops import moments as jmom
    from tempo_tpu.ops import sketches as jsk
    from tempo_tpu.registry import metrics as jrm

    edges = (0.002, 0.032, 0.512, 8.192)
    cap, n, mk = 64, 512, 12
    gamma, nb = jsk.dd_params(0.01, 1e-9, 1e6)
    k, lo, hi = jmom.moments_params(mk, 1e-9, 1e6)
    b = _spans(3, n, cap)
    widths = (None, len(edges) + 1, None, None, None, nb, None, k + 3)

    def fn(rank):
        from tempo_tpu_torch.parallel import sharded_serving_step

        step = sharded_serving_step(_multihost_mesh(), edges, gamma, 1e-9,
                                    cap, cap, mom_rows=cap,
                                    mom_meta=(k, lo, hi))
        st = [torch.zeros((cap,) if w is None else (cap, w))
              for w in widths]
        return [t.numpy() for t in step(*st, *b)]

    calls, lat, sizes = (jrm.counter_init(cap), jrm.histogram_init(cap, edges),
                         jrm.counter_init(cap))
    dd = jsk.dd_init(cap, 0.01, 1e-9, 1e6)
    mom = jmom.moments_init(cap, mk, 1e-9, 1e6)
    calls, lat, sizes, dd, mom = jspm._fused_update_impl(
        calls, lat, sizes, dd, mom, *(jnp.asarray(x) for x in b))
    want = (calls.values, lat.bucket_counts, lat.sums, lat.counts,
            sizes.values, dd.counts, dd.zeros, mom.data)
    out = run_ranks(tmp_path, fn)
    for rank, st in enumerate(out):
        _assert_planes(st[:7], want[:7], (2, 4), f"rank {rank}")
        got_m, want_m = st[7], np.asarray(want[7])
        np.testing.assert_array_equal(got_m[:, 0], want_m[:, 0])
        # the bounds are maxima of f32 logs: an ulp from the reference's
        np.testing.assert_allclose(got_m[:, k + 1:], want_m[:, k + 1:],
                                   rtol=1e-6)
        np.testing.assert_allclose(got_m[:, 1:k + 1], want_m[:, 1:k + 1],
                                   rtol=SUM_RTOL, atol=1e-4)
        for a, c in zip(st, out[0]):
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("n_buckets", [0, 64])
def test_sharded_query_range_step_across_ranks(tmp_path, n_buckets):
    """`sharded_query_range_step` on 2 data x 2 series shards across two
    ranks, iterated twice, against the reference's on one device: the
    histogram plane's counts exact, the value grid within rtol 1e-5."""
    import jax.numpy as jnp

    from tempo_tpu.parallel import make_mesh as jmake
    from tempo_tpu.parallel import sharded_query_range_step as jstep

    n_series, n_steps, n_spans = 32, 4, 256
    rng = np.random.default_rng(n_buckets + 5)
    cols = (rng.integers(0, n_series, n_spans).astype(np.int32),
            rng.integers(0, n_steps, n_spans).astype(np.int32),
            (rng.lognormal(17, 1.5, n_spans) if n_buckets
             else rng.random(n_spans)).astype(np.float32))
    shape = (n_series, n_steps) + ((n_buckets,) if n_buckets else ())

    def fn(rank):
        from tempo_tpu_torch.parallel import sharded_query_range_step

        step = sharded_query_range_step(_multihost_mesh(),
                                        n_buckets=n_buckets)
        g = torch.zeros(shape)
        for _ in range(2):
            g = step(g, *cols)
        return g.numpy()

    js = jstep(jmake(1, series_shards=1), n_buckets=n_buckets)
    jg = jnp.zeros(shape, jnp.float32)
    for _ in range(2):
        jg = js(jg, *(jnp.asarray(x) for x in cols))
    for g in run_ranks(tmp_path, fn):
        if n_buckets:
            np.testing.assert_array_equal(g, np.asarray(jg))
        else:
            np.testing.assert_allclose(g, np.asarray(jg), rtol=SUM_RTOL)


def test_merge_sketch_states_over_the_group(tmp_path):
    """`merge_sketch_states(group=)`: each rank merges its two shards'
    HLL sketches and counts, then the group reduces them; every rank's
    registers equal the reference's HLL that took every shard's items,
    bit for bit, and the counts their exact sum."""
    import jax.numpy as jnp

    from tempo_tpu.ops import sketches as jsk

    n_series, prec, n = 8, 10, 400
    rng = np.random.default_rng(21)
    shards = [(rng.integers(0, n_series, n).astype(np.int32),
               rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
               rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))
              for _ in range(4)]

    def fn(rank):
        from tempo_tpu_torch.ops import sketches as tsk
        from tempo_tpu_torch.parallel import merge_sketch_states

        states = []
        for sid, h1, h2 in shards[2 * rank:2 * rank + 2]:
            hll = tsk.hll_update(tsk.hll_init(n_series, prec, device="cpu"),
                                 sid, h1, h2)
            counts = torch.from_numpy(np.bincount(
                sid, minlength=n_series).astype(np.float32))
            states.append({"hll": hll, "counts": counts})
        got = merge_sketch_states(states,
                                  group=torch.distributed.group.WORLD)
        return got["hll"].registers.numpy(), got["counts"].numpy()

    ref = jsk.hll_init(n_series, prec)
    for sid, h1, h2 in shards:
        ref = jsk.hll_update(ref, jnp.asarray(sid), jnp.asarray(h1),
                             jnp.asarray(h2))
    want_counts = sum(np.bincount(s[0], minlength=n_series)
                      for s in shards).astype(np.float32)
    for regs, counts in run_ranks(tmp_path, fn):
        np.testing.assert_array_equal(regs, np.asarray(ref.registers))
        np.testing.assert_array_equal(counts, want_counts)


def test_rank_that_raises_fails_instead_of_hanging(tmp_path):
    """A rank that raises before the collective fails the run within the
    group's timeout; its peer, blocked in the reduce, is reaped."""
    def fn(rank):
        from tempo_tpu_torch.parallel import sharded_query_range_step

        if rank == 1:
            raise RuntimeError("rank 1 gives up")
        step = sharded_query_range_step(_multihost_mesh())
        return step(torch.zeros((8, 2)), np.zeros(8, np.int32),
                    np.zeros(8, np.int32), np.ones(8, np.float32)).numpy()

    t = time.monotonic()
    with pytest.raises(AssertionError, match="rank 1 gives up"):
        run_ranks(tmp_path, fn, timeout_s=2.0)
    assert time.monotonic() - t < 6.0
