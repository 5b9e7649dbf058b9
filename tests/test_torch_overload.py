"""The main path's overload controls and remote write's retries, the port
against the reference.

Mirrors `tests/test_sampling.py:161-355` on the CPU:

- the scheduler's keep fraction (smoothing ramps and snaps back, the
  fraction tracks a forced pressure) and in-flight jobs counting toward
  the control pressure (step 1 of the main path, `sched/scheduler.py`);
- the sampler's floor and opt-out and its idle-tenant sweep
  (`distributor/sampler.py`);
- the rate limiter under tenant churn: the bucket map stays bounded, a
  drained bucket is never evicted to launder a fresh burst, and an
  evicted idle bucket admits what a kept one would
  (`distributor/limiter.py:30-106`);
- remote write (step 6): `Retry-After` on 429 and 5xx, full-jitter
  backoff from a seeded generator in both packages, 4xx failing fast,
  and the `tempo_remote_write_*` families
  (`generator/remote_write.py:254-300`), against the conftest's
  package-agnostic `faulty_remote_write` endpoint.

Each scenario runs on both packages with the same inputs and the same
fake clock, and the outcomes (fractions, admit decisions, bucket sets,
sleeps, request counts, counters) are compared exactly. The control law
itself (`test_torch_sched.py:102`) and the 429 ladder
(`test_torch_distributor.py:653`) are held elsewhere.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from tests.test_torch_frontend import mod

from tempo_tpu_torch import sched as tsched

SIDES = ("port", "ref")


@pytest.fixture(autouse=True)
def _port_sched():
    tsched.reset()
    yield
    tsched.reset()


def pressure_scheduler(side, pressure=0.0, cfg=None):
    """Either package's scheduler with its live-ingest fill forced to
    `pressure` (the port twin of `tests/conftest.py`'s
    `make_pressure_scheduler`); no worker."""
    sm = mod(side, "sched")

    class _Pressure(sm.DeviceScheduler):
        def __init__(self):
            super().__init__(cfg or sm.SchedConfig(sampling_smoothing_s=0.0,
                                                   pipeline_depth=0),
                             start_worker=False)
            self.forced_pressure = pressure

        def depth(self, prio):
            if prio == sm.PRIO_INGEST:
                return int(round(self.forced_pressure * self._limit(prio)))
            return super().depth(prio)

    return _Pressure()


@pytest.fixture
def forced_sched_saturation():
    """Install a forced-pressure scheduler as each package's process
    scheduler: `arm(side, pressure, cfg)` returns it (the port twin of
    the conftest fixture of that name)."""
    cms = []

    def arm(side, pressure=1.0, cfg=None):
        sc = pressure_scheduler(side, pressure, cfg)
        cm = mod(side, "sched").use(sc)
        cm.__enter__()
        cms.append(cm)
        return sc

    yield arm
    for cm in reversed(cms):
        cm.__exit__(None, None, None)


def test_scheduler_keep_fraction_tracks_pressure(forced_sched_saturation):
    """Off at no pressure, in the sampling band at 0.8, and snapping fully
    off again; the same fractions on both sides."""
    got = {}
    for side in SIDES:
        sm = mod(side, "sched")
        sc = forced_sched_saturation(side, 0.0)
        out = [sc.keep_fraction(), sm.ingest_keep_fraction()]
        sc.forced_pressure = 0.8
        out.append(sm.ingest_keep_fraction())
        sc.forced_pressure = 0.0
        out.append(sm.ingest_keep_fraction())
        got[side] = out
    assert got["port"] == got["ref"]
    assert got["port"][:2] == [1.0, 1.0] and got["port"][3] == 1.0
    assert 0.05 <= got["port"][2] < 1.0


def test_keep_fraction_smoothing_ramps_and_snaps_back(
        forced_sched_saturation):
    """With 1 s smoothing the fraction ramps toward the floor under full
    pressure (not a step), settles at the floor, and recovers exactly;
    the trajectory on a fake clock equals the reference's step by step."""
    got = {}
    for side in SIDES:
        sm = mod(side, "sched")
        t = [0.0]
        sc = forced_sched_saturation(
            side, 0.0, sm.SchedConfig(sampling_smoothing_s=1.0))
        sc.now = lambda: t[0]
        out = [sc.keep_fraction()]
        sc.forced_pressure = 1.0
        for dt in (0.1, 0.2, 0.4, 0.8, 30.0):
            t[0] += dt
            out.append(sc.keep_fraction())
        sc.forced_pressure = 0.0
        t[0] += 30.0
        out.append(sc.keep_fraction())
        got[side] = (out, sc.cfg.sampling_min_fraction)
    assert got["port"] == got["ref"]
    out, floor = got["port"]
    assert out[0] == 1.0 and out[1] > floor
    assert out[-2] == pytest.approx(floor, abs=1e-6) and out[-1] == 1.0
    assert all(a >= b for a, b in zip(out[1:-1], out[2:-1]))


def test_control_pressure_includes_inflight_jobs():
    """Popped jobs still in flight count toward the control pressure: 0.4
    with 4 of 10 queued, 0.4 during their dispatch, 0 after; on both."""
    got = {}
    for side in SIDES:
        sm = mod(side, "sched")
        sc = sm.DeviceScheduler(sm.SchedConfig(max_queue_ingest=10,
                                               sampling_smoothing_s=0.0),
                                start_worker=False)
        mid = []
        for _ in range(4):
            sc.submit_rows("k", "mk", (np.zeros(2, np.float32),), 2,
                           lambda arr, sc=sc: mid.append(
                               sc.control_pressure()))
        before = sc.control_pressure()
        sc.drain_once(force=True)
        got[side] = (before, mid[0], sc.control_pressure())
    assert got["port"] == got["ref"]
    assert got["port"][0] == pytest.approx(0.4)
    assert got["port"][1] == pytest.approx(0.4) and got["port"][2] == 0.0


def _recs(side, n, seed=0):
    native = mod(side, "native")
    rng = np.random.default_rng(seed)
    recs = np.zeros(n, native.STAGE_REC_DTYPE)
    recs["trace_id"] = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    recs["tid_len"] = 16
    recs["start_ns"] = 1_000_000_000
    recs["end_ns"] = 1_000_000_000 + 1_000_000
    return recs


def test_effective_fraction_floor_and_optout():
    """The tenant's floor lifts the fraction, `enabled: false` opts out,
    no pressure means 1.0; on both."""
    got = {}
    for side in SIDES:
        Sampler = mod(side, "distributor.sampler").SpanSampler
        Limits = mod(side, "overrides.limits").SamplingLimits

        def pol(**kw):
            return Limits(**{"tail_min_spans": 1 << 30, **kw})

        s = Sampler(fraction_source=lambda: 0.1)
        s2 = Sampler(fraction_source=lambda: 1.0)
        got[side] = [s.effective_fraction("t", pol(floor=0.4)),
                     s.effective_fraction("t", pol(floor=0.0)),
                     s.effective_fraction("t", pol(enabled=False)),
                     s2.effective_fraction("t", pol(floor=0.4))]
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0.4 and got["port"][1] == pytest.approx(0.1)
    assert got["port"][2:] == [1.0, 1.0]


def test_sampler_idle_tenant_eviction():
    """50 tenants observed, the clock past the idle TTL, one fresh tenant:
    the sweep leaves only it, on both."""
    got = {}
    for side in SIDES:
        Sampler = mod(side, "distributor.sampler").SpanSampler
        t = [0.0]
        s = Sampler(now=lambda: t[0])
        for i in range(50):
            s.observe(f"ten-{i}", _recs(side, 4, seed=i))
        n0 = s.tenants()
        t[0] = Sampler.IDLE_TTL_S + 1.0
        s._next_sweep = 0.0
        s.observe("fresh", _recs(side, 4))
        got[side] = (n0, s.tenants(), Sampler.IDLE_TTL_S)
    assert got["port"] == got["ref"] and got["port"][:2] == (50, 1)


def _limiter(side, **kw):
    return mod(side, "distributor.limiter").RateLimiter(**kw)


def test_rate_limiter_buckets_bounded_under_tenant_churn():
    """5,000 ephemeral tenants against a 100-bucket cap: the map stays
    within the cap, then the TTL sweep leaves only the active tenant;
    the same decisions and bucket sets on both."""
    got = {}
    for side in SIDES:
        t = [0.0]
        rl = _limiter(side, now=lambda: t[0], idle_ttl_s=60.0,
                      max_buckets=100)
        admits, sizes = [], []
        for i in range(5000):
            t[0] += 0.001
            admits.append(rl.allow(f"churn-{i}", 10, 1000.0, 1000.0))
            sizes.append(len(rl._buckets))
        t[0] += 30.0
        rl.allow("keepalive", 10, 1000.0, 1000.0)
        t[0] += 45.0
        rl._next_sweep = 0.0
        rl.allow("keepalive", 10, 1000.0, 1000.0)
        got[side] = (admits, sizes, sorted(rl._buckets))
    assert got["port"] == got["ref"]
    assert max(got["port"][1]) <= 101
    assert got["port"][2] == ["keepalive"]


def test_rate_limiter_churn_cannot_launder_spent_burst():
    """A tenant that drained its burst at a trickle refill survives every
    trim under fast-refill churn, so it stays refused; on both."""
    got = {}
    for side in SIDES:
        t = [0.0]
        rl = _limiter(side, now=lambda: t[0], idle_ttl_s=1e6, max_buckets=50)
        first = rl.allow("A", 1000, 1.0, 1000.0)
        for i in range(500):
            t[0] += 0.01
            rl.allow(f"churn-{i}", 1, 1e6, 1000.0)
        t[0] += 1.0
        got[side] = (first, "A" in rl._buckets,
                     rl.allow("A", 1000, 1.0, 1000.0), sorted(rl._buckets))
    assert got["port"] == got["ref"]
    assert got["port"][:3] == (True, True, False)


def test_rate_limiter_eviction_is_lossless():
    """An evicted idle bucket is recreated full: it admits exactly what a
    kept bucket admits; on both."""
    got = {}
    for side in SIDES:
        t = [0.0]
        kept = _limiter(side, now=lambda: t[0], idle_ttl_s=1e9)
        evicted = _limiter(side, now=lambda: t[0], idle_ttl_s=10.0)
        out = [rl.allow("t", 900, 100.0, 1000.0) for rl in (kept, evicted)]
        t[0] = 20.0
        evicted._next_sweep = 0.0
        evicted.allow("other", 1, 100.0, 1000.0)
        out.append("t" in evicted._buckets)
        for rl in (kept, evicted):
            out += [rl.allow("t", 1000, 100.0, 1000.0),
                    rl.allow("t", 500, 100.0, 1000.0)]
        got[side] = out
    assert got["port"] == got["ref"]
    assert got["port"] == [True, True, False, True, False, True, False]


# -- remote write's retries ---------------------------------------------------


def _send(side, srv, retries, backoff_s, rng=None, sleeps=None):
    rw = mod(side, "generator.remote_write")
    Sample = mod(side, "registry.series").Sample
    c = rw.RemoteWriteClient(rw.RemoteWriteConfig(
        url=srv.url, retries=retries, backoff_s=backoff_s))
    if rng is not None:
        c._rng = rng
    c._sleep = (sleeps.append if sleeps is not None else lambda s: None)
    ok = c.send([Sample(name="m", labels=(("a", "b"),), value=1.0, ts_ms=0)])
    return ok, c.retried_sends, c.failed_sends


@pytest.mark.parametrize("status", [429, 503])
def test_remote_write_honors_retry_after(faulty_remote_write, status):
    """A 429 or 5xx with `Retry-After: 0.05`: one retry whose sleep is at
    least the advertised delay; the same sleeps (seeded jitter) and
    counters on both sides."""
    srv = faulty_remote_write
    got = {}
    for side in SIDES:
        srv.requests.clear()
        srv.script.append((status, {"Retry-After": "0.05"}))
        sleeps = []
        res = _send(side, srv, 2, 0.01, random.Random(7), sleeps)
        got[side] = (res, sleeps, len(srv.requests))
    assert got["port"] == got["ref"]
    (ok, retried, failed), sleeps, n_req = got["port"]
    assert ok and retried == 1 and failed == 0 and n_req == 2
    assert sleeps and sleeps[0] >= 0.05


def test_remote_write_full_jitter_backoff(faulty_remote_write):
    """Three 503s without `Retry-After`: sleeps drawn U(0, base * 2^i)
    from `random.Random(42)` in each package, equal draw for draw, under
    the exponential envelope and not all equal."""
    srv = faulty_remote_write
    got = {}
    for side in SIDES:
        srv.requests.clear()
        for _ in range(3):
            srv.script.append((503, {}))
        sleeps = []
        res = _send(side, srv, 3, 0.5, random.Random(42), sleeps)
        got[side] = (res, sleeps)
    assert got["port"] == got["ref"]
    (ok, _, _), sleeps = got["port"]
    assert ok and len(sleeps) == 3
    for i, s in enumerate(sleeps):
        assert 0.0 <= s <= 0.5 * (2 ** i)
    assert len({round(s, 6) for s in sleeps}) > 1


def test_remote_write_non_retryable_4xx_fails_fast(faulty_remote_write):
    """A 400 fails at once: one request, no retry, one failed send; on
    both."""
    srv = faulty_remote_write
    got = {}
    for side in SIDES:
        srv.requests.clear()
        srv.script.append((400, {}))
        got[side] = (_send(side, srv, 3, 0.01), len(srv.requests))
    assert got["port"] == got["ref"] == ((False, 0, 1), 1)


def test_remote_write_obs_families_register(faulty_remote_write):
    """The `tempo_remote_write_*` families render from the port's
    process registry (the reference's JAX runtime registry holds them
    there), and a retried and a failed send move them."""
    from tempo_tpu_torch.obs.runtime import RUNTIME
    from tempo_tpu_torch.obs.registry import parse_exposition

    fams = ("tempo_remote_write_retries_total",
            "tempo_remote_write_sends_total",
            "tempo_remote_write_failed_sends_total")

    def totals():
        parsed = parse_exposition(RUNTIME.render())
        return {f: sum(parsed[f]["samples"].values()) for f in fams}

    text = RUNTIME.render()
    for fam in fams:
        assert fam in text
    jtext = mod("ref", "obs.jaxruntime").RUNTIME.render()
    assert all(f in jtext for f in fams)
    before = totals()
    srv = faulty_remote_write
    srv.script += [(503, {}), (400, {})]
    _send("port", srv, 2, 0.01)
    after = totals()
    assert after["tempo_remote_write_retries_total"] == \
        before["tempo_remote_write_retries_total"] + 1
    assert after["tempo_remote_write_failed_sends_total"] == \
        before["tempo_remote_write_failed_sends_total"] + 1
