"""Seeded random OTLP payloads through the port's fast paths, against full
staging and against the reference.

Mirrors `tests/test_ingest_fuzz.py`'s 2 tests on the CPU, over the
port's own `native.cpp`: the staged fast path (`push_otlp_staged`, the
C++ resolve), the tee's scan-record path (`push_otlp_recs`) and full
staging (`push_otlp` with the fast path off) must hold bit-identical
series state on the port (compared every fifth payload); the reference's full path
on the same payloads must give the same series with counts and buckets
exact and float sums within rtol 1e-6 (K1 folds one f32 delta a row a
push where the reference adds span by span: ROADMAP section 3). Malformed
payloads (truncated, bit-flipped) must raise `ValueError` in both
packages, case for case. The reference's test draws a random seed; these
pin theirs, so a failure reproduces. The reference's generators set
`registry.disable_collection`, under which `collect()` returns no
samples, and keep the tenant's default 30 s ingestion slack, which drops
every fuzzed span (stamped in 2001), so its parity asserts compare empty
lists; these generators collect and turn the slack off for the tenant,
so the series state itself is compared.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from tests.test_ingest_fuzz import _payload
from tests.test_torch_frontend import mod

SEEDS = (20261017, 757988082)
N_CASES = 25


TENANTS = [f"{kind}-{seed}" for seed in SEEDS for kind in ("t", "bad")]


def _mk_gen(side):
    """A span-metrics generator whose fuzz tenants have the slack filter
    off (every timestamp shape reaches span metrics) and small state."""
    sm = mod(side, "generator.processors.spanmetrics").SpanMetricsConfig(
        sketch_max_series=128)
    cfg = mod(side, "generator.instance").GeneratorConfig(
        processors=("span-metrics",), spanmetrics=sm)
    ov = mod(side, "overrides").Overrides()
    for tenant in TENANTS:
        ov.set_tenant_patch(tenant, {"generator": {
            "processors": ["span-metrics"], "ingestion_time_range_slack_s": 0,
            "max_active_series": 512}})
    kw = {"device": "cpu"} if side == "port" else {}
    return mod(side, "generator.generator").Generator(cfg, overrides=ov, **kw)


@pytest.fixture(scope="module")
def gens():
    """Three port generators (the fast, full and tee routes) and one of
    the reference; each test works in tenants of its own."""
    return {"fast": _mk_gen("port"), "slow": _mk_gen("port"),
            "tee": _mk_gen("port"), "ref": _mk_gen("ref")}


def _samples(gen, tenant):
    return sorted((s.name, s.labels, s.value)
                  for s in gen.instance(tenant).registry.collect(10_000))


def _close(a, b):
    """Same series in the same order; sums within rtol 1e-6, every other
    value exact."""
    assert [x[:2] for x in a] == [x[:2] for x in b]
    for (name, labels, va), (_, _, vb) in zip(a, b):
        if name.endswith("_sum"):
            assert va == pytest.approx(vb, rel=1e-6), (name, labels)
        else:
            assert va == vb, (name, labels)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_fast_paths_match_full_staging(gens, seed):
    from tempo_tpu_torch import native

    t = f"t-{seed}"
    rng = random.Random(seed)
    fast, slow, tee, ref = (gens[k] for k in ("fast", "slow", "tee", "ref"))
    slow.instance(t).push_otlp_staged = lambda *a, **k: None
    n_fast = n_fallback = 0
    for case in range(N_CASES):
        payload = _payload(rng)
        ctx = f"seed={seed} case={case}"
        if fast.instance(t).push_otlp_staged(payload) is None:
            fast.push_otlp(t, payload)
            n_fallback += 1
        else:
            n_fast += 1
        slow.push_otlp(t, payload)
        ref.push_otlp(t, payload)
        recs = native.otlp_scan(payload)
        assert recs is not None
        if tee.push_otlp_recs(t, payload, recs) is None:
            tee.push_otlp(t, payload)
        if case % 5 == 4:           # every fifth payload, and the last
            want = _samples(slow, t)
            assert _samples(fast, t) == want, f"{ctx}: fast != full"
            assert _samples(tee, t) == want, f"{ctx}: tee != full"
    _close(want, _samples(ref, t))
    assert n_fast > 0 and n_fallback > 0, (n_fast, n_fallback)
    assert len(want) > 0 and np.isfinite([v for *_, v in want]).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_malformed_payloads_rejected(gens, seed):
    t = f"bad-{seed}"
    rng = random.Random(seed + 7)
    sides = {"port": gens["slow"], "ref": gens["ref"]}
    base = _payload(rng)
    outcomes = {side: [] for side in sides}
    for case in range(20):
        bad = bytearray(base[:rng.randrange(1, len(base))])
        if bad and rng.random() < 0.7:
            bad[rng.randrange(len(bad))] ^= 0xFF
        for side, gen in sides.items():
            try:
                gen.push_otlp(t, bytes(bad))
                outcomes[side].append("ok")
            except ValueError:
                outcomes[side].append("rejected")
            except Exception as e:
                raise AssertionError(f"{side} seed={seed} case={case}: "
                                     f"{type(e).__name__}: {e}") from e
    assert outcomes["port"] == outcomes["ref"]
    assert "rejected" in outcomes["port"]
    _close(_samples(sides["port"], t), _samples(sides["ref"], t))
