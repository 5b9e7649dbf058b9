"""The port's span-metrics write path against the JAX reference, end to end.

The same OTLP payloads and a pinned clock go into two generator
instances with the page pool on and only the span-metrics processor: the
reference's (`kernel="xla"`, direct route) and the port's on the CPU.
Series are matched by label set, not slot id. Tolerances: calls, bucket
and count samples exact; sums (latency `_sum`, size) at rtol=1e-5;
`quantile(0.5)` / `quantile(0.99)` equal; the decoded remote-write
samples equal under the same rules. Compared before and after a
`purge_stale` eviction and after slot reuse.
"""

from __future__ import annotations

import math

import pytest

from tempo_tpu.generator.instance import (GeneratorConfig as JGenCfg,
                                          GeneratorInstance as JGen)
from tempo_tpu.generator.processors.spanmetrics import SpanMetricsConfig as JSmCfg
from tempo_tpu.generator.remote_write import RemoteWriteConfig as JRwCfg
from tempo_tpu.model.otlp import spans_from_otlp_proto as j_spans
from tempo_tpu.model.span_batch import SpanBatchBuilder as JBuilder
from tempo_tpu.registry import pages as jpages
from tempo_tpu.registry.registry import RegistryOverrides as JOv
from tempo_tpu.utils.spanfilter import (AttributeMatch as JAm,
                                        FilterPolicy as JFp, PolicyMatch as JPm)

import tempo_tpu_torch as tt
from tempo_tpu_torch.generator.remote_write import (LocalReceiver,
                                                    RemoteWriteConfig,
                                                    decode_write_request)
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
from tempo_tpu_torch.registry import pages as tpages
from tempo_tpu_torch.utils.spanfilter import (AttributeMatch, FilterPolicy,
                                              PolicyMatch)

T0 = 1_700_000_000.0
POOL = dict(enabled=True, page_rows=64, arena_slots=2048)
SM = dict(sketch_max_series=256)
SERIES = 1024


@pytest.fixture
def receiver():
    with LocalReceiver() as rx:
        yield rx


def _worlds(url="", clock=None, jsm=None, tsm=None):
    clock = clock if clock is not None else [T0]
    now = lambda: clock[0]  # noqa: E731
    with jpages.use(jpages.PagePool(jpages.PagePoolConfig(**POOL))):
        jg = JGen("t", JGenCfg(
            processors=("span-metrics",), registry=JOv(max_active_series=SERIES),
            spanmetrics=JSmCfg(use_scheduler=False, kernel="xla", **SM,
                               **(jsm or {})),
            remote_write=JRwCfg(url=url and url + "/jax")), now=now)
    # which series own a DDSketch row (slot < sketch_max_series) depends on
    # the order slots are handed out: the reference's C++ row table gives
    # them in first-seen order, its numpy path (the port's) in sorted
    # label order, so the reference is held on its numpy path here
    for mt in jg.registry._metrics.values():
        mt.table._nat = None
    with tpages.use(tpages.PagePool(tpages.PagePoolConfig(**POOL),
                                    device="cpu")):
        tg = tt.GeneratorInstance("t", tt.GeneratorConfig(
            registry=tt.RegistryOverrides(max_active_series=SERIES),
            spanmetrics=tt.SpanMetricsConfig(**SM, **(tsm or {})),
            remote_write=RemoteWriteConfig(url=url and url + "/torch")),
            now=now, device="cpu")
    return clock, jg, tg


def _push(jg, tg, data):
    b = JBuilder(jg.registry.interner)
    for span in j_spans(data):
        b.append(**span)
    jg.push_batch(b.build())
    tg.push_batch(tt.otlp_proto_to_batch(
        data, tt.SpanBatchBuilder(tg.registry.interner)))


def _payload(seed, now_s, n=600, **kw):
    return encode_spans_otlp(synthetic_spans(
        n, seed=seed, now_ns=int(now_s * 1e9), n_services=6, n_ops=12, **kw))


def _is_sum(name, labels, i=None):
    if name == "traces_spanmetrics_size_total" or name.endswith("_sum"):
        return True
    return i == 1 and "le" not in dict(labels)


def _same(a, b, is_sum):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return abs(a - b) <= 1e-5 * abs(b) + 1e-6 if is_sum else a == b


def _compare_collect(jg, tg, ctx):
    ja = {(s.name, s.labels): s for s in jg.registry.collect(1)}
    ta = {(s.name, s.labels): s for s in tg.registry.collect(1)}
    assert ja.keys() == ta.keys(), f"{ctx}: series sets differ"
    for k, js in ja.items():
        ts = ta[k]
        assert _same(ts.value, js.value, _is_sum(*k)), \
            f"{ctx}: {k} {ts.value} vs {js.value}"
        assert (ts.exemplar is None) == (js.exemplar is None), f"{ctx}: {k}"
        if js.exemplar is not None:
            assert (ts.exemplar.trace_id_hex, ts.exemplar.value) == \
                (js.exemplar.trace_id_hex, js.exemplar.value), f"{ctx}: {k}"
    return len(ja)


def _compare_quantiles(jg, tg, ctx):
    jp, tp = jg.processors["span-metrics"], tg.processors["span-metrics"]
    for q in (0.5, 0.99):
        assert tp.quantile(q) == jp.quantile(q), f"{ctx}: quantile({q})"


def test_push_collect_quantile_match():
    _, jg, tg = _worlds()
    for seed in range(3):
        _push(jg, tg, _payload(seed, T0))
    assert tg.registry.active_series == jg.registry.active_series > 256
    n = _compare_collect(jg, tg, "push")
    assert n > 1000
    _compare_quantiles(jg, tg, "push")
    calls = sum(s.value for s in tg.registry.collect(1)
                if s.name == "traces_spanmetrics_calls_total")
    assert calls == 3 * 600


def test_slack_drops_and_purge_then_reuse_match():
    """Spans outside the ingestion slack drop in both; after the clock
    moves past the stale window the early-only series are evicted (NaN
    markers, pages back to the free lists) and their slots are reused."""
    clock, jg, tg = _worlds()
    _push(jg, tg, _payload(0, T0))
    _push(jg, tg, _payload(1, T0 - 120))             # all outside the slack
    assert tg.spans_filtered_slack == jg.spans_filtered_slack == 600
    clock[0] = T0 + 600
    _push(jg, tg, _payload(2, clock[0], kinds=(2,), statuses=(0,)))
    clock[0] = T0 + 1000                             # stale_duration 900 s
    assert tg.registry.purge_stale() == jg.registry.purge_stale() > 0
    _compare_collect(jg, tg, "after purge")          # includes NaN markers
    _compare_quantiles(jg, tg, "after purge")
    _push(jg, tg, _payload(3, clock[0]))             # reuses the freed slots
    _compare_collect(jg, tg, "after reuse")
    _compare_quantiles(jg, tg, "after reuse")


def test_filter_policy_and_target_info_match():
    jsm = dict(enable_target_info=True, filter_policies=(JFp(exclude=JPm(
        "regex", (JAm("name", "op-1.*"),))),))
    tsm = dict(enable_target_info=True, filter_policies=(FilterPolicy(
        exclude=PolicyMatch("regex", (AttributeMatch("name", "op-1.*"),))),))
    _, jg, tg = _worlds(jsm=jsm, tsm=tsm)
    _push(jg, tg, _payload(4, T0))
    assert tg.processors["span-metrics"].spans_discarded == \
        jg.processors["span-metrics"].spans_discarded > 0
    _compare_collect(jg, tg, "filtered")


def test_remote_write_samples_match(receiver):
    _, jg, tg = _worlds(url=receiver.url)
    for seed in range(2):
        _push(jg, tg, _payload(10 + seed, T0))
    assert jg.collect_and_push() == tg.collect_and_push() > 0
    bodies = receiver.bodies
    jd = decode_write_request(bodies["/jax"])
    td = decode_write_request(bodies["/torch"])
    assert jd.keys() == td.keys() and len(td) > 1000
    for k, jv in jd.items():
        name = dict(k)["__name__"]
        for i, (a, b) in enumerate(zip(td[k], jv, strict=True)):
            assert _same(a, b, _is_sum(name, k, i)), (k, i, a, b)
