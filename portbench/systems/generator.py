"""A metrics-generator replica under closed-loop OTLP clients.

One `tempo_tpu_torch.generator.Generator` on one card hosts the
configuration's tenants, each under the configuration's processors and
limits, on dense state with the process device scheduler on. Each client
is an exporter that sends a payload, waits for the reply, and sends the
next, pushing OTLP bytes through `Generator.push_otlp`. The traffic's
`threads` exporter threads serve the clients, each thread its share of
them in turn, so at most `threads` pushes are in flight. A client cycles through payload templates drawn from the seed in set-up
and stamps each push with its own trace-id prefix and the clock's time
(`traffic/otlp.Payload.stamp`), so no two pushes share a trace.

The window closes when the clients have stopped, every tenant has
drained (the scheduler flushed, the ingest pipelines reaped) and the
card has synchronised: every acknowledged span is in device state.
After the window the clock moves past the service-graph edge TTL and
one single-span push a tenant expires every waiting edge; then each
tenant's collection and DDSketch quantiles are held against the
reference (`reference/generator.py`, `reference/judge_generator.py`).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from portbench.core import roofline, scrape
from portbench.core.record import Record, judged
from portbench.core.trace import DeviceTrace, HostSpans, traced_slice
from portbench.reference.generator import EDGES, Pushed, TenantReference
from portbench.reference.judge_generator import Tally
from portbench.traffic import otlp, trees


class Clock:
    """The generator's clock: the host's, plus a skew the harness moves."""

    def __init__(self) -> None:
        self.skew = 0.0

    def now(self) -> float:
        return time.time() + self.skew


@dataclasses.dataclass
class Client:
    tenant: str
    index: int
    templates: list          # [(SpanColumns, Payload)]
    pushed: np.ndarray       # acknowledgements a template
    lat_s: list = dataclasses.field(default_factory=list)
    acked_at: list = dataclasses.field(default_factory=list)  # (t, template)
    spans: int = 0
    attempted: int = 0
    failed: int = 0
    errors: list = dataclasses.field(default_factory=list)


def _space(traffic: dict) -> trees.LabelSpace:
    return trees.LabelSpace(**traffic["label_space"])


def make_clients(cfg: dict, traffic: dict, seed: int) -> list[Client]:
    space = _space(traffic)
    per = int(traffic["clients_per_tenant"])
    out = []
    for t in range(int(cfg["tenants"])):
        perms = trees.label_permutations(space, [seed, t])
        for k in range(per):
            c = t * per + k
            rng = np.random.default_rng([seed, t, k, 11])
            tpl = []
            for _ in range(int(traffic["templates_per_client"])):
                cols = trees.trace_trees(
                    int(traffic["spans_per_payload"]), space=space,
                    perms=perms, rng=rng, db_share=float(traffic["db_share"]),
                    end_spread_ns=int(traffic["end_spread_s"] * 1e9))
                tpl.append((cols, otlp.encode(cols, space)))
            out.append(Client(f"tenant-{t}", c, tpl,
                              np.zeros(len(tpl), np.int64)))
    return out


def closing_payload(space: trees.LabelSpace, now_ns: int) -> tuple:
    """One INTERNAL span named `close` in the first service: columns and
    wire bytes."""
    f = otlp._field
    span_msg = (f(1, bytes([2] * 16)) + f(2, bytes([1] * 8)) + f(5, b"close")
                + bytes([0x30, 1, 0x39]) + (now_ns - 1000).to_bytes(8, "little")
                + bytes([0x41]) + now_ns.to_bytes(8, "little"))
    res = f(1, f(1, f(1, b"service.name") + f(2, f(1, space.service_name(0)
                                                     .encode()))))
    raw = f(1, res + f(2, f(2, span_msg)))
    z = np.zeros(1, np.int64)
    cols = trees.SpanColumns(
        trace_id=np.zeros((1, 16), np.uint8), span_id=np.ones((1, 8), np.uint8),
        parent_span_id=np.zeros((1, 8), np.uint8), has_parent=np.zeros(1, bool),
        service=z, name=z, kind=np.ones(1, np.int64), status=z,
        db=z - 1, start_ns=z - 1000, end_ns=z, peer=z - 1)
    return cols, np.array([len(span_msg)], np.int64), raw


def _prefix(client: int, seq: int) -> bytes:
    return ((client & 0xFFFF) << 48 | (seq & (1 << 48) - 1)).to_bytes(8, "big")


def _push(gen, clock, c: Client, seq: int, spans: HostSpans) -> None:
    j = seq % len(c.templates)
    with spans.span("harness.stamp"):
        raw = c.templates[j][1].stamp(_prefix(c.index, seq),
                                      int(clock.now() * 1e9))
    c.attempted += 1
    t0 = time.perf_counter()
    try:
        with spans.span("generator.push_otlp"):
            n = gen.push_otlp(c.tenant, raw)
    except Exception as e:   # a refused push is a failed request
        c.failed += 1
        c.errors.append(repr(e))
        return
    t1 = time.perf_counter()
    c.pushed[j] += 1
    c.spans += n
    c.lat_s.append(t1 - t0)
    c.acked_at.append((t1, j))


def build(cfg: dict, device: str, clock: Clock):
    """The generator as the configuration states it."""
    from tempo_tpu_torch import sched
    from tempo_tpu_torch.generator import Generator
    from tempo_tpu_torch.generator.instance import GeneratorConfig
    from tempo_tpu_torch.generator.processors.servicegraphs import (
        ServiceGraphsConfig)
    from tempo_tpu_torch.generator.processors.spanmetrics import (
        SpanMetricsConfig)
    from tempo_tpu_torch.overrides import Overrides
    from tempo_tpu_torch.overrides.limits import Limits

    sched.configure(sched.SchedConfig(**cfg.get("scheduler", {})))
    sm = dict(cfg["spanmetrics"])
    for k in ("intrinsic_dimensions", "histogram_buckets"):
        sm[k] = tuple(sm[k])
    gcfg = GeneratorConfig(
        processors=tuple(cfg["processors"]),
        spanmetrics=SpanMetricsConfig(**sm),
        servicegraphs=ServiceGraphsConfig(**cfg["servicegraphs"]))
    lim = Limits().merged_with({"generator": {
        "processors": list(cfg["processors"]),
        "max_active_series": cfg["max_active_series"],
        "ingestion_time_range_slack_s": cfg["ingestion_time_range_slack_s"]}})
    return Generator(gcfg, overrides=Overrides(defaults=lim), now=clock.now,
                     device=device)


def _drain(gen, device: str) -> None:
    import torch

    for inst in list(gen.instances.values()):
        inst.drain()
    if device != "cpu":
        torch.cuda.synchronize()


def _scrape(gen) -> dict:
    from tempo_tpu_torch.obs.runtime import RUNTIME

    return scrape.parse(RUNTIME.render(extra=[gen.obs]))


def _trace_bytes(clients, lo: float, hi: float, space) -> int:
    """Least K1 bytes of the pushes acknowledged in [lo, hi], by tenant."""
    by_tenant: dict = {}
    for c in clients:
        for t, j in c.acked_at:
            if lo <= t <= hi:
                cols = c.templates[j][0]
                dur = cols.duration_ns / 1e9
                by_tenant.setdefault(c.tenant, []).append(
                    (trees.label_ids(cols, space),
                     np.searchsorted(np.asarray(EDGES), dur, side="left")))
    total = 0
    for rows in by_tenant.values():
        lab = np.concatenate([r[0] for r in rows])
        bk = np.concatenate([r[1] for r in rows])
        total += roofline.k1_bytes(lab, bk)
    return total


def run(cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None) -> Record:
    import torch

    import tempo_tpu_torch  # noqa: F401  (builds the C++ host layer)

    cfg, traffic = cell.config, cell.traffic
    t_setup = time.perf_counter() if t_start is None else t_start
    if device != "cpu":
        from tempo_tpu_torch.ops import cuda_kernels
        cuda_kernels.build_all()
        torch.cuda.reset_peak_memory_stats()
    clock = Clock()
    gen = build(cfg, device, clock)
    clients = make_clients(cfg, traffic, seed)
    space = _space(traffic)
    warm = int(traffic["warmup_pushes_per_client"])
    seq = [0] * len(clients)
    spans = HostSpans(trace)

    def loop(group: list, stop: threading.Event, limit: int | None) -> None:
        while not stop.is_set():
            due = [c for c in group if limit is None or seq[c.index] < limit]
            if not due:
                return
            for c in due:
                if stop.is_set():
                    return
                _push(gen, clock, c, seq[c.index], spans)
                seq[c.index] += 1

    n_threads = int(traffic["threads"])

    def drive(stop, limit=None):
        ths = [threading.Thread(target=loop,
                                args=(clients[i::n_threads], stop, limit))
               for i in range(n_threads)]
        for th in ths:
            th.start()
        return ths

    for th in drive(threading.Event(), warm):
        th.join()
    _drain(gen, device)
    dt = DeviceTrace(spans) if trace else None
    if dt is not None:
        dt.warm()
    setup_s = time.perf_counter() - t_setup
    for c in clients:                   # the window's own readings
        c.lat_s.clear()
        c.acked_at.clear()
        c.spans = c.attempted = c.failed = 0

    before = _scrape(gen)
    stop = threading.Event()
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    ths = drive(stop)
    if dt is not None:
        off, length = traced_slice(seconds)
        time.sleep(off)
        dt.start()
        time.sleep(length)
        dt.stop()
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    stop.set()
    for th in ths:
        th.join()
    with spans.span("generator.drain"):
        _drain(gen, device)
    window_s = time.perf_counter() - t0
    cpu_s = time.process_time() - cpu0
    after = _scrape(gen)
    peak = int(torch.cuda.max_memory_allocated()) if device != "cpu" else 0

    acked = sum(c.spans for c in clients)
    rec = Record(
        end_to_end={"ingest_spans_per_s": acked / window_s,
                    "setup_s": setup_s,
                    "device_peak_mib": peak / 2**20},
        correct=False, attempted=sum(c.attempted for c in clients),
        failed=sum(c.failed for c in clients), checks={},
        memory_peak_bytes=peak, trace=dt,
        data={"push_s": [x for c in clients for x in c.lat_s],
              "counters": (before, after), "spans": acked, "cpu_s": cpu_s})
    if dt is not None:
        rec.data["k1_bytes"] = _trace_bytes(clients, dt.t_start, dt.t_stop,
                                            space)
        rec.data["k1_device_s"] = dt.device_s(("pfu_",))
    t_check = time.perf_counter()
    numbers, diag = _check(gen, cfg, clients, clock, space, device, seed)
    rec.correct, rec.checks = judged(numbers, cfg["limits"])
    tenths = np.zeros(10)
    for c in clients:
        for t, j in c.acked_at:
            k = int((t - t0) / window_s * 10)
            tenths[min(max(k, 0), 9)] += c.templates[j][1].n
    rec.data["diag"] = diag + [
        f"ingest_spans_per_s {acked / window_s!r}",
        f"process CPU seconds in the window {cpu_s:.3f}: "
        f"{acked / cpu_s:.1f} spans a CPU second",
        "spans/s by tenth of the window: " + " ".join(
            f"{x / (window_s / 10):.0f}" for x in tenths)] + [
        f"{k} {scrape.delta(before, after, k)}" for k in (
            "tempo_sched_dispatch_errors_total", "tempo_sched_shed_jobs_total")]
    rec.data["phases_s"] = {"setup": setup_s, "window": window_s,
                            "check": time.perf_counter() - t_check}
    errors = [e for c in clients for e in c.errors]
    if errors:
        rec.data["errors"] = errors[:5]
    from tempo_tpu_torch import sched
    sched.reset()
    return rec


def _series(samples) -> dict:
    out: dict = {}
    for s in samples:
        out.setdefault(s.name, {})[tuple(kv for kv in s.labels
                                         if kv[0] != "__name__")] = s.value
    return out


def _check(gen, cfg, clients, clock, space, device, seed) -> tuple:
    """The collection and quantiles of `check_tenants` tenants drawn from
    the seed, against the reference: the compared numbers, and lines that
    name the series behind them."""
    picked = np.sort(np.random.default_rng([seed, 13]).choice(
        int(cfg["tenants"]), int(cfg["check_tenants"]), replace=False))
    clock.skew += 6 * float(cfg["servicegraphs"]["wait_s"])
    closing = {}
    for t in picked.tolist():
        cols, nbytes, raw = closing_payload(space, int(clock.now() * 1e9))
        tenant = f"tenant-{t}"
        closing[tenant] = Pushed(cols, nbytes, gen.push_otlp(tenant, raw))
    _drain(gen, device)
    qs = tuple(cfg["quantiles"])
    tally = Tally()
    diag: list = []
    for t in picked.tolist():
        tenant = f"tenant-{t}"
        inst = gen.instances[tenant]
        pushed = [closing[tenant]]
        for c in clients:
            if c.tenant == tenant:
                pushed += [Pushed(cols, p.span_bytes, int(k))
                           for (cols, p), k in zip(c.templates, c.pushed)
                           if k]
        got = _series(inst.registry.collect())
        qv = inst.processors["span-metrics"].quantiles(qs)
        quant: dict = {}
        for j, m in enumerate(qv):
            for labels, v in m.items():
                key = tuple(kv for kv in labels if kv[0] != "__name__")
                quant.setdefault(key, [0.0] * len(qs))[j] = v
        ref = TenantReference(space, pushed,
                              rel_err=cfg["spanmetrics"]["sketch_rel_err"],
                              min_s=cfg["spanmetrics"]["sketch_min_s"],
                              max_s=cfg["spanmetrics"]["sketch_max_s"])
        tally.add(got, quant, ref, qs,
                  int(cfg["spanmetrics"]["sketch_max_series"]))
        sg = inst.processors["service-graphs"]
        diag.append(f"{tenant} service-graph edges dropped {sg.dropped} "
                    f"expired {sg.expired} pending {len(sg._store)}; spans "
                    f"received {inst.spans_received} filtered by the "
                    f"time-range slack {inst.spans_filtered_slack}")
    return tally.numbers(), tally.describe() + diag
