"""Import and device guards of the PyTorch/CUDA port.

- A fresh interpreter imports `tempo_tpu_torch`, pushes, collects and
  reads a quantile on the CPU under the `sketch: dd` f32 tier and under
  `sketch: both` with compact state on paged state, and under `sketch:
  dd` on dense state (no pool), then pushes trace trees through a
  configured device scheduler into the default processors (span metrics
  and service graphs) on dense and paged state, and ends with neither
  `jax` nor any `tempo_tpu` module loaded. The test is exact-prefix: `tempo_tpu_torch` itself starts with
  the string "tempo_tpu", so a module counts as the reference only when
  its name is `tempo_tpu` or starts with `tempo_tpu.`.
- A fresh interpreter drives the staged routes (`stage_otlp`,
  `push_staged_view`, `push_otlp_staged`) and maps only the port's
  native library, the one built under `build/`.
- A fresh interpreter drives `Distributor.push_otlp` into port
  `Generator`s (the staged tee, the columnar tee and the dict route) and
  ends with no `jax`, no `tempo_tpu` module and no `yaml` loaded; an
  `Overrides()` without a runtime-config path needs no PyYAML, and no
  port module imports `yaml` outside a function.
- A fresh interpreter drives the ingesters behind `Distributor.push_otlp`
  (push through the staged and the columnar tee, cut, complete, flush,
  find at every stage) and ends with no `jax`, `tempo_tpu`, `yaml` or
  `pyarrow` module loaded: the port writes and reads Parquet itself.
- A fresh interpreter drives the read side over backend blocks
  (`TempoDB.write_block`, `search`, `query_range` with rate and quantile
  on both query tiers, the device plane on and off, `find_trace_by_id`)
  and ends with no `jax`, `tempo_tpu`, `yaml` or `pyarrow` loaded.
- A fresh interpreter drives the query frontend (`Frontend` over
  `Querier` and `TempoDB` with a job cache: search, find, tags, a rate
  `query_range` and the sidecar fold tier) with the same result.
- A fresh interpreter drives the ingest-storage path
  (`Distributor.push_otlp` onto a bus, a local-blocks `Generator` and a
  `BlockBuilder` with sidecars draining it, a frontend rate query over
  both legs) with the same result.
- A fresh interpreter drives the materialized grids (an explicit and an
  auto-subscribed grid over a local-blocks tenant, read through
  `Frontend`) and a trace-analytics tenant pushed and cut, with the
  same result.
- A fresh interpreter drives the App at target `all` (`start_loops`,
  `serve`, a push, a find and a query over HTTP, one compaction sweep,
  shutdown) with the same result; `load_config(text=...)` loads PyYAML
  and nothing else of the list.
- A fresh interpreter drives an App with `wal` and `fleet` on (a push,
  the App abandoned, a second App replaying the WAL at boot), and
  another the `--kv-only` worker's server holding the ring of two fleet
  controllers that hand a tenant off, with the same result.
- A fresh interpreter drives a `KafkaBus` produce and a group-mode
  `consume_bus` against the mock broker, and another an App with
  `mesh.enabled` pushing and collecting on logical CPU series shards,
  with the same result.
- No source file of the port, nor `chip_smoke.py`, imports either, and
  none imports `pyarrow` anywhere.
- Asking for `cuda` without a CUDA device raises.
- Every configuration the port does not carry raises
  `NotImplementedError` instead of quietly doing something else.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tempo_tpu_torch"


def _is_reference(name: str) -> bool:
    return name == "tempo_tpu" or name.startswith("tempo_tpu.") \
        or name == "jax" or name.startswith("jax.")


def test_exact_prefix_rule():
    assert _is_reference("tempo_tpu.ops.pages")
    assert _is_reference("jax.numpy")
    assert not _is_reference("tempo_tpu_torch")
    assert not _is_reference("tempo_tpu_torch.ops.pages")
    assert not _is_reference("jaxlib_like")


_DRIVE = """
import sys
import tempo_tpu_torch as tt
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
from tempo_tpu_torch.registry import pages
pool = pages.PagePool(tt.PagePoolConfig(enabled=True, page_rows=64,
                                        arena_slots=1024), device="cpu")
data = encode_spans_otlp(synthetic_spans(300, seed=0, now_ns=int(1.7e18)))
for p, sm in ((pool, dict()), (pool, dict(sketch="both", compact_state=True)),
              (None, dict())):
    with pages.use(p):
        g = tt.GeneratorInstance(f"t{len(sm)}", tt.GeneratorConfig(
            registry=tt.RegistryOverrides(max_active_series=512),
            spanmetrics=tt.SpanMetricsConfig(sketch_max_series=128, **sm)),
            now=lambda: 1.7e9, device="cpu")
    assert g.state_layout == ("paged" if p else "dense")
    g.push_batch(tt.otlp_proto_to_batch(data, tt.SpanBatchBuilder(g.registry.interner)))
    assert g.collect_and_push() > 0
    assert g.processors["span-metrics"].quantile(0.5)
from chip_smoke import trace_tree_spans
sc = tt.sched.configure(tt.SchedConfig(batch_window_ms=60_000.0))
for p in (None, pool):
    with pages.use(p):
        g = tt.GeneratorInstance("s", tt.GeneratorConfig(
            registry=tt.RegistryOverrides(max_active_series=512),
            spanmetrics=tt.SpanMetricsConfig(sketch_max_series=128)),
            now=lambda: 1.7e9, device="cpu")
    assert set(g.processors) == {"span-metrics", "service-graphs"}
    tree = encode_spans_otlp(trace_tree_spans(200, seed=1, now_ns=int(1.7e18)))
    g.push_batch(tt.otlp_proto_to_batch(tree, tt.SpanBatchBuilder(g.registry.interner)))
    assert sc.pending() == 1
    assert g.collect_and_push() > 0
    assert sc.pending() == 0 and sc.batches_total
    names = {s.name for s in g.registry.collect(1)}
    assert "traces_service_graph_request_total" in names
    assert "traces_spanmetrics_calls_total" in names
tt.sched.reset()
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu") or m.startswith(("jax.", "tempo_tpu.")))
print("LOADED", bad)
"""


_STAGED_DRIVE = """
import sys
import numpy as np
import tempo_tpu_torch as tt
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
from tempo_tpu_torch.registry import pages
data = encode_spans_otlp(synthetic_spans(300, seed=0, now_ns=int(1.7e18)))
pool = pages.PagePool(tt.PagePoolConfig(enabled=True, page_rows=64,
                                        arena_slots=1024), device="cpu")
for p in (None, pool):
    with pages.use(p):
        g = tt.GeneratorInstance("t", tt.GeneratorConfig(
            processors=("span-metrics",),
            registry=tt.RegistryOverrides(max_active_series=512),
            spanmetrics=tt.SpanMetricsConfig(sketch_max_series=128)),
            now=lambda: 1.7e9, device="cpu")
    st = tt.stage_otlp(data, g.registry.interner, include_span_attrs=False)
    st.sample_weight = np.full(st.n, 2.0, np.float32)
    assert g.push_staged_view(st.view()) == 300
    assert g.push_staged_view(st.view(np.arange(0, 300, 3))) == 100
    assert g.push_otlp_staged(data) == 300
    assert g.collect_and_push() > 0 and g.spans_received == 700
    assert g.processors["span-metrics"].quantile(0.5)
maps = open("/proc/self/maps").read().splitlines()
print("LIBS", sorted({l.split()[-1] for l in maps if "native" in l and ".so" in l}))
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu") or m.startswith(("jax.", "tempo_tpu.")))
print("LOADED", bad)
"""


_DIST_DRIVE = """
import sys
import time
import tempo_tpu_torch as tt
from tempo_tpu_torch.distributor import Distributor
from tempo_tpu_torch.generator import Generator
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
from tempo_tpu_torch.overrides import Overrides
from tempo_tpu_torch.ring import ACTIVE, InstanceDesc, Ring
from tempo_tpu_torch.ring.ring import _instance_tokens

def ring(ids, rf):
    r = Ring(replication_factor=rf)
    for i in ids:
        r.register(InstanceDesc(id=i, state=ACTIVE,
                                tokens=_instance_tokens(i, 64)))
    return r

class Ing:
    staged_needs_attrs = False
    def push(self, t, traces): return [None] * len(traces)
    def push_otlp(self, t, data): return {}
    def push_staged(self, t, view): return {}

ov = Overrides()
assert "yaml" not in sys.modules
for t, procs in (("a", ["span-metrics"]), ("b", ["span-metrics", "service-graphs"])):
    ov.set_tenant_patch(t, {"generator": {"processors": procs,
                                          "max_active_series": 512},
                            "ingestion": {"max_attribute_bytes": 64 if t == "b" else 0}})
ings = {f"i{k}": Ing() for k in range(3)}
data = encode_spans_otlp(synthetic_spans(300, seed=0, now_ns=time.time_ns()))
for n_gen in (1, 2):
    gens = {f"g{k}": Generator(tt.GeneratorConfig(
        spanmetrics=tt.SpanMetricsConfig(sketch_max_series=128)),
        overrides=ov, instance_id=f"g{k}", device="cpu") for k in range(n_gen)}
    d = Distributor(ring(ings, 3), ings, overrides=ov,
                    generator_ring=ring(gens, 1), generator_clients=gens)
    for t in ("a", "b"):
        assert d.push_otlp(t, data) == {}
    assert sum(g.instance("a").spans_received for g in gens.values()) == 300
    assert sum(g.collect_all() for g in gens.values()) > 0
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu", "yaml")
             or m.startswith(("jax.", "tempo_tpu.", "yaml.")))
print("LOADED", bad)
"""


def test_distributor_into_generator_loads_no_reference_and_no_yaml():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _DIST_DRIVE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


_INGESTER_DRIVE = """
import sys
import tempfile
import time
import tempo_tpu_torch as tt
from tempo_tpu_torch.backend import LocalBackend, read_block_meta
from tempo_tpu_torch.block import BackendBlock
from tempo_tpu_torch.distributor import Distributor
from tempo_tpu_torch.generator import Generator
from tempo_tpu_torch.ingester import Ingester
from tempo_tpu_torch.model.otlp import encode_spans_otlp
from tempo_tpu_torch.overrides import Overrides
from tempo_tpu_torch.ring import ACTIVE, InstanceDesc, Ring
from tempo_tpu_torch.ring.ring import _instance_tokens
from chip_smoke import trace_tree_spans

def ring(ids, rf):
    r = Ring(replication_factor=rf)
    for i in ids:
        r.register(InstanceDesc(id=i, state=ACTIVE,
                                tokens=_instance_tokens(i, 64)))
    return r

root = tempfile.mkdtemp()
store = LocalBackend(root + "/store")
ov = Overrides()
ov.set_tenant_patch("a", {"generator": {"processors": ["span-metrics"],
                                        "max_active_series": 512}})
spans = trace_tree_spans(24, seed=3, now_ns=time.time_ns())
data = encode_spans_otlp(spans)
tid = spans[0]["trace_id"]
ings = {f"i{k}": Ingester(f"{root}/i{k}", flush_writer=store,
                          overrides=ov, instance_id=f"i{k}")
        for k in range(3)}
gens = {"g0": Generator(tt.GeneratorConfig(
    spanmetrics=tt.SpanMetricsConfig(sketch_max_series=128)),
    overrides=ov, instance_id="g0", device="cpu")}
d = Distributor(ring(ings, 3), ings, overrides=ov,
                generator_ring=ring(gens, 1), generator_clients=gens)
assert d.push_otlp("a", data) == {}
for ing in ings.values():
    assert ing.find_trace_by_id("a", tid)
    ing.sweep_all(immediate=True)
    assert ing.find_trace_by_id("a", tid)
    assert ing.flush_tick() == 2
    (entry,) = ing.instance("a").complete.values()
    assert entry.flushed_ts and ing.find_trace_by_id("a", tid)
    meta = read_block_meta(store, entry.meta.block_id, "a")
    assert BackendBlock(store, meta).find_trace_by_id(tid)
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu", "yaml", "pyarrow")
             or m.startswith(("jax.", "tempo_tpu.", "yaml.", "pyarrow.")))
print("LOADED", bad)
"""


def test_ingester_drive_loads_no_reference_yaml_or_pyarrow():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _INGESTER_DRIVE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


_READ_DRIVE = """
import sys
import tempfile
from tempo_tpu_torch.backend import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.ops.moments import use_query_tier
from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

T0 = 1_700_000_000 * 10**9
traces = []
for i in range(64):
    tid = bytes([i + 1]) * 16
    start = T0 + i * 7 * 10**9
    traces.append((tid, [{
        "trace_id": tid, "span_id": bytes([i + 1]) * 8, "name": f"op-{i % 3}",
        "service": f"svc-{i % 2}", "kind": 2, "status_code": i % 3,
        "start_unix_nano": start, "end_unix_nano": start + 10**6 * (i + 1),
        "attrs": {"http.status_code": 200 + 100 * (i % 4)}}]))
store = LocalBackend(tempfile.mkdtemp())
for plane in (True, False):
    db = TempoDB(store, store, TempoDBConfig(device_plane=plane), device="cpu")
    db.write_block("t", traces, replication_factor=1)
    db.poll_now()
    assert len(db.search("t", "{ span.http.status_code >= 400 }", limit=100)) == 32
    assert db.find_trace_by_id("t", traces[5][0])
    for q in ("{ } | rate() by (resource.service.name)",
              "{ } | quantile_over_time(duration, .5, .99) by (name)"):
        req = QueryRangeRequest(q, T0, T0 + 900 * 10**9, 60 * 10**9)
        assert db.query_range("t", req)
        with use_query_tier("moments"):
            assert db.query_range("t", req)
    if plane:
        assert db.plane_stats["fused_metric_blocks"] == 4
    db.shutdown()
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu", "yaml", "pyarrow")
             or m.startswith(("jax.", "tempo_tpu.", "yaml.", "pyarrow.")))
print("LOADED", bad)
"""


def test_read_side_drive_loads_no_reference_yaml_or_pyarrow():
    """`TempoDB` write_block → search → query_range (rate and quantile,
    the log2 and moments tiers, the plane on and off) → find_trace_by_id
    in a fresh interpreter: no `jax`, `tempo_tpu`, `yaml` or `pyarrow`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _READ_DRIVE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


_FRONTEND_DRIVE = """
import sys
import numpy as np
from tempo_tpu_torch.backend import CacheProvider, MemBackend, block_keypath
from tempo_tpu_torch.block import sidecar
from tempo_tpu_torch.db import TempoDB
from tempo_tpu_torch.frontend import Frontend
from tempo_tpu_torch.ops import moments
from tempo_tpu_torch.querier import Querier

T0 = 1_700_000_000
traces = []
for i in range(48):
    tid = bytes([i + 1]) * 16
    start = (T0 + i * 5) * 10**9
    traces.append((tid, [{
        "trace_id": tid, "span_id": bytes([i + 1]) * 8, "name": f"op-{i % 3}",
        "service": f"svc-{i % 2}", "kind": 2, "status_code": i % 3,
        "start_unix_nano": start, "end_unix_nano": start + 10**6 * (i + 1)}]))
be = MemBackend()
db = TempoDB(be, be, device="cpu", now=lambda: T0 + 7200)
meta = db.write_block("t", traces, replication_factor=1)
db.poll_now()
fe = Frontend(db, Querier(db), cache_provider=CacheProvider(),
              now=lambda: T0 + 7200)
assert len(fe.search("t", "{ }", limit=100, start_s=0, end_s=T0 + 7200)) == 48
assert fe.find_trace("t", traces[5][0])
assert fe.tag_names("t")["resource"] == []
q = "{ } | rate() by (resource.service.name)"
want = fe.query_range("t", q, start_s=T0 - 60, end_s=T0 + 600, step_s=60.0)
assert sum(float(s.samples.sum()) for s in want) * 60 == 48
# a sidecar in the reference's format: the fold tier answers the block
rows = np.zeros((2, moments.n_cols(moments.QUERY_K)))
rows[:, 0] = 24
sc = sidecar.Sidecar(moments.QUERY_K, moments.QUERY_LO, moments.QUERY_HI,
                     48, [("svc-0", "op"), ("svc-1", "op")], rows,
                     np.zeros(1 << sidecar.SIDECAR_HLL_PRECISION, np.int32))
be.write(sidecar.SIDECAR_NAME, block_keypath(meta.block_id, "t"), sc.to_json())
db.blocklist.metas("t")[0].sidecar = True
assert db.sidecar_plan(q) is not None
got = fe.query_range("t", q, start_s=T0 - 60, end_s=T0 + 600, step_s=660.0)
assert db.compaction_stats["sidecar_folds"] == 1
assert sum(float(s.samples.sum()) for s in got) * 660 == 48
fe.shutdown()
db.shutdown()
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu", "yaml", "pyarrow")
             or m.startswith(("jax.", "tempo_tpu.", "yaml.", "pyarrow.")))
print("LOADED", bad)
"""


def test_frontend_drive_loads_no_reference_yaml_or_pyarrow():
    """`Frontend` over `Querier` and `TempoDB` with a `CacheProvider`: a
    search, a find, `tag_names`, a rate `query_range` and the sidecar
    tier through `sidecar_plan`, in a fresh interpreter: no `jax`,
    `tempo_tpu`, `yaml` or `pyarrow`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _FRONTEND_DRIVE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


_INGEST_STORAGE_DRIVE = """
import sys
import tempfile
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.blockbuilder import BlockBuilder, BlockBuilderConfig
from tempo_tpu_torch.db import TempoDB
from tempo_tpu_torch.distributor import Distributor
from tempo_tpu_torch.frontend import Frontend
from tempo_tpu_torch.generator import Generator, GeneratorConfig
from tempo_tpu_torch.generator.processors.localblocks import LocalBlocksConfig
from tempo_tpu_torch.ingest import Bus
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
from tempo_tpu_torch.overrides import Overrides
from tempo_tpu_torch.querier import Querier
from tempo_tpu_torch.ring import Ring

T0 = 1_700_000_000.0
clock = [T0]
now = lambda: clock[0]
ov = Overrides()
ov.set_tenant_patch("t", {"generator": {
    "processors": ["span-metrics", "local-blocks"], "max_active_series": 512}})
with tempfile.TemporaryDirectory() as root:
    gen = Generator(GeneratorConfig(localblocks=LocalBlocksConfig(
        data_dir=root)), overrides=ov, now=now, device="cpu")
    bus = Bus(2)
    be = MemBackend()
    bb = BlockBuilder(bus, be, BlockBuilderConfig(partitions=None), now=now,
                      device="cpu")
    d = Distributor(Ring(replication_factor=1), {}, overrides=ov, bus=bus,
                    now=now)
    for leg in range(2):
        spans = synthetic_spans(32, seed=leg, now_ns=int((clock[0] - 5) * 1e9))
        assert d.push_otlp("t", encode_spans_otlp(spans)) == {}
        assert gen.consume_bus(bus) > 0 and bb.consume_cycle() > 0
        clock[0] += 1200.0
    gen.instance("t").tick(immediate=True)
    db = TempoDB(be, be, device="cpu", now=now)
    db.poll_now()
    assert all(m.sidecar and m.replication_factor == 1
               for m in db.blocklist.metas("t"))
    fe = Frontend(db, Querier(db), generator_query_range=gen.query_range,
                  now=now)
    got = fe.query_range("t", "{ } | rate()", start_s=T0 - 600,
                         end_s=clock[0], step_s=clock[0] - T0 + 600)
    assert round(sum(float(s.samples.sum()) for s in got)
                 * (clock[0] - T0 + 600)) == 64
    assert db.compaction_stats["sidecar_folds"] > 0
    fe.shutdown()
    db.shutdown()
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu", "yaml", "pyarrow")
             or m.startswith(("jax.", "tempo_tpu.", "yaml.", "pyarrow.")))
print("LOADED", bad)
"""


def test_ingest_storage_drive_loads_no_reference_yaml_or_pyarrow():
    """`Distributor.push_otlp` onto a bus, a local-blocks `Generator` and
    a `BlockBuilder` (sidecars on) draining it, and a frontend rate query
    over both legs (the sidecar fold behind the cutoff, the generators'
    local blocks after it), in a fresh interpreter: no `jax`,
    `tempo_tpu`, `yaml` or `pyarrow`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _INGEST_STORAGE_DRIVE],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


_GRID_DRIVE_HEAD = """
import sys
import tempfile
from tempo_tpu_torch.generator import Generator, GeneratorConfig
from tempo_tpu_torch.generator.processors.localblocks import LocalBlocksConfig
from tempo_tpu_torch.model.span_batch import SpanBatchBuilder
from tempo_tpu_torch.overrides import Overrides

T0 = 1_700_000_000.0
clock = [T0]
now = lambda: clock[0]
ov = Overrides()
ov.set_tenant_patch("t", {"generator": {
    "processors": ["span-metrics", "local-blocks"], "max_active_series": 512}})
ov.set_tenant_patch("ta", {"generator": {
    "processors": ["span-metrics", "trace-analytics"],
    "max_active_series": 512}})


def push(inst, k):
    b = SpanBatchBuilder(inst.registry.interner)
    t0 = int(clock[0] * 1e9)
    for i in range(40):
        tid = bytes([k, i // 4 + 1]) * 8
        b.append(trace_id=tid, span_id=bytes([i % 4 + 1]) * 8,
                 parent_span_id=b"" if i % 4 == 0 else bytes([1]) * 8,
                 name=f"op-{i % 3}", service=f"svc-{i % 2}",
                 status_code=2 if i % 5 == 0 else 0,
                 start_unix_nano=t0 - (i % 4 + 1) * 10**8,
                 end_unix_nano=t0 - (i % 4) * 10**7)
    inst.push_batch(b.build())
"""

_DRIVE_TAIL = """
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu", "yaml", "pyarrow")
             or m.startswith(("jax.", "tempo_tpu.", "yaml.", "pyarrow.")))
print("LOADED", bad)
"""

_MATVIEW_DRIVE = _GRID_DRIVE_HEAD + """
from tempo_tpu_torch import matview
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.db import TempoDB
from tempo_tpu_torch.frontend import Frontend, FrontendConfig
from tempo_tpu_torch.querier import Querier
from tempo_tpu_torch.querier.querier import QuerierConfig
from tempo_tpu_torch.ring import Ring

with tempfile.TemporaryDirectory() as root:
    gen = Generator(GeneratorConfig(localblocks=LocalBlocksConfig(
        data_dir=root)), overrides=ov, now=now, device="cpu")
    mv = matview.configure(matview.MatViewConfig(auto_subscribe_after=2),
                           now=now, device="cpu")
    be = MemBackend()
    db = TempoDB(be, be, device="cpu", now=now)
    fe = Frontend(db, Querier(db, Ring(replication_factor=1), {},
                              cfg=QuerierConfig(rf=1)),
                  cfg=FrontendConfig(query_backend_after_s=1e9),
                  generator_query_range=gen.query_range, now=now)
    rate = "{ } | rate() by (resource.service.name)"
    hist = "{ } | histogram_over_time(duration)"
    assert fe.subscribe_query("t", rate, 10.0) == (True, "")
    inst = gen.instance("t")
    push(inst, 1)
    kw = dict(start_s=(int(T0) // 10 - 3) * 10.0,
              end_s=(int(T0) // 10 + 1) * 10.0, step_s=10.0)
    for _ in range(2):
        fe.query_range("t", hist, **kw)
    clock[0] += 5
    push(inst, 2)
    served = {s.labels: s.samples.tolist()
              for s in fe.query_range("t", rate, **kw)}
    fe.query_range("t", hist, **kw)
    assert mv.reads["hit"] == 2 and mv.auto_subscribed == 1, mv.reads
    matview.reset()
    assert served == {s.labels: s.samples.tolist()
                      for s in fe.query_range("t", rate, **kw)}
    fe.shutdown()
    db.shutdown()
""" + _DRIVE_TAIL

_TRACE_ANALYTICS_DRIVE = _GRID_DRIVE_HEAD + """
gen = Generator(overrides=ov, now=now, device="cpu")
ta = gen.instance("ta")
push(ta, 3)
ta.tick(immediate=True)
samples = ta.registry.collect()
assert any(s.name == "tempo_critical_path_seconds_total" for s in samples)
assert any(s.name == "tempo_error_root_cause_total" for s in samples)
assert ta.processors["trace-analytics"].quantile(0.5)
""" + _DRIVE_TAIL


def _fresh(drive: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", drive], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_matview_drive_loads_no_reference():
    """A materializer with an explicit and an auto-subscribed grid over a
    local-blocks tenant, read through `Frontend` (served reads equal the
    recompute), in a fresh interpreter: no `jax`, `tempo_tpu`, `yaml` or
    `pyarrow`."""
    _fresh(_MATVIEW_DRIVE)


def test_trace_analytics_drive_loads_no_reference():
    """A span-metrics + trace-analytics tenant pushed and cut, its
    counters collected and a share quantile read, in a fresh
    interpreter: no `jax`, `tempo_tpu`, `yaml` or `pyarrow`."""
    _fresh(_TRACE_ANALYTICS_DRIVE)


def test_no_port_source_imports_pyarrow():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        bad = [m for m in _imports(f) if m.split(".")[0] in
               ("pyarrow", "zstandard", "snappy")]
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_yaml_is_imported_only_inside_functions():
    for f in sorted(PORT.rglob("*.py")):
        tree = ast.parse(f.read_text(), str(f))
        for node in tree.body:
            names = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module] if isinstance(
                node, ast.ImportFrom) else []
            assert "yaml" not in names, f"{f.relative_to(ROOT)} imports yaml"


def test_staged_routes_load_only_the_ports_native_library():
    """`stage_otlp` + `push_staged_view` + `push_otlp_staged` in a fresh
    interpreter, on dense and paged state: no `jax` or `tempo_tpu.*`
    module loads, and the one native library mapped is the port's build
    under `build/`, not the reference's (`_tempo_native_*.so` in its
    user cache)."""
    import tempo_tpu_torch as tt

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _STAGED_DRIVE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    libs = [line for line in out.stdout.splitlines()
            if line.startswith("LIBS")]
    assert libs == [f"LIBS {[tt.native.library_path()]}"], out.stdout
    assert Path(tt.native.library_path()).parent == ROOT / "build"
    assert "_tempo_native_" not in out.stdout


def test_push_and_collect_load_no_reference_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _DRIVE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_never_import_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 17
    for f in files:
        bad = [m for m in _imports(f) if _is_reference(m)]
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_cuda_without_a_device_raises(monkeypatch):
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.registry import pages

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.PagePoolConfig(enabled=True, page_rows=64, arena_slots=1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pages.configure(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pages.configure(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.GeneratorInstance("t")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.ManagedRegistry("t")
    assert pages.active() is None


def _instance(**sm):
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.registry import pages

    pool = pages.PagePool(tt.PagePoolConfig(enabled=True, page_rows=64,
                                            arena_slots=1024), device="cpu")
    with pages.use(pool):
        return tt.GeneratorInstance("t", tt.GeneratorConfig(
            registry=tt.RegistryOverrides(max_active_series=512),
            spanmetrics=tt.SpanMetricsConfig(sketch_max_series=128, **sm)),
            device="cpu")


@pytest.mark.parametrize("sm", [dict(sketch="moments"), dict(sketch="both"),
                                dict(compact_state=True), dict()])
def test_unsupported_spanmetrics_configs_raise(sm):
    """Under every sketch and state tier the scheduler route (the
    default) builds and queues a push. The name is kept from when the
    scheduler's serving-mesh options raised: since item 13 `align`
    rounds the merged window up to its multiple and `shards` splits the
    occupancy per shard."""
    import numpy as np

    import tempo_tpu_torch as tt
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

    g = _instance(**sm)
    proc = g.processors["span-metrics"]
    assert proc.cfg.use_scheduler
    sc = tt.DeviceScheduler(tt.SchedConfig(), start_worker=False)
    with tt.sched.use(sc):
        data = encode_spans_otlp(synthetic_spans(50, seed=0, now_ns=10**18))
        proc.push_batch(tt.otlp_proto_to_batch(
            data, tt.SpanBatchBuilder(g.registry.interner)))
        assert sc.pending() == 1
        sc.flush()
        for kw, want in ((dict(align=3), 66), (dict(shards=2), 64)):
            got = []
            sc.submit_rows("k", "m", (np.zeros(48, np.int32),), 48,
                           lambda s: got.append(s.shape[0]), **kw)
            sc.drain_once(force=True)
            assert got == [max(want, sc.cfg.min_bucket_rows)
                           if "shards" in kw else want]


@pytest.mark.parametrize("sm", [dict(sketch="moments"), dict(sketch="both"),
                                dict(sketch="both", compact_state=True)])
def test_moments_and_compact_tiers_build(sm):
    g = _instance(**sm)
    proc = g.processors["span-metrics"]
    assert (proc._pmom is not None) == (sm["sketch"] != "dd")
    assert proc.calls.values.data.dtype == (
        torch.int32 if sm.get("compact_state") else torch.float32)


def test_dense_layout_and_other_entry_points_raise():
    """No pool, or a capacity the pool's pages do not divide, builds dense
    state (no longer raising); every entry point of a later slice raises."""
    import tempo_tpu_torch as tt
    from tempo_tpu_torch.registry import pages

    with pages.use(None):
        assert tt.GeneratorInstance("t", device="cpu").state_layout == "dense"
    pool = pages.PagePool(tt.PagePoolConfig(enabled=True, page_rows=64,
                                            arena_slots=1024), device="cpu")
    with pages.use(pool):
        g = tt.GeneratorInstance("t", tt.GeneratorConfig(
            registry=tt.RegistryOverrides(max_active_series=1000)),
            device="cpu")
        assert g.state_layout == "dense"
        # native histograms came with ROADMAP section 2, item 6: a dense
        # family here (the capacity splits into no whole pages)
        nh = g.registry.new_native_histogram("h", ("a",))
        assert type(nh).__name__ == "NativeHistogram"
        lb = tt.GeneratorInstance("t", tt.GeneratorConfig(
            processors=("span-metrics", "local-blocks"),
            registry=tt.RegistryOverrides(max_active_series=512)),
            device="cpu")
        assert set(lb.processors) == {"span-metrics", "local-blocks"}
        shutil.rmtree(os.path.dirname(
            lb.processors["local-blocks"].inst.wal_dir))
        ta = tt.GeneratorInstance("t", tt.GeneratorConfig(
            processors=("span-metrics", "trace-analytics"),
            registry=tt.RegistryOverrides(max_active_series=512)),
            device="cpu")
        assert set(ta.processors) == {"span-metrics", "trace-analytics"}
        assert ta._fast_spanmetrics() is None
    g = _instance()
    with pytest.raises(ValueError, match="unknown sketch"):
        _instance(sketch="hll")
    with pytest.raises(ValueError, match="unknown kernel"):
        _instance(kernel="mosaic")
    with pytest.raises(ValueError, match="pallas_interpret"):
        _instance(pallas_interpret="yes")
    for kernel in ("xla", "pallas"):
        for interpret in (False, True):
            _instance(kernel=kernel, pallas_interpret=interpret)
    assert g.device_state_bytes() == 0    # no series yet: no pages backed


_APP_DRIVE = """
import json
import socket
import sys
import tempfile
import time
import urllib.parse
import urllib.request
from tempo_tpu_torch.app import App
from tempo_tpu_torch.app.api import serve
from tempo_tpu_torch.app.config import Config
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

s = socket.socket()
s.bind(("127.0.0.1", 0))
port = s.getsockname()[1]
s.close()
with tempfile.TemporaryDirectory() as root:
    cfg = Config()
    cfg.storage.local_path = root + "/blocks"
    cfg.storage.wal_path = root + "/wal"
    cfg.generator.localblocks.data_dir = root + "/lb"
    cfg.server.http_listen_port = port
    app = App(cfg, device="cpu")
    app.overrides.set_tenant_patch("single-tenant", {"generator": {
        "processors": ["span-metrics", "local-blocks"]}})
    app.start_loops()
    srv = serve(app, block=False)
    base = f"http://127.0.0.1:{port}"
    spans = synthetic_spans(64, seed=1, now_ns=int((time.time() - 5) * 1e9))
    req = urllib.request.Request(base + "/v1/traces",
                                 data=encode_spans_otlp(spans),
                                 headers={"Content-Type":
                                          "application/x-protobuf"})
    assert urllib.request.urlopen(req, timeout=10).status == 200
    tid = spans[0]["trace_id"].hex()
    doc = json.loads(urllib.request.urlopen(
        base + "/api/traces/" + tid, timeout=10).read())
    assert doc["spans"]
    now = time.time()
    doc = json.loads(urllib.request.urlopen(
        base + "/api/metrics/query_range?q=" +
        urllib.parse.quote("{ } | rate()") +
        f"&start={now - 300}&end={now}&step=300", timeout=10).read())
    assert doc["series"]
    # two historical blocks of the tenant, then one compaction sweep
    old = [dict(s, start_unix_nano=s["start_unix_nano"] - 7200 * 10 ** 9,
                end_unix_nano=s["end_unix_nano"] - 7200 * 10 ** 9)
           for s in spans]
    from tempo_tpu_torch.block.schema import spans_by_trace
    for half in (old[:40], old[20:]):
        app.db.write_block("single-tenant", spans_by_trace(half),
                           replication_factor=1)
    assert app.db.compact_tenant_once("single-tenant") == 1
    assert app.db.compaction_stats["blocks"] == 2
    srv.shutdown()
    app.shutdown()
""" + _DRIVE_TAIL

_CONFIG_DRIVE = """
import sys
from tempo_tpu_torch.app import load_config
cfg = load_config(text="server: {http_listen_port: 9999}")
assert cfg.server.http_listen_port == 9999 and "yaml" in sys.modules
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu", "pyarrow")
             or m.startswith(("jax.", "tempo_tpu.", "pyarrow.")))
print("LOADED", bad)
"""


def test_app_drive_loads_no_reference_yaml_or_pyarrow():
    """`App(Config(), device="cpu")` at target `all` (the `local`
    backend, the default config's compaction loop and usage reporter):
    `start_loops`, `serve`, one OTLP push over HTTP, a find and a rate
    `query_range` over HTTP, one `compact_tenant_once`, shutdown, in a
    fresh interpreter: no `jax`, `tempo_tpu`, `yaml` or `pyarrow`."""
    _fresh(_APP_DRIVE)


def test_load_config_text_loads_yaml_and_no_reference():
    """`load_config(text=...)` is the one path that imports PyYAML; it
    loads no `jax`, `tempo_tpu` or `pyarrow`."""
    _fresh(_CONFIG_DRIVE)


_WAL_FLEET_DRIVE = """
import sys
import tempfile
import time
from tempo_tpu_torch.app import App
from tempo_tpu_torch.app.config import Config
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

now = time.time()
payload = encode_spans_otlp(synthetic_spans(48, seed=2,
                                            now_ns=int((now - 5) * 1e9)))
with tempfile.TemporaryDirectory() as root:
    def boot():
        cfg = Config()
        cfg.target = "metrics-generator"
        cfg.storage.local_path = root + "/blocks"
        cfg.storage.wal_path = root + "/wal"
        cfg.wal.enabled = True
        cfg.wal.dir = root + "/gwal"
        cfg.fleet.enabled = True
        cfg.usage_stats_enabled = False
        cfg.overrides_defaults.generator.processors = ["span-metrics"]
        cfg.overrides_defaults.generator.max_active_series = 1024
        app = App(cfg, now=lambda: now, device="cpu")
        app.start_loops()
        return app
    def state(app):
        inst = app.generator.instance("t")
        inst.drain()                     # the scheduler's window landed
        return sorted((s.name, s.labels, s.value)
                      for s in inst.registry.collect(1))
    a = boot()
    assert a.generator.push_otlp("t", payload) == 48
    want = state(a)
    a.fleet._stop.set()                  # abandoned: no shutdown
    b = boot()                           # boot tick replays the WAL
    assert state(b) == want
    b.fleet.cfg.checkpoint_on_shutdown = False
    b.shutdown()
""" + _DRIVE_TAIL

_KV_WORKER_DRIVE = """
import sys
import threading
import time
from tempo_tpu_torch.backend.mem import MemBackend
from tempo_tpu_torch.fleet import checkpoint as ck
from tempo_tpu_torch.fleet.controller import FleetController
from tempo_tpu_torch.fleet.placement import TenantPlacement
from tempo_tpu_torch.fleet.worker import make_kv_server
from tempo_tpu_torch.generator import Generator, GeneratorConfig
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
from tempo_tpu_torch.registry import RegistryOverrides
from tempo_tpu_torch.ring import Lifecycler, Ring
from tempo_tpu_torch.ring.kv import RemoteKVStore

srv = make_kv_server(0)
threading.Thread(target=srv.serve_forever, daemon=True).start()
kv = RemoteKVStore(f"http://127.0.0.1:{srv.kv_port}", poll_interval_s=0.05)
now = time.time()
payload = encode_spans_otlp(synthetic_spans(48, seed=2,
                                            now_ns=int((now - 5) * 1e9)))
be = MemBackend()
members = {}
for iid in ("g-a", "g-b"):
    g = Generator(GeneratorConfig(
        processors=("span-metrics",),
        registry=RegistryOverrides(max_active_series=1024)),
        instance_id=iid, now=lambda: now, device="cpu")
    ring = Ring(kv=kv, key="generator", replication_factor=1,
                now=lambda: now)
    lc = Lifecycler(kv, iid, key="generator", now=lambda: now)
    members[iid] = (g, lc, FleetController(g, ring, iid, be, be,
                                           now=lambda: now))
own = "g-a" if TenantPlacement(members["g-a"][2].ring, "g-a").owns("h") \\
    else "g-b"
other = "g-b" if own == "g-a" else "g-a"
members[own][0].push_otlp("h", payload)
members[own][1].leave()
members[own][2].tick()
members[other][2].tick()
assert "h" in members[other][0].tenants()
assert ck.list_checkpoints(be, "fleet-checkpoints") == {}
kv.shutdown()
srv.shutdown()
""" + _DRIVE_TAIL


def test_wal_fleet_drive_loads_no_reference_yaml_or_pyarrow():
    """An App at target `metrics-generator` with `wal` and `fleet` on, on
    the CPU: a push, the App abandoned, a second App over the same dirs
    replaying the WAL in its boot tick. No `jax`, `tempo_tpu`, `yaml` or
    `pyarrow` is loaded."""
    _fresh(_WAL_FLEET_DRIVE)


def test_kv_only_worker_drive_loads_no_reference_yaml_or_pyarrow():
    """The `--kv-only` worker's server (`fleet.worker.make_kv_server`)
    holding the ring of two `FleetController`s (through `RemoteKVStore`)
    that hand a tenant off over a `MemBackend` loads none of them
    either."""
    _fresh(_KV_WORKER_DRIVE)


_GRPC_CLI_DRIVE = """
import contextlib
import io
import sys
import tempfile
import time
import grpc
from tempo_tpu_torch.app import App
from tempo_tpu_torch.app.config import Config
from tempo_tpu_torch.cli.__main__ import main as cli_main
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

with tempfile.TemporaryDirectory() as root:
    cfg = Config()
    cfg.storage.local_path = root + "/blocks"
    cfg.storage.wal_path = root + "/wal"
    cfg.generator.localblocks.data_dir = root + "/lb"
    cfg.server.grpc_listen_port = 0
    app = App(cfg, device="cpu")
    app.overrides.set_tenant_patch("single-tenant", {"generator": {
        "processors": ["span-metrics"]}})
    from tempo_tpu_torch.grpcplane import build_grpc_server
    srv, port = build_grpc_server(app)
    spans = synthetic_spans(16, seed=1, now_ns=int((time.time() - 5) * 1e9))
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        export = ch.unary_unary(
            "/opentelemetry.proto.collector.trace.v1.TraceService/Export")
        assert export(encode_spans_otlp(spans), timeout=10) == b""
    app.sched.flush()
    assert app.generator.instance("single-tenant").spans_received == 16
    assert app.ingester.find_trace_by_id("single-tenant",
                                         spans[0]["trace_id"])
    srv.stop(0)
    app.shutdown()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli_main(["--path", root + "/blocks", "--device", "cpu",
                         "list", "blocks", "single-tenant"]) == 0
    # the ingester flushed the pushed traces into one block at shutdown
    assert "total: 1 blocks, 16 traces" in out.getvalue()
""" + _DRIVE_TAIL


_KAFKA_DRIVE = """
import sys
import time
from tempo_tpu_torch.generator import Generator
from tempo_tpu_torch.generator.instance import GeneratorConfig
from tempo_tpu_torch.generator.processors.spanmetrics import SpanMetricsConfig
from tempo_tpu_torch.ingest.encoding import encode_push
from tempo_tpu_torch.ingest.kafka import KafkaBus
from tempo_tpu_torch.overrides import Overrides
from tests.mock_kafka import start_mock_kafka

srv, port, broker = start_mock_kafka(n_partitions=2)
bus = KafkaBus(f"127.0.0.1:{port}", n_partitions=2, timeout_s=5.0)
t0 = int((time.time() - 3) * 1e9)
for p in range(2):
    tid = bytes([p + 1]) * 16
    bus.produce(p, "t", encode_push([(tid, [{
        "trace_id": tid, "span_id": b"s" * 8, "name": "op", "service": "svc",
        "start_unix_nano": t0, "end_unix_nano": t0 + 10 ** 6}])])[0])
assert broker.produce_batches == 2
ov = Overrides()
ov.set_tenant_patch("t", {"generator": {"processors": ["span-metrics"]}})
gen = Generator(GeneratorConfig(processors=("span-metrics",),
                                spanmetrics=SpanMetricsConfig(
                                    sketch_max_series=128)),
                overrides=ov, device="cpu")
assert gen.consume_bus(bus) == 2
assert gen._cgroups["metrics-generator"].assignment == [0, 1]
assert [bus.committed("metrics-generator", p) for p in range(2)] == [1, 1]
assert gen.instance("t").spans_received == 2
bus.close()
srv.shutdown()
""" + _DRIVE_TAIL

_MESH_DRIVE = """
import sys
import tempfile
import time
from tempo_tpu_torch.app import App
from tempo_tpu_torch.app.config import Config
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
from tempo_tpu_torch.parallel import serving

with tempfile.TemporaryDirectory() as root:
    cfg = Config(target="metrics-generator")
    cfg.storage.backend = "mem"
    cfg.storage.wal_path = root + "/wal"
    cfg.mesh.enabled = True
    cfg.sched.enabled = False
    app = App(cfg, device="cpu")
    assert app.mesh is serving.active() and app.mesh.series_shards == 1
    # logical shards: the App's mesh over 4 CPU shards
    sm = serving.ServingMesh(cfg.mesh, devices=["cpu"] * 4)
    with serving.use(sm):
        app.overrides.set_tenant_patch("single-tenant", {"generator": {
            "processors": ["span-metrics"], "max_active_series": 1024}})
        spans = synthetic_spans(32, seed=1,
                                now_ns=int((time.time() - 5) * 1e9))
        assert app.generator.push_otlp("single-tenant",
                                       encode_spans_otlp(spans)) == 32
        proc = app.generator.instance("single-tenant").processors[
            "span-metrics"]
        assert proc._mesh is sm and len(proc._mesh_plan.arenas) == 4
        got = sum(s.value for s in
                  app.generator.instance("single-tenant").registry.collect(1)
                  if s.name == "traces_spanmetrics_calls_total")
        assert got == 32, got
    app.shutdown()
""" + _DRIVE_TAIL


def test_kafka_drive_loads_no_reference_yaml_or_pyarrow():
    """A `KafkaBus` produce against the mock broker and a group-mode
    `Generator.consume_bus`, in a fresh interpreter: no `jax`,
    `tempo_tpu`, `yaml` or `pyarrow` is loaded."""
    _fresh(_KAFKA_DRIVE)


def test_mesh_app_drive_loads_no_reference_yaml_or_pyarrow():
    """An App with `mesh.enabled` (a 1 x 1 mesh over its CPU device), then
    a push and a collect with the tenant on 4 logical CPU series shards,
    in a fresh interpreter: no `jax`, `tempo_tpu`, `yaml` or `pyarrow`
    is loaded."""
    _fresh(_MESH_DRIVE)


def test_grpc_export_and_cli_drive_loads_no_reference_yaml_or_pyarrow():
    """An App's gRPC OTLP `Export` round trip (distributor, ingester, the
    generator's tee) and one `cli` command, in a fresh interpreter: no
    `jax`, `tempo_tpu`, `yaml` or `pyarrow` is loaded."""
    _fresh(_GRPC_CLI_DRIVE)
