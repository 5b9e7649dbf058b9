"""Import and device guards of the PyTorch/CUDA port.

- A fresh interpreter imports `tempo_tpu_torch`, pushes, collects and
  reads a quantile on the CPU under the `sketch: dd` f32 tier and under
  `sketch: both` with compact state on paged state, and under `sketch:
  dd` on dense state (no pool), and ends with neither `jax` nor any
  `tempo_tpu` module loaded. The test is exact-prefix: `tempo_tpu_torch` itself starts with
  the string "tempo_tpu", so a module counts as the reference only when
  its name is `tempo_tpu` or starts with `tempo_tpu.`.
- No source file of the port, nor `chip_smoke.py`, imports either.
- Asking for `cuda` without a CUDA device raises.
- Every configuration this slice does not carry raises
  `NotImplementedError` instead of quietly doing something else.
"""

from __future__ import annotations

import ast
import os
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
bad = sorted(m for m in sys.modules
             if m in ("jax", "tempo_tpu") or m.startswith(("jax.", "tempo_tpu.")))
print("LOADED", bad)
"""


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
    """The scheduler route raises under every sketch and state tier."""
    with pytest.raises(NotImplementedError, match="later slice"):
        _instance(use_scheduler=True, **sm)


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
        with pytest.raises(NotImplementedError, match="later slice"):
            g.registry.new_native_histogram("h", ("a",))
        for proc in ("service-graphs", "local-blocks", "trace-analytics"):
            with pytest.raises(NotImplementedError, match="later slice"):
                tt.GeneratorInstance("t", tt.GeneratorConfig(
                    processors=("span-metrics", proc),
                    registry=tt.RegistryOverrides(max_active_series=512)),
                    device="cpu")
    g = _instance()
    with pytest.raises(NotImplementedError, match="staged native"):
        g.push_otlp_staged(b"")
    with pytest.raises(ValueError, match="unknown sketch"):
        _instance(sketch="hll")
    assert g.device_state_bytes() == 0    # no series yet: no pages backed
