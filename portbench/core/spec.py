"""Finds a cell's pieces by the names in `BENCHMARK.json`.

A cell names a configuration and a traffic mix. The configuration's file
(`configs/<name>.json`, as `BENCHMARK.json` lists it) names the system
that runs it, `systems/<system>.py`; the traffic mix is the data file
`workloads/<traffic>.json`; each per-layer metric is read by
`metrics/<metric>.py`. A later cell, configuration or metric adds files
and entries here and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench_path: Path | None = None) -> Cell:
    bench = json.loads((bench_path or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((HERE / "workloads" / f"{w['traffic']}.json")
                           .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def system(name: str):
    """The module that runs a configuration's system."""
    return importlib.import_module(f"portbench.systems.{name}")


def reader(metric: str):
    """`metrics/<metric>.py`'s `read(record)`: a number, or None when the
    run gave it nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
