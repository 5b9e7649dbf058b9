"""BENCHMARK.json holds to the contract's shape, and every piece it names
is found by name."""

import json
import re

import pytest

from portbench.core import spec
from portbench.core.record import Record

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 2 + 14 * cells <= 2 + 14 * 24
    # a full check of 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, cells // 4)


def test_names_units_and_bounds():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads(cell):
    c = spec.load_cell(cell)
    assert c.config["system"] == "generator"
    assert spec.system(c.config["system"]).run
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_readers_find_nothing_to_read(metric):
    rec = Record(end_to_end={}, correct=True, attempted=0, failed=0,
                 checks={}, memory_peak_bytes=0,
                 data={"counters": ({}, {}), "push_s": []})
    assert spec.reader(metric)(rec) is None
