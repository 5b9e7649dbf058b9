"""The control (the reference in bfloat16, put in the program's place)
fails the cell's comparison, and the float64 reference in the same place
passes it; at a size a test run holds. `python3 portbench/control.py`
reads the same at a cell's own size on the card's machine."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import control
from portbench.core import spec


def _small_gen():
    c = spec.load_cell("gen-collector")
    c.config = json.loads(json.dumps(c.config))
    c.traffic = dict(c.traffic, spans_per_payload=2048,
                     templates_per_client=2)
    return c


@pytest.mark.parametrize("seed", [11, 2**31 + 3])
def test_generator_control_fails(seed):
    c = _small_gen()
    lim = c.config["limits"]
    got = control.generator_control(c, seed, 6)
    assert any(got[k] > lim[k] for k in lim), got
    same = control.generator_control(c, seed, 6, dtype=torch.float64)
    assert all(same[k] <= lim[k] for k in lim), same


BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", cell,
         "--seed", str(2**31 + 9), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
