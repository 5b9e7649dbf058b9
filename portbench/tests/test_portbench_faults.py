"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run of a cell's system on the CPU at a small size, with one fault
planted in the program where it produces its answer: a step that leaves
its state unchanged, half of each batch left out, and one answer
altered. The exchange between chips is not a fault these one-card cells
can have. The same run unbroken comes out correct.
"""

import json

import pytest
import torch

from portbench.core import spec
from portbench.systems import generator


def _gen_cell():
    c = spec.load_cell("gen-collector")
    c.config = json.loads(json.dumps(c.config))
    c.config.update(tenants=2, check_tenants=2)
    c.traffic = dict(c.traffic, spans_per_payload=256, templates_per_client=2,
                     warmup_pushes_per_client=1,
                     label_space=dict(c.traffic["label_space"], services=4,
                                      names=4))
    return c


def _unchanged(*args, **kw):
    return None


def _half(fused):
    def step(arenas, tables, batch, **kw):
        b = batch.clone() if isinstance(batch, torch.Tensor) else \
            tuple(torch.as_tensor(x).clone() for x in batch)
        n = b[0].shape[0]
        b[0][n // 2:] = -1           # the second half's slots: dropped
        return fused(arenas, tables, b, **kw)
    return step


def _altered(fused):
    def step(arenas, tables, batch, **kw):
        b = batch.clone() if isinstance(batch, torch.Tensor) else \
            tuple(torch.as_tensor(x).clone() for x in batch)
        b[1][0] += 1.0               # one span's seconds
        return fused(arenas, tables, b, **kw)
    return step


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_generator_cell_faults(monkeypatch, fault):
    from tempo_tpu_torch.ops import pages

    fused = pages.fused_step
    if fault is not None:
        monkeypatch.setattr(pages, "fused_step", {
            "unchanged": _unchanged, "half": _half(fused),
            "altered": _altered(fused)}[fault])
    rec = generator.run(_gen_cell(), 2**31 + 101, 0.5, False, device="cpu")
    assert rec.correct is (fault is None), rec.checks
