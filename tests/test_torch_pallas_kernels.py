"""The port's paged fused update against the JAX reference.

`tempo_tpu_torch.ops.cuda_kernels.paged_fused_update` on CPU tensors runs
its plain PyTorch version; it is held against the reference's Pallas
kernel in interpret mode and against its composed-scatter XLA step
(`tempo_tpu.ops.pages.fused_step(kernel="xla")`), at the small shapes of
tests/test_pallas_kernels.py, from the same seeded numpy inputs.

Tolerances (the reference's own contract between its kernel tiers):
integer-count planes (calls, latency count, histogram buckets, DDSketch
zeros and buckets) exact for integer weights; the two float sums
(latency sum, size) at rtol=1e-5, atol=1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.ops import pages as jop
from tempo_tpu.ops import pallas_kernels as jpk
from tempo_tpu_torch.ops import cuda_kernels as tck
from tempo_tpu_torch.ops import pages as top

EDGES = (0.002, 0.008, 0.032, 0.128, 0.512)
PAGE_ROWS = 8
PAGE_SHIFT = 3
N_PHYS = 6          # physical pages per arena, page 0 = trash
DD_GAMMA = 1.1
DD_MIN = 1e-6
DD_NB = 32
SUM_ROLES = (1, 3)  # hist_sums, sizes


def _arenas(seed, dd=True, fill=True):
    """Role arenas as numpy; backed pages 1..3 carry integer state."""
    rng = np.random.default_rng(seed)
    rows = N_PHYS * PAGE_ROWS
    shapes = [(rows,)] * 4 + [(rows, len(EDGES) + 1)]
    if dd:
        shapes += [(rows,), (rows, DD_NB)]
    out = []
    for shape in shapes:
        a = np.zeros(shape, np.float32)
        if fill:
            a[PAGE_ROWS:4 * PAGE_ROWS] = rng.integers(
                0, 5, a[PAGE_ROWS:4 * PAGE_ROWS].shape)
        out.append(a)
    return out


def _tables(n_roles, lpages=4):
    """Logical pages 0..2 backed by physical 1..3 (rotated per role),
    logical page 3 unbacked; the DDSketch roles cover only two logical
    pages, so the stacked table pads them with -1."""
    tabs = []
    for r in range(n_roles):
        t = np.full(2 if r >= 5 else lpages, -1, np.int32)
        t[:3 if r < 5 else 2] = np.roll([1, 2, 3], r)[:len(t[:3 if r < 5 else 2])]
        tabs.append(t)
    return tabs


def _stacked(tabs):
    p = max(len(t) for t in tabs)
    out = np.full((len(tabs), p), -1, np.int32)
    for r, t in enumerate(tabs):
        out[r, :len(t)] = t
    return out


def _batch(seed, n=32, lpages=4):
    rng = np.random.default_rng(seed)
    mat = np.empty((4, n), np.float32)
    mat[0] = rng.integers(-1, lpages * PAGE_ROWS, n)      # incl. discards
    mat[1] = rng.lognormal(-3, 1.5, n)
    mat[1, :3] = (DD_MIN, DD_MIN / 2, 0.0)                 # DDSketch zeros
    mat[2] = rng.integers(100, 5000, n)
    mat[3] = rng.integers(1, 4, n)                         # integer weights
    return mat


def _compare(ref, got, ctx):
    for r, (x, p) in enumerate(zip(ref, got)):
        x, p = np.asarray(x), np.asarray(p)
        if r in SUM_ROLES:
            np.testing.assert_allclose(p, x, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{ctx} role {r}")
        else:
            np.testing.assert_array_equal(p, x, err_msg=f"{ctx} role {r}")
        assert not p[:PAGE_ROWS].any(), f"{ctx} role {r}: trash page written"


def _port_update(arenas, tabs, slots, vals, dd_rows):
    ts = [torch.from_numpy(a.copy()) for a in arenas]
    tck.paged_fused_update(
        torch.from_numpy(_stacked(tabs)), torch.from_numpy(slots),
        torch.from_numpy(np.ascontiguousarray(vals)), ts,
        page_rows=PAGE_ROWS, edges=EDGES, gamma=DD_GAMMA, min_value=DD_MIN,
        dd_rows=dd_rows)
    return [t.numpy() for t in ts]


@pytest.mark.parametrize("dd", [True, False])
def test_plain_matches_pallas_interpret(dd):
    """The port's plain version vs the reference's Pallas kernel in
    interpret mode, on the stacked -1-padded tables the kernel takes."""
    n_roles = 7 if dd else 5
    dd_rows = 2 * PAGE_ROWS if dd else 0
    arenas = _arenas(0, dd)
    tabs = _tables(n_roles)
    mat = _batch(1)
    slots = mat[0].astype(np.int32)
    ref = jpk.paged_fused_update(
        jnp.asarray(_stacked(tabs)), jnp.asarray(slots), jnp.asarray(mat[1:]),
        tuple(jnp.asarray(a) for a in arenas), page_rows=PAGE_ROWS,
        edges=EDGES, gamma=DD_GAMMA, min_value=DD_MIN, dd_rows=dd_rows,
        mom_rows=0, mom_meta=None, interpret=True)
    got = _port_update(arenas, tabs, slots, mat[1:], dd_rows)
    _compare(ref, got, f"dd={dd}")
    assert tck.paged_fused_update.launches == 0  # host tensors: no kernel


@pytest.mark.parametrize("packed", [True, False])
def test_fused_step_matches_xla_tier(packed):
    """`ops.pages.fused_step` vs the reference's composed-scatter step over
    three batches from non-zero state: packed [4, N] and vector routes,
    discards, an unbacked page, slots >= dd_rows, per-role tables of
    different lengths."""
    dd_rows = 2 * PAGE_ROWS
    step = jop.fused_step(EDGES, DD_GAMMA, DD_MIN, dd_rows, PAGE_SHIFT,
                          packed, kernel="xla")
    arenas = _arenas(2)
    tabs = _tables(7)
    ref = tuple(jnp.asarray(a) for a in arenas)
    got = [torch.from_numpy(a.copy()) for a in arenas]
    stacked = torch.from_numpy(_stacked(tabs))
    for seed in range(3):
        mat = _batch(10 + seed)
        if packed:
            ref = step(*ref, *(jnp.asarray(t) for t in tabs), mat)
            top.fused_step(got, stacked, torch.from_numpy(mat),
                           edges=EDGES, gamma=DD_GAMMA, min_value=DD_MIN,
                           dd_rows=dd_rows, page_shift=PAGE_SHIFT)
        else:
            vec = (mat[0].astype(np.int32), mat[1], mat[2], mat[3])
            ref = step(*ref, *(jnp.asarray(t) for t in tabs), *vec)
            top.fused_step(got, stacked, vec, edges=EDGES, gamma=DD_GAMMA,
                           min_value=DD_MIN, dd_rows=dd_rows,
                           page_shift=PAGE_SHIFT)
    _compare(ref, [g.numpy() for g in got], f"packed={packed}")


def test_unbacked_and_discards_drop():
    """Discards and spans aimed at an unbacked logical page touch
    nothing, the trash page included."""
    arenas = _arenas(0, fill=False)
    mat = np.zeros((4, 16), np.float32)
    mat[0, :8] = -1
    mat[0, 8:] = 3 * PAGE_ROWS + np.arange(8)   # logical page 3: unbacked
    mat[1], mat[2], mat[3] = 0.5, 100.0, 1.0
    got = _port_update(arenas, _tables(7), mat[0].astype(np.int32), mat[1:],
                       2 * PAGE_ROWS)
    for r, a in enumerate(got):
        assert not a.any(), f"role {r} should be untouched"


def test_wrapper_checks_its_inputs():
    arenas = [torch.from_numpy(a) for a in _arenas(0)]
    tabs = torch.from_numpy(_stacked(_tables(7)))
    slots = torch.zeros(4, dtype=torch.int32)
    vals = torch.zeros(3, 4)
    kw = dict(page_rows=PAGE_ROWS, edges=EDGES, gamma=DD_GAMMA,
              min_value=DD_MIN, dd_rows=2 * PAGE_ROWS)
    with pytest.raises(ValueError, match="arenas"):
        tck.paged_fused_update(tabs, slots, vals, arenas[:5], **kw)
    with pytest.raises(ValueError, match="tables"):
        tck.paged_fused_update(tabs.long(), slots, vals, arenas, **kw)
    with pytest.raises(ValueError, match="vals"):
        tck.paged_fused_update(tabs, slots, vals[:2], arenas, **kw)
    with pytest.raises(ValueError, match="power of two"):
        tck.paged_fused_update(tabs, slots, vals, arenas,
                               **dict(kw, page_rows=6))


# ---------------------------------------------------------------------------
# DDSketch bucket index at the default deployment's widths
# ---------------------------------------------------------------------------

REL_ERR, MIN_S, MAX_S = 0.01, 1e-6, 1e5     # spanmetrics defaults


def _dd_grids(values, n_slots):
    """DDSketch grids of `values` (span i → slot i % n_slots) through the
    reference's XLA step and the port's fused step, at page_rows 256."""
    from tempo_tpu.ops.sketches import dd_params
    gamma, nb = dd_params(REL_ERR, MIN_S, MAX_S)
    shift = 8
    lpages = -(-n_slots // 256)
    rows = (lpages + 1) * 256
    tabs = [np.arange(1, lpages + 1, dtype=np.int32)] * 7
    n = len(values)
    mat = np.zeros((4, n), np.float32)
    mat[0] = np.arange(n) % n_slots
    mat[1] = values
    mat[3] = 1.0
    arenas = [np.zeros(rows, np.float32) for _ in range(4)] + [
        np.zeros((rows, len(EDGES) + 1), np.float32),
        np.zeros(rows, np.float32), np.zeros((rows, nb), np.float32)]
    step = jop.fused_step(EDGES, gamma, MIN_S, lpages * 256, shift, True,
                          kernel="xla")
    ref = np.asarray(step(*(jnp.asarray(a) for a in arenas),
                          *(jnp.asarray(t) for t in tabs), mat)[6])
    got = [torch.from_numpy(a) for a in arenas]
    top.fused_step(got, torch.from_numpy(_stacked(tabs)),
                   torch.from_numpy(mat), edges=EDGES, gamma=gamma,
                   min_value=MIN_S, dd_rows=lpages * 256, page_shift=shift)
    live = slice(256, 256 + n_slots)   # logical slot s → arena row 256 + s
    return ref[live], got[6].numpy()[live], gamma, nb


def test_dd_index_lognormal_exact():
    """On lognormal durations the DDSketch grid is bit-identical."""
    v = np.random.default_rng(5).lognormal(-3, 2.5, 65536).astype(np.float32)
    ref, got, _, _ = _dd_grids(v, 256)
    np.testing.assert_array_equal(got, ref)


def test_dd_index_edge_probe():
    """Durations placed on the bucket edges min·γ^i and on the f32 values
    next to them. torch's f32 `log` and XLA's differ by one ulp on some
    inputs, so some of these probes land one bucket apart: measured on an
    x86 CPU, 499 of the 3,801 probes (90 below an edge, 167 on it, 242
    above it), all by one bucket. The exception is at most one bucket,
    only within one ulp of an edge; random durations stay bit-identical
    (`test_dd_index_lognormal_exact`)."""
    from tempo_tpu.ops.sketches import dd_params
    gamma, nb = dd_params(REL_ERR, MIN_S, MAX_S)
    edges = (MIN_S * np.power(gamma, np.arange(1, nb - 1))).astype(np.float32)
    probes = np.concatenate([np.nextafter(edges, np.float32(0)), edges,
                             np.nextafter(edges, np.float32(np.inf))])
    ref, got, _, _ = _dd_grids(probes, len(probes))
    ib_ref, ib_got = ref.argmax(axis=1), got.argmax(axis=1)
    assert (ref.sum(axis=1) == 1).all() and (got.sum(axis=1) == 1).all()
    shift = ib_got - ib_ref
    n_shifted = int((shift != 0).sum())
    assert np.abs(shift).max() <= 1, "a probe moved more than one bucket"
    assert n_shifted <= len(probes) // 6, n_shifted
    print(f"dd edge probe: {n_shifted} of {len(probes)} shifted one bucket")
