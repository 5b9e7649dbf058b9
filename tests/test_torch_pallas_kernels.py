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
from tempo_tpu_torch.registry.registry import DEFAULT_HISTOGRAM_EDGES

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


def test_wrapper_takes_arenas_of_their_own_row_counts():
    """Each role's arena may have its own row count (dense state sizes the
    sketch arenas to dd_rows) as long as its table names only its pages:
    arenas cut to the pages their tables name give the rows the uniform
    arenas give. The uniform (paged) case validates as before."""
    arenas, tabs = _arenas(0), _tables(7)
    last = [max(t) + 1 for t in tabs]                 # pages each table needs
    mat = _batch(1)
    slots, vals = mat[0].astype(np.int32), mat[1:]
    want = _port_update(arenas, tabs, slots, vals, 2 * PAGE_ROWS)
    cut = [a[:n * PAGE_ROWS] for a, n in zip(arenas, last)]
    assert len({a.shape[0] for a in cut}) > 1
    got = _port_update(cut, tabs, slots, vals, 2 * PAGE_ROWS)
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w[:g.shape[0]], err_msg=f"role {r}")


def test_wrapper_refuses_a_table_past_its_arena():
    """A table entry past its own arena's last page raises `ValueError`,
    whatever the other arenas' row counts."""
    arenas, tabs = _arenas(0), _tables(7)
    cut = [a if r != 6 else a[:3 * PAGE_ROWS] for r, a in enumerate(arenas)]
    tabs[6] = np.array([1, 3], np.int32)              # page 3 of a 3-page arena
    with pytest.raises(ValueError, match="role 6 names physical page 3"):
        _port_update(cut, tabs, np.zeros(4, np.int32),
                     np.zeros((3, 4), np.float32), 2 * PAGE_ROWS)
    with pytest.raises(ValueError, match="not a multiple"):
        _port_update([a[:-1] if r == 6 else a for r, a in enumerate(arenas)],
                     _tables(7), np.zeros(4, np.int32),
                     np.zeros((3, 4), np.float32), 2 * PAGE_ROWS)


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


# ---------------------------------------------------------------------------
# moments and compact branches, three dispatches from non-zero state
# ---------------------------------------------------------------------------

MOM_META = (4, float(np.log(1e-6)), float(np.log(1e5)))
# calls, hist_counts, hist_buckets, dd_zeros, dd_counts under compact
INT_ROLES = (0, 2, 4, 5, 6)


def _roles(dd, mom):
    return 5 + (2 if dd else 0) + (1 if mom else 0)


def _state(seed, dd, mom, compact):
    """Role arenas with non-zero state on the backed pages 1..3, in the
    storage of the tier: f32, or int32 counts, a bf16 (sum, compensation)
    pair for the latency sum, f32 sizes and moments."""
    rng = np.random.default_rng(seed)
    rows = N_PHYS * PAGE_ROWS
    live = slice(PAGE_ROWS, 4 * PAGE_ROWS)
    out = []
    for r in range(_roles(dd, mom)):
        is_mom = mom and r == _roles(dd, mom) - 1
        width = MOM_META[0] + 3 if is_mom else {4: len(EDGES) + 1,
                                                6: DD_NB}.get(r)
        if compact and r == 1:
            pair = np.zeros((rows, 2), np.float32)
            pair[live, 0] = rng.integers(0, 64, 3 * PAGE_ROWS) / 8
            pair[live, 1] = rng.integers(-4, 5, 3 * PAGE_ROWS) / 1024
            out.append(torch.from_numpy(pair).to(torch.bfloat16))
            continue
        a = np.zeros((rows,) if width is None else (rows, width), np.float32)
        a[live] = rng.integers(0, 5, a[live].shape)
        int32 = compact and r in INT_ROLES and not is_mom
        dt = torch.int32 if int32 else torch.float32
        out.append(torch.from_numpy(a).to(dt))
    return out


def _dispatch(seed, arm, n=48):
    """A [4, n] batch. Dyadic arm: weights in {0.25, 0.5, 1, 1.5, 2.5},
    durations multiples of 1/1024, so every f32 delta is exact; the first
    five spans pin per-dispatch deltas of 0.5, 2.5 and 1.5 on slots 0..2,
    which no other span touches (half-to-even rounding: 0, 2, 2).
    Lognormal arm: lognormal durations, integer weights."""
    rng = np.random.default_rng(seed)
    mat = np.empty((4, n), np.float32)
    mat[0] = rng.integers(-1, 4 * PAGE_ROWS, n)          # incl. discards
    mat[0][(mat[0] >= 0) & (mat[0] < 3)] = 3
    mat[2] = rng.integers(100, 5000, n)
    if arm == "dyadic":
        mat[1] = rng.integers(1, 8 * 1024, n) / 1024
        mat[3] = rng.choice([0.25, 0.5, 1.0, 1.5, 2.5], n)
        mat[0, :5] = (0, 0, 1, 2, 2)
        mat[3, :5] = (0.25, 0.25, 2.5, 0.5, 1.0)
    else:
        mat[1] = rng.lognormal(-3, 1.5, n)
        mat[3] = rng.integers(1, 4, n)
    mat[1, 5:8] = (DD_MIN, DD_MIN / 2, 0.0)              # DDSketch zeros
    return mat


def _k1_kw(dd, mom, compact):
    return dict(page_rows=PAGE_ROWS, edges=EDGES, gamma=DD_GAMMA,
                min_value=DD_MIN, dd_rows=2 * PAGE_ROWS if dd else 0,
                mom_rows=3 * PAGE_ROWS if mom else 0,
                mom_meta=MOM_META if mom else None, compact=compact)


def _run_both(dd, mom, compact, arm, dispatches=3):
    """Three dispatches through the reference's Pallas kernel (interpret
    mode) and the port's wrapper on CPU tensors (its plain version)."""
    kw = _k1_kw(dd, mom, compact)
    got = _state(20, dd, mom, compact)
    # copies: JAX may wrap host memory without copying it and reads it
    # asynchronously, while the port's update below writes `got` in place
    ref = tuple(jnp.asarray(_to_np(a).copy()) if a.dtype != torch.bfloat16
                else jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                for a in got)
    tabs = _stacked(_tables(_roles(dd, mom)))
    for d in range(dispatches):
        mat = _dispatch(30 + d, arm)
        slots = mat[0].astype(np.int32)
        ref = jpk.paged_fused_update(
            jnp.asarray(tabs), jnp.asarray(slots), jnp.asarray(mat[1:]), ref,
            interpret=True, **kw)
        tck.paged_fused_update(torch.from_numpy(tabs), torch.from_numpy(slots),
                               torch.from_numpy(mat[1:].copy()), got, **kw)
    return [_ref_np(x) for x in ref], [_to_np(g) for g in got]


def _to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ref_np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _assert_moments(ref, got, ctx, exact_sums=False):
    """Moment columns take a `log`, and XLA's f32 log and torch's differ
    by an ulp on some inputs: sums at rtol 1e-5, atol 1e-6 (each basis
    term is in [-1, 1] times the weight); the two bound columns at
    atol 2e-6, one f32 ulp of a value in [16, 32)."""
    k = MOM_META[0]
    np.testing.assert_allclose(got[:, :k + 1], ref[:, :k + 1], rtol=1e-5,
                               atol=1e-6, err_msg=f"{ctx} moment sums")
    np.testing.assert_allclose(got[:, k + 1:], ref[:, k + 1:], rtol=0,
                               atol=2e-6, err_msg=f"{ctx} moment bounds")


COMBOS = [(dd, mom, compact) for dd in (True, False) for mom in (True, False)
          for compact in (True, False)]


@pytest.mark.parametrize("dd,mom,compact", COMBOS)
def test_plain_matches_pallas_dyadic(dd, mom, compact):
    """Dyadic arm: every f32 delta is exact, so the int32 planes, the bf16
    pair (as stored) and the f32 sums are bit-identical to the
    reference's Pallas kernel over three dispatches, and the half-way
    per-dispatch deltas round to even; moment columns under
    `_assert_moments`; page 0 stays zero."""
    ref, got = _run_both(dd, mom, compact, "dyadic")
    n_roles = _roles(dd, mom)
    for r, (x, p) in enumerate(zip(ref, got)):
        ctx = f"dd={dd} mom={mom} compact={compact} role {r}"
        if mom and r == n_roles - 1:
            _assert_moments(x, p, ctx)
        else:
            np.testing.assert_array_equal(p, x, err_msg=ctx)
        assert not p[:PAGE_ROWS].any(), f"{ctx}: trash page written"
    if compact:
        # slots 0..2 sit on logical page 0 → physical page 1 of calls;
        # their per-dispatch deltas 0.5, 2.5, 1.5 round to 0, 2, 2
        start = _state(20, dd, mom, compact)[0].numpy()
        np.testing.assert_array_equal(
            got[0][PAGE_ROWS:PAGE_ROWS + 3] - start[PAGE_ROWS:PAGE_ROWS + 3],
            [0, 6, 6])


@pytest.mark.parametrize("dd,mom,compact", COMBOS)
def test_plain_matches_pallas_lognormal(dd, mom, compact):
    """Lognormal arm (integer weights): int32 and integer-count planes
    exact; f32 sums at rtol 1e-5, atol 1e-6; moments under
    `_assert_moments`; the bf16 pair folded (sum + compensation) within
    the reference's documented compact envelope, 1% relative."""
    ref, got = _run_both(dd, mom, compact, "lognormal")
    n_roles = _roles(dd, mom)
    for r, (x, p) in enumerate(zip(ref, got)):
        ctx = f"dd={dd} mom={mom} compact={compact} role {r}"
        if mom and r == n_roles - 1:
            _assert_moments(x, p, ctx)
        elif r == 1 and compact:
            np.testing.assert_allclose(p.sum(axis=1), x.sum(axis=1),
                                       rtol=1e-2, atol=1e-6, err_msg=ctx)
        elif r in SUM_ROLES:
            np.testing.assert_allclose(p, x, rtol=1e-5, atol=1e-6,
                                       err_msg=ctx)
        else:
            np.testing.assert_array_equal(p, x, err_msg=ctx)
        assert not p[:PAGE_ROWS].any(), f"{ctx}: trash page written"


def test_fused_step_with_moments_matches_xla_tier():
    """With f32 state the two reference tiers agree within tolerance, and
    the port's plain version matches the composed-scatter one too:
    `ops.pages.fused_step` with the moments plane vs the reference's XLA
    step, over three dispatches."""
    kw = _k1_kw(True, True, False)
    step = jop.fused_step(EDGES, DD_GAMMA, DD_MIN, kw["dd_rows"], PAGE_SHIFT,
                          True, mom_rows=kw["mom_rows"], mom_meta=MOM_META,
                          kernel="xla")
    got = _state(21, True, True, False)
    ref = tuple(jnp.asarray(a.numpy().copy()) for a in got)  # see _run_both
    tabs = _tables(8)
    for d in range(3):
        mat = _dispatch(40 + d, "lognormal")
        ref = step(*ref, *(jnp.asarray(t) for t in tabs), mat)
        top.fused_step(got, torch.from_numpy(_stacked(tabs)),
                       torch.from_numpy(mat), edges=EDGES, gamma=DD_GAMMA,
                       min_value=DD_MIN, dd_rows=kw["dd_rows"],
                       page_shift=PAGE_SHIFT, mom_rows=kw["mom_rows"],
                       mom_meta=MOM_META)
    _compare(ref[:7], [g.numpy() for g in got[:7]], "moments")
    _assert_moments(np.asarray(ref[7]), got[7].numpy(), "moments")


def test_wrapper_checks_compact_dtypes():
    kw = _k1_kw(True, True, True)
    arenas = _state(0, True, True, True)
    tabs = torch.from_numpy(_stacked(_tables(8)))
    slots, vals = torch.zeros(4, dtype=torch.int32), torch.zeros(3, 4)
    tck.paged_fused_update(tabs, slots, vals, arenas, **kw)
    bad = list(arenas)
    bad[0] = bad[0].float()
    with pytest.raises(ValueError, match="arena 0"):
        tck.paged_fused_update(tabs, slots, vals, bad, **kw)
    with pytest.raises(ValueError, match="arena 0: want torch.float32"):
        tck.paged_fused_update(tabs, slots, vals, arenas,
                               **dict(kw, compact=False))
    with pytest.raises(ValueError, match="mom_meta"):
        tck.paged_fused_update(tabs, slots, vals, arenas,
                               **dict(kw, mom_meta=None))


# ---------------------------------------------------------------------------
# K2: the dense fused span-metrics delta
# ---------------------------------------------------------------------------

# the reference benchmark's edges (benchmarks/bench_kernels.py:22, F = 16),
# the registry's default edges (F = 18) and none (F = 4)
K2_EDGE_SETS = {
    "bench": (0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.128, 0.256, 0.512,
              1.024, 2.048, 4.096),
    "default": DEFAULT_HISTOGRAM_EDGES,
    "none": (),
}


def _k2_batch(seed, n, s, slots_kind, edges):
    """K2 inputs: `uniform` slots over [-2, s + 3), or `zipf` slots (a =
    1.1 over s series, 5% discards, a few past the range); lognormal
    durations, four of them on an edge; integer sizes and weights."""
    rng = np.random.default_rng(seed)
    if slots_kind == "uniform":
        slots = rng.integers(-2, s + 3, n)
    else:
        p = 1.0 / np.arange(1, s + 1) ** 1.1
        slots = rng.permutation(s)[rng.choice(s, size=n, p=p / p.sum())]
        slots[rng.random(n) < 0.05] = -1
        slots[:3] = (s, s + 1, -5)
    dur = rng.lognormal(-3, 2.0, n).astype(np.float32)
    dur[3:3 + min(4, len(edges))] = edges[:4]    # on an edge: lower bucket
    sizes = rng.integers(100, 5000, n).astype(np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    return slots.astype(np.int32), dur, sizes, w


@pytest.mark.parametrize("slots_kind", ["uniform", "zipf"])
@pytest.mark.parametrize("edge_set", list(K2_EDGE_SETS))
def test_k2_plain_matches_reference(edge_set, slots_kind):
    """The port's K2 on CPU tensors (its plain version, the scatter twin)
    against the reference's Pallas kernel in interpret mode and its XLA
    scatter twin, with negative and out-of-range slots, uniform or
    Zipf-skewed: count and histogram columns exact for integer weights,
    sums at rtol 1e-5."""
    from tempo_tpu.ops.pallas_kernels import (fused_spanmetrics_matmul,
                                              fused_spanmetrics_scatter)

    edges = K2_EDGE_SETS[edge_set]
    n, s = 1024, 64
    slots, dur, sizes, w = _k2_batch(len(edges), n, s, slots_kind, edges)
    j = [jnp.asarray(x) for x in (slots, dur, sizes, w)]
    ref_mm = np.asarray(fused_spanmetrics_matmul(*j, n_series=s, edges=edges,
                                                 block=256, interpret=True))
    ref_sc = np.asarray(fused_spanmetrics_scatter(*j, n_series=s,
                                                  edges=edges))
    got = tck.fused_spanmetrics_matmul(
        *(torch.from_numpy(x) for x in (slots, dur, sizes, w)), n_series=s,
        edges=edges).numpy()
    assert got.shape == (s, 4 + len(edges))
    exact = [0] + list(range(3, got.shape[1]))
    for ref in (ref_mm, ref_sc):
        np.testing.assert_array_equal(got[:, exact], ref[:, exact])
        np.testing.assert_allclose(got[:, 1:3], ref[:, 1:3], rtol=1e-5)
    keep = (slots >= 0) & (slots < s)
    assert got[:, 0].sum() == w[keep].sum()
    assert tck.fused_spanmetrics_matmul.launches == 0


def test_k2_wrapper_checks_its_inputs():
    z = torch.zeros(4)
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 slots"):
        tck.fused_spanmetrics_matmul(z, z, z, z, n_series=4, edges=EDGES)
    with pytest.raises(ValueError, match="int32 slots"):
        tck.fused_spanmetrics_matmul(i32, z, z[:3], z, n_series=4,
                                     edges=EDGES)
    with pytest.raises(ValueError, match="contiguous"):
        tck.fused_spanmetrics_matmul(i32, torch.zeros(8)[::2], z, z,
                                     n_series=4, edges=EDGES)
    with pytest.raises(ValueError, match="at most 64"):
        tck.fused_spanmetrics_matmul(i32, z, z, z, n_series=4,
                                     edges=tuple(range(65)))
    m = z.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tck.fused_spanmetrics_matmul(i32.to("meta"), m, m, m, n_series=4,
                                     edges=EDGES)


def _k2_ops(o, b, total):
    """The atomics K2's `span_add` issues for one span whose row starts at
    flat cell `o`, with bucket `b`, into an output of `total` cells: a
    list of (first cell, lanes), each lane the span column it adds (0..2,
    3 for the bucket column 3 + b) or None for +0.0. Four lanes are one
    float4 atomic on a 16 B quad, one lane a scalar atomic."""
    q0, q2, qh = o >> 2, (o + 2) >> 2, (o + 3 + b) >> 2
    if 4 * q2 + 4 > total:
        return [(o, [0]), (o + 1, [1]), (o + 2, [2]), (o + 3 + b, [3])]
    p = o & 3
    a, c = [None] * 4, [None] * 4
    a[p] = 0
    for col in (1, 2):
        if p + col < 4:
            a[p + col] = col
        else:
            c[p + col - 4] = col
    ops = [(4 * q0, a)]
    if q2 != q0:
        ops.append((4 * q2, c))
    if qh == q0:
        a[(o + 3 + b) & 3] = 3
    elif qh == q2:
        c[(o + 3 + b) & 3] = 3
    else:
        ops.append((o + 3 + b, [3]))
    return ops


K2_SHAPES = [(4096, 262144, 12), (65536, 16384, 14), (4099, 1000, 13),
             (65536, 0, 14), (4096, 4 * 256 * 132, 12),
             (4096, 4 * 256 * 132 - 1, 12)]


@pytest.mark.parametrize("n_series,n,n_edges", K2_SHAPES)
def test_k2_layout(n_series, n, n_edges):
    """K2's launch choices at the bench shape, the deployment shape, a
    series count and row stride that leave the output's last quad
    ragged, no spans, and either side of the spans-a-thread switch: the
    span pass covers [0, n) once, uses no
    shared memory beyond a block's 227 KB, and every span's cells go out
    as vector atomics on 16 B quads of the output (the vector width
    divides the quad grid the kernel adds on, whatever the row stride)
    or as scalars where a quad would run past the end; every one of its
    four cells taken exactly once."""
    lay = tck.k2_layout(n, n_series, n_edges)
    f = n_edges + 4
    assert lay.row_stride == f and lay.smem_bytes <= 232448
    per_block = lay.block * lay.spans_per_thread
    assert lay.blocks * per_block >= n > (lay.blocks - 1) * per_block or \
        n == lay.blocks == 0
    assert lay.launches == (2 if n else 1)
    # four spans a thread only while that still gives every SM a block
    assert lay.spans_per_thread == (4 if n >= 4 * lay.block * 132 else 1)
    total = n_series * f
    for s in (0, 1, 2, 3, n_series - 2, n_series - 1):
        for b in range(n_edges + 1):
            o = s * f
            ops = _k2_ops(o, b, total)
            cells = [at + j for at, lanes in ops
                     for j, col in enumerate(lanes) if col is not None]
            assert sorted(cells) == [o, o + 1, o + 2, o + 3 + b]
            for at, lanes in ops:
                assert len(lanes) in (1, lay.vector)
                if len(lanes) == lay.vector:
                    assert at % lay.vector == 0 and at + lay.vector <= total
            # two vector atomics and a scalar at most, or four scalars
            assert len(ops) <= 3 or all(len(lanes) == 1 for _, lanes in ops)


@pytest.mark.parametrize("n_series,edge_set", [(64, "bench"), (64, "default"),
                                               (64, "none"), (63, "default"),
                                               (61, "bench")])
def test_k2_quad_plan_matches_scatter(n_series, edge_set):
    """The kernel's quad plan (`_k2_ops`, adds of +0.0 included) applied
    span by span in f32 equals the plain version on the exact columns
    bit for bit, the sums at rtol 1e-5: the identity behind K2's float4
    atomics, at F = 16, 18 and 4 and with the last row's quad ragged."""
    edges = K2_EDGE_SETS[edge_set]
    slots, dur, sizes, w = _k2_batch(7, 2048, n_series, "zipf", edges)
    f = len(edges) + 4
    total = n_series * f
    buf = np.zeros(-(-total // 4) * 4, np.float32)
    bucket = (dur[:, None] > np.asarray(edges, np.float32)[None, :]).sum(1)
    for i in range(len(slots)):
        if not 0 <= slots[i] < n_series:
            continue
        vals = (w[i], np.float32(dur[i] * w[i]), np.float32(sizes[i] * w[i]),
                w[i])
        for at, lanes in _k2_ops(int(slots[i]) * f, int(bucket[i]), total):
            for j, col in enumerate(lanes):
                buf[at + j] += np.float32(0.0) if col is None else vals[col]
    assert not buf[total:].any()
    got = buf[:total].reshape(n_series, f)
    ref = tck.fused_spanmetrics_scatter(
        *(torch.from_numpy(x) for x in (slots, dur, sizes, w)),
        n_series=n_series, edges=edges).numpy()
    exact = [0] + list(range(3, f))
    np.testing.assert_array_equal(got[:, exact], ref[:, exact])
    np.testing.assert_allclose(got[:, 1:3], ref[:, 1:3], rtol=1e-5)
    assert not np.signbit(got).any()        # +0.0 lanes leave no -0.0


def test_k2_params_block_matches_the_source():
    """`FsmParams` and the launch constants in `fused_spanmetrics.cu`
    against the wrapper's `_K2_FIELDS` and `k2_layout`'s choices; the
    packed block holds n_series, the edge count and the padded edges."""
    import re
    import struct

    src = (tck._CSRC / "fused_spanmetrics.cu").read_text()
    body = re.search(r"struct FsmParams \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for m in re.finditer(r"^\s*(int|float)\s+(\w+)(?:\[(\w+)\])?;", body,
                         re.M):
        kind, name, count = m.groups()
        n = int(re.search(rf"#define {count} (\d+)", src).group(1)) \
            if count else 1
        fields.append((name, f"{n}{kind[0]}" if count else kind[0]))
    assert fields == list(tck._K2_FIELDS)
    for macro, want in (("FSM_BLOCK", tck.K2_BLOCK),
                        ("FSM_MAX_EDGES", tck.MAX_EDGES)):
        assert int(re.search(rf"#define {macro} (\d+)", src).group(1)) == want
    # the launch instantiates the pass for each spans-a-thread count the
    # layout may pick
    for spt in {tck.k2_layout(n, 1, 0).spans_per_thread
                for n in (1, tck.K2_SPT4_MIN_SPANS)}:
        assert f"fsm_span_kernel<{spt}, " in src
    edges = K2_EDGE_SETS["default"]
    buf, addr, nbytes = tck._k2_params_of(65536, edges)
    assert nbytes == struct.calcsize(tck._K2_FORMAT) == 4 * (2 + tck.MAX_EDGES)
    got = struct.unpack(tck._K2_FORMAT, buf.raw)
    assert got[:2] == (65536, len(edges))
    np.testing.assert_array_equal(
        got[2:], np.float32(list(edges) + [0.0] * (tck.MAX_EDGES - len(edges))))
    assert tck._k2_params_of(65536, edges)[1] == addr     # packed once


# ---------------------------------------------------------------------------
# the identity K1's compact fold relies on, and its host-side contract
# ---------------------------------------------------------------------------

def _touched_cells(mat, n_lrows, dd_rows, mom_rows):
    """Per role, the flat cells of its logical-row delta that the batch's
    spans add to (what the kernel's `span_cells` yields), in numpy."""
    s = mat[0].astype(np.int64)
    dur = mat[1]
    ok = (s >= 0) & (s < n_lrows)
    hb = (dur[:, None] > np.asarray(EDGES, np.float32)[None, :]).sum(axis=1)
    cells = {r: s[ok] for r in range(4)}
    cells[4] = s[ok] * (len(EDGES) + 1) + hb[ok]
    if dd_rows:
        zero = dur <= np.float32(DD_MIN)
        idx = top.dd_index(torch.from_numpy(dur.copy()), DD_GAMMA, DD_MIN,
                           DD_NB).numpy()
        in_dd = ok & (s < dd_rows)
        cells[5] = s[in_dd & zero]
        cells[6] = s[in_dd & ~zero] * DD_NB + idx[in_dd & ~zero]
    if mom_rows:
        width = MOM_META[0] + 3
        rows = s[ok & (s < mom_rows)]
        cells[_roles(bool(dd_rows), True) - 1] = (
            rows[:, None] * width + np.arange(width)[None, :]).reshape(-1)
    return cells


def _fold_batch(seed):
    """A dyadic batch (deltas 0.5, 2.5, 1.5 pinned on slots 0..2), plus
    slot 12 (backed in every role) taking weights +1.5 and -1.5 on one
    duration, so its calls and moment-sum deltas are exactly 0 while its
    bounds are not; spans on the unbacked logical page 3 and on slots >=
    dd_rows."""
    mat = _dispatch(seed, "dyadic")
    mat[0][(mat[0] == 12)] = 13
    mat[0, 8:10] = 12
    mat[1, 8:10] = 0.125
    mat[3, 8:10] = (1.5, -1.5)
    assert (mat[0] >= 3 * PAGE_ROWS).any() and (mat[0] >= 2 * PAGE_ROWS).any()
    return mat


@pytest.mark.parametrize("dd,mom,compact", COMBOS)
def test_fold_of_touched_cells_matches_full_fold(dd, mom, compact):
    """`fold_deltas` of the whole-dispatch deltas equals `fold_deltas` of
    the same deltas kept only on the cells the spans map to (the pair role
    left whole: it is folded on every backed row), bit for bit: the
    identity behind K1's fold of touched cells."""
    kw = _k1_kw(dd, mom, compact)
    n_roles = _roles(dd, mom)
    tabs = torch.from_numpy(_stacked(_tables(n_roles)))
    mat = _fold_batch(50)
    n_lrows = tabs.shape[1] * PAGE_ROWS
    deltas = top.dispatch_deltas(
        torch.from_numpy(mat[0].astype(np.int32)), torch.from_numpy(mat[1:]),
        n_lrows=n_lrows, edges=EDGES, gamma=DD_GAMMA, min_value=DD_MIN,
        dd_rows=kw["dd_rows"], nb_dd=DD_NB if dd else 0,
        mom_rows=kw["mom_rows"], mom_meta=kw["mom_meta"],
        page_shift=PAGE_SHIFT)
    cells = _touched_cells(mat, n_lrows, kw["dd_rows"], kw["mom_rows"])
    kept = []
    for r, d in enumerate(deltas):
        if compact and r == 1:
            kept.append(d.clone())
            continue
        k = torch.zeros_like(d).reshape(-1)
        at = torch.from_numpy(cells[r])
        k[at] = d.reshape(-1)[at]
        kept.append(k.reshape(d.shape))
    mom_k = MOM_META[0] if mom else None
    full = _state(60, dd, mom, compact)
    part = [a.clone() for a in full]
    top.fold_deltas(full, tabs, deltas, page_shift=PAGE_SHIFT, mom_k=mom_k)
    top.fold_deltas(part, tabs, kept, page_shift=PAGE_SHIFT, mom_k=mom_k)
    for r, (a, b) in enumerate(zip(full, part)):
        assert torch.equal(a, b), f"role {r}"
    if mom:   # slot 12: zero moment sums, non-zero bounds
        row = deltas[-1][12]
        assert not row[:MOM_META[0] + 1].any() and row[MOM_META[0] + 1:].all()
    if compact:   # the half-way deltas are there to be rounded
        np.testing.assert_array_equal(deltas[0][:3].numpy(), [0.5, 2.5, 1.5])


def test_wrapper_checks_compact_scratch():
    """A compact call's scratch must be contiguous f32 of the layout's
    size on the arenas' device; the check runs before any dispatch, so it
    needs no card. The CPU path leaves a right scratch all zero."""
    kw = _k1_kw(True, True, True)
    arenas = _state(0, True, True, True)
    tabs = torch.from_numpy(_stacked(_tables(8)))
    slots = torch.from_numpy(_dispatch(1, "dyadic")[0].astype(np.int32))
    vals = torch.from_numpy(_dispatch(1, "dyadic")[1:].copy())
    scratch = tck.compact_scratch(tabs, arenas, page_rows=PAGE_ROWS,
                                  edges=EDGES, dd_rows=kw["dd_rows"])
    n_lrows = tabs.shape[1] * PAGE_ROWS
    assert scratch.numel() == n_lrows * (3 + len(EDGES) + 1) + \
        kw["dd_rows"] * (1 + DD_NB)
    tck.paged_fused_update(tabs, slots, vals, arenas, **kw, scratch=scratch)
    assert not scratch.any()
    for bad in (scratch[:-1], scratch.double(), scratch.to("meta"),
                torch.zeros(scratch.numel(), 2)[:, 0]):
        with pytest.raises(ValueError, match="scratch"):
            tck.paged_fused_update(tabs, slots, vals, arenas, **kw,
                                   scratch=bad)


def test_params_block_matches_the_source():
    """`PfuParams` in `paged_fused_update.cu`, field by field, against
    the wrapper's `_PFU_FIELDS` (order, type, count); the block a plan
    caches is byte-equal to a freshly packed one, and its scratch pointers
    follow `_scratch_roles`."""
    import re
    import struct

    src = (tck._CSRC / "paged_fused_update.cu").read_text()
    body = re.search(r"struct PfuParams \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for m in re.finditer(r"^\s*(int|float)\s+(\w+)(?:\[(\w+)\])?;", body,
                         re.M):
        kind, name, count = m.groups()
        n = int(re.search(rf"#define {count} (\d+)", src).group(1)) \
            if count else 1
        fields.append((name, f"{n}{kind[0]}" if count else kind[0]))
    assert fields == list(tck._PFU_FIELDS)
    assert struct.calcsize(tck._PFU_FORMAT) == 4 * sum(
        int(t[:-1] or 1) for _, t in fields)
    kw = _k1_kw(True, True, True)
    arenas = _state(0, True, True, True)
    tabs = torch.from_numpy(_stacked(_tables(8)))
    scratch = tck.compact_scratch(tabs, arenas, page_rows=PAGE_ROWS,
                                  edges=EDGES, dd_rows=kw["dd_rows"])
    plan = tck._Plan(tabs, arenas, scratch, PAGE_ROWS, EDGES, DD_GAMMA,
                     DD_MIN, kw["dd_rows"], kw["mom_rows"], MOM_META, True)
    fresh = tck._pfu_params(8, tabs.shape[1], PAGE_ROWS, EDGES, DD_GAMMA,
                            DD_MIN, kw["dd_rows"], DD_NB, kw["mom_rows"],
                            MOM_META, True)
    # the launch block: tables, arena and scratch pointers, then PfuParams
    assert int(re.search(r"#define PFU_MAX_ROLES (\d+)", src).group(1)) == \
        tck.MAX_ROLES
    assert "(1 + 2 * PFU_MAX_ROLES) * sizeof(void*)" in src
    head = 8 * (1 + 2 * tck.MAX_ROLES)
    assert plan.buf.raw[head:] == fresh
    assert plan.block_bytes == head + len(fresh)
    ptrs = struct.unpack(f"={head // 8}Q", plan.buf.raw[:head])
    assert ptrs[0] == tabs.data_ptr()
    assert list(ptrs[1:9]) == [a.data_ptr() for a in arenas]
    got = struct.unpack(tck._PFU_FORMAT, fresh)
    assert got[:9] == (8, tabs.shape[1], PAGE_SHIFT, kw["dd_rows"], DD_NB,
                       len(EDGES), kw["mom_rows"], MOM_META[0], 1)
    at = scratch.data_ptr()
    for r, k in tck._scratch_roles(tabs.shape[1] * PAGE_ROWS, len(EDGES),
                                   kw["dd_rows"], DD_NB):
        assert ptrs[9 + r] == at, f"role {r}"
        at += 4 * k
    assert ptrs[9 + 3] == 0 and ptrs[9 + 7] == 0
    assert at == scratch.data_ptr() + 4 * scratch.numel()
