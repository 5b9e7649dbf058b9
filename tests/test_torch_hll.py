"""The HyperLogLog device code and the sidecar's hashes, against the
reference (`tempo_tpu/ops/sketches.py:250-310`, `ops/pages.py::hll_step`,
`ops/compact.py:79-99,160-217`) on the same seeded numpy inputs.

Registers are integers and sidecars interchange between the packages, so
`hll_update`, `hll_merge`, `hll_step` and `build_sidecar_arrays` must
give the reference's registers bit for bit, including the rho edges
(h2 = 0 gives 33, h2 >= 2^31 gives 1, 2^k - 1 and 2^k for every k);
`trace_hashes` is bit-exact; `hll_estimate` (float32 in both) is held
within rtol 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tempo_tpu.ops import compact as jcompact
from tempo_tpu.ops import pages as jpages
from tempo_tpu.ops import sketches as jsk
from tempo_tpu_torch.ops import compact as tcompact
from tempo_tpu_torch.ops import pages as tpages
from tempo_tpu_torch.ops import sketches as tsk


def edge_h2() -> np.ndarray:
    """0, every 2^k - 1 and 2^k in [0, 2^32), and the top value."""
    ks = np.arange(33, dtype=np.uint64)
    v = np.concatenate([[0], (np.uint64(1) << ks) - np.uint64(1),
                        np.uint64(1) << ks[:32], [0xFFFFFFFF]])
    return np.unique(v).astype(np.uint32)


def _regs(state) -> np.ndarray:
    r = state.registers
    return r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)


def test_rho_matches_clz_at_every_edge():
    h2 = edge_h2()
    h1 = np.arange(len(h2), dtype=np.uint32) << np.uint32(22)
    _, rho = tpages.hll_cells(tpages.u32_on(h1, "cpu"),
                              tpages.u32_on(h2, "cpu"), 10)
    want = np.array([33 if v == 0 else 32 - int(v).bit_length() + 1
                     for v in h2.tolist()])
    np.testing.assert_array_equal(rho.numpy(), want)
    assert rho.dtype == torch.int32
    assert rho[0] == 33 and (rho.numpy()[h2 >= 1 << 31] == 1).all()
    # the same registers as the reference's lax.clz
    j = jsk.hll_update(jsk.hll_init(1, precision=10),
                       np.zeros(len(h2), np.int32), h1, h2)
    t = tsk.hll_update(tsk.hll_init(1, precision=10, device="cpu"),
                       np.zeros(len(h2), np.int32), h1, h2)
    np.testing.assert_array_equal(_regs(t), _regs(j))
    # signed int32 tensors read back as their unsigned values
    t2 = tsk.hll_update(tsk.hll_init(1, precision=10, device="cpu"),
                        torch.zeros(len(h2), dtype=torch.int32),
                        torch.from_numpy(h1.view(np.int32)),
                        torch.from_numpy(h2.view(np.int32)))
    np.testing.assert_array_equal(_regs(t2), _regs(j))


@pytest.mark.parametrize("precision", [4, 10, 14])
def test_hll_update_merge_estimate_match_reference(precision):
    rng = np.random.default_rng(precision)
    n, s = 5000, 6
    sids = rng.integers(0, s, n).astype(np.int32)
    h1 = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    h2 = np.concatenate([edge_h2(), rng.integers(
        0, 1 << 32, n - len(edge_h2()), dtype=np.uint32)])
    mask = rng.random(n) < 0.8
    j = jsk.hll_update(jsk.hll_init(s, precision=precision), sids, h1, h2,
                       mask=mask)
    t = tsk.hll_update(tsk.hll_init(s, precision=precision, device="cpu"),
                       sids, h1, h2, mask=mask)
    np.testing.assert_array_equal(_regs(t), _regs(j))
    rev = sids[::-1].copy()
    jb = jsk.hll_update(jsk.hll_init(s, precision=precision), rev,
                        h2, h1)
    tb = tsk.hll_update(tsk.hll_init(s, precision=precision, device="cpu"),
                        rev, h2, h1)
    jm, tm = jsk.hll_merge(j, jb), tsk.hll_merge(t, tb)
    np.testing.assert_array_equal(_regs(tm), _regs(jm))
    for a, b in ((t, j), (tm, jm), (tsk.hll_init(s, precision, "cpu"),
                                    jsk.hll_init(s, precision))):
        te, je = tsk.hll_estimate(a), np.asarray(jsk.hll_estimate(b))
        assert te.dtype == torch.float32
        np.testing.assert_allclose(te.numpy(), je, rtol=1e-6)
    with pytest.raises(ValueError, match="incompatible"):
        tsk.hll_merge(t, tsk.hll_init(s, precision + 1, "cpu"))


def test_hll_ids_outside_the_rows_drop():
    """Ids past the last row drop in both packages. A negative id drops in
    the port; the reference's scatter wraps it to the last rows, so the
    comparison leaves negative ids out."""
    h1 = np.array([1 << 31, 5 << 26, 7], np.uint32)
    h2 = np.array([1, 2, 0], np.uint32)
    sids = np.array([3, 9, 1], np.int32)
    j = jsk.hll_update(jsk.hll_init(2, precision=6), sids, h1, h2)
    t = tsk.hll_update(tsk.hll_init(2, precision=6, device="cpu"), sids, h1,
                       h2)
    np.testing.assert_array_equal(_regs(t), _regs(j))
    assert _regs(t).sum() == 33
    neg = tsk.hll_update(tsk.hll_init(2, precision=6, device="cpu"),
                         np.array([-1], np.int32), h1[:1], h2[:1])
    assert _regs(neg).sum() == 0


def test_paged_hll_step_matches_reference_and_dense():
    """`tests/test_pages.py:386`, the HLL half: the paged register max
    through an identity page table equals the dense `hll_update`, in both
    packages; then a shuffled table with unbacked pages and discards."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n, n_series, page_rows = 256, 32, 8
    sids = rng.integers(0, n_series, n).astype(np.int32)
    h1 = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    h2 = rng.integers(1, 1 << 32, n, dtype=np.uint32)
    shift = page_rows.bit_length() - 1
    table = np.arange(n_series // page_rows, dtype=np.int32)

    dense = tsk.hll_update(tsk.hll_init(n_series, precision=6, device="cpu"),
                           sids, h1, h2)
    ar = torch.zeros((n_series, 1 << 6), dtype=torch.int32)
    tpages.hll_step(ar, torch.from_numpy(table), torch.from_numpy(sids), h1,
                    h2, precision=6, page_shift=shift)
    jar = jpages.hll_step(6, shift)(jnp.zeros((n_series, 1 << 6), jnp.int32),
                                    table, sids, h1, h2)
    np.testing.assert_array_equal(ar.numpy(), _regs(dense))
    np.testing.assert_array_equal(ar.numpy(), np.asarray(jar))

    shuffled = np.array([3, -1, 0, 1], np.int32)
    sids2 = sids.copy()
    sids2[::7] = -1
    ar2 = torch.zeros((n_series, 1 << 6), dtype=torch.int32)
    tpages.hll_step(ar2, torch.from_numpy(shuffled), torch.from_numpy(sids2),
                    h1, h2, precision=6, page_shift=shift)
    jar2 = jpages.hll_step(6, shift)(jnp.zeros((n_series, 1 << 6),
                                               jnp.int32),
                                     shuffled, sids2, h1, h2)
    np.testing.assert_array_equal(ar2.numpy(), np.asarray(jar2))
    assert ar2[2 * page_rows:3 * page_rows].sum() == 0   # no owner


def test_trace_hashes_and_limbs_bit_exact():
    rng = np.random.default_rng(5)
    tid = rng.integers(0, 256, (4096, 16)).astype(np.uint8)
    tid[:4] = [[0] * 16, [255] * 16, list(range(16)), [1] + [0] * 15]
    for a, b in zip(tcompact.trace_hashes(tid), jcompact.trace_hashes(tid)):
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcompact.trace_id_limbs(tid),
                    jcompact.trace_id_limbs(tid)):
        np.testing.assert_array_equal(a, b)
    sid = tid[:, :8]
    for a, b in zip(tcompact.span_id_limbs(sid), jcompact.span_id_limbs(sid)):
        np.testing.assert_array_equal(a, b)
    x = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(tcompact._mix32(x, 0x9E3779B9),
                                  jcompact._mix32(x, 0x9E3779B9))
    assert [tcompact.pad_pow2(n) for n in (0, 64, 65, 1000)] == \
        [jcompact.pad_pow2(n) for n in (0, 64, 65, 1000)]
    assert tcompact.SIDECAR_HLL_PRECISION == jcompact.SIDECAR_HLL_PRECISION
    # the cold tier's merge over the same ids (tests/test_torch_compact.py
    # fuzzes it): equal to the reference's kernel row for row
    np.testing.assert_array_equal(
        tcompact.merge_order(tid, sid, device="cpu"),
        jcompact.merge_order(tid, sid))


def test_build_sidecar_arrays_match_reference():
    """The sidecar's device pass on the CPU: registers bit-identical,
    moment counts and bounds exact, sums within f32 reduction order."""
    from tempo_tpu_torch.ops import moments as msk

    rng = np.random.default_rng(9)
    n, n_series = 3000, 7
    sids = rng.integers(0, n_series, n).astype(np.int32)
    dur = rng.integers(1, 10**10, n).astype(np.int64)
    dur[:3] = [1, 10**14, 10**15]
    tid = rng.integers(0, 256, (n, 16)).astype(np.uint8)
    args = (sids, dur, n_series, tid, msk.QUERY_K, msk.QUERY_LO,
            msk.QUERY_HI)
    t_rows, t_hll = tcompact.build_sidecar_arrays(*args, device="cpu")
    j_rows, j_hll = jcompact.build_sidecar_arrays(*args)
    assert t_rows.dtype == np.float32 and t_hll.dtype == np.int32
    assert t_rows.shape == (n_series, msk.QUERY_K + 3) and t_hll.shape == (
        1 << tcompact.SIDECAR_HLL_PRECISION,)
    np.testing.assert_array_equal(t_hll, j_hll)
    k = msk.QUERY_K
    np.testing.assert_array_equal(t_rows[:, 0], j_rows[:, 0])
    np.testing.assert_array_equal(t_rows[:, k + 1:], j_rows[:, k + 1:])
    np.testing.assert_allclose(t_rows[:, 1:k + 1], j_rows[:, 1:k + 1],
                               rtol=1e-5, atol=1e-6 * n)
    empty = tcompact.build_sidecar_arrays(
        np.zeros(0, np.int32), np.zeros(0, np.int64), 0,
        np.zeros((0, 16), np.uint8), k, msk.QUERY_LO, msk.QUERY_HI,
        device="cpu")
    jempty = jcompact.build_sidecar_arrays(
        np.zeros(0, np.int32), np.zeros(0, np.int64), 0,
        np.zeros((0, 16), np.uint8), k, msk.QUERY_LO, msk.QUERY_HI)
    for a, b in zip(empty, jempty):
        np.testing.assert_array_equal(a, b)
