"""The port's moments sketch against the JAX reference.

`tempo_tpu_torch.ops.moments`: the device half (basis, update, zeroing,
meta check) in torch and the host maxent solver in numpy, each fed the
same seeded numpy inputs as `tempo_tpu.ops.moments`.

Tolerances: the basis takes an f32 `log`, and XLA's and torch's differ by
one ulp on some inputs (about 5.6% of lognormal durations on an x86
CPU); z at 1 ulp, and the Chebyshev columns at atol 2e-5 (T_j' is at
most j^2 = 144 at k = 12, times an ulp of s, 2^-24 to 2^-23; measured at
most 2.1e-6 over 600,000 durations). Moment sums at rtol 1e-5 plus that
atol per unit of weight; the bound columns at atol 2e-6 (one ulp of a
value in [16, 32)). The solver is the same numpy code on the same rows:
bit-identical values and the same failure mask.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.ops import moments as jm
from tempo_tpu_torch.ops import moments as tm

K = 12
MIN_S, MAX_S = 1e-6, 1e5


def _values(seed, n=4096):
    rng = np.random.default_rng(seed)
    v = rng.lognormal(-3, 2.5, n).astype(np.float32)
    v[:6] = (0.0, 1e-9, MIN_S, MAX_S, 3e5, 1.0)        # clipped and exact
    return v


@pytest.mark.parametrize("k", [4, 12])
def test_basis_matches(k):
    _, lo, hi = jm.moments_params(k, MIN_S, MAX_S)
    v = _values(0)
    zr, br = (np.asarray(x) for x in jm.moments_basis(jnp.asarray(v), k, lo, hi))
    zt, bt = (x.numpy() for x in tm.moments_basis(torch.from_numpy(v), k, lo, hi))
    assert np.max(np.abs(zt - zr) / np.spacing(np.abs(zr).astype(np.float32))) <= 1
    np.testing.assert_allclose(bt, br, rtol=0, atol=2e-5)
    assert tm.moments_params(k, MIN_S, MAX_S) == jm.moments_params(k, MIN_S, MAX_S)
    assert tm.n_cols(k) == jm.n_cols(k) == k + 3


def _updates(seed, n_series=64, n=3000):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n_series + 2, n).astype(np.int32)
    v = _values(seed + 1, n)
    w = rng.integers(1, 4, n).astype(np.float32)
    mask = rng.random(n) < 0.9
    return ids, v, w, mask


def _both_updated(seed, n_series=64):
    ids, v, w, mask = _updates(seed, n_series)
    ids = np.where(ids < n_series, ids, -1).astype(np.int32)
    ref = jm.moments_update(jm.moments_init(n_series, K, MIN_S, MAX_S),
                            jnp.asarray(ids), jnp.asarray(v),
                            mask=jnp.asarray(mask), weights=jnp.asarray(w))
    got = tm.moments_update(tm.moments_init(n_series, K, MIN_S, MAX_S,
                                            device="cpu"),
                            torch.from_numpy(ids), torch.from_numpy(v),
                            mask=torch.from_numpy(mask),
                            weights=torch.from_numpy(w))
    return np.asarray(ref.data), got.data.numpy(), w[mask & (ids >= 0)]


def test_update_matches():
    """Counts exact (integer weights); moment sums within the basis
    tolerance per unit of weight; bounds at atol 2e-6; masked and
    negative ids drop."""
    ref, got, w_kept = _both_updated(3)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    assert got[:, 0].sum() == w_kept.sum()
    atol = 2e-5 * ref[:, :1]
    assert (np.abs(got[:, 1:K + 1] - ref[:, 1:K + 1])
            <= 1e-5 * np.abs(ref[:, 1:K + 1]) + atol).all()
    np.testing.assert_allclose(got[:, K + 1:], ref[:, K + 1:], rtol=0,
                               atol=2e-6)


def test_zero_slots_and_meta_check():
    _, got, _ = _both_updated(4)
    sk = tm.MomentsSketch(torch.from_numpy(got.copy()), K,
                          *jm.moments_params(K, MIN_S, MAX_S)[1:])
    tm.moments_zero_slots(sk, torch.tensor([1, 5, 64, -1], dtype=torch.int32))
    assert not sk.data[[1, 5]].any() and sk.data[2].any()
    other = tm.moments_init(64, K, MIN_S, 1e4, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        tm.merge_meta_check(sk, other)
    tm.merge_meta_check(sk, tm.moments_init(64, K, MIN_S, MAX_S, device="cpu"))


def test_quantiles_for_rows_bit_identical():
    """The same rows (the reference's update output, plus a point mass, an
    empty row and a row the solver cannot fit) give bit-identical values
    and the same failed mask in both packages, for q50 and q99 from one
    CDF."""
    ref, _, _ = _both_updated(5, n_series=24)
    rows = ref.astype(np.float64)
    rows[3] = 0.0                                        # empty
    rows[4, :] = rows[5, :]
    rows[4, K + 1] = rows[4, K + 2] = 0.0                # inconsistent support
    rows[6, 1:K + 1] = 0.9                               # infeasible moments
    _, lo, hi = jm.moments_params(K, MIN_S, MAX_S)
    jm.reset_solver_cache()
    tm.reset_solver_cache()
    rv, rf = jm.quantiles_for_rows(rows, K, lo, hi, [0.5, 0.99])
    tv, tf = tm.quantiles_for_rows(rows, K, lo, hi, [0.5, 0.99])
    assert rf.any() and (~rf & (rows[:, 0] > 0)).any()
    np.testing.assert_array_equal(tf, rf)
    np.testing.assert_array_equal(tv, rv)
    assert tm.solves_total == jm.solves_total
    assert tm.fallbacks_total == jm.fallbacks_total
    # a second read is served from the cache
    tm.quantiles_for_rows(rows, K, lo, hi, [0.5])
    assert tm.cache_hits_total == int((rows[:, 0] > 0).sum() - tf.sum())
