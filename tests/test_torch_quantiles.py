"""The bisection quantiles of ark_tpu_torch.ops.quantiles against the jitted
functions of ark_tpu.ops.quantiles and against the port's own sort path.

Both forms pick exact order statistics and interpolate them in f32 with
XLA's CPU rounding (one fused multiply-add), so every result must be equal
bit for bit (NaN where a column has nothing valid), on negatives, NaNs,
zeros, infinities, all-zero columns and q in {0, 0.5, 0.999, 1}. The one
exception is the JAX package's own: where an order statistic is infinite,
the sort path's zero weight times it gives NaN and the bisection's does not
(column 2 below), so there each form is held to its JAX twin alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_tpu.ops import quantiles as jq
from ark_tpu_torch.ops import quantiles as tq

torch.set_num_threads(1)

QS = [0.0, 0.5, 0.999, 1.0]


def _columns(seed, n=777, c=7):
    """Mixed-sign columns over six decades, a third zeros, some NaNs; column
    0 all zeros, column 1 all NaN but one value, column 2 with +-inf and
    -0.0 (which counts as a zero)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, c)) * 10.0 ** rng.uniform(-3, 3, (n, c))).astype(np.float32)
    x[rng.random((n, c)) < 0.33] = 0
    x[rng.random((n, c)) < 0.05] = np.nan
    x[:, 0] = 0
    x[:, 1] = np.nan
    x[5, 1] = -2.5
    x[:3, 2] = [np.inf, -np.inf, -0.0]
    return x


FINITE = [0, 1, 3, 4, 5, 6]                  # the columns without an infinity


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q", QS + [0.37])
@pytest.mark.parametrize("seed", [0, 1])
def test_nonzero_quantile_per_column_bisect_matches_jax_and_sort(seed, q):
    x = _columns(seed)
    got = tq.nonzero_quantile_per_column_bisect(torch.from_numpy(x), q)
    _equal(got, jq.nonzero_quantile_per_column_bisect(jnp.asarray(x), q))
    by_sort = tq.nonzero_quantile_per_column(torch.from_numpy(x), q)
    _equal(by_sort, jq.nonzero_quantile_per_column(jnp.asarray(x), q))
    _equal(got[FINITE], by_sort[FINITE].numpy())
    assert torch.isnan(got[0]) and got[1] == -2.5


@pytest.mark.parametrize("q", QS + [0.37])
@pytest.mark.parametrize("seed", [2, 3])
def test_masked_quantile_per_column_bisect_matches_jax_and_sort(seed, q):
    x = _columns(seed)
    valid = np.random.default_rng(seed + 10).random(x.shape[0]) < 0.6
    valid[5] = True
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    got = tq.masked_quantile_per_column_bisect(xt, vt, q)
    _equal(got, jq.masked_quantile_per_column_bisect(jnp.asarray(x), jnp.asarray(valid), q))
    by_sort = tq.masked_quantile_per_column(xt, vt, q)
    _equal(by_sort, jq.masked_quantile_per_column(jnp.asarray(x), jnp.asarray(valid), q))
    _equal(got[FINITE], by_sort[FINITE].numpy())
    none = tq.masked_quantile_per_column_bisect(xt, torch.zeros_like(vt), q)
    assert torch.isnan(none).all()


@pytest.mark.parametrize("q", QS)
def test_masked_quantile_flat_matches_jitted_jax(q):
    """`_masked_quantile_flat` alone: held to it under jit, where XLA fuses
    the interpolation (the eager JAX function rounds it twice)."""
    x = _columns(4)[:, 3]
    valid = ~np.isnan(x)
    flat = jax.jit(jq._masked_quantile_flat, static_argnames="q")
    got = tq._masked_quantile_flat(torch.from_numpy(x), torch.from_numpy(valid), q)
    _equal(got, flat(jnp.asarray(x), jnp.asarray(valid), q=q))
    empty = np.zeros_like(valid)
    assert torch.isnan(tq._masked_quantile_flat(torch.from_numpy(x),
                                                torch.from_numpy(empty), q))


@pytest.mark.parametrize("n", [1, 2, 3, 1000])
def test_bisect_on_short_and_tied_columns(n):
    """One to three valid rows (ranks at both ends) and long runs of ties."""
    rng = np.random.default_rng(n)
    x = rng.integers(-3, 4, (n, 5)).astype(np.float32)
    for q in QS:
        got = tq.nonzero_quantile_per_column_bisect(torch.from_numpy(x), q)
        _equal(got, jq.nonzero_quantile_per_column_bisect(jnp.asarray(x), q))
        _equal(got, tq.nonzero_quantile_per_column(torch.from_numpy(x), q).numpy())


def test_masked_order_stats_match_jax_bisection_on_mixed_columns():
    """The order statistics under both bisection quantiles: sorting the keys
    picks the element JAX's 32 counting steps pick, bit for bit, on signed
    zeros, infinities and NaNs, and key 0xFFFFFFFF (NaN) for a rank past the
    valid count."""
    x = _columns(5, n=300, c=4)
    valid = (x != 0) & ~np.isnan(x)
    ranks = np.array([[0, 7, 299], [3, 1, 0], [50, 50, 51], [2, 90, 400]])
    got = tq.masked_order_stats(torch.from_numpy(x), torch.from_numpy(valid),
                                torch.from_numpy(ranks))
    want = jax.jit(jq.masked_order_stats)(jnp.asarray(x), jnp.asarray(valid),
                                          jnp.asarray(ranks, jnp.int32))
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  np.asarray(want).view(np.int32))
