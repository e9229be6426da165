"""The port's blur, quantiles and per-FOV preprocess against ark_tpu's.

Quantiles are exact: the order statistics are exact and the interpolation
is the same f32 formula, rounded as XLA's CPU backend rounds it. The blur
and the row normalization carry rtol 1e-6 for the order of the tap sums
(torch sums the taps in order; XLA's convolution in its own order).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from ark_tpu.ops import image_filters as jfilters
from ark_tpu.ops import quantiles as jq
from ark_tpu.phenotyping import pixie_fused as jfused
from ark_tpu.phenotyping import pixie_preprocessing as jprep
from ark_tpu_torch.ops import image_filters as tfilters
from ark_tpu_torch.ops import quantiles as tq
from ark_tpu_torch.phenotyping import pixie_fused as tfused
from ark_tpu_torch.phenotyping import pixie_preprocessing as tprep

torch.set_num_threads(1)

BLUR_RTOL, BLUR_ATOL = 1e-6, 1e-7
QS = [0.0, 0.05, 0.5, 0.99, 0.999, 1.0]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32),
                                  np.asarray(b, np.float32))


@pytest.mark.parametrize("sigma", [2.0, 0.0])
@pytest.mark.parametrize("shape", [(48, 48, 4), (48, 48), (5, 7, 3)])
def test_gaussian_blur_matches_jax(shape, sigma):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    ref = np.asarray(jfilters.gaussian_blur(jnp.asarray(img), sigma=sigma))
    got = tfilters.gaussian_blur(torch.from_numpy(img), sigma=sigma).numpy()
    np.testing.assert_allclose(got, ref, rtol=BLUR_RTOL, atol=BLUR_ATOL)


def test_symmetric_padding_matches_numpy():
    for n, r in [(5, 2), (3, 5), (1, 4), (8, 8)]:
        x = torch.arange(n, dtype=torch.float32)[:, None]
        got = torch.index_select(x, 0, tfilters._symmetric_index(n, r, "cpu"))
        np.testing.assert_array_equal(
            got[:, 0].numpy(), np.pad(np.arange(n), r, mode="symmetric"))


@pytest.mark.parametrize("n", [3, 1237, 2500])
def test_quantiles_exactly_equal(n):
    rng = np.random.default_rng(n)
    x = rng.random(n).astype(np.float32)
    x[x < 0.3] = 0.0
    for q in QS:
        _same(tq.quantile(torch.from_numpy(x), q), jq.quantile(jnp.asarray(x), q))
        _same(tq.nonzero_quantile(torch.from_numpy(x), q),
              jq.nonzero_quantile(jnp.asarray(x), q))
    m = rng.random((n, 5)).astype(np.float32)
    m[m < 0.5] = 0.0
    m[:, 2] = 0.0
    valid = rng.random(n) < 0.7
    for q in QS:
        _same(tq.nonzero_quantile_per_column(torch.from_numpy(m), q),
              jq.nonzero_quantile_per_column(jnp.asarray(m), q))
        _same(tq.masked_quantile_per_column(
            torch.from_numpy(m), torch.from_numpy(valid), q),
            jq.masked_quantile_per_column(jnp.asarray(m), jnp.asarray(valid), q))


def test_quantile_nan_rules():
    x = np.array([0.3, np.nan, 0.1, 0.0, 0.7], np.float32)
    # quantile propagates NaN; nonzero_quantile ignores it (NaN is not > 0)
    assert np.isnan(float(tq.quantile(torch.from_numpy(x), 0.5)))
    assert np.isnan(float(jq.quantile(jnp.asarray(x), 0.5)))
    _same(tq.nonzero_quantile(torch.from_numpy(x), 0.5),
          jq.nonzero_quantile(jnp.asarray(x), 0.5))
    zeros = np.zeros(9, np.float32)
    assert np.isnan(float(tq.nonzero_quantile(torch.from_numpy(zeros), 0.99)))
    assert np.isnan(float(jq.nonzero_quantile(jnp.asarray(zeros), 0.99)))
    m = np.array([[0.0, np.nan], [0.0, 2.0], [0.0, 1.0]], np.float32)
    _same(tq.nonzero_quantile_per_column(torch.from_numpy(m), 0.5),
          jq.nonzero_quantile_per_column(jnp.asarray(m), 0.5))


@pytest.mark.parametrize("blur_factor", [2, 0])
def test_prep_fov_parts_inner_matches_jax(blur_factor):
    rng = np.random.default_rng(2)
    img = rng.gamma(0.5, 1.0, (48, 40, 4)).astype(np.float32)
    img[rng.random((48, 40, 4)) < 0.4] = 0.0
    img[:5, :5] = 0.0                      # all-zero rows at blur 0
    ref = jprep._prep_fov_parts_inner(jnp.asarray(img), blur_factor)
    got = tprep._prep_fov_parts_inner(torch.from_numpy(img), blur_factor)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=BLUR_RTOL, atol=BLUR_ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_channel_percentiles_device_matches_per_channel_and_jax():
    """The port's one-call per-channel nonzero quantile equals per-channel
    nonzero_quantile calls bitwise, and the JAX package's batched call."""
    rng = np.random.default_rng(12345)
    img = rng.random((37, 53, 5), np.float32)
    img[img < 0.4] = 0.0
    img[..., 3] = 0.0
    vals, haspos = tfused._channel_percentiles_device(torch.from_numpy(img), 0.99)
    ref_vals, ref_haspos = jfused._channel_percentiles_device(jnp.asarray(img), 0.99)
    np.testing.assert_array_equal(haspos.numpy(), np.asarray(ref_haspos))
    _same(vals.numpy(), ref_vals)
    for c in range(5):
        _same(vals[c], tq.nonzero_quantile(torch.from_numpy(img[..., c]), 0.99))


def test_fov_quantiles_replicates_pandas_on_device_stats():
    """The port's device order statistics fed to _fov_quantiles equal the
    real pandas frame quantile bitwise (both numpy paths)."""
    rng = np.random.default_rng(7)
    for trial in range(12):
        n = int(rng.integers(3, 2000))
        c = int(rng.integers(1, 6))
        v = rng.random((n, c)).astype(np.float32)
        if trial % 3 == 0:
            v[v < 0.3] = 0.0
        elif trial % 3 == 1 and c > 1:
            v[:, 0] = 0.0
        ref = pd.DataFrame(v).replace(0, np.nan).quantile(q=0.999, axis=0)
        sorted_t, counts = tfused._quantile_stats_device(torch.from_numpy(v))

        def sorted_cols(lo_rows, hi_rows, _s=sorted_t):
            picked = torch.gather(
                _s, 0, torch.from_numpy(np.stack([lo_rows, hi_rows]))).numpy()
            return picked[0], picked[1]

        got = tfused._fov_quantiles(sorted_cols, counts.numpy(), n, 0.999)
        assert got.dtype == ref.values.dtype
        np.testing.assert_array_equal(got, ref.values, err_msg=str(trial))
