"""ark_tpu_torch.ops.classical (and the morphology and filter functions that
came with it) against the JAX package's jitted functions, on the CPU.

Tolerances. The JAX functions run as XLA programs whose CPU backend sums a
convolution's taps in its own order and contracts multiply-adds, so floats
are held to rtol 1e-5 with an atol of 1e-6 of the output's largest magnitude
(`close`). Exceptions, all stricter: the Gaussian-derivative taps, multi-Otsu
and the morphology functions are equal; Sobel is bitwise (3-tap convolutions
are exact sums here, and the port reproduces XLA's fused gx*gx + gy*gy and
its reciprocal multiply); the local threshold's mask may differ only where
the pixel lies within the blur's tolerance of its local mean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from ark_tpu.ops import classical as JC
from ark_tpu.ops import image_filters as JF
from ark_tpu.ops import morphology as JM
from ark_tpu_torch.ops import classical as TC
from ark_tpu_torch.ops import image_filters as TF
from ark_tpu_torch.ops import morphology as TM

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(float(np.abs(want).max()), 1e-30))


def _ridges(rng, shape=(160, 144), n=5):
    """Noise plus a few bright line segments."""
    img = rng.uniform(0, 0.05, shape).astype(np.float32)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for _ in range(n):
        cy, cx = rng.uniform(20, min(shape) - 20, 2)
        theta = rng.uniform(0, np.pi)
        d = np.abs((yy - cy) * np.cos(theta) - (xx - cx) * np.sin(theta))
        along = np.abs((yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta))
        img[(d < 2) & (along < 30)] += 0.7
    return img


@pytest.mark.parametrize("sigma", [0.5, 1.0, 3.0, 9.0])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_derivative_taps_are_equal(sigma, order):
    np.testing.assert_array_equal(TC._gaussian_derivative_kernel1d(sigma, order),
                                  JC._gaussian_derivative_kernel1d(sigma, order))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_correlate1d_matches_scipy_reflect(rng, axis):
    x = rng.random((9, 11, 3)).astype(np.float32)
    taps = rng.normal(size=7).astype(np.float32)
    got = TF.correlate1d(torch.as_tensor(x), taps, axis=axis).numpy()
    want = ndi.correlate1d(x.astype(np.float64), taps.astype(np.float64), axis=axis,
                           mode="reflect")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_correlate1d_pads_wider_than_the_image(rng):
    x = rng.random((3, 4)).astype(np.float32)
    taps = rng.normal(size=15).astype(np.float32)
    got = TF.correlate1d(torch.as_tensor(x), taps, axis=0).numpy()
    want = ndi.correlate1d(x.astype(np.float64), taps.astype(np.float64), axis=0,
                           mode="reflect")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("orders", [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2)])
def test_sep_conv_matches(rng, orders):
    img = rng.random((70, 90)).astype(np.float32)
    krow = TC._gaussian_derivative_kernel1d(2.0, orders[0])
    kcol = TC._gaussian_derivative_kernel1d(1.5, orders[1])
    want = jax.jit(lambda x: JC._sep_conv(x, krow, kcol))(jnp.asarray(img))
    close(TC._sep_conv(torch.as_tensor(img), krow, kcol).numpy(), want)


def test_convolution_direction_on_a_ramp():
    """A true convolution, not a correlation: on a ramp rising along an
    axis, the order-1 Gaussian derivative and Sobel's [1, 0, -1] give the
    positive slope; the reversed direction would flip the sign."""
    g0 = TC._gaussian_derivative_kernel1d(1.5, 0)
    g1 = TC._gaussian_derivative_kernel1d(1.5, 1)
    smooth = np.array([1.0, 2.0, 1.0], np.float32) / 4.0
    diff = np.array([1.0, 0.0, -1.0], np.float32)
    cols = np.tile(np.arange(40, dtype=np.float32) * 0.5, (30, 1))   # slope 0.5 along axis 1
    for img, first, second in ((cols, (g0, g1), (smooth, diff)),
                               (cols.T.copy(), (g1, g0), (diff, smooth))):
        t = torch.as_tensor(img)
        for taps, slope in ((first, 0.5), (second, 1.0)):
            got = TC._sep_conv(t, *taps).numpy()
            want = np.asarray(jax.jit(lambda x, k=taps: JC._sep_conv(x, *k))(jnp.asarray(img)))
            np.testing.assert_allclose(got[10:-10, 10:-10], slope, rtol=1e-3)   # sampled taps
            close(got, want)
    # the mixed term of x * y is +1
    yy, xx = np.mgrid[:40, :40].astype(np.float32)
    hrc = TC._sep_conv(torch.as_tensor(yy * xx * 0.01), g1, g1).numpy()
    np.testing.assert_allclose(hrc[10:-10, 10:-10], 0.01, rtol=1e-3)


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_sobel_is_bitwise(rng, scale):
    img = (rng.random((90, 75)) * scale).astype(np.float32)
    want = np.asarray(JC.sobel(jnp.asarray(img)))
    np.testing.assert_array_equal(TC.sobel(torch.as_tensor(img)).numpy(), want)


def test_sobel_step_edge():
    img = np.zeros((32, 32), np.float32)
    img[:, 16:] = 1.0
    grad = TC.sobel(torch.as_tensor(img)).numpy()
    assert grad[:, 15:17].mean() > 10 * grad[:, 5].mean()
    np.testing.assert_array_equal(grad, np.asarray(JC.sobel(jnp.asarray(img))))


def test_gaussian_blur_batch(rng):
    imgs = rng.random((3, 40, 36, 2)).astype(np.float32)
    got = TF.gaussian_blur_batch(torch.as_tensor(imgs), sigma=1.5).numpy()
    close(got, JF.gaussian_blur_batch(jnp.asarray(imgs), sigma=1.5))
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], TF.gaussian_blur(torch.as_tensor(imgs[i]), sigma=1.5).numpy())


@pytest.mark.parametrize("classes", [2, 3, 4])
def test_multi_otsu_is_equal(rng, classes):
    data = np.concatenate([rng.normal(m, 0.5, 3000) for m in (0, 5, 10, 16)])
    np.testing.assert_array_equal(TC.multi_otsu(data, classes=classes),
                                  JC.multi_otsu(data, classes=classes))
    flat = np.full(50, 3.0)
    np.testing.assert_array_equal(TC.multi_otsu(flat, classes=classes),
                                  JC.multi_otsu(flat, classes=classes))


def test_multi_otsu_rejects_one_class():
    with pytest.raises(ValueError):
        TC.multi_otsu(np.arange(9.0), classes=1)


@pytest.mark.parametrize("shape,kernel_size,nbins", [
    ((64, 64), 16, 256), ((64, 64), None, 256), ((100, 90), None, 256),
    ((100, 90), (10, 25), 256), ((75, 130), 12, 256), ((128, 128), 8, 256),
    ((60, 60), 7, 100), ((33, 20), 1, 256)])
def test_equalize_adapthist_matches(rng, shape, kernel_size, nbins):
    img = rng.random(shape) ** 3
    got = TC.equalize_adapthist(img, kernel_size=kernel_size, nbins=nbins, device="cpu")
    want = JC.equalize_adapthist(img, kernel_size=kernel_size, nbins=nbins)
    close(got, want)
    assert got.dtype == np.float64 and 0 <= got.min() and got.max() <= 1


def test_clahe_geometry_is_equal():
    for h, w, ks in ((1024, 1024, 8.0), (100, 90, None), (64, 50, (7.6, 3)), (5, 5, 1)):
        assert TC._clahe_geometry(h, w, ks) == JC._clahe_geometry(h, w, ks)


@pytest.mark.parametrize("sigma", [1.0, 3.0, 5.0])
def test_hessian_eigvals_match(rng, sigma):
    img = _ridges(rng)
    got = TC._hessian_eigvals(torch.as_tensor(img), sigma)
    want = JC._hessian_eigvals(jnp.asarray(img), sigma)
    for g, w in zip(got, want):
        close(g.numpy(), w)
    assert bool((got[0].abs() <= got[1].abs()).all())


@pytest.mark.parametrize("black_ridges", [False, True])
def test_frangi_matches(rng, black_ridges):
    """Frangi's factor 1 - exp(-S^2 / 2 gamma^2) is a difference from 1: its
    absolute steps are 2^-24, so the atol is of order one, not of the
    response's own (small) scale."""
    img = _ridges(rng)
    got = TC.frangi(img, black_ridges=black_ridges, device="cpu")
    want = JC.frangi(img, black_ridges=black_ridges)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    got = TC.frangi(img, sigmas=[1, 2, 3], gamma=0.5, black_ridges=black_ridges,
                    device="cpu")
    close(got, JC.frangi(img, sigmas=[1, 2, 3], gamma=0.5, black_ridges=black_ridges))
    if not black_ridges:
        assert got[img > 0.5].mean() > 5 * max(got[img < 0.1].mean(), 1e-9)


@pytest.mark.parametrize("black_ridges", [False, True])
def test_meijering_matches(rng, black_ridges):
    img = _ridges(rng)
    got = TC.meijering(img, sigmas=range(1, 5), black_ridges=black_ridges, device="cpu")
    close(got, JC.meijering(img, sigmas=range(1, 5), black_ridges=black_ridges))
    assert got.max() == 1.0
    flat = np.zeros((20, 20), np.float32)
    np.testing.assert_array_equal(TC.meijering(flat, device="cpu"), JC.meijering(flat))


@pytest.mark.parametrize("block_size,offset", [(1, 0.0), (7, 0.0), (25, 0.01)])
def test_local_adaptive_threshold(rng, block_size, offset):
    img = _ridges(rng)
    got = TC.local_adaptive_threshold(img, block_size, offset, device="cpu")
    want = JC.local_adaptive_threshold(img, block_size, offset)
    mean = np.asarray(JF.gaussian_blur(jnp.asarray(img), sigma=(block_size - 1) / 6.0))
    near = np.abs(img - (mean - offset)) <= RTOL * np.abs(mean) + ATOL
    assert got.dtype == bool and not ((got != want) & ~near).any()
    assert (got != want).sum() <= 1e-3 * img.size


def test_remove_small_holes_is_equal(rng):
    mask = rng.random((80, 70)) < 0.8
    for area in (1, 4, 64):
        np.testing.assert_array_equal(TM.remove_small_holes(mask, area),
                                      JM.remove_small_holes(mask, area))
    edge = np.ones((20, 20), bool)
    edge[0:2, 0:2] = False                       # a hole at the border fills too
    edge[10:16, 10:16] = False
    out = TM.remove_small_holes(edge, area_threshold=10)
    assert out[0:2, 0:2].all() and not out[10:16, 10:16].any()


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_binary_erosion_is_equal(rng, iterations):
    mask = ndi.binary_dilation(rng.random((50, 60)) < 0.2, iterations=3)
    got = TM.binary_erosion(torch.as_tensor(mask), iterations=iterations).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JM.binary_erosion(jnp.asarray(mask), iterations=iterations)))
    np.testing.assert_array_equal(got, ndi.binary_erosion(mask, iterations=iterations))


@pytest.mark.parametrize("connectivity", [1, 2])
def test_erode_mask_is_equal(rng, connectivity):
    seeds = np.zeros((60, 60), np.int32)
    pts = rng.integers(0, 60, (12, 2))
    seeds[pts[:, 0], pts[:, 1]] = np.arange(1, 13)
    dist, (iy, ix) = ndi.distance_transform_edt(seeds == 0, return_indices=True)
    labels = np.where(dist <= 9, seeds[iy, ix], 0).astype(np.uint16)
    got = TM.erode_mask(labels, connectivity=connectivity, device="cpu")
    want = JM.erode_mask(labels, connectivity=connectivity)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and (got > 0).sum() < (labels > 0).sum()
