"""ark_tpu_torch.ops.edt against ark_tpu.ops.edt and scipy, on the CPU.

Tolerances: the squared transform is int32 min-plus work, bitwise equal to
the JAX package's and to scipy's squared distances (rounded to integers), in
any row chunking; the root is correctly rounded on both sides, so the float
transform is bitwise equal to the JAX package's too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from ark_tpu.ops import edt as JE
from ark_tpu_torch.ops import edt as TE

torch.set_num_threads(1)

CASES = [
    ((33, 47), 0.5),     # odd, non-square
    ((64, 64), 0.9),     # sparse background: long-range distances
    ((128, 96), 0.98),   # very sparse background
    ((50, 50), 0.02),    # dense background: mostly zeros
    ((1, 7), 0.5),       # single row
    ((7, 1), 0.5),       # single column
    ((300, 260), 0.97),  # larger than one source block (256)
]


def _mask(rng, shape, p):
    img = rng.random(shape) < p
    if not (~img).any():       # ensure at least one background pixel
        img.flat[0] = False
    return img


@pytest.mark.parametrize("shape,p", CASES)
def test_squared_transform_is_bitwise(rng, shape, p):
    img = _mask(rng, shape, p)
    got = TE._edt2_int(torch.as_tensor(img)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(JE._edt2_int(jnp.asarray(img))))
    np.testing.assert_array_equal(
        got, np.rint(ndi.distance_transform_edt(img) ** 2).astype(np.int32))


@pytest.mark.parametrize("shape,p", CASES)
def test_distance_is_bitwise_to_jax_and_close_to_scipy(rng, shape, p):
    img = _mask(rng, shape, p)
    got = TE.distance_transform_edt(img, device="cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(JE.distance_transform_edt(img)))
    np.testing.assert_allclose(got, ndi.distance_transform_edt(img), atol=1e-4)


@pytest.mark.parametrize("pass2_bytes", [1, 4 * 260 * 256 * 7, 2 ** 30])
def test_any_row_chunking_gives_the_same_bits(rng, pass2_bytes):
    img = _mask(rng, (300, 260), 0.97)
    want = np.asarray(JE._edt2_int(jnp.asarray(img)))
    got = TE._edt2_int(torch.as_tensor(img), pass2_bytes=pass2_bytes).numpy()
    np.testing.assert_array_equal(got, want)


def test_pass2_block_stays_under_its_limit(rng, monkeypatch):
    """The (rows, W, 256) candidate block never exceeds PASS2_BYTES."""
    seen = []
    real = torch.Tensor.amin

    def amin(self, *a, **k):
        seen.append(self.numel() * self.element_size())
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "amin", amin)
    TE._edt2_int(torch.as_tensor(_mask(rng, (130, 300), 0.9)), pass2_bytes=2 ** 20)
    assert seen and max(seen) <= 2 ** 20


def test_planted_disk(rng):
    img = np.zeros((120, 140), bool)
    yy, xx = np.mgrid[:120, :140]
    img |= (yy - 40) ** 2 + (xx - 50) ** 2 < 30 ** 2
    ours = TE.distance_transform_edt(img, device="cpu").numpy()
    assert ours[40, 50] == 30.0
    assert ours[~img].max() == 0.0
    np.testing.assert_array_equal(ours, np.asarray(JE.distance_transform_edt(img)))


def test_integer_input_and_tensor_input(rng):
    img = (rng.random((40, 40)) < 0.7).astype(np.uint8) * 7  # nonzero=fg
    img[0, 0] = 0
    want = np.asarray(JE.distance_transform_edt(img))
    np.testing.assert_array_equal(
        TE.distance_transform_edt(img, device="cpu").numpy(), want)
    np.testing.assert_array_equal(
        TE.distance_transform_edt(torch.as_tensor(img), device="cpu").numpy(), want)


def test_no_background_returns_inf():
    out = TE.distance_transform_edt(np.ones((8, 9), bool), device="cpu").numpy()
    assert np.isinf(out).all()
    assert (TE._edt2_int(torch.ones((8, 9), dtype=torch.bool)).numpy()
            == TE._SENTINEL ** 2).all()


def test_all_background_is_zero():
    out = TE.distance_transform_edt(np.zeros((8, 9), bool), device="cpu").numpy()
    assert (out == 0).all()


def test_raises_on_non_2d():
    with pytest.raises(ValueError):
        TE.distance_transform_edt(np.ones((2, 3, 4), bool), device="cpu")


def test_large_distances_stay_exact():
    """One background pixel in a corner of 600 x 700: squared distances pass
    f32's exact integers nowhere here, but the root must match numpy's
    correctly rounded one of the exact integer."""
    img = np.ones((600, 700), bool)
    img[0, 0] = False
    yy, xx = np.mgrid[:600, :700]
    want2 = (yy ** 2 + xx ** 2).astype(np.int32)
    got2 = TE._edt2_int(torch.as_tensor(img)).numpy()
    np.testing.assert_array_equal(got2, want2)
    got = TE.distance_transform_edt(img, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.sqrt(want2.astype(np.float32)))
