"""ark_tpu_torch.ops.cc against ark_tpu.ops.cc on the same numpy masks.

Labeling is integer work with a fixed schedule of rounds, so labels, counts
and convergence flags must be equal bit for bit (tolerance: none),
including where a round budget is too small and the flag reports it.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from ark_tpu.ops import cc as jcc
from ark_tpu_torch.ops import cc as tcc

torch.set_num_threads(1)


def _masks(seed, b=3, h=37, w=53, density=0.55):
    rng = np.random.default_rng(seed)
    return rng.random((b, h, w)) < density


def _assert_same(got, ref):
    for g, r in zip(got, ref):
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            assert g == bool(r)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("density", [0.3, 0.55, 0.7])
def test_label_batched_matches_jax(density, connectivity):
    mask = _masks(int(density * 100) + connectivity, density=density)
    ref = jcc.label_batched(jnp.asarray(mask), connectivity=connectivity)
    got = tcc.label_batched(torch.from_numpy(mask), connectivity=connectivity)
    _assert_same(got, ref)
    assert got[2]
    # scipy's numbering, image by image
    structure = np.ones((3, 3)) if connectivity == 2 else None
    for i in range(mask.shape[0]):
        want, n = ndi.label(mask[i], structure=structure)
        np.testing.assert_array_equal(got[0][i].numpy(), want)
        assert int(got[1][i]) == n


@pytest.mark.parametrize("rounds", [0, 1, 2])
def test_cc_rounds_short_budget_flag(rounds):
    """A budget too small for a winding mask: the same partial forest and a
    False flag on both sides."""
    mask = np.zeros((2, 24, 24), bool)
    mask[:, ::4, :] = True                  # a serpentine corridor
    mask[:, :, 0] = True
    mask[:, :, -1] = True
    for r in range(0, 24, 8):
        mask[:, r + 1:r + 4, 0] = False
    mask[1] = np.rot90(mask[1])
    fg = jnp.asarray(mask)
    n = 24 * 24
    iota = np.arange(n, dtype=np.int32).reshape(1, 24, 24)
    lab0 = np.where(mask, iota, n).astype(np.int32)
    ref = jcc._cc_rounds_batched(fg, jnp.asarray(lab0), 1, rounds)
    got = tcc._cc_rounds_batched(torch.from_numpy(mask), torch.from_numpy(lab0), 1,
                                 rounds)
    _assert_same(got, ref)


@pytest.mark.parametrize("rounds", [1, 8])
def test_label_batched_small_matches_jax(rounds):
    """Marker plateaus (flag True) and wider components (flag False at a
    small round budget)."""
    rng = np.random.default_rng(5)
    mask = rng.random((3, 40, 40)) < 0.08
    mask[1, 10:20, 5:30] = True             # diameter far above 8
    ref = jcc.label_batched_small(jnp.asarray(mask), rounds=rounds)
    got = tcc.label_batched_small(torch.from_numpy(mask), rounds=rounds)
    _assert_same(got, ref)
    assert got[2] is False


@pytest.mark.parametrize("kwargs", [dict(min_area=3), dict(min_area=2, max_area=6),
                                    dict(min_area=2, n_max=40),
                                    dict(min_area=2, n_max=10 ** 4)])
def test_area_filter_batched_matches_jax(kwargs):
    mask = _masks(9, density=0.45)
    labels = np.array(jcc.label_batched(jnp.asarray(mask))[0])
    ref = jcc.area_filter_batched(jnp.asarray(labels), **kwargs)
    got = tcc.area_filter_batched(torch.from_numpy(labels), **kwargs)
    _assert_same(got, ref)


def test_neighbor_min_matches_jax():
    rng = np.random.default_rng(2)
    lab = rng.integers(0, 50, (2, 9, 11)).astype(np.int32)
    fg = rng.random((2, 9, 11)) < 0.7
    for conn in (1, 2):
        ref = jcc._neighbor_min_batched(jnp.asarray(lab), jnp.asarray(fg), 99, conn)
        got = tcc._neighbor_min(torch.from_numpy(lab), torch.from_numpy(fg), 99,
                                conn)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tcc._budget(512 * 512) == jcc._budget(512 * 512)


def test_offset_guard_refuses_the_same_shapes():
    for mod in (jcc, tcc):
        with pytest.raises(ValueError, match="split the batch"):
            mod._check_offset_ids(2 ** 12, 2 ** 20)
