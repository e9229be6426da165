"""ark_tpu_torch.ops.cc against ark_tpu.ops.cc on the same numpy masks.

Labeling is integer work with a fixed schedule of rounds, so labels, counts
and convergence flags must be equal bit for bit (tolerance: none),
including where a round budget is too small and the flag reports it, for
the batched stacks and for the single-image API (labels, area filters,
small objects and holes, the latter two also against scipy).
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


# ---------------------------------------------------------------------------
# The single-image API
# ---------------------------------------------------------------------------

def _structure(connectivity):
    return np.ones((3, 3)) if connectivity == 2 else None


def _scipy_small_objects(mask, min_size, connectivity):
    lab, _ = ndi.label(mask, structure=_structure(connectivity))
    areas = np.bincount(lab.ravel())
    return (lab > 0) & (areas[lab] >= min_size)


def _scipy_small_holes(mask, area_threshold, connectivity):
    return mask | _scipy_small_objects(~mask, 1, connectivity) & \
        ~_scipy_small_objects(~mask, area_threshold + 1, connectivity)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("density", [0.2, 0.55, 0.8])
def test_label_matches_jax_and_scipy(density, connectivity):
    mask = np.random.default_rng(int(density * 10) + connectivity).random((57, 43)) < density
    ref = jcc._label_full(jnp.asarray(mask), connectivity)
    got = tcc._label_full(torch.from_numpy(mask), connectivity)
    _assert_same(got, ref)                 # labels, count, representatives, flag
    assert got[3] is True
    labels, n = tcc.label(mask, connectivity, device="cpu")
    want, n_want = ndi.label(mask, structure=_structure(connectivity))
    np.testing.assert_array_equal(labels.numpy(), want)
    assert labels.dtype == torch.int32 and int(n) == n_want
    ref_labels, ref_n = jcc.label(jnp.asarray(mask), connectivity)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    assert int(n) == int(ref_n)


def test_label_resumes_after_a_shrunk_budget(monkeypatch):
    """A one-round budget leaves the labels unconverged on both sides; each
    resume runs the same rounds, and label_checked ends on scipy's labels.
    (A shape no other test traces: jit caches the budget by shape.)"""
    monkeypatch.setattr(jcc, "_budget", lambda n: 1)
    monkeypatch.setattr(tcc, "_budget", lambda n: 1)
    mask = np.random.default_rng(12).random((31, 39)) < 0.55
    fg_j, fg_t = jnp.asarray(mask), torch.from_numpy(mask)
    ref = jcc._label_full(fg_j, 1)
    got = tcc._label_full(fg_t, 1)
    _assert_same(got, ref)
    assert got[3] is False
    resumes = 0
    while not got[3]:
        ref = jcc._label_resume(fg_j, ref[2], 1)
        got = tcc._label_resume(fg_t, got[2], 1)
        _assert_same(got, ref)
        resumes += 1
    assert resumes >= 1
    labels, n = tcc.label_checked(mask, 1, device="cpu")
    want, n_want = ndi.label(mask)
    np.testing.assert_array_equal(labels.numpy(), want)
    assert int(n) == n_want


@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_np_is_a_writable_copy_equal_to_jax(connectivity):
    mask = np.random.default_rng(20 + connectivity).random((40, 33)) < 0.5
    got, n = tcc.label_np(mask, connectivity, device="cpu")
    want, n_want = jcc.label_np(mask, connectivity)
    assert isinstance(n, int) and n == n_want
    np.testing.assert_array_equal(got, want)
    assert got.flags.writeable
    got[got == 1] = 0                      # host pipelines edit labels in place
    again, _ = tcc.label_np(mask, connectivity, device="cpu")
    np.testing.assert_array_equal(again, want)


@pytest.mark.parametrize("kwargs", [dict(min_area=3), dict(min_area=2, max_area=6),
                                    dict(min_area=2, n_max=40), dict(n_max=5, min_area=1),
                                    dict(min_area=2, n_max=10 ** 4)])
def test_area_filter_matches_jax(kwargs):
    """With and without the table bound; labels past it (which read the
    table's last entry, as JAX's gather clamps) and negative labels (which
    count from its end) included."""
    mask = np.random.default_rng(31).random((45, 38)) < 0.45
    labels = np.array(jcc.label(jnp.asarray(mask))[0])
    labels[0, :5] = [-1, -3, -10 ** 6, 60, 10 ** 6]
    ref = jcc.area_filter(jnp.asarray(labels), **kwargs)
    got = tcc.area_filter(torch.from_numpy(labels), **kwargs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("min_size", [1, 4, 12])
def test_remove_small_objects_matches_jax_and_scipy(min_size, connectivity):
    mask = np.random.default_rng(min_size).random((50, 47)) < 0.4
    got = tcc.remove_small_objects(mask, min_size, connectivity, device="cpu").numpy()
    ref = np.asarray(jcc.remove_small_objects(jnp.asarray(mask), min_size, connectivity))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _scipy_small_objects(mask, min_size, connectivity))


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("area_threshold", [0, 3, 64])
def test_remove_small_holes_matches_jax_and_scipy(area_threshold, connectivity):
    mask = np.random.default_rng(area_threshold + 7).random((48, 52)) < 0.62
    want = _scipy_small_holes(mask, area_threshold, connectivity)
    got = tcc.remove_small_holes(mask, area_threshold, connectivity, device="cpu").numpy()
    ref = np.asarray(jcc.remove_small_holes(jnp.asarray(mask), area_threshold,
                                            connectivity))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)
    got_np = tcc.remove_small_holes_np(mask, area_threshold, connectivity, device="cpu")
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_array_equal(got_np, jcc.remove_small_holes_np(mask, area_threshold,
                                                                    connectivity))
    np.testing.assert_array_equal(got_np, want)


def test_single_image_api_takes_tensors_and_follows_device():
    mask = np.eye(8, dtype=np.uint8) * 3             # nonzero is foreground
    for m in (mask, torch.from_numpy(mask)):
        lab4, n4 = tcc.label(m, 1, device="cpu")
        lab8, n8 = tcc.label(m, 2, device="cpu")
        assert (int(n4), int(n8)) == (8, 1) and lab4.device.type == "cpu"
        assert tcc.area_filter(lab8, min_area=9).sum() == 0
