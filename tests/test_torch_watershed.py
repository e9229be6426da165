"""ark_tpu_torch.ops.watershed against ark_tpu.ops.watershed on the same
numpy inputs, and the port's exact order statistics against the JAX
package's bisection.

Everything here is integer or exact-order-statistic work, so the tolerance
is none: quantized levels, claim rounds, labels and convergence flags must
be equal bit for bit. The Pallas claim kernel runs in interpret mode, as the
JAX package's own tests run it on the CPU.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from ark_tpu.ops import quantiles as jq
from ark_tpu.ops import watershed as JW
from ark_tpu_torch.ops import _kernels
from ark_tpu_torch.ops import quantiles as tq
from ark_tpu_torch.ops import watershed as TW
from chip_smoke import claim_inputs

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_float_keys_roundtrip_matches_jax():
    x = np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan, 1e-45, -3e38],
                 np.float32)
    ref = np.asarray(jq._float_keys(jnp.asarray(x))).astype(np.int64)
    got = tq._float_keys(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    back = tq._keys_to_float(torch.from_numpy(ref)).numpy()
    np.testing.assert_array_equal(_bits(back), _bits(x))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_order_stats_matches_bisection(seed):
    """Exact order statistics, bit for bit, including -0.0/+0.0 ties, an
    all-invalid column and ranks past the valid count (both give the float
    of key 0xFFFFFFFF)."""
    rng = np.random.default_rng(seed)
    n, c = 301, 5
    x = rng.normal(size=(n, c)).astype(np.float32)
    x[rng.random((n, c)) < 0.1] = 0.0
    x[rng.random((n, c)) < 0.1] = -0.0
    valid = rng.random((n, c)) < 0.6
    valid[:, 3] = False
    nv = valid.sum(0)
    ranks = np.stack([np.zeros(c), nv // 2, np.maximum(nv - 1, 0), nv + 3],
                     axis=1).astype(np.int32)
    ref = jq.masked_order_stats(jnp.asarray(x), jnp.asarray(valid),
                                jnp.asarray(ranks))
    got = tq.masked_order_stats(torch.from_numpy(x), torch.from_numpy(valid),
                                torch.from_numpy(ranks))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


def test_quantize_matches_jax_with_blank_fov():
    """A FOV with no masked pixel has NaN statistics on both sides; its
    levels must still come out equal (XLA converts NaN to 0)."""
    rng = np.random.default_rng(4)
    elev = rng.normal(size=(3, 40, 56)).astype(np.float32)
    mask = rng.random((3, 40, 56)) < 0.7
    mask[1] = False
    ref = JW._quantize(jnp.asarray(elev), jnp.asarray(mask), 256)
    got = TW._quantize(torch.from_numpy(elev), torch.from_numpy(mask), 256)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantize_hot_pixel_matches_jax():
    rng = np.random.default_rng(12345)
    elev = rng.random((1, 48, 48)).astype(np.float32)
    elev[0, 0, 0] = 1e9
    mask = np.ones_like(elev, bool)
    ref = np.asarray(JW._quantize(jnp.asarray(elev), jnp.asarray(mask), 256))
    got = TW._quantize(torch.from_numpy(elev), torch.from_numpy(mask), 256).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0, 0] == 255 and len(np.unique(got)) > 100


@pytest.mark.parametrize("level", [0, 7, 15])
def test_claim_round_matches_jax_and_pallas(level, monkeypatch):
    """The port's plain round == the JAX round (with its mask operand) ==
    the Pallas kernel in interpret mode on the mask-encoded labels, and
    claim_round's changed count == the kernel's."""
    monkeypatch.setattr(JW, "_PALLAS_INTERPRET", True)
    rng = np.random.default_rng(level)
    b, h, w, bh = 2, 32, 128, 8
    lab, q = claim_inputs(rng, (b, h, w), levels=16)
    mask = lab >= 0
    lab0 = np.where(mask, lab, 0).astype(np.int32)
    ref_masked = np.asarray(JW._claim_round(jnp.asarray(lab0), jnp.asarray(q),
                                            jnp.asarray(mask), jnp.int32(level)))
    got_masked = TW._claim_round(torch.from_numpy(lab0), torch.from_numpy(q),
                                 torch.from_numpy(mask), level).numpy()
    np.testing.assert_array_equal(got_masked, ref_masked)

    qhalo = JW._band_halos(jnp.asarray(q), bh)
    ref_p, chg_p = JW._claim_round_pallas(jnp.asarray(lab), jnp.asarray(q), qhalo,
                                          jnp.int32(level), bh)
    got, chg = TW.claim_round(torch.from_numpy(lab), torch.from_numpy(q), level)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_p))
    assert int(chg) == int(chg_p) == int((got.numpy() != lab).sum())
    np.testing.assert_array_equal(np.where(got.numpy() < 0, 0, got.numpy()),
                                  ref_masked)


def _relief(seed, b=2, h=32, w=128, n_markers=5):
    rng = np.random.default_rng(seed)
    elev = np.stack([ndi.gaussian_filter(rng.random((h, w)), 2)
                     for _ in range(b)]).astype(np.float32)
    mask = elev < np.quantile(elev, 0.8, axis=(1, 2), keepdims=True)
    markers = np.zeros_like(elev, np.int32)
    for i in range(b):
        ys, xs = np.where(mask[i])
        for j, k in enumerate(rng.choice(ys.size, n_markers, replace=False)):
            markers[i, ys[k], xs[k]] = j + 1
    return elev, markers, mask


def _levels(elev, mask, levels):
    q = JW._quantize(jnp.asarray(elev), jnp.asarray(mask), levels)
    return q, torch.from_numpy(np.array(q))


def test_level_flood_matches_pallas_flood(monkeypatch):
    """The level engine == the JAX level engine with its Pallas rounds in
    interpret mode: same claims, same ties, same flag."""
    elev, markers, mask = _relief(11)
    qj, qt = _levels(elev, mask, 32)
    monkeypatch.setattr(JW, "_PALLAS_INTERPRET", True)
    JW._flood.clear_cache()
    JW._quantize_and_flood.clear_cache()
    try:
        ref, done = JW._flood(qj, jnp.asarray(markers), jnp.asarray(mask), 32, 4)
        ref, done = np.asarray(ref), bool(done)
    finally:
        JW._flood.clear_cache()
        JW._quantize_and_flood.clear_cache()
    got, got_done = TW._flood(qt, torch.from_numpy(markers), torch.from_numpy(mask),
                              32, 4)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got_done is done is True


@pytest.mark.parametrize("bfs_rounds", [0, 1, 2])
def test_level_flood_phase_b_matches_jax(bfs_rounds):
    """bfs_rounds small enough that phase B (connected components of the
    conductive set, min label per component) finishes most levels."""
    elev, markers, mask = _relief(3, b=3, h=24, w=40, n_markers=6)
    mask[2, :, 20:22] = False
    qj, qt = _levels(elev, mask, 64)
    ref, done = JW._flood(qj, jnp.asarray(markers), jnp.asarray(mask), 64,
                          bfs_rounds)
    got, got_done = TW._flood(qt, torch.from_numpy(markers), torch.from_numpy(mask),
                              64, bfs_rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got_done == bool(done)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minimax_flood_matches_jax(seed):
    elev, markers, mask = _relief(20 + seed, b=2, h=40, w=48, n_markers=6)
    qj, qt = _levels(elev, mask, 256)
    ref, done = JW._flood_minimax(qj, jnp.asarray(markers), jnp.asarray(mask), 256,
                                  rounds=2 * (40 + 48))
    got, got_done = TW._flood_minimax(qt, torch.from_numpy(markers),
                                      torch.from_numpy(mask), 256, 2 * (40 + 48))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got_done is bool(done) is True


@pytest.mark.parametrize("rounds", [1, 128])
def test_minimax_round_budget_flag_matches_jax(rounds):
    """One block cannot certify a 32x32 flood from a corner (False on both
    sides, equal partial labels); 128 rounds can."""
    markers = np.zeros((1, 32, 32), np.int32)
    markers[0, 0, 0] = 1
    q = np.zeros((1, 32, 32), np.int32)
    mask = np.ones((1, 32, 32), bool)
    ref, done = JW._flood_minimax(jnp.asarray(q), jnp.asarray(markers),
                                  jnp.asarray(mask), 256, rounds=rounds)
    got, got_done = TW._flood_minimax(torch.from_numpy(q), torch.from_numpy(markers),
                                      torch.from_numpy(mask), 256, rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got_done is bool(done) is (rounds == 128)


@pytest.mark.parametrize("engine", ["minimax", "levels"])
def test_masked_gap_blocks_the_flood(engine, monkeypatch):
    """A corridor with a full-height masked gap: the far side stays 0 under
    both engines, equal to the JAX package's labels."""
    monkeypatch.setattr(JW, "_ENGINE", engine)
    monkeypatch.setattr(TW, "_ENGINE", engine)
    elev = np.zeros((8, 64), np.float32)
    mask = np.ones((8, 64), bool)
    mask[:, 30:34] = False
    markers = np.zeros((8, 64), np.int32)
    markers[4, 2] = 1
    JW._quantize_and_flood.clear_cache()
    ref, done = JW.watershed_device(elev, markers, mask)
    JW._quantize_and_flood.clear_cache()
    got, got_done = TW.watershed_device(elev, markers, mask, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got_done is bool(done) is True
    assert (got.numpy()[:, 34:] == 0).all()


def test_watershed_batch_np_falls_back_to_native(monkeypatch):
    rng = np.random.default_rng(6)
    elev = rng.random((2, 16, 16)).astype(np.float32)
    markers = np.zeros_like(elev, np.int32)
    markers[:, 8, 8] = 1
    mask = np.ones_like(elev, bool)
    real = TW.watershed_device
    monkeypatch.setattr(TW, "watershed_device",
                        lambda *a, **k: (real(*a, **k)[0], False))
    got = TW.watershed_batch_np(elev, markers, mask, device="cpu")
    want = np.stack([JW.watershed(elev[i], markers[i], mask[i]) for i in range(2)])
    np.testing.assert_array_equal(got, want)


def test_claim_round_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Off the CPU, claim_round launches the kernel or raises; it never runs
    the plain round, and a device that is not CUDA raises before any
    library is built."""
    def refuse(name):
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_kernels, "lib", refuse)
    lab = torch.empty((1, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TW.claim_round(lab, lab, 0)
    before = TW.claim_round.launches
    got, chg = TW.claim_round(torch.zeros((1, 4, 4), dtype=torch.int32),
                              torch.zeros((1, 4, 4), dtype=torch.int32), 0)
    assert int(chg) == 0 and TW.claim_round.launches == before
