"""The port's segment reductions, relabeling and boundaries against the JAX
package's, on the CPU.

Tolerances: every segment sum (sizes, channel sums, positive counts,
centroid and centre-weighted sums, Crofton and Euler sums, the centroid and
central-moment passes and the channel sums riding the second pass) is
bitwise equal in every row, row 0 (the background's own sums) included. With
``background=False``, which the cell table and the fiber table pass, row 0
of the sums is zero and rows 1: are unchanged. The derived features (axis
lengths, eccentricity, orientation, equivalent diameter) are held to
rtol = atol = 1e-6: XLA's atan2 and its fusion of the eigenvalue arithmetic
round differently from torch's in the last bit; area, centroids and
perimeter stay bitwise. Relabeling and boundaries are integer work,
bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ark_tpu.ops import morphology as JMO
from ark_tpu.ops import relabel as JRL
from ark_tpu.ops import segment_reduce as JSR
from ark_tpu_torch.ops import morphology as TMO
from ark_tpu_torch.ops import relabel as TRL
from ark_tpu_torch.ops import segment_reduce as TSR

torch.set_num_threads(2)

DERIVED_TOL = 1e-6
BITWISE_FEATURES = ("area", "centroid-0", "centroid-1", "perimeter")


def _blobs(rng, shape, n, rmax=9, scale=1):
    """Overlapping elliptic blobs (touching cells, concave unions), labels
    i * scale."""
    h, w = shape
    lab = np.zeros(shape, np.int32)
    yy, xx = np.ogrid[:h, :w]
    for i in range(1, n + 1):
        y, x, r = rng.integers(0, h), rng.integers(0, w), rng.integers(1, rmax)
        lab[((yy - y) ** 2 + (xx - x) ** 2 * rng.uniform(0.4, 2.5)) < r * r] = i * scale
    return lab


def _label_cases():
    rng = np.random.default_rng(7)
    cases = {"blobs": _blobs(rng, (96, 128), 40),
             "gaps_and_large_ids": _blobs(rng, (64, 80), 25, scale=977),
             "dense_random": rng.integers(0, 30, (48, 40)).astype(np.int32),
             "empty_fov": np.zeros((32, 48), np.int32)}
    single = _blobs(rng, (40, 40), 6)
    single[0, 39] = 50                      # a single-pixel cell at a corner
    cases["single_pixel"] = single
    return cases


LABELS = _label_cases()


@pytest.fixture(params=sorted(LABELS))
def case(request):
    lab = LABELS[request.param]
    rng = np.random.default_rng(len(request.param))
    img = rng.gamma(1.0, 3.0, lab.shape + (5,)).astype(np.float32)
    img[rng.random(img.shape) < 0.3] = 0.0
    return lab, img, int(lab.max()) + 1


def _assert_bitwise(jax_out, torch_out):
    """Every row, the background's included (NaN rows of absent labels
    compare equal)."""
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))


def test_segment_sums_bitwise(case):
    lab, img, s = case
    jl, ji = jnp.asarray(lab), jnp.asarray(img)
    tl, ti = torch.as_tensor(lab), torch.as_tensor(img)
    _assert_bitwise(JSR.cell_sizes(jl, s), TSR.cell_sizes(tl, s))
    _assert_bitwise(JSR.channel_sums(ji, jl, s), TSR.channel_sums(ti, tl, s))
    for thr in (0.0, 2.5):
        _assert_bitwise(JSR.positive_pixel_counts(ji, jl, s, thr),
                        TSR.positive_pixel_counts(ti, tl, s, thr))
    _assert_bitwise(JSR.crofton_perimeter(jl, s), TSR.crofton_perimeter(tl, s))
    _assert_bitwise(JSR.euler_numbers(jl, s), TSR.euler_numbers(tl, s))
    # centroids and centre weights: NaN rows (absent labels) on both sides
    _assert_bitwise(JSR.centroids(jl, s), TSR.centroids(tl, s))
    _assert_bitwise(JSR.center_weighted_sums(ji, jl, s),
                    TSR.center_weighted_sums(ti, tl, s))


def _background_image(seed=11, shape=(72, 90)):
    """Seeded blobs on a background that holds more than half the pixels."""
    lab = _blobs(np.random.default_rng(seed), shape, 25, rmax=6)
    assert (lab == 0).mean() > 0.5
    return lab


REDUCERS = {
    "segment_sum": lambda m, img, lab, s, **kw: (
        jax.ops.segment_sum(img.reshape(-1, img.shape[-1]), lab.reshape(-1),
                            num_segments=s) if m is JSR
        else m.segment_sum(img.reshape(-1, img.shape[-1]), lab.reshape(-1), s, **kw)),
    "cell_sizes": lambda m, img, lab, s, **kw: m.cell_sizes(lab, s, **kw),
    "channel_sums": lambda m, img, lab, s, **kw: m.channel_sums(img, lab, s, **kw),
    "positive_pixel_counts": lambda m, img, lab, s, **kw: m.positive_pixel_counts(
        img, lab, s, 1.5, **kw),
    "centroids": lambda m, img, lab, s, **kw: m.centroids(lab, s, **kw),
    "center_weighted_sums": lambda m, img, lab, s, **kw: m.center_weighted_sums(
        img, lab, s, **kw),
}
# quotients of the sums: held to the file's tolerance for derived columns
QUOTIENTS = ("centroids",)


@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_background_row_matches_jax(name):
    """Row 0 is the JAX package's: the sums of the label-0 pixels in
    ascending pixel order (bitwise), the centroid of the background within
    1e-6; with background=False row 0 is zero (NaN for the centroid) and
    rows 1: keep their bits."""
    lab = _background_image()
    s = int(lab.max()) + 1
    img = np.random.default_rng(12).gamma(1.0, 3.0, lab.shape + (4,)).astype(np.float32)
    want = np.asarray(REDUCERS[name](JSR, jnp.asarray(img), jnp.asarray(lab), s))
    args = (TSR, torch.as_tensor(img), torch.as_tensor(lab), s)
    got = REDUCERS[name](*args).numpy()
    assert np.all(np.isfinite(want[0])) and np.any(want[0] != 0)
    if name in QUOTIENTS:
        np.testing.assert_allclose(got[0], want[0], rtol=DERIVED_TOL, atol=DERIVED_TOL)
    else:
        np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1:], want[1:])
    without = REDUCERS[name](*args, background=False).numpy()
    np.testing.assert_array_equal(without[1:], got[1:])
    if name == "centroids":
        assert np.isnan(without[0]).all()
    elif name != "center_weighted_sums":     # its row 0 is a sum of NaN weights
        assert not without[0].any()


@pytest.mark.parametrize("n_points,k", [(1, 1), (40, 3), (500, 15)])
def test_flat_sorted_labels_from_zero(n_points, k):
    """The shape of UMAP's edge sums: flat sorted labels that start at 0
    (each point id `k` times, then a stable sort of arbitrary ids), two
    columns; segment 0 is point 0, a real row. Bitwise the JAX package's
    sorted segment_sum, with and without a plan."""
    rng = np.random.default_rng(n_points)
    vals = rng.normal(size=(n_points * k, 2)).astype(np.float32)
    heads = np.repeat(np.arange(n_points, dtype=np.int32), k)
    tails = np.sort(rng.integers(0, n_points, n_points * k).astype(np.int32),
                    kind="stable")
    for ids in (heads, tails):
        want = np.asarray(jax.ops.segment_sum(
            jnp.asarray(vals), jnp.asarray(ids), num_segments=n_points,
            indices_are_sorted=True))
        ids_t, vals_t = torch.as_tensor(ids), torch.as_tensor(vals)
        plan = TSR.segment_plan(ids_t, n_points)
        for got in (TSR.segment_sum(vals_t, ids_t, n_points),
                    TSR.segment_sum(vals_t, ids_t, n_points, plan)):
            np.testing.assert_array_equal(got.numpy(), want)
        assert np.any(want[0] != 0)


def test_central_moment_passes_bitwise(case):
    """Both passes of the two-pass central moments, in the jitted form the
    JAX package runs them (inside moment_features' jit), with the channel
    sums riding the second pass."""
    lab, img, s = case
    extra = img.reshape(-1, img.shape[-1])
    want = jax.jit(JSR._central_moment_sums, static_argnums=1)(
        jnp.asarray(lab), s, jnp.asarray(extra))
    got = TSR._central_moment_sums(torch.as_tensor(lab), s, torch.as_tensor(extra))
    for name, j, t in zip(("m00", "cy", "cx", "mu20", "mu02", "mu11",
                           "perimeter", "extra"), want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def test_moment_features_match_jax(case):
    lab, img, s = case
    jf, jc = JSR.moment_and_channel_features(jnp.asarray(img), jnp.asarray(lab), s)
    tf, tc = TSR.moment_and_channel_features(torch.as_tensor(img),
                                             torch.as_tensor(lab), s)
    _assert_bitwise(jc, tc)
    jm = JSR.moment_features(jnp.asarray(lab), s)
    tm = TSR.moment_features(torch.as_tensor(lab), s)
    assert sorted(tf) == sorted(jf) == sorted(tm) == sorted(jm)
    for feats_j, feats_t in ((jf, tf), (jm, tm)):
        for name in feats_j:
            j, t = np.asarray(feats_j[name]), feats_t[name].numpy()
            if name in BITWISE_FEATURES:
                np.testing.assert_array_equal(t, j, err_msg=name)
            else:
                np.testing.assert_allclose(t, j, rtol=DERIVED_TOL,
                                           atol=DERIVED_TOL, err_msg=name)


def test_far_corner_cell_keeps_its_shape():
    """A small ellipse at the far corner of a 4096^2 FOV: the port's
    features equal the JAX package's, and equal those of the same cell near
    the origin within 1e-3, which only the two-pass central moments give
    (raw f32 moments were 37% off in eccentricity there)."""
    yy, xx = np.mgrid[:24, :36]
    cell = (((yy - 12) / 11.0) ** 2 + ((xx - 18) / 17.0) ** 2 <= 1.0).astype(np.int32)

    def feats_at(offset, size=4096):
        labels = np.zeros((size, size), np.int32)
        labels[offset:offset + 24, offset:offset + 36] = cell
        t = TSR.moment_features(torch.as_tensor(labels), 2)
        j = JSR.moment_features(jnp.asarray(labels), 2)
        return ({k: float(v[1]) for k, v in t.items()},
                {k: float(np.asarray(v)[1]) for k, v in j.items()})

    near, _ = feats_at(0)
    far, far_jax = feats_at(4096 - 40)
    for key in far:
        assert far[key] == pytest.approx(far_jax[key], rel=DERIVED_TOL,
                                         abs=DERIVED_TOL), key
    for key in ("eccentricity", "major_axis_length", "minor_axis_length",
                "orientation", "area", "perimeter"):
        assert near[key] == pytest.approx(far[key], rel=1e-3, abs=1e-3), key


def test_segment_sum_plain_is_a_sequential_scatter():
    """index_add_ on the CPU adds in ascending index order: bitwise equal to
    np.add.at, row 0 included; num_segments past the largest label gives zero
    rows; 1-D and 2-D values; no launch is counted."""
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 50, 20_000).astype(np.int32)
    lab[lab > 40] += 1000
    for vals in (rng.gamma(1.0, 3.0, (lab.size, 7)).astype(np.float32),
                 rng.random(lab.size, dtype=np.float32)):
        want = np.zeros((1200,) + vals.shape[1:], np.float32)
        np.add.at(want, lab, vals)
        before = TSR.segment_sum.launches
        got = TSR.segment_sum(torch.as_tensor(vals), torch.as_tensor(lab), 1200)
        np.testing.assert_array_equal(got.numpy(), want)
        assert TSR.segment_sum.launches == before
    empty = TSR.segment_sum(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.int32), 4)
    assert empty.shape == (4, 3) and not empty.any()


def test_segment_sum_drops_labels_out_of_range_like_jax():
    """Labels < 0 or >= num_segments contribute nothing, as in
    jax.ops.segment_sum; the rest keep their sequential order."""
    rng = np.random.default_rng(1)
    lab = rng.integers(-5, 60, 5000).astype(np.int32)
    vals = rng.gamma(1.0, 3.0, (lab.size, 3)).astype(np.float32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(lab),
                                          num_segments=50))
    got = TSR.segment_sum(torch.as_tensor(vals), torch.as_tensor(lab), 50)
    _assert_bitwise(want, got)


@pytest.mark.parametrize("mode", ["inner", "outer", "thick"])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_find_boundaries_matches_jax(mode, connectivity):
    lab = LABELS["blobs"]
    want = np.asarray(JMO.find_boundaries(jnp.asarray(lab), connectivity=connectivity,
                                          mode=mode))
    got = TMO.find_boundaries(torch.as_tensor(lab), connectivity=connectivity,
                              mode=mode)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,use_device", [(np.float64, True), (np.float64, False),
                                              (np.float32, True), (np.int32, True),
                                              (np.int64, True)])
def test_relabel_segmentation_matches_jax(dtype, use_device):
    lab = LABELS["gaps_and_large_ids"]
    ids = np.unique(lab)[1:]
    mapping = {int(i): float(k % 7) + 0.25 for k, i in enumerate(ids[::2])}
    mapping[10 ** 7] = 3.0                       # out of range: ignored
    want = JRL.relabel_segmentation(mapping, -1, lab, _dtype=dtype,
                                    use_device=use_device)
    got = TRL.relabel_segmentation(mapping, -1, lab, _dtype=dtype,
                                   use_device=use_device, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TRL.build_lut(mapping, int(lab.max()), 0, dtype),
        JRL.build_lut(mapping, int(lab.max()), 0, dtype))


# --- the plan: one per label image, reused by every sum over it -----------

def _plan_case(rng, shape=(37, 53), n_labels=40):
    """Labels with gaps, out-of-range ids (negative and past num_segments)
    and a segment that wraps around the image's edge in raster order."""
    lab = _blobs(rng, shape, n_labels, rmax=7)
    lab[0, -3:] = 7
    lab[1, :2] = 7                            # label 7 spans a row break
    lab[rng.random(shape) < 0.02] = -4
    lab[rng.random(shape) < 0.02] = n_labels + 30
    return lab


@pytest.mark.parametrize("k", [1, 3, 31, 32, 33, 44, 65])
def test_segment_sum_with_a_plan_matches_plain(k):
    """Edge cases at every column count the kernel tiles differently:
    labels outside [0, num_segments) dropped, empty segments zero, one
    segment (only the background), 1-D values for K = 1; a reused plan
    gives the fresh call's sums, and background=False zeroes row 0 alone."""
    rng = np.random.default_rng(k)
    lab = torch.as_tensor(_plan_case(rng))
    s = int(lab.max()) - 10                   # some labels past num_segments
    vals = torch.as_tensor(rng.gamma(1.0, 3.0, (lab.numel(), k)).astype(np.float32))
    if k == 1:
        vals = vals[:, 0]
    plan = TSR.segment_plan(lab, s)
    want = TSR.segment_sum_plain(vals, lab.reshape(-1), s)
    for got in (TSR.segment_sum(vals, lab, s, plan), TSR.segment_sum(vals, lab, s, plan),
                TSR.segment_sum(vals, lab, s)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    absent = np.setdiff1d(np.arange(1, s), lab.numpy())
    assert absent.size and want[0].all() and not want[absent].any()
    without = TSR.segment_sum(vals, lab, s, plan, background=False)
    assert not without[0].any() and torch.equal(without[1:], want[1:])
    one = TSR.segment_sum(vals, lab, 1, TSR.segment_plan(lab, 1))
    assert one.shape == (1,) + tuple(vals.shape[1:])
    assert torch.equal(one[0], want[0])
    assert not TSR.segment_sum(vals, lab, 1, background=False).any()


def test_mismatched_plan_raises():
    lab = torch.as_tensor(_plan_case(np.random.default_rng(0)))
    vals = torch.ones(lab.numel(), 3)
    plan = TSR.segment_plan(lab, 20)
    with pytest.raises(ValueError, match="plan"):
        TSR.segment_sum(vals, lab, 21, plan)                     # num_segments
    with pytest.raises(ValueError, match="plan"):
        TSR.segment_sum(vals, lab.reshape(-1), 20, plan)         # shape
    with pytest.raises(ValueError, match="plan"):
        TSR.segment_sum(vals, lab.T.contiguous(), 20, plan)      # transposed image


def test_boxes_hold_every_pixel_and_raster_order_is_pixel_order():
    """The plan kernel's plain version gives each segment's tightest box
    (empty for absent labels; row 0 holds the background's); adding a segment's pixels while
    scanning its box in raster order, as the walk does, is the sequential
    scatter, bit for bit."""
    rng = np.random.default_rng(5)
    lab = _plan_case(rng)
    s = int(lab.max()) - 10
    boxes = TSR.segment_boxes_plain(torch.as_tensor(lab), s).numpy()
    assert boxes.dtype == np.int32 and boxes.shape == (s, 4)
    empty = [2 ** 31 - 1, -1, 2 ** 31 - 1, -1]
    vals = rng.gamma(1.0, 3.0, (lab.size, 3)).astype(np.float32)
    want = TSR.segment_sum_plain(torch.as_tensor(vals), torch.as_tensor(lab), s).numpy()
    flat_vals = vals.reshape(lab.shape + (3,))
    for seg in range(s):
        ys, xs = np.nonzero(lab == seg)
        if ys.size == 0:
            assert boxes[seg].tolist() == empty
            continue
        assert boxes[seg].tolist() == [ys.min(), ys.max(), xs.min(), xs.max()]
        r0, r1, c0, c1 = boxes[seg]
        acc = np.zeros(3, np.float32)
        for r in range(r0, r1 + 1):
            for c in range(c0, c1 + 1):
                if lab[r, c] == seg:
                    acc = acc + flat_vals[r, c]
        np.testing.assert_array_equal(acc, want[seg])
    flat = TSR.segment_boxes_plain(torch.as_tensor(lab.reshape(-1)), s).numpy()
    rows = np.nonzero((flat[:, 0] != empty[0]))[0]
    assert (flat[rows, 0] == 0).all() and (flat[rows, 1] == 0).all()    # one row


def test_central_moment_sums_build_one_plan(monkeypatch):
    """The two passes of one compartment share one plan."""
    calls = []
    real = TSR.segment_plan

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TSR, "segment_plan", counting)
    lab = LABELS["blobs"]
    TSR.moment_and_channel_features(torch.ones(lab.shape + (2,)), torch.as_tensor(lab),
                                    int(lab.max()) + 1)
    assert len(calls) == 1
