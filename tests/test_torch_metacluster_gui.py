"""ark_tpu_torch.utils.metacluster_remap_gui against
ark_tpu.utils.metacluster_remap_gui, headless under Agg.

Each case mirrors one of tests/utils/test_metacluster_{gui,io}.py: the same
state transitions (clicks, drags, buttons, remaps, renames) run on both
packages' GUIs, built from one CSV, and leave the same state: the same
assertions hold on the port's, and both give the same frames (the Agg
canvas's RGBA bytes), the same image arrays and colours of every heatmap
and strip, and the same remap CSV bytes. The reader's validation raises the
same errors, and the throttle fires the same calls.
"""

import asyncio

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot  # noqa: E402

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from ark_tpu.utils import metacluster_remap_gui as J  # noqa: E402
from ark_tpu.utils.metacluster_remap_gui import throttle as JT  # noqa: E402
from ark_tpu_torch.utils import metacluster_remap_gui as T  # noqa: E402
from ark_tpu_torch.utils.metacluster_remap_gui import throttle as TT  # noqa: E402

PACKAGES = {"jax": J, "port": T}
THROTTLES = {"jax": JT.throttle, "port": TT.throttle}
IMAGES = ("im_c", "im_m", "im_cs", "im_cl", "im_ml")


def _som_avg_csv(path, seed=0, n=20, constant_m2=False):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame(rng.random((n, 3)), columns=["m1", "m2", "m3"])
    if constant_m2:
        df["m2"] = 0.0
    df["pixel_som_cluster"] = np.arange(1, n + 1)
    df["pixel_meta_cluster"] = (np.arange(n) % (3 if constant_m2 else 4)) + 1
    df["count"] = rng.integers(10, 100, n)
    df.to_csv(path, index=False)
    return str(path)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    matplotlib.pyplot.close("all")


@pytest.fixture
def som_avg_csv(tmp_path):
    return _som_avg_csv(tmp_path / "som_avg.csv")


def _mcds(csv, tmp_path, **kwargs):
    out = {}
    for name, pkg in PACKAGES.items():
        mcd = pkg.metaclusterdata_from_files(csv, **kwargs)
        mcd.output_mapping_filename = str(tmp_path / f"remap_{name}.csv")
        out[name] = mcd
    return out


@pytest.fixture
def guis(som_avg_csv, tmp_path):
    """{package: (gui, mcd)}, each GUI built on Agg from the same CSV."""
    out = {}
    for name, mcd in _mcds(som_avg_csv, tmp_path).items():
        gui = PACKAGES[name].MetaClusterGui(mcd, enable_throttle=False)
        assert gui._figure is not None, "widget layer failed to build on Agg"
        out[name] = (gui, mcd)
    return out


def _frame(gui):
    gui._figure.canvas.draw()
    return bytes(gui._figure.canvas.buffer_rgba())


def _state(gui, mcd):
    state = {"selected": sorted(gui.selected_clusters),
             "mask": np.asarray(gui.selection_mask).tolist(),
             "mapping": mcd.mapping.to_dict(),
             "order": list(mcd.marker_order),
             "names": list(mcd.metacluster_displaynames),
             "norm": (gui.zscore_norm.vmin, gui.zscore_norm.vmax)}
    if gui._figure is not None:
        for key in IMAGES:
            im = getattr(gui, key)
            data = np.ma.filled(np.asarray(im.get_array(), dtype=float), np.nan)
            state[key] = (data.tobytes(), data.shape, im.to_rgba(im.get_array()).tobytes())
        state["frame"] = _frame(gui)
    path = mcd.output_mapping_filename
    if path is not None and path.exists():
        state["csv"] = path.read_bytes()
    return state


def _assert_same_state(guis):
    got = _state(*guis["port"])
    want = _state(*guis["jax"])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


def _both(guis, action):
    """Run `action(gui, mcd)` on each package's GUI; returns its results."""
    return {name: action(gui, mcd) for name, (gui, mcd) in guis.items()}


class _FakePick:
    """Stand-in for a matplotlib pick_event."""

    class _Mouse:
        def __init__(self, x, button):
            self.name = "button_press_event"
            self.xdata = float(x)
            self.button = button

    def __init__(self, artist, x, button=1):
        self.artist = artist
        self.mouseevent = self._Mouse(x, button)


class _FakeMouse:
    """Stand-in for a matplotlib button_press/release MouseEvent."""

    def __init__(self, inaxes, ydata):
        self.inaxes = inaxes
        self.ydata = ydata
        self.xdata = 1.0


# ---------------------------------------------------------------------------
# the state model, colormaps, the z-score norm
# ---------------------------------------------------------------------------

def test_metaclusterdata_from_files(som_avg_csv, tmp_path):
    mcds = _mcds(som_avg_csv, tmp_path, cluster_type="pixel")
    mcd, ref = mcds["port"], mcds["jax"]
    assert (mcd.cluster_count, mcd.metacluster_count, mcd.marker_count) == (20, 4, 3)
    assert mcd.metaclusters.shape == (4, 3)
    assert (mcd.metaclusters.values <= 1.0 + 1e-9).all()
    pd.testing.assert_frame_equal(mcd.metaclusters, ref.metaclusters)
    pd.testing.assert_frame_equal(mcd.clusters, ref.clusters)
    np.testing.assert_array_equal(mcd.linkage_matrix, ref.linkage_matrix)
    assert mcd.linkage_matrix.shape[1] == 4


def test_metaclusterdata_remap_and_save(som_avg_csv, tmp_path):
    mcds = _mcds(som_avg_csv, tmp_path)
    for mcd in mcds.values():
        new_mc = mcd.new_metacluster()
        assert new_mc == 5
        mcd.remap(1, new_mc)
        assert mcd.which_metacluster(1) == new_mc
        mcd.change_displayname(new_mc, "tumor")
    out = pd.read_csv(tmp_path / "remap_port.csv")
    assert {"pixel_som_cluster", "pixel_meta_cluster",
            "pixel_meta_cluster_rename"}.issubset(out.columns)
    assert (out[out["pixel_som_cluster"] == 1]["pixel_meta_cluster_rename"] == "tumor").all()
    assert (tmp_path / "remap_port.csv").read_bytes() == \
        (tmp_path / "remap_jax.csv").read_bytes()


def test_gui_selection_and_remap(som_avg_csv, tmp_path):
    """The state machine with the widget layer off (debug=True)."""
    guis = {name: (PACKAGES[name].MetaClusterGui(mcd, debug=True, enable_throttle=False),
                   mcd) for name, mcd in _mcds(som_avg_csv, tmp_path).items()}

    def act(gui, mcd):
        gui.select_cluster(1)
        gui.select_cluster(2, extend=True)
        assert gui.selected_clusters == {1, 2}
        gui.select_cluster(3)
        assert gui.selected_clusters == {3}
        gui.select_metacluster(1)
        assert set(mcd.cluster_in_metacluster(1)).issubset(gui.selected_clusters)
        mc = gui.new_metacluster_from_selection()
        assert all(mcd.which_metacluster(c) == mc for c in gui.selected_clusters)
        z = gui.cluster_heatmap_data()
        assert z.shape == (20, 3) and z.values.max() <= 3 and z.values.min() >= -3
        return mc, z

    got = _both(guis, act)
    assert got["port"][0] == got["jax"][0]
    pd.testing.assert_frame_equal(got["port"][1], got["jax"][1])
    _assert_same_state(guis)


def test_colormap_helpers(som_avg_csv, tmp_path):
    assert T.distinct_rgbs(10) == J.distinct_rgbs(10)
    assert len(set(T.distinct_rgbs(10))) == 10
    cmap = T.distinct_cmap(33)
    assert cmap.N == 33
    np.testing.assert_array_equal(cmap.colors, J.distinct_cmap(33).colors)
    for mcd in _mcds(som_avg_csv, tmp_path).values():
        mcd.save_output_mapping()
    raw, renamed = T.generate_meta_cluster_colormap_dict(str(tmp_path / "remap_port.csv"),
                                                         cmap)
    ref = J.generate_meta_cluster_colormap_dict(str(tmp_path / "remap_jax.csv"), cmap)
    assert set(raw) == {1, 2, 3, 4} and len(renamed) == 4
    assert (raw, renamed) == ref


def test_zscore_normalize():
    got, ref = T.ZScoreNormalize(-3, 0, 3), J.ZScoreNormalize(-3, 0, 3)
    vals = np.array([-3.0, -1.2, 0.0, 0.7, 3.0])
    np.testing.assert_array_equal(np.asarray(got(vals)), np.asarray(ref(vals)))
    np.testing.assert_allclose(got(np.array([-3.0, 0.0, 3.0])), [0, 0.5, 1.0])
    np.testing.assert_allclose(got.inverse([0, 0.5, 1.0]), [-3, 0, 3])
    np.testing.assert_array_equal(got.inverse([0.1, 0.9]), ref.inverse([0.1, 0.9]))


def test_zscore_calibrate_all_nan_falls_back():
    for pkg in PACKAGES.values():
        zn = pkg.ZScoreNormalize()
        zn.calibrate(np.full((3, 4), np.nan))
        assert (zn.vmin, zn.vmax) == (-3.0, 3.0)


# ---------------------------------------------------------------------------
# the widget and pick surface
# ---------------------------------------------------------------------------

def test_gui_builds_full_axes_grid(guis):
    gui, mcd = guis["port"]
    assert len(gui._figure.axes) >= 12
    assert len(gui._figure.axes) == len(guis["jax"][0]._figure.axes)
    assert len(gui.rects_cp) == mcd.cluster_count
    assert gui.im_c.get_array().shape == (mcd.marker_count, mcd.cluster_count)
    assert gui.im_m.get_array().shape == (mcd.marker_count, mcd.metacluster_count)
    _assert_same_state(guis)


def test_gui_left_click_toggles_cluster(guis):
    def act(gui, mcd):
        first = mcd.clusters.index[0]
        gui.onpick(_FakePick(gui.im_c, 0.4, button=1))
        assert first in gui.selected_clusters
        assert np.asarray(gui.selection_mask)[0, 0] == 1
        return first

    _both(guis, act)
    _assert_same_state(guis)
    first = _both(guis, lambda gui, mcd: (gui.onpick(_FakePick(gui.im_c, 0.4, button=1)),
                                          mcd.clusters.index[0])[1])
    assert first["port"] not in guis["port"][0].selected_clusters
    _assert_same_state(guis)


def test_gui_metacluster_click_toggles_whole_group(guis):
    def click(gui, mcd):
        mc = mcd.metaclusters.index[1]
        col = list(mcd.metaclusters.index).index(mc)
        gui.onpick(_FakePick(gui.im_m, col + 0.2, button=1))
        return mc

    mc = _both(guis, click)["port"]
    gui, mcd = guis["port"]
    assert set(mcd.cluster_in_metacluster(mc)) <= gui.selected_clusters
    assert gui.current_metacluster.value == mc
    _assert_same_state(guis)
    _both(guis, click)
    assert not (set(mcd.cluster_in_metacluster(mc)) & gui.selected_clusters)
    _assert_same_state(guis)


def test_gui_color_label_click_selects_metacluster(guis):
    def act(gui, mcd):
        mc = mcd.which_metacluster(mcd.clusters_with_metaclusters.index[0])
        gui.onpick(_FakePick(gui.im_cl, 0.3, button=1))
        assert set(mcd.cluster_in_metacluster(mc)) <= gui.selected_clusters

    _both(guis, act)
    _assert_same_state(guis)


def test_gui_right_click_remaps_selection(guis, tmp_path):
    def act(gui, mcd):
        c0, c1 = mcd.clusters.index[0], mcd.clusters.index[1]
        gui.select_cluster(c0)
        gui.select_cluster(c1, extend=True)
        target = mcd.metaclusters.index[2]
        col = list(mcd.metaclusters.index).index(target)
        gui.onpick(_FakePick(gui.im_m, col + 0.5, button=3))
        assert mcd.which_metacluster(c0) == mcd.which_metacluster(c1) == target
        return c0, target

    c0, target = _both(guis, act)["port"]
    out = pd.read_csv(tmp_path / "remap_port.csv")
    assert (out.loc[out["pixel_som_cluster"] == c0, "pixel_meta_cluster"] == target).all()
    _assert_same_state(guis)


def test_gui_widgets_buttons_and_slider(guis):
    def act(gui, mcd):
        chosen = mcd.clusters.index[0]
        gui.select_cluster(chosen)
        gui.new_metacluster_button.click()
        assert mcd.which_metacluster(chosen) == 5
        gui.clear_selection_button.click()
        assert gui.selected_clusters == set()
        gui.zscore_clamp_slider.value = 1.0
        assert gui.zscore_cap == 1.0
        assert gui.cluster_heatmap_data().values.max() <= 1.0 + 1e-9

    _both(guis, act)
    _assert_same_state(guis)


def test_gui_displayname_editor_persists(guis, tmp_path):
    def act(gui, mcd):
        mc = mcd.metaclusters.index[0]
        gui.current_metacluster.value = mc
        gui.current_metacluster_displayname.value = "myeloid"
        assert mcd.get_metacluster_displayname(mc) == "myeloid"
        assert ("myeloid", mc) in list(gui.current_metacluster.options)

    _both(guis, act)
    out = pd.read_csv(tmp_path / "remap_port.csv")
    assert "myeloid" in set(out["pixel_meta_cluster_rename"])
    _assert_same_state(guis)


def test_gui_update_repaints_after_remap(guis):
    def act(gui, mcd):
        before = np.array(gui.im_cl.get_array(), dtype=float).copy()
        gui.select_cluster(mcd.clusters.index[0])
        gui.new_metacluster_from_selection()
        gui._update_gui()
        assert not np.array_equal(before, np.array(gui.im_cl.get_array(), dtype=float))

    _both(guis, act)
    _assert_same_state(guis)


def test_gui_enable_debug_mode(guis):
    def act(gui, mcd):
        n = len(gui.gui.children)
        gui.enable_debug_mode()
        return len(gui.gui.children) - n

    assert _both(guis, act) == {"jax": 1, "port": 1}


# ---------------------------------------------------------------------------
# marker ordering: the dendrogram's leaf order and drag-to-reorder
# ---------------------------------------------------------------------------

def test_gui_applies_dendrogram_leaf_order(guis):
    gui, mcd = guis["port"]
    assert gui.ddg["leaves"] == guis["jax"][0].ddg["leaves"]
    assert mcd.marker_order == list(gui.ddg["leaves"])[::-1]
    raw = ["m1", "m2", "m3"]
    assert list(mcd.marker_names) == [raw[i] for i in mcd.marker_order]

    def repaint(gui, mcd):
        gui._heatmaps_stale = True
        gui._update_gui()
        assert gui.im_c.get_array().shape == (mcd.marker_count, mcd.cluster_count)

    _both(guis, repaint)
    _assert_same_state(guis)


def test_move_marker_reorders_state_and_tables(guis):
    def act(gui, mcd):
        before, names = mcd.marker_order, list(mcd.marker_names)
        gui.move_marker(0, 2)
        assert mcd.marker_order == [before[1], before[2], before[0]]
        assert list(mcd.marker_names) == [names[1], names[2], names[0]]
        assert list(mcd.metaclusters.columns) == list(mcd.marker_names)
        gui._update_gui()

    _both(guis, act)
    _assert_same_state(guis)


def test_drag_to_reorder_markers(guis):
    def act(gui, mcd):
        names = list(mcd.marker_names)
        m = mcd.marker_count
        gui._on_marker_press(_FakeMouse(gui.ax_c, m - 0.5))
        assert gui._drag_marker_row == 0
        gui._on_marker_release(_FakeMouse(gui.ax_c, 0.5))
        assert gui._drag_marker_row is None
        assert list(mcd.marker_names) == names[1:] + names[:1]
        gui._update_gui()

    _both(guis, act)
    _assert_same_state(guis)


def test_drag_outside_heatmap_is_ignored(guis):
    def act(gui, mcd):
        order = mcd.marker_order
        gui._on_marker_press(_FakeMouse(gui.ax_m, 1.5))
        assert gui._drag_marker_row is None
        gui._on_marker_release(_FakeMouse(gui.ax_c, 0.5))
        gui._on_marker_press(_FakeMouse(gui.ax_c, 0.5))
        gui._on_marker_release(_FakeMouse(gui.ax_c, 0.5))
        gui._on_marker_press(_FakeMouse(gui.ax_c, 0.5))
        gui._on_marker_release(_FakeMouse(None, None))
        assert mcd.marker_order == order

    _both(guis, act)
    _assert_same_state(guis)


def test_marker_order_survives_remap_and_rename(guis):
    def act(gui, mcd):
        gui.move_marker(2, 0)
        order = mcd.marker_order
        gui.select_cluster(mcd.clusters.index[0])
        mc = gui.new_metacluster_from_selection()
        gui.rename_metacluster(mc, "dragged")
        assert mcd.marker_order == order
        gui._update_gui()
        assert list(mcd.metaclusters.columns) == list(mcd.marker_names)

    _both(guis, act)
    _assert_same_state(guis)


def test_gui_constructs_with_default_throttle(som_avg_csv, tmp_path):
    """The throttled repaint path (no event loop: it fires at once)."""
    guis = {name: (PACKAGES[name].MetaClusterGui(mcd), mcd)
            for name, mcd in _mcds(som_avg_csv, tmp_path).items()}

    def act(gui, mcd):
        assert gui._figure is not None
        gui.select_cluster(mcd.clusters.index[0])
        gui.update_gui()

    _both(guis, act)
    _assert_same_state(guis)


def test_constant_marker_column_does_not_blank_heatmaps(tmp_path):
    csv = _som_avg_csv(tmp_path / "avg.csv", seed=5, n=12, constant_m2=True)
    guis = {name: (PACKAGES[name].MetaClusterGui(mcd, enable_throttle=False), mcd)
            for name, mcd in _mcds(csv, tmp_path).items()}

    def act(gui, mcd):
        gui._heatmaps_stale = True
        gui._update_gui()
        assert np.isfinite(gui.zscore_norm.vmin) and np.isfinite(gui.zscore_norm.vmax)
        assert gui.zscore_norm.vmax > 0
        assert np.isfinite(np.asarray(gui.im_c.get_array(), dtype=float)).any()

    _both(guis, act)
    _assert_same_state(guis)


# ---------------------------------------------------------------------------
# the CSV reader and validator
# ---------------------------------------------------------------------------

def _write_csv(path, n=6, cluster_type="pixel", **overrides):
    df = pd.DataFrame({
        "m1": np.linspace(0, 1, n), "m2": np.linspace(1, 0, n),
        f"{cluster_type}_som_cluster": np.arange(1, n + 1),
        f"{cluster_type}_meta_cluster": (np.arange(n) % 2) + 1,
        "count": np.arange(10, 10 + n)})
    for col, vals in overrides.items():
        if vals is None:
            df = df.drop(columns=col)
        else:
            df[col] = vals
    df.to_csv(path, index=False)
    return str(path)


def _read_both(path, **kwargs):
    return {name: pkg.metaclusterdata_from_files(path, **kwargs)
            for name, pkg in PACKAGES.items()}


def _errors_of_both(path, **kwargs):
    out = {}
    for name, pkg in PACKAGES.items():
        with pytest.raises(Exception) as info:
            pkg.metaclusterdata_from_files(path, **kwargs)
        out[name] = (type(info.value), str(info.value))
    assert out["port"] == out["jax"]
    return out["port"]


def test_reads_pixel_csv_and_renames_columns(tmp_path):
    got = _read_both(_write_csv(tmp_path / "avg.csv"))
    mcd = got["port"]
    assert (mcd.cluster_count, mcd.metacluster_count) == (6, 2)
    assert list(mcd.cluster_pixelcounts["count"]) == [10, 11, 12, 13, 14, 15]
    assert set(mcd.clusters.columns) == {"m1", "m2"}
    pd.testing.assert_frame_equal(mcd.clusters, got["jax"].clusters)
    pd.testing.assert_frame_equal(mcd.cluster_pixelcounts, got["jax"].cluster_pixelcounts)


def test_reads_cell_csv_with_cell_prefixed_columns(tmp_path):
    path = _write_csv(tmp_path / "avg.csv", cluster_type="cell")
    for name, mcd in _read_both(path, cluster_type="cell").items():
        assert mcd.cluster_count == 6 and mcd.cluster_type == "cell"
        mcd.output_mapping_filename = str(tmp_path / f"remap_{name}.csv")
        mcd.save_output_mapping()
    out = pd.read_csv(tmp_path / "remap_port.csv")
    assert list(out.columns) == ["cell_som_cluster", "cell_meta_cluster",
                                 "cell_meta_cluster_rename"]
    assert (tmp_path / "remap_port.csv").read_bytes() == \
        (tmp_path / "remap_jax.csv").read_bytes()


def test_prefix_trim_strips_marker_prefixes(tmp_path):
    n = 4
    df = pd.DataFrame({
        "pixie_m1": np.ones(n), "pixie_m2": np.zeros(n),
        "pixel_som_cluster": np.arange(1, n + 1),
        "pixel_meta_cluster": np.ones(n, int), "count": np.ones(n, int)})
    path = tmp_path / "avg.csv"
    df.to_csv(path, index=False)
    got = _read_both(str(path), prefix_trim="pixie_")
    assert set(got["port"].clusters.columns) == {"m1", "m2"}
    pd.testing.assert_frame_equal(got["port"].clusters, got["jax"].clusters)


def test_invalid_cluster_type_rejected(tmp_path):
    err, _ = _errors_of_both(_write_csv(tmp_path / "avg.csv"), cluster_type="voxel")
    assert issubclass(err, ValueError)


@pytest.mark.parametrize("missing", ["pixel_som_cluster", "pixel_meta_cluster", "count"])
def test_missing_required_columns_raise(tmp_path, missing):
    err, _ = _errors_of_both(_write_csv(tmp_path / f"no_{missing}.csv", **{missing: None}))
    assert issubclass(err, ValueError)


def test_duplicate_and_zero_based_ids_rejected(tmp_path):
    _, msg = _errors_of_both(_write_csv(tmp_path / "dup.csv",
                                        pixel_som_cluster=[1, 1, 2, 3, 4, 5]))
    assert "unique" in msg
    err, _ = _errors_of_both(_write_csv(tmp_path / "zero.csv",
                                        pixel_som_cluster=[0, 1, 2, 3, 4, 5]))
    assert issubclass(err, ValueError)
    _, msg = _errors_of_both(_write_csv(tmp_path / "no1.csv",
                                        pixel_som_cluster=[2, 3, 4, 5, 6, 7]))
    assert "starting with 1" in msg


def test_missing_file_raises(tmp_path):
    _errors_of_both(str(tmp_path / "does_not_exist.csv"))


def test_carries_renames_forward_across_sessions(tmp_path):
    path = _write_csv(tmp_path / "avg.csv",
                      pixel_meta_cluster_rename=["tumor", "stroma"] * 3)
    for mcd in _read_both(path).values():
        assert mcd.get_metacluster_displayname(1) == "tumor"
        assert mcd.get_metacluster_displayname(2) == "stroma"


# ---------------------------------------------------------------------------
# throttle: the first call fires at once; calls inside the window collapse
# to one trailing call with the last arguments
# ---------------------------------------------------------------------------

def _throttled_calls(throttle, drive):
    calls = []

    @throttle(0.05)
    def record(x):
        calls.append(x)

    asyncio.run(drive(record, calls))
    return calls


def test_throttle_first_call_immediate_then_trailing():
    async def drive(record, calls):
        record(1)
        record(2)
        record(3)
        assert calls == [1]
        await asyncio.sleep(0.15)

    got = {name: _throttled_calls(t, drive) for name, t in THROTTLES.items()}
    assert got == {"jax": [1, 3], "port": [1, 3]}


def test_throttle_quiet_period_resets():
    async def drive(record, calls):
        record("a")
        await asyncio.sleep(0.12)
        record("b")
        assert calls == ["a", "b"]

    got = {name: _throttled_calls(t, drive) for name, t in THROTTLES.items()}
    assert got["port"] == got["jax"] == ["a", "b"]


def test_throttle_preserves_function_metadata():
    for throttle in THROTTLES.values():
        @throttle(0.01)
        def my_handler(change=None):
            """docs"""

        assert my_handler.__name__ == "my_handler" and my_handler.__doc__ == "docs"


def test_throttle_without_event_loop_degrades_gracefully():
    for throttle in THROTTLES.values():
        calls = []

        @throttle(10.0)
        def record(x):
            calls.append(x)

        record(1)
        record(2)
        assert calls == [1, 2]


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_cosine_similarity_equals_sklearn(dtype):
    """The dendrogram's similarity, computed in numpy, is sklearn's bit for
    bit, a zero row (left unnormalized) included."""
    from sklearn.metrics.pairwise import cosine_similarity

    from ark_tpu_torch.utils.metacluster_remap_gui import metaclusterdata

    x = (np.random.default_rng(5).random((17, 40)) * 9).astype(dtype)
    x[4] = 0
    got, want = metaclusterdata.cosine_similarity(x), cosine_similarity(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
