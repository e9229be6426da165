"""Interactive SOM→metacluster remapping GUI (ipywidgets + matplotlib).

Behavioral parity with reference
`src/ark/utils/metacluster_remap_gui/metaclustergui.py:24-567`:

* a 4×3 figure — dendrogram pane | z-scored SOM-cluster heatmap |
  pixel-weighted metacluster heatmap, with per-cluster pixel-count bars +
  z-score colorbar on top and selection-marker / metacluster-color-label
  strips underneath;
* left-click toggles a cluster's selection (clicking the metacluster
  heatmap or either color-label strip toggles the WHOLE metacluster);
  right-click remaps the current selection into the clicked metacluster;
* widgets: max-z-score clamp slider, clear-selection / new-metacluster
  buttons, a current-metacluster dropdown and a live displayname editor;
* every mapping/rename edit persists through `MetaClusterData` to the
  remap CSV immediately.

The full state machine (selection, toggling, remap, rename, persistence)
runs headless — the tests drive it through the same handler methods the
matplotlib pick events call.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .colormap_helper import distinct_cmap
from .metaclusterdata import MetaClusterData
from .throttle import throttle
from .zscore_norm import ZScoreNormalize

DEFAULT_HEATMAP_COLORMAP = "vlag"


def _resolve_cmap(cmap):
    """'vlag' is a seaborn palette (the reference's default heatmap); it is
    not registered with bare matplotlib, so resolve through seaborn and fall
    back to the closest built-in diverging map."""
    if not isinstance(cmap, str):
        return cmap
    import matplotlib as mpl
    if cmap in mpl.colormaps:
        return cmap
    try:
        import seaborn as sns
        return sns.color_palette(cmap, as_cmap=True)
    except Exception:
        return "coolwarm"


class MetaClusterGui:
    """Interactive remapping GUI over a MetaClusterData state model."""

    def __init__(self, metaclusterdata: MetaClusterData, heatmapcolors=None,
                 width=17.0, debug=False, enable_throttle=True):
        self.mcd = metaclusterdata
        self.width = width
        self.debug = debug
        self.selected_clusters = set()
        self.heatmapcolors = _resolve_cmap(
            heatmapcolors or DEFAULT_HEATMAP_COLORMAP)
        self.zscore_norm = ZScoreNormalize(-3, 0, 3)
        self.zscore_cap = 3.0
        self._figure = None
        self._widgets = None
        self._heatmaps_stale = True

        if enable_throttle:
            self.update_gui = throttle(0.2)(self._update_gui)
        else:
            self.update_gui = self._update_gui

        if not debug:
            try:
                self.make_widgets()
                self.make_gui()
                self._update_gui()
            except Exception:
                # headless environment without a GUI backend: the state
                # machine (selection/remap/rename/persist) remains usable
                self._widgets = None
                self._figure = None

    # ------------------------------------------------------------------
    # selection / remap state machine (reference :516-567)
    # ------------------------------------------------------------------
    def select_cluster(self, cluster, extend=False):
        """Select a cluster. extend=False replaces the selection
        (programmatic use); extend=True applies the click semantics —
        toggle membership of `cluster` in the selection."""
        if not extend:
            self.selected_clusters = {cluster}
            return
        if cluster in self.selected_clusters:
            self.selected_clusters.remove(cluster)
        else:
            self.selected_clusters.add(cluster)

    def select_metacluster(self, metacluster):
        """Toggle an entire metacluster: select all of its clusters, or
        deselect them when every one is already selected."""
        clusters = self.mcd.cluster_in_metacluster(metacluster)
        if all(c in self.selected_clusters for c in clusters):
            self.selected_clusters.difference_update(clusters)
        else:
            self.selected_clusters.update(clusters)
        self._set_current_metacluster(metacluster)

    def clear_selection(self, _event=None):
        self.selected_clusters = set()

    def remap_current_selection(self, metacluster):
        """Move the selected clusters into `metacluster` and persist."""
        for cluster in self.selected_clusters:
            self.mcd.remap(cluster, metacluster)
        self._heatmaps_stale = True
        if self.mcd.output_mapping_filename is not None:
            self.mcd.save_output_mapping()

    def new_metacluster_from_selection(self, _event=None):
        """Move the selection into a brand-new metacluster; returns its id."""
        mc = self.mcd.new_metacluster()
        self.remap_current_selection(mc)
        self._set_current_metacluster(mc)
        return mc

    def rename_metacluster(self, metacluster, displayname):
        self.mcd.change_displayname(metacluster, displayname)
        self._heatmaps_stale = True

    @property
    def selection_mask(self):
        """(1, cluster_count) 0/1 mask over metacluster-sorted clusters."""
        return [[1 if c in self.selected_clusters else 0
                 for c in self.mcd.clusters.index]]

    # ------------------------------------------------------------------
    # plotting data
    # ------------------------------------------------------------------
    def _preplot(self, df: pd.DataFrame) -> pd.DataFrame:
        """Per-marker z-score clipped at the slider cap, markers as rows."""
        from scipy.stats import zscore
        return df.apply(zscore).clip(lower=-self.zscore_cap,
                                     upper=self.zscore_cap).T

    def cluster_heatmap_data(self) -> pd.DataFrame:
        """z-scored (per marker) cluster expression, metacluster-sorted."""
        return self._preplot(self.mcd.clusters).T

    def metacluster_heatmap_data(self) -> pd.DataFrame:
        return self._preplot(self.mcd.metaclusters).T

    # ------------------------------------------------------------------
    # widget layer (reference make_widgets :236-315)
    # ------------------------------------------------------------------
    def make_widgets(self):
        import ipywidgets as widgets

        self.zscore_clamp_slider = widgets.FloatSlider(
            value=3, min=1, max=10.0, step=0.5, description="Max Zscore:",
            continuous_update=True, readout=True, readout_format=".1f")
        self.zscore_clamp_slider.observe(self.update_zscore)

        self.clear_selection_button = widgets.Button(
            description="Clear Selection", button_style="warning",
            tooltip="Clear currently selected clusters")
        self.clear_selection_button.on_click(
            lambda e: (self.clear_selection(), self.update_gui()))

        self.new_metacluster_button = widgets.Button(
            description="New metacluster", button_style="success",
            tooltip="Create new metacluster from current selection")
        self.new_metacluster_button.on_click(
            lambda e: (self.new_metacluster_from_selection(),
                       self.update_gui()))

        self.current_metacluster = widgets.Dropdown(
            value=self.mcd.metaclusters.index[0],
            options=list(zip(self.mcd.metacluster_displaynames,
                             self.mcd.metaclusters.index)),
            description="MetaCluster:")
        self.current_metacluster.observe(
            self._on_current_metacluster_change, type="change", names="value")

        self.current_metacluster_displayname = widgets.Text(
            value=self.mcd.get_metacluster_displayname(
                self.current_metacluster.value),
            placeholder="Metacluster Displayname", description="Edit Name:")
        self.current_metacluster_displayname.observe(
            self._on_displayname_change, type="change", names="value")

        self.metacluster_info = widgets.VBox([
            self.current_metacluster, self.current_metacluster_displayname])
        self.tools = widgets.HBox([
            self.zscore_clamp_slider, self.clear_selection_button,
            self.new_metacluster_button])
        self.toolbar = widgets.HBox([self.tools, self.metacluster_info])
        self.plot_output = widgets.Output()
        self.debug_output = widgets.Output()
        self.gui = widgets.VBox([self.plot_output, self.toolbar])
        self._widgets = self.gui

    # widget handlers ----------------------------------------------------
    def update_zscore(self, change=None):
        if change is not None and change.get("name") != "value":
            return
        self.zscore_cap = float(self.zscore_clamp_slider.value)
        self._heatmaps_stale = True
        self.update_gui()

    def _set_current_metacluster(self, metacluster):
        if self._widgets is None:
            return
        options = list(zip(self.mcd.metacluster_displaynames,
                           self.mcd.metaclusters.index))
        self.current_metacluster.options = options
        if metacluster in self.mcd.metaclusters.index:
            self.current_metacluster.value = metacluster
            self.current_metacluster_displayname.value = \
                self.mcd.get_metacluster_displayname(metacluster)

    def _on_current_metacluster_change(self, change):
        self.current_metacluster_displayname.value = \
            self.mcd.get_metacluster_displayname(change["new"])

    def _on_displayname_change(self, change):
        if change["new"]:
            self.rename_metacluster(self.current_metacluster.value,
                                    change["new"])
            self._set_current_metacluster(self.current_metacluster.value)
            self.update_gui()

    # ------------------------------------------------------------------
    # figure layer (reference make_gui :70-235)
    # ------------------------------------------------------------------
    def make_gui(self):
        """Build the 4×3 axes grid:

            |    | cp (pixel counts) | cb (colorbar)     |
            | cd | c  (cluster map)  | m  (metacluster)  |
            |    | cs (selection)    | ms                |
            |    | cl (color labels) | ml                |
        """
        import matplotlib.pyplot as plt
        from matplotlib import cm
        from scipy.cluster.hierarchy import dendrogram

        width_ratios = [max(self.mcd.cluster_count // 7, 1),
                        self.mcd.cluster_count,
                        self.mcd.metacluster_count * 2]
        marker_ratio = max(self.mcd.marker_count / 20, 1)
        height_ratios = [6 * marker_ratio,
                         self.mcd.marker_count * marker_ratio,
                         marker_ratio, marker_ratio]
        self._figure, axes = plt.subplots(
            4, 3, figsize=(self.width, 6 * marker_ratio),
            gridspec_kw={"width_ratios": width_ratios,
                         "height_ratios": height_ratios})
        ((ax_01, ax_cp, ax_cb),
         (ax_cd, ax_c, ax_m),
         (ax_02, ax_cs, ax_ms),
         (ax_03, ax_cl, ax_ml)) = axes
        self.ax_cp, self.ax_cb = ax_cp, ax_cb
        self.ax_cd, self.ax_c, self.ax_m = ax_cd, ax_c, ax_m
        self.ax_cs, self.ax_ms = ax_cs, ax_ms
        self.ax_cl, self.ax_ml = ax_cl, ax_ml
        for ax in (ax_01, ax_02, ax_03, ax_ms):
            ax.axis("off")

        # dendrogram pane (ward linkage on marker cosine similarity); its
        # leaf order becomes the marker row order of both heatmaps
        # (reference metaclustergui.py:202-209)
        orig_fixed_names = list(self.mcd.fixed_width_marker_names)
        self.ddg = dendrogram(self.mcd.linkage_matrix, ax=ax_cd,
                              orientation="left", no_labels=True,
                              color_threshold=0)
        self.mcd.set_marker_order(list(self.ddg["leaves"])[::-1])
        self._heatmaps_stale = True
        ax_cd.set_xticks([])
        ax_cd.set_yticks(np.arange(self.mcd.marker_count) * 10 + 5)
        # scipy places leaf k of `leaves` at y = 10k+5 (orientation="left")
        ax_cd.set_yticklabels(
            [orig_fixed_names[i] for i in self.ddg["leaves"]], fontsize=7)

        nan_c = np.full((self.mcd.marker_count, self.mcd.cluster_count),
                        np.nan)
        nan_m = np.full((self.mcd.marker_count, self.mcd.metacluster_count),
                        np.nan)
        self.im_c = ax_c.imshow(nan_c, aspect="auto",
                                cmap=self.heatmapcolors,
                                norm=self.zscore_norm, picker=True)
        self.im_m = ax_m.imshow(nan_m, aspect="auto",
                                cmap=self.heatmapcolors,
                                norm=self.zscore_norm, picker=True)
        ax_c.set_yticks(np.arange(self.mcd.marker_count) + 0.5)
        # the (0, n, 0, m) extent draws data row 0 at the TOP, so tick
        # labels (bottom-up) read the marker list reversed (reference :209)
        ax_c.set_yticklabels(list(self.mcd.marker_names)[::-1], fontsize=7)
        ax_c.set_xticks([])
        ax_m.set_yticks([])
        ax_m.set_xticks([])

        # selection-marker strips
        self.im_cs = ax_cs.imshow(np.asarray(self.selection_mask),
                                  aspect="auto", cmap="Greens", vmin=0,
                                  vmax=1, picker=True)
        ax_cs.set_xticks([])
        ax_cs.set_yticks([])

        # metacluster color-label strips
        self.im_cl = ax_cl.imshow(np.zeros((1, self.mcd.cluster_count)),
                                  aspect="auto", picker=True)
        self.im_ml = ax_ml.imshow(
            np.zeros((1, self.mcd.metacluster_count)), aspect="auto",
            picker=True)
        ax_cl.set_xticks([])
        ax_cl.set_yticks([])
        ax_ml.set_yticks([])

        # per-cluster pixel-count bars
        counts = self.mcd.clusters.join(
            self.mcd.cluster_pixelcounts)["count"]
        self.rects_cp = ax_cp.bar(
            np.arange(self.mcd.cluster_count) + 0.5, counts.values,
            color="gray")
        ax_cp.set_xlim(0, self.mcd.cluster_count)
        ax_cp.set_xticks([])

        # z-score colorbar
        self._figure.colorbar(
            cm.ScalarMappable(norm=self.zscore_norm,
                              cmap=self.heatmapcolors),
            cax=ax_cb, orientation="horizontal")

        self._canvas_cid = self._figure.canvas.mpl_connect(
            "pick_event", self.onpick)
        # drag a marker row (press on one row of the cluster heatmap,
        # release on another) to reorder the heatmap markers
        self._drag_marker_row = None
        self._figure.canvas.mpl_connect(
            "button_press_event", self._on_marker_press)
        self._figure.canvas.mpl_connect(
            "button_release_event", self._on_marker_release)

    # pick-event routing (reference :516-567) ----------------------------
    def onpick(self, e):
        if e.mouseevent.name != "button_press_event":
            return
        if e.mouseevent.xdata is None:
            return
        if e.mouseevent.button == 1:
            self.onpick_select(e)
        elif e.mouseevent.button == 3:
            self.onpick_remap(e)
        self.update_gui()

    def onpick_select(self, e):
        ix = int(e.mouseevent.xdata)
        if e.artist in (self.im_c, self.im_cs):
            if 0 <= ix < self.mcd.cluster_count:
                self.select_cluster(self.mcd.clusters.index[ix], extend=True)
        elif e.artist in (self.im_m, self.im_ml):
            if 0 <= ix < self.mcd.metacluster_count:
                self.select_metacluster(self.mcd.metaclusters.index[ix])
        elif e.artist is self.im_cl:
            if 0 <= ix < self.mcd.cluster_count:
                cluster = self.mcd.clusters_with_metaclusters.index[ix]
                self.select_metacluster(self.mcd.which_metacluster(cluster))

    def onpick_remap(self, e):
        ix = int(e.mouseevent.xdata)
        metacluster = None
        if e.artist in (self.im_c, self.im_cs, self.im_cl):
            if 0 <= ix < self.mcd.cluster_count:
                cluster = self.mcd.clusters_with_metaclusters.index[ix]
                metacluster = self.mcd.which_metacluster(cluster)
        elif e.artist in (self.im_m, self.im_ml):
            if 0 <= ix < self.mcd.metacluster_count:
                metacluster = self.mcd.metaclusters.index[ix]
        if metacluster is not None:
            self._set_current_metacluster(metacluster)
            self.remap_current_selection(metacluster)

    # marker drag-to-reorder ---------------------------------------------
    def _marker_row_at(self, e):
        """Marker row index under a mouse event on the cluster heatmap,
        or None. Display y counts up from the bottom while data row 0 is
        drawn at the top, hence the flip."""
        if getattr(e, "inaxes", None) is not self.ax_c or e.ydata is None:
            return None
        row = self.mcd.marker_count - 1 - int(e.ydata)
        if 0 <= row < self.mcd.marker_count:
            return row
        return None

    def _on_marker_press(self, e):
        self._drag_marker_row = self._marker_row_at(e)

    def _on_marker_release(self, e):
        src, dst = self._drag_marker_row, self._marker_row_at(e)
        self._drag_marker_row = None
        if src is not None and dst is not None and src != dst:
            self.move_marker(src, dst)
            self.update_gui()

    def move_marker(self, src_row, dst_row):
        """Move the marker displayed at heatmap row `src_row` so it is
        displayed at row `dst_row` (rows counted from the top, matching
        what the user sees). Rewrites the state model's marker order."""
        order = list(self.mcd.marker_order)
        order.insert(dst_row, order.pop(src_row))
        self.mcd.set_marker_order(order)
        self._heatmaps_stale = True

    # repaint (reference update_gui :374-440) ----------------------------
    def _update_gui(self):
        if self._figure is None:
            return
        self.im_cs.set_data(np.asarray(self.selection_mask))
        self.im_cs.set_extent((0, self.mcd.cluster_count, 0, 1))
        if not self._heatmaps_stale:
            self._figure.canvas.draw_idle()
            return

        zc = self._preplot(self.mcd.clusters)
        self.zscore_norm.calibrate(zc.values)
        self.im_c.set_data(zc.values)
        self.im_c.set_extent((0, self.mcd.cluster_count, 0,
                              self.mcd.marker_count))
        self.ax_c.set_yticklabels(list(self.mcd.marker_names)[::-1],
                                  fontsize=7)
        zm = self._preplot(self.mcd.metaclusters)
        self.im_m.set_data(zm.values)
        self.im_m.set_extent((0, self.mcd.metacluster_count, 0,
                              self.mcd.marker_count))

        # metacluster color labels under both heatmaps
        mc_cmap = distinct_cmap(self.mcd.cluster_count)
        self.im_cl.set_data(
            [self.mcd.clusters_with_metaclusters["metacluster"].values])
        self.im_cl.set_extent((0, self.mcd.cluster_count, 0, 1))
        self.im_cl.set_cmap(mc_cmap)
        self.im_cl.set_clim(0, self.mcd.cluster_count)
        self.im_ml.set_data([np.asarray(self.mcd.metaclusters.index)])
        self.im_ml.set_extent((0, self.mcd.metacluster_count, 0, 1))
        self.im_ml.set_cmap(mc_cmap)
        self.im_ml.set_clim(0, self.mcd.cluster_count)
        self.ax_ml.set_xticks(np.arange(self.mcd.metacluster_count) + 0.5)
        self.ax_ml.set_xticklabels(self.mcd.metacluster_displaynames,
                                   rotation=90, fontsize=7)

        # pixel-count bars follow the metacluster-sorted cluster order
        counts = self.mcd.clusters.join(
            self.mcd.cluster_pixelcounts)["count"]
        peak = counts.max()  # pandas max skips NaN; NaN if empty/all-NaN
        ymax = float(peak) * 1.65 if peak == peak else 0.0
        # clamp: an all-zero count column would set_ylim(0, 0) — degenerate
        # axis plus a matplotlib warning
        self.ax_cp.set_ylim(0, max(ymax, 1.0))
        for rect, h in zip(self.rects_cp, counts.values):
            rect.set_height(h)

        if self._widgets is not None:
            self.current_metacluster.options = list(zip(
                self.mcd.metacluster_displaynames,
                self.mcd.metaclusters.index))
        self._figure.canvas.draw_idle()
        self._heatmaps_stale = False

    def enable_debug_mode(self):
        """Route handler tracebacks into a visible output widget."""
        self.debug = True
        if self._widgets is not None:
            self.gui.children = tuple(self.gui.children) + \
                (self.debug_output,)

    def _ipython_display_(self):
        from IPython.display import display
        if self._widgets is None:
            self.make_widgets()
            self.make_gui()
            self._update_gui()
        display(self.gui)
