"""Plotting utilities: metacluster colormaps, cluster plots, overlays, Mantis
project export, colored masks, cohort plot functions, continuous-stat coloring.

Port of ``ark_tpu/utils/plot_utils.py``. The device work runs in torch ops
on the `device` the caller names: the two boundary masks and the uint8
rescale of ``create_overlay`` (its array-level core is
``overlay_from_arrays``), the colour-table gather of ``save_colored_mask``
and ``save_colored_masks`` (``gather_colors``), and the mask generation of
``cohort_cluster_plot`` and ``color_segmentation_by_stat`` (through
``utils/data_utils``). The overlay's 5th and 95th percentiles stay numpy's
on the host: ``np.percentile`` interpolates in f64 over the channel's own
dtype, and one ulp of a limit moves a byte of the image. matplotlib and
tqdm are imported inside the functions that need them, so the module
imports where they are absent.
"""

from __future__ import annotations

import os
import pathlib
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch import settings
from ark_tpu_torch.io import io_utils, load_utils
from ark_tpu_torch.io.image_utils import read_image, save_image
from ark_tpu_torch.io.io_utils import natsorted
from ark_tpu_torch.ops import morphology
from ark_tpu_torch.utils.data_utils import (ClusterMaskData, erode_mask,
                                            generate_cluster_mask,
                                            map_segmentation_labels, save_fov_mask)
from ark_tpu_torch.utils.misc_utils import verify_in_list, verify_same_elements

_IMAGE_EXTS = [".tiff", ".tif", ".png", ".jpg", ".jpeg"]


@dataclass
class MetaclusterColormap:
    """Colormap + id/name bookkeeping for metacluster masks (background=0
    black; unassigned=max+1 light gray)."""
    cluster_type: str
    cluster_id_to_name_path: Union[str, pathlib.Path]
    metacluster_colors: Dict

    unassigned_color: Tuple[float, ...] = field(init=False)
    unassigned_id: int = field(init=False)
    background_color: Tuple[float, ...] = field(init=False)
    metacluster_id_to_name: pd.DataFrame = field(init=False)
    mc_colors: np.ndarray = field(init=False)
    cmap: "matplotlib.colors.ListedColormap" = field(init=False)
    norm: "matplotlib.colors.BoundaryNorm" = field(init=False)

    def __post_init__(self) -> None:
        self.unassigned_color = (0.9, 0.9, 0.9, 1.0)
        self.background_color = (0.0, 0.0, 0.0, 1.0)
        self._metacluster_cmap_generator()

    def _metacluster_cmap_generator(self) -> None:
        """Build the id-ordered color table for this cluster type's masks.

        Behavioral contract (shared with the reference MetaclusterColormap,
        plot_utils.py:41-169, because mask integers must land on the right
        colors): row i of the color table colors mask value i — background
        id 0 is black, every real cluster_id takes its metacluster's entry
        from `metacluster_colors`, and a trailing "Unassigned" id = max+1
        is light gray; the BoundaryNorm centers each integer on its bin.
        """
        import matplotlib.colors as colors

        meta_col = f"{self.cluster_type}_meta_cluster"
        rename_col = f"{self.cluster_type}_meta_cluster_rename"
        mapping = pd.read_csv(self.cluster_id_to_name_path)
        verify_in_list(
            required_cols=[f"{self.cluster_type}_som_cluster", meta_col,
                           rename_col, "cluster_id"],
            cluster_mapping_cols=mapping.columns.values)

        table = mapping[[meta_col, rename_col, "cluster_id"]] \
            .drop_duplicates()
        unassigned_meta = int(table[meta_col].max() + 1)
        self.unassigned_id = int(table["cluster_id"].max() + 1)
        sentinels = pd.DataFrame({
            meta_col: [unassigned_meta, 0],
            rename_col: ["Unassigned", "Empty"],
            "cluster_id": [self.unassigned_id, 0]})
        table = pd.concat([table, sentinels])
        self.metacluster_colors |= {unassigned_meta: self.unassigned_color,
                                    0: self.background_color}
        verify_same_elements(
            metacluster_colors_ids=list(self.metacluster_colors.keys()),
            metacluster_mapping_ids=table[meta_col].values)

        table["color"] = table[meta_col].map(self.metacluster_colors)
        self.metacluster_id_to_name = table.sort_values(
            "cluster_id", ignore_index=True)
        self.mc_colors = np.array(
            self.metacluster_id_to_name["color"].to_list())
        self.cmap = colors.ListedColormap(self.mc_colors)
        self.norm = colors.BoundaryNorm(
            np.arange(len(self.mc_colors) + 1) - 0.5, len(self.mc_colors))


def _cmap_add_background_unassigned(cluster_colors: np.ndarray):
    unassigned_color = np.array([0.9, 0.9, 0.9, 1.0])
    background_color = np.array([0.0, 0.0, 0.0, 1.0])
    return np.vstack([background_color, cluster_colors, unassigned_color])


def create_cmap(cmap, n_clusters: int):
    """Discrete colormap + boundary norm (background/unassigned added)."""
    import matplotlib.colors as colors
    from matplotlib import colormaps

    if isinstance(cmap, np.ndarray):
        if cmap.ndim != 2:
            raise ValueError(
                f"colors_array must be a 2D array, got {cmap.ndim}D array")
        if cmap.shape[0] != n_clusters:
            raise ValueError(f"colors_array must have {n_clusters} colors, "
                             f"got {cmap.shape[0]} colors")
        color_map = colors.ListedColormap(
            colors=_cmap_add_background_unassigned(cmap))
    elif isinstance(cmap, list):
        if len(cmap) != n_clusters:
            raise ValueError(f"colors_array must have {n_clusters} colors, "
                             f"got {len(cmap)} colors")
        color_map = colors.ListedColormap(
            colors=_cmap_add_background_unassigned(
                colors.to_rgba_array(cmap)))
    elif isinstance(cmap, str):
        try:
            color_map = colormaps[cmap]
        except KeyError:
            raise KeyError(f"Colormap {cmap} not found.")
        colors_rgba = color_map(np.linspace(0, 1, n_clusters))
        color_map = colors.ListedColormap(
            colors=_cmap_add_background_unassigned(colors_rgba))
    else:
        raise ValueError("cmap must be an ndarray, list, or str")
    bounds = [i - 0.5 for i in np.linspace(0, color_map.N, color_map.N + 1)]
    norm = colors.BoundaryNorm(bounds, color_map.N)
    return color_map, norm


def plot_cluster(image, fov: str, cmap, norm, cbar_visible: bool = True,
                 cbar_labels: Optional[List[str]] = None, dpi: int = 300,
                 figsize=None) -> "matplotlib.figure.Figure":
    """Plot one cluster mask with a discrete colorbar."""
    import matplotlib.pyplot as plt
    from matplotlib import cm, gridspec
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    if cbar_labels is None:
        # the colormap has n_clusters + 2 bands: 0=background (black),
        # 1..n=clusters, n+1=unassigned. The reference's default labels
        # (plot_utils.py:272) start 'Cluster 1' at tick 0, misnaming the
        # background band and every cluster after it
        n = len(cmap.colors) - 2
        cbar_labels = (["Empty"] + [f"Cluster {x}" for x in range(1, n + 1)]
                       + ["Unassigned"])
    fig = plt.figure(figsize=figsize, dpi=dpi)
    fig.set_layout_engine(layout="tight")
    gs = gridspec.GridSpec(nrows=1, ncols=1, figure=fig)
    fig.suptitle(f"{fov}")
    ax = fig.add_subplot(gs[0, 0])
    ax.axis("off")
    ax.grid(visible=False)
    ax.imshow(X=image, cmap=cmap, norm=norm, origin="upper", aspect="equal",
              interpolation="none")
    if cbar_visible:
        divider = make_axes_locatable(fig.gca())
        cax = divider.append_axes(position="right", size="5%", pad="3%")
        cbar = fig.colorbar(cm.ScalarMappable(norm=norm, cmap=cmap), cax=cax,
                            orientation="vertical", use_gridspec=True,
                            pad=0.1, shrink=0.9, drawedges=True)
        cbar.ax.set_yticks(ticks=np.arange(len(cbar_labels)),
                           labels=cbar_labels)
        cbar.minorticks_off()
    return fig


def plot_neighborhood_cluster_result(img_xr, fovs: List[str], k: int,
                                     cmap_name: str = "tab20",
                                     cbar_visible: bool = True,
                                     save_dir=None, fov_col: str = "fovs",
                                     dpi: int = 300, figsize=(10, 10)) -> None:
    """Plot neighborhood-cluster masks per FOV."""
    import matplotlib.pyplot as plt

    verify_in_list(fovs=fovs, unique_fovs=list(img_xr.coords[fov_col]))
    my_colors = plt.get_cmap(cmap_name, k).colors
    cmap, norm = create_cmap(np.asarray(my_colors), n_clusters=k)
    cbar_labels = ["Empty"] + [f"Cluster {x}" for x in range(1, k + 1)]
    for fov in fovs:
        image = np.squeeze(img_xr.sel(**{fov_col: fov}).values)
        fig = plot_cluster(image=image, fov=fov, cmap=cmap, norm=norm,
                           cbar_visible=cbar_visible,
                           cbar_labels=cbar_labels, dpi=dpi, figsize=figsize)
        if save_dir:
            fig.savefig(fname=os.path.join(save_dir, f"{fov}.png"), dpi=300)


def plot_pixel_cell_cluster(img_xr, fovs: List[str], cluster_id_to_name_path,
                            metacluster_colors: Dict,
                            cluster_type: str = "pixel",
                            cbar_visible: bool = True, save_dir=None,
                            fov_col: str = "fovs", erode: bool = False,
                            dpi=300, figsize=(10, 10), *, device="cuda"):
    """Plot pixel/cell cluster masks with the GUI metacluster colormap."""
    verify_in_list(provided_cluster_type=[cluster_type],
                   valid_cluster_types=["pixel", "cell"])
    verify_in_list(fovs=fovs, unique_fovs=list(img_xr.coords[fov_col]))
    io_utils.validate_paths(cluster_id_to_name_path)
    mcc = MetaclusterColormap(cluster_type=cluster_type,
                              cluster_id_to_name_path=cluster_id_to_name_path,
                              metacluster_colors=metacluster_colors)
    for fov in fovs:
        image = np.squeeze(img_xr.sel(**{fov_col: fov}).values)
        if erode:
            image = erode_mask(image, connectivity=2, mode="thick", device=device)
        fig = plot_cluster(
            image=image, fov=fov, cmap=mcc.cmap, norm=mcc.norm,
            cbar_visible=cbar_visible,
            cbar_labels=mcc.metacluster_id_to_name[
                f"{cluster_type}_meta_cluster_rename"].values,
            dpi=dpi, figsize=figsize)
        if save_dir:
            fig.savefig(fname=os.path.join(save_dir, f"{fov}.png"), dpi=300)


def tif_overlay_preprocess(segmentation_labels, plotting_tif):
    """Format a 2-D/3-D signal image into 3-channel RGB for overlays."""
    if len(plotting_tif.shape) == 2:
        if plotting_tif.shape != segmentation_labels.shape:
            raise ValueError("plotting_tif and segmentation_labels array "
                             "dimensions not equal.")
        formatted_tif = np.zeros(
            (plotting_tif.shape[0], plotting_tif.shape[1], 3),
            dtype=plotting_tif.dtype)
        formatted_tif[..., 2] = plotting_tif
    elif len(plotting_tif.shape) == 3:
        if plotting_tif.shape[2] > 3:
            raise ValueError("max 3 channels of overlay supported, got "
                             "{}".format(plotting_tif.shape))
        formatted_tif = np.zeros(
            (plotting_tif.shape[0], plotting_tif.shape[1], 3),
            dtype=plotting_tif.dtype)
        formatted_tif[..., :plotting_tif.shape[2]] = plotting_tif
        formatted_tif = np.flip(formatted_tif, axis=2)
    else:
        raise ValueError("plotting tif must be 2D or 3D array, got "
                         "{}".format(plotting_tif.shape))
    return formatted_tif


def _rescale_to_uint8(channel: torch.Tensor, in_range) -> torch.Tensor:
    """(channel - lo) / max(hi - lo, 1e-12) of an f64 channel, clipped to
    [0, 1], times 255 and truncated to uint8, on the channel's device. The divisor is a
    tensor: a host scalar would become a multiply by its reciprocal on CUDA,
    and one ulp moves a byte."""
    lo, hi = in_range               # numpy scalars: hi - lo rounds in their own type
    span = torch.tensor(float(max(hi - lo, 1e-12)), dtype=torch.float64,
                        device=channel.device)
    scaled = (channel - float(lo)) / span
    return (torch.clamp(scaled, 0, 1) * 255).to(torch.uint8)


def _contour_mask(labels: np.ndarray, device) -> torch.Tensor:
    return morphology.find_boundaries(
        torch.as_tensor(np.asarray(labels).astype(np.int32), device=device),
        connectivity=1, mode="inner")


def overlay_from_arrays(plotting_vals: np.ndarray, segmentation_labels: np.ndarray,
                        alternate_segmentation=None, *, device="cuda") -> np.ndarray:
    """The overlay of ``create_overlay`` from arrays in memory: (H, W) or
    (H, W, <=3) channel data and the (H, W) labels whose inner boundaries
    are drawn white (those of `alternate_segmentation` red). Boundaries and
    the rescale to uint8 run on `device`; each channel's 5th and 95th
    percentile of its positive pixels is numpy's, on the host."""
    plotting_rgb = tif_overlay_preprocess(segmentation_labels, plotting_vals)
    contour = _contour_mask(segmentation_labels, device)
    rescaled = torch.zeros(plotting_rgb.shape, dtype=torch.uint8, device=device)
    for idx in range(plotting_rgb.shape[2]):
        channel = plotting_rgb[:, :, idx]
        if np.max(channel) == 0:
            continue
        percentiles = np.percentile(channel[channel > 0], [5, 95])
        # widened on the host: torch converts only some integer types itself
        rescaled[:, :, idx] = _rescale_to_uint8(
            torch.as_tensor(channel.astype(np.float64), device=device), percentiles)
    rescaled[contour] = 255

    if alternate_segmentation is not None:
        if segmentation_labels.shape != alternate_segmentation.shape:
            raise ValueError("segmentation_labels and alternate_"
                             "segmentation array dimensions not equal.")
        alternate = _contour_mask(alternate_segmentation, device)
        rescaled[alternate] = torch.tensor([255, 0, 0], dtype=torch.uint8, device=device)
    return rescaled.cpu().numpy()


def create_overlay(fov, segmentation_dir, data_dir, img_overlay_chans,
                   seg_overlay_comp, alternate_segmentation=None, *, device="cuda"):
    """Segmentation-boundary overlay (white) on rescaled channel data;
    alternate contours in red."""
    plotting_tif = load_utils.load_imgs_from_dir(
        data_dir=data_dir, files=[fov + ".tiff"], xr_dim_name="channels",
        xr_channel_names=["nuclear_channel", "membrane_channel"])
    verify_in_list(provided_channels=img_overlay_chans,
                   img_channels=list(plotting_tif.coords["channels"]))
    vals = plotting_tif.sel(fovs=fov).values
    # channels-first input files arrive as (2, H, W) -> DataArray channel axis
    if vals.shape[-1] != 2 and vals.shape[0] == 2:
        vals = np.moveaxis(vals, 0, -1)
    chan_idx = [list(plotting_tif.coords["channels"]).index(c)
                for c in img_overlay_chans]
    plotting_vals = vals[..., chan_idx]

    seg_cell = load_utils.load_imgs_from_dir(
        data_dir=segmentation_dir, files=[fov + "_whole_cell.tiff"],
        xr_dim_name="compartments", xr_channel_names=["whole_cell"],
        trim_suffix="_whole_cell", match_substring="_whole_cell")
    seg_nuc = load_utils.load_imgs_from_dir(
        data_dir=segmentation_dir, files=[fov + "_nuclear.tiff"],
        xr_dim_name="compartments", xr_channel_names=["nuclear"],
        trim_suffix="_nuclear", match_substring="_nuclear")
    comp_stack = np.concatenate((seg_cell.values, seg_nuc.values), axis=-1)
    comp_names = ["whole_cell", "nuclear"]
    verify_in_list(provided_compartments=seg_overlay_comp,
                   seg_compartments=comp_names)
    segmentation_labels = comp_stack[0, :, :,
                                     comp_names.index(seg_overlay_comp)]

    return overlay_from_arrays(plotting_vals, segmentation_labels,
                               alternate_segmentation, device=device)


def set_minimum_color_for_colormap(cmap, default=(0, 0, 0, 1)):
    """Force the colormap's minimum value to a fixed color (black default)."""
    import matplotlib.colors as colors

    cmapN = cmap.N
    corrected = cmap(np.arange(cmapN))
    corrected[0, :] = list(default)
    return colors.ListedColormap(corrected)


def create_mantis_dir(fovs: List[str], mantis_project_path, img_data_path,
                      mask_output_dir, mapping, seg_dir,
                      cluster_type="pixel", mask_suffix: str = "_mask",
                      seg_suffix_name: Optional[str] = "_whole_cell.tiff",
                      img_sub_folder: str = None,
                      new_mask_suffix: str = None):
    """Assemble a Mantis Viewer project directory (channels + population
    masks + segmentation + mapping CSVs per FOV)."""
    verify_in_list(provided_cluster_type=[cluster_type],
                   valid_cluster_types=["pixel", "cell"])
    os.makedirs(mantis_project_path, exist_ok=True)
    img_sub_folder = "" if not img_sub_folder else img_sub_folder

    if isinstance(mapping, (pathlib.Path, str)):
        map_df = pd.read_csv(mapping)
    elif isinstance(mapping, pd.DataFrame):
        map_df = mapping
    else:
        raise ValueError("Mapping must either be a path to an already saved "
                         "mapping csv, or a DataFrame that is already loaded "
                         "in.")
    save_seg_tiff = all(v is not None for v in [seg_dir, seg_suffix_name])
    if not new_mask_suffix:
        new_mask_suffix = mask_suffix

    cluster_id_key = "cluster_id"
    map_df = map_df.loc[:, [cluster_id_key,
                            f"{cluster_type}_meta_cluster_rename"]]
    map_df = map_df.drop_duplicates().sort_values(by=[cluster_id_key])
    map_df = map_df.rename(
        {cluster_id_key: "region_id",
         f"{cluster_type}_meta_cluster_rename": "region_name"}, axis=1)

    mask_names_loaded = io_utils.list_files(mask_output_dir, mask_suffix)
    mask_names_delimited = [mn.split(mask_suffix)[0]
                            for mn in mask_names_loaded]
    fovs = natsorted(fovs)
    verify_in_list(fovs=fovs, img_data_fovs=mask_names_delimited)
    # pair each FOV with ITS mask by exact name — a substring filter +
    # zip mispairs when one requested FOV is a prefix of an unrequested
    # mask's FOV name (fov1 matching fov10's mask shifts the whole zip)
    for fov in fovs:
        mn = fov
        img_source_dir = os.path.join(img_data_path, fov, img_sub_folder)
        output_dir = os.path.join(mantis_project_path, fov)
        if not os.path.exists(output_dir):
            os.makedirs(output_dir)
            chans = io_utils.list_files(img_source_dir, substrs=_IMAGE_EXTS)
            for chan in chans:
                shutil.copy(os.path.join(img_source_dir, chan),
                            os.path.join(output_dir, chan))
        mask_name = mn + mask_suffix + ".tiff"
        shutil.copy(os.path.join(mask_output_dir, mask_name),
                    os.path.join(output_dir,
                                 "population{}.tiff".format(new_mask_suffix)))
        if save_seg_tiff:
            if not os.path.exists(os.path.join(output_dir,
                                               "cell_segmentation.tiff")):
                shutil.copy(os.path.join(seg_dir, fov + seg_suffix_name),
                            os.path.join(output_dir,
                                         "cell_segmentation.tiff"))
        map_df.to_csv(os.path.join(
            output_dir, "population{}.csv".format(new_mask_suffix)),
            index=False)


def gather_colors(mask: np.ndarray, table: np.ndarray, *, device="cuda") -> np.ndarray:
    """table[mask] on `device`: an (H, W) image of non-negative integer ids
    through a (n_ids, 4) uint8 colour table; (H, W, 4) uint8."""
    idx = torch.as_tensor(np.asarray(mask).astype(np.int64), device=device)
    return torch.as_tensor(np.ascontiguousarray(table), device=device)[idx].cpu().numpy()


def save_colored_mask(fov: str, save_dir: str, suffix: str, data, cmap,
                      norm, *, device="cuda") -> None:
    """Save one mask rendered through a colormap as uint8 RGBA. A mask of
    non-negative integer ids goes through the colormap id by id on the host
    and is gathered on `device`; any other image (a continuous statistic)
    is rendered by matplotlib on the host."""
    os.makedirs(save_dir, exist_ok=True)
    data = np.asarray(data)
    if data.dtype.kind in "iu" and data.size and data.min() >= 0:
        ids = np.arange(int(data.max()) + 1, dtype=data.dtype)
        table = (cmap(norm(ids)) * 255.999).astype(np.uint8)
        colored_mask = gather_colors(data, table, device=device)
    else:
        colored_mask = (cmap(norm(data)) * 255.999).astype(np.uint8)
    save_image(os.path.join(save_dir, f"{fov}{suffix}"), colored_mask)


def save_colored_masks(fovs: List[str], mask_dir, save_dir,
                       cluster_id_to_name_path, metacluster_colors: Dict,
                       cluster_type: str, *, device="cuda") -> None:
    """Render saved pixie masks through the metacluster colormap."""
    from tqdm import tqdm

    verify_in_list(provided_cluster_type=[cluster_type],
                   valid_cluster_types=["pixel", "cell"])
    mask_dir = pathlib.Path(mask_dir)
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    io_utils.validate_paths([mask_dir, save_dir])
    mcc = MetaclusterColormap(cluster_type=cluster_type,
                              cluster_id_to_name_path=cluster_id_to_name_path,
                              metacluster_colors=metacluster_colors)
    table = (mcc.mc_colors * 255.999).astype(np.uint8)
    for fov in tqdm(fovs, desc="Saving colored masks", unit="FOVs"):
        mask = read_image(str(mask_dir / f"{fov}_{cluster_type}_mask.tiff"))
        colored_mask = gather_colors(np.squeeze(mask), table, device=device)
        save_image(str(save_dir / f"{fov}_{cluster_type}_mask_colored.tiff"),
                   colored_mask)


def cohort_cluster_plot(fovs: List[str], seg_dir, save_dir,
                        cell_data: pd.DataFrame,
                        fov_col: str = settings.FOV_ID,
                        label_col: str = settings.CELL_LABEL,
                        cluster_col: str = settings.CELL_TYPE,
                        seg_suffix: str = "_whole_cell.tiff",
                        cmap="viridis", style: str = "seaborn-v0_8-paper",
                        erode: bool = False, display_fig: bool = False,
                        fig_file_type: str = "png", figsize: tuple = (10, 10),
                        dpi: int = 300, *, device="cuda") -> None:
    """Save numbered, colored, and plotted cluster masks for each FOV."""
    import matplotlib.colors as colors
    import matplotlib.pyplot as plt
    from tqdm import tqdm

    plt.style.use(style)
    seg_dir = pathlib.Path(seg_dir)
    io_utils.validate_paths(seg_dir)
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(fovs, str):
        fovs = [fovs]
    for sub_dir in ["cluster_masks", "cluster_masks_colored",
                    "cluster_plots"]:
        (save_dir / sub_dir).mkdir(parents=True, exist_ok=True)

    cmd = ClusterMaskData(data=cell_data, fov_col=fov_col,
                          label_col=label_col, cluster_col=cluster_col)
    if isinstance(cmap, pd.DataFrame):
        unique_clusters = cmd.mapping[[cmd.cluster_column,
                                       cmd.cluster_id_column]].drop_duplicates()
        cmap_colors = cmap.merge(
            right=unique_clusters,
            on=cmd.cluster_column).sort_values(by="cluster_id")["color"].values
        colors_like = [colors.is_color_like(c) for c in cmap_colors]
        if not all(colors_like):
            bad = np.asarray(cmap_colors)[~np.array(colors_like)]
            raise ValueError(
                "Not all colors in the provided cmap are valid colors."
                f"The following colors are invalid: {bad}")
        np_colors = colors.to_rgba_array(cmap_colors)
        color_map, norm = create_cmap(np_colors, n_clusters=cmd.n_clusters)
    else:
        color_map, norm = create_cmap(cmap, n_clusters=cmd.n_clusters)

    for fov in tqdm(fovs, desc="Cluster Mask Generation", unit="FOVs"):
        cluster_mask = generate_cluster_mask(
            fov=fov, seg_dir=seg_dir, cmd=cmd, seg_suffix=seg_suffix,
            erode=erode, device=device)
        save_fov_mask(fov, data_dir=save_dir / "cluster_masks",
                      mask_data=cluster_mask, sub_dir=None)
        save_colored_mask(fov=fov,
                          save_dir=str(save_dir / "cluster_masks_colored"),
                          suffix=".tiff", data=cluster_mask, cmap=color_map,
                          norm=norm, device=device)
        cluster_labels = ["Background"] + cmd.cluster_names + ["Unassigned"]
        fig = plot_cluster(image=cluster_mask, fov=fov, cmap=color_map,
                           norm=norm, cbar_visible=True,
                           cbar_labels=cluster_labels, figsize=figsize,
                           dpi=dpi)
        fig.savefig(fname=os.path.join(save_dir, "cluster_plots",
                                       f"{fov}.{fig_file_type}"))
        if display_fig:
            fig.show(warn=False)
        else:
            plt.close(fig)


def plot_continuous_variable(image, name: str, stat_name: str, cmap,
                             norm=None, cbar_visible: bool = True,
                             dpi: int = 300, figsize=(10, 10)
                             ) -> "matplotlib.figure.Figure":
    """Plot an image colored by a continuous per-cell statistic."""
    import matplotlib.pyplot as plt
    from matplotlib import gridspec
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    fig = plt.figure(figsize=figsize, dpi=dpi)
    fig.set_layout_engine(layout="tight")
    gs = gridspec.GridSpec(nrows=1, ncols=1, figure=fig)
    fig.suptitle(f"{name}")
    ax = fig.add_subplot(gs[0, 0])
    ax.axis("off")
    ax.grid(visible=False)
    im = ax.imshow(X=image, cmap=cmap, norm=norm, origin="upper",
                   aspect="equal", interpolation="none")
    if cbar_visible:
        divider = make_axes_locatable(fig.gca())
        cax = divider.append_axes(position="right", size="5%", pad="3%")
        fig.colorbar(mappable=im, cax=cax, orientation="vertical",
                     use_gridspec=True, pad=0.1, shrink=0.9, drawedges=False,
                     label=stat_name)
    return fig


def color_segmentation_by_stat(fovs: List[str], data_table: pd.DataFrame,
                               seg_dir, save_dir,
                               fov_col: str = settings.FOV_ID,
                               label_col: str = settings.CELL_LABEL,
                               stat_name: str = settings.CELL_TYPE,
                               cmap: str = "viridis", reverse: bool = False,
                               seg_suffix: str = "_whole_cell.tiff",
                               cbar_visible: bool = True,
                               style: str = "seaborn-v0_8-paper", erode: bool = False,
                               display_fig: bool = False,
                               fig_file_type: str = "png",
                               figsize: tuple = (10, 10), dpi: int = 300, *,
                               device="cuda"):
    """Color segmentation masks by a continuous statistic (cohort-normalized
    colormap)."""
    import matplotlib.colors as colors
    import matplotlib.pyplot as plt
    from matplotlib import colormaps
    from tqdm import tqdm

    plt.style.use(style)
    seg_dir = pathlib.Path(seg_dir)
    save_dir = pathlib.Path(save_dir)
    io_utils.validate_paths([seg_dir])
    save_dir.mkdir(parents=True, exist_ok=True)
    verify_in_list(statistic_name=[fov_col, label_col, stat_name],
                   data_table_columns=data_table.columns)
    (save_dir / "continuous_plots").mkdir(parents=True, exist_ok=True)
    (save_dir / "colored").mkdir(parents=True, exist_ok=True)

    data_table = data_table[data_table[fov_col].isin(fovs)]
    groups = data_table[[fov_col, label_col, stat_name]].sort_values(
        by=[fov_col, label_col]).groupby(by=fov_col)
    vmin = data_table[stat_name].min()
    vmax = data_table[stat_name].max()
    norm = colors.Normalize(vmin=vmin, vmax=vmax)
    if reverse:
        cmap = f"{cmap}_r"
    color_map = set_minimum_color_for_colormap(cmap=colormaps[cmap],
                                               default=(0, 0, 0, 1))
    for fov, fov_group in tqdm(groups, desc=f"Generating {stat_name} Plots",
                               unit="FOVs"):
        label_map = read_image(str(seg_dir / f"{fov}{seg_suffix}"))
        if erode:
            label_map = erode_mask(label_map, connectivity=2, mode="thick",
                                   device=device)
        mapped_seg_image = map_segmentation_labels(
            labels=fov_group[label_col], values=fov_group[stat_name],
            label_map=label_map, device=device)
        fig = plot_continuous_variable(
            image=mapped_seg_image, name=fov, stat_name=stat_name, norm=norm,
            cmap=color_map, cbar_visible=cbar_visible, figsize=figsize,
            dpi=dpi)
        fig.savefig(fname=os.path.join(save_dir, "continuous_plots",
                                       f"{fov}.{fig_file_type}"))
        save_colored_mask(fov=fov, save_dir=str(save_dir / "colored"),
                          suffix=".tiff", data=mapped_seg_image,
                          cmap=color_map, norm=norm, device=device)
        if display_fig:
            fig.show(warn=False)
        else:
            plt.close(fig)
