"""Cohort data utilities: cluster-mask models, relabeling, mask generation,
stitching, AnnData export.

Port of ``ark_tpu/utils/data_utils.py``. The device work runs in torch ops
on the `device` the caller names: ``erode_mask`` (thick boundaries over
``ops/morphology.find_boundaries``), ``label_cells_by_cluster`` (a lookup-
table gather, ``ops/relabel``) and the scatter of
``generate_pixel_cluster_mask``. All of it is integer work, so every device
gives the same masks. Each function that reads files has an array-level
core beside it (``cluster_mask_from_labels``, ``scatter_pixel_clusters``)
that takes arrays and `device`, for callers that hold their images in
memory. ``ClusterMaskData``, the savers, the stitchers and the AnnData
writer are host code (pandas, numpy, h5py), as in the JAX package; h5py is
imported inside the functions that need it. AnnData stores are written as
`.h5ad`-layout HDF5, and the JAX package's ``AnnDataLite.read_h5ad`` reads
them (and this one reads the JAX package's)."""

from __future__ import annotations

import itertools
import os
import pathlib
import re
from typing import Dict, List, Optional, TypedDict

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch import settings
from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.io import io_utils, load_utils
from ark_tpu_torch.io.image_utils import check_tiff_name, read_image, save_image
from ark_tpu_torch.io.io_utils import natsorted
from ark_tpu_torch.ops import morphology, relabel
from ark_tpu_torch.utils.labeled_array import DataArray
from ark_tpu_torch.utils.misc_utils import verify_in_list


def save_fov_mask(fov, data_dir, mask_data, sub_dir=None, name_suffix=""):
    """Save one FOV's cluster-mask image as `<fov><suffix>.tiff`."""
    io_utils.validate_paths(data_dir)
    if sub_dir is None:
        sub_dir = ""
    save_dir = os.path.join(data_dir, sub_dir)
    os.makedirs(save_dir, exist_ok=True)
    save_image(os.path.join(save_dir, fov + name_suffix + ".tiff"), mask_data)


def erode_mask(seg_mask: np.ndarray, *, device="cuda", **kwargs) -> np.ndarray:
    """Zero the boundary pixels of every labeled object; the boundaries
    (`connectivity` 1 and `mode` "thick" unless given) are found on
    `device`."""
    connectivity = kwargs.get("connectivity", 1)
    mode = kwargs.get("mode", "thick")
    seg_mask = np.asarray(seg_mask)
    edges = morphology.find_boundaries(
        torch.as_tensor(seg_mask.astype(np.int32), device=device),
        connectivity=connectivity, mode=mode).cpu().numpy()
    return np.where(~edges, seg_mask, 0)


class ClusterMaskData:
    """Cohort mapping fov × segmentation-label → cluster id.

    String clusters get stable sorted integer ids starting at 1; background
    stays 0; unassigned cells get max_id + 1 (reference :87-201)."""

    def __init__(self, data: pd.DataFrame, fov_col: str, label_col: str,
                 cluster_col: str) -> None:
        self.fov_column = fov_col
        self.label_column = label_col
        self.cluster_column = cluster_col
        self.cluster_id_column = "cluster_id"

        mapping_data = data[[fov_col, label_col, cluster_col]].copy()
        cluster_name_id = pd.DataFrame(
            {cluster_col: mapping_data[cluster_col].unique()})
        cluster_name_id = cluster_name_id.sort_values(
            by=cluster_col).reset_index(drop=True)
        cluster_name_id[self.cluster_id_column] = \
            (cluster_name_id.index + 1).astype(np.int32)
        self.cluster_name_id = cluster_name_id

        mapping_data = mapping_data.merge(right=cluster_name_id,
                                          on=cluster_col)
        mapping_data = mapping_data.astype({
            fov_col: str, label_col: np.int32,
            self.cluster_id_column: np.int32})
        self.unique_fovs: List[str] = natsorted(
            mapping_data[fov_col].unique().tolist())
        self.unassigned_id = np.int32(
            mapping_data[self.cluster_id_column].max() + 1)
        self.n_clusters = int(mapping_data[self.cluster_id_column].max())

        cluster0 = pd.DataFrame({
            fov_col: self.unique_fovs,
            label_col: np.repeat(0, len(self.unique_fovs)),
            cluster_col: np.repeat(0, len(self.unique_fovs)),
            self.cluster_id_column: np.repeat(0, len(self.unique_fovs)),
        })
        mapping_data = pd.concat([mapping_data, cluster0]).astype({
            fov_col: str, label_col: np.int32,
            self.cluster_id_column: np.int32})
        self.mapping = mapping_data.sort_values(by=[fov_col, label_col])

    def fov_mapping(self, fov: str) -> pd.DataFrame:
        verify_in_list(requested_fov=[fov], all_fovs=self.unique_fovs)
        return self.mapping[
            self.mapping[self.fov_column] == fov].reset_index(drop=True)

    @property
    def cluster_names(self) -> List[str]:
        return self.cluster_name_id[self.cluster_column].tolist()


def label_cells_by_cluster(fov: str, cmd: ClusterMaskData, label_map, *,
                           device="cuda") -> np.ndarray:
    """Relabel a cell-id image by cluster assignment (a lookup-table gather,
    on `device` for images of 2^20 pixels or more). The int16 output wraps
    above 32767 cluster ids, as in the JAX package."""
    verify_in_list(fov_name=[fov], all_data_fovs=cmd.unique_fovs)
    if isinstance(label_map, DataArray):
        labeled_image = np.squeeze(label_map.values).astype(np.int32)
    else:
        labeled_image = np.squeeze(np.asarray(label_map)).astype(np.int32)
    fov_clusters = cmd.fov_mapping(fov=fov)
    mapping = dict(zip(fov_clusters[cmd.label_column].astype(np.int32),
                       fov_clusters[cmd.cluster_id_column].astype(np.int32)))
    relabeled = relabel.relabel_segmentation(
        mapping=mapping, unassigned_id=cmd.unassigned_id,
        labeled_image=labeled_image, _dtype=np.int32, device=device)
    return relabeled.astype(np.int16)


def map_segmentation_labels(labels, values, label_map,
                            unassigned_id: float = 0, *, device="cuda") -> np.ndarray:
    """Map per-cell values onto a label image (NaN values -> 0). The table
    is float64, so the gather stays on the host (``ops/relabel``)."""
    if isinstance(label_map, DataArray):
        labeled_image = np.squeeze(label_map.values).astype(np.int32)
    else:
        labeled_image = np.squeeze(np.asarray(label_map)).astype(np.int32)
    labels = np.asarray(labels, dtype=np.int64)
    values = np.nan_to_num(np.asarray(values, dtype=np.float64), nan=0.0)
    mapping = dict(zip(labels, values))
    return relabel.relabel_segmentation(
        mapping=mapping, unassigned_id=unassigned_id,
        labeled_image=labeled_image, _dtype=np.float64, device=device)


# re-exported for API parity with the reference module
relabel_segmentation = relabel.relabel_segmentation


def cluster_mask_from_labels(fov: str, label_vals: np.ndarray,
                             cmd: ClusterMaskData, erode: bool = True, *,
                             device="cuda") -> np.ndarray:
    """One FOV's cell-cluster mask from its (H, W) segmentation labels in
    memory: the array-level core of ``generate_cluster_mask``."""
    if erode:
        label_vals = erode_mask(label_vals, connectivity=2, mode="thick",
                                device=device)
    return label_cells_by_cluster(fov=fov, cmd=cmd, label_map=label_vals,
                                  device=device)


def generate_cluster_mask(fov: str, seg_dir, cmd: ClusterMaskData,
                          seg_suffix: str = "_whole_cell.tiff",
                          erode: bool = True, *, device="cuda", **kwargs) -> np.ndarray:
    """One FOV's cell-cluster mask from its segmentation labels."""
    io_utils.validate_paths([seg_dir])
    label_map = load_utils.load_imgs_from_dir(
        data_dir=seg_dir, files=[fov + seg_suffix],
        xr_dim_name="compartments", xr_channel_names=["whole_cell"],
        trim_suffix=seg_suffix.split(".")[0]).sel(fovs=fov)
    return cluster_mask_from_labels(fov, np.squeeze(label_map.values), cmd,
                                    erode, device=device)


def generate_and_save_cell_cluster_masks(
        fovs: List[str], save_dir, seg_dir, cell_data: pd.DataFrame,
        cluster_id_to_name_path, fov_col: str = settings.FOV_ID,
        label_col: str = settings.CELL_LABEL,
        cell_cluster_col: str = settings.CELL_TYPE,
        seg_suffix: str = "_whole_cell.tiff", sub_dir: str = None,
        name_suffix: str = "", *, device="cuda"):
    """Generate + save cell cluster masks cohort-wide; refresh the GUI
    cluster-id→name CSV with the mask integer ids."""
    from tqdm import tqdm

    cmd = ClusterMaskData(data=cell_data, fov_col=fov_col,
                          label_col=label_col, cluster_col=cell_cluster_col)
    gui_map = pd.read_csv(cluster_id_to_name_path)
    cluster_map = cmd.mapping.filter(
        [cmd.cluster_column, cmd.cluster_id_column]).drop_duplicates()
    gui_map = gui_map.drop(columns="cluster_id", errors="ignore")
    updated = gui_map.merge(cluster_map, on=[cmd.cluster_column], how="left")
    updated.to_csv(cluster_id_to_name_path, index=False)

    for fov in tqdm(fovs, desc="Cell Cluster Mask Generation", unit="FOVs"):
        cell_mask = generate_cluster_mask(fov=fov, seg_dir=seg_dir, cmd=cmd,
                                          seg_suffix=seg_suffix, device=device)
        save_fov_mask(fov, data_dir=save_dir, mask_data=cell_mask,
                      sub_dir=sub_dir, name_suffix=name_suffix)


def scatter_pixel_clusters(shape, coordinates, cluster_labels, *,
                           device="cuda") -> np.ndarray:
    """(H, W) int16 image with `cluster_labels` written at the flat pixel
    indices `coordinates` and 0 elsewhere, scattered on `device`: the
    array-level core of ``generate_pixel_cluster_mask``. Each pixel of a FOV
    has one row in its feather, so the indices are unique and the scatter
    has no order to keep."""
    h, w = int(shape[0]), int(shape[1])
    coords = torch.as_tensor(np.asarray(coordinates, np.int64), device=device)
    # numpy's own cast of an index assignment, made before the upload
    vals = torch.as_tensor(np.asarray(cluster_labels).astype(np.int16), device=device)
    img_flat = torch.zeros(h * w, dtype=torch.int16, device=device)
    img_flat[coords] = vals
    return img_flat.reshape(h, w).cpu().numpy()


def generate_pixel_cluster_mask(fov, base_dir, tiff_dir, chan_file_path,
                                pixel_data_dir, cluster_mapping,
                                pixel_cluster_col="pixel_meta_cluster", *,
                                device="cuda"):
    """One FOV's pixel-cluster mask: scatter the feather rows into an image
    by flat index."""
    io_utils.validate_paths([tiff_dir, os.path.join(tiff_dir, chan_file_path),
                             os.path.join(base_dir, pixel_data_dir)])
    verify_in_list(provided_cluster_col=[pixel_cluster_col],
                   valid_cluster_cols=["pixel_som_cluster",
                                       "pixel_meta_cluster"])
    verify_in_list(
        provided_fov_file=[fov + ".feather"],
        consensus_fov_files=os.listdir(os.path.join(base_dir, pixel_data_dir)))

    channel_data = np.squeeze(read_image(os.path.join(tiff_dir,
                                                      chan_file_path)))
    fov_data = feather.read_dataframe(
        os.path.join(base_dir, pixel_data_dir, fov + ".feather"))
    fov_data[pixel_cluster_col] = fov_data[pixel_cluster_col].astype(int)
    coordinates = (fov_data["row_index"].values * channel_data.shape[1]
                   + fov_data["column_index"].values)
    mapping = cluster_mapping.drop_duplicates()[
        [pixel_cluster_col, "cluster_id"]]
    id_mapping = dict(zip(mapping[pixel_cluster_col], mapping["cluster_id"]))
    cluster_labels = fov_data[pixel_cluster_col].map(id_mapping).values
    return scatter_pixel_clusters(channel_data.shape[:2], coordinates,
                                  cluster_labels, device=device)


def generate_and_save_pixel_cluster_masks(fovs: List[str], base_dir, save_dir,
                                          tiff_dir, chan_file, pixel_data_dir,
                                          cluster_id_to_name_path,
                                          pixel_cluster_col="pixel_meta_cluster",
                                          sub_dir: str = None,
                                          name_suffix: str = "", *, device="cuda"):
    """Generate + save pixel cluster masks cohort-wide."""
    from tqdm import tqdm

    gui_map = pd.read_csv(cluster_id_to_name_path)
    cluster_map = gui_map.copy()[[pixel_cluster_col]]
    cluster_map = cluster_map.drop_duplicates().sort_values(
        by=[pixel_cluster_col])
    cluster_map["cluster_id"] = list(range(1, len(cluster_map) + 1))
    gui_map = gui_map.drop(columns="cluster_id", errors="ignore")
    updated = gui_map.merge(cluster_map, on=[pixel_cluster_col], how="left")
    updated.to_csv(cluster_id_to_name_path, index=False)

    for fov in tqdm(fovs, desc="Pixel Cluster Mask Generation", unit="FOVs"):
        chan_file_path = os.path.join(fov, chan_file)
        pixel_mask = generate_pixel_cluster_mask(
            fov=fov, base_dir=base_dir, tiff_dir=tiff_dir,
            chan_file_path=chan_file_path, pixel_data_dir=pixel_data_dir,
            pixel_cluster_col=pixel_cluster_col, cluster_mapping=updated,
            device=device)
        save_fov_mask(fov, data_dir=save_dir, mask_data=pixel_mask,
                      sub_dir=sub_dir, name_suffix=name_suffix)


def generate_and_save_neighborhood_cluster_masks(
        fovs: List[str], save_dir, seg_dir, neighborhood_data: pd.DataFrame,
        fov_col: str = settings.FOV_ID, label_col: str = settings.CELL_LABEL,
        cluster_col: str = settings.KMEANS_CLUSTER,
        seg_suffix: str = "_whole_cell.tiff", xr_channel_name="label",
        sub_dir=None, name_suffix: str = "", *, device="cuda"):
    """Generate + save neighborhood cluster masks cohort-wide."""
    from tqdm import tqdm

    cmd = ClusterMaskData(data=neighborhood_data, fov_col=fov_col,
                          label_col=label_col, cluster_col=cluster_col)
    for fov in tqdm(fovs, desc="Neighborhood Cluster Mask Generation",
                    unit="FOVs"):
        label_map = load_utils.load_imgs_from_dir(
            seg_dir, files=[fov + seg_suffix],
            xr_channel_names=[xr_channel_name],
            trim_suffix=seg_suffix.split(".")[0]).sel(fovs=fov)
        neighborhood_mask = label_cells_by_cluster(fov, cmd, label_map,
                                                   device=device)
        save_fov_mask(fov, data_dir=save_dir, mask_data=neighborhood_mask,
                      sub_dir=sub_dir, name_suffix=name_suffix)


def split_img_stack(stack_dir, output_dir, stack_list, indices, names,
                    channels_first=True):
    """Split channel stacks into per-channel image files."""
    for stack_name in stack_list:
        img_stack = read_image(os.path.join(stack_dir, stack_name))
        img_dir = os.path.join(output_dir, os.path.splitext(stack_name)[0])
        os.makedirs(img_dir)
        for i in range(len(indices)):
            channel = img_stack[indices[i], ...] if channels_first \
                else img_stack[..., indices[i]]
            save_image(os.path.join(img_dir, names[i]), channel)


def stitch_images(image_data: DataArray, num_cols: int) -> DataArray:
    """Stitch a (fovs, rows, cols, channels) tile array into one image
    (re-provides `alpineer.data_utils.stitch_images`)."""
    n_fovs, h, w, c = image_data.shape
    num_rows = int(np.ceil(n_fovs / num_cols))
    stitched = np.zeros((num_rows * h, num_cols * w, c),
                        dtype=image_data.values.dtype)
    for i in range(n_fovs):
        r, cc = divmod(i, num_cols)
        stitched[r * h:(r + 1) * h, cc * w:(cc + 1) * w, :] = \
            image_data.values[i]
    return DataArray(stitched[None],
                     coords={"stitch": ["stitched_image"],
                             "rows": np.arange(stitched.shape[0]),
                             "cols": np.arange(stitched.shape[1]),
                             "channels": image_data.coords["channels"]})


def stitch_images_by_shape(data_dir, stitched_dir, img_sub_folder=None,
                           channels=None, segmentation=False,
                           clustering=False):
    """Stitch per-channel cohort images using RnCm FOV folder names."""
    io_utils.validate_paths(data_dir)
    if img_sub_folder in [None, ""]:
        img_sub_folder = ""
    if clustering and clustering not in ["pixel", "cell"]:
        raise ValueError(
            "If stitching images from the pixie pipeline, the clustering arg "
            'must be set to either "pixel" or "cell".')

    if segmentation:
        files = natsorted(io_utils.list_files(data_dir,
                                              substrs="_whole_cell.tiff"))
        fovs = [f.split("_whole_cell.tiff")[0] for f in files]
    elif clustering:
        suffix = f"_{clustering}_mask.tiff"
        files = natsorted(io_utils.list_files(data_dir, substrs=suffix))
        fovs = [f.split(suffix)[0] for f in files]
    else:
        fovs = natsorted(io_utils.list_folders(data_dir))
        if "stitched_images" in fovs:
            fovs.remove("stitched_images")
    if len(fovs) == 0:
        raise ValueError(f"No FOVs found in directory, {data_dir}.")
    if os.path.exists(stitched_dir):
        raise ValueError(f"The {stitched_dir} directory already exists.")

    # fullmatch with the same grammar get_tiled_fov_names enforces
    # (optional run prefix + RnCm, nothing after): a substring search let
    # 'R1C1_extra' pass this friendly check only to die later inside the
    # tiled loader with a generic error after dirs were already created
    search_term = re.compile(r"(?:.*_)?R\d+C\d+")
    bad = [fov for fov in fovs if re.fullmatch(search_term, fov) is None]
    if bad:
        raise ValueError(f"Invalid FOVs found in directory, {data_dir}. FOV "
                         f"names {bad} should have the form RnCm.")

    if not segmentation and not clustering:
        channel_imgs = io_utils.list_files(
            os.path.join(data_dir, fovs[0], img_sub_folder),
            substrs=[".tiff", ".tif", ".png", ".jpg"])
    else:
        channel_imgs = io_utils.list_files(data_dir, substrs=fovs[0] + "_")
        channel_imgs = [c.split(fovs[0] + "_")[1] for c in channel_imgs]
    if channels is None:
        channels = io_utils.remove_file_extensions(channel_imgs)
    else:
        verify_in_list(channel_inputs=channels,
                       valid_channels=io_utils.remove_file_extensions(
                           channel_imgs))
    file_ext = os.path.splitext(channel_imgs[0])[1]
    # the tiles read and the first, whose extension the stitched files take,
    # are TIFFs: checked before any directory is made
    for name in channel_imgs:
        if name == channel_imgs[0] or io_utils.remove_file_extensions([name])[0] in channels:
            check_tiff_name(name)

    _, dims = load_utils.get_tiled_fov_names(fovs, return_dims=True)
    for chan, (prefix, num_rows, num_cols) in itertools.product(channels, dims):
        expected_fovs = [
            f"{prefix + '_' if prefix else ''}R{r}C{c}"
            for r in range(1, num_rows + 1) for c in range(1, num_cols + 1)]
        subdir_name = prefix if prefix else "unnamed_tile"
        stitched_subdir = os.path.join(stitched_dir, subdir_name)
        os.makedirs(stitched_subdir, exist_ok=True)
        image_data = load_utils.load_tiled_img_data(
            data_dir, [f for f in fovs if f in expected_fovs], expected_fovs,
            chan, single_dir=any([segmentation, clustering]),
            img_sub_folder=img_sub_folder)
        stitched = stitch_images(image_data, num_cols)
        current = stitched.values[0, :, :, 0]
        save_image(os.path.join(stitched_subdir,
                                chan + "_stitched" + file_ext), current)


# ---------------------------------------------------------------------------
# AnnData export (h5ad-layout HDF5 via h5py)
# ---------------------------------------------------------------------------

def _h5ad_set_encoding(node, enc_type: str, enc_version: str):
    node.attrs["encoding-type"] = enc_type
    node.attrs["encoding-version"] = enc_version


def _h5ad_write_array(group, name: str, vals: np.ndarray):
    """One spec-encoded array member: numeric -> 'array', strings ->
    utf-8 variable-length 'string-array' (anndata on-disk spec v0.1)."""
    import h5py
    vals = np.asarray(vals)
    if vals.dtype.kind in "UOS" or str(vals.dtype).startswith("str"):
        ds = group.create_dataset(
            name, data=[str(v) for v in vals],
            dtype=h5py.string_dtype(encoding="utf-8"))
        _h5ad_set_encoding(ds, "string-array", "0.2.0")
    else:
        # numeric and bool arrays share the plain 'array' encoding
        ds = group.create_dataset(name, data=vals)
        _h5ad_set_encoding(ds, "array", "0.2.0")
    return ds


def _write_h5ad(path, X: np.ndarray, obs: pd.DataFrame, var_names: List[str],
                obsm: Dict[str, np.ndarray]):
    """Write an AnnData `.h5ad` following the anndata on-disk spec (v0.8+
    element encodings: root 'anndata' 0.1.0, dataframe groups 0.2.0 with
    `_index`/`column-order`, utf-8 'string-array' columns), so real anndata
    readers open these stores. Divergence from the reference
    (`data_utils.py:850-1004`): the reference writes *zarr* AnnData stores;
    here the same logical object is written as HDF5 `.h5ad`; anndata reads
    both, via `read_h5ad` and `read_zarr`.
    """
    import h5py
    with h5py.File(path, "w") as f:
        _h5ad_set_encoding(f, "anndata", "0.1.0")
        _h5ad_write_array(f, "X", np.asarray(X, np.float32))

        grp_var = f.create_group("var")
        _h5ad_set_encoding(grp_var, "dataframe", "0.2.0")
        grp_var.attrs["_index"] = "var_names"
        grp_var.attrs["column-order"] = np.array([], dtype="S")
        _h5ad_write_array(grp_var, "var_names", np.asarray(var_names))

        grp_obs = f.create_group("obs")
        _h5ad_set_encoding(grp_obs, "dataframe", "0.2.0")
        grp_obs.attrs["_index"] = "obs_names"
        grp_obs.attrs["column-order"] = np.asarray(
            [str(c) for c in obs.columns],
            dtype=h5py.string_dtype(encoding="utf-8"))
        _h5ad_write_array(grp_obs, "obs_names",
                          np.asarray(obs.index.astype(str)))
        for col in obs.columns:
            _h5ad_write_array(grp_obs, str(col), obs[col].values)

        grp_obsm = f.create_group("obsm")
        _h5ad_set_encoding(grp_obsm, "dict", "0.1.0")
        for key, arr in obsm.items():
            _h5ad_write_array(grp_obsm, key, np.asarray(arr))
        # optional mappings anndata expects to be dict-encoded when present
        for extra in ("uns", "layers", "obsp", "varp", "varm"):
            g = f.create_group(extra)
            _h5ad_set_encoding(g, "dict", "0.1.0")


class AnnDataLite:
    """Light in-memory AnnData stand-in: X, obs, var_names, obsm."""

    def __init__(self, X, obs: pd.DataFrame, var_names: List[str],
                 obsm: Dict[str, np.ndarray]):
        self.X = np.asarray(X)
        self.obs = obs
        self.var_names = list(var_names)
        self.obsm = obsm

    @property
    def n_obs(self):
        return self.X.shape[0]

    @staticmethod
    def _decode(vals: np.ndarray) -> np.ndarray:
        """Bytes (fixed 'S' or vlen utf-8 object arrays) -> str."""
        if vals.dtype.kind == "S":
            return vals.astype(str)
        if vals.dtype.kind == "O":
            return np.array([v.decode() if isinstance(v, bytes) else str(v)
                             for v in vals])
        return vals

    @staticmethod
    def read_h5ad(path) -> "AnnDataLite":
        import h5py
        with h5py.File(path, "r") as f:
            X = f["X"][:]
            dec = AnnDataLite._decode
            var_index = f["var"].attrs.get("_index", "var_names")
            obs_index = f["obs"].attrs.get("_index", "obs_names")
            var_names = list(dec(f["var"][var_index][:]))
            obs_names = list(dec(f["obs"][obs_index][:]))
            obs = {}
            for col in f["obs"]:
                if col == obs_index:
                    continue
                obs[col] = dec(f["obs"][col][:])
            obs = pd.DataFrame(obs, index=obs_names)
            obsm = {k: f["obsm"][k][:] for k in f["obsm"]}
        return AnnDataLite(X, obs, var_names, obsm)


class ConvertToAnnData:
    """Cell table CSV → per-FOV AnnData stores (X=markers, obs=properties,
    obsm['spatial']=centroids); reference :898-1004."""

    def __init__(self, cell_table_path, markers="auto",
                 extra_obs_parameters: Optional[List[str]] = None) -> None:
        io_utils.validate_paths(paths=cell_table_path)
        cell_table = pd.read_csv(cell_table_path)
        ct_columns = cell_table.columns
        marker_index_start = ct_columns.get_loc(settings.PRE_CHANNEL_COL) + 1
        marker_index_stop = ct_columns.get_loc(settings.POST_CHANNEL_COL)
        obs_index_start = ct_columns.get_loc(settings.POST_CHANNEL_COL) + 1
        if markers == "auto":
            markers = ct_columns[marker_index_start:marker_index_stop].to_list()
        else:
            verify_in_list(requested_markers=markers,
                           all_markers=ct_columns[
                               marker_index_start:marker_index_stop].to_list())
        self.var_names = markers
        if extra_obs_parameters:
            verify_in_list(requested_parameters=extra_obs_parameters,
                           all_parameters=ct_columns[obs_index_start:].to_list())
        else:
            extra_obs_parameters = []
        obs_names = [settings.CELL_LABEL, settings.CELL_SIZE,
                     *ct_columns[obs_index_start:].to_list(),
                     *extra_obs_parameters]
        # the extras are validated to be a SUBSET of the post-channel
        # columns already spread above, so they always duplicate (the
        # reference ships this bug, data_utils.py:957-961, and its writer
        # crashes on the duplicated obs column) — dedup preserving order
        obs_names = list(dict.fromkeys(obs_names))
        if settings.CELL_SIZE in obs_names:
            obs_names.remove(settings.CELL_SIZE)
            if "area" not in obs_names:
                cell_table = cell_table.rename(
                    columns={settings.CELL_SIZE: "area"})
                obs_names.append("area")
        self.obs_names = obs_names
        self.cell_table = cell_table

    def convert_to_adata(self, save_dir) -> Dict[str, str]:
        save_dir = pathlib.Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        result = {}
        for fov_id, fov_pd in self.cell_table.groupby(by=settings.FOV_ID,
                                                      sort=True):
            fov_pd = fov_pd.sort_values(by=settings.CELL_LABEL).reset_index()
            index = [f"{fov_id}_{int(lab)}"
                     for lab in fov_pd[settings.CELL_LABEL]]
            X = fov_pd[self.var_names].values
            obs = fov_pd[[c for c in self.obs_names
                          if c in fov_pd.columns]].copy()
            obs.index = index
            obsm = {}
            if settings.CENTROID_0 in obs.columns:
                obsm["spatial"] = obs[[settings.CENTROID_0,
                                       settings.CENTROID_1]].values
                obs = obs.drop(columns=[settings.CENTROID_0,
                                        settings.CENTROID_1])
            path = save_dir / f"{fov_id}.h5ad"
            _write_h5ad(path, X, obs, self.var_names, obsm)
            result[str(fov_id)] = path.as_posix()
        return result


class AnnCollectionKwargs(TypedDict, total=False):
    """Keyword options accepted by `load_anndatas` (API parity with the
    reference's anndata.AnnCollection kwargs, `data_utils.py:1007-1016`).
    The h5ad-backed loader joins on obs by construction, so these are
    accepted and recorded but do not change behavior."""
    join_obs: Optional[str]
    join_obsm: Optional[str]
    join_vars: Optional[str]
    label: Optional[str]
    keys: Optional[List[str]]
    index_unique: Optional[str]
    harmonize_dtypes: bool
    indices_strict: bool


def load_anndatas(anndata_dir, **kwargs) -> Dict[str, AnnDataLite]:
    """Load every per-FOV AnnData store in a directory (lazy-ish; reference
    loads an AnnCollection, :1019-1034)."""
    anndata_dir = pathlib.Path(anndata_dir)
    return {f.stem: AnnDataLite.read_h5ad(f)
            for f in natsorted(anndata_dir.glob("*.h5ad"))}
