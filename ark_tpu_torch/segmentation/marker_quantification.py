"""Single-cell marker quantification: the cell-table engine.

Port of ``ark_tpu/segmentation/marker_quantification.py``. Every per-cell
sum of a FOV is a whole-FOV segment reduction on `device`
(``ark_tpu_torch.ops.segment_reduce``, whose CUDA path is the deterministic
segment-sum kernel), so the cell table is the JAX package's bit for bit in
its sums; the convex-hull rasters run on `device` too, and the concavity
counts and the table assembly on the host. The output has the schema and
column order of ``ark_tpu_torch.settings`` (the JAX package's) in the port's
``DataArray``. Files go through ``ark_tpu_torch.io`` and its own TIFF
codec.

Each step is a span (``ark_tpu_torch.utils.profiling``): a
``generate_cell_table`` call is one ``quant.cell_table`` tree (attributes
``fovs``, ``nuclear_counts`` and, once a FOV's tree is read, ``channels``)
with a ``quant.fov`` span a FOV (``fov``; ``resumed`` when its checkpoint
part was loaded), whose children are ``quant.load`` (the channel tree, read
into the planes of one stack that crosses to `device` once and is
interleaved channel-last there, and the masks; ``direct`` and ``decoded``
count the channel files read straight into their planes and those decoded
and copied; or the part), ``quant.match_nuclei`` (``segmentation_utils``),
a ``quant.reduce`` a compartment (``comp``; the labels' upload, both
segment sums and their readback, with device events and the
``segment_sum`` and ``plan`` launches it made), ``quant.convex``
(``comp``, ``cells``, ``device_cells``, ``host_cells``),
``quant.concavities`` (``comp``, ``crops``),
``quant.assemble`` (the derived columns, the transforms and the DataFrames)
and ``quant.checkpoint`` (``bytes`` of the part written). ``timings``,
where a function takes it, is a dict that collects the spans' seconds:
``device_reductions_s`` (the ``quant.reduce`` spans), ``convex_s``
(``quant.convex`` and ``quant.concavities``) and ``assembly_s``
(``quant.assemble``).
"""

from __future__ import annotations

import contextlib
import copy
import os
import warnings
from typing import List

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch import settings
from ark_tpu_torch.io import io_utils, load_utils
from ark_tpu_torch.ops import convex as convex_ops
from ark_tpu_torch.ops import segment_reduce
from ark_tpu_torch.segmentation import segmentation_utils
from ark_tpu_torch.segmentation.regionprops_extraction import (CONVEX_PROPS,
                                                               REGIONPROPS_FUNCTION,
                                                               RegionProp)
from ark_tpu_torch.segmentation.signal_extraction import (EXTRACTION_FUNCTION,
                                                          EXTRACTION_FUNCTION_BATCH)
from ark_tpu_torch.utils import profiling
from ark_tpu_torch.utils.labeled_array import DataArray
from ark_tpu_torch.utils.misc_utils import verify_in_list, verify_same_elements

# moment-derived props computed vectorized (no per-cell work); centroid_dif
# uses the batched hull centroid of ops.convex
_VECTOR_SINGLE_COMP = {"major_minor_axis_ratio", "perim_square_over_area",
                       "major_axis_equiv_diam_ratio", "convex_hull_resid",
                       "centroid_dif"}


@contextlib.contextmanager
def _phase(timings, key, name, **attrs):
    """The step's span (its attributes as `span` takes them); its seconds
    are added into ``timings[key]``."""
    with profiling.span(name, **attrs) as sp:
        yield sp
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + sp.seconds


@contextlib.contextmanager
def _reduce_span(timings, device, comp):
    """One compartment's ``quant.reduce``: the uploads, segment sums and
    readback done inside, with the ``segment_sum`` and ``plan`` launches
    they made."""
    sums0 = segment_reduce.segment_sum.launches
    plans0 = segment_reduce.segment_plan.launches
    with _phase(timings, "device_reductions_s", "quant.reduce", device=device,
                comp=comp) as sp:
        yield sp
        sp.attrs["segment_sum"] = segment_reduce.segment_sum.launches - sums0
        sp.attrs["plan"] = segment_reduce.segment_plan.launches - plans0


def _reductions(labels: np.ndarray, images: torch.Tensor, extraction: str,
                sig_kwargs, device):
    """(moment features, channel sums) of one compartment's label image over
    the FOV's (H, W, C) f32 `images` on `device`, read back to the host and
    indexed by raw label value; row 0 (the background) is not computed."""
    n_seg = int(labels.max()) + 1 if labels.size else 1
    lab_t = torch.as_tensor(labels, device=device)
    if extraction == "total_intensity" and not sig_kwargs:
        # default path: morphology and channel sums in two segment sums
        feats_t, counts_t = segment_reduce.moment_and_channel_features(
            images, lab_t, n_seg, background=False)
    else:
        feats_t = segment_reduce.moment_features(lab_t, n_seg, background=False)
        counts_t = EXTRACTION_FUNCTION_BATCH[extraction](
            images, lab_t, n_seg, **sig_kwargs)
    return ({k: v.cpu().numpy() for k, v in feats_t.items()},
            counts_t.cpu().numpy())


def _compartment_features(labels: np.ndarray, reduced, cell_ids: np.ndarray,
                          regionprops_names: List[str],
                          regionprops_single_comp: List[str], reg_kwargs, *,
                          device, comp: str = "whole_cell", timings=None):
    """(len(cell_ids), n_features) matrix for one compartment's label image,
    given its `_reductions`.

    Column order: [cell_size] + channels + regionprops_names."""
    n_cells = len(cell_ids)
    feats, counts = reduced
    sizes = feats["area"]

    need_convex = bool(
        ({"convex_area"} & set(regionprops_names))
        or (CONVEX_PROPS & set(regionprops_single_comp)))
    # only per-cell raster consumers (num_concavities) need the crops
    need_masks = bool(set(regionprops_single_comp) - _VECTOR_SINGLE_COMP)
    convex = None
    if need_convex:
        counts0 = dict(convex_ops.COUNTS)
        with _phase(timings, "convex_s", "quant.convex", comp=comp,
                    cells=n_cells) as sp:
            convex = convex_ops.convex_features(labels, cell_ids,
                                                with_masks=need_masks, device=device)
            for key in ("device_cells", "host_cells"):
                sp.attrs[key] = convex_ops.COUNTS[key] - counts0[key]

    with _phase(timings, "assembly_s", "quant.assemble"):
        idx = cell_ids  # the reductions are indexed by raw label value
        columns = {}
        columns["label"] = cell_ids.astype(float)
        for name in ["area", "eccentricity", "major_axis_length",
                     "minor_axis_length", "perimeter", "equivalent_diameter",
                     "centroid-0", "centroid-1"]:
            columns[name] = feats[name][idx]
        if convex is not None:
            columns["convex_area"] = convex["convex_area"]

        with np.errstate(divide="ignore", invalid="ignore"):
            columns["major_minor_axis_ratio"] = np.where(
                columns["minor_axis_length"] == 0, np.nan,
                columns["major_axis_length"] / columns["minor_axis_length"])
            columns["perim_square_over_area"] = (
                columns["perimeter"] ** 2 / columns["area"])
            columns["major_axis_equiv_diam_ratio"] = (
                columns["major_axis_length"] / columns["equivalent_diameter"])
            if convex is not None:
                columns["convex_hull_resid"] = np.where(
                    columns["convex_area"] > 0,
                    (columns["convex_area"] - columns["area"])
                    / np.maximum(columns["convex_area"], 1), 0.0)
                # mask centroid to hull centroid, over sqrt(area)
                columns["centroid_dif"] = np.where(
                    columns["convex_area"] > 0,
                    np.hypot(
                        columns["centroid-0"] - convex["convex_centroid"][:, 0],
                        columns["centroid-1"] - convex["convex_centroid"][:, 1])
                    / np.sqrt(np.maximum(columns["area"], 1e-12)), 0.0)

    host_props = [p for p in regionprops_single_comp
                  if p not in _VECTOR_SINGLE_COMP]
    if host_props:
        crops0 = convex_ops.COUNTS["crops"]
        with _phase(timings, "convex_s", "quant.concavities", comp=comp) as sp:
            _host_props(columns, host_props, labels, cell_ids, convex, reg_kwargs)
            sp.attrs["crops"] = convex_ops.COUNTS["crops"] - crops0

    with _phase(timings, "assembly_s", "quant.assemble"):
        n_channels = counts.shape[1]
        out = np.zeros((n_cells, 1 + n_channels + len(regionprops_names)))
        out[:, 0] = sizes[idx]
        out[:, 1:1 + n_channels] = counts[idx]
        unsupported = []
        for j, name in enumerate(regionprops_names):
            if name in columns:
                out[:, 1 + n_channels + j] = columns[name]
            else:
                unsupported.append(name)
    if unsupported:
        warnings.warn(
            f"regionprops features {unsupported} are not implemented by the "
            f"quantification engine; their columns are zero-filled "
            f"(supported: moments-derived and convex-hull features, see "
            f"ark_tpu_torch.ops.segment_reduce / ark_tpu_torch.ops.convex)")
    return out


def _host_props(columns, host_props, labels, cell_ids, convex, reg_kwargs):
    """The per-cell raster props into `columns`: ``num_concavities`` for all
    cells in one batched labeling pass, any other through its
    ``REGIONPROPS_FUNCTION`` cell by cell."""
    n_cells = len(cell_ids)
    if "num_concavities" in host_props and convex is not None:
        columns["num_concavities"] = convex_ops.count_concavities_batch(
            convex["masks"],
            small_concavity_minimum=reg_kwargs.get("small_concavity_minimum", 10),
            max_compactness=reg_kwargs.get("max_compactness", 60),
            large_concavity_minimum=reg_kwargs.get("large_concavity_minimum", 150))
        host_props = [p for p in host_props if p != "num_concavities"]
    if not host_props:
        return
    for p in host_props:
        columns[p] = np.zeros(n_cells)
    for i, cid in enumerate(cell_ids):
        mask_info = convex["masks"][i] if convex is not None else None
        if mask_info is None:
            coords = np.argwhere(labels == cid)
            if coords.size == 0:
                continue
            mask, hull, origin = convex_ops.convex_image(coords)
        else:
            mask, hull, origin = mask_info
        prop = RegionProp(
            label=int(cid), area=float(columns["area"][i]),
            centroid=(float(columns["centroid-0"][i]),
                      float(columns["centroid-1"][i])),
            major_axis_length=float(columns["major_axis_length"][i]),
            minor_axis_length=float(columns["minor_axis_length"][i]),
            perimeter=float(columns["perimeter"][i]),
            equivalent_diameter=float(columns["equivalent_diameter"][i]),
            eccentricity=float(columns["eccentricity"][i]),
            convex_area=float(columns.get("convex_area",
                                          np.zeros(n_cells))[i]),
            image=mask, convex_image=hull, bbox_origin=origin)
        for p in host_props:
            columns[p][i] = REGIONPROPS_FUNCTION[p](prop, **reg_kwargs)


def _upload_images(images, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(images, dtype=np.float32), device=device)


def get_single_compartment_props(segmentation_labels, regionprops_base=None,
                                 regionprops_single_comp=None, *, device,
                                 **kwargs):
    """Regionprops table (base and derived) of one compartment's label
    image, a cells x props DataFrame; every property is computed for all
    cells at once on `device`."""
    regionprops_base = copy.deepcopy(
        settings.REGIONPROPS_BASE) if regionprops_base is None \
        else copy.deepcopy(regionprops_base)
    regionprops_single_comp = copy.deepcopy(
        settings.REGIONPROPS_SINGLE_COMP) if regionprops_single_comp is None \
        else copy.deepcopy(regionprops_single_comp)
    if regionprops_single_comp:
        verify_in_list(extras_props=regionprops_single_comp,
                       props_options=list(REGIONPROPS_FUNCTION.keys()))

    names = [r for r in regionprops_base if r != "coords"]
    if "centroid" in names:
        names.remove("centroid")
        names += ["centroid-0", "centroid-1"]
    names.extend(regionprops_single_comp)

    labels = np.asarray(segmentation_labels).astype(np.int32)
    cell_ids = np.unique(labels)
    cell_ids = cell_ids[cell_ids != 0]
    dummy = torch.zeros(labels.shape + (1,), dtype=torch.float32, device=device)
    with _reduce_span(None, device, "whole_cell"):
        reduced = _reductions(labels, dummy, "total_intensity", {}, device)
    feats = _compartment_features(
        labels, reduced, cell_ids, names, regionprops_single_comp,
        kwargs.get("regionprops_kwargs", {}), device=device)
    # drop the leading [cell_size, dummy_channel] schema columns
    return pd.DataFrame(feats[:, 2:], columns=names)


def assign_single_compartment_features(marker_counts, compartment,
                                       segmentation_labels, input_images,
                                       regionprops_names,
                                       regionprops_single_comp,
                                       extraction="total_intensity",
                                       cell_ids=None, *, device,
                                       **kwargs) -> DataArray:
    """Fill one compartment's plane of a marker_counts DataArray with the
    signal and regionprops features of all its cells (or `cell_ids`) in one
    call on `device`."""
    labels = np.asarray(segmentation_labels).astype(np.int32)
    if cell_ids is None:
        cell_ids = np.unique(labels)
        cell_ids = cell_ids[cell_ids != 0]
    with _reduce_span(None, device, compartment):
        reduced = _reductions(labels, _upload_images(input_images, device),
                              extraction, kwargs.get("signal_kwargs", {}), device)
    feats = _compartment_features(
        labels, reduced, cell_ids, list(regionprops_names),
        list(regionprops_single_comp), kwargs.get("regionprops_kwargs", {}),
        device=device, comp=compartment)
    compartments = list(marker_counts.coords["compartments"])
    rows_of = {int(c): i for i, c in
               enumerate(np.asarray(marker_counts.coords["cell_id"]))}
    rows = np.array([rows_of[int(c)] for c in cell_ids])
    marker_counts.values[compartments.index(compartment),
                         rows, :feats.shape[1]] = feats
    return marker_counts


def assign_multi_compartment_features(marker_counts, regionprops_multi_comp,
                                      **kwargs) -> DataArray:
    """Apply multi-compartment derived features (e.g. nc_ratio) to a
    marker_counts DataArray."""
    if not regionprops_multi_comp:
        return marker_counts
    verify_in_list(regionprops_multi_comp=list(regionprops_multi_comp),
                   props_options=list(REGIONPROPS_FUNCTION.keys()))
    for name in regionprops_multi_comp:
        marker_counts = REGIONPROPS_FUNCTION[name](marker_counts, **kwargs)
    return marker_counts


def compute_marker_counts(input_images, segmentation_labels,
                          nuclear_counts=False,
                          regionprops_base=None, regionprops_single_comp=None,
                          regionprops_multi_comp=None,
                          split_large_nuclei=False,
                          extraction="total_intensity",
                          fast_extraction=False, *, device, timings=None,
                          **kwargs) -> DataArray:
    """The full per-cell feature array of one FOV, computed on `device`.

    input_images: (rows, cols, channels) DataArray; segmentation_labels:
    (rows, cols, compartments) DataArray. Returns a (compartments x cell_id x
    features) DataArray in the reference's schema. The images are uploaded
    (``_upload_images``) before the steps."""
    return _marker_counts(
        _upload_images(input_images.values, device),
        list(input_images.coords["channels"]), segmentation_labels,
        nuclear_counts=nuclear_counts, regionprops_base=regionprops_base,
        regionprops_single_comp=regionprops_single_comp,
        regionprops_multi_comp=regionprops_multi_comp,
        split_large_nuclei=split_large_nuclei, extraction=extraction,
        fast_extraction=fast_extraction, device=device, timings=timings, **kwargs)


def _marker_counts(images, channel_names, segmentation_labels,
                   nuclear_counts=False,
                   regionprops_base=None, regionprops_single_comp=None,
                   regionprops_multi_comp=None,
                   split_large_nuclei=False,
                   extraction="total_intensity",
                   fast_extraction=False, *, device, timings=None,
                   **kwargs) -> DataArray:
    """``compute_marker_counts`` of the FOV's (rows, cols, channels) float32
    `images` on `device`, whose channels are `channel_names`."""
    regionprops_base = copy.deepcopy(
        settings.REGIONPROPS_BASE) if regionprops_base is None \
        else copy.deepcopy(regionprops_base)
    regionprops_single_comp = copy.deepcopy(
        settings.REGIONPROPS_SINGLE_COMP) if regionprops_single_comp is None \
        else copy.deepcopy(regionprops_single_comp)
    regionprops_multi_comp = copy.deepcopy(
        settings.REGIONPROPS_MULTI_COMP) if regionprops_multi_comp is None \
        else copy.deepcopy(regionprops_multi_comp)

    verify_in_list(extraction=extraction,
                   extraction_options=list(EXTRACTION_FUNCTION.keys()))
    if regionprops_single_comp:
        verify_in_list(extras_props=regionprops_single_comp,
                       props_options=list(REGIONPROPS_FUNCTION.keys()))

    if fast_extraction:
        regionprops_base = [settings.POST_CHANNEL_COL, "centroid"]
        regionprops_single_comp = []
        regionprops_multi_comp = []

    # label first
    if settings.POST_CHANNEL_COL in regionprops_base:
        regionprops_base.remove(settings.POST_CHANNEL_COL)
    regionprops_base.insert(0, settings.POST_CHANNEL_COL)
    if not any("centroid" in r for r in regionprops_base):
        regionprops_base.append("centroid")

    regionprops_names = [r for r in regionprops_base if r != "coords"]
    if "centroid" in regionprops_names:
        regionprops_names.remove("centroid")
        regionprops_names += ["centroid-0", "centroid-1"]
    regionprops_names.extend(regionprops_single_comp)
    single_names = list(regionprops_names)  # before multi-comp names

    compartments = list(segmentation_labels.coords["compartments"])
    cell_labels = segmentation_labels.sel(compartments="whole_cell").values
    cell_labels = np.asarray(cell_labels).astype(np.int32)
    unique_cell_ids = np.unique(cell_labels)
    unique_cell_ids = unique_cell_ids[unique_cell_ids != 0]
    if len(unique_cell_ids) == 0:
        warnings.warn("No cells found in the provided image")

    feature_names = ([settings.PRE_CHANNEL_COL] + channel_names
                     + regionprops_names)
    if nuclear_counts and regionprops_multi_comp:
        feature_names = feature_names + regionprops_multi_comp
        regionprops_names = regionprops_names + regionprops_multi_comp

    marker_counts = DataArray(
        np.zeros((len(compartments), len(unique_cell_ids),
                  len(feature_names))),
        coords={"compartments": compartments,
                "cell_id": unique_cell_ids.astype(int),
                "features": feature_names})

    sig_kwargs = kwargs.get("signal_kwargs", {})
    reg_kwargs = kwargs.get("regionprops_kwargs", {})
    if len(unique_cell_ids) == 0:
        return marker_counts

    with _reduce_span(timings, device, "whole_cell"):
        reduced = _reductions(cell_labels, images, extraction, sig_kwargs, device)
    wc = _compartment_features(
        cell_labels, reduced, unique_cell_ids, single_names,
        regionprops_single_comp, reg_kwargs, device=device, timings=timings)
    marker_counts.values[compartments.index("whole_cell"), :, :wc.shape[1]] = wc

    if nuclear_counts:
        nuc_labels = np.asarray(
            segmentation_labels.sel(compartments="nuclear").values
        ).astype(np.int32)
        if split_large_nuclei:
            nuc_labels = segmentation_utils.split_large_nuclei(
                cell_segmentation_labels=cell_labels,
                nuc_segmentation_labels=nuc_labels,
                cell_ids=unique_cell_ids)
        nuc_of_cell = segmentation_utils.match_nuclei_to_cells(cell_labels,
                                                               nuc_labels)
        if not nuc_of_cell:
            warnings.warn("No nuclei found in the provided image")
        else:
            matched_cells = np.array(
                [c for c in unique_cell_ids if int(c) in nuc_of_cell])
            matched_nucs = np.array(
                [nuc_of_cell[int(c)] for c in matched_cells])
            with _reduce_span(timings, device, "nuclear"):
                reduced = _reductions(nuc_labels, images, extraction, sig_kwargs,
                                      device)
            nuc_feats = _compartment_features(
                nuc_labels, reduced, matched_nucs, single_names,
                regionprops_single_comp, reg_kwargs, device=device,
                comp="nuclear", timings=timings)
            with _phase(timings, "assembly_s", "quant.assemble"):
                comp_idx = compartments.index("nuclear")
                row_of_cell = {int(c): i for i, c in enumerate(unique_cell_ids)}
                rows = np.array([row_of_cell[int(c)] for c in matched_cells])
                # nuclear rows carry the NUCLEUS id in the label column; the
                # row position ties a nucleus to its cell
                marker_counts.values[comp_idx, rows, :nuc_feats.shape[1]] = nuc_feats
                for rn in regionprops_multi_comp:
                    marker_counts = REGIONPROPS_FUNCTION[rn](marker_counts,
                                                             **reg_kwargs)
    return marker_counts


def create_marker_count_matrices(segmentation_labels, image_data,
                                 nuclear_counts=False,
                                 split_large_nuclei=False,
                                 extraction="total_intensity",
                                 fast_extraction=False, *, device,
                                 timings=None, **kwargs):
    """One FOV's (size-normalized, arcsinh-transformed) cell-table pair of
    DataFrames, computed on `device`."""
    if not isinstance(segmentation_labels, DataArray):
        raise ValueError("Incorrect data type for segmentation_labels, "
                         "expecting DataArray")
    if not isinstance(image_data, DataArray):
        raise ValueError("Incorrect data type for image_data, expecting "
                         "DataArray")
    if nuclear_counts:
        verify_in_list(nuclear_label="nuclear",
                       compartment_names=list(
                           segmentation_labels.coords["compartments"]))
    verify_in_list(extraction=extraction,
                   extraction_options=list(EXTRACTION_FUNCTION.keys()))
    verify_same_elements(
        segmentation_labels_fovs=list(segmentation_labels.coords["fovs"]),
        img_data_fovs=list(image_data.coords["fovs"]))

    fov = list(segmentation_labels.coords["fovs"])[0]
    images = image_data.sel(fovs=fov)
    return _count_tables(
        segmentation_labels, _upload_images(images.values, device),
        list(images.coords["channels"]), nuclear_counts=nuclear_counts,
        split_large_nuclei=split_large_nuclei, extraction=extraction,
        fast_extraction=fast_extraction, device=device, timings=timings,
        **kwargs)


def _count_tables(segmentation_labels, images, channel_names,
                  nuclear_counts=False, split_large_nuclei=False,
                  extraction="total_intensity", fast_extraction=False, *,
                  device, timings=None, **kwargs):
    """``create_marker_count_matrices`` of one FOV's (rows, cols, channels)
    float32 `images` on `device`, whose channels are `channel_names`."""
    fov = list(segmentation_labels.coords["fovs"])[0]
    marker_counts = _marker_counts(
        images, channel_names, segmentation_labels.sel(fovs=fov),
        nuclear_counts=nuclear_counts, split_large_nuclei=split_large_nuclei,
        extraction=extraction, fast_extraction=fast_extraction, device=device,
        timings=timings, **kwargs)

    with _phase(timings, "assembly_s", "quant.assemble"):
        normalized, arcsinh = _tables(marker_counts, fov, nuclear_counts)
    return normalized, arcsinh


def _tables(marker_counts, fov, nuclear_counts):
    """The (size-normalized, arcsinh-transformed) DataFrames of one FOV's
    marker counts: the whole-cell columns, then with `nuclear_counts` the
    nuclear ones suffixed ``_nuclear``, then ``fov``."""
    marker_counts_norm = segmentation_utils.transform_expression_matrix(
        marker_counts, transform="size_norm")
    marker_counts_arcsinh = segmentation_utils.transform_expression_matrix(
        marker_counts_norm, transform="arcsinh")

    features = list(marker_counts.coords["features"])
    normalized = pd.DataFrame(
        data=marker_counts_norm.sel(compartments="whole_cell").values,
        columns=features)
    arcsinh = pd.DataFrame(
        data=marker_counts_arcsinh.sel(compartments="whole_cell").values,
        columns=features)
    normalized[settings.CELL_LABEL] = normalized[settings.CELL_LABEL].astype(np.int32)
    arcsinh[settings.CELL_LABEL] = arcsinh[settings.CELL_LABEL].astype(np.int32)

    if nuclear_counts:
        nuc_column_names = [f + "_nuclear" for f in features]
        normalized_nuc = pd.DataFrame(
            data=marker_counts_norm.sel(compartments="nuclear").values,
            columns=nuc_column_names)
        normalized = pd.concat((normalized, normalized_nuc), axis=1)
        arcsinh_nuc = pd.DataFrame(
            data=marker_counts_arcsinh.sel(compartments="nuclear").values,
            columns=nuc_column_names)
        arcsinh = pd.concat((arcsinh, arcsinh_nuc), axis=1)

    normalized["fov"] = fov
    arcsinh["fov"] = fov
    return normalized, arcsinh


def generate_cell_table(segmentation_dir, tiff_dir, img_sub_folder="TIFs",
                        is_mibitiff=False, fovs=None,
                        extraction="total_intensity", nuclear_counts=False,
                        fast_extraction=False, mask_types=None,
                        add_underscore=True, checkpoint_dir=None, *, device,
                        **kwargs):
    """Cohort cell table: per FOV and mask type, extract on `device`
    and concatenate. Returns (size-normalized, arcsinh) DataFrames.

    `checkpoint_dir` enables per-FOV resume: each FOV's tables are written
    there atomically with the identity of the inputs they came from, and a
    rerun loads finished FOVs instead of extracting them again; a parameter
    manifest invalidates parts written under other settings. The result of
    a resumed run equals a straight run bit for bit. The call is one
    ``quant.cell_table`` span tree (module docstring)."""
    mask_types = ["whole_cell"] if mask_types is None else mask_types
    if fovs is None:
        fovs = io_utils.list_folders(tiff_dir)
    fovs = io_utils.remove_file_extensions(fovs)
    verify_in_list(extraction=extraction,
                   extraction_options=list(EXTRACTION_FUNCTION.keys()))
    fovs = sorted(fovs)

    if checkpoint_dir is not None:
        _reconcile_quant_checkpoint(
            checkpoint_dir,
            dict(extraction=extraction, nuclear_counts=nuclear_counts,
                 fast_extraction=fast_extraction, mask_types=mask_types,
                 add_underscore=add_underscore,
                 img_sub_folder=img_sub_folder,
                 kwargs=sorted((k, repr(v)) for k, v in kwargs.items())))

    normalized_tables, arcsinh_tables = [], []
    with profiling.span("quant.cell_table", fovs=len(fovs),
                        nuclear_counts=bool(nuclear_counts)) as root:
        for fov_name in fovs:
            with profiling.span("quant.fov", fov=fov_name) as fov_span:
                norm, arcsinh, channels = _fov_tables(
                    fov_name, segmentation_dir, tiff_dir, img_sub_folder,
                    extraction, nuclear_counts, fast_extraction, mask_types,
                    add_underscore, checkpoint_dir, device=device, **kwargs)
            if channels is None:
                fov_span.attrs["resumed"] = True
            else:
                root.attrs["channels"] = channels
            normalized_tables.extend(norm)
            arcsinh_tables.extend(arcsinh)
        with profiling.span("quant.assemble"):
            return (pd.concat(normalized_tables),
                    pd.concat(arcsinh_tables))


def _fov_tables(fov_name, segmentation_dir, tiff_dir, img_sub_folder,
                extraction, nuclear_counts, fast_extraction, mask_types,
                add_underscore, checkpoint_dir, *, device, **kwargs):
    """One FOV's (size-normalized, arcsinh) tables, two lists with one
    DataFrame a mask type, and the number of channels read: loaded from its
    checkpoint part when that part is of these inputs (channels None), else
    extracted (and the part written)."""
    part_path = os.path.join(checkpoint_dir, fov_name + ".quant.pkl") \
        if checkpoint_dir is not None else None
    ident = None if part_path is None else _fov_input_identity(
        fov_name, segmentation_dir, tiff_dir, img_sub_folder,
        mask_types, add_underscore, nuclear_counts)
    if part_path is not None and os.path.exists(part_path):
        with profiling.span("quant.load"):
            loaded = _load_part(part_path)
        # a part from other inputs (or without an identity) is stale
        if loaded is not None and len(loaded) == 3 and loaded[2] == ident:
            return loaded[0], loaded[1], None

    with profiling.span("quant.load") as load:
        images, channel_names, load.attrs["direct"], load.attrs["decoded"] = \
            _fov_images(tiff_dir, fov_name, img_sub_folder, device)
        labels_of = [_mask_labels(segmentation_dir, fov_name, mask_type,
                                  add_underscore, nuclear_counts)
                     for mask_type in mask_types]

    fov_norm_parts, fov_arcsinh_parts = [], []
    for mask_type, current_labels in labels_of:
        # the nuclear compartment exists only for the whole_cell mask type
        compartments = list(current_labels.coords["compartments"])
        normalized, arcsinh = _count_tables(
            current_labels, images, channel_names, extraction=extraction,
            nuclear_counts=nuclear_counts and "nuclear" in compartments,
            fast_extraction=fast_extraction, device=device, **kwargs)
        with profiling.span("quant.assemble"):
            mask_type_str = "whole_cell" \
                if mask_type == "final_cells_remaining" else mask_type
            normalized["mask_type"] = mask_type_str
            arcsinh["mask_type"] = mask_type_str
        fov_norm_parts.append(normalized)
        fov_arcsinh_parts.append(arcsinh)

    if part_path is not None:
        with profiling.span("quant.checkpoint") as sp:
            # atomic commit: a kill mid-write leaves a .tmp the rerun ignores
            tmp = part_path + ".tmp"
            pd.to_pickle((fov_norm_parts, fov_arcsinh_parts, ident), tmp)
            sp.attrs["bytes"] = os.path.getsize(tmp)
            os.replace(tmp, part_path)
    return fov_norm_parts, fov_arcsinh_parts, len(channel_names)


def _fov_images(tiff_dir, fov_name, img_sub_folder, device):
    """The FOV's channel tree as the (rows, cols, channels) float32 tensor
    on `device` that its reductions read, bitwise ``_upload_images`` of
    ``load_imgs_from_tree``'s array, with the channel names and the
    loader's (direct, decoded) counts. Each file is read into its plane of
    one channel-first float32 stack (``load_utils.load_fov_planes``),
    pinned on CUDA (torch's caching host allocator keeps the block from
    reuse until the copies out of it are done); the stack crosses in one
    non-blocking copy and is interleaved channel-last on `device`."""
    pin = torch.device(device).type == "cuda"
    host = []

    def empty(shape, _dtype):
        host.append(torch.empty(shape, dtype=torch.float32, pin_memory=pin))
        return host[-1].numpy()

    _, channel_names, direct, decoded = load_utils.load_fov_planes(
        tiff_dir, fov_name, img_sub_folder, empty=empty)
    planes = host[0].to(device, non_blocking=True)
    return planes.permute(1, 2, 0).contiguous(), channel_names, direct, decoded


def _mask_labels(segmentation_dir, fov_name, mask_type, add_underscore,
                 nuclear_counts):
    """(mask type as named, its (1, H, W, compartments) label DataArray):
    the mask of `mask_type`, and for the whole-cell mask with
    `nuclear_counts` the nuclear one beside it."""
    if mask_type is None:
        mask_type, mask_suff = "cell_mask", None
    else:
        mask_suff = "_" + mask_type if add_underscore else mask_type
    fov_mask_name = (fov_name + mask_suff + ".tiff") if mask_suff \
        else fov_name + ".tiff"
    current_labels_cell = load_utils.load_imgs_from_dir(
        data_dir=segmentation_dir, files=[fov_mask_name],
        xr_dim_name="compartments", xr_channel_names=[mask_type],
        trim_suffix=mask_suff)
    compartments = ["whole_cell"]
    seg_vals = current_labels_cell.values
    if nuclear_counts and mask_type == "whole_cell":
        current_labels_nuc = load_utils.load_imgs_from_dir(
            data_dir=segmentation_dir,
            files=[fov_name + "_nuclear.tiff"],
            xr_dim_name="compartments", xr_channel_names=["nuclear"],
            trim_suffix="_nuclear")
        compartments = ["whole_cell", "nuclear"]
        seg_vals = np.concatenate(
            (current_labels_cell.values, current_labels_nuc.values),
            axis=-1)
    return mask_type, DataArray(
        seg_vals,
        coords={"fovs": list(current_labels_cell.coords["fovs"]),
                "rows": current_labels_cell.coords["rows"],
                "cols": current_labels_cell.coords["cols"],
                "compartments": compartments})


def _load_part(part_path):
    """A checkpoint part this program wrote, or None when it cannot be read
    (a corrupted part is extracted again)."""
    import pickle

    try:
        return pd.read_pickle(part_path)
    except (OSError, EOFError, pickle.UnpicklingError, ValueError,
            AttributeError, ImportError, IndexError, TypeError):
        return None


def _fov_input_identity(fov_name, segmentation_dir, tiff_dir, img_sub_folder,
                        mask_types, add_underscore, nuclear_counts):
    """(size, mtime_ns) of every input file this FOV's extraction reads,
    stored in the FOV's part and compared on resume, so that regenerated
    masks or channel images invalidate exactly that FOV. A missing file
    records None."""
    paths = []
    for mask_type in mask_types:
        suff = None if mask_type is None else (
            "_" + mask_type if add_underscore else mask_type)
        paths.append(os.path.join(
            segmentation_dir,
            (fov_name + suff + ".tiff") if suff else fov_name + ".tiff"))
    if nuclear_counts and "whole_cell" in mask_types:
        paths.append(os.path.join(segmentation_dir,
                                  fov_name + "_nuclear.tiff"))
    chan_dir = os.path.join(tiff_dir, fov_name, img_sub_folder or "")
    if os.path.isdir(chan_dir):
        paths.extend(os.path.join(chan_dir, f)
                     for f in sorted(os.listdir(chan_dir)))
    ident = {}
    for p in paths:
        try:
            st = os.stat(p)
            ident[os.path.basename(p)] = (st.st_size, st.st_mtime_ns)
        except OSError:
            ident[os.path.basename(p)] = None
    return ident


def _reconcile_quant_checkpoint(checkpoint_dir, params):
    """Create or validate the cell-table checkpoint dir: parts written under
    other extraction settings are stale, so they are removed and the
    manifest rewritten; a resumed run never mixes configurations."""
    import json

    os.makedirs(checkpoint_dir, exist_ok=True)
    manifest_path = os.path.join(checkpoint_dir, "quant_manifest.json")
    manifest = json.dumps(params, sort_keys=True, default=repr)
    existing = None
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path) as f:
                existing = f.read()
        except OSError:
            pass
    if existing != manifest:
        if existing is not None:
            print("Cell-table extraction settings changed: discarding "
                  "checkpointed FOV parts")
        for f in os.listdir(checkpoint_dir):
            if f.endswith(".quant.pkl") or f.endswith(".tmp"):
                os.remove(os.path.join(checkpoint_dir, f))
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(manifest)
        os.replace(tmp, manifest_path)


def get_existing_mask_types(fov_names: List[str],
                            mask_names: List[str]) -> List[str]:
    """Unique mask-type suffixes present for the given FOVs; each mask binds
    to its longest matching FOV prefix."""
    stripped = io_utils.remove_file_extensions(mask_names)
    result = []
    for item in stripped:
        best = max((p for p in fov_names
                    if item == p or item.startswith(p + "_")),
                   key=len, default=None)
        if best is not None and item != best:
            result.append(item[len(best) + 1:])
    return sorted(set(result))
