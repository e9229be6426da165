"""Single-sweep pixie pixel stage on an explicit torch device.

Port of ``ark_tpu/phenotyping/pixie_fused.py``. ``run_pixel_clustering``
produces the artifact set of the multi-pass chain (``create_pixel_matrix`` ->
``train_pixel_som`` -> ``cluster_pixels`` -> ``generate_som_avg_files`` ->
``pixel_consensus_cluster`` -> ``generate_meta_avg_files``) bit for bit, from
one TIFF load, one device round trip of the pixel matrix and one full
feather write per FOV, with the cohort's working set held on the device
between the cohort barriers (channel norms -> pixel threshold -> trained SOM
-> consensus):

  stats     one TIFF load + one upload per FOV; per-channel percentiles
            come back as scalars and the raw stack stays on the device.
  sweep     per FOV, from the resident raw image: the q05 threshold
            statistic and the blurred/row-normalized matrix.
  subset    per FOV: validity mask, the seeded training subset and the
            per-FOV 99.9% quantile from two exact order statistics per
            channel (``_fov_quantiles``).
  train     ``pixel_som_clustering.train_pixel_som`` on the device.
  assign    per FOV, depth 2: FOV i+1's valid rows stream to the host while
            FOV i's host divide runs, and FOV i's BMU kernel runs while FOV
            i-1's labels are collected. Results stay in a byte-budgeted
            host store until consensus.
  avgs+meta the averaging/consensus functions of template 2, fed the
            RAM-resident frames; each FOV's feather is then written once.

FOVs past the device budget spill to a disk stash (.npy + .npz), and FOVs
past the host budget take the write-now-append-meta-later path; outputs are
identical either way. A device-to-host copy is a pinned ``non_blocking`` copy
with a CUDA event (``_HostCopy``).

Host IO is the port's ``ark_tpu_torch.io``, which imports imageio only
inside the functions that read or write TIFFs, and sklearn is imported only
by consensus clustering, so the device phases import, and run, on a GPU host
without the TIFF and sklearn stack.
"""

from __future__ import annotations

import os
import time
import zipfile
from shutil import rmtree

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.io import io_utils
from ark_tpu_torch.io import load_utils
from ark_tpu_torch.io.image_utils import read_image
from ark_tpu_torch.ops import quantiles
from ark_tpu_torch.ops import som as som_ops
from ark_tpu_torch.phenotyping import pixie_preprocessing
from ark_tpu_torch.utils.misc_utils import verify_in_list

_DEFAULT_HBM_CACHE_BYTES = 8 << 30
# RAM-deferred write budget: normalized f64 matrices held on host between
# SOM assignment and consensus so each FOV's feather is written exactly once
_DEFAULT_HOST_CACHE_BYTES = 16 << 30


class _HbmCohortCache:
    """Byte-budgeted fov -> device-tensor cache: the cohort's working set
    lives on the device between pipeline barriers. ``put`` refuses (returns
    False) past the budget; the caller spills that FOV to the disk stash."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.used = 0
        self._store = {}

    def put(self, key, arrs) -> bool:
        # budget the run's device tensors only: ("raw", fov) entries carry
        # the host numpy mirror alongside the device tensor
        nb = sum(a.numel() * a.element_size() for a in arrs
                 if isinstance(a, torch.Tensor))
        if self.used + nb > self.budget:
            return False
        self._store[key] = (arrs, nb)
        self.used += nb
        return True

    def get(self, key):
        got = self._store.get(key)
        return got[0] if got is not None else None

    def pop(self, key):
        got = self._store.pop(key, None)
        if got is None:
            return None
        arrs, nb = got
        self.used -= nb
        return arrs


class _HostCopy:
    """A device-to-host copy in flight: a pinned ``non_blocking`` copy and a
    CUDA event recorded after it, so ``numpy()`` waits for this copy and not
    for work queued later. A CPU tensor is its own host copy."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cpu":
            self._host = t
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _channel_percentiles_device(img: torch.Tensor, percentile: float):
    """Per-channel nonzero quantile + has-positive of an (H, W, C) image.
    Equals per-channel ``quantiles.nonzero_quantile(img[..., c], q)`` calls
    bitwise (the multi-pass ``calculate_channel_percentiles`` path)."""
    cols = img.reshape(-1, img.shape[-1])
    positive = cols > 0
    vals = quantiles.nanquantile(torch.where(positive, cols, float("nan")),
                                 percentile)
    return vals, torch.any(positive, dim=0)


def _prep_fov_parts(img: torch.Tensor, blur_factor: int = 2):
    """Threshold-independent per-FOV preprocess: the multi-pass
    ``_prep_fov_device`` minus the valid mask, which needs the cohort
    threshold. img: (H, W, C) channel-normalized. Returns (norm, rowsums,
    anynz)."""
    return pixie_preprocessing._prep_fov_parts_inner(img, blur_factor)


def _intensity_q05_async(img_norm_dev: torch.Tensor) -> _HostCopy:
    """q05 of channel-normalized total signal, the per-FOV statistic of
    ``calculate_pixel_intensity_percentile``, from the device-resident image
    (the same torch ops, so bitwise-equal to the multi-pass path). Returns
    its host copy in flight: the caller collects the q05s after the sweep."""
    summed = torch.sum(img_norm_dev, dim=-1)
    return _HostCopy(quantiles.quantile(summed, 0.05))


def _valid_mask_device(rowsums: torch.Tensor, anynz: torch.Tensor,
                       thresh: float) -> torch.Tensor:
    return (rowsums > float(np.float32(thresh))) & anynz


def _quantile_stats_device(norm_keep: torch.Tensor):
    """Per-column (sorted nonzero values ascending, nonzero count): zeros are
    pushed past every real value with +inf so the first ``count`` entries of
    each sorted column are exactly the nonzero order statistics (norm values
    are nonnegative)."""
    masked = torch.where(norm_keep == 0, float("inf"), norm_keep)
    return torch.sort(masked, dim=0).values, torch.sum(norm_keep != 0, dim=0)


def _fov_quantiles(sorted_cols, counts, n_rows, q):
    """Per-channel value of pandas ``frame.replace(0, nan).quantile(q)``
    from two order statistics per column, exact by construction.

    pandas routes the frame through two numpy paths: with any NaN present
    it runs ``np.quantile`` per column on the f32 non-NaN values and casts
    the results back to f32; with no NaN it runs one f64-returning
    ``np.quantile(values, qs, axis=1)`` over the 2-D f32 block. Linear
    interpolation touches only the two order statistics bracketing
    ``q*(n-1)``, so a surrogate column of the same length filled with those
    two values reproduces each path bit for bit.

    sorted_cols: accessor f(lo_rows, hi_rows) -> (a_lo (C,), a_hi (C,))
    exact f32 order statistics of each column's nonzero values;
    counts: (C,) nonzero counts; n_rows: rows in the frame.
    """
    counts = np.asarray(counts, np.int64)
    if n_rows == 0:
        # empty frame: pandas .quantile returns NaN per column
        return np.full(len(counts), np.nan, np.float32)
    nan_present = bool((counts < n_rows).any())
    lo_rows = np.zeros(len(counts), np.int64)
    hi_rows = np.zeros(len(counts), np.int64)
    for ci, nn in enumerate(counts):
        if nn == 0:
            continue
        pos = np.float64(q) * (int(nn) - 1)
        lo = int(np.floor(pos))
        lo_rows[ci] = lo
        hi_rows[ci] = min(lo + 1, int(nn) - 1)
    a_lo, a_hi = sorted_cols(lo_rows, hi_rows)

    def surrogate(ci):
        nn = int(counts[ci])
        col = np.empty(nn, np.float32)
        col[:lo_rows[ci] + 1] = a_lo[ci]
        col[lo_rows[ci] + 1:] = a_hi[ci]
        return col

    if nan_present:
        out = []
        for ci, nn in enumerate(counts):
            if nn == 0:
                out.append(np.nan)   # all-NaN column -> NaN (f32 cast below)
            else:
                out.append(np.quantile(surrogate(ci),
                                       np.asarray([q], np.float64))[0])
        return np.asarray(out, np.float32)
    block = np.stack([surrogate(ci) for ci in range(len(counts))])
    return np.quantile(block, np.asarray([q], np.float64), axis=1)[0]


def _load_fov_raw(tiff_dir, fov, channels, img_sub_folder, is_mibitiff,
                  seg_dir, seg_suffix):
    """One TIFF-tree load per FOV: (H, W, C) f32 in the given channel order
    plus the segmentation labels (or None)."""
    if is_mibitiff:
        img_xr = load_utils.load_imgs_from_mibitiff(
            tiff_dir, mibitiff_files=[fov + ".tiff"])
    else:
        img_xr = load_utils.load_imgs_from_tree(
            tiff_dir, img_sub_folder=img_sub_folder, fovs=[fov])
    verify_in_list(provided_chans=channels,
                   pixel_mat_chans=list(img_xr.coords["channels"]))
    seg_labels = None
    if seg_dir is not None:
        seg_labels = read_image(os.path.join(seg_dir, fov + seg_suffix))
    raw = img_xr.sel(fovs=fov, channels=channels).values.astype(np.float32)
    return raw, seg_labels


def _stash_path(cache_dir, fov):
    return os.path.join(cache_dir, fov + ".stash.npz")


def _norm_path(cache_dir, fov):
    return os.path.join(cache_dir, fov + ".norm.npy")


def _atomic_npz(path, **arrays):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _atomic_npy(path, array):
    tmp = path + ".tmp.npy"
    np.save(tmp, array)
    os.replace(tmp, path)


def _data_feather_has_som(data_path, fov):
    """True if the FOV's data feather exists and carries the SOM column (the
    corrupt/missing policy is `pixel_cluster_utils._file_missing_col`'s)."""
    from ark_tpu_torch.phenotyping import pixel_cluster_utils

    p = os.path.join(data_path, fov + ".feather")
    return os.path.exists(p) and not pixel_cluster_utils._file_missing_col(
        p, "pixel_som_cluster")


def run_pixel_clustering(fovs, channels, base_dir, tiff_dir, seg_dir=None,
                         img_sub_folder="TIFs",
                         seg_suffix="_whole_cell.tiff",
                         pixel_output_dir="pixel_output_dir",
                         data_dir="pixel_mat_data",
                         subset_dir="pixel_mat_subsetted",
                         norm_vals_name_pre_rownorm="channel_norm_pre_rownorm.feather",
                         norm_vals_name_post_rownorm="channel_norm_post_rownorm.feather",
                         pixel_thresh_name="pixel_thresh.feather",
                         channel_percentile_pre_rownorm=0.99,
                         channel_percentile_post_rownorm=0.999,
                         is_mibitiff=False, blur_factor=2,
                         subset_proportion=0.1, seed=42, max_k=20, cap=3,
                         xdim=10, ydim=10, lr_start=0.05, lr_end=0.01,
                         num_passes=1,
                         som_weights_name="pixel_som_weights.feather",
                         pc_chan_avg_som_cluster_name="pixel_channel_avg_som_cluster.csv",
                         pc_chan_avg_meta_cluster_name="pixel_channel_avg_meta_cluster.csv",
                         num_fovs_subset=100, keep_cache=False,
                         hbm_cache_bytes=_DEFAULT_HBM_CACHE_BYTES,
                         host_cache_bytes=_DEFAULT_HOST_CACHE_BYTES,
                         timings=None, device="cuda"):
    """Preprocess + SOM-cluster + meta-cluster the pixel cohort in one sweep
    on `device`.

    Produces the exact artifact set of the multi-pass chain (template 2
    steps 1-3) with one TIFF load, one device round trip of the pixel
    matrix, and one full-feather write per FOV. Returns (pixel_pysom,
    pixel_cc) like the individual steps do.

    ``hbm_cache_bytes`` bounds the device-resident cohort working set;
    FOVs past it spill to a disk stash. ``timings``: optional dict that
    per-phase wall seconds are accumulated into.
    """
    import pyarrow as pa

    from ark_tpu_torch.phenotyping import (pixel_cluster_utils,
                                           pixel_meta_clustering,
                                           pixel_som_clustering)

    t_phase = time.perf_counter
    if timings is None:
        timings = {}

    def _mark(name, t0):
        timings[name] = round(timings.get(name, 0.0) + t_phase() - t0, 3)

    channels = io_utils.natsorted(channels)
    if subset_proportion <= 0 or subset_proportion > 1:
        raise ValueError("Invalid subset percentage entered: must be in (0, 1]")
    io_utils.validate_paths([base_dir, tiff_dir])
    os.makedirs(os.path.join(base_dir, pixel_output_dir), exist_ok=True)
    data_path = os.path.join(base_dir, data_dir)
    subset_path = os.path.join(base_dir, subset_dir)
    os.makedirs(data_path, exist_ok=True)
    os.makedirs(subset_path, exist_ok=True)
    cache_dir = os.path.join(base_dir, pixel_output_dir, "_fused_cache")
    os.makedirs(cache_dir, exist_ok=True)
    hbm = _HbmCohortCache(hbm_cache_bytes)

    channel_norm_pre_path = os.path.join(base_dir, pixel_output_dir,
                                         norm_vals_name_pre_rownorm)
    pixel_thresh_path = os.path.join(base_dir, pixel_output_dir,
                                     pixel_thresh_name)
    norm_post_path = os.path.join(base_dir, norm_vals_name_post_rownorm)
    quantile_path = os.path.join(base_dir, data_dir,
                                 "channel_norm_post_rownorm_perfov.csv")

    # channel-set change invalidates the whole cohort (reference :281-297)
    if os.path.exists(channel_norm_pre_path):
        prev = feather.read_dataframe(channel_norm_pre_path)
        if set(prev.columns.values) != set(channels):
            print("New channels provided: overwriting whole cohort")
            for d in (data_path, subset_path, cache_dir):
                rmtree(d)
                os.mkdir(d)
            os.remove(channel_norm_pre_path)
            if os.path.exists(pixel_thresh_path):
                os.remove(pixel_thresh_path)

    pixel_cluster_utils.check_for_modified_channels(
        tiff_dir=tiff_dir, test_fov=fovs[0], img_sub_folder=img_sub_folder,
        channels=channels)

    need_channel_norm = not os.path.exists(channel_norm_pre_path)
    need_thresh = not os.path.exists(pixel_thresh_path)
    channel_norm_df = None if need_channel_norm \
        else feather.read_dataframe(channel_norm_pre_path)

    def fov_complete(fov):
        return (os.path.exists(os.path.join(subset_path, fov + ".feather"))
                and _data_feather_has_som(data_path, fov))

    fov_shapes = {}

    def _upload_raw(fov):
        raw, _ = _load_fov_raw(tiff_dir, fov, channels, img_sub_folder,
                               is_mibitiff, None, seg_suffix)
        fov_shapes[fov] = raw.shape[:2]
        return raw, torch.as_tensor(raw, device=device)

    # ---- phase: cohort channel percentiles (raw stays resident) ----
    _t0 = t_phase()
    if need_channel_norm:
        # per-FOV per-channel nonzero quantiles; FOVs without positive
        # pixels for a channel are excluded from that channel's mean.
        # Depth 2: FOV i's scalars are collected one iteration late, while
        # FOV i+1's TIFF decodes on the host.
        per_fov_vals, per_fov_haspos = [], []

        def _collect_stats(entry):
            vals_c, haspos_c = entry
            per_fov_vals.append([float(v) for v in vals_c.numpy()])
            per_fov_haspos.append(haspos_c.numpy())

        stats_inflight = None
        for fov in fovs:
            raw, dev = _upload_raw(fov)
            vals, haspos = _channel_percentiles_device(
                dev, channel_percentile_pre_rownorm)
            if not fov_complete(fov):
                hbm.put(("raw", fov), (dev, raw))
            if stats_inflight is not None:
                _collect_stats(stats_inflight)
            stats_inflight = (_HostCopy(vals), _HostCopy(haspos))
        if stats_inflight is not None:
            _collect_stats(stats_inflight)
        means = []
        for ci in range(len(channels)):
            vs = [per_fov_vals[fi][ci] for fi in range(len(fovs))
                  if per_fov_haspos[fi][ci]]
            means.append(np.mean(vs))
        channel_norm_df = pd.DataFrame(np.expand_dims(means, 0),
                                       columns=channels)
        channel_norm_df = channel_norm_df[
            io_utils.natsorted(channel_norm_df.columns)]
        feather.write_dataframe(channel_norm_df, channel_norm_pre_path,
                                compression="uncompressed")
    _mark("chan_percentiles_s", _t0)

    # two normalization vectors, matching the multi-pass path exactly: the
    # q05 statistic divides in f32 on the device while preprocessing divides
    # in f64 on the host then casts
    norm_vect_f64 = channel_norm_df.iloc[0].values.reshape(1, 1, -1)
    norm_vect_f32 = torch.as_tensor(
        channel_norm_df.iloc[0].values.astype(np.float32), device=device)

    def _prep_resident(fov, raw_host):
        """raw -> (norm, rowsums, anynz), cached on the device or spilled."""
        dev_prep = torch.as_tensor(pixie_preprocessing.channel_norm_divide(
            raw_host, norm_vect_f64), device=device)
        norm, rowsums, anynz = _prep_fov_parts(dev_prep,
                                               blur_factor=blur_factor)
        if hbm.put(("norm", fov), (norm, rowsums, anynz)):
            return True
        _atomic_npy(_norm_path(cache_dir, fov), norm.cpu().numpy())
        _atomic_npz(_stash_path(cache_dir, fov),
                    rowsums=rowsums.cpu().numpy(),
                    anynz=anynz.cpu().numpy(),
                    shape=np.array(raw_host.shape[:2]))
        return False

    # ---- phase: norm-matrix sweep (q05 rides along while the threshold
    # artifact is still missing) ----
    _t0 = t_phase()
    q05s = {}
    for fov in fovs:
        done = fov_complete(fov)
        has_state = (hbm.get(("norm", fov)) is not None
                     or (os.path.exists(_stash_path(cache_dir, fov))
                         and os.path.exists(_norm_path(cache_dir, fov))))
        if (done or has_state) and not need_thresh:
            hbm.pop(("raw", fov))
            continue
        raw_res = hbm.pop(("raw", fov))
        raw_dev, raw_host = raw_res if raw_res else (None, None)
        if need_thresh:
            if raw_dev is None:
                raw_host, raw_dev = _upload_raw(fov)
            q05s[fov] = _intensity_q05_async(raw_dev / norm_vect_f32)
        if not (done or has_state):
            if raw_host is None:
                raw_host, raw_dev = _upload_raw(fov)
            _prep_resident(fov, raw_host)
        del raw_dev, raw_host
    q05s = {f: float(q.numpy()) for f, q in q05s.items()}
    _mark("norm_sweep_s", _t0)

    if need_thresh:
        pixel_thresh_val = float(np.mean([q05s[f] for f in fovs]))
        feather.write_dataframe(
            pd.DataFrame({"pixel_thresh_val": [pixel_thresh_val]}),
            pixel_thresh_path, compression="uncompressed")
    else:
        pixel_thresh_val = feather.read_dataframe(
            pixel_thresh_path)["pixel_thresh_val"].values[0]

    def _get_fov_state(fov):
        """(norm_keep_dev or None, norm_keep_host or None, keep, width).
        Resident path: the cache's full norm is replaced by its valid-row
        gather (the host sees only the mask); spilled path: mmap gather on
        the host. Regenerates from TIFFs if neither source exists."""
        got = hbm.get(("norm_keep", fov))
        if got is not None:
            return got[0], None, got[1], fov_shapes[fov][1]
        res = hbm.pop(("norm", fov))
        if res is not None:
            norm_dev, rowsums, anynz = res
            mask = _valid_mask_device(rowsums, anynz,
                                      pixel_thresh_val).cpu().numpy()
            keep = np.flatnonzero(mask)
            norm_keep = norm_dev[torch.as_tensor(keep, device=device)]
            hbm.put(("norm_keep", fov), (norm_keep, keep))
            return norm_keep, None, keep, fov_shapes[fov][1]
        # disk stash / regeneration path
        norm = rowsums = anynz = w = None
        if (os.path.exists(_stash_path(cache_dir, fov))
                and os.path.exists(_norm_path(cache_dir, fov))):
            try:
                z = np.load(_stash_path(cache_dir, fov))
                rowsums, anynz = z["rowsums"], z["anynz"]
                w = int(z["shape"][1])
                norm = np.load(_norm_path(cache_dir, fov), mmap_mode="r")
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile):
                norm = None   # unreadable stash: regenerate from the TIFFs
        if norm is None:
            raw, _ = _load_fov_raw(tiff_dir, fov, channels, img_sub_folder,
                                   is_mibitiff, None, seg_suffix)
            w = raw.shape[1]
            dn, dr, da = _prep_fov_parts(
                torch.as_tensor(pixie_preprocessing.channel_norm_divide(
                    raw, norm_vect_f64), device=device),
                blur_factor=blur_factor)
            norm, rowsums, anynz = (dn.cpu().numpy(), dr.cpu().numpy(),
                                    da.cpu().numpy())
        valid = (rowsums > np.float32(pixel_thresh_val)) & anynz
        keep = np.flatnonzero(valid)
        return None, norm[keep], keep, w

    # ---- phase: per-FOV subset + 99.9% quantile ----
    _t0 = t_phase()
    quant_dat_all = pd.read_csv(quantile_path, index_col="channel") \
        if os.path.exists(quantile_path) else pd.DataFrame()
    wrote_quant = False
    # valid-pixel label values gathered here are reused by the assign phase
    # so each segmentation TIFF is decoded once per run
    seg_keep_cache = {}
    for fov in fovs:
        sub_file = os.path.join(subset_path, fov + ".feather")
        if os.path.exists(sub_file) and fov in quant_dat_all.columns:
            continue
        seg_labels = None if seg_dir is None else read_image(
            os.path.join(seg_dir, fov + seg_suffix))
        norm_keep_dev, norm_keep_host, keep, w = _get_fov_state(fov)
        if seg_labels is not None:
            seg_keep_cache[fov] = seg_labels.ravel()[keep]

        # subset: same draw as `pixel_mat.sample(frac=...)` after
        # np.random.seed(seed)
        np.random.seed(seed)
        n_sub = int(round(subset_proportion * len(keep)))
        locs = np.random.choice(len(keep), size=n_sub, replace=False)
        if norm_keep_dev is not None:
            sub_vals = norm_keep_dev[torch.as_tensor(locs, device=device)
                                     ].cpu().numpy()
        else:
            sub_vals = norm_keep_host[locs]
        sub_df = pd.DataFrame(sub_vals, columns=channels,
                              index=locs.astype(np.int64))
        sub_df["fov"] = fov
        sub_df["row_index"] = (keep[locs] // w).astype(np.int64)
        sub_df["column_index"] = (keep[locs] % w).astype(np.int64)
        if seg_labels is not None:
            sub_df["label"] = seg_keep_cache[fov][locs]
        feather.write_dataframe(sub_df, sub_file, compression="uncompressed")

        # per-FOV 99.9% nonzero quantile, exact pandas
        # `.replace(0, nan).quantile(q)` semantics per column
        if norm_keep_dev is not None:
            sorted_dev, counts_dev = _quantile_stats_device(norm_keep_dev)
            counts = counts_dev.cpu().numpy()

            def sorted_cols(lo_rows, hi_rows, _s=sorted_dev):
                rows = torch.as_tensor(np.stack([lo_rows, hi_rows]),
                                       device=device)
                picked = torch.gather(_s, 0, rows).cpu().numpy()   # (2, C)
                return picked[0], picked[1]
        else:
            nz_sorted = [np.sort(norm_keep_host[:, ci]
                                 [norm_keep_host[:, ci] != 0])
                         for ci in range(len(channels))]
            counts = np.asarray([len(z) for z in nz_sorted])

            def sorted_cols(lo_rows, hi_rows, _z=nz_sorted):
                a_lo = np.asarray([z[i] if len(z) else np.float32(np.nan)
                                   for z, i in zip(_z, lo_rows)])
                a_hi = np.asarray([z[i] if len(z) else np.float32(np.nan)
                                   for z, i in zip(_z, hi_rows)])
                return a_lo, a_hi

        qvals = _fov_quantiles(sorted_cols, counts, len(keep),
                               channel_percentile_post_rownorm)
        quant_fov = pd.Series(qvals, index=pd.Index(channels, name="channel"),
                              name=fov)
        if fov in quant_dat_all.columns:
            quant_dat_all = quant_dat_all.drop(columns=[fov])
        quant_dat_all = quant_dat_all.merge(quant_fov, how="outer",
                                            left_index=True, right_index=True)
        quant_dat_all.to_csv(quantile_path)
        wrote_quant = True

    if wrote_quant or not os.path.exists(norm_post_path):
        mean_quant = pd.DataFrame(quant_dat_all.mean(axis=1))
        mean_quant = mean_quant.reindex(io_utils.natsorted(mean_quant.index))
        feather.write_dataframe(mean_quant.T, norm_post_path,
                                compression="uncompressed")
    _mark("subset_quantile_s", _t0)

    # ---- phase: SOM training ----
    _t0 = t_phase()
    pixel_pysom = pixel_som_clustering.train_pixel_som(
        fovs, channels, base_dir, subset_dir=subset_dir,
        norm_vals_name=norm_vals_name_post_rownorm,
        som_weights_name=som_weights_name, xdim=xdim, ydim=ydim,
        lr_start=lr_start, lr_end=lr_end, num_passes=num_passes, seed=seed,
        device=device)
    _mark("som_train_s", _t0)

    # ---- phase: per-FOV assignment + single full-feather write ----
    _t0 = t_phase()
    weights_cols = list(pixel_pysom.weights.columns)
    weights_dev = som_ops.som_weights_from_numpy(pixel_pysom.weights.values,
                                                 device)
    # label-aligned like the multi-pass assign (`sub.div(norm_data.iloc[0],
    # axis=1)` aligns by column name)
    norm_vals_row = pixel_pysom.norm_data[channels].iloc[0].values  # f64
    if weights_cols != channels:
        raise ValueError(
            f"SOM weights columns {weights_cols} do not match the "
            f"natural-sorted channels {channels}; retrain or pass the "
            f"channel set the weights were trained on")
    print("Mapping pixel data to SOM cluster labels")
    todo = [f for f in fovs if not _data_feather_has_som(data_path, f)]
    for f in fovs:
        if f not in todo:
            hbm.pop(("norm", f))
            hbm.pop(("norm_keep", f))
    # Depth-2 software pipeline over the per-FOV chain
    #   d2h(norm_keep) -> f64 divide -> h2d + BMU -> labels d2h -> write
    # FOV i+1's valid-row matrix streams down while FOV i's host tail runs,
    # and FOV i's BMU runs while FOV i-1's labels are collected and stored.
    pending = {}

    def _start_readback(f):
        dev, host, keep_f, w_f = _get_fov_state(f)
        pending[f] = (_HostCopy(dev) if dev is not None else None, host,
                      keep_f, w_f)

    def _som_table(fov_p, normalized, labels, keep_p, w_p, seg_keep_p):
        """The FOV's full arrow table with the SOM column: the artifact
        layout the multi-pass chain produces after ``cluster_pixels``."""
        n = len(keep_p)
        cols = {c: pa.array(normalized[:, ci])
                for ci, c in enumerate(channels)}
        cols["fov"] = pa.array([fov_p], type=pa.large_string()).take(
            pa.array(np.zeros(n, np.int64)))
        cols["row_index"] = pa.array((keep_p // w_p).astype(np.int64))
        cols["column_index"] = pa.array((keep_p % w_p).astype(np.int64))
        if seg_keep_p is not None:
            cols["label"] = pa.array(seg_keep_p)
        # zero-valid-pixel FOV: the multi-pass chain's labels come from
        # `np.empty(0)` (float64), so the empty column is f64 too
        cols["pixel_som_cluster"] = pa.array(
            labels.astype(np.int32) if n else labels.astype(np.float64))
        return pa.table(cols)

    def _commit_table(fov_p, table):
        out_file = os.path.join(data_path, fov_p + ".feather")
        feather.write_table(table, out_file + ".tmp",
                            compression="uncompressed")
        os.replace(out_file + ".tmp", out_file)
        if not keep_cache:
            for leftover in (_stash_path(cache_dir, fov_p),
                             _norm_path(cache_dir, fov_p)):
                try:
                    os.remove(leftover)
                except FileNotFoundError:
                    pass

    # RAM-deferred write store: FOVs held here get their ONE feather write
    # after consensus, already carrying both label columns; past the byte
    # budget, FOVs take the write-now-append-meta-later path
    ram_store = {}
    ram_used = [0]

    def _flush(entry):
        """Read back the labels (waits for that FOV's BMU only); stash the
        FOV in the RAM store or commit its SOM-only feather now (spill)."""
        fov_p, labels_copy, normalized, keep_p, w_p, seg_p = entry
        labels = labels_copy.numpy() + 1   # 1-indexed, as som_map
        pixel_pysom.som_clusters_seen.update(list(np.unique(labels)))
        nb = (normalized.nbytes + labels.nbytes + keep_p.nbytes
              + (seg_p.nbytes if seg_p is not None else 0))
        if ram_used[0] + nb <= host_cache_bytes:
            ram_store[fov_p] = (normalized, labels, keep_p, w_p, seg_p)
            ram_used[0] += nb
            return
        _commit_table(fov_p, _som_table(fov_p, normalized, labels,
                                        keep_p, w_p, seg_p))

    if todo:
        _start_readback(todo[0])
    in_flight = None
    for i, fov in enumerate(todo):
        if i + 1 < len(todo):
            _start_readback(todo[i + 1])
        norm_keep_copy, norm_keep_host, keep, w = pending.pop(fov)
        # reuse the subset phase's gathered label values; a resumed run
        # whose subset feather already existed decodes the TIFF here
        seg_keep = seg_keep_cache.pop(fov, None)
        if seg_keep is None and seg_dir is not None:
            seg_keep = read_image(
                os.path.join(seg_dir, fov + seg_suffix)).ravel()[keep]
        _td = t_phase()
        if norm_keep_copy is not None:
            norm_keep_host = norm_keep_copy.numpy()    # ONE full readback
            hbm.pop(("norm_keep", fov))
        _mark("assign_d2h_wait_s", _td)
        # f64 norm-divide: bitwise-equal to the pandas upcast div the
        # multi-pass assignment applies (assign_som_clusters_table)
        normalized = np.empty(norm_keep_host.shape, np.float64)
        np.divide(norm_keep_host, norm_vals_row, out=normalized)
        # the BMU kernel runs while the PREVIOUS FOV is flushed below
        labels_dev = som_ops.som_map_async(
            weights_dev, normalized.astype(np.float32), device=device)
        entry = (fov, _HostCopy(labels_dev), normalized, keep, w, seg_keep)
        if in_flight is not None:
            _tf = t_phase()
            _flush(in_flight)
            _mark("assign_flush_s", _tf)
        in_flight = entry
    if in_flight is not None:
        _tf = t_phase()
        _flush(in_flight)
        _mark("assign_flush_s", _tf)
    _mark("assign_write_s", _t0)

    # ---- phase: averages + consensus + meta labels. RAM-held FOVs are
    # served to the averaging passes through `table_source` and get their
    # meta labels via the same `assign_consensus_labels_table` the per-FOV
    # consensus pass applies, then ONE feather write. ----
    ram_meta = {}

    def _ram_table(fov_t, cols_needed):
        e = ram_store.get(fov_t)
        if e is None:
            return None
        normalized, labels, _keep, _w, _seg = e
        data = {}
        for c in cols_needed:
            if c == "pixel_som_cluster":
                data[c] = labels
            elif c == "pixel_meta_cluster":
                data[c] = ram_meta[fov_t]
            else:
                data[c] = normalized[:, channels.index(c)]
        return pd.DataFrame(data)

    _t0 = t_phase()
    pixel_som_clustering.generate_som_avg_files(
        fovs, channels, base_dir, pixel_pysom, data_dir=data_dir,
        pc_chan_avg_som_cluster_name=pc_chan_avg_som_cluster_name,
        num_fovs_subset=num_fovs_subset, seed=seed, table_source=_ram_table)
    _mark("som_avg_s", _t0)
    # consensus over the avg table; the per-FOV meta fan-out inside only
    # sees spilled FOVs (RAM-held ones have no feather on disk yet)
    _t0 = t_phase()
    pixel_cc = pixel_meta_clustering.pixel_consensus_cluster(
        fovs, channels, base_dir, max_k=max_k, cap=cap, data_dir=data_dir,
        pc_chan_avg_som_cluster_name=pc_chan_avg_som_cluster_name, seed=seed)
    _mark("consensus_meta_assign_s", _t0)
    _t0 = t_phase()
    for fov in fovs:
        e = ram_store.get(fov)
        if e is None:
            continue
        normalized, labels, keep_f, w_f, seg_f = e
        table = pixel_cc.assign_consensus_labels_table(
            _som_table(fov, normalized, labels, keep_f, w_f, seg_f))
        ram_meta[fov] = table.column("pixel_meta_cluster").to_pandas()
        _commit_table(fov, table)
    _mark("final_write_s", _t0)
    _t0 = t_phase()
    pixel_meta_clustering.generate_meta_avg_files(
        fovs, channels, base_dir, pixel_cc, data_dir=data_dir,
        pc_chan_avg_som_cluster_name=pc_chan_avg_som_cluster_name,
        pc_chan_avg_meta_cluster_name=pc_chan_avg_meta_cluster_name,
        num_fovs_subset=num_fovs_subset, seed=seed, table_source=_ram_table)
    _mark("meta_avg_s", _t0)
    ram_store.clear()

    if not keep_cache:
        rmtree(cache_dir, ignore_errors=True)
    return pixel_pysom, pixel_cc
