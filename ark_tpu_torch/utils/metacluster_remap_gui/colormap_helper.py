"""Deterministic distinct colormaps + compact metacluster colormap dicts
(reference `src/ark/utils/metacluster_remap_gui/colormap_helper.py:10-120`)."""

from __future__ import annotations

import colorsys
import itertools

import matplotlib
import numpy as np
import pandas as pd

from ark_tpu_torch.io import io_utils
from ark_tpu_torch.utils.misc_utils import verify_in_list


def distinct_rgbs(n=33):
    """n visually distinct RGB tuples; deterministic and prefix-stable."""
    def infinite_hues():
        yield 0
        for k in itertools.count():
            i = 2 ** k  # zeno's dichotomy
            for j in range(1, i, 2):
                yield j / i

    def hue_to_hsvs(h):
        s = 6 / 10
        for v in [6 / 10, 9 / 10]:
            yield h, s, v

    hues = infinite_hues()
    hsvs = itertools.chain.from_iterable(hue_to_hsvs(hue) for hue in hues)
    rgbs = (colorsys.hsv_to_rgb(*hsv) for hsv in hsvs)
    return list(itertools.islice(rgbs, n))


def distinct_cmap(n=33):
    """n distinct colors as a matplotlib ListedColormap."""
    return matplotlib.colors.ListedColormap(distinct_rgbs(n))


def generate_meta_cluster_colormap_dict(meta_cluster_remap_path, cmap,
                                        cluster_type="pixel"):
    """(raw-id → color, renamed → color) dicts from a remap CSV + cmap."""
    verify_in_list(provided_cluster_type=[cluster_type],
                   valid_cluster_types=["pixel", "cell"])
    io_utils.validate_paths(meta_cluster_remap_path)
    remapping = pd.read_csv(meta_cluster_remap_path)
    verify_in_list(
        required_cols=[f"{cluster_type}_som_cluster",
                       f"{cluster_type}_meta_cluster",
                       f"{cluster_type}_meta_cluster_rename"],
        remapping_cols=remapping.columns.values)
    raw_colormap = {
        i: cmap(i - 1)
        for i in np.unique(remapping[f"{cluster_type}_meta_cluster"])}
    meta_id_to_name = dict(zip(
        remapping[f"{cluster_type}_meta_cluster"],
        remapping[f"{cluster_type}_meta_cluster_rename"]))
    renamed_colormap = {
        meta_id_to_name[meta_id]: color
        for meta_id, color in raw_colormap.items()}
    return raw_colormap, renamed_colormap
