"""Derived morphology features.

Port of ``ark_tpu/segmentation/regionprops_extraction.py``. The functions
keep the reference's per-cell ``(prop, **kwargs)`` signature and work on the
``RegionProp`` record that the quantification engine builds from the
segment-reduction outputs; ``nc_ratio`` works on the whole marker-counts
array. The convex-hull features use ``ark_tpu_torch.ops.convex``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ark_tpu_torch.ops import convex as convex_ops


@dataclass
class RegionProp:
    """The subset of skimage.regionprops attributes the features need."""
    label: int
    area: float
    centroid: Tuple[float, float]
    major_axis_length: float
    minor_axis_length: float
    perimeter: float
    equivalent_diameter: float
    eccentricity: float = 0.0
    convex_area: float = 0.0
    coords: Optional[np.ndarray] = None
    image: Optional[np.ndarray] = None          # bbox-cropped mask
    convex_image: Optional[np.ndarray] = None   # bbox-cropped hull raster
    bbox_origin: Tuple[int, int] = (0, 0)


def major_minor_axis_ratio(prop, **kwargs):
    """major axis length / minor axis length (NaN when minor is 0)."""
    if prop.minor_axis_length == 0:
        return float("nan")
    return prop.major_axis_length / prop.minor_axis_length


def perim_square_over_area(prop, **kwargs):
    """perimeter^2 / area."""
    return np.square(prop.perimeter) / prop.area


def major_axis_equiv_diam_ratio(prop, **kwargs):
    """major axis length / equivalent diameter."""
    return prop.major_axis_length / prop.equivalent_diameter


def convex_hull_resid(prop, **kwargs):
    """(convex area - area) / convex area."""
    return (prop.convex_area - prop.area) / prop.convex_area


def centroid_dif(prop, **kwargs):
    """Distance between the mask centroid and the convex-hull centroid,
    normalized by sqrt(area)."""
    cell_cy, cell_cx = np.nonzero(prop.image)
    cell_centroid = np.array([cell_cy.mean(), cell_cx.mean()])
    conv_cy, conv_cx = np.nonzero(prop.convex_image)
    convex_centroid = np.array([conv_cy.mean(), conv_cx.mean()])
    return float(np.linalg.norm(cell_centroid - convex_centroid)
                 / np.sqrt(prop.area))


def num_concavities(prop, **kwargs):
    """Count of meaningful concavities (hull-minus-mask components passing
    the area and compactness thresholds)."""
    return convex_ops.count_concavities(
        prop.image, prop.convex_image,
        small_concavity_minimum=kwargs.get("small_concavity_minimum", 10),
        max_compactness=kwargs.get("max_compactness", 60),
        large_concavity_minimum=kwargs.get("large_concavity_minimum", 150))


def nc_ratio(marker_counts, **kwargs):
    """nuclear area / whole-cell area, written into both compartments of the
    marker-counts array."""
    whole_cell_areas = marker_counts.sel(compartments="whole_cell",
                                         features="area").values
    nuclear_areas = marker_counts.sel(compartments="nuclear",
                                      features="area").values
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.nan_to_num(nuclear_areas / whole_cell_areas,
                              posinf=0, neginf=0)
    marker_counts.loc["nuclear", :, "nc_ratio"] = ratio
    marker_counts.loc["whole_cell", :, "nc_ratio"] = ratio
    return marker_counts


REGIONPROPS_FUNCTION = {
    "major_minor_axis_ratio": major_minor_axis_ratio,
    "perim_square_over_area": perim_square_over_area,
    "major_axis_equiv_diam_ratio": major_axis_equiv_diam_ratio,
    "convex_hull_resid": convex_hull_resid,
    "centroid_dif": centroid_dif,
    "num_concavities": num_concavities,
    "nc_ratio": nc_ratio,
}

# features that need the convex-hull geometry
CONVEX_PROPS = {"convex_hull_resid", "centroid_dif", "num_concavities"}
