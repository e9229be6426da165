"""Typed per-stage pipeline configs: a copy of ``ark_tpu/config.py``, so that
both packages read and write the same JSON.

The reference has no config system — every knob is a function kwarg set in a
notebook cell, with determinism via `seed=42` threaded through each stochastic
call (SURVEY.md §5). These dataclasses capture those defaults as the explicit
compatibility contract, give cohort runs one serializable description
(`to_json`/`from_json`), and keep every stage's kwargs in one place.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class SomConfig:
    """SOM grid/training parameters (reference `cluster_helpers.py:54-56`)."""
    xdim: int = 10
    ydim: int = 10
    num_passes: int = 1
    lr_start: float = 0.05
    lr_end: float = 0.01
    seed: int = 42


@dataclass
class PixelClusterConfig:
    """Pixie pixel pipeline (reference `pixie_preprocessing.py:188-198`,
    `pixel_som_clustering.py:16-21`, `pixel_meta_clustering.py:53-56`)."""
    channels: List[str] = field(default_factory=list)
    blur_factor: int = 2
    subset_proportion: float = 0.1
    channel_percentile_pre_rownorm: float = 0.99
    channel_percentile_post_rownorm: float = 0.999
    max_k: int = 20
    cap: float = 3.0
    num_fovs_subset: int = 100
    som: SomConfig = field(default_factory=SomConfig)
    seed: int = 42


@dataclass
class CellClusterConfig:
    """Pixie cell pipeline (reference `cell_som_clustering.py:8-11`,
    `cell_meta_clustering.py:10-11`)."""
    pixel_cluster_col: str = "pixel_meta_cluster_rename"
    max_k: int = 20
    cap: float = 3.0
    normalize: bool = True
    som: SomConfig = field(default_factory=SomConfig)
    seed: int = 42


@dataclass
class SegmentationConfig:
    """Mesmer segmentation + quantification (reference
    `deepcell_service_utils.py:95-98`, `marker_quantification.py:185-190`)."""
    nuc_channels: List[str] = field(default_factory=list)
    mem_channels: List[str] = field(default_factory=list)
    batch_size: int = 5                 # reference zip_size
    maxima_threshold: float = 0.1
    interior_threshold: float = 0.3
    min_cell_size: int = 15
    extraction: str = "total_intensity"
    nuclear_counts: bool = False
    fast_extraction: bool = False
    weights_path: Optional[str] = None


@dataclass
class SpatialConfig:
    """Spatial analysis (reference `neighborhood_analysis.py:16`,
    `spatial_analysis_utils.py:341`)."""
    distlim: float = 50
    dist_lim_enrichment: float = 100
    bootstrap_num: int = 100
    self_neighbor: bool = False
    min_k: int = 2
    max_k: int = 10
    seed: int = 42


@dataclass
class LdaConfig:
    """Spatial-LDA (reference `spLDA/processing.py:76-77,232`)."""
    featurization: str = "cluster"
    radius: int = 100
    train_frac: float = 0.75
    n_topics: int = 5
    difference_penalty: float = 0.25
    num_boots: int = 25
    seed: int = 42


@dataclass
class PipelineConfig:
    """Full-cohort run description."""
    fovs: List[str] = field(default_factory=list)
    base_dir: str = "."
    tiff_dir: str = "image_data"
    img_sub_folder: Optional[str] = None
    segmentation: SegmentationConfig = field(
        default_factory=SegmentationConfig)
    pixel: PixelClusterConfig = field(default_factory=PixelClusterConfig)
    cell: CellClusterConfig = field(default_factory=CellClusterConfig)
    spatial: SpatialConfig = field(default_factory=SpatialConfig)
    lda: LdaConfig = field(default_factory=LdaConfig)

    def to_json(self, path: Optional[str] = None) -> str:
        payload = json.dumps(dataclasses.asdict(self), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(payload)
        return payload

    @classmethod
    def from_json(cls, source: str) -> "PipelineConfig":
        """Load from a JSON string or file path."""
        try:
            data = json.loads(source)
        except (json.JSONDecodeError, ValueError):
            with open(source) as f:
                data = json.load(f)
        return cls(
            fovs=data.get("fovs", []),
            base_dir=data.get("base_dir", "."),
            tiff_dir=data.get("tiff_dir", "image_data"),
            img_sub_folder=data.get("img_sub_folder"),
            segmentation=SegmentationConfig(**data.get("segmentation", {})),
            pixel=_nested(PixelClusterConfig, data.get("pixel", {})),
            cell=_nested(CellClusterConfig, data.get("cell", {})),
            spatial=SpatialConfig(**data.get("spatial", {})),
            lda=LdaConfig(**data.get("lda", {})),
        )


def _nested(cls, data):
    data = dict(data)
    if "som" in data and isinstance(data["som"], dict):
        data["som"] = SomConfig(**data["som"])
    return cls(**data)
