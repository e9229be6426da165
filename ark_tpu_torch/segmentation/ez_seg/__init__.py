"""ez_seg: masks for non-cell objects and their merge with cell masks.
Port of ``ark_tpu/segmentation/ez_seg``."""

from ark_tpu_torch.segmentation.ez_seg import (composites,  # noqa: F401
                                         ez_object_segmentation,
                                         ez_seg_display, ez_seg_utils,
                                         merge_masks)
