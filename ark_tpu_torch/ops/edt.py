"""Exact Euclidean distance transform in torch ops.

Port of ``ark_tpu/ops/edt.py`` (the fiber pipeline's distance to the nearest
background pixel; exact, not chamfer), by the same separable decomposition:

  pass 1:  g[i, j]   = min_{i': bg[i', j]} |i - i'|      (per-column 1-D EDT)
  pass 2:  dt2[i, j] = min_{j'} ( g[i, j']^2 + (j - j')^2 )

Pass 1 is a cummax of the background rows' indices and a flipped cummin.
Pass 2 is the direct min-plus over source columns, 256 at a time. In eager
torch its (rows, W, 256) int32 candidate block is real memory, 1 GiB at
1024^2, so the rows go in chunks that keep it under ``PASS2_BYTES``.

All distance arithmetic is int32 (squared distances reach 2 * 4096^2, past
f32's exact integers), and a min over integers does not depend on its
grouping: the squared transform is bitwise equal on every device, in any
chunking, and to the JAX package's and scipy's. The root is the correctly
rounded one of ``distances._sqrt`` (torch's own CPU sqrt is not). Pixels of
an image with no background at all get +inf.
"""

from __future__ import annotations

import numpy as np
import torch

from ark_tpu_torch.ops.distances import _sqrt

# larger than any real distance in a 16k x 16k image, and SENTINEL^2 plus any
# real squared offset stays inside int32
_SENTINEL = 1 << 15
_BLOCK = 256
# the most one pass-2 candidate block may take: 64 rows at W = 1024
PASS2_BYTES = 64 * 2 ** 20


def _column_pass(fg: torch.Tensor) -> torch.Tensor:
    """Per-column vertical distance to the nearest background pixel (int32,
    _SENTINEL where the column has no background)."""
    h = fg.shape[0]
    idx = torch.arange(h, dtype=torch.int32, device=fg.device)[:, None]
    bg = ~fg
    last_zero = torch.cummax(torch.where(bg, idx, -_SENTINEL), dim=0).values
    next_zero = torch.cummin(torch.where(bg, idx, 2 * _SENTINEL).flip(0),
                             dim=0).values.flip(0)
    down = torch.clamp_max(idx - last_zero, _SENTINEL)
    up = torch.clamp_max(next_zero - idx, _SENTINEL)
    return torch.minimum(down, up)


def _edt2_int(fg: torch.Tensor, block: int = _BLOCK,
              pass2_bytes: int = PASS2_BYTES) -> torch.Tensor:
    """Squared EDT as int32, on `fg`'s device; fg is a bool (H, W)
    foreground mask. _SENTINEL^2 where no background is in reach."""
    h, w = fg.shape
    g = _column_pass(fg)
    g2 = g * g                                                  # (H, W) int32
    cols = torch.arange(w, dtype=torch.int32, device=fg.device)
    out = torch.full((h, w), _SENTINEL * _SENTINEL, dtype=torch.int32,
                     device=fg.device)
    rows = max(1, pass2_bytes // (4 * w * min(block, w)))
    for s in range(0, w, block):
        d = cols[:, None] - cols[None, s:s + block]             # (W, B)
        d2 = d * d
        for r in range(0, h, rows):
            # the (R, W, B) candidates are freed before the next step's are made
            best = (g2[r:r + rows, None, s:s + block] + d2[None]).amin(dim=2)
            torch.minimum(out[r:r + rows], best, out=out[r:r + rows])
    return out


def _foreground(image, device) -> torch.Tensor:
    """`image` (array or tensor) as a bool tensor on `device`: nonzero is
    foreground."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image))
    image = image.to(device)
    return image if image.dtype == torch.bool else image != 0


def distance_transform_edt(image, *, device="cuda") -> torch.Tensor:
    """Exact Euclidean distance to the nearest zero/False pixel of a 2-D
    image (scipy.ndimage.distance_transform_edt semantics), as an f32
    tensor on `device`.

    Pixels in an image with no background at all get +inf rather than
    scipy's phantom-corner artifact."""
    fg = _foreground(image, device)
    if fg.ndim != 2:
        raise ValueError(f"expected a 2-D image, got shape {tuple(fg.shape)}")
    d2 = _edt2_int(fg)
    dist = _sqrt(d2.to(torch.float32))
    return torch.where(d2 >= _SENTINEL * _SENTINEL, float("inf"), dist)
