"""Segment reductions over label images, in torch: the cell table's engine.

Port of ``ark_tpu/ops/segment_reduce.py``. Every per-cell quantity is a
segment reduction over the dense (H*W)-pixel arrays, keyed by the label
image; all of them go through one function, ``segment_sum``:

- on a CUDA tensor it launches the hand-written kernel in
  ``ark_tpu_torch/csrc/segment_sum.cu``, which adds each segment's pixels in
  ascending pixel order (a float ``index_add_`` on CUDA uses atomics, so its
  order, and the last bits of the cell table, would change from run to run).
  The kernel walks each segment's bounding box, which ``segment_plan``
  computes once per label image on the device; a caller that sums several
  value sets over one image builds the plan once and passes it to each sum;
- on a CPU tensor it runs ``segment_sum_plain``, ``index_add_``, a sequential
  scatter in the same order (a plan is checked against the call, then
  ignored).

Both give sums bitwise equal to the JAX package's CPU ``segment_sum``, row
0 included: segment 0 (the background of a label image, point 0 of UMAP's
edge sums) is summed like any other. Every public function takes
``background: bool = True``. One warp walking the background of a 1024^2
FOV is a serial chain of ~0.5M adds a column, milliseconds where the cells'
rows take tens of microseconds, so the callers that index by cell id and
never read row 0 (the cell table, the fiber table) pass ``background=False``:
row 0 of the sums is then zero on every device, the background row of
``centroids`` NaN and the one of the moment features that of an empty
segment. Rows 1: do not depend on it.

All functions take `num_segments` = max label + 1; tensors are on the
device the caller chose, and the results stay there.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ark_tpu_torch.ops import _kernels

_SQRT2 = 1.4142135623730951
_INT32_MAX = 2 ** 31 - 1
_EMPTY_BOX = (_INT32_MAX, -1, _INT32_MAX, -1)


def _row_width(labels: torch.Tensor) -> int:
    """Width of the rows the labels are laid out in: the last axis of an
    image, or the whole array for flat labels."""
    return labels.shape[-1] if labels.ndim >= 2 else max(labels.numel(), 1)


class SegmentPlan(NamedTuple):
    """What ``segment_sum`` needs to know about one label image, built once
    by ``segment_plan``: the labels' shape and device and `num_segments`
    (checked against every call), and on CUDA the int32 labels and each
    segment's bounding box (first row, last row, first column, last column;
    empty as (2^31-1, -1, 2^31-1, -1)). A CPU plan holds no tensors."""
    shape: Tuple[int, ...]
    num_segments: int
    device: torch.device
    labels: Optional[torch.Tensor] = None       # (N,) int32, CUDA only
    boxes: Optional[torch.Tensor] = None        # (num_segments, 4) int32, CUDA only


def segment_boxes_plain(labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Each segment's bounding box in torch ops: (num_segments, 4) int32 rows
    of (first row, last row, first column, last column) of the labels in
    [0, num_segments), laid out in rows of ``_row_width(labels)``; absent
    labels hold the empty box. The plan kernel's plain version."""
    flat = labels.reshape(-1).to(torch.int64)
    w = _row_width(labels)
    pos = torch.arange(flat.numel(), device=flat.device)
    keep = (flat >= 0) & (flat < num_segments)
    lab = flat[keep]
    rows, cols = (pos // w)[keep], (pos % w)[keep]
    out = []
    for vals, init, how in ((rows, _EMPTY_BOX[0], "amin"), (rows, -1, "amax"),
                            (cols, _EMPTY_BOX[2], "amin"), (cols, -1, "amax")):
        col = torch.full((num_segments,), init, dtype=torch.int64, device=flat.device)
        out.append(col.scatter_reduce_(0, lab, vals, how))
    return torch.stack(out, dim=1).to(torch.int32)


def _int32_labels(labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Flat contiguous int32 labels; an int64 label outside [0,
    num_segments) stays outside after the cast (clamped to -1 or
    num_segments first)."""
    if labels.dtype == torch.int64:
        labels = torch.clamp(labels, -1, num_segments)
    return labels.reshape(-1).to(torch.int32).contiguous()


def _check_labels(labels: torch.Tensor, num_segments: int, device=None) -> None:
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_sum: integer labels expected, got {labels.dtype}")
    if num_segments < 1 or num_segments > 2 ** 31 - 2:
        raise ValueError(f"segment_sum: num_segments {num_segments} out of range")
    if labels.numel() >= 2 ** 31:
        raise ValueError(f"segment_sum: {labels.numel()} pixels; the kernels index "
                         f"pixels with int32")
    if device is not None and labels.device != device:
        raise ValueError(f"segment_sum: labels on {labels.device}, values on {device}; "
                         f"the kernel takes both on one CUDA device")


def segment_plan(labels: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The plan of one label image ((H, W), or (N,) as one row) for
    ``segment_sum(..., plan=)``. On a CUDA tensor it launches the plan
    kernel (``ark_segment_plan_launch``: every segment's bounding box from
    integer atomics, order-independent) on the current stream without a
    host sync, and raises if the launch is refused; ``segment_plan.launches``
    counts those launches. On a CPU tensor it only records the shape and
    `num_segments`."""
    if labels.device.type == "cpu":
        return SegmentPlan(tuple(labels.shape), num_segments, labels.device)
    if labels.device.type != "cuda":
        raise ValueError(f"segment_plan: labels on {labels.device}; the kernel takes "
                         f"CUDA tensors")
    _check_labels(labels, num_segments)
    flat = _int32_labels(labels, num_segments)
    boxes = torch.empty((num_segments, 4), dtype=torch.int32, device=flat.device)
    lib = _kernels.lib("segment_sum")
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.ark_segment_plan_launch(flat.data_ptr(), flat.numel(),
                                          _row_width(labels), num_segments,
                                          boxes.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_plan kernel launch failed: "
                           f"{lib.ark_segment_sum_error_string(err).decode()} ({err})")
    segment_plan.launches += 1
    return SegmentPlan(tuple(labels.shape), num_segments, labels.device, flat, boxes)


segment_plan.launches = 0


def segment_sum_plain(values: torch.Tensor, labels: torch.Tensor,
                      num_segments: int, background: bool = True) -> torch.Tensor:
    """Per-segment sums of `values` (N,) or (N, K) keyed by `labels` (N
    entries, any shape), as ``index_add_`` on the tensors' device; labels
    outside [0, num_segments) are dropped, as ``jax.ops.segment_sum`` drops
    them, and row 0 is zero with ``background=False``. On the CPU
    ``index_add_`` adds in ascending index order; on CUDA it uses atomics
    (any order), so the tests compare the kernel with this on a CPU copy."""
    labels = labels.reshape(-1)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    valid = (labels >= 0) & (labels < num_segments)
    if not bool(valid.all()):
        labels, values = labels[valid], values[valid]
    out.index_add_(0, labels.to(torch.int64), values)
    if not background:
        out[0] = 0
    return out


def _check_plan(plan: SegmentPlan, labels: torch.Tensor, num_segments: int) -> None:
    if (plan.shape != tuple(labels.shape) or plan.num_segments != num_segments
            or plan.device != labels.device):
        raise ValueError(f"segment_sum: the plan is of labels {plan.shape} on "
                         f"{plan.device} with {plan.num_segments} segments, the call "
                         f"of labels {tuple(labels.shape)} on {labels.device} with "
                         f"{num_segments}")


def _check_kernel_operands(values, labels, num_segments):
    if values.device.type != "cuda" or labels.device != values.device:
        raise ValueError(f"segment_sum: values on {values.device} and labels on "
                         f"{labels.device}; the kernel takes both on one CUDA device")
    if values.dtype != torch.float32:
        raise TypeError(f"segment_sum: the kernel takes float32 values, got "
                        f"{values.dtype}")
    _check_labels(labels, num_segments)
    if values.ndim not in (1, 2) or values.shape[0] != labels.numel():
        raise ValueError(f"segment_sum: values (N,) or (N, K) for N labels expected, "
                         f"got {tuple(values.shape)} and labels {tuple(labels.shape)}")


def segment_sum(values: torch.Tensor, labels: torch.Tensor, num_segments: int,
                plan: Optional[SegmentPlan] = None, background: bool = True
                ) -> torch.Tensor:
    """Per-segment sums of `values` (N,) or (N, K) keyed by `labels` ((H, W)
    or (N,)), each accumulated in ascending pixel order; labels outside
    [0, num_segments) are dropped. With ``background=False`` segment 0 is
    not summed and row 0 is zero (for callers that never read it: its walk
    is one warp's serial chain over every background pixel). The CUDA kernel
    for CUDA tensors, ``segment_sum_plain`` for CPU ones. `plan` is
    ``segment_plan(labels, num_segments)``, built once per label image and
    reused; without one, this call builds it. A plan of another shape,
    device or `num_segments` raises. On CUDA tensors the wrapper launches
    ``ark_segment_sum_launch`` on the current stream and raises if the
    launch is refused; it never falls back. ``segment_sum.launches`` counts
    kernel launches."""
    if plan is not None:
        _check_plan(plan, labels, num_segments)
    if values.device.type == "cpu" and labels.device.type == "cpu":
        return segment_sum_plain(values, labels, num_segments, background)
    _check_kernel_operands(values, labels, num_segments)
    if plan is None:
        plan = segment_plan(labels, num_segments)
    n, k = values.shape[0], (values.shape[1] if values.ndim == 2 else 1)
    vals = values.reshape(n, k).contiguous()
    out = torch.empty((num_segments, k), dtype=torch.float32, device=vals.device)
    if n == 0 or k == 0:
        return out.zero_().reshape((num_segments,) + tuple(values.shape[1:]))
    lib = _kernels.lib("segment_sum")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.ark_segment_sum_launch(
            vals.data_ptr(), plan.labels.data_ptr(), _row_width(labels),
            plan.boxes.data_ptr(), num_segments, k, int(background), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: "
                           f"{lib.ark_segment_sum_error_string(err).decode()} "
                           f"({err})")
    segment_sum.launches += 1
    return out.reshape((num_segments,) + tuple(values.shape[1:]))


segment_sum.launches = 0


def segment_max(values: torch.Tensor, labels: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max of (N,) `values`; -inf for an empty segment (the
    identity ``jax.ops.segment_max`` uses). A max is exact in any order, so
    ``scatter_reduce_`` serves every device."""
    out = torch.full((num_segments,), -math.inf, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, labels.to(torch.int64), values, "amax")


def _pixel_coords(labels: torch.Tensor):
    h, w = labels.shape
    rr = torch.arange(h, dtype=torch.float32, device=labels.device)
    cc = torch.arange(w, dtype=torch.float32, device=labels.device)
    return (rr[:, None].expand(h, w).reshape(-1),
            cc[None, :].expand(h, w).reshape(-1))


def cell_sizes(labels: torch.Tensor, num_segments: int,
               background: bool = True) -> torch.Tensor:
    """Pixel count per label; (num_segments,)."""
    return segment_sum(torch.ones(labels.numel(), dtype=torch.float32,
                                  device=labels.device),
                       labels.to(torch.int32), num_segments, background=background)


def channel_sums(images: torch.Tensor, labels: torch.Tensor,
                 num_segments: int, background: bool = True) -> torch.Tensor:
    """Total intensity per (label, channel); (num_segments, C)."""
    c = images.shape[-1]
    return segment_sum(images.reshape(-1, c).to(torch.float32),
                       labels.to(torch.int32), num_segments, background=background)


def positive_pixel_counts(images: torch.Tensor, labels: torch.Tensor,
                          num_segments: int, threshold: float = 0.0,
                          background: bool = True) -> torch.Tensor:
    """Count of pixels with value > threshold per (label, channel)."""
    c = images.shape[-1]
    thr = torch.tensor(threshold, dtype=torch.float32, device=images.device)
    pos = (images.reshape(-1, c).to(torch.float32) > thr).to(torch.float32)
    return segment_sum(pos, labels.to(torch.int32), num_segments,
                       background=background)


def centroids(labels: torch.Tensor, num_segments: int,
              plan: Optional[SegmentPlan] = None, background: bool = True
              ) -> torch.Tensor:
    """(num_segments, 2) centroid (row, col) per label; NaN for an empty
    label, and for row 0 with ``background=False``."""
    rr, cc = _pixel_coords(labels)
    sums = segment_sum(torch.stack([torch.ones_like(rr), rr, cc], dim=1),
                       labels.to(torch.int32), num_segments, plan, background)
    return sums[:, 1:] / sums[:, :1]


def center_weighted_sums(images: torch.Tensor, labels: torch.Tensor,
                         num_segments: int, background: bool = True) -> torch.Tensor:
    """Center-weighted intensity per (label, channel): weight per pixel
    1 - d_inf(pixel, cell centroid) / (max-in-cell d_inf + 1), as the JAX
    package computes it (centroid pass, segment max, weighted sum)."""
    c = images.shape[-1]
    labels = labels.to(torch.int32)
    seg = labels.reshape(-1).to(torch.int64)
    plan = segment_plan(labels, num_segments)
    cent = centroids(labels, num_segments, plan, background)
    rr, cc = _pixel_coords(labels)
    own = cent[seg]
    dist = torch.maximum(torch.abs(rr - own[:, 0]), torch.abs(cc - own[:, 1]))
    dmax = segment_max(dist, seg, num_segments)
    weights = 1.0 - dist / (dmax[seg] + 1.0)
    vals = images.reshape(-1, c).to(torch.float32) * weights[:, None]
    return segment_sum(vals, labels, num_segments, plan, background)


def _perimeter_contributions(labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel Cauchy-Crofton boundary contribution, (H, W) f32: every
    pixel's 8 neighbour mismatches credited to its own label (the same total
    per label as crediting each crossing to both ends). The image border
    counts as background."""
    labels = labels.to(torch.int32)
    h, w = labels.shape
    lab = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=0)

    def neq(dy, dx):
        return (labels != lab[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]
                ).to(torch.float32)

    straight = neq(0, 1) + neq(0, -1) + neq(1, 0) + neq(-1, 0)
    diag = neq(1, 1) + neq(1, -1) + neq(-1, 1) + neq(-1, -1)
    # XLA's jitted CPU code divides by the constant as a multiply by its f32
    # reciprocal; the port does the same (no FMA question: every sum
    # straight + diag * r over straight, diag in 0..4 rounds alike either way)
    return (math.pi / 8.0) * (straight + diag * (1.0 / _SQRT2))


def crofton_perimeter(labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-label perimeter by the 4-direction Cauchy-Crofton estimator,
    P = (pi/8)(n_h + n_v + (n_d1 + n_d2)/sqrt2), in one segment sum. The
    background has no perimeter: row 0 is zero, as in the JAX package."""
    return segment_sum(_perimeter_contributions(labels).reshape(-1),
                       labels.to(torch.int32), num_segments, background=False)


def euler_numbers(labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-label Euler number (objects - holes), 8-connectivity, from Gray
    bit-quad counts E = (Q1 - Q3 - 2 Qd) / 4, routed through one per-pixel
    value image so that the reduction is one segment sum. Row 0 is zero, as
    in the JAX package."""
    h, w = labels.shape
    lab = torch.nn.functional.pad(labels.to(torch.int32), (1, 1, 1, 1), value=0)
    a, b = lab[:-1, :-1], lab[:-1, 1:]
    c, d = lab[1:, :-1], lab[1:, 1:]
    quads = [a, b, c, d]
    val = torch.zeros((h, w), dtype=torch.float32, device=labels.device)
    for slot in range(4):
        cand = quads[slot]
        # count a candidate once per quad: only from its first slot
        first = torch.ones_like(cand, dtype=torch.bool)
        for prev in range(slot):
            first &= quads[prev] != cand
        i0, i1, i2, i3 = (a == cand), (b == cand), (c == cand), (d == cand)
        n_in = (i0.to(torch.int32) + i1.to(torch.int32) + i2.to(torch.int32)
                + i3.to(torch.int32))
        diag = (i0 & i3 & ~i1 & ~i2) | (i1 & i2 & ~i0 & ~i3)
        q1 = (n_in == 1).to(torch.float32)
        q3 = (n_in == 3).to(torch.float32)
        qd = diag.to(torch.float32)
        contrib = torch.where(first, (q1 - q3 - 2.0 * qd) / 4.0, 0.0)
        # pixel (y, x) is slot a of quad (y+1, x+1), b of (y+1, x), c of
        # (y, x+1) and d of (y, x)
        oy, ox = {0: (1, 1), 1: (1, 0), 2: (0, 1), 3: (0, 0)}[slot]
        padc = torch.nn.functional.pad(contrib, (0, 1, 0, 1))
        val = val + padc[oy:oy + h, ox:ox + w]
    return segment_sum(val.reshape(-1), labels.to(torch.int32), num_segments,
                       background=False)


def _features_from_central(m00, cy, cx, mu20, mu02, mu11, perimeter) -> dict:
    """Morphology dict from per-label central second moments (already
    divided by area), skimage's conventions."""
    common = torch.sqrt(torch.clamp_min(4.0 * mu11 ** 2 + (mu20 - mu02) ** 2, 0.0))
    l1 = (mu20 + mu02 + common) / 2.0
    l2 = torch.clamp_min((mu20 + mu02 - common) / 2.0, 0.0)
    major = 4.0 * torch.sqrt(torch.clamp_min(l1, 0.0))
    minor = 4.0 * torch.sqrt(l2)
    # skimage gives 0 for the degenerate l1 == 0 (single pixel)
    ecc = torch.where(
        l1 > 0.0,
        torch.sqrt(torch.clamp_min(1.0 - l2 / torch.clamp_min(l1, 1e-12), 0.0)),
        0.0)
    eq_diam = torch.sqrt(4.0 * m00 * (1.0 / math.pi))   # XLA's reciprocal multiply
    # angle between the row axis and the major axis, in (-pi/2, pi/2]
    orientation = 0.5 * torch.atan2(2.0 * mu11, mu20 - mu02)
    return {
        "area": m00,
        "centroid-0": cy,
        "centroid-1": cx,
        "major_axis_length": major,
        "minor_axis_length": minor,
        "eccentricity": ecc,
        "equivalent_diameter": eq_diam,
        "orientation": orientation,
        "perimeter": perimeter,
    }


def _central_moment_sums(labels: torch.Tensor, num_segments: int,
                         extra_cols: torch.Tensor = None, background: bool = True):
    """Two-pass central moments: pass 1 sums [1, r, c] for exact centroids;
    pass 2 sums the CENTERED monomials, the perimeter contributions and any
    `extra_cols`. Raw second moments about the origin cancel in f32 (mu20 =
    m20/m00 - cy^2 subtracts two ~cy^2-sized terms: 37% eccentricity error at
    the far corner of 4096^2), so the two passes stay.

    Both passes share one plan of the label image.

    Returns (m00, cy, cx, mu20, mu02, mu11, perimeter, extra_sums)."""
    labels = labels.to(torch.int32)
    idx = labels.reshape(-1).to(torch.int64)
    plan = segment_plan(labels, num_segments)
    rr, cc = _pixel_coords(labels)
    first = segment_sum(torch.stack([torch.ones_like(rr), rr, cc], dim=1), labels,
                        num_segments, plan, background)
    m00 = first[:, 0]
    safe = torch.clamp_min(m00, 1.0)
    cy, cx = first[:, 1] / safe, first[:, 2] / safe
    cent = (first[:, 1:3] / safe[:, None])[idx]
    dy = rr - cent[:, 0]
    dx = cc - cent[:, 1]
    cols = [dy * dy, dx * dx, dy * dx, _perimeter_contributions(labels).reshape(-1)]
    second_in = torch.stack(cols, dim=1)
    if extra_cols is not None:
        second_in = torch.cat([second_in, extra_cols], dim=1)
    second = segment_sum(second_in, labels, num_segments, plan, background)
    mu20 = second[:, 0] / safe
    mu02 = second[:, 1] / safe
    mu11 = second[:, 2] / safe
    perimeter = second[:, 3].clone()
    perimeter[0] = 0.0                    # the background has no perimeter
    extra = second[:, 4:] if extra_cols is not None else None
    return m00, cy, cx, mu20, mu02, mu11, perimeter, extra


def moment_features(labels: torch.Tensor, num_segments: int,
                    background: bool = True) -> dict:
    """Moments-based morphology per label (skimage regionprops semantics):
    area, centroid-0/1, major/minor axis length, eccentricity, equivalent
    diameter, orientation, perimeter; (num_segments,) tensors. Two segment
    sums (centroids, then centred monomials and perimeter)."""
    m00, cy, cx, mu20, mu02, mu11, perim, _ = _central_moment_sums(
        labels, num_segments, background=background)
    return _features_from_central(m00, cy, cx, mu20, mu02, mu11, perim)


def moment_and_channel_features(images: torch.Tensor, labels: torch.Tensor,
                                num_segments: int, background: bool = True):
    """(morphology dict, (S, C) channel sums) in two segment sums: the
    channel sums ride the second (centred-moment) pass. The default
    quantification path (``total_intensity`` and the base regionprops)."""
    c = images.shape[-1]
    m00, cy, cx, mu20, mu02, mu11, perim, chan = _central_moment_sums(
        labels, num_segments,
        extra_cols=images.reshape(-1, c).to(torch.float32), background=background)
    return _features_from_central(m00, cy, cx, mu20, mu02, mu11, perim), chan
