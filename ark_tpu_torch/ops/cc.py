"""Connected-component labeling and area filters, in torch ops.

Port of ``ark_tpu/ops/cc.py``: Shiloach–Vishkin rounds of neighbour-min
hooking, a tree hook through a segment min, and pointer doubling, on
(B, H, W) stacks with per-image flat indices (the device watershed and
Mesmer's device postprocess), and the single-image API (``label``,
``label_checked``, ``label_np``, ``area_filter``, ``remove_small_objects``,
``remove_small_holes``) as a stack of one. The JAX package's fixed-length
scans with ``lax.cond`` early-outs become Python loops with the same round
budgets and the same order of checks, so every label, count and
convergence flag equals the JAX package's bit for bit. Segment min and sum
are integer scatters (``scatter_reduce_`` with ``amin``, ``bincount``):
integer atomics give one result in any order. Functions given a tensor
follow its device; those given a host mask take ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

_I32_MAX = 2 ** 31 - 1


def _neighbor_min(lab: torch.Tensor, fg: torch.Tensor, sentinel: int,
                  connectivity: int) -> torch.Tensor:
    """Min of L over each pixel's neighbourhood (itself included), masked to
    foreground; background keeps the sentinel. lab, fg: (..., H, W), so one
    function serves the JAX package's `_neighbor_min` and its batched vmap."""
    h, w = lab.shape[-2:]
    pad = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=sentinel)
    offs = [(0, 1), (2, 1), (1, 0), (1, 2)]
    if connectivity == 2:
        offs += [(0, 0), (0, 2), (2, 0), (2, 2)]
    out = lab
    for dy, dx in offs:
        out = torch.minimum(out, pad[..., dy:dy + h, dx:dx + w])
    return torch.where(fg, out, sentinel)


def _n_log(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _budget(n: int) -> int:
    """Default round budget (the JAX package's: 2 ceil(log2 n) + 4). Read at
    call time, so a test can shrink it."""
    return 2 * _n_log(n) + 4


def _check_offset_ids(b: int, n: int) -> None:
    """The JAX package's int32 guard on the flat (image, label) ids
    label + i*(n+1); kept so both sides refuse the same shapes."""
    if b * (n + 1) > _I32_MAX:
        raise ValueError(
            f"batched CC/area ops need b*(H*W+1) <= int32 max; got "
            f"{b} x {n + 1} - split the batch")


def _offsets(b: int, n: int, device) -> torch.Tensor:
    return (torch.arange(b, dtype=torch.int64, device=device) * (n + 1))[:, None]


def _cc_rounds_batched(fg: torch.Tensor, lab: torch.Tensor, connectivity: int,
                       rounds: int):
    """`rounds` hook + pointer-doubling rounds from `lab` (per-image flat
    indices, sentinel H*W); returns (lab, converged), the joint flag of the
    batch. A round runs while the previous one changed something, and each
    round's jumps run while the previous jump changed something, at most
    ceil(log2 n) of them: the JAX package's early-outs, in its order."""
    b, h, w = fg.shape
    n = h * w
    _check_offset_ids(b, n)
    n_log = _n_log(n)
    offs = _offsets(b, n, fg.device)
    sent_col = torch.full((b, 1), n, dtype=torch.int32, device=fg.device)
    done = False
    for _ in range(rounds):
        cand = _neighbor_min(lab, fg, n, connectivity)
        ids = (lab.reshape(b, n).to(torch.int64) + offs).reshape(-1)
        hook = torch.full((b * (n + 1),), _I32_MAX, dtype=torch.int32,
                          device=fg.device)
        hook.scatter_reduce_(0, ids, cand.reshape(-1), reduce="amin")
        new = torch.where(fg, hook[ids].reshape(b, h, w), n)
        for _ in range(n_log):
            flat = torch.cat([new.reshape(b, n), sent_col], dim=1).reshape(-1)
            jumped = flat[(new.reshape(b, n).to(torch.int64) + offs).reshape(-1)
                          ].reshape(b, h, w)
            settled = torch.equal(jumped, new)
            new = jumped
            if settled:
                break
        done = torch.equal(new, lab)
        lab = new
        if done:
            break
    return lab, done


def _renumber_batched(fg: torch.Tensor, rep: torch.Tensor):
    """Per-image sequential 1..n_i ids in raster order of each component's
    first pixel (scipy.ndimage.label's numbering); returns (labels, counts)."""
    b, h, w = fg.shape
    n = h * w
    rep2 = rep.reshape(b, n).to(torch.int64)
    iota = torch.arange(n, dtype=torch.int64, device=fg.device)[None, :]
    is_rep = fg.reshape(b, n) & (rep2 == iota)
    ranks = torch.cumsum(is_rep, dim=1, dtype=torch.int32)
    ranks_ext = torch.cat([ranks, torch.zeros((b, 1), dtype=torch.int32,
                                              device=fg.device)], dim=1)
    labels = torch.where(fg.reshape(b, n), torch.gather(ranks_ext, 1, rep2), 0)
    return labels.reshape(b, h, w).to(torch.int32), ranks[:, -1]


def _iota_labels(fg: torch.Tensor) -> torch.Tensor:
    b, h, w = fg.shape
    n = h * w
    iota = torch.arange(n, dtype=torch.int32, device=fg.device).reshape(1, h, w)
    return torch.where(fg, iota, n)


def label_batched(mask: torch.Tensor, connectivity: int = 1):
    """(B, H, W) boolean stack -> (labels (B, H, W) int32, counts (B,) int32,
    converged). Per-image numbering equals scipy.ndimage.label's when
    `converged` is True."""
    fg = mask.to(torch.bool)
    if fg.numel() == 0:
        raise ValueError("label_batched needs a non-empty stack")
    n = fg.shape[1] * fg.shape[2]
    rep, done = _cc_rounds_batched(fg, _iota_labels(fg), connectivity,
                                   _budget(n))
    labels, counts = _renumber_batched(fg, rep)
    return labels, counts, done


def label_batched_small(mask: torch.Tensor, connectivity: int = 1,
                        rounds: int = 8):
    """Batched CC for masks whose components have tiny geodesic diameter
    (watershed marker plateaus): `rounds` neighbour-min passes with no
    scatter, then one more as the fixpoint check. Returns (labels, counts,
    converged); the numbering is scipy's iff `converged`."""
    fg = mask.to(torch.bool)
    if fg.numel() == 0:
        raise ValueError("label_batched_small needs a non-empty stack")
    n = fg.shape[1] * fg.shape[2]
    lab = _iota_labels(fg)
    for _ in range(rounds):
        lab = _neighbor_min(lab, fg, n, connectivity)
    done = torch.equal(_neighbor_min(lab, fg, n, connectivity), lab)
    labels, counts = _renumber_batched(fg, lab)
    return labels, counts, done


def area_filter_batched(labels: torch.Tensor, min_area: int = 0,
                        max_area: int = _I32_MAX, n_max: int | None = None):
    """Zero out labels whose per-image pixel count falls outside [min_area,
    max_area]; surviving labels keep their ids. Returns (filtered,
    in_range): `in_range` is False iff some label exceeded `n_max` (the
    table bound), and the result is then not to be trusted."""
    b, h, w = labels.shape
    n = h * w
    m = n if n_max is None else n_max
    _check_offset_ids(b, m)
    lab2 = labels.to(torch.int32).reshape(b, n)
    in_range = bool(torch.all(lab2 <= m))
    safe = torch.clamp(lab2, 0, m).to(torch.int64)
    flat_ids = (safe + _offsets(b, m, labels.device)).reshape(-1)
    counts = torch.bincount(flat_ids, minlength=b * (m + 1)).reshape(b, m + 1)
    ids = torch.arange(m + 1, dtype=torch.int32, device=labels.device)[None, :]
    keep = (counts >= min_area) & (counts <= max_area) & (ids > 0)
    lut = torch.where(keep, ids, 0).reshape(-1)
    out = torch.where((lab2 >= 0) & (lab2 <= m), lut[flat_ids].reshape(b, n), 0)
    return out.reshape(b, h, w).to(torch.int32), in_range


# ---------------------------------------------------------------------------
# The single-image API: one (H, W) mask as a stack of one. The JAX package's
# single-image rounds fill their hook table with the sentinel where the
# batched ones take int32 max; every slot that is read holds a candidate
# (at most the sentinel), so the two give the same labels and flags.
# ---------------------------------------------------------------------------

def _cc_rounds(fg: torch.Tensor, lab: torch.Tensor, connectivity: int, rounds: int):
    """`rounds` hook + pointer-doubling rounds of one (H, W) image from `lab`;
    returns (lab, converged)."""
    lab, done = _cc_rounds_batched(fg[None], lab[None], connectivity, rounds)
    return lab[0], done


def _renumber(fg: torch.Tensor, rep: torch.Tensor):
    """scipy's raster-order ids 1..n of one image from its component-min
    representatives; returns (labels int32, n int32 scalar)."""
    labels, counts = _renumber_batched(fg[None], rep[None])
    return labels[0], counts[0]


def _label_full(fg: torch.Tensor, connectivity: int):
    """init -> rounds -> renumber: (labels, n, rep, converged)."""
    rep, done = _cc_rounds(fg, _iota_labels(fg[None])[0], connectivity,
                           _budget(fg.numel()))
    labels, count = _renumber(fg, rep)
    return labels, count, rep, done


def _label_resume(fg: torch.Tensor, rep: torch.Tensor, connectivity: int):
    """Another budget of rounds from `rep`, for a budget that fell short."""
    rep, done = _cc_rounds(fg, rep, connectivity, _budget(fg.numel()))
    labels, count = _renumber(fg, rep)
    return labels, count, rep, done


def _foreground(mask, device) -> torch.Tensor:
    """The mask's nonzero pixels as a bool tensor on `device`."""
    if isinstance(mask, torch.Tensor):
        return mask.to(device) != 0
    return torch.from_numpy(np.asarray(mask) != 0).to(device)


def label(mask, connectivity: int = 1, *, device="cuda"):
    """Label the connected components of a 2-D mask (scipy.ndimage.label's
    semantics and numbering: 1..n in raster order of each component's first
    pixel, background 0); connectivity 2 is 8-connected. Returns (labels
    int32 (H, W), n int32 scalar) on `device`. Trusts the round budget, as
    the JAX package's jitted `label` does; `label_checked` resumes on the
    flag."""
    labels, count, _, _ = _label_full(_foreground(mask, device), connectivity)
    return labels, count


def label_checked(mask, connectivity: int = 1, *, device="cuda"):
    """`label` with the convergence flag checked: further budgets of rounds
    run until the labels are exact. Returns (labels, n) on `device`."""
    fg = _foreground(mask, device)
    labels, count, rep, done = _label_full(fg, connectivity)
    while not done:          # never met at the default budget
        labels, count, rep, done = _label_resume(fg, rep, connectivity)
    return labels, count


def label_np(mask: np.ndarray, connectivity: int = 1, *, device="cuda"):
    """numpy in, numpy out: `label_checked` on `device`; the labels are a
    writable copy (host pipelines edit them in place)."""
    labels, count = label_checked(mask, connectivity, device=device)
    return labels.cpu().numpy().copy(), int(count)


def area_filter(labels: torch.Tensor, n_max: int | None = None, min_area: int = 0,
                max_area: int = _I32_MAX) -> torch.Tensor:
    """Zero out labels whose pixel count falls outside [min_area, max_area];
    surviving labels keep their ids. The table holds ids 0..n_max (all of
    the image's size by default). As in the JAX package's gather, a label
    past the table reads its last entry and a negative one counts from its
    end; labels outside it count no area. On the tensor's device."""
    lab = labels.to(torch.int32)
    num = lab.numel() + 1 if n_max is None else n_max + 1
    flat = lab.reshape(-1).to(torch.int64)
    inside = flat[(flat >= 0) & (flat < num)]
    counts = torch.bincount(inside, minlength=num)
    ids = torch.arange(num, dtype=torch.int32, device=lab.device)
    keep = (counts >= min_area) & (counts <= max_area) & (ids > 0)
    lut = torch.where(keep, ids, 0)
    index = torch.clamp(torch.where(flat < 0, flat + num, flat), 0, num - 1)
    return lut[index].reshape(lab.shape)


def remove_small_objects(mask, min_size: int = 5, connectivity: int = 1, *,
                         device="cuda") -> torch.Tensor:
    """Drop connected components smaller than `min_size` from a boolean mask
    (skimage's remove_small_objects on a bool image), on `device`. Trusts
    the round budget, as the JAX package's does."""
    labels, _ = label(mask, connectivity, device=device)
    return area_filter(labels, min_area=min_size) > 0


def remove_small_holes(mask, area_threshold: int = 64, connectivity: int = 1, *,
                       device="cuda") -> torch.Tensor:
    """Fill background components of area <= `area_threshold` (skimage's
    semantics: border-touching holes fill like any other), on `device`.
    Trusts the round budget; `remove_small_holes_np` resumes on the flag."""
    fg = _foreground(mask, device)
    return _fill_small_holes(fg, label(~fg, connectivity, device=device)[0],
                             area_threshold)


def remove_small_holes_np(mask: np.ndarray, area_threshold: int = 64,
                          connectivity: int = 1, *, device="cuda") -> np.ndarray:
    """`remove_small_holes` with the labels' flag checked; numpy in and out,
    the work on `device`."""
    fg = _foreground(mask, device)
    bg_labels, _ = label_checked(~fg, connectivity, device=device)
    return _fill_small_holes(fg, bg_labels, area_threshold).cpu().numpy()


def _fill_small_holes(fg: torch.Tensor, bg_labels: torch.Tensor,
                      area_threshold: int) -> torch.Tensor:
    big_bg = area_filter(bg_labels, min_area=area_threshold + 1) > 0
    return fg | ((bg_labels > 0) & ~big_bg)
