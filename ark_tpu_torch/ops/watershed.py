"""Marker watershed: the native host flood, and the batched device floods.

Port of ``ark_tpu/ops/watershed.py``. The host ``watershed`` and
``label_components`` call the port's copy of the JAX package's native C++
kernels (``ark_tpu_torch.native``, built with g++ on first use). The device floods compute
what the JAX package's compute, bit for bit: labels and convergence flags.

Two engines, chosen by the module global ``_ENGINE`` as in the reference:

- ``"minimax"`` (the default): packed (value, label) relaxation of the
  minimax recurrence, accelerated by four directional scans per block, then a
  breadth-first re-labeling over optimal edges (``_flood_minimax``).
- ``"levels"``: the level scan (``_flood``). For each of `levels` levels,
  claim rounds until a round changes nothing, at most `bfs_rounds` of them
  (phase A); if phase A did not converge, the level is finished exactly with
  connected components of the conductive set (phase B, ``_resolve_level``).
  Each claim round is ``claim_round``: on a CUDA tensor the hand-written
  kernel in ``ark_tpu_torch/csrc/watershed_claim.cu``, on a CPU tensor its
  plain version ``_claim_round``.

The reference's ``lax.scan``/``lax.cond`` loops become Python loops with the
same budgets and the same order of checks; each check reads one flag back
from the device. Phase B hands ties out by minimum label, so any other
schedule of rounds would change who owns a tie.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ark_tpu_torch.ops import _kernels, cc
from ark_tpu_torch.ops.quantiles import masked_order_stats


def watershed(image: np.ndarray, markers: np.ndarray,
              mask: np.ndarray = None) -> np.ndarray:
    """Marker-based watershed on `image` (flood ascending values), restricted
    to `mask`. 4-connected; returns int32 labels. Host (native C++)."""
    from ark_tpu_torch import native

    lib = native.get_lib()
    image = np.ascontiguousarray(image, np.float32)
    markers = np.ascontiguousarray(markers, np.int32)
    if mask is None:
        mask = np.ones(image.shape, np.uint8)
    mask = np.ascontiguousarray(mask.astype(bool), np.uint8)
    h, w = image.shape
    out = np.zeros((h, w), np.int32)
    lib.watershed(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        markers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def label_components(mask: np.ndarray) -> np.ndarray:
    """4-connected component labeling via the native kernel (host)."""
    from ark_tpu_torch import native

    lib = native.get_lib()
    mask = np.ascontiguousarray(mask.astype(bool), np.uint8)
    h, w = mask.shape
    out = np.zeros((h, w), np.int32)
    n = ctypes.c_int32(0)
    lib.label_components(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.byref(n))
    return out


_LAB_SENTINEL = 2 ** 31 - 1


def _quantize(image: torch.Tensor, mask: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-image quantization of `image` to int32 buckets [0, levels) over
    the native kernel's hot-pixel-robust range: the 0.1%/99.9% order
    statistics of the MASKED values. image, mask: (B, H, W). An image with
    no masked pixel has NaN statistics; its buckets are 0, as XLA's
    float-to-int conversion makes them (torch's would be undefined)."""
    b, h, w = image.shape
    n = h * w
    x = image.reshape(b, n).T.to(torch.float32)                  # (n, B)
    valid = mask.reshape(b, n).T
    nv = torch.sum(valid, dim=0).to(torch.int32)                 # (B,)
    lo_k = torch.div(nv, 1000, rounding_mode="floor")            # C++: size/1000
    hi_k = torch.clamp_min(nv - 1 - lo_k, 0)
    stats = masked_order_stats(x, valid, torch.stack([lo_k, hi_k], dim=1))
    vmin, vmax = stats[:, 0], stats[:, 1]
    rng = vmax - vmin
    ok = (nv > 0) & (rng > 0)
    # a true division: torch computes `scalar / tensor` as a reciprocal
    # times the scalar, which rounds differently
    top = torch.full_like(rng, levels - 1)
    scale = torch.where(ok, top / torch.where(rng > 0, rng, 1.0), 0.0)
    q = torch.floor((image - vmin[:, None, None]) * scale[:, None, None])
    q = torch.clamp(q, 0, levels - 1)
    return torch.where(torch.isnan(q), 0.0, q).to(torch.int32)


def _neighbor_min4(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Min over the 4 neighbours (not the pixel itself), `fill` past the
    edges. x: (B, H, W)."""
    h, w = x.shape[1:]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return torch.minimum(torch.minimum(p[:, :h, 1:w + 1], p[:, 2:, 1:w + 1]),
                         torch.minimum(p[:, 1:h + 1, :w], p[:, 1:h + 1, 2:]))


def _claim_round(lab: torch.Tensor, q: torch.Tensor, mask, level: int
                 ) -> torch.Tensor:
    """One synchronous claim: every unlabeled masked pixel adjacent to a
    source (labeled, q <= level) takes the min source label among its
    4-neighbours. `mask` None means the labels are mask-encoded (-1 outside
    the mask), as ``claim_round`` takes them. The plain version of the
    claim kernel."""
    src = (lab > 0) & (q <= level)
    cand = _neighbor_min4(torch.where(src, lab, _LAB_SENTINEL), _LAB_SENTINEL)
    claim = (lab == 0) & (cand < _LAB_SENTINEL)
    if mask is not None:
        claim &= mask
    return torch.where(claim, cand, lab)


def _check_claim_operands(lab: torch.Tensor, q: torch.Tensor) -> None:
    if lab.device.type != "cuda" or q.device != lab.device:
        raise ValueError(f"claim_round: labels on {lab.device} and levels on "
                         f"{q.device}; the kernel takes both on one CUDA device")
    if lab.dtype != torch.int32 or q.dtype != torch.int32:
        raise TypeError(f"claim_round: the kernel takes int32, got labels "
                        f"{lab.dtype} and levels {q.dtype}")
    if lab.ndim != 3 or q.shape != lab.shape:
        raise ValueError(f"claim_round: (B, H, W) labels and levels of one "
                         f"shape expected, got {tuple(lab.shape)} and "
                         f"{tuple(q.shape)}")
    if not (lab.is_contiguous() and q.is_contiguous()):
        raise ValueError("claim_round: the kernel takes contiguous tensors")


def claim_round(lab: torch.Tensor, q: torch.Tensor, level: int):
    """One claim round on mask-encoded labels (-1 outside the mask, 0
    unlabeled): the CUDA kernel for CUDA tensors, ``_claim_round`` for CPU
    ones. Port of ``ark_tpu.ops.watershed._claim_round_pallas``. Returns
    (new labels, number of changed pixels as an int32 scalar tensor), both
    on the input's device. On CUDA tensors it launches
    ``ark_claim_round_launch`` on the current stream and raises if the
    launch is refused; it never falls back. ``claim_round.launches`` counts
    kernel launches."""
    if lab.device.type == "cpu" and q.device.type == "cpu":
        new = _claim_round(lab, q, None, level)
        return new, torch.sum(new != lab, dtype=torch.int32)
    _check_claim_operands(lab, q)
    b, h, w = lab.shape
    out = torch.empty_like(lab)
    changed = torch.zeros((), dtype=torch.int32, device=lab.device)
    lib = _kernels.lib("watershed_claim")
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        err = lib.ark_claim_round_launch(
            lab.data_ptr(), q.data_ptr(), int(level), b, h, w, out.data_ptr(),
            changed.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"claim kernel launch failed: "
                           f"{lib.ark_claim_round_error_string(err).decode()} "
                           f"({err})")
    claim_round.launches += 1
    return out, changed


claim_round.launches = 0


def _resolve_level(lab, rep, q, mask, level: int):
    """Finish a level exactly (phase B): connected components of the
    conductive set {mask & q <= level}, the min source label per component,
    one frontier claim round. `rep` is the component forest carried across
    levels (the conductive set only grows, so an earlier fixpoint stays a
    valid starting state). Returns (lab, rep, sv_converged)."""
    b, h, w = lab.shape
    n = h * w
    conductive = mask & (q <= level)
    iota = torch.arange(n, dtype=torch.int32, device=lab.device).reshape(1, h, w)
    rep_init = torch.where(conductive & (rep == n), iota, rep)
    rep, done = cc._cc_rounds_batched(conductive, rep_init, 1, cc._budget(n))
    src_lab = torch.where((lab > 0) & conductive, lab, _LAB_SENTINEL)
    ids = (rep.reshape(b, n).to(torch.int64) + cc._offsets(b, n, lab.device)
           ).reshape(-1)
    table = torch.full((b * (n + 1),), cc._I32_MAX, dtype=torch.int32,
                       device=lab.device)
    table.scatter_reduce_(0, ids, src_lab.reshape(-1), reduce="amin")
    got = table[ids].reshape(b, h, w)
    lab = torch.where(conductive & (lab == 0) & (got < _LAB_SENTINEL), got, lab)
    lab, _ = claim_round(lab, q, level)
    return lab, rep, done


def _flood(q, markers, mask, levels: int, bfs_rounds: int):
    """The level-scan flood on pre-quantized q; returns (labels, converged).
    Labels are mask-encoded (-1 outside the mask) for the claim rounds and
    phase B alike, and decoded at the end."""
    b, h, w = q.shape
    q = q.to(torch.int32).contiguous()
    lab = torch.where((markers > 0) & mask, markers.to(torch.int32), 0)
    lab = torch.where(mask, lab, -1).contiguous()
    rep = torch.full_like(lab, h * w)
    converged = True
    for level in range(levels):
        for _ in range(bfs_rounds):                       # phase A
            lab, changed = claim_round(lab, q, level)
            if int(changed) == 0:
                break
        else:                                             # phase B
            lab, rep, sv_done = _resolve_level(lab, rep, q, mask, level)
            converged = converged and sv_done
    return torch.where(lab == -1, 0, lab), converged


# ---------------------------------------------------------------------------
# Minimax-relaxation flood (see the reference's comment block above its
# `_flood_minimax`): v(p) = min over 4-neighbours u of max(v(u), q(u)) on
# packed int32 keys (value << label_bits | label), converging in rounds of the
# order of the basin radius, with a breadth-first re-labeling pass after.
# ---------------------------------------------------------------------------

_MINIMAX_BLOCK = 16   # unconditional rounds per convergence check


def _label_bits(levels: int) -> int:
    # one extra value bucket (= `levels`) is the sweep's absorbing gate
    return 31 - max(int(np.ceil(np.log2(levels + 1))), 1)


def _lift(pk, qs, labm: int):
    """Label-preserving lift of each key to at least its pixel's height."""
    return torch.where(pk >= qs, pk, qs | (pk & labm))


def _minimax_round(pk, qs, labm: int, claimable):
    """One relaxation round on packed keys (qs: q shifted into the value
    bits; INT32_MAX is INF and loses every min)."""
    cand = _neighbor_min4(_lift(pk, qs, labm), _LAB_SENTINEL)
    return torch.where(claimable, torch.minimum(pk, cand), pk)


def _along(x: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    return x[(slice(None),) * dim + (sl,)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = a
    out[(slice(None),) * dim + (slice(1, None, 2),)] = b
    return out


def _associative_scan(comb, elems, dim: int):
    """``jax.lax.associative_scan`` (forward) step for step: combine adjacent
    pairs, scan the half recursively, fill in the even positions, interleave.
    The sweep's operator is not associative on equal-value ties, so only
    this exact recursion gives the reference's intermediate keys."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = comb([_along(e, dim, slice(0, -1, 2)) for e in elems],
                   [_along(e, dim, slice(1, None, 2)) for e in elems])
    odd = _associative_scan(comb, reduced, dim)
    evens = [_along(e, dim, slice(2, None, 2)) for e in elems]
    if n % 2 == 0:
        even = comb([_along(e, dim, slice(0, -1)) for e in odd], evens)
    else:
        even = comb(odd, evens)
    even = [torch.cat([_along(e, dim, slice(0, 1)), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(a, b, dim) for a, b in zip(even, odd)]


def _minimax_sweep(pk, qs, labm: int, claimable, absorb: int):
    """Fast-sweeping acceleration: four directional scans carry keys along
    whole rows and columns; the segment transfer f(s) = min(c, lift_g(s))
    composes as (c1, g1) + (c2, g2) = (min(c2, lift_g2(c1)), max(g1, g2)).
    Non-mask pixels gate with the absorbing level `absorb`, and any key
    lifted that high goes back to INF."""
    def comb(a, b):
        c1, g1 = a
        c2, g2 = b
        return [torch.minimum(c2, _lift(c1, g2, labm)), torch.maximum(g1, g2)]

    qs_gate = torch.where(claimable | (pk <= labm), qs, absorb)

    def one_dir(pk, dim, reverse):
        p = pk.flip(dim) if reverse else pk
        g = qs_gate.flip(dim) if reverse else qs_gate
        # the gate entering position j from j-1 is q at j-1; the first
        # position has no predecessor and gets the absorbing gate
        gate = torch.cat([torch.full_like(_along(g, dim, slice(0, 1)), absorb),
                          _along(g, dim, slice(0, g.shape[dim] - 1))], dim=dim)
        out, _ = _associative_scan(comb, [p, gate], dim)
        out = torch.where(out >= absorb, _LAB_SENTINEL, out)
        return out.flip(dim) if reverse else out

    for dim, reverse in ((2, False), (2, True), (1, False), (1, True)):
        cand = one_dir(pk, dim, reverse)
        pk = torch.where(claimable, torch.minimum(pk, cand), pk)
    return pk


def _refine_round(newlab, pk, qs, lb: int, labm: int, claimable):
    """One synchronous breadth-first re-labeling round over OPTIMAL edges:
    an unclaimed pixel p takes the min label among relabeled 4-neighbours u
    whose exit value max(v(u), q(u)) equals v(p). Reads only the value bits
    of `pk`."""
    h, w = newlab.shape[1:]
    exitv = _lift(pk, qs, labm) >> lb
    valp = pk >> lb
    lab_ok = torch.where(newlab > 0, newlab, _LAB_SENTINEL)
    ev = F.pad(exitv, (1, 1, 1, 1), value=_LAB_SENTINEL >> lb)
    lv = F.pad(lab_ok, (1, 1, 1, 1), value=_LAB_SENTINEL)
    cand = torch.full_like(newlab, _LAB_SENTINEL)
    for rows, cols in ((slice(None, h), slice(1, w + 1)),
                       (slice(2, None), slice(1, w + 1)),
                       (slice(1, h + 1), slice(None, w)),
                       (slice(1, h + 1), slice(2, None))):
        hit = ev[:, rows, cols] == valp
        cand = torch.minimum(cand, torch.where(hit, lv[:, rows, cols],
                                               _LAB_SENTINEL))
    take = claimable & (newlab == 0) & (pk != _LAB_SENTINEL) \
        & (cand < _LAB_SENTINEL)
    return torch.where(take, cand, newlab)


def _flood_minimax(q, markers, mask, levels: int, rounds: int):
    """Minimax flood on pre-quantized q; returns (labels, converged)."""
    lb = _label_bits(levels)
    labm = (1 << lb) - 1
    lab0 = torch.where((markers > 0) & mask, markers.to(torch.int32), 0)
    pk = torch.where(lab0 > 0, lab0, _LAB_SENTINEL)        # markers frozen
    claimable = mask & (lab0 == 0)
    qs = q.to(torch.int32) << lb
    absorb = levels << lb
    n_blocks = -(-rounds // _MINIMAX_BLOCK)

    done = False
    for _ in range(n_blocks):
        pk = _minimax_sweep(pk, qs, labm, claimable, absorb)
        for _ in range(_MINIMAX_BLOCK):
            pk = _minimax_round(pk, qs, labm, claimable)
        # certificate: one more NEIGHBOUR round changes nothing
        probe = _minimax_round(pk, qs, labm, claimable)
        done = torch.equal(probe, pk)
        pk = probe
        if done:
            break

    newlab = lab0
    rdone = False
    for _ in range(n_blocks):
        new = newlab
        for _ in range(_MINIMAX_BLOCK):
            new = _refine_round(new, pk, qs, lb, labm, claimable)
        rdone = torch.equal(new, newlab)
        newlab = new
        if rdone:
            break
    lab = torch.where(pk == _LAB_SENTINEL, 0, newlab)
    # labels must fit the packed key's label field; an overflow folds into
    # the flag so callers take their certified fallback
    fits = int(lab0.max()) <= labm
    return lab.to(torch.int32), done and rdone and fits


# engine selector for same-process A/Bs, as in the reference
_ENGINE = "minimax"


def flood(q, markers, mask, levels: int, bfs_rounds: int):
    """Engine-dispatched device flood on pre-quantized q; returns (labels,
    converged). `bfs_rounds` applies to the level engine only; the minimax
    engine budgets 2(h+w) rounds."""
    if _ENGINE == "minimax":
        h, w = q.shape[1:]
        return _flood_minimax(q, markers, mask, levels, rounds=2 * (h + w))
    return _flood(q, markers, mask, levels, bfs_rounds)


def _quantize_and_flood(image, markers, mask, levels: int, bfs_rounds: int):
    """Quantize, then flood (the whole device watershed)."""
    q = _quantize(image.to(torch.float32), mask, levels)
    return flood(q, markers, mask, levels, bfs_rounds)


def _on(a, device, dtype) -> torch.Tensor:
    """A numpy array or tensor as a contiguous `dtype` tensor on `device`."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype).contiguous()


def watershed_device(image, markers, mask=None, levels: int = 256,
                     bfs_rounds: int = 32, *, device):
    """Batched marker watershed on `device`. image: (B, H, W) or (H, W)
    float, flooded ascending; markers: int labels of the same shape; mask:
    optional bool. Numpy arrays or tensors. Returns (labels int32 tensor on
    `device`, converged bool)."""
    image = _on(image, device, torch.float32)
    markers = _on(markers, device, torch.int32)
    mask = torch.ones(image.shape, dtype=torch.bool, device=device) \
        if mask is None else _on(mask, device, torch.bool)
    single = image.ndim == 2
    if single:
        image, markers, mask = image[None], markers[None], mask[None]
    lab, done = _quantize_and_flood(image, markers, mask, levels, bfs_rounds)
    return (lab[0], done) if single else (lab, done)


def watershed_batch_np(image: np.ndarray, markers: np.ndarray,
                       mask: np.ndarray = None, levels: int = 256,
                       bfs_rounds: int = 32, *, device) -> np.ndarray:
    """numpy in, numpy out over `watershed_device` for (B, H, W) stacks; if
    a round budget reports non-convergence, the native per-image flood
    gives the result instead."""
    lab, done = watershed_device(image, markers, mask, levels=levels,
                                 bfs_rounds=bfs_rounds, device=device)
    if not done:
        mask = np.ones(image.shape, bool) if mask is None else mask
        return np.stack([watershed(image[i], markers[i], mask[i])
                         for i in range(image.shape[0])])
    return lab.cpu().numpy()
