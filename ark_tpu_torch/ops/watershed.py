"""Marker watershed: the native host flood, and the batched device floods.

Port of ``ark_tpu/ops/watershed.py``. The host ``watershed`` and
``label_components`` call the port's copy of the JAX package's native C++
kernels (``ark_tpu_torch.native``, built with g++ on first use). The device floods compute
what the JAX package's compute, bit for bit: labels and convergence flags.

Two engines, chosen by the module global ``_ENGINE`` as in the reference:

- ``"minimax"`` (the default): packed (value, label) relaxation of the
  minimax recurrence, accelerated by four directional scans per block, then a
  breadth-first re-labeling over optimal edges (``_flood_minimax``). Both
  halves are one launch each of a hand-written cooperative kernel on a CUDA
  tensor, read back once, and their plain loops on a CPU tensor. The
  relaxation is ``minimax_relax`` (``ark_tpu_torch/csrc/minimax_relax.cu``):
  every block's sweep, replaying ``_associative_scan``'s tree line by line,
  its 16 rounds and its probe run on the card, where the plain loop
  ``_relax_plain`` dispatched ~1,700 torch ops a block and a synchronising
  comparison. The re-labeling is ``minimax_relabel``
  (``ark_tpu_torch/csrc/minimax_relabel.cu``), where the plain loop of
  ``_refine_round`` blocks made ~20 launches a round. Each keeps the
  reference's blocks and stopping rule, and its rounds stay synchronous, so
  keys, labels, flags and block counts are the plain loops'.
- ``"levels"``: the level scan (``_flood``). For each of `levels` levels,
  claim rounds until a round changes nothing, at most `bfs_rounds` of them
  (phase A); if phase A did not converge, the level is finished exactly with
  connected components of the conductive set (phase B, ``_resolve_level``).
  Phase A's rounds are ``claim_levels``: on a CUDA tensor one launch of the
  hand-written cooperative kernel in ``ark_tpu_torch/csrc/watershed_claim.cu``
  runs level after level on the card and returns at the first level that
  needs phase B (or after the last); on a CPU tensor its plain version
  ``_claim_levels`` loops over ``_claim_round``. Phase B's one frontier round
  is ``claim_round``, the one-round kernel of the same source.

The reference's ``lax.scan``/``lax.cond`` loops become loops with the same
budgets and the same order of checks: phase A's on the card, the levels'
in Python, which reads the stop level back once a launch. Phase B hands
ties out by minimum label, so any other schedule of rounds would change who
owns a tie.

``flood`` runs in a ``watershed.flood`` span: its ``engine``, and its
``blocks``: the minimax engine's relaxation and re-labeling blocks (each
loop a child span with its own count and its ``engine``, "kernel" or
"plain"; the re-labeling's also with its ``rounds``), the level engine's
claim rounds.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ark_tpu_torch.ops import _kernels, cc
from ark_tpu_torch.ops.quantiles import masked_order_stats
from ark_tpu_torch.utils import profiling


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


def _check_claim_operands(lab: torch.Tensor, q: torch.Tensor,
                          name: str = "claim_round", cuda: bool = True) -> None:
    """Raises on operands the claim kernels do not take; with `cuda` False,
    on what the plain versions must refuse alike (all but the device)."""
    if cuda and (lab.device.type != "cuda" or q.device != lab.device):
        raise ValueError(f"{name}: labels on {lab.device} and levels on "
                         f"{q.device}; the kernel takes both on one CUDA device")
    if lab.dtype != torch.int32 or q.dtype != torch.int32:
        raise TypeError(f"{name}: the kernel takes int32, got labels "
                        f"{lab.dtype} and levels {q.dtype}")
    if lab.ndim != 3 or q.shape != lab.shape:
        raise ValueError(f"{name}: (B, H, W) labels and levels of one "
                         f"shape expected, got {tuple(lab.shape)} and "
                         f"{tuple(q.shape)}")
    if not (lab.is_contiguous() and q.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if lab.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel's 16-byte loads take 16-byte aligned "
                         f"tensors, got labels at {lab.data_ptr() % 16} and levels "
                         f"at {q.data_ptr() % 16} bytes past a 16-byte boundary "
                         f"(a view at an offset: pass a copy)")


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
        return _claim_round_plain(lab, q, level)
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


def _claim_round_plain(lab: torch.Tensor, q: torch.Tensor, level: int):
    """``claim_round``'s plain version on any device: ``_claim_round`` on
    mask-encoded labels, and the number of pixels it changed (an int32
    scalar tensor)."""
    new = _claim_round(lab, q, None, level)
    return new, torch.sum(new != lab, dtype=torch.int32)


def _claim_levels(lab: torch.Tensor, q: torch.Tensor, level: int, levels: int,
                  bfs_rounds: int, round_fn=_claim_round_plain):
    """Phase A of levels `level`, `level` + 1, ... on mask-encoded labels:
    each level's synchronous rounds until one changes nothing (a fixpoint)
    or `bfs_rounds` have run. Returns (labels, the first level whose budget
    ran out without converging, or `levels`; the rounds run). With the
    default `round_fn` it is the plain version of the level-scan kernel;
    given ``claim_round`` (or any function with its interface) it is the
    loop of one-round launches the level scan ran before that kernel: a
    launch and a host read of the changed count a round."""
    rounds = 0
    while level < levels:
        for _ in range(bfs_rounds):
            lab, changed = round_fn(lab, q, level)
            rounds += 1
            if int(changed) == 0:
                break
        else:
            return lab, level, rounds
        level += 1
    return lab, level, rounds


def claim_levels(lab: torch.Tensor, q: torch.Tensor, level: int, levels: int,
                 bfs_rounds: int):
    """Phase A of the level scan from `level` on mask-encoded labels (-1
    outside the mask, 0 unlabeled): the CUDA kernel for CUDA tensors,
    ``_claim_levels`` for CPU ones. Returns (labels, stop level, rounds) as
    ``_claim_levels`` does, and refuses what the kernel does not take
    (int64, a layout that is not contiguous or not 16-byte aligned, mixed
    devices) on either device. On CUDA tensors it makes one cooperative
    launch of ``ark_claim_levels_launch`` on the current stream, never
    writes into `lab`, reads the stop level and the rounds back once, and
    raises if the launch is refused; it never falls back.
    ``claim_levels.launches`` counts kernel launches,
    ``claim_levels.rounds`` the rounds run on either device."""
    on_cpu = lab.device.type == "cpu" and q.device.type == "cpu"
    _check_claim_operands(lab, q, "claim_levels", cuda=not on_cpu)
    if on_cpu:
        out = _claim_levels(lab, q, level, levels, bfs_rounds)
        _levels_counts.rounds += out[2]
        return out
    bufs, status = _launch_levels(lab, q, level, levels, bfs_rounds)
    stop, rounds, which = status.tolist()
    _levels_counts.rounds += rounds
    return (lab if which < 0 else bufs[which]), stop, rounds


def _launch_levels(lab, q, level: int, levels: int, bfs_rounds: int):
    """One launch of the level-scan kernel on checked CUDA operands, on the
    current stream, without synchronising: returns (its two label buffers,
    its status: the stop level, the rounds and which buffer holds the
    labels, -1 for `lab`), and counts the launch in
    ``claim_levels.launches``."""
    b, h, w = lab.shape
    bufs = (torch.empty_like(lab), torch.empty_like(lab))
    # three changed counts, then the status
    scratch = torch.zeros(6, dtype=torch.int32, device=lab.device)
    lib = _kernels.lib("watershed_claim")
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        err = lib.ark_claim_levels_launch(
            lab.data_ptr(), q.data_ptr(), int(level), int(levels), int(bfs_rounds),
            b, h, w, bufs[0].data_ptr(), bufs[1].data_ptr(), scratch.data_ptr(),
            scratch[3:].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"level-scan claim kernel launch failed: "
                           f"{lib.ark_claim_round_error_string(err).decode()} "
                           f"({err})")
    _levels_counts.launches += 1
    return bufs, scratch[3:]


claim_levels.launches = 0
claim_levels.rounds = 0
# the counters' owner under a name of its own: a stand-in patched over
# `claim_levels` (a counting wrapper, a plain version) keeps its own counts
# and never receives the kernel's
_levels_counts = claim_levels


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


def _start_labels(markers, mask) -> torch.Tensor:
    """The level scan's first labels: the markers inside the mask, -1
    outside it (int32, contiguous)."""
    lab = torch.where((markers > 0) & mask, markers.to(torch.int32), 0)
    return torch.where(mask, lab, -1).contiguous()


def _flood(q, markers, mask, levels: int, bfs_rounds: int, stats=None):
    """The level-scan flood on pre-quantized q; returns (labels, converged).
    Labels are mask-encoded (-1 outside the mask) for the claim rounds and
    phase B alike, and decoded at the end. `stats`, a dict, gets the claim
    rounds run as `blocks`."""
    b, h, w = q.shape
    q = q.to(torch.int32).contiguous()
    if q.data_ptr() % 16:               # a view at an offset: the kernels' loads
        q = q.clone()
    lab = _start_labels(markers, mask)
    rep = torch.full_like(lab, h * w)
    converged = True
    level = rounds = 0
    while level < levels:
        lab, level, run = claim_levels(lab, q, level, levels, bfs_rounds)  # phase A
        rounds += run
        if level < levels:                                                 # phase B
            lab, rep, sv_done = _resolve_level(lab, rep, q, mask, level)
            converged = converged and sv_done
            level += 1
    if stats is not None:
        stats["blocks"] = rounds
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


def _relax_plain(pk, qs, labm: int, claimable, absorb: int, n_blocks: int):
    """The relaxation's plain loop on any device: blocks of one sweep,
    ``_MINIMAX_BLOCK`` rounds and a probe round, until a probe changes
    nothing, at most `n_blocks` blocks. Returns (keys, converged, blocks)."""
    done = False
    block = 0
    for block in range(1, n_blocks + 1):
        pk = _minimax_sweep(pk, qs, labm, claimable, absorb)
        for _ in range(_MINIMAX_BLOCK):
            pk = _minimax_round(pk, qs, labm, claimable)
        # certificate: one more NEIGHBOUR round changes nothing
        probe = _minimax_round(pk, qs, labm, claimable)
        done = torch.equal(probe, pk)
        pk = probe
        if done:
            break
    return pk, done, block


def minimax_relax(pk, qs, labm: int, claimable, absorb: int, n_blocks: int):
    """The minimax flood's relaxation from first keys `pk` over shifted
    heights `qs` ((B, H, W) int32, each a multiple of ``labm + 1`` below
    `absorb`; `claimable` bool): the CUDA kernel for CUDA tensors,
    ``_relax_plain`` for CPU ones, in a ``watershed.relax`` span with the
    `blocks` run and the `engine` that ran them ("kernel" or "plain").
    Returns (keys, converged, blocks), those of ``_relax_plain`` bit for bit.
    On CUDA tensors it makes one cooperative launch of
    ``ark_minimax_relax_launch`` on the current stream, never writes into
    its operands, reads its status back once and raises if the launch is
    refused or a height is out of range; it never falls back.
    ``minimax_relax.launches`` counts kernel launches,
    ``minimax_relax.blocks`` the blocks run on either device."""
    with profiling.span("watershed.relax") as span:
        if pk.device.type == "cpu":
            out, engine = _relax_plain(pk, qs, labm, claimable, absorb, n_blocks), "plain"
        else:
            _check_relax_operands(pk, qs, labm, claimable, absorb)
            pk, qs, claimable = (t.contiguous() for t in (pk, qs, claimable))
            bufs, status = _launch_relax(pk, qs, labm, claimable, absorb, n_blocks)
            blocks, which, done, bad = status.tolist()
            if bad:
                raise ValueError(f"minimax_relax: a height is not a multiple of "
                                 f"{labm + 1} in [0, {absorb})")
            out, engine = (bufs[which], bool(done), blocks), "kernel"
        span.attrs.update(engine=engine, blocks=out[2])
    _relax_counts.blocks += out[2]
    return out


def _check_relax_operands(pk, qs, labm: int, claimable, absorb: int):
    """Refuse what the relaxation kernel does not take: a label mask that is
    not 2^lb - 1 (1 <= lb <= 30) or an absorbing gate that is not a positive
    multiple of 2^lb, operands off one CUDA device, dtypes other than int32
    keys and heights and a bool mask, shapes that are not one (B, H, W)."""
    lb = int(labm).bit_length()
    if not (1 <= lb <= 30 and labm == (1 << lb) - 1 and absorb > 0 and absorb & labm == 0):
        raise ValueError(f"minimax_relax: label mask {labm} and absorbing gate {absorb}: "
                         f"the kernel takes 2^lb - 1 (1 <= lb <= 30) and a positive "
                         f"multiple of 2^lb")
    if pk.device.type != "cuda" or any(t.device != pk.device for t in (qs, claimable)):
        raise ValueError(f"minimax_relax: keys on {pk.device}, heights on {qs.device}, "
                         f"claimable on {claimable.device}; the kernel takes all on one "
                         f"CUDA device")
    if pk.dtype != torch.int32 or qs.dtype != torch.int32 or claimable.dtype != torch.bool:
        raise TypeError(f"minimax_relax: the kernel takes int32 keys and heights and a "
                        f"bool mask, got {pk.dtype}, {qs.dtype}, {claimable.dtype}")
    if pk.ndim != 3 or not qs.shape == claimable.shape == pk.shape:
        raise ValueError(f"minimax_relax: (B, H, W) operands of one shape expected, got "
                         f"{[tuple(t.shape) for t in (pk, qs, claimable)]}")


def _launch_relax(pk, qs, labm: int, claimable, absorb: int, n_blocks: int):
    """One launch of the relaxation kernel on checked, contiguous CUDA
    operands, on the current stream, without synchronising: returns (its two
    key buffers, its status: the blocks run, which buffer holds the keys, 1
    if the last probe changed nothing, 1 if a height was refused), and
    counts the launch in ``minimax_relax.launches``."""
    b, h, w = pk.shape
    lb = int(labm).bit_length()
    lib = _kernels.lib("minimax_relax")
    plan = (ctypes.c_longlong * 5)()
    with torch.cuda.device(pk.device):
        err = lib.ark_minimax_relax_plan(lb, int(labm), int(absorb), b, h, w, plan)
        if err == 0:
            tree_bytes, packed_bytes = plan[3], plan[4]
            packed = torch.empty(b * h * w * packed_bytes, dtype=torch.uint8,
                                 device=pk.device)
            tree = torch.empty(max(tree_bytes, 16), dtype=torch.uint8, device=pk.device)
            bufs = (torch.empty_like(pk), torch.empty_like(pk))
            # four flags, then the status
            scratch = torch.zeros(8, dtype=torch.int32, device=pk.device)
            stream = torch.cuda.current_stream(pk.device).cuda_stream
            err = lib.ark_minimax_relax_launch(
                pk.data_ptr(), qs.data_ptr(), claimable.data_ptr(), lb, int(labm),
                int(absorb), int(n_blocks), b, h, w, packed.data_ptr(), tree.data_ptr(),
                tree_bytes, bufs[0].data_ptr(), bufs[1].data_ptr(), scratch.data_ptr(),
                scratch[4:].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"relaxation kernel launch failed: "
                           f"{lib.ark_minimax_relax_error_string(err).decode()} ({err})")
    _relax_counts.launches += 1
    return bufs, scratch[4:]


minimax_relax.launches = 0
minimax_relax.blocks = 0
# the counters' owner under a name of its own, as `_relabel_counts`: a stand-in
# patched over `minimax_relax` keeps its own counts
_relax_counts = minimax_relax


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


def _relabel_plain(lab0, pk, qs, lb: int, labm: int, claimable, n_blocks: int):
    """The re-labeling's plain loop on any device: blocks of
    ``_MINIMAX_BLOCK`` ``_refine_round`` rounds until a block changes
    nothing, at most `n_blocks` blocks. Returns (labels, converged, blocks,
    rounds run)."""
    newlab = lab0
    rdone = False
    block = 0
    for block in range(1, n_blocks + 1):
        new = newlab
        for _ in range(_MINIMAX_BLOCK):
            new = _refine_round(new, pk, qs, lb, labm, claimable)
        rdone = torch.equal(new, newlab)
        newlab = new
        if rdone:
            break
    return newlab, rdone, block, block * _MINIMAX_BLOCK


def _relabel_blocks(rounds: int, converged: bool, n_blocks: int):
    """(blocks, converged) as ``_relabel_plain`` reports them, from the
    rounds a run that stops at the first round changing nothing ran and
    whether that round came. Labels only go from 0 to a label, so a block
    changes nothing iff its first round does: the plain loop ends with the
    block that holds that round if the round opens it, else with the next
    block, unless the budget of `n_blocks` ends first (then the last block
    changed labels and the flag is False)."""
    if not converged:
        return n_blocks, False
    block = -(-rounds // _MINIMAX_BLOCK)
    if (rounds - 1) % _MINIMAX_BLOCK == 0:
        return block, True
    if block < n_blocks:
        return block + 1, True
    return block, False


def minimax_relabel(lab0, pk, qs, lb: int, labm: int, claimable, n_blocks: int):
    """The minimax flood's re-labeling from first labels `lab0` over the
    relaxed keys `pk` and shifted heights `qs` ((B, H, W) int32; `claimable`
    bool): the CUDA kernel for CUDA tensors, ``_relabel_plain`` for CPU
    ones, in a ``watershed.relabel`` span with the plain loop's `blocks`,
    the `rounds` run and the `engine` that ran them ("kernel" or "plain").
    Returns (labels, converged, blocks, rounds run) with the labels, flag
    and blocks of ``_relabel_plain``, bit for bit. On CUDA tensors it makes
    one cooperative launch of ``ark_minimax_relabel_launch`` on the current
    stream, reads its status back once and raises if the launch is refused;
    it never falls back. ``minimax_relabel.launches`` counts kernel
    launches, ``minimax_relabel.rounds`` the rounds run on either device."""
    with profiling.span("watershed.relabel") as span:
        if lab0.device.type == "cpu":
            out, engine = _relabel_plain(lab0, pk, qs, lb, labm, claimable, n_blocks), "plain"
        else:
            _check_relabel_operands(lab0, pk, qs, claimable)
            lab0, pk, qs, claimable = (t.contiguous() for t in (lab0, pk, qs, claimable))
            bufs, status = _launch_relabel(lab0, pk, qs, lb, labm, claimable, n_blocks)
            rounds, which, converged = status.tolist()
            blocks, rdone = _relabel_blocks(rounds, bool(converged), n_blocks)
            out, engine = (bufs[which], rdone, blocks, rounds), "kernel"
        span.attrs.update(engine=engine, blocks=out[2], rounds=out[3])
    _relabel_counts.rounds += out[3]
    return out


def _check_relabel_operands(lab0, pk, qs, claimable):
    """Refuse what the re-labeling kernel does not take: operands off one
    CUDA device, dtypes other than int32 labels, keys and heights and a bool
    mask, shapes that are not one (B, H, W)."""
    if lab0.device.type != "cuda" or any(t.device != lab0.device
                                         for t in (pk, qs, claimable)):
        raise ValueError(f"minimax_relabel: labels on {lab0.device}, keys on "
                         f"{pk.device}, heights on {qs.device}, claimable on "
                         f"{claimable.device}; the kernel takes all on one CUDA device")
    if {lab0.dtype, pk.dtype, qs.dtype} != {torch.int32} \
            or claimable.dtype != torch.bool:
        raise TypeError(f"minimax_relabel: the kernel takes int32 labels, keys and "
                        f"heights and a bool mask, got {lab0.dtype}, {pk.dtype}, "
                        f"{qs.dtype}, {claimable.dtype}")
    if lab0.ndim != 3 or not pk.shape == qs.shape == claimable.shape == lab0.shape:
        raise ValueError(f"minimax_relabel: (B, H, W) operands of one shape expected, "
                         f"got {[tuple(t.shape) for t in (lab0, pk, qs, claimable)]}")


def _launch_relabel(lab0, pk, qs, lb: int, labm: int, claimable, n_blocks: int):
    """One launch of the re-labeling kernel on checked, contiguous CUDA
    operands, on the current stream, without synchronising: returns (its
    two label buffers, its status: the rounds run, which buffer holds the
    labels, 1 if the last round changed nothing), and counts the launch in
    ``minimax_relabel.launches``."""
    b, h, w = lab0.shape
    bufs = (torch.empty_like(lab0), torch.empty_like(lab0))
    edges = torch.empty(lab0.shape, dtype=torch.uint8, device=lab0.device)
    # three changed flags, then the status
    scratch = torch.zeros(6, dtype=torch.int32, device=lab0.device)
    lib = _kernels.lib("minimax_relabel")
    with torch.cuda.device(lab0.device):
        stream = torch.cuda.current_stream(lab0.device).cuda_stream
        err = lib.ark_minimax_relabel_launch(
            lab0.data_ptr(), pk.data_ptr(), qs.data_ptr(), claimable.data_ptr(), int(lb),
            int(labm), _MINIMAX_BLOCK * int(n_blocks), b, h, w, edges.data_ptr(),
            bufs[0].data_ptr(), bufs[1].data_ptr(), scratch.data_ptr(),
            scratch[3:].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"re-labeling kernel launch failed: "
                           f"{lib.ark_minimax_relabel_error_string(err).decode()} ({err})")
    _relabel_counts.launches += 1
    return bufs, scratch[3:]


minimax_relabel.launches = 0
minimax_relabel.rounds = 0
# the counters' owner under a name of its own, as `_levels_counts`: a stand-in
# patched over `minimax_relabel` keeps its own counts
_relabel_counts = minimax_relabel


def _flood_minimax(q, markers, mask, levels: int, rounds: int, stats=None):
    """Minimax flood on pre-quantized q; returns (labels, converged). The
    relaxation (``minimax_relax``: one kernel launch on CUDA tensors, the
    plain loop of sweep-and-round blocks on CPU ones) runs in its
    ``watershed.relax`` span with the `blocks` run and the `engine`; the
    re-labeling (``minimax_relabel``: one kernel launch on CUDA tensors, the
    plain loop of ``_refine_round`` blocks on CPU ones) in its
    ``watershed.relabel`` span with the plain loop's `blocks`, the `rounds`
    run and the `engine` that ran them; `stats`, a dict, gets the two block
    counts' sum as `blocks`. Both kernels keep their plain loop's blocks and
    stopping rule, and their rounds stay synchronous (see
    ``csrc/minimax_relax.cu`` and ``csrc/minimax_relabel.cu``), so keys,
    labels, flags and blocks are the plain loops'."""
    lb = _label_bits(levels)
    labm = (1 << lb) - 1
    lab0 = torch.where((markers > 0) & mask, markers.to(torch.int32), 0)
    pk = torch.where(lab0 > 0, lab0, _LAB_SENTINEL)        # markers frozen
    claimable = mask & (lab0 == 0)
    qs = q.to(torch.int32) << lb
    absorb = levels << lb
    n_blocks = -(-rounds // _MINIMAX_BLOCK)

    pk, done, relax_blocks = minimax_relax(pk, qs, labm, claimable, absorb, n_blocks)
    newlab, rdone, relabel_blocks, _ = minimax_relabel(lab0, pk, qs, lb, labm, claimable,
                                                       n_blocks)
    if stats is not None:
        stats["blocks"] = relax_blocks + relabel_blocks
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
    with profiling.span("watershed.flood", engine=_ENGINE) as sp:
        if _ENGINE == "minimax":
            h, w = q.shape[1:]
            return _flood_minimax(q, markers, mask, levels, rounds=2 * (h + w),
                                  stats=sp.attrs)
        return _flood(q, markers, mask, levels, bfs_rounds, stats=sp.attrs)


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
