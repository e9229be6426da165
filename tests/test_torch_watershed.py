"""ark_tpu_torch.ops.watershed against ark_tpu.ops.watershed on the same
numpy inputs, and the port's exact order statistics against the JAX
package's bisection.

Everything here is integer or exact-order-statistic work, so the tolerance
is none: quantized levels, claim rounds, labels and convergence flags must
be equal bit for bit. The Pallas claim kernel runs in interpret mode, as the
JAX package's own tests run it on the CPU.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from ark_tpu.ops import quantiles as jq
from ark_tpu.ops import watershed as JW
from ark_tpu_torch.ops import _kernels
from ark_tpu_torch.ops import quantiles as tq
from ark_tpu_torch.ops import watershed as TW
from chip_smoke import claim_inputs

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_float_keys_roundtrip_matches_jax():
    x = np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan, 1e-45, -3e38],
                 np.float32)
    ref = np.asarray(jq._float_keys(jnp.asarray(x))).astype(np.int64)
    got = tq._float_keys(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    back = tq._keys_to_float(torch.from_numpy(ref)).numpy()
    np.testing.assert_array_equal(_bits(back), _bits(x))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_order_stats_matches_bisection(seed):
    """Exact order statistics, bit for bit, including -0.0/+0.0 ties, an
    all-invalid column and ranks past the valid count (both give the float
    of key 0xFFFFFFFF)."""
    rng = np.random.default_rng(seed)
    n, c = 301, 5
    x = rng.normal(size=(n, c)).astype(np.float32)
    x[rng.random((n, c)) < 0.1] = 0.0
    x[rng.random((n, c)) < 0.1] = -0.0
    valid = rng.random((n, c)) < 0.6
    valid[:, 3] = False
    nv = valid.sum(0)
    ranks = np.stack([np.zeros(c), nv // 2, np.maximum(nv - 1, 0), nv + 3],
                     axis=1).astype(np.int32)
    ref = jq.masked_order_stats(jnp.asarray(x), jnp.asarray(valid),
                                jnp.asarray(ranks))
    got = tq.masked_order_stats(torch.from_numpy(x), torch.from_numpy(valid),
                                torch.from_numpy(ranks))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


def test_quantize_matches_jax_with_blank_fov():
    """A FOV with no masked pixel has NaN statistics on both sides; its
    levels must still come out equal (XLA converts NaN to 0)."""
    rng = np.random.default_rng(4)
    elev = rng.normal(size=(3, 40, 56)).astype(np.float32)
    mask = rng.random((3, 40, 56)) < 0.7
    mask[1] = False
    ref = JW._quantize(jnp.asarray(elev), jnp.asarray(mask), 256)
    got = TW._quantize(torch.from_numpy(elev), torch.from_numpy(mask), 256)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantize_hot_pixel_matches_jax():
    rng = np.random.default_rng(12345)
    elev = rng.random((1, 48, 48)).astype(np.float32)
    elev[0, 0, 0] = 1e9
    mask = np.ones_like(elev, bool)
    ref = np.asarray(JW._quantize(jnp.asarray(elev), jnp.asarray(mask), 256))
    got = TW._quantize(torch.from_numpy(elev), torch.from_numpy(mask), 256).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0, 0] == 255 and len(np.unique(got)) > 100


@pytest.mark.parametrize("level", [0, 7, 15])
def test_claim_round_matches_jax_and_pallas(level, monkeypatch):
    """The port's plain round == the JAX round (with its mask operand) ==
    the Pallas kernel in interpret mode on the mask-encoded labels, and
    claim_round's changed count == the kernel's."""
    monkeypatch.setattr(JW, "_PALLAS_INTERPRET", True)
    rng = np.random.default_rng(level)
    b, h, w, bh = 2, 32, 128, 8
    lab, q = claim_inputs(rng, (b, h, w), levels=16)
    mask = lab >= 0
    lab0 = np.where(mask, lab, 0).astype(np.int32)
    ref_masked = np.asarray(JW._claim_round(jnp.asarray(lab0), jnp.asarray(q),
                                            jnp.asarray(mask), jnp.int32(level)))
    got_masked = TW._claim_round(torch.from_numpy(lab0), torch.from_numpy(q),
                                 torch.from_numpy(mask), level).numpy()
    np.testing.assert_array_equal(got_masked, ref_masked)

    qhalo = JW._band_halos(jnp.asarray(q), bh)
    ref_p, chg_p = JW._claim_round_pallas(jnp.asarray(lab), jnp.asarray(q), qhalo,
                                          jnp.int32(level), bh)
    got, chg = TW.claim_round(torch.from_numpy(lab), torch.from_numpy(q), level)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_p))
    assert int(chg) == int(chg_p) == int((got.numpy() != lab).sum())
    np.testing.assert_array_equal(np.where(got.numpy() < 0, 0, got.numpy()),
                                  ref_masked)


def _relief(seed, b=2, h=32, w=128, n_markers=5):
    rng = np.random.default_rng(seed)
    elev = np.stack([ndi.gaussian_filter(rng.random((h, w)), 2)
                     for _ in range(b)]).astype(np.float32)
    mask = elev < np.quantile(elev, 0.8, axis=(1, 2), keepdims=True)
    markers = np.zeros_like(elev, np.int32)
    for i in range(b):
        ys, xs = np.where(mask[i])
        for j, k in enumerate(rng.choice(ys.size, n_markers, replace=False)):
            markers[i, ys[k], xs[k]] = j + 1
    return elev, markers, mask


def _levels(elev, mask, levels):
    q = JW._quantize(jnp.asarray(elev), jnp.asarray(mask), levels)
    return q, torch.from_numpy(np.array(q))


def test_level_flood_matches_pallas_flood(monkeypatch):
    """The level engine == the JAX level engine with its Pallas rounds in
    interpret mode: same claims, same ties, same flag."""
    elev, markers, mask = _relief(11)
    qj, qt = _levels(elev, mask, 32)
    monkeypatch.setattr(JW, "_PALLAS_INTERPRET", True)
    JW._flood.clear_cache()
    JW._quantize_and_flood.clear_cache()
    try:
        ref, done = JW._flood(qj, jnp.asarray(markers), jnp.asarray(mask), 32, 4)
        ref, done = np.asarray(ref), bool(done)
    finally:
        JW._flood.clear_cache()
        JW._quantize_and_flood.clear_cache()
    got, got_done = TW._flood(qt, torch.from_numpy(markers), torch.from_numpy(mask),
                              32, 4)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got_done is done is True


@pytest.mark.parametrize("bfs_rounds", [0, 1, 2])
def test_level_flood_phase_b_matches_jax(bfs_rounds):
    """bfs_rounds small enough that phase B (connected components of the
    conductive set, min label per component) finishes most levels."""
    elev, markers, mask = _relief(3, b=3, h=24, w=40, n_markers=6)
    mask[2, :, 20:22] = False
    qj, qt = _levels(elev, mask, 64)
    ref, done = JW._flood(qj, jnp.asarray(markers), jnp.asarray(mask), 64,
                          bfs_rounds)
    got, got_done = TW._flood(qt, torch.from_numpy(markers), torch.from_numpy(mask),
                              64, bfs_rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got_done == bool(done)


_jax_round = jax.jit(JW._claim_round)


def _jax_claim_levels(lab, q, mask, level, levels, bfs_rounds):
    """Phase A as the JAX package's level scan runs it: JW._claim_round on
    labels with a mask operand, each level until a round changes nothing or
    `bfs_rounds` rounds have run. Returns (labels, stop level, rounds)."""
    lab, q, mask = jnp.asarray(lab), jnp.asarray(q), jnp.asarray(mask)
    rounds = 0
    while level < levels:
        for _ in range(bfs_rounds):
            new = _jax_round(lab, q, mask, jnp.int32(level))
            rounds += 1
            done = bool(jnp.all(new == lab))
            lab = new
            if done:
                break
        else:
            return np.asarray(lab), level, rounds
        level += 1
    return np.asarray(lab), level, rounds


def _claim_levels_inputs(kind):
    """(mask-encoded labels, levels, level count): claim_inputs' random
    labels, or markers on a smooth relief with a masked band."""
    if kind == "random":
        lab, q = claim_inputs(np.random.default_rng(21), (2, 24, 37), levels=16)
        return lab, q, 16
    elev, markers, mask = _relief(5, b=2, h=24, w=40, n_markers=4)
    mask[1, :, 18:20] = False
    q = np.array(JW._quantize(jnp.asarray(elev), jnp.asarray(mask), 32))
    return np.where(mask, markers, -1).astype(np.int32), q, 32


@pytest.mark.parametrize("kind", ["random", "relief"])
@pytest.mark.parametrize("start", ["first", "mid"])
@pytest.mark.parametrize("bfs_rounds", [0, 1, 2, 32])
def test_claim_levels_matches_jax_round_loop(kind, start, bfs_rounds):
    """The plain level scan == a loop of the JAX package's round with its
    break rule: labels (decoded), stop level and rounds, bit for bit; the
    wrapper gives the same on CPU tensors and counts its rounds, and the
    mask's -1 stays where it was."""
    lab, q, levels = _claim_levels_inputs(kind)
    level = 0 if start == "first" else levels // 2
    mask = lab >= 0
    want, want_stop, want_rounds = _jax_claim_levels(np.where(mask, lab, 0), q, mask,
                                                     level, levels, bfs_rounds)
    got, stop, rounds = TW._claim_levels(torch.from_numpy(lab), torch.from_numpy(q),
                                         level, levels, bfs_rounds)
    np.testing.assert_array_equal(np.where(mask, got.numpy(), 0), want)
    assert ((got.numpy() == -1) == ~mask).all()
    assert (stop, rounds) == (want_stop, want_rounds)
    # the budgets under 32 leave levels to phase B; 32 converges everywhere
    assert (stop < levels) == (bfs_rounds < 32)
    before = TW.claim_levels.rounds, TW.claim_levels.launches
    again = TW.claim_levels(torch.from_numpy(lab), torch.from_numpy(q), level, levels,
                            bfs_rounds)
    assert torch.equal(again[0], got) and again[1:] == (stop, rounds)
    assert (TW.claim_levels.rounds, TW.claim_levels.launches) == (
        before[0] + rounds, before[1])


def test_claim_levels_refuses_what_the_kernel_does_not_take():
    """int64, a transposed layout, operands on two devices and a view that
    starts off a 16-byte boundary (the kernel's loads are 16 bytes) raise,
    on the CPU as on the card."""
    lab, q = (torch.from_numpy(a) for a in claim_inputs(np.random.default_rng(2),
                                                        (2, 6, 9)))
    with pytest.raises(TypeError, match="int32"):
        TW.claim_levels(lab.to(torch.int64), q.to(torch.int64), 0, 16, 2)
    with pytest.raises(ValueError, match="contiguous"):
        TW.claim_levels(lab.transpose(1, 2), q.transpose(1, 2), 0, 16, 2)
    with pytest.raises(ValueError, match="CUDA"):
        TW.claim_levels(lab, q.to("meta"), 0, 16, 2)
    assert lab[1:].is_contiguous() and lab[1:].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        TW.claim_levels(lab[1:], q[1:], 0, 16, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TW.claim_levels(lab[1:].clone(), q[1:], 0, 16, 2)


def test_level_flood_takes_levels_at_an_offset():
    """The level flood copies levels that start off a 16-byte boundary, so
    its claim rounds take them: the same labels and flag as from a fresh
    tensor."""
    elev, markers, mask = _relief(9, b=3, h=7, w=129, n_markers=4)
    q = torch.from_numpy(np.array(JW._quantize(jnp.asarray(elev), jnp.asarray(mask),
                                               256)))
    m, k = torch.from_numpy(markers), torch.from_numpy(mask)
    assert q[1:].data_ptr() % 16
    got = TW._flood(q[1:], m[1:], k[1:], 256, 2)
    want = TW._flood(q[1:].clone(), m[1:], k[1:], 256, 2)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]


def test_claim_levels_loop_of_rounds_is_the_plain_scan():
    """``_claim_levels`` given the one-round wrapper (the loop of one-round
    launches the level scan ran before its kernel) == its plain default,
    at a budget that leaves levels to phase B and at one that does not."""
    lab, q, levels = _claim_levels_inputs("relief")
    lab, q = torch.from_numpy(lab), torch.from_numpy(q)
    for bfs_rounds in (2, 32):
        got = TW._claim_levels(lab, q, 0, levels, bfs_rounds, TW.claim_round)
        want = TW._claim_levels(lab, q, 0, levels, bfs_rounds)
        assert torch.equal(got[0], want[0]) and got[1:] == want[1:]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minimax_flood_matches_jax(seed):
    elev, markers, mask = _relief(20 + seed, b=2, h=40, w=48, n_markers=6)
    qj, qt = _levels(elev, mask, 256)
    ref, done = JW._flood_minimax(qj, jnp.asarray(markers), jnp.asarray(mask), 256,
                                  rounds=2 * (40 + 48))
    got, got_done = TW._flood_minimax(qt, torch.from_numpy(markers),
                                      torch.from_numpy(mask), 256, 2 * (40 + 48))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got_done is bool(done) is True


@pytest.mark.parametrize("rounds", [1, 128])
def test_minimax_round_budget_flag_matches_jax(rounds):
    """One block cannot certify a 32x32 flood from a corner (False on both
    sides, equal partial labels); 128 rounds can."""
    markers = np.zeros((1, 32, 32), np.int32)
    markers[0, 0, 0] = 1
    q = np.zeros((1, 32, 32), np.int32)
    mask = np.ones((1, 32, 32), bool)
    ref, done = JW._flood_minimax(jnp.asarray(q), jnp.asarray(markers),
                                  jnp.asarray(mask), 256, rounds=rounds)
    got, got_done = TW._flood_minimax(torch.from_numpy(q), torch.from_numpy(markers),
                                      torch.from_numpy(mask), 256, rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got_done is bool(done) is (rounds == 128)


def _relabel_by_edges(lab0, pk, qs, lb, labm, claimable, n_blocks):
    """The re-labeling kernel's algorithm (csrc/minimax_relabel.cu) in plain
    torch: each pixel's four neighbour tests reduced once to bits of a byte
    (none past the edge, none for a pixel that cannot take a label), then
    synchronous rounds that read only those bits and the labels, stopping at
    the first round that changes nothing or after 16 * n_blocks rounds, and
    the block rule. Returns (labels, converged, blocks, rounds)."""
    sent = TW._LAB_SENTINEL
    h, w = lab0.shape[1:]
    near = ((slice(None, h), slice(1, w + 1)), (slice(2, None), slice(1, w + 1)),
            (slice(1, h + 1), slice(None, w)), (slice(1, h + 1), slice(2, None)))
    exitv = torch.nn.functional.pad(TW._lift(pk, qs, labm) >> lb, (1, 1, 1, 1), value=-1)
    can = claimable & (pk != sent)
    edges = torch.zeros(lab0.shape, dtype=torch.uint8)
    for bit, (rows, cols) in enumerate(near):
        edges |= ((exitv[:, rows, cols] == (pk >> lb)) & can).to(torch.uint8) << bit
    lab, rounds, converged = lab0, 0, False
    while rounds < TW._MINIMAX_BLOCK * n_blocks and not converged:
        lv = torch.nn.functional.pad(torch.where(lab > 0, lab, sent), (1, 1, 1, 1),
                                     value=sent)
        cand = torch.full_like(lab, sent)
        for bit, (rows, cols) in enumerate(near):
            cand = torch.minimum(cand, torch.where((edges >> bit) & 1 == 1,
                                                   lv[:, rows, cols], sent))
        new = torch.where((lab == 0) & (cand < sent), cand, lab)
        rounds += 1
        converged = torch.equal(new, lab)
        lab = new
    blocks, rdone = TW._relabel_blocks(rounds, converged, n_blocks)
    return lab, rdone, blocks, rounds


def _relabel_operands(kind, seed, monkeypatch, fn="minimax_relabel"):
    """The re-labeling's operands as ``_flood_minimax`` hands them over
    (after its relaxation), or with `fn` "minimax_relax" the relaxation's:
    a relief at 256 levels, the same at 8 levels (wide plateaus, ties
    everywhere), a batch of 3 at W % 4 != 0 with an empty mask and an image
    without markers, a flood from a corner of a flat 32 x 32 image (seed 0
    the top left, 1 the bottom right), or (a shape) 8 levels of noise with
    sparse markers."""
    if isinstance(kind, tuple):
        rng = np.random.default_rng(seed)
        q = rng.integers(0, 8, kind).astype(np.int32)
        mask = rng.random(kind) < 0.9
        markers = np.where(rng.random(kind) < 0.02, rng.integers(1, 9, kind), 0)
        markers.reshape(-1)[seed % markers.size] = 3
        markers, levels = markers.astype(np.int32), 8
    elif kind == "corner":
        q = np.zeros((1, 32, 32), np.int32)
        markers = np.zeros((1, 32, 32), np.int32)
        markers[0, -seed, -seed] = 1          # the top left or bottom right corner
        mask, levels = np.ones((1, 32, 32), bool), 256
    else:
        b, w = (3, 37) if kind == "batch3" else (2, 48)
        elev, markers, mask = _relief(40 + seed, b=b, h=40, w=w, n_markers=6)
        if kind == "batch3":
            mask[1] = False
            markers[2] = 0
        levels = 8 if kind == "plateaus" else 256
        q = np.array(JW._quantize(jnp.asarray(elev), jnp.asarray(mask), levels))
    got = {}
    real = getattr(TW, fn)

    def capture(*args):
        got["args"] = args
        return real(*args)

    monkeypatch.setattr(TW, fn, capture)
    h, w = q.shape[1:]
    TW._flood_minimax(torch.from_numpy(q), torch.from_numpy(markers),
                      torch.from_numpy(mask), levels, 2 * (h + w))
    monkeypatch.setattr(TW, fn, real)
    return got["args"]


@pytest.mark.parametrize("kind", ["relief", "plateaus", "batch3", "corner"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("budget", [None, 1, 2])
def test_relabel_kernel_algorithm_matches_refine_loop(kind, seed, budget, monkeypatch):
    """The kernel's algorithm (edge bits once, synchronous rounds, the first
    round that changes nothing, the block rule) == the plain loop of
    ``_refine_round`` blocks, bitwise: labels, flag and blocks, at the
    flood's budget and at budgets of 1 and 2 blocks, where the flag is False
    and the partial labels are still equal."""
    *args, n_blocks = _relabel_operands(kind, seed, monkeypatch)
    n_blocks = n_blocks if budget is None else budget
    want = TW._relabel_plain(*args, n_blocks)
    got = _relabel_by_edges(*args, n_blocks)
    assert torch.equal(got[0], want[0])
    assert got[1:3] == want[1:3]
    assert want[3] == TW._MINIMAX_BLOCK * want[2]
    assert want[3] - 2 * TW._MINIMAX_BLOCK < got[3] <= want[3]
    if kind == "corner" and budget is not None:
        assert want[1] is False and int((want[0] > 0).sum()) < 32 * 32
    if budget is None:
        assert want[1] is True and want[2] > 1


@pytest.mark.parametrize("rounds,converged,n_blocks,want", [
    (1, True, 5, (1, True)),       # the first round changes nothing
    (17, True, 5, (2, True)),      # the round that opens block 2
    (5, True, 5, (2, True)),       # block 1 changed labels, block 2 did not
    (16, True, 2, (2, True)),
    (5, True, 1, (1, False)),      # the budget ends with a block that changed
    (16, True, 1, (1, False)),
    (80, False, 5, (5, False)),    # no round without a change
    (0, False, 0, (0, False)),     # no budget
])
def test_relabel_block_rule(rounds, converged, n_blocks, want):
    """The blocks and the flag the plain loop reports, from the rounds to
    the first round that changes nothing."""
    assert TW._relabel_blocks(rounds, converged, n_blocks) == want


def test_minimax_relabel_counts_and_refuses(monkeypatch):
    """On CPU tensors the wrapper is the plain loop and counts its rounds,
    no launch; a device that is not CUDA raises before any library is
    built."""
    def refuse(name):
        raise AssertionError("the library was asked for")

    *args, n_blocks = _relabel_operands("relief", 0, monkeypatch)
    monkeypatch.setattr(_kernels, "lib", refuse)
    before = TW.minimax_relabel.launches, TW.minimax_relabel.rounds
    got = TW.minimax_relabel(*args, n_blocks)
    want = TW._relabel_plain(*args, n_blocks)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    assert (TW.minimax_relabel.launches, TW.minimax_relabel.rounds) == (
        before[0], before[1] + want[3])
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        TW.minimax_relabel(*meta, n_blocks)


def _comb(labm):
    """The sweep's comb on (keys, gates), as ``_minimax_sweep`` has it."""
    def comb(a, b):
        return [torch.minimum(b[0], TW._lift(a[0], b[1], labm)), torch.maximum(a[1], b[1])]
    return comb


def _scan_by_levels(c, g, labm):
    """``jax.lax.associative_scan``'s tree over the last dim of (lines, n)
    keys `c` and gates `g`, level by level by index arithmetic, as the
    relaxation kernel (csrc/minimax_relax.cu) runs it: up, level l + 1 holds
    the combs of level l's pairs (2i, 2i + 1); down, S[0] = A[0], S[2k + 1]
    = S'[k] and S[2k + 2] = comb(S'[k], A[2k + 2]) from the scan S' of the
    level above, keeping only keys. Returns the scan's keys."""
    def comb_key(c1, c2, g2):
        return torch.minimum(c2, TW._lift(c1, g2, labm))

    levels = [(c, g)]
    while levels[-1][0].shape[1] >= 2:
        a_c, a_g = levels[-1]
        i = torch.arange(a_c.shape[1] // 2)
        levels.append((comb_key(a_c[:, 2 * i], a_c[:, 2 * i + 1], a_g[:, 2 * i + 1]),
                       torch.maximum(a_g[:, 2 * i], a_g[:, 2 * i + 1])))
    s = levels[-1][0]
    for a_c, a_g in reversed(levels[:-1]):
        j = torch.arange(a_c.shape[1])
        odd, even = j[1::2], j[2::2]
        out = a_c.clone()
        out[:, odd] = s[:, (odd - 1) // 2]
        out[:, even] = comb_key(s[:, even // 2 - 1], a_c[:, even], a_g[:, even])
        s = out
    return s


def _packed_heights(pk, qs, labm, claimable):
    """The kernel's first phase: a pixel's height bucket, its gate bit (open
    where it is claimable or its key holds a bare label) and its claimable
    bit in one integer, once a flood."""
    lb = labm.bit_length()
    return ((qs >> lb) << 2) | ((claimable | (pk <= labm)).to(torch.int32) << 1) \
        | claimable.to(torch.int32)


def _sweep_by_levels(pk, packed, labm, absorb):
    """The kernel's sweep: four passes in the plain order, each over lines
    whose gates come from the packed bits, the scan by ``_scan_by_levels``."""
    lb = labm.bit_length()
    claim = (packed & 1) == 1
    gate = torch.where((packed & 2) == 2, (packed >> 2) << lb, absorb)
    for along_w, reverse in ((True, False), (True, True), (False, False), (False, True)):
        k, g = (pk, gate) if along_w else (pk.transpose(1, 2), gate.transpose(1, 2))
        shape = k.shape
        k, g = k.reshape(-1, shape[2]), g.reshape(-1, shape[2])
        if reverse:
            k, g = k.flip(1), g.flip(1)
        g_in = torch.cat([torch.full_like(g[:, :1], absorb), g[:, :-1]], 1)
        c = _scan_by_levels(k, g_in, labm)
        cand = torch.where(c >= absorb, TW._LAB_SENTINEL, c)
        cand = (cand.flip(1) if reverse else cand).reshape(shape)
        cand = cand if along_w else cand.transpose(1, 2)
        pk = torch.where(claim, torch.minimum(pk, cand), pk)
    return pk


def _round_by_packed(pk, packed, labm):
    """One synchronous round as the kernel runs it, from the packed heights:
    a claimable pixel takes min(key, lifted neighbour keys), INF past the
    edges."""
    lb = labm.bit_length()
    sent = TW._LAB_SENTINEL
    lifted = torch.nn.functional.pad(TW._lift(pk, (packed >> 2) << lb, labm),
                                     (1, 1, 1, 1), value=sent)
    h, w = pk.shape[1:]
    cand = torch.minimum(torch.minimum(lifted[:, :h, 1:w + 1], lifted[:, 2:, 1:w + 1]),
                         torch.minimum(lifted[:, 1:h + 1, :w], lifted[:, 1:h + 1, 2:]))
    return torch.where((packed & 1) == 1, torch.minimum(pk, cand), pk)


def _relax_by_levels(pk, qs, labm, claimable, absorb, n_blocks):
    """The relaxation kernel's algorithm in plain torch: heights packed once,
    then blocks of a sweep (``_sweep_by_levels``), 16 rounds and a probe
    round, the keys the probe's, stopping at the first block whose probe
    changed nothing or after `n_blocks`. Returns (keys, converged, blocks)."""
    packed = _packed_heights(pk, qs, labm, claimable)
    blocks = 0
    while blocks < n_blocks:
        blocks += 1
        pk = _sweep_by_levels(pk, packed, labm, absorb)
        for _ in range(TW._MINIMAX_BLOCK):
            pk = _round_by_packed(pk, packed, labm)
        probe = _round_by_packed(pk, packed, labm)
        changed = not torch.equal(probe, pk)
        pk = probe
        if not changed:
            return pk, True, blocks
    return pk, False, blocks


@pytest.mark.parametrize("n", [1, 2, 3, 37, 1023, 1024])
@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_by_levels_is_the_associative_scan(n, dim, reverse):
    """The kernel's level-by-level tree == ``_associative_scan``'s recursion,
    bitwise, on lines of odd and even lengths along either image dimension
    and in either direction, over 8-level keys whose values tie everywhere
    (labels 1-5, some INF) and gates that include the absorbing one."""
    rng = np.random.default_rng(n * 4 + dim * 2 + reverse)
    lb = TW._label_bits(8)
    labm, absorb = (1 << lb) - 1, 8 << lb
    shape = (2, n, 3) if dim == 1 else (2, 3, n)
    c = torch.from_numpy((rng.integers(0, 8, shape) << lb | rng.integers(1, 6, shape))
                         .astype(np.int32))
    c = torch.where(torch.from_numpy(rng.random(shape) < 0.1), TW._LAB_SENTINEL, c)
    g = torch.from_numpy((rng.integers(0, 9, shape) << lb).astype(np.int32))
    if reverse:
        c, g = c.flip(dim), g.flip(dim)
    want = TW._associative_scan(_comb(labm), [c, g], dim)[0]
    lines = [x.movedim(dim, -1) for x in (c, g)]
    got = _scan_by_levels(*(x.reshape(-1, n) for x in lines), labm)
    assert torch.equal(got.reshape(lines[0].shape).movedim(-1, dim), want)
    assert n < 3 or not torch.equal(want, c)          # the scan moved keys


RELAX_KINDS = ["relief", "plateaus", "batch3", "corner", (1, 1, 1024), (1, 1023, 2),
               (2, 3, 37), (3, 2, 1), (1, 37, 1024)]


@pytest.mark.parametrize("kind", RELAX_KINDS)
def test_sweep_by_levels_matches_minimax_sweep(kind, monkeypatch):
    """The kernel's sweep (gates from bits packed once a flood, the tree
    level by level) == ``_minimax_sweep`` (gates from the keys entering each
    sweep, the recursion), bitwise, at every block of the flood's
    relaxation: the gate never changes within a flood."""
    pk, qs, labm, claimable, absorb, n_blocks = _relabel_operands(
        kind, 1, monkeypatch, fn="minimax_relax")
    packed = _packed_heights(pk, qs, labm, claimable)
    for _ in range(min(n_blocks, 3)):
        want = TW._minimax_sweep(pk, qs, labm, claimable, absorb)
        assert torch.equal(_sweep_by_levels(pk, packed, labm, absorb), want)
        assert torch.equal(_round_by_packed(want, packed, labm),
                           TW._minimax_round(want, qs, labm, claimable))
        pk = TW._minimax_round(want, qs, labm, claimable)


@pytest.mark.parametrize("kind", RELAX_KINDS)
@pytest.mark.parametrize("budget", [None, 1, 2])
def test_relax_kernel_algorithm_matches_plain_loop(kind, budget, monkeypatch):
    """The kernel's algorithm (heights packed once, the tree level by level,
    Jacobi rounds, the probe's keys, the first probe that changes nothing)
    == ``_relax_plain``, bitwise: keys, flag and blocks, at the flood's
    budget and at budgets of 1 and 2 blocks."""
    *args, n_blocks = _relabel_operands(kind, 0, monkeypatch, fn="minimax_relax")
    n_blocks = n_blocks if budget is None else budget
    want = TW._relax_plain(*args, n_blocks)
    got = _relax_by_levels(*args, n_blocks)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    if budget is None:
        assert want[1] is True and want[2] >= 1
    if kind in ("relief", "plateaus", (1, 37, 1024)) and budget is not None:
        assert want[1] is False                       # 3 to 5 blocks at the full budget


def test_minimax_relax_counts_and_refuses(monkeypatch):
    """On CPU tensors the wrapper is the plain loop and counts its blocks, no
    launch, in a ``watershed.relax`` span whose engine is "plain"; a device
    that is not CUDA, a label mask that is not 2^lb - 1 and an absorbing
    gate off the value bits raise before any library is built."""
    from ark_tpu_torch.utils import profiling

    def refuse(name):
        raise AssertionError("the library was asked for")

    *args, n_blocks = _relabel_operands("relief", 0, monkeypatch, fn="minimax_relax")
    monkeypatch.setattr(_kernels, "lib", refuse)
    before = TW.minimax_relax.launches, TW.minimax_relax.blocks
    profiling.reset()
    try:
        with profiling.recording():
            got = TW.minimax_relax(*args, n_blocks)
        (span,) = [s for s in profiling.spans() if s["name"] == "watershed.relax"]
    finally:
        profiling.reset()
    want = TW._relax_plain(*args, n_blocks)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    assert span["attrs"] == {"engine": "plain", "blocks": want[2]}
    assert (TW.minimax_relax.launches, TW.minimax_relax.blocks) == (
        before[0], before[1] + want[2])
    pk, qs, labm, claimable, absorb = args
    meta = [a.to("meta") for a in (pk, qs, claimable)]
    with pytest.raises(ValueError, match="CUDA"):
        TW.minimax_relax(meta[0], meta[1], labm, meta[2], absorb, n_blocks)
    with pytest.raises(ValueError, match="label mask"):
        TW._check_relax_operands(*[a.to("meta") for a in (pk, qs)], labm - 1,
                                 claimable.to("meta"), absorb)
    with pytest.raises(ValueError, match="label mask"):
        TW._check_relax_operands(*[a.to("meta") for a in (pk, qs)], labm,
                                 claimable.to("meta"), absorb + 1)


@pytest.mark.parametrize("engine", ["minimax", "levels"])
def test_masked_gap_blocks_the_flood(engine, monkeypatch):
    """A corridor with a full-height masked gap: the far side stays 0 under
    both engines, equal to the JAX package's labels."""
    monkeypatch.setattr(JW, "_ENGINE", engine)
    monkeypatch.setattr(TW, "_ENGINE", engine)
    elev = np.zeros((8, 64), np.float32)
    mask = np.ones((8, 64), bool)
    mask[:, 30:34] = False
    markers = np.zeros((8, 64), np.int32)
    markers[4, 2] = 1
    JW._quantize_and_flood.clear_cache()
    ref, done = JW.watershed_device(elev, markers, mask)
    JW._quantize_and_flood.clear_cache()
    got, got_done = TW.watershed_device(elev, markers, mask, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got_done is bool(done) is True
    assert (got.numpy()[:, 34:] == 0).all()


def test_watershed_batch_np_falls_back_to_native(monkeypatch):
    rng = np.random.default_rng(6)
    elev = rng.random((2, 16, 16)).astype(np.float32)
    markers = np.zeros_like(elev, np.int32)
    markers[:, 8, 8] = 1
    mask = np.ones_like(elev, bool)
    real = TW.watershed_device
    monkeypatch.setattr(TW, "watershed_device",
                        lambda *a, **k: (real(*a, **k)[0], False))
    got = TW.watershed_batch_np(elev, markers, mask, device="cpu")
    want = np.stack([JW.watershed(elev[i], markers[i], mask[i]) for i in range(2)])
    np.testing.assert_array_equal(got, want)


def test_claim_round_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Off the CPU, claim_round launches the kernel or raises; it never runs
    the plain round, and a device that is not CUDA raises before any
    library is built."""
    def refuse(name):
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_kernels, "lib", refuse)
    lab = torch.empty((1, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TW.claim_round(lab, lab, 0)
    before = TW.claim_round.launches
    got, chg = TW.claim_round(torch.zeros((1, 4, 4), dtype=torch.int32),
                              torch.zeros((1, 4, 4), dtype=torch.int32), 0)
    assert int(chg) == 0 and TW.claim_round.launches == before
