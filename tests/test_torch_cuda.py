"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here carries the `cuda` marker and skips without a card. The
file imports no jax, so it also runs on a machine without it, apart from
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Tolerances: the claim kernels, the relaxation and re-labeling kernels and
the floods are integer work, bitwise; BMU indices may differ only where the plain
version's two best nodes are closer than 1e-6 * max(|d|, 1), and distances
carry the f32 summation-order tolerance of tests/test_torch_som.py; a
duplicated node's tie goes to the lowest index. The segment-sum kernel is
bitwise equal to the plain version run on a CPU copy (row 0, the
background's sums, included; zero on both with ``background=False``; NaN
where it has NaN) and to a second run of itself, on the CPU parity tests'
images, widths and flat ids (tests/segment_sum_cases.py), and the plan
kernel's boxes equal its plain version's.

The spatial stage has no kernel of its own; its device work is held to the
CPU port: distances (D <= 4), neighbor counts, distance files and the
enrichment null given the same permutations bitwise; D > 4 within the
summation-order bound of tests/test_torch_distances.py; k-means (f64, the
same seeding on every device) to equal labels.

The classical image ops have no kernel either: the squared EDT (int32
min-plus) and its correctly rounded root are bitwise equal to the CPU
port's, and the fiber labels are held to the CPU port's by the
near-threshold rule of ``chip_smoke.fiber_labels_differ``.

Cluster masks, overlays and coloured masks are integers and uint8: equal to
the CPU port's. UMAP's epochs go through the segment-sum kernel (2 sums an
epoch, 2 plans a fit); its seeded negatives are equal on both devices, and
a few epochs from the same start agree by ``chip_smoke``'s rule for them
(pow differs in the last bits, and the epochs are a chaotic map).

Spatial LDA has no kernel either: its featurized counts are bitwise the CPU
port's, its digamma (XLA's Lanczos formula) within 1e-6 of the CPU's, one
outer EM step within the CPU tests' bounds for one step against the JAX
package.

The single-image labeling, area filter and hole filling are integer work
and the bisection quantiles exact order statistics: bitwise the CPU port's.
The profiler's trace holds CUDA kernel events, and the prefetch loader's
copies on its own stream reach the consumer equal to the host arrays. The
cell table's FOV upload (planes in pinned memory, one non-blocking copy,
the channel-last interleave on the card) is bitwise the DataArray path's,
and a pending copy keeps its host block from the next FOV.
"""

import os

import numpy as np
import pytest
import torch

from ark_tpu_torch.analysis import spatial_analysis_utils as TSA
from ark_tpu_torch.analysis import spatial_enrichment as TSE
from ark_tpu_torch.ops import distances as TD
from ark_tpu_torch.ops import kmeans as TK
from ark_tpu_torch.ops import segment_reduce as TSR
from ark_tpu_torch.ops import som as tsom
from ark_tpu_torch.ops import watershed as TW
from ark_tpu_torch.ops import edt as TE
from ark_tpu_torch.ops import umap as TU
from ark_tpu_torch.segmentation import fiber_segmentation as TF
from ark_tpu_torch.utils import data_utils as TDU
from ark_tpu_torch.utils import plot_utils as TPU
from tests import segment_sum_cases as cases
from chip_smoke import (CLAIM_BUDGETS, CLAIM_SHAPES, DIST_ATOL, DIST_RTOL, EXCUSED_SHARE,
                        FIBER_DEFAULTS, OPT_ATOL, OPT_EPOCHS, OPT_OUTLIERS, OPT_WORST,
                        claim_inputs, dense_masks,
                        fiber_image, fiber_labels_differ, pixel_rows)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda"


@pytest.mark.cuda
def test_bmu_kernel_matches_plain_on_cuda(card):
    """The BMU kernel against bmu_plain on the card, on row-normalized rows
    like the pixel stage's (|x|^2 <= 1; far larger rows cancel in f32)."""
    rng = np.random.default_rng(11)
    for n, c, k in [(1, 3, 7), (1000, 7, 100), (70_001, 40, 144),
                    (5000, 16, 1), (3001, 80, 33)]:
        x = torch.as_tensor(pixel_rows(rng, n, c), device=card)
        w = torch.as_tensor(pixel_rows(rng, k, c), device=card)
        idx_k, dist_k = tsom.bmu(w, x, return_dist=True)
        idx_p, dist_p = tsom.bmu_plain(w, x, return_dist=True)
        d = (w * w).sum(1)[None, :] - 2.0 * (x @ w.T)
        if k > 1:
            two = torch.topk(d, 2, dim=1, largest=False).values
            ties = (two[:, 1] - two[:, 0]) < 1e-6 * two[:, 0].abs().clamp_min(1)
        else:
            ties = torch.zeros(n, dtype=torch.bool, device=card)
        assert not bool(((idx_k != idx_p) & ~ties).any())
        torch.testing.assert_close(dist_k, dist_p, rtol=DIST_RTOL,
                                   atol=DIST_ATOL)


def _bmu_matches_plain(card, rng, n, c, k, dup=False):
    x = torch.as_tensor(pixel_rows(rng, n, c), device=card)
    w0 = torch.as_tensor(pixel_rows(rng, k, c), device=card)
    w = torch.cat([w0, w0]) if dup else w0    # every node twice: exact ties
    idx_k, dist_k = tsom.bmu(w, x, return_dist=True)
    idx_only, _ = tsom.bmu(w, x, return_dist=False)
    idx_p, dist_p = tsom.bmu_plain(w, x, return_dist=True)
    assert torch.equal(idx_k, idx_only)
    if dup:
        assert bool((idx_k < k).all()), "a duplicated node lost its tie"
    d = (w0 * w0).sum(1)[None, :] - 2.0 * (x @ w0.T)
    if k > 1:
        two = torch.topk(d, 2, dim=1, largest=False).values
        ties = (two[:, 1] - two[:, 0]) < 1e-6 * two[:, 0].abs().clamp_min(1)
    else:
        ties = torch.zeros(n, dtype=torch.bool, device=card)
    assert not bool(((idx_k != idx_p) & ~ties).any())
    torch.testing.assert_close(dist_k, dist_p, rtol=DIST_RTOL, atol=DIST_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4, 5, 16, 20, 33, 64, 65])
def test_bmu_kernel_register_widths_on_cuda(card, c):
    """Every register width (C rounded up to 4 or 8) and the wide path,
    across node counts at and past the 128-node chunk; N = 1037 is no
    multiple of any block's rows."""
    rng = np.random.default_rng(c)
    for k in (1, 100, 128, 129, 300):
        _bmu_matches_plain(card, rng, 1037, c, k)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 16, 20, 64])
def test_bmu_kernel_duplicated_nodes_on_cuda(card, c):
    _bmu_matches_plain(card, np.random.default_rng(100 + c), 5000, c, 50, dup=True)


@pytest.mark.cuda
def test_claim_kernel_matches_plain_on_cuda(card):
    """The claim kernel == the plain round, bitwise, labels and changed
    counts, at ragged shapes and three levels; what the kernel does not
    take raises."""
    rng = np.random.default_rng(0)
    for shape in ((1, 1, 1), (2, 7, 129), (4, 33, 1000), (2, 512, 512)):
        lab_np, q_np = claim_inputs(rng, shape)
        lab = torch.as_tensor(lab_np, device=card)
        q = torch.as_tensor(q_np, device=card)
        for level in (0, 128, 255):
            before = TW.claim_round.launches
            got, chg = TW.claim_round(lab, q, level)
            want = TW._claim_round(lab, q, None, level)
            assert torch.equal(got, want)
            assert int(chg) == int((want != lab).sum())
            assert TW.claim_round.launches == before + 1
    with pytest.raises(TypeError, match="int32"):
        TW.claim_round(lab.to(torch.int64), q.to(torch.int64), 0)
    with pytest.raises(ValueError, match="contiguous"):
        TW.claim_round(lab.transpose(1, 2), q.transpose(1, 2), 0)
    with pytest.raises(ValueError, match="CUDA"):
        TW.claim_round(lab, q.cpu(), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bfs_rounds", CLAIM_BUDGETS)
def test_claim_levels_kernel_matches_plain_on_cuda(card, bfs_rounds):
    """The level-scan kernel == the plain scan, bitwise: labels, stop level
    and rounds, from level 0 and mid-way, at the smoke's claim shapes; one
    launch a call, and its input is not written."""
    rng = np.random.default_rng(bfs_rounds)
    for shape in CLAIM_SHAPES:
        lab_np, q_np = claim_inputs(rng, shape)
        lab = torch.as_tensor(lab_np, device=card)
        q = torch.as_tensor(q_np, device=card)
        for level in (0, 128):
            before = TW.claim_levels.launches
            got, stop, rounds = TW.claim_levels(lab, q, level, 256, bfs_rounds)
            assert TW.claim_levels.launches == before + 1
            want, want_stop, want_rounds = TW._claim_levels(lab, q, level, 256, bfs_rounds)
            assert torch.equal(got, want) and (stop, rounds) == (want_stop, want_rounds)
            assert torch.equal(lab.cpu(), torch.from_numpy(lab_np))


@pytest.mark.cuda
def test_claim_levels_refuses_what_the_kernel_does_not_take_on_cuda(card):
    lab, q = (torch.as_tensor(a, device=card)
              for a in claim_inputs(np.random.default_rng(1), (2, 8, 12)))
    with pytest.raises(TypeError, match="int32"):
        TW.claim_levels(lab.to(torch.int64), q.to(torch.int64), 0, 256, 2)
    with pytest.raises(ValueError, match="contiguous"):
        TW.claim_levels(lab.transpose(1, 2), q.transpose(1, 2), 0, 256, 2)
    with pytest.raises(ValueError, match="CUDA"):
        TW.claim_levels(lab, q.cpu(), 0, 256, 2)


@pytest.mark.cuda
def test_claim_kernels_refuse_views_off_16_bytes_on_cuda(card):
    """A contiguous view that starts off a 16-byte boundary raises before
    either kernel's 16-byte loads could fault; a copy of it runs and equals
    the plain versions; the level flood copies such levels itself."""
    lab, q = (torch.as_tensor(a, device=card)
              for a in claim_inputs(np.random.default_rng(4), (2, 7, 129)))
    assert lab[1:].is_contiguous() and lab[1:].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        TW.claim_round(lab[1:], q[1:], 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TW.claim_levels(lab[1:], q[1:], 0, 256, 2)
    a, b = lab[1:].clone(), q[1:].clone()
    got, chg = TW.claim_round(a, b, 128)
    assert torch.equal(got, TW._claim_round(a, b, None, 128))
    got = TW.claim_levels(a, b, 0, 256, 2)
    want = TW._claim_levels(a, b, 0, 256, 2)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    markers = torch.where(lab > 0, lab, 0)
    mask = lab >= 0
    flood = TW._flood(q[1:], markers[1:], mask[1:], 256, 32)
    plain = TW._flood(q[1:].cpu(), markers[1:].cpu(), mask[1:].cpu(), 256, 32)
    assert torch.equal(flood[0].cpu(), plain[0]) and flood[1] == plain[1]


@pytest.mark.cuda
@pytest.mark.parametrize("bfs_rounds", CLAIM_BUDGETS)
def test_level_flood_on_cuda_matches_cpu(card, bfs_rounds):
    """The level engine on the card (kernel rounds, phase B on the device)
    == the same flood on the CPU (plain rounds), labels and flag."""
    rng = np.random.default_rng(bfs_rounds)
    q = rng.integers(0, 64, (3, 48, 80)).astype(np.int32)
    mask = rng.random((3, 48, 80)) < 0.85
    markers = np.where(rng.random((3, 48, 80)) < 0.01,
                       rng.integers(1, 30, (3, 48, 80)), 0).astype(np.int32)
    args = [torch.as_tensor(a) for a in (q, markers, mask)]
    want = TW._flood(*args, 64, bfs_rounds)
    got = TW._flood(*[a.to(card) for a in args], 64, bfs_rounds)
    assert torch.equal(got[0].cpu(), want[0]) and got[1] == want[1]


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 1, 3])
def test_relabel_kernel_matches_plain_loop_on_cuda(card, budget):
    """The re-labeling kernel == the plain loop of ``_refine_round`` blocks
    on the same CUDA tensors, bitwise: labels, flag and blocks, at 4 x 1024^2
    on a cell-like relief and on one whose labels cross a plateau (over
    1,000 rounds, as the segmentation cell's floods), and at odd shapes (W % 4 !=
    0, a single pixel), at the flood's budget and at budgets of 1 and 3
    blocks (flag False); one launch a call, the rounds within the plain
    loop's last two blocks, the operands unwritten. The reliefs and the
    operands are the smoke's (``chip_smoke.cell_relief``,
    ``relabel_operands``)."""
    from chip_smoke import cell_relief, relabel_operands

    for shape, crossing in (((4, 1024, 1024), False), ((4, 1024, 1024), True),
                            ((1, 1, 1), False), ((2, 7, 129), False), ((3, 33, 1001), True),
                            ((2, 64, 36), False)):
        (*args, n_blocks), _ = relabel_operands(*cell_relief(*shape, seed=7, device=card,
                                                             crossing=crossing))
        n_blocks = n_blocks if budget is None else budget
        saved = [a.clone() for a in args if isinstance(a, torch.Tensor)]
        before = TW.minimax_relabel.launches, TW.minimax_relabel.rounds
        got = TW.minimax_relabel(*args, n_blocks)
        assert TW.minimax_relabel.launches == before[0] + 1
        assert TW.minimax_relabel.rounds == before[1] + got[3]
        want = TW._relabel_plain(*args, n_blocks)
        assert torch.equal(got[0], want[0]) and got[1:3] == want[1:3], shape
        assert want[3] - 2 * TW._MINIMAX_BLOCK < got[3] <= want[3]
        assert all(torch.equal(a, b) for a, b in
                   zip([a for a in args if isinstance(a, torch.Tensor)], saved))
        if shape[0] == 4:   # 72 or ~1,850 rounds: the flood's budget ends them, 3 blocks not
            assert got[1] is (budget is None)
            assert got[3] > (1000 if crossing else 48) or budget is not None


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 1, 3])
def test_relax_kernel_matches_plain_loop_on_cuda(card, budget):
    """The relaxation kernel == the plain loop of sweep-and-round blocks on
    the same CUDA tensors, bitwise: keys, flag and blocks, at 4 x 1024^2 on
    a cell-like relief and on one whose keys cross a plateau, at odd shapes
    (3 x 37 x 53, 1 x 1023 x 1025, a single pixel, W % 4 != 0), on rows too
    long for a tile's tree in shared memory (its levels in global scratch)
    and at 40,000 levels (heights packed in 32 bits), at the flood's budget
    and at budgets of 1 and 3 blocks; one launch a call in a
    ``watershed.relax`` span whose engine is "kernel", the operands
    unwritten. The reliefs and the operands are the smoke's
    (``chip_smoke.cell_relief``, ``relax_operands``)."""
    import ctypes

    from ark_tpu_torch.ops import _kernels
    from ark_tpu_torch.utils import profiling
    from chip_smoke import cell_relief, relax_operands

    cases = [((4, 1024, 1024), False, 256), ((4, 1024, 1024), True, 256),
             ((3, 37, 53), False, 256), ((1, 1023, 1025), False, 256),
             ((1, 1, 1), False, 256), ((2, 7, 129), True, 256), ((1, 3, 9000), False, 256),
             ((2, 200, 131), False, 40_000)]
    for shape, crossing, levels in cases:
        q, markers, mask = cell_relief(*shape, seed=7, device=card, crossing=crossing)
        *args, n_blocks = relax_operands(q * (levels // 256), markers, mask, levels)
        n_blocks = n_blocks if budget is None else budget
        plan = (ctypes.c_longlong * 5)()
        pk, qs, labm, claimable, absorb = args
        assert _kernels.lib("minimax_relax").ark_minimax_relax_plan(
            labm.bit_length(), labm, absorb, *shape, plan) == 0
        assert (plan[3] > 0) is (shape[2] == 9000) and plan[4] == (4 if levels > 16384 else 2)
        saved = [a.clone() for a in (pk, qs, claimable)]
        before = TW.minimax_relax.launches, TW.minimax_relax.blocks
        profiling.reset()
        try:
            with profiling.recording():
                got = TW.minimax_relax(*args, n_blocks)
            (span,) = [s for s in profiling.spans() if s["name"] == "watershed.relax"]
        finally:
            profiling.reset()
        assert TW.minimax_relax.launches == before[0] + 1
        assert TW.minimax_relax.blocks == before[1] + got[2]
        assert span["attrs"] == {"engine": "kernel", "blocks": got[2]}
        want = TW._relax_plain(*args, n_blocks)
        assert torch.equal(got[0], want[0]) and got[1:] == want[1:], shape
        assert all(torch.equal(a, b) for a, b in zip((pk, qs, claimable), saved))
        if shape[0] == 4 and budget == 1:      # 3 and 27 blocks at the flood's budget
            assert got[1] is False


@pytest.mark.cuda
def test_minimax_relax_refuses_on_cuda(card):
    """On CUDA tensors the relaxation kernel refuses int64 keys, shapes that
    differ and heights off the value bits (after its launch, from its
    status); it never runs the plain loop."""
    from chip_smoke import cell_relief, relax_operands

    pk, qs, labm, claimable, absorb, n_blocks = relax_operands(
        *cell_relief(1, 64, 48, seed=3, device=card))
    with pytest.raises(TypeError, match="int32"):
        TW.minimax_relax(pk.long(), qs, labm, claimable, absorb, n_blocks)
    with pytest.raises(ValueError, match="one shape"):
        TW.minimax_relax(pk, qs[:, :-1], labm, claimable, absorb, n_blocks)
    before = TW.minimax_relax.launches
    with pytest.raises(ValueError, match="height"):
        TW.minimax_relax(pk, qs | 1, labm, claimable, absorb, n_blocks)
    with pytest.raises(ValueError, match="height"):
        TW.minimax_relax(pk, torch.full_like(qs, absorb), labm, claimable, absorb, n_blocks)
    assert TW.minimax_relax.launches == before + 2


@pytest.mark.cuda
def test_minimax_flood_on_cuda_matches_cpu(card):
    """The minimax flood on the card (the relaxation and re-labeling
    kernels) == the same flood on the CPU (the plain loops), labels and
    flag, on whole tensors and on views at an offset; one relaxation and one
    re-labeling launch a flood, the ``watershed.relax`` span's engine and
    blocks (the CPU's), and the ``watershed.relabel`` span's engine, blocks
    (the CPU's) and rounds."""
    from ark_tpu_torch.utils import profiling
    from chip_smoke import cell_relief

    q, markers, mask = cell_relief(3, 200, 131, seed=5, device=card)
    for view in (slice(None), slice(1, None)):
        args = [t[view] for t in (q, markers, mask)]
        runs = {}
        for device in (card, "cpu"):
            profiling.reset()
            before = TW.minimax_relabel.launches, TW.minimax_relax.launches
            try:
                with profiling.recording():
                    out = TW.flood(*[a.to(device) for a in args], 256, 32)
                (relabel,) = [s for s in profiling.spans()
                              if s["name"] == "watershed.relabel"]
                (relax,) = [s for s in profiling.spans() if s["name"] == "watershed.relax"]
            finally:
                profiling.reset()
            runs[device] = out, relabel["attrs"], relax["attrs"], (
                TW.minimax_relabel.launches - before[0], TW.minimax_relax.launches - before[1])
        (got, attrs, rattrs, launches), (want, plain, rplain, plain_launches) = (
            runs[card], runs["cpu"])
        assert torch.equal(got[0].cpu(), want[0]) and got[1] is want[1] is True
        assert (launches, plain_launches) == ((1, 1), (0, 0))
        assert rattrs == {"engine": "kernel", "blocks": rplain["blocks"]}
        assert rplain["engine"] == "plain" and rplain["blocks"] >= 1
        assert attrs["engine"] == "kernel" and plain["engine"] == "plain"
        assert attrs["blocks"] == plain["blocks"] > 1
        assert plain["rounds"] - 2 * TW._MINIMAX_BLOCK < attrs["rounds"] <= plain["rounds"]


def _segment_cases(rng):
    """(labels (N,) int32, values (N, K) f32, num_segments): label gaps and
    large ids, a single-pixel cell, num_segments past the largest label, an
    empty FOV, 1-D values, K = 3 and K = 44, and labels past num_segments
    (dropped)."""
    lab = rng.integers(0, 300, 256 * 256).astype(np.int32)
    lab[lab % 7 == 3] = 0                                # gaps
    lab[lab > 250] += 100_000                            # large ids
    lab[12345] = 200_500                                 # a single-pixel cell
    yield lab, rng.gamma(1.0, 3.0, (lab.size, 44)).astype(np.float32), 200_501
    yield lab, rng.random((lab.size, 3), dtype=np.float32), 200_600
    yield lab, rng.random(lab.size, dtype=np.float32), 200_501
    yield lab, rng.random((lab.size, 2), dtype=np.float32), 150
    empty = np.zeros(64 * 64, np.int32)
    yield empty, rng.random((empty.size, 5), dtype=np.float32), 1
    yield empty[:0], np.zeros((0, 4), np.float32), 3


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 31, 32, 33, 44, 65, 200])
def test_segment_sum_kernel_at_every_column_tile_on_cuda(card, k):
    """Blob masks with out-of-range labels, at every K the walk tiles
    differently: bitwise equal to index_add_ on a CPU copy, with the plan
    built once and reused, and the plan kernel's boxes equal to
    segment_boxes_plain."""
    rng = np.random.default_rng(k)
    lab_np = rng.integers(0, 40, (96, 130)).astype(np.int32)
    lab_np[::7] = rng.integers(-3, 60, (14, 130))
    lab = torch.as_tensor(lab_np, device=card)
    vals = torch.as_tensor(rng.gamma(1.0, 3.0, (lab_np.size, k)).astype(np.float32),
                           device=card)
    n_seg = 50
    before = TSR.segment_plan.launches
    plan = TSR.segment_plan(lab, n_seg)
    assert TSR.segment_plan.launches == before + 1
    assert torch.equal(plan.boxes.cpu(), TSR.segment_boxes_plain(lab.cpu(), n_seg))
    want = TSR.segment_sum_plain(vals.cpu(), lab.cpu(), n_seg)
    for _ in range(2):
        assert torch.equal(TSR.segment_sum(vals, lab, n_seg, plan).cpu(), want)
    with pytest.raises(ValueError, match="plan"):
        TSR.segment_sum(vals, lab, n_seg + 1, plan)


@pytest.mark.cuda
def test_segment_sum_kernel_matches_plain_on_cuda(card):
    """The segment-sum kernel == index_add_ on a CPU copy, bitwise, and ==
    a second run of itself; one launch per call; what it does not take
    raises."""
    rng = np.random.default_rng(3)
    for lab_np, val_np, n_seg in _segment_cases(rng):
        lab = torch.as_tensor(lab_np, device=card)
        val = torch.as_tensor(val_np, device=card)
        before = TSR.segment_sum.launches
        got = TSR.segment_sum(val, lab, n_seg)
        again = TSR.segment_sum(val, lab, n_seg)
        want = TSR.segment_sum_plain(torch.as_tensor(val_np),
                                     torch.as_tensor(lab_np), n_seg)
        assert torch.equal(got.cpu(), want) and torch.equal(got, again)
        cells = TSR.segment_sum(val, lab, n_seg, background=False)
        assert not bool(cells[0].any()) and torch.equal(cells[1:], got[1:])
        assert TSR.segment_sum.launches == before + (3 if lab_np.size else 0)
    with pytest.raises(ValueError, match="num_segments"):
        TSR.segment_sum(val[:0], lab[:0], 0)
    # labels outside [0, num_segments) are dropped, as in jax.ops.segment_sum
    lab = torch.as_tensor([0, 5, 2, -3, 2, 1], dtype=torch.int32, device=card)
    got = TSR.segment_sum(torch.arange(6.0, device=card), lab, 3)
    assert got.tolist() == [0.0, 5.0, 6.0]
    with pytest.raises(TypeError, match="float32"):
        TSR.segment_sum(torch.ones(3, dtype=torch.float64, device=card), lab, 6)
    with pytest.raises(ValueError, match="CUDA"):
        TSR.segment_sum(torch.ones(3, device=card), lab.cpu(), 6)


def _kernel_against_plain(card, vals_np, ids_np, n_seg):
    """The kernel's sums (one plan, with and without the background row)
    against segment_sum_plain on the CPU, bitwise (NaN where it has NaN);
    returns the launches the two sums counted."""
    vals, ids = (torch.as_tensor(a, device=card) for a in (vals_np, ids_np))
    want = TSR.segment_sum_plain(torch.as_tensor(vals_np), torch.as_tensor(ids_np), n_seg)
    plan = TSR.segment_plan(ids, n_seg)
    before = TSR.segment_sum.launches
    got = TSR.segment_sum(vals, ids, n_seg, plan)
    without = TSR.segment_sum(vals, ids, n_seg, plan, background=False)
    assert cases.same_bits(got.cpu().numpy(), want.numpy())
    assert not bool(without[0].any())
    assert cases.same_bits(without[1:].cpu().numpy(), got[1:].cpu().numpy())
    return TSR.segment_sum.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("k", cases.K_VALUES)
@pytest.mark.parametrize("kind", cases.IMAGE_KINDS)
def test_background_kernel_on_every_image_and_width_on_cuda(card, kind, k):
    """The background row's kernel beside the walk, on the images and at
    the widths of the CPU parity tests: bitwise the plain version; a sum
    with the background launches the walk and the background kernel, one
    without it the walk alone."""
    lab = cases.label_image(kind)
    launches = _kernel_against_plain(card, cases.values(lab.size, k, seed=k), lab,
                                     int(lab.max()) + 1)
    assert launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", cases.FLAT_KINDS)
def test_flat_kernel_on_ids_in_and_out_of_order_on_cuda(card, kind):
    """The flat kernel on UMAP's ids (heads, sorted tails with hubs) and on
    ids in no order, with ids outside [0, num_segments): bitwise the plain
    version, one launch a sum."""
    ids, n = cases.flat_ids(kind)
    assert _kernel_against_plain(card, cases.values(ids.size, 2, seed=3), ids, n) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["image", "flat"])
def test_special_values_on_cuda(card, layout):
    """NaN, +-inf and -0.0 through both new paths: bitwise the plain
    version (NaN where it has NaN), a column of -0.0 summing to +0.0."""
    ids = (cases.label_image("background_42pct") if layout == "image"
           else cases.flat_ids("sorted_hubs")[0])
    _kernel_against_plain(card, cases.values(ids.size, 5, seed=4, special=True), ids,
                          int(ids.max()) + 1)


@pytest.mark.cuda
def test_distances_and_neighbor_counts_match_cpu_on_cuda(card):
    rng = np.random.default_rng(21)
    for d in (1, 2, 3, 4):
        pts = (5000 * (0.75 + 0.25 * rng.random((1500, d)))).astype(np.float32)
        pts[1] = pts[0]
        pts[1, 0] -= 1.5
        cpu = torch.as_tensor(pts)
        dev = cpu.to(card)
        for zero in (False, True):
            got = TD.pairwise_distances(dev, dev, zero_diagonal=zero)
            assert torch.equal(got.cpu(), TD.pairwise_distances(cpu, cpu,
                                                                 zero_diagonal=zero))
        assert float(got[0, 1]) == 1.5 and bool((torch.diagonal(got) == 0).all())
    x = rng.poisson(3.0, (900, 20)).astype(np.float32)
    got = TD.squared_distances(torch.as_tensor(x, device=card),
                               torch.as_tensor(x, device=card), True).cpu().double()
    want = TD.squared_distances(torch.as_tensor(x), torch.as_tensor(x), True).double()
    norms = (torch.as_tensor(x).double() ** 2).sum(1)
    assert bool(((got - want).abs() <= 4 * 19 * 2.0 ** -24
                 * (norms[:, None] + norms[None, :])).all())
    assert bool((torch.diagonal(got) == 0).all())
    coords = rng.uniform(0, 2000, (5000, 2)).astype(np.float32)
    onehot = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 5000)]
    for block in (333, 4096):
        got = TD.blocked_neighbor_counts(coords, onehot, 60.0, block_rows=block,
                                         device=card)
        assert np.array_equal(got, TD.blocked_neighbor_counts(
            coords, onehot, 60.0, block_rows=block, device="cpu"))
    dist = TD.cdist(coords[:800], device=card)
    assert np.array_equal(dist, TD.cdist(coords[:800], device="cpu"))
    got = TD.knn_mean_distance(torch.as_tensor(dist, device=card), 5).cpu()
    torch.testing.assert_close(got, TD.knn_mean_distance(torch.as_tensor(dist), 5),
                               rtol=1e-6, atol=0)
    labels = rng.integers(0, 4, len(x))
    assert TD.silhouette_score(x, labels, device=card) == pytest.approx(
        TD.silhouette_score(x, labels, device="cpu"), rel=1e-5)


@pytest.mark.cuda
def test_dist_matrix_files_and_neighbor_counts_match_cpu_on_cuda(card, tmp_path):
    import pandas as pd

    rng = np.random.default_rng(22)
    table = pd.DataFrame({"fov": np.repeat(["f1", "f2", "f3"], 400),
                          "label": np.tile(np.arange(1, 401), 3),
                          "centroid-0": rng.uniform(0, 1024, 1200),
                          "centroid-1": rng.uniform(0, 1024, 1200),
                          "cell_meta_cluster": rng.choice(["A", "B", "C"], 1200)})
    for device in ("cpu", card):
        os.makedirs(tmp_path / device)
        TSA.calc_dist_matrix(table, str(tmp_path / device), device=device)
    for fov in ("f1", "f2", "f3"):
        got = TSA.load_dist_matrix(str(tmp_path / card), fov)
        want = TSA.load_dist_matrix(str(tmp_path / "cpu"), fov)
        assert got.equals(want)
        cells = table[table["fov"] == fov]
        for g, w in zip(TSA.compute_neighbor_counts(cells, got, 50, device=card),
                        TSA.compute_neighbor_counts(cells, want, 50, device="cpu")):
            pd.testing.assert_frame_equal(g, w, check_exact=True)


@pytest.mark.cuda
def test_enrichment_null_matches_cpu_on_cuda(card, monkeypatch):
    rng = np.random.default_rng(23)
    pts = rng.uniform(0, 600, (700, 2)).astype(np.float32)
    dist = TD.cdist(pts, device="cpu")
    pos = (rng.random((7, 700)) < 0.2).astype(np.float32)
    perms = TSE.draw_permutations(700, 40, seed=9)
    want = TSE._enrichment(dist, pos, 50, perms, "cpu")
    got = TSE._enrichment(dist, pos, 50, perms, card)
    monkeypatch.setattr(TSE, "NULL_CHUNK_BYTES", 3 * 2 * 4 * 7 * 700)
    chunked = TSE._enrichment(dist, pos, 50, perms, card)
    for key, val in want.items():
        assert np.array_equal(got[key], val), key
        assert np.array_equal(chunked[key], val), key


@pytest.mark.cuda
def test_kmeans_matches_cpu_on_cuda(card):
    rng = np.random.default_rng(24)
    data = rng.poisson(4.0, (3000, 12)).astype(np.float32)
    for k in (2, 6, 10):
        got, inertia = TK.kmeans(data, k, seed=7, device=card)
        want, want_inertia = TK.kmeans(data, k, seed=7, device="cpu")
        assert np.array_equal(got, want)
        assert inertia == pytest.approx(want_inertia, rel=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,p", [((33, 47), 0.5), ((257, 1000), 0.99),
                                     ((1, 7), 0.5), ((7, 1), 0.5), ((512, 512), 0.999),
                                     ((64, 80), 1.0), ((64, 80), 0.0)])
def test_squared_edt_matches_cpu_on_cuda(card, shape, p):
    rng = np.random.default_rng(25)
    fg = rng.random(shape) < p
    got = TE._edt2_int(torch.as_tensor(fg, device=card))
    want = TE._edt2_int(torch.as_tensor(fg))
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    assert torch.equal(TE.distance_transform_edt(fg, device=card).cpu(),
                       TE.distance_transform_edt(fg, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 9])
def test_fiber_labels_match_cpu_on_cuda(card, seed):
    img = fiber_image(np.random.default_rng(seed), size=256, n_fibers=12)
    args = dict(FIBER_DEFAULTS, contrast_scaling_divisor=32)
    got = TF._fiber_steps(img, 256, *args.values(), device=card)
    want = TF._fiber_steps(img, 256, *args.values(), device="cpu")
    differ, excused, left = fiber_labels_differ(got, want, args["ridge_cutoff"])
    print(f"seed {seed}: {differ} label pixels differ, {excused} excused, {left} not")
    assert left == 0 and excused <= EXCUSED_SHARE * img.size
    assert want["labeled_filtered"].max() >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 44])
def test_segment_sum_background_row_on_cuda(card, k):
    """Row 0 on the card is bitwise the CPU port's: a label image that is
    mostly background (one warp walks ~50,000 pixels in pixel order), and
    flat sorted labels that start at 0 (UMAP's shape: point 0 is a row)."""
    rng = np.random.default_rng(k)
    lab_np = dense_masks(seed=k, n_fovs=1, size=256, n_cells=25, cell_radius=12,
                         nuc_radius=3)["whole_cell"][0]
    assert (lab_np == 0).mean() > 0.6
    flat_np = np.sort(rng.integers(0, 500, 20_000).astype(np.int32), kind="stable")
    for labels_np, n_seg in ((lab_np, int(lab_np.max()) + 1), (flat_np, 500)):
        vals_np = rng.normal(size=(labels_np.size, k)).astype(np.float32)
        labels, vals = (torch.as_tensor(a, device=card) for a in (labels_np, vals_np))
        want = TSR.segment_sum_plain(torch.as_tensor(vals_np), torch.as_tensor(labels_np),
                                     n_seg)
        plan = TSR.segment_plan(labels, n_seg)
        assert torch.equal(plan.boxes.cpu(),
                           TSR.segment_boxes_plain(torch.as_tensor(labels_np), n_seg))
        got = TSR.segment_sum(vals, labels, n_seg, plan)
        assert bool(want[0].any()) and torch.equal(got.cpu(), want)
    sizes = TSR.cell_sizes(torch.as_tensor(lab_np, device=card), int(lab_np.max()) + 1)
    assert int(sizes[0]) == int((lab_np == 0).sum())
    cent = TSR.centroids(torch.as_tensor(lab_np, device=card), int(lab_np.max()) + 1)
    assert torch.equal(cent.cpu(), TSR.centroids(torch.as_tensor(lab_np),
                                                 int(lab_np.max()) + 1))


@pytest.mark.cuda
def test_umap_epochs_on_cuda(card):
    """A fit's sums launch the segment-sum kernel (2 an epoch, 2 plans);
    the seeded negatives are equal on both devices; OPT_EPOCHS epochs from
    the same graph and start agree with the CPU port by chip_smoke's rule;
    two fits on the card are bitwise equal."""
    rng = np.random.default_rng(5)
    data = np.concatenate([rng.normal(c, 0.5, (400, 8)) for c in (0, 4, 8)]
                          ).astype(np.float32)
    x = torch.as_tensor(data)
    idx, dists = TU._knn(x, 15)
    heads, tails, w = TU.fuzzy_graph(idx, dists)
    n, n_edges = len(data), len(heads)
    assert torch.equal(TU.draw_negatives(7, 3, 5, n_edges, n, card).cpu(),
                       TU.draw_negatives(7, 3, 5, n_edges, n, "cpu"))
    emb0 = TU._pca(x, 2)
    emb0 = emb0 / (emb0.abs().max() + 1e-12) * 10.0
    want = TU._optimize(emb0, heads, tails, w, 42, n_epochs=OPT_EPOCHS)
    sums, plans = TSR.segment_sum.launches, TSR.segment_plan.launches
    got = TU._optimize(emb0.to(card), heads.to(card), tails.to(card), w.to(card), 42,
                       n_epochs=OPT_EPOCHS).cpu()
    assert TSR.segment_sum.launches == sums + 2 * OPT_EPOCHS
    assert TSR.segment_plan.launches == plans + 2
    err = (got - want).abs()
    assert float((err > OPT_ATOL).float().mean()) <= OPT_OUTLIERS
    assert float(err.max()) <= OPT_WORST
    a = TU.UMAP(n_epochs=30, device=card).fit_transform(data)
    np.testing.assert_array_equal(a, TU.UMAP(n_epochs=30, device=card).fit_transform(data))


@pytest.mark.cuda
def test_cluster_masks_and_overlay_match_cpu_on_cuda(card):
    import pandas as pd

    lab = dense_masks(seed=4, n_fovs=1, size=256, n_cells=80, cell_radius=10,
                      nuc_radius=3)["whole_cell"][0]
    rng = np.random.default_rng(4)
    table = pd.DataFrame({"fov": "fov0", "label": np.unique(lab)[1:-1]})
    table["cell_meta_cluster"] = ["t%d" % (i % 5) for i in table["label"]]
    cmd = TDU.ClusterMaskData(table, "fov", "label", "cell_meta_cluster")
    masks = {dev: TDU.cluster_mask_from_labels("fov0", lab, cmd, device=dev)
             for dev in (card, "cpu")}
    np.testing.assert_array_equal(masks[card], masks["cpu"])
    colors = rng.integers(0, 256, (7, 4)).astype(np.uint8)
    np.testing.assert_array_equal(TPU.gather_colors(masks[card], colors, device=card),
                                  colors[masks["cpu"]])
    flat = rng.permutation(lab.size)[:30_000]
    ids = rng.integers(1, 21, len(flat))
    np.testing.assert_array_equal(
        TDU.scatter_pixel_clusters(lab.shape, flat, ids, device=card),
        TDU.scatter_pixel_clusters(lab.shape, flat, ids, device="cpu"))
    chans = rng.gamma(1.0, 30.0, lab.shape + (2,)).astype(np.float32)
    np.testing.assert_array_equal(
        TPU.overlay_from_arrays(chans, lab, np.roll(lab, 2, 0), device=card),
        TPU.overlay_from_arrays(chans, lab, np.roll(lab, 2, 0), device="cpu"))


@pytest.mark.cuda
def test_digamma_matches_cpu_on_cuda(card):
    """XLA's Lanczos digamma in torch ops: CUDA's log1p, cos and sin round
    differently from the CPU's, so within 1e-6 of max(|digamma|, 1) (each
    within 5e-7 of XLA's on the CPU tests' grid); the same poles."""
    from ark_tpu_torch.spLDA import model as TM

    x = np.concatenate([np.geomspace(1e-3, 1e4, 200_001),
                        [-4.0, -2.5, -1.0, -0.3, 0.0, 0.2, 0.5]]).astype(np.float32)
    got = TM._digamma(torch.from_numpy(x).to(card)).cpu().numpy()
    want = TM._digamma(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.max(np.abs(got - want)[ok] / np.maximum(np.abs(want[ok]), 1.0)) < 1e-6


def _lda_cohort(rng, n_fovs=2, n_cells=150, n_feats=6):
    """Count features of cells drawn from three topics, with each FOV's MST
    difference matrix."""
    import pandas as pd

    from ark_tpu_torch.spLDA import featurization as TF

    beta = np.full((3, n_feats), 0.02)
    for k in range(3):
        beta[k, 2 * k:2 * k + 2] = 0.47
    theta = rng.dirichlet(np.full(3, 0.1), n_fovs * n_cells)
    X = np.stack([rng.multinomial(60, t @ beta / (t @ beta).sum()) for t in theta])
    index = pd.MultiIndex.from_tuples([(f"fov{i // n_cells}", i % n_cells)
                                       for i in range(len(X))])
    frame = pd.DataFrame(X.astype(np.float32), index=index)
    diffs = {}
    for f in range(n_fovs):
        edges = TF._mst_edges(rng.uniform(0, 500, (n_cells, 2)))
        d = np.zeros((len(edges), n_cells), np.float32)
        d[np.arange(len(edges)), edges[:, 0]] = 1.0
        d[np.arange(len(edges)), edges[:, 1]] = -1.0
        diffs[f"fov{f}"] = d
    return frame, diffs


@pytest.mark.cuda
def test_one_outer_em_step_matches_cpu_on_cuda(card):
    """One outer EM iteration (20 E-steps, the M-step, the smoothing) from
    the same lambda_0: the Laplacian blocks equal, lambda within rtol 3e-5
    and gamma within rtol 1e-3 (the CPU tests' bounds for one iteration
    against the JAX package)."""
    from ark_tpu_torch.spLDA import model as TM

    frame, diffs = _lda_cohort(np.random.default_rng(8))
    lam0 = torch.from_numpy(TM.initial_topics(42, 3, frame.shape[1]))
    out = {}
    for dev in (card, "cpu"):
        blocks = TM.laplacian_blocks(frame, diffs, device=dev)
        out[dev] = ([b.cpu() for _, b in blocks], *TM._lda_em(
            torch.tensor(frame.values, device=dev), blocks, lam0.to(dev), 3, 1 / 3, 1 / 3,
            0.25, n_iter=1))
    for a, b in zip(out[card][0], out["cpu"][0]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(out[card][1].cpu().numpy(), out["cpu"][1].numpy(), rtol=3e-5)
    np.testing.assert_allclose(out[card][2].cpu().numpy(), out["cpu"][2].numpy(), rtol=1e-3)


@pytest.mark.cuda
def test_lda_featurization_matches_cpu_on_cuda(card):
    """The four neighborhood reducers on the card: counts bitwise the CPU
    port's, averages within rtol 1e-6; the within-cluster sums (f64) within
    rtol 1e-9."""
    import pandas as pd

    from ark_tpu_torch.spLDA import featurization as TF
    from ark_tpu_torch.utils import spatial_lda_utils as TLU

    rng = np.random.default_rng(9)
    n = 3000
    df = pd.DataFrame({"x": rng.uniform(0, 1024, n), "y": rng.uniform(0, 1024, n),
                       "cluster": rng.choice([f"t{i}" for i in range(20)], n),
                       "m1": rng.random(n), "m2": rng.random(n),
                       "is_index": rng.random(n) < 0.9})
    for name, kw in (("neighborhood_to_cluster", {}),
                     ("neighborhood_to_marker", {"markers": ["m1", "m2"]}),
                     ("neighborhood_to_count", {})):
        fn = getattr(TF, name)
        pd.testing.assert_frame_equal(fn(df, 100, device=card, **kw),
                                      fn(df, 100, device="cpu", **kw), check_exact=True)
    pd.testing.assert_frame_equal(
        TF.neighborhood_to_avg_marker(df, 100, ["m1", "m2"], device=card),
        TF.neighborhood_to_avg_marker(df, 100, ["m1", "m2"], device="cpu"), rtol=1e-6)
    data = rng.uniform(0, [5, 30, 2, 9], (4000, 4))
    labels = rng.integers(0, 5, 4000)
    assert TLU.within_cluster_sums(data, labels, device=card) == pytest.approx(
        TLU.within_cluster_sums(data, labels, device="cpu"), rel=1e-9)


@pytest.mark.cuda
def test_targets_from_labels_match_cpu_on_cuda(card):
    """The training targets on the card, bitwise the CPU port's."""
    from ark_tpu_torch.segmentation import synthetic as TSY

    _, cells, nucs = TSY.synthetic_cells(np.random.default_rng(4), 3, hw=96, crowding=0.35)
    for labels in (cells, nucs):
        got = TSY.targets_from_labels(labels, device=card)
        want = TSY.targets_from_labels(labels, device="cpu")
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_training_steps_are_deterministic_on_cuda(card, monkeypatch):
    """Two identical f32 steps of the published network at 2 x 64^2 under
    torch.use_deterministic_algorithms(True) (no float-atomic backward is
    allowed to run): gradients, parameters and averages bitwise equal."""
    import chip_smoke

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(chip_smoke, "DEVICE", card)
    x, targets = chip_smoke.training_batch(5, 2, 64, card)
    chip_smoke.check_deterministic_steps(x, targets)


@pytest.mark.cuda
def test_training_step_matches_cpu_on_cuda(card, monkeypatch):
    """One f32 step of the published network at 2 x 64^2 on the card
    against the CPU port: the loss within rtol 1e-5, each gradient within
    1e-4 of its largest entry, the batch-norm averages within 1e-5."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", card)
    chip_smoke.compare_training_step_cpu_cuda()


@pytest.mark.cuda
def test_graphed_fit_matches_eager_steps_on_cuda(card, monkeypatch):
    """fit's CUDA-graph replays against the same steps launched one by one:
    losses, parameters and batch-norm averages bitwise."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", card)
    x, targets = chip_smoke.training_batch(6, 4, 64, card)
    chip_smoke.check_graphed_fit(x, targets)


@pytest.mark.cuda
def test_single_image_cc_matches_cpu_on_cuda(card):
    """label, label_checked, area_filter, remove_small_objects and
    remove_small_holes on the card, bitwise the CPU port's."""
    from ark_tpu_torch.ops import cc

    rng = np.random.default_rng(13)
    for shape, density in [((257, 300), 0.55), ((64, 64), 0.3), ((1, 1), 1.0)]:
        mask = rng.random(shape) < density
        for conn in (1, 2):
            got, want = (cc._label_full(torch.from_numpy(mask).to(d), conn)
                         for d in (card, "cpu"))
            assert torch.equal(got[0].cpu(), want[0]) and int(got[1]) == int(want[1])
            assert got[3] is want[3] is True
            labels = got[0]
            assert torch.equal(cc.area_filter(labels, min_area=4).cpu(),
                               cc.area_filter(want[0], min_area=4))
            for fn, arg in ((cc.remove_small_objects, 6), (cc.remove_small_holes, 6)):
                assert torch.equal(fn(mask, arg, conn, device=card).cpu(),
                                   fn(mask, arg, conn, device="cpu"))


@pytest.mark.cuda
def test_bisect_quantiles_match_cpu_on_cuda(card):
    """Both bisection quantiles on the card, bitwise the CPU port's and the
    card's sort path (NaN where a column has nothing valid)."""
    from ark_tpu_torch.ops import quantiles as Q

    def same(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)

    rng = np.random.default_rng(14)
    x = (rng.standard_normal((50_000, 16)) * 100).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0
    x[:, 0] = 0
    valid = torch.from_numpy(rng.random(50_000) < 0.7)
    xt = torch.from_numpy(x)
    for q in (0.0, 0.5, 0.999, 1.0):
        got = Q.nonzero_quantile_per_column_bisect(xt.to(card), q).cpu()
        same(got, Q.nonzero_quantile_per_column_bisect(xt, q))
        same(got, Q.nonzero_quantile_per_column(xt.to(card), q).cpu())
        got = Q.masked_quantile_per_column_bisect(xt.to(card), valid.to(card), q).cpu()
        same(got, Q.masked_quantile_per_column_bisect(xt, valid, q))
        assert torch.isnan(got[0]) and not torch.isnan(got[1:]).any()


@pytest.mark.cuda
def test_trace_holds_cuda_kernel_events_on_cuda(card, tmp_path):
    import json

    from ark_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path), device=card) as prof:
        torch.ones(512, 512, device=card).matmul(torch.ones(512, 512, device=card))
        torch.cuda.synchronize()
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    (path,) = list(tmp_path.iterdir())
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
@pytest.mark.parametrize("device", [True, "cuda"])
def test_device_span_reads_the_events_around_its_kernels_on_cuda(card, device, monkeypatch):
    """A span given the card times a known run of kernels by its events,
    within 10% of events recorded just outside it, and never synchronises."""
    from ark_tpu_torch.utils import profiling

    a = torch.randn(2048, 2048, device=card)
    for _ in range(3):
        a = torch.tanh(a @ a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    real_sync = torch.cuda.synchronize

    def no_sync(*args, **kwargs):
        raise AssertionError("the span synchronised")
    profiling.reset()
    try:
        monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
        with profiling.recording():
            start.record()
            with profiling.span("matmuls", device=device):
                for _ in range(40):
                    a = torch.tanh(a @ a)
            end.record()
        monkeypatch.setattr(torch.cuda, "synchronize", real_sync)
        torch.cuda.synchronize()
        (got,) = profiling.spans()
    finally:
        profiling.reset()
    want = start.elapsed_time(end)
    assert want > 1.0
    assert abs(got["device_ms"] - want) <= 0.1 * want, (got["device_ms"], want)


@pytest.mark.cuda
def test_prefetch_copies_on_its_own_stream_on_cuda(card):
    """Each result copied from pinned memory on the loader's stream reaches
    the consumer's stream, which works on it at once, equal to the host
    arrays; the consumer's current stream stays its own."""
    from ark_tpu_torch.parallel.prefetch import PrefetchLoader

    rng = np.random.default_rng(15)
    fovs = [rng.random((2, 512, 512)).astype(np.float32) for _ in range(6)]
    consumer = torch.cuda.current_stream()
    seen = []
    for i, batch in PrefetchLoader(range(6), lambda i: {"img": fovs[i]}, device=card):
        assert batch["img"].is_cuda and torch.cuda.current_stream() == consumer
        doubled = batch["img"] * 2                 # queued at once on the consumer's stream
        assert torch.equal(doubled.cpu(), torch.from_numpy(fovs[i]) * 2)
        seen.append(i)
    assert seen == list(range(6))
    # a result already on the card passes through, not through pinning
    on_card = [torch.from_numpy(f).to(card) for f in fovs[:2]]
    got = [b for _, b in PrefetchLoader(range(2), lambda i: on_card[i], device=card)]
    assert all(torch.equal(g, w) for g, w in zip(got, on_card))


@pytest.mark.cuda
def test_cell_table_fov_upload_is_pinned_and_survives_the_next_fov_on_cuda(
        card, tmp_path, monkeypatch):
    """The cell table's FOV upload (``marker_quantification._fov_images``):
    each channel file goes straight into its plane of a pinned stack, which
    crosses in one non-blocking copy; the channel-last images on the card
    equal ``_upload_images`` of ``load_imgs_from_tree``'s array bitwise. Two
    FOVs in a row, the stream held busy ahead of the first copy so that it
    is still pending while the second FOV is read into host memory: neither
    FOV's values are overwritten."""
    from ark_tpu_torch.io import load_utils, tiff
    from ark_tpu_torch.segmentation import marker_quantification as mq

    rng = np.random.default_rng(23)
    fovs, n_channels = ["fov0", "fov1"], 8
    for fov in fovs:
        os.makedirs(tmp_path / fov)
        for c in range(n_channels):
            tiff.write(str(tmp_path / fov / f"ch{c}.tiff"),
                       rng.poisson(3.0, (1024, 1024)).astype(np.float32))
    stacks = []
    real = load_utils.load_fov_planes

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        stacks.append(torch.from_numpy(out[0]).is_pinned())
        return out

    monkeypatch.setattr(load_utils, "load_fov_planes", keep)
    # two cached pinned blocks and warm device blocks, so that no allocation
    # below calls cudaHostAlloc or cudaMalloc (which may wait for the device)
    spare = [torch.empty((n_channels, 1024, 1024), dtype=torch.float32, pin_memory=True)
             for _ in range(2)]
    del spare
    warm = mq._fov_images(str(tmp_path), "fov1", None, card)
    torch.cuda.synchronize()
    del warm
    torch.cuda._sleep(2_000_000_000)               # about a second at the card's clock
    first = mq._fov_images(str(tmp_path), "fov0", None, card)
    assert not torch.cuda.current_stream().query(), "the first copy did not wait"
    second = mq._fov_images(str(tmp_path), "fov1", None, card)
    torch.cuda.synchronize()
    assert stacks == [True] * 3
    for fov, (images, names, direct, decoded) in zip(fovs, (first, second)):
        want = load_utils.load_imgs_from_tree(str(tmp_path), fovs=[fov])
        ref = mq._upload_images(want.values[0], card)
        assert images.shape == ref.shape and images.is_contiguous()
        assert torch.equal(images.view(torch.int32), ref.view(torch.int32)), fov
        assert names == list(want.coords["channels"])
        assert (direct, decoded) == (n_channels, 0)
