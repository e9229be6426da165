"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here carries the `cuda` marker and skips without a card. The
file imports no jax, so it also runs on a machine without it, apart from
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Tolerances: the claim kernel and the floods are integer work, bitwise; BMU
indices may differ only where the plain version's two best nodes are closer
than 1e-6 * max(|d|, 1), and distances carry the f32 summation-order
tolerance of tests/test_torch_som.py. The segment-sum kernel is bitwise
equal to the plain version run on a CPU copy (row 0, the background, is
zero on both) and to a second run of itself.
"""

import numpy as np
import pytest
import torch

from ark_tpu_torch.ops import segment_reduce as TSR
from ark_tpu_torch.ops import som as tsom
from ark_tpu_torch.ops import watershed as TW
from chip_smoke import DIST_ATOL, DIST_RTOL, claim_inputs, pixel_rows


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
@pytest.mark.parametrize("bfs_rounds", [1, 32])
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
        assert not bool(got[0].any())
        assert TSR.segment_sum.launches == before + (2 if lab_np.size else 0)
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
