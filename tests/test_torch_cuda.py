"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here carries the `cuda` marker and skips without a card. The
file imports no jax, so it also runs on a machine without it, apart from
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Tolerances: the claim kernel and the floods are integer work, bitwise; BMU
indices may differ only where the plain version's two best nodes are closer
than 1e-6 * max(|d|, 1), and distances carry the f32 summation-order
tolerance of tests/test_torch_som.py; a duplicated node's tie goes to the
lowest index. The segment-sum kernel is bitwise equal to the plain version
run on a CPU copy (row 0, the background, is zero on both) and to a second
run of itself, and the plan kernel's boxes equal its plain version's.

The spatial stage has no kernel of its own; its device work is held to the
CPU port: distances (D <= 4), neighbor counts, distance files and the
enrichment null given the same permutations bitwise; D > 4 within the
summation-order bound of tests/test_torch_distances.py; k-means (f64, the
same seeding on every device) to equal labels.
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
