"""The port's multi-process layer (ark_tpu_torch.parallel.{mesh,cohort}, the
sharded SOM, LDA EM step, UMAP epoch and Mesmer step, and
graft_entry.dryrun_multigpu) against the JAX package's sharded functions,
on the CPU, on the same seeded numpy inputs.

The port's ranks are spawned processes of one gloo group, joined through a
FileStore in the test's temporary directory (no TCP port), with a 60 s
timeout at init, in each collective and on the join: a rank that hangs is
killed and the test fails. The ranks import torch and the port only
(tests/torch_parallel_ranks.py; each reports whether jax was loaded). World
size 1 runs in this process with no process group. The JAX side runs on a
mesh of the same size as the port's world (the SOM's batches and UMAP's
negatives depend on it), over the suite's 8 virtual CPU devices.

XLA's CPU ``psum`` over a 1-D mesh adds the devices in order, left to right
(probed: bitwise a left-to-right sum of the shards at 2, 3 and 4 devices,
not a right-to-left or pairwise one), which is the port's
``mesh.rank_order_sum``. Tolerances, each with its reason:

- mesh helpers, the init contract: exact.
- every rank's results: bitwise equal.
- pixel cohort: 'valid' equal to JAX; 'pixel_mat' bitwise the port's
  single-card preprocessing per FOV (and within the blur's rtol 1e-6 of
  JAX, tests/test_torch_preprocess.py); 'som_clusters' equal to JAX except
  at near-ties (chip_smoke.py's rule).
- fiber cohort: per FOV bitwise the port's ``_fiber_device_program``;
  within the classical ops' rtol 1e-5 / atol 1e-6 of JAX.
- channel percentiles: equal to JAX (the port's quantile tests' rule: the
  order statistics and the interpolation are exact).
- sharded SOM: WEIGHTS_ATOL = 1e-4 of JAX (chip_smoke.py's: the order of
  the H^T X products, then 256 steps); at world size 1 bitwise the port's
  ``_train_steps`` given the same draws. One sharded step: 1e-6 (one
  step's rounding).
- LDA EM step: rtol 2e-4 of JAX (tests/parallel/test_sharded_extras.py).
- UMAP epoch given JAX's negatives: atol 2e-5 on coordinates ~1-10 (the
  port's one-epoch tolerance, tests/test_torch_umap.py: XLA fuses
  multiply-adds and its pow differs in the last bits; the sums are the same
  order). With rate 0, the numpy oracle of test_sharded_extras.py at rtol
  1e-4, atol 1e-6.
- Mesmer step (mini network, 2 x 64^2, through ``params_from_flax``):
  tests/test_torch_train.py's rules: loss rtol 1e-5 of JAX's f32 loss;
  gradients within 1e-4 of each tensor's largest entry of a float64
  ``jax.grad`` of the dry run's loss; the batch statistics within 1e-6 of
  max(|stat|, 1). At world size 2 the same tolerances against the port's
  own single-process step on the whole batch.
- every world size against world size 1: bitwise for the per-FOV stages;
  the SOM step's tolerance for one step; the LDA step rtol 1e-5 (the (K, V)
  statistics summed in other splits: 1.8e-6 seen); UMAP with the port's own
  negatives (the same ids for an edge at every world size) atol 1e-5, about
  5 ulps of coordinates up to 16 (per-point sums of the same updates in
  other splits: 2 ulps seen). The SOM schedule's minibatches and JAX's
  UMAP negatives depend on the world size, so those have none.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ark_tpu.models import unet as JU
from ark_tpu.ops import som as jsom, umap as jumap
from ark_tpu.parallel import cohort as jcohort, mesh as jmesh
from ark_tpu.segmentation import synthetic as JS
from ark_tpu.spLDA import model as jlda
from ark_tpu_torch import graft_entry
from ark_tpu_torch.models import unet as TU
from ark_tpu_torch.ops import som as tsom
from ark_tpu_torch.parallel import mesh as tmesh
from ark_tpu_torch.phenotyping import pixie_preprocessing as tprep
from ark_tpu_torch.segmentation import fiber_segmentation as tfiber
from ark_tpu_torch.ops import classical as tclassical
from tests import torch_parallel_ranks as ranks
from tests.test_torch_som import assert_labels_equal_except_near_ties

torch.set_num_threads(1)

WORLD_SIZES = [1, 2, 3, 4]
MESMER_WORLDS = [1, 2]
TIMEOUT_S = 60.0
WEIGHTS_ATOL = 1e-4
STEP_ATOL = 1e-6
LDA_RTOL, LDA_SPLIT_RTOL = 2e-4, 1e-5
UMAP_ATOL, UMAP_SPLIT_ATOL = 2e-5, 1e-5
FIBER_RTOL, FIBER_ATOL = 1e-5, 1e-6
BLUR_RTOL, BLUR_ATOL = 1e-6, 1e-7
LOSS_RTOL, GRAD_TOL, STAT_TOL = 1e-5, 1e-4, 1e-6
HW, MESMER_BATCH = 64, 2
UMAP_RATE = 3
UNREAD = ("P4", "P5", "P6", "P7")      # FPN outputs the heads never read
COUNTERS = ["bmu", "claim_levels", "claim_round", "minimax_relabel", "minimax_relax",
            "segment_plan", "segment_sum"]


def _chain(n):
    return (np.eye(n) * 2 - np.eye(n, k=1) - np.eye(n, k=-1)).astype(np.float32) / 4


def _jax_negatives(seed, ws, rate, e_local, n):
    """umap_epoch_sharded's draws: shard r folds its index into the key,
    then one split a negative round; concatenated in rank order."""
    out = []
    for r in range(ws):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), r)
        shard = []
        for _ in range(rate):
            key, sub = jax.random.split(key)
            shard.append(np.asarray(jax.random.randint(sub, (e_local,), 0, n)))
        out.append(np.stack(shard))
    return np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def flax_mini():
    return JU.init_mesmer_mini(seed=0, input_shape=(1, HW, HW, 2))


def _inputs(ws, flax_mini):
    rng = np.random.default_rng(12)
    inp = {}
    imgs = rng.random((5, 32, 32, 4)).astype(np.float32)
    imgs[:, :12] = 0          # rows 0-3 stay zero after the blur (radius 8)
    inp["pixel_imgs"] = imgs
    inp["channel_norms"] = (rng.random(4) * 0.5 + 0.6).astype(np.float32)
    inp["post_norms"] = (rng.random(4) * 0.3 + 0.2).astype(np.float32)
    inp["pixel_thresh"] = 0.3
    inp["pixel_weights"] = rng.random((25, 4)).astype(np.float32)
    inp["fiber_imgs"] = rng.random((5, 32, 32)).astype(np.float32)
    pct = rng.random((5, 32, 32, 4)).astype(np.float32)
    pct[pct < 0.3] = 0
    inp["pct_imgs"] = pct
    inp["som_data"] = rng.random((600, 6)).astype(np.float32)
    inp["step_w0"] = rng.random((100, 6)).astype(np.float32)
    inp["step_x"] = rng.random((48, 6)).astype(np.float32)
    n, v, k = 26, 6, 3
    inp["lda_X"] = rng.integers(0, 5, (n, v)).astype(np.float32)
    inp["lda_lam"] = rng.random((k, v)).astype(np.float32) + 0.5
    inp["lda_gamma"] = rng.random((n, k)).astype(np.float32) + 0.5
    # one chain Laplacian a FOV of 10, 9 and 7 cells: blocks straddle ranks
    inp["lda_blocks"] = [(0, _chain(10)), (10, _chain(9)), (19, _chain(7))]
    inp["lda_L"] = np.zeros((n, n), np.float32)
    for first, b in inp["lda_blocks"]:
        inp["lda_L"][first:first + len(b), first:first + len(b)] = b
    n_pts, n_edges = 40, 150
    inp["umap_emb"] = (rng.random((n_pts, 2)) * 10).astype(np.float32)
    inp["umap_heads"] = rng.integers(0, n_pts, n_edges)
    inp["umap_tails"] = rng.integers(0, n_pts, n_edges)
    w = rng.random(n_edges).astype(np.float32)
    w[-5:] = 0.0
    inp["umap_w"] = w
    e_pad = tmesh.pad_to_multiple(n_edges, ws)
    inp["umap_negs"] = _jax_negatives(7, ws, UMAP_RATE, e_pad // ws, n_pts)
    if ws in MESMER_WORLDS:
        imgs, cells, _ = JS.synthetic_cells(np.random.default_rng(7), MESMER_BATCH, hw=HW)
        t = JS.targets_from_labels(cells)
        inp["mesmer_x"] = imgs
        inp["mesmer_y_dist"] = t["inner_distance"]
        inp["mesmer_y_pix"] = t["pixelwise"]
        inp["mesmer_state"] = TU.params_from_flax(flax_mini[1])
        if ws == 2:                    # two equal halves: the first image twice
            for k in ("x", "y_dist", "y_pix"):
                inp[f"mesmer_halves_{k}"] = np.concatenate([inp[f"mesmer_{k}"][:1]] * 2)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory, flax_mini):
    """ws -> (inputs, [each rank's results]); world size 1 in this process
    with no process group, the others in spawned gloo ranks."""
    cache = {}

    def get(ws):
        if ws not in cache:
            inp = _inputs(ws, flax_mini)
            if ws == 1:
                cache[ws] = inp, [ranks.compute(inp)]
            else:
                d = tmp_path_factory.mktemp(f"ws{ws}")
                in_path = os.path.join(d, "inputs.pt")
                torch.save(inp, in_path)
                tmesh.launch(ranks.run_rank, ws, (in_path, str(d)), backend="gloo",
                             timeout_s=TIMEOUT_S, join_timeout_s=TIMEOUT_S, store_dir=str(d))
                cache[ws] = inp, [torch.load(os.path.join(d, f"rank{r}.pt"),
                                             weights_only=False) for r in range(ws)]
        return cache[ws]

    return get


def _pad_rows(a, n_pad, fill=0):
    a = np.asarray(a)
    return np.concatenate([a, np.full((n_pad - len(a),) + a.shape[1:], fill, a.dtype)])


@pytest.fixture(scope="module")
def jax_runs(flax_mini):
    """ws -> the JAX package's sharded functions on a ws-device mesh."""
    cache = {}

    def get(ws, inp):
        if ws in cache:
            return cache[ws]
        mesh = jmesh.get_mesh(ws)
        out = {}
        out["pixel"] = jcohort.run_pixel_cohort(
            inp["pixel_imgs"], inp["channel_norms"], inp["pixel_thresh"],
            inp["post_norms"], inp["pixel_weights"], mesh=mesh)
        out["fiber"] = jcohort.run_fiber_cohort(inp["fiber_imgs"], fiber_widths=(1, 2),
                                                mesh=mesh)
        out["percentiles"] = jcohort.cohort_channel_percentiles(inp["pct_imgs"], 0.99,
                                                                mesh=mesh)
        out["som"] = jsom.som_train_sharded(inp["som_data"], mesh, seed=3)
        step = jsom.make_sharded_train_step(mesh)
        xs = jax.device_put(jnp.asarray(inp["step_x"]), NamedSharding(mesh, P("fov")))
        out["som_step"] = np.asarray(step(jnp.asarray(inp["step_w0"]), xs, jnp.float32(0.05),
                                          jnp.float32(2.0),
                                          jnp.asarray(jsom.grid_distances(10, 10))))
        n = inp["lda_X"].shape[0]
        n_pad = tmesh.pad_to_multiple(n, ws)
        k = inp["lda_lam"].shape[0]
        lpad = np.zeros((n_pad, n_pad), np.float32)
        lpad[:n, :n] = inp["lda_L"]
        lam, gamma = jlda.em_step_sharded(
            _pad_rows(inp["lda_X"], n_pad), inp["lda_lam"],
            _pad_rows(inp["lda_gamma"], n_pad, 1.0), lpad, mesh, alpha=1 / k, eta=1 / k,
            penalty=0.1, e_steps=5)
        out["lda"] = {"lam": np.asarray(lam), "gamma": np.asarray(gamma)[:n]}
        e_pad = tmesh.pad_to_multiple(len(inp["umap_w"]), ws)
        args = (inp["umap_emb"], _pad_rows(inp["umap_heads"], e_pad),
                _pad_rows(inp["umap_tails"], e_pad), _pad_rows(inp["umap_w"], e_pad))
        out["umap"] = np.asarray(jumap.umap_epoch_sharded(
            *args, jax.random.PRNGKey(7), mesh, lr=1.0, negative_sample_rate=UMAP_RATE))
        cache[ws] = out
        return out

    return get


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- mesh helpers

@pytest.mark.parametrize("n,ws", [(5, 1), (5, 2), (8, 3), (24, 4), (3, 4)])
def test_row_split_is_the_meshs_block_order(n, ws):
    """Rank r's rows are device r's block of P("fov") on a ws-device mesh."""
    n_pad = tmesh.pad_to_multiple(n, ws)
    assert n_pad == jmesh.pad_to_multiple(n, ws)
    arr = jax.device_put(jnp.arange(n_pad), jmesh.fov_sharding(jmesh.get_mesh(ws)))
    devices = list(jmesh.get_mesh(ws).devices)
    for shard in arr.addressable_shards:
        r = devices.index(shard.device)
        lo, hi = tmesh.shard_bounds(n_pad, ws, r)
        np.testing.assert_array_equal(np.asarray(shard.data), np.arange(lo, hi))
    if ws > 1:
        with pytest.raises(ValueError, match="split"):
            tmesh.shard_bounds(n_pad + 1, ws, 0)


def test_no_group_is_world_size_one():
    assert torch.distributed.is_initialized() is False
    assert (tmesh.world(), tmesh.rank(), tmesh.resolve_group()) == (1, 0, None)
    a = np.arange(10).reshape(5, 2)
    np.testing.assert_array_equal(tmesh.local_rows(a), a)
    t = torch.arange(6.0)
    assert tmesh.rank_order_sum(t) is t and tmesh.all_gather_rows(t) is t
    assert tmesh.all_reduce_sum(t) is t


def test_init_process_group_surfaces_real_errors(monkeypatch):
    """Only the double-init error is swallowed; any other failure propagates
    (tests/parallel/test_multihost.py's contract)."""
    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="unreachable"):
        tmesh.init_process_group("gloo", "file:///nonexistent", 2, 0)
    for msg in ("trying to initialize the default process group twice!",
                "Distributed system is already initialized"):
        def twice(msg=msg, **kw):
            raise ValueError(msg)

        monkeypatch.setattr(torch.distributed, "init_process_group", twice)
        tmesh.init_process_group("gloo", "file:///nonexistent", 2, 0)     # no raise


def test_launch_kills_a_rank_that_hangs(tmp_path):
    with pytest.raises(RuntimeError, match="killed"):
        tmesh.launch(ranks.hang, 2, (120.0,), backend="gloo", timeout_s=10.0,
                     join_timeout_s=4.0, store_dir=str(tmp_path))


def test_launch_raises_on_a_failed_rank(tmp_path):
    with pytest.raises(RuntimeError, match=r"\{1: 1\}"):
        tmesh.launch(ranks.fail, 2, backend="gloo", timeout_s=TIMEOUT_S,
                     join_timeout_s=TIMEOUT_S, store_dir=str(tmp_path))


# ---------------------------------------------------------------- the ranks

@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_every_rank_returns_the_same_result(runs, ws):
    _, results = runs(ws)
    assert len(results) == ws
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["world"], [ws, r])
        if ws > 1:
            assert res.pop("jax_loaded") is False, f"rank {r} loaded jax"
    for res in results[1:]:
        _same({k: v for k, v in res.items() if k != "world"},
              {k: v for k, v in results[0].items() if k != "world"})


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_pixel_cohort_matches_jax(runs, jax_runs, ws):
    inp, results = runs(ws)
    got, want = results[0]["pixel"], jax_runs(ws, inp)["pixel"]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for i, img in enumerate(inp["pixel_imgs"]):
        x = torch.from_numpy(img) / torch.from_numpy(inp["channel_norms"])
        norm, _ = tprep._prep_fov_device(x, inp["pixel_thresh"])
        single = norm / torch.from_numpy(inp["post_norms"])
        np.testing.assert_array_equal(got["pixel_mat"][i], single.numpy())
        assert_labels_equal_except_near_ties(
            np.where(got["valid"][i], got["som_clusters"][i], 0),
            np.where(want["valid"][i], want["som_clusters"][i], 0),
            inp["pixel_weights"], got["pixel_mat"][i])
    np.testing.assert_allclose(got["pixel_mat"], want["pixel_mat"], rtol=BLUR_RTOL,
                               atol=BLUR_ATOL)
    assert got["som_clusters"].dtype == np.int32 and got["valid"].any()
    assert not got["valid"][:, :4 * 32].any()


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_fiber_cohort_matches_jax(runs, jax_runs, ws):
    inp, results = runs(ws)
    got, want = results[0]["fiber"], jax_runs(ws, inp)["fiber"]
    th, tw, n_tr, n_tc = tclassical._clahe_geometry(32, 32, 32 / 128)
    for i, img in enumerate(inp["fiber_imgs"]):
        single = tfiber._fiber_device_program(
            torch.from_numpy(img), 0.1, blur=2, th=th, tw=tw, n_tr=n_tr, n_tc=n_tc,
            fiber_widths=(1, 2), sobel_blur=1)
        for k in ("distance_transformed", "elevation_map", "has_bg"):
            np.testing.assert_array_equal(got[k][i], single[k].numpy())
    for k in ("distance_transformed", "elevation_map"):
        np.testing.assert_allclose(got[k], want[k], rtol=FIBER_RTOL, atol=FIBER_ATOL)
    np.testing.assert_array_equal(got["has_bg"], want["has_bg"])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_channel_percentiles_match_jax(runs, jax_runs, ws):
    inp, results = runs(ws)
    np.testing.assert_array_equal(results[0]["percentiles"],
                                  jax_runs(ws, inp)["percentiles"])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_map_over_fovs_gathers_tuples_in_fov_order(runs, ws):
    inp, results = runs(ws)
    prod, sums = results[0]["map_pairs"]
    a = inp["fiber_imgs"]
    np.testing.assert_array_equal(prod, a * (a + 1))
    np.testing.assert_array_equal(sums, [torch.from_numpy(x).sum().item() for x in a])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_som_train_sharded_matches_jax(runs, jax_runs, ws):
    inp, results = runs(ws)
    got, want = results[0]["som"], jax_runs(ws, inp)["som"]
    assert got.shape == want.shape == (100, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=WEIGHTS_ATOL)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_som_train_sharded_makes_one_collective_a_step(runs, ws):
    """Each step gathers its (H^T X, H^T 1) statistics side by side, in one
    all-gather; world size 1 makes none."""
    _, results = runs(ws)
    want = tsom.MAX_TRAIN_STEPS if ws > 1 else 0
    assert [int(res["som_collectives"]) for res in results] == [want] * ws


def test_som_train_sharded_at_world_size_one_is_the_single_card_loop():
    """Given the sharded schedule's draws, ``_train_steps`` gives the same
    bits: world size 1 only skips the sums."""
    data = np.random.default_rng(4).random((300, 5)).astype(np.float32)
    got = tsom.som_train_sharded(data, xdim=6, ydim=5, seed=9, device="cpu")
    init_rows, shard_rows, orders, bs_local = tsom._sharded_schedule(
        300, 30, 1, 1, 9, None, True)
    want = tsom._train_steps(torch.from_numpy(data[shard_rows]),
                             torch.from_numpy(data[init_rows]),
                             torch.from_numpy(orders[0]),
                             torch.from_numpy(tsom.grid_distances(6, 5)), bs_local,
                             0.05, 0.01, tsom.default_radius_start(6, 5))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_som_step_matches_jax(runs, jax_runs, ws):
    inp, results = runs(ws)
    np.testing.assert_allclose(results[0]["som_step"], jax_runs(ws, inp)["som_step"],
                               rtol=0, atol=STEP_ATOL)
    _, base = runs(1)
    np.testing.assert_allclose(results[0]["som_step"], base[0]["som_step"], rtol=0,
                               atol=STEP_ATOL)


@pytest.mark.parametrize("laplacian", ["lda", "lda_blocks"])
@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_lda_em_step_sharded_matches_jax(runs, jax_runs, ws, laplacian):
    """The dense Laplacian and its FOV blocks (JAX takes the dense one)."""
    inp, results = runs(ws)
    got, want = results[0][laplacian], jax_runs(ws, inp)["lda"]
    _, base = runs(1)
    for k in ("lam", "gamma"):
        np.testing.assert_allclose(got[k], want[k], rtol=LDA_RTOL)
        np.testing.assert_allclose(got[k], base[0]["lda"][k], rtol=LDA_SPLIT_RTOL)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_umap_epoch_sharded_matches_jax_given_its_negatives(runs, jax_runs, ws):
    inp, results = runs(ws)
    got, want = results[0]["umap"], jax_runs(ws, inp)["umap"]
    assert np.abs(want - inp["umap_emb"]).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=UMAP_ATOL)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_umap_epoch_attraction_matches_the_oracle(runs, ws):
    """rate 0: the numpy scatter of test_sharded_extras.py; zero-weight
    edges add nothing."""
    inp, results = runs(ws)
    emb, lr = inp["umap_emb"], 0.7
    a, b = jumap._A, jumap._B
    delta = np.zeros_like(emb)
    for h, t, wi in zip(inp["umap_heads"], inp["umap_tails"], inp["umap_w"]):
        diff = emb[h] - emb[t]
        d2 = float((diff ** 2).sum())
        coef = -2.0 * a * b * max(d2, 1e-8) ** (b - 1.0) / (1.0 + a * max(d2, 1e-8) ** b) \
            if d2 > 0 else 0.0
        g = np.clip(coef * diff, -4.0, 4.0) * wi
        delta[h] += lr * g
        delta[t] -= lr * g
    np.testing.assert_allclose(results[0]["umap_attract"], emb + delta, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_every_world_size_agrees_with_world_size_one(runs, ws):
    """The per-FOV stages bitwise; UMAP with the port's own negatives (the
    same ids for an edge at every world size) to UMAP_SPLIT_ATOL."""
    _, results = runs(ws)
    _, base = runs(1)
    for k in ("pixel", "fiber", "percentiles", "map_pairs"):
        _same(results[0][k], base[0][k])
    np.testing.assert_allclose(results[0]["umap_seeded"], base[0]["umap_seeded"], rtol=0,
                               atol=UMAP_SPLIT_ATOL)


# ---------------------------------------------------------------- Mesmer step

def _dry_loss(model):
    def loss_fn(params, batch_stats, x, y_dist, y_pix):
        out, upd = model.apply({"params": params, "batch_stats": batch_stats}, x,
                               train=True, mutable=["batch_stats"])
        l_dist = jnp.mean((out["whole_cell_inner_distance"][..., 0] - y_dist) ** 2)
        l_pix = -jnp.mean(jnp.sum(y_pix * jnp.log(out["whole_cell_pixelwise"] + 1e-7), -1))
        return l_dist + l_pix, upd["batch_stats"]
    return loss_fn


@pytest.fixture(scope="module")
def jax_mesmer(flax_mini, runs):
    """JAX's f32 loss and updated batch statistics of the dry run's step on
    the whole batch, and its float64 gradients."""
    model, variables = flax_mini
    inp, _ = runs(1)
    args = [jnp.asarray(inp[k]) for k in ("mesmer_x", "mesmer_y_dist", "mesmer_y_pix")]
    (loss, stats), _ = jax.jit(jax.value_and_grad(_dry_loss(model), has_aux=True))(
        variables["params"], variables["batch_stats"], *args)
    enabled = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        m64 = JU.PanopticNet(dtype=jnp.float64, stage_sizes=(1, 1, 1, 1), base_width=16,
                             fpn_channels=64, head_upsample_filters=32,
                             head_dense_features=64, inner_activation="linear")
        f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
        grads = jax.jit(jax.grad(lambda *a: _dry_loss(m64)(*a)[0]))(
            jax.tree.map(f64, variables["params"]),
            jax.tree.map(f64, variables["batch_stats"]), *(f64(a) for a in args))
        grads = jax.tree.map(np.asarray, jax.device_get(grads))
    finally:
        jax.config.update("jax_enable_x64", enabled)
    return float(loss), jax.device_get(stats), grads


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _check_grads(got, unreached, ref):
    """The gradient rules of tests/test_torch_train.py: each tensor within
    GRAD_TOL of the reference's largest entry; P4-P7 and the nuclear heads
    (unread by this loss) unreached; zero where the reference is zero."""
    as_flax = TU.params_to_flax({**{k: torch.from_numpy(v) for k, v in got.items()},
                                 **{k: torch.zeros(()) for k in unreached}})["params"]
    checked = 0
    for path, want in _leaves(ref):
        g = _node(as_flax, path)
        if not want.any():
            assert not np.asarray(g).any(), path
            continue
        if path[-2:] == ("dense_0", "bias"):
            kernel = np.abs(_node(ref, path[:-1] + ("kernel",))).max()
            assert max(np.abs(g).max(), np.abs(want).max()) <= GRAD_TOL * kernel, path
            continue
        err = np.abs(g - want).max() / np.abs(want).max()
        assert err <= GRAD_TOL, (path, err)
        checked += 1
    return checked


@pytest.mark.parametrize("ws", MESMER_WORLDS)
def test_sharded_mesmer_step_matches_jax(runs, jax_mesmer, ws):
    inp, results = runs(ws)
    got = results[0]["mesmer"]
    loss, stats, grads = jax_mesmer
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
    assert {k.split(".")[1] for k in got["unreached"] if k.startswith("FPN_0")} \
        == set(UNREAD)
    assert _check_grads(got["grads"], got["unreached"], grads) > 40
    got_stats = TU.params_to_flax({k: torch.from_numpy(v) for k, v in
                                   got["stats"].items()})["batch_stats"]
    for path, ref in _leaves(stats):
        err = np.abs(_node(got_stats, path) - ref) / np.maximum(np.abs(ref), 1.0)
        assert err.max() <= STAT_TOL, (path, err.max())
    # plain SGD: p + (-lr) g, every parameter the loss reaches
    for name, p0 in inp["mesmer_state"].items():
        if name in got["grads"]:
            want = p0.numpy() + np.float32(-1e-3) * got["grads"][name]
            np.testing.assert_array_equal(got["params"][name], want)
        elif name in got["params"]:
            np.testing.assert_array_equal(got["params"][name], p0.numpy())


def test_sharded_mesmer_step_at_two_ranks_is_the_whole_batch_step(runs):
    _, (got, *_) = runs(2)
    _, (base,) = runs(1)
    got, base = got["mesmer"], base["mesmer"]
    np.testing.assert_allclose(float(got["loss"]), float(base["loss"]), rtol=LOSS_RTOL)
    assert got["unreached"] == base["unreached"]
    ref = TU.params_to_flax({**{k: torch.from_numpy(v) for k, v in base["grads"].items()},
                             **{k: torch.zeros(()) for k in base["unreached"]}})["params"]
    assert _check_grads(got["grads"], got["unreached"],
                        jax.tree.map(np.asarray, ref)) > 40
    for k, s in base["stats"].items():
        assert (np.abs(got["stats"][k] - s) / np.maximum(np.abs(s), 1.0)).max() <= STAT_TOL


def test_sharded_mesmer_step_on_equal_halves_is_one_rank_on_one_half(runs):
    """Exact arithmetic, where the split can show: two ranks holding the
    same image each sum their batch-norm partials to exactly twice one
    rank's, the loss counts exactly twice the pixels, and the gradient
    all-reduce adds two equal halves, so every bit equals one rank's step on
    that image alone. (On distinct images the split only reorders f32
    sums, which this network's train-mode batch norms amplify: hence the
    tolerances above.)"""
    inp, (got, *_) = runs(2)
    one = {f"mesmer_{k}": inp[f"mesmer_halves_{k}"][:1] for k in ("x", "y_dist", "y_pix")}
    want = ranks.mesmer_step({**one, "mesmer_state": inp["mesmer_state"]}, "mesmer")
    _same(got["mesmer_halves"], want)


# ---------------------------------------------------------------- the dry run

def test_dryrun_multigpu_on_two_gloo_ranks_matches_world_size_one(monkeypatch):
    """dryrun_multigpu(2) end to end with the mini network at the JAX dry
    run's shapes; each piece equals the same pieces run here at world size
    1, bitwise except the SOM's (its minibatches), UMAP's (LDA's split
    tolerance) and the Mesmer step's (its tolerances). The spawned ranks
    inherit one CPU thread each from the environment."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got = graft_entry.dryrun_multigpu(2, backend="gloo", device="cpu", mini=True,
                                      timeout_s=TIMEOUT_S)
    base = graft_entry.dryrun_stages(graft_entry.dryrun_inputs(2), mini=True, device="cpu")
    assert [sorted(x) for x in got["launches"]] == [COUNTERS] * 2
    assert all(c["calls"] > 0 for c in got["collectives"])
    for stage in ("pixel", "quant", "enrichment", "flood", "fiber", "lda"):
        if stage == "lda":
            for k in ("lam", "gamma"):
                np.testing.assert_allclose(got[stage][k], base[stage][k], rtol=LDA_SPLIT_RTOL)
        else:
            _same(got[stage], base[stage])
    np.testing.assert_allclose(got["umap"]["emb"], base["umap"]["emb"], rtol=0,
                               atol=UMAP_SPLIT_ATOL)
    np.testing.assert_allclose(float(got["mesmer"]["loss"]), float(base["mesmer"]["loss"]),
                               rtol=LOSS_RTOL)
    s_got, s_base = graft_entry.summary(got), graft_entry.summary(base)
    for k in s_got:
        if not k.startswith(("som", "sharded-train", "umap", "mesmer", "lda")):
            assert s_got[k] == s_base[k], k
    for engine in ("levels", "minimax"):
        assert got["flood"][f"{engine}/done"].all()
        assert (got["flood"][f"{engine}/labels"] > 0).all()
