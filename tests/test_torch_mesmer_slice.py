"""The segmentation slice of the port against the JAX package's, end to end.

Template 1's path: Mesmer's percentile normalization, the forward, local
maxima and the deep-watershed postprocess, on the in-repo trained
checkpoint at the JAX tests' cohort size (4 x 64²). Tolerances: the
normalization, the maxima and every integer step are bitwise; the heads
differ in the last bits (other summation orders), so labels from each
side's own heads are held to instance agreement (recall and precision at
IoU 0.5 >= 0.98) and to the planted-truth bounds of
tests/segmentation/test_mesmer_planted.py, while the postprocess fed the
JAX heads must give the JAX labels bit for bit under both flood engines.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ark_tpu.ops import watershed as JW
from ark_tpu.segmentation import mesmer as JM
from ark_tpu.segmentation import synthetic as JS
from ark_tpu_torch.ops import watershed as TW
from ark_tpu_torch.segmentation import mesmer as TM
from ark_tpu_torch.segmentation import synthetic as TS

torch.set_num_threads(2)

CKPT = os.path.join(os.path.dirname(JM.__file__), "..", "models",
                    "checkpoints", "mesmer_mini_synthetic.npz")
AGREEMENT = 0.98


@pytest.fixture(scope="module")
def cohort():
    return TS.synthetic_cells(np.random.default_rng(3), 4, hw=64)


@pytest.fixture(scope="module")
def tapp():
    return TM.Mesmer(weights_path=CKPT, device="cpu")


@pytest.fixture(scope="module")
def japp():
    return JM.Mesmer(weights_path=CKPT)


@pytest.fixture()
def engine(request, monkeypatch):
    monkeypatch.setattr(JW, "_ENGINE", request.param)
    monkeypatch.setattr(TW, "_ENGINE", request.param)
    return request.param


def test_synthetic_cells_match_jax():
    for kwargs in (dict(), dict(n_cells=(20, 30), crowding=0.35)):
        got = TS.synthetic_cells(np.random.default_rng(7), 2, hw=96, **kwargs)
        ref = JS.synthetic_cells(np.random.default_rng(7), 2, hw=96, **kwargs)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    assert TS.match_instances(got[1][0], got[1][0])["recall"] == 1.0
    assert TS.match_instances(got[1][0], ref[2][0]) \
        == JS.match_instances(got[1][0], ref[2][0])


@pytest.mark.parametrize("shape", [(4, 64, 64, 2), (2, 37, 53, 2), (1, 300, 7, 2)])
def test_percentile_normalize_bitwise(shape):
    """Against the reference as it runs inside its jitted step, where XLA
    fuses the percentile lerp into one multiply-add."""
    rng = np.random.default_rng(shape[1])
    x = (rng.random(shape) ** 3 * 10).astype(np.float32)
    ref = np.asarray(jax.jit(JM._percentile_normalize)(jnp.asarray(x)))
    got = TM._percentile_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_find_maxima_bitwise():
    rng = np.random.default_rng(1)
    inner = rng.random((3, 40, 52)).astype(np.float32)
    inner[0, :5, :5] = 0.5                                 # a flat plateau
    for thr in (0.1, 0.6):
        ref = np.asarray(JM._find_maxima(jnp.asarray(inner), thr))
        got = TM._find_maxima(torch.from_numpy(inner), thr).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("engine", ["minimax", "levels"], indirect=True)
def test_device_postprocess_on_jax_heads_is_bitwise(engine, cohort, tapp):
    """The port's device postprocess given the heads of the JAX package's
    step == the JAX package's fused forward + postprocess, label for label
    (a fresh JAX Mesmer, so its step traces under this engine)."""
    imgs = cohort[0]
    japp = JM.Mesmer(weights_path=CKPT)
    args = (japp.variables, jnp.asarray(imgs), jnp.float32(0.1))
    heads = japp._segment_device(*args)
    ref, done = japp._segment_device_post(*args, jnp.float32(0.3), jnp.int32(15))
    res = {c: {k: torch.from_numpy(np.array(v)) for k, v in heads[c].items()}
           for c in heads}
    got, got_done = tapp._device_post(res, 0.3, 15)
    for comp in ("whole_cell", "nuclear"):
        np.testing.assert_array_equal(got[comp].numpy(), np.asarray(ref[comp]))
    assert got_done is bool(done) is True


def _agreement(a, b):
    stats = [TS.match_instances(a[i], b[i]) for i in range(a.shape[0])]
    return (np.mean([s["recall"] for s in stats]),
            np.mean([s["precision"] for s in stats]))


def _check_against_jax_and_truth(got, ref, cohort):
    _, cells, nucs = cohort
    for comp, truth in (("whole_cell", cells), ("nuclear", nucs)):
        assert got[comp].dtype == np.int32 and got[comp].shape == truth.shape
        recall, precision = _agreement(got[comp], ref[comp])
        assert recall >= AGREEMENT and precision >= AGREEMENT, (comp, recall,
                                                                precision)
        recall, precision = _agreement(got[comp], truth)
        assert recall >= 0.9 and precision >= 0.9, (comp, recall, precision)


@pytest.mark.parametrize("engine", ["minimax", "levels"], indirect=True)
def test_segment_fovs_device_matches_jax(engine, cohort):
    tapp = TM.Mesmer(weights_path=CKPT, device="cpu")
    launches, levels_launches = TW.claim_round.launches, TW.claim_levels.launches
    got = TM.segment_fovs(cohort[0], app=tapp, batch_size=3, device="cpu",
                          postprocess="device")
    ref = JM.segment_fovs(cohort[0], app=JM.Mesmer(weights_path=CKPT), batch_size=3,
                          postprocess="device")
    _check_against_jax_and_truth(got, ref, cohort)
    assert tapp.host_fallbacks == 0
    assert TW.claim_round.launches == launches      # CPU tensors: no kernel
    assert TW.claim_levels.launches == levels_launches


def test_predict_host_matches_jax(cohort, tapp, japp):
    got = tapp.predict(cohort[0], postprocess="host")
    ref = japp.predict(cohort[0], postprocess="host")
    _check_against_jax_and_truth(got, ref, cohort)
    hosted = TM.segment_fovs(cohort[0], app=tapp, batch_size=3, device="cpu")
    for comp in got:
        np.testing.assert_array_equal(hosted[comp], got[comp])


def test_non_convergence_falls_back_to_host_and_is_counted(cohort, monkeypatch):
    """A round budget that reports non-convergence sends the batch to the
    host flood, as in the reference, and the fallback is counted."""
    app = TM.Mesmer(weights_path=CKPT, device="cpu")
    real = TW.flood
    monkeypatch.setattr(TW, "flood", lambda *a: (real(*a)[0], False))
    got = app.predict(cohort[0][:2], postprocess="device")
    assert app.host_fallbacks == 1
    want = app.predict(cohort[0][:2], postprocess="host")
    for comp in want:
        np.testing.assert_array_equal(got[comp], want[comp])


def test_predict_rejects_unknown_postprocess(tapp, cohort):
    with pytest.raises(ValueError, match="postprocess"):
        tapp.predict(cohort[0][:1], postprocess="gpu")
    with pytest.raises(TypeError, match="unknown predict kwargs"):
        TM.segment_fovs(cohort[0][:1], app=tapp, device="cpu", bogus=1)


def test_phase_timings_cover_the_device_path(cohort):
    timings = {}
    app = TM.Mesmer(weights_path=CKPT, device="cpu", timings=timings)
    app.predict(cohort[0][:1], postprocess="device")
    assert set(timings) == {"normalize", "forward", "maxima", "markers",
                            "quantize", "flood", "area_filter"}
    assert all(v >= 0 for v in timings.values())


def test_create_deepcell_output_writes_masks(tmp_path, cohort):
    """Template 1's entry on a tmp dir: int32 masks per FOV, equal to
    predict's, and a second call skips what is done."""
    from ark_tpu.io.image_utils import read_image, save_image
    from ark_tpu_torch.utils import deepcell_service_utils as dsu

    inp, out = tmp_path / "deepcell_input", tmp_path / "deepcell_output"
    for i in range(2):
        save_image(str(inp / f"fov{i}.tiff"), np.moveaxis(cohort[0][i], -1, 0))
    dsu.create_deepcell_output(str(inp), str(out), weights_path=CKPT,
                               zip_size=1, device="cpu")
    want = TM.Mesmer(weights_path=CKPT, device="cpu").predict(cohort[0][:2])
    for i in range(2):
        for comp in ("whole_cell", "nuclear"):
            mask = read_image(str(out / f"fov{i}_{comp}.tiff"))
            assert mask.dtype == np.int32
            np.testing.assert_array_equal(mask, want[comp][i])
    stamp = os.path.getmtime(out / "fov0_whole_cell.tiff")
    dsu.create_deepcell_output(str(inp), str(out), weights_path=CKPT, device="cpu")
    assert os.path.getmtime(out / "fov0_whole_cell.tiff") == stamp


def test_smoke_segmentation_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's segmentation phases, driven on the CPU at a tiny size
    (the card's run is the same code at full size): every check they make
    holds, the level engine's level scans, their rounds and phase B's
    rounds are counted, and so are the minimax engine's re-labelings and
    relaxations."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    real_levels, real_round = TW.claim_levels, TW.claim_round

    # the smoke reads the counts of whatever stands under the name: this
    # wrapper's, kept here from what the real one returns
    def counted(lab, q, level, levels, bfs_rounds):
        out = real_levels(lab, q, level, levels, bfs_rounds)
        counted.launches += 1
        counted.rounds += out[2]
        return out

    def counted_round(lab, q, level):
        counted_round.launches += 1
        return real_round(lab, q, level)

    def counted_relabel(*args):
        out = real_relabel(*args)
        counted_relabel.launches += 1
        counted_relabel.rounds += out[3]
        return out

    def counted_relax(*args):
        out = real_relax(*args)
        counted_relax.launches += 1
        counted_relax.blocks += out[2]
        return out

    real_relabel, real_relax = TW.minimax_relabel, TW.minimax_relax
    counted.launches = counted.rounds = counted_round.launches = 0
    counted_relabel.launches = counted_relabel.rounds = 0
    counted_relax.launches = counted_relax.blocks = 0
    monkeypatch.setattr(TW, "claim_levels", counted)
    monkeypatch.setattr(TW, "claim_round", counted_round)
    monkeypatch.setattr(TW, "minimax_relabel", counted_relabel)
    monkeypatch.setattr(TW, "minimax_relax", counted_relax)
    monkeypatch.setattr(TW, "_ENGINE", TW._ENGINE)

    def counts():
        return {"launches": counted.launches, "rounds": counted.rounds,
                "round_launches": counted_round.launches,
                "relabel_launches": counted_relabel.launches,
                "relabel_rounds": counted_relabel.rounds,
                "relax_launches": counted_relax.launches, "relax_blocks": counted_relax.blocks}

    # each segment_fovs call's counts, read around it as the phase reads them
    runs = []
    real_segment = TM.segment_fovs

    def recorded(*args, **kw):
        before = counts()
        out = real_segment(*args, **kw)
        runs.append((TW._ENGINE, {k: v - before[k] for k, v in counts().items()}))
        return out

    monkeypatch.setattr(TM, "segment_fovs", recorded)
    fovs = TS.synthetic_cells(np.random.default_rng(0), 2, hw=64,
                              n_cells=(12, 16), crowding=0.35)[0]
    app, masks = chip_smoke.run_device_postprocess({"small": (fovs, 2)})
    assert sorted(masks["small"]) == ["nuclear", "whole_cell"]
    assert masks["small"]["whole_cell"].shape == fovs.shape[:3]
    # after the warm-up, each engine's counted run, then its phase-timed run
    assert [engine for engine, _ in runs[1:]] == ["minimax"] * 2 + ["levels"] * 2
    minimax, levels = runs[1][1], runs[3][1]
    assert runs[2][1] == minimax and runs[4][1] == levels
    assert levels["launches"] > 0 and app.host_fallbacks == 0
    assert levels["rounds"] >= levels["launches"]
    # the minimax engine's runs: one re-labeling and one relaxation a flood;
    # the level engine's runs, none
    assert minimax["relabel_launches"] == 2 and minimax["relax_launches"] == 2
    assert minimax["relax_blocks"] >= 2 and minimax["relabel_rounds"] > 0
    assert levels["relabel_launches"] == levels["relax_launches"] == 0
    assert minimax["launches"] == minimax["round_launches"] == 0
    assert TW._ENGINE == "minimax"
    relief = chip_smoke.cohort_relief(app, fovs)
    before = counted_round.launches
    chip_smoke.compare_level_flood(relief)
    assert counted_round.launches > before
    # the re-labeling check; the counted wrapper stands in for the kernel's
    # launch count
    before = counted_relabel.launches
    floods = {**relief, "cell-like": chip_smoke.cell_relief(2, 64, 48, seed=7),
              "crossing": chip_smoke.cell_relief(2, 64, 48, seed=7, crossing=True)}
    err, checked = chip_smoke.check_relabel_kernel(floods)
    assert err == 0 and checked == 4 * (1 + len(chip_smoke.RELABEL_BUDGETS))
    assert counted_relabel.launches - before == checked + 4     # and the captured floods
    # the relaxation check on the same floods, each captured once more
    before = counted_relax.launches
    err, checked = chip_smoke.check_relax_kernel(floods)
    assert err == 0 and checked == 4 * (1 + len(chip_smoke.RELAX_BUDGETS))
    assert counted_relax.launches - before == checked + 4
