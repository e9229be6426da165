"""The spans of the two benchmarked paths, on the CPU.

Template 2's `run_pixel_clustering` on tests/phenotyping/test_pixie_fused.py's
cohort: one `pixie.run` root a call, each phase a child of it, the
`timings` dict filled from the phase spans, one `pixie.load_fov` a FOV, and
the `feather.write` bytes equal to the files left on disk. Template 1's
`segment_fovs` on the in-repo checkpoint: one `mesmer.segment_fovs` root, a
`mesmer.<phase>` span for each phase with its device (here the host's)
milliseconds, and a `watershed.flood` whose `blocks` count the loops run
(the minimax engine's two loops are its children, each with its count).
Template 1's `generate_cell_table` on tests/test_torch_cell_table_reference.py's
tree: one `quant.cell_table` root, a `quant.fov` a FOV with its steps as
children (its `quant.load` counting the channel files read straight into
their planes), `create_marker_count_matrices`'s `timings` filled from its steps,
and the benchmark's `table.*` readers reading the tree (None from a program
without spans). Template 3's `run_cell_clustering` on
tests/test_torch_cell_som_reference.py's cohort: one `cells.run` root with
a `cells.fov_counts` a FOV under `cells.c2pc`, the SOM steps' attributes,
and the benchmark's `cells.*` readers; the pixel run records no `cells.*`
span.
"""

import os

import numpy as np
import pytest
import torch

from ark_tpu_torch.ops import watershed as TW
from ark_tpu_torch.phenotyping import pixie_fused
from ark_tpu_torch.segmentation import mesmer as TM
from ark_tpu_torch.segmentation import synthetic as TS
from ark_tpu_torch.utils import profiling
from tests import test_torch_cell_som_reference as cell_som
from tests import test_torch_cell_table_reference as cell_table
from tests.phenotyping.test_pixie_fused import CHANNELS, FOVS, MAX_K, _build_cohort

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "ark_tpu", "models", "checkpoints", "mesmer_mini_synthetic.npz")
PIXIE_PHASES = {"chan_percentiles": "chan_percentiles_s", "norm_sweep": "norm_sweep_s",
                "subset_quantile": "subset_quantile_s", "som_train": "som_train_s",
                "assign": "assign_write_s", "som_avg": "som_avg_s",
                "consensus_meta_assign": "consensus_meta_assign_s",
                "final_write": "final_write_s", "meta_avg": "meta_avg_s"}
ASSIGN_PARTS = {"assign.d2h_wait": "assign_d2h_wait_s", "assign.flush": "assign_flush_s"}
MESMER_PHASES = ("normalize", "forward", "maxima", "markers", "quantize", "flood",
                 "area_filter", "readback")


def _recorded(fn):
    profiling.reset()
    try:
        with profiling.recording():
            out = fn()
        return out, profiling.spans()
    finally:
        profiling.reset()


def _seconds(s):
    return (s["end_ns"] - s["start_ns"]) / 1e9


@pytest.fixture(scope="module")
def pixie_run(tmp_path_factory):
    base, tiff_dir, seg_dir = _build_cohort(tmp_path_factory.mktemp("spans"))
    timings = {}
    _, spans = _recorded(lambda: pixie_fused.run_pixel_clustering(
        FOVS, CHANNELS, base, tiff_dir, seg_dir=seg_dir, img_sub_folder=None,
        max_k=MAX_K, subset_proportion=0.5, timings=timings, device="cpu"))
    return base, timings, spans


def test_pixie_run_is_one_tree_with_a_child_a_phase(pixie_run):
    _, _, spans = pixie_run
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "pixie.run" and root["attrs"] == {"fovs": len(FOVS)}
    assert {s["root"] for s in spans} == {root["id"]}
    ids = {s["id"] for s in spans}
    assert all(s["parent"] in ids for s in spans if s is not root)
    phases = {s["name"]: s for s in spans
              if s["parent"] == root["id"] and s["name"] in PIXIE_PHASES}
    assert set(phases) == set(PIXIE_PHASES)
    for s in spans:
        if s["name"] in ASSIGN_PARTS:
            assert s["parent"] == phases["assign"]["id"]


def test_pixie_timings_are_the_phase_spans(pixie_run):
    """Every key the dict had, each the sum of its spans' seconds, rounded
    to the dict's 3 places a span."""
    _, timings, spans = pixie_run
    keys = {**PIXIE_PHASES, **ASSIGN_PARTS}
    assert set(timings) == set(keys.values())
    for name, key in keys.items():
        mine = [_seconds(s) for s in spans if s["name"] == name]
        assert mine, name
        assert abs(timings[key] - sum(mine)) <= 0.0005 * len(mine) + 1e-9, key
    assert len([s for s in spans if s["name"] == "assign.flush"]) == len(FOVS)


def test_pixie_run_records_only_its_own_spans(pixie_run):
    """The pixel SOM shares its base class with the cell SOM, whose spans
    live in the cell subclass only."""
    _, _, spans = pixie_run
    names = {s["name"] for s in spans}
    assert names == {"pixie.run", "pixie.load_fov", "tiff.read", "feather.write",
                     *PIXIE_PHASES, *ASSIGN_PARTS}


def test_pixie_loads_each_fov_once_under_its_span(pixie_run):
    _, _, spans = pixie_run
    loads = [s for s in spans if s["name"] == "pixie.load_fov"]
    assert sorted(s["attrs"]["fov"] for s in loads) == sorted(FOVS)
    by_id = {s["id"]: s for s in spans}
    reads = [s for s in spans if s["name"] == "tiff.read"]
    # the channel TIFFs are the loads' children; the masks are read apart
    assert sum(by_id[s["parent"]]["name"] == "pixie.load_fov" for s in reads) \
        == len(FOVS) * len(CHANNELS)
    assert all(s["attrs"]["bytes"] > 0 for s in reads)


def test_pixie_write_bytes_are_the_files_on_disk(pixie_run):
    """The last write of each path holds the bytes the path holds now, and
    every feather and CSV the run left was written in a span."""
    base, _, spans = pixie_run
    last = {}
    for s in spans:
        if s["name"] == "feather.write":
            path = s["attrs"]["path"]
            last[path[:-4] if path.endswith(".tmp") else path] = s["attrs"]["bytes"]
    on_disk = {}
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith((".feather", ".csv")):
                on_disk[os.path.join(d, f)] = os.path.getsize(os.path.join(d, f))
    assert on_disk and set(on_disk) == set(last)
    assert sum(last.values()) == sum(on_disk.values())
    assert all(last[p] == n for p, n in on_disk.items())


@pytest.fixture(scope="module")
def app():
    return TM.Mesmer(weights_path=CKPT, device="cpu")


@pytest.fixture(scope="module")
def fovs():
    return TS.synthetic_cells(np.random.default_rng(3), 2, hw=64)[0]


def _count(monkeypatch, name):
    real = getattr(TW, name)
    calls = []

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out)
        return out
    monkeypatch.setattr(TW, name, counted)
    return calls


def test_mesmer_call_is_one_tree_with_its_phases(app, fovs, monkeypatch):
    sweeps = _count(monkeypatch, "_minimax_sweep")
    refines = _count(monkeypatch, "_refine_round")
    _, spans = _recorded(lambda: TM.segment_fovs(fovs, app=app, batch_size=2, device="cpu",
                                                 postprocess="device"))
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "mesmer.segment_fovs" and root["attrs"] == {"fovs": 2}
    assert {s["root"] for s in spans} == {root["id"]}
    counts = {p: sum(s["name"] == f"mesmer.{p}" for s in spans) for p in MESMER_PHASES}
    assert counts == {"normalize": 1, "forward": 1, "maxima": 1, "markers": 2, "quantize": 2,
                      "flood": 2, "area_filter": 2, "readback": 1}
    for s in spans:
        if s["name"].startswith("mesmer.") and s is not root:
            assert s["parent"] == root["id"]
            assert s["device_ms"] == pytest.approx(_seconds(s) * 1e3)
    by_id = {s["id"]: s for s in spans}
    floods = [s for s in spans if s["name"] == "watershed.flood"]
    assert len(floods) == 2
    assert all(by_id[s["parent"]]["name"] == "mesmer.flood" for s in floods)
    assert all(s["attrs"]["engine"] == "minimax" for s in floods)
    loops = {name: [s for s in spans if s["name"] == name]
             for name in ("watershed.relax", "watershed.relabel")}
    for name, parts in loops.items():
        assert sorted(by_id[s["parent"]]["id"] for s in parts) == sorted(s["id"] for s in floods)
    assert sum(s["attrs"]["blocks"] for s in loops["watershed.relax"]) == len(sweeps) > 0
    assert sum(s["attrs"]["blocks"] for s in loops["watershed.relabel"]) \
        == len(refines) // TW._MINIMAX_BLOCK > 0
    assert len(refines) % TW._MINIMAX_BLOCK == 0
    # on CPU tensors the relaxation is the plain loop, a sweep a block
    assert all(s["attrs"]["engine"] == "plain" for s in loops["watershed.relax"])
    # on CPU tensors the re-labeling is the plain loop: every block's rounds run
    assert all(s["attrs"]["engine"] == "plain"
               and s["attrs"]["rounds"] == TW._MINIMAX_BLOCK * s["attrs"]["blocks"]
               for s in loops["watershed.relabel"])
    for flood in floods:
        assert flood["attrs"]["blocks"] == sum(s["attrs"]["blocks"] for s in spans
                                               if s["parent"] == flood["id"])


def test_level_flood_counts_its_claim_rounds(app, fovs, monkeypatch):
    monkeypatch.setattr(TW, "_ENGINE", "levels")
    runs = _count(monkeypatch, "claim_levels")
    _, spans = _recorded(lambda: app.predict(fovs[:1], postprocess="device"))
    floods = [s for s in spans if s["name"] == "watershed.flood"]
    assert [s["attrs"]["engine"] for s in floods] == ["levels", "levels"]
    assert sum(s["attrs"]["blocks"] for s in floods) == sum(r[2] for r in runs) > 0
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "mesmer.predict"


def test_host_postprocess_hands_its_span_to_the_pool(app, fovs):
    _, spans = _recorded(lambda: TM.segment_fovs(fovs, app=app, batch_size=2, device="cpu"))
    (root,) = [s for s in spans if s["parent"] is None]
    (post,) = [s for s in spans if s["name"] == "mesmer.host_post"]
    floods = [s for s in spans if s["name"] == "mesmer.host_flood"]
    assert post["parent"] == root["id"]
    assert sorted(s["attrs"]["fov"] for s in floods) == [0, 0, 1, 1]
    assert all(s["parent"] == post["id"] and s["root"] == root["id"] for s in floods)


QUANT_STEPS = {"quant.load": 1, "quant.match_nuclei": 1, "quant.reduce": 2,
               "quant.convex": 2, "quant.concavities": 2, "quant.checkpoint": 1}
QUANT_TIMINGS = {"device_reductions_s": ("quant.reduce",),
                 "convex_s": ("quant.convex", "quant.concavities"),
                 "assembly_s": ("quant.assemble",)}


@pytest.fixture(scope="module")
def quant_run(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("quant_spans"))
    tree = cell_table.write_tree(base, *cell_table._cohort())
    out, spans = _recorded(lambda: cell_table.run_job(base, *tree))
    return out, tree, spans


def test_cell_table_is_one_tree_with_a_fov_span_a_fov(quant_run):
    _, _, spans = quant_run
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "quant.cell_table"
    assert root["attrs"] == {"fovs": 2, "channels": len(cell_table.CHANNELS),
                             "nuclear_counts": True}
    assert {s["root"] for s in spans} == {root["id"]}
    fovs = [s for s in spans if s["name"] == "quant.fov"]
    assert sorted(s["attrs"]["fov"] for s in fovs) == cell_table.FOVS
    assert all(s["parent"] == root["id"] for s in fovs)
    by_id = {s["id"]: s for s in spans}
    for fov in fovs:
        kids = [s for s in spans if s["parent"] == fov["id"]]
        counts = {n: sum(s["name"] == n for s in kids) for n in QUANT_STEPS}
        assert counts == QUANT_STEPS, fov["attrs"]["fov"]
        assert any(s["name"] == "quant.assemble" for s in kids)
        assert {s["name"] for s in kids} <= set(QUANT_STEPS) | {"quant.assemble"}
    # the codec's reads sit inside the loads: 6 channels and 2 masks a FOV
    reads = [s for s in spans if s["name"] == "tiff.read"]
    assert len(reads) == 2 * (len(cell_table.CHANNELS) + 2)
    assert all(by_id[s["parent"]]["name"] == "quant.load" for s in reads)


def test_cell_table_step_attributes(quant_run):
    out, _, spans = quant_run
    # the planted tree's channels are float32 pages of one native strip:
    # every file goes straight into its plane
    loads = [s for s in spans if s["name"] == "quant.load"]
    assert [s["attrs"] for s in loads] == [
        {"direct": len(cell_table.CHANNELS), "decoded": 0}] * len(cell_table.FOVS)
    reduces = [s for s in spans if s["name"] == "quant.reduce"]
    assert sorted(s["attrs"]["comp"] for s in reduces) == ["nuclear"] * 2 + ["whole_cell"] * 2
    # CPU tensors launch no kernel; the host's clock stands for the device's
    assert all(s["attrs"]["segment_sum"] == 0 and s["attrs"]["plan"] == 0
               and s["device_ms"] is not None for s in reduces)
    for s in (s for s in spans if s["name"] == "quant.convex"):
        a = s["attrs"]
        assert a["comp"] in ("whole_cell", "nuclear")
        assert a["device_cells"] + a["host_cells"] <= a["cells"] and a["cells"] > 0
    assert sum(s["attrs"]["host_cells"] for s in spans if s["name"] == "quant.convex") == 2
    crops = [s["attrs"]["crops"] for s in spans if s["name"] == "quant.concavities"]
    assert len(crops) == 4 and sum(crops) > 0
    matched = [s["attrs"]["matched"] for s in spans if s["name"] == "quant.match_nuclei"]
    assert len(matched) == 2 and min(matched) > 0
    parts = [os.path.join(out, "parts", f"{f}.quant.pkl") for f in cell_table.FOVS]
    written = [s["attrs"]["bytes"] for s in spans if s["name"] == "quant.checkpoint"]
    assert written == [os.path.getsize(p) for p in parts]


def test_cell_table_timings_are_the_step_spans(quant_run):
    from ark_tpu_torch.io import load_utils
    from ark_tpu_torch.segmentation import marker_quantification as TQ

    _, (tiff_dir, seg_dir), _ = quant_run
    images = load_utils.load_imgs_from_tree(tiff_dir, img_sub_folder=None, fovs=["fov0"])
    _, labels = TQ._mask_labels(seg_dir, "fov0", "whole_cell", True, True)
    timings = {}
    _, spans = _recorded(lambda: TQ.create_marker_count_matrices(
        labels, images, nuclear_counts=True, device="cpu", timings=timings))
    assert set(timings) == set(QUANT_TIMINGS)
    for key, names in QUANT_TIMINGS.items():
        mine = [_seconds(s) for s in spans if s["name"] in names]
        assert mine, key
        assert timings[key] == pytest.approx(sum(mine), rel=1e-6, abs=1e-6)


def test_cell_table_readers_read_the_tree(quant_run, monkeypatch):
    from portbench import run as harness

    _, _, spans = quant_run
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in spans])
    rec = {"attempted": 1, "fovs": 2}

    def total(*names):
        return sum(_seconds(s) for s in spans if s["name"] in names)
    want = {"table.load_s_per_fov": total("quant.load") / 2,
            "table.reduce_ms_per_fov": 1e3 * total("quant.reduce") / 2,
            "table.convex_s_per_fov": total("quant.convex", "quant.concavities") / 2,
            "table.assemble_s_per_fov": total("quant.assemble") / 2}
    for name, value in want.items():
        assert harness.read_metric(name, rec) == pytest.approx(value) and value > 0
    monkeypatch.delattr(profiling, "spans")                      # a program without spans
    for name in want:
        assert harness.read_metric(name, rec) is None


CELLS_STEPS = ("cells.c2pc", "cells.normalize", "cells.som_train", "cells.som_assign",
               "cells.som_avg", "cells.consensus", "cells.meta_avg", "cells.weighted",
               "cells.wc_avg")


@pytest.fixture(scope="module")
def cells_run(tmp_path_factory):
    driver = cell_som.small_cohort(tmp_path_factory.mktemp("cells_spans"))
    base = os.path.join(driver.workdir, "job")
    _, spans = _recorded(lambda: driver.job(base))
    return driver, base, spans


def test_cell_clustering_is_one_tree_with_a_count_span_a_fov(cells_run):
    driver, base, spans = cells_run
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "cells.run"
    cells = cell_som.reference.read_job(base).cells
    assert root["attrs"] == {"fovs": len(driver.fovs), "cells": len(cells), "columns": 8}
    assert {s["root"] for s in spans} == {root["id"]}
    by_id = {s["id"]: s for s in spans}
    steps = {n: [s for s in spans if s["name"] == n] for n in CELLS_STEPS}
    assert all(len(v) == 1 for v in steps.values()), {n: len(v) for n, v in steps.items()}
    # every step but the normalization, which the SOM's constructor runs,
    # is a child of the root
    assert all(v[0]["parent"] == root["id"] for n, v in steps.items()
               if n != "cells.normalize")
    assert by_id[steps["cells.normalize"][0]["parent"]]["name"] == "cells.run"
    (c2pc,) = steps["cells.c2pc"]
    (read,) = [s for s in spans if s["name"] == "cells.read_table"]
    assert read["parent"] == c2pc["id"]
    assert read["attrs"] == {"bytes": os.path.getsize(driver.cell_table)}
    counts = [s for s in spans if s["name"] == "cells.fov_counts"]
    assert [s["attrs"]["fov"] for s in counts] == driver.fovs
    assert all(s["parent"] == c2pc["id"] for s in counts)
    for s in counts:
        path = os.path.join(driver.pixel_dir, s["attrs"]["fov"] + ".feather")
        assert s["attrs"]["pixels"] == len(cell_som.reference._feather(path, ["label"]))
    # the runner's three feathers and the SOM weights go through feather.write
    writes = [os.path.basename(s["attrs"]["path"]) for s in spans
              if s["name"] == "feather.write"]
    assert sorted(writes) == sorted(["cluster_counts.feather", "cell_som_weights.feather",
                                     "weighted_cell_channel.feather",
                                     "cluster_counts_size_norm.feather"])


def test_cell_som_step_attributes(cells_run):
    _, _, spans = cells_run
    (train,) = [s for s in spans if s["name"] == "cells.som_train"]
    (root,) = [s for s in spans if s["parent"] is None]
    assert train["attrs"] == {"rows": root["attrs"]["cells"]}
    (assign,) = [s for s in spans if s["name"] == "cells.som_assign"]
    # CPU tensors take the plain BMU: no kernel launch
    assert assign["attrs"] == {"bmu": 0}
    for s in (train, assign, *[s for s in spans if s["name"] == "cells.weighted"]):
        assert s["device_ms"] == pytest.approx(_seconds(s) * 1e3)


def test_cell_som_assign_counts_its_bmu_launches(cells_run, monkeypatch):
    from ark_tpu_torch.ops import som
    from ark_tpu_torch.phenotyping import cluster_helpers

    real = som.som_map

    def launching(weights, data, return_dist=True, *, device):
        som.bmu.launches += 1
        return real(weights, data, return_dist, device=device)
    monkeypatch.setattr(som, "som_map", launching)
    driver, base, _ = cells_run
    cells = cell_som.reference.read_job(base).cells
    cols = [c for c in cells.columns if c.startswith("pixel_meta_cluster_rename_")]
    pysom = cluster_helpers.CellSOMCluster(
        cells, os.path.join(base, "cell_som_weights.feather"), driver.fovs, cols,
        normalize=False, device="cpu")
    _, spans = _recorded(pysom.assign_som_clusters)
    (assign,) = [s for s in spans if s["name"] == "cells.som_assign"]
    assert assign["attrs"] == {"bmu": 1}


def test_cell_clustering_readers_read_the_tree(cells_run, monkeypatch):
    from portbench import run as harness

    driver, _, spans = cells_run
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in spans])
    n = len(driver.fovs)
    rec = {"attempted": 1, "fovs": n}

    def total(*names):
        return sum(_seconds(s) for s in spans if s["name"] in names)
    want = {"cells.counts_s_per_fov": total("cells.c2pc") / n,
            "cells.tables_s_per_fov": total("cells.normalize", "cells.som_avg",
                                            "cells.consensus", "cells.meta_avg",
                                            "cells.weighted", "cells.wc_avg") / n}
    for name, value in want.items():
        assert harness.read_metric(name, rec) == pytest.approx(value) and value > 0
    # the SOM's milliseconds come from the job after the window, not the tree
    assert harness.read_metric("cells.som_ms_per_job", rec) is None
    monkeypatch.delattr(profiling, "spans")                      # a program without spans
    for name in want:
        assert harness.read_metric(name, rec) is None


def test_cell_som_ms_is_read_from_an_unprofiled_job_after_the_window(cells_run):
    from portbench import run as harness

    driver, _, _ = cells_run
    profiling.reset()
    try:
        driver.traced_extras()
        held = profiling.spans()
    finally:
        profiling.reset()
    (outer,) = [s for s in held if s["name"] == "portbench.untraced_job"]
    # the job hangs under the harness's span: no `cells.run` root for the
    # window's readers to count
    assert outer["parent"] is None and {s["root"] for s in held} == {outer["id"]}
    assert not [s for s in held if s["parent"] is None and s["name"] == "cells.run"]
    som = sum(_seconds(s) for s in held if s["name"] in ("cells.som_train", "cells.som_assign"))
    assert som > 0
    assert driver.records["som_ms_untraced"] == pytest.approx(1e3 * som)
    assert harness.read_metric("cells.som_ms_per_job", driver.records) \
        == driver.records["som_ms_untraced"]
    assert not os.path.exists(os.path.join(driver.workdir, "untraced"))
