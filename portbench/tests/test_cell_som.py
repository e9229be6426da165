"""The cell-SOM cell at a tiny size on the CPU: the harness's check passes on
the program as it is and fails on a fault planted in the timed path; the
driver's inputs are what template 3 reads (template 2's pixel feathers after
the GUI remap, column for column and type for type; the 118-column cell
table of the cell-table cell, its sizes the masks' pixel counts)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from portbench import inputs
from portbench import run as harness
from portbench.drivers import cell_cluster_jobs, pixie_jobs
from portbench.reference import cell_som as reference
from portbench.reference import cell_table
from portbench.tests.conftest import ROOT

CELL = "cell_som_100k"
SEED = 3_000_000_019


def _bench():
    with open(f"{ROOT}/BENCHMARK.json") as f:
        return json.load(f)


def small(load_cell):
    """The cell at 3 FOVs of 96^2 with 40 cells each, a 4 x 4 SOM and
    max_k 5 (the conftest's 16 cells are too few for 20 meta clusters)."""
    def load(name):
        bench, cell, cfg, traffic = load_cell(name)
        return (bench, cell, dict(cfg, fov_size=96, xdim=4, ydim=4, max_k=5),
                dict(traffic, fovs_per_job=3, cells_per_fov=40, cell_radius=10))
    return load


@pytest.fixture
def small_run(monkeypatch, capsys):
    monkeypatch.setattr(harness, "load_cell", small(harness.load_cell))

    def go(trace=0):
        result = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "2",
                               "--trace", str(trace)], device="cpu")
        out, err = capsys.readouterr()
        return result, out.strip().splitlines(), err
    return go


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    _, _, cfg, traffic = small(harness.load_cell)(CELL)
    d = cell_cluster_jobs.Driver(cfg, traffic, SEED, "cpu",
                                 str(tmp_path_factory.mktemp("cell_som_inputs")))
    d.make_inputs()
    return d


@pytest.mark.parametrize("trace", [0, 1])
def test_correct_and_last_line(small_run, trace):
    result, out, err = small_run(trace=trace)
    assert json.loads(out[-1]) == result
    assert result["correct"], err[-3000:]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"rows_mismatch", "count_mismatch", "norm_gap",
                                     "som_gap", "som_unexcused", "meta_mismatch",
                                     "avg_gap", "weighted_gap"}
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in _bench()[kind] if CELL in m.get("workloads", [CELL])}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    if trace:
        assert set(want) == {"cells.counts_s_per_fov", "cells.som_ms_per_job",
                             "cells.tables_s_per_fov"}
        gaps = {name for name, _ in result["breakdown"]["idle_gaps"]}
        assert {"create_c2pc_data", "train_cell_som"} <= gaps
    (line,) = [x for x in err.splitlines() if x.startswith("records ")]
    records = json.loads(line[len("records "):])
    phases = [records[f"setup_{p}_s"] for p in ("context", "masks", "pixels", "table",
                                                   "warm")]
    assert all(v >= 0 for v in phases)
    assert records["input_bytes"] > 0 and records["cells"] == 3 * 40
    assert 0 < records["job_s_min"] <= records["job_s_max"]


def test_fault_a_count_altered(small_run, monkeypatch):
    from ark_tpu_torch.phenotyping import cell_cluster_utils

    real = cell_cluster_utils._c2pc_counts

    def altered(labels, clusters, cluster_ids):
        counts = real(labels, clusters, cluster_ids)
        counts.iloc[0, 0] += 1
        return counts
    monkeypatch.setattr(cell_cluster_utils, "_c2pc_counts", altered)
    result, _, err = small_run()
    assert not result["correct"], err[-2000:]
    assert result["checks"]["count_mismatch"]["value"] > 0


def test_fault_training_step_unchanged(small_run, monkeypatch):
    from ark_tpu_torch.ops import som

    monkeypatch.setattr(som, "_train_step", lambda w, *a, **k: w)
    result, _, err = small_run()
    assert not result["correct"], err[-2000:]
    assert result["checks"]["som_gap"]["value"] > result["checks"]["som_gap"]["limit"]


def test_pixel_feathers_have_template_2s_schema(driver, tmp_path):
    """A pixel job of the pixel cell, remapped by the metacluster GUI's
    untouched mapping, writes the feathers' columns and types."""
    import pandas as pd
    import pyarrow as pa

    from ark_tpu_torch.phenotyping import pixel_meta_clustering

    _, _, cfg, traffic = harness.load_cell("pixie_files_4fov")
    cfg = dict(cfg, fov_size=64)
    traffic = dict(traffic, fovs_per_job=2, cells_per_fov=8, cell_radius=8)
    pixel = pixie_jobs.Driver(cfg, traffic, SEED, "cpu", str(tmp_path))
    pixel.make_inputs()
    base = os.path.join(str(tmp_path), "job")
    pixel.job(base, {})
    som_avg = pd.read_csv(os.path.join(base, "pixel_channel_avg_som_cluster.csv"))
    remap = som_avg[["pixel_som_cluster", "pixel_meta_cluster"]].copy()
    remap["pixel_meta_cluster_rename"] = remap["pixel_meta_cluster"].astype(str)
    remap.to_csv(os.path.join(base, "remap.csv"), index=False)
    pixel_meta_clustering.apply_pixel_meta_cluster_remapping(
        pixel.fovs, pixel.channels, base, "pixel_mat_data", "remap.csv")

    def schema(path):
        with pa.memory_map(path) as src:
            s = pa.ipc.open_file(src).schema
        return [(f.name, str(f.type)) for f in s]
    want = schema(os.path.join(base, "pixel_mat_data", "fov0.feather"))
    assert cfg["channels"] == driver.channels
    assert schema(os.path.join(driver.pixel_dir, "fov0.feather")) == want
    assert ("pixel_meta_cluster_rename", "int64") in want
    # the pixel averages' columns, as template 2 leaves them after the remap
    avg = pd.read_csv(driver.pixel_avg)
    assert list(avg.columns) == ["pixel_meta_cluster", *driver.channels, "count",
                                 "pixel_meta_cluster_rename"]


def test_cell_table_is_the_cell_table_cells(driver):
    import pandas as pd

    with open(os.path.join(ROOT, "portbench", "configs", "quant_1024x40.json")) as f:
        quant = json.load(f)
    table = pd.read_csv(driver.cell_table)
    assert list(table.columns) == cell_table.columns(quant["channels"])
    assert len(table.columns) == 118 == driver.traffic["cell_table_columns"]
    masks = inputs.whole_cell_masks(SEED, len(driver.fovs), driver.cfg["fov_size"],
                                    driver.traffic["cells_per_fov"],
                                    driver.traffic["cell_radius"], "cpu")
    assert list(table["fov"].astype(str).unique()) == sorted(driver.fovs)
    for fov, mask in zip(driver.fovs, masks):
        mine = table[table["fov"].astype(str) == fov]
        ids, n = np.unique(mask[mask > 0], return_counts=True)
        assert np.array_equal(mine["label"].to_numpy(), ids)
        assert np.array_equal(mine["cell_size"].to_numpy(np.float64), n.astype(np.float64))
    assert set(table["mask_type"].astype(str)) == {"whole_cell"}


def test_pixels_as_the_traffic_says(driver):
    tr = driver.traffic
    draws = cell_cluster_jobs.cohort_draws(SEED, tr, len(driver.channels))
    # every meta cluster holds at least one SOM cluster
    assert set(draws["som_to_meta"]) == set(range(tr["pixel_meta_clusters"]))
    assert len(draws["som_to_meta"]) == tr["pixel_som_clusters"]
    size = driver.cfg["fov_size"] ** 2
    px = reference._feather(os.path.join(driver.pixel_dir, "fov0.feather"))
    assert 0.85 < len(px) / size < 1.0                    # 5% dropped
    meta = px["pixel_meta_cluster"].to_numpy()
    som = px["pixel_som_cluster"].to_numpy()
    assert np.array_equal(draws["som_to_meta"][som - 1] + 1, meta)
    assert np.array_equal(px["pixel_meta_cluster_rename"].to_numpy(), meta)
    flat = px["row_index"].to_numpy() * driver.cfg["fov_size"] + px["column_index"].to_numpy()
    assert np.all(np.diff(flat) > 0)


def test_cell_table_channels_are_the_cohorts_counts(driver):
    """Each channel is a Poisson count over the cell's size, its rate the sum
    over the mask of the cell-table cell's per-pixel rates: dense, as a
    ~350-px cell of that cohort gives it."""
    import pandas as pd

    masks = inputs.whole_cell_masks(SEED, 1, driver.cfg["fov_size"],
                                    driver.traffic["cells_per_fov"],
                                    driver.traffic["cell_radius"], "cpu")
    mask = masks[0]
    labels = np.unique(mask[mask > 0])
    got = cell_cluster_jobs.mask_rates(inputs.host_rng(5, 0), mask, labels, 3)
    # the field as `inputs.mibi_cohort` lays it out, summed pixel by pixel
    size = mask.shape[0]
    cell = max(size // 32, 1)
    coarse = inputs.host_rng(5, 0).gamma(0.6, 4.0, size=(size // cell, size // cell, 3))
    field = coarse.repeat(cell, 0).repeat(cell, 1)
    want = np.zeros((int(mask.max()) + 1, 3))
    np.add.at(want, mask.ravel(), field.reshape(-1, 3))
    np.testing.assert_allclose(got, want[labels], rtol=1e-12)

    table = pd.read_csv(driver.cell_table)
    with open(os.path.join(ROOT, "portbench", "configs", "quant_1024x40.json")) as f:
        panel = json.load(f)["channels"]
    whole = table[panel].to_numpy() * table["cell_size"].to_numpy()[:, None]
    np.testing.assert_allclose(whole, np.round(whole), atol=1e-9)
    assert (whole > 0).mean() > 0.9
    nuc = table["cell_size_nuclear"].to_numpy()
    counts = table[[f"{c}_nuclear" for c in panel]].to_numpy() * nuc[:, None]
    np.testing.assert_allclose(counts, np.round(counts), atol=1e-9)
    assert np.all(counts[nuc == 0] == 0) and (counts[nuc > 0] > 0).mean() > 0.8
