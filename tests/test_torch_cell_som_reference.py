"""The port's template-3 cell clustering against the benchmark's plain
reference (``portbench/reference/cell_som.py``), on the CPU.

A seeded cohort of 3 FOVs of 128^2, ~60 cells each, drawn and written as
the benchmark's cell-SOM cell writes it (template 2's pixel feathers with 8
pixel meta clusters, their channel averages, a 118-column cell table), goes
through ``run_cell_clustering(..., device="cpu")`` with a 4 x 4 SOM and
max_k 5; the judge reads the job's files and holds them to the reference
within the configuration's limits. The judge fails on each fault planted in
the job's tables: a count off by one, a dropped row, two cells' meta labels
swapped, a SOM weight moved by 1e-2.
"""

import json
import os

import numpy as np
import pytest
import torch

from ark_tpu_torch.phenotyping import pixie_cells
from portbench.drivers import cell_cluster_jobs
from portbench.reference import cell_som as reference

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "portbench", "configs", "pixie_cell_34x3000.json")) as _f:
    CFG = json.load(_f)
with open(os.path.join(REPO, "portbench", "traffic", "cohort_34fov.json")) as _f:
    TRAFFIC = json.load(_f)
LIMITS = CFG["limits"]
SMALL_CFG = dict(CFG, fov_size=128, xdim=4, ydim=4, max_k=5)
SMALL_TRAFFIC = dict(TRAFFIC, fovs_per_job=3, cells_per_fov=60, cell_radius=10,
                     pixel_meta_clusters=8, pixel_som_clusters=16, phenotypes=4)
SEED = 20241019


def small_cohort(workdir, seed=SEED):
    """The benchmark driver at the small size, its inputs written."""
    driver = cell_cluster_jobs.Driver(SMALL_CFG, SMALL_TRAFFIC, seed, "cpu", str(workdir))
    driver.make_inputs()
    return driver


def _linked(job, base):
    """A fresh job directory linking the cohort's pixel feathers and
    averages."""
    os.makedirs(base)
    for name in ("pixel_mat_data", reference.PIXEL_META_AVG):
        os.symlink(os.path.join(job["driver"].workdir, name), os.path.join(base, name))
    return base


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    driver = small_cohort(tmp_path_factory.mktemp("cell_som"))
    base = os.path.join(driver.workdir, "job")
    driver.job(base)
    return {"driver": driver, "base": base, "got": reference.read_job(base),
            "ref": driver.reference()}


def test_the_port_is_within_every_limit(job):
    checks = reference.judge(job["got"], job["ref"])
    assert set(checks) == set(LIMITS)
    assert all(checks[k] <= LIMITS[k] for k in LIMITS), checks
    # the cohort is what the configuration says: every cell of the table
    # counted, 8 count columns, 16 SOM nodes trained over 3 FOVs
    got = job["got"]
    assert len(got.cells) == len(got.counts) > 150
    assert len(job["ref"].count_cols(got.cells)) == 8
    assert got.weights.shape == (16, 8)
    assert sorted(got.cells["fov"].astype(str).unique()) == job["driver"].fovs
    assert got.cells["cell_meta_cluster"].nunique() == 5


def test_the_runner_returns_the_saved_cells(job, tmp_path):
    base = _linked(job, str(tmp_path / "again"))
    returned = pixie_cells.run_cell_clustering(
        base, job["driver"].channels, job["driver"].cell_table, job["driver"].fovs,
        xdim=4, ydim=4, max_k=5, device="cpu")
    saved = reference.read_job(base).cells
    assert list(returned.columns) == list(saved.columns)
    assert np.array_equal(returned["cell_meta_cluster"].to_numpy(),
                          saved["cell_meta_cluster"].to_numpy())
    assert np.array_equal(returned["cell_som_cluster"].to_numpy(),
                          job["got"].cells["cell_som_cluster"].to_numpy())


def test_the_runner_keeps_the_precision_and_tf32_is_refused(job, tmp_path):
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full f32"):
            pixie_cells.run_cell_clustering(_linked(job, str(tmp_path / "tf32")),
                                            job["driver"].channels,
                                            job["driver"].cell_table,
                                            job["driver"].fovs, xdim=4, ydim=4, max_k=5,
                                            device="cpu")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prec)


def _planted(got, fault):
    out = reference.Outputs(**{k: v.copy() for k, v in vars(got).items()})
    cols = [c for c in out.counts.columns if c.startswith(CFG["pixel_cluster_col"] + "_")]
    if fault == "count_off_by_one":
        out.counts.loc[7, cols[2]] += 1
        return out, "count_mismatch"
    if fault == "row_dropped":
        out.cells = out.cells.drop(index=11).reset_index(drop=True)
        return out, "rows_mismatch"
    if fault == "meta_swapped":
        meta = out.cells["cell_meta_cluster"].to_numpy()
        a = 0
        b = int(np.flatnonzero(meta != meta[a])[0])
        out.cells.loc[[a, b], "cell_meta_cluster"] = meta[[b, a]]
        return out, "meta_mismatch"
    if fault == "som_weight_moved":
        out.weights.iloc[3, 1] += 1e-2
        return out, "som_gap"
    raise ValueError(fault)


@pytest.mark.parametrize("fault", ["count_off_by_one", "row_dropped", "meta_swapped",
                                   "som_weight_moved"])
def test_the_judge_fails_a_planted_fault(job, fault):
    got, check = _planted(job["got"], fault)
    assert reference.judge(got, job["ref"])[check] > LIMITS[check]


def test_float32_tables_fail_their_limits(job):
    """The program's job with its normalized cells and count averages in
    float32 (the configuration keeps them in float64) fails `norm_gap` and
    `avg_gap` and nothing else (the CPU's products take no TF32, so the
    weighted product is the program's here)."""
    from portbench import control_cell_som

    low = control_cell_som.lowered_tables(job["got"], job["driver"].reference(tf32=True))
    checks = reference.judge(low, job["ref"])
    assert checks["norm_gap"] > LIMITS["norm_gap"] and checks["avg_gap"] > LIMITS["avg_gap"]
    assert all(checks[k] <= LIMITS[k] for k in LIMITS if k not in ("norm_gap", "avg_gap")), \
        checks


def test_a_cells_counts_are_its_pixels(job):
    """The job's counts are the pixels of each (cell, cluster) pair: one
    cell recounted from its FOV's feather."""
    driver, got = job["driver"], job["got"]
    row = got.counts.iloc[5]
    px = reference._feather(os.path.join(driver.pixel_dir, f"{row['fov']}.feather"),
                            columns=["label", CFG["pixel_cluster_col"]])
    mine = px[px["label"] == row["label"]][CFG["pixel_cluster_col"]].value_counts()
    for cluster, n in mine.items():
        assert row[f"{CFG['pixel_cluster_col']}_{cluster}"] == n
    assert sum(mine) == sum(row[c] for c in job["ref"].count_cols(got.counts))
