"""The port's template-1 cell table against the benchmark's plain reference
(``portbench/reference/cell_table.py``), on the CPU.

A seeded TIFF tree of 2 FOVs of 192^2 x 6 channels, ~40 cells each, with
whole-cell and nuclear masks, goes through
``generate_cell_table(..., nuclear_counts=True, device="cpu")`` and the
template's two ``to_csv`` calls; the judge reads the CSVs and holds them to
the reference within the configuration's limits. Each FOV carries a cell
without a nucleus, a cell that two nuclei overlap equally (the lowest id
wins), a nucleus split evenly between two cells (both match it), a C-shaped
cell whose concavity passes the thresholds and a cell whose box is over
128 px (the host hull path). The judge fails on each fault planted in the
tables: a channel count off by one, two nuclei swapped, a concavity count
changed, a row dropped.
"""

import json
import os

import numpy as np
import pytest
import torch

from ark_tpu_torch.io.image_utils import save_image
from ark_tpu_torch.ops import convex
from ark_tpu_torch.segmentation import marker_quantification as TQ
from portbench.reference import cell_table as reference

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "portbench", "configs", "quant_1024x40.json")) as _f:
    LIMITS = json.load(_f)["limits"]
CHANNELS = ["CD3", "CD4", "CD8", "ECAD", "Ki67", "SMA"]
FOVS = ["fov0", "fov1"]
SIZE = 192
# the special cells' and nuclei's ids
C_SHAPE, LONG, NO_NUCLEUS, TIE, SPLIT_A, SPLIT_B = 101, 102, 103, 104, 105, 106
TIE_NUCLEI, SPLIT_NUCLEUS = (203, 205), 210


def _masks(rng):
    """(whole-cell, nuclear) int32 masks: Voronoi cells of seeded centres
    within radius 14, a disc nucleus near each centre (ids permuted), and
    the special cells painted over a cleared band."""
    yy, xx = np.mgrid[:SIZE, :SIZE]
    centres = rng.uniform(0, SIZE, (40, 2))
    d2 = (yy[None] - centres[:, 0, None, None]) ** 2 + (xx[None] - centres[:, 1, None, None]) ** 2
    cells = np.where(d2.min(0) <= 14 ** 2, d2.argmin(0) + 1, 0).astype(np.int32)
    ids = rng.permutation(40) + 1
    nucs = np.zeros_like(cells)
    for (cy, cx), nid in zip(centres + rng.uniform(-2, 2, (40, 2)), ids):
        nucs[((yy - cy) ** 2 + (xx - cx) ** 2 <= rng.uniform(3, 4.5) ** 2) & (nucs == 0)] = nid
    # a band for the special cells
    cells[:, 140:], nucs[:, 140:] = 0, 0
    cells[150:, :], nucs[150:, :] = 0, 0
    ring = ((yy - 40) ** 2 + (xx - 165) ** 2 <= 14 ** 2) & ((yy - 40) ** 2 + (xx - 165) ** 2 >= 49)
    cells[ring & ~((xx > 165) & (np.abs(yy - 40) < 5))] = C_SHAPE
    nucs[38:43, 150:154] = 221
    cells[185:188, 10:160] = LONG                      # a 150-px bar and its upright
    cells[160:188, 10:13] = LONG
    nucs[185:188, 60:70] = 222
    cells[160:170, 100:110] = NO_NUCLEUS
    cells[100:112, 145:165] = TIE
    nucs[102:106, 147:153] = TIE_NUCLEI[1]             # 24 px each: a tie
    nucs[106:110, 156:162] = TIE_NUCLEI[0]
    cells[70:90, 142:152] = SPLIT_A
    cells[70:90, 152:162] = SPLIT_B
    nucs[75:85, 147:157] = SPLIT_NUCLEUS               # 50 px in each
    return cells, nucs


def _cohort(seed=20240611):
    rng = np.random.default_rng(seed)
    raws, cells, nucs = [], [], []
    for _ in FOVS:
        lam = rng.gamma(0.6, 4.0, (SIZE // 16, SIZE // 16, len(CHANNELS)))
        lam = lam.repeat(16, 0).repeat(16, 1)
        raws.append(rng.poisson(lam).astype(np.float32))
        c, n = _masks(rng)
        cells.append(c)
        nucs.append(n)
    return raws, cells, nucs


def write_tree(base, raws, cells, nucs):
    """The template's tree under `base`; returns (tiff_dir, seg_dir)."""
    tiff_dir = os.path.join(base, "image_data")
    seg_dir = os.path.join(base, "segmentation", "deepcell_output")
    for fov, raw, c, n in zip(FOVS, raws, cells, nucs):
        for ci, chan in enumerate(CHANNELS):
            save_image(os.path.join(tiff_dir, fov, f"{chan}.tiff"), raw[..., ci])
        save_image(os.path.join(seg_dir, f"{fov}_whole_cell.tiff"), c)
        save_image(os.path.join(seg_dir, f"{fov}_nuclear.tiff"), n)
    return tiff_dir, seg_dir


def run_job(base, tiff_dir, seg_dir):
    """Template 1's cell 9 on the tree; returns the tables' directory."""
    out = os.path.join(base, "segmentation", "cell_table")
    os.makedirs(out)
    norm, arcsinh = TQ.generate_cell_table(
        segmentation_dir=seg_dir, tiff_dir=tiff_dir, img_sub_folder=None, fovs=FOVS,
        nuclear_counts=True, checkpoint_dir=os.path.join(out, "parts"), device="cpu")
    norm.to_csv(os.path.join(out, reference.NORM_CSV), index=False)
    arcsinh.to_csv(os.path.join(out, reference.ARCSINH_CSV), index=False)
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("cell_table"))
    raws, cells, nucs = _cohort()
    tiff_dir, seg_dir = write_tree(base, raws, cells, nucs)
    host0 = convex.COUNTS["host_cells"]
    out = run_job(base, tiff_dir, seg_dir)
    want = reference.tables(FOVS, raws, cells, nucs, CHANNELS)
    return {"got": reference.read_job(out), "want": want,
            "host_cells": convex.COUNTS["host_cells"] - host0}


def _judged(got, want):
    return reference.judge(got, want, CHANNELS)


def test_the_port_is_within_every_limit(job):
    checks = _judged(job["got"], job["want"])
    assert set(checks) == set(LIMITS)
    assert all(checks[k] <= LIMITS[k] for k in LIMITS), checks


def _row(table, fov, label):
    hit = table[(table["fov"] == fov) & (table["label"] == label)]
    assert len(hit) == 1
    return hit.iloc[0]


@pytest.mark.parametrize("fov", FOVS)
def test_the_special_cells(job, fov):
    got, want = job["got"][0], job["want"][0]
    for t in (got, want):
        assert _row(t, fov, NO_NUCLEUS)["label_nuclear"] == 0
        assert _row(t, fov, NO_NUCLEUS)["nc_ratio"] == 0
        assert _row(t, fov, TIE)["label_nuclear"] == min(TIE_NUCLEI)
        assert _row(t, fov, SPLIT_A)["label_nuclear"] == SPLIT_NUCLEUS
        assert _row(t, fov, SPLIT_B)["label_nuclear"] == SPLIT_NUCLEUS
        assert _row(t, fov, SPLIT_B)["convex_area_nuclear"] == 100
        assert _row(t, fov, C_SHAPE)["num_concavities"] >= 1
        assert _row(t, fov, LONG)["convex_area"] > 150 * 3


def test_the_long_cell_takes_the_host_hull(job):
    assert job["host_cells"] == len(FOVS)


def _planted(job, fault):
    norm, arcsinh = (t.copy() for t in job["got"])
    row = int(np.flatnonzero((norm["label_nuclear"] > 0).to_numpy())[3])
    if fault == "count_off_by_one":
        norm.loc[row, "CD4"] += 1.0 / norm.loc[row, "cell_size"]
        return (norm, arcsinh), "channel_gap"
    if fault == "nuclei_swapped":
        other = int(np.flatnonzero((norm["label_nuclear"] > 0).to_numpy())[7])
        for t in (norm, arcsinh):
            t.loc[[row, other], "label_nuclear"] = t.loc[[other, row], "label_nuclear"].to_numpy()
        return (norm, arcsinh), "nucleus_mismatch"
    if fault == "concavity_changed":
        norm.loc[row, "num_concavities"] += 1
        return (norm, arcsinh), "concavity_mismatch"
    if fault == "row_dropped":
        return tuple(t.drop(index=row).reset_index(drop=True) for t in (norm, arcsinh)), \
            "rows_mismatch"
    raise ValueError(fault)


@pytest.mark.parametrize("fault", ["count_off_by_one", "nuclei_swapped", "concavity_changed",
                                   "row_dropped"])
def test_the_judge_fails_a_planted_fault(job, fault):
    got, check = _planted(job, fault)
    assert _judged(got, job["want"])[check] > LIMITS[check]


def test_the_control_fails_a_limit(job):
    raws, cells, nucs = _cohort()
    low = reference.tables(FOVS, raws, cells, nucs, CHANNELS, dtype="bfloat16")
    checks = _judged(low, job["want"])
    assert any(checks[k] > LIMITS[k] for k in LIMITS), checks
