"""The cell-table cell at a tiny size on the CPU: the harness's check passes
on the program as it is and fails on faults planted in the timed path; the
seeded nuclei are as the traffic file says; the segment sum's bound and the
roofline reader."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench import run as harness
from portbench.counts import segsum_bound
from portbench.drivers import cell_table_jobs
from portbench.tests.conftest import ROOT

CELL = "cell_table_1024x40"


def _bench():
    with open(f"{ROOT}/BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
def test_correct_and_last_line(tiny_run, trace):
    result, out, err = tiny_run(CELL, trace=trace)
    assert json.loads(out[-1]) == result
    assert result["correct"], err[-3000:]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"rows_mismatch", "nucleus_mismatch", "concavity_mismatch",
                                     "channel_gap", "morph_gap", "arcsinh_gap"}
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in _bench()[kind] if CELL in m.get("workloads", [CELL])}
    got = {k: v["unit"] for k, v in result["metrics"].items()}
    # on the CPU no kernel runs, so the device readers find nothing to read
    assert got == {k: u for k, u in want.items() if k != "segsum_roofline"}
    if trace:
        assert set(got) == {"table.load_s_per_fov", "table.reduce_ms_per_fov",
                            "table.convex_s_per_fov", "table.assemble_s_per_fov"}
    # set-up's phases and the jobs' split between the table and its CSVs
    (line,) = [x for x in err.splitlines() if x.startswith("records ")]
    records = json.loads(line[len("records "):])
    phases = [records[f"setup_{p}_s"] for p in ("context", "draw", "write", "warm")]
    assert all(v >= 0 for v in phases)
    if not trace:
        assert sum(phases) <= result["metrics"]["setup_s"]["value"]
    assert 0 < records["setup_warm_csv_s"] < records["setup_warm_s"]
    assert 0 < records["csv_s_min"] <= records["csv_s_max"]
    assert 0 < records["table_s_min"] <= records["table_s_max"]
    assert 0 < records["csv_share"] < 1


def test_fault_nucleus_matched_elsewhere(tiny_run, monkeypatch):
    from ark_tpu_torch.segmentation import segmentation_utils

    real = segmentation_utils.match_nuclei_to_cells

    def moved(cells, nucs):
        got = real(cells, nucs)
        first = min(got)
        got[first] = max(got.values()) if got[first] != max(got.values()) else min(got.values())
        return got
    monkeypatch.setattr(segmentation_utils, "match_nuclei_to_cells", moved)
    result, _, err = tiny_run(CELL)
    assert not result["correct"], err[-2000:]
    assert result["checks"]["nucleus_mismatch"]["value"] > 0


def test_fault_a_count_altered(tiny_run, monkeypatch):
    from ark_tpu_torch.ops import segment_reduce

    real = segment_reduce.moment_and_channel_features

    def altered(*args, **kwargs):
        feats, chan = real(*args, **kwargs)
        chan = chan.clone()
        chan[1:, 0] += 1.0
        return feats, chan
    monkeypatch.setattr(segment_reduce, "moment_and_channel_features", altered)
    result, _, err = tiny_run(CELL)
    assert not result["correct"], err[-2000:]
    assert result["checks"]["channel_gap"]["value"] > result["checks"]["channel_gap"]["limit"]


def test_nuclei_as_the_traffic_says():
    traffic = {"nucleus_radius": "4-6", "nucleus_jitter": 3, "share_without_nucleus": 0.05}
    seed, size, n = 3_000_000_019, 128, 40
    centres = cell_table_jobs.cell_centres(seed, 2, size, n, "cpu")
    masks = inputs.whole_cell_masks(seed, 2, size, n, 12, "cpu")
    nuclei = cell_table_jobs.nuclear_masks(seed, centres, size, traffic, "cpu")
    for c, m, nuc in zip(centres, masks, nuclei):
        at = np.clip(np.round(c.numpy()).astype(int), 0, size - 1)
        # the replayed centres are the masks' own: most centres' pixels carry them
        assert np.mean(m[at[:, 0], at[:, 1]] == np.arange(1, n + 1)) > 0.9
        ids = np.unique(nuc[nuc > 0])
        assert len(ids) == n - 2 and set(ids) <= set(range(1, n - 1))
    # the numbering is a permutation, not the cells' order
    ids_at = [int(nuclei[0][tuple(a)]) for a in np.round(centres[0].numpy()).astype(int)]
    assert ids_at != sorted(ids_at)


def test_segsum_bound_and_reader():
    n, k, s = 1 << 20, 44, 3001
    plan = segsum_bound.launch_bound_s("plan", n, 0, s)
    assert plan == pytest.approx((4 * n + 16 * s) / 3.35e12)
    walk = segsum_bound.launch_bound_s("sum", n, k, s, 900_000, 450)
    assert walk == pytest.approx((4 * (900_000 * k + n + s * k) + 16 * s) / 3.35e12)
    # a chain of adds binds when the segment is long enough
    assert segsum_bound.launch_bound_s("sum", n, 1, 2, 10, 10**7) \
        == pytest.approx(10**7 * 4.219 / 1.98e9)
    launches = [("plan", n, 0, s, 0, 0), ("sum", n, k, s, 900_000, 450)]
    rec = {"segsum_launches": launches,
           "device_s_by_name": {"void segment_walk_kernel<44>(float const*)": 2 * walk,
                                "box_kernel(int const*)": 2 * plan, "other": 1.0}}
    assert harness.read_metric("segsum_roofline", rec) == pytest.approx(50.0)
    assert harness.read_metric("segsum_roofline", {"device_s_by_name": {}}) is None


def test_launches_recorded_only_for_cuda_tensors():
    from ark_tpu_torch.ops import segment_reduce

    launches = []
    restore = cell_table_jobs._record_segsum(launches)
    try:
        labels = torch.tensor([[0, 1], [2, 2]], dtype=torch.int32)
        segment_reduce.segment_sum(torch.ones(4, 3), labels, 3, background=False)
        segment_reduce.segment_plan(labels, 3)
    finally:
        restore()
    assert launches == [] and segment_reduce.segment_sum.__name__ == "segment_sum"
