"""On the card: the control (the plain reference one precision lower than the
configuration states) fails the cell's check at a reduced size. Skips
without a card, decided inside the test."""

from __future__ import annotations

import json

import pytest

from portbench.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pixie_files_4fov", "mesmer_bf16_4x1024"])
def test_control_fails_the_check(cell, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's lower precision exists only there")
    from portbench import control, run
    from portbench.reference import pixie

    def reduced(name):
        bench, c, cfg, traffic = load(name)
        cfg = dict(cfg, fov_size=256)
        if traffic["driver"] == "seg_calls":
            cfg["maxima_per_fov"] = 60
            traffic = dict(traffic, pool_fovs=4, cells_per_fov=80, batch_size=2)
        else:
            traffic = dict(traffic, cells_per_fov=60)
        return bench, c, cfg, traffic
    load = run.load_cell
    monkeypatch.setattr(run, "load_cell", reduced)
    lines = control.main(["--workload", cell, "--seeds", "31,32,33", "--control"])
    with open(f"{ROOT}/BENCHMARK.json") as f:
        conf = {w["name"]: w["config"] for w in json.load(f)["workloads"]}[cell]
    with open(f"{ROOT}/portbench/configs/{conf}.json") as f:
        limits = json.load(f)["limits"]
    for line in lines:
        got = line["control"]
        if "prep_gap" in got:
            got = pixie.compared(got)
        assert any(v > limits[k] for k, v in got.items() if k in limits), line
