"""The harness end to end at a tiny size on the CPU: the check passes on the
program as it is, fails on each fault planted in the timed path, and the
last line has the contract's form."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.tests.conftest import ROOT

CELLS = ["pixie_files_4fov", "mesmer_bf16_4x1024"]


def _bench():
    with open(f"{ROOT}/BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_correct_and_last_line(tiny_run, cell, trace):
    result, out, err = tiny_run(cell, trace=trace)
    assert json.loads(out[-1]) == result
    assert result["correct"], err[-3000:]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check ")
    bench = _bench()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in bench[kind] if cell in m.get("workloads", [cell])}
    got = {k: v["unit"] for k, v in result["metrics"].items()}
    # on the CPU no kernel runs, so the device readers find nothing to read
    device_only = {"bmu_roofline"}
    assert got == {k: u for k, u in want.items() if k not in device_only}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert len(result["breakdown"]["idle_gaps"]) <= 10


def _fault_run(tiny_run, cell):
    result, _, err = tiny_run(cell)
    assert not result["correct"], err[-2000:]
    return result


def test_fault_pixie_answer_altered(tiny_run, monkeypatch):
    from ark_tpu_torch.ops import som

    real = som.som_map_async

    def altered(weights, data, *, device):
        idx = real(weights, data, device=device).clone()
        idx[0] = (idx[0] + 1) % weights.shape[0]
        return idx
    monkeypatch.setattr(som, "som_map_async", altered)
    res = _fault_run(tiny_run, "pixie_files_4fov")
    assert res["checks"]["som_unexcused"]["value"] > 0


def test_fault_pixie_cell_label_altered(tiny_run, monkeypatch):
    from ark_tpu_torch.phenotyping import pixie_fused

    real = pixie_fused.read_image

    def altered(path):
        img = real(path)
        return img + 1 if path.endswith("_whole_cell.tiff") else img
    monkeypatch.setattr(pixie_fused, "read_image", altered)
    res = _fault_run(tiny_run, "pixie_files_4fov")
    assert res["checks"]["label_mismatch"]["value"] > 0


def test_fault_pixie_half_the_cohort_left_out(tiny_run, monkeypatch):
    from ark_tpu_torch.phenotyping import pixie_fused

    real = pixie_fused._channel_percentiles_device
    calls = []

    def half(img, q):
        vals, pos = real(img, q)
        calls.append(1)
        return vals, pos & (len(calls) % 2 == 1)   # every other FOV drops out of the mean
    monkeypatch.setattr(pixie_fused, "_channel_percentiles_device", half)
    res = _fault_run(tiny_run, "pixie_files_4fov")
    assert res["checks"]["stage_gap"]["value"] > res["checks"]["stage_gap"]["limit"]


def test_fault_pixie_training_step_unchanged(tiny_run, monkeypatch):
    from ark_tpu_torch.ops import som

    monkeypatch.setattr(som, "_train_step", lambda w, *a, **k: w)
    res = _fault_run(tiny_run, "pixie_files_4fov")
    assert res["checks"]["stage_gap"]["value"] > res["checks"]["stage_gap"]["limit"]


def test_fault_seg_head_altered(tiny_run, monkeypatch):
    from ark_tpu_torch.models import unet

    real = unet.PanopticNet.forward

    def altered(self, x):
        out = real(self, x)
        out["nuclear_pixelwise"] = out["nuclear_pixelwise"].clone()
        out["nuclear_pixelwise"][0, 3, 5, 0] += 0.25
        return out
    monkeypatch.setattr(unet.PanopticNet, "forward", altered)
    res = _fault_run(tiny_run, "mesmer_bf16_4x1024")
    assert res["checks"]["head_max_gap"]["value"] > res["checks"]["head_max_gap"]["limit"]


def test_fault_seg_half_the_batch_left_out(tiny_run, monkeypatch):
    from ark_tpu_torch.models import unet

    real = unet.PanopticNet.forward

    def half(self, x):
        h = x.shape[0] // 2
        out = real(self, x[:h])
        return {k: torch.cat([v, v]) for k, v in out.items()}
    monkeypatch.setattr(unet.PanopticNet, "forward", half)
    _fault_run(tiny_run, "mesmer_bf16_4x1024")


def test_fault_seg_mask_altered(tiny_run, monkeypatch):
    from ark_tpu_torch.segmentation import mesmer

    real = mesmer.segment_fovs

    def altered(*a, **k):
        out = real(*a, **k)
        out["whole_cell"][0, 10:14, 10:14] = 7
        return out
    monkeypatch.setattr(mesmer, "segment_fovs", altered)
    res = _fault_run(tiny_run, "mesmer_bf16_4x1024")
    assert res["checks"]["mask_mismatch"]["value"] > 0


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run exits
    with an error and prints no result."""
    import shutil
    import subprocess
    import sys

    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "pixie_files_4fov", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
