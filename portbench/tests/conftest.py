"""Shared helpers of the benchmark's own tests: the harness at a tiny size
on the CPU (the cell's configuration with 64^2 FOVs, two FOVs a job, a pool
of four FOVs in batches of two)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(load_cell):
    def load(name):
        bench, cell, cfg, traffic = load_cell(name)
        cfg = dict(cfg, fov_size=64)
        if traffic["driver"] == "seg_calls":
            cfg["maxima_per_fov"] = 12
            traffic = dict(traffic, pool_fovs=4, cells_per_fov=12, batch_size=2)
        else:
            traffic = dict(traffic, cells_per_fov=8, cell_radius=8)
            traffic["fovs_per_job"] = min(traffic["fovs_per_job"], 2)
        return bench, cell, cfg, traffic
    return load


@pytest.fixture
def tiny_run(monkeypatch, capsys):
    """run(cell, trace=0, seconds=2) -> (result dict, stdout lines, stderr)."""
    from portbench import run as harness

    monkeypatch.setattr(harness, "load_cell", tiny_cell(harness.load_cell))

    def go(cell, trace=0, seconds=2.0, seed=3_000_000_017):
        result = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                               str(seconds), "--trace", str(trace)], device="cpu")
        out, err = capsys.readouterr()
        return result, out.strip().splitlines(), err
    return go
