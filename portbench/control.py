"""Readings behind each limit of ``correct``: the program's numbers and the
control's, cell by cell and seed by seed, outside any timed window.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--program] [--control]

``--program`` runs the timed path once per seed (one job, or one call on each
of two batches of the pool) and prints the numbers the run's check compares;
``--control`` puts the plain reference in the program's place one precision
lower than the configuration states and prints the same numbers: TF32 for
the pixel stage's float32 with TF32 off, float8 e4m3 for the network's
bfloat16. A limit lies between the program's largest reading and the
control's smallest. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402


def pixie_readings(driver, program: bool, control: bool) -> dict:
    from portbench.reference import pixie as reference

    driver.make_inputs()
    out = {}
    if program:
        base = os.path.join(driver.workdir, "job")
        driver.job(base, {})
        got = reference.read_job(base, driver.fovs, driver.channels, driver.cfg["fov_size"])
        shutil.rmtree(base)
        out["program"] = reference.judge_parts(got, driver.raws, driver.masks,
                                               driver.channels, driver.cfg, driver.device)
        # the same job judged with every step started from the job's own
        # values: where the two differ, a last-bit difference upstream moved
        # a later step
        out["program_forced"] = reference.judge_parts(
            got, driver.raws, driver.masks, driver.channels, driver.cfg, driver.device,
            forced=("prep", "train"))
    if control:
        ctl = reference.PixelReference(driver.raws, driver.channels, driver.cfg,
                                       driver.device, tf32=True).run(driver.masks)
        out["control"] = reference.judge_parts(ctl, driver.raws, driver.masks,
                                               driver.channels, driver.cfg, driver.device)
    return out


def seg_readings(driver, program: bool, control: bool) -> dict:
    from portbench.drivers.seg_calls import compare
    from portbench.reference import panoptic as reference

    driver.setup()
    cfg = driver.cfg
    out = {}
    for i in (0, 1):
        batch = driver._batch(i)
        want = reference.heads(cfg, driver.state, batch, driver.device)
        got = {}
        if program:
            heads, masks = driver.captured_call(i)
            got["program"] = compare(cfg, heads, masks, want)
        if control:
            low = reference.heads(cfg, driver.state, batch, driver.device, quant="fp8")
            # the postprocess, too, one precision lower: on the heads in float8
            masks = reference.postprocess({k: reference.fp8(v) for k, v in low.items()},
                                          cfg["compartments"], cfg["maxima_threshold"],
                                          cfg["interior_threshold"], cfg["min_cell_size"])
            got["control"] = compare(cfg, low, masks, want)
        for side, numbers in got.items():
            prev = out.get(side, {})
            out[side] = {k: max(v, prev.get(k, 0.0)) for k, v in numbers.items()}
    return out


READINGS = {"pixie_jobs": pixie_readings, "seg_calls": seg_readings}


def main(argv=None, device: str = "cuda"):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import importlib

    _, cell, cfg, traffic = run.load_cell(args.workload)
    drv_mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        t0 = time.time()
        try:
            driver = drv_mod.Driver(cfg, traffic, seed, device, workdir)
            readings = READINGS[traffic["driver"]](driver, args.program, args.control)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        line = {"workload": args.workload, "seed": seed, **readings,
                "seconds": time.time() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
