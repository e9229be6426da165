"""Readings behind each limit of the cell-table cell's ``correct``: the
program's numbers and the control's, seed by seed, outside any timed window.

    python3 portbench/control_cell_table.py --workload cell_table_1024x40 \
        --seeds 1,2,3 [--program] [--control]

``--program`` runs the timed path once per seed (one job of the traffic's
FOVs: ``generate_cell_table`` and the two CSVs) and prints the numbers the
run's check compares; ``--control`` puts the plain reference one precision
below the configuration's float32 in the program's place (its sums and
moments in bfloat16, ``portbench/reference/cell_table.py``) and prints the
same numbers. A limit lies between the program's largest reading and the
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


def readings(driver, program: bool, control: bool) -> dict:
    from portbench.reference import cell_table as reference

    driver.make_inputs()
    want = reference.tables(driver.fovs, driver.raws, driver.masks, driver.nuclei,
                            driver.channels)
    out = {}
    if program:
        base = os.path.join(driver.workdir, "job")
        t0 = time.perf_counter()
        driver.job(base)
        out["job_s"] = time.perf_counter() - t0
        got = reference.read_job(driver.table_dir(base))
        out["program"] = reference.judge(got, want, driver.channels)
        shutil.rmtree(base)
    if control:
        low = reference.tables(driver.fovs, driver.raws, driver.masks, driver.nuclei,
                               driver.channels, dtype="bfloat16")
        out["control"] = reference.judge(low, want, driver.channels)
    return out


def main(argv=None, device: str = "cuda"):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="cell_table_1024x40")
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    from portbench.drivers import cell_table_jobs

    _, _, cfg, traffic = run.load_cell(args.workload)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        t0 = time.time()
        try:
            driver = cell_table_jobs.Driver(cfg, traffic, seed, device, workdir)
            line = {"workload": args.workload, "seed": seed,
                    **readings(driver, args.program, args.control)}
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
