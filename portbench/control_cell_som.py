"""Readings behind each limit of the cell-SOM cell's ``correct``: the
program's numbers and the control's, seed by seed, outside any timed window.

    python3 portbench/control_cell_som.py --workload cell_som_100k \
        --seeds 1,2,3 [--program] [--control]

Each seed draws and writes the cohort as the cell's set-up does.
``--program`` runs the timed path once (one ``run_cell_clustering`` job) and
prints the numbers the run's check compares. ``--control`` prints the same
numbers for two stand-ins one precision below the configuration:
``control``, the plain reference in the program's place with its float32
products in TF32 (its SOM training, nearest nodes and weighted product, as
``portbench/control.py`` does for the pixel cell); and ``tables``, the
program's own job with only its value tables lowered (the normalized cells
and the count averages in float32 where the configuration keeps float64,
the weighted product in TF32), its counts, SOM and labels as they are, so
that ``norm_gap``, ``avg_gap`` and ``weighted_gap`` each get a reading of
their precision alone. A limit lies between the program's largest reading
and the stand-ins' smallest. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import pandas as pd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402


def _means32(values, labels):
    """(sorted ids, per-id float32 means of the rows of `values`, counts)."""
    ids, inv = np.unique(labels, return_inverse=True)
    sums = np.zeros((len(ids), values.shape[1]), np.float32)
    np.add.at(sums, inv, values.astype(np.float32))
    counts = np.bincount(inv, minlength=len(ids)).astype(np.float32)
    return ids, sums / counts[:, None], counts


def lowered_tables(got, ref_tf32):
    """The program's job `got` (``cell_som.Outputs``) with its value tables one
    precision below the configuration's and nothing else changed: the
    normalized cells and both count-average tables computed in float32 over
    the job's own counts and labels, the weighted product with TF32 on (its
    channel means over the job's labels in float64, as configured)."""
    from portbench.reference import cell_som as reference

    counts, cells = got.counts, got.cells
    cols = ref_tf32.count_cols(counts)
    sized = counts[cols].to_numpy(np.float32) / \
        counts["cell_size"].to_numpy(np.float32)[:, None]
    quant = pd.DataFrame(sized, columns=cols).replace(0, np.nan).quantile(
        q=0.999, axis=0).to_numpy(np.float32)
    x = sized / quant
    cells = cells.copy()
    cells[cols] = x.astype(np.float64)
    som = cells["cell_som_cluster"].to_numpy(np.int64)
    meta = cells["cell_meta_cluster"].to_numpy(np.int64)
    ids, means, n = _means32(x, som)
    som_avg = got.som_avg.copy()
    at = som_avg["cell_som_cluster"].map({int(k): i for i, k in enumerate(ids)}).to_numpy()
    som_avg[cols + ["count"]] = np.column_stack([means, n])[at].astype(np.float64)
    ids, means, n = _means32(x, meta)
    meta_avg = got.meta_avg.copy()
    at = meta_avg["cell_meta_cluster"].map({int(k): i for i, k in enumerate(ids)}).to_numpy()
    meta_avg[cols + ["count"]] = np.column_stack([means, n])[at].astype(np.float64)

    wt = ref_tf32.weighted(counts)
    weighted = got.weighted.copy()
    weighted[ref_tf32.channels] = wt
    tables = []
    for table, key, labels in ((got.wc_som, "cell_som_cluster", som),
                               (got.wc_meta, "cell_meta_cluster", meta)):
        ids, means, _ = reference._means(wt, labels)
        table = table.copy()
        at = table[key].map({int(k): i for i, k in enumerate(ids)}).to_numpy()
        table[ref_tf32.channels] = means[at]
        tables.append(table)
    return reference.Outputs(counts=counts, cells=cells, weights=got.weights,
                             som_avg=som_avg, meta_avg=meta_avg, weighted=weighted,
                             wc_som=tables[0], wc_meta=tables[1])


def readings(driver, program: bool, control: bool) -> dict:
    from portbench.reference import cell_som as reference

    t0 = time.perf_counter()
    driver.make_inputs()
    out = {"inputs_s": time.perf_counter() - t0}
    if program or control:
        base = os.path.join(driver.workdir, "job")
        t0 = time.perf_counter()
        driver.job(base)
        out["job_s"] = time.perf_counter() - t0
        got = reference.read_job(base)
        shutil.rmtree(base)
    if program:
        t0 = time.perf_counter()
        out["program"] = reference.judge(got, driver.reference())
        out["judge_s"] = time.perf_counter() - t0
    if control:
        ref_tf32 = driver.reference(tf32=True)
        out["control"] = reference.judge(ref_tf32.run(), driver.reference())
        out["tables"] = reference.judge(lowered_tables(got, ref_tf32), driver.reference())
    return out


def main(argv=None, device: str = "cuda"):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="cell_som_100k")
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    from portbench.drivers import cell_cluster_jobs

    _, _, cfg, traffic = run.load_cell(args.workload)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        t0 = time.time()
        try:
            driver = cell_cluster_jobs.Driver(cfg, traffic, seed, device, workdir)
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
