"""Closed loop of template-2 jobs: ``run_pixel_clustering`` over a seeded
TIFF tree, one job after another, each in a fresh directory.

Set-up draws the cohort and its whole-cell masks from the seed, writes them
as the template's TIFF tree (tiff_dir/<fov>/<channel>.tiff and
segmentation/deepcell_output/<fov>_whole_cell.tiff) and runs one job of the
window's own size as the warm-up (it builds the BMU kernel and
meets every shape the window meets). A job started while the window is open
counts whole. One job of the window, drawn from the seed, keeps its files
for the check; every other job's directory is deleted when it ends.
"""

from __future__ import annotations

import os
import shutil
import time

from portbench import inputs
from portbench.reference import pixie as reference

# the program's functions whose spans name the device's idle gaps
LABELLED = {
    "ark_tpu_torch.phenotyping.pixie_fused": ("_load_fov_raw", "_prep_fov_parts",
                                              "_channel_percentiles_device",
                                              "_quantile_stats_device", "_fov_quantiles"),
    "ark_tpu_torch.phenotyping.pixel_cluster_utils": ("compute_pixel_cluster_channel_avg",),
    "ark_tpu_torch.phenotyping.pixel_som_clustering": ("train_pixel_som",
                                                       "generate_som_avg_files"),
    "ark_tpu_torch.phenotyping.pixel_meta_clustering": ("pixel_consensus_cluster",
                                                        "generate_meta_avg_files"),
    "ark_tpu_torch.io.feather_utils": ("write_table", "write_dataframe"),
    "ark_tpu_torch.ops.som": ("som_map_async",),
}
TABLE_PHASES = ("som_avg_s", "meta_avg_s", "final_write_s")


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, workdir: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir = device, workdir
        self.fovs = [f"fov{i}" for i in range(traffic["fovs_per_job"])]
        self.channels = list(cfg["channels"])
        self.tiff_dir = os.path.join(workdir, "image_data")
        self.seg_dir = os.path.join(workdir, "segmentation", "deepcell_output")
        self.kept_dir = None
        self.records = {}

    def make_inputs(self):
        cfg = self.cfg
        tr = self.traffic
        self.raws = inputs.mibi_cohort(self.seed, len(self.fovs), cfg["fov_size"],
                                       len(self.channels), self.device)
        self.masks = inputs.whole_cell_masks(self.seed, len(self.fovs), cfg["fov_size"],
                                             tr["cells_per_fov"], tr["cell_radius"],
                                             self.device)
        self.records["input_bytes"] = (
            inputs.write_tree(self.tiff_dir, self.raws, self.fovs, self.channels,
                              cfg["img_sub_folder"] or "")
            + inputs.write_masks(self.seg_dir, self.masks, self.fovs, cfg["seg_suffix"]))

    def setup(self):
        self.make_inputs()
        warm = os.path.join(self.workdir, "warm")
        self.job(warm, {})
        self.records["job_bytes"] = _tree_bytes(warm)
        shutil.rmtree(warm)

    def job(self, base: str, timings: dict):
        from ark_tpu_torch.phenotyping import pixie_fused

        os.makedirs(base)
        cfg = self.cfg
        pixie_fused.run_pixel_clustering(
            self.fovs, self.channels, base, self.tiff_dir, seg_dir=self.seg_dir,
            img_sub_folder=cfg["img_sub_folder"], seg_suffix=cfg["seg_suffix"],
            channel_percentile_pre_rownorm=cfg["percentile_pre"],
            channel_percentile_post_rownorm=cfg["percentile_post"],
            blur_factor=cfg["blur_factor"], subset_proportion=cfg["subset_proportion"],
            seed=cfg["seed"], max_k=cfg["max_k"], cap=cfg["cap"], xdim=cfg["xdim"],
            ydim=cfg["ydim"], lr_start=cfg["lr_start"], lr_end=cfg["lr_end"],
            num_passes=cfg["num_passes"], timings=timings, device=self.device)

    def window(self, seconds: float, traced: bool) -> dict:
        """Jobs back to back until `seconds` have passed; returns the
        window's end-to-end numbers."""
        import importlib

        from portbench import tiffclock, trace

        restores = []
        launches = []
        if traced:
            for mod, names in LABELLED.items():
                restores.append(trace.labelled(importlib.import_module(mod), names))
            restores.append(_record_bmu_shapes(launches))
        rng = inputs.host_rng(self.seed, 5)
        jobs, failed = [], 0
        t0 = time.perf_counter()
        t_end = t0
        try:
            while time.perf_counter() - t0 < seconds:
                i = len(jobs)
                base = os.path.join(self.workdir, f"job{i}")
                timings = {}
                clock = tiffclock.TiffClock() if traced else None
                start = time.perf_counter()
                try:
                    if traced:
                        import torch

                        with clock, torch.profiler.record_function("portbench.job"):
                            self.job(base, timings)
                    else:
                        self.job(base, timings)
                except Exception as exc:   # a failed job is counted, the loop goes on
                    failed += 1
                    self.records.setdefault("errors", []).append(repr(exc)[:500])
                    shutil.rmtree(base, ignore_errors=True)
                    jobs.append({"failed": True})
                    t_end = time.perf_counter()
                    continue
                t_end = time.perf_counter()
                jobs.append({"seconds": t_end - start, "timings": timings,
                             "tiff_s": clock.seconds if clock else None,
                             "tiff_calls": clock.calls if clock else None})
                # reservoir of one: job i is kept with probability 1 / (i + 1)
                if rng.random() < 1.0 / (i + 1):
                    if self.kept_dir:
                        shutil.rmtree(self.kept_dir)
                    self.kept_dir = base
                else:
                    shutil.rmtree(base)
        finally:
            for restore in restores:
                restore()
        done = [j for j in jobs if not j.get("failed")]
        n_fovs = len(done) * len(self.fovs)
        self.records.update({
            "jobs": done, "fovs": n_fovs, "attempted": len(jobs), "failed": failed,
            "bmu_launches": launches,
            "table_s": sum(sum(j["timings"].get(p, 0.0) for p in TABLE_PHASES) for j in done),
            "tiff_s": sum(j["tiff_s"] or 0.0 for j in done) if traced else None,
            "tiff_calls": sum(j["tiff_calls"] or 0 for j in done) if traced else None,
        })
        return {"fovs_per_s": n_fovs / (t_end - t0) if n_fovs else None}

    def traced_extras(self):
        pass

    def release(self):
        pass

    def check(self) -> dict:
        if self.kept_dir is None:
            raise RuntimeError("no job finished in the window, so none was checked")
        got = reference.read_job(self.kept_dir, self.fovs, self.channels, self.cfg["fov_size"])
        parts = reference.judge_parts(got, self.raws, self.masks, self.channels, self.cfg,
                                      self.device)
        self.records.update({f"part.{k}": v for k, v in parts.items()})
        return reference.compared(parts)


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _record_bmu_shapes(launches: list):
    """Wrap the program's BMU entry so each launch's (n, c, k) is recorded;
    returns the restore function."""
    from ark_tpu_torch.ops import som

    original = som.bmu

    def bmu(weights, data, return_dist=True):
        out = original(weights, data, return_dist)
        if data.device.type == "cuda" and data.shape[0] > 0:
            launches.append((int(data.shape[0]), int(data.shape[1]), int(weights.shape[0])))
        return out
    bmu.launches = original.launches
    som.bmu = bmu

    def restore():
        original.launches = bmu.launches
        som.bmu = original
    return restore

