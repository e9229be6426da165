"""Closed loop of template-1 cell-table jobs: ``generate_cell_table`` over a
seeded TIFF tree with whole-cell and nuclear masks, then the template's two
``to_csv`` calls, one job after another.

Set-up draws the channel counts (as the pixel cell draws them), the
whole-cell masks and the nuclei from the seed, writes the template's tree
(image_data/<fov>/<channel>.tiff, segmentation/deepcell_output/
<fov>_whole_cell.tiff and <fov>_nuclear.tiff) and runs one job of the
window's own size as the warm-up (it builds the segment-sum kernels and meets
every shape the window meets). The records carry set-up's phases (CUDA
context, drawing the inputs, writing the tree, the warm-up job and its
CSVs) and each job's split between ``generate_cell_table`` and the two
``to_csv`` calls (a ``portbench.to_csv`` label in a traced window), so that
both are read on the GPU's host. Each job writes into a fresh
<job>/segmentation/cell_table, its checkpoint parts under parts/ as the
template sets them. A job started while the window is open counts whole. One
job of the window, drawn from the seed, keeps its files for the check; every
other job's directory is deleted when it ends.

The nuclei: around each cell's centre (the centres ``inputs.whole_cell_masks``
drew) a disc of a seeded radius in the traffic's ``nucleus_radius`` range,
its centre moved by up to ``nucleus_jitter`` pixels along each axis; a
seeded ``share_without_nucleus`` of the cells has none; the nuclei are
numbered by a seeded permutation, so a nucleus's id is not its cell's; a
pixel in several discs takes the nearest centre's; nothing is clipped to the
cell, so a nucleus may lie in two cells and the max-overlap rule decides.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np
import torch

from portbench import inputs
from portbench.reference import cell_table as reference

# the program's functions whose spans name the device's idle gaps
LABELLED = {
    "ark_tpu_torch.io.load_utils": ("load_imgs_from_tree", "load_imgs_from_dir"),
    "ark_tpu_torch.ops.convex": ("convex_features", "count_concavities_batch"),
    "ark_tpu_torch.ops.segment_reduce": ("moment_and_channel_features",),
    "ark_tpu_torch.segmentation.segmentation_utils": ("match_nuclei_to_cells",
                                                      "transform_expression_matrix"),
}


def cell_centres(seed: int, n_fovs: int, size: int, n_cells: int, device) -> list:
    """Per FOV the (n_cells, 2) centres ``inputs.whole_cell_masks`` draws
    for the same arguments: the same generator, the same draws."""
    gen = inputs.generator(seed, 7, device)
    return [torch.rand(n_cells, 2, generator=gen, device=device) * size
            for _ in range(n_fovs)]


def nuclear_masks(seed: int, centres: list, size: int, traffic: dict, device) -> list:
    """Per FOV an (H, W) int32 nuclear mask around `centres` (module
    docstring)."""
    lo, hi = (float(r) for r in str(traffic["nucleus_radius"]).split("-"))
    jitter = float(traffic["nucleus_jitter"])
    gen = inputs.generator(seed, 11, device)
    rng = inputs.host_rng(seed, 12)
    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32),
                            indexing="ij")
    out = []
    for c in centres:
        n = c.shape[0]
        radius = lo + (hi - lo) * torch.rand(n, generator=gen, device=device)
        at = c + (2.0 * torch.rand(n, 2, generator=gen, device=device) - 1.0) * jitter
        without = rng.choice(n, size=int(round(traffic["share_without_nucleus"] * n)),
                             replace=False)
        kept = np.setdiff1d(np.arange(n), without)
        ids = np.zeros(n, np.int64)
        ids[kept] = rng.permutation(len(kept)) + 1
        kept_t = torch.as_tensor(kept, device=device)
        ids_t = torch.as_tensor(ids[kept], dtype=torch.int32, device=device)
        at, radius = at[kept_t], radius[kept_t]
        best = torch.full((size, size), float("inf"), device=device)
        label = torch.zeros((size, size), dtype=torch.int32, device=device)
        for s in range(0, len(kept), 64):
            p, r = at[s:s + 64], radius[s:s + 64, None, None]
            d2 = (yy[None] - p[:, 0, None, None]) ** 2 + (xx[None] - p[:, 1, None, None]) ** 2
            d2 = torch.where(d2 <= r * r, d2, float("inf"))
            dmin, arg = torch.min(d2, dim=0)
            closer = dmin < best
            best = torch.where(closer, dmin, best)
            label = torch.where(closer, ids_t[s:s + 64][arg], label)
        out.append(label.cpu().numpy())
    return out


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

    def _clock(self, key: str, t0: float) -> float:
        """Record the seconds since `t0` under `key`, the device synced;
        returns now."""
        if self.device != "cpu":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.records[key] = now - t0
        return now

    def make_inputs(self):
        cfg, tr = self.cfg, self.traffic
        n, size = len(self.fovs), cfg["fov_size"]
        t = time.perf_counter()
        torch.empty(0, device=self.device)
        t = self._clock("setup_context_s", t)
        self.raws = inputs.mibi_cohort(self.seed, n, size, len(self.channels), self.device)
        self.masks = inputs.whole_cell_masks(self.seed, n, size, tr["cells_per_fov"],
                                             tr["cell_radius"], self.device)
        centres = cell_centres(self.seed, n, size, tr["cells_per_fov"], self.device)
        self.nuclei = nuclear_masks(self.seed, centres, size, tr, self.device)
        t = self._clock("setup_draw_s", t)
        self.records["input_bytes"] = (
            inputs.write_tree(self.tiff_dir, self.raws, self.fovs, self.channels,
                              cfg["img_sub_folder"] or "")
            + inputs.write_masks(self.seg_dir, self.masks, self.fovs, "_whole_cell.tiff")
            + inputs.write_masks(self.seg_dir, self.nuclei, self.fovs, "_nuclear.tiff"))
        self._clock("setup_write_s", t)

    def setup(self):
        self.make_inputs()
        warm = os.path.join(self.workdir, "warm")
        t = time.perf_counter()
        self.records["setup_warm_csv_s"] = self.job(warm)["csv_s"]
        self._clock("setup_warm_s", t)
        self.records["job_bytes"] = _tree_bytes(warm)
        shutil.rmtree(warm)

    @staticmethod
    def table_dir(base: str) -> str:
        return os.path.join(base, "segmentation", "cell_table")

    def job(self, base: str, traced: bool = False) -> dict:
        """Template 1's cell 9: the cell table and its two CSVs; returns the
        seconds of each ({"table_s", "csv_s"})."""
        from ark_tpu_torch.segmentation import marker_quantification

        cfg = self.cfg
        out = self.table_dir(base)
        os.makedirs(out)
        t0 = time.perf_counter()
        size_norm, arcsinh = marker_quantification.generate_cell_table(
            segmentation_dir=self.seg_dir, tiff_dir=self.tiff_dir,
            img_sub_folder=cfg["img_sub_folder"], fovs=self.fovs,
            extraction=cfg["extraction"], nuclear_counts=cfg["nuclear_counts"],
            fast_extraction=cfg["fast_extraction"], mask_types=cfg["mask_types"],
            add_underscore=cfg["add_underscore"],
            checkpoint_dir=os.path.join(out, "parts"), device=self.device)
        t1 = time.perf_counter()
        with torch.profiler.record_function("portbench.to_csv") if traced \
                else contextlib.nullcontext():
            size_norm.to_csv(os.path.join(out, reference.NORM_CSV), index=False)
            arcsinh.to_csv(os.path.join(out, reference.ARCSINH_CSV), index=False)
        return {"table_s": t1 - t0, "csv_s": time.perf_counter() - t1}

    def window(self, seconds: float, traced: bool) -> dict:
        """Jobs back to back until `seconds` have passed; returns the
        window's end-to-end numbers."""
        import importlib

        from portbench import trace

        restores, launches = [], []
        if traced:
            for mod, names in LABELLED.items():
                restores.append(trace.labelled(importlib.import_module(mod), names))
            restores.append(_record_segsum(launches))
        rng = inputs.host_rng(self.seed, 5)
        jobs, failed = [], 0
        t0 = time.perf_counter()
        t_end = t0
        try:
            while time.perf_counter() - t0 < seconds:
                i = len(jobs)
                base = os.path.join(self.workdir, f"job{i}")
                start = time.perf_counter()
                try:
                    if traced:
                        with torch.profiler.record_function("portbench.job"):
                            split = self.job(base, traced)
                    else:
                        split = self.job(base)
                except Exception as exc:   # a failed job is counted, the loop goes on
                    failed += 1
                    self.records.setdefault("errors", []).append(repr(exc)[:500])
                    shutil.rmtree(base, ignore_errors=True)
                    jobs.append({"failed": True})
                    t_end = time.perf_counter()
                    continue
                t_end = time.perf_counter()
                jobs.append({"seconds": t_end - start, **split})
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
            "job_s_min": min((j["seconds"] for j in done), default=None),
            "job_s_max": max((j["seconds"] for j in done), default=None),
            **{f"{key}_{stat.__name__}": stat(j[key] for j in done) if done else None
               for key in ("table_s", "csv_s") for stat in (min, max)},
            "csv_share": sum(j["csv_s"] for j in done) / sum(j["seconds"] for j in done)
            if done else None,
            "segsum_launches": [(kind, n, k, s, *(int(v) for v in counted.tolist()))
                                for kind, n, k, s, counted in launches],
        })
        return {"fovs_per_s": n_fovs / (t_end - t0) if n_fovs else None}

    def traced_extras(self):
        pass

    def release(self):
        pass

    def check(self) -> dict:
        if self.kept_dir is None:
            raise RuntimeError("no job finished in the window, so none was checked")
        got = reference.read_job(self.table_dir(self.kept_dir))
        want = reference.tables(self.fovs, self.raws, self.masks, self.nuclei,
                                self.channels)
        return reference.judge(got, want, self.channels)


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _record_segsum(launches: list):
    """Wrap the program's segment sum and plan so that each CUDA launch on a
    label image records (kind, pixels, K, segments, counted), `counted` a
    device tensor of (pixels whose values the launch reads, the longest
    chain of adds) read after the window; returns the restore function. The
    labels' histogram is taken once a plan, for the sums given that plan."""
    from ark_tpu_torch.ops import segment_reduce as sr

    real_sum, real_plan = sr.segment_sum, sr.segment_plan
    newest = {}                     # the newest plan and its labels' histogram

    def histogram(labels, num_segments):
        return torch.bincount(labels.reshape(-1).to(torch.int64),
                              minlength=num_segments)[:num_segments]

    def segment_sum(values, labels, num_segments, plan=None, background=True):
        out = real_sum(values, labels, num_segments, plan, background)
        if values.device.type == "cuda" and labels.ndim == 2 and values.shape[0] > 0:
            k = values.shape[1] if values.ndim == 2 else 1
            sizes = newest["sizes"] if plan is not None and newest.get("plan") is plan \
                else histogram(labels, num_segments)
            read = sizes if background else torch.cat([sizes.new_zeros(1), sizes[1:]])
            launches.append(("sum", labels.numel(), k, num_segments,
                             torch.stack([read.sum(), read.max()])))
        return out

    def segment_plan(labels, num_segments):
        out = real_plan(labels, num_segments)
        if labels.device.type == "cuda" and labels.ndim == 2:
            newest.update(plan=out, sizes=histogram(labels, num_segments))
            launches.append(("plan", labels.numel(), 0, num_segments,
                             torch.zeros(2, dtype=torch.int64)))
        return out

    segment_sum.launches = real_sum.launches
    segment_plan.launches = real_plan.launches
    sr.segment_sum, sr.segment_plan = segment_sum, segment_plan

    def restore():
        real_sum.launches, real_plan.launches = segment_sum.launches, segment_plan.launches
        sr.segment_sum, sr.segment_plan = real_sum, real_plan
        newest.clear()
    return restore
