"""Closed loop of template-3 jobs: ``run_cell_clustering`` over one seeded
cohort of template 2's pixel feathers and template 1's cell table, one job
after another, each in a fresh directory.

Set-up draws the cohort on the device and writes it as template 3 finds it:
- the whole-cell masks (``inputs.whole_cell_masks``, as the cell-table cell
  draws them);
- each cell draws one of ``phenotypes`` phenotypes, and each phenotype is a
  seeded Dirichlet over the ``pixel_meta_clusters`` pixel meta clusters;
  pixels outside every cell (label 0) draw from a distribution of their own;
  each pixel draws its meta cluster from its cell's phenotype, then one of
  the meta cluster's pixel SOM clusters (``pixel_som_clusters`` of them,
  each mapped to one meta cluster by a seeded map that leaves no meta
  cluster empty), uniformly; its 15 channel values are its meta cluster's
  seeded profile times log-normal noise;
- a seeded ``1 - kept_pixel_share`` of the pixels is dropped, as template
  2's threshold drops pixels;
- pixel_mat_data/<fov>.feather, uncompressed, with the columns and types
  ``run_pixel_clustering`` writes (the channels as float64, ``fov`` a large
  string, ``row_index`` and ``column_index`` int64, ``label`` int32,
  ``pixel_som_cluster`` int32, ``pixel_meta_cluster`` int64) and the GUI
  remap's ``pixel_meta_cluster_rename`` (int64: the metacluster GUI's
  untouched names, the meta cluster numbers, read back as integers);
- pixel_channel_avg_meta_cluster.csv as template 2 writes it after the
  remap: each meta cluster's channel means over the kept pixels, its pixel
  count and its name;
- one cell-table CSV with the configuration's ``cell_table_columns`` (the
  size-normalized table of ``quant_1024x40``): a row a cell, FOVs in sorted
  order and labels ascending, ``cell_size`` and ``area`` each mask's pixel
  count, ``fov`` and ``mask_type`` as template 1 writes them; the rest
  seeded by kind: a nucleus of ~75 pixels for all but ``NO_NUCLEUS`` of the
  cells (its columns 0 without one), whole-number ids, hull areas and
  concavity counts, float region properties, and each channel the count
  the cell-table cell's own cohort gives (``inputs.mibi_cohort``'s
  per-pixel Poisson rates: a coarse gamma grid a FOV and channel, here
  summed over each mask, so a cell's count is a Poisson draw of that sum)
  over the cell's size, its nuclear copy the same rate over the nucleus. It
  is written with pyarrow's CSV writer (pandas' ``to_csv`` takes tens of
  seconds at this size), which prints integral values without a decimal
  point.

Then it runs one job as the warm-up (it builds the BMU kernel and meets
every shape the window meets). Each job runs in a fresh <job> directory
that links the cohort's pixel_mat_data and the pixel averages, and writes
template 3's tables beside them. A job started while the window is open
counts whole. One job of the window, drawn from the seed, keeps its files
for the check; every other job's directory is deleted when it ends. After
a traced window one more job runs with the program's spans recorded and
no profiler, for the SOM's milliseconds (``traced_extras``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np
import torch

from portbench import inputs, spans
from portbench.reference import cell_som as reference

# the program's functions whose spans name the device's idle gaps (none of
# them carries a counter attribute, which the label's wrapper would drop)
LABELLED = {
    "ark_tpu_torch.phenotyping.cell_cluster_utils": ("create_c2pc_data",),
    "ark_tpu_torch.phenotyping.cell_som_clustering": ("train_cell_som", "cluster_cells"),
    "ark_tpu_torch.phenotyping.cell_meta_clustering": ("cell_consensus_cluster",),
    "ark_tpu_torch.phenotyping.weighted_channel_comp": ("generate_wc_avg_files",),
    "ark_tpu_torch.io.feather_utils": ("write_dataframe",),
}
CELL_TABLE = "cell_table_size_normalized.csv"
# the cell table's float-valued region properties (the size-normalized
# table's own, with their nuclear copies): seeded floats
MORPH = ("eccentricity", "major_axis_length", "minor_axis_length", "perimeter",
         "equivalent_diameter", "centroid-0", "centroid-1", "major_minor_axis_ratio",
         "perim_square_over_area", "major_axis_equiv_diam_ratio", "convex_hull_resid",
         "centroid_dif", "nc_ratio")
# the cell table's columns drawn by kind rather than as channels
NOT_CHANNELS = frozenset(("fov", "mask_type", "label", "cell_size", "area", "convex_area",
                          "num_concavities") + MORPH)
# the share of the cells without a nucleus (as the cell-table cell draws them)
NO_NUCLEUS = 0.05
# the SOM's spans, which `cells.som_ms_per_job` reads
SOM_SPANS = ("cells.som_train", "cells.som_assign")


def cohort_draws(seed: int, traffic: dict, n_channels: int) -> dict:
    """The cohort's seeded distributions (module docstring), host arrays:
    the 0-based SOM -> meta map, the phenotypes' and the background's
    meta-cluster probabilities (the background's last) and each meta
    cluster's channel profile."""
    rng = inputs.host_rng(seed, 21)
    n_meta, n_som = traffic["pixel_meta_clusters"], traffic["pixel_som_clusters"]
    som_to_meta = np.concatenate([np.arange(n_meta),
                                  rng.integers(0, n_meta, n_som - n_meta)])
    return {"som_to_meta": som_to_meta[rng.permutation(n_som)],
            "meta_probs": rng.dirichlet(np.full(n_meta, 0.3), traffic["phenotypes"] + 1),
            "profiles": rng.dirichlet(np.full(n_channels, 0.5), n_meta)}


def mask_rates(rng: np.random.Generator, mask: np.ndarray, labels: np.ndarray,
               n_channels: int) -> np.ndarray:
    """The sums over each of `labels`' masks of the per-pixel Poisson rates
    that ``inputs.mibi_cohort`` draws for a FOV of the cell-table cell (a
    channel's rate is one gamma draw a block of ``size // 32`` pixels
    square): (len(labels), n_channels) float64."""
    size = mask.shape[0]
    cell = max(size // 32, 1)
    nb = size // cell
    coarse = rng.gamma(0.6, 4.0, size=(nb * nb, n_channels))
    r, c = np.indices(mask.shape)
    block = ((r // cell) * nb + c // cell).ravel()
    hist = np.bincount(mask.ravel().astype(np.int64) * (nb * nb) + block,
                       minlength=(int(mask.max()) + 1) * nb * nb).reshape(-1, nb * nb)
    return hist[labels].astype(np.float64) @ coarse


def fov_pixels(gen: torch.Generator, mask: np.ndarray, draws: dict, traffic: dict,
               device) -> dict:
    """One FOV's kept pixels, drawn on `device` from its (H, W) mask: host
    arrays of the flat index, label, 0-based meta and SOM clusters, the
    (C, P) channel values (float32 draws, as float64), and each meta
    cluster's channel sums and pixel count."""
    d = {k: torch.as_tensor(v, device=device) for k, v in draws.items()}
    n_meta, n_ph = d["meta_probs"].shape[1], d["meta_probs"].shape[0] - 1
    lab = torch.as_tensor(mask, device=device).reshape(-1).to(torch.int64)
    phen = torch.randint(0, n_ph, (int(lab.max()) + 1,), generator=gen, device=device)
    phen[0] = n_ph                                          # the background's own
    cdf = torch.cumsum(d["meta_probs"].to(torch.float32), 1)
    u = torch.rand(lab.numel(), 1, generator=gen, device=device)
    meta = torch.clamp((u > cdf[phen[lab]]).sum(1), max=n_meta - 1)
    # each meta cluster's SOM clusters, padded; one drawn uniformly
    members = [torch.nonzero(d["som_to_meta"] == m)[:, 0] for m in range(n_meta)]
    size = torch.tensor([len(m) for m in members], device=device)
    table = torch.zeros(n_meta, int(size.max()), dtype=torch.int64, device=device)
    for m, ids in enumerate(members):
        table[m, :len(ids)] = ids
    pick = (torch.rand(lab.numel(), generator=gen, device=device) * size[meta]).long()
    som = table[meta, torch.minimum(pick, size[meta] - 1)]
    keep = torch.rand(lab.numel(), generator=gen, device=device) \
        < traffic["kept_pixel_share"]
    at = torch.nonzero(keep)[:, 0]
    meta, som = meta[at], som[at]
    noise = torch.exp(0.5 * torch.randn(d["profiles"].shape[1], at.numel(), generator=gen,
                                        device=device) - 0.125)
    values = (d["profiles"].to(torch.float32).T[:, meta] * noise).to(torch.float64)
    # the meta clusters' channel sums and pixel counts, for template 2's
    # average table
    sums = torch.zeros(n_meta, values.shape[0], dtype=torch.float64, device=device)
    sums.index_add_(0, meta, values.T)
    return {"flat": at.cpu().numpy(), "label": lab[at].to(torch.int32).cpu().numpy(),
            "meta": meta.cpu().numpy(), "som": som.cpu().numpy(),
            "values": values.cpu().numpy(), "sums": sums.cpu().numpy(),
            "counts": torch.bincount(meta, minlength=n_meta).cpu().numpy()}


def pixel_table(fov: str, px: dict, channels, width: int):
    """The FOV's arrow table, as template 2 leaves it after the GUI remap."""
    import pyarrow as pa

    n = len(px["flat"])
    name = fov.encode()
    offsets = np.arange(n + 1, dtype=np.int64) * len(name)
    cols = {c: pa.array(px["values"][ci]) for ci, c in enumerate(channels)}
    cols["fov"] = pa.LargeStringArray.from_buffers(
        n, pa.py_buffer(offsets), pa.py_buffer(name * n))
    cols["row_index"] = pa.array(px["flat"] // width)
    cols["column_index"] = pa.array(px["flat"] % width)
    cols["label"] = pa.array(px["label"])
    cols["pixel_som_cluster"] = pa.array((px["som"] + 1).astype(np.int32))
    cols["pixel_meta_cluster"] = pa.array(px["meta"] + 1)
    cols["pixel_meta_cluster_rename"] = pa.array(px["meta"] + 1)
    return pa.table(cols)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, workdir: str):
        if cfg["pixel_cluster_col"] != traffic["pixel_cluster_col"]:
            raise ValueError("the configuration and the traffic name other pixel "
                             "cluster columns")
        if len(cfg["cell_table_columns"]) != traffic["cell_table_columns"]:
            raise ValueError("the configuration's cell table has another width than "
                             "the traffic's")
        # the program's runner, imported first: a program without it fails
        # here, before set-up's minute of drawing and writing
        from ark_tpu_torch.phenotyping import pixie_cells

        self.pixie_cells = pixie_cells
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir = device, workdir
        self.fovs = [f"fov{i}" for i in range(traffic["fovs_per_job"])]
        self.channels = list(cfg["channels"])
        self.pixel_dir = os.path.join(workdir, "pixel_mat_data")
        self.pixel_avg = os.path.join(workdir, reference.PIXEL_META_AVG)
        self.cell_table = os.path.join(workdir, CELL_TABLE)
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
        import pandas as pd
        import pyarrow.csv as pcsv
        import pyarrow.feather as pf

        cfg, tr = self.cfg, self.traffic
        size, n_ch = cfg["fov_size"], len(self.channels)
        t = time.perf_counter()
        torch.empty(0, device=self.device)
        t = self._clock("setup_context_s", t)
        masks = inputs.whole_cell_masks(self.seed, len(self.fovs), size,
                                        tr["cells_per_fov"], tr["cell_radius"], self.device)
        t = self._clock("setup_masks_s", t)
        draws = cohort_draws(self.seed, tr, n_ch)
        gen = inputs.generator(self.seed, 22, self.device)
        n_meta = tr["pixel_meta_clusters"]
        sums, counts = np.zeros((n_meta, n_ch)), np.zeros(n_meta, np.int64)
        os.makedirs(self.pixel_dir)
        written, draw_s, pixels = 0, 0.0, 0
        for fov, mask in zip(self.fovs, masks):
            t0 = time.perf_counter()
            px = fov_pixels(gen, mask, draws, tr, self.device)
            draw_s += time.perf_counter() - t0
            sums += px["sums"]
            counts += px["counts"]
            path = os.path.join(self.pixel_dir, f"{fov}.feather")
            pf.write_feather(pixel_table(fov, px, self.channels, size), path,
                             compression="uncompressed")
            written += os.path.getsize(path)
            pixels += len(px["flat"])
        self.records["setup_pixel_draw_s"] = draw_s
        t = self._clock("setup_pixels_s", t)
        avg = pd.DataFrame(sums / np.maximum(counts, 1)[:, None], columns=self.channels)
        avg.insert(0, "pixel_meta_cluster", np.arange(1, n_meta + 1))
        avg["count"] = counts
        avg["pixel_meta_cluster_rename"] = np.arange(1, n_meta + 1)
        avg.to_csv(self.pixel_avg, index=False)
        written += os.path.getsize(self.pixel_avg)
        pcsv.write_csv(self.cell_table_frame(masks), self.cell_table,
                       write_options=pcsv.WriteOptions(quoting_style="needed"))
        written += os.path.getsize(self.cell_table)
        self._clock("setup_table_s", t)
        self.records.update(input_bytes=written, pixels=pixels,
                            cells=sum(len(np.unique(m)) - 1 for m in masks))

    def cell_table_frame(self, masks):
        """The cell-table CSV's arrow table (module docstring)."""
        import pyarrow as pa

        rng, field = inputs.host_rng(self.seed, 23), inputs.host_rng(self.seed, 24)
        panel = [c for c in self.cfg["cell_table_columns"]
                 if c not in NOT_CHANNELS and not c.endswith("_nuclear")]
        order = sorted(range(len(self.fovs)), key=lambda i: self.fovs[i])
        labels, sizes, fovs, rates = [], [], [], []
        for i in order:
            ids, n = np.unique(masks[i], return_counts=True)
            labels.append(ids[ids > 0])
            sizes.append(n[ids > 0])
            fovs += [self.fovs[i]] * int((ids > 0).sum())
            rates.append(mask_rates(field, masks[i], labels[-1], len(panel)))
        label, size = np.concatenate(labels), np.concatenate(sizes).astype(np.float64)
        n = len(label)
        nucleus = rng.random(n) >= NO_NUCLEUS
        sizes = {"": size, "_nuclear": np.where(nucleus, rng.poisson(75.0, n) + 1, 0.0)}
        # each channel's summed rate over the whole cell, and over its nucleus
        # at the cell's mean rate
        rates = np.concatenate(rates)
        rates = {"": rates, "_nuclear": rates / size[:, None] * sizes["_nuclear"][:, None]}
        cols = {}
        for name in self.cfg["cell_table_columns"]:
            comp = "_nuclear" if name.endswith("_nuclear") else ""
            base, size_c = name[:len(name) - len(comp)], sizes[comp]
            if name == "fov":
                values = pa.array(fovs)
            elif name == "mask_type":
                values = pa.array(["whole_cell"] * n)
            elif name == "label":
                values = label.astype(np.int64)
            elif base in ("cell_size", "area"):
                values = size_c
            elif base == "label":
                values = np.where(nucleus, rng.permutation(n) + 1, 0).astype(np.float64)
            elif base == "convex_area":
                values = size_c + np.where(size_c > 0, rng.poisson(3.0, n), 0)
            elif base == "num_concavities":
                values = np.where(size_c > 0, rng.poisson(0.2, n), 0).astype(np.float64)
            elif base in MORPH:
                values = np.where(size_c > 0, rng.gamma(2.0, 1.0, n), 0.0)
            else:                       # a channel: its Poisson count over the size
                counts = rng.poisson(rates[comp][:, panel.index(base)])
                values = np.where(size_c > 0, counts / np.maximum(size_c, 1), 0.0)
            cols[name] = pa.array(values)
        return pa.table(cols)

    def setup(self):
        self.make_inputs()
        warm = os.path.join(self.workdir, "warm")
        t = time.perf_counter()
        self.job(warm)
        self._clock("setup_warm_s", t)
        self.records["job_bytes"] = _tree_bytes(warm)
        shutil.rmtree(warm)

    def job(self, base: str):
        """Template 3 in a fresh directory linking the cohort's inputs."""
        cfg = self.cfg
        os.makedirs(base)
        os.symlink(self.pixel_dir, os.path.join(base, "pixel_mat_data"))
        os.symlink(self.pixel_avg, os.path.join(base, reference.PIXEL_META_AVG))
        self.pixie_cells.run_cell_clustering(
            base, self.channels, self.cell_table, self.fovs,
            pixel_cluster_col=cfg["pixel_cluster_col"], xdim=cfg["xdim"], ydim=cfg["ydim"],
            num_passes=cfg["num_passes"], lr_start=cfg["lr_start"], lr_end=cfg["lr_end"],
            max_k=cfg["max_k"], cap=cfg["cap"], seed=cfg["seed"], device=self.device)

    def window(self, seconds: float, traced: bool) -> dict:
        """Jobs back to back until `seconds` have passed; returns the
        window's end-to-end numbers."""
        import importlib

        from portbench import trace

        restores = []
        if traced:
            for mod, names in LABELLED.items():
                restores.append(trace.labelled(importlib.import_module(mod), names))
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
                    with torch.profiler.record_function("portbench.job") if traced \
                            else contextlib.nullcontext():
                        self.job(base)
                except Exception as exc:   # a failed job is counted, the loop goes on
                    failed += 1
                    self.records.setdefault("errors", []).append(repr(exc)[:500])
                    shutil.rmtree(base, ignore_errors=True)
                    jobs.append({"failed": True})
                    t_end = time.perf_counter()
                    continue
                t_end = time.perf_counter()
                jobs.append({"seconds": t_end - start})
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
        })
        return {"fovs_per_s": n_fovs / (t_end - t0) if n_fovs else None}

    def traced_extras(self):
        """One job with the program's spans recorded and no profiler (whose
        cost on the SOM training's ~2,600 eager launches is about as large as
        their own): its SOM milliseconds. The job runs under a span of the
        harness, so its `cells.run` is no root and the window's readers do
        not count it. A program without spans records nothing."""
        try:
            from ark_tpu_torch.utils import profiling
            recording, span = profiling.recording, profiling.span
        except (ImportError, AttributeError):
            return
        base = os.path.join(self.workdir, "untraced")
        with recording(), span("portbench.untraced_job") as outer:
            self.job(base)
        shutil.rmtree(base)
        som = [s for s in profiling.spans()
               if s["root"] == outer.id and s["name"] in SOM_SPANS]
        if som:
            self.records["som_ms_untraced"] = 1e3 * sum(spans.seconds(s) for s in som)

    def release(self):
        pass

    def reference(self, tf32: bool = False) -> reference.CellReference:
        return reference.CellReference(self.pixel_dir, self.cell_table, self.pixel_avg,
                                       self.fovs, self.channels, self.cfg, self.device,
                                       tf32=tf32)

    def check(self) -> dict:
        if self.kept_dir is None:
            raise RuntimeError("no job finished in the window, so none was checked")
        return reference.judge(reference.read_job(self.kept_dir), self.reference())


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
               for f in fs if not os.path.islink(os.path.join(d, f)))
