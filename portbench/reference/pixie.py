"""Plain Pixie pixel clustering (ark-analysis template 2), and the judge that
holds a job's files to it.

The stage, as ark-analysis defines it (Liu et al. 2023; its
``pixie_preprocessing``, ``pixel_som_clustering``, ``pixel_meta_clustering``
and ``cluster_helpers``), with the batch-SOM schedule of this repository's
pipeline (256 minibatch steps, FlowSOM's seeded start and bubble
neighbourhood):

1. channel norms: per FOV and channel the 0.99 quantile of the positive
   counts; their mean over the FOVs that have any;
2. threshold: the mean over FOVs of the 0.05 quantile of the summed
   channel-normalized counts;
3. per FOV: counts / norms, a Gaussian blur (sigma = blur_factor, radius
   4 sigma, reflected edges) as products with banded matrices, row sums,
   rows scaled to sum 1; a pixel is kept where its row sum exceeds the
   threshold and any channel is nonzero;
4. a seeded subset of each FOV's kept rows (``np.random.seed(seed)`` then
   ``np.random.choice``), and per FOV the 0.999 quantile of each channel's
   nonzero kept values (pandas' ``replace(0, nan).quantile``), averaged
   over FOVs: the post-rownorm norms;
5. the SOM trained on the subset over the post norms; every kept pixel
   mapped to its nearest node;
6. per-cluster channel averages; Ward linkage of the z-scored averages
   (capped at +-cap) cut into max_k meta clusters; per-meta averages;
7. each kept pixel carries the whole-cell mask's label at its position.

Products run in float32 with TF32 off, or with TF32 on for the control.
Imports nothing of the program. What the judge reads of a job is its files.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch

from portbench.reference.compare import column_gap, partition_mismatch, rel_gap

MAX_TRAIN_STEPS = 256
# near ties: a pixel whose row sum lies within this share of the threshold
# may fall either side under another summation order, and a node whose
# squared distance lies within this share of (|x|^2 + |w|^2) of the best
# may be picked instead
KEEP_TIE_RTOL = 1e-5
BMU_TIE_RTOL = 1e-5


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    mm = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.set_float32_matmul_precision(prec)


@dataclass
class Outputs:
    """What a job produced, per FOV in the order given: the kept pixels'
    flat indices (ascending), their normalized values (f64), SOM and meta
    labels, cell labels; the cohort's norms, threshold, weights and the two average
    tables (cluster id, channels..., count)."""
    norm_pre: np.ndarray
    thresh: float
    norm_post: np.ndarray
    weights: np.ndarray
    kept: list
    values: list
    som: list
    meta: list
    cell: list
    som_avg: np.ndarray
    meta_avg: np.ndarray


def read_job(base_dir: str, fovs, channels, size: int) -> Outputs:
    """A finished run_pixel_clustering job's files as Outputs."""
    import pyarrow as pa

    def feather(path):
        with pa.memory_map(path) as src:
            return pa.ipc.open_file(src).read_all().to_pandas()

    out_dir = os.path.join(base_dir, "pixel_output_dir")
    norm_pre = feather(os.path.join(out_dir, "channel_norm_pre_rownorm.feather"))[channels]
    thresh = feather(os.path.join(out_dir, "pixel_thresh.feather"))["pixel_thresh_val"]
    norm_post = feather(os.path.join(base_dir, "channel_norm_post_rownorm.feather"))[channels]
    weights = feather(os.path.join(base_dir, "pixel_som_weights.feather"))[channels]
    kept, values, som, meta, cell = [], [], [], [], []
    for fov in fovs:
        t = feather(os.path.join(base_dir, "pixel_mat_data", f"{fov}.feather"))
        flat = t["row_index"].to_numpy(np.int64) * size + t["column_index"].to_numpy(np.int64)
        order = np.argsort(flat, kind="stable")
        kept.append(flat[order])
        values.append(t[channels].to_numpy(np.float64)[order])
        som.append(t["pixel_som_cluster"].to_numpy(np.int64)[order])
        meta.append(t["pixel_meta_cluster"].to_numpy(np.int64)[order])
        cell.append(t["label"].to_numpy(np.int64)[order] if "label" in t else None)
    som_avg = pd.read_csv(os.path.join(base_dir, "pixel_channel_avg_som_cluster.csv"))
    meta_avg = pd.read_csv(os.path.join(base_dir, "pixel_channel_avg_meta_cluster.csv"))
    return Outputs(
        norm_pre=norm_pre.to_numpy(np.float64)[0], thresh=float(thresh.iloc[0]),
        norm_post=norm_post.to_numpy(np.float64)[0],
        weights=weights.to_numpy(np.float32), kept=kept, values=values, som=som,
        meta=meta, cell=cell,
        som_avg=som_avg[["pixel_som_cluster", *channels, "count"]].to_numpy(np.float64),
        meta_avg=meta_avg[["pixel_meta_cluster", *channels, "count"]].to_numpy(np.float64))


# ---------------------------------------------------------------------------
# the plain stage
# ---------------------------------------------------------------------------

def _quantile_sorted(srt: torch.Tensor, n: int, q: float) -> float:
    """numpy's linear quantile of the first n entries of a sorted vector."""
    if n == 0:
        return float("nan")
    pos = q * (n - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n - 1)
    a, b = float(srt[lo]), float(srt[hi])
    return a + (b - a) * (pos - lo)


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized Gaussian taps of radius int(truncate * sigma + 0.5)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (taps / taps.sum()).astype(np.float32)


def correlate(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Same-size correlation along `axis` with reflected edges
    (``d c b a | a b c d | d c b a``): the taps' weighted sum of shifted
    copies, in tap order, in float32."""
    n, r = x.shape[axis], (len(taps) - 1) // 2
    i = torch.arange(-r, n + r, device=x.device) % (2 * n)
    src = torch.index_select(x, axis, torch.where(i >= n, 2 * n - 1 - i, i))
    out = src.narrow(axis, 0, n) * float(taps[0])
    for t in range(1, len(taps)):
        out = out + src.narrow(axis, t, n) * float(taps[t])
    return out


class PixelReference:
    """The plain stage over in-memory counts (one (H, W, C) f32 array per FOV).

    Its steps can start from another run's values at the stage's cohort
    barriers (the norms and threshold, the post-rownorm norms, the SOM
    weights), so that each step is judged on its own."""

    def __init__(self, raws, channels, cfg: dict, device, tf32: bool = False):
        self.raws = raws
        self.channels = list(channels)
        self.cfg = cfg
        self.device = torch.device(device)
        self.tf32 = tf32

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(a, device=self.device, dtype=dtype)

    def norms_and_threshold(self):
        """Steps 1-2: the channel norms and the pixel threshold. The channel
        sums are a product with a ones vector (TF32 in the control)."""
        cfg, c = self.cfg, len(self.channels)
        ones = torch.ones(c, 1, device=self.device)
        per_fov, has = [], []
        with matmul_precision(self.tf32), torch.no_grad():
            for raw in self.raws:
                cols = self._t(raw).reshape(-1, c)
                vals, pos = [], []
                for ci in range(c):
                    col = cols[:, ci]
                    srt = torch.sort(col[col > 0]).values.to(torch.float64)
                    vals.append(_quantile_sorted(srt, srt.numel(), cfg["percentile_pre"]))
                    pos.append(srt.numel() > 0)
                per_fov.append(vals)
                has.append(pos)
            per_fov, has = np.array(per_fov), np.array(has)
            self.norm_pre = np.array([per_fov[has[:, ci], ci].mean() for ci in range(c)])
            q05 = []
            for raw in self.raws:
                x = self._t(raw).reshape(-1, c) / self._t(self.norm_pre)
                summed = (x @ ones)[:, 0]
                srt = torch.sort(summed).values.to(torch.float64)
                q05.append(_quantile_sorted(srt, srt.numel(), 0.05))
            self.thresh = float(np.mean(q05))

    def prep(self, norm_pre, thresh):
        """Step 3 from the given norms and threshold: each FOV's row sums,
        row-scaled matrix and kept mask."""
        c = len(self.channels)
        taps = gaussian_taps(self.cfg["blur_factor"])
        self.thresh_used = float(thresh)
        self.rowsums, self.norms, self.valid = [], [], []
        with torch.no_grad():
            for raw in self.raws:
                h, w, _ = raw.shape
                x = self._t((raw / np.asarray(norm_pre, np.float64)).astype(np.float32))
                mat = correlate(correlate(x, taps, 0), taps, 1).reshape(h * w, c)
                rowsums = torch.sum(mat, dim=1)
                anynz = torch.any(mat != 0, dim=1)
                self.rowsums.append(rowsums)
                self.norms.append(mat / torch.where(rowsums == 0, 1.0, rowsums)[:, None])
                self.valid.append((rowsums > np.float32(thresh)) & anynz)

    def keep(self, given=None):
        """Each FOV's kept flat indices. With `given` (another run's kept
        indices per FOV), pixels within KEEP_TIE_RTOL of the threshold take
        the given decision; returns the count of pixels decided otherwise
        beyond that band."""
        self.kept, unexcused = [], 0
        for fi, valid in enumerate(self.valid):
            if given is None:
                self.kept.append(torch.nonzero(valid)[:, 0].cpu().numpy())
                continue
            other = torch.zeros_like(valid)
            other[self._t(given[fi], torch.int64)] = True
            near = torch.abs(self.rowsums[fi] - self.thresh_used) \
                <= KEEP_TIE_RTOL * abs(self.thresh_used)
            unexcused += int(torch.sum((valid != other) & ~near))
            self.kept.append(torch.nonzero(torch.where(near, other, valid))[:, 0].cpu().numpy())
        return unexcused

    def post_norm_and_subset(self):
        """Step 4: each FOV's seeded subset of kept rows, and the post-rownorm
        norms."""
        cfg = self.cfg
        quants, subs = [], []
        for fi, kept in enumerate(self.kept):
            norm_keep = self.norms[fi][self._t(kept, torch.int64)].cpu().numpy()
            np.random.seed(cfg["seed"])
            n_sub = int(round(cfg["subset_proportion"] * len(kept)))
            locs = np.random.choice(len(kept), size=n_sub, replace=False)
            subs.append(norm_keep[locs])
            frame = pd.DataFrame(norm_keep, columns=self.channels)
            quants.append(frame.replace(0, np.nan).quantile(cfg["percentile_post"]))
        self.norm_post = pd.concat(quants, axis=1).mean(axis=1).to_numpy()
        self.subset_rows = np.concatenate(subs)

    def values(self, norm_post):
        """Each FOV's kept pixels over the given post norms, float64."""
        out = []
        for fi, kept in enumerate(self.kept):
            nk = self.norms[fi][self._t(kept, torch.int64)].cpu().numpy()
            out.append(nk.astype(np.float64) / np.asarray(norm_post, np.float64))
        return out

    def train(self, norm_post) -> np.ndarray:
        """Step 5, on the subset over the given post norms: batch SOM with
        FlowSOM's seeded start rows and visiting order, 256 minibatch steps,
        learning rate lr_start -> lr_end and bubble radius r0 -> 0 linearly,
        r0 the 0.67 quantile of the grid's distances."""
        cfg = self.cfg
        data = self._t(self.subset_rows.astype(np.float64) / np.asarray(norm_post, np.float64))
        n = data.shape[0]
        k = cfg["xdim"] * cfg["ydim"]
        rng = np.random.default_rng(cfg["seed"])
        init = rng.choice(n, size=k, replace=n < k)
        bs = int(np.clip(1 << max(max(n * cfg["num_passes"] // MAX_TRAIN_STEPS, 1) - 1, 1)
                         .bit_length(), 8, 1 << 16))
        perm = rng.permutation(n)
        order = np.tile(perm, -(-MAX_TRAIN_STEPS * bs // n))[:MAX_TRAIN_STEPS * bs]
        gx, gy = np.meshgrid(np.arange(cfg["xdim"]), np.arange(cfg["ydim"]), indexing="ij")
        grid = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
        gdist = np.sqrt(((grid[:, None] - grid[None]) ** 2).sum(-1)).astype(np.float32)
        r0 = np.float32(np.quantile(gdist, 0.67))
        frac = np.arange(MAX_TRAIN_STEPS, dtype=np.float32) / np.float32(MAX_TRAIN_STEPS - 1)
        alpha = np.float32(cfg["lr_start"]) + np.float32(cfg["lr_end"] - cfg["lr_start"]) * frac
        radius = r0 * (np.float32(1) - frac)
        gdist_t = self._t(gdist)
        order_t = self._t(order, torch.int64)
        w = data[self._t(init, torch.int64)]
        with matmul_precision(self.tf32), torch.no_grad():
            for t in range(MAX_TRAIN_STEPS):
                x = data[order_t[t * bs:(t + 1) * bs]]
                d = torch.sum(w * w, 1)[None] - 2.0 * (x @ w.T)
                h = (gdist_t[torch.argmin(d, 1)] <= float(radius[t])).to(torch.float32)
                num = h.T @ x
                den = h.sum(0)
                target = num / torch.clamp_min(den, 1.0)[:, None]
                w = torch.where((den > 0)[:, None], w + float(alpha[t]) * (target - w), w)
        self.weights = w.cpu().numpy()
        return self.weights

    def labels(self, weights, values):
        """1-indexed nearest nodes of each FOV's pixels under `weights`, and
        the squared distances (|x|^2 + |w|^2 - 2 x.w) to every node."""
        w = self._t(weights)
        w2 = torch.sum(w * w, 1)
        out = []
        with matmul_precision(self.tf32), torch.no_grad():
            for v in values:
                x = self._t(v.astype(np.float32))
                d = torch.sum(x * x, 1)[:, None] + w2[None] - 2.0 * (x @ w.T)
                out.append((torch.argmin(d, 1) + 1, d))
        return out

    def averages(self, values, labels, ids):
        """(len(ids), 1 + C + 1) table: id, channel means over every FOV's
        pixels of that label, count."""
        c = len(self.channels)
        ids = np.asarray(ids, np.int64)
        sums = torch.zeros(len(ids), c, dtype=torch.float64, device=self.device)
        counts = torch.zeros(len(ids), dtype=torch.float64, device=self.device)
        for v, lab in zip(values, labels):
            row = self._t(np.searchsorted(ids, lab), torch.int64)
            sums.index_add_(0, row, self._t(v, torch.float64))
            counts.index_add_(0, row, torch.ones(len(lab), dtype=torch.float64,
                                                 device=self.device))
        means = (sums / torch.clamp_min(counts, 1)[:, None]).cpu().numpy()
        return np.column_stack([ids, means, counts.cpu().numpy()])

    def ward(self, som_avg) -> np.ndarray:
        """Meta cluster (0-based, arbitrary numbering) of each row of the
        SOM average table: Ward linkage of the z-scored channel columns,
        capped at +-cap, cut into max_k clusters by undoing the last
        max_k - 1 merges."""
        from scipy.cluster import hierarchy

        x = som_avg[:, 1:-1]
        sd = x.std(axis=0)
        z = np.clip((x - x.mean(axis=0)) / np.where(sd > 0, sd, 1.0),
                    -self.cfg["cap"], self.cfg["cap"])
        n = len(z)
        link = hierarchy.ward(z)
        parent = list(range(2 * n - 1))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for step in range(n - self.cfg["max_k"]):
            a, b = int(link[step, 0]), int(link[step, 1])
            parent[find(a)] = n + step
            parent[find(b)] = n + step
        roots = [find(i) for i in range(n)]
        _, meta = np.unique(roots, return_inverse=True)
        return meta

    def run(self, masks) -> Outputs:
        """The whole stage from its own state, as a job would produce it (the
        control)."""
        self.norms_and_threshold()
        self.prep(self.norm_pre, self.thresh)
        self.keep()
        self.post_norm_and_subset()
        weights = self.train(self.norm_post)
        values = self.values(self.norm_post)
        som = [lab.cpu().numpy() for lab, _ in self.labels(weights, values)]
        ids = np.unique(np.concatenate(som))
        som_avg = self.averages(values, som, ids)
        meta = _lookup(ids, self.ward(som_avg) + 1, som)
        meta_avg = self.averages(values, meta, np.unique(np.concatenate(meta)))
        return Outputs(norm_pre=self.norm_pre, thresh=self.thresh,
                       norm_post=self.norm_post.astype(np.float64), weights=weights,
                       kept=self.kept, values=values, som=som, meta=meta,
                       cell=[np.asarray(m).ravel()[k] for m, k in zip(masks, self.kept)],
                       som_avg=som_avg, meta_avg=meta_avg)


def compared(parts: dict) -> dict:
    """The numbers compared, from ``judge_parts``' readings. The control
    (TF32) moves no order statistic and no elementwise sum, so the
    preprocessing's floats cannot be held to a limit of their own; they share
    ``stage_gap`` with the SOM weights, which the control does move."""
    return {
        "stage_gap": max(parts["prep_gap"], parts["value_gap"], parts["weight_gap"]),
        **{k: parts[k] for k in ("label_mismatch", "kept_unexcused", "som_unexcused",
                                 "avg_gap", "meta_mismatch")},
    }


# Steps that start from the job's own values at their cohort barrier rather
# than from the reference's: "prep" (the norms and threshold), "train" (the
# post-rownorm norms). The job's 0.99 quantiles sit up to ~3e-4 off numpy's
# on some seeds (compared in prep_gap); from the reference's own norms a few
# pixels beyond the threshold's tie band change side, the seeded subset draw
# changes, and the whole SOM with it. So step 3 starts from the job's norms
# and threshold; the training starts from the reference's own post norms,
# which then equal the job's bitwise.
FORCED = ("prep",)


def judge_parts(got: Outputs, raws, masks, channels, cfg: dict, device,
                forced=FORCED) -> dict:
    """Each step's own reading for a pixel job. The plain stage runs from the
    inputs through every step on its own values (a step named in `forced`
    starts from the job's values instead), and each step's result is
    compared with the job's:

    prep_gap        norms, threshold and post-rownorm norms, relative;
    label_mismatch  kept pixels whose cell label is not the mask's there;
    kept_unexcused  pixels kept on one side only, away from the threshold
                    (within it the job's decision stands);
    value_gap       the feathers' channel values, relative to each channel;
    weight_gap      the SOM weights against the plain training's;
    som_unexcused   share of pixels whose label is not the nearest node of
                    the plain weights, away from a near tie;
    avg_gap         the SOM and meta average tables;
    meta_mismatch   share of pixels whose meta label disagrees with the
                    Ward cut of the plain averages, as partitions."""
    ref = PixelReference(raws, channels, cfg, device)
    ref.norms_and_threshold()
    prep_gap = max(rel_gap(got.norm_pre, ref.norm_pre), rel_gap([got.thresh], [ref.thresh]))
    if "prep" in forced:
        ref.prep(got.norm_pre, got.thresh)
    else:
        ref.prep(ref.norm_pre, ref.thresh)
    kept_unexcused = ref.keep(given=got.kept)
    ref.post_norm_and_subset()
    prep_gap = max(prep_gap, rel_gap(got.norm_post, ref.norm_post))
    norm_post = got.norm_post if "train" in forced else ref.norm_post
    w_ref = ref.train(norm_post)
    values = ref.values(norm_post)
    label_bad = 0
    for cell, kept, mask in zip(got.cell, got.kept, masks):
        want = np.asarray(mask).ravel()[kept]
        label_bad += len(kept) if cell is None else int(np.sum(cell != want))
    # rows both sides kept (all of them unless kept_unexcused > 0)
    rows = [np.intersect1d(a, b, return_indices=True) for a, b in zip(got.kept, ref.kept)]
    g_val = [v[ia] for v, (_, ia, _) in zip(got.values, rows)]
    r_val = [v[ib] for v, (_, _, ib) in zip(values, rows)]
    g_som = [v[ia] for v, (_, ia, _) in zip(got.som, rows)]
    g_meta = [v[ia] for v, (_, ia, _) in zip(got.meta, rows)]
    value_gap = max(column_gap(a, b) for a, b in zip(g_val, r_val))
    # every label must be the nearest node of the plain weights, near ties
    # excused (there the job's label stands)
    bmu_bad, n_px, som_ref = 0, 0, []
    w2 = torch.sum(torch.as_tensor(w_ref, device=device) ** 2, 1)
    for (lab, d), g_lab, v in zip(ref.labels(w_ref, r_val), g_som, r_val):
        g = torch.as_tensor(g_lab, device=device)
        n_px += len(g_lab)
        ok_ids = (g >= 1) & (g <= d.shape[1])
        gi = torch.clamp(g - 1, 0, d.shape[1] - 1)
        d_got = torch.gather(d, 1, gi[:, None])[:, 0]
        d_best = torch.gather(d, 1, (lab - 1)[:, None])[:, 0]
        x2 = torch.as_tensor(np.sum(v * v, 1), device=device, dtype=torch.float32)
        tie = (d_got - d_best) <= BMU_TIE_RTOL * (x2 + w2[lab - 1])
        bad = (g != lab) & ~(tie & ok_ids)
        bmu_bad += int(torch.sum(bad))
        som_ref.append(torch.where(bad, lab, g).cpu().numpy())
    som_share = bmu_bad / max(n_px, 1)
    ids = np.unique(np.concatenate(som_ref))
    som_avg = ref.averages(r_val, som_ref, ids)
    meta_ref = _lookup(ids, ref.ward(som_avg) + 1, som_ref)
    meta_share = partition_mismatch(np.concatenate(g_meta), np.concatenate(meta_ref))
    # meta averages: the plain groups under the job's numbering, where each
    # plain group carries one job label
    got_meta = np.concatenate(g_meta)
    base = int(got_meta.max()) + 1
    keys = np.unique(np.concatenate(meta_ref) * base + got_meta)
    pairs = np.stack([keys // base, keys % base])
    meta_gap = 1.0
    if len(np.unique(pairs[0])) == pairs.shape[1]:
        meta_avg = ref.averages(r_val, _lookup(pairs[0], pairs[1], meta_ref),
                                np.unique(pairs[1]))
        meta_gap = _table_gap(got.meta_avg, meta_avg)
    return {
        "prep_gap": prep_gap,
        "label_mismatch": float(label_bad),
        "kept_unexcused": float(kept_unexcused),
        "value_gap": value_gap,
        "weight_gap": rel_gap(got.weights, w_ref),
        "som_unexcused": som_share,
        "avg_gap": max(_table_gap(got.som_avg, som_avg), meta_gap),
        "meta_mismatch": meta_share,
        "norm_pre_bitwise": float(np.array_equal(got.norm_pre, ref.norm_pre)
                                  and got.thresh == ref.thresh),
        "norm_post_bitwise": float(np.array_equal(got.norm_post, ref.norm_post)),
    }


def _lookup(keys, vals, arrays):
    """Each array's entries mapped through keys -> vals."""
    lut = np.zeros(int(np.max(keys)) + 1, np.int64)
    lut[np.asarray(keys, np.int64)] = vals
    return [lut[a] for a in arrays]


def _table_gap(got, want) -> float:
    """Gap of two (id, channels..., count) tables over the ids both hold:
    the channel columns' gap and the counts' relative gap; 1 when the ids
    differ."""
    common, ig, iw = np.intersect1d(got[:, 0], want[:, 0], return_indices=True)
    if len(common) == 0:
        return float("inf")
    gap = max(column_gap(got[ig, 1:-1], want[iw, 1:-1]),
              rel_gap(got[ig, -1], want[iw, -1]))
    return gap if len(common) == len(got) == len(want) else max(gap, 1.0)
