"""Plain Pixie cell clustering (ark-analysis template 3), and the judge that
holds a job's files to it.

The stage, as ark-analysis defines it (Liu et al. 2023; its
``cell_cluster_utils``, ``cell_som_clustering``, ``cell_meta_clustering``,
``weighted_channel_comp`` and ``cluster_helpers``), with the batch-SOM
schedule of this repository's pipeline (256 minibatch steps, FlowSOM's
seeded start rows and visiting order, bubble neighbourhood):

1. counts: per FOV, each (cell label, pixel cluster) pair's pixels among
   the FOV's pixel-feather rows with a label above 0, by ``np.add.at``; the
   cluster columns are the sorted cluster ids seen in any FOV's pixels;
2. the cells: the cell table's rows of the job's FOVs in the table's order,
   their counts joined by (fov, label); cells with no counted pixel
   dropped; a cluster column no kept cell holds dropped; the counts divided
   by ``cell_size``;
3. each column divided by its 0.999 quantile of nonzero values (pandas'
   ``replace(0, nan).quantile``, linear);
4. the SOM (``portbench/reference/pixie.py``'s ``train``) on those values
   in float32; every cell mapped to its nearest node;
5. per SOM cluster the columns' means and the count; Ward linkage of the
   z-scored means (capped at +-cap) cut into max_k meta clusters
   (``pixie.py``'s ``ward``); per meta cluster the means and the count;
6. the weighted channel table: each cell's counts (float32, the columns in
   string order) times the pixel clusters' channel averages (float32, the
   rows in the same order), over ``cell_size``; its channel means per SOM
   and per meta cluster.

Products run in float32 with TF32 off, or with TF32 on for the control.
Departures from ark-analysis: the SOM is this repository's batch schedule,
not FlowSOM's online one (as in ``pixie.py``); consensus clustering with
``L = K = max_k`` runs no resampling, so the meta clusters are the Ward cut
alone; cluster ids are integers (the metacluster GUI's untouched names read
back as integers). Imports nothing of the program. What the judge reads of
a job is its files.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch

from portbench.reference import pixie
from portbench.reference.compare import column_gap, partition_mismatch, rel_gap

COUNTS = "cluster_counts.feather"
CELL_DATA = "cluster_counts_size_norm.feather"
WEIGHTS = "cell_som_weights.feather"
SOM_COUNT_AVG = "cell_som_cluster_count_avg.csv"
META_COUNT_AVG = "cell_meta_cluster_count_avg.csv"
WEIGHTED = "weighted_cell_channel.feather"
SOM_CHANNEL_AVG = "cell_som_cluster_channel_avg.csv"
META_CHANNEL_AVG = "cell_meta_cluster_channel_avg.csv"
PIXEL_META_AVG = "pixel_channel_avg_meta_cluster.csv"
KEY = ["fov", "label"]
# a node whose squared distance lies within this share of (|x|^2 + |w|^2)
# of the best may be picked instead
BMU_TIE_RTOL = pixie.BMU_TIE_RTOL


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 off (on for the control), for matmuls and
    cuDNN alike."""
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with pixie.matmul_precision(tf32):
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn


@dataclass
class Outputs:
    """A job's tables: the counts, the labelled normalized cells, the SOM
    weights (columns as trained), the count averages, the weighted table
    and its channel averages."""
    counts: pd.DataFrame
    cells: pd.DataFrame
    weights: pd.DataFrame
    som_avg: pd.DataFrame
    meta_avg: pd.DataFrame
    weighted: pd.DataFrame
    wc_som: pd.DataFrame
    wc_meta: pd.DataFrame


def _feather(path, columns=None) -> pd.DataFrame:
    """A feather file (memory-mapped) as pandas, or only its `columns`."""
    import pyarrow as pa

    with pa.memory_map(path) as src:
        table = pa.ipc.open_file(src).read_all()
        return (table if columns is None else table.select(columns)).to_pandas()


def read_job(base_dir: str) -> Outputs:
    """A finished run_cell_clustering job's files as Outputs."""
    def csv(name):
        return pd.read_csv(os.path.join(base_dir, name), float_precision="round_trip")

    def fe(name):
        return _feather(os.path.join(base_dir, name))
    return Outputs(counts=fe(COUNTS), cells=fe(CELL_DATA), weights=fe(WEIGHTS),
                   som_avg=csv(SOM_COUNT_AVG), meta_avg=csv(META_COUNT_AVG),
                   weighted=fe(WEIGHTED), wc_som=csv(SOM_CHANNEL_AVG),
                   wc_meta=csv(META_CHANNEL_AVG))


def _keys(t: pd.DataFrame) -> list:
    return list(zip(t["fov"].astype(str), t["label"].to_numpy(np.int64)))


def _means(values: np.ndarray, labels: np.ndarray):
    """(sorted ids, per-id means of the rows of `values` in float64, counts)."""
    ids, inv = np.unique(labels, return_inverse=True)
    sums = np.zeros((len(ids), values.shape[1]))
    np.add.at(sums, inv, values)
    counts = np.bincount(inv, minlength=len(ids)).astype(np.float64)
    return ids, sums / counts[:, None], counts


class CellReference:
    """The plain stage over a job's input files: the pixel feathers under
    `pixel_dir`, the cell table CSV and template 2's pixel-cluster channel
    averages."""

    def __init__(self, pixel_dir, cell_table_path, pixel_avg_path, fovs, channels,
                 cfg: dict, device, tf32: bool = False):
        self.pixel_dir = pixel_dir
        self.cell_table_path = cell_table_path
        self.pixel_avg_path = pixel_avg_path
        self.fovs = list(fovs)
        self.channels = list(channels)
        self.cfg = cfg
        self.col = cfg["pixel_cluster_col"]
        self.device = torch.device(device)
        self.tf32 = tf32
        self._pixie = pixie.PixelReference(None, [], cfg, device, tf32)

    def counts(self) -> pd.DataFrame:
        """Steps 1-2: the kept cells' (fov, label, cell_size, integer counts)
        in the program's row and column order."""
        table = pd.read_csv(self.cell_table_path, usecols=["fov", "label", "cell_size"])
        table["fov"] = table["fov"].astype(str)
        table = table[table["fov"].isin(self.fovs)].reset_index(drop=True)
        per_fov, ids = {}, set()
        for fov in self.fovs:
            px = _feather(os.path.join(self.pixel_dir, f"{fov}.feather"),
                          columns=["label", self.col])
            lab = px["label"].to_numpy(np.int64)
            clu = px[self.col].to_numpy(np.int64)
            per_fov[fov] = (lab, clu)
            ids.update(np.unique(clu).tolist())
        ids = np.array(sorted(ids), np.int64)
        counts = np.zeros((len(table), len(ids)), np.int64)
        for fov, (lab, clu) in per_fov.items():
            inside = lab > 0
            lab, idx = lab[inside], np.searchsorted(ids, clu[inside])
            grid = np.zeros((int(lab.max(initial=0)) + 1, len(ids)), np.int64)
            np.add.at(grid, (lab, idx), 1)
            rows = np.flatnonzero((table["fov"] == fov).to_numpy())
            labels = table["label"].to_numpy(np.int64)[rows]
            ok = labels < grid.shape[0]
            counts[rows[ok]] = grid[labels[ok]]
        kept = counts.sum(axis=1) > 0
        held = counts[kept].any(axis=0)
        cols = [f"{self.col}_{i}" for i in ids[held]]
        out = table[kept].reset_index(drop=True)
        out[cols] = counts[kept][:, held]
        return out

    def normalized(self, counts: pd.DataFrame) -> pd.DataFrame:
        """Step 3 on the size-normalized counts: the SOM's input, float64."""
        cols = self.count_cols(counts)
        sized = counts[cols].to_numpy(np.float64) / \
            counts["cell_size"].to_numpy(np.float64)[:, None]
        frame = pd.DataFrame(sized, columns=cols)
        quant = frame.replace(0, np.nan).quantile(q=0.999, axis=0).to_numpy(np.float64)
        out = counts[KEY + ["cell_size"]].copy()
        out[cols] = sized / quant
        return out

    def count_cols(self, t: pd.DataFrame) -> list:
        return [c for c in t.columns if c.startswith(self.col + "_")]

    def train(self, cells: pd.DataFrame) -> np.ndarray:
        """Step 4's training on the normalized cells; (K, C) float32."""
        cols = self.count_cols(cells)
        self._pixie.subset_rows = cells[cols].to_numpy(np.float64)
        with precision(self.tf32):
            return self._pixie.train(np.ones(len(cols)))

    def nearest(self, weights: np.ndarray, cells: pd.DataFrame):
        """1-indexed nearest nodes and every squared distance (a tensor)."""
        x = cells[self.count_cols(cells)].to_numpy(np.float64)
        with precision(self.tf32):
            ((lab, d),) = self._pixie.labels(weights, [x])
        return lab, d

    def ward(self, som_ids, som_means) -> np.ndarray:
        """Step 5's cut: meta cluster (0-based) of each SOM cluster row."""
        table = np.column_stack([som_ids, som_means, np.zeros(len(som_ids))])
        return self._pixie.ward(table)

    def weighted(self, counts: pd.DataFrame) -> np.ndarray:
        """Step 6's product over `counts`' rows: (cells, channels) float64."""
        cols = sorted(self.count_cols(counts))
        avg = pd.read_csv(self.pixel_avg_path)
        key = avg[self.col].astype(str)
        by_id = {k: i for i, k in enumerate(key)}
        rows = [by_id[c[len(self.col) + 1:]] for c in cols]
        a = torch.as_tensor(counts[cols].to_numpy(np.float32), device=self.device)
        b = torch.as_tensor(avg[self.channels].to_numpy(np.float32)[rows],
                            device=self.device)
        with precision(self.tf32), torch.no_grad():
            prod = (a @ b).cpu().numpy()
        return prod.astype(np.float64) / counts["cell_size"].to_numpy(np.float64)[:, None]

    def run(self) -> Outputs:
        """The whole stage from its own state, as a job would produce it (the
        control)."""
        counts = self.counts()
        cells = self.normalized(counts)
        cols = self.count_cols(cells)
        w = self.train(cells)
        som = self.nearest(w, cells)[0].cpu().numpy()
        ids, means, n = _means(cells[cols].to_numpy(np.float64), som)
        meta_of = self.ward(ids, means) + 1
        meta = _lookup(ids, meta_of, som)
        m_ids, m_means, m_n = _means(cells[cols].to_numpy(np.float64), meta)
        cells = cells.assign(cell_som_cluster=som, cell_meta_cluster=meta)
        wt = self.weighted(counts)
        weighted = pd.DataFrame(wt, columns=self.channels)
        weighted[["cell_size", "fov", "label"]] = counts[["cell_size", "fov", "label"]]
        ws_ids, ws_means, _ = _means(wt, som)
        wm_ids, wm_means, _ = _means(wt, meta)
        som_avg = pd.DataFrame(means, columns=cols).assign(count=n)
        som_avg.insert(0, "cell_som_cluster", ids)
        som_avg["cell_meta_cluster"] = meta_of
        meta_avg = pd.DataFrame(m_means, columns=cols).assign(count=m_n)
        meta_avg.insert(0, "cell_meta_cluster", m_ids)
        wc_som = pd.DataFrame(ws_means, columns=self.channels)
        wc_som.insert(0, "cell_som_cluster", ws_ids)
        wc_som["cell_meta_cluster"] = _lookup(ids, meta_of, [ws_ids])[0]
        wc_meta = pd.DataFrame(wm_means, columns=self.channels)
        wc_meta.insert(0, "cell_meta_cluster", wm_ids)
        return Outputs(counts=counts, cells=cells,
                       weights=pd.DataFrame(w, columns=cols), som_avg=som_avg,
                       meta_avg=meta_avg, weighted=weighted, wc_som=wc_som,
                       wc_meta=wc_meta)


def _lookup(keys, vals, arrays):
    """Each array's entries mapped through keys -> vals."""
    lut = np.zeros(int(np.max(keys)) + 1, np.int64)
    lut[np.asarray(keys, np.int64)] = vals
    return [lut[np.asarray(a, np.int64)] for a in arrays]


def _rows(got: pd.DataFrame, want: pd.DataFrame) -> int:
    """Rows whose (fov, label) differ from the reference's at the same
    place, and rows one side has beyond the other's end."""
    g, w = _keys(got), _keys(want)
    return abs(len(g) - len(w)) + sum(a != b for a, b in zip(g, w))


def _paired(got: pd.DataFrame, want: pd.DataFrame):
    """(got rows, want rows) index arrays of the (fov, label) pairs both
    hold."""
    m = want[KEY].assign(fov=want["fov"].astype(str), _w=np.arange(len(want))).merge(
        got[KEY].assign(fov=got["fov"].astype(str), _g=np.arange(len(got))), on=KEY)
    return m["_g"].to_numpy(), m["_w"].to_numpy()


def _table_gap(got_ids, got_vals, want_ids, want_vals) -> float:
    """Gap of two tables of per-cluster values over the ids both hold,
    each column relative to its largest; at least 1 when the ids differ."""
    common, ig, iw = np.intersect1d(got_ids, want_ids, return_indices=True)
    if len(common) == 0:
        return float("inf")
    gap = column_gap(np.asarray(got_vals, np.float64)[ig],
                     np.asarray(want_vals, np.float64)[iw])
    return gap if len(common) == len(got_ids) == len(want_ids) else max(gap, 1.0)


def judge(got: Outputs, ref: CellReference) -> dict:
    """The numbers ``correct`` compares. The plain stage runs from the job's
    input files through every step on its own values, and each step's
    result is compared with the job's:

    rows_mismatch   cells kept, dropped or out of order in the counts, the
                    labelled cells and the weighted table;
    count_mismatch  integer pixel counts that differ (every entry of the
                    paired rows when the count columns differ);
    norm_gap        the normalized cells, each column relative to itself;
    som_gap         the SOM weights against the plain training's;
    som_unexcused   share of cells whose SOM label is not the nearest node
                    of the plain weights, away from a near tie (within one
                    the job's label stands);
    meta_mismatch   share of cells whose meta label disagrees, as
                    partitions, with the Ward cut of the plain SOM means
                    (and with the SOM average table's meta column);
    avg_gap         the SOM and meta count-average tables;
    weighted_gap    the weighted table and its two channel-average tables."""
    counts = ref.counts()
    cells = ref.normalized(counts)
    cols = ref.count_cols(cells)
    rows = (_rows(got.counts, counts) + _rows(got.cells, counts)
            + _rows(got.weighted, counts))
    gi, wi = _paired(got.counts, counts)
    if ref.count_cols(got.counts) == cols:
        count_bad = float(np.sum(got.counts[cols].to_numpy(np.float64)[gi]
                                 != counts[cols].to_numpy(np.float64)[wi]))
    else:
        count_bad = float(max(len(gi), 1) * max(len(cols), 1))
    ci, cw = _paired(got.cells, cells)
    same_cols = ref.count_cols(got.cells) == cols
    norm_gap = column_gap(got.cells[cols].to_numpy(np.float64)[ci],
                          cells[cols].to_numpy(np.float64)[cw]) if same_cols \
        else float("inf")
    w_ref = ref.train(cells)
    som_gap = rel_gap(got.weights[cols].to_numpy(np.float64), w_ref) \
        if list(got.weights.columns) == cols else float("inf")

    # every label must be the nearest node of the plain weights, near ties
    # excused (there the job's label stands)
    lab, d = ref.nearest(w_ref, cells)
    want_som = lab.cpu().numpy().astype(np.int64)
    g_som = np.zeros(len(cells), np.int64)
    g_som[cw] = got.cells["cell_som_cluster"].to_numpy(np.int64)[ci]
    x = cells[cols].to_numpy(np.float64)
    g = torch.as_tensor(g_som, device=d.device)
    k = d.shape[1]
    gi_t = torch.clamp(g - 1, 0, k - 1)
    d_got = torch.gather(d, 1, gi_t[:, None])[:, 0]
    d_best = torch.gather(d, 1, (lab - 1)[:, None])[:, 0]
    w2 = torch.sum(torch.as_tensor(w_ref, device=d.device) ** 2, 1)
    x2 = torch.as_tensor(np.sum(x * x, 1), device=d.device, dtype=torch.float32)
    tie = (d_got - d_best) <= BMU_TIE_RTOL * (x2 + w2[lab - 1])
    bad = ((g != lab) & ~(tie & (g >= 1) & (g <= k))).cpu().numpy()
    som_share = float(bad.sum()) / max(len(cells), 1)
    som = np.where(bad, want_som, g_som)

    ids, means, n = _means(x, som)
    meta = _lookup(ids, ref.ward(ids, means) + 1, [som])[0]
    g_meta = np.zeros(len(cells), np.int64)
    g_meta[cw] = got.cells["cell_meta_cluster"].to_numpy(np.int64)[ci]
    meta_share = partition_mismatch(g_meta, meta)
    # the SOM average table's meta column, carried to the cells
    som_file_meta = dict(zip(got.som_avg["cell_som_cluster"].astype(np.int64),
                             got.som_avg["cell_meta_cluster"].astype(np.int64)))
    carried = np.array([som_file_meta.get(int(s), 0) for s in g_som], np.int64)
    meta_share = max(meta_share, partition_mismatch(carried, meta))

    # the plain meta groups under the job's numbering, where each plain
    # group carries one job label
    base = int(max(g_meta.max(initial=0), 0)) + 1
    keys = np.unique(meta * base + g_meta)
    pairs = np.stack([keys // base, keys % base])
    one_to_one = len(np.unique(pairs[0])) == pairs.shape[1] \
        and len(np.unique(pairs[1])) == pairs.shape[1]
    meta_job = _lookup(pairs[0], pairs[1], [meta])[0] if one_to_one else None

    som_tab = got.som_avg
    avg_gap = _table_gap(som_tab["cell_som_cluster"], som_tab[cols + ["count"]],
                         ids, np.column_stack([means, n])) if same_cols else float("inf")
    wt = ref.weighted(counts)
    wi_g, wi_w = _paired(got.weighted, counts)
    weighted_gap = column_gap(got.weighted[ref.channels].to_numpy(np.float64)[wi_g],
                              wt[wi_w])
    weighted_gap = max(weighted_gap, rel_gap(
        got.weighted["cell_size"].to_numpy(np.float64)[wi_g],
        counts["cell_size"].to_numpy(np.float64)[wi_w]))
    # the cells are the counts' rows, in their order
    ws_ids, ws_means, _ = _means(wt, som)
    weighted_gap = max(weighted_gap, _table_gap(
        got.wc_som["cell_som_cluster"], got.wc_som[ref.channels], ws_ids, ws_means))
    if meta_job is None:
        avg_gap = weighted_gap = max(avg_gap, weighted_gap, 1.0)
    else:
        m_ids, m_means, m_n = _means(x, meta_job)
        avg_gap = max(avg_gap, _table_gap(got.meta_avg["cell_meta_cluster"],
                                          got.meta_avg[cols + ["count"]],
                                          m_ids, np.column_stack([m_means, m_n]))
                      if same_cols else float("inf"))
        wm_ids, wm_means, _ = _means(wt, meta_job)
        weighted_gap = max(weighted_gap, _table_gap(
            got.wc_meta["cell_meta_cluster"], got.wc_meta[ref.channels], wm_ids, wm_means))
    return {"rows_mismatch": float(rows), "count_mismatch": count_bad,
            "norm_gap": norm_gap, "som_gap": som_gap, "som_unexcused": som_share,
            "meta_mismatch": meta_share, "avg_gap": avg_gap,
            "weighted_gap": weighted_gap}
