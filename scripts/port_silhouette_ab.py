"""The silhouette sweep's seconds on the card under three square roots.

    python scripts/port_silhouette_ab.py            (needs a CUDA card)

Builds the smoke's spatial cohort (10 FOVs x 3000 cells, 20 phenotypes), its
distance files and neighborhood matrix, as ``chip_smoke.py`` phase (c) does,
and times ``neighborhood_analysis.compute_cluster_metrics_silhouette``
(k = 2..10) with ``distances._sqrt_close`` set, in turns (raw, one step,
exact, exact, one step, raw, after one warm sweep), to: torch's raw f32
sqrt (what the block rested on before), the one f64 Newton step the port
runs, and the exact ``_sqrt`` (two steps and the midpoint test). Prints the
card's name and power limit, each sweep's seconds, and the largest relative
difference of the scores from the exact root's.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    import chip_smoke
    from ark_tpu_torch.analysis import neighborhood_analysis as na
    from ark_tpu_torch.analysis import spatial_analysis_utils as sau
    from ark_tpu_torch.ops import distances

    if not torch.cuda.is_available():
        print("this script needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.gpu_name_and_power()
    print(card)
    table = chip_smoke.spatial_cohort()
    with tempfile.TemporaryDirectory() as base:
        sau.calc_dist_matrix(table, base, device="cuda")
        counts, _ = na.create_neighborhood_matrix(
            table, base, distlim=chip_smoke.SPATIAL_TEMPLATE["distlim"], device="cuda")
    roots = {"raw": torch.sqrt, "one step": distances._sqrt_close, "exact": distances._sqrt}

    def sweep(name):
        distances._sqrt_close = roots[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = na.compute_cluster_metrics_silhouette(counts, device="cuda").values
        torch.cuda.synchronize()
        return time.perf_counter() - t0, np.asarray(scores, np.float64)

    sweep("one step")                                                   # warm-up
    seconds, scores = {name: [] for name in roots}, {}
    for name in ("raw", "one step", "exact", "exact", "one step", "raw"):
        s, scores[name] = sweep(name)
        seconds[name].append(s)
    distances._sqrt_close = roots["one step"]
    for name in roots:
        rel = float(np.max(np.abs(scores[name] - scores["exact"]) / np.abs(scores["exact"])))
        print(f"silhouette sweep k=2..10 on {len(counts)} cells [{card}], {name} root: "
              f"{seconds[name][0]:.4f} and {seconds[name][1]:.4f} s; largest relative "
              f"difference from the exact root's scores {rel:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
