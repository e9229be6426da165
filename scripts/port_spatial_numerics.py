"""Probes of the rounding facts the port's spatial ops are built on (CPU only).

    JAX_PLATFORMS=cpu python scripts/port_spatial_numerics.py [--processes 30]

Prints, for the installed jax and torch:
1. how often plain f32 sums of per-axis squares differ from the JAX
   package's jitted `squared_distances` (D = 2, 3, 4, coordinates in the
   far quarter of a 5000-px stage), and how often the fused rule
   s = fma(d0, d0, d1*d1), s = fma(dk, dk, s) does;
2. at D = 20, the largest difference between the port's and the JAX
   package's squared distances, in units of 2^-24 (|a|^2 + |b|^2);
3. in fresh processes, the largest relative error of torch's first f32
   sqrt call on a 3002 x 3002 matrix of squared distances, against numpy's
   correctly rounded sqrt, and in how many processes it passed 1e-6;
4. the relative error of the JAX package's f32 k-means inertia against the
   same partition's inertia in f64, on blobs of spread 4 and 8 (k = 7);
5. in fresh processes whose first torch call is the port's
   `silhouette_score(..., device="cpu")` on (3000, 20) rows in 6 clusters,
   its largest relative difference from the same function with the exact
   root (`distances._sqrt`), once as the port runs it (one f64 Newton step)
   and once resting on torch's raw sqrt.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIRST_SQRT = """
import numpy as np, torch
rng = np.random.default_rng(49)
p = torch.as_tensor(rng.uniform(0, 1024, (3002, 2)).astype(np.float32))
d0 = p[:, 0, None] - p[None, :, 0]
d1 = p[:, 1, None] - p[None, :, 1]
q = d0.to(torch.float64)
q = q.mul_(q).add_(d1.square_())
s = q.to(torch.float32)
r = torch.sqrt(s).numpy().astype(np.float64)
t = np.sqrt(s.numpy().astype(np.float64))
print(float(np.max(np.abs(r - t) / np.maximum(t, 1e-30))))
"""

FIRST_SILHOUETTE = """
import sys
import numpy as np, torch
from ark_tpu_torch.ops import distances
if sys.argv[1] == "raw":
    distances._sqrt_close = torch.sqrt
rng = np.random.default_rng(50)
centers = rng.poisson(4.0, (6, 20))
labels = rng.integers(0, 6, 3000)
x = (rng.poisson(centers[labels] + 1.0) + rng.random((3000, 20))).astype(np.float32)
first = distances.silhouette_score(x, labels, device="cpu")
distances._sqrt_close = distances._sqrt
exact = distances.silhouette_score(x, labels, device="cpu")
print(abs(first - exact) / abs(exact))
"""


def fused_share():
    import jax
    import jax.numpy as jnp
    import torch

    from ark_tpu.ops import distances as jd

    rng = np.random.default_rng(0)
    jitted = jax.jit(jd.squared_distances)
    for d in (2, 3, 4):
        a = (5000 * (0.75 + 0.25 * rng.random((700, d)))).astype(np.float32)
        b = (5000 * (0.75 + 0.25 * rng.random((600, d)))).astype(np.float32)
        want = np.asarray(jitted(jnp.asarray(a), jnp.asarray(b)))
        diffs = [torch.as_tensor(a[:, k, None] - b[None, :, k]) for k in range(d)]
        acc = diffs[0] * diffs[0]
        for x in diffs[1:]:
            acc = acc + x * x
        fused = (diffs[0].double() ** 2 + (diffs[1] * diffs[1]).double()).float()
        for x in diffs[2:]:
            fused = (x.double() ** 2 + fused.double()).float()
        print(f"D={d}: plain f32 sums differ from the jitted JAX function at "
              f"{np.mean(acc.numpy() != want):.1%} of entries, the fused rule at "
              f"{np.mean(fused.numpy() != want):.1%}")


def d20_units():
    import jax
    import jax.numpy as jnp
    import torch

    from ark_tpu.ops import distances as jd
    from ark_tpu_torch.ops import distances as td

    rng = np.random.default_rng(0)
    worst = 0.0
    for scale in (1.0, 30.0, 1000.0):
        a = (rng.random((500, 20)) * scale).astype(np.float32)
        b = (rng.random((400, 20)) * scale).astype(np.float32)
        b[:50] = a[:50] + rng.normal(0, 1e-3 * scale, (50, 20)).astype(np.float32)
        want = np.asarray(jax.jit(jd.squared_distances)(jnp.asarray(a), jnp.asarray(b)))
        got = td.squared_distances(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        norms = (a.astype(np.float64) ** 2).sum(1)[:, None] \
            + (b.astype(np.float64) ** 2).sum(1)
        worst = max(worst, float(np.max(np.abs(got.astype(np.float64) - want)
                                        / (norms * 2.0 ** -24))))
    print(f"D=20: port vs JAX squared distances differ by at most {worst:.1f} "
          f"units of 2^-24 (|a|^2 + |b|^2)")


def first_sqrt(processes):
    env = dict(os.environ, PYTHONPATH=REPO)
    errs = [float(subprocess.run([sys.executable, "-c", FIRST_SQRT], env=env,
                                 capture_output=True, text=True, check=True,
                                 timeout=300).stdout)
            for _ in range(processes)]
    print(f"torch's first f32 sqrt call: largest relative error {max(errs):.2g}; "
          f"{sum(e > 1e-6 for e in errs)} of {processes} fresh processes past 1e-6")


def first_silhouette(processes):
    env = dict(os.environ, PYTHONPATH=REPO)
    for root, name in (("newton", "one f64 Newton step (the port)"),
                       ("raw", "torch's raw sqrt")):
        errs = [float(subprocess.run([sys.executable, "-c", FIRST_SILHOUETTE, root],
                                     env=env, capture_output=True, text=True,
                                     check=True, timeout=300).stdout)
                for _ in range(processes)]
        print(f"first-call silhouette (3000, 20), {name}: largest relative "
              f"difference from the exact root {max(errs):.2g}; "
              f"{sum(e > 1e-5 for e in errs)} of {processes} fresh processes past "
              f"1e-5, {sum(e > 1e-7 for e in errs)} past 1e-7")


def kmeans_inertia():
    import jax.numpy as jnp

    from ark_tpu.ops import kmeans as jk

    for spread in (4.0, 8.0):
        rng = np.random.default_rng(12345)
        centers = rng.normal(0, spread, (4, 5))
        data = (centers[np.repeat(np.arange(4), 60)]
                + rng.normal(0, 0.5, (240, 5))).astype(np.float32)
        _, labels, inertia = jk.kmeans_fit_multi(jnp.asarray(data), 7, seed=42, n_init=3)
        x = data.astype(np.float64)
        labels = np.asarray(labels)
        exact = sum(((x[labels == c] - x[labels == c].mean(0)) ** 2).sum()
                    for c in np.unique(labels))
        print(f"k-means, blobs of spread {spread:g}, k=7: the JAX package's f32 "
              f"inertia is off by {abs(float(inertia) - exact) / exact:.2g} of it")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=30)
    args = ap.parse_args()
    fused_share()
    d20_units()
    first_sqrt(args.processes)
    kmeans_inertia()
    first_silhouette(args.processes)


if __name__ == "__main__":
    main()
