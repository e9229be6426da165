"""Classical image filters for the fiber and ez_seg pipelines, in torch ops.

Port of ``ark_tpu/ops/classical.py``: CLAHE, Frangi vesselness, the Sobel
elevation map, multi-Otsu thresholds, the Gaussian-weighted local threshold
and the Meijering ridge filter. Hessians and gradients are separable
Gaussian-derivative convolutions (``image_filters.correlate1d``, one multiply
and one add per tap in tap order, so the CPU and the card sum alike); CLAHE
is a bincount, a cumsum and a gather; multi-Otsu is a dynamic program over a
256-entry histogram on the host.

Numerics. The JAX package runs these as jitted XLA programs, whose CPU
backend contracts multiply-adds and sums a convolution's taps in an order of
its own, so the floats agree within a stated tolerance (the port's tests
hold each function to rtol 1e-5 with an atol of 1e-6 of its scale), not
bitwise. Between the CPU and the card the port keeps what it can equal:
square roots are the correctly rounded ``distances._sqrt`` (torch's own CPU
sqrt is not, and its first call of a process has been off by 3e-4), and
CLAHE's sums of 256 bins run in f64 and round once, which no summation order
changes, and so does Frangi's ``exp`` (the f64 result rounded to f32 is the
same wherever the devices' f64 ``exp`` differ in their last bits only).

Every function works on the device of the tensor it is given; the functions
that take numpy arrays take a `device` (default "cuda") and return numpy.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ark_tpu_torch.ops.distances import _fma_square, _sqrt
from ark_tpu_torch.ops.image_filters import (_symmetric_index, correlate1d,
                                             gaussian_blur)
from ark_tpu_torch.ops.som import _as_f32_tensor as _as_f32


def _gaussian_derivative_kernel1d(sigma: float, order: int,
                                  truncate: float = 4.0) -> np.ndarray:
    """1-D Gaussian derivative taps (order 0, 1 or 2), scipy-compatible."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    if order == 0:
        return g.astype(np.float32)
    if order == 1:
        return (-x / sigma ** 2 * g).astype(np.float32)
    return (((x ** 2 - sigma ** 2) / sigma ** 4) * g).astype(np.float32)


def _sep_conv(img: torch.Tensor, krow: np.ndarray, kcol: np.ndarray) -> torch.Tensor:
    """Separable 2-D convolution with symmetric boundary: `krow` along the
    rows' axis, then `kcol` along the columns'. A true convolution, so the
    correlation gets the reversed taps: the antisymmetric derivative taps
    would otherwise flip the result's sign."""
    x = correlate1d(img.to(torch.float32), krow[::-1], axis=0)
    return correlate1d(x, kcol[::-1], axis=1)


def _recip(c: float) -> float:
    """1 / c rounded in f32. XLA divides by a constant as a multiply by this
    reciprocal, and so does torch on the card (a true division on the CPU):
    the port multiplies everywhere, so that the devices agree."""
    return float(np.float32(1.0) / np.float32(c))


def sobel(img: torch.Tensor) -> torch.Tensor:
    """Sobel gradient-magnitude elevation map (skimage's normalization: the
    smoothing tap is [1, 2, 1] / 4, the derivative tap the unscaled
    [1, 0, -1], the magnitude divided by sqrt 2)."""
    smooth = np.array([1.0, 2.0, 1.0], np.float32) / 4.0
    diff = np.array([1.0, 0.0, -1.0], np.float32)
    gy = _sep_conv(img, diff, smooth)
    gx = _sep_conv(img, smooth, diff)
    # fma(gx, gx, gy * gy): XLA's CPU contraction of the jitted reference,
    # and one rounding rule for every device
    return _sqrt(_fma_square(gx, gy * gy)) * _recip(np.sqrt(np.float32(2.0)))


def multi_otsu(img: np.ndarray, classes: int = 3,
               nbins: int = 256) -> np.ndarray:
    """Multi-Otsu thresholds for any number of classes (skimage
    `threshold_multiotsu` semantics).

    Maximizes the between-class variance sum m_k^2 / w_k over all placements
    of `classes - 1` cuts by dynamic programming on histogram prefix sums,
    O(classes nbins^2), so classes >= 4 are exact. Each returned threshold
    is the bin center of the first bin of the class above the cut. Host
    numpy: the search runs on the 256-entry histogram."""
    if classes < 2:
        raise ValueError("multi_otsu requires classes >= 2")
    img = np.asarray(img, np.float64).ravel()
    lo, hi = img.min(), img.max()
    if hi <= lo:
        return np.array([lo] * (classes - 1))
    hist, bin_edges = np.histogram(img, bins=nbins, range=(lo, hi))
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    p = hist / hist.sum()
    W = np.concatenate([[0.0], np.cumsum(p)])
    M = np.concatenate([[0.0], np.cumsum(p * centers)])
    # S[a, b] = m^2 / w of the class spanning bins [a, b) (0 if massless);
    # only a < b is a legal (non-empty) class span
    wseg = W[None, :] - W[:, None]
    mseg = M[None, :] - M[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        S = np.where(wseg > 0, mseg * mseg / np.where(wseg > 0, wseg, 1.0),
                     0.0)
    edge = np.arange(nbins + 1)
    S = np.where(edge[:, None] < edge[None, :], S, -np.inf)

    # best[b] = max objective for the classes so far covering bins [0, b);
    # one argmax table per added cut for backtracking
    best = S[0]
    cut_arg = []
    for _ in range(classes - 1):
        tot = best[:, None] + S                  # (cut t, end b)
        arg = np.argmax(tot, axis=0)             # ties -> lowest cut
        cut_arg.append(arg)
        best = tot[arg, edge]
    cuts = []
    b = nbins
    for arg in reversed(cut_arg):
        b = int(arg[b])
        cuts.append(b)
    cuts = cuts[::-1]
    return centers[np.array(cuts)]


def _clahe_device(img: torch.Tensor, th: int, tw: int, n_tr: int, n_tc: int,
                  clip_limit: float, nbins: int) -> torch.Tensor:
    """CLAHE core on `img`'s device: per-tile histograms as one bincount
    (integer counts, exact in any order), clipped cdf transfer functions,
    bilinear blend of the 4 surrounding tiles."""
    h, w = img.shape
    ph, pw = n_tr * th, n_tc * tw
    dev = img.device
    x = img.to(torch.float32)
    padded = x[_symmetric_index(h, 0, dev, after=ph - h)][
        :, _symmetric_index(w, 0, dev, after=pw - w)]

    bins = torch.clamp((padded * (nbins - 1)).to(torch.int32), 0, nbins - 1)
    tr = torch.arange(ph, dtype=torch.int32, device=dev) // th
    tc = torch.arange(pw, dtype=torch.int32, device=dev) // tw
    tile_idx = tr[:, None] * n_tc + tc[None, :]
    flat = (tile_idx * nbins + bins).reshape(-1).long()
    hists = torch.bincount(flat, minlength=n_tr * n_tc * nbins).to(
        torch.float32).reshape(n_tr, n_tc, nbins)

    # clip_limit * th * tw in f32, product by product, as the reference's
    # traced f32 scalar rounds it
    clip = max(float(np.float32(clip_limit) * np.float32(th) * np.float32(tw)), 1.0)
    # the sums over a tile's 256 bins run in f64 and round once to f32: the
    # same on every device, whatever the order
    excess = torch.clamp_min(hists - clip, 0).sum(dim=2, keepdim=True,
                                                  dtype=torch.float64).to(torch.float32)
    hists = torch.clamp_max(hists, clip) + excess * _recip(nbins)
    cdf = torch.cumsum(hists, dim=2, dtype=torch.float64).to(torch.float32)
    cdf = cdf / cdf[:, :, -1:]                                   # (tr, tc, B)

    yy = (torch.arange(ph, dtype=torch.float32, device=dev) + 0.5) * _recip(th) - 0.5
    xx = (torch.arange(pw, dtype=torch.float32, device=dev) + 0.5) * _recip(tw) - 0.5
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, n_tr - 1)
    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, n_tc - 1)
    y1 = torch.clamp(y0 + 1, 0, n_tr - 1)
    x1 = torch.clamp(x0 + 1, 0, n_tc - 1)
    fy = torch.clamp(yy - y0, 0, 1)[:, None]
    fx = torch.clamp(xx - x0, 0, 1)[None, :]

    b = bins.long()
    c00 = cdf[y0[:, None], x0[None, :], b]
    c01 = cdf[y0[:, None], x1[None, :], b]
    c10 = cdf[y1[:, None], x0[None, :], b]
    c11 = cdf[y1[:, None], x1[None, :], b]
    out = ((1 - fy) * ((1 - fx) * c00 + fx * c01)
           + fy * ((1 - fx) * c10 + fx * c11))
    return out[:h, :w]


def _clahe_geometry(h: int, w: int, kernel_size):
    """Static tile geometry (th, tw, n_tr, n_tc) shared by the host-facing
    CLAHE wrapper and the fiber pipeline."""
    if kernel_size is None:
        kernel_size = (h // 8, w // 8)
    if np.isscalar(kernel_size):
        kernel_size = (int(kernel_size), int(kernel_size))
    th = max(int(round(kernel_size[0])), 2)
    tw = max(int(round(kernel_size[1])), 2)
    n_tr = max(-(-h // th), 1)
    n_tc = max(-(-w // tw), 1)
    return th, tw, n_tr, n_tc


def equalize_adapthist(img, kernel_size=None, clip_limit: float = 0.01,
                       nbins: int = 256, *, device="cuda") -> np.ndarray:
    """CLAHE: tile-wise clipped histogram equalization with bilinear blending
    of neighboring tile transfer functions, on `device`. Input in [0, 1];
    output in [0, 1], float64 numpy (skimage `equalize_adapthist`)."""
    arr = _as_f32(img, device)
    h, w = arr.shape
    th, tw, n_tr, n_tc = _clahe_geometry(h, w, kernel_size)
    out = _clahe_device(arr, th, tw, n_tr, n_tc, float(clip_limit), int(nbins))
    return out.cpu().numpy().astype(np.float64)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp through f64: the devices' own f32 ``exp`` differ in the last
    bit, their f64 results rounded to f32 all but never."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def _hessian_eigvals(img: torch.Tensor, sigma: float):
    """Scale-normalized Hessian eigenvalues (l1, l2 with |l1| <= |l2|)."""
    g0 = _gaussian_derivative_kernel1d(sigma, 0)
    g1 = _gaussian_derivative_kernel1d(sigma, 1)
    g2 = _gaussian_derivative_kernel1d(sigma, 2)
    s2 = sigma ** 2
    hrr = _sep_conv(img, g2, g0) * s2
    hcc = _sep_conv(img, g0, g2) * s2
    hrc = _sep_conv(img, g1, g1) * s2
    tmp = _sqrt((hrr - hcc) ** 2 + 4 * hrc ** 2)
    mu1 = (hrr + hcc + tmp) / 2
    mu2 = (hrr + hcc - tmp) / 2
    # order by absolute value
    swap = torch.abs(mu1) > torch.abs(mu2)
    l1 = torch.where(swap, mu2, mu1)
    l2 = torch.where(swap, mu1, mu2)
    return l1, l2


def _frangi_device(x: torch.Tensor, sigmas, beta: float = 0.5,
                   gamma: float = 15.0) -> torch.Tensor:
    """Frangi core (bright ridges) on `x`'s device: max over scales of
    exp(-R_b^2 / 2 beta^2) (1 - exp(-S^2 / 2 gamma^2)) on ridge-signed
    Hessian eigenvalues."""
    out = None
    for sigma in sigmas:
        l1, l2 = _hessian_eigvals(x, float(sigma))
        rb2 = (l1 / torch.where(l2 == 0, 1e-10, l2)) ** 2
        s2 = l1 ** 2 + l2 ** 2
        v = _exp(-rb2 * _recip(2 * beta ** 2)) * \
            (1 - _exp(-s2 * _recip(2 * gamma ** 2)))
        v = torch.where(l2 < 0, v, 0.0)   # bright ridges: l2 negative
        out = v if out is None else torch.maximum(out, v)
    return out


def frangi(img, sigmas: Iterable[float] = (1, 3, 5, 7, 9),
           black_ridges: bool = False, beta: float = 0.5,
           gamma: float = 15.0, *, device="cuda") -> np.ndarray:
    """Frangi vesselness (see `_frangi_device`) on `device`; numpy out."""
    x = _as_f32(np.asarray(img), device)
    if black_ridges:
        x = -x
    return _frangi_device(x, sigmas, beta, gamma).cpu().numpy()


def meijering(img, sigmas: Iterable[float] = (1, 3, 5, 7, 9),
              black_ridges: bool = False, *, device="cuda") -> np.ndarray:
    """Meijering neuriteness ridge filter on `device`: max over scales of
    the normalized modified-Hessian minimum eigenvalue; numpy out."""
    x = _as_f32(np.asarray(img), device)
    if black_ridges:
        x = -x
    out = None
    for sigma in sigmas:
        l1, l2 = _hessian_eigvals(x, float(sigma))
        # modified eigenvalues: m = l + l_other / 3
        m1 = l1 + l2 * _recip(3.0)
        m2 = l2 + l1 * _recip(3.0)
        mmin = torch.minimum(m1, m2)
        v = torch.where(mmin < 0, -mmin, 0.0)
        out = v if out is None else torch.maximum(out, v)
    mx = torch.max(out)
    out = torch.where(mx > 0, out / mx, out)
    return out.cpu().numpy()


def local_adaptive_threshold(img: np.ndarray, block_size: int,
                             offset: float = 0.0, *, device="cuda") -> np.ndarray:
    """Gaussian-weighted local threshold (skimage threshold_local
    'gaussian'): pixel > local_mean - offset, the mean blurred on `device`."""
    sigma = (block_size - 1) / 6.0
    local_mean = gaussian_blur(_as_f32(img, device), sigma=sigma).cpu().numpy()
    return np.asarray(img) > (local_mean - offset)
