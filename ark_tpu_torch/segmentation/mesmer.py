"""In-process Mesmer segmentation on PyTorch.

Port of ``ark_tpu/segmentation/mesmer.py``. The PanopticNet forward
(``ark_tpu_torch.models.unet``) runs on channel-stacked FOV batches on an
explicit ``device``; the deep-watershed instance postprocess runs either on
the host (``postprocess='host'``: scipy marker labeling and the native C++
priority flood per FOV, in a thread pool) or on the device
(``postprocess='device'``: local maxima, batched marker labeling, 256-level
quantization, the flood engine that ``ops.watershed._ENGINE`` selects, and
the small-object filter). On a CUDA device the level engine's claim rounds
run the hand-written claim kernel. The device path falls back to the host
flood only when a round budget reports non-convergence, as the reference
does; ``Mesmer.host_fallbacks`` counts those fallbacks.

Spans (``ark_tpu_torch.utils.profiling``): a ``mesmer.segment_fovs`` (or
``mesmer.predict``) root, a ``mesmer.<phase>`` child with device events for
each phase of the device path and its readback, and ``mesmer.host_post``
with one ``mesmer.host_flood`` a FOV in the host postprocess's pool.

Weights: an ``.npz`` checkpoint in the JAX package's format (its
``__config__`` names the architecture), an injected model, or seeded random
init of the full published configuration.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ark_tpu_torch.models import unet
from ark_tpu_torch.ops import cc, morphology
from ark_tpu_torch.ops import watershed as watershed_ops
from ark_tpu_torch.ops.quantiles import masked_order_stats
from ark_tpu_torch.utils import profiling

# the reference's device deep-watershed parameters (mesmer.py:31-39)
_DEVICE_WATERSHED_LEVELS = 256
_DEVICE_WATERSHED_BFS_ROUNDS = 32
_MARKER_TABLE = 2 ** 14 - 1
COMPARTMENTS = ("whole_cell", "nuclear")


def _lerp_fused(lo: torch.Tensor, hi: torch.Tensor, frac: float) -> torch.Tensor:
    """lo * (1 - frac) + hi * frac rounded as XLA's CPU backend rounds it
    inside the reference's jitted step: one fused multiply-add
    fma(lo, 1 - frac, hi * frac). The f64 product of two f32 values is
    exact, so the f64 sum rounded to f32 is the fused result (up to double
    rounding)."""
    w_lo = float(np.float32(1.0 - frac))
    w_hi = torch.tensor(np.float32(frac), device=hi.device)
    rounded = (hi * w_hi).to(torch.float64)
    return (lo.to(torch.float64) * w_lo + rounded).to(torch.float32)


def _percentile_normalize(batch: torch.Tensor) -> torch.Tensor:
    """Per-image, per-channel normalization to [0, 1] between the 0.1 and
    99.9 percentiles (linear interpolation, as jnp.percentile), on
    (B, H, W, C) f32."""
    b, h, w, c = batch.shape
    n = h * w
    flat = batch.permute(0, 3, 1, 2).reshape(b, c, n)
    stats = {}
    for q in (0.1, 99.9):
        pos = q / 100.0 * (n - 1)
        i0 = int(np.floor(pos))
        stats[q] = (i0, pos - i0)
    idxs = (stats[0.1][0], min(stats[0.1][0] + 1, n - 1),
            stats[99.9][0], min(stats[99.9][0] + 1, n - 1))
    # exact order statistics: the element the reference's 32-step bisection
    # on the float bits' monotone keys converges to, bit for bit
    ranks = torch.tensor(idxs, device=batch.device).expand(b * c, len(idxs))
    rows = flat.reshape(b * c, n).T                                # (n, b*c)
    os_ = masked_order_stats(rows, torch.ones_like(rows, dtype=torch.bool),
                             ranks).reshape(b, c, len(idxs))
    lo = _lerp_fused(os_[..., 0], os_[..., 1], stats[0.1][1])
    hi = _lerp_fused(os_[..., 2], os_[..., 3], stats[99.9][1])
    floor = torch.tensor(np.float32(1e-6), device=batch.device)
    return torch.clamp((batch - lo[:, None, None, :])
                       / torch.maximum(hi - lo, floor)[:, None, None, :], 0.0, 1.0)


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(value), device=device)


def _find_maxima(inner_distance: torch.Tensor, threshold: float = 0.1
                 ) -> torch.Tensor:
    """Local-maxima mask: pixels equal to their 3x3 max-pool (padded with
    -inf) and above threshold. (B, H, W) -> bool (B, H, W)."""
    pooled = F.max_pool2d(inner_distance[:, None], 3, 1, 1)[:, 0]
    return (inner_distance >= pooled) & (
        inner_distance > _f32(threshold, inner_distance.device))


class Mesmer:
    """Whole-cell + nuclear segmentation from (nuclear, membrane) images on
    `device`."""

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0,
                 dtype=None, model=None, *, device, timings: Optional[dict] = None):
        """Weights, in order of precedence: an injected `model`, an `.npz`
        checkpoint (its recorded dtype unless `dtype` is given), else the
        full published architecture with seeded random weights (bfloat16
        unless `dtype` is given). `timings`, when a dict, collects seconds
        per phase of every call (each phase then ends in a device
        synchronise)."""
        self.device = torch.device(device)
        if model is not None:
            self.model = model.to(self.device).eval()
        elif weights_path is not None:
            self.model = unet.model_from_npz(weights_path, dtype, device=self.device)
        else:
            self.model = unet.init_mesmer(
                seed, torch.bfloat16 if dtype is None else dtype, device=self.device)
        self.timings = timings
        self.host_fallbacks = 0

    @contextlib.contextmanager
    def _phase(self, name: str):
        if self.timings is None:
            yield
            return
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0

    def _span(self, name: str, **attrs):
        """The phase's span, beside `_phase`: it times the phase by device
        events and never synchronises."""
        return profiling.span("mesmer." + name, device=self.device, **attrs)

    def _forward(self, xn: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The network on normalized (B, H, W, 2) f32; f32 models run with
        TF32 off."""
        precision = unet.full_f32() if self.model.dtype == torch.float32 \
            else contextlib.nullcontext()
        with torch.inference_mode(), precision:
            return self.model(xn)

    def _upload(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch, np.float32)).to(self.device)

    def predict_raw(self, batch: np.ndarray) -> Dict[str, np.ndarray]:
        """Run the network on a (B, H, W, 2) batch; returns the semantic
        heads as numpy."""
        out = self._forward(_percentile_normalize(self._upload(batch)))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _segment_device(self, x: torch.Tensor, maxima_threshold: float):
        """Normalize, forward, and per compartment the inner distance, the
        foreground and the maxima, on the device."""
        with self._span("normalize"), self._phase("normalize"):
            xn = _percentile_normalize(x)
        with self._span("forward"), self._phase("forward"):
            out = self._forward(xn)
        res = {}
        with self._span("maxima"), self._phase("maxima"):
            for comp in COMPARTMENTS:
                inner = out[f"{comp}_inner_distance"][..., 0]
                res[comp] = {
                    "inner": inner,
                    # flood everywhere the net says 'not background'
                    "foreground": 1.0 - out[f"{comp}_pixelwise"][..., 2],
                    "maxima": _find_maxima(inner, maxima_threshold),
                }
        return res

    def _device_post(self, res, interior_threshold: float, min_cell_size: int):
        """The deep-watershed postprocess on the device: marker labeling,
        quantization, flood, small-object filter. Returns ({compartment:
        labels tensor}, converged)."""
        out = {}
        done = True
        for comp in COMPARTMENTS:
            with self._span("markers", comp=comp), self._phase("markers"):
                markers, _, m_done = cc.label_batched_small(res[comp]["maxima"])
            with self._span("quantize", comp=comp), self._phase("quantize"):
                fgmask = res[comp]["foreground"] > _f32(
                    interior_threshold, res[comp]["foreground"].device)
                q = watershed_ops._quantize(-res[comp]["inner"], fgmask,
                                            _DEVICE_WATERSHED_LEVELS)
            with self._span("flood", comp=comp), self._phase("flood"):
                lab, w_done = watershed_ops.flood(
                    q, markers, fgmask, _DEVICE_WATERSHED_LEVELS,
                    _DEVICE_WATERSHED_BFS_ROUNDS)
            with self._span("area_filter", comp=comp), self._phase("area_filter"):
                out[comp], a_ok = cc.area_filter_batched(
                    lab, min_area=min_cell_size, n_max=_MARKER_TABLE)
            done = done and m_done and w_done and a_ok
        return out, done

    def _postprocess_device_out(self, devres, interior_threshold: float,
                                min_cell_size: int) -> Dict[str, np.ndarray]:
        """Host deep-watershed postprocess of one `_segment_device` result:
        per-FOV floods in a thread pool (the native flood releases the
        GIL). Reading the tensors back is where the device is awaited."""
        import scipy.ndimage as ndi

        def postprocess_one(args):
            b, inner_b, foreground_b, maxima_b = args
            with profiling.span("mesmer.host_flood", parent=post, fov=b):
                markers, _ = ndi.label(maxima_b)
                mask = foreground_b > interior_threshold
                lab = watershed_ops.watershed(-inner_b, markers, mask)
                return morphology.remove_small_objects(lab, min_size=min_cell_size)

        labels = {}
        with profiling.span("mesmer.host_post") as post:
            for comp in COMPARTMENTS:
                inner = devres[comp]["inner"].cpu().numpy()
                foreground = devres[comp]["foreground"].cpu().numpy()
                maxima = devres[comp]["maxima"].cpu().numpy()
                work = [(b, inner[b], foreground[b], maxima[b])
                        for b in range(inner.shape[0])]
                with concurrent.futures.ThreadPoolExecutor() as pool:
                    batch_labels = list(pool.map(postprocess_one, work))
                labels[comp] = np.stack(batch_labels).astype(np.int32)
        return labels

    def predict(self, batch: np.ndarray, maxima_threshold: float = 0.1,
                interior_threshold: float = 0.3, min_cell_size: int = 15,
                postprocess: str = "host") -> Dict[str, np.ndarray]:
        """Segment a (B, H, W, 2) batch. postprocess='host' (default): the
        native priority flood per FOV. postprocess='device': the whole
        postprocess on the device (use it with trained weights: random
        weights give garbage relief with thousands of spurious maxima).
        Returns {'whole_cell': (B, H, W) int32, 'nuclear': (B, H, W) int32}."""
        if postprocess not in ("host", "device"):
            raise ValueError(f"postprocess must be 'host' or 'device', "
                             f"got {postprocess!r}")
        with profiling.span("mesmer.predict", fovs=len(batch)):
            x = self._upload(batch)
            if postprocess == "device":
                return self._finish_device_post(self._dispatch_device_post(
                    x, maxima_threshold, interior_threshold, min_cell_size))
            dev = self._segment_device(x, maxima_threshold)
            return self._postprocess_device_out(dev, interior_threshold, min_cell_size)

    def _dispatch_device_post(self, x, maxima_threshold, interior_threshold,
                              min_cell_size):
        """Forward and device postprocess of one batch; the labels stay on
        the device until `_finish_device_post` reads them."""
        res = self._segment_device(x, maxima_threshold)
        out, done = self._device_post(res, interior_threshold, min_cell_size)
        return out, done, x, maxima_threshold, interior_threshold, min_cell_size

    def _finish_device_post(self, pending) -> Dict[str, np.ndarray]:
        """Read a `_dispatch_device_post` result back; if a round budget
        reported non-convergence, the host flood gives the labels instead
        (counted in `host_fallbacks`)."""
        out, done, x, maxima_threshold, interior_threshold, min_cell_size = pending
        if done:
            with self._span("readback"):
                return {k: v.cpu().numpy().astype(np.int32) for k, v in out.items()}
        self.host_fallbacks += 1
        dev = self._segment_device(x, maxima_threshold)
        return self._postprocess_device_out(dev, interior_threshold, min_cell_size)


def segment_fovs(fov_images: np.ndarray, weights_path: Optional[str] = None,
                 batch_size: int = 4, app: Optional[Mesmer] = None, *, device,
                 **predict_kwargs) -> Dict[str, np.ndarray]:
    """Segment a stack of (N, H, W, 2) FOV images in device batches.

    With the host postprocess, batch i+1's device work is queued before
    batch i's host floods run, so the device overlaps the host. Pass `app`
    to reuse a Mesmer (`weights_path` and `device` then come from it)."""
    if app is None:
        app = Mesmer(weights_path=weights_path, device=device)
    maxima_threshold = predict_kwargs.pop("maxima_threshold", 0.1)
    interior_threshold = predict_kwargs.pop("interior_threshold", 0.3)
    min_cell_size = predict_kwargs.pop("min_cell_size", 15)
    postprocess = predict_kwargs.pop("postprocess", "host")
    if predict_kwargs:
        raise TypeError(f"unknown predict kwargs: {sorted(predict_kwargs)}")
    if fov_images.shape[0] == 0:
        raise ValueError("segment_fovs needs at least one FOV image")
    if postprocess not in ("host", "device"):
        raise ValueError(
            f"postprocess must be 'host' or 'device', got {postprocess!r}")

    whole, nuc = [], []

    def collect(out):
        whole.append(out["whole_cell"])
        nuc.append(out["nuclear"])

    with profiling.span("mesmer.segment_fovs", fovs=fov_images.shape[0]):
        pending = None
        for i in range(0, fov_images.shape[0], batch_size):
            x = app._upload(fov_images[i:i + batch_size])
            if postprocess == "device":
                collect(app._finish_device_post(app._dispatch_device_post(
                    x, maxima_threshold, interior_threshold, min_cell_size)))
                continue
            dev = app._segment_device(x, maxima_threshold)
            if pending is not None:
                collect(app._postprocess_device_out(pending, interior_threshold,
                                                    min_cell_size))
            pending = dev
        if pending is not None:
            collect(app._postprocess_device_out(pending, interior_threshold,
                                                min_cell_size))
    return {"whole_cell": np.concatenate(whole), "nuclear": np.concatenate(nuc)}
