"""Inputs made from the seed: pixel-stage cohorts written as TIFF trees,
two-channel FOVs for segmentation, and the network's weights.

Everything large is drawn on the device with a ``torch.Generator`` seeded
from ``--seed``; only the small coarse fields come from numpy. The same seed
gives the same inputs on every card.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named use of the run's seed."""
    mixed = np.random.SeedSequence([seed % 2 ** 63, stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, stream])


# ---------------------------------------------------------------------------
# Pixel stage: MIBI-like counts, as chip_smoke.make_cohort draws them
# ---------------------------------------------------------------------------

def mibi_cohort(seed: int, n_fovs: int, size: int, n_channels: int, device):
    """Per FOV an (H, W, C) float32 numpy array of counts: per channel a smooth
    random intensity field (a coarse gamma grid upsampled) with Poisson
    noise; about a third of the pixels of a channel carry no signal."""
    cell = max(size // 32, 1)
    rng = host_rng(seed, 1)
    gen = generator(seed, 2, device)
    raws = []
    for _ in range(n_fovs):
        coarse = rng.gamma(0.6, 4.0, size=(size // cell, size // cell, n_channels))
        lam = torch.as_tensor(coarse, dtype=torch.float32, device=device)
        lam = lam.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
        raws.append(torch.poisson(lam, generator=gen).cpu().numpy())
    return raws


def tiff_bytes(img: np.ndarray) -> bytes:
    """A baseline little-endian TIFF of one 2-D float32 or int32 image: one
    uncompressed strip, the tags every reader needs."""
    img = np.ascontiguousarray(img, "<f4" if img.dtype.kind == "f" else "<i4")
    h, w = img.shape
    tags = [(256, 4, w), (257, 4, h), (258, 3, 32), (259, 3, 1), (262, 3, 1),
            (273, 4, 8), (277, 3, 1), (278, 4, h), (279, 4, img.nbytes),
            (339, 3, 3 if img.dtype.kind == "f" else 2)]
    ifd_at = 8 + img.nbytes
    out = [b"II*\x00", struct.pack("<I", ifd_at), img.tobytes(),
           struct.pack("<H", len(tags))]
    for code, typ, value in tags:
        fmt = "<HHIHH" if typ == 3 else "<HHII"
        out.append(struct.pack(fmt, code, typ, 1, value, 0) if typ == 3
                   else struct.pack(fmt, code, typ, 1, value))
    out.append(struct.pack("<I", 0))
    return b"".join(out)


def _write(path: str, img: np.ndarray) -> int:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = tiff_bytes(img)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def write_tree(tiff_dir: str, raws, fovs, channels, sub_folder: str = "") -> int:
    """tiff_dir/<fov>/<sub_folder>/<channel>.tiff for every FOV and channel;
    returns the bytes written."""
    return sum(_write(os.path.join(tiff_dir, fov, sub_folder, f"{chan}.tiff"), raw[..., ci])
               for fov, raw in zip(fovs, raws) for ci, chan in enumerate(channels))


def whole_cell_masks(seed: int, n_fovs: int, size: int, n_cells: int, radius: float,
                     device) -> list:
    """Per FOV an (H, W) int32 whole-cell mask, as Mesmer writes one: each
    pixel takes the nearest of `n_cells` seeded centres (numbered 1.. in
    drawing order) where that centre lies within `radius`, else 0."""
    gen = generator(seed, 7, device)
    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32),
                            indexing="ij")
    out = []
    for _ in range(n_fovs):
        centers = torch.rand(n_cells, 2, generator=gen, device=device) * size
        best = torch.full((size, size), float("inf"), device=device)
        label = torch.zeros((size, size), dtype=torch.int32, device=device)
        for lo in range(0, n_cells, 64):
            c = centers[lo:lo + 64]
            d2 = (yy[None] - c[:, 0, None, None]) ** 2 + (xx[None] - c[:, 1, None, None]) ** 2
            dmin, arg = torch.min(d2, dim=0)
            closer = dmin < best
            best = torch.where(closer, dmin, best)
            label = torch.where(closer, (arg + lo + 1).to(torch.int32), label)
        out.append(torch.where(best <= radius ** 2, label, 0).cpu().numpy())
    return out


def write_masks(seg_dir: str, masks, fovs, suffix: str) -> int:
    """seg_dir/<fov><suffix> for every FOV; returns the bytes written."""
    return sum(_write(os.path.join(seg_dir, fov + suffix), m) for fov, m in zip(fovs, masks))


# ---------------------------------------------------------------------------
# Segmentation: nuclear and membrane channels of crowded tissue
# ---------------------------------------------------------------------------

def tissue_fovs(seed: int, n_fovs: int, size: int, n_cells: int, device) -> np.ndarray:
    """(N, H, W, 2) float32: channel 0 nuclei (Gaussian blobs), channel 1
    membranes (rings around them), both with Poisson counts."""
    gen = generator(seed, 3, device)
    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32),
                            indexing="ij")
    out = []
    for _ in range(n_fovs):
        centers = torch.rand(n_cells, 2, generator=gen, device=device) * size
        radius = 4.0 + 3.0 * torch.rand(n_cells, generator=gen, device=device)
        nuc = torch.zeros(size, size, device=device)
        mem = torch.zeros(size, size, device=device)
        # blobs in chunks, so the (cells, H, W) distance stack stays small
        for lo in range(0, n_cells, 64):
            c = centers[lo:lo + 64]
            r = radius[lo:lo + 64, None, None]
            d2 = (yy[None] - c[:, 0, None, None]) ** 2 + (xx[None] - c[:, 1, None, None]) ** 2
            d = torch.sqrt(d2)
            nuc += torch.sum(torch.exp(-d2 / (2 * (0.6 * r) ** 2)), dim=0)
            mem += torch.sum(torch.exp(-((d - 1.8 * r) ** 2) / 4.0), dim=0)
        lam = torch.stack([8.0 * nuc + 0.2, 6.0 * mem + 0.2], dim=-1)
        out.append(torch.poisson(lam, generator=gen).cpu().numpy())
    return np.stack(out).astype(np.float32)


def panoptic_state(shapes, seed: int, device) -> dict:
    """A state dict for the given {name: shape} from one draw on the device:
    kernels lecun-normal (1 / sqrt(fan in)), biases small, batch norms near
    the identity with seeded statistics, the last norm of each bottleneck
    small, so that every layer moves the output."""
    gen = generator(seed, 4, device)
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        z = flat[at:at + n].reshape(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            fan_in = int(np.prod(shape[1:]))
            state[name] = z / fan_in ** 0.5
        elif leaf == "bias":
            state[name] = 0.02 * z
        elif leaf == "scale":
            last = name.split(".")[-2] == "BatchNorm_2" and "BottleneckBlock" in name
            state[name] = (0.25 if last else 1.0) + 0.05 * z
        elif leaf == "mean":
            state[name] = 0.05 * z
        elif leaf == "var":
            state[name] = 1.0 + 0.1 * torch.abs(z)
        else:
            raise ValueError(f"no rule for parameter {name}")
    return state


def calibrate_inner(cfg: dict, state: dict, image: np.ndarray, device) -> dict:
    """`state` with each inner-distance head's last layer scaled and shifted
    so that, over `image` (one (H, W, 2) FOV) as the plain float32 network
    computes it, the head's output before its activation has the standard
    deviation ``cfg["inner_logit_sd"]`` and exactly
    ``cfg["maxima_per_fov"]`` of its 3x3 local maxima lie above the maxima
    threshold. Seeded weights give a nearly flat relief whose level and
    roughness differ from seed to seed; calibrated, every seed's FOVs hold
    about as many instances as a deployment's (a thousand cells a FOV)."""
    from portbench.reference import panoptic

    net = panoptic.Net(cfg, state, device)
    x = torch.as_tensor(np.asarray(image, np.float32)[None], device=device)
    with panoptic.no_tf32(), torch.no_grad():
        out = net.forward(panoptic.percentile_normalize(x), logits=True)
    state = dict(state)
    k = cfg["maxima_per_fov"]
    for comp in cfg["compartments"]:
        z = out[f"{comp}_inner_logit"][0, ..., 0].to(torch.float64)
        peaks = z[z >= torch.nn.functional.max_pool2d(z[None, None], 3, 1, 1)[0, 0]]
        top = torch.sort(peaks, descending=True).values
        cut = float(top[k - 1] + top[k]) / 2
        gain = cfg["inner_logit_sd"] / float(z.std())
        w, b = f"{comp}_inner.dense_1.weight", f"{comp}_inner.dense_1.bias"
        state[w] = (state[w].to(torch.float64) * gain).to(state[w].dtype)
        state[b] = ((state[b].to(torch.float64) - cut) * gain
                    + cfg["maxima_threshold"]).to(state[b].dtype)
    del net, out
    return state
