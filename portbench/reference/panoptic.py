"""Plain PanopticNet (ResNet50 backbone, feature pyramid, semantic heads) and
Mesmer's deep-watershed postprocess, in torch ops and float32.

Written from the published description (Greenwald et al. 2022; deepcell-tf
``PanopticNet`` with ``Location2D`` inputs, keras ResNet50 v1 bottlenecks,
a feature pyramid over C3-C5, semantic heads of three 3x3 conv + x2
bilinear upsamplings then two channel-dense layers). Parameters are read by
the flax-path names of the checkpoint format (``ResNet50Backbone_0.
BottleneckBlock_3.Conv_1.weight``). Batch norm runs on its stored averages.
Convolutions and products run with TF32 off, unless a caller asks for the
lower-precision control: ``quant="fp8"`` rounds the input and the weight of
every convolution and dense layer to float8 e4m3 (per-tensor scale) before
a float32 product. Imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

BACKBONE_EPS = 1.001e-5
HEAD_EPS = 1e-3
N_CLASSES = {"inner": 1, "pixelwise": 3}


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter and stored average the configuration
    has, in the checkpoint format's names."""
    shapes = {}

    def conv(name, cin, cout, k, bias=True):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            shapes[f"{name}.bias"] = (cout,)

    def bn(name, c):
        for leaf in ("scale", "bias", "mean", "var"):
            shapes[f"{name}.{leaf}"] = (c,)

    def dense(name, cin, cout):
        shapes[f"{name}.weight"] = (cout, cin)
        shapes[f"{name}.bias"] = (cout,)

    dense("tensor_product", 4 if cfg["location"] else 2, 3)
    base = cfg["base_width"]
    conv("ResNet50Backbone_0.Conv_0", 3, base, 7, bias=False)
    bn("ResNet50Backbone_0.BatchNorm_0", base)
    c, idx = base, 0
    for i, blocks in enumerate(cfg["stage_sizes"]):
        f = base * 2 ** i
        for j in range(blocks):
            p = f"ResNet50Backbone_0.BottleneckBlock_{idx}"
            conv(f"{p}.Conv_0", c, f, 1, bias=False)
            bn(f"{p}.BatchNorm_0", f)
            conv(f"{p}.Conv_1", f, f, 3, bias=False)
            bn(f"{p}.BatchNorm_1", f)
            conv(f"{p}.Conv_2", f, 4 * f, 1, bias=False)
            bn(f"{p}.BatchNorm_2", 4 * f)
            if j == 0 or c != 4 * f:
                conv(f"{p}.Conv_3", c, 4 * f, 1, bias=False)
                bn(f"{p}.BatchNorm_3", 4 * f)
            c, idx = 4 * f, idx + 1
    fpn = cfg["fpn_channels"]
    widths = [base * 2 ** i * 4 for i in range(len(cfg["stage_sizes"]))]
    for level, cin in zip((3, 4, 5), widths[1:]):
        conv(f"FPN_0.C{level}_reduced", cin, fpn, 1)
        conv(f"FPN_0.P{level}", fpn, fpn, 3)
    conv("FPN_0.P6", widths[-1], fpn, 3)
    conv("FPN_0.P7", fpn, fpn, 3)
    up, dn = cfg["head_upsample_filters"], cfg["head_dense_features"]
    for comp in cfg["compartments"]:
        for head, n in N_CLASSES.items():
            p = f"{comp}_{head}"
            cin = fpn
            for i in range(3):
                conv(f"{p}.upsample_conv_{i}", cin, up, 3)
                cin = up
            dense(f"{p}.dense_0", up, dn)
            bn(f"{p}.bn_0", dn)
            dense(f"{p}.dense_1", dn, n)
    return shapes


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    amax = torch.clamp_min(t.abs().amax(), 1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Net:
    """The forward of one configuration over a state dict (f32 copies)."""

    def __init__(self, cfg: dict, state: dict, device, quant: str = "none"):
        self.cfg = cfg
        self.p = {k: v.detach().to(device=device, dtype=torch.float32)
                  for k, v in state.items()}
        self.quant = quant

    def _q(self, t):
        return fp8(t) if self.quant == "fp8" else t

    def conv(self, name, x, stride=1, pad=0):
        b = self.p.get(f"{name}.bias")
        return F.conv2d(self._q(x), self._q(self.p[f"{name}.weight"]), b, stride, pad)

    def dense(self, name, x):
        return F.linear(self._q(x), self._q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"])

    def bn(self, name, x, eps, dim=1):
        shape = [1] * x.ndim
        shape[dim] = -1
        p = self.p
        mul = p[f"{name}.scale"] / torch.sqrt(p[f"{name}.var"] + eps)
        return (x - p[f"{name}.mean"].reshape(shape)) * mul.reshape(shape) \
            + p[f"{name}.bias"].reshape(shape)

    def forward(self, x: torch.Tensor, logits: bool = False) -> dict:
        """(B, H, W, 2) normalized images -> {head name: (B, H, W, n) f32};
        with `logits`, also each inner-distance head before its activation
        (``<compartment>_inner_logit``)."""
        cfg = self.cfg
        b, h, w, _ = x.shape
        if cfg["location"]:
            ys = torch.arange(h, dtype=torch.float32, device=x.device) / max(h - 1, 1)
            xs = torch.arange(w, dtype=torch.float32, device=x.device) / max(w - 1, 1)
            grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
            x = torch.cat([x, grid[None].expand(b, h, w, 2)], dim=-1)
        x = self.dense("tensor_product", x).permute(0, 3, 1, 2)
        bb = "ResNet50Backbone_0"
        x = F.relu(self.bn(f"{bb}.BatchNorm_0", self.conv(f"{bb}.Conv_0", x, 2, 3),
                           BACKBONE_EPS))
        x = F.max_pool2d(x, 3, 2, padding=1)
        base, c, idx, feats = cfg["base_width"], cfg["base_width"], 0, []
        for i, blocks in enumerate(cfg["stage_sizes"]):
            f = base * 2 ** i
            for j in range(blocks):
                s = 2 if (i > 0 and j == 0) else 1
                p = f"{bb}.BottleneckBlock_{idx}"
                y = F.relu(self.bn(f"{p}.BatchNorm_0", self.conv(f"{p}.Conv_0", x, s),
                                   BACKBONE_EPS))
                y = F.relu(self.bn(f"{p}.BatchNorm_1", self.conv(f"{p}.Conv_1", y, 1, 1),
                                   BACKBONE_EPS))
                y = self.bn(f"{p}.BatchNorm_2", self.conv(f"{p}.Conv_2", y), BACKBONE_EPS)
                if j == 0 or c != 4 * f:
                    x = self.bn(f"{p}.BatchNorm_3", self.conv(f"{p}.Conv_3", x, s),
                                BACKBONE_EPS)
                x = F.relu(y + x)
                c, idx = 4 * f, idx + 1
            feats.append(x)
        lat = [self.conv(f"FPN_0.C{lv}_reduced", ft) for lv, ft in zip((3, 4, 5), feats[1:])]
        top = lat[-1]
        for lt in lat[-2::-1]:
            top = lt + F.interpolate(top, size=lt.shape[2:], mode="bilinear",
                                     align_corners=False)
        p3 = self.conv("FPN_0.P3", top, 1, 1)
        out = {}
        for comp in cfg["compartments"]:
            for head, n in N_CLASSES.items():
                name = f"{comp}_{head}"
                y = p3
                for i in range(3):
                    y = F.relu(self.conv(f"{name}.upsample_conv_{i}", y, 1, 1))
                    size = (h, w) if i == 2 else (y.shape[2] * 2, y.shape[3] * 2)
                    y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
                y = y.permute(0, 2, 3, 1)
                y = F.relu(self.bn(f"{name}.bn_0", self.dense(f"{name}.dense_0", y),
                                   HEAD_EPS, dim=-1))
                y = self.dense(f"{name}.dense_1", y)
                if head == "inner":
                    out[f"{comp}_inner_distance"] = F.relu(y)
                    if logits:
                        out[f"{comp}_inner_logit"] = y
                else:
                    out[f"{comp}_pixelwise"] = torch.softmax(y, dim=-1)
        return out


@contextlib.contextmanager
def no_tf32():
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


def percentile_normalize(batch: torch.Tensor) -> torch.Tensor:
    """Per image and channel, (x - p0.1) / max(p99.9 - p0.1, 1e-6) clipped
    to [0, 1]; percentiles with numpy's linear interpolation, in float64."""
    b, h, w, c = batch.shape
    n = h * w
    flat = batch.permute(0, 3, 1, 2).reshape(b, c, n).to(torch.float64)
    srt = torch.sort(flat, dim=-1).values

    def pct(q):
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        return srt[..., lo] + (srt[..., hi] - srt[..., lo]) * (pos - lo)

    lo, hi = pct(0.1), pct(99.9)
    den = torch.clamp_min(hi - lo, 1e-6)
    out = (flat - lo[..., None]) / den[..., None]
    return torch.clamp(out, 0, 1).reshape(b, c, h, w).permute(0, 2, 3, 1).to(torch.float32)


def heads(cfg: dict, state: dict, batch: np.ndarray, device, quant: str = "none") -> dict:
    """The four heads of a (B, H, W, 2) raw batch, computed image by image so
    that the float32 activations of one image at a time are resident."""
    net = Net(cfg, state, device, quant)
    x = torch.as_tensor(np.asarray(batch, np.float32), device=device)
    outs = []
    with no_tf32(), torch.no_grad():
        for i in range(x.shape[0]):
            outs.append(net.forward(percentile_normalize(x[i:i + 1])))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


# ---------------------------------------------------------------------------
# deep-watershed postprocess
# ---------------------------------------------------------------------------

INF = 2 ** 30
CHECK_EVERY = 16


def _shift_min(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Min over the four neighbours of each pixel (not the pixel itself),
    `fill` past the edges. x: (H, W)."""
    p = F.pad(x[None, None], (1, 1, 1, 1), value=fill)[0, 0]
    return torch.minimum(torch.minimum(p[:-2, 1:-1], p[2:, 1:-1]),
                         torch.minimum(p[1:-1, :-2], p[1:-1, 2:]))


def _fixpoint(step, x: torch.Tensor) -> torch.Tensor:
    """Apply `step` until it changes nothing."""
    while True:
        y = x
        for _ in range(CHECK_EVERY):
            y = step(y)
        if torch.equal(y, x):
            return x
        x = y


def components(mask: torch.Tensor) -> torch.Tensor:
    """4-connected components of a 2-D bool mask, numbered 1.. in raster
    order of each component's first pixel (scipy.ndimage.label's numbering):
    every pixel takes the smallest flat index of its component, then the
    components are ranked by it."""
    h, w = mask.shape
    idx = torch.arange(h * w, device=mask.device, dtype=torch.int64).reshape(h, w)
    rep = torch.where(mask, idx, INF * 4)
    rep = _fixpoint(lambda r: torch.where(mask, torch.minimum(r, _shift_min(r, INF * 4)),
                                          r), rep)
    firsts = torch.unique(rep[mask])
    out = torch.zeros(h, w, dtype=torch.int64, device=mask.device)
    out[mask] = torch.searchsorted(firsts, rep[mask]) + 1
    return out


def quantize(image: torch.Tensor, mask: torch.Tensor, levels: int = 256) -> torch.Tensor:
    """`levels` buckets of a float32 image over the masked values' robust
    range: the (n // 1000)-th smallest and largest of the n masked values;
    floor((x - lo) * ((levels - 1) / (hi - lo))) clipped to [0, levels),
    every product and quotient in float32 (0 where the range is empty)."""
    vals = torch.sort(image[mask]).values
    n = vals.numel()
    if n == 0:
        return torch.zeros(image.shape, dtype=torch.int64, device=image.device)
    k = n // 1000
    lo, hi = vals[k], vals[max(n - 1 - k, 0)]
    rng = hi - lo
    scale = (torch.tensor(float(levels - 1), device=image.device) / rng if rng > 0
             else torch.zeros((), device=image.device))
    q = torch.floor((image - lo) * scale)
    return torch.clamp(q, 0, levels - 1).to(torch.int64)


def flood(q: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Marker flood by minimax paths over 4-neighbours inside `mask`.

    A pixel's height v is the least, over paths from a marker to it through
    the mask, of the largest level the path passes before it (the marker's
    own level counts, the pixel's does not); markers have height 0. The
    pixel joins the nearest marker, in steps, along optimal edges: it takes
    the smallest label among its neighbours u already labelled whose
    max(v(u), q(u)) equals v(pixel), one synchronous step after another.
    Pixels no path reaches stay 0."""
    seeds = (markers > 0) & mask
    open_ = mask & ~seeds
    v = torch.where(seeds, 0, INF).to(torch.int64)

    def exit_(v):
        return torch.where(v < INF, torch.maximum(v, q), INF)

    v = _fixpoint(lambda v: torch.where(open_, torch.minimum(v, _shift_min(exit_(v), INF)),
                                        v), v)
    ex = exit_(v)
    pad_ex = F.pad(ex[None, None], (1, 1, 1, 1), value=INF)[0, 0]

    def grow(lab):
        pad = F.pad(lab[None, None], (1, 1, 1, 1), value=0)[0, 0]
        best = torch.full_like(lab, INF)
        for rows, cols in ((slice(None, -2), slice(1, -1)), (slice(2, None), slice(1, -1)),
                           (slice(1, -1), slice(None, -2)), (slice(1, -1), slice(2, None))):
            nb = pad[rows, cols]
            hit = (nb > 0) & (pad_ex[rows, cols] == v)
            best = torch.minimum(best, torch.where(hit, nb, INF))
        take = open_ & (lab == 0) & (v < INF) & (best < INF)
        return torch.where(take, best, lab)

    return _fixpoint(grow, torch.where(seeds, markers, 0))


def postprocess(out: dict, compartments, maxima_threshold: float,
                interior_threshold: float, min_cell_size: int) -> dict:
    """Mesmer's deep watershed on the heads, computed in the heads' own
    dtype, as torch compares a tensor with a float32 scalar: markers are the
    4-connected components of the 3x3 local maxima of the inner distance
    above `maxima_threshold`; the mask is where one minus the background
    probability exceeds `interior_threshold`; the negated inner distance,
    in float32, is cut into 256 levels over the mask and flooded from the
    markers (``flood``); objects under `min_cell_size` pixels are removed."""
    labels = {}
    for comp in compartments:
        inner = out[f"{comp}_inner_distance"][..., 0]
        dt = inner.dtype
        pooled = F.max_pool2d(inner[:, None].double(), 3, 1, 1)[:, 0].to(dt)
        maxima = (inner >= pooled) & (inner > torch.tensor(np.float32(maxima_threshold)).to(dt))
        fg = (1.0 - out[f"{comp}_pixelwise"][..., 2]) \
            > torch.tensor(np.float32(interior_threshold)).to(dt)
        per_image = []
        for b in range(inner.shape[0]):
            markers = components(maxima[b])
            q = quantize(-inner[b].to(torch.float32), fg[b])
            lab = flood(q, markers, fg[b])
            counts = torch.bincount(lab.ravel())
            keep = counts >= min_cell_size
            keep[0] = False
            per_image.append(torch.where(keep[lab], lab, 0).cpu().numpy().astype(np.int32))
        labels[comp] = np.stack(per_image)
    return labels
