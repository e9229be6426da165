"""Mesmer-style segmentation network (ResNet50 + FPN + semantic heads) as
torch ``nn.Module``s.

Port of ``ark_tpu/models/unet.py``. Module and parameter names mirror the
flax module paths (``ResNet50Backbone_0.BottleneckBlock_3.Conv_1``), so that
``params_from_flax`` maps a flax variables tree onto a state dict one name
for one name. Public inputs and outputs keep the JAX package's NHWC layout;
the convolutions run in NCHW inside. As in flax, parameters are float32 and
each layer computes in the model's ``dtype`` (bfloat16 by default):
convolutions and the channel-dense layers cast their weights to it, batch
norm computes in float32 and casts back, and the last dense layer of each
head computes in float32. ``model.train()`` selects flax's train mode (batch
statistics, running averages updated); ``model.eval()`` the running
averages. torch's random init cannot draw flax's ``jax.random`` numbers, so
parity with the JAX package always goes through ``params_from_flax``;
``params_to_flax`` and ``save_params_npz`` go the other way.
"""

from __future__ import annotations

import contextlib
import functools
import json
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# keras/TF constants the published weights were trained under (see the
# reference module): backbone batch norms use 1.001e-5, the head's 1e-3
BACKBONE_BN_EPSILON = 1.001e-5
HEAD_BN_EPSILON = 1e-3
# flax's running-average decay (the JAX package's BatchNorm(momentum=0.9))
BN_MOMENTUM = 0.9

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# True resizes every pyramid and head upsample of a bf16 network in float32
# and rounds the result back to the model dtype, as the JAX package's
# switch of the same name does; False resizes in the model dtype. Read at
# call time. F.interpolate computes a bf16 input in float32 and rounds once
# either way, so the switch moves only the product form run under autograd.
RESIZE_IN_F32 = False


def location2d_grid(h: int, w: int, device=None) -> torch.Tensor:
    """deepcell-tf ``Location2D`` channels: row and column index grids, each
    divided by its max index, stacked (y, x) channel-last. (h, w, 2) f32."""
    ys = torch.arange(h, dtype=torch.float32, device=device) / max(h - 1, 1)
    xs = torch.arange(w, dtype=torch.float32, device=device) / max(w - 1, 1)
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """(n_out, n_in) bilinear weights of ``jax.image.resize`` (its
    ``compute_weight_mat`` for the triangle kernel when upsampling), computed
    in f32 in its order of operations, then cast to `dtype`."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0)).astype(f32)
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(device=device, dtype=dtype)


def _resize_products(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """``jax.image.resize``'s own form of the bilinear resize of NCHW `x`:
    two products with the interpolation-weight matrices, rows then columns.
    Its backward is two more products, where ``F.interpolate``'s scatters
    with float atomics on CUDA."""
    h, w = x.shape[2:]
    rows = _resize_weights(h, th, x.dtype, x.device)
    cols = _resize_weights(w, tw, x.dtype, x.device)
    y = F.linear(x.transpose(2, 3), rows)                  # (B, C, W, th)
    return F.linear(y.transpose(2, 3), cols)               # (B, C, th, tw)


def _bilinear_resize(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Bilinear resize of NCHW `x` to (th, tw), returned in its own dtype and
    computed in it (in float32 when RESIZE_IN_F32): half-pixel centres,
    edges clamped, no antialiasing. This is ``jax.image.resize``'s
    'bilinear' when upsampling, and the network only ever upsamples. Under
    autograd it takes the product form (a deterministic backward); without
    a gradient ``F.interpolate``, which reads each input once instead of
    multiplying through mostly-zero matrices."""
    if tuple(x.shape[2:]) == (th, tw):
        return x
    dtype = x.dtype
    if RESIZE_IN_F32:
        x = x.to(torch.float32)
    if torch.is_grad_enabled() and x.requires_grad:
        return _resize_products(x, th, tw).to(dtype)
    return F.interpolate(x, size=(th, tw), mode="bilinear", align_corners=False).to(dtype)


class Conv(nn.Module):
    """flax ``nn.Conv``: f32 weight (OIHW) and bias, computed in `dtype`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, self.padding)


class Dense(nn.Module):
    """flax ``nn.Dense`` over the last axis: f32 weight (out, in) and bias,
    computed in `dtype`."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm``: y = (x - mean) * (rsqrt(var + eps) * scale) +
    bias in f32, cast to `dtype`. In eval mode mean and var are the running
    averages; in train mode they are the batch's (f32 mean and the fast
    variance E[x^2] - E[x]^2 clipped at 0, flax's ``_compute_stats``), and the
    running averages move to ``0.9 * avg + 0.1 * batch``, with the biased
    variance. `channel_dim` is 1 for NCHW maps and -1 for NHWC ones."""

    def __init__(self, c: int, eps: float, dtype=torch.bfloat16,
                 channel_dim: int = 1):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.eps, self.dtype, self.channel_dim = eps, dtype, channel_dim
        # None: train mode takes the statistics of this process's batch.
        # Else a callable (sums, count) -> (sums, count) that turns this
        # process's (2, C) f32 [sum x; sum x^2] and pixel count into the
        # global batch's (see ``global_batch_stats``)
        self.batch_reduce = None

    def _batch_stats(self, xf: torch.Tensor):
        dims = [d for d in range(xf.ndim) if d != self.channel_dim % xf.ndim]
        if self.batch_reduce is None:
            mean = xf.mean(dims)
            mean_sq = xf.square().mean(dims)
        else:
            sums = torch.stack([xf.sum(dims), xf.square().sum(dims)])
            sums, count = self.batch_reduce(sums, xf.numel() // xf.shape[self.channel_dim])
            mean, mean_sq = sums / torch.tensor(float(count), device=xf.device)
        # torch.maximum splits the gradient at a tie as jnp.maximum does
        var = torch.maximum(mean_sq - mean.square(), torch.zeros((), device=xf.device))
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        return mean, var

    def forward(self, x):
        shape = [1] * x.ndim
        shape[self.channel_dim] = -1
        xf = x.to(torch.float32)
        mean, var = self._batch_stats(xf) if self.training else (self.mean, self.var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.reshape(shape)).to(self.dtype)


@contextlib.contextmanager
def global_batch_stats(model: nn.Module, reduce):
    """Within the block, every train-mode ``BatchNorm`` of `model` takes its
    mean and E[x^2] over the global batch: `reduce(sums, count)` returns
    the global (2, C) sums and pixel count from this process's (it must be
    differentiable in `sums`), as one ``jax.jit`` over a batch-sharded
    array computes them. Outside it the model is unchanged."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.batch_reduce = reduce
    try:
        yield model
    finally:
        for m in norms:
            m.batch_reduce = None


class BottleneckBlock(nn.Module):
    """ResNet50 v1 bottleneck (stride on the first 1x1 conv, as keras)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 projection: bool = False, dtype=torch.bfloat16):
        super().__init__()
        eps = BACKBONE_BN_EPSILON
        self.Conv_0 = Conv(cin, features, 1, stride, bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, eps, dtype)
        self.Conv_1 = Conv(features, features, 3, 1, 1, bias=False, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(features, eps, dtype)
        self.Conv_2 = Conv(features, features * 4, 1, bias=False, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(features * 4, eps, dtype)
        self.project = projection or cin != features * 4
        if self.project:
            self.Conv_3 = Conv(cin, features * 4, 1, stride, bias=False,
                               dtype=dtype)
            self.BatchNorm_3 = BatchNorm(features * 4, eps, dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


class ResNet50Backbone(nn.Module):
    """ResNet50 stages; returns C2..C5 (strides 4..32)."""

    def __init__(self, cin: int = 3, dtype=torch.bfloat16,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), base_width: int = 64):
        super().__init__()
        # keras stem: ZeroPadding2D(3) + 7x7/2 VALID conv
        self.Conv_0 = Conv(cin, base_width, 7, 2, 3, bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(base_width, BACKBONE_BN_EPSILON, dtype)
        self.stages = []
        c, idx = base_width, 0
        for i, n_blocks in enumerate(stage_sizes):
            features = base_width * 2 ** i
            stage = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"BottleneckBlock_{idx}"
                setattr(self, name, BottleneckBlock(
                    c, features, stride, projection=j == 0, dtype=dtype))
                stage.append(name)
                c, idx = features * 4, idx + 1
            self.stages.append(stage)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        # 3x3/2 max pool over a (1, 1) pad of -inf (the input is post-relu,
        # so keras' zero pad gives the same)
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for stage in self.stages:
            for name in stage:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats


class FPN(nn.Module):
    """deepcell-tf feature pyramid over C3-C5: 1x1 laterals, bilinear
    top-down adds, 3x3 smoothing. P6/P7 exist so that the published weights
    map 1:1, but the heads read only P3, so they are not computed."""

    def __init__(self, in_channels: Sequence[int], channels: int = 256,
                 dtype=torch.bfloat16):
        super().__init__()
        for level, cin in zip((3, 4, 5), in_channels):
            setattr(self, f"C{level}_reduced", Conv(cin, channels, 1, dtype=dtype))
            setattr(self, f"P{level}", Conv(channels, channels, 3, 1, 1,
                                            dtype=dtype))
        self.P6 = Conv(in_channels[-1], channels, 3, 2, 1, dtype=dtype)
        self.P7 = Conv(channels, channels, 3, 2, 1, dtype=dtype)

    def forward(self, feats):
        """feats = [C3, C4, C5] -> P3."""
        laterals = [getattr(self, f"C{level}_reduced")(f)
                    for level, f in zip((3, 4, 5), feats)]
        top = laterals[-1]
        for lat in laterals[-2::-1]:
            top = lat + _bilinear_resize(top, lat.shape[2], lat.shape[3])
        return self.P3(top)


class SemanticHead(nn.Module):
    """deepcell-tf semantic head: three rounds of 3x3 conv + relu + bilinear
    upsample (x2, x2, then to the input size), a channel-dense + batch norm
    + relu, a channel-dense to n_classes in f32. Returns NHWC."""

    def __init__(self, cin: int, n_classes: int, upsample_filters: int = 64,
                 dense_features: int = 128, dtype=torch.bfloat16):
        super().__init__()
        c = cin
        for i in range(3):
            setattr(self, f"upsample_conv_{i}",
                    Conv(c, upsample_filters, 3, 1, 1, dtype=dtype))
            c = upsample_filters
        self.dense_0 = Dense(upsample_filters, dense_features, dtype)
        self.bn_0 = BatchNorm(dense_features, HEAD_BN_EPSILON, dtype,
                              channel_dim=-1)
        self.dense_1 = Dense(dense_features, n_classes, torch.float32)

    def forward(self, p3, out_hw):
        x = p3
        for i in range(3):
            x = F.relu(getattr(self, f"upsample_conv_{i}")(x))
            h, w = x.shape[2:]
            th, tw = out_hw if i == 2 else (h * 2, w * 2)
            x = _bilinear_resize(x, th, tw)
        x = x.permute(0, 2, 3, 1)                       # NHWC for the denses
        x = F.relu(self.bn_0(self.dense_0(x)))
        return self.dense_1(x)


class PanopticNet(nn.Module):
    """Mesmer-configuration segmentation net. forward((B, H, W, 2) NHWC)
    returns, per compartment c, ``<c>_inner_distance`` (B, H, W, 1) and
    ``<c>_pixelwise`` (B, H, W, 3) softmax, f32. Defaults are the published
    Mesmer configuration; ``init_mesmer_mini`` gives the mini one."""

    def __init__(self, compartments: Sequence[str] = ("whole_cell", "nuclear"),
                 dtype=torch.bfloat16, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 base_width: int = 64, fpn_channels: int = 256,
                 head_upsample_filters: int = 64, head_dense_features: int = 128,
                 location: bool = True, inner_activation: str = "relu"):
        super().__init__()
        if inner_activation not in ("relu", "softplus", "linear"):
            raise ValueError(f"unknown inner_activation {inner_activation!r}")
        self.compartments = tuple(compartments)
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.base_width = base_width
        self.location = location
        self.inner_activation = inner_activation
        self.tensor_product = Dense(4 if location else 2, 3, dtype)
        self.ResNet50Backbone_0 = ResNet50Backbone(3, dtype, stage_sizes,
                                                   base_width)
        widths = [base_width * 2 ** i * 4 for i in range(len(stage_sizes))]
        self.FPN_0 = FPN(widths[1:], fpn_channels, dtype)
        for comp in self.compartments:
            for name, n_classes in (("inner", 1), ("pixelwise", 3)):
                setattr(self, f"{comp}_{name}", SemanticHead(
                    fpn_channels, n_classes, head_upsample_filters,
                    head_dense_features, dtype))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        b, h, w, _ = x.shape
        x = x.to(self.dtype)
        if self.location:
            loc = location2d_grid(h, w, x.device)[None].expand(b, h, w, 2)
            x = torch.cat([x, loc.to(self.dtype)], dim=-1)
        x = self.tensor_product(x).permute(0, 3, 1, 2)  # NCHW from here
        feats = self.ResNet50Backbone_0(x)
        p3 = self.FPN_0(feats[1:])
        act = {"relu": F.relu, "softplus": F.softplus,
               "linear": lambda y: y}[self.inner_activation]
        out = {}
        for comp in self.compartments:
            inner = getattr(self, f"{comp}_inner")(p3, (h, w))
            pixelwise = getattr(self, f"{comp}_pixelwise")(p3, (h, w))
            out[f"{comp}_inner_distance"] = act(inner)
            out[f"{comp}_pixelwise"] = torch.softmax(pixelwise, dim=-1)
        return out


@contextlib.contextmanager
def full_f32():
    """Full-precision f32 convolutions and matmuls for the duration (cuDNN
    convolutions default to TF32, which keeps ~3 decimal digits)."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init (variance scaling 1, fan_in, truncated
    normal at 2 std), drawn from a torch generator."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def init_mesmer(seed: int = 0, dtype=torch.bfloat16, *, device, **config):
    """A PanopticNet with seeded random weights on `device` (the
    distributions of flax's defaults: truncated lecun-normal kernels, zero
    biases, unit batch-norm scales except the last of each bottleneck, which
    starts at zero). Returns the model in eval mode."""
    model = PanopticNet(dtype=dtype, **config)
    gen = torch.Generator().manual_seed(seed)
    for name, module in model.named_modules():
        if isinstance(module, Conv):
            _lecun_normal_(module.weight, module.weight[0].numel(), gen)
        elif isinstance(module, Dense):
            _lecun_normal_(module.weight, module.weight.shape[1], gen)
        elif isinstance(module, BatchNorm) and name.endswith("BatchNorm_2") \
                and "BottleneckBlock" in name:
            with torch.no_grad():
                module.scale.zero_()
    return model.to(device).eval()


MINI_CONFIG = dict(stage_sizes=(1, 1, 1, 1), base_width=16, fpn_channels=64,
                   head_upsample_filters=32, head_dense_features=64,
                   inner_activation="linear")


def init_mesmer_mini(seed: int = 0, dtype=torch.float32, *, device):
    """The mini PanopticNet: 1-block stages, width 16, 64-channel FPN,
    narrow heads, linear inner-distance head."""
    return init_mesmer(seed, dtype, device=device, **MINI_CONFIG)


def params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """A flax variables tree ({'params': ..., 'batch_stats': ...}, numpy or
    jax leaves) as a PanopticNet state dict: conv kernels HWIO -> OIHW,
    dense kernels (in, out) -> (out, in), batch-norm scale/bias and
    mean/var by name."""
    state = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        a = np.asarray(node, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            leaf = "weight"
        # a copy: jax arrays read back as read-only numpy views
        state[".".join(path[:-1] + [leaf])] = torch.from_numpy(np.array(a))

    for collection in ("params", "batch_stats"):
        walk(dict(variables.get(collection, {})), [])
    return state


def load_params_npz(path: str, return_config: bool = False):
    """Load a flattened param dict ('a/b/c' keys) from .npz into a nested
    dict of numpy arrays (the JAX package's format). With
    return_config=True returns (variables, config dict or None)."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    config = None
    raw = flat.pop("__config__", None)
    if raw is not None:
        config = json.loads(str(raw.item() if raw.ndim == 0 else raw[0]))
    tree: Dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return (tree, config) if return_config else tree


def params_to_flax(state) -> Dict:
    """A PanopticNet state dict as the JAX package's variables tree of f32
    numpy arrays, the inverse of ``params_from_flax``: weights OIHW -> HWIO
    and (out, in) -> (in, out) as ``kernel``, batch-norm mean and var under
    'batch_stats', every other tensor under 'params'."""
    tree: Dict = {"params": {}, "batch_stats": {}}
    for name, t in state.items():
        *path, leaf = name.split(".")
        a = t.detach().to(device="cpu", dtype=torch.float32).numpy()
        if leaf == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            leaf = "kernel"
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def save_params_npz(path: str, model_or_tree, config: Dict = None):
    """Save a PanopticNet, or a variables tree of the JAX package's layout
    (as ``convert_deepcell.convert`` returns), as the JAX package's
    flattened compressed .npz ('a/b/c' keys); `config` (PanopticNet kwargs)
    is embedded as JSON under '__config__', so either package rebuilds the
    architecture from it."""
    tree = model_or_tree
    if isinstance(tree, nn.Module):
        tree = params_to_flax(tree.state_dict())
    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)

    rec(tree, "")
    if config is not None:
        flat["__config__"] = np.array(json.dumps(config))
    np.savez_compressed(path, **flat)


def model_from_npz(path: str, dtype=None, *, device):
    """The PanopticNet a checkpoint describes (its '__config__'), with its
    weights, on `device`. `dtype=None` takes the checkpoint's dtype, else
    bfloat16; an explicit dtype wins."""
    variables, config = load_params_npz(path, return_config=True)
    config = dict(config or {})
    cfg_dtype = config.pop("dtype", None)
    if dtype is None:
        dtype = _DTYPES[cfg_dtype] if cfg_dtype is not None else torch.bfloat16
    model = PanopticNet(dtype=dtype, **{k: tuple(v) if isinstance(v, list) else v
                                        for k, v in config.items()})
    model.load_state_dict(params_from_flax(variables))
    return model.to(device).eval()
