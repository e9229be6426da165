"""Convert published deepcell-tf Mesmer weights (Keras HDF5) to the JAX
package's `.npz` checkpoint format, on PyTorch's side of the repo.

Port of ``ark_tpu/models/convert_deepcell.py``, with the same layer-name map
(``tests/models/deepcell_layer_manifest.json`` lists deepcell-tf's names and
shapes) and the same error messages, word for word, so that a misread layer
fails the same way in both packages:

    python -m ark_tpu_torch.models.convert_deepcell MultiplexSegmentation.h5 out.npz
    # then: Mesmer(weights_path="out.npz", device="cuda")

The target tree is the variables layout of the JAX package (``params`` and
``batch_stats``, flax names, HWIO kernels), built without jax from
``unet.params_to_flax`` of the full PanopticNet's state dict. Keras
Conv2D kernels are (H, W, in, out), as flax's; TensorProduct kernels are
(in, out), as nn.Dense's. BatchNorm gamma/beta/moving_mean/moving_variance
map to scale/bias/mean/var; a ResNet conv's bias is folded into the
following batch norm's moving mean (BN(Wx + b) = BN'(Wx) with mean' =
mean - b), since the backbone convs are bias-free. Every assignment is
shape-checked, and conversion fails listing every missing layer, shape
mismatch and leftover Keras layer. h5py is imported only inside
``read_keras_h5``.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from ark_tpu_torch.models import unet

RESNET50_STAGES = (3, 4, 6, 3)
# Mesmer semantic-head order (deepcell-tf PanopticNet created with
# num_semantic_classes=[1, 3, 1, 3])
SEMANTIC_HEADS = ("whole_cell_inner", "whole_cell_pixelwise",
                  "nuclear_inner", "nuclear_pixelwise")


def read_keras_h5(path: str) -> "Dict[str, Dict[str, np.ndarray]]":
    """Read a Keras `save_weights` HDF5 file → {layer: {weight: array}}.

    Handles both the classic layout (root attrs `layer_names`, per-layer
    attrs `weight_names`) and a flat group walk for files saved by
    `model.save` (weights under `model_weights/`).
    """
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                parts = [p for p in name.split("/") if p]
                # .../<layer>/<weight>:0 ; layer group may be nested
                weight = parts[-1].split(":")[0]
                layer = parts[-2] if len(parts) >= 2 else parts[0]
                out.setdefault(layer, {})[weight] = np.asarray(obj)

        root.visititems(visit)
    return out


def _backbone_block_names(stages=RESNET50_STAGES) -> List[Tuple[str, str]]:
    """[(keras block prefix, flax module name)] in flax creation order."""
    pairs = []
    i = 0
    for si, n_blocks in enumerate(stages):
        stage = si + 2
        for b in range(1, n_blocks + 1):
            pairs.append((f"conv{stage}_block{b}", f"BottleneckBlock_{i}"))
            i += 1
    return pairs


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _assign_bn(params, batch_stats, scope: List[str], bn_name: str,
               layers, keras_bn: str, errors: List[str],
               fold_bias=None) -> None:
    """gamma/beta → scale/bias, moving stats → batch_stats; optionally fold
    a preceding conv's bias into the moving mean."""
    bn_src = layers.get(keras_bn)
    if bn_src is None:
        errors.append(f"missing keras layer {keras_bn}")
        return
    p_bn = _node(params, scope)[bn_name]
    s_bn = _node(batch_stats, scope)[bn_name]
    gamma = bn_src.get("gamma")
    if gamma is None or gamma.shape != tuple(np.shape(p_bn["scale"])):
        errors.append(f"{keras_bn}: gamma {None if gamma is None else gamma.shape}"
                      f" != flax {tuple(np.shape(p_bn['scale']))}")
        return
    p_bn["scale"] = gamma.astype(np.float32)
    p_bn["bias"] = bn_src["beta"].astype(np.float32)
    mean = bn_src["moving_mean"].astype(np.float32)
    if fold_bias is not None:
        mean = mean - fold_bias.astype(np.float32)
    s_bn["mean"] = mean
    s_bn["var"] = bn_src["moving_variance"].astype(np.float32)


def _assign_conv_bn(params, batch_stats, scope: List[str], conv_name: str,
                    bn_name: str, layers, keras_conv: str, keras_bn: str,
                    errors: List[str]):
    """Assign one keras conv(+bias-fold)+bn pair into the flax tree."""
    conv_src = layers.get(keras_conv)
    if conv_src is None:
        errors.append(f"missing keras layer {keras_conv}")
        return
    kern = conv_src.get("kernel")
    tgt = _node(params, scope)[conv_name]
    if kern.shape != tuple(tgt["kernel"].shape):
        errors.append(f"{keras_conv}: kernel {kern.shape} != flax "
                      f"{tuple(tgt['kernel'].shape)}")
        return
    tgt["kernel"] = kern.astype(np.float32)
    _assign_bn(params, batch_stats, scope, bn_name, layers, keras_bn,
               errors, fold_bias=conv_src.get("bias"))


def _assign_weighted(params, scope: List[str], leaf_name: str, layers,
                     keras_layer: str, errors: List[str]):
    """Assign a conv or dense (kernel + optional bias) by exact shape."""
    src = layers.get(keras_layer)
    if src is None:
        errors.append(f"missing keras layer {keras_layer}")
        return
    tgt = _node(params, scope)[leaf_name]
    kern = src.get("kernel")
    if kern is None or kern.shape != tuple(np.shape(tgt["kernel"])):
        errors.append(
            f"{keras_layer}: kernel {None if kern is None else kern.shape} "
            f"!= flax {tuple(np.shape(tgt['kernel']))}")
        return
    tgt["kernel"] = kern.astype(np.float32)
    if "bias" in src and "bias" in tgt:
        tgt["bias"] = src["bias"].astype(np.float32)
    elif "bias" in src:
        errors.append(f"{keras_layer}: keras bias present but flax layer "
                      f"is bias-free (no following BN to fold into)")
    elif "bias" in tgt:
        errors.append(f"{keras_layer}: flax layer expects a bias but the "
                      f"keras layer has none")


def _copy_tree(node):
    """The nested dicts copied, leaves as float32 numpy arrays (assignments
    replace leaves, so the caller's tree is left as it was)."""
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    return np.asarray(node, dtype=np.float32)


def convert(layers: "Dict[str, Dict[str, np.ndarray]]",
            variables, stages=RESNET50_STAGES) -> Dict:
    """Map a keras layer dict onto a variables tree of the JAX package's
    layout (numpy leaves; `template_variables()` gives the full network's).

    Returns a new variables dict; raises ValueError listing every mapping
    failure (missing layer, shape mismatch, leftover weights). `stages`
    must match the variables' backbone depth (default: full ResNet50).
    """
    params = _copy_tree(variables["params"])
    batch_stats = _copy_tree(variables["batch_stats"])
    errors: List[str] = []
    used = set()

    def mark(*names):
        used.update(n for n in names if n in layers)

    # input fixer (PanopticNet TensorProduct after the Location2D concat)
    _assign_weighted(params, [], "tensor_product", layers, "tensor_product",
                     errors)
    mark("tensor_product")

    # stem
    bb = ["ResNet50Backbone_0"]
    _assign_conv_bn(params, batch_stats, bb, "Conv_0", "BatchNorm_0",
                    layers, "conv1_conv", "conv1_bn", errors)
    mark("conv1_conv", "conv1_bn")
    # stages
    for keras_prefix, flax_block in _backbone_block_names(stages):
        scope = bb + [flax_block]
        for k in (1, 2, 3):
            _assign_conv_bn(params, batch_stats, scope, f"Conv_{k-1}",
                            f"BatchNorm_{k-1}", layers,
                            f"{keras_prefix}_{k}_conv",
                            f"{keras_prefix}_{k}_bn", errors)
            mark(f"{keras_prefix}_{k}_conv", f"{keras_prefix}_{k}_bn")
        if f"{keras_prefix}_0_conv" in layers:   # projection shortcut
            _assign_conv_bn(params, batch_stats, scope, "Conv_3",
                            "BatchNorm_3", layers,
                            f"{keras_prefix}_0_conv",
                            f"{keras_prefix}_0_bn", errors)
            mark(f"{keras_prefix}_0_conv", f"{keras_prefix}_0_bn")

    # FPN laterals + smoothing + retinanet extras (flax leaf names were
    # chosen to equal the keras names — see unet.FPN)
    for name in [f"C{l}_reduced" for l in (3, 4, 5)] + \
                [f"P{l}" for l in (3, 4, 5, 6, 7)]:
        _assign_weighted(params, ["FPN_0"], name, layers, name, errors)
        mark(name)

    # semantic heads, by explicit deepcell-tf names (no file-order guess)
    for n, flax_head in enumerate(SEMANTIC_HEADS):
        scope = [flax_head]
        for i in range(3):
            _assign_weighted(params, scope, f"upsample_conv_{i}", layers,
                             f"conv_{i}_semantic_upsample_{n}", errors)
            mark(f"conv_{i}_semantic_upsample_{n}")
        _assign_weighted(params, scope, "dense_0", layers,
                         f"tensor_product_0_semantic_{n}", errors)
        _assign_bn(params, batch_stats, scope, "bn_0", layers,
                   f"batch_normalization_0_semantic_{n}", errors)
        _assign_weighted(params, scope, "dense_1", layers,
                         f"tensor_product_1_semantic_{n}", errors)
        mark(f"tensor_product_0_semantic_{n}",
             f"batch_normalization_0_semantic_{n}",
             f"tensor_product_1_semantic_{n}")

    leftovers = [n for n in layers if n not in used
                 and any(k in ("kernel", "gamma") for k in layers[n])]
    if leftovers:
        errors.append(f"unmapped keras layers with weights: {leftovers}")
    if errors:
        raise ValueError("deepcell conversion failed:\n  " +
                         "\n  ".join(errors))
    return {"params": params, "batch_stats": batch_stats}


def template_variables() -> Dict:
    """The full published PanopticNet's variables tree (numpy, the JAX
    package's layout), as the conversion target: shapes only matter, every
    leaf is overwritten."""
    return unet.params_to_flax(unet.PanopticNet(dtype=torch.float32).state_dict())


def convert_file(h5_path: str, npz_path: str) -> None:
    converted = convert(read_keras_h5(h5_path), template_variables())
    # no dtype in the config: inference runs at Mesmer's bf16 default
    unet.save_params_npz(npz_path, converted, config=None)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit("usage: python -m ark_tpu_torch.models.convert_deepcell "
                 "<MultiplexSegmentation.h5> <out.npz>")
    convert_file(sys.argv[1], sys.argv[2])
    print(f"wrote {sys.argv[2]}")
