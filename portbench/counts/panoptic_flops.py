"""Operations of one PanopticNet forward, counted from the configuration.

Each convolution and channel-dense layer counts 2 x its multiply-adds at the
resolution where the forward computes it; resizes, batch norms, pooling,
activations and the softmax are not counted. P6 and P7 of the feature
pyramid exist in the published weights but feed no head, so the forward
computes neither and neither is counted.
"""

from __future__ import annotations


def _conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def forward_flop(cfg: dict, h: int, w: int) -> int:
    """FLOP of one image of h x w through the network `cfg` describes."""
    flop = 0

    def conv(hw, cin, cout, k, stride=1, pad=0):
        nonlocal flop
        oh, ow = _conv_out(hw[0], k, stride, pad), _conv_out(hw[1], k, stride, pad)
        flop += 2 * oh * ow * cout * cin * k * k
        return oh, ow

    n_in = 4 if cfg["location"] else 2
    flop += 2 * h * w * n_in * 3                       # tensor_product dense
    base = cfg["base_width"]
    hw = conv((h, w), 3, base, 7, 2, 3)                 # stem
    hw = (_conv_out(hw[0], 3, 2, 1), _conv_out(hw[1], 3, 2, 1))   # max pool
    c = base
    feats = []
    for i, blocks in enumerate(cfg["stage_sizes"]):
        f = base * 2 ** i
        for j in range(blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            out_hw = conv(hw, c, f, 1, stride)
            conv(out_hw, f, f, 3, 1, 1)
            conv(out_hw, f, 4 * f, 1)
            if j == 0 or c != 4 * f:
                conv(hw, c, 4 * f, 1, stride)
            hw, c = out_hw, 4 * f
        feats.append((hw, c))
    fpn = cfg["fpn_channels"]
    for fhw, fc in feats[1:]:                           # laterals of C3..C5
        conv(fhw, fc, fpn, 1)
    p3_hw = feats[1][0]
    conv(p3_hw, fpn, fpn, 3, 1, 1)                      # P3 smoothing
    n_classes = {"inner": 1, "pixelwise": 3}
    up, dense = cfg["head_upsample_filters"], cfg["head_dense_features"]
    for _comp in cfg["compartments"]:
        for head in ("inner", "pixelwise"):
            hhw, cin = p3_hw, fpn
            for i in range(3):
                conv(hhw, cin, up, 3, 1, 1)
                cin = up
                hhw = (hhw[0] * 2, hhw[1] * 2) if i < 2 else (h, w)
            flop += 2 * h * w * up * dense
            flop += 2 * h * w * dense * n_classes[head]
    return flop
