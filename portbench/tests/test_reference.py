"""The plain references against the port at a tiny size on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.reference import panoptic
from portbench.reference.compare import partition_mismatch
from portbench.tests.test_counts import MINI


def test_plain_network_equals_the_port_in_float32():
    from ark_tpu_torch.models import unet

    state = inputs.panoptic_state(panoptic.param_shapes(MINI), 7, "cpu")
    model = unet.PanopticNet(compartments=tuple(MINI["compartments"]), dtype=torch.float32,
                             stage_sizes=tuple(MINI["stage_sizes"]),
                             **{k: MINI[k] for k in ("base_width", "fpn_channels",
                                                     "head_upsample_filters",
                                                     "head_dense_features", "location",
                                                     "inner_activation")})
    model.load_state_dict(state)
    x = torch.rand(2, 48, 64, 2)
    with torch.no_grad():
        got = model.eval()(x)
        want = panoptic.Net(MINI, state, "cpu").forward(x)
    for k in want:
        assert torch.allclose(got[k], want[k], rtol=1e-4, atol=1e-5), k


def _planted_heads(rng, size=64, n=6):
    yy, xx = np.mgrid[:size, :size]
    inner = np.zeros((size, size), np.float32)
    for cy, cx in rng.uniform(8, size - 8, (n, 2)):
        inner = np.maximum(inner, np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 30.0)
                           .astype(np.float32))
    fg = (inner > 0.2).astype(np.float32)
    pix = np.stack([fg * 0.5, fg * 0.45, 1.0 - 0.95 * fg], -1)
    return {"whole_cell_inner_distance": torch.from_numpy(inner)[None, ..., None],
            "whole_cell_pixelwise": torch.from_numpy(pix)[None]}


def _random_heads(rng, dtype, size=96, batch=2):
    """A rough random relief, as seeded weights give: smoothed noise over a
    mask of random blobs, with plateaus where `dtype` rounds."""
    noise = torch.from_numpy(rng.normal(size=(batch, 1, size // 4, size // 4)).astype(np.float32))
    inner = torch.relu(F.interpolate(noise, size=(size, size), mode="bilinear",
                                     align_corners=False)[:, 0] + 0.2)
    inner = inner + 0.05 * torch.from_numpy(rng.random((batch, size, size)).astype(np.float32))
    back = torch.from_numpy(rng.random((batch, size // 8, size // 8)).astype(np.float32))
    back = F.interpolate(back[:, None], size=(size, size), mode="nearest")[:, 0]
    pix = torch.stack([0.5 * (1 - back), 0.5 * (1 - back), back], -1)
    return {"whole_cell_inner_distance": inner[..., None].to(dtype),
            "whole_cell_pixelwise": pix.to(dtype)}


def _port_postprocess(heads, maxima_threshold=0.1):
    from ark_tpu_torch.models import unet
    from ark_tpu_torch.segmentation import mesmer

    app = mesmer.Mesmer(model=unet.init_mesmer_mini(device="cpu"), device="cpu")
    inner = heads["whole_cell_inner_distance"][..., 0]
    res = {"whole_cell": {"inner": inner,
                          "foreground": 1.0 - heads["whole_cell_pixelwise"][..., 2],
                          "maxima": mesmer._find_maxima(inner, maxima_threshold)}}
    mesmer.COMPARTMENTS, saved = ("whole_cell",), mesmer.COMPARTMENTS
    try:
        got, done = app._device_post(res, 0.3, 15)
    finally:
        mesmer.COMPARTMENTS = saved
    assert done
    return got["whole_cell"].numpy()


@pytest.mark.parametrize("case", ["planted", "random_f32", "random_bf16"])
def test_plain_postprocess_equals_the_port(case):
    """Label for label, ties included: the plain flood follows the same
    minimax rule and the same numbering."""
    rng = np.random.default_rng(3)
    if case == "planted":
        heads = _planted_heads(rng)
    else:
        heads = _random_heads(rng, torch.float32 if case == "random_f32" else torch.bfloat16)
    want = panoptic.postprocess(heads, ["whole_cell"], 0.1, 0.3, 15)["whole_cell"]
    got = _port_postprocess(heads)
    assert len(np.unique(want)) > 3
    np.testing.assert_array_equal(got, want)
    assert partition_mismatch(got, want) == 0.0


def test_plain_flood_takes_the_smaller_label_at_a_tie():
    """Two markers at the same height, one pixel between them: the smaller
    label wins; a path over a higher level loses to a lower one."""
    q = torch.tensor([[0, 0, 0, 0, 0], [0, 3, 3, 3, 0]])
    markers = torch.tensor([[2, 0, 0, 0, 1], [0, 0, 0, 0, 0]])
    mask = torch.ones_like(q, dtype=torch.bool)
    lab = panoptic.flood(q, markers, mask)
    assert lab[0, 2] == 1 and lab[0, 1] == 2 and lab[0, 3] == 1
    assert panoptic.components(torch.tensor([[1, 0, 1], [1, 0, 1]], dtype=torch.bool)
                               ).tolist() == [[1, 0, 2], [1, 0, 2]]
