"""The benchmark's operation counts against torch's own counter, and the BMU
bound's arithmetic."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import hw, inputs
from portbench.counts import bmu_bound, panoptic_flops
from portbench.reference import panoptic

MINI = dict(compartments=["whole_cell", "nuclear"], stage_sizes=[1, 2, 1, 1], base_width=8,
            fpn_channels=16, head_upsample_filters=8, head_dense_features=16,
            location=True, inner_activation="relu")


@pytest.mark.parametrize("hw_", [(64, 64), (96, 128)])
def test_panoptic_flop_count_matches_torch(hw_):
    state = inputs.panoptic_state(panoptic.param_shapes(MINI), 1, "cpu")
    net = panoptic.Net(MINI, state, "cpu")
    x = torch.rand(1, *hw_, 2)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net.forward(x)
    assert panoptic_flops.forward_flop(MINI, *hw_) == counter.get_total_flops()


def test_published_widths_count():
    cfg = dict(MINI, stage_sizes=[3, 4, 6, 3], base_width=64, fpn_channels=256,
               head_upsample_filters=64, head_dense_features=128)
    tflop = panoptic_flops.forward_flop(cfg, 1024, 1024) / 1e12
    assert 0.35 < tflop < 0.42            # ResNet50 ~0.17, four heads ~0.19, pyramid ~0.03


def test_bmu_bound():
    n, c, k = 4_194_304, 16, 100
    assert bmu_bound.launch_bound_s(n, c, k) == pytest.approx(2 * n * c * k / hw.F32_FLOP_PER_S)
    assert bmu_bound.launch_bound_s(10_000_000, 1, 1) == pytest.approx(
        4 * (10_000_000 * 2 + 1) / hw.HBM_BYTES_PER_S)
