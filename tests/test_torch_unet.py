"""ark_tpu_torch.models.unet against ark_tpu.models.unet.

torch cannot draw flax's random init, so each case initializes the flax
model, carries its variables across with ``params_from_flax`` and runs both
forwards in f32 on the same numpy input. Batch-norm statistics are drawn
away from their init values so the norms are not identities. Convolutions
and resizes sum in other orders in torch and XLA; the heads agree within
HEADS_ATOL (measured at most 7e-7 on the random-init cases and 5.3e-6 on
the trained checkpoint's larger activations).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ark_tpu.models import unet as JU
from ark_tpu.segmentation import mesmer as JM
from ark_tpu_torch.models import unet as TU

torch.set_num_threads(2)

HEADS_ATOL = 1e-5
CKPT = os.path.join(os.path.dirname(JU.__file__), "checkpoints",
                    "mesmer_mini_synthetic.npz")
CONFIGS = {"mini": TU.MINI_CONFIG, "full": {}}


def _perturbed(variables, rng):
    """The flax tree with batch-norm scale/bias/mean/var and every bias
    drawn at random (init leaves them at 1, 0, 0, 1)."""
    draws = {"scale": lambda s: rng.uniform(0.5, 1.5, s),
             "bias": lambda s: rng.normal(0, 0.1, s),
             "mean": lambda s: rng.normal(0, 0.1, s),
             "var": lambda s: rng.uniform(0.5, 2.0, s)}

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in draws:
                out[k] = jnp.asarray(draws[k](np.shape(v)).astype(np.float32))
            else:
                out[k] = v
        return out

    return walk(dict(variables))


def _torch_model(config, variables):
    model = TU.PanopticNet(dtype=torch.float32, **config)
    model.load_state_dict(TU.params_from_flax(variables))
    return model.eval()


def _assert_heads_close(got, ref, atol):
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].detach().numpy()
        assert g.shape == r.shape and g.dtype == np.float32, k
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
@pytest.mark.parametrize("name", ["mini", "full"])
def test_forward_matches_flax(name, hw):
    config = CONFIGS[name]
    model, variables = JU.init_mesmer(seed=1, input_shape=(1, *hw, 2),
                                      dtype=jnp.float32, **config)
    rng = np.random.default_rng(len(name) + hw[1])
    variables = _perturbed(variables, rng)
    x = rng.random((2 if name == "mini" else 1, *hw, 2)).astype(np.float32)
    ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables,
                                                               jnp.asarray(x))
    with torch.inference_mode():
        got = _torch_model(config, variables)(torch.from_numpy(x))
    _assert_heads_close(got, ref, HEADS_ATOL)


def test_checkpoint_matches_jax_mesmer():
    """The in-repo trained checkpoint through the port's loader == the JAX
    package's Mesmer(weights_path=...) forward."""
    app = JM.Mesmer(weights_path=CKPT)
    model = TU.model_from_npz(CKPT, device="cpu")
    assert model.dtype == torch.float32 and model.base_width == 16
    assert model.stage_sizes == (1, 1, 1, 1) and model.inner_activation == "linear"
    x = np.random.default_rng(3).random((2, 64, 64, 2)).astype(np.float32)
    ref = app._forward(app.variables, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    _assert_heads_close(got, ref, HEADS_ATOL)
    assert TU.model_from_npz(CKPT, dtype=torch.bfloat16, device="cpu").dtype \
        == torch.bfloat16


def test_load_params_npz_matches_jax(tmp_path):
    flat, config = TU.load_params_npz(CKPT, return_config=True)
    ref, ref_config = JU.load_params_npz(CKPT, return_config=True)
    assert config == ref_config
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    got = jax.tree_util.tree_leaves_with_path(flat)
    assert [p for p, _ in got] == [p for p, _ in leaves]
    for (_, a), (_, b) in zip(got, leaves):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("sizes", [((3, 5), (6, 10)), ((2, 3), (3, 5)),
                                   ((6, 10), (13, 21)), ((12, 20), (48, 80))])
def test_bilinear_resize_matches_jax_image_resize(sizes):
    """Upsampling at sizes that are not powers of two (the FPN's top-down
    path at 48x80 meets (2, 3) -> (3, 5)); f32, atol 2e-6 on values of
    magnitude ~1 (measured 1.2e-6: the interpolation weights round
    differently)."""
    (h, w), (th, tw) = sizes
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3)).astype(np.float32)
    ref = np.asarray(JU._bilinear_resize(jnp.asarray(x), th, tw))
    got = TU._bilinear_resize(torch.from_numpy(x).permute(0, 3, 1, 2), th, tw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=2e-6)


def test_location_grid_matches_jax():
    for h, w in ((1, 1), (5, 9), (64, 48)):
        np.testing.assert_array_equal(TU.location2d_grid(h, w).numpy(),
                                      np.asarray(JU.location2d_grid(h, w)))


def test_seeded_init_is_deterministic_and_finite():
    """Seeded random weights (the template-1 default): the same seed gives
    the same weights, the last norm of each bottleneck starts at zero, and
    a forward gives finite heads of the right shapes."""
    a = TU.init_mesmer_mini(seed=5, device="cpu")
    b = TU.init_mesmer_mini(seed=5, device="cpu")
    c = TU.init_mesmer_mini(seed=6, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["ResNet50Backbone_0.Conv_0.weight"],
                           sc["ResNet50Backbone_0.Conv_0.weight"])
    assert not sa["ResNet50Backbone_0.BottleneckBlock_0.BatchNorm_2.scale"].any()
    x = torch.rand(1, 48, 40, 2)
    with torch.inference_mode():
        out = a(x)
    assert out["whole_cell_inner_distance"].shape == (1, 48, 40, 1)
    assert out["nuclear_pixelwise"].shape == (1, 48, 40, 3)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_full_config_maps_every_flax_leaf():
    """The published configuration's flax tree and the torch state dict
    name the same tensors with the same element counts (P6/P7 included)."""
    _, variables = JU.init_mesmer(seed=0, input_shape=(1, 64, 64, 2),
                                  dtype=jnp.float32)
    state = TU.params_from_flax(variables)
    model = TU.PanopticNet(dtype=torch.bfloat16)
    want = model.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        assert state[k].shape == v.shape, k
    assert "FPN_0.P7.weight" in state
