"""ark_tpu_torch.models.convert_deepcell against ark_tpu.models.convert_deepcell,
and the port's ``graft_entry.entry``.

The Keras HDF5 is built from tests/models/deepcell_layer_manifest.json, as
the JAX package's converter test builds it (the published weights are not
in the repository). Both converters map the same layers onto the same
template tree (the port's, from ``params_to_flax``; every leaf is
overwritten), and must give the same tree bit for bit, and fail with the
same message. The converted weights (kernels scaled by 1/sqrt(fan_in), so
the activations stay finite) drive the port's full network within 1e-5 of
the flax forward at 64² (the earlier full-width checks' tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ark_tpu.models import convert_deepcell as JC
from ark_tpu.models import unet as JU
from ark_tpu_torch import graft_entry
from ark_tpu_torch.models import convert_deepcell as TC
from ark_tpu_torch.models import unet as TU
from chip_smoke import manifest_layers

torch.set_num_threads(2)

HEADS_ATOL = 1e-5


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, b in want.items():
        a = got[path]
        assert a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.fixture(scope="module")
def template():
    return TC.template_variables()


@pytest.fixture(scope="module")
def layers():
    return manifest_layers(np.random.default_rng(0))


@pytest.fixture(scope="module")
def h5_path(layers, tmp_path_factory):
    import h5py

    path = tmp_path_factory.mktemp("h5") / "manifest_mesmer.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        for lname, weights in layers.items():
            lg = g.create_group(lname).create_group(lname)
            for wname, arr in weights.items():
                lg.create_dataset(f"{wname}:0", data=arr)
    return str(path)


def test_template_is_the_flax_tree():
    """The port's conversion target has the flax init's leaves and shapes."""
    _, variables = JU.init_mesmer(seed=0, input_shape=(1, 64, 64, 2), dtype=jnp.float32)
    got = dict(_leaves(TC.template_variables()))
    want = dict(_leaves(jax.device_get(variables)))
    assert set(got) == set(want)
    assert all(got[p].shape == want[p].shape for p in want)


def test_converter_matches_jax_on_manifest_h5(h5_path, layers, template):
    read = TC.read_keras_h5(h5_path)
    ref_read = JC.read_keras_h5(h5_path)
    assert set(read) == set(ref_read) == set(layers)
    for name, weights in ref_read.items():
        assert set(read[name]) == set(weights)
        for w, a in weights.items():
            np.testing.assert_array_equal(read[name][w], a)
    got = TC.convert(read, template)
    _assert_trees_equal(got, JC.convert(ref_read, template))
    # every leaf of the template was overwritten, and the template is intact
    np.testing.assert_array_equal(
        got["batch_stats"]["ResNet50Backbone_0"]["BatchNorm_0"]["mean"],
        layers["conv1_bn"]["moving_mean"] - layers["conv1_conv"]["bias"])
    assert not template["params"]["FPN_0"]["P6"]["bias"].any()


def _renamed_head(layers):
    layers["conv_1_semantic_upsample_0_v2"] = layers.pop("conv_1_semantic_upsample_0")


def _missing(layers):
    del layers["conv3_block1_2_conv"], layers["conv3_block1_2_bn"]


def _shape(layers):
    layers["P3"]["kernel"] = layers["P3"]["kernel"][:1]


def _leftover(layers):
    layers["some_extra_conv"] = {"kernel": np.zeros((1, 1, 4, 4), np.float32)}


@pytest.mark.parametrize("break_it,names", [
    (_renamed_head, ("conv_1_semantic_upsample_0", "unmapped")),
    (_missing, ("conv3_block1_2_conv",)),
    (_shape, ("P3",)),
    (_leftover, ("some_extra_conv",)),
])
def test_converter_fails_with_the_jax_message(layers, template, break_it, names):
    broken = {k: dict(v) for k, v in layers.items()}
    break_it(broken)
    with pytest.raises(ValueError) as ref:
        JC.convert(broken, template)
    with pytest.raises(ValueError) as got:
        TC.convert(broken, template)
    assert str(got.value) == str(ref.value)
    assert all(n in str(got.value) for n in names)


def test_convert_file_writes_a_checkpoint_both_packages_load(h5_path, tmp_path, template):
    path = str(tmp_path / "mesmer.npz")
    TC.convert_file(h5_path, path)
    loaded, config = JU.load_params_npz(path, return_config=True)
    assert config is None
    _assert_trees_equal({k: jax.device_get(loaded[k]) for k in ("params", "batch_stats")},
                        TC.convert(TC.read_keras_h5(h5_path), template))
    model = TU.model_from_npz(path, device="cpu")
    assert model.dtype == torch.bfloat16 and model.base_width == 64


def test_converted_forward_matches_flax(layers, template):
    """The converted weights through params_from_flax into the full network
    on the CPU, against the flax forward of the same tree, f32 at 64²."""
    converted = TC.convert(layers, template)
    x = np.random.default_rng(1).random((1, 64, 64, 2), dtype=np.float32)
    model = JU.PanopticNet(dtype=jnp.float32)
    ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        jax.tree.map(jnp.asarray, converted), jnp.asarray(x))
    net = TU.PanopticNet(dtype=torch.float32)
    net.load_state_dict(TU.params_from_flax(converted))
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x))
    for k, r in ref.items():
        r = np.asarray(r)
        assert np.isfinite(r).all() and np.abs(r).max() > 1e-3, k
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0, atol=HEADS_ATOL, err_msg=k)


def test_entry_runs_the_full_network():
    forward, (model, x) = graft_entry.entry(device="cpu")
    assert model.dtype == torch.float32 and not model.training
    assert tuple(x.shape) == (1, 128, 128, 2) and x.dtype == torch.float32
    assert sum(p.numel() for p in model.parameters()) > 20_000_000
    inner, pixelwise = forward(model, x)
    assert tuple(inner.shape) == (1, 128, 128, 1)
    assert tuple(pixelwise.shape) == (1, 128, 128, 3)
    assert not inner.requires_grad and torch.isfinite(inner).all()
    torch.testing.assert_close(pixelwise.sum(-1), torch.ones(1, 128, 128))
