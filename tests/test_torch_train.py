"""ark_tpu_torch.segmentation.train (and the training side of models/unet.py
and synthetic.targets_from_labels) against the JAX package's.

The mini configuration, carried across with ``params_from_flax``, on the
same numpy inputs. The train-mode cases run at 64² with a batch of 4: at
32² the C5 map is 1x1, a batch norm there sees 4 values a channel, and the
fast variance's conditioning lifts the two packages' summation-order
noise to 1e-4 in the heads (measured). Tolerances, each measured well
inside:
- ``mesmer_loss``: rtol 1e-6.
- train-mode heads: within 1e-5 of each head's largest magnitude; updated
  batch statistics within 1e-6 of max(|stat|, 1).
- gradients: within 1e-4 of each tensor's largest entry of ``jax.grad`` run
  in float64 (the port's f32 autograd sits 1.1e-5 from it; JAX's own f32
  gradient sits 2.6e-4 from it, so the f64 run is the reference). The
  biases that feed a train-mode batch norm have zero gradient in exact
  arithmetic: both sides hold them below 1e-4 of their layer's kernel
  gradient. FPN's P4-P7, which the heads never read, get no gradient (None
  here, zeros in JAX).
- the Adam update given the same gradients: atol 1e-7 (updates ~1e-3).
- ``fit``: Adam's first steps are ~lr * sign(g), so a parameter whose
  gradient is near zero may move either way by up to 2 lr. After one step,
  parameters within 1e-6 where JAX's gradient is above 1e-3 of its
  tensor's largest entry (ten times the gradients' tolerance); after 3,
  within lr where every step's is, so no such entry took a flipped step
  (measured 6.6e-4: the later gradients read the earlier flips). P4-P7
  bitwise unchanged. The heads' dense_0 biases (zero gradient in exact
  arithmetic, so Adam steps on rounding noise) are not compared. The
  running averages after one step within 1e-6 of max(|stat|, 1); after 3
  they read the flipped steps of the branches behind a zero-initialised
  batch-norm scale (1.3e-3 of a vector's largest magnitude, measured) and
  are not compared. The losses of the first two steps within rtol 1e-5
  (measured 1.6e-6). The third step's loss already reads the sign flips of
  two steps: JAX's own f32 and f64 fits of this case differ by 1.2e-4 at
  step 2 and 1.5e-3 at step 4, the port's from JAX's f32 by 4.2e-4 at
  step 3 (measured), so it is held at rtol 1e-3.
- ``targets_from_labels`` and checkpoints: bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ark_tpu.models import unet as JU
from ark_tpu.segmentation import mesmer as JM
from ark_tpu.segmentation import synthetic as JS
from ark_tpu.segmentation import train as JT
from ark_tpu_torch.models import unet as TU
from ark_tpu_torch.segmentation import synthetic as TS
from ark_tpu_torch.segmentation import train as TT

torch.set_num_threads(2)

HW, BATCH = 64, 4
MINI_FLAX = dict(stage_sizes=(1, 1, 1, 1), base_width=16, fpn_channels=64,
                 head_upsample_filters=32, head_dense_features=64,
                 inner_activation="linear")
FIT_STEPS = 3
UNREAD = ("P4", "P5", "P6", "P7")      # FPN outputs the heads never read


def _targets(cell_labels, nuc_labels):
    ct, nt = JS.targets_from_labels(cell_labels), JS.targets_from_labels(nuc_labels)
    return {"whole_cell_inner_distance": ct["inner_distance"],
            "whole_cell_pixelwise": ct["pixelwise"],
            "nuclear_inner_distance": nt["inner_distance"],
            "nuclear_pixelwise": nt["pixelwise"]}


@pytest.fixture(scope="module")
def batch():
    imgs, cells, nucs = TS.synthetic_cells(np.random.default_rng(7), BATCH, hw=HW)
    return imgs, _targets(cells, nucs)


@pytest.fixture(scope="module")
def flax_mini():
    return JU.init_mesmer_mini(seed=0, input_shape=(1, HW, HW, 2))


def _torch_mini(variables):
    model = TU.PanopticNet(dtype=torch.float32, **TU.MINI_CONFIG)
    model.load_state_dict(TU.params_from_flax(variables))
    return model


def _loss_fn(model):
    def loss_fn(params, batch_stats, x, t):
        out, upd = model.apply({"params": params, "batch_stats": batch_stats}, x,
                               train=True, mutable=["batch_stats"])
        return JT.mesmer_loss(out, t, inner_weight=10.0), (out, upd["batch_stats"])
    return loss_fn


@pytest.fixture(scope="module")
def jax_value_and_grad(flax_mini):
    """One jitted train-mode value_and_grad, compiled once for the module."""
    return jax.jit(jax.value_and_grad(_loss_fn(flax_mini[0]), has_aux=True))


@pytest.fixture(scope="module")
def jax_step(flax_mini, batch, jax_value_and_grad):
    """JAX's f32 loss, heads, updated batch stats and gradients of one
    train-mode step."""
    _, variables = flax_mini
    imgs, targets = batch
    (loss, (out, stats)), grads = jax_value_and_grad(
        variables["params"], variables["batch_stats"], jnp.asarray(imgs),
        {k: jnp.asarray(v) for k, v in targets.items()})
    return jax.device_get((loss, out, stats, grads))


@pytest.fixture(scope="module")
def jax_grad_f64(flax_mini, batch):
    """``jax.grad`` of the same step computed in float64."""
    _, variables = flax_mini
    imgs, targets = batch
    enabled = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        model = JU.PanopticNet(dtype=jnp.float64, **MINI_FLAX)
        f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
        grads = jax.jit(jax.grad(lambda *a: _loss_fn(model)(*a)[0]))(
            jax.tree.map(f64, variables["params"]),
            jax.tree.map(f64, variables["batch_stats"]), f64(imgs),
            {k: f64(v) for k, v in targets.items()})
        return jax.tree.map(np.asarray, jax.device_get(grads))
    finally:
        jax.config.update("jax_enable_x64", enabled)


@pytest.fixture(scope="module")
def torch_step(flax_mini, batch):
    """The port's train-mode forward, loss and autograd gradients (flax
    names), and its model after the step's forward."""
    _, variables = flax_mini
    imgs, targets = batch
    model = _torch_mini(variables).train()
    out = model(torch.from_numpy(imgs))
    loss = TT.mesmer_loss(out, {k: torch.from_numpy(v) for k, v in targets.items()},
                          inner_weight=10.0)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), out, model, dict(zip(names, grads))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_mesmer_loss_matches_jax(batch):
    rng = np.random.default_rng(3)
    _, targets = batch
    out = {k: rng.random(v.shape[:3] + ((1,) if "inner" in k else (3,)),
                         dtype=np.float32) for k, v in targets.items()}
    for weights in ({}, {"inner_weight": 10.0, "pixelwise_weight": 0.5}):
        for keys in (list(targets), ["whole_cell_inner_distance", "nuclear_pixelwise"]):
            t = {k: targets[k] for k in keys}
            ref = JT.mesmer_loss({k: jnp.asarray(v) for k, v in out.items()},
                                 {k: jnp.asarray(v) for k, v in t.items()}, **weights)
            got = TT.mesmer_loss({k: torch.from_numpy(v) for k, v in out.items()},
                                 {k: torch.from_numpy(v) for k, v in t.items()}, **weights)
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_train_mode_forward_matches_flax(jax_step, torch_step):
    """Heads and the updated running averages of one train-mode forward."""
    loss, out, stats, _ = jax_step
    got_loss, got_out, model, _ = torch_step
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6)
    for k, ref in out.items():
        ref = np.asarray(ref)
        err = np.abs(got_out[k].detach().numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, (k, err)
    got_stats = TU.params_to_flax(dict(model.named_buffers()))["batch_stats"]
    paths = [p for p, _ in _leaves(stats)]
    assert sorted(p for p, _ in _leaves(got_stats)) == sorted(paths)
    for path, ref in _leaves(stats):
        got = _node(got_stats, path)
        err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
        assert err.max() <= 1e-6, (path, err.max())


def test_eval_mode_leaves_the_running_averages(flax_mini, batch):
    _, variables = flax_mini
    model = _torch_mini(variables).eval()
    before = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        model(torch.from_numpy(batch[0]))
    assert all(torch.equal(before[k], v) for k, v in model.named_buffers())


def test_gradients_match_jax_grad(jax_grad_f64, torch_step):
    _, _, _, grads = torch_step
    got = TU.params_to_flax({k: torch.zeros(()) if g is None else g
                             for k, g in grads.items()})["params"]
    assert {k for k, g in grads.items() if g is None} == {
        f"FPN_0.{p}.{leaf}" for p in UNREAD for leaf in ("weight", "bias")}
    checked = 0
    for path, ref in _leaves(jax_grad_f64):
        if path[1] in UNREAD:
            assert not ref.any(), path
            continue
        g = _node(got, path)
        if not ref.any():
            # behind a zero-initialised batch-norm scale: exactly zero
            assert not g.any(), path
            continue
        if path[-2:] == ("dense_0", "bias"):
            # feeds a train-mode batch norm: zero in exact arithmetic
            kernel = np.abs(_node(jax_grad_f64, path[:-1] + ("kernel",))).max()
            assert max(np.abs(g).max(), np.abs(ref).max()) <= 1e-4 * kernel, path
            continue
        err = np.abs(g - ref).max() / np.abs(ref).max()
        assert err <= 1e-4, (path, err)
        checked += 1
    assert checked > 60


def test_adam_update_matches_optax(flax_mini, jax_step):
    """Three updates given the same gradients (zeros for P4-P7 on the JAX
    side, None on the port's)."""
    _, variables = flax_mini
    grads = jax_step[3]
    model = _torch_mini(variables)
    names = [n for n, _ in model.named_parameters()]
    state = TU.params_from_flax({"params": grads})
    unread = tuple(f"FPN_0.{p}." for p in UNREAD)
    tgrads = [None if n.startswith(unread) else state[n] for n in names]
    opt = TT.Adam(list(model.parameters()), 1e-3)
    tx = optax.adam(1e-3)
    opt_state = tx.init(variables["params"])
    update = jax.jit(tx.update)
    for step in range(3):
        scale = 1.0 + step               # a different gradient each step
        upd, opt_state = update(jax.tree.map(lambda g: g * scale, grads), opt_state,
                                variables["params"])
        got = opt.update([None if g is None else g * scale for g in tgrads])
        ref = TU.params_from_flax({"params": upd})
        for n, u in zip(names, got):
            np.testing.assert_allclose(u.numpy(), ref[n].numpy(), rtol=0, atol=1e-7,
                                       err_msg=f"step {step} {n}")
            if n.startswith(unread):
                assert not u.any()


@pytest.fixture(scope="module")
def fits(flax_mini, jax_value_and_grad):
    """Both packages' fit, FIT_STEPS steps from the same weights on the same
    8 images (the schedule reshuffles them), with each step's JAX gradients
    and, after one step, JAX's parameters and the port's."""
    model, variables = flax_mini
    imgs, cells, nucs = TS.synthetic_cells(np.random.default_rng(11), 8, hw=HW,
                                           crowding=0.35)
    targets = _targets(cells, nucs)
    ref_vars, ref_losses = JT.fit(model, variables, imgs, targets, steps=FIT_STEPS,
                                  batch_size=BATCH, seed=0)
    order = TT.minibatch_order(8, FIT_STEPS, BATCH, 0)
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    step_grads = []
    for rows in order:
        (_, (_, stats)), g = jax_value_and_grad(
            params, stats, jnp.asarray(imgs[rows]),
            {k: jnp.asarray(v[rows]) for k, v in targets.items()})
        upd, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        step_grads.append(jax.device_get(g))
        if len(step_grads) == 1:
            first = jax.device_get((params, stats))
    tmodel, losses = TT.fit(_torch_mini(variables), imgs, targets, steps=FIT_STEPS,
                            batch_size=BATCH, seed=0, device="cpu")
    one_step, _ = TT.fit(_torch_mini(variables), imgs, targets, steps=1,
                         batch_size=BATCH, seed=0, device="cpu")
    return (jax.device_get(ref_vars), ref_losses, step_grads, tmodel, losses,
            jax.device_get(variables), first[0], first[1], one_step)


def test_fit_matches_jax_fit(fits):
    (ref_vars, ref_losses, step_grads, model, losses, start, first, first_stats,
     one_step) = fits
    assert losses.shape == (FIT_STEPS,) and losses.dtype == np.float32
    np.testing.assert_allclose(losses[:2], ref_losses[:2], rtol=1e-5)
    np.testing.assert_allclose(losses[2:], ref_losses[2:], rtol=1e-3)
    assert not model.training
    got = TU.params_to_flax(model.state_dict())
    compared = 0
    for path, ref in _leaves(ref_vars["params"]):
        g = _node(got["params"], path)
        if path[1] in UNREAD:
            np.testing.assert_array_equal(g, _node(start["params"], path))
            np.testing.assert_array_equal(ref, g)
            continue
        if path[-2:] == ("dense_0", "bias"):
            continue
        grads = [np.abs(_node(s, path)) for s in step_grads]
        reliable = [a > 1e-3 * a.max() for a in grads]
        np.testing.assert_allclose(_node(TU.params_to_flax(one_step.state_dict())["params"],
                                         path)[reliable[0]],
                                   _node(first, path)[reliable[0]], rtol=0, atol=1e-6,
                                   err_msg=f"one step {path}")
        reliable = np.all(reliable, axis=0)
        np.testing.assert_allclose(g[reliable], ref[reliable], rtol=0, atol=1e-3,
                                   err_msg=str(path))
        compared += int(reliable.sum())
    # 34% of the entries: the branches behind a zero-initialised batch-norm
    # scale get no gradient in the first step
    assert compared > 0.25 * sum(v.size for _, v in _leaves(ref_vars["params"]))
    one_stats = TU.params_to_flax(dict(one_step.named_buffers()))["batch_stats"]
    for path, ref in _leaves(first_stats):
        err = np.abs(_node(one_stats, path) - ref) / np.maximum(np.abs(ref), 1.0)
        assert err.max() <= 1e-6, (path, err.max())


def test_minibatch_order_is_the_jax_schedule():
    rng = np.random.default_rng(5)
    order = TT.minibatch_order(10, 7, 4, 5)
    want = np.concatenate([rng.permutation(10) for _ in range(3)])[:28].reshape(7, 4)
    np.testing.assert_array_equal(order, want)


@pytest.mark.parametrize("crowding", [0.0, 0.35])
@pytest.mark.parametrize("which", ["cell", "nuclear"])
def test_targets_from_labels_bitwise(crowding, which):
    _, cells, nucs = TS.synthetic_cells(np.random.default_rng(5), 4, hw=48,
                                        crowding=crowding)
    labels = cells if which == "cell" else nucs
    labels[1] = np.where(labels[1] == 2, 7, labels[1])   # a gap in the ids
    labels[2] = 0                                        # an empty image
    ref = JS.targets_from_labels(labels)
    got = TS.targets_from_labels(labels, device="cpu")
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_training_reduces_loss_quickly():
    """The port's copy of the JAX package's test: a fresh mini net, 12 steps
    on 32² images, and the deep-watershed loss drops."""
    imgs, cell_labels, _ = TS.synthetic_cells(np.random.default_rng(7), 8, hw=32)
    cell_t = TS.targets_from_labels(cell_labels, device="cpu")
    targets = {"whole_cell_inner_distance": cell_t["inner_distance"],
               "whole_cell_pixelwise": cell_t["pixelwise"]}
    model = TU.init_mesmer_mini(seed=0, device="cpu")
    _, losses = TT.fit(model, imgs, targets, steps=12, batch_size=4, seed=0, device="cpu")
    assert losses[-4:].mean() < losses[:4].mean()


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    """save_params_npz from the port: the JAX package's load_params_npz
    reads every tensor back bitwise, and its Mesmer builds the recorded
    architecture."""
    model = TU.init_mesmer_mini(seed=3, device="cpu")
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(len(name))))
    path = str(tmp_path / "port.npz")
    TU.save_params_npz(path, model, config=TT.MINI_CHECKPOINT_CONFIG)
    loaded, config = JU.load_params_npz(path, return_config=True)
    assert config == TT.MINI_CHECKPOINT_CONFIG
    want = TU.params_to_flax(model.state_dict())
    assert sorted(p for p, _ in _leaves(loaded)) == sorted(p for p, _ in _leaves(want))
    for path_, ref in _leaves(want):
        np.testing.assert_array_equal(np.asarray(_node(loaded, path_)), ref)
    app = JM.Mesmer(weights_path=path)
    assert app.model.base_width == 16 and app.model.inner_activation == "linear"
    state = TU.params_from_flax(app.variables)
    assert all(torch.equal(state[k], v) for k, v in model.state_dict().items())


def test_jax_checkpoint_round_trips_through_the_port(tmp_path):
    """The other direction: the JAX package's checkpoint, loaded by the port
    and saved again, gives the JAX package the same tensors bitwise."""
    src = str(tmp_path / "jax.npz")
    _, variables = JU.init_mesmer_mini(seed=4, input_shape=(1, 32, 32, 2))
    JU.save_params_npz(src, variables, config=TT.MINI_CHECKPOINT_CONFIG)
    model = TU.model_from_npz(src, device="cpu")
    dst = str(tmp_path / "port.npz")
    TU.save_params_npz(dst, model, config=TT.MINI_CHECKPOINT_CONFIG)
    ref, ref_config = JU.load_params_npz(src, return_config=True)
    got, config = JU.load_params_npz(dst, return_config=True)
    assert config == ref_config
    assert sorted(p for p, _ in _leaves(got)) == sorted(p for p, _ in _leaves(ref))
    for path, val in _leaves(ref):
        np.testing.assert_array_equal(np.asarray(_node(got, path)), val)


def test_params_to_flax_inverts_params_from_flax(flax_mini):
    _, variables = flax_mini
    tree = TU.params_to_flax(TU.params_from_flax(variables))
    for path, val in _leaves(jax.device_get(variables)):
        np.testing.assert_array_equal(_node(tree, path), val)
        assert _node(tree, path).dtype == np.float32


def test_train_on_synthetic_writes_the_jax_config(tmp_path):
    path = str(tmp_path / "w.npz")
    app, losses = TT.train_on_synthetic(steps=2, n_images=4, hw=32, seed=1,
                                        weights_out=path, device="cpu")
    assert losses.shape == (2,) and np.isfinite(losses).all()
    assert not app.model.training
    _, config = JU.load_params_npz(path, return_config=True)
    assert config == {"stage_sizes": [1, 1, 1, 1], "base_width": 16,
                      "fpn_channels": 64, "head_upsample_filters": 32,
                      "head_dense_features": 64, "inner_activation": "linear",
                      "dtype": "float32"}
    out = app.predict(TS.synthetic_cells(np.random.default_rng(2), 1, hw=32)[0])
    assert out["whole_cell"].shape == (1, 32, 32)


def test_training_precision_restores_the_flags():
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with TT.training_precision(TU.PanopticNet(dtype=torch.float32, **TU.MINI_CONFIG)):
        assert cudnn.deterministic and not cudnn.benchmark and not cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    with TT.training_precision(TU.PanopticNet(dtype=torch.bfloat16, **TU.MINI_CONFIG)):
        assert cudnn.deterministic and cudnn.allow_tf32 == before[2]
    assert (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.parametrize("sizes", [((3, 5), (6, 10)), ((2, 3), (3, 5)),
                                   ((6, 10), (13, 21)), ((12, 20), (48, 80))])
def test_resize_product_form_matches_jax_image_resize(sizes):
    """Under autograd the resize is jax.image.resize's two products: within
    the eval path's atol 2e-6 of it (measured 4.8e-7), and its gradient is
    the transposed products."""
    (h, w), (th, tw) = sizes
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: JU._bilinear_resize(a, th, tw), jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = TU._bilinear_resize(xt, th, tw)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=2e-6)
    cot = np.random.default_rng(1).normal(size=np.shape(ref)).astype(np.float32)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot).permute(0, 3, 1, 2))
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]), rtol=0, atol=1e-5)
