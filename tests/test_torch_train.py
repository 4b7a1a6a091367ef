"""The port's training step against the JAX package's, on the tiny model.

The JAX MapAnything at the `_SLICE_CFG` of tests/test_torch_model.py gets its
init perturbed by seeded numpy noise; the port loads the same weights with
load_jax_params. The batch is make_synthetic_batch(1, 2, 28, 42) of each
package (the same numpy stream), fp32 throughout, the JAX side under
jax.default_matmul_precision("highest"). Tolerances:

  * (a) loss and every parameter gradient of one step: 1e-4 of the
    reference's max-abs per tensor (fp32 through a few dozen layers);
  * (b) the optimizer fed the same gradients as optax: parameters within
    1e-6 of the reference's max-abs per tensor, 3 steps, with and without
    accumulation (Adam's sign-like update would magnify gradient noise, so
    the optimizers are compared on identical gradients);
  * (c) the group labels and the weight-decay mask equal JAX's leaf for
    leaf;
  * (d) the losses of 3 whole steps within 1e-4 relative.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.data.synthetic import make_synthetic_batch as jax_batch
from mapanything_tpu.models import GeometricInputConfig as JaxGeomCfg
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models import images_only_config as jax_images_only
from mapanything_tpu.train import losses as JL
from mapanything_tpu.train import step as JS
from mapanything_tpu.utils import flops as JF
from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import (
    GeometricInputConfig,
    MapAnything,
    MapAnythingConfig,
    images_only_config,
)
from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention,
    reset_launch_counts,
)
from mapanything_tpu_torch.train import step as PS
from mapanything_tpu_torch.utils import flops as PF
from mapanything_tpu_torch.utils.weights import from_jax_params, load_jax_params
from torch_jax_init import init_params

HIGHEST = "highest"
H, W = 28, 42  # 2 x 3 patches of 14
_SLICE_CFG = dict(encoder_size="test", trunk_dim=128, trunk_depth=4,
                  trunk_num_heads=2, trunk_indices=(1, 2), dpt_feature_dim=32,
                  dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))


def _perturb(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape))
        .astype(np.float32), params)


@pytest.fixture(scope="module")
def setup():
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **_SLICE_CFG))
    # the tree holds the six prior encoders, which images-only steps leave
    # at zero gradient
    params = init_params(jax_model, H, W)
    with jax.default_matmul_precision(HIGHEST):
        jbatch = jax_batch(1, 2, H, W, seed=0)
    # both models get the images only
    jbatch = {"views": {"img": jbatch["views"]["img"]}, "gt": jbatch["gt"]}
    return jax_model, _perturb(params, 12), jbatch


def _port_model(params):
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **_SLICE_CFG),
                        device="cpu")
    return load_jax_params(model, params)


def _assert_close_max(out, ref, tol, name):
    """max |out - ref| <= tol * max |ref| (and finite)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    assert np.isfinite(out).all(), name
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: max abs err {err:.3g}"


def test_loss_and_gradients_match_jax(setup):
    jax_model, params, jbatch = setup

    def loss_fn(p):
        # JAX's make_train_step loss_fn
        preds = jax_model.apply(p, jbatch["views"], jax_images_only())
        return JL.overall_loss(jbatch["gt"], preds)

    with jax.default_matmul_precision(HIGHEST):
        (ref_loss, ref_det), ref_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = _port_model(params)
    ref_grads = from_jax_params(jax.tree.map(np.asarray, ref_grads), port)

    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cpu")
    names = [n for n, _ in port.named_parameters()]
    reset_launch_counts()
    loss, det, grads = PS.loss_and_grads(
        PS.make_loss_fn(port, images_only_config()),
        [p for _, p in port.named_parameters()], batch)
    # 2 encoder + 4 trunk attentions, forward with lse and backward, plain
    assert flash_attention.plain_launches == 12
    assert flash_attention.kernel_launches == 0
    _assert_close_max(loss.numpy(), np.asarray(ref_loss), 1e-4, "loss")
    for key in ref_det:
        _assert_close_max(det[key].detach().numpy(), np.asarray(ref_det[key]),
                          1e-4, key)
    for name, g in zip(names, grads):
        _assert_close_max(g.numpy(), ref_grads[name], 1e-4, f"d {name}")


def _own_copies(arrays, names):
    """Tensors holding copies of `arrays[name]`, sharing no memory with
    them."""
    return [torch.from_numpy(np.array(arrays[n], order="C"))
            for n in names]


def test_optimizer_gradients_do_not_alias_the_jax_inputs(setup):
    """The optimizer test's gradients share no memory with the numpy arrays
    handed to JAX: JAX's CPU client reads an argument's buffer after the
    jitted call has returned, and the port's in-place clip would change
    it under JAX (the cause of an intermittent optimizer mismatch)."""
    _, params, _ = setup
    port = _port_model(params)
    grads = jax.tree.map(np.asarray, params)
    leaves = jax.tree_util.tree_leaves(grads)
    converted = from_jax_params(grads, port)
    names = [n for n, _ in port.named_parameters()]
    # from_jax_params hands back views where the layout allows ...
    assert any(np.shares_memory(converted[n], leaf)
               for n in names for leaf in leaves)
    # ... and the copies share nothing
    for t in _own_copies(converted, names):
        assert not any(np.shares_memory(t.numpy(), leaf) for leaf in leaves)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_optimizer_matches_optax_on_same_gradients(setup, accum_steps):
    _, params, _ = setup
    cfg = dict(warmup_steps=2, total_steps=10, accum_steps=accum_steps)
    tx = JS.make_optimizer(JS.OptimConfig(**cfg), params)
    opt_state = tx.init(params)

    @jax.jit
    def optax_step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    port = _port_model(params)
    opt = PS.make_optimizer(PS.OptimConfig(**cfg), port)
    rng = np.random.default_rng(accum_steps)
    ref = params
    # the global norm is far above the clip at 1e-2 and far below at 1e-5
    for step, scale in enumerate((1e-2, 1e-5, 1e-2, 1e-2)[:2 + accum_steps]):
        grads = jax.tree.map(
            lambda x: (scale * rng.standard_normal(x.shape)).astype(
                np.float32), params)
        ref, opt_state = optax_step(grads, opt_state, ref)
        # the port clips its gradients in place (AdamW.step's contract), so
        # it gets copies: from_jax_params returns views of `grads`, which
        # the jitted optax step may still be reading after it returns
        opt.step(_own_copies(from_jax_params(grads, port), opt.names))
        want = from_jax_params(jax.tree.map(np.asarray, ref), port)
        for name, p in zip(opt.names, opt.params):
            _assert_close_max(p.detach().numpy(), want[name], 1e-6,
                              f"step {step} {name}")


def test_group_labels_and_decay_mask_match_jax(setup):
    _, params, _ = setup
    port = _port_model(params)
    opt = PS.make_optimizer(PS.OptimConfig(), port)

    def mark(fn):  # a per-leaf flag, as a full array so that it converts
        return from_jax_params(jax.tree_util.tree_map_with_path(
            lambda path, x: np.full(np.shape(x), float(fn(path, x)),
                                    np.float32), params), port)

    is_encoder = mark(lambda path, _: JS._group_label(path) == "encoder")
    decays = mark(lambda _, x: np.ndim(x) > 1)
    assert any(lab == "encoder" for lab in opt.labels)
    assert any(lab == "rest" for lab in opt.labels)
    for name, label, decay in zip(opt.names, opt.labels, opt.decay):
        assert np.all(is_encoder[name] == (label == "encoder")), name
        assert np.all(decays[name] == decay), name


def test_three_steps_match_jax(setup):
    jax_model, params, jbatch = setup
    cfg = dict(warmup_steps=2, total_steps=100)
    with jax.default_matmul_precision(HIGHEST):
        state = JS.create_train_state(jax_model, params, JS.OptimConfig(**cfg))
        step = jax.jit(JS.make_train_step(jax_model, jax_images_only()))
        ref = []
        for _ in range(3):
            state, m = step(state, jbatch, jax.random.PRNGKey(0))
            ref.append((float(m["loss"]), float(m["grad_norm"])))

    port = _port_model(params)
    train_step = PS.make_train_step(port, images_only_config())
    tstate = PS.create_train_state(port, PS.OptimConfig(**cfg))
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cpu")
    for i, (ref_loss, ref_norm) in enumerate(ref):
        tstate, m = train_step(tstate, batch)
        assert abs(float(m["loss"]) - ref_loss) <= 1e-4 * abs(ref_loss), i
        assert abs(float(m["grad_norm"]) - ref_norm) <= 1e-4 * ref_norm, i
    assert tstate.step == 3 and tstate.optimizer.count == 3


def test_step_rejects_geometric_inputs(setup):
    """The step once refused every prior; with GeometricInputConfig() (every
    prior on) its loss and gradients now match JAX's step on the batch's
    priors, within (a)'s 1e-4."""
    jax_model, params, _ = setup
    with jax.default_matmul_precision(HIGHEST):
        jbatch = jax_batch(1, 2, H, W, seed=0)

        def loss_fn(p):
            preds = jax_model.apply(p, jbatch["views"], JaxGeomCfg())
            return JL.overall_loss(jbatch["gt"], preds)

        (ref_loss, _), ref_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = _port_model(params)
    ref_grads = from_jax_params(jax.tree.map(np.asarray, ref_grads), port)
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cpu")
    named = list(port.named_parameters())
    loss, _, grads = PS.loss_and_grads(
        PS.make_loss_fn(port, GeometricInputConfig()),
        [p for _, p in named], batch)
    _assert_close_max(loss.numpy(), np.asarray(ref_loss), 1e-4, "loss")
    for (name, _), g in zip(named, grads):
        _assert_close_max(g.numpy(), ref_grads[name], 1e-4, f"d {name}")
    assert any(float(g.abs().max()) > 0 for (name, _), g in zip(named, grads)
               if name.startswith("cam_rot_encoder"))


@pytest.mark.parametrize("res,views", [(518, 1), (518, 4), (392, 32)])
def test_flop_counts_match_jax(res, views):
    assert PF.analytic_flops(res, views) == JF.analytic_flops(res, views)
    assert PF.train_step_flops(res, views) == JF.train_step_flops(res, views)
    assert (PF.global_attention_tokens(res, views)
            == JF.global_attention_tokens(res, views))
