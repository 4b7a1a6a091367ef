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
  * (d) the losses of 3 whole steps within 1e-4 relative;
  * (e) AdamW reading its per-step scalars from its device tensor against
    the Python-float arithmetic: moments bitwise, parameters within one
    unit in the last place a step, across warmup, cosine and a resume;
  * (f) the rule that engages the step's CUDA graphs, on the step's
    inputs, the CPU's steps all eager, and the device constants a graph
    reads kept for the process (the graphs themselves:
    tests/test_torch_train_cuda.py).
"""

from types import SimpleNamespace

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


def _python_float_adamw(cfg, opt, params, mu, nu, grads, count):
    """The inner step as AdamW once computed it, its learning rate and bias
    corrections passed to the foreach ops as Python floats (count: the
    steps taken before this one)."""
    lr = PS.cosine_schedule(cfg)(count)
    count += 1
    norm = PS.global_norm(grads)
    clip = torch.where(norm < cfg.grad_clip, 1.0, cfg.grad_clip / norm)
    torch._foreach_mul_(grads, clip)
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, grads, alpha=1 - cfg.b1)
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - cfg.b2)
    denom = torch._foreach_div(nu, 1 - cfg.b2 ** count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, 1e-8)
    upd = torch._foreach_div(mu, 1 - cfg.b1 ** count)
    torch._foreach_div_(upd, denom)
    decayed = [i for i, d in enumerate(opt.decay) if d]
    torch._foreach_add_([upd[i] for i in decayed],
                        [params[i] for i in decayed], alpha=cfg.weight_decay)
    for label, scale in (("encoder", cfg.encoder_lr_scale), ("rest", 1.0)):
        idx = [i for i, g in enumerate(opt.labels) if g == label]
        torch._foreach_add_([params[i] for i in idx], [upd[i] for i in idx],
                            alpha=-(lr * scale))
    return lr


def test_adamw_device_scalars_match_python_floats(setup, tmp_path):
    """AdamW reading its learning rates and bias corrections from the
    device tensor `scalars` against the Python-float arithmetic, over 6
    steps across the end of the warmup (2 steps) and into the cosine, with
    a resume through train/checkpoints.py after the third. The moments
    follow their own trajectory on both sides and match bitwise; each
    step's parameters, from the same parameters before it, within one
    unit in the last place of the larger of their values before and after
    (the new update rounds lr * update before the addition that the old
    one fused)."""
    from mapanything_tpu_torch.train.checkpoints import (load_train_state,
                                                         save_train_state)

    _, params, _ = setup
    cfg = PS.OptimConfig(warmup_steps=2, total_steps=8)
    state = PS.create_train_state(_port_model(params), cfg)
    opt = state.optimizer
    mu = [torch.zeros_like(p) for p in opt.params]
    nu = [torch.zeros_like(p) for p in opt.params]
    rng = np.random.default_rng(5)
    lrs = []
    for step in range(6):
        if step == 3:  # resume into a fresh model and optimizer
            path = str(tmp_path / "ckpt")
            save_train_state(path, state)
            state = PS.create_train_state(_port_model(params), cfg)
            state, _, _ = load_train_state(path, state)
            opt = state.optimizer
            assert opt.count == 3
        # the norm far above the clip on even steps, far below on odd ones
        scale = 1e-2 if step % 2 == 0 else 1e-5
        grads = [torch.from_numpy(
            (scale * rng.standard_normal(p.shape)).astype(np.float32))
            for p in opt.params]
        before = [p.detach().clone() for p in opt.params]
        want = [b.clone() for b in before]
        lrs.append(_python_float_adamw(cfg, opt, want, mu, nu,
                                       [g.clone() for g in grads], step))
        opt.step(grads)
        enc, rest, bias1, bias2 = opt.scalars.tolist()
        assert (enc, rest) == (np.float32(-lrs[-1] * cfg.encoder_lr_scale),
                               np.float32(-lrs[-1]))
        assert (bias1, bias2) == (np.float32(1 - cfg.b1 ** (step + 1)),
                                  np.float32(1 - cfg.b2 ** (step + 1)))
        for i, name in enumerate(opt.names):
            assert torch.equal(opt.mu[i], mu[i]), f"step {step} mu {name}"
            assert torch.equal(opt.nu[i], nu[i]), f"step {step} nu {name}"
            ulp = np.spacing(np.maximum(np.abs(before[i].numpy()),
                                        np.abs(want[i].numpy())))
            gap = np.abs(opt.params[i].detach().numpy() - want[i].numpy())
            assert (gap <= ulp).all(), f"step {step} {name}"
    assert lrs[0] == 0.0 and lrs[2] == cfg.lr and lrs[5] < lrs[3]


def test_graph_engagement_rule(setup):
    """step_signature, next_path and graphable: the step's inputs alone
    decide whether it replays, is captured or runs eagerly, and whether
    the graphs kept are dropped (a new binding)."""
    _, params, _ = setup
    model = _port_model(params)
    geom = images_only_config()
    state = PS.create_train_state(model, PS.OptimConfig())
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cpu")
    gen = torch.Generator()
    sig = PS.step_signature(state, batch, gen, geom)
    # the same signature: eager once, captured once, then replayed
    other = make_synthetic_batch(1, 2, H, W, seed=1, device="cpu")
    assert PS.step_signature(state, other, gen, geom) == sig
    assert PS.next_path(sig, set(), {}) == "eager"
    assert PS.next_path(sig, {sig}, {}) == "capture"
    assert PS.next_path(sig, {sig}, {sig: None}) == "replay"
    # a new shape or geometric config: eager first, under the same
    # binding, so the graphs of the other shapes are kept
    wider = make_synthetic_batch(1, 2, H, W + 14, seed=0, device="cpu")
    for new in (PS.step_signature(state, wider, gen, geom),
                PS.step_signature(state, batch, gen,
                                  GeometricInputConfig())):
        assert new != sig and new[0] == sig[0]
        assert PS.next_path(new, {sig}, {sig: None}) == "eager"
        assert PS.next_path(new, {sig, new}, {sig: None}) == "capture"
    # a new generator or state: a new binding, which drops the graphs
    fresh = PS.create_train_state(model, PS.OptimConfig())
    for new in (PS.step_signature(state, batch, torch.Generator(), geom),
                PS.step_signature(fresh, batch, gen, geom)):
        assert new[0] != sig[0] and new[1] == sig[1]
    # a moment replaced in place of the optimizer's
    fresh.optimizer.mu = list(state.optimizer.mu)
    fresh.optimizer.nu = list(state.optimizer.nu)
    fresh.optimizer.scalars = state.optimizer.scalars
    fresh.optimizer.mu[0] = torch.zeros_like(fresh.optimizer.mu[0])
    assert PS.step_signature(fresh, batch, gen, geom)[0] != sig[0]
    assert PS.next_path(None, {sig}, {sig: None}) == "eager"
    # graphable: parameters and batch on the card, no mesh, no accumulation
    card = torch.device("cuda", 0)

    def fake(acc=None, batch_tensor=None):
        opt = SimpleNamespace(params=[SimpleNamespace(device=card)], acc=acc)
        views = {} if batch_tensor is None else {"img": batch_tensor}
        return SimpleNamespace(optimizer=opt), {"views": views, "gt": {}}

    assert PS.graphable(*fake())
    assert not PS.graphable(*fake(), mesh=SimpleNamespace())
    assert not PS.graphable(*fake(acc=[]))
    assert not PS.graphable(*fake(batch_tensor=torch.zeros(1)))  # off it
    assert not PS.graphable(state, batch)  # the CPU
    acc_state = PS.create_train_state(model, PS.OptimConfig(accum_steps=2))
    assert not PS.graphable(acc_state, batch)


def test_cpu_steps_stay_eager(setup):
    """Every step on the CPU runs eagerly, accumulation or not, and the
    counter says so."""
    _, params, _ = setup
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cpu")
    batch = {"views": {"img": batch["views"]["img"]}, "gt": batch["gt"]}
    for accum in (1, 2):
        port = _port_model(params)
        step = PS.make_train_step(port, images_only_config())
        state = PS.create_train_state(port, PS.OptimConfig(accum_steps=accum))
        for _ in range(3):
            state, _ = step(state, batch)
        assert step.counts == {"captures": 0, "replays": 0, "eager": 3}
        assert state.step == 3 and state.optimizer.count == 3 // accum


def test_device_constants_outlive_other_sizes():
    """utils/device.py::device_constant keeps every size's tensors: a
    captured step reads them by address, so other sizes made in between
    (more than a bounded cache would hold) leave the first size's tensor
    the same object."""
    from mapanything_tpu_torch.utils.device import device_constant

    made = []

    @device_constant
    def table(n, device):
        made.append(n)
        return torch.arange(n, dtype=torch.float32, device=device)

    first = table(3, "cpu")
    for n in range(4, 40):
        table(n, "cpu")
    assert table(3, "cpu") is first
    assert made == list(range(3, 40))
