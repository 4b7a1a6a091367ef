"""Training the model variants: the port's train step against the JAX
package's, on the tiny model of tests/test_torch_variants.py.

The variants: the global and the cross-attention trunk (its gathered
contexts; 3 views, so the batch of the other views holds two), the
ablations preset (RoPE2D on the frame layers, no scale token), RADIO and
CroCo inside MapAnything, and the two pose families other than the released
one (+confidence+mask). None of them uses view PE, so no view-PE rows are
drawn. The last family also trains the disentangled criterion composed as
the JAX package composes it (forward, criterion, backward).

Both packages get the same weights: the port's own init, moved into JAX's
tree (`port_tree`, through utils/weights.py::from_jax_params's own mapping)
with seeded noise on every leaf, and the same seeded synthetic batch. JAX's
loss and gradients are its make_train_step's: overall_loss on model.apply,
differentiated in one pass: the forward and its pullback compiled once a
model, the loss's gradient with respect to the predictions once a loss and
shape. The port runs fp32, the JAX model fp32 under
jax.default_matmul_precision("highest"), and JAX's loss stage (the loss, its
details and d loss / d predictions, from the fp32 predictions) in fp64, as
tests/test_torch_seq_parallel.py's gradients: XLA's jitted fp32 CPU sum of
the joint normalisation (thousands of pixel distances) lies ~1.6e-5 off the
exact sum at 32x48, and the robust loss (scaling_c 0.05) amplifies that to
~1.2e-4 of a term, while the port's sum is exact to fp32. Limits, as
tests/test_torch_train.py (a) and (c): the loss, every detail and every
parameter gradient within 1e-4 of the reference's max-abs per tensor; the
group labels and the weight-decay mask leaf for leaf; each attention
launches its plain forward with lse and its plain backward once (CPU
tensors), no kernel.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapanything_tpu.data.synthetic import make_synthetic_batch as jax_batch
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models import images_only_config as jax_images_only
from mapanything_tpu.train import criteria as JC
from mapanything_tpu.train import losses as JL
from mapanything_tpu.train import step as JS
from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    dense_dim_for,
    images_only_config,
)
from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention,
    reset_launch_counts,
)
from mapanything_tpu_torch.train import criteria as PC
from mapanything_tpu_torch.train import step as PS
from mapanything_tpu_torch.utils.weights import (
    from_jax_params,
    load_jax_params,
)
from test_torch_variants import TINY
from torch_jax_init import prior_views

HIGHEST = "highest"
TOL = 1e-4
POSE_ARMS = {"campointmap_pose": "campointmap+pose+confidence+mask",
             "pointmap_raydirs_depth_pose":
             "pointmap+raydirs+depth+pose+confidence+mask"}
# name: (config fields, views, attention calls of one forward: the
# encoder's 2 blocks and the trunk's 2 layers, the cross trunk's 6 a layer)
VARIANTS = {
    "global": (dict(info_sharing_type="global"), 2, 4),
    "cross": (dict(info_sharing_type="cross"), 3, 14),
    "ablations": (dict(use_scale_token=False, trunk_rope_freq=100.0), 2, 4),
    "radio": (dict(encoder_type="radio", patch_size=16), 2, 4),
    "croco": (dict(encoder_type="croco", patch_size=16), 2, 4),
    **{name: (dict(scene_rep_type=srt, dense_output_dim=dense_dim_for(srt)),
              2, 4) for name, srt in POSE_ARMS.items()},
}


def composed(C):
    """The 16b criteria of chip_smoke.py, built from a criteria module:
    {name: (the family they train, the criterion)}."""
    robust = C.RobustRegressionLoss(alpha=0.5, scaling_c=0.05)
    mask = 0.3 * C.NonAmbiguousMaskLoss(C.BCELoss())
    disentangled = C.DisentangledFactoredGeometryScaleRegr3DPlusNormalGMLoss(
        robust, normal_loss_weight=3.0, gm_loss_weight=3.0)
    return {
        "regr3d": ("pointmap+confidence+mask", C.ConfLoss(
            C.Regr3D(robust, norm_mode="?avg_dis"), alpha=0.2) + mask),
        "points_plus_scale": ("raymap+depth+confidence+mask", C.ConfLoss(
            C.PointsPlusScaleRegr3D(robust), alpha=0.2) + mask),
        # sets: depth 0, ray directions 1, pose quats 2, pose trans 3,
        # scale 4, normal 5, gradient matching 6
        "disentangled": (POSE_ARMS["pointmap_raydirs_depth_pose"],
                         C.ConfAndExcludeTopNPercentPixelLoss(
                             disentangled, conf_alpha=0.2, top_n_percent=5,
                             conf_loss_set_indices=[0],
                             exclude_loss_set_indices=[1, 2, 3]) + mask),
    }


def port_tree(port, shapes):
    """JAX's parameter tree of the port model's values: each JAX leaf is
    filled with its element indices, from_jax_params maps them to the port's
    layout, and the port's values are scattered back by index."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    ends = np.cumsum([int(np.prod(leaf.shape)) for leaf in leaves])
    starts = ends - [int(np.prod(leaf.shape)) for leaf in leaves]
    index = treedef.unflatten([
        np.arange(lo, hi, dtype=np.float64).reshape(leaf.shape)
        for lo, hi, leaf in zip(starts, ends, leaves)])
    flat = np.full(int(ends[-1]), np.nan, np.float32)
    params = dict(port.named_parameters())
    for name, idx in from_jax_params(index, port).items():
        flat[np.asarray(idx, np.int64).ravel()] = (
            params[name].detach().numpy().ravel())
    assert not np.isnan(flat).any()
    return treedef.unflatten([flat[lo:hi].reshape(leaf.shape)
                              for lo, hi, leaf in zip(starts, ends, leaves)])


def model_pair(kw, seed):
    """(JAX model, its tree, the port model with the same weights, h, w):
    the port's own seeded init with N(0, 0.02^2) noise on every leaf."""
    h, w = (32, 48) if "patch_size" in kw else (28, 42)
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY,
                                             **kw))
    port = MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY, **kw),
                       device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), prior_views(1, 1, h, w), jax_images_only()))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(
            np.float32), port_tree(port, shapes))
    load_jax_params(port, tree)
    return jax_model, tree, port, h, w


def _floats(preds):
    return {k: v for k, v in preds.items() if v.dtype != bool}


@functools.lru_cache(maxsize=None)
def _jax_loss_grad(name):
    """jit of (gt, float predictions) -> ((loss, details), d loss / d
    predictions) for the released loss or a composed criterion; called in
    fp64 (jax.enable_x64)."""
    loss = (JL.overall_loss if name == "released"
            else composed(JC)[name][1])
    return jax.jit(jax.value_and_grad(lambda gt, pr: loss(gt, pr),
                                      argnums=1, has_aux=True))


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.asarray(x).dtype == np.float32
                        else np.asarray(x), tree)


def jax_reference(jax_model, tree, views, gt, losses):
    """{loss name: (loss, details, parameter gradients)} of JAX's step loss
    (the loss of model.apply's predictions) and its gradient."""
    with jax.default_matmul_precision(HIGHEST):
        def forward(p):
            return _floats(jax_model.apply(p, views, jax_images_only()))

        preds, pull = jax.jit(lambda p: jax.vjp(forward, p))(tree)
        backward = jax.jit(lambda fn, cot: fn(cot)[0])
        out = {}
        for name in losses:
            with jax.enable_x64(True):
                (loss, det), cot = _jax_loss_grad(name)(_f64(gt),
                                                        _f64(preds))
                loss, det, cot = jax.tree.map(np.asarray, (loss, det, cot))
            cot = jax.tree.map(lambda c: c.astype(np.float32), cot)
            out[name] = (loss, det, jax.tree.map(np.asarray,
                                                 backward(pull, cot)))
    return out


def port_loss_and_grads(port, batch, criterion=None):
    """(loss, details, {name: gradient}) of the port: make_train_step's
    loss_and_grads for the released loss, or the composed step's forward,
    criterion and backward. Checks each attention's plain launches: one
    forward in the no-grad forward; one forward with lse and one backward
    in the step."""
    named = list(port.named_parameters())
    reset_launch_counts()
    with torch.no_grad():
        port(batch["views"], images_only_config())
    calls = flash_attention.plain_launches
    reset_launch_counts()
    if criterion is None:
        loss_fn = PS.make_loss_fn(port, images_only_config())
    else:
        def loss_fn(b, generator=None):
            return criterion(b["gt"], port(b["views"], images_only_config()))
    loss, det, grads = PS.loss_and_grads(loss_fn, [p for _, p in named],
                                         batch)
    assert flash_attention.plain_launches == 2 * calls
    assert flash_attention.kernel_launches == 0
    return loss, det, dict(zip([n for n, _ in named], grads)), calls


def assert_close_max(out, ref, name):
    """max |out - ref| <= TOL * max |ref| (and finite)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    assert np.isfinite(out).all(), name
    err = np.abs(out - ref).max()
    assert err <= TOL * np.abs(ref).max(), f"{name}: max abs err {err:.3g}"


def check_step(port, got, ref):
    """The loss, its details and every parameter gradient."""
    (loss, det, grads), (ref_loss, ref_det, ref_grads) = got, ref
    assert_close_max(loss.numpy(), ref_loss, "loss")
    assert set(ref_det) <= set(det)
    for key in ref_det:
        assert_close_max(det[key].detach().numpy(), ref_det[key], key)
    ref_grads = from_jax_params(ref_grads, port)
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert_close_max(g.numpy(), ref_grads[name], f"d {name}")


def check_labels_and_decay(port, tree):
    """(c): the AdamW group labels and decay mask against optax's, leaf for
    leaf."""
    opt = PS.make_optimizer(PS.OptimConfig(), port)

    def mark(fn):
        return from_jax_params(jax.tree_util.tree_map_with_path(
            lambda path, x: np.full(np.shape(x), float(fn(path, x)),
                                    np.float32), tree), port)

    is_encoder = mark(lambda path, _: JS._group_label(path) == "encoder")
    decays = mark(lambda _, x: np.ndim(x) > 1)
    assert {"encoder", "rest"} == set(opt.labels)
    for name, label, decay in zip(opt.names, opt.labels, opt.decay):
        assert np.all(is_encoder[name] == (label == "encoder")), name
        assert np.all(decays[name] == decay), name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_step_matches_jax(variant):
    kw, views, calls = VARIANTS[variant]
    jax_model, tree, port, h, w = model_pair(kw, seed=21)
    check_labels_and_decay(port, tree)
    with jax.default_matmul_precision(HIGHEST):
        jbatch = jax_batch(1, views, h, w, seed=0)
    batch = make_synthetic_batch(1, views, h, w, seed=0, device="cpu")
    losses = ["released"] + (["disentangled"] if variant ==
                             "pointmap_raydirs_depth_pose" else [])
    ref = jax_reference(jax_model, tree, {"img": jbatch["views"]["img"]},
                        jbatch["gt"], losses)
    for name in losses:
        crit = None if name == "released" else composed(PC)[name][1]
        *got, launched = port_loss_and_grads(port, batch, crit)
        assert launched == calls, (name, launched)
        check_step(port, got, ref[name])
