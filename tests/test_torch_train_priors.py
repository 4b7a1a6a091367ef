"""Training with geometric priors (the stochastic prior mix) against the JAX
package, on the CPU.

The JAX MapAnything at the tiny config of tests/test_torch_seq_parallel.py
is initialised on views carrying every prior and perturbed by seeded numpy
noise; the port loads the same weights. The batch is make_synthetic_batch
(1, 2, 28, 42) of each package (the same numpy stream, every prior in its
views). fp32 on both sides, JAX under
jax.default_matmul_precision("highest"). Tolerances:

  * (a) the deterministic presets: the port's step loss function and its
    gradients against the loss function of JAX's make_train_step, loss
    and every parameter gradient within 1e-4 of the reference's max-abs
    (tests/test_torch_train.py's limit);
  * (b) `aug_training` at B = 1: each of the port's draws for a generator
    seed (draw_prior_masks, the draws the step makes from that seed)
    written as a 0/1 config plus `*_valid` view keys (the sparse pixels
    applied to the input depth); JAX's loss and gradients on that input
    within the same 1e-4. A per-view `norm_all` draw has no 0/1 form, so
    (b) takes the seeds whose `norm_all` draws are all 0, chosen until the
    seeds cover every modality both on and off, the sparse gate on, a
    dropped sample and a dropped view;
  * (c) every mask's share over many draws within a 4-sigma binomial bound
    of its probability, `norm_all` and the kept pixels included.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.data.synthetic import make_synthetic_batch as jax_batch
from mapanything_tpu.models import GeometricInputConfig as JaxGeomCfg
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models import tasks as JTasks
from mapanything_tpu.train import losses as JL
from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    aug_training_config,
    tasks as PTasks,
)
from mapanything_tpu_torch.models.mapanything import draw_prior_masks
from mapanything_tpu_torch.train import step as PS
from mapanything_tpu_torch.utils.weights import from_jax_params, load_jax_params
from torch_jax_init import init_params

HIGHEST = "highest"
B, V, H, W = 1, 2, 28, 42
TINY = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
            trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
            dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
PRESETS = ["calibrated_sfm", "mvs", "registration", "pass_through",
           "posed_sfm_non_metric"]


def _perturb(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def _assert_close_max(out, ref, tol, name):
    """max |out - ref| <= tol * max |ref| (and finite)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    assert np.isfinite(out).all(), name
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: max abs err {err:.3g}"


@pytest.fixture(scope="module")
def setup():
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY))
    params = _perturb(init_params(jax_model, H, W), 31)
    with jax.default_matmul_precision(HIGHEST):
        jbatch = jax.tree.map(np.asarray, jax_batch(B, V, H, W, seed=0))
    port = load_jax_params(
        MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY),
                    device="cpu"), params)
    return jax_model, params, jbatch, port


def _jax_value_and_grad(jax_model, geom):
    """JAX make_train_step's loss_fn, differentiated: (params, views, gt)
    -> ((loss, details), grads)."""

    def loss_fn(params, views, gt):
        preds = jax_model.apply(params, views, geom)
        return JL.overall_loss(gt, preds)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _check_against_jax(port, ref_loss, ref_grads, batch, geom, generator):
    named = list(port.named_parameters())
    ref_grads = from_jax_params(jax.tree.map(np.asarray, ref_grads), port)
    loss, _, grads = PS.loss_and_grads(
        PS.make_loss_fn(port, geom), [p for _, p in named], batch, generator)
    _assert_close_max(loss.numpy(), np.asarray(ref_loss), 1e-4, "loss")
    for (name, _), g in zip(named, grads):
        _assert_close_max(g.numpy(), ref_grads[name], 1e-4, f"d {name}")


@pytest.mark.parametrize("task", PRESETS)
def test_preset_step_matches_jax(setup, task):
    jax_model, params, jbatch, port = setup
    with jax.default_matmul_precision(HIGHEST):
        (ref_loss, _), ref_grads = _jax_value_and_grad(
            jax_model, JTasks.task_config(task))(params, jbatch["views"],
                                                 jbatch["gt"])
    batch = make_synthetic_batch(B, V, H, W, seed=0, device="cpu")
    _check_against_jax(port, ref_loss, ref_grads, batch,
                       PTasks.task_config(task), None)


# --- aug_training ------------------------------------------------------------


def _draws(seed):
    return draw_prior_masks(aug_training_config(), B, V, "cpu",
                            torch.Generator().manual_seed(seed), (H, W))


def _coverage(m):
    """The cases a draw covers (module docstring, (b))."""
    per_sample = m["keep"] & m["overall"]
    cases = set()
    for name in ("ray", "depth", "cam"):
        on = bool((m[name] & per_sample).any())
        cases.add(f"{name}_{'on' if on else 'off'}")
    if bool(m["sparse"].all() and (m["depth"] & per_sample).any()):
        cases.add("sparse_on")
    if not bool(m["overall"].all()):
        cases.add("sample_dropped")
    if bool(m["overall"].all()) and not bool(m["keep"].all()):
        cases.add("view_dropped")
    return cases


def _chosen_seeds():
    want = {f"{n}_{s}" for n in ("ray", "depth", "cam") for s in ("on", "off")}
    want |= {"sparse_on", "sample_dropped", "view_dropped"}
    seeds, covered = [], set()
    for seed in range(2000):
        m = _draws(seed)
        if m["depth_norm_all"].any() or m["pose_norm_all"].any():
            continue  # no 0/1 form
        new = _coverage(m) - covered
        if new:
            seeds.append(seed)
            covered |= new
        if covered == want:
            return seeds
    raise AssertionError(f"seeds cover {sorted(covered)} only")


def _as_jax_views(views, m):
    """The port's draws m as `*_valid` keys of the JAX views, and the kept
    pixels applied to the depth where the sparse gate holds."""
    per_sample = (m["keep"] & m["overall"]).numpy()
    out = dict(views)
    for name, key in (("ray", "ray_dirs_valid"), ("depth", "depth_valid"),
                      ("cam", "pose_valid")):
        out[key] = m[name].numpy() & per_sample
    if bool(m["sparse"].all()):
        out["depth_along_ray"] = (views["depth_along_ray"]
                                  * m["keep_px"].numpy())
    return out


def test_aug_training_step_matches_jax_per_draw(setup):
    jax_model, params, jbatch, port = setup
    seeds = _chosen_seeds()
    assert 3 <= len(seeds) <= 9, seeds
    # every draw of a chosen seed: all probabilities 1, norm_all never
    geom = JaxGeomCfg(overall_prob=1.0, dropout_prob=0.0, ray_dirs_prob=1.0,
                      depth_prob=1.0, cam_prob=1.0, sparse_depth_prob=0.0,
                      depth_scale_norm_all_prob=0.0,
                      pose_scale_norm_all_prob=0.0)
    value_and_grad = _jax_value_and_grad(jax_model, geom)
    batch = make_synthetic_batch(B, V, H, W, seed=0, device="cpu")
    for seed in seeds:
        views = _as_jax_views(jbatch["views"], _draws(seed))
        with jax.default_matmul_precision(HIGHEST):
            (ref_loss, _), ref_grads = value_and_grad(params, views,
                                                      jbatch["gt"])
        _check_against_jax(port, ref_loss, ref_grads, batch,
                           aug_training_config(),
                           torch.Generator().manual_seed(seed))


def test_aug_training_mask_shares():
    cfg = aug_training_config()
    b, v, px = 4096, 8, (8, 8)
    m = draw_prior_masks(cfg, b, v, "cpu", torch.Generator().manual_seed(3),
                         px)
    probs = {"overall": cfg.overall_prob, "keep": 1.0 - cfg.dropout_prob,
             "ray": cfg.ray_dirs_prob, "depth": cfg.depth_prob,
             "cam": cfg.cam_prob, "sparse": cfg.sparse_depth_prob,
             "depth_norm_all": cfg.depth_scale_norm_all_prob,
             "pose_norm_all": cfg.pose_scale_norm_all_prob,
             "keep_px": 1.0 - cfg.sparsification_removal_percent}
    assert set(m) == set(probs)
    shapes = {"keep": (b, v), "depth_norm_all": (b, v),
              "pose_norm_all": (b, v), "keep_px": (b, v, *px, 1)}
    for key, p in probs.items():
        assert m[key].dtype == torch.bool, key
        assert tuple(m[key].shape) == shapes.get(key, (b, 1)), key
        n = m[key].numel()
        share = float(m[key].float().mean())
        bound = 4.0 * np.sqrt(p * (1.0 - p) / n)
        assert abs(share - p) <= bound, (key, share, p, bound)
    # the draws are independent of each other: the per-sample masks agree
    # with each other no more than chance
    both = float((m["ray"] & m["depth"]).float().mean())
    assert abs(both - 0.25) <= 4.0 * np.sqrt(0.25 * 0.75 / b), both


def test_deterministic_masks_draw_nothing():
    """Probabilities of 0 and 1 are constant masks: a deterministic config
    leaves the generator untouched but for the sparse pixels."""
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    for task in PRESETS:
        m = draw_prior_masks(PTasks.task_config(task), 2, 3, "cpu", gen,
                             (4, 4))
        assert "keep_px" not in m
        cfg = dataclasses.asdict(PTasks.task_config(task))
        assert bool(m["ray"].all()) == (cfg["ray_dirs_prob"] == 1.0)
    assert torch.equal(gen.get_state(), state)
    sparse = draw_prior_masks(PTasks.task_config("registration_sparse"), 2, 3,
                              "cpu", gen, (4, 4))
    assert tuple(sparse["keep_px"].shape) == (2, 3, 4, 4, 1)
    assert not torch.equal(gen.get_state(), state)


def test_stochastic_step_is_seeded(setup):
    """The aug_training step is a function of its generator's seed: the same
    seed gives the same loss, and the masks (hence the loss) change over
    seeds."""
    port = setup[3]
    batch = make_synthetic_batch(B, V, H, W, seed=0, device="cpu")
    loss_fn = PS.make_loss_fn(port, aug_training_config())
    with torch.no_grad():
        losses = [float(loss_fn(batch, torch.Generator().manual_seed(s))[0])
                  for s in (0, 0, 1, 2, 3, 4)]
    assert losses[0] == losses[1]
    assert len(set(losses[1:])) > 1
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        loss_fn(batch)
