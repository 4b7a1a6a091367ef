"""Geometric priors on the view-sharded path, on CPU ranks over gloo at p = 2
and p = 4, against the JAX package and against the port's unsharded calls.

One spawn of p ranks per ring size runs two checks on each rank ((c) is
tests/test_torch_train_priors_sharded.py, which reuses this module's
helpers):

  (a) view_sharded_forward with BASELINE config 3's priors (intrinsics as
      rays, camera-to-world poses, the metric flag; the `mvs` preset) on 4
      views against JAX's model.apply of the same views: every output
      within 1e-4 of the reference's max-abs (at least 1), the tolerance of
      tests/test_torch_priors.py;
  (b) make_view_sharded_train_step with `aug_training` against the port's
      unsharded make_train_step, the generators seeded alike, 2 steps on 2
      samples x 4 views: the masks are the same draws, so the two differ
      by the reduction order alone: the losses and grad norms within 1e-6
      relative, each step's gradient within rel-L2 1e-6; the parameters,
      where AdamW's m / sqrt(v) magnifies that rounding on gradients near
      zero, at test_torch_seq_parallel.py's rtol 5e-3 / atol 5e-5;
  (c) make_view_sharded_train_step with `pass_through` (every prior)
      against JAX's train step, 2 steps, at tests/test_torch_seq_parallel.
      py's tolerances: loss rtol 1e-4, grad_norm rtol 2e-3, the parameters
      rtol 5e-3 / atol 5e-5, the same on every rank.

JAX is imported inside the fixture only, so the spawned ranks load torch
alone.
"""

import os

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    aug_training_config,
    tasks as PTasks,
)
from mapanything_tpu_torch.parallel import spawn_cpu_ranks
from mapanything_tpu_torch.parallel.inference import view_sharded_forward
from mapanything_tpu_torch.parallel.ring_check import config3_views
from mapanything_tpu_torch.train import step as PS
from mapanything_tpu_torch.train.seq_parallel import (
    make_view_sharded_train_step,
)
from mapanything_tpu_torch.utils import inference as PI

TINY = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
            trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
            dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
H, W = 28, 42
VIEWS = 4
OPTIM = dict(warmup_steps=1, total_steps=10)
STEPS = 2
AUG_SEED = 5


def _model(folder):
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY),
                        device="cpu")
    model.load_state_dict(torch.load(os.path.join(folder, "model.pt")))
    return model


def _infer_views():
    rng = np.random.default_rng(40)
    views = [{"img": rng.standard_normal((1, H, W, 3)).astype(np.float32),
              "data_norm_type": ["dinov2"]} for _ in range(VIEWS)]
    return config3_views(views)


def _step_batch():
    return make_synthetic_batch(2, VIEWS, 28, 28, seed=22, device="cpu")


class _Recording(PS.TrainState):
    """A TrainState that keeps a copy of every step's gradients."""

    def apply_gradients(self, grads, norm=None):
        self.grads = getattr(self, "grads", []) + [
            torch.cat([g.flatten() for g in grads]).clone()]
        return super().apply_gradients(grads, norm)


def _steps(model, step, geom_seed):
    """STEPS steps: losses, grad norms, each step's flat gradient and the
    final flat parameters."""
    state = _Recording(model, PS.make_optimizer(PS.OptimConfig(**OPTIM),
                                                model))
    gen = None if geom_seed is None else torch.Generator().manual_seed(
        geom_seed)
    batch = _step_batch()
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    params = torch.cat([p.detach().flatten() for p in model.parameters()])
    return {"losses": np.asarray(losses), "norms": np.asarray(norms),
            "grads": torch.stack(state.grads).numpy(),
            "params": params.numpy()}


def _rank(group, folder):
    import torch.distributed as dist

    rank = dist.get_rank(group)
    res = {}
    # (a) the sharded forward with config 3's priors
    batched = PI.stack_views(PI.preprocess_input_views_for_inference(
        _infer_views()))
    with torch.no_grad():
        out = view_sharded_forward(_model(folder), batched, group,
                                   PTasks.task_config("mvs"))
    res.update({f"infer.{k}": v.float().numpy() for k, v in out.items()})
    # (b) the stochastic step, against the unsharded one in the parent
    model = _model(folder)
    step = make_view_sharded_train_step(model, aug_training_config(),
                                        group=group)
    res.update({f"aug.{k}": v for k, v in _steps(model, step,
                                                 AUG_SEED).items()})
    np.savez(os.path.join(folder, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX init perturbed by seeded noise, and the port loading it."""
    import jax

    import jax.numpy as jnp

    from mapanything_tpu.models import MapAnything as JaxMapAnything
    from mapanything_tpu.models import MapAnythingConfig as JaxConfig
    from mapanything_tpu_torch.utils.weights import load_jax_params
    from torch_jax_init import init_params

    folder = str(tmp_path_factory.mktemp("sharded"))
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY))
    rng = np.random.default_rng(41)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape))
        .astype(np.float32), init_params(jax_model, H, W))
    port = load_jax_params(
        MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY),
                    device="cpu"), params)
    torch.save(port.state_dict(), os.path.join(folder, "model.pt"))
    return folder, params, port


def run_ranks(cache, p, weights, rank_fn):
    """Every rank's results of rank_fn(group, folder) at ring size p, once
    per module (`cache`)."""
    if p not in cache:
        folder = os.path.join(weights[0], f"{rank_fn.__name__}_p{p}")
        os.makedirs(folder)
        torch.save(torch.load(os.path.join(weights[0], "model.pt")),
                   os.path.join(folder, "model.pt"))
        spawn_cpu_ranks(rank_fn, p, folder)
        cache[p] = [dict(np.load(os.path.join(folder, f"rank{r}.npz")))
                    for r in range(p)]
    return cache[p]


@pytest.fixture(scope="module")
def refs(weights):
    """JAX's outputs for (a); the port's unsharded steps for (b)."""
    import jax
    import jax.numpy as jnp

    from mapanything_tpu.models import MapAnything as JaxMapAnything
    from mapanything_tpu.models import MapAnythingConfig as JaxConfig
    from mapanything_tpu.models import tasks as JTasks
    from mapanything_tpu.utils import inference as JI

    folder, params, _ = weights
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY))
    views = JI.stack_views(JI.preprocess_input_views_for_inference(
        _infer_views()))
    with jax.default_matmul_precision("highest"):
        infer = jax.tree.map(np.asarray, jax_model.apply(
            params, views, JTasks.task_config("mvs")))
    model = _model(folder)
    aug = _steps(model, PS.make_train_step(model, aug_training_config()),
                 AUG_SEED)
    return infer, aug


_RANKS = {}


@pytest.fixture(params=[2, 4], ids=["p2", "p4"])
def run(request, weights, refs):
    infer, aug = refs
    return dict(infer=infer, aug=aug,
                ranks=run_ranks(_RANKS, request.param, weights, _rank))


def _close_rel(out, ref, tol, name):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    assert np.isfinite(out).all(), name
    err = np.max(np.abs(out - ref))
    bound = tol * max(1.0, float(np.max(np.abs(ref))))
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


def test_sharded_forward_with_config3_priors_matches_jax(run):
    for rank in run["ranks"]:
        keys = {k[6:] for k in rank if k.startswith("infer.")}
        assert keys == set(run["infer"]), sorted(keys)
        for key in keys:
            _close_rel(rank[f"infer.{key}"], run["infer"][key], 1e-4, key)


def test_sharded_aug_training_step_matches_unsharded(run):
    ref = run["aug"]
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank["aug.losses"], ref["losses"],
                                   rtol=1e-6)
        np.testing.assert_allclose(rank["aug.norms"], ref["norms"],
                                   rtol=1e-6)
        for i, (got, want) in enumerate(zip(rank["aug.grads"],
                                            ref["grads"])):
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= 1e-6, f"step {i} gradient rel-L2 {err:.3g}"
        np.testing.assert_allclose(rank["aug.params"], ref["params"],
                                   rtol=5e-3, atol=5e-5)
    # the two steps drew different masks
    assert ref["losses"][0] != ref["losses"][1]
