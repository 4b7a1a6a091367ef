"""The view-sharded training slice (train/seq_parallel.py) on CPU ranks over
gloo, against the JAX package and against the port's unsharded step.

  (a) view_sharded_overall_loss at p = 2 (4 views, 2 a rank) on seeded
      numpy GT and predictions against the JAX package's unsharded
      overall_loss on the same arrays, with and without the normal and
      gradient-matching terms and the pairwise-pose arm (as
      tests/test_seq_parallel.py): the total on every rank, the sum of the
      ranks' shares, the per-set details, and the gradient of the total
      with respect to every prediction (each rank backpropagates its share;
      the per-view gradients are its views', the replicated metric scale's
      is summed over the ranks) against jax.grad of the JAX loss. Both
      sides differ in summation order only: rtol 1e-5 with an atol of 1e-6
      of the reference's largest magnitude (elements that cancel to near
      zero). The loss values compare in fp32; the gradients in fp64 on
      both sides, since JAX's own fp32 gradient is up to 8e-6 of its
      max-abs (the metric scale's 1e-4) from the fp64 one.
  (b) make_view_sharded_train_step at p = 2 on the JAX test's tiny config
      against the port's unsharded make_train_step from the same weights
      and batch, two steps (the first at lr 0, the second moves the
      parameters), with the JAX test's tolerances: loss rtol 1e-4,
      grad_norm rtol 2e-3, the updated parameters rtol 5e-3 / atol 5e-5,
      and the same parameters on both ranks.
  (c) p = 1 (a one-process group in this process) against the same
      unsharded steps, at those tolerances.
  (d) train/grad_check.py::compare_sharded, the check chip_smoke.py and
      parallel/ring_check.py run on the card, at p = 2 and p = 1: fp32 on
      the CPU, the sharded and unsharded losses and gradients (pulled back
      from one cotangent, and of the whole loss) agree within 1e-5.

JAX is imported inside the fixtures only, so the spawned ranks load torch
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
    images_only_config,
)
from mapanything_tpu_torch.parallel import init_distributed, spawn_cpu_ranks
from mapanything_tpu_torch.train import step as PS
from mapanything_tpu_torch.train.losses import (
    FactoredGeometryConfig,
    OverallLossConfig,
)
from mapanything_tpu_torch.train.seq_parallel import (
    make_view_sharded_train_step,
    shard_views,
    view_sharded_overall_loss,
)

P = 2
# (use_normal_gm, pairwise relative-pose arm)
LOSS_CASES = [(False, False), (True, False), (True, True)]
# the JAX test's TINY, fp32
TINY = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
            trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
            dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8),
            dense_head_chunk=2)
OPTIM = dict(warmup_steps=1, total_steps=10)
STEPS = 2


def _port_loss_cfg(use_normal_gm, pairwise):
    return OverallLossConfig(
        use_normal_gm=use_normal_gm,
        factored=FactoredGeometryConfig(
            compute_pairwise_relative_pose_loss=pairwise))


def _fake_preds(gt, seed):
    """Prediction-shaped numpy arrays from the GT with noise (the JAX
    test's _fake_preds)."""
    rng = np.random.default_rng(seed)
    b, v, h, w = gt["valid_mask"].shape

    def noisy(x, scale=0.1):
        return (x * (1 + scale * rng.standard_normal(x.shape))).astype(
            np.float32)

    return {
        "pts3d": noisy(gt["pts3d"]),
        "pts3d_cam": noisy(gt["pts3d_cam"]),
        "depth_along_ray": noisy(gt["depth_along_ray"]),
        "ray_directions": noisy(gt["ray_directions_cam"], 0.02),
        "cam_quats": noisy(gt["camera_pose_quats"], 0.02),
        "cam_trans": noisy(gt["camera_pose_trans"]),
        "metric_scaling_factor": (
            1.0 + 0.1 * rng.standard_normal((b,))).astype(np.float32),
        "conf": (1.0 + np.abs(rng.standard_normal((b, v, h, w)))).astype(
            np.float32),
        "non_ambiguous_mask_logits": rng.standard_normal(
            (b, v, h, w)).astype(np.float32),
    }


def _local(x, rank, p):
    """This rank's views of a (B, V, ...) entry; (B,) entries whole."""
    if x.dim() < 2:
        return x
    v = x.shape[1] // p
    return x[:, rank * v:(rank + 1) * v]


def _loss_rank(group, folder):
    """One rank: every loss case's total, share, details and the gradient
    of its share with respect to its local predictions."""
    import torch.distributed as dist

    p, rank = dist.get_world_size(group), dist.get_rank(group)
    data = np.load(os.path.join(folder, "loss_inputs.npz"))

    def tensors(prefix, dtype):
        return {k[len(prefix):]: _local(torch.from_numpy(data[k]), rank, p)
                .to(dtype if data[k].dtype == np.float32 else None)
                for k in data if k.startswith(prefix)}

    res = {}
    for ci, case in enumerate(LOSS_CASES):
        for dtype in (torch.float32, torch.float64):
            preds = {k: t.clone().requires_grad_()
                     for k, t in tensors("pred.", dtype).items()}
            total, det = view_sharded_overall_loss(
                tensors("gt.", dtype), preds, _port_loss_cfg(*case), group)
            share = det.pop("_share")
            if dtype == torch.float32:
                res[f"{ci}.share"] = share.detach().numpy()
                for key, val in det.items():
                    res[f"{ci}.det.{key}"] = val.numpy()
                continue
            share.backward()
            for key, t in preds.items():
                res[f"{ci}.grad.{key}"] = t.grad.numpy()
    np.savez(os.path.join(folder, f"loss_rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def loss_run(tmp_path_factory):
    """The JAX loss and its gradient per case; every rank's results."""
    import jax

    from mapanything_tpu.data.synthetic import make_synthetic_batch as jbatch
    from mapanything_tpu.train.losses import FactoredGeometryConfig as JFC
    from mapanything_tpu.train.losses import OverallLossConfig as JOC
    from mapanything_tpu.train.losses import overall_loss

    folder = str(tmp_path_factory.mktemp("loss"))
    gt = jax.tree.map(np.asarray, jbatch(batch_size=2, num_views=4,
                                         height=14, width=14, seed=20)["gt"])
    # one real-data sample: the exclusion path
    gt = dict(gt, is_synthetic=np.asarray([False, True]))
    preds = _fake_preds(gt, seed=21)
    np.savez(os.path.join(folder, "loss_inputs.npz"),
             **{f"gt.{k}": v for k, v in gt.items()},
             **{f"pred.{k}": v for k, v in preds.items()})
    def f64(x):
        return x.astype(np.float64) if x.dtype == np.float32 else x

    refs = []
    for use_normal_gm, pairwise in LOSS_CASES:
        cfg = JOC(use_normal_gm=use_normal_gm, factored=JFC(
            compute_pairwise_relative_pose_loss=pairwise))
        with jax.default_matmul_precision("highest"):
            total, det = jax.jit(lambda g, pr, cfg=cfg: overall_loss(
                g, pr, cfg))(gt, preds)
            with jax.enable_x64(True):
                grads = jax.jit(jax.grad(
                    lambda pr, g, cfg=cfg: overall_loss(g, pr, cfg)[0]))(
                    jax.tree.map(f64, preds), jax.tree.map(f64, gt))
        refs.append(jax.tree.map(np.asarray, (total, det, grads)))
    spawn_cpu_ranks(_loss_rank, P, folder)
    ranks = [dict(np.load(os.path.join(folder, f"loss_rank{r}.npz")))
             for r in range(P)]
    return refs, ranks


def _close(out, ref, name=""):
    ref = np.asarray(ref)
    atol = 1e-6 * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("ci", range(len(LOSS_CASES)),
                         ids=[f"normal_gm={a}-pairwise={b}"
                              for a, b in LOSS_CASES])
def test_view_sharded_loss_matches_jax(loss_run, ci):
    refs, ranks = loss_run
    ref_total, ref_det, ref_grads = refs[ci]
    for rank in ranks:
        _close(rank[f"{ci}.det.total"], ref_total, "total")
    _close(sum(rank[f"{ci}.share"] for rank in ranks), ref_total, "shares")

    def ref_sum(substr):
        return sum(float(val) for key, val in ref_det.items()
                   if substr in key and "avg" not in key)

    det = ranks[0]
    _close(det[f"{ci}.det.pts3d_conf_viewsum_local"],
           ref_sum("_conf_loss_view"), "pts3d_conf")
    _close(det[f"{ci}.det.cam_pts3d_viewsum_local"]
           + det[f"{ci}.det.depth_along_ray_viewsum_local"],
           ref_sum("_bot95%_view"), "cam_pts3d + depth")
    _close(det[f"{ci}.det.mask_bce_viewsum_local"],
           ref_sum("NonAmbiguousMaskLoss_mask_view"), "mask_bce")
    for rank in ranks[1:]:
        for key in det:
            if f"{ci}.det." in key:
                np.testing.assert_array_equal(rank[key], det[key], key)

    for key, ref in ref_grads.items():
        parts = [rank[f"{ci}.grad.{key}"] for rank in ranks]
        got = (sum(parts) if key == "metric_scaling_factor"
               else np.concatenate(parts, axis=1))
        _close(got, ref, f"d total / d {key}")


# --- the train step ----------------------------------------------------------


def _tiny_model():
    return MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY),
                       device="cpu")


def _tiny_batch():
    return make_synthetic_batch(1, 4, 28, 28, seed=22, device="cpu")


def _sharded_steps(model, group):
    """STEPS view-sharded steps: (losses, grad_norms, final parameters)."""
    state = PS.create_train_state(model, PS.OptimConfig(**OPTIM))
    step = make_view_sharded_train_step(model, images_only_config(),
                                        group=group)
    batch = _tiny_batch()
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    return np.asarray(losses), np.asarray(norms), params


def _compare_keys(res):
    return {key: np.asarray(res[key]) for key in (
        "loss_rel_diff", "grad_rel_l2", "full_loss_grad_rel_l2")}


def _step_rank(group, folder):
    import torch.distributed as dist

    from mapanything_tpu_torch.train.grad_check import compare_sharded

    model = _tiny_model()
    model.load_state_dict(torch.load(os.path.join(folder, "model.pt")))
    cmp = _compare_keys(compare_sharded(model, _tiny_batch(), group))
    losses, norms, params = _sharded_steps(model, group)
    np.savez(os.path.join(folder, f"step_rank{dist.get_rank(group)}.npz"),
             losses=losses, norms=norms,
             **{f"param.{n}": p for n, p in params.items()},
             **{f"cmp.{k}": v for k, v in cmp.items()})


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """The seeded weights, the unsharded reference steps and every rank's
    view-sharded steps at p = 2."""
    folder = str(tmp_path_factory.mktemp("step"))
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY),
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(state_dict, os.path.join(folder, "model.pt"))
    state = PS.create_train_state(model, PS.OptimConfig(**OPTIM))
    step = PS.make_train_step(model, images_only_config())
    batch = _tiny_batch()
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    ref = {"losses": np.asarray(losses), "norms": np.asarray(norms),
           "params": {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()}}
    spawn_cpu_ranks(_step_rank, P, folder)
    ranks = [dict(np.load(os.path.join(folder, f"step_rank{r}.npz")))
             for r in range(P)]
    return dict(folder=folder, state_dict=state_dict, ref=ref, ranks=ranks)


def _check_steps(losses, norms, params, ref):
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(norms, ref["norms"], rtol=2e-3, atol=1e-5)
    assert np.isfinite(losses).all() and (norms > 0).all()
    moved = 0
    for name, want in ref["params"].items():
        np.testing.assert_allclose(params[name], want, rtol=5e-3, atol=5e-5,
                                   err_msg=name)
        moved += not np.array_equal(want, params[name])
    assert moved, "no parameter moved"


def test_view_sharded_step_matches_unsharded(step_run):
    ref = step_run["ref"]
    for rank in step_run["ranks"]:
        params = {k[6:]: v for k, v in rank.items() if k[:6] == "param."}
        _check_steps(rank["losses"], rank["norms"], params, ref)
    # the same optimizer step on the same summed gradients: the same
    # parameters on every rank
    r0, r1 = step_run["ranks"]
    for key in r0:
        if key[:6] == "param.":
            np.testing.assert_array_equal(r0[key], r1[key], key)


def _check_compare(cmp):
    for key, val in cmp.items():
        assert val <= 1e-5, f"{key} {val:.3e}"


def test_compare_sharded_at_two_ranks(step_run):
    for rank in step_run["ranks"]:
        _check_compare({k[4:]: v for k, v in rank.items() if k[:4] == "cmp."})


def test_compare_sharded_at_one_rank(step_run):
    import torch.distributed as dist

    from mapanything_tpu_torch.train.grad_check import compare_sharded

    model = _tiny_model()
    model.load_state_dict(step_run["state_dict"])
    group = init_distributed(device="cpu")
    try:
        cmp = compare_sharded(model, _tiny_batch(), group)
    finally:
        dist.destroy_process_group()
    assert cmp["ranks"] == 1 and cmp["views"] == 4
    _check_compare(_compare_keys(cmp))


def test_one_rank_step_matches_unsharded(step_run):
    import torch.distributed as dist

    model = _tiny_model()
    model.load_state_dict(step_run["state_dict"])
    group = init_distributed(device="cpu")
    try:
        losses, norms, params = _sharded_steps(model, group)
    finally:
        dist.destroy_process_group()
    _check_steps(losses, norms, params, step_run["ref"])


@pytest.mark.parametrize("p,rank", [(2, 1), (4, 3)])
def test_shard_views_takes_each_ranks_views(monkeypatch, p, rank):
    """Rank r of p gets views [r V/p, (r + 1) V/p) of every entry with a
    view axis, the images, the priors and their per-view flags included,
    and the per-sample flags whole; a view count that p does not divide
    raises."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: p)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    batch = make_synthetic_batch(2, 4, 28, 28, seed=3, device="cpu")
    views, gt = shard_views(batch, None)
    lo, hi = rank * 4 // p, (rank + 1) * 4 // p
    assert set(views) == set(batch["views"]) > {"img", "camera_pose_quats",
                                                "is_metric_scale"}
    for key, t in batch["views"].items():
        assert torch.equal(views[key], t[:, lo:hi]), key
    for key, t in batch["gt"].items():
        assert torch.equal(gt[key], t[:, lo:hi] if t.dim() >= 2 else t), key
    batch["views"]["img"] = batch["views"]["img"][:, :3]
    with pytest.raises(ValueError, match="multiple of the group size"):
        shard_views(batch, None)
