"""Data and tensor parallelism (parallel/mesh.py and the mesh step of
train/step.py) on CPU ranks over gloo, against the JAX package's mesh step
and against the port's one-rank step.

The model is the JAX test's tiny one with the channel split tensor
parallelism needs: the "test" encoder (64 wide, 2 heads), a trunk 128 wide
with 4 heads and 2 layers, fp32. JAX's init (with every prior encoder),
perturbed by seeded numpy noise, goes to both packages. The global batch
is make_synthetic_batch(2, 2, 28, 42) of each (the same numpy stream),
images only. One spawn of 4 ranks over gloo runs every mesh: ranks {0, 1}
as (data, model) = (2, 1) while ranks {2, 3} run (1, 2), then all four as
(2, 2), then the extra cases. Each mesh takes STEPS steps (the first at lr
0: the warmup starts at 0).

  * against JAX's step on make_mesh(2, 2) over the host devices that
    tests/conftest.py forces (shard_params, shard_batch, the jitted
    make_train_step, as tests/test_sharding.py): the losses and grad_norms
    within 1e-4 relative and the gathered parameters within 1e-4 of each
    tensor's max-abs, tests/test_torch_train.py's one-device tolerances.
    GSPMD's step is the whole batch's on any mesh (tests/test_sharding.py
    holds (4, 1) and (4, 2) to one device), so one JAX mesh, the one with
    both axes, is the reference of the port's three: each JAX mesh is a
    compile of ~20 s here;
  * against the port's one-rank step on the whole batch: the losses,
    grad_norms and the gathered gradients within 1e-5 (of each tensor's
    max-abs), the same arithmetic summed in another order, and the
    parameters within 1e-5 of each tensor's max-abs;

The updated parameters also get an absolute allowance of LR_NOISE x lr:
Adam divides each gradient by its own magnitude, so an element whose
gradient is rounding noise moves by a noise-driven fraction of lr. The
key biases are such elements: softmax ignores a constant added to every
key, so their exact gradient is 0.
  * the parameter rules against JAX's param_sharding on the JAX tree;
  * qkv cut contiguously instead of by heads: the step misses the
    one-rank step, so the head-parallel split is what makes it right;
  * an `aug_training` step at DP 2 equals the one-rank step with the same
    generator: every data rank draws the whole batch's masks;
  * a TP save loads bitwise into a one-rank model, and back into a
    sharded one;
  * the DP-reduced criterion at 2 ranks with unequal mask counts against
    overall_loss on the joined batch.

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
    aug_training_config,
    images_only_config,
)
from mapanything_tpu_torch.parallel import spawn_cpu_ranks
from mapanything_tpu_torch.parallel import mesh as PM
from mapanything_tpu_torch.train import checkpoints as PC
from mapanything_tpu_torch.train import step as PS

CFG = dict(encoder_size="test", trunk_dim=128, trunk_depth=2,
           trunk_num_heads=4, trunk_indices=(0, 1), dpt_feature_dim=32,
           dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
B, V, H, W = 2, 2, 28, 42
OPTIM = dict(warmup_steps=1, total_steps=10)
STEPS = 2
LR_NOISE = 0.25
MESHES = [(2, 1), (1, 2), (2, 2)]
AUG_SEED = 5
# parameters that JAX's regex shards on the model axis and the port
# replicates: an fc1 outside an Attention/Mlp pair (the heads' and the
# prior encoders'), whose partner is not sharded (ROADMAP, pinned
# divergences)
REPLICATED_FC1 = {
    "pose_head.fc1", "scale_head.fc1", "depth_scale_encoder.fc1",
    "cam_rot_encoder.fc1", "cam_trans_encoder.fc1",
    "cam_trans_scale_encoder.fc1",
}


def _model():
    return MapAnything(MapAnythingConfig(dtype=torch.float32, **CFG),
                       device="cpu")


def _batch(priors=False):
    batch = make_synthetic_batch(B, V, H, W, seed=0, device="cpu")
    if priors:
        return batch
    return {"views": {"img": batch["views"]["img"]}, "gt": batch["gt"]}


def _steps(model, mesh=None, batch=None, geom=None, generator=None):
    """STEPS steps: (losses, grad_norms, the state); the state's `grads`
    are the first step's gradients (this rank's parts), before the clip."""
    state = PS.create_train_state(model, PS.OptimConfig(**OPTIM))
    apply, state.grads = state.optimizer.step, None

    def recording(grads, norm=None):
        if state.grads is None:
            state.grads = [g.clone() for g in grads]
        return apply(grads, norm)

    state.optimizer.step = recording
    step = PS.make_train_step(model, geom or images_only_config(), mesh=mesh)
    batch = _batch() if batch is None else batch
    if mesh is not None:
        batch = PM.shard_batch(batch, mesh)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, batch, generator)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return np.asarray(losses), np.asarray(norms), state


def _loaded(folder):
    model = _model()
    model.load_state_dict(torch.load(os.path.join(folder, "model.pt")))
    return model


def _record(res, tag, losses, norms, state):
    """The losses and norms, and the gathered parameters and first-step
    gradients of the mesh's rank (0, 0) (every rank joins the gathers)."""
    model = state.model
    full = PM.unshard_params(model)
    grads = [PM.gather_full(model, name, g) for name, g in
             zip(state.optimizer.names, state.grads)]
    mesh = model.mesh
    res[f"{tag}.losses"], res[f"{tag}.norms"] = losses, norms
    if mesh.data_rank == 0 and mesh.model_rank == 0:
        for name, g in zip(state.optimizer.names, grads):
            res[f"{tag}.param.{name}"] = full[name].numpy()
            res[f"{tag}.grad.{name}"] = g.numpy()


def _contiguous_qkv_step(folder, mesh):
    """The TP step with each qkv cut contiguously over its 3 * dim rows
    (rank 0 all of q and half of k, at TP 2) instead of by heads."""
    model = _loaded(folder)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    PM.shard_params(model, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            split = model.tp_split.get(name)
            if split is not None and split.chunks == 3:
                p.data = PM.shard(full[name], PM.Split(split.dim),
                                  mesh.model_rank, mesh.n_model).clone()
    return _steps(model, mesh)[0]


def _save_and_resume(folder, mesh, state):
    """A TP save of the whole state and of the parameters; the state read
    back into a fresh sharded model: its local parts bitwise (1.0) or not
    (0.0)."""
    path = os.path.join(folder, "tp_state.pt")
    PC.save_train_state(path, state, 0.5, epoch=1)
    PC.save_params(os.path.join(folder, "tp_params.pt"), state.model)
    torch.distributed.barrier(group=mesh.model_group)
    fresh = PS.create_train_state(PM.shard_params(_loaded(folder), mesh),
                                  PS.OptimConfig(**OPTIM))
    fresh, best, epoch = PC.load_train_state(path, fresh)
    same = (best == 0.5 and epoch == 1 and fresh.step == state.step
            and all(torch.equal(a, b) for a, b in zip(
                fresh.optimizer.params + fresh.optimizer.mu
                + fresh.optimizer.nu,
                state.optimizer.params + state.optimizer.mu
                + state.optimizer.nu)))
    return np.float32(same)


def _mesh_rank(group, folder):
    import torch.distributed as dist

    rank = dist.get_rank()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    res = {}
    shape = MESHES[rank // 2]
    mesh = PM.make_mesh(*shape, group=pairs[rank // 2])
    model = PM.shard_params(_loaded(folder), mesh)
    losses, norms, state = _steps(model, mesh)
    _record(res, str(shape), losses, norms, state)
    if rank >= 2:  # TP 2
        res["contiguous.losses"] = _contiguous_qkv_step(folder, mesh)
        res["resumed_bitwise"] = _save_and_resume(folder, mesh, state)
    else:  # DP 2 with the prior masks drawn at random
        aug = PM.shard_params(_loaded(folder), mesh)
        losses, norms, aug_state = _steps(
            aug, mesh, _batch(priors=True), aug_training_config(),
            torch.Generator().manual_seed(AUG_SEED))
        _record(res, "aug", losses, norms, aug_state)
        res["shapes." + str(shape)] = np.asarray(
            [p.numel() for p in aug.parameters()])
    mesh = PM.make_mesh(2, 2, group=group)
    model = PM.shard_params(_loaded(folder), mesh)
    losses, norms, state = _steps(model, mesh)
    _record(res, str(MESHES[2]), losses, norms, state)
    np.savez(os.path.join(folder, f"rank{rank}.npz"), **res)


def _perturb(params, seed, scale=0.02):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape))
        .astype(np.float32), params)


@pytest.fixture(scope="module")
def jax_setup():
    import jax
    import jax.numpy as jnp

    from mapanything_tpu.data.synthetic import make_synthetic_batch as jbatch
    from mapanything_tpu.models import MapAnything as JaxMapAnything
    from mapanything_tpu.models import MapAnythingConfig as JaxConfig
    from torch_jax_init import init_params

    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **CFG))
    params = _perturb(init_params(jax_model, H, W), 12)
    with jax.default_matmul_precision("highest"):
        batch = jbatch(B, V, H, W, seed=0)
    batch = {"views": {"img": batch["views"]["img"]}, "gt": batch["gt"]}
    return jax_model, params, batch


JAX_MESH = (2, 2)


@pytest.fixture(scope="module")
def jax_steps(jax_setup):
    """JAX's step on JAX_MESH: (losses, grad_norms, the parameters in the
    port's names)."""
    import jax

    from mapanything_tpu.models import images_only_config as jax_images
    from mapanything_tpu.parallel import make_mesh, shard_batch, shard_params
    from mapanything_tpu.train import step as JS
    from mapanything_tpu_torch.utils.weights import from_jax_params

    jax_model, params, batch = jax_setup
    port = _model()
    step = jax.jit(JS.make_train_step(jax_model, jax_images()))
    n_data, n_model = JAX_MESH
    with jax.default_matmul_precision("highest"):
        mesh = make_mesh(n_data, n_model,
                         devices=jax.devices()[:n_data * n_model])
        state = JS.create_train_state(
            jax_model, shard_params(params, mesh), JS.OptimConfig(**OPTIM))
        sharded = shard_batch(batch, mesh)
        losses, norms = [], []
        for _ in range(STEPS):
            state, m = step(state, sharded, jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return (np.asarray(losses), np.asarray(norms),
            from_jax_params(jax.tree.map(np.asarray, state.params), port))


@pytest.fixture(scope="module")
def mesh_run(jax_setup, tmp_path_factory):
    """The port's one-rank steps on the whole batch (images only and
    aug_training) and every rank's mesh results."""
    from mapanything_tpu_torch.utils.weights import load_jax_params

    _, params, _ = jax_setup
    folder = str(tmp_path_factory.mktemp("mesh"))
    model = load_jax_params(_model(), params)
    torch.save({k: v.clone() for k, v in model.state_dict().items()},
               os.path.join(folder, "model.pt"))
    def one_rank(*args, **kw):
        losses, norms, state = _steps(_loaded(folder), *args, **kw)
        return (losses, norms,
                {n: p.detach().numpy().copy()
                 for n, p in state.model.named_parameters()},
                {n: g.numpy() for n, g in zip(state.optimizer.names,
                                              state.grads)})

    ref = {"plain": one_rank(),
           "aug": one_rank(batch=_batch(priors=True),
                           geom=aug_training_config(),
                           generator=torch.Generator().manual_seed(AUG_SEED))}
    spawn_cpu_ranks(_mesh_rank, 4, folder)
    ranks = [dict(np.load(os.path.join(folder, f"rank{r}.npz")))
             for r in range(4)]
    return dict(folder=folder, ref=ref, ranks=ranks)


def _params_of(ranks, tag, kind="param"):
    out = {}
    for res in ranks:
        prefix = f"{tag}.{kind}."
        out.update({k[len(prefix):]: v for k, v in res.items()
                    if k.startswith(prefix)})
    return out


def _close_max(got, want, rtol, atol, name):
    """max |got - want| <= rtol max |want| + atol."""
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + atol, f"{name}: {err:.3g}"


def _check(losses, norms, params, ref, rtol, name, grads=None):
    ref_losses, ref_norms, ref_params = ref[:3]
    np.testing.assert_allclose(losses, ref_losses, rtol=rtol, err_msg=name)
    np.testing.assert_allclose(norms, ref_norms, rtol=rtol, err_msg=name)
    assert set(params) == set(ref_params), name
    lr = PS.OptimConfig().lr
    moved = 0
    for key, want in ref_params.items():
        _close_max(params[key], want, rtol, LR_NOISE * lr, f"{name} {key}")
        moved += not np.array_equal(want, params[key])
    assert moved, f"{name}: no parameter moved"
    if grads is not None:
        assert set(grads) == set(ref[3]), name
        for key, want in ref[3].items():
            _close_max(grads[key], want, rtol, 0.0, f"{name} d {key}")


def _ranks_of(shape):
    return {(2, 1): [0, 1], (1, 2): [2, 3], (2, 2): [0, 1, 2, 3]}[shape]


@pytest.mark.parametrize("shape", MESHES, ids=["dp2", "tp2", "dp2xtp2"])
def test_mesh_step_matches_one_rank(mesh_run, shape):
    """The port's mesh step against its one-rank step on the whole batch;
    every rank reads the same loss and norm."""
    ranks = [mesh_run["ranks"][r] for r in _ranks_of(shape)]
    tag = str(shape)
    for res in ranks:
        np.testing.assert_array_equal(res[f"{tag}.losses"],
                                      ranks[0][f"{tag}.losses"])
    _check(ranks[0][f"{tag}.losses"], ranks[0][f"{tag}.norms"],
           _params_of(ranks, tag), mesh_run["ref"]["plain"], 1e-5, tag,
           _params_of(ranks, tag, "grad"))


@pytest.mark.parametrize("shape", MESHES, ids=["dp2", "tp2", "dp2xtp2"])
def test_mesh_step_matches_jax_mesh_step(mesh_run, jax_steps, shape):
    ranks = [mesh_run["ranks"][r] for r in _ranks_of(shape)]
    tag = str(shape)
    _check(ranks[0][f"{tag}.losses"], ranks[0][f"{tag}.norms"],
           _params_of(ranks, tag), jax_steps, 1e-4, f"JAX {tag}")


def test_aug_training_masks_are_the_global_draws_rows(mesh_run):
    """DP 2 with the stochastic prior mix equals the one-rank step with a
    generator in the same state: each data rank keeps its rows of the
    whole batch's draw (two ranks drawing alike for their own rows would
    give both samples the same masks)."""
    ranks = mesh_run["ranks"][:2]
    _check(ranks[0]["aug.losses"], ranks[0]["aug.norms"],
           _params_of(ranks, "aug"), mesh_run["ref"]["aug"], 1e-5, "aug",
           _params_of(ranks, "aug", "grad"))


def test_contiguous_qkv_split_misses_the_step(mesh_run):
    """The same TP 2 step with qkv cut contiguously: its loss misses the
    one-rank step's far outside the 1e-5 the head split meets."""
    ref = mesh_run["ref"]["plain"][0]
    for res in mesh_run["ranks"][2:]:
        np.testing.assert_allclose(res[str(MESHES[1]) + ".losses"], ref,
                                   rtol=1e-5)
        rel = np.abs(res["contiguous.losses"] - ref) / np.abs(ref)
        assert rel.max() > 1e-3, rel


def test_tp_checkpoint_loads_into_one_rank_bitwise(mesh_run):
    """The TP 2 run's files hold the released, unsharded layout: they load
    into a one-rank model bitwise equal to the gathered parameters, and
    back into the sharded model bitwise (checked on both ranks)."""
    folder = mesh_run["folder"]
    gathered = _params_of(mesh_run["ranks"][2:], str(MESHES[1]))
    for fname in ("tp_params.pt", "tp_state.pt"):
        model = _model()
        if fname == "tp_params.pt":
            PC.load_params(os.path.join(folder, fname), model)
        else:
            state = PS.create_train_state(model, PS.OptimConfig(**OPTIM))
            _, best, epoch = PC.load_train_state(os.path.join(folder, fname),
                                                 state)
            assert best == 0.5 and epoch == 1 and state.step == STEPS
        for name, p in model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), gathered[name],
                                          err_msg=f"{fname} {name}")
    for res in mesh_run["ranks"][2:]:
        assert res["resumed_bitwise"] == 1.0


def test_dp_ranks_hold_whole_parameters(mesh_run):
    full = [p.numel() for p in _model().parameters()]
    for res in mesh_run["ranks"][:2]:
        assert res[f"shapes.{MESHES[0]}"].tolist() == full


# --- the parameter rules ------------------------------------------------------


def _fake_mesh(rank, n=2):
    return PM.Mesh(n_data=1, n_model=n, data_rank=0, model_rank=rank)


def test_param_rules_match_jax(jax_setup):
    """PARAM_RULES are JAX's; the parameters the port splits, and along
    which torch dimension, are those JAX's param_sharding shards, but for
    the pinned REPLICATED_FC1; each rank holds its heads of q, k and v
    and the matching slices of the other split parameters."""
    import jax

    from mapanything_tpu.parallel import make_mesh, param_sharding
    from mapanything_tpu.parallel import mesh as JM
    from mapanything_tpu_torch.utils.weights import _flatten, _torch_key

    assert PM.PARAM_RULES == [(pattern, tuple(spec))
                              for pattern, spec in JM._PARAM_RULES]
    _, params, _ = jax_setup
    mesh = make_mesh(n_data=4, n_model=2)
    jax_split = {}
    for path, leaf in _flatten(params["params"]):
        spec = tuple(param_sharding("/".join(path), leaf, mesh).spec)
        if "model" in spec:
            axis = spec.index("model") - (len(spec) - np.ndim(leaf))
            # (in, out) kernels are torch's (1, 0); biases dim 0
            jax_split[_torch_key(path)] = (1 - axis if np.ndim(leaf) == 2
                                           else 0)
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **CFG),
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    port = PM.param_split(model, 2)
    assert {n: s.dim for n, s in port.items()} == {
        n: d for n, d in jax_split.items()
        if n.rsplit(".", 1)[0] not in REPLICATED_FC1}
    assert {n.rsplit(".", 1)[0] for n in set(jax_split) - set(port)} == (
        REPLICATED_FC1)
    assert any(".attn.qkv." in n for n in port)
    assert any(n.startswith("encoder.") for n in port)
    assert any(n.startswith("info_sharing.") for n in port)

    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    for rank in range(2):
        local = PM.shard_params(_copy(full), _fake_mesh(rank))
        for name, p in local.named_parameters():
            want = full[name]
            if name not in port:
                assert torch.equal(p, want), name
                continue
            dim = port[name].dim
            if ".qkv." in name:  # rank r's heads of each of q, k and v
                thirds = want.chunk(3, dim)
                want = torch.cat([t.chunk(2, dim)[rank] for t in thirds], dim)
            else:
                want = want.chunk(2, dim)[rank]
            assert torch.equal(p, want), name


def _copy(full):
    model = _model()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(full[name])
    return model


def test_unshard_inverts_shard():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((12, 5)).astype(np.float32))
    for split in (PM.Split(0, 3), PM.Split(0), PM.Split(1)):
        for n in (2, 4):
            if x.shape[split.dim] % (n * split.chunks):
                continue
            parts = [PM.shard(x, split, r, n) for r in range(n)]
            assert torch.equal(PM.unshard(parts, split), x)


def test_make_mesh_rank_layout_is_jax():
    """Rank r of the group sits at (r // n_model, r % n_model), as JAX's
    np.arange(world).reshape(n_data, n_model) of its devices."""
    import torch.distributed as dist

    from mapanything_tpu_torch.parallel import init_distributed

    init_distributed(device="cpu")
    try:
        mesh = PM.make_mesh(1, 1)
        assert (mesh.n_data, mesh.n_model, mesh.data_rank,
                mesh.model_rank) == (1, 1, 0, 0)
        assert mesh.data_group is None and mesh.model_group is None
        with pytest.raises(ValueError, match="does not cover"):
            PM.make_mesh(2, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name,path", [
    ("encoder.blocks.3.attn.qkv.weight", "encoder/blocks_3/attn/qkv/kernel"),
    ("info_sharing.blocks.0.mlp.fc2.bias",
     "info_sharing/blocks_0/mlp/fc2/bias"),
    ("pose_head.fc1.weight", "pose_head/fc1/kernel"),
])
def test_jax_path(name, path):
    assert PM.jax_path(name) == path


def test_view_sharded_step_refuses_a_tp_model():
    """TP and the ring both use the model axis (as in JAX): the
    view-sharded step refuses a tensor-parallel model."""
    from mapanything_tpu_torch.train.seq_parallel import (
        make_view_sharded_train_step,
    )

    model = PM.shard_params(_model(), _fake_mesh(0))
    with pytest.raises(ValueError, match="tensor-parallel"):
        make_view_sharded_train_step(model, images_only_config())


# --- the DP-reduced criterion -------------------------------------------------


def _criterion_rank(group, folder):
    import torch.distributed as dist

    from mapanything_tpu_torch.train.criteria import Reduction
    from mapanything_tpu_torch.train.losses import overall_loss

    rank = dist.get_rank(group)
    data = np.load(os.path.join(folder, "inputs.npz"))
    gt = {k[3:]: torch.from_numpy(data[k][rank:rank + 1])
          for k in data if k.startswith("gt.")}
    preds = {k[5:]: torch.from_numpy(data[k][rank:rank + 1])
             .requires_grad_(data[k].dtype == np.float32)
             for k in data if k.startswith("pred.")}
    total, det = overall_loss(gt, preds, red=Reduction(data_group=group))
    det.pop("_share").backward()
    res = {f"det.{k}": v.detach().numpy() for k, v in det.items()}
    res["total"] = total.numpy()
    for k, t in preds.items():
        if t.grad is not None:
            res[f"grad.{k}"] = t.grad.numpy()
    np.savez(os.path.join(folder, f"crit{rank}.npz"), **res)


def test_dp_criterion_is_the_joined_batchs(tmp_path):
    """overall_loss with a data group of 2 ranks, one sample each with
    very different valid-pixel counts and one real-data sample (the top-5%
    exclusion), against overall_loss on the joined batch: the total, every
    detail and the gradients (each rank its sample's rows), within 1e-5.
    The mean of the two ranks' own losses misses it."""
    from mapanything_tpu_torch.train.losses import overall_loss

    gt = make_synthetic_batch(2, 3, 14, 21, seed=4, device="cpu")["gt"]
    rng = np.random.default_rng(7)
    valid = gt["valid_mask"].numpy().copy()
    valid[0] &= rng.random(valid[0].shape) > 0.8  # ~20% valid
    valid[0, 2] = False
    gt["valid_mask"] = torch.from_numpy(valid)
    gt["is_synthetic"] = torch.tensor([True, False])
    gt["is_metric_scale"] = torch.tensor([True, False])
    preds = {
        "metric_scaling_factor": torch.tensor([1.3, 0.7]),
        "conf": torch.from_numpy(1 + rng.random((2, 3, 14, 21))
                                 .astype(np.float32)),
        "non_ambiguous_mask_logits": torch.from_numpy(
            rng.standard_normal((2, 3, 14, 21)).astype(np.float32)),
        "cam_quats": torch.nn.functional.normalize(torch.from_numpy(
            rng.standard_normal((2, 3, 4)).astype(np.float32)), dim=-1),
    }
    s = preds["metric_scaling_factor"][:, None, None, None, None]
    for key, src in (("pts3d", "pts3d"), ("pts3d_cam", "pts3d_cam"),
                     ("depth_along_ray", "depth_along_ray")):
        noise = 0.1 * rng.standard_normal(gt[src].shape).astype(np.float32)
        preds[key] = (gt[src] + torch.from_numpy(noise)) * s
    rays = gt["ray_directions_cam"]
    preds["ray_directions"] = rays + 0.05 * torch.from_numpy(
        rng.standard_normal(rays.shape).astype(np.float32))
    preds["cam_trans"] = (gt["camera_pose_trans"]
                          * preds["metric_scaling_factor"][:, None, None])
    np.savez(tmp_path / "inputs.npz",
             **{f"gt.{k}": v.numpy() for k, v in gt.items()},
             **{f"pred.{k}": v.numpy() for k, v in preds.items()})
    spawn_cpu_ranks(_criterion_rank, 2, str(tmp_path))
    ranks = [dict(np.load(tmp_path / f"crit{r}.npz")) for r in range(2)]

    leaves = {k: v.clone().requires_grad_() for k, v in preds.items()}
    total, det = overall_loss(gt, leaves)
    total.backward()

    def close(got, want, name):
        want = want.detach().numpy()
        atol = 1e-6 * float(np.abs(want).max(initial=0.0))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=name)

    for r, res in enumerate(ranks):
        close(res["total"], total, "total")
        for key, val in det.items():
            close(res[f"det.{key}"], val, key)
        for key, leaf in leaves.items():
            close(res[f"grad.{key}"], leaf.grad[r:r + 1], f"d {key}")
    own = [float(overall_loss({k: v[r:r + 1] for k, v in gt.items()},
                              {k: v[r:r + 1] for k, v in preds.items()})[0])
           for r in range(2)]
    assert abs(np.mean(own) - float(total.detach())) > 1e-3 * abs(
        float(total.detach()))
