"""Gradient checkpointing (`encoder_/trunk_gradient_checkpointing`) on the
CPU.

  * against the JAX package with both flags on (flax nn.remat per block):
    the loss and every parameter gradient of the step's loss function with
    every prior on (GeometricInputConfig()), within 1e-4 of the
    reference's max-abs (tests/test_torch_train.py's limit);
  * against the port without checkpointing, the same weights, batch and
    generator (`aug_training`), each flag alone and both, and the chunked
    MLPs of the memory-efficient forward (each chunk checkpointed too):
    loss and gradients within 1e-6 of the max-abs; the recompute launches
    one more attention forward per checkpointed attention and nothing
    else;
  * the view-sharded step with a checkpointed trunk at p = 2 and 4 over
    gloo (the recompute reissues each RingGlobalBlock's rotations in the
    backward, on every rank in the same order) against the same step
    without checkpointing: losses and gradients within 1e-6 relative.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import (
    GeometricInputConfig,
    MapAnything,
    MapAnythingConfig,
    aug_training_config,
)
from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention,
    reset_launch_counts,
)
from mapanything_tpu_torch.parallel import spawn_cpu_ranks
from mapanything_tpu_torch.train import step as PS
from mapanything_tpu_torch.train.losses import overall_loss
from mapanything_tpu_torch.train.seq_parallel import (
    make_view_sharded_train_step,
)

HIGHEST = "highest"
TINY = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
            trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
            dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
H, W = 28, 42
BOTH = dict(encoder_gradient_checkpointing=True,
            trunk_gradient_checkpointing=True)
# attentions of the tiny model: 2 encoder blocks, 2 trunk layers
ENCODER_ATTN, TRUNK_ATTN = 2, 2


def _model(state_dict=None, **flags):
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY,
                                          **flags), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _assert_close_max(out, ref, tol, name):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    assert np.isfinite(out).all(), name
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: max abs err {err:.3g}"


def test_checkpointed_step_matches_jax():
    import jax
    import jax.numpy as jnp

    from mapanything_tpu.data.synthetic import make_synthetic_batch as jb
    from mapanything_tpu.models import GeometricInputConfig as JaxGeomCfg
    from mapanything_tpu.models import MapAnything as JaxMapAnything
    from mapanything_tpu.models import MapAnythingConfig as JaxConfig
    from mapanything_tpu.train import losses as JL
    from mapanything_tpu_torch.utils.weights import (
        from_jax_params,
        load_jax_params,
    )
    from torch_jax_init import init_params

    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY,
                                             **BOTH))
    rng = np.random.default_rng(51)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape))
        .astype(np.float32), init_params(jax_model, H, W))
    with jax.default_matmul_precision(HIGHEST):
        jbatch = jb(1, 2, H, W, seed=0)

        def loss_fn(p):
            preds = jax_model.apply(p, jbatch["views"], JaxGeomCfg())
            return JL.overall_loss(jbatch["gt"], preds)

        (ref_loss, _), ref_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = load_jax_params(
        MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY, **BOTH),
                    device="cpu"), params)
    ref_grads = from_jax_params(jax.tree.map(np.asarray, ref_grads), port)
    named = list(port.named_parameters())
    loss, _, grads = PS.loss_and_grads(
        PS.make_loss_fn(port, GeometricInputConfig()), [p for _, p in named],
        make_synthetic_batch(1, 2, H, W, seed=0, device="cpu"))
    _assert_close_max(loss.numpy(), np.asarray(ref_loss), 1e-4, "loss")
    for (name, _), g in zip(named, grads):
        _assert_close_max(g.numpy(), ref_grads[name], 1e-4, f"d {name}")


def _loss_and_grads(model, memory_efficient=False):
    batch = make_synthetic_batch(1, 2, H, W, seed=1, device="cpu")
    params = list(model.parameters())
    for p in params:
        p.grad = None
    chunking = dataclasses.replace(model.cfg, mlp_token_chunk=5)
    preds = model(batch["views"], aug_training_config(),
                  torch.Generator().manual_seed(3), memory_efficient,
                  chunking=chunking)
    loss, _ = overall_loss(batch["gt"], preds)
    reset_launch_counts()
    loss.backward()
    backward_launches = flash_attention.plain_launches
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for p in params]
    return float(loss.detach()), grads, backward_launches


@pytest.mark.parametrize("flags,memory_efficient", [
    (dict(encoder_gradient_checkpointing=True), False),
    (dict(trunk_gradient_checkpointing=True), False),
    (BOTH, False),
    (BOTH, True),
], ids=["encoder", "trunk", "both", "both_chunked"])
def test_checkpointed_matches_unchecked(flags, memory_efficient):
    plain = _model()
    loss_ref, grads_ref, launches_ref = _loss_and_grads(plain,
                                                        memory_efficient)
    ckpt = _model(plain.state_dict(), **flags)
    loss, grads, launches = _loss_and_grads(ckpt, memory_efficient)
    assert abs(loss - loss_ref) <= 1e-6 * abs(loss_ref)
    for (name, _), g, r in zip(plain.named_parameters(), grads, grads_ref):
        if float(r.abs().max()) == 0.0:
            assert float(g.abs().max()) == 0.0, name
        else:
            _assert_close_max(g.numpy(), r.numpy(), 1e-6, f"d {name}")
    # the backward: one plain backward per attention, and with
    # checkpointing one more forward per checkpointed attention
    attentions = ENCODER_ATTN + TRUNK_ATTN
    recomputed = (ENCODER_ATTN * flags.get("encoder_gradient_checkpointing",
                                           False)
                  + TRUNK_ATTN * flags.get("trunk_gradient_checkpointing",
                                           False))
    assert launches_ref == attentions
    assert launches == attentions + recomputed


def test_no_recompute_without_grad():
    """Under no_grad a checkpointed model runs its blocks once."""
    model = _model(**BOTH)
    batch = make_synthetic_batch(1, 2, H, W, seed=1, device="cpu")
    reset_launch_counts()
    with torch.no_grad():
        model(batch["views"])
    assert flash_attention.plain_launches == ENCODER_ATTN + TRUNK_ATTN


# --- the view-sharded step over gloo --------------------------------------------


def _sharded_rank(group, folder):
    import torch.distributed as dist

    state_dict = torch.load(os.path.join(folder, "model.pt"))
    res = {}
    for name, flags in (("plain", {}),
                        ("ckpt", dict(trunk_gradient_checkpointing=True))):
        model = _model(state_dict, **flags)
        state = PS.create_train_state(model, PS.OptimConfig(
            warmup_steps=1, total_steps=10))
        step = make_view_sharded_train_step(model, aug_training_config(),
                                            group=group)
        captured = []
        apply = state.apply_gradients
        state.apply_gradients = lambda g, n=None: (
            captured.append(torch.cat([x.flatten() for x in g]).clone())
            or apply(g, n))
        gen = torch.Generator().manual_seed(7)
        batch = make_synthetic_batch(1, 4, 28, 28, seed=8, device="cpu")
        losses = []
        for _ in range(2):
            state, metrics = step(state, batch, gen)
            losses.append(float(metrics["loss"]))
        res[f"{name}.losses"] = np.asarray(losses)
        res[f"{name}.grads"] = torch.stack(captured).numpy()
    np.savez(os.path.join(folder, f"rank{dist.get_rank(group)}.npz"), **res)


@pytest.mark.parametrize("p", [2, 4])
def test_checkpointed_ring_step_matches_unchecked(tmp_path, p):
    torch.save(_model().state_dict(), tmp_path / "model.pt")
    spawn_cpu_ranks(_sharded_rank, p, str(tmp_path))
    for r in range(p):
        res = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(res["ckpt.losses"], res["plain.losses"],
                                   rtol=1e-6)
        for got, want in zip(res["ckpt.grads"], res["plain.grads"]):
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= 1e-6, err
