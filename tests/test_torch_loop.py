"""The training loop (train/loop.py) and its checkpoints (train/
checkpoints.py) on the CPU, as tests/test_loop.py holds the JAX loop:

  * train_one_epoch runs, and its one-step-late tripwire fires at every
    iteration (a NaN loss at each iteration in turn): the batch is dumped
    with a checkpoint and the loop exits non-zero;
  * a 20-step overfit of the `aug_training` step on one tiny batch: the
    mean of the last two losses under 0.6 x the mean of the first two (the
    JAX test's limit and recipe);
  * a run killed in epoch 1 and resumed from checkpoint-last ends with the
    parameters, the optimizer state and the step of an uninterrupted run,
    bit for bit;
  * a checkpoint round trip restores every AdamW tensor and counter, with
    and without accumulation, and the model's parameters alone;
  * checkpoint-best follows the median of the test loaders' median losses;
  * SmoothedValue and MetricLogger equal the JAX package's on the same
    sequence.
"""

import math

import numpy as np
import pytest
import torch
from torch import nn

from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    aug_training_config,
)
from mapanything_tpu_torch.train import checkpoints as C
from mapanything_tpu_torch.train import loop as L
from mapanything_tpu_torch.train import step as PS

TINY = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
            trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
            dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))


def _tiny_model(seed=0):
    return MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY),
                       device="cpu",
                       generator=torch.Generator().manual_seed(seed))


# --- train_one_epoch and the tripwire -----------------------------------------


class _FakeLoader:
    """Tiny numpy batches shaped like the real loader's."""

    def __init__(self, n=6):
        self.n = n

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            yield {"views": {"img": np.zeros((1, 2, 4, 4, 3), np.float32)},
                   "gt": {"x": np.full((3,), float(i), np.float32)}}


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(3))


def _toy_state():
    return PS.create_train_state(
        _Toy(), PS.OptimConfig(lr=0.1, warmup_steps=1, total_steps=10))


def _toy_step(explode_at=None):
    def step(state, batch, generator):
        w = state.model.w
        loss = ((w - batch["gt"]["x"]) ** 2).mean()
        grad, = torch.autograd.grad(loss, [w])
        if explode_at is not None and float(batch["gt"]["x"][0]) == explode_at:
            loss = loss * float("nan")
        norm = PS.global_norm([grad])
        state.apply_gradients([grad], norm)
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return step


def _run_epoch(tmp_path, step):
    cfg = L.TrainLoopConfig(output_dir=str(tmp_path), print_freq=3)
    return L.train_one_epoch(None, _toy_state(), step, _FakeLoader(6), 0,
                             cfg, torch.Generator(), str(tmp_path / "log.txt"),
                             device="cpu")


def test_train_one_epoch_runs(tmp_path):
    state, _ = _run_epoch(tmp_path, _toy_step())
    assert state.step == 6 and state.optimizer.count == 6
    assert "steps" in (tmp_path / "log.txt").read_text()


@pytest.mark.parametrize("explode_at", range(6))
def test_explosion_fires_on_any_iteration(tmp_path, explode_at):
    """A NaN at any iteration, at print_freq or not, the last one too, is
    caught one step late: the batch and a checkpoint are dumped and the
    loop exits non-zero."""
    with pytest.raises(SystemExit):
        _run_epoch(tmp_path, _toy_step(float(explode_at)))
    dump = tmp_path / "explosion_dump"
    assert [p.name for p in dump.glob("batch_*.npz")] == [
        f"batch_e0_i{explode_at}.npz"]
    assert (dump / "checkpoint-post-explosion").exists()
    # the one step late read: the state went one step past the exploded one
    # (none after the last)
    state = _toy_state()
    _, _, epoch = C.load_train_state(str(dump / "checkpoint-post-explosion"),
                                     state)
    assert state.step == min(explode_at + 2, 6) and epoch is None


# --- the aug_training step learns ---------------------------------------------


def test_overfits_tiny_batch_short():
    steps, lr = 20, 3e-3
    model = _tiny_model()
    batch = make_synthetic_batch(1, 2, 28, 28, seed=0, device="cpu")
    state = PS.create_train_state(model, PS.OptimConfig(
        lr=lr, encoder_lr_scale=1.0, warmup_steps=10, total_steps=steps,
        min_lr=lr * 0.5))
    step = PS.make_train_step(model, aug_training_config())
    gen = torch.Generator().manual_seed(1)
    losses = []
    for i in range(steps):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        assert math.isfinite(losses[-1]), f"loss diverged at step {i}"
        assert math.isfinite(float(metrics["grad_norm"])), i
    first, last = np.mean(losses[:2]), np.mean(losses[-2:])
    assert last < 0.6 * first, (first, last)


# --- kill and resume ----------------------------------------------------------


class _Preempted(RuntimeError):
    pass


class _SyntheticLoader:
    """The same tiny batches every epoch, as numpy; raises at
    (epoch, iter) == kill_at."""

    def __init__(self, n=2, kill_at=None, seed=100):
        self.batches = [
            {grp: {k: t.numpy() for k, t in tree.items()}
             for grp, tree in make_synthetic_batch(
                 1, 2, 28, 28, seed=seed + i, device="cpu").items()}
            for i in range(n)]
        self.kill_at = kill_at
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, batch in enumerate(self.batches):
            if self.kill_at == (self.epoch, i):
                raise _Preempted(f"killed at epoch {self.epoch} iter {i}")
            yield batch


OPTIM = PS.OptimConfig(lr=1e-3, warmup_steps=2, total_steps=10)


def _train(out_dir, loader, **kw):
    cfg = L.TrainLoopConfig(output_dir=str(out_dir), epochs=3, print_freq=10,
                            save_freq=1, seed=0)
    return L.train(_tiny_model(), loader, cfg, OPTIM, device="cpu", **kw)


def test_kill_and_resume_is_trajectory_exact(tmp_path):
    state_a = _train(tmp_path / "a", _SyntheticLoader())
    with pytest.raises(_Preempted):
        _train(tmp_path / "b", _SyntheticLoader(kill_at=(1, 1)))
    # checkpoint-last holds the end of epoch 0; the resumed run (another
    # fresh model, overwritten by the checkpoint) replays epochs 1-2 with
    # the generators the uninterrupted run used
    state_b = _train(tmp_path / "b", _SyntheticLoader())
    assert state_a.step == state_b.step == 6
    assert state_a.optimizer.count == state_b.optimizer.count == 6
    pa = dict(state_a.model.named_parameters())
    for name, p in state_b.model.named_parameters():
        assert torch.equal(p, pa[name]), name
    for ta, tb in zip(state_a.optimizer.mu + state_a.optimizer.nu,
                      state_b.optimizer.mu + state_b.optimizer.nu):
        assert torch.equal(ta, tb)


def test_epoch_generators_are_fixed_by_seed_and_epoch():
    draw = [torch.rand(4, generator=L.epoch_generator(s, e, "cpu"))
            for s, e in ((0, 0), (0, 0), (0, 1), (1, 0))]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[3])


# --- checkpoints ----------------------------------------------------------------


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_checkpoint_round_trip_every_adamw_tensor(tmp_path, accum_steps):
    batch = make_synthetic_batch(1, 2, 28, 28, seed=4, device="cpu")
    cfg = PS.OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                         accum_steps=accum_steps)
    model = _tiny_model(1)
    state = PS.create_train_state(model, cfg)
    step = PS.make_train_step(model, aug_training_config())
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):  # with accumulation: one inner step, one pending
        state, _ = step(state, batch, gen)
    path = str(tmp_path / "ckpt")
    C.save_train_state(path, state, best_so_far=1.5, epoch=7)
    assert not (tmp_path / "ckpt.tmp").exists()

    fresh = PS.create_train_state(_tiny_model(2), cfg)
    fresh, best, epoch = C.load_train_state(path, fresh)
    assert (best, epoch, fresh.step) == (1.5, 7, 3)
    a, b = state.optimizer, fresh.optimizer
    assert (a.count, a.mini_step) == (b.count, b.mini_step)
    assert a.count == (3 if accum_steps == 1 else 1)
    tensors = list(zip(a.params + a.mu + a.nu, b.params + b.mu + b.nu))
    if accum_steps > 1:
        assert a.mini_step == 1 and any(bool(t.any()) for t in a.acc)
        tensors += list(zip(a.acc, b.acc))
    for ta, tb in tensors:
        assert torch.equal(ta, tb)
    # the optimizer still holds the model's own parameters
    assert all(p is q for p, q in zip(b.params, fresh.model.parameters()))

    params = str(tmp_path / "params")
    C.save_params(params, state.model)
    other = C.load_params(params, _tiny_model(3))
    for p, q in zip(state.model.parameters(), other.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="accum_steps"):
        C.load_train_state(path, PS.create_train_state(
            _tiny_model(), PS.OptimConfig(accum_steps=3 - accum_steps)))


def test_best_checkpoint_follows_median_val_loss(tmp_path, monkeypatch):
    """Per epoch, the median of the loaders' medians: 4 (saved), 6 (not),
    2 (saved), 3 (not); checkpoint-best then holds epoch 2's state."""
    medians = iter([{"a": 3.0, "b": 5.0, "c": 4.0},
                    {"a": 6.0, "b": 7.0, "c": 1.0},
                    {"a": 2.0, "b": 1.0, "c": 9.0},
                    {"a": 3.0, "b": 3.0, "c": 3.0}])
    seen = {}

    def fake_eval(model, loader, loss_cfg, epoch, name, device):
        if epoch not in seen:
            seen[epoch] = next(medians)
            seen[epoch]["params"] = [p.detach().clone()
                                     for p in model.parameters()]
        return {"loss_med": seen[epoch][name], "loss_avg": 0.0}

    monkeypatch.setattr(L, "test_one_epoch", fake_eval)
    loaders = {name: None for name in "abc"}
    cfg = L.TrainLoopConfig(output_dir=str(tmp_path), epochs=4,
                            print_freq=10, seed=0)
    L.train(_tiny_model(), _SyntheticLoader(n=1), cfg, OPTIM,
            test_loaders=loaders, device="cpu")
    best = PS.create_train_state(_tiny_model(5), OPTIM)
    best, best_val, epoch = C.load_train_state(
        str(tmp_path / "checkpoint-best"), best)
    assert (best_val, epoch, best.step) == (2.0, 2, 2)
    for p, q in zip(best.model.parameters(), seen[2]["params"]):
        assert torch.equal(p, q)
    last = PS.create_train_state(_tiny_model(5), OPTIM)
    _, last_best, last_epoch = C.load_train_state(
        str(tmp_path / "checkpoint-last"), last)
    assert (last_best, last_epoch, last.step) == (2.0, 4, 4)


def test_eval_is_images_only_and_frozen(tmp_path):
    """test_one_epoch reads the loader at epoch 0 with every prior off: its
    median and mean are those of the images-only losses."""
    from mapanything_tpu_torch.train.losses import overall_loss

    loader = _SyntheticLoader(n=3)
    loader.set_epoch(5)
    model = _tiny_model()
    stats = L.test_one_epoch(model, loader, epoch=3, device="cpu")
    assert loader.epoch == 0
    losses = []
    with torch.no_grad():
        for batch in loader.batches:
            batch = L.to_device(batch, "cpu")
            preds = model({"img": batch["views"]["img"]})
            losses.append(float(overall_loss(batch["gt"], preds)[0]))
    assert stats == {"loss_med": float(np.median(losses)),
                     "loss_avg": float(np.mean(losses))}


def test_train_runs_on_the_card_unless_asked(tmp_path):
    cfg = L.TrainLoopConfig(output_dir=str(tmp_path), epochs=1)
    with pytest.raises(ValueError, match="the model lives on cpu"):
        L.train(_tiny_model(), _SyntheticLoader(n=1), cfg, OPTIM,
                device="meta")


# --- SmoothedValue and MetricLogger against JAX's ------------------------------


def test_smoothed_value_and_metric_logger_match_jax():
    from mapanything_tpu.train import loop as JL

    seq = np.random.default_rng(0).standard_normal(37).tolist()
    for window in (5, 20, 50):
        ours, ref = L.SmoothedValue(window), JL.SmoothedValue(window)
        for i, x in enumerate(seq):
            ours.update(x, n=1 + i % 3)
            ref.update(x, n=1 + i % 3)
            for attr in ("median", "avg", "global_avg", "value", "count",
                         "total"):
                assert getattr(ours, attr) == getattr(ref, attr), attr
            assert str(ours) == str(ref)
    ours, ref = L.MetricLogger(), JL.MetricLogger()
    for i, x in enumerate(seq):
        kw = {"loss": x, "grad_norm": abs(x), "n_views": 2,
              "skipped": None if i % 2 else x}
        ours.update(**kw)
        ref.update(**kw)
    assert str(ours) == str(ref)
    assert ours.loss.median == ref.loss.median
    with pytest.raises(AttributeError):
        ours.missing
