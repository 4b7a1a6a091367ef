"""Optimizer, learning-rate schedule and the training step; counterpart of
mapanything_tpu/train/step.py.

The optimizer is the JAX package's optax chain written out on tensors:

  * one global clip of the gradient norm to `grad_clip` ahead of the groups
    (optax.clip_by_global_norm: no epsilon, unchanged below the limit);
  * AdamW per parameter group: the encoder at `encoder_lr_scale` times the
    schedule, everything else at 1 (optax.scale_by_adam with eps after the
    square root, then add_decayed_weights, then scale_by_learning_rate);
  * weight decay `p * weight_decay` added to the Adam update, only for
    parameters with more than one dimension;
  * a linear warmup from 0 followed by a cosine decay to `min_lr`
    (optax.warmup_cosine_decay_schedule): the first step runs at lr 0;
  * `accum_steps > 1` averages the gradients of k micro-steps (a running
    mean) and steps the inner optimizer once per k (optax.MultiSteps).

Parameters and optimizer state are fp32 and updated in place. The forward
computes in the model's dtype (bf16 at the released width).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch
from torch import nn

from ..models import GeometricInputConfig, MapAnything, images_only_config
from .losses import OverallLossConfig, overall_loss


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 2e-4
    encoder_lr_scale: float = 0.05  # 1e-5 / 2e-4 (lower_encoder_lr_64g.yaml)
    warmup_steps: int = 1000
    total_steps: int = 100_000
    min_lr: float = 1e-6
    weight_decay: float = 0.05
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    accum_steps: int = 1


def cosine_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Linear warmup from 0 to `lr` over `warmup_steps`, then a cosine decay
    to `min_lr` at `total_steps`."""

    def schedule(step: int) -> float:
        if step < cfg.warmup_steps:
            return cfg.lr * step / cfg.warmup_steps
        decay_steps = cfg.total_steps - cfg.warmup_steps
        t = min(step - cfg.warmup_steps, decay_steps)
        alpha = cfg.min_lr / cfg.lr if cfg.lr else 0.0
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return cfg.lr * ((1 - alpha) * cosine + alpha)

    return schedule


def group_label(name: str) -> str:
    """"encoder" for the image encoder's parameters, "rest" otherwise."""
    return "encoder" if name.split(".", 1)[0] == "encoder" else "rest"


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element of fp32 tensors."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class AdamW:
    """The JAX package's make_optimizer chain on a model's parameters.

    `step(grads, norm)` takes one gradient per parameter, in the order of
    `model.named_parameters()`, and updates the parameters in place. It
    clips the gradients in place; `norm`, their global norm, may be passed
    by a caller that has it already.
    """

    def __init__(self, cfg: OptimConfig, model: nn.Module):
        self.cfg = cfg
        self.schedule = cosine_schedule(cfg)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.labels = [group_label(n) for n in self.names]
        self.decay = [p.ndim > 1 for p in self.params]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # inner steps taken (optax's count)
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.accum_steps > 1 else None)

    def step(self, grads, norm=None) -> None:
        grads = list(grads)
        if self.acc is not None:
            n = self.mini_step
            # the running mean acc + (g - acc) / (n + 1), as optax.MultiSteps
            for acc, g in zip(self.acc, grads):
                acc.add_((g - acc) / (n + 1))
            self.mini_step = (n + 1) % self.cfg.accum_steps
            if self.mini_step:
                return
            grads, norm = self.acc, None
        self._inner_step(grads, global_norm(grads) if norm is None else norm)
        if self.acc is not None:
            for acc in self.acc:
                acc.zero_()

    @torch.no_grad()
    def _inner_step(self, grads, norm) -> None:
        cfg = self.cfg
        clip = torch.where(norm < cfg.grad_clip, 1.0, cfg.grad_clip / norm)
        torch._foreach_mul_(grads, clip)
        lr = self.schedule(self.count)
        self.count += 1
        # the moments, as optax.scale_by_adam (eps after the square root)
        torch._foreach_mul_(self.mu, cfg.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - cfg.b1)
        torch._foreach_mul_(self.nu, cfg.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - cfg.b2)
        denom = torch._foreach_div(self.nu, 1 - cfg.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        upd = torch._foreach_div(self.mu, 1 - cfg.b1 ** self.count)
        torch._foreach_div_(upd, denom)
        del denom
        decayed = [i for i, d in enumerate(self.decay) if d]
        if decayed:
            torch._foreach_add_([upd[i] for i in decayed],
                                [self.params[i] for i in decayed],
                                alpha=cfg.weight_decay)
        for label, scale in (("encoder", cfg.encoder_lr_scale), ("rest", 1.0)):
            idx = [i for i, g in enumerate(self.labels) if g == label]
            if idx:
                torch._foreach_add_([self.params[i] for i in idx],
                                    [upd[i] for i in idx],
                                    alpha=-(lr * scale))


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer and the step count."""

    model: MapAnything
    optimizer: AdamW
    step: int = 0

    def apply_gradients(self, grads, norm=None) -> "TrainState":
        self.optimizer.step(grads, norm)
        self.step += 1
        return self


def make_optimizer(cfg: OptimConfig, model: nn.Module) -> AdamW:
    return AdamW(cfg, model)


def create_train_state(model: MapAnything,
                       optim_cfg: OptimConfig) -> TrainState:
    return TrainState(model=model, optimizer=make_optimizer(optim_cfg, model))


def _check_images_only(geom_cfg: GeometricInputConfig) -> None:
    if geom_cfg != images_only_config():
        raise NotImplementedError(
            "training with geometric inputs is not ported yet: ROADMAP queue "
            "A item 8 (multimodal priors); use images_only_config()")


def make_loss_fn(model: MapAnything, geom_cfg: GeometricInputConfig,
                 loss_cfg: OverallLossConfig = OverallLossConfig()):
    """(batch) -> (loss, details): the model on the batch's images, then
    the released criterion against the batch's GT."""
    _check_images_only(geom_cfg)

    def loss_fn(batch: Dict) -> tuple:
        # images only: the views' prior keys are inputs this config ignores
        preds = model({"img": batch["views"]["img"]})
        return overall_loss(batch["gt"], preds, loss_cfg)

    return loss_fn


def loss_and_grads(loss_fn, params, batch: Dict):
    """Run loss_fn forward and backward; returns (loss, details, grads) with
    one gradient per parameter (zeros where none reached it)."""
    for p in params:
        p.grad = None
    loss, details = loss_fn(batch)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    return loss.detach(), details, grads


def make_train_step(model: MapAnything, geom_cfg: GeometricInputConfig,
                    loss_cfg: OverallLossConfig = OverallLossConfig()
                    ) -> Callable:
    """Build train_step(state, batch) -> (state, metrics).

    `batch` holds "views" (the model inputs) and "gt" (the supervision), as
    data/synthetic.py makes it. Only the images-only geometric config is
    ported; it is deterministic, so the step takes no random key (the JAX
    step's `rng`). metrics: "loss", every loss detail, and "grad_norm", the
    global norm before clipping; all are tensors on the model's device.
    """
    loss_fn = make_loss_fn(model, geom_cfg, loss_cfg)

    def train_step(state: TrainState, batch: Dict):
        loss, details, grads = loss_and_grads(
            loss_fn, state.optimizer.params, batch)
        norm = global_norm(grads)
        metrics = {"loss": loss,
                   **{k: v.detach() for k, v in details.items()},
                   "grad_norm": norm}
        state.apply_gradients(grads, norm)
        for p in state.optimizer.params:
            p.grad = None  # free the gradients before the next forward
        return state, metrics

    return train_step


__all__ = [
    "AdamW",
    "OptimConfig",
    "TrainState",
    "cosine_schedule",
    "create_train_state",
    "global_norm",
    "group_label",
    "loss_and_grads",
    "make_loss_fn",
    "make_optimizer",
    "make_train_step",
]
