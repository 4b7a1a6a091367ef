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

The step feeds the batch's views, priors included, to the model with the
geometric config; a stochastic config (the `aug_training` mix) draws its
masks from the torch.Generator the step is given, the JAX step's `rng`.

With a mesh (parallel/mesh.py; JAX's `jit_train_step(mesh=)`), each rank
holds its data rank's rows and, for a tensor-parallel model, its part of
the sharded layers: the masks are those of the whole batch's draw, the
loss is the whole batch's (criteria.Reduction over the data group), the
gradients are summed over the data group in flat buckets, the global norm
counts every sharded gradient's squares once over the model group, and
AdamW updates the local parts. So the step computes what the one-rank step
computes on the whole batch.

On the card, a step whose inputs match an earlier step's replays a CUDA
graph of the whole step: forward, criterion, backward, the norm, the clip
and AdamW, captured once for each batch shape (make_train_step). AdamW
reads its per-step scalars, the groups' learning rates and the bias
corrections, from a device tensor that the host writes before each step,
so the captured update follows the schedule. A mesh, gradient
accumulation and parameters on the CPU keep the step eager.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

import torch.distributed as dist

from ..models import GeometricInputConfig, MapAnything
from ..models.mapanything import scene_rep_family, scene_rep_keys
from ..parallel.distributed import all_reduce_grads
from ..perf.timing import span
from .criteria import Reduction
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


def model_norm(model: nn.Module) -> Callable:
    """The global norm of one tensor per parameter of `model`: local, or,
    for a tensor-parallel model (parallel/mesh.py::shard_params), the
    squares of the split parameters' parts summed over the model group and
    those of the replicated ones counted once."""
    split = getattr(model, "tp_split", {})
    if not split:
        return global_norm
    group = model.mesh.model_group
    flags = [name in split for name, _ in model.named_parameters()]

    def norm(tensors) -> torch.Tensor:
        sq = torch.stack(torch._foreach_norm(tensors)) ** 2
        is_split = torch.tensor(flags, device=sq.device)
        parts = torch.stack([sq[is_split].sum(), sq[~is_split].sum()])
        both = parts.clone()
        dist.all_reduce(both, group=group)
        return torch.sqrt(both[0] + parts[1])

    return norm


class AdamW:
    """The JAX package's make_optimizer chain on a model's parameters.

    `step(grads, norm)` takes one gradient per parameter, in the order of
    `model.named_parameters()`, and updates the parameters in place. It
    clips the gradients in place; `norm`, their global norm, may be passed
    by a caller that has it already. A tensor-parallel model's parameters
    are its local parts, and their norm is the model group's (model_norm).

    An inner step is `write_scalars()`, the host's part (the count, the
    schedule), then `update(grads, norm)`, the device's: the update reads
    its learning rates and bias corrections from `scalars`, so that a CUDA
    graph of `update` replays each step's values.
    """

    def __init__(self, cfg: OptimConfig, model: nn.Module):
        self.cfg = cfg
        self.schedule = cosine_schedule(cfg)
        self.norm = model_norm(model)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.labels = [group_label(n) for n in self.names]
        self.decay = [p.ndim > 1 for p in self.params]
        # the inner step's scalars (write_scalars): -lr of the encoder
        # group and of the rest, then 1 - b1**count and 1 - b2**count
        self.scalars = torch.zeros(4, dtype=torch.float32,
                                   device=self.params[0].device)
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
        self.write_scalars()
        self.update(grads, self.norm(grads) if norm is None else norm)
        if self.acc is not None:
            for acc in self.acc:
                acc.zero_()

    def write_scalars(self) -> None:
        """Count one inner step and write its scalars to `scalars`: a copy
        from pinned memory on the current stream, ahead of the update that
        reads them. Each is the fp32 rounding of the Python float the
        update once took as an argument."""
        cfg = self.cfg
        lr = self.schedule(self.count)
        self.count += 1
        host = torch.tensor([-(lr * cfg.encoder_lr_scale), -lr,
                             1 - cfg.b1 ** self.count,
                             1 - cfg.b2 ** self.count], dtype=torch.float32)
        if self.scalars.is_cuda:
            host = host.pin_memory()
        self.scalars.copy_(host, non_blocking=True)

    @torch.no_grad()
    def update(self, grads, norm) -> None:
        """The inner step's device work: the clip, the moments and the
        update, its per-step scalars read from `scalars`."""
        cfg = self.cfg
        lr_encoder, lr_rest, bias1, bias2 = self.scalars.unbind()
        clip = torch.where(norm < cfg.grad_clip, 1.0, cfg.grad_clip / norm)
        torch._foreach_mul_(grads, clip)
        # the moments, as optax.scale_by_adam (eps after the square root)
        torch._foreach_mul_(self.mu, cfg.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - cfg.b1)
        torch._foreach_mul_(self.nu, cfg.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - cfg.b2)
        denom = torch._foreach_div(self.nu, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        upd = torch._foreach_div(self.mu, bias1)
        torch._foreach_div_(upd, denom)
        del denom
        decayed = [i for i, d in enumerate(self.decay) if d]
        if decayed:
            torch._foreach_add_([upd[i] for i in decayed],
                                [self.params[i] for i in decayed],
                                alpha=cfg.weight_decay)
        for label, neg_lr in (("encoder", lr_encoder), ("rest", lr_rest)):
            idx = [i for i, g in enumerate(self.labels) if g == label]
            if idx:
                scaled = [upd[i] for i in idx]
                torch._foreach_mul_(scaled, neg_lr)
                torch._foreach_add_([self.params[i] for i in idx], scaled)


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


# the predictions the released criterion reads (train/criteria.py)
RELEASED_LOSS_KEYS = frozenset({
    "metric_scaling_factor", "pts3d", "pts3d_cam", "depth_along_ray",
    "ray_directions", "cam_trans", "cam_quats", "conf",
    "non_ambiguous_mask_logits"})


def check_released_scene_rep(model: MapAnything,
                             step: str = "the train step") -> None:
    """Raise ValueError for a model whose outputs lack a key the released
    criterion reads: the scene representations the JAX package's step fails
    on (KeyError there). The ones it trains are the pose families with
    +confidence+mask. The message names the missing keys and the composed
    criteria that take the family (forward, criterion, backward, AdamW, as
    tests/test_criteria.py composes them)."""
    srt = model.cfg.scene_rep_type
    missing = RELEASED_LOSS_KEYS - scene_rep_keys(srt)
    if missing:
        criteria = ("FactoredGeometryScaleRegr3D or a Disentangled* "
                    "criterion" if scene_rep_family(srt).endswith("pose")
                    else "Regr3D or PointsPlusScaleRegr3D")
        raise ValueError(
            f"{step} trains the released criterion, which reads "
            f"{sorted(missing)}; scene_rep_type {srt!r} does not output "
            f"them. Compose {criteria} from train/criteria.py for it (with "
            "ConfLoss where it has +confidence, NonAmbiguousMaskLoss where "
            "it has +mask)")


def make_loss_fn(model: MapAnything, geom_cfg: GeometricInputConfig,
                 loss_cfg: OverallLossConfig = OverallLossConfig(),
                 mesh=None):
    """(batch, generator=None) -> (loss, details): the model on the batch's
    views with `geom_cfg` (its masks drawn from `generator`), then the
    released criterion against the batch's GT. With a mesh, the batch is
    this data rank's rows: the loss is the whole batch's and
    ``details["_share"]`` the rank's share (losses.py::overall_loss)."""
    check_released_scene_rep(model)
    red = None if mesh is None else Reduction(data_group=mesh.data_group)
    shard = None if mesh is None else (mesh.data_rank, mesh.n_data)

    def loss_fn(batch: Dict, generator: Optional[torch.Generator] = None
                ) -> tuple:
        preds = model(batch["views"], geom_cfg, generator, batch_shard=shard)
        with span("train.loss"):
            return overall_loss(batch["gt"], preds, loss_cfg, red)

    return loss_fn


def loss_and_grads(loss_fn, params, batch: Dict,
                   generator: Optional[torch.Generator] = None,
                   data_group=None):
    """Run loss_fn forward and backward; returns (loss, details, grads) with
    one gradient per parameter (zeros where none reached it: a prior
    encoder whose mask was 0 in this step still decays under AdamW). The
    rank's share of the loss is backpropagated where loss_fn gives one,
    and the gradients are summed over `data_group`."""
    for p in params:
        p.grad = None
    with span("train.forward"):
        loss, details = loss_fn(batch, generator)
    with span("train.backward"):
        details.pop("_share", loss).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if data_group is not None:
            all_reduce_grads(grads, data_group)
    return loss.detach(), details, grads


def graphable(state: TrainState, batch: Dict, mesh=None) -> bool:
    """Whether a CUDA graph can serve the step: the parameters and the
    batch's tensors on one card, no mesh (its collectives) and no gradient
    accumulation (the micro-steps' Python branch)."""
    opt = state.optimizer
    device = opt.params[0].device
    if device.type != "cuda" or mesh is not None or opt.acc is not None:
        return False
    return all(t.device == device for part in ("views", "gt")
               for t in batch[part].values() if isinstance(t, torch.Tensor))


def step_signature(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator],
                   geom_cfg: GeometricInputConfig) -> tuple:
    """(binding, shape): what a captured step is bound to. The binding is
    what the graph reads and writes by address: the generator's identity,
    and the identity and storage of the optimizer's parameters, moments
    and scalars. The shape is the key, shape, dtype and device of each
    tensor of the batch's views and gt (a plain value by its value, any
    other by its identity) and the geometric config."""
    plain = (str, int, float, bool, type(None))

    def part(d):
        return tuple(
            (k, (tuple(v.shape), v.dtype, v.device)
             if isinstance(v, torch.Tensor)
             else v if isinstance(v, plain) else id(v))
            for k, v in sorted(d.items()))

    opt = state.optimizer
    tensors = [*opt.params, *opt.mu, *opt.nu, opt.scalars]
    binding = (id(generator), id(opt),
               tuple((id(t), t.data_ptr()) for t in tensors))
    return binding, (part(batch["views"]), part(batch["gt"]), geom_cfg)


def next_path(signature: Optional[tuple], warmed, captured) -> str:
    """"eager", "capture" or "replay": a step no graph can serve (signature
    None) or of a signature not yet run (not in `warmed`) runs eagerly; the
    second of a signature is captured and replayed, the later ones are
    replayed (the signature in `captured`)."""
    if signature is None or signature not in warmed:
        return "eager"
    return "replay" if signature in captured else "capture"


# raised, from CUDA's own error, where the capture of a step fails
CAPTURE_FAILED = (
    "CUDA refused to capture the training step. One cause is an autograd "
    "graph that the caller keeps alive from an earlier forward on the "
    "default stream (a loss, or a loss detail, not let go): it holds the "
    "parameters' gradient accumulators on that stream, which a capture may "
    "not touch. Let go of such losses and their details before the step")


@dataclasses.dataclass
class _Captured:
    """One captured step: the graph, its static batch and its metrics."""

    graph: "torch.cuda.CUDAGraph"
    batch: Dict
    metrics: Dict


class _StepGraphs:
    """make_train_step's captured steps, one for each signature seen twice,
    all of one binding (step_signature), whose generator and state are held
    so that no other object takes their ids. The graphs share one memory
    pool: one replays at a time and its metrics are cloned out before the
    next, so their activations are one step's, and each graph kept adds
    its static batch. A new binding drops them."""

    def __init__(self):
        self.side = None  # the warm-ups' stream
        self.reset(None, None)

    def reset(self, binding, held) -> None:
        self.binding, self.held = binding, held
        self.warmed: set = set()  # the signatures run eagerly once
        self.captured: Dict[tuple, _Captured] = {}
        self.pool = None


def make_train_step(model: MapAnything, geom_cfg: GeometricInputConfig,
                    loss_cfg: OverallLossConfig = OverallLossConfig(),
                    mesh=None) -> Callable:
    """Build train_step(state, batch, generator=None) -> (state, metrics).

    `batch` holds "views" (the model inputs, priors included) and "gt" (the
    supervision), as data/synthetic.py makes it. `generator`, a
    torch.Generator on the model's device, is the JAX step's `rng`: the
    masks of a stochastic `geom_cfg` are drawn from it, and a stochastic
    config without one raises ValueError. metrics: "loss", every loss
    detail, and "grad_norm", the global norm before clipping; all are
    tensors on the model's device, the step's own.

    With `mesh` (parallel/mesh.py, after shard_params and before
    create_train_state for a tensor-parallel model), `batch` holds this
    data rank's rows (shard_batch) and the step is the module docstring's:
    the loss, grad_norm and updated parameters of the one-rank step on the
    whole batch, and the loss details are the whole batch's too.

    On the card, without a mesh or accumulation (graphable), the step
    keeps a CUDA graph of itself for each step_signature (a training
    loader's aspect-ratio buckets and view counts each get their own). The
    first step of a signature runs eagerly, on a side stream, as capture's
    warm-up; the second is captured, and it and the later ones are
    replays: the batch copied into the graph's inputs, the optimizer's
    scalars written, one replay, the metrics cloned out (the span
    "train.graph"). The generator's draws are the eager step's: the graph
    advances it as the step would. A step with another generator or state
    drops the graphs. A capture that CUDA refuses raises RuntimeError
    (CAPTURE_FAILED). `train_step.counts` counts the "captures", the
    "replays" and the "eager" steps.
    """
    loss_fn = make_loss_fn(model, geom_cfg, loss_cfg, mesh)
    data_group = None if mesh is None else mesh.data_group
    graphs = _StepGraphs()
    counts = {"captures": 0, "replays": 0, "eager": 0}

    def run(state, batch, generator, apply) -> Dict:
        loss, details, grads = loss_and_grads(
            loss_fn, state.optimizer.params, batch, generator, data_group)
        with span("train.optimizer"):
            norm = state.optimizer.norm(grads)
            metrics = {"loss": loss,
                       **{k: v.detach() for k, v in details.items()},
                       "grad_norm": norm}
            apply(grads, norm)
            for p in state.optimizer.params:
                p.grad = None  # free the gradients before the next forward
        return metrics

    def eager(state, batch, generator) -> Dict:
        counts["eager"] += 1
        return run(state, batch, generator, state.apply_gradients)

    def capture(state, batch, generator) -> _Captured:
        g = torch.cuda.CUDAGraph()
        if generator is not None:
            g.register_generator_state(generator)
        static = {part: {k: v.clone() if isinstance(v, torch.Tensor) else v
                         for k, v in batch[part].items()}
                  for part in ("views", "gt")}
        if graphs.pool is None:
            graphs.pool = torch.cuda.graph_pool_handle()
        try:
            with torch.cuda.graph(g, pool=graphs.pool,
                                  capture_error_mode="thread_local"):
                metrics = run(state, static, generator,
                              state.optimizer.update)
        except torch.cuda.OutOfMemoryError:
            raise
        except RuntimeError as err:
            raise RuntimeError(CAPTURE_FAILED) from err
        counts["captures"] += 1
        return _Captured(g, static, metrics)

    def warm_up(state, batch, generator) -> Dict:
        """An eager step on a side stream, as capture requires."""
        if graphs.side is None:
            graphs.side = torch.cuda.Stream(state.optimizer.params[0].device)
        main = torch.cuda.current_stream()
        graphs.side.wait_stream(main)
        with torch.cuda.stream(graphs.side):
            metrics = eager(state, batch, generator)
        main.wait_stream(graphs.side)
        return metrics

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None):
        signature = (step_signature(state, batch, generator, geom_cfg)
                     if graphable(state, batch, mesh) else None)
        binding = None if signature is None else signature[0]
        if binding != graphs.binding:
            graphs.reset(binding, None if binding is None
                         else (generator, state))
        path = next_path(signature, graphs.warmed, graphs.captured)
        if path == "eager":
            if signature is None:
                return state, eager(state, batch, generator)
            graphs.warmed.add(signature)
            return state, warm_up(state, batch, generator)
        if path == "capture":
            graphs.captured[signature] = capture(state, batch, generator)
        step = graphs.captured[signature]
        with span("train.graph"):
            if path == "replay":
                for part, static in step.batch.items():
                    for k, v in static.items():
                        if isinstance(v, torch.Tensor):
                            v.copy_(batch[part][k])
                counts["replays"] += 1
            state.optimizer.write_scalars()
            step.graph.replay()
            metrics = {k: v.clone() for k, v in step.metrics.items()}
        state.step += 1
        return state, metrics

    train_step.counts = counts
    return train_step


__all__ = [
    "AdamW",
    "OptimConfig",
    "TrainState",
    "cosine_schedule",
    "create_train_state",
    "global_norm",
    "graphable",
    "group_label",
    "loss_and_grads",
    "make_loss_fn",
    "make_optimizer",
    "make_train_step",
    "model_norm",
    "next_path",
    "step_signature",
]
