"""Training slice of the PyTorch port: the released loss, AdamW, the train
step and its view-sharded form, checkpoints and the training loop
(counterpart of mapanything_tpu/train)."""

from . import criteria
from .criteria import MultiLoss, released_criterion
from .losses import (
    FactoredGeometryConfig,
    OverallLossConfig,
    RobustRegressionLoss,
    bce_with_logits,
    overall_loss,
)
from .step import (
    AdamW,
    OptimConfig,
    TrainState,
    cosine_schedule,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from .seq_parallel import (
    make_view_sharded_train_step,
    view_sharded_overall_loss,
)
from .checkpoints import (
    load_params,
    load_train_state,
    save_params,
    save_train_state,
)
from .loop import MetricLogger, SmoothedValue, TrainLoopConfig, train

__all__ = [
    "AdamW",
    "FactoredGeometryConfig",
    "MetricLogger",
    "MultiLoss",
    "OptimConfig",
    "OverallLossConfig",
    "RobustRegressionLoss",
    "SmoothedValue",
    "TrainLoopConfig",
    "TrainState",
    "bce_with_logits",
    "cosine_schedule",
    "create_train_state",
    "criteria",
    "load_params",
    "load_train_state",
    "make_optimizer",
    "make_train_step",
    "make_view_sharded_train_step",
    "overall_loss",
    "released_criterion",
    "save_params",
    "save_train_state",
    "train",
    "view_sharded_overall_loss",
]
