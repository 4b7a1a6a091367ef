"""Training slice of the PyTorch port: the released loss, AdamW and the
train step (counterpart of mapanything_tpu/train)."""

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

__all__ = [
    "AdamW",
    "FactoredGeometryConfig",
    "MultiLoss",
    "OptimConfig",
    "OverallLossConfig",
    "RobustRegressionLoss",
    "TrainState",
    "bce_with_logits",
    "cosine_schedule",
    "create_train_state",
    "criteria",
    "make_optimizer",
    "make_train_step",
    "overall_loss",
    "released_criterion",
]
