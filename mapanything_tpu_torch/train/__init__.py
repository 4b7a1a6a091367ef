"""Training slice of the PyTorch port: the released loss, AdamW, the train
step and its view-sharded form (counterpart of mapanything_tpu/train)."""

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
    "make_view_sharded_train_step",
    "overall_loss",
    "released_criterion",
    "view_sharded_overall_loss",
]
