"""Training slice of the PyTorch port: the released loss and the composable
criteria, AdamW, the train step and its view-sharded form, checkpoints, the
training loop and its CLI, `python -m mapanything_tpu_torch.train`
(counterpart of mapanything_tpu/train and scripts/train.py)."""

from . import criteria
from .criteria import MultiLoss, released_criterion
from .losses import (
    FactoredGeometryConfig,
    L1Loss,
    L2Loss,
    OverallLossConfig,
    RobustRegressionLoss,
    bce_with_logits,
    exclude_top_n_percent,
    factored_geometry_scale_regr3d,
    non_ambiguous_mask_loss,
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
from .loop import (
    MetricLogger,
    SmoothedValue,
    TrainLoopConfig,
    build_dataset_mix,
    train,
)

__all__ = [
    "AdamW",
    "FactoredGeometryConfig",
    "L1Loss",
    "L2Loss",
    "MetricLogger",
    "MultiLoss",
    "OptimConfig",
    "OverallLossConfig",
    "RobustRegressionLoss",
    "SmoothedValue",
    "TrainLoopConfig",
    "TrainState",
    "bce_with_logits",
    "build_dataset_mix",
    "cosine_schedule",
    "create_train_state",
    "criteria",
    "exclude_top_n_percent",
    "factored_geometry_scale_regr3d",
    "load_params",
    "load_train_state",
    "make_optimizer",
    "make_train_step",
    "make_view_sharded_train_step",
    "non_ambiguous_mask_loss",
    "overall_loss",
    "released_criterion",
    "save_params",
    "save_train_state",
    "train",
    "view_sharded_overall_loss",
]
