"""Host-side data of the PyTorch port: image loading and preprocessing,
synthetic batches, and the WAI data layer (scene IO, datasets, samplers and
the threaded loader)."""

from .base_dataset import BaseDataset
from .combinators import CatDataset, EasyDataset, MulDataset, ResizedDataset
from .image import IMAGE_NORMALIZATION_DICT, load_images
from .loader import (
    DataLoader,
    collate_views,
    get_test_data_loader,
    get_train_data_loader,
)
from .samplers import (
    BatchedMultiFeatureRandomSampler,
    BatchedRandomSampler,
    DynamicBatchedMultiFeatureRandomSampler,
)
from .synthetic import make_synthetic_batch
from .wai_datasets import WAI_DATASET_SPECS, WAIDataset, make_wai_dataset

__all__ = [
    "BaseDataset",
    "BatchedMultiFeatureRandomSampler",
    "BatchedRandomSampler",
    "CatDataset",
    "DataLoader",
    "DynamicBatchedMultiFeatureRandomSampler",
    "EasyDataset",
    "IMAGE_NORMALIZATION_DICT",
    "MulDataset",
    "ResizedDataset",
    "WAIDataset",
    "WAI_DATASET_SPECS",
    "collate_views",
    "get_test_data_loader",
    "get_train_data_loader",
    "load_images",
    "make_synthetic_batch",
    "make_wai_dataset",
]
