"""Host-side data loading of the PyTorch port."""

from .image import IMAGE_NORMALIZATION_DICT, load_images
from .synthetic import make_synthetic_batch

__all__ = ["IMAGE_NORMALIZATION_DICT", "load_images", "make_synthetic_batch"]
