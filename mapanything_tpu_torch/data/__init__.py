"""Host-side data loading of the PyTorch port."""

from .image import IMAGE_NORMALIZATION_DICT, load_images

__all__ = ["IMAGE_NORMALIZATION_DICT", "load_images"]
