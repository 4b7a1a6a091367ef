"""Where the port's entry points put their tensors."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when None. A CUDA device without a card raises:
    the entry points run on the CPU only when the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return device


def to_device(batch, device):
    """The batch's numpy arrays and tensors on `device`, nested dicts
    kept."""
    if isinstance(batch, dict):
        return {key: to_device(val, device) for key, val in batch.items()}
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device)
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return batch


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and convs, the caller's setting restored: fp32
    products in full fp32, as the JAX package's precision="highest"."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
