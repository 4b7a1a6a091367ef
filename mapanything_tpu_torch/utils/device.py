"""Where the port's entry points put their tensors."""

from __future__ import annotations

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
