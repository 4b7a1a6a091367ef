"""Misc utilities; counterpart of mapanything_tpu/utils/misc.py (the
reference's mapanything/utils/misc.py and parallel.py host helpers).

Seeding, stream-to-logger redirection, invalid-value masking, pooled maps
and the device -> host copy of nested outputs. The host -> device copy is
`utils/device.py::to_device`.
"""

from __future__ import annotations

import logging
import math
import multiprocessing
import random
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import torch

__all__ = ["StreamToLogger", "invalid_to_nans", "invalid_to_zeros",
           "process_map", "redirect_output_to_logger", "seed_everything",
           "thread_map", "to_host"]


def seed_everything(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (every card's
    too, which torch seeds lazily)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class StreamToLogger:
    """Redirect a stream (stdout/stderr) through logging
    (reference misc.py:18)."""

    def __init__(self, logger: logging.Logger, level: int = logging.INFO):
        self.logger = logger
        self.level = level
        self._buf = ""

    def write(self, buf: str):
        self._buf += buf
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line:
                self.logger.log(self.level, line)

    def flush(self):
        if self._buf:
            self.logger.log(self.level, self._buf)
            self._buf = ""


def redirect_output_to_logger(logger: logging.Logger) -> None:
    sys.stdout = StreamToLogger(logger, logging.INFO)
    sys.stderr = StreamToLogger(logger, logging.ERROR)


def _flatten_leading(arr: torch.Tensor, ndim: int) -> torch.Tensor:
    if arr.ndim > ndim:
        arr = arr.reshape((-1,) + tuple(arr.shape[-(ndim - 1):]))
    return arr


def invalid_to_nans(arr: torch.Tensor, valid_mask: Optional[torch.Tensor],
                    ndim: int = 999) -> torch.Tensor:
    """A copy of `arr` (..., C) with NaN where `valid_mask` (...) is False,
    leading dims merged down to `ndim` (reference misc.py
    invalid_to_nans, which writes in place)."""
    if valid_mask is not None:
        arr = torch.where(valid_mask[..., None], arr,
                          torch.full_like(arr, float("nan")))
    return _flatten_leading(arr, ndim)


def invalid_to_zeros(arr: torch.Tensor, valid_mask: Optional[torch.Tensor],
                     ndim: int = 999):
    """`arr` zeroed where invalid and the count of valid entries per batch
    item (misc.py invalid_to_zeros)."""
    if valid_mask is not None:
        arr = arr * valid_mask[..., None]
        nnz = valid_mask.reshape(valid_mask.shape[0], -1).sum(dim=-1)
    else:
        nnz = math.prod(arr.shape[1:-1])
    return _flatten_leading(arr, ndim), nnz


def thread_map(fn: Callable, items: Iterable, max_workers: int = 8
               ) -> List[Any]:
    """Ordered threaded map (reference parallel.py equivalents)."""
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(fn, items))


def process_map(fn: Callable, items: Iterable, max_workers: int = 8
                ) -> List[Any]:
    """Ordered map over spawned worker processes (a fork would copy the
    parent's threads' locks): `fn` and the items must pickle."""
    with ProcessPoolExecutor(
            max_workers=max_workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(fn, items))


def to_host(tree):
    """Every tensor of a nested dict / list / tuple as a numpy array (bf16
    widened to fp32); other leaves unchanged."""
    if isinstance(tree, dict):
        return {key: to_host(val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(val) for val in tree)
    if isinstance(tree, torch.Tensor):
        x = tree.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return tree
