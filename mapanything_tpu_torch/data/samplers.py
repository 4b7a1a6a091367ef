"""Batched samplers; counterpart of mapanything_tpu/data/samplers.py (the
reference's datasets/base/batched_sampler.py).

Three samplers, same contracts as the reference:
  * BatchedRandomSampler (:33) — every sample in a batch shares one feature
    index (e.g. the aspect-ratio bucket) so batches stack into one shape;
  * BatchedMultiFeatureRandomSampler (:134) — same with multiple feature
    pools (aspect ratio x num-views);
  * DynamicBatchedMultiFeatureRandomSampler (:244) — batch size derives from
    a feature (num views) via feature_to_batch_size_map =
    max_imgs_per_device // num_views, with round-robin rank distribution.

All yield tuples (sample_idx, feat_idx_1, ...) consumed by
BaseDataset.__getitem__. Pure numpy: the rank split takes the place of
torch's DistributedSampler."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np


class BatchedRandomSampler:
    """Random sampling; each batch shares one feature index."""

    def __init__(self, dataset, batch_size: int, pool_size: int,
                 world_size: int = 1, rank: int = 0, drop_last: bool = True):
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.len_dataset = n = len(dataset)
        self.total_size = round_by(n, batch_size * world_size) if drop_last else n
        self.world_size = world_size
        self.rank = rank
        self.epoch = None

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.epoch is None:
            assert self.world_size == 1 and self.rank == 0, (
                "call set_epoch(epoch) in distributed mode"
            )
            seed = int(np.random.randint(2**31))
        else:
            seed = self.epoch + 788
        rng = np.random.default_rng(seed=seed)

        sample_idxs = np.arange(self.total_size) % self.len_dataset
        rng.shuffle(sample_idxs)
        n_batches = (self.total_size + self.batch_size - 1) // self.batch_size
        feat_idxs = rng.integers(self.pool_size, size=n_batches)
        feat_idxs = np.repeat(feat_idxs, self.batch_size)[: self.total_size]
        idxs = np.stack([sample_idxs, feat_idxs], axis=-1)

        # rank-contiguous split
        size_per_proc = self.total_size // self.world_size
        idxs = idxs[self.rank * size_per_proc : (self.rank + 1) * size_per_proc]
        yield from (tuple(row) for row in idxs)


class BatchedMultiFeatureRandomSampler:
    """Random sampling; each batch shares indices for MULTIPLE features."""

    def __init__(self, dataset, batch_size: int, pool_sizes: Union[int, List[int]],
                 world_size: int = 1, rank: int = 0, drop_last: bool = True):
        self.batch_size = batch_size
        self.pool_sizes = pool_sizes if isinstance(pool_sizes, list) else [pool_sizes]
        self.len_dataset = n = len(dataset)
        self.total_size = round_by(n, batch_size * world_size) if drop_last else n
        self.world_size = world_size
        self.rank = rank
        self.epoch = None

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.epoch is None:
            assert self.world_size == 1 and self.rank == 0, (
                "call set_epoch(epoch) in distributed mode"
            )
            seed = int(np.random.randint(2**31))
        else:
            seed = self.epoch + 788
        rng = np.random.default_rng(seed=seed)

        sample_idxs = np.arange(self.total_size) % self.len_dataset
        rng.shuffle(sample_idxs)
        n_batches = (self.total_size + self.batch_size - 1) // self.batch_size
        feats = []
        for pool in self.pool_sizes:
            f = rng.integers(pool, size=n_batches)
            feats.append(np.repeat(f, self.batch_size)[: self.total_size])
        idxs = np.stack([sample_idxs] + feats, axis=-1)

        size_per_proc = self.total_size // self.world_size
        idxs = idxs[self.rank * size_per_proc : (self.rank + 1) * size_per_proc]
        yield from (tuple(row) for row in idxs)


class DynamicBatchedMultiFeatureRandomSampler:
    """Feature-dependent batch sizes: yields LISTS of index tuples, one list
    per batch, sized by feature_to_batch_size_map[feat] (num views -> batch).

    Batches are distributed round-robin across ranks (reference
    batched_sampler.py:358-431)."""

    def __init__(
        self,
        dataset,
        pool_sizes: Union[int, List[int]],
        scaling_feature_idx: int = 0,
        feature_to_batch_size_map: Optional[Union[Dict[int, int], Callable]] = None,
        world_size: int = 1,
        rank: int = 0,
        drop_last: bool = True,
    ):
        self.pool_sizes = pool_sizes if isinstance(pool_sizes, list) else [pool_sizes]
        if not 0 <= scaling_feature_idx < len(self.pool_sizes):
            raise ValueError(
                f"scaling_feature_idx must be in [0, {len(self.pool_sizes) - 1}]"
            )
        self.scaling_feature_idx = scaling_feature_idx
        if feature_to_batch_size_map is None:
            feature_to_batch_size_map = {
                i: 1 for i in range(self.pool_sizes[scaling_feature_idx])
            }
        self.feature_to_batch_size_map = feature_to_batch_size_map
        self.len_dataset = len(dataset)
        self.total_size = self.len_dataset
        self.world_size = world_size
        self.rank = rank
        self.epoch = None
        self.drop_last = drop_last

    def _batch_size_for(self, feat: int) -> int:
        if callable(self.feature_to_batch_size_map):
            return max(1, self.feature_to_batch_size_map(feat))
        return max(1, self.feature_to_batch_size_map[feat])

    def __len__(self):
        if callable(self.feature_to_batch_size_map):
            sizes = [self._batch_size_for(i)
                     for i in range(self.pool_sizes[self.scaling_feature_idx])]
            max_bs = max(sizes)
        else:
            max_bs = max(self.feature_to_batch_size_map.values())
        total = self.total_size // max(1, max_bs)
        if not self.drop_last and self.total_size % max_bs:
            total += 1
        return total // self.world_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.epoch is None:
            assert self.world_size == 1 and self.rank == 0, (
                "call set_epoch(epoch) in distributed mode"
            )
            seed = int(np.random.randint(2**31))
        else:
            seed = self.epoch + 788
        rng = np.random.default_rng(seed=seed)

        sample_idxs = rng.permutation(self.len_dataset)
        pos = 0
        batch_i = 0
        while pos < self.len_dataset:
            feats = [int(rng.integers(p)) for p in self.pool_sizes]
            bs = self._batch_size_for(feats[self.scaling_feature_idx])
            chunk = sample_idxs[pos : pos + bs]
            pos += bs
            if len(chunk) < bs and self.drop_last:
                break
            batch = [tuple([int(s)] + feats) for s in chunk]
            if batch_i % self.world_size == self.rank:
                yield batch
            batch_i += 1


def round_by(total: int, multiple: int, up: bool = False) -> int:
    if up:
        total = total + multiple - 1
    return (total // multiple) * multiple
