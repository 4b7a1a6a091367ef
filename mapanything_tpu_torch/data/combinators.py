"""Dataset combinators (+, *, @); counterpart of
mapanything_tpu/data/combinators.py (the reference's
datasets/base/easy_dataset.py).

`ds1 + ds2` concatenates, `n * ds` repeats each element n times, `n @ ds`
resizes to n elements with random (epoch-reshuffled) assignment.
"""

from __future__ import annotations

import numpy as np


class EasyDataset:
    """Composable dataset base (reference easy_dataset.py:20)."""

    def __add__(self, other):
        return CatDataset([self, other])

    def __rmul__(self, factor):
        return MulDataset(factor, self)

    def __rmatmul__(self, factor):
        return ResizedDataset(factor, self)

    def set_epoch(self, epoch):
        pass

    def make_sampler(self, batch_size=None, shuffle=True, world_size=1,
                     rank=0, drop_last=True, max_num_of_images_per_gpu=None,
                     use_dynamic_sampler=True):
        """Build the matching sampler (reference easy_dataset.py:78-169)."""
        from .samplers import (
            BatchedMultiFeatureRandomSampler,
            DynamicBatchedMultiFeatureRandomSampler,
        )

        if not shuffle:
            raise NotImplementedError("only shuffled sampling is supported")
        num_views = getattr(self, "num_views", None)
        num_ar = len(getattr(self, "_resolutions", [None]))
        if use_dynamic_sampler:
            if max_num_of_images_per_gpu is None:
                raise ValueError(
                    "max_num_of_images_per_gpu is required for the dynamic sampler"
                )
            if isinstance(num_views, int):
                # the batch size is the same in every aspect-ratio bucket.
                # (The JAX package maps bucket 0 alone, so there a batch
                # drawn in another bucket raises KeyError.)
                pools = [num_ar]
                feature_map = dict.fromkeys(
                    range(num_ar),
                    max(1, max_num_of_images_per_gpu // num_views))
                scaling_idx = 0
            else:
                # variable views: pool over (aspect ratio, num_views choices);
                # batch size = max_imgs // sampled num_views
                views_list = list(num_views)
                pools = [num_ar, len(views_list)]
                feature_map = {
                    i: max(1, max_num_of_images_per_gpu // v)
                    for i, v in enumerate(views_list)
                }
                scaling_idx = 1
            return DynamicBatchedMultiFeatureRandomSampler(
                self, pool_sizes=pools, scaling_feature_idx=scaling_idx,
                feature_to_batch_size_map=feature_map, world_size=world_size,
                rank=rank, drop_last=drop_last,
            )
        if batch_size is None:
            raise ValueError("batch_size is required for the static sampler")
        pools = [num_ar]
        if not isinstance(num_views, int):
            pools.append(len(list(num_views)))
        return BatchedMultiFeatureRandomSampler(
            self, batch_size=batch_size, pool_sizes=pools,
            world_size=world_size, rank=rank, drop_last=drop_last,
        )


class MulDataset(EasyDataset):
    """Artificially duplicate each element `multiplicator` times
    (reference easy_dataset.py:172)."""

    def __init__(self, multiplicator: int, dataset):
        assert isinstance(multiplicator, int) and multiplicator > 0
        self.multiplicator = multiplicator
        self.dataset = dataset

    def __len__(self):
        return self.multiplicator * len(self.dataset)

    def __repr__(self):
        return f"{self.multiplicator}*{self.dataset!r}"

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx = (idx[0] // self.multiplicator,) + idx[1:]
            return self.dataset[idx]
        return self.dataset[idx // self.multiplicator]

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)

    def __getattr__(self, name):
        return getattr(self.dataset, name)


class ResizedDataset(EasyDataset):
    """Set dataset size to `new_size` with epoch-reshuffled random mapping
    (reference easy_dataset.py:229)."""

    def __init__(self, new_size: int, dataset):
        assert isinstance(new_size, int) and new_size > 0
        self.new_size = new_size
        self.dataset = dataset
        self._idxs = None

    def __len__(self):
        return self.new_size

    def __repr__(self):
        size_str = "_".join(
            f"{self.new_size // 10 ** i % 10}" for i in range(
                len(str(self.new_size)) - 1, -1, -1)
        )
        return f"{size_str} @ {self.dataset!r}"

    def set_epoch(self, epoch):
        rng = np.random.default_rng(seed=epoch + 777)
        n_repeats = (self.new_size + len(self.dataset) - 1) // len(self.dataset)
        idxs = np.arange(len(self.dataset))
        perm = np.concatenate(
            [rng.permutation(idxs) for _ in range(n_repeats)]
        )
        self._idxs = perm[: self.new_size]
        self.dataset.set_epoch(epoch)

    def __getitem__(self, idx):
        assert self._idxs is not None, (
            "call set_epoch(epoch) before indexing a ResizedDataset"
        )
        if isinstance(idx, tuple):
            return self.dataset[(self._idxs[idx[0]],) + idx[1:]]
        return self.dataset[self._idxs[idx]]

    def __getattr__(self, name):
        return getattr(self.dataset, name)


class CatDataset(EasyDataset):
    """Concatenation of datasets (reference easy_dataset.py:297)."""

    def __init__(self, datasets):
        flat = []
        for ds in datasets:
            flat += ds.datasets if isinstance(ds, CatDataset) else [ds]
        for name in ("num_views", "_resolutions"):
            values = [getattr(d, name, None) for d in flat]
            if any(v != values[0] for v in values[1:]):
                # the sampler reads these of the first term alone and draws
                # one bucket and view count a batch for the whole mix
                raise ValueError(
                    f"the terms of a dataset mix differ in {name}: {values}")
        self.datasets = flat
        self._cum = np.cumsum([len(d) for d in flat])

    def __len__(self):
        return int(self._cum[-1])

    def __repr__(self):
        return " + ".join(repr(d) for d in self.datasets)

    def set_epoch(self, epoch):
        for d in self.datasets:
            d.set_epoch(epoch)
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __getitem__(self, idx):
        other = None
        if isinstance(idx, tuple):
            idx, *other = idx
        ds_idx = int(np.searchsorted(self._cum, idx, side="right"))
        local = idx - (0 if ds_idx == 0 else int(self._cum[ds_idx - 1]))
        ds = self.datasets[ds_idx]
        if other:
            return ds[(local, *other)]
        return ds[local]

    def __getattr__(self, name):
        # delegate shared attributes (num_views, _resolutions, ...) to the
        # first constituent; __init__ holds the terms equal in these
        return getattr(self.datasets[0], name)
