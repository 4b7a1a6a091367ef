"""Multi-threaded data loader and (B, V, ...) collation; counterpart of
mapanything_tpu/data/loader.py (the reference's datasets/__init__.py:29-177
DataLoader glue):

  * train: DynamicBatchedMultiFeatureRandomSampler yields whole batches of
    (scene, ar, nviews) tuples; worker threads materialize view lists; the
    collate stacks them into one numpy (B, V, ...) pytree matching the model
    input contract (plus the GT keys the loss consumes);
  * eval: fixed batch sampler with rank sharding (the DistributedSampler
    replacement);
  * data parallelism (`get_train_data_loader(data_shard=(d, n))`): every
    data rank draws the batches that one process would draw at n times the
    image budget (the JAX trainer's single-controller batch) and loads its
    own rows of each, so the ranks step in lockstep on batches of one
    shape. The samplers' round-robin rank split (world_size, rank) gives
    ranks batches of different shapes and, at an epoch's end, different
    counts, which a synchronous step cannot take.

Batches stay numpy: the trainer moves them to its device
(utils/device.py::to_device), and only its thread touches the card.
Threads (not processes) suffice because the heavy lifting is PIL, numpy and
the native host ops, which release the GIL; this also keeps mmap'd
covisibility matrices shared.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

_VIEW_KEYS = (
    "img",
    "ray_directions_cam",
    "depth_along_ray",
    "camera_pose_quats",
    "camera_pose_trans",
)
_GT_KEYS = (
    "pts3d",
    "pts3d_cam",
    "ray_directions_cam",
    "depth_along_ray",
    "camera_pose_quats",
    "camera_pose_trans",
    "valid_mask",
    "non_ambiguous_mask",
)


def collate_views(samples: List[List[dict]]) -> Dict[str, Dict[str, np.ndarray]]:
    """List (batch) of lists (views) of view dicts -> {"views", "gt"} pytree.

    Output arrays are (B, V, ...) numpy, as data/synthetic.py's batches hold
    them (the same keys, dtypes and shapes)."""
    def stack(key):
        return np.stack(
            [np.stack([np.asarray(v[key]) for v in views]) for views in samples]
        )

    views_out: Dict[str, np.ndarray] = {}
    gt_out: Dict[str, np.ndarray] = {}

    views_out["img"] = stack("img").astype(np.float32)
    for k in _VIEW_KEYS[1:]:
        if k in samples[0][0]:
            views_out[k] = stack(k).astype(np.float32)
    # per-sample flags
    ims = np.stack(
        [np.asarray([v["is_metric_scale"] for v in views]) for views in samples]
    )
    views_out["is_metric_scale"] = ims.astype(bool)

    for k in _GT_KEYS:
        if k in samples[0][0]:
            arr = stack(k)
            gt_out[k] = arr.astype(bool if "mask" in k else np.float32)
    gt_out["is_metric_scale"] = ims[:, 0].astype(bool)
    gt_out["is_synthetic"] = np.asarray(
        [views[0]["is_synthetic"] for views in samples], dtype=bool
    )
    return {"views": views_out, "gt": gt_out}


class RowShardSampler:
    """Rows [d k, (d + 1) k) of each batch of a batch sampler, k = len //
    n: data rank d's share; a batch's last len % n rows are dropped so
    that every rank holds k."""

    def __init__(self, sampler, rank: int, n: int):
        if not 0 <= rank < n:
            raise ValueError(f"data rank {rank} of {n}")
        self.sampler, self.rank, self.n = sampler, rank, n

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        for batch in self.sampler:
            k = len(batch) // self.n
            if k:
                yield list(batch[self.rank * k:(self.rank + 1) * k])


class DataLoader:
    """Iterates batches from (dataset, batch sampler) with worker threads."""

    def __init__(self, dataset, batch_sampler, num_workers: int = 4,
                 collate_fn=collate_views, prefetch: int = 2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(0, num_workers)
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        return len(self.batch_sampler)

    def _load_batch(self, batch_idxs) -> Dict:
        samples = [self.dataset[i] for i in batch_idxs]
        return self.collate_fn(samples)

    def __iter__(self) -> Iterator[Dict]:
        batches = iter(self.batch_sampler)
        if self.num_workers == 0:
            for b in batches:
                yield self._load_batch(b if isinstance(b, list) else [b])
            return

        # normalize: dynamic sampler yields lists; static yields tuples that
        # must be grouped by the caller-provided batch size
        def batch_lists():
            for b in batches:
                yield b if isinstance(b, list) else [b]

        # Both queues are BOUNDED and everything honors `cancelled`: an
        # abandoned iterator (e.g. `next(iter(loader))` to probe shapes)
        # must tear its threads down instead of loading the whole epoch
        # into memory for nobody and leaking workers for the process
        # lifetime.
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.num_workers)
        in_q: "queue.Queue" = queue.Queue(maxsize=2 * self.num_workers)
        stop = object()
        cancelled = threading.Event()

        def put_cancellable(q, item) -> bool:
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        # total batch count is only known after the sampler is exhausted;
        # the feeder publishes it here when done
        n_total = [None]

        def feeder():
            try:
                n = 0
                for b in batch_lists():
                    if not put_cancellable(in_q, (n, b)):
                        return
                    n += 1
                n_total[0] = n
                for _ in threads:
                    put_cancellable(in_q, stop)
            except Exception as e:  # sampler fault: surface, don't hang
                put_cancellable(out_q, (-1, e))

        def worker():
            while not cancelled.is_set():
                try:
                    item = in_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is stop:
                    put_cancellable(out_q, stop)
                    return
                seq, payload = item
                try:
                    res = (seq, self._load_batch(payload))
                except Exception as e:  # surface loader faults
                    res = (seq, e)
                if not put_cancellable(out_q, res):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        feed = threading.Thread(target=feeder, daemon=True)
        for t in threads:
            t.start()
        feed.start()

        try:
            # in-order delivery
            pending: Dict[int, Dict] = {}
            next_seq = 0
            finished_workers = 0
            while n_total[0] is None or next_seq < n_total[0]:
                item = out_q.get()
                if item is stop:
                    finished_workers += 1
                    if finished_workers == len(threads):
                        if n_total[0] is None or next_seq < n_total[0]:
                            raise RuntimeError(
                                "data loader workers exited early")
                        break
                    continue
                seq, payload = item
                if isinstance(payload, Exception):
                    raise payload
                pending[seq] = payload
                while next_seq in pending:
                    yield pending.pop(next_seq)
                    next_seq += 1
        finally:
            cancelled.set()
            for t in [feed, *threads]:
                t.join(timeout=2.0)


def get_train_data_loader(dataset, max_num_of_imgs_per_gpu: int,
                          world_size: int = 1, rank: int = 0,
                          num_workers: int = 4,
                          data_shard: Optional[tuple] = None) -> DataLoader:
    """Reference datasets/__init__.py:140 equivalent. With `data_shard`
    (d, n), data rank d's rows of the batches drawn at n times the image
    budget (RowShardSampler, the module docstring)."""
    n = 1 if data_shard is None else data_shard[1]
    sampler = dataset.make_sampler(
        shuffle=True, world_size=world_size, rank=rank,
        max_num_of_images_per_gpu=max_num_of_imgs_per_gpu * n,
        use_dynamic_sampler=True,
    )
    if data_shard is not None:
        sampler = RowShardSampler(sampler, *data_shard)
    return DataLoader(dataset, sampler, num_workers=num_workers)


def get_test_data_loader(dataset, batch_size: int, world_size: int = 1,
                         rank: int = 0, num_workers: int = 4) -> DataLoader:
    """Reference datasets/__init__.py:29 equivalent (fixed batch size)."""
    sampler = dataset.make_sampler(
        batch_size=batch_size, shuffle=True, world_size=world_size, rank=rank,
        use_dynamic_sampler=False,
    )

    class _GroupedSampler:
        def __init__(self, inner, bs):
            self.inner, self.bs = inner, bs

        def set_epoch(self, e):
            self.inner.set_epoch(e)

        def __len__(self):
            return len(self.inner) // self.bs

        def __iter__(self):
            group = []
            for idx in self.inner:
                group.append(idx)
                if len(group) == self.bs:
                    yield group
                    group = []

    return DataLoader(dataset, _GroupedSampler(sampler, batch_size),
                      num_workers=num_workers)
