"""Copy of pcfm/data/loader.py (framework-free; the port keeps its own).

Host-side batch loader.

Replaces the reference's torch DataLoader + DistributedSampler
(train.py:188-199) with a numpy batcher:
  * epoch-seeded global shuffle, then a per-process contiguous shard
    (rank r of world w takes slice r::w) — the DistributedSampler contract
    (shuffle, drop_last, set_epoch) without torch;
  * per-item numpy RNG derived from (seed, epoch, index) — the analogue of
    ``worker_init_fn=init_np_seed`` (datasets.py:13-15), but deterministic
    and independent of worker scheduling;
  * a background thread pool prefetches and collates the next batches so
    host IO overlaps device compute (the role DataLoader workers play).

All batches are fixed-shape (the per-item K-point subsample guarantees it),
so every step sees the same tensor shapes.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

_COLLATE_KEYS = ("train_points", "test_points", "train_rgb", "test_rgb",
                 "cond", "mean", "std", "center", "scale")


def collate(items) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k in _COLLATE_KEYS:
        present = sum(1 for it in items if k in it)
        if present and present != len(items):
            # shards disagreeing on optional fields would otherwise
            # either KeyError mid-stack or silently drop the field for
            # the whole batch depending on items[0] (review)
            raise ValueError(
                f"collate: key '{k}' present in only {present}/"
                f"{len(items)} batch items — shards disagree on optional "
                "fields (rgb/motors); re-pack the dataset uniformly")
        if present:
            out[k] = np.stack([it[k] for it in items], axis=0)
    out["idx"] = np.asarray([it["idx"] for it in items], np.int64)
    if "anno_id" in items[0]:
        out["anno_id"] = [it["anno_id"] for it in items]
    return out


def load_item(ds, seed: int, epoch: int, idx: int):
    """One item of an epoch: ``ds.get`` with a numpy RNG derived from
    (seed, epoch, index), so it does not depend on which worker loads it."""
    rng = np.random.RandomState(
        (seed * 1000003 + epoch * 10007 + idx * 31 + 7) % (2**31))
    return ds.get(int(idx), rng)


class DataLoader:
    """Iterable over epoch batches; call ``epoch_batches(ep)`` per epoch
    (the set_epoch analogue)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 num_workers: int = 4, rank: int = 0, world_size: int = 1,
                 prefetch: int = 4):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.seed = int(seed)
        self.num_workers = max(0, int(num_workers))
        self.rank = int(rank)
        self.world_size = max(1, int(world_size))
        self.prefetch = max(1, int(prefetch))

    def __len__(self):
        # ceil-shard like _epoch_indices (DistributedSampler pads every
        # rank to the same length) so len(loader) == batches actually
        # yielded — loop.py derives total_steps for the cosine schedule
        # from this (review: floor-sharding understated it on ragged
        # world sizes, letting cosine_lr run past t=1)
        n = -(-len(self.ds) // self.world_size)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.ds)
        if self.shuffle:
            order = np.random.RandomState(
                self.seed * 100003 + epoch).permutation(n)
        else:
            order = np.arange(n)
        if self.world_size > 1:
            # pad to a multiple of world_size (DistributedSampler semantics)
            pad = (-len(order)) % self.world_size
            if pad:
                order = np.concatenate([order, order[:pad]])
            order = order[self.rank::self.world_size]
        return order

    def _load_one(self, epoch: int, idx: int):
        return load_item(self.ds, self.seed, epoch, idx)

    def _epoch_chunks(self, epoch: int) -> list:
        """The epoch's batches as index arrays, in order (the last one
        partial when not ``drop_last``)."""
        order = self._epoch_indices(epoch)
        nb = len(order) // self.batch_size if self.drop_last \
            else -(-len(order) // self.batch_size)
        return [order[b * self.batch_size:(b + 1) * self.batch_size]
                for b in range(nb)]

    def epoch_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        chunks = self._epoch_chunks(epoch)
        if not chunks:
            return
        if self.num_workers == 0:
            for chunk in chunks:
                yield collate([self._load_one(epoch, i) for i in chunk])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Enqueue, re-checking stop so an abandoned generator never
            leaves the producer parked on a full queue (thread/executor
            leak — review)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for chunk in chunks:
                        if stop.is_set():
                            return
                        items = list(ex.map(
                            lambda i: self._load_one(epoch, i), chunk))
                        if not _put(collate(items)):
                            return
            except BaseException as e:      # forward to the consumer —
                _put(e)                     # otherwise a data error is a
                return                      # silent permanent q.get() hang
            _put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # drain so a producer blocked in _put wakes and exits
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def get_data_loaders(cfg, tr_dataset=None, te_dataset=None,
                     rank: int = 0, world_size: int = 1) -> Dict:
    """Loader-factory parity with the reference ``get_data_loaders``
    (datasets.py:719-742): train (shuffled), train_unshuffle, test."""
    if tr_dataset is None or te_dataset is None:
        from pcfm_torch.data.h5_dataset import get_datasets
        tr_dataset, te_dataset = get_datasets(cfg)
    common = dict(seed=cfg.seed, num_workers=cfg.num_workers, rank=rank,
                  world_size=world_size)
    return {
        "train_loader": DataLoader(tr_dataset, cfg.batch_size, shuffle=True,
                                   drop_last=True, **common),
        "train_unshuffle_loader": DataLoader(tr_dataset, cfg.batch_size,
                                             shuffle=False, drop_last=True,
                                             **common),
        "test_loader": DataLoader(te_dataset, cfg.batch_size, shuffle=False,
                                  drop_last=False, **common),
    }


def to_model_batch(batch: Dict[str, np.ndarray], train: bool = True,
                   has_rgb: bool = False,
                   cond_dim: int = 0) -> Dict[str, np.ndarray]:
    """Map loader keys to the train-step batch contract
    ({'pts','rgb','cond'})."""
    prefix = "train" if train else "test"
    out = {"pts": batch[f"{prefix}_points"].astype(np.float32)}
    if has_rgb and f"{prefix}_rgb" in batch:
        out["rgb"] = batch[f"{prefix}_rgb"].astype(np.float32)
    if cond_dim > 0 and "cond" in batch:
        out["cond"] = batch["cond"].astype(np.float32)
    return out
