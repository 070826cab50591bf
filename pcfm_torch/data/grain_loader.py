"""Worker-process loader backend, selected with ``--loader_backend grain``:
the port's counterpart of pcfm/data/grain_loader.py.

It does not use the ``grain`` library (the card's machine does not have
it): PyTorch's idiom for loading in other processes is
``torch.utils.data.DataLoader`` with worker processes, and ``ProcessLoader``
is that, behind the thread loader's contract (``pcfm_torch.data.loader``):
``epoch_batches(ep)`` yields ``collate``d numpy dicts, ``len``, ``rank`` /
``world_size`` sharding, ``drop_last`` with a partial tail.  Why processes:
h5py holds the interpreter lock while it decompresses and numpy's
permutations hold it too, so threads overlap little of an item's work, and
the lock is the one the train step's launch thread needs.

Order: the thread loader's, not grain's.  For the same seed, epoch, rank
and world size the backend yields the thread loader's batches bit for bit:
its epoch permutation and pad-sharding (``DataLoader._epoch_chunks``) and
its per-item seeds (``load_item``).  The JAX backend instead takes grain's
own per-epoch reshuffle and floor-sharding; the port deliberately does not,
as no library here reproduces them.

Workers are forked from a fork server that this process starts fresh
(this process may hold CUDA and open h5py handles;
``_H5ShardDataset.__getstate__`` drops the handles, so each worker opens
its own) and persist across epochs: the batch sampler, in this process,
hands them ``(epoch, index)`` keys.  A worker writes each batch into a slot
of shared memory mapped once on both sides; this process copies it out.
A batch larger than its slot (the slots are sized from item 0, and a
dataset's items may differ: an optional key on some of them) goes back
whole through torch's own transfer, in the same order.
A worker's exception is raised to the consumer; ``num_workers = 0`` loads
in this process, as JAX's ``worker_count=0`` does.
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Dict, Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader as TorchDataLoader
from torch.utils.data import Dataset, Sampler, get_worker_info

from pcfm_torch.data.loader import DataLoader, collate, load_item

# imported once by the worker processes' fork server
_WORKER_MODULES = ("pcfm_torch.data.grain_loader",
                   "pcfm_torch.data.h5_dataset", "pcfm_torch.data.synthetic")
_HEADER = 64                # a slot's header: the batch's sequence number


class _EpochItems(Dataset):
    """Map-style view of a dataset keyed by ``(epoch, index, slot, seq)``:
    the item the thread loader loads for ``(epoch, index)``, tagged with
    the slot its batch goes to.  Pickled to every worker at its start, with
    the slots, so it holds only the dataset, the seed and the slots."""

    def __init__(self, ds, seed: int, slots: list):
        self.ds, self.seed, self.slots = ds, seed, slots

    def __getitem__(self, key):
        epoch, idx, slot, seq = key
        return dict(load_item(self.ds, self.seed, epoch, idx),
                    _slot=(slot, seq))


class _EpochBatches(Sampler):
    """Batch sampler over ``order``'s batches of ``epoch``, which the
    caller sets before each pass; read when a pass begins.  The j-th batch
    of a pass goes to slot j % ``slots`` and carries the pass's sequence
    number ``seq0 + j``.  ``order`` is a thread loader of its own, so that
    no cycle keeps the workers alive."""

    def __init__(self, order: DataLoader, slots: int):
        self.order, self.slots, self.epoch, self.seq0 = order, slots, 0, 0

    def __iter__(self):
        ep, seq0, k = self.epoch, self.seq0, self.slots
        return iter([[(ep, int(i), j % k, seq0 + j) for i in chunk]
                     for j, chunk in enumerate(self.order._epoch_chunks(ep))])

    def __len__(self) -> int:
        return len(self.order)


def _worker_context():
    """``forkserver``: a server process, started fresh (no CUDA, no open
    files of this one) with torch and the datasets imported, forks each
    worker.  Spawned workers would each import torch while this process
    waits to hand them the dataset, one after another."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(_WORKER_MODULES))
    return ctx


def _layout(batch: Dict) -> tuple:
    """[(key, dtype, shape, offset)] of a batch's arrays in a slot, each at
    a multiple of 64 bytes after the slot's 64-byte header; the bytes the
    slot needs."""
    layout, size = [], _HEADER
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            layout.append((k, v.dtype.str, v.shape, size))
            size += -(-v.nbytes // 64) * 64
    return layout, size


def _collate_into_slot(items) -> tuple:
    """``collate`` in a worker, written into the batch's slot of shared
    memory: the header set to -1, the arrays, then the header to the
    batch's sequence number.  Returns (slot, seq, layout, the keys that
    are not arrays); for a batch larger than its slot, (slot, seq, None,
    the whole batch), which torch's transfer carries and the slot never
    sees."""
    slot, seq = items[0]["_slot"]
    batch = collate(items)
    layout, size = _layout(batch)
    raw = get_worker_info().dataset.slots[slot].numpy()
    if size > raw.nbytes:
        return slot, seq, None, batch
    header = raw[:_HEADER].view(np.int64)
    header[0] = -1
    for k, _, _, at in layout:
        v = np.ascontiguousarray(batch[k])
        raw[at:at + v.nbytes] = v.reshape(-1).view(np.uint8)
    header[0] = seq
    return slot, seq, layout, {k: v for k, v in batch.items()
                               if not isinstance(v, np.ndarray)}


class ProcessLoader(DataLoader):
    """The thread loader's batches, loaded in ``num_workers`` worker
    processes (in this process when 0).  Each batch in flight has a slot
    of shared memory that both sides map once (a new block a batch costs
    page faults on both sides), which this process copies out of before
    it yields the batch; there are more slots than the batches torch keeps
    in flight, so a worker never writes a slot that is being read, and a
    sequence number in the slot's header checks it.  One pass at a time:
    starting ``epoch_batches`` again ends the pass before it.  ``close``
    stops the workers (as does dropping the loader)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 num_workers: int = 0, rank: int = 0, world_size: int = 1,
                 prefetch: int = 4):
        super().__init__(dataset, batch_size, shuffle=shuffle,
                         drop_last=drop_last, seed=seed,
                         num_workers=num_workers, rank=rank,
                         world_size=world_size, prefetch=prefetch)
        # torch keeps in_flight batches a worker in flight, handing them
        # out in turn: (in_flight + 1) slots a worker leave one free, and
        # batch j's slot j % slots is one of its worker's own, so that a
        # worker maps and faults in only those
        self._in_flight = max(2, -(-self.prefetch // max(1, num_workers)))
        self._sampler = _EpochBatches(DataLoader(
            dataset, batch_size, shuffle=shuffle, drop_last=drop_last,
            seed=seed, num_workers=0, rank=rank, world_size=world_size),
            (self._in_flight + 1) * max(1, num_workers))
        self._workers = None
        self._slots = None
        self._pass = None

    def _torch_loader(self) -> TorchDataLoader:
        if self._workers is None:
            # a slot holds a whole batch: its size from one batch of the
            # first item (the datasets' items have fixed shapes; a larger
            # batch bypasses its slot, _collate_into_slot)
            _, size = _layout(collate(
                [load_item(self.ds, self.seed, 0, 0)] * self.batch_size))
            self._slots = [torch.zeros(size, dtype=torch.uint8)
                           .share_memory_()
                           for _ in range(self._sampler.slots)]
            self._workers = TorchDataLoader(
                _EpochItems(self.ds, self.seed, self._slots),
                batch_sampler=self._sampler, collate_fn=_collate_into_slot,
                num_workers=self.num_workers, persistent_workers=True,
                prefetch_factor=self._in_flight,
                multiprocessing_context=_worker_context())
        return self._workers

    def _copy_out(self, shared: tuple) -> Dict:
        """The batch in its slot, copied out (the keys in ``collate``'s
        order); raises if the slot's header shows another batch.  A batch
        that came whole (``layout`` None) is the batch."""
        slot, seq, layout, rest = shared
        if layout is None:
            return rest
        raw = self._slots[slot].numpy()
        header = raw[:_HEADER].view(np.int64)
        if header[0] != seq:
            raise RuntimeError(f"ProcessLoader: slot {slot} holds batch "
                               f"{header[0]}, not {seq}")
        out = {k: raw[at:at + np.dtype(dt).itemsize * int(np.prod(shape))]
               .view(dt).reshape(shape).copy()
               for k, dt, shape, at in layout}
        if header[0] != seq:
            raise RuntimeError(f"ProcessLoader: slot {slot} was written "
                               f"while batch {seq} was read from it")
        out.update(rest)
        return out

    def epoch_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers == 0:
            yield from super().epoch_batches(epoch)
            return
        workers = self._torch_loader()
        self._pass = token = object()
        self._sampler.epoch = epoch
        self._sampler.seq0 += len(self)
        it = iter(workers)
        while True:
            if self._pass is not token:
                raise RuntimeError("ProcessLoader: another epoch_batches "
                                   "pass began before this one ended")
            try:
                batch = next(it)
            except StopIteration:
                return
            yield self._copy_out(batch)

    def close(self) -> None:
        """Stop the worker processes (a later pass starts new ones)."""
        workers, self._workers = self._workers, None
        it = None if workers is None else workers._iterator
        if it is not None:
            it._shutdown_workers()


def make_loader(backend: str, *args, **kwargs):
    """Factory: 'thread' (``pcfm_torch.data.loader.DataLoader``) or 'grain'
    (``ProcessLoader``)."""
    if backend == "grain":
        return ProcessLoader(*args, **kwargs)
    if backend == "thread":
        return DataLoader(*args, **kwargs)
    raise ValueError(f"loader_backend {backend!r}: 'thread' or 'grain'")
