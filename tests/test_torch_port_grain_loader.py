"""The port's worker-process loader (pcfm_torch/data/grain_loader.py,
``--loader_backend grain``) against the port's and the JAX package's thread
loaders: the same batches bit for bit, on the synthetic set and on H5
shards, at world size 1 and 3, with and without ``drop_last``; the contract
properties of tests/test_grain_loader.py; a worker's exception; the
shared-memory slots' guards; and a tiny CPU training run whose losses
equal the thread backend's.  Two workers a loader, forked from one fork
server that starts once."""
import json
import multiprocessing as mp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcfm.data.h5_dataset import PartNetH5Dataset as JaxPartNet  # noqa: E402
from pcfm.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from pcfm.data.synthetic import SyntheticDataset as JaxSynthetic  # noqa: E402
from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.data.grain_loader import ProcessLoader, make_loader  # noqa: E402
from pcfm_torch.data.h5_dataset import (PartNetH5Dataset,  # noqa: E402
                                        SubsetDataset)
from pcfm_torch.data.loader import DataLoader, collate  # noqa: E402
from pcfm_torch.data.synthetic import (SyntheticDataset,  # noqa: E402
                                       write_synthetic_shards)

WORKERS = 2
SYN = dict(size=12, n_points=64, tr_sample_size=32, te_sample_size=24,
           with_rgb=True, with_cond=True, seed=0)


def _equal(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], list):
                assert x[k] == y[k], k
            else:
                assert x[k].dtype == y[k].dtype, k
                assert np.array_equal(x[k], y[k]), k


def _epochs(loader, epochs=(0, 1, 2)) -> list:
    return [list(loader.epoch_batches(ep)) for ep in epochs]


# (batch, drop_last, world_size, ranks)
CASES = [(4, True, 1, (0,)), (5, False, 1, (0,)), (5, True, 1, (0,)),
         (2, True, 3, (0, 1, 2)), (3, False, 3, (1,))]


@pytest.mark.parametrize("batch,drop_last,world,ranks", CASES)
def test_synthetic_batches_equal_the_thread_loaders(batch, drop_last,
                                                    world, ranks):
    ds, jds = SyntheticDataset(**SYN), JaxSynthetic(**SYN)
    seen = []
    for rank in ranks:
        kw = dict(shuffle=True, drop_last=drop_last, seed=3, rank=rank,
                  world_size=world)
        proc = ProcessLoader(ds, batch, num_workers=WORKERS, **kw)
        try:
            got = _epochs(proc)
        finally:
            proc.close()
        _equal(sum(got, []),
               sum(_epochs(DataLoader(ds, batch, num_workers=2, **kw)), []))
        _equal(sum(got, []),
               sum(_epochs(JaxDataLoader(jds, batch, num_workers=0, **kw)),
                   []))
        for ep in got:
            # keys and shapes; one pass a call; len() batches
            assert len(ep) == len(proc)
            b = ep[0]
            assert b["train_points"].shape == (batch, 32, 3)
            assert b["train_rgb"].shape == (batch, 32, 3)
            assert b["test_points"].shape == (batch, 24, 3)
            assert b["cond"].shape == (batch, 1)
            idx = np.concatenate([x["idx"] for x in ep])
            shard = -(-SYN["size"] // world)
            if drop_last:
                assert len(idx) == shard // batch * batch
            else:                        # the partial tail batch
                assert [len(x["idx"]) for x in ep][-1] == \
                    shard - (len(ep) - 1) * batch
            if world == 1:
                # one epoch draws each record at most once, in an order of
                # its own
                assert len(np.unique(idx)) == len(idx)
        seen.append(got)
    if world > 1 and len(ranks) == world and drop_last:
        # the ranks' shards of an epoch are disjoint but for the padding
        per_rank = [set(np.concatenate([x["idx"] for x in s[0]]))
                    for s in seen]
        assert sum(map(len, per_rank)) <= SYN["size"] + world
        assert len(set.union(*per_rank)) >= sum(map(len, per_rank)) - world


def test_h5_batches_equal_the_jax_thread_loader(tmp_path):
    pytest.importorskip("h5py")
    write_synthetic_shards(str(tmp_path), per_split=10, n_points=96,
                           n_shards=3)
    kw = dict(split="train", tr_sample_size=40, te_sample_size=48,
              expand_stats=True)
    ds, jds = PartNetH5Dataset(str(tmp_path), **kw), \
        JaxPartNet(str(tmp_path), **kw)
    ds.get(0, np.random.RandomState(0))    # a live handle in this process
    lk = dict(shuffle=True, drop_last=False, seed=5, rank=1, world_size=3)
    proc = ProcessLoader(ds, 3, num_workers=WORKERS, **lk)
    try:
        got = _epochs(proc, (0, 1))
    finally:
        proc.close()
    want = _epochs(JaxDataLoader(jds, 3, num_workers=2, **lk), (0, 1))
    _equal(sum(got, []), sum(want, []))
    assert "anno_id" in got[0][0] and "train_rgb" in got[0][0]


def test_worker_error_reaches_the_consumer():
    ds = SubsetDataset(SyntheticDataset(**SYN), [0, 1, 2, 3, 99, 5])
    proc = ProcessLoader(ds, 2, shuffle=False, num_workers=WORKERS)
    try:
        with pytest.raises(IndexError, match="out of range"):
            list(proc.epoch_batches(0))
    finally:
        proc.close()


def test_abandoned_pass_and_close_leave_no_process():
    ds = SyntheticDataset(**SYN)
    proc = ProcessLoader(ds, 4, num_workers=WORKERS, seed=1)
    first = proc.epoch_batches(0)
    next(first)
    assert len(mp.active_children()) >= WORKERS
    whole = list(proc.epoch_batches(1))      # a new pass ends the first
    _equal(whole, list(DataLoader(ds, 4, num_workers=0,
                                  seed=1).epoch_batches(1)))
    with pytest.raises(RuntimeError, match="another epoch_batches pass"):
        next(first)
    proc.close()
    assert mp.active_children() == []
    # dropping a loader mid-pass stops its workers too
    proc = ProcessLoader(ds, 4, num_workers=WORKERS)
    gen = proc.epoch_batches(0)
    next(gen)
    del gen, proc
    assert mp.active_children() == []


def test_slot_guards(monkeypatch):
    """A batch larger than its slot bypasses it and arrives whole, equal to
    ``collate(items)``; a batch that fits goes through its slot; the
    consumer refuses a slot whose header holds another batch."""
    from types import SimpleNamespace

    from pcfm_torch.data import grain_loader as gl
    ds = SyntheticDataset(**SYN)
    proc = ProcessLoader(ds, 4, num_workers=1)
    proc._slots = [torch.zeros(64 + 4096, dtype=torch.uint8)]
    monkeypatch.setattr(gl, "get_worker_info", lambda: SimpleNamespace(
        dataset=SimpleNamespace(slots=proc._slots)))
    items = [dict(gl.load_item(ds, 0, 0, i), _slot=(0, 7)) for i in range(4)]
    big = gl._collate_into_slot(items)
    assert big[:3] == (0, 7, None)
    _equal([proc._copy_out(big)], [collate(items)])
    assert not proc._slots[0].any()            # the slot was not written
    small = [dict(it, train_points=it["train_points"][:2],
                  test_points=it["test_points"][:2],
                  train_rgb=it["train_rgb"][:2],
                  test_rgb=it["test_rgb"][:2]) for it in items]
    shared = gl._collate_into_slot(small)
    assert shared[:2] == (0, 7)
    _equal([proc._copy_out(shared)], [collate(small)])
    with pytest.raises(RuntimeError, match="holds batch 7, not 8"):
        proc._copy_out((0, 8) + shared[2:])


class _CondFromEight(SyntheticDataset):
    """Items 8-15 add a ``cond`` array that items 0-7 lack: the first batch
    sizes the slots, the second does not fit them."""

    def get(self, idx, rng):
        item = super().get(idx, rng)
        if idx >= 8:
            item["cond"] = np.asarray([self.thetas[idx]], np.float32)
        return item


def test_oversized_batch_equals_the_thread_loaders():
    ds = _CondFromEight(**dict(SYN, size=16, with_cond=False))
    kw = dict(shuffle=False, drop_last=True, seed=0)
    want = list(DataLoader(ds, 8, num_workers=0, **kw).epoch_batches(0))
    assert "cond" not in want[0] and "cond" in want[1]
    proc = ProcessLoader(ds, 8, num_workers=WORKERS, **kw)
    got = [list(proc.epoch_batches(ep)) for ep in (0, 0)]
    proc.close()
    assert mp.active_children() == []
    for batches in got:
        _equal(batches, want)


def test_make_loader():
    ds = SyntheticDataset(**SYN)
    assert type(make_loader("thread", ds, 4, num_workers=0)) is DataLoader
    proc = make_loader("grain", ds, 4, num_workers=0)
    assert isinstance(proc, ProcessLoader)
    _equal(list(proc.epoch_batches(2)),
           list(DataLoader(ds, 4, num_workers=0).epoch_batches(2)))
    with pytest.raises(ValueError, match="loader_backend"):
        make_loader("tf.data", ds, 4)


def _losses(tmp_path, backend: str) -> list:
    from pcfm_torch.train.loop import train
    cfg = Config(dataset_type="synthetic", pf_backbone="mlp", latent_dim=16,
                 enc_width=16, enc_depth=4, pf_width=32, pf_depth=3,
                 pf_emb_dim=16, lf_width=32, lf_depth=3, lf_emb_dim=16,
                 warmup_steps=0, amp=False, epochs=2, save_every=2,
                 batch_size=16, tr_max_sample_points=32,
                 te_max_sample_points=32, num_workers=WORKERS,
                 out_dir=str(tmp_path / backend), vis_count=1,
                 geom_warmup_epochs=0, sample_steps=2,
                 loader_backend=backend)
    out = train(cfg, verbose=False, device="cpu")
    assert out["epochs_run"] == 2 and np.isfinite(out["loss"])
    with open(tmp_path / backend / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("sec",
                                                      "points_per_sec")}
            for r in rows]


def test_training_losses_equal_the_thread_backend(tmp_path):
    torch.manual_seed(0)
    grain = _losses(tmp_path, "grain")
    assert mp.active_children() == []        # the loop's loader is gone
    assert grain == _losses(tmp_path, "thread") and len(grain) == 2
