"""Copy of pcfm/data/h5_dataset.py (framework-free; the port keeps its own).

H5 shard datasets — numpy re-implementation of the reference data layer
(`datasets.py`), torch-free and host-side.

* ``PartNetH5Dataset`` — port of ``PartNetH5PointClouds``
  (datasets.py:374-629): shard discovery, motors effective-dim scan with
  mode/max canonical-dim policy, outlier report JSON, RGB probe, per-item
  random point subsample with replacement-overflow, NaN->0 motors padded /
  truncated to cond_dim.
* ``TDCRH5Dataset`` — the evident intent of the reference's broken
  ``TDCRH5PointClouds`` (datasets.py:155-362 references unbound variables
  and is dead code as shipped; SURVEY.md §7 'Hard parts'): same shard
  mechanics, condition built by ``encode_motors``.
* ``subset_indices`` / ``SubsetDataset`` — train-fraction subsetting with a
  dedicated seed (datasets.py:49-67); the reference uses
  ``torch.randperm``, we use a seeded numpy permutation.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from pcfm_torch.data.condition import encode_motors, get_cond_dim


def _rgb_to_float01(arr: np.ndarray) -> np.ndarray:
    """uint8 / float RGB -> clipped float [0,1] (datasets.py:367-372)."""
    arr = arr.astype(np.float32)
    mx = float(np.max(arr)) if arr.size > 0 else 1.0
    if mx > 1.0:
        arr = arr / 255.0
    return np.clip(arr, 0.0, 1.0)


def sample_idx(rng: np.random.RandomState, n: int, k: int) -> np.ndarray:
    """Random subsample of k of n points; when k > n, all n points plus
    k-n resampled-with-replacement extras (datasets.py:557-563)."""
    if k <= 0:
        return np.empty((0,), dtype=np.int64)
    if k <= n:
        return rng.choice(n, k, replace=False)
    base = np.arange(n, dtype=np.int64)
    extra = rng.choice(n, k - n, replace=True)
    return np.concatenate([base, extra], axis=0)


def _discover(data_dir: str, split: str, patterns: Sequence[str],
              files=None) -> List[str]:
    if files is not None:
        if isinstance(files, (list, tuple)):
            return sorted(set(str(x) for x in files))
        if isinstance(files, str):
            return sorted(set(glob.glob(files)))
        raise TypeError("files must be None, list/tuple, or a glob string")
    # first NON-EMPTY pattern wins: the later patterns are broader
    # fallbacks (e.g. a flat data_dir/*.h5), and unioning them would let
    # the train and test splits silently share files (review —
    # train/test contamination with flat layouts or stray top-level .h5)
    for p in patterns:
        flist = glob.glob(p)
        if flist:
            return sorted(set(flist))
    return []


class _H5ShardDataset:
    """Common shard plumbing: lazy per-file handles, (file, row) index.

    Handles are opened under a lock: the DataLoader's thread pool calls
    ``get`` concurrently, and a bare check-then-set would leak duplicate
    h5py.File objects (reads themselves are safe — h5py serializes all
    HDF5 calls behind its global lock)."""

    def __init__(self):
        import threading
        self._handles: Dict[int, "h5py.File"] = {}
        self._open_lock = threading.Lock()

    def _ensure_open(self, fi: int):
        import h5py
        h = self._handles.get(fi)
        if h is None:
            with self._open_lock:
                h = self._handles.get(fi)
                if h is None:
                    h = h5py.File(self.files[fi], "r")
                    self._handles[fi] = h
        return h

    def close(self):
        for h in list(self._handles.values()):
            try:
                h.close()
            except Exception:
                pass
        self._handles.clear()

    # picklable across process boundaries (grain worker processes ship the
    # dataset inside the _LoadItem transform): drop the lock and any live
    # h5py handles; workers lazily reopen their own
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_handles"] = {}
        state.pop("_open_lock", None)
        return state

    def __setstate__(self, state):
        import threading
        self.__dict__.update(state)
        self._handles = {}
        self._open_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._index)

    def __del__(self):
        self.close()


class PartNetH5Dataset(_H5ShardDataset):
    """PartNet category H5 shards: keys data / data_norm / motors /
    (optional anno_id, center, scale, rgb)."""

    def __init__(self, data_dir: str, split: str = "train",
                 use_norm: bool = True, expand_stats: bool = False,
                 tr_sample_size: int = 2048, te_sample_size: int = 2048,
                 keep_annos: Optional[Set[str]] = None,
                 cond_dim_policy: str = "mode",
                 exclude_outliers: bool = False, report_file: str = "",
                 report_topk: int = 200, files=None, verbose: bool = True,
                 cond_dim_override: Optional[int] = None):
        super().__init__()
        import h5py
        self.split = str(split)
        self.use_norm = bool(use_norm)
        self.expand_stats = bool(expand_stats)
        self.tr_n = int(tr_sample_size)
        self.te_n = int(te_sample_size)
        self.data_dir = os.path.abspath(data_dir)
        self.keep_annos = set(keep_annos or [])
        self.cond_dim_policy = str(cond_dim_policy).lower()
        assert self.cond_dim_policy in {"mode", "max"}
        self.exclude_outliers = bool(exclude_outliers)
        self.report_file = str(report_file)
        self.report_topk = int(report_topk)

        self.files = _discover(data_dir, split, [
            os.path.join(self.data_dir, self.split, "shard-*.h5"),
            os.path.join(self.data_dir, self.split, "*.h5"),
            os.path.join(self.data_dir, self.split, "*.hdf5"),
        ], files)
        if not self.files:
            raise FileNotFoundError(
                f"partnet_h5: no shard-*.h5 files found in "
                f"{self.data_dir}/{self.split}")

        self._index = []
        self._key_points_map = {}
        self._has_motors = False
        self._has_rgb = False
        eff_dims, eff_meta = [], []
        dim_hist: Dict[int, int] = {}

        for fi, fp in enumerate(self.files):
            with h5py.File(fp, "r") as f:
                key = "data_norm" if (self.use_norm and "data_norm" in f) \
                    else "data"
                if key not in f:
                    raise KeyError(
                        f"partnet_h5 shard {fp} lacks dataset '{key}'")
                nrows = int(f[key].shape[0])
                self._key_points_map[fi] = key
                if "rgb" in f:
                    self._has_rgb = True
                annos = None
                if "anno_id" in f:
                    annos = [a.decode("utf-8", "ignore")
                             if isinstance(a, (bytes, np.bytes_)) else str(a)
                             for a in f["anno_id"][:]]
                if "motors" in f:
                    self._has_motors = True
                    motors = f["motors"][()]
                    if np.issubdtype(motors.dtype, np.floating):
                        isn = np.isnan(motors)
                        eff = ((~isn).sum(axis=1).astype(int)
                               if isn.ndim == 2
                               else np.array([int((~isn).sum())] * nrows))
                    else:
                        eff = np.array([motors.shape[1]] * nrows, dtype=int)
                    for i in range(nrows):
                        eff_dims.append(int(eff[i]))
                        eff_meta.append((fi, i,
                                         annos[i] if annos is not None
                                         else ""))
                        dim_hist[int(eff[i])] = dim_hist.get(int(eff[i]),
                                                             0) + 1
                if self.keep_annos and annos is not None:
                    self._index.extend((fi, i) for i in range(nrows)
                                       if annos[i] in self.keep_annos)
                else:
                    self._index.extend((fi, i) for i in range(nrows))

        # canonical joints dimension
        if self._has_motors and eff_dims:
            if self.cond_dim_policy == "mode":
                canon = max(dim_hist.items(), key=lambda kv: kv[1])[0]
            else:
                canon = max(eff_dims)
        else:
            canon = 0
        # a val/test split pads motors to the TRAIN split's canonical dim
        # (cond_dim_override) — its own mode can differ, and the model's
        # cond input width is fixed by the train scan (review)
        self.cond_dim = int(canon if cond_dim_override is None
                            else cond_dim_override)

        self.outliers = []
        if self._has_motors and eff_dims:
            for (fi, ri, aid), ei in zip(eff_meta, eff_dims):
                if ei != self.cond_dim:
                    self.outliers.append({"file": self.files[fi],
                                          "row": int(ri),
                                          "anno_id": str(aid),
                                          "eff_dim": int(ei)})
            if self.exclude_outliers:
                keep = {(fi, ri) for (fi, ri, _), ei in zip(eff_meta, eff_dims)
                        if ei == self.cond_dim}
                old_n = len(self._index)
                self._index = [x for x in self._index if x in keep]
                if verbose:
                    print(f"[partnet_h5/{self.split}] dropped outlier rows: "
                          f"{old_n} -> {len(self._index)} kept, "
                          f"{len(self.outliers)} outliers "
                          f"(canon_dim {self.cond_dim}, "
                          f"{self.cond_dim_policy} policy)")
            elif verbose:
                print(f"[partnet_h5/{self.split}] canonical cond dim "
                      f"{self.cond_dim} via {self.cond_dim_policy} policy; "
                      f"per-row dims {dict(sorted(dim_hist.items()))}; "
                      f"{len(self.outliers)} outliers")

        # dataset-level denormalization hints
        self.all_points_mean = np.zeros(3, dtype=np.float32)
        self.all_points_std = np.ones(3, dtype=np.float32)
        if not self.use_norm and self.files:
            try:
                with h5py.File(self.files[0], "r") as f0:
                    if "center" in f0 and "scale" in f0:
                        c0 = np.asarray(f0["center"][0], dtype=np.float32)
                        s0 = float(np.asarray(f0["scale"][0],
                                              dtype=np.float32))
                        self.all_points_mean = c0
                        self.all_points_std = np.array([s0] * 3, np.float32)
            except Exception:
                pass

        self.shuffle_idx = np.arange(len(self._index), dtype=np.int64)

        if self.report_file:
            try:
                os.makedirs(os.path.dirname(self.report_file) or ".",
                            exist_ok=True)
                rep = {"split": self.split, "canon_dim": self.cond_dim,
                       "policy": self.cond_dim_policy, "dim_hist": dim_hist,
                       "outliers_count": len(self.outliers),
                       "outliers_preview": self.outliers[
                           :min(self.report_topk, len(self.outliers))]}
                with open(self.report_file, "w", encoding="utf-8") as f:
                    json.dump(rep, f, ensure_ascii=False, indent=2)
                if verbose:
                    print(f"[partnet_h5/{self.split}] outlier report at "
                          f"{self.report_file}")
            except Exception as e:  # pragma: no cover
                print(f"[partnet_h5] could not write outlier report: {e}")

        self.has_rgb = bool(self._has_rgb)

    def get(self, idx: int, rng: np.random.RandomState) -> Dict:
        fi, ri = self._index[idx]
        f = self._ensure_open(fi)
        key = self._key_points_map[fi]
        pts = f[key][ri].astype(np.float32)
        n = pts.shape[0]
        tr_idx = sample_idx(rng, n, self.tr_n)
        te_idx = sample_idx(rng, n, self.te_n)
        item = {"idx": idx, "train_points": pts[tr_idx],
                "test_points": pts[te_idx],
                "mean": self.all_points_mean.reshape(1, 3),
                "std": self.all_points_std.reshape(1, 3)}
        if self.expand_stats and "center" in f and "scale" in f:
            item["center"] = f["center"][ri].astype(np.float32)
            item["scale"] = np.asarray([f["scale"][ri]], np.float32)
        if self._has_motors and "motors" in f and self.cond_dim > 0:
            m = np.nan_to_num(f["motors"][ri].astype(np.float32).reshape(-1),
                              nan=0.0)
            d = m.shape[0]
            if d < self.cond_dim:
                pad = np.zeros(self.cond_dim, np.float32)
                pad[:d] = m
                m = pad
            elif d > self.cond_dim:
                m = m[:self.cond_dim]
            item["cond"] = m.astype(np.float32)
        if self.has_rgb and "rgb" in f:
            rgb_all = f["rgb"][ri]
            item["train_rgb"] = _rgb_to_float01(rgb_all[tr_idx])
            item["test_rgb"] = _rgb_to_float01(rgb_all[te_idx])
        if "anno_id" in f:
            aid = f["anno_id"][ri]
            item["anno_id"] = (aid.decode("utf-8", "ignore")
                               if isinstance(aid, (bytes, np.bytes_))
                               else str(aid))
        return item


class TDCRH5Dataset(_H5ShardDataset):
    """TDCR continuum-robot shards: data / data_norm / motors / center /
    scale; condition via encode_motors."""

    def __init__(self, data_dir: str, split: str = "train",
                 use_norm: bool = True, expand_stats: bool = False,
                 tr_sample_size: int = 2048, te_sample_size: int = 2048,
                 cond_mode: str = "motors", motor_enc: str = "raw6+geom",
                 motor_mod2_offset_deg: float = 0.0,
                 motor_max_pos: float = 0.4,
                 motor_mod3_offset_deg: float = 0.0, files=None):
        super().__init__()
        import h5py
        self.split = str(split)
        self.use_norm = bool(use_norm)
        self.expand_stats = bool(expand_stats)
        self.tr_n = int(tr_sample_size)
        self.te_n = int(te_sample_size)
        self.cond_mode = str(cond_mode)
        self.motor_enc = str(motor_enc)
        self.motor_mod2_offset_deg = float(motor_mod2_offset_deg)
        self.motor_mod3_offset_deg = float(motor_mod3_offset_deg)
        self.motor_max_pos = float(motor_max_pos)
        self.data_dir = os.path.abspath(data_dir)

        self.files = _discover(data_dir, split, [
            os.path.join(self.data_dir, self.split, "*.h5"),
            os.path.join(self.data_dir, self.split, "*.hdf5"),
            os.path.join(self.data_dir, f"{self.split}*.h5"),
            os.path.join(self.data_dir, "*.h5"),
            os.path.join(self.data_dir, "*.hdf5"),
        ], files)
        if not self.files:
            raise FileNotFoundError(
                f"tdcr_h5: no shard-*.h5 files found in "
                f"{self.data_dir}/{self.split}")

        self._index = []
        self._key_points_map = {}
        self._has_motors = False
        for fi, fp in enumerate(self.files):
            with h5py.File(fp, "r") as f:
                key = "data_norm" if (self.use_norm and "data_norm" in f) \
                    else "data"
                if key not in f:
                    raise KeyError(f"tdcr_h5 shard {fp} lacks dataset '{key}'")
                nrows = int(f[key].shape[0])
                self._index.extend((fi, i) for i in range(nrows))
                self._key_points_map[fi] = key
                if "motors" in f:
                    self._has_motors = True

        self.cond_dim = (get_cond_dim(self.motor_enc)
                         if (self.cond_mode == "motors" and self._has_motors)
                         else 0)
        self.has_rgb = False

        self.all_points_mean = np.zeros(3, dtype=np.float32)
        self.all_points_std = np.ones(3, dtype=np.float32)
        if not self.use_norm:
            try:
                with h5py.File(self.files[0], "r") as f0:
                    if "center" in f0 and "scale" in f0:
                        self.all_points_mean = np.asarray(
                            f0["center"][0], dtype=np.float32)
                        s0 = float(np.asarray(f0["scale"][0], np.float32))
                        self.all_points_std = np.array([s0] * 3, np.float32)
            except Exception:
                pass
        self.shuffle_idx = np.arange(len(self._index), dtype=np.int64)

    def get(self, idx: int, rng: np.random.RandomState) -> Dict:
        fi, ri = self._index[idx]
        f = self._ensure_open(fi)
        key = self._key_points_map[fi]
        pts = f[key][ri].astype(np.float32)
        n = pts.shape[0]
        tr_idx = sample_idx(rng, n, self.tr_n)
        te_idx = sample_idx(rng, n, self.te_n)
        item = {"idx": idx, "train_points": pts[tr_idx],
                "test_points": pts[te_idx],
                "mean": self.all_points_mean.reshape(1, 3),
                "std": self.all_points_std.reshape(1, 3)}
        if self.expand_stats and "center" in f and "scale" in f:
            item["center"] = f["center"][ri].astype(np.float32)
            item["scale"] = np.asarray([f["scale"][ri]], np.float32)
        if self.cond_mode == "motors" and self._has_motors and "motors" in f:
            m = f["motors"][ri].astype(np.float32)
            item["cond"] = encode_motors(
                m, self.motor_enc,
                mod2_offset_deg=self.motor_mod2_offset_deg,
                max_pos=self.motor_max_pos,
                mod3_offset_deg=self.motor_mod3_offset_deg
            ).astype(np.float32)
        return item


class SubsetDataset:
    """Subset view forwarding attrs to the base (datasets.py:18-32)."""

    def __init__(self, base, indices):
        self.dataset = base
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self):
        return len(self.indices)

    def get(self, idx: int, rng: np.random.RandomState):
        return self.dataset.get(int(self.indices[idx]), rng)

    def __getattr__(self, name):
        base = object.__getattribute__(self, "dataset")
        while isinstance(base, SubsetDataset):
            base = object.__getattribute__(base, "dataset")
        return getattr(base, name)


def subset_indices(n: int, train_fraction: float = 1.0,
                   train_count: Optional[int] = None,
                   seed: int = 0) -> Optional[np.ndarray]:
    """Port of _pick_subset_indices (datasets.py:49-67)."""
    if train_count is None and not (0.0 < float(train_fraction) < 1.0):
        return None
    if n <= 1:
        return None
    if train_count is not None:
        n_keep = max(1, min(int(train_count), n))
    else:
        n_keep = max(1, min(int(np.ceil(n * float(train_fraction))), n))
    rng = np.random.RandomState(int(seed))
    idx = np.sort(rng.permutation(n)[:n_keep])
    print(f"[data] training subset: keeping {n_keep} of {n} rows "
          f"({n_keep / n:.2%}, subset seed {seed})")
    return idx.astype(np.int64)


def _parse_keep_annos(cfg) -> tuple:
    """Port of _parse_keep_annos (datasets.py:122-151)."""
    keep = set(getattr(cfg, "keep_anno", None) or [])
    path = getattr(cfg, "keep_anno_file", "") or ""
    if path and os.path.isfile(path):
        with open(path) as f:
            keep.update(ln.strip() for ln in f if ln.strip())
    splits = set(getattr(cfg, "keep_anno_splits", None) or ["train"])
    return (keep or None), splits


def get_datasets(cfg, eval_only: bool = False):
    """Factory (port of datasets.py:634-716): builds (train, val-or-test)
    datasets, applies the train subset, and writes ``cond_dim`` /
    ``has_rgb`` back onto cfg like the reference writes onto args.

    ``eval_only=True`` (the eval/sample CLIs on a restored run): skips the
    expensive train-split scan, pads the test split's condition to the
    RUN's recorded ``cfg.cond_dim``, and VERIFIES the data against the
    checkpoint's recorded dims instead of mutating cfg — the model's
    input widths are already fixed by the restored params (review: the
    post-restore cfg mutation could silently change the lazy
    enc_in_channels/pf_cond_dim properties under the built bundle)."""
    from pathlib import Path
    ds_type = cfg.dataset_type.lower()
    keep_ids, keep_splits = _parse_keep_annos(cfg)

    if ds_type == "tdcr_h5":
        common = dict(
            use_norm=cfg.tdcr_use_norm,
            tr_sample_size=cfg.tr_max_sample_points,
            te_sample_size=cfg.te_max_sample_points,
            cond_mode=cfg.cond_mode, motor_enc=cfg.motor_enc,
            motor_mod2_offset_deg=cfg.motor_mod2_offset_deg,
            motor_mod3_offset_deg=cfg.motor_mod3_offset_deg,
            motor_max_pos=cfg.motor_max_pos)
        # TDCR cond_dim is a pure function of cond_mode/motor_enc (no data
        # scan), so eval_only can skip the train split entirely
        tr = None if eval_only else TDCRH5Dataset(
            cfg.data_dir, split="train", **common)
        val_dir = Path(cfg.data_dir, "val")
        split = ("val" if val_dir.exists() and any(val_dir.glob("*.h5"))
                 else "test")
        te = TDCRH5Dataset(cfg.data_dir, split=split, **common)
    elif ds_type == "partnet_h5":
        tr = None if eval_only else PartNetH5Dataset(
            cfg.data_dir, split="train", use_norm=cfg.tdcr_use_norm,
            tr_sample_size=cfg.tr_max_sample_points,
            te_sample_size=cfg.te_max_sample_points,
            keep_annos=(keep_ids if "train" in keep_splits else None),
            cond_dim_policy=cfg.partnet_cond_policy,
            exclude_outliers=cfg.partnet_exclude_outliers,
            report_file=cfg.partnet_report_file_train)
        val_dir = Path(cfg.data_dir, "val")
        split = ("val" if val_dir.exists()
                 and any(val_dir.glob("shard-*.h5")) else "test")
        te = PartNetH5Dataset(
            cfg.data_dir, split=split, use_norm=cfg.tdcr_use_norm,
            tr_sample_size=cfg.tr_max_sample_points,
            te_sample_size=cfg.te_max_sample_points,
            keep_annos=(keep_ids if split in keep_splits else None),
            cond_dim_policy=cfg.partnet_cond_policy,
            exclude_outliers=False,
            report_file=cfg.partnet_report_file_eval,
            cond_dim_override=(cfg.cond_dim if eval_only
                               else tr.cond_dim))
    elif ds_type == "synthetic":
        from pcfm_torch.data.synthetic import SyntheticDataset
        tr = None if eval_only else SyntheticDataset(
            split="train",
            tr_sample_size=cfg.tr_max_sample_points,
            te_sample_size=cfg.te_max_sample_points)
        te = SyntheticDataset(split="test",
                              tr_sample_size=cfg.tr_max_sample_points,
                              te_sample_size=cfg.te_max_sample_points)
    else:
        raise ValueError(f"Unknown dataset_type: {ds_type}")

    if eval_only:
        if bool(cfg.has_rgb) and not bool(getattr(te, "has_rgb", False)):
            raise ValueError(
                "eval data has no RGB but the restored run was trained "
                f"with has_rgb=True ({cfg.data_dir}) — the checkpoint's "
                "6-channel inputs cannot be built from this dataset")
        te_cond = int(getattr(te, "cond_dim", 0))
        if te_cond and int(cfg.cond_dim) and te_cond != int(cfg.cond_dim):
            raise ValueError(
                f"eval data cond_dim={te_cond} != restored run "
                f"cond_dim={cfg.cond_dim} — the checkpoint's conditioning "
                "width cannot be built from this dataset (partnet_h5 pads "
                "via cond_dim_override; tdcr/synthetic cannot)")
        return None, te

    sel = subset_indices(len(tr), cfg.train_fraction, cfg.train_count,
                         cfg.train_subset_seed if cfg.train_subset_seed
                         is not None else cfg.seed)
    if sel is not None:
        tr = SubsetDataset(tr, sel)

    base = getattr(tr, "dataset", tr)
    cfg.has_rgb = bool(getattr(base, "has_rgb", False))
    cfg.cond_dim = int(getattr(base, "cond_dim", 0))
    return tr, te
