"""Copy of pcfm/data/synthetic.py (framework-free; the port keeps its own).

Synthetic articulated point clouds — CPU-runnable stand-in for the
PartNet H5 data (BASELINE.json config 1; also used by the test-suite and
benchmarks).

Shapes: two thin boxes joined at a hinge, opened by a joint angle theta
(a toy 'scissors'); per-point RGB colors the two parts differently, so the
geometry-warmup and color-flow paths are exercised end-to-end.  The
generator can also emit reference-schema H5 shards
(data / data_norm / motors / rgb / anno_id / center / scale) for data-layer
tests.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from pcfm_torch.data.h5_dataset import sample_idx


def hinge_shape(rng: np.random.RandomState, n_points: int,
                theta: float) -> tuple:
    """Two unit boxes hinged at the origin, opened by +-theta/2."""
    half = n_points // 2
    pts = []
    cols = []
    for sign, color in ((+1.0, (0.85, 0.2, 0.2)), (-1.0, (0.2, 0.3, 0.9))):
        m = half if sign > 0 else n_points - half
        box = rng.uniform([0, -0.1, -0.02], [1.0, 0.1, 0.02], size=(m, 3))
        a = sign * theta / 2.0
        rot = np.array([[np.cos(a), -np.sin(a), 0],
                        [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]], np.float32)
        pts.append(box.astype(np.float32) @ rot.T)
        cols.append(np.tile(np.asarray(color, np.float32), (m, 1)))
    xyz = np.concatenate(pts, 0)
    rgb = np.concatenate(cols, 0)
    perm = rng.permutation(n_points)
    return xyz[perm], rgb[perm]


class SyntheticDataset:
    """In-memory dataset with the PartNet item schema."""

    def __init__(self, split: str = "train", size: int = 64,
                 n_points: int = 2048, tr_sample_size: int = 2048,
                 te_sample_size: int = 2048, with_rgb: bool = True,
                 with_cond: bool = True, seed: int = 0):
        self.split = split
        self.tr_n = int(tr_sample_size)
        self.te_n = int(te_sample_size)
        rng = np.random.RandomState(seed + (1 if split != "train" else 0))
        self.thetas = rng.uniform(0.1, 2.5, size=size).astype(np.float32)
        self.clouds = []
        self.rgbs = []
        for th in self.thetas:
            xyz, rgb = hinge_shape(rng, n_points, float(th))
            c = xyz.mean(0)
            s = float(np.abs(xyz - c).max()) or 1.0
            self.clouds.append(((xyz - c) / s).astype(np.float32))
            self.rgbs.append(rgb)
        self.has_rgb = bool(with_rgb)
        self.cond_dim = 1 if with_cond else 0
        self.all_points_mean = np.zeros(3, np.float32)
        self.all_points_std = np.ones(3, np.float32)
        self.shuffle_idx = np.arange(size, dtype=np.int64)

    def __len__(self):
        return len(self.clouds)

    def get(self, idx: int, rng: np.random.RandomState) -> Dict:
        pts = self.clouds[idx]
        n = pts.shape[0]
        tr_idx = sample_idx(rng, n, self.tr_n)
        te_idx = sample_idx(rng, n, self.te_n)
        item = {"idx": idx, "train_points": pts[tr_idx],
                "test_points": pts[te_idx],
                "mean": self.all_points_mean.reshape(1, 3),
                "std": self.all_points_std.reshape(1, 3)}
        if self.cond_dim:
            item["cond"] = np.asarray([self.thetas[idx]], np.float32)
        if self.has_rgb:
            item["train_rgb"] = self.rgbs[idx][tr_idx]
            item["test_rgb"] = self.rgbs[idx][te_idx]
        return item


def write_synthetic_shards(out_dir: str, splits=("train", "test"),
                           per_split: int = 16, n_points: int = 512,
                           n_shards: int = 2, with_rgb: bool = True,
                           with_motors: bool = True, motors_dim: int = 2,
                           nan_rows: int = 0, seed: int = 0):
    """Emit reference-schema shard-*.h5 files (datasets.py:441-470 keys)."""
    import h5py
    rng = np.random.RandomState(seed)
    for split in splits:
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        per_shard = max(1, per_split // n_shards)
        row = 0
        for si in range(n_shards):
            rows = per_shard if si < n_shards - 1 else per_split - row
            data = np.zeros((rows, n_points, 3), np.float32)
            data_norm = np.zeros_like(data)
            rgb = np.zeros((rows, n_points, 3), np.uint8)
            motors = np.full((rows, max(motors_dim, 1)), np.nan, np.float32)
            centers = np.zeros((rows, 3), np.float32)
            scales = np.zeros((rows,), np.float32)
            annos = []
            for i in range(rows):
                th = rng.uniform(0.1, 2.5)
                xyz, col = hinge_shape(rng, n_points, th)
                c = xyz.mean(0)
                s = float(np.abs(xyz - c).max()) or 1.0
                data[i] = xyz
                data_norm[i] = (xyz - c) / s
                rgb[i] = (col * 255).astype(np.uint8)
                motors[i, :motors_dim] = th
                if nan_rows and i < nan_rows:
                    motors[i, motors_dim - 1:] = np.nan
                centers[i] = c
                scales[i] = s
                annos.append(f"{split}-{si}-{i}")
                row += 1
            with h5py.File(os.path.join(d, f"shard-{si:03d}.h5"), "w") as f:
                f.create_dataset("data", data=data)
                f.create_dataset("data_norm", data=data_norm)
                if with_rgb:
                    f.create_dataset("rgb", data=rgb)
                if with_motors:
                    f.create_dataset("motors", data=motors)
                f.create_dataset("center", data=centers)
                f.create_dataset("scale", data=scales)
                f.create_dataset(
                    "anno_id",
                    data=np.asarray(annos, dtype=h5py.string_dtype()))
    return out_dir
