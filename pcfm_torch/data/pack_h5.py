"""PLY -> H5 shard packer: the port's copy of pcfm/data/pack_h5.py, with
the CLI of scripts/pack_h5.py as ``python -m pcfm_torch.data.pack_h5``.

The reference README trains from `shard-*.h5` files but the repo ships no
packer (SURVEY.md §2.4 note) — the schema is recovered from the consumer
(`datasets.py:441-470, 565-620`):
  data      (B, N, 3) float32   raw points
  data_norm (B, N, 3) float32   (data - center) / scale
  rgb       (B, N, 3) uint8     optional per-point colors
  motors    (B, Dmax) float32   per-pose joint values, NaN-padded
  anno_id   (B,)      str       model annotation id
  center    (B, 3)    float32
  scale     (B,)      float32

Input layout is the `make_dataset.py` output tree:
  {model_id}/pose_XXX/{pointcloud.ply, angles.json}  (+ per-model joint.json)

Normalization convention (ours — the reference's packer is absent):
center = per-cloud mean, scale = max |p - center| (points end in [-1,1]^3).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from pcfm_torch.data.ply import load_ply


def _pose_records(in_dir: str) -> List[Dict]:
    recs = []
    for ply_path in sorted(glob.glob(
            os.path.join(in_dir, "**", "pose_*", "pointcloud.ply"),
            recursive=True)):
        pose_dir = os.path.dirname(ply_path)
        model_dir = os.path.dirname(pose_dir)
        angles_path = os.path.join(pose_dir, "angles.json")
        angles = None
        if os.path.isfile(angles_path):
            with open(angles_path) as f:
                a = json.load(f)
            if isinstance(a, dict):
                vals = a.get("angles", a.get("values", a))
                if isinstance(vals, dict):
                    vals = [vals[k] for k in sorted(vals)]
                angles = np.asarray(vals, np.float32).reshape(-1)
            else:
                angles = np.asarray(a, np.float32).reshape(-1)
        recs.append({"ply": ply_path, "angles": angles,
                     "anno_id": os.path.basename(model_dir)})
    return recs


def pack_ply_to_h5(in_dir: str, out_dir: str, split: str = "train",
                   n_points: Optional[int] = None, shard_size: int = 128,
                   val_fraction: float = 0.0, seed: int = 0,
                   verbose: bool = True) -> List[str]:
    """Pack a make_dataset.py-style PLY tree into shard-*.h5 files.

    Args:
      n_points: resample every cloud to this count (required when clouds
        have different sizes; None keeps the per-file size of the first).
      val_fraction: if > 0, also emit a 'test' split with this fraction.
    Returns list of written shard paths.
    """
    import h5py
    recs = _pose_records(in_dir)
    if not recs:
        raise FileNotFoundError(
            f"no pose_*/pointcloud.ply found under {in_dir}")
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(recs))
    n_val = int(len(recs) * val_fraction)
    splits = {split: [recs[i] for i in order[n_val:]]}
    if n_val:
        splits["test"] = [recs[i] for i in order[:n_val]]

    written = []
    for sp, rs in splits.items():
        d = os.path.join(out_dir, sp)
        os.makedirs(d, exist_ok=True)
        max_joints = max((0 if r["angles"] is None else len(r["angles"]))
                        for r in rs)
        for si in range(0, len(rs), shard_size):
            chunk = rs[si:si + shard_size]
            data, norm, rgbs, motors, annos, centers, scales = \
                [], [], [], [], [], [], []
            has_rgb = True
            npts = n_points
            for r in chunk:
                xyz, rgb = load_ply(r["ply"])
                if npts is None:
                    npts = xyz.shape[0]
                if xyz.shape[0] != npts:
                    ridx = (rng.choice(xyz.shape[0], npts, replace=False)
                            if xyz.shape[0] >= npts else
                            rng.choice(xyz.shape[0], npts, replace=True))
                    xyz = xyz[ridx]
                    rgb = rgb[ridx] if rgb is not None else None
                c = xyz.mean(0)
                s = float(np.abs(xyz - c).max()) or 1.0
                data.append(xyz)
                norm.append((xyz - c) / s)
                centers.append(c)
                scales.append(s)
                annos.append(r["anno_id"])
                if rgb is None:
                    has_rgb = False
                else:
                    rgbs.append(rgb)
                m = np.full((max(max_joints, 1),), np.nan, np.float32)
                if r["angles"] is not None:
                    m[:len(r["angles"])] = r["angles"]
                motors.append(m)
            path = os.path.join(d, f"shard-{si // shard_size:03d}.h5")
            with h5py.File(path, "w") as f:
                f.create_dataset("data", data=np.stack(data))
                f.create_dataset("data_norm",
                                 data=np.stack(norm).astype(np.float32))
                if has_rgb and rgbs:
                    f.create_dataset("rgb", data=np.stack(rgbs))
                if max_joints > 0:
                    f.create_dataset("motors", data=np.stack(motors))
                f.create_dataset("center",
                                 data=np.stack(centers).astype(np.float32))
                f.create_dataset("scale",
                                 data=np.asarray(scales, np.float32))
                f.create_dataset(
                    "anno_id",
                    data=np.asarray(annos, dtype=h5py.string_dtype()))
            written.append(path)
            if verbose:
                print(f"[pack_h5] wrote {path} ({len(chunk)} clouds, "
                      f"{npts} pts, rgb={has_rgb}, joints={max_joints})")
    return written


def build_parser() -> argparse.ArgumentParser:
    """scripts/pack_h5.py's options."""
    p = argparse.ArgumentParser("PLY -> H5 shard packer")
    p.add_argument("--in_dir", required=True,
                   help="tree of {model}/pose_*/pointcloud.ply")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--n_points", type=int, default=None)
    p.add_argument("--shard_size", type=int, default=128)
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    a = build_parser().parse_args(argv)
    return pack_ply_to_h5(a.in_dir, a.out_dir, split=a.split,
                          n_points=a.n_points, shard_size=a.shard_size,
                          val_fraction=a.val_fraction, seed=a.seed)


if __name__ == "__main__":
    main()
