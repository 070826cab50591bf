"""What the learning runs share: a synthetic split held on the device, a
batch gathered by index in an order drawn from a seeded
``torch.Generator``, one epoch of train steps reading the last two
steps' losses (as the JAX harnesses read them), the conditioned
generative suite and its seed band, and the atomic JSON write."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from pcfm_torch.data.synthetic import SyntheticDataset
from pcfm_torch.device import DEVICES
from pcfm_torch.eval.metrics import generative_metrics
from pcfm_torch.train.step import train_step

# the JAX harnesses' late-epoch read: the mean of the last two steps
LATE_STEPS = 2


def dump_json(path: str, obj) -> None:
    """Atomic JSON write: a temp file in the same directory, then
    ``os.replace``, so that a run cut mid-write leaves the last whole
    file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="cuda (default) or cpu")


def seeds(text: str) -> List[int]:
    """A comma-separated list of integers ('' -> [])."""
    return [int(s) for s in text.split(",") if s.strip()]


def device_split(split: str, size: int, n_points: int, device,
                 seed: int = 0) -> Tuple[SyntheticDataset, Dict]:
    """The synthetic set's ``split`` with RGB and the 1-D condition, and
    its clouds on ``device``: 'pts' (S, N, 3), 'rgb' (S, N, 3), 'cond'
    (S, 1)."""
    ds = SyntheticDataset(split=split, size=size, n_points=n_points,
                          tr_sample_size=n_points, te_sample_size=n_points,
                          with_rgb=True, with_cond=True, seed=seed)
    arrays = {"pts": np.stack(ds.clouds), "rgb": np.stack(ds.rgbs),
              "cond": ds.thetas[:, None]}
    return ds, {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrays.items()}


def gather_batch(split: Dict, idx: torch.Tensor) -> Dict:
    """The clouds ``idx`` of a device split, gathered on the device."""
    return {k: v.index_select(0, idx) for k, v in split.items()}


class EpochOrder:
    """Each epoch's order of a split's clouds: a permutation from a
    ``torch.Generator`` seeded once (scripts' ``np.random.RandomState(1)``
    counterpart), cut to whole batches, on the split's device."""

    def __init__(self, size: int, batch: int, device, seed: int = 1):
        self.size, self.batch, self.device = size, batch, device
        self.gen = torch.Generator().manual_seed(seed)

    @property
    def steps(self) -> int:
        return self.size // self.batch

    def next(self) -> List[torch.Tensor]:
        order = torch.randperm(self.size, generator=self.gen)
        order = order[:self.steps * self.batch].to(self.device)
        return list(order.split(self.batch))


def train_epoch(state, split: Dict, batches: Iterable[torch.Tensor],
                generator: torch.Generator, color_on: float, drop_p: float,
                keys: Sequence[str] = ("loss_point", "loss_latent")
                ) -> Dict[str, float]:
    """One epoch of train steps on batches gathered from ``split``; the
    mean of each of ``keys`` over the epoch's last LATE_STEPS steps (the
    only host reads)."""
    batches = list(batches)
    late = []
    for i, idx in enumerate(batches):
        m = train_step(state, gather_batch(split, idx), generator, color_on,
                       drop_p)
        if i >= len(batches) - LATE_STEPS:
            late.append(torch.stack([m.get(k, torch.zeros(
                (), device=m["loss"].device)) for k in keys]))
    means = torch.stack(late).mean(0).tolist()
    return dict(zip(keys, means))


def generator_for(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def conditioned_suite(sample_fn: Callable, te_cond: torch.Tensor,
                      te_pts: torch.Tensor, batch: int, n_points: int,
                      seed: int, metrics: tuple = ("cd",)
                      ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """The eval CLI's suite protocol: one generated cloud per test cloud
    with that cloud's condition, in batches of ``batch`` (the last padded
    with zero conditions, its padded rows dropped); then MMD / COV / 1-NNA
    against the test clouds, on their device.  Each batch's draws come
    from a generator seeded by (seed + its first index).  Returns the
    generated xyz (T, N, 3) on the device and the metrics."""
    gens = []
    total = te_cond.shape[0]
    for s0 in range(0, total, batch):
        conds = te_cond[s0:s0 + batch]
        pad = batch - conds.shape[0]
        if pad:
            conds = torch.cat([conds, conds.new_zeros(pad, conds.shape[1])])
        x = sample_fn(conds, generator_for(conds.device, seed + s0), batch,
                      n_points)
        gens.append(x[:batch - pad, :, :3].float())
    gen = torch.cat(gens)[:total]
    return gen, generative_metrics(gen, te_pts, metrics=metrics)


def seed_band(suite: Callable[[int], Tuple[np.ndarray, Dict]],
              seed_list: Sequence[int], tag: int = 0,
              log: Callable[[str], None] = print) -> Tuple[list, dict]:
    """Repeated-seed suites: each seed's metrics and each metric's mean /
    min / max.  ``suite(seed)`` runs one suite."""
    rows = []
    for s in seed_list:
        _, res = suite(900_000 + tag * 1000 + s)
        rows.append({k: float(v) for k, v in res.items()})
        log(f"seed {s}: { {k: round(v, 4) for k, v in rows[-1].items()} }")
    agg = {k: {"mean": round(float(np.mean([r[k] for r in rows])), 4),
               "min": round(float(np.min([r[k] for r in rows])), 4),
               "max": round(float(np.max([r[k] for r in rows])), 4)}
           for k in rows[0]}
    return rows, agg


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them (or
    'cpu'), written beside every wall time."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device)
