"""Full-size convergence run, the port's counterpart of
scripts/convergence_full.py: the hybrid backbone at the bench workload
(batch 8, 20 000 RGB points, the 1-D joint condition, latent 128, the
Config's three-stage ContextNet) on device-resident synthetic clouds
(``--size`` of them, ``--size // --batch`` steps an epoch).  Every
``--eval_every`` epochs it reconstructs the first ``--batch`` test clouds
with Heun x 25 from the EMA weights and records their mean chamfer
distance; at the end it writes sample PLYs.

Every flag is the JAX script's environment knob of the same name,
lower-cased, with its default, plus ``--device`` (the card by default;
``--device cpu`` asks for the CPU).  The point-flow head runs the FiLM
kernel trunk, the ContextNet the voxel kernels, the recon CD the chamfer
kernel.  Writes OUT/history.json (a row an epoch, with its ms a step on
the host clock) and recon_*.ply / gt_*.ply.

    python -m pcfm_torch.quality.convergence_full --epochs 120 \\
        --out docs/torch_quality/conv_full
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from pcfm_torch.config import Config
from pcfm_torch.data.ply import save_point_cloud_ply_rgb
from pcfm_torch.device import resolve_device
from pcfm_torch.ops.chamfer import chamfer_l2
from pcfm_torch.quality.common import (EpochOrder, add_device_flag, card,
                                       device_split, dump_json,
                                       generator_for, train_epoch)
from pcfm_torch.train.evaluate import make_recon_fn
from pcfm_torch.train.loop import epoch_scalars
from pcfm_torch.train.state import init_state

TEST_CLOUDS = 16


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="hybrid convergence run at the bench workload")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--size", type=int, default=256, help="train clouds")
    p.add_argument("--npts", type=int, default=20000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out", type=str, default=os.path.join(
        tempfile.gettempdir(), "pcfm_conv_full"))
    p.add_argument("--film_every", type=int, default=1)
    add_device_flag(p)
    return p


def make_config(args) -> Config:
    """scripts/convergence_full.py's Config, with the kernel trunk."""
    return Config(pf_backbone="hybrid", latent_dim=128, has_rgb=True,
                  cond_dim=1, pointflow_rgb=True, use_rgb_in_latent=True,
                  amp=True, use_bf16=True, tr_max_sample_points=args.npts,
                  batch_size=args.batch, epochs=args.epochs,
                  warmup_steps=200, geom_warmup_epochs=5,
                  cfg_drop_warmup_epochs=10, sampler="heun",
                  sample_steps=25, seed=7, pf_film_every=args.film_every,
                  fused_trunk="on")


def main(argv: Optional[Sequence[str]] = None, overrides=None) -> list:
    """Parse ``argv`` and run; returns the history.  ``overrides``
    replaces Config fields (for callers that shrink the model, as the CPU
    tests do)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    def log(msg):
        print(f"[conv] {msg}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    t_all = time.time()
    cfg = make_config(args).replace(**(overrides or {}))
    where = card(device)
    log(f"device {device} ({where})")
    _, train = device_split("train", args.size, args.npts, device)
    ds_te, test = device_split("test", TEST_CLOUDS, args.npts, device)
    te = {k: v[:args.batch] for k, v in test.items()}
    log(f"data on device: {args.size}x{args.npts} pts")

    order = EpochOrder(args.size, args.batch, device)
    state = init_state(cfg, device, args.epochs * order.steps,
                       torch.Generator().manual_seed(cfg.seed))
    gen = generator_for(device, cfg.seed)
    recon = make_recon_fn(state.bundle)

    hist = []
    t0 = time.time()
    for ep in range(1, args.epochs + 1):
        color_on, dp = epoch_scalars(cfg, ep)
        te0 = time.time()
        losses = train_epoch(state, train, order.next(), gen, color_on, dp)
        epoch_s = time.time() - te0
        row = {"epoch": ep, "loss_point": round(losses["loss_point"], 4),
               "loss_latent": round(losses["loss_latent"], 4),
               "ms_per_step": round(epoch_s * 1e3 / order.steps, 3),
               "elapsed_s": round(time.time() - t0, 1)}
        if ep % args.eval_every == 0 or ep == args.epochs:
            x = recon(te["pts"], te["rgb"], te["cond"],
                      generator_for(device, 10_000_000 + ep))
            cd = chamfer_l2(x[..., :3].float(), te["pts"])
            row["recon_cd"] = round(float(cd.mean()), 4)
        hist.append(row)
        log(str(row))
        dump_json(os.path.join(args.out, "history.json"), hist)
    train_s = time.time() - t0

    x = recon(te["pts"], te["rgb"], te["cond"], generator_for(device, 42))
    x = x.float().cpu().numpy()
    for i in range(min(4, args.batch)):
        save_point_cloud_ply_rgb(x[i, :, :3], np.clip(x[i, :, 3:6], 0, 1),
                                 os.path.join(args.out, f"recon_{i}.ply"))
        save_point_cloud_ply_rgb(ds_te.clouds[i], ds_te.rgbs[i],
                                 os.path.join(args.out, f"gt_{i}.ply"))
    dump_json(os.path.join(args.out, "summary.json"), {
        "device": where, "epochs": args.epochs, "steps": state.step,
        "size": args.size, "npts": args.npts, "batch": args.batch,
        "train_s": round(train_s, 1),
        "total_s": round(time.time() - t_all, 1),
        "final": hist[-1] if hist else None})
    log(f"total {time.time() - t_all:.0f}s; PLYs + history in {args.out}")
    return hist


if __name__ == "__main__":
    main()
