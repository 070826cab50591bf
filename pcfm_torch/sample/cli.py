"""Sampling CLI: generate point clouds from a checkpoint — port of
pcfm/sample/cli.py with the same flags.

Loads the newest ``ckpts/hybrid_ep*.pt`` under --out_dir (config from its
``args``, overridable from the command line), runs the latent-flow ->
point-flow pipeline on the card (``--device cpu`` asks for the CPU; without
CUDA and without that flag it is an error), and writes PLY files.  The
point flow runs in eval mode (BatchNorm running statistics).

    python -m pcfm_torch.sample.cli --out_dir RUN --num_samples 8 \
        --n_points 20000
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from pcfm_torch.data.ply import (save_point_cloud_ply,
                                 save_point_cloud_ply_rgb)
from pcfm_torch.device import DEVICES, resolve_device
from pcfm_torch.train import checkpoint as ckpt
from pcfm_torch.train.evaluate import make_sample_fn


def load_run(out_dir: str, overrides: Optional[dict] = None,
             device="cuda"):
    """Rebuild (cfg, bundle, epoch) from the newest checkpoint, on
    ``device`` ("cuda", or "cpu" when asked)."""
    device = resolve_device(device)
    path, ep = ckpt.find_latest(out_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {out_dir}/ckpts")
    cfg, bundle, _ = ckpt.load(path, device, overrides)
    return cfg, bundle, ep


def main(argv: Optional[Sequence[str]] = None, device=None) -> np.ndarray:
    """Parse ``argv``, sample, write PLYs; returns the clouds.  ``device``
    (a keyword for callers) overrides ``--device``."""
    p = argparse.ArgumentParser("pcfm_torch sampling")
    p.add_argument("--out_dir", type=str, required=True,
                   help="training run dir containing ckpts/")
    p.add_argument("--save_dir", type=str, default="",
                   help="default: {out_dir}/generated")
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--n_points", type=int, default=2048)
    p.add_argument("--sample_steps", type=int, default=None)
    p.add_argument("--latent_sample_steps", type=int, default=None,
                   help="latent-flow NFE override (0 = sample_steps)")
    p.add_argument("--sampler", type=str, default=None,
                   choices=["euler", "midpoint", "heun", "rk4", "dopri5"])
    p.add_argument("--guidance_scale", type=float, default=None)
    p.add_argument("--eval_oversample", type=float, default=None,
                   help="density recipe: sample ceil(k*N) points per cloud "
                        "and FPS-subsample to N (1.0 = off)")
    p.add_argument("--latent_prior_std", type=float, default=None,
                   help="latent prior std override (diversity knob)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cond", type=float, nargs="*", default=None,
                   help="joint condition values (broadcast to all samples)")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the run goes: the card (default; an error "
                        "without CUDA) or, when asked, the CPU")
    args = p.parse_args(argv)

    over = {k: getattr(args, k) for k in
            ("sample_steps", "latent_sample_steps", "sampler",
             "guidance_scale", "eval_oversample", "latent_prior_std")}
    cfg, bundle, ep = load_run(args.out_dir, over, device or args.device)
    sample_fn = make_sample_fn(bundle)

    cond = None
    if args.cond is not None and cfg.cond_dim > 0:
        c = np.zeros((args.num_samples, cfg.cond_dim), np.float32)
        c[:, :len(args.cond)] = np.asarray(args.cond, np.float32)
        cond = torch.from_numpy(c).to(bundle.device)

    gen = torch.Generator(device=bundle.device).manual_seed(args.seed)
    x = sample_fn(cond, gen, args.num_samples, args.n_points).cpu().numpy()

    save_dir = args.save_dir or os.path.join(args.out_dir, "generated")
    os.makedirs(save_dir, exist_ok=True)
    for i in range(x.shape[0]):
        path = os.path.join(save_dir, f"sample_{i}.ply")
        if x.shape[-1] == 6:
            save_point_cloud_ply_rgb(x[i, :, :3], np.clip(x[i, :, 3:], 0, 1),
                                     path)
        else:
            save_point_cloud_ply(x[i], path)
    print(f"[sample] wrote {x.shape[0]} clouds ({x.shape[1]} pts, "
          f"ep{ep} ckpt, {cfg.sampler} x{cfg.sample_steps}, "
          f"{bundle.device}) -> {save_dir}")
    return x


if __name__ == "__main__":
    main()
