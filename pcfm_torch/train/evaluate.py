"""Generation / reconstruction (the serve path) — port of
pcfm/train/evaluate.py.

  * sample: latent-flow integration z ~ flow(N(0, s^2)) -> point flow
  * recon:  z = enc(GT) -> point-flow integration from the prior

Both default to the EMA weights (``cfg.ema_eval``) and run the networks in
eval mode (the hybrid's BatchNorms on their running statistics).  The
priors are drawn
from a ``torch.Generator`` unless they are handed in (``z0`` / ``x0``), so
a test can give both frameworks the same draws.  ``dump_clouds`` and
``val_cd`` are the training loop's validation outputs.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import numpy as np
import torch

from pcfm_torch.config import Config
from pcfm_torch.data.ply import (save_point_cloud_ply,
                                 save_point_cloud_ply_rgb)
from pcfm_torch.ops.chamfer import chamfer_l2
from pcfm_torch.ops.sampling import furthest_point_sample_indices, gather
from pcfm_torch.sample.integrators import get_sampler
from pcfm_torch.sample.priors import make_latent_prior, make_pf_prior
from pcfm_torch.train.state import ModelBundle


@contextlib.contextmanager
def eval_mode(*modules: torch.nn.Module):
    """Run ``modules`` in eval mode, restoring each one's mode after."""
    modes = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        yield
    finally:
        for m, was in zip(modules, modes):
            m.train(was)


def _cond_full(cfg: Config, z: torch.Tensor,
               cond_j: Optional[torch.Tensor]) -> torch.Tensor:
    """Point-flow condition [z || cond], zero-padded when cond is absent."""
    if cond_j is not None:
        return torch.cat([z, cond_j.to(z.dtype)], dim=1)
    if cfg.cond_dim > 0:
        pad = torch.zeros((z.shape[0], cfg.cond_dim), dtype=z.dtype,
                          device=z.device)
        return torch.cat([z, pad], dim=1)
    return z


def _pf_prior(cfg: Config, generator, shape) -> torch.Tensor:
    return make_pf_prior(generator, shape, cfg.point_prior_std,
                         cfg.color_prior, cfg.color_prior_std)


def make_recon_fn(bundle: ModelBundle, use_ema: Optional[bool] = None):
    """recon(pts, rgb, cond_j, generator, x0=None) -> x (B, N, D)."""
    cfg = bundle.cfg
    use_ema = cfg.ema_eval if use_ema is None else use_ema
    sampler = get_sampler(cfg.sampler)

    @torch.no_grad()
    def recon(pts, rgb, cond_j, generator=None, x0=None):
        if cfg.enc_in_channels == 6:
            rgb_in = rgb if rgb is not None else torch.zeros_like(pts)
            enc_in = torch.cat([pts, rgb_in], dim=-1)
        else:
            enc_in = pts
        pf = bundle.pf_velocity_fn(use_ema)
        with eval_mode(bundle.enc, pf):
            z, _ = bundle.enc(enc_in)
            cond_full = _cond_full(cfg, z, cond_j)
            b, n = pts.shape[:2]
            if x0 is None:
                x0 = _pf_prior(cfg, generator, (b, n, cfg.pf_point_dim))
            return sampler(pf, x0, max(1, cfg.sample_steps), cond=cond_full,
                           guidance_scale=cfg.guidance_scale)

    return recon


def make_sample_fn(bundle: ModelBundle, use_ema: Optional[bool] = None):
    """sample(cond_j, generator, batch, n_points, z0=None, x0=None) ->
    x (B, N, D): unconditional latent flow, then the point flow.

    With ``cfg.eval_oversample = k > 1`` the point flow integrates
    ceil(k * N) points (``x0`` then holds that many) and furthest point
    sampling takes N of them: the flow treats points i.i.d., so
    oversampling is exact, and FPS evens out the local density."""
    cfg = bundle.cfg
    use_ema = cfg.ema_eval if use_ema is None else use_ema
    oversample = max(1.0, float(cfg.eval_oversample))
    sampler = get_sampler(cfg.sampler)

    @torch.no_grad()
    def sample(cond_j, generator, batch: int, n_points: int, z0=None,
               x0=None):
        if z0 is None:
            z0 = make_latent_prior(generator, batch, cfg.latent_dim,
                                   cfg.latent_prior_std)
        lf, pf = bundle.lf_velocity_fn(use_ema), bundle.pf_velocity_fn(use_ema)
        with eval_mode(lf, pf):
            # the latent flow is unconditional; its NFE is overridable
            lat_steps = int(cfg.latent_sample_steps) \
                or max(1, cfg.sample_steps)
            z = sampler(lf, z0, lat_steps, cond=None, guidance_scale=0.0)
            cond_full = _cond_full(cfg, z, cond_j)
            n_gen = int(math.ceil(n_points * oversample))
            if x0 is None:
                x0 = _pf_prior(cfg, generator, (batch, n_gen,
                                                cfg.pf_point_dim))
            x = sampler(pf, x0, max(1, cfg.sample_steps), cond=cond_full,
                        guidance_scale=cfg.guidance_scale)
        if n_gen > n_points:
            x = gather(x, furthest_point_sample_indices(x[..., :3],
                                                        n_points))
        return x

    return sample


def dump_clouds(x: np.ndarray, gt_pts: np.ndarray,
                gt_rgb: Optional[np.ndarray], out_dir: str, count: int):
    """PLY dumps of predictions + ground truth (train.py:345-353)."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(min(count, x.shape[0])):
        pred, gt = (os.path.join(out_dir, f"{k}_{i}.ply")
                    for k in ("pred", "gt"))
        if x.shape[-1] == 6 and gt_rgb is not None:
            save_point_cloud_ply_rgb(x[i, :, :3], np.clip(x[i, :, 3:], 0, 1),
                                     pred)
            save_point_cloud_ply_rgb(gt_pts[i], np.clip(gt_rgb[i], 0, 1), gt)
        else:
            save_point_cloud_ply(x[i, :, :3], pred)
            save_point_cloud_ply(gt_pts[i], gt)


def val_cd(x: torch.Tensor, pts: torch.Tensor) -> float:
    """Mean train-time CD between generated and ground-truth xyz."""
    return float(chamfer_l2(x[:, :, :3], pts).mean())
