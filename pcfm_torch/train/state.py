"""Model bundle — port of the ``ModelBundle`` of pcfm/train/state.py.

Builds the encoder, point flow and latent flow from a ``Config`` with the
dtype policy of the JAX package (``amp and use_bf16`` -> bf16 compute, fp32
parameters), plus EMA shadows that start equal to the live weights (as
``init_state`` does).  Optimizer, EMA update and train state come with the
training port.
"""
from __future__ import annotations

import copy
from typing import Callable

import torch

from pcfm_torch.config import Config
from pcfm_torch.models.encoder import ShapeEncoder
from pcfm_torch.models.latent import ConditionalLatentVelocityNet
from pcfm_torch.models.velocity import VelocityNet


class ModelBundle:
    """The port's modules for one Config: ``enc``, ``pf``, ``lf`` and the
    EMA shadows ``ema_pf``, ``ema_lf``, all on ``device``."""

    def __init__(self, cfg: Config, device, generator: torch.Generator):
        self.cfg = cfg
        self.device = torch.device(device)
        dtype = torch.bfloat16 if (cfg.amp and cfg.use_bf16) \
            else torch.float32
        self.dtype = dtype
        kw = dict(generator=generator, device=self.device)
        self.enc = ShapeEncoder(latent_dim=cfg.latent_dim,
                                width=cfg.enc_width, depth=cfg.enc_depth,
                                in_channels=cfg.enc_in_channels, dtype=dtype,
                                **kw)
        if cfg.pf_backbone != "mlp":
            raise NotImplementedError(
                f"pf_backbone '{cfg.pf_backbone}' is not yet ported to "
                "pcfm_torch (only 'mlp')")
        self.pf = VelocityNet(cond_dim=cfg.pf_cond_dim, width=cfg.pf_width,
                              depth=cfg.pf_depth, emb_dim=cfg.pf_emb_dim,
                              point_dim=cfg.pf_point_dim, dtype=dtype,
                              fused_trunk=cfg.fused_trunk,
                              film_every=cfg.pf_film_every, **kw)
        self.lf = ConditionalLatentVelocityNet(
            latent_dim=cfg.latent_dim, cond_dim=0, width=cfg.lf_width,
            depth=cfg.lf_depth, emb_dim=cfg.lf_emb_dim, dtype=dtype, **kw)
        self.ema_pf = copy.deepcopy(self.pf)
        self.ema_lf = copy.deepcopy(self.lf)

    def modules(self) -> dict:
        return {"encoder": self.enc, "pf": self.pf, "lf": self.lf,
                "ema_pf": self.ema_pf, "ema_lf": self.ema_lf}

    def pf_velocity_fn(self, use_ema: bool) -> Callable:
        """v(x, t, cond) for the samplers: the EMA or the live point flow
        (eval mode; the module itself is the velocity function)."""
        return self.ema_pf if use_ema else self.pf

    def lf_velocity_fn(self, use_ema: bool) -> Callable:
        """v(y, t, cond) of the EMA or the live latent flow."""
        return self.ema_lf if use_ema else self.lf
