"""Checkpoints in the reference format — ``ckpts/hybrid_ep{ep:04d}.pt``.

A checkpoint is one ``torch.save`` dict with the reference trainer's keys
(reference train.py:682-708): module state_dicts ``encoder``, ``pf``,
``lf``; EMA shadows ``ema_pf``, ``ema_lf`` keyed like the state_dicts;
``args`` (the Config as a dict), ``cond_dim``, ``epoch``, ``global_step``.
pcfm/interop/torch_ckpt.py:state_from_reference_ckpt reads it unchanged,
so a port checkpoint loads into the JAX package.  Optimizer state comes
with the training port.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple

import torch

from pcfm_torch.config import Config
from pcfm_torch.train.state import ModelBundle

_CKPT_RE = re.compile(r"hybrid_ep(\d+)\.pt$")


def ckpt_dir(out_dir: str) -> str:
    return os.path.join(os.path.abspath(out_dir), "ckpts")


def save(out_dir: str, epoch: int, bundle: ModelBundle,
         global_step: int = 0) -> str:
    d = ckpt_dir(out_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"hybrid_ep{epoch:04d}.pt")
    ckpt = {k: {n: v.detach().cpu() for n, v in m.state_dict().items()}
            for k, m in bundle.modules().items()}
    ckpt.update(args=dataclasses.asdict(bundle.cfg),
                cond_dim=int(bundle.cfg.cond_dim), epoch=int(epoch),
                global_step=int(global_step))
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)               # a reader never sees half a file
    return path


def find_latest(out_dir: str) -> Tuple[Optional[str], int]:
    """(path, epoch) of the newest checkpoint, or (None, 0)."""
    d = ckpt_dir(out_dir)
    if not os.path.isdir(d):
        return None, 0
    best_ep, best_path = 0, None
    for fn in os.listdir(d):
        m = _CKPT_RE.match(fn)
        if m and int(m.group(1)) > best_ep:
            best_ep, best_path = int(m.group(1)), os.path.join(d, fn)
    return best_path, best_ep


def load(path: str, device, overrides: Optional[dict] = None
         ) -> Tuple[Config, ModelBundle, dict]:
    """Rebuild (cfg, bundle, ckpt) from a checkpoint.  ``overrides``
    replaces Config fields (None values are ignored) before the modules
    are built; weights load strictly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    cfg = Config(**{k: v for k, v in ckpt["args"].items()
                    if k in {f.name for f in dataclasses.fields(Config)}})
    cfg = cfg.replace(cond_dim=int(ckpt.get("cond_dim", cfg.cond_dim)),
                      **{k: v for k, v in (overrides or {}).items()
                         if v is not None})
    # the initial draw is overwritten by the checkpoint's weights
    bundle = ModelBundle(cfg, device, torch.Generator().manual_seed(0))
    for key, module in bundle.modules().items():
        module.load_state_dict(ckpt.get(key) or ckpt[key.replace("ema_", "")])
    return cfg, bundle, ckpt
