"""JAX param trees -> port state_dicts.

The inverse of pcfm/interop/torch_ckpt.py's ``*_from_sd``: a flax param
tree of the JAX package (nested dicts of numpy arrays, e.g.
``jax.device_get(state.params["pf"])``) becomes a state_dict that the
port's modules load with ``load_state_dict``.  flax Dense kernels are
(in, out); torch Linear weights are (out, in).  No jax is imported: the
trees are plain numpy.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tree = Dict[str, Any]


def _dense(p: Tree, where: str, prefix: str) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(p["kernel"], np.float32)
    bias = np.asarray(p["bias"], np.float32)
    if kernel.ndim != 2 or bias.shape != (kernel.shape[1],):
        raise ValueError(f"{where}: Dense kernel {kernel.shape} / bias "
                         f"{bias.shape} do not fit")
    return {f"{prefix}.weight": torch.from_numpy(kernel.T.copy()),
            f"{prefix}.bias": torch.from_numpy(bias.copy())}


def _norm(p: Tree, where: str, prefix: str, width: int
          ) -> Dict[str, torch.Tensor]:
    scale = np.asarray(p["scale"], np.float32)
    bias = np.asarray(p["bias"], np.float32)
    if scale.shape != (width,) or bias.shape != (width,):
        raise ValueError(f"{where}: LayerNorm {scale.shape}/{bias.shape} "
                         f"!= ({width},)")
    return {f"{prefix}.weight": torch.from_numpy(scale.copy()),
            f"{prefix}.bias": torch.from_numpy(bias.copy())}


def _blocks(p: Tree) -> list:
    return sorted(int(k.split("_")[1]) for k in p if k.startswith("block_"))


def velocity_net_to_sd(p: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``VelocityNet`` params -> port ``VelocityNet`` state_dict."""
    sd = {}
    for name in ("t_proj", "c_proj", "input"):
        sd.update(_dense(p[name], name, name))
    sd.update(_dense(p["out"], "out", "out.1"))
    for i in _blocks(p):
        blk = _dense(p[f"block_{i}"], f"block_{i}", f"blocks.{i}.1")
        sd.update(blk)
        if f"film_{i}" in p:
            film = p[f"film_{i}"]
            width = blk[f"blocks.{i}.1.weight"].shape[0]
            sd.update(_norm(film["norm"], f"film_{i}/norm",
                            f"films.{i}.norm", width))
            sd.update(_dense(film["affine"], f"film_{i}/affine",
                             f"films.{i}.affine"))
    return sd


def latent_net_to_sd(p: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``ConditionalLatentVelocityNet`` params -> port state_dict."""
    sd = {}
    for name in ("t_proj", "c_proj", "input"):
        sd.update(_dense(p[name], name, name))
    sd.update(_dense(p["out"], "out", "out.1"))
    for i in _blocks(p):
        sd.update(_dense(p[f"block_{i}"], f"block_{i}", f"blocks.{i}.1"))
    return sd


def shape_encoder_to_sd(p: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``ShapeEncoder`` params -> port state_dict (``mlp.{2i}``,
    ``head.{2j}``, the last head Linear after the hidden ones)."""
    sd = {}
    for i in range(3):
        sd.update(_dense(p[f"mlp_{i}"], f"mlp_{i}", f"mlp.{2 * i}"))
    n_hidden = sum(1 for k in p if k.startswith("head_") and k != "head_out")
    for j in range(n_hidden):
        sd.update(_dense(p[f"head_{j}"], f"head_{j}", f"head.{2 * j}"))
    sd.update(_dense(p["head_out"], "head_out", f"head.{2 * n_hidden}"))
    return sd
