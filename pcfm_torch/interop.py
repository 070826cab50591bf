"""JAX param trees -> port state_dicts, and reference checkpoints -> port
runs.

The inverse of pcfm/interop/torch_ckpt.py's ``*_from_sd``: a flax param
tree of the JAX package (nested dicts of numpy arrays, e.g.
``jax.device_get(state.params["pf"])``, with ``batch_stats`` for the
hybrid) becomes a state_dict that the port's modules load with
``load_state_dict``.  flax Dense kernels are (in, out); torch Linear
weights are (out, in); flax Conv kernels (D, H, W, in, out), torch's
(out, in, D, H, W).  No jax is imported: the trees are plain numpy.

``import_reference_checkpoint`` (and ``python -m pcfm_torch.interop
ref.pt --out_dir D``) is the port's counterpart of pcfm/interop/: a
reference ``hybrid_epNNNN.pt`` becomes a port run (below).
``adamw_state_dict`` builds the port optimizer's state from per-parameter
AdamW moments, as scripts/jax_run_to_torch.py carries a JAX run's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

# the reference-format readers live beside the port's own checkpoint code
from pcfm_torch.train.checkpoint import (  # noqa: F401
    config_from_reference_args, unwrap_ddp)

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


# ------------------------------------------------------------ hybrid

def _conv1d(p: Tree, where: str, prefix: str) -> Dict[str, torch.Tensor]:
    """flax Dense -> reference Conv1d(k=1): weight (out, in, 1), bias (a
    bias-free Dense gets bias 0)."""
    kernel = np.asarray(p["kernel"], np.float32)
    if kernel.ndim != 2:
        raise ValueError(f"{where}: Dense kernel {kernel.shape} is not 2-D")
    bias = np.asarray(p["bias"], np.float32) if "bias" in p \
        else np.zeros(kernel.shape[1], np.float32)
    return {f"{prefix}.weight": torch.from_numpy(kernel.T[:, :, None].copy()),
            f"{prefix}.bias": torch.from_numpy(bias.copy())}


def _bn(p: Tree, s: Tree, where: str, prefix: str, width: int
        ) -> Dict[str, torch.Tensor]:
    """flax BatchNorm params {scale, bias} + batch_stats {mean, var} ->
    torch BatchNorm entries (num_batches_tracked 0)."""
    sd = _norm(p, where, prefix, width)
    for src, dst in (("mean", "running_mean"), ("var", "running_var")):
        v = np.asarray(s[src], np.float32)
        if v.shape != (width,):
            raise ValueError(f"{where}: {src} {v.shape} != ({width},)")
        sd[f"{prefix}.{dst}"] = torch.from_numpy(v.copy())
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _shared_mlp(p: Tree, s: Tree, where: str, prefix: str, dim: int = 1
                ) -> Dict[str, torch.Tensor]:
    """JAX SharedMLP (dense_i without bias, bn_i) -> reference
    ``layers.{3i}`` Conv1d (bias 0; a Conv2d's (out, in, 1, 1) weight at
    ``dim=2``) + ``layers.{3i+1}`` BatchNorm."""
    sd = {}
    layers = sorted(int(k.split("_")[1]) for k in p if k.startswith("dense_"))
    if layers != list(range(len(layers))) or not layers:
        raise ValueError(f"{where}: Dense layers {layers}")
    for i in layers:
        conv, bn = f"{prefix}.layers.{3 * i}", f"{prefix}.layers.{3 * i + 1}"
        part = _conv1d(p[f"dense_{i}"], f"{where}/dense_{i}", conv)
        part[f"{conv}.weight"] = part[f"{conv}.weight"].reshape(
            *part[f"{conv}.weight"].shape[:2], *(1,) * dim)
        sd.update(part)
        sd.update(_bn(p[f"bn_{i}"], s[f"bn_{i}"], f"{where}/bn_{i}", bn,
                      part[f"{conv}.weight"].shape[0]))
    return sd


def _norm_layer(p: Tree, s: Tree, where: str, prefix: str, width: int
                ) -> Dict[str, torch.Tensor]:
    """make_norm's params: GroupNorm {scale, bias}, BatchNorm1d
    {bn: {scale, bias}} (+ stats), or nothing (norm 'none')."""
    if p is None:
        return {}
    if "bn" in p:
        return _bn(p["bn"], s["bn"], f"{where}/bn", prefix, width)
    return _norm(p, where, prefix, width)


def _pvconv(p: Tree, s: Tree, where: str, prefix: str
            ) -> Dict[str, torch.Tensor]:
    sd = {}
    for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
        kernel = np.asarray(p[f"conv3d_{j}"]["kernel"], np.float32)
        if kernel.ndim != 5:
            raise ValueError(f"{where}/conv3d_{j}: kernel {kernel.shape}")
        out = kernel.shape[-1]
        # flax (D, H, W, in, out) -> torch (out, in, D, H, W)
        sd[f"{prefix}.voxel_layers.{ci}.weight"] = torch.from_numpy(
            kernel.transpose(4, 3, 0, 1, 2).copy())
        sd[f"{prefix}.voxel_layers.{ci}.bias"] = torch.zeros(out)
        sd.update(_bn(p[f"bn3d_{j}"], s[f"bn3d_{j}"], f"{where}/bn3d_{j}",
                      f"{prefix}.voxel_layers.{bi}", out))
    if "se" in p:
        for name, idx in (("fc1", 0), ("fc2", 2)):
            kernel = np.asarray(p["se"][name]["kernel"], np.float32)
            sd[f"{prefix}.voxel_layers.6.fc.{idx}.weight"] = \
                torch.from_numpy(kernel.T.copy())
    sd.update(_shared_mlp(p["point_features"], s["point_features"],
                          f"{where}/point_features",
                          f"{prefix}.point_features"))
    return sd


def pvconv_to_sd(p: Tree, s: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``PVConv`` params + batch_stats -> port ``PVConv`` state_dict."""
    return {k[len("pvconv."):]: v
            for k, v in _pvconv(p, s, "pvconv", "pvconv").items()}


def context_net_to_sd(p: Tree, s: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``ContextNet`` params + batch_stats -> port ``ContextNet``
    state_dict (the inverse of pcfm/interop/torch_ckpt.py
    context_net_from_sd)."""
    sd = {}
    for name in ("t_proj", "c_proj"):
        sd.update(_dense(p[name], name, name))
    sd.update(_conv1d(p["head_pre"], "head_pre", "head_pre"))
    sd.update(_conv1d(p["head_out"], "head_out", "head_out"))
    width = sd["head_pre.weight"].shape[0]
    sd.update(_norm_layer(p.get("head_norm"), s.get("head_norm", {}),
                          "head_norm", "head_norm", width))
    if "ctx_from_emb" in p:
        sd.update(_dense(p["ctx_from_emb"], "ctx_from_emb",
                         "ctx_from_emb.0"))
    if "global_0" in p:
        sd.update(_dense(p["global_0"], "global_0", "global_mlp.0"))
        sd.update(_dense(p["global_1"], "global_1", "global_mlp.2"))
    stages = sorted(int(k.split("_")[1]) for k in p
                    if k.startswith("stage_"))
    for si in stages:
        sp, ss = p[f"stage_{si}"], s[f"stage_{si}"]
        pre = f"stages.{si}"
        sd.update(_shared_mlp(sp["proj"], ss["proj"], f"stage_{si}/proj",
                              f"{pre}.proj"))
        for bi in _blocks(sp):
            bp, bs = sp[f"block_{bi}"], ss[f"block_{bi}"]
            where, b = f"stage_{si}/block_{bi}", f"{pre}.blocks.{bi}"
            sd.update(_pvconv(bp["pvconv"], bs["pvconv"], f"{where}/pvconv",
                              f"{b}.pvconv"))
            sd.update(_shared_mlp(bp["post"], bs["post"], f"{where}/post",
                                  f"{b}.post"))
            sd.update(_dense(bp["film"]["affine"], f"{where}/film/affine",
                             f"{b}.film.affine"))
            width = sd[f"{b}.post.layers.0.weight"].shape[0]
            sd.update(_norm_layer(bp["film"].get("norm"),
                                  bs.get("film", {}).get("norm", {}),
                                  f"{where}/film/norm", f"{b}.film.norm",
                                  width))
    return sd


def hybrid_to_sd(p: Tree, s: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``HybridMLP`` params {ctx_net, head} + batch_stats {ctx_net} ->
    port ``HybridMLP`` state_dict, keyed like the reference's
    (``ctx_net.*``, ``head.*``); the inverse of
    pcfm/interop/torch_ckpt.py:hybrid_from_sd.  Conv biases are written as
    0, the JAX running means as they are."""
    sd = {f"ctx_net.{k}": v for k, v in
          context_net_to_sd(p["ctx_net"], s["ctx_net"]).items()}
    sd.update({f"head.{k}": v
               for k, v in velocity_net_to_sd(p["head"]).items()})
    return sd


def adversary_to_sd(p: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``CondAdversary`` params -> port ``CondAdversary`` state_dict
    (the same names: ``dense_{i}``, ``out``)."""
    sd = {}
    for name in p:
        sd.update(_dense(p[name], name, name))
    return sd


# ------------------------------------------------------------ PointNet++

def _pointnet_mlps(p: Tree, s: Tree, where: str, dim: int
                   ) -> Dict[str, torch.Tensor]:
    sd = {}
    for i in sorted(int(k.split("_")[1]) for k in p if k.startswith("mlp_")):
        sd.update(_shared_mlp(p[f"mlp_{i}"], s[f"mlp_{i}"],
                              f"{where}/mlp_{i}", f"mlps.{i}", dim))
    return sd


def pointnet_a_to_sd(p: Tree, s: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``PointNetAModule`` params + batch_stats -> port state_dict
    (``mlps.{i}``: the reference's Conv1d SharedMLPs)."""
    return _pointnet_mlps(p, s, "pointnet_a", 1)


def pointnet_sa_to_sd(p: Tree, s: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``PointNetSAModule`` params + batch_stats -> port state_dict
    (``mlps.{i}``: the reference's Conv2d SharedMLPs, one a radius)."""
    return _pointnet_mlps(p, s, "pointnet_sa", 2)


def pointnet_fp_to_sd(p: Tree, s: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``PointNetFPModule`` params + batch_stats -> port state_dict
    (``mlp``: the reference's Conv1d SharedMLP)."""
    return _shared_mlp(p["mlp"], s["mlp"], "pointnet_fp/mlp", "mlp", 1)


# ------------------------------------------------ reference checkpoints
#
# The counterpart of pcfm/interop/torch_ckpt.py:263-372.  The port keeps
# the reference's state_dict names and checkpoint format, so
# ``checkpoint.load`` reads a reference ``hybrid_epNNNN.pt`` as it reads a
# port run (its variants normalised, every tensor checked against the
# modules its Config builds); importing adds the optimizer state and
# writes a port run.


def _group_params(bundle) -> Dict[str, list]:
    """{group: [(name, parameter, trainable)]} in module order, the groups
    of ``make_optimizer``."""
    from pcfm_torch.train.state import GROUP_LR, trainable_parameters
    out = {}
    for g in GROUP_LR:
        module = getattr(bundle, g)
        if module is not None:
            live = {id(p) for p in trainable_parameters(module)}
            out[g] = [(n, p, id(p) in live)
                      for n, p in module.named_parameters()]
    return out


def adamw_state_dict(bundle, moments: Dict[str, Tree], step: int) -> Tree:
    """The state_dict of ``make_optimizer(bundle)`` carrying AdamW moments:
    ``moments[group][name] = (exp_avg, exp_avg_sq)`` for every trainable
    parameter of each group (the dead conv biases have none), and ``step``
    as each parameter's step (torch counts it as optax counts ``count``)."""
    from pcfm_torch.train.state import make_optimizer
    opt = make_optimizer(bundle)
    sd = opt.state_dict()
    state, idx = {}, 0
    for g, params in _group_params(bundle).items():
        have = moments.get(g, {})
        for name, p, trainable in params:
            if not trainable:
                continue
            if name not in have:
                raise ValueError(f"no moments for {g}/{name}")
            m, v = (torch.as_tensor(x, dtype=torch.float32).reshape(p.shape)
                    for x in have[name])
            state[idx] = {"step": torch.tensor(float(step)),
                          "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
            idx += 1
    if idx != sum(len(g["params"]) for g in sd["param_groups"]):
        raise ValueError("moments do not cover the optimizer's parameters")
    sd["state"] = state
    return sd


# the checkpoint key of each optimizer group's module
GROUP_CKPT_KEY = {"enc": "encoder", "pf": "pf", "lf": "lf", "adv": "adv"}


def reference_adamw_state(bundle, ckpt: Tree) -> Optional[Tree]:
    """The reference optimizer's state (torch AdamW, groups enc / pf / lf,
    train.py:249-253) in the port's layout, or None where it does not
    fit.  A group's ids follow its module's ``parameters()`` order in the
    reference, which is the order of the parameters in the checkpoint's
    own state_dict of that module (torch lists both module by module), so
    each id is matched to a parameter by name, whatever order the port
    registers them in.  The reference's groups hold every parameter, the
    dead conv biases too; their moments are dropped, as the port's AdamW
    holds none."""
    ref_opt = ckpt.get("opt") or {}
    groups = ref_opt.get("param_groups") or []
    params = _group_params(bundle)
    if not groups or len(groups) != len(params):
        return None
    moments = {}
    for (g, plist), group in zip(params.items(), groups):
        by_name = {name: (p, trainable) for name, p, trainable in plist}
        order = [k for k in ckpt[GROUP_CKPT_KEY[g]] if k in by_name]
        ids = list(group["params"])
        if len(ids) != len(order):
            return None
        pairs = [(n, i) for n, i in zip(order, ids) if by_name[n][1]]
        moments[g] = {}
        for name, i in pairs:
            st = ref_opt.get("state", {}).get(i)
            if st is None or "exp_avg" not in st:
                return None
            if tuple(st["exp_avg"].shape) != tuple(by_name[name][0].shape):
                return None
            moments[g][name] = (st["exp_avg"], st["exp_avg_sq"])
    steps = {float(st["step"]) for st in ref_opt["state"].values()
             if "step" in st}
    if len(steps) != 1:
        return None
    return adamw_state_dict(bundle, moments, int(steps.pop()))


def import_reference_checkpoint(path: str, out_dir: str, device="cuda",
                                **cfg_overrides):
    """Load a reference ``hybrid_epNNNN.pt`` with ``checkpoint.load`` and
    write a port run under ``{out_dir}/ckpts/hybrid_ep{epoch:04d}.pt``
    that the port's train (auto-resume), sample, eval and distill CLIs
    load as it is: the modules built on ``device`` and checked, the EMA
    shadows, ``global_step``, ``epoch`` and the optimizer state (where it
    fits).  Returns (checkpoint path, Config)."""
    from pcfm_torch.device import resolve_device
    from pcfm_torch.train import checkpoint

    cfg, bundle, ckpt = checkpoint.load(
        path, resolve_device(device), {"out_dir": out_dir, **cfg_overrides})
    saved = checkpoint.save(out_dir, int(ckpt.get("epoch", 0) or 0), bundle,
                            global_step=int(ckpt.get("global_step", 0)
                                            or 0),
                            opt=reference_adamw_state(bundle, ckpt))
    return saved, cfg


def main(argv=None):
    """``python -m pcfm_torch.interop ref.pt --out_dir D``: the options of
    ``python -m pcfm.interop`` (pcfm/interop/__main__.py) plus
    ``--device``."""
    import argparse

    from pcfm_torch.device import DEVICES
    ap = argparse.ArgumentParser(
        description="Import a reference PyTorch checkpoint into a "
        "pcfm_torch run")
    ap.add_argument("ckpt", help="path to hybrid_epNNNN.pt")
    ap.add_argument("--out_dir", required=True,
                    help="pcfm_torch run dir to write ckpts/ under")
    ap.add_argument("--ctx_dtype", default="fp32", choices=["fp32", "bf16"],
                    help="ContextNet island precision for the continued "
                    "run (fp32 = exact reference semantics)")
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="where the modules are built and checked")
    args = ap.parse_args(argv)
    path, cfg = import_reference_checkpoint(
        args.ckpt, args.out_dir, device=args.device,
        ctx_dtype=args.ctx_dtype)
    with_opt = "opt" in torch.load(path, map_location="cpu",
                                   weights_only=True, mmap=True)
    print(f"[interop] wrote {path}")
    print(f"[interop] backbone={cfg.pf_backbone} cond_dim={cfg.cond_dim} "
          f"point_dim={cfg.pf_point_dim} latent_dim={cfg.latent_dim} "
          f"ctx_dtype={cfg.ctx_dtype} optimizer state "
          f"{'carried' if with_opt else 'not carried (fresh on resume)'}")
    return path, cfg


if __name__ == "__main__":
    main()
