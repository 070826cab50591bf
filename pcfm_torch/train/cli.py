"""Training CLI — the port's ``python -m pcfm_torch.train.cli``.

``build_parser`` is a copy of pcfm/train/cli.py's, with every flag, default
and choice of the JAX package's (the reference train.py flag surface plus
the documented-but-unregistered flags, SURVEY.md §5), and one flag of the
port's own: ``--device {cuda,cpu}``.  The run goes on the card unless
``--device cpu`` asks for the CPU; without CUDA and without that flag it
stops with an error that names the flag.

    python -m pcfm_torch.train.cli --dataset_type synthetic --epochs 1 \\
        --batch_size 8 --tr_max_sample_points 20000 --latent_dim 128 \\
        --fused_trunk on --out_dir runs/port

Data and point-axis parallel, one process per card (torchrun's
environment; ``--dp`` x ``--sp`` = the number of processes, and each data
shard loads ``--batch_size`` clouds):

    torchrun --nproc_per_node=8 -m pcfm_torch.train.cli --dp 8 ...
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from pcfm_torch.config import Config
from pcfm_torch.device import DEVICES
from pcfm_torch.parallel.distributed import (cleanup_distributed,
                                             init_distributed)


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(
        "pcfm FM training (MLP / HybridMLP point-flow)")

    def flag(name, **kw):
        p.add_argument(name, **kw)

    # ========== Data ==========
    flag("--dataset_type", type=str, default=d.dataset_type,
         choices=["tdcr_h5", "partnet_h5", "synthetic"])
    flag("--data_dir", type=str, default="")
    flag("--batch_size", type=int, default=d.batch_size)
    flag("--num_workers", type=int, default=d.num_workers)
    flag("--tr_max_sample_points", type=int, default=d.tr_max_sample_points)
    flag("--te_max_sample_points", type=int, default=d.te_max_sample_points)
    flag("--tdcr_use_norm", action="store_true", default=d.tdcr_use_norm)
    flag("--train_fraction", type=float, default=d.train_fraction)
    flag("--train_count", type=int, default=None)
    flag("--train_subset_seed", type=int, default=d.train_subset_seed)
    flag("--keep_anno", type=str, nargs="*", default=[])
    flag("--keep_anno_file", type=str, default="")
    flag("--keep_anno_splits", type=str, nargs="*", default=["train"])
    flag("--partnet_cond_policy", type=str, default=d.partnet_cond_policy,
         choices=["mode", "max"])
    flag("--partnet_exclude_outliers", action="store_true", default=False)
    flag("--partnet_report_file_train", type=str, default="")
    flag("--partnet_report_file_eval", type=str, default="")
    flag("--cond_mode", type=str, default=d.cond_mode)
    flag("--motor_enc", type=str, default=d.motor_enc)
    flag("--motor_mod2_offset_deg", type=float, default=0.0)
    flag("--motor_mod3_offset_deg", type=float, default=0.0)
    flag("--motor_max_pos", type=float, default=d.motor_max_pos)

    # ========== Backbone & Models ==========
    flag("--pf_backbone", type=str, default=d.pf_backbone,
         choices=["mlp", "hybrid"])
    flag("--latent_dim", type=int, default=d.latent_dim)
    flag("--enc_width", type=int, default=d.enc_width)
    flag("--enc_depth", type=int, default=d.enc_depth)
    flag("--pf_width", type=int, default=d.pf_width)
    flag("--pf_depth", type=int, default=d.pf_depth)
    flag("--pf_emb_dim", type=int, default=d.pf_emb_dim)
    flag("--cfg_drop_p", type=float, default=d.cfg_drop_p)
    flag("--lf_width", type=int, default=d.lf_width)
    flag("--lf_depth", type=int, default=d.lf_depth)
    flag("--lf_emb_dim", type=int, default=d.lf_emb_dim)
    flag("--ctx_dim", type=int, default=d.ctx_dim)
    flag("--ctx_emb_dim", type=int, default=d.ctx_emb_dim)
    flag("--ctx_stage_channels", type=int, nargs="+",
         default=list(d.ctx_stage_channels))
    flag("--ctx_stage_blocks", type=int, nargs="+",
         default=list(d.ctx_stage_blocks))
    flag("--ctx_stage_res", type=int, nargs="+",
         default=list(d.ctx_stage_res))
    flag("--ctx_with_se", action="store_true", default=d.ctx_with_se)
    flag("--ctx_norm", type=str, default=d.ctx_norm,
         choices=["group", "batch", "syncbn", "none"])
    flag("--ctx_gn_groups", type=int, default=d.ctx_gn_groups)
    flag("--ctx_with_global", action="store_true", default=d.ctx_with_global)
    flag("--ctx_voxel_normalize", action="store_true",
         default=d.ctx_voxel_normalize)
    flag("--use_rgb_in_latent", action="store_true",
         default=d.use_rgb_in_latent)
    flag("--pointflow_rgb", action="store_true", default=d.pointflow_rgb)

    # ========== Training ==========
    flag("--epochs", type=int, default=d.epochs)
    flag("--lr_enc", type=float, default=d.lr_enc)
    flag("--lr_pf", type=float, default=d.lr_pf)
    flag("--lr_lf", type=float, default=d.lr_lf)
    flag("--min_lr", type=float, default=d.min_lr)
    flag("--use_cosine_lr", action="store_true", default=d.use_cosine_lr)
    flag("--warmup_steps", type=int, default=d.warmup_steps)
    flag("--weight_decay", type=float, default=d.weight_decay)
    flag("--grad_clip_norm", type=float, default=d.grad_clip_norm)
    flag("--t_beta_a", type=float, default=d.t_beta_a)
    flag("--fm_coupling", type=str, default=d.fm_coupling,
         choices=["indep", "sliced_ot"],
         help="prior->data pairing: indep (reference) | sliced_ot "
              "(rank-pair along a random direction per step; "
              "density-aware, dp-only meshes)")
    flag("--geom_warmup_epochs", type=int, default=d.geom_warmup_epochs)
    flag("--cfg_drop_warmup_epochs", type=int,
         default=d.cfg_drop_warmup_epochs)

    # ========== FM priors ==========
    flag("--point_prior_std", type=float, default=d.point_prior_std)
    flag("--latent_prior_std", type=float, default=d.latent_prior_std)
    flag("--color_prior", type=str, default=d.color_prior,
         choices=["gauss", "uniform", "zeros"])
    flag("--color_prior_std", type=float, default=d.color_prior_std)
    flag("--ctx_t_gate_tau", type=float, default=d.ctx_t_gate_tau)
    flag("--ctx_t_gate_k", type=float, default=d.ctx_t_gate_k)

    # ========== Sampling / CFG / EMA ==========
    flag("--sample_steps", type=int, default=d.sample_steps)
    flag("--latent_sample_steps", type=int, default=d.latent_sample_steps,
         help="eval-time latent-flow NFE override (0 = sample_steps)")
    flag("--sampler", type=str, default=d.sampler,
         choices=["euler", "midpoint", "heun", "rk4", "dopri5"])
    flag("--guidance_scale", type=float, default=d.guidance_scale)
    flag("--eval_oversample", type=float, default=d.eval_oversample,
         help="eval-time density recipe: sample ceil(k*N) points, "
              "FPS-subsample to N (1.0 = off)")
    flag("--ema_decay", type=float, default=d.ema_decay)
    flag("--ema_eval", action="store_true", default=d.ema_eval)

    # ========== Loss ==========
    for name in ("point", "latent", "color", "emd", "pair", "var", "cov",
                 "zreg", "adv"):
        flag(f"--lambda_{name}", type=float,
             default=getattr(d, f"lambda_{name}"))

    # ========== System / I/O ==========
    flag("--out_dir", type=str, default=d.out_dir)
    flag("--save_every", type=int, default=d.save_every)
    flag("--keep_last_ckpts", type=int, default=d.keep_last_ckpts)
    flag("--async_save", action="store_true", default=d.async_save)
    flag("--no_async_save", dest="async_save", action="store_false")
    flag("--vis_count", type=int, default=d.vis_count)
    flag("--seed", type=int, default=d.seed)
    flag("--amp", action="store_true", default=d.amp)
    flag("--no_amp", dest="amp", action="store_false")
    flag("--use_bf16", action="store_true", default=d.use_bf16)
    flag("--voxel_backend", type=str, default=d.voxel_backend,
         choices=["auto", "xla", "sorted"])
    flag("--grid_bn", type=str, default=d.grid_bn,
         choices=["auto", "flax", "flat", "flat_bf16"])
    flag("--fused_trunk", type=str, default=d.fused_trunk,
         choices=["auto", "on", "off"])
    flag("--pf_film_every", type=int, default=d.pf_film_every,
         help="opt-in turbo trunk: FiLM every k-th block (1 = parity)")
    flag("--ctx_dtype", type=str, default=d.ctx_dtype,
         choices=["bf16", "fp32"])
    flag("--dp", type=int, default=d.dp)
    flag("--sp", type=int, default=d.sp)
    flag("--tensorboard", action="store_true", default=d.tensorboard)
    flag("--loader_backend", type=str, default=d.loader_backend,
         choices=["thread", "grain"])
    flag("--flat_optimizer", action="store_true", default=d.flat_optimizer)
    flag("--no_flat_optimizer", dest="flat_optimizer",
         action="store_false")
    # ========== The port's own flag ==========
    flag("--device", type=str, default="cuda", choices=DEVICES,
         help="where the run goes: the card (default; an error without "
              "CUDA) or, when asked, the CPU")
    return p


def _config(args: argparse.Namespace) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in known})


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    return _config(build_parser().parse_args(argv))


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """Parse ``argv`` and train.  ``device`` (a keyword for callers)
    overrides ``--device``.  Under torchrun the process joins the group
    first (``init_distributed``; a group the caller made is used as it
    is) and leaves it after."""
    from pcfm_torch.train.loop import train
    args = build_parser().parse_args(argv)
    cfg = _config(args)
    if cfg.dataset_type != "synthetic" and not cfg.data_dir:
        raise SystemExit("--data_dir is required for H5 datasets")
    device = device or args.device
    init_distributed(device)
    try:
        return train(cfg, device=device)
    finally:
        cleanup_distributed()


if __name__ == "__main__":
    main()
