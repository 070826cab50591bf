"""Generative-quality run, the port's counterpart of
scripts/gen_quality_tpu.py: the hybrid backbone at 2048 RGB points with
the 1-D joint condition, trained on a device-resident synthetic split
while the MMD / COV / 1-NNA suite is evaluated on conditioned samples
(one generated cloud per test cloud, with its condition: the eval CLI's
suite protocol) every ``--eval_every`` epochs.  The run stops early once
the suite reaches ``--nna_target`` and ``--cov_target``, or when its time
budget is spent; then a final suite over ``--final_seeds`` (CD and EMD
variants), an optional sweep of sampling recipes, and sample PLYs.

Every flag is the JAX script's environment knob of the same name,
lower-cased, with its default, plus ``--device`` (the card by default;
``--device cpu`` asks for the CPU).  The point-flow head runs the FiLM
kernel trunk (``fused_trunk="on"``), the ContextNet the voxel kernels.
Writes OUT/history.json (a row an epoch), OUT/final_suite.json,
OUT/guidance_sweep.json (with a sweep), OUT/state_latest.pt (the train
state, for ``--resume``), gen_final.npy and gen_*.ply / ref_*.ply.

    python -m pcfm_torch.quality.gen_quality --epochs 800 --eval_every 100 \\
        --test 96 --sample_steps 50 --guidance 2.0 --final_seeds 101 \\
        --out docs/torch_quality/genq
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from pcfm_torch.config import Config
from pcfm_torch.data.ply import save_point_cloud_ply_rgb
from pcfm_torch.device import resolve_device
from pcfm_torch.quality.common import (EpochOrder, add_device_flag, card,
                                       conditioned_suite, device_split,
                                       dump_json, generator_for, seed_band,
                                       seeds, train_epoch)
from pcfm_torch.train.evaluate import make_sample_fn
from pcfm_torch.train.loop import epoch_scalars
from pcfm_torch.train.state import init_state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="hybrid generative-quality run (MMD / COV / 1-NNA)")
    a = p.add_argument
    a("--epochs", type=int, default=400)
    a("--eval_every", type=int, default=25)
    a("--save_every", type=int, default=0,
      help="state save interval in epochs (0: --eval_every)")
    a("--size", type=int, default=200, help="train clouds")
    a("--test", type=int, default=192, help="reference (test) clouds")
    a("--npts", type=int, default=2048)
    a("--batch", type=int, default=16)
    a("--out", type=str,
      default=os.path.join(tempfile.gettempdir(), "pcfm_gen_quality"))
    a("--budget_s", type=float, default=1500,
      help="stop training after this many seconds")
    a("--guidance_sweep", type=str, default="",
      help="comma-separated guidance scales swept after training")
    a("--recipes", type=str, default="[]",
      help="JSON list of {guidance, steps, oversample, latent_std, "
           "latent_steps} sampling recipes swept after training")
    a("--nna_target", type=float, default=0.70)
    a("--cov_target", type=float, default=0.45)
    a("--final_seeds", type=str, default="101,202,303")
    a("--sweep_seeds", type=str, default="101,202,303")
    a("--resume", type=str, default="",
      help="a state_latest.pt of an identically configured run")
    a("--resume_epoch", type=int, default=0,
      help="the epoch of a resumed state that records none")
    a("--final_save", type=int, default=1,
      help="0: no state save after a budget stop")
    a("--ctx_res", type=str, default="32,16,8")
    a("--ctx_ch", type=str, default="128,256,256")
    a("--ctx_blocks", type=str, default="2,2,2")
    a("--latent", type=int, default=64)
    a("--pf_width", type=int, default=512)
    a("--pf_depth", type=int, default=6)
    a("--ctx_dim", type=int, default=64)
    a("--geom_warmup", type=int, default=20)
    a("--sample_steps", type=int, default=25)
    a("--guidance", type=float, default=0.0)
    a("--t_beta_a", type=float, default=2.0)
    a("--fm_coupling", type=str, default="indep")
    a("--prior_std", type=float, default=1.0)
    a("--lambda_emd", type=float, default=0.0)
    a("--lr", type=float, default=3e-4)
    a("--cosine", type=int, default=1)
    add_device_flag(p)
    return p


def make_config(args) -> Config:
    """scripts/gen_quality_tpu.py's Config, with the kernel trunk."""
    ints = lambda s: [int(x) for x in s.split(",")]  # noqa: E731
    return Config(pf_backbone="hybrid", latent_dim=args.latent,
                  has_rgb=True, pf_width=args.pf_width,
                  pf_depth=args.pf_depth, ctx_dim=args.ctx_dim,
                  cond_dim=1, pointflow_rgb=True, use_rgb_in_latent=True,
                  amp=True, use_bf16=True, tr_max_sample_points=args.npts,
                  batch_size=args.batch, epochs=args.epochs,
                  warmup_steps=200, geom_warmup_epochs=args.geom_warmup,
                  cfg_drop_warmup_epochs=40,
                  ctx_stage_res=ints(args.ctx_res),
                  ctx_stage_channels=ints(args.ctx_ch),
                  ctx_stage_blocks=ints(args.ctx_blocks),
                  sampler="heun", sample_steps=args.sample_steps,
                  guidance_scale=args.guidance, t_beta_a=args.t_beta_a,
                  fm_coupling=args.fm_coupling,
                  point_prior_std=args.prior_std,
                  lambda_emd=args.lambda_emd, lr_enc=args.lr,
                  lr_pf=args.lr, lr_lf=args.lr,
                  use_cosine_lr=args.cosine != 0, seed=7,
                  fused_trunk="on")


def save_state(path: str, state, cfg: Config, order: EpochOrder,
               gen: torch.Generator, epoch: int, gstep: int,
               extra: dict) -> None:
    """The train state (modules, optimizer, the two generators' states,
    epoch, step) for ``--resume``, written atomically."""
    blob = {"modules": {k: m.state_dict()
                        for k, m in state.bundle.modules().items()},
            "opt": state.opt.state_dict(), "epoch": epoch, "gstep": gstep,
            "cfg": dataclasses.asdict(cfg),
            "order_rng": order.gen.get_state(), "step_rng": gen.get_state(),
            **extra}
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_state(path: str, state, cfg: Config, order: EpochOrder,
               gen: torch.Generator, log) -> tuple:
    """Resume from ``save_state``'s file (weights load strictly: a
    differently configured run fails loudly); returns (epoch, step)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    mine = dataclasses.asdict(cfg)
    diff = {k: (v, mine.get(k)) for k, v in blob["cfg"].items()
            if mine.get(k) != v}
    if diff:
        log(f"WARNING resume cfg diff: {diff}")
    for k, m in state.bundle.modules().items():
        m.load_state_dict(blob["modules"][k])
    state.opt.load_state_dict(blob["opt"])
    order.gen.set_state(blob["order_rng"])
    gen.set_state(blob["step_rng"])
    state.step = int(blob["gstep"])
    return int(blob.get("epoch", 0)), int(blob["gstep"])


def main(argv: Optional[Sequence[str]] = None, overrides=None) -> dict:
    """Parse ``argv`` and run; returns the final result dict.
    ``overrides`` replaces Config fields (for callers that shrink the
    model, as the CPU tests do)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    def log(msg):
        print(f"[genq] {msg}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    t_all = time.time()
    cfg = make_config(args).replace(**(overrides or {}))
    where = card(device)
    log(f"device {device} ({where})")
    _, train = device_split("train", args.size, args.npts, device)
    ds_te, test = device_split("test", args.test, args.npts, device)
    log(f"data on device: {args.size}x{args.npts} pts, test ref {args.test}")

    order = EpochOrder(args.size, args.batch, device)
    steps_per_epoch = order.steps
    state = init_state(cfg, device, args.epochs * steps_per_epoch,
                       torch.Generator().manual_seed(cfg.seed))
    gen = generator_for(device, cfg.seed)
    bundle = state.bundle
    sample = make_sample_fn(bundle)          # latent Heun -> point Heun

    def run_suite(ep, sample_fn=None, metrics=("cd",)):
        return conditioned_suite(sample_fn or sample, test["cond"],
                                 test["pts"], args.batch, args.npts,
                                 77_000 + ep, metrics)

    def band(seed_list, sample_fn=None, metrics=("cd",), tag=0):
        return seed_band(lambda s: run_suite(s, sample_fn, metrics),
                         seed_list, tag, log)

    path = os.path.join(args.out, "state_latest.pt")
    hist, gstep, start_ep = [], 0, 1
    save_every = args.save_every or args.eval_every
    if args.resume:
        res_ep, gstep = load_state(args.resume, state, cfg, order, gen, log)
        start_ep = (res_ep or args.resume_epoch) + 1
        hist_path = os.path.join(args.out, "history.json")
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                hist = json.load(f)[:start_ep - 1]
        log(f"resumed {args.resume} at epoch {start_ep} (gstep {gstep})")
    extra = {"size": args.size, "test": args.test, "npts": args.npts,
             "batch": args.batch}
    done, ep, last_save_ep = False, start_ep - 1, -1
    t0 = time.time()
    for ep in range(start_ep, args.epochs + 1):
        color_on, dp = epoch_scalars(cfg, ep)
        te = time.time()
        row = train_epoch(state, train, order.next(), gen, color_on, dp,
                          ("loss_point", "loss_latent", "loss_emd"))
        epoch_s = time.time() - te
        gstep += steps_per_epoch
        row = {"epoch": ep, "loss_point": round(row["loss_point"], 4),
               "loss_latent": round(row["loss_latent"], 4),
               **({"loss_emd": round(row["loss_emd"], 4)}
                  if cfg.lambda_emd > 0 else {}),
               "ms_per_step": round(epoch_s * 1e3 / steps_per_epoch, 3),
               "elapsed_s": round(time.time() - t0, 1)}
        if ep % args.eval_every == 0 or ep == args.epochs:
            ts = time.time()
            _, suite = run_suite(ep)
            row.update({k: round(float(v), 4) for k, v in suite.items()})
            row["suite_s"] = round(time.time() - ts, 1)
            done = (suite.get("nna_cd", 1.0) <= args.nna_target
                    and suite.get("cov_cd", 0.0) >= args.cov_target)
        if ep % save_every == 0 or ep == args.epochs or done:
            save_state(path, state, cfg, order, gen, ep, gstep, extra)
            last_save_ep = ep
        hist.append(row)
        log(str(row))
        dump_json(os.path.join(args.out, "history.json"), hist)
        if done or time.time() - t_all > args.budget_s:
            if not done:
                log("budget out")
            break
    train_s = time.time() - t0
    if ep >= start_ep and last_save_ep != ep and args.final_save != 0:
        save_state(path, state, cfg, order, gen, ep, gstep, extra)

    final_seeds = seeds(args.final_seeds)
    protocol = {"test_clouds": args.test, "train_clouds": args.size,
                "npts": args.npts, "batch": args.batch, "seeds": final_seeds,
                "sampler": cfg.sampler, "sample_steps": cfg.sample_steps,
                "guidance": cfg.guidance_scale, "epochs_run": ep,
                "target_met_in_loop": done}
    result = {"protocol": protocol, "device": where,
              "train_s": round(train_s, 1)}
    if not final_seeds:
        log("final_seeds empty: skipping the final protocol")
        result["total_s"] = round(time.time() - t_all, 1)
        dump_json(os.path.join(args.out, "final_suite.json"), result)
        return result
    log(f"final band over seeds {final_seeds} (cd+emd):")
    rows, agg = band(final_seeds, metrics=("cd", "emd"), tag=0)
    log(f"final agg: {agg}")
    gen_x, _ = run_suite(900_000 + final_seeds[0])        # PLY / npy dump
    result.update({"default": agg, "default_per_seed": rows})
    dump_json(os.path.join(args.out, "final_suite.json"), result)

    recipes = ([{"guidance": float(g)} for g in args.guidance_sweep.split(",")
                if g.strip()] + list(json.loads(args.recipes)))
    if recipes:
        def recipe_sample(r):
            b = copy.copy(bundle)
            b.cfg = cfg.replace(
                guidance_scale=float(r.get("guidance", cfg.guidance_scale)),
                sample_steps=int(r.get("steps", cfg.sample_steps)),
                eval_oversample=float(r.get("oversample", 1.0)),
                latent_prior_std=float(r.get("latent_std",
                                             cfg.latent_prior_std)),
                latent_sample_steps=int(r.get("latent_steps", 0)))
            return make_sample_fn(b)

        sweep_seeds = seeds(args.sweep_seeds)
        if sweep_seeds == final_seeds:
            base_mean = agg["nna_cd"]["mean"]
        else:                   # select within one protocol's seeds
            _, base = band(sweep_seeds, metrics=("cd",), tag=998)
            base_mean = base["nna_cd"]["mean"]
        sweep, best_r, best_mean = [], None, base_mean
        for i, r in enumerate(recipes):
            rows_r, agg_r = band(sweep_seeds, recipe_sample(r),
                                 ("cd", "emd"), tag=i + 1)
            sweep.append({"recipe": r, "agg": agg_r, "per_seed": rows_r})
            log(f"sweep {r}: {agg_r}")
            dump_json(os.path.join(args.out, "guidance_sweep.json"), sweep)
            if agg_r["nna_cd"]["mean"] < best_mean:
                best_r, best_mean = r, agg_r["nna_cd"]["mean"]
        by_emd = min(sweep, key=lambda e: e["agg"]["nna_emd"]["mean"])
        result.update({"best_emd_recipe": by_emd["recipe"],
                       "best_emd_agg": by_emd["agg"]})
        if best_r is not None:
            rows_b, agg_b = band(final_seeds, recipe_sample(best_r),
                                 ("cd", "emd"), tag=999)
            result.update({"best_recipe": best_r,
                           "best_guidance": best_r.get("guidance",
                                                       cfg.guidance_scale),
                           "best": agg_b, "best_per_seed": rows_b})
            log(f"best band ({best_r}): {agg_b}")
            gen_x, _ = run_suite(900_000 + final_seeds[0],
                                 recipe_sample(best_r))
    gen_np = gen_x.cpu().numpy()
    np.save(os.path.join(args.out, "gen_final.npy"), gen_np)
    for i in range(min(4, len(gen_np))):
        save_point_cloud_ply_rgb(gen_np[i], np.full_like(gen_np[i], 0.6),
                                 os.path.join(args.out, f"gen_{i}.ply"))
        save_point_cloud_ply_rgb(ds_te.clouds[i], ds_te.rgbs[i],
                                 os.path.join(args.out, f"ref_{i}.ply"))
    result["total_s"] = round(time.time() - t_all, 1)
    dump_json(os.path.join(args.out, "final_suite.json"), result)
    log(f"total {result['total_s']:.0f}s; history + PLYs in {args.out}")
    return result


if __name__ == "__main__":
    main()
