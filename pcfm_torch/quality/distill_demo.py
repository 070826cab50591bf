"""Distillation quality demo, the port's counterpart of
scripts/distill_demo.py: train a small mlp flow on the synthetic
articulated set through the training loop, distill its point flow
progressively 32 -> 16 -> 8 -> 4 Euler steps (three one-phase halvings of
400 optimizer steps), and compare the recon CD on a fixed 16-cloud test
batch at each NFE against the teacher's Heun x 32 and the undistilled
field's Euler at the same step count.

Every flag is the JAX script's environment knob of the same name,
lower-cased, with its default, plus ``--device`` (the card by default;
``--device cpu`` asks for the CPU).  The point flow runs the FiLM kernel
trunk, the recon CD the chamfer kernel.  Prints the table of
docs/distill.md and writes it, with the teacher's run, to OUT
(distill.json, distill.md, ckpts/).

    python -m pcfm_torch.quality.distill_demo --out docs/torch_quality/distill
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from pcfm_torch.config import Config
from pcfm_torch.data import DataLoader, get_datasets, to_model_batch
from pcfm_torch.device import resolve_device
from pcfm_torch.distill.progressive import distill_pf
from pcfm_torch.ops.chamfer import chamfer_l2
from pcfm_torch.quality.common import (add_device_flag, card, dump_json,
                                       generator_for)
from pcfm_torch.sample.integrators import euler_sample, heun_sample
from pcfm_torch.train import checkpoint as ckpt
from pcfm_torch.train.evaluate import eval_mode
from pcfm_torch.train.loop import device_prefetch, to_device, train

HALVINGS = 3
TEACHER_STEPS = 32
FIXED_CLOUDS = 16


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="progressive distillation: quality against NFE")
    p.add_argument("--out", type=str, default=os.path.join(
        tempfile.gettempdir(), "pcfm_distill_demo"))
    p.add_argument("--epochs", type=int, default=120)
    add_device_flag(p)
    return p


def make_config(args) -> Config:
    """scripts/distill_demo.py's Config, with the kernel trunk."""
    return Config(dataset_type="synthetic", pf_backbone="mlp",
                  latent_dim=32, enc_width=64, enc_depth=4, pf_width=128,
                  pf_depth=4, pf_emb_dim=64, lf_width=64, lf_depth=3,
                  lf_emb_dim=32, warmup_steps=50, amp=False,
                  epochs=args.epochs, save_every=args.epochs,
                  batch_size=16, tr_max_sample_points=512,
                  te_max_sample_points=512, num_workers=0, out_dir=args.out,
                  vis_count=1, geom_warmup_epochs=10,
                  cfg_drop_warmup_epochs=20, sample_steps=TEACHER_STEPS,
                  seed=5, fused_trunk="on")


def recon_cd(bundle, pf, batch, sampler, steps: int,
             prior_device=None) -> float:
    """Mean train-time CD of the fixed batch reconstructed from one prior
    (a generator seeded 7 on ``prior_device``, the batch's device by
    default, then moved there) by ``sampler`` x ``steps`` on the field
    ``pf``."""
    cfg = bundle.cfg
    pts = batch["pts"]
    enc_in = torch.cat([pts, batch["rgb"]], -1) \
        if cfg.enc_in_channels == 6 else pts
    with torch.no_grad(), eval_mode(bundle.enc, pf):
        z, _ = bundle.enc(enc_in)
        cond_full = torch.cat([z, batch["cond"].to(z.dtype)], 1)
        b, n = pts.shape[:2]
        where = pts.device if prior_device is None else prior_device
        x0 = torch.randn((b, n, cfg.pf_point_dim), device=where,
                         generator=generator_for(where, 7)).to(pts.device)
        x = sampler(pf, x0, steps, cond=cond_full)
    return float(chamfer_l2(x[..., :3].float(), pts).mean())


def fixed_batch(cfg: Config, device) -> dict:
    """The fixed test batch: the test split's first FIXED_CLOUDS clouds,
    on ``device``."""
    _, te_ds = get_datasets(cfg)
    return to_device(to_model_batch(next(iter(DataLoader(
        te_ds, FIXED_CLOUDS, shuffle=False, drop_last=True, seed=0,
        num_workers=0).epoch_batches(0))), train=False, has_rgb=True,
        cond_dim=cfg.cond_dim), device)


def teacher_rows(bundle, fixed, prior_device=None) -> list:
    """(sampler, recon CD) of the trained field: Heun x TEACHER_STEPS,
    then Euler at each halving's step count, undistilled."""
    rows = [(f"teacher heun x{TEACHER_STEPS} (NFE {2 * TEACHER_STEPS})",
             recon_cd(bundle, bundle.ema_pf, fixed, heun_sample,
                      TEACHER_STEPS, prior_device))]
    steps = TEACHER_STEPS
    for _ in range(HALVINGS):
        steps //= 2
        rows.append((f"UNdistilled euler x{steps} (NFE {steps})",
                     recon_cd(bundle, bundle.ema_pf, fixed, euler_sample,
                              steps, prior_device)))
    return rows


def main(argv: Optional[Sequence[str]] = None, overrides=None,
         steps_per_phase: int = 400, halvings: int = HALVINGS) -> dict:
    """Parse ``argv`` and run; returns {sampler: recon CD} and the times.
    ``overrides`` replaces Config fields, ``steps_per_phase`` the
    optimizer steps a halving and ``halvings`` their number (for callers
    that shrink the run, as the CPU tests do)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    where = card(device)
    print(f"[demo] device {device} ({where})", flush=True)
    t_all = time.time()
    cfg = make_config(args).replace(**(overrides or {}))
    print("[demo] training teacher...", flush=True)
    train(cfg, verbose=False, device=device)
    train_s = time.time() - t_all
    path, _ = ckpt.find_latest(args.out)
    cfg, bundle, _ = ckpt.load(path, device)

    tr_ds, _ = get_datasets(cfg)
    loader = DataLoader(tr_ds, cfg.batch_size, shuffle=True, drop_last=True,
                        seed=9, num_workers=0)
    fixed = fixed_batch(cfg, device)
    rows = teacher_rows(bundle, fixed)

    def batches(phase):
        def raw():
            e = 0
            while True:
                yield from loader.epoch_batches(1000 * phase + e)
                e += 1
        yield from device_prefetch(raw(), cfg, device)

    print("[demo] distilling...", flush=True)
    t_d = time.time()
    steps = TEACHER_STEPS
    for phase in range(halvings):
        student, student_ema, steps = distill_pf(
            bundle, batches, base_steps=steps, phases=1,
            steps_per_phase=steps_per_phase, lr=2e-4,
            generator=generator_for(device, phase), verbose=False)
        bundle.pf.load_state_dict(student.state_dict())
        bundle.ema_pf.load_state_dict(student_ema.state_dict())
        rows.append((f"distilled euler x{steps} (NFE {steps})",
                     recon_cd(bundle, bundle.ema_pf, fixed, euler_sample,
                              steps)))
    distill_s = time.time() - t_d

    table = dict(rows)
    out = {"recon_cd": table, "device": where, "epochs": args.epochs,
           "halvings": halvings, "steps_per_phase": steps_per_phase,
           "teacher_train_s": round(train_s, 1),
           "distill_s": round(distill_s, 1),
           "total_s": round(time.time() - t_all, 1)}
    lines = ["| sampler | recon CD |", "|---|---|"] + [
        f"| {k} | {v:.4f} |" for k, v in rows]
    print("\n".join(lines), flush=True)
    dump_json(os.path.join(args.out, "distill.json"), out)
    with open(os.path.join(args.out, "distill.md.tmp"), "w") as f:
        f.write(f"# Progressive distillation: quality against NFE\n\n"
                f"`python -m pcfm_torch.quality.distill_demo` on {where}: "
                f"mlp flow on the synthetic articulated set "
                f"({args.epochs} epochs), then {halvings} progressive "
                f"halvings ({steps_per_phase} optimizer steps each).  "
                f"Recon CD on a fixed {FIXED_CLOUDS}-cloud test batch:\n\n"
                + "\n".join(lines) + "\n")
    os.replace(os.path.join(args.out, "distill.md.tmp"),
               os.path.join(args.out, "distill.md"))
    return out


if __name__ == "__main__":
    main()
