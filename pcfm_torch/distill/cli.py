"""Distillation CLI: progressive few-NFE distillation of a trained run —
port of pcfm/distill/cli.py with the same flags, plus ``--device``.

    python -m pcfm_torch.distill.cli --out_dir runs/hybrid --phases 3

loads the newest checkpoint under --out_dir, runs ``phases`` teacher
halvings on the run's training data, and saves
``{save_dir}/ckpts/hybrid_epNNNN.pt`` whose point flow (live and EMA) is
the distilled student, with ``sampler="euler"`` and the reduced
``sample_steps`` in its config, so the sampling and evaluation CLIs take
the fast path as they are.  The run goes on the card; ``--device cpu``
asks for the CPU, and without CUDA and without that flag it is an error.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from pcfm_torch.data import DataLoader, get_datasets
from pcfm_torch.device import DEVICES
from pcfm_torch.distill.progressive import distill_pf
from pcfm_torch.sample.cli import load_run
from pcfm_torch.train import checkpoint as ckpt
from pcfm_torch.train.loop import device_prefetch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("pcfm progressive distillation")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, default="",
                   help="default: {out_dir}_distilled")
    p.add_argument("--phases", type=int, default=3,
                   help="number of NFE halvings")
    p.add_argument("--steps_per_phase", type=int, default=400)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--guidance_scale", type=float, default=None,
                   help="distill the CFG-guided field at this scale "
                        "(default: the run's own guidance_scale); the "
                        "saved config gets guidance_scale=0 — the student "
                        "bakes the guidance in")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the run goes: the card (default; an error "
                        "without CUDA) or, when asked, the CPU")
    return p


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv``, distill, save.  Returns (save_dir, student steps)."""
    args = build_parser().parse_args(argv)
    cfg, bundle, ep = load_run(args.out_dir, {"batch_size": args.batch_size},
                               args.device)
    src_path, _ = ckpt.find_latest(args.out_dir)
    src = torch.load(src_path, map_location="cpu", weights_only=True)
    tr_ds, _ = get_datasets(cfg)
    loader = DataLoader(tr_ds, cfg.batch_size, shuffle=True, drop_last=True,
                        seed=cfg.seed + 1, num_workers=cfg.num_workers)

    def batches(phase: int):
        def raw():
            ep_i = 0
            while True:              # rewind for as long as the phase runs
                empty = True
                for b in loader.epoch_batches(1000 * phase + ep_i):
                    empty = False
                    yield b
                if empty:            # distill_pf names the empty phase
                    return
                ep_i += 1
        yield from device_prefetch(raw(), cfg, bundle.device)

    gscale = (cfg.guidance_scale if args.guidance_scale is None
              else args.guidance_scale)
    # an unguided distillation of a CFG-trained run keeps the run's
    # guidance_scale for sampling (new_cfg below), so the student's
    # unconditional branch stays supervised through cond dropout
    drop_p = (cfg.cfg_drop_p if (gscale == 0 and cfg.guidance_scale > 0)
              else 0.0)
    student, student_ema, steps = distill_pf(
        bundle, batches, base_steps=cfg.sample_steps, phases=args.phases,
        steps_per_phase=args.steps_per_phase, lr=args.lr,
        ema_decay=args.ema_decay,
        generator=torch.Generator(device=bundle.device).manual_seed(
            args.seed),
        guidance_scale=gscale, cond_drop_p=drop_p)

    # the student and its EMA carry the teacher's EMA running statistics
    # (distilled against them), so --no_ema_eval pairs the live student
    # with those same statistics
    bundle.pf.load_state_dict(student.state_dict())
    bundle.ema_pf.load_state_dict(student_ema.state_dict())
    # guidance baked into the student (gscale > 0): the config's scale is
    # zeroed so that sampling does not apply CFG a second time; an
    # unguided distillation of a guided run keeps the run's scale
    bundle.cfg = cfg.replace(sampler="euler", sample_steps=steps,
                             guidance_scale=(0.0 if gscale > 0
                                             else cfg.guidance_scale))
    save_dir = args.save_dir or (args.out_dir.rstrip("/") + "_distilled")
    # the run's optimizer state and step go with it, as the JAX CLI saves
    # the run's state
    ckpt.save(save_dir, ep, bundle,
              global_step=int(src.get("global_step", 0) or 0),
              opt=src.get("opt"))
    # the actual reduction (steps clamp at 1); evaluations a step by
    # sampler: euler / midpoint 1, heun 2, rk4 4
    teacher_evals = {"heun": 2, "rk4": 4}.get(cfg.sampler, 1) \
        * cfg.sample_steps
    factor = max(1, teacher_evals // max(1, steps))
    print(f"[distill] saved distilled checkpoint (euler x{steps}, "
          f"{factor}x fewer NFE) to {save_dir}")
    return save_dir, steps


if __name__ == "__main__":
    main()
