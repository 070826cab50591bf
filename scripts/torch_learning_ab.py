#!/usr/bin/env python
"""One learning run's recipe trained twice side by side on the card: in
bf16 with the FiLM kernel trunk (the recipe as it runs) and in fp32 with
the plain trunk, TF32 off, from the same weights, on the same batches,
with the same draws at every step.  A recipe that misses its quality
target is narrowed with it: if the fp32 run reaches where bf16 does not,
the precision is at fault; if both land together, it is not.

``--recipe`` names a ``pcfm_torch.quality`` harness; the run takes that
harness's Config and data at its recorded settings (the LR schedule of
the whole run, RECIPES' epochs) and trains its first ``--epochs``
epochs.  Every ``--eval_every`` epochs and at the end it reads:

  * convergence_full: the EMA recon CD of its 8 test clouds (Heun x 25)
    for the bf16 model, the fp32 model, and the bf16-trained weights
    sampled by the fp32 plain model (``bf16_weights_fp32_sampling``),
    each from the same prior;
  * gen_quality: at the end only, the conditioned suite (MMD / COV /
    1-NNA, CD) of both models on the same priors.

Writes OUT/ab.json (a row an epoch: each run's mean losses over the
epoch, and the reads).  Imports nothing of JAX.

    python scripts/torch_learning_ab.py --recipe convergence_full \\
        --epochs 40 --eval_every 10 --out /tmp/ab_conv
"""
import argparse
import copy
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from pcfm_torch.device import DEVICES, resolve_device  # noqa: E402
from pcfm_torch.ops.chamfer import chamfer_l2  # noqa: E402
from pcfm_torch.quality import convergence_full, gen_quality  # noqa: E402
from pcfm_torch.quality.common import (EpochOrder, card,  # noqa: E402
                                       conditioned_suite, device_split,
                                       dump_json, gather_batch,
                                       generator_for)
from pcfm_torch.train.evaluate import make_recon_fn, make_sample_fn  # noqa: E402
from pcfm_torch.train.loop import epoch_scalars  # noqa: E402
from pcfm_torch.train.state import init_state  # noqa: E402
from pcfm_torch.train.step import make_draws, train_step  # noqa: E402

# each recipe's recorded settings (docs/torch_quality/README.md), with
# the whole run's epochs
RECIPES = {
    "convergence_full": (convergence_full, ["--epochs", "120"]),
    "gen_quality": (gen_quality, ["--epochs", "800", "--size", "200",
                                  "--test", "96", "--batch", "16",
                                  "--sample_steps", "50",
                                  "--guidance", "2.0"]),
}
NAMES = ("loss_point", "loss_latent")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", choices=sorted(RECIPES), required=True)
    p.add_argument("--epochs", type=int, required=True,
                   help="the epochs trained here, from the first")
    p.add_argument("--eval_every", type=int, default=0,
                   help="recon CD every this many epochs (0: at the end)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod, recipe_argv = RECIPES[args.recipe]
    rargs = mod.build_parser().parse_args(recipe_argv
                                          + ["--device", args.device])
    cfgs = {"bf16_kernel": mod.make_config(rargs)}
    cfgs["fp32_plain"] = cfgs["bf16_kernel"].replace(
        amp=False, fused_trunk="off", ctx_dtype="fp32")
    os.makedirs(args.out, exist_ok=True)
    size = rargs.size
    _, train = device_split("train", size, rargs.npts, device)
    order = EpochOrder(size, rargs.batch, device)
    total = rargs.epochs * order.steps
    states = {p: init_state(c, device, total,
                            torch.Generator().manual_seed(c.seed))
              for p, c in cfgs.items()}
    ref = states["bf16_kernel"].bundle.modules()
    for k, m in states["fp32_plain"].bundle.modules().items():
        m.load_state_dict(ref[k].state_dict())
    cfg = cfgs["bf16_kernel"]
    gen = generator_for(device, cfg.seed)
    if args.recipe == "convergence_full":
        _, test = device_split("test", convergence_full.TEST_CLOUDS,
                               rargs.npts, device)
        test = {k: v[:rargs.batch] for k, v in test.items()}
    else:
        _, test = device_split("test", rargs.test, rargs.npts, device)
    # the fp32 plain model that samples the bf16-trained weights
    cross = copy.deepcopy(states["fp32_plain"].bundle)

    def recon_cds(ep) -> dict:
        for k, m in cross.modules().items():
            m.load_state_dict(ref[k].state_dict())
        bundles = {p: st.bundle for p, st in states.items()}
        bundles["bf16_weights_fp32_sampling"] = cross
        out = {}
        for p, b in bundles.items():
            x = make_recon_fn(b)(test["pts"], test["rgb"], test["cond"],
                                 generator_for(device, 10_000_000 + ep))
            out[p] = float(chamfer_l2(x[..., :3].float(),
                                      test["pts"]).mean())
        return out

    def suites(ep) -> dict:
        return {p: conditioned_suite(make_sample_fn(st.bundle), test["cond"],
                                     test["pts"], rargs.batch, rargs.npts,
                                     900_000 + ep)[1]
                for p, st in states.items()}

    rows, t0 = [], time.time()
    result = {"recipe": args.recipe, "recipe_epochs": rargs.epochs,
              "epochs": args.epochs, "device": card(device), "rows": rows}
    for ep in range(1, args.epochs + 1):
        color_on, dp = epoch_scalars(cfg, ep)
        losses = {p: [] for p in states}
        for idx in order.next():
            batch = gather_batch(train, idx)
            draws = make_draws(cfg, batch, gen, dp)
            for p, st in states.items():
                m = train_step(st, batch, None, color_on, dp, draws=draws)
                losses[p].append(torch.stack([m[k] for k in NAMES]))
        row = {"epoch": ep, "elapsed_s": round(time.time() - t0, 1)}
        for p, ls in losses.items():
            mean = torch.stack(ls).mean(0).tolist()
            row[p] = dict(zip(NAMES, (round(v, 5) for v in mean)))
        last = ep == args.epochs
        if args.recipe == "convergence_full" and (
                last or (args.eval_every and ep % args.eval_every == 0)):
            row["recon_cd"] = recon_cds(ep)
        if args.recipe == "gen_quality" and last:
            row["suite_cd"] = suites(ep)
        rows.append(row)
        print(f"[ab] {row}", flush=True)
        dump_json(os.path.join(args.out, "ab.json"), result)
    result["total_s"] = round(time.time() - t0, 1)
    dump_json(os.path.join(args.out, "ab.json"), result)
    return result


if __name__ == "__main__":
    main()
