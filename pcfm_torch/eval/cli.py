"""Evaluation CLI: CD / EMD / F-score of a trained model on its test set,
and the MMD / COV / 1-NNA suite — port of pcfm/eval/cli.py with the same
flags, plus ``--device {cuda,cpu}`` (the card by default; without CUDA
and without ``--device cpu`` it is an error).

Protocols, over the whole test split (the ragged tail batch is padded to
the run's batch size and its padded rows dropped from the metrics):
  * recon — z = enc(GT), point flow from the prior, metrics vs GT
  * gen   — latent-flow z, point flow, metrics vs the GT batch
  * suite — one generated cloud per test cloud (same conditions), then
            MMD / COV / 1-NNA (``--suite_emd`` adds the EMD variants;
            ``--suite_seeds`` repeats the generation per seed and reports
            a mean / min / max band)

The random draws of a batch (priors, EMD subsample) come from a
``torch.Generator`` seeded by ``--seed`` (or the suite seed), the mode and
the batch index, so a seed fixes a run.  They are not the JAX package's
draws (its key splits have no torch counterpart), so the metrics match the
JAX CLI's in distribution, not value by value.  One JSON line with the JAX
CLI's keys is printed and returned.

    python -m pcfm_torch.eval.cli --out_dir RUN --mode both
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from pcfm_torch.data import DataLoader, get_datasets
from pcfm_torch.device import DEVICES
from pcfm_torch.eval.metrics import (aggregate, cloud_metrics,
                                     generative_metrics)
from pcfm_torch.sample.cli import load_run
from pcfm_torch.train.evaluate import make_recon_fn, make_sample_fn

# the seed streams of the three protocols
STREAMS = {"recon": 0, "gen": 1, "suite": 2}


def pad_batch(arr: Optional[torch.Tensor],
              full: int) -> Optional[torch.Tensor]:
    """Pad a ragged tail batch to the full batch size by repeating the last
    row; callers slice results back to the true count."""
    if arr is None or arr.shape[0] == full:
        return arr
    pad = arr[-1:].expand(full - arr.shape[0], *arr.shape[1:])
    return torch.cat([arr, pad], dim=0)


def batch_generator(device, seed: int, mode: str,
                    batch: int) -> torch.Generator:
    """The draws of one batch: a generator on ``device`` seeded from
    (seed, protocol, batch index)."""
    state = np.random.SeedSequence([seed, STREAMS[mode], batch])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("pcfm_torch evaluation")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--mode", type=str, default="both",
                   choices=["recon", "gen", "both", "suite"])
    p.add_argument("--suite_size", type=int, default=0,
                   help="suite mode: clouds per set (0 = whole test set)")
    p.add_argument("--suite_emd", action="store_true",
                   help="suite mode: also compute MMD/COV/1-NNA under EMD")
    p.add_argument("--suite_seeds", type=str, default="",
                   help="suite mode: comma-separated seeds; with >1 the "
                        "suite is resampled per seed and reported as a "
                        "per-metric mean/min/max band; empty = single "
                        "pass at --seed")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_batches", type=int, default=0,
                   help="0 = whole test set")
    p.add_argument("--sample_steps", type=int, default=None)
    p.add_argument("--latent_sample_steps", type=int, default=None,
                   help="latent-flow NFE override (0 = sample_steps)")
    p.add_argument("--sampler", type=str, default=None)
    p.add_argument("--guidance_scale", type=float, default=None)
    p.add_argument("--eval_oversample", type=float, default=None,
                   help="density recipe: sample ceil(k*N) points per cloud "
                        "and FPS-subsample to N (1.0 = off)")
    p.add_argument("--latent_prior_std", type=float, default=None,
                   help="latent prior std override (diversity knob)")
    p.add_argument("--emd_max_points", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the run goes: the card (default; an error "
                        "without CUDA) or, when asked, the CPU")
    return p


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """Parse ``argv``, evaluate, print and return the JSON line.
    ``device`` (a keyword for callers) overrides ``--device``."""
    args = build_parser().parse_args(argv)
    over = {k: getattr(args, k) for k in
            ("data_dir", "batch_size", "sample_steps", "latent_sample_steps",
             "sampler", "guidance_scale", "eval_oversample",
             "latent_prior_std")}
    cfg, bundle, ep = load_run(args.out_dir, over, device or args.device)
    dev = bundle.device
    # eval_only: the restored run's cond_dim / has_rgb stay authoritative
    _, te_ds = get_datasets(cfg, eval_only=True)
    # drop_last=False: the tail batch is padded, so every cloud is evaluated
    loader = DataLoader(te_ds, cfg.batch_size, shuffle=False,
                        drop_last=False, seed=cfg.seed, num_workers=2)
    recon_fn = make_recon_fn(bundle)
    sample_fn = make_sample_fn(bundle)

    def tensor(x):
        return None if x is None else torch.from_numpy(
            np.asarray(x, np.float32)).to(dev)

    def batches():
        for bi, batch in enumerate(loader.epoch_batches(0)):
            if args.max_batches and bi >= args.max_batches:
                return
            yield bi, batch

    if args.mode == "suite":
        metrics = ("cd", "emd") if args.suite_emd else ("cd",)

        def run_suite(seed: int):
            refs, gens = [], []
            for bi, batch in batches():
                pts = tensor(batch["test_points"])
                gen = batch_generator(dev, seed, "suite", bi)
                x = sample_fn(pad_batch(tensor(batch.get("cond")),
                                        cfg.batch_size),
                              gen, cfg.batch_size, pts.shape[1])
                refs.append(pts)
                gens.append(x[:pts.shape[0], :, :3])
                if args.suite_size and sum(r.shape[0] for r in refs) >= \
                        args.suite_size:
                    break
            ref = torch.cat(refs)[:args.suite_size or None]
            gen = torch.cat(gens)[:args.suite_size or None]
            return ref.shape[0], generative_metrics(gen, ref,
                                                    metrics=metrics)

        seeds = [int(s) for s in args.suite_seeds.split(",") if s.strip()]
        out = {"epoch": ep, "sampler": cfg.sampler,
               "steps": cfg.sample_steps}
        if len(seeds) <= 1:
            n_clouds, suite = run_suite(seeds[0] if seeds else args.seed)
            out.update(n_clouds=n_clouds,
                       **{k: round(v, 6) for k, v in suite.items()})
        else:
            # the same reference set, a fresh generation per seed
            rows = []
            for s in seeds:
                n_clouds, suite = run_suite(s)
                rows.append({k: float(v) for k, v in suite.items()})
            out["n_clouds"] = n_clouds
            out["seeds"] = seeds
            out["per_seed"] = [{k: round(v, 6) for k, v in r.items()}
                               for r in rows]
            for k in rows[0]:
                vals = [r[k] for r in rows]
                out[k] = {"mean": round(float(np.mean(vals)), 6),
                          "min": round(float(np.min(vals)), 6),
                          "max": round(float(np.max(vals)), 6)}
        print(json.dumps(out))
        return out

    results, counts = {}, {}
    for mode in (["recon", "gen"] if args.mode == "both" else [args.mode]):
        per_batch = []
        for bi, batch in batches():
            pts = tensor(batch["test_points"])
            true_b = pts.shape[0]
            pts = pad_batch(pts, cfg.batch_size)
            rgb = pad_batch(tensor(batch.get("test_rgb")), cfg.batch_size)
            cond = pad_batch(tensor(batch.get("cond")), cfg.batch_size)
            gen = batch_generator(dev, args.seed, mode, bi)
            if mode == "recon":
                x = recon_fn(pts, rgb, cond, gen)
            else:
                x = sample_fn(cond, gen, pts.shape[0], pts.shape[1])
            mb = cloud_metrics(x, pts, emd_max_points=args.emd_max_points,
                               generator=gen)
            per_batch.append({k: v[:true_b].cpu().numpy()
                              for k, v in mb.items()})
        results[mode] = aggregate(per_batch)
        counts[mode] = sum(int(mb["cd"].shape[0]) for mb in per_batch)

    out = {"epoch": ep, "sampler": cfg.sampler, "steps": cfg.sample_steps,
           "n_clouds": max(counts.values()),
           **{f"{m}_{k}": round(v, 6) for m, r in results.items()
              for k, v in r.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
