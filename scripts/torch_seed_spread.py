#!/usr/bin/env python
"""Seed spreads of the port's learning runs, and the device split of
distill_demo's teacher.

Spread: ``--recipe R --seeds 5,6,7`` runs one learning recipe once a
seed through the port's harness, ``pcfm_torch.quality.R.main(argv,
overrides={"seed": s})``, and for distill_demo with ``--packages
jax,torch`` also through the JAX package (scripts/distill_demo.py's
``main`` rebuilt here with the seed replaced, from the package's own
``train``, ``distill_pf`` and the script's ``recon_cd``; the CPU only).
On the card each distill_demo row also reads the trained teacher with
the prior made on the CPU (a generator seeded 7, as the recipe seeds its
own), and loaded on the CPU with that prior: training apart from
sampling.

Split (``--split LEG,...``, distill_demo): the teacher of the first seed
trained through this script's copy of the training loop with every
step's draws from a CPU ``torch.Generator`` seeded as the CPU run seeds
its own, made on the CPU and moved to ``--device``, then read as above.
Legs:

  * ``cpu_draws_fp32_plain``: the plain trunk, TF32 off for matmuls and
    cuDNN;
  * ``cpu_draws_recipe``: the recipe as it runs (the kernel trunk, the
    backends' defaults).

On the CPU the recipe leg equals the harness's own CPU run bit for bit.
``--bisect N``: the teacher's first N steps on the CPU and on the device
from one state each step (per module: gradient, update, EMA) and freely
(their drift), to bisect a leg that parts.  ``--fingerprint``: hashes of
the data, the initial weights and the first CPU steps on this host.
``--rows_from DIR``: a convergence_full or gen_quality seed's row read
from a finished run's files.

Writes OUT_DIR/seed_spread_<recipe>_<cpu|cuda>.json: a package's rows
(one a seed, each with its device string and wall seconds) and each
metric's mean / min / max / std, and the split's legs.  Runs that write
one file add to it (by package and seed, or leg), so the packages may
run in separate processes.  The JAX package is imported only for
``--packages jax``.

    python scripts/torch_seed_spread.py --recipe distill_demo \\
        --packages jax,torch --seeds 5,6,7,8,9 --device cpu
    python scripts/torch_seed_spread.py --recipe distill_demo \\
        --seeds 5,6,7,8,9 --split cpu_draws_fp32_plain,cpu_draws_recipe
    python scripts/torch_seed_spread.py --recipe convergence_full \\
        --seeds 7,8,9 --recipe_args "--epochs 120"
"""
import argparse
import contextlib
import copy
import fcntl
import hashlib
import json
import math
import os
import shlex
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pcfm_torch import kinks  # noqa: E402
from pcfm_torch.data import get_datasets, to_model_batch  # noqa: E402
from pcfm_torch.data.grain_loader import make_loader  # noqa: E402
from pcfm_torch.device import DEVICES, resolve_device  # noqa: E402
from pcfm_torch.quality import (convergence_full, distill_demo,  # noqa: E402
                                gen_quality)
from pcfm_torch.quality.common import card, dump_json  # noqa: E402
from pcfm_torch.train import checkpoint as ckpt  # noqa: E402
from pcfm_torch.train.loop import (device_prefetch,  # noqa: E402
                                   epoch_scalars, to_device)
from pcfm_torch.train.state import init_state  # noqa: E402
from pcfm_torch.train.step import make_draws, train_step  # noqa: E402
from pcfm_torch.utils import seed_all  # noqa: E402

RECIPES = {"distill_demo": distill_demo,
           "convergence_full": convergence_full,
           "gen_quality": gen_quality}
LEGS = {"cpu_draws_fp32_plain": ({"fused_trunk": "off"}, False),
        "cpu_draws_recipe": ({}, None)}
# scripts/distill_demo.py:57-64, the JAX Config of the demo; one device,
# as the script has on a CPU host (a host with more, such as the tests'
# virtual devices, would shard its batch)
JAX_DISTILL = dict(dp=1, sp=1, dataset_type="synthetic", pf_backbone="mlp",
                   latent_dim=32, enc_width=64, enc_depth=4, pf_width=128,
                   pf_depth=4, pf_emb_dim=64, lf_width=64, lf_depth=3,
                   lf_emb_dim=32, warmup_steps=50, amp=False, batch_size=16,
                   num_workers=0, vis_count=1, geom_warmup_epochs=10,
                   cfg_drop_warmup_epochs=20, sample_steps=32)
TEACHER = "teacher heun x32 (NFE 64)"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", choices=sorted(RECIPES), required=True)
    p.add_argument("--seeds", type=str, required=True,
                   help="comma-separated Config seeds")
    p.add_argument("--packages", type=str, default="torch",
                   help="torch and / or jax (distill_demo on the CPU)")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES)
    p.add_argument("--split", type=str, default="",
                   help="distill_demo legs, comma-separated: "
                        + ", ".join(LEGS) + " (no spread then)")
    p.add_argument("--bisect", type=int, default=0,
                   help="distill_demo: this many steps on the CPU and on "
                        "the device from one state (no spread then)")
    p.add_argument("--fingerprint", action="store_true",
                   help="distill_demo: hashes of the first seed's data, "
                        "initial weights and first CPU steps on this host "
                        "(no spread then)")
    p.add_argument("--rows_from", type=str, default="",
                   help="convergence_full / gen_quality: record the one "
                        "seed's row from the files of this finished run "
                        "(its harness's output directory) instead of "
                        "running it")
    p.add_argument("--recipe_args", type=str, default="",
                   help="the harness's flags (its defaults otherwise)")
    p.add_argument("--epochs", type=int, default=120,
                   help="distill_demo's epochs")
    p.add_argument("--npts", type=int, default=512,
                   help="distill_demo's points a cloud")
    p.add_argument("--steps_per_phase", type=int, default=400,
                   help="distill_demo's optimizer steps a halving")
    p.add_argument("--halvings", type=int, default=distill_demo.HALVINGS,
                   help="distill_demo's distillation phases")
    p.add_argument("--config", nargs="*", default=[], metavar="KEY=VALUE",
                   help="Config fields replaced in every run, both "
                        "packages' (JSON values; for tiny runs)")
    p.add_argument("--threads", type=int, default=0,
                   help="torch's CPU threads (0: its default)")
    p.add_argument("--out_dir", type=str, default=os.path.join(
        os.path.dirname(__file__), "..", "docs", "torch_quality"))
    p.add_argument("--work", type=str, default=os.path.join(
        tempfile.gettempdir(), "seed_spread"),
        help="where the runs write their files")
    return p


def summary(rows) -> dict:
    """Each metric's mean / min / max / std (ddof 1) over the rows."""
    out = {}
    for k in rows[0]["metrics"]:
        v = np.array([r["metrics"][k] for r in rows if k in r["metrics"]])
        out[k] = {"n": int(v.size), "mean": float(v.mean()),
                  "min": float(v.min()), "max": float(v.max()),
                  "std": float(v.std(ddof=1)) if v.size > 1 else 0.0}
    return out


@contextlib.contextmanager
def locked(path: str):
    """An exclusive lock for the read-merge-write of ``path``."""
    lock = os.path.join(tempfile.gettempdir(), "seed_spread_"
                        + os.path.basename(path) + ".lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def record(path: str, recipe: str, package: str = None, row: dict = None,
           leg: dict = None) -> dict:
    """Merge one spread row (by package and seed) or one split leg (by
    leg and seed) into the JSON at ``path``; returns the whole."""
    with locked(path):
        blob = {"recipe": recipe, "packages": {}, "split": []}
        if os.path.exists(path):
            with open(path) as f:
                blob = json.load(f)
        if row is not None:
            pkg = blob["packages"].setdefault(package, {"rows": []})
            rows = [r for r in pkg["rows"] if r["seed"] != row["seed"]]
            pkg["rows"] = sorted(rows + [row], key=lambda r: r["seed"])
            pkg["summary"] = summary(pkg["rows"])
        if leg is not None:
            blob["split"] = [g for g in blob["split"] if
                             (g["leg"], g["seed"]) != (leg["leg"],
                                                       leg["seed"])]
            blob["split"].append(leg)
        dump_json(path, blob)
    return blob


def fresh(path: str) -> str:
    """An empty run directory (a harness resumes from what it finds)."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def teacher_reads(run_dir: str, device) -> dict:
    """The trained teacher's rows (``distill_demo.teacher_rows``) read
    with a CPU-made prior on ``device`` and, loaded there, on the CPU;
    each key names its read."""
    path, _ = ckpt.find_latest(run_dir)
    out = {}
    for where, tag in ((device, "cpu prior"),
                       (torch.device("cpu"), "on cpu")):
        cfg, bundle, _ = ckpt.load(path, where)
        fixed = distill_demo.fixed_batch(cfg, where)
        for name, cd in distill_demo.teacher_rows(bundle, fixed, "cpu"):
            out[f"{name} | {tag}"] = cd
    return out


def config_overrides(args) -> dict:
    """``--config``'s fields."""
    out = {}
    for item in args.config:
        key, _, value = item.partition("=")
        out[key] = json.loads(value)
    return out


def distill_overrides(args, seed: int) -> dict:
    return {"seed": seed, "tr_max_sample_points": args.npts,
            "te_max_sample_points": args.npts, **config_overrides(args)}


def torch_row(args, seed: int, device) -> dict:
    """One seed of the recipe through the port's harness."""
    run = fresh(os.path.join(args.work, f"{args.recipe}_torch_{seed}"))
    argv = shlex.split(args.recipe_args) + ["--device", args.device,
                                            "--out", run]
    if args.recipe == "distill_demo":
        res = distill_demo.main(argv + ["--epochs", str(args.epochs)],
                                distill_overrides(args, seed),
                                args.steps_per_phase, args.halvings)
        metrics = dict(res["recon_cd"])
        if device.type != "cpu":
            metrics.update(teacher_reads(run, device))
    else:
        RECIPES[args.recipe].main(argv, {"seed": seed,
                                         **config_overrides(args)})
        metrics, _ = run_metrics(args.recipe, run)
    return metrics


def run_metrics(recipe: str, run: str) -> tuple:
    """(metrics, device string) of a finished convergence_full or
    gen_quality run from the files it wrote in ``run``: the recon CD at
    each evaluated epoch; the in-loop suites and the final suite's means."""
    def read(name):
        with open(os.path.join(run, name)) as f:
            return json.load(f)
    hist = read("history.json")
    if recipe == "convergence_full":
        metrics = {f"recon_cd ep{r['epoch']:04d}": r["recon_cd"]
                   for r in hist if "recon_cd" in r}
        metrics["loss_point final"] = hist[-1]["loss_point"]
        return metrics, read("summary.json")["device"]
    res = read("final_suite.json")
    metrics = {f"{k} ep{r['epoch']:04d}": r[k] for r in hist
               for k in ("nna_cd", "cov_cd", "mmd_cd") if k in r}
    metrics.update({f"final {k}": v["mean"]
                    for k, v in res.get("default", {}).items()})
    metrics["epochs_run"] = res["protocol"]["epochs_run"]
    return metrics, res["device"]


def jax_row(args, seed: int) -> dict:
    """scripts/distill_demo.py's ``main`` with ``seed``, the sizes of
    ``args`` and no file written outside the run: {sampler: recon CD}."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pcfm.config import Config as JaxConfig
    from pcfm.data import DataLoader, get_datasets as jax_datasets
    from pcfm.data import to_model_batch
    from pcfm.distill.progressive import distill_pf
    from pcfm.sample.integrators import euler_sample, heun_sample
    from pcfm.train import checkpoint as jax_ckpt
    from pcfm.train.loop import train
    from pcfm.train.state import init_state as jax_init_state
    from scripts.distill_demo import recon_cd

    run = fresh(os.path.join(args.work, f"distill_demo_jax_{seed}"))
    cfg = JaxConfig(**{**JAX_DISTILL, **distill_overrides(args, seed)},
                    epochs=args.epochs, save_every=args.epochs, out_dir=run)
    train(cfg, verbose=False)
    path, _ = jax_ckpt.find_latest(run)
    bundle, state, _ = jax_init_state(cfg, jax.random.PRNGKey(0), 1)
    state, _ = jax_ckpt.restore(path, state)
    tr_ds, te_ds = jax_datasets(cfg)
    loader = DataLoader(tr_ds, cfg.batch_size, shuffle=True, drop_last=True,
                        seed=9, num_workers=0)
    fixed = to_model_batch(next(iter(DataLoader(
        te_ds, 16, shuffle=False, drop_last=True, seed=0,
        num_workers=0).epoch_batches(0))), train=False, has_rgb=True,
        cond_dim=cfg.cond_dim)
    fixed = {"test_points": fixed["pts"], "test_rgb": fixed["rgb"],
             "cond": fixed["cond"]}
    ema = state.ema_pf
    rows = [(TEACHER, recon_cd(bundle, state, ema["params"],
                               ema["batch_stats"], fixed, heun_sample, 32))]
    for s in (16, 8, 4):
        rows.append((f"UNdistilled euler x{s} (NFE {s})",
                     recon_cd(bundle, state, ema["params"],
                              ema["batch_stats"], fixed, euler_sample, s)))

    def batches(phase):
        e = 0
        while True:
            for b in loader.epoch_batches(1000 * phase + e):
                yield to_model_batch(b, train=True, has_rgb=True,
                                     cond_dim=cfg.cond_dim)
            e += 1

    steps, cur = 32, state
    for phase in range(args.halvings):
        pf_p, pf_e, steps = distill_pf(
            bundle, cur, batches, base_steps=steps, phases=1,
            steps_per_phase=args.steps_per_phase, lr=2e-4,
            rng=jax.random.PRNGKey(phase), verbose=False)
        params = dict(cur.params)
        params["pf"] = pf_p
        cur = cur.replace(params=params, ema_pf={
            "params": pf_e, "batch_stats": ema["batch_stats"]})
        rows.append((f"distilled euler x{steps} (NFE {steps})",
                     recon_cd(bundle, cur, pf_e, ema["batch_stats"], fixed,
                              euler_sample, steps)))
    return dict(rows)


def teacher_config(args, seed: int, run: str, **overrides):
    """distill_demo's Config for ``seed`` at the script's sizes, its run
    in ``run``."""
    dargs = distill_demo.build_parser().parse_args(
        ["--epochs", str(args.epochs), "--out", run])
    return distill_demo.make_config(dargs).replace(
        **distill_overrides(args, seed), **overrides)


def teacher_start(cfg, devices) -> tuple:
    """The training loop's start at one rank (train/loop.py): the
    seeding, the train loader, and a fresh state on each of ``devices``,
    each drawn from a CPU generator seeded ``cfg.seed``."""
    seed_all(cfg.seed)
    tr_ds, _ = get_datasets(cfg)
    loader = make_loader(cfg.loader_backend, tr_ds, cfg.batch_size,
                         shuffle=True, drop_last=True, seed=cfg.seed,
                         num_workers=cfg.num_workers, rank=0, world_size=1)
    total = cfg.epochs * max(1, len(loader))
    return loader, [init_state(cfg, d, total,
                               torch.Generator().manual_seed(cfg.seed))
                    for d in devices]


def train_cpu_draws(cfg, device) -> str:
    """``pcfm_torch.train.loop.train`` at one rank, without validation,
    with each step's draws made from a CPU generator seeded ``cfg.seed``
    (on the CPU: the loop's own generator) and moved to ``device``; saves
    the last epoch's checkpoint as the loop does and returns its path."""
    os.makedirs(cfg.out_dir, exist_ok=True)
    loader, (state,) = teacher_start(cfg, [device])
    gen = torch.Generator().manual_seed(cfg.seed)
    for ep in range(1, cfg.epochs + 1):
        color_on, drop_p = epoch_scalars(cfg, ep)
        for mb in device_prefetch(loader.epoch_batches(ep), cfg, device):
            draws = make_draws(cfg, mb, gen, drop_p)
            train_step(state, mb, None, color_on, drop_p,
                       draws={k: v.to(device) for k, v in draws.items()})
    return ckpt.save(cfg.out_dir, cfg.epochs, state.bundle,
                     global_step=state.step, opt=state.opt,
                     keep_last=cfg.keep_last_ckpts)


@contextlib.contextmanager
def tf32(allow):
    """TF32 for matmuls and cuDNN set to ``allow`` (None: as they are)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    if allow is not None:
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
    try:
        yield {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
               "cudnn_tf32": torch.backends.cudnn.allow_tf32}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def split_leg(args, leg: str, seed: int, device) -> dict:
    """One leg of the split: the teacher trained on CPU draws, then read
    with the device's own prior, the CPU's prior, and on the CPU."""
    overrides, allow = LEGS[leg]
    run = fresh(os.path.join(args.work, f"split_{leg}_{seed}"))
    cfg = teacher_config(args, seed, run, **overrides)
    t0 = time.time()
    with tf32(allow) as flags:
        train_cpu_draws(cfg, device)
        path, _ = ckpt.find_latest(run)
        lcfg, bundle, _ = ckpt.load(path, device)
        reads = {f"{k} | {device.type} prior": v for k, v in
                 distill_demo.teacher_rows(
                     bundle, distill_demo.fixed_batch(lcfg, device))}
        reads.update(teacher_reads(run, device))
    return {"leg": leg, "seed": seed, "device": card(device),
            "fused_trunk": cfg.fused_trunk, "amp": cfg.amp, **flags,
            "wall_s": round(time.time() - t0, 1), "recon_cd": reads}


TRAINED = ("encoder", "pf", "lf")
SHADOWS = ("ema_pf", "ema_lf")


def float_tensors(bundle, name: str) -> dict:
    return {k: v.detach().float().cpu() for k, v in
            bundle.modules()[name].state_dict().items()
            if v.is_floating_point()}


def rel_diff(a: dict, b: dict, base: dict = None) -> float:
    """||a - b|| over ||b - base|| (over ||b|| without ``base``), every
    tensor of a module together."""
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float(((b[k] - (0 if base is None else base[k])) ** 2).sum())
              for k in b)
    return math.sqrt(num / den) if den > 0 else math.sqrt(num)


def step_with_grads(state, batch, draws, color_on, drop_p) -> tuple:
    """``train_step`` on given draws; also returns each trained module's
    gradients as they reach the optimizer (before the clip)."""
    grads = {}
    apply = state.apply_gradients

    def snap():
        for name in TRAINED:
            mod = state.bundle.modules()[name]
            # a copy: the clip then scales the gradients in place
            grads[name] = {k: (torch.zeros_like(p) if p.grad is None
                               else p.grad).detach().float().cpu().clone()
                           for k, p in mod.named_parameters()}
        return apply()

    state.apply_gradients = snap
    try:
        m = train_step(state, batch, None, color_on, drop_p, draws=draws)
    finally:
        del state.apply_gradients
    return {k: float(v) for k, v in m.items()}, grads


def bisect(args, seed: int, device) -> dict:
    """The teacher's first ``args.bisect`` steps in fp32 with the plain
    trunk and TF32 off, on the CPU and on ``device`` from one initial
    state, on the same batches and the CPU's draws.  Each step a device
    state takes the CPU's state before it (modules and optimizer) and
    the CPU's choices at the kinks, so its step differs from the CPU's by
    the step's own arithmetic: per module the gradient, the update (the
    parameters after it, against the CPU's update) and the EMA shadows'
    update.  A second device state trains freely beside them, so the
    distance its parameters drift from the CPU's, against the distance
    the CPU's moved from the start, shows how the two runs part."""
    cfg = teacher_config(args, seed, fresh(os.path.join(
        args.work, f"bisect_{seed}")), fused_trunk="off")
    cpu = torch.device("cpu")
    loader, made = teacher_start(cfg, [cpu, device, device])
    states = dict(zip(("cpu", "same", "free"), made))
    start = {n: float_tensors(states["cpu"].bundle, n)
             for n in TRAINED + SHADOWS}
    gen = torch.Generator().manual_seed(cfg.seed)
    rows, t0 = [], time.time()
    with tf32(False) as flags:
        for ep in range(1, cfg.epochs + 1):
            color_on, drop_p = epoch_scalars(cfg, ep)
            for raw in loader.epoch_batches(ep):
                if len(rows) == args.bisect:
                    break
                mb = to_model_batch(raw, train=True, has_rgb=cfg.has_rgb,
                                    cond_dim=cfg.cond_dim)
                b_cpu, b_dev = to_device(mb, cpu), to_device(mb, device)
                draws = make_draws(cfg, b_cpu, gen, drop_p)
                d_dev = {k: v.to(device) for k, v in draws.items()}
                ref, same = states["cpu"], states["same"]
                for key, mod in ref.bundle.modules().items():
                    same.bundle.modules()[key].load_state_dict(
                        mod.state_dict())
                # a copy: on one device the loaded moments are the CPU's own
                same.opt.load_state_dict(copy.deepcopy(ref.opt.state_dict()))
                same.step = ref.step
                before = {n: float_tensors(ref.bundle, n)
                          for n in TRAINED + SHADOWS}
                rec = kinks.Kinks()
                with kinks.record(rec):
                    m_cpu, g_cpu = step_with_grads(ref, b_cpu, draws,
                                                   color_on, drop_p)
                with kinks.replay(rec):
                    m_dev, g_dev = step_with_grads(same, b_dev, d_dev,
                                                   color_on, drop_p)
                step_with_grads(states["free"], b_dev, d_dev, color_on,
                                drop_p)
                row = {"step": ref.step, "epoch": ep,
                       "metrics": {k: abs(m_dev[k] - v) / max(abs(v), 1e-12)
                                   for k, v in m_cpu.items()}}
                for n in TRAINED:
                    after = float_tensors(ref.bundle, n)
                    row[n] = {
                        "grad": rel_diff(g_dev[n], g_cpu[n]),
                        "update": rel_diff(float_tensors(same.bundle, n),
                                           after, before[n]),
                        "free_drift": rel_diff(
                            float_tensors(states["free"].bundle, n), after,
                            start[n])}
                for n in SHADOWS:
                    now = float_tensors(ref.bundle, n)
                    row[n] = {
                        "update": rel_diff(float_tensors(same.bundle, n),
                                           now, before[n]),
                        "free_drift": rel_diff(
                            float_tensors(states["free"].bundle, n), now,
                            start[n])}
                rows.append(row)
            if len(rows) == args.bisect:
                break
    worst = {f"{n}.{k}": max(r[n][k] for r in rows)
             for n in TRAINED + SHADOWS for k in rows[0][n]
             if k != "free_drift"}
    return {"seed": seed, "device": card(device), **flags,
            "fused_trunk": cfg.fused_trunk, "steps": len(rows),
            "wall_s": round(time.time() - t0, 1), "worst": worst,
            "free_drift_last": {n: rows[-1][n]["free_drift"]
                                for n in TRAINED + SHADOWS},
            "rows": [r for r in rows if r["step"] <= 8
                     or r["step"] % 16 == 0 or r is rows[-1]]}


def sha(t) -> str:
    return hashlib.sha1(np.ascontiguousarray(
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    ).tobytes()).hexdigest()[:16]


def fingerprint(args, seed: int, steps: int = 8) -> dict:
    """On this host's CPU: the installed versions, and hashes of the
    teacher's train split, its initial weights (each module's float
    tensors) and the weights after its first ``steps`` steps on the CPU's
    draws.  Two hosts that draw the same run give the same hashes."""
    cfg = teacher_config(args, seed, args.work, fused_trunk="off")
    cpu = torch.device("cpu")
    loader, (state,) = teacher_start(cfg, [cpu])

    def weights():
        return {n: sha(torch.cat([t.flatten() for t in
                                  float_tensors(state.bundle, n).values()]))
                for n in TRAINED + SHADOWS}

    out = {"seed": seed, "torch": torch.__version__, "numpy": np.__version__,
           "train_clouds": sha(np.stack(loader.ds.clouds)),
           "init": weights()}
    gen = torch.Generator().manual_seed(cfg.seed)
    losses = []
    for ep in range(1, cfg.epochs + 1):
        color_on, drop_p = epoch_scalars(cfg, ep)
        for mb in device_prefetch(loader.epoch_batches(ep), cfg, cpu):
            if len(losses) == steps:
                break
            m = train_step(state, mb, None, color_on, drop_p,
                           draws=make_draws(cfg, mb, gen, drop_p))
            losses.append(float(m["loss"]))
    out.update(losses=losses, after=weights())
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    seed_list = [int(s) for s in args.seeds.split(",") if s.strip()]
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"seed_spread_{args.recipe}_"
                        f"{args.device}.json")
    if args.rows_from:       # files of a finished run: no device needed
        if args.recipe == "distill_demo" or len(seed_list) != 1:
            raise SystemExit("--rows_from: one seed of convergence_full "
                             "or gen_quality")
        metrics, run_device = run_metrics(args.recipe, args.rows_from)
        row = {"seed": seed_list[0], "device": run_device,
               "source": args.rows_from, "metrics": metrics}
        print(f"[spread] torch {json.dumps(row)}", flush=True)
        return record(path, args.recipe, "torch", row)
    device = resolve_device(args.device)
    if args.threads:
        torch.set_num_threads(args.threads)
    packages = [p.strip() for p in args.packages.split(",") if p.strip()]
    if "jax" in packages and (args.recipe != "distill_demo"
                              or device.type != "cpu"):
        raise SystemExit("the JAX package runs distill_demo on the CPU only")
    legs = [g.strip() for g in args.split.split(",") if g.strip()]
    if (legs or args.bisect or args.fingerprint) \
            and args.recipe != "distill_demo":
        raise SystemExit("--split, --bisect and --fingerprint are "
                         "distill_demo's")
    where = card(device)
    blob = {}
    if args.fingerprint:
        res = fingerprint(args, seed_list[0])
        print(f"[fingerprint] {json.dumps(res)}", flush=True)
        dump_json(os.path.join(args.out_dir, "init_fingerprint_torch"
                               f"{torch.__version__.split('+')[0]}.json"),
                  res)
        return res
    if args.bisect:
        res = bisect(args, seed_list[0], device)
        print(f"[bisect] worst {json.dumps(res['worst'])} free drift "
              f"{json.dumps(res['free_drift_last'])}", flush=True)
        dump_json(os.path.join(args.out_dir, f"bisect_distill_demo_"
                               f"{args.device}.json"), res)
        return res
    for leg in legs:
        res = split_leg(args, leg, seed_list[0], device)
        print(f"[split] {json.dumps(res)}", flush=True)
        blob = record(path, args.recipe, leg=res)
    for seed in [] if legs else seed_list:
        for pkg in packages:
            t0 = time.time()
            metrics = (jax_row(args, seed) if pkg == "jax"
                       else torch_row(args, seed, device))
            bad = [k for k, v in metrics.items() if not math.isfinite(v)]
            row = {"seed": seed, "device": "cpu" if pkg == "jax" else where,
                   "wall_s": round(time.time() - t0, 1),
                   "metrics": metrics}
            print(f"[spread] {pkg} {json.dumps(row)}", flush=True)
            blob = record(path, args.recipe, pkg, row)
            if bad:
                raise SystemExit(f"{pkg} seed {seed}: not finite: {bad}")
    print(f"[spread] wrote {path}", flush=True)
    return blob


if __name__ == "__main__":
    main()
