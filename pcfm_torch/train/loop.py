"""The training loop — port of pcfm/train/loop.py.

  * data from pcfm_torch.data (the port's copy of the framework-free
    pcfm.data: datasets, host loader); the train loader's backend is
    ``cfg.loader_backend`` (threads, or worker processes for ``grain``),
    the val loader's the thread loader, as in JAX
  * ModelBundle + AdamW (3 groups) + EMA, auto-resume from ckpts/*.pt
  * per epoch: geometry-warmup and CFG-warmup scalars, then the steps
  * per save_every: checkpoint + validation recon / sample PLY dumps + CD

The host reads the device's values once every ``log_every`` steps (the
progress bar) and once per epoch (the metrics line), never per step, so it
can queue the next steps while the card works.  Batches are copied from
pinned host memory without blocking, two ahead.

Data and point-axis parallel: one process per rank in the default process
group (``pcfm_torch.parallel.init_distributed``: torchrun's environment),
laid out as a (dp, sp) grid (``cfg.dp`` x ``cfg.sp`` = the world size;
``dp = -1``: world // sp).  Each data shard's loader yields ``batch_size``
clouds (the global batch is ``batch_size * dp``); the sp ranks of a shard
load the same clouds and keep N / sp points each.  Every rank's card is
``cuda:LOCAL_RANK`` unless the caller names one.  Rank 0's parameters and
buffers are broadcast at the start and after a resume; rank 0 prints,
writes TensorBoard, saves, and runs validation alone on the fixed val
batch, which is every data shard's first val batch (gathered once), while
the other ranks wait at a barrier.  Every rank waits for rank 0's save
before ``auto_resume`` reads.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from pcfm_torch.config import Config
from pcfm_torch.data import DataLoader, get_datasets, to_model_batch
from pcfm_torch.data.grain_loader import make_loader
from pcfm_torch.device import resolve_device
from pcfm_torch.parallel import sp_context
from pcfm_torch.parallel.distributed import cuda_device
from pcfm_torch.parallel.mesh import data_axis_shard, make_grid, shard_batch
from pcfm_torch.train import checkpoint as ckpt
from pcfm_torch.train.evaluate import (dump_clouds, make_recon_fn,
                                       make_sample_fn, val_cd)
from pcfm_torch.train.state import (broadcast_state, count_parameters,
                                    init_state)
from pcfm_torch.train.step import train_step
from pcfm_torch.utils import MetricEMA, seed_all


def to_device(arrays: dict, device: torch.device) -> dict:
    """numpy -> device tensors; from pinned memory without blocking the
    host when the device is a GPU."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def device_prefetch(batches, cfg: Config, device, depth: int = 2,
                    grid=None):
    """Start the host->device copies ``depth`` batches ahead, of this
    rank's points of each cloud."""
    buf = deque()
    for batch in batches:
        mb = to_model_batch(batch, train=True, has_rgb=cfg.has_rgb,
                            cond_dim=cfg.cond_dim)
        buf.append(to_device(shard_batch(mb, grid, data_sharded=True),
                             device))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def epoch_scalars(cfg: Config, ep: int):
    """(color_on, drop_p) of epoch ``ep``: geometry warmup and CFG-dropout
    warmup (train.py:546,615)."""
    use_rgb = (ep > cfg.geom_warmup_epochs) and cfg.pointflow_rgb \
        and cfg.has_rgb
    ramp = min(1.0, max(0.0, ep / max(1, cfg.cfg_drop_warmup_epochs)))
    drop_p = cfg.cfg_drop_p * ramp if cfg.cfg_drop_p > 0 else 0.0
    return (1.0 if use_rgb else 0.0), drop_p


def _progress(total: int, desc: str):
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=total, desc=desc, leave=False)


def train(cfg: Config, verbose: bool = True, device="cuda") -> dict:
    """Run training to cfg.epochs on ``device`` ("cuda": this rank's card,
    or "cpu" when asked); returns summary metrics (every rank's mean)."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = cuda_device(device)
        torch.cuda.set_device(device)
    grid = make_grid(cfg.dp, cfg.sp, cfg.tr_max_sample_points)
    if grid.size == 1:
        grid = None                     # one rank: no collective anywhere
    sp_context.set_sp_group(grid)
    try:
        return _train(cfg, verbose, device, grid)
    finally:
        sp_context.set_sp_group(None)


def _barrier(grid) -> None:
    if grid is not None:
        dist.barrier()


def _train(cfg: Config, verbose: bool, device: torch.device, grid) -> dict:
    rank = 0 if grid is None else grid.rank
    verbose = verbose and rank == 0
    seed_all(cfg.seed + rank)
    if rank == 0:
        os.makedirs(cfg.out_dir, exist_ok=True)

    # ---- data (sets cfg.cond_dim / cfg.has_rgb) ----
    tr_ds, te_ds = get_datasets(cfg)
    d_rank, d_world = data_axis_shard(grid)
    train_loader = make_loader(cfg.loader_backend, tr_ds, cfg.batch_size,
                               shuffle=True, drop_last=True, seed=cfg.seed,
                               num_workers=cfg.num_workers, rank=d_rank,
                               world_size=d_world)
    val_loader = DataLoader(te_ds, cfg.batch_size, shuffle=False,
                            drop_last=False, seed=cfg.seed,
                            num_workers=max(1, cfg.num_workers // 2),
                            rank=d_rank, world_size=d_world)
    total_steps = cfg.epochs * max(1, len(train_loader))

    # ---- models / state ----
    state = init_state(cfg, device, total_steps,
                       torch.Generator().manual_seed(cfg.seed))
    bundle = state.bundle
    if verbose:
        print(f"[Models] enc: {count_parameters(bundle.enc)/1e6:.2f}M  "
              f"pf: {count_parameters(bundle.pf)/1e6:.2f}M  "
              f"lf: {count_parameters(bundle.lf)/1e6:.2f}M  ({device})")
        print(f"[Dims] cond_dim(joint)={cfg.cond_dim} "
              f"latent_dim={cfg.latent_dim} pf_cond_dim={cfg.pf_cond_dim} "
              f"enc_in={cfg.enc_in_channels} pf_point_dim={cfg.pf_point_dim}")
        if dist.is_initialized():
            print(f"[Dist] {dist.get_backend()}, world "
                  f"{dist.get_world_size()}")
        if grid is not None:
            print(f"[Mesh] {{'data': {grid.dp}, 'points': {grid.sp}}}: "
                  f"global batch {cfg.batch_size * grid.dp} x "
                  f"{cfg.tr_max_sample_points} points")

    _barrier(grid)                # the files every rank reads are complete
    start_epoch, _ = ckpt.auto_resume(cfg.out_dir, state, verbose=verbose)
    broadcast_state(state)
    if start_epoch > cfg.epochs:
        if verbose:
            print("[Auto-Resume] Training already completed for the "
                  "requested total epochs. Nothing to do.")
        return {"epochs_run": 0}

    recon_fn, sample_fn = make_recon_fn(bundle), make_sample_fn(bundle)
    # fixed val batch for comparable visualizations (train.py:260-263):
    # the first batch of every data shard (pcfm/train/loop.py:237-266)
    val_batch = gather_val_batch(
        next(iter(val_loader.epoch_batches(0))), grid)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    global_batch = cfg.batch_size * (1 if grid is None else grid.dp)

    lp_ema, lz_ema = MetricEMA(), MetricEMA()
    last_metrics = {}
    prof, steps_seen = None, 0
    tb = None
    if cfg.tensorboard and rank == 0:
        from pcfm_torch.utils.tb import SummaryWriter
        tb = SummaryWriter(os.path.join(cfg.out_dir, "tb"))

    for ep in range(start_epoch, cfg.epochs + 1):
        color_on, drop_p = epoch_scalars(cfg, ep)
        t_ep = time.perf_counter()
        n_steps = 0
        pbar = _progress(len(train_loader), f"Ep{ep}") if verbose else None
        for mb in device_prefetch(train_loader.epoch_batches(ep), cfg,
                                  device, grid=grid):
            if cfg.profile_dir and steps_seen == 1 and rank == 0:
                # skip the first step (allocator and kernel warm-up)
                prof = start_profile(device)
            metrics = train_step(state, mb, gen, color_on, drop_p)
            n_steps += 1
            steps_seen += 1
            if pbar is not None:
                if n_steps % max(1, cfg.log_every) == 0:
                    # sync sparsely; per-step host reads would stall
                    pbar.set_postfix(lp=float(metrics["loss_point"]),
                                     lz=float(metrics["loss_latent"]))
                pbar.update(1)
            if prof is not None and steps_seen == 1 + cfg.profile_steps:
                stop_profile(prof, cfg.profile_dir, device)
                prof = None
        if pbar is not None:
            pbar.close()
        if n_steps == 0:
            raise ValueError(
                f"epoch {ep} produced no batches: dataset has "
                f"{len(train_loader.ds)} items < batch_size "
                f"{cfg.batch_size} (drop_last). Lower --batch_size or "
                f"add data.")
        # one host read per epoch for the metric prints
        names = sorted(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        last_metrics = dict(zip(names, values))
        lp_ema.update(last_metrics["loss_point"])
        lz_ema.update(last_metrics["loss_latent"])
        dt = time.perf_counter() - t_ep
        pps = global_batch * cfg.tr_max_sample_points * n_steps / dt
        if rank == 0:
            with open(os.path.join(cfg.out_dir, "metrics.jsonl"), "a") as f:
                json.dump({"epoch": ep, "sec": round(dt, 3),
                           "points_per_sec": round(pps, 1),
                           **{k: round(v, 6)
                              for k, v in last_metrics.items()}}, f)
                f.write("\n")
        if tb is not None:
            tb.add_scalars({f"train/{k}": v for k, v in last_metrics.items()}
                           | {"perf/sec_per_epoch": dt,
                              "perf/points_per_sec": pps}, ep)
            tb.flush()
        if verbose:
            print(f"Ep{ep}: lp={last_metrics['loss_point']:.4f} "
                  f"lz={last_metrics['loss_latent']:.4f} "
                  f"(ema {lp_ema.value:.4f}/{lz_ema.value:.4f}, "
                  f"{dt:.1f}s, {pps/1e6:.2f}M pts/s)")

        if (ep % cfg.save_every) == 0 or ep == cfg.epochs:
            if rank == 0:
                ckpt.save(cfg.out_dir, ep, bundle, global_step=state.step,
                          opt=state.opt, keep_last=cfg.keep_last_ckpts,
                          async_save=cfg.async_save)
                with sp_context.suspended():     # whole clouds, rank 0 alone
                    cd_rec, cd_gen = run_validation(
                        cfg, recon_fn, sample_fn, val_batch, ep, device,
                        verbose)
                if tb is not None:
                    tb.add_scalars({"val/recon_cd": cd_rec,
                                    "val/gen_cd": cd_gen}, ep)
                    tb.flush()
            _barrier(grid)

    if prof is not None:           # the run ended inside the window
        stop_profile(prof, cfg.profile_dir, device)
    if tb is not None:
        tb.close()
    ckpt.wait_for_saves()
    _barrier(grid)                 # every rank returns after the last save
    return {"epochs_run": cfg.epochs - start_epoch + 1, **last_metrics}


def gather_val_batch(batch: dict, grid) -> dict:
    """The fixed val batch of a run: every data shard's first val batch,
    concatenated in data order (on every rank; one rank of each points
    group contributes).  The batch itself on one rank."""
    if grid is None:
        return batch
    keys = ("test_points", "test_rgb", "cond")
    mine = {k: batch.get(k) for k in keys}
    every = [None] * grid.size
    dist.all_gather_object(every, mine)
    shards = every[::grid.sp]            # points index 0 of each data index
    return {k: (None if shards[0][k] is None else
                np.concatenate([s[k] for s in shards]))
            for k in keys}


def start_profile(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof, profile_dir: str, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}")


def run_validation(cfg: Config, recon_fn, sample_fn, val_batch: dict,
                   ep: int, device, verbose: bool = True):
    """save_val_recon + save_val_samples (train.py:283-429) on the fixed
    val batch: PLY dumps and the train-time CD of both."""
    arrays = {"pts": val_batch["test_points"]}
    for key, src in (("rgb", "test_rgb"), ("cond", "cond")):
        if val_batch.get(src) is not None:
            arrays[key] = val_batch[src]
    t = to_device({k: np.asarray(v, np.float32) for k, v in arrays.items()},
                  device)
    pts, rgb, cond = t["pts"], t.get("rgb"), t.get("cond")
    b, n = pts.shape[:2]
    gen = torch.Generator(device=device).manual_seed(cfg.seed * 100003 + ep)
    x_rec = recon_fn(pts, rgb, cond, gen)
    x_gen = sample_fn(cond, gen, b, n)
    gt_pts = val_batch["test_points"]
    gt_rgb = val_batch.get("test_rgb")
    for x, name in ((x_rec, "samples_recon"), (x_gen, "samples")):
        dump_clouds(x.cpu().numpy(), gt_pts, gt_rgb,
                    os.path.join(cfg.out_dir, f"{name}_ep{ep:04d}"),
                    cfg.vis_count)
    cd_rec, cd_gen = val_cd(x_rec, pts), val_cd(x_gen, pts)
    if verbose:
        print(f"[Val-Recon ep{ep:04d}] CD = {cd_rec:.4f} "
              f"(EMA={cfg.ema_eval}, {cfg.sampler})")
        print(f"[Val ep{ep:04d}] random-z CD = {cd_gen:.4f} "
              f"(EMA={cfg.ema_eval}, {cfg.sampler})")
    return cd_rec, cd_gen
