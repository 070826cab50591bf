#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (pcfm_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; imports nothing of JAX.  Phases, each fatal on
failure:

1. build every kernel of the path from pcfm_torch/csrc with nvcc;
2. kernel vs plain: the fused FiLM-block kernel against its plain-torch
   version (fp32 math, TF32 off) at the sampling path's shapes
   (8 and 16 clouds x 20 000 points x 512 channels, bf16), error and
   CUDA-event times of both;
3. main path: a full-width reference-format checkpoint of the bench
   configuration (bench.py: 8 clouds x 20 000 RGB points, latent 128,
   cond_dim 1, mlp point flow 512/6/256, latent flow 512/6/256, bf16
   compute, Heun x 50) with random weights from a seeded generator,
   sampled through the sampling CLI, plain and with guidance 0.25; the
   kernel must run 5 blocks x 100 evaluations = 500 times per run;
4. Heun x 50 ms/shape with the kernel trunk and with the plain trunk;
5. kernel trunk vs plain trunk end to end: the same priors through 4 Heun
   steps, each bf16 path against an fp32 plain run;
6. backward kernel vs plain: all seven gradients of the FiLM-block
   backward kernel against its plain-torch version at (8 | 16, 20 000,
   512) bf16, each within GRAD_REL_TOL of the gradient's max, bitwise equal
   across two launches, CUDA-event times of both;
7. the training path: the training CLI at the same full width
   (`--dataset_type synthetic`, 8 steps, validation, a checkpoint); the
   forward and backward kernels must run 5 times per step, the losses be
   finite, and a rerun must find nothing to do;
8. train step ms at bench.py's workload with the kernel trunk and the plain
   trunk in turns (x 293 steps = s/epoch), peak memory, and the kernels'
   share of device time from one torch.profiler run;
9. determinism: two 3-step runs from one seed and batch (kernel trunk)
   give bitwise-equal losses and parameters.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "runs", "chip_smoke")
SEED = 0
DEVICE = "cuda"
B, N, C = 8, 20000, 512
FILM_BLOCKS = 5                      # pf_depth 6 -> 5 FiLM trunk blocks
NFE = 100                            # Heun x 50
KERNEL_TOL = 6e-2                    # atol = rtol, as the JAX bf16 test
E2E_REL_TOL = 5e-2
# backward: each gradient's max abs error over its max |plain| value; the
# kernel's products are bf16 x bf16 -> fp32 summed over up to 320k rows in
# another order than the fp32 plain version
GRAD_REL_TOL = 2e-2
TRAIN_SAMPLE_STEPS = 4               # validation sampler of the CLI phase
STEPS_PER_EPOCH = 293                # bench.py's epoch at batch 8
TIMED_STEPS = 10


def sh(*cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ply_vertices(path: str) -> tuple:
    """(vertex count, property names) from an ASCII PLY header, checked
    against the number of data rows."""
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    count = next(int(x.split()[2]) for x in lines[:end]
                 if x.startswith("element vertex"))
    props = [x.split()[-1] for x in lines[:end] if x.startswith("property")]
    if len(lines) - end - 1 != count:
        raise RuntimeError(f"{path}: {len(lines) - end - 1} rows, header "
                           f"says {count}")
    return count, tuple(props)


def bench_cfg(**kw):
    from pcfm_torch.config import Config
    base = dict(pf_backbone="mlp", latent_dim=128, has_rgb=True, cond_dim=1,
                pointflow_rgb=True, use_rgb_in_latent=True, amp=True,
                use_bf16=True, tr_max_sample_points=N, batch_size=B,
                warmup_steps=0, fused_trunk="on", sampler="heun",
                sample_steps=50)
    base.update(kw)
    return Config(**base)


def kernel_vs_plain(fb, torch):
    """Phase 2. Returns (max abs err, kernel ms, plain ms) at B and 2B."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for bsz in (B, 2 * B):
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, device=DEVICE, generator=g) * scale
        h = rnd(bsz, N, C, scale=0.7).bfloat16()
        s, t = 1.0 + rnd(C, scale=0.1), rnd(C, scale=0.1)
        gamma = rnd(bsz, C, scale=0.2).bfloat16()
        beta = rnd(bsz, C, scale=0.2).bfloat16()
        w, b = rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.1)
        args = (h, s, t, gamma, beta, w, b)

        y, mean, rstd = fb.film_block_forward(*args)
        torch.cuda.synchronize()
        y_ref, mean_ref, rstd_ref = fb.film_block_reference_forward(*args)
        err = (y.float() - y_ref.float()).abs()
        bound = KERNEL_TOL + KERNEL_TOL * y_ref.float().abs()
        ok = bool((err <= bound).all()) and bool(torch.isfinite(y).all())
        mean_err = (mean - mean_ref).abs().max().item()
        rstd_rel = ((rstd - rstd_ref).abs() / rstd_ref).max().item()
        print(f"[kernel] film_block ({bsz}, {N}, {C}) bf16: max abs err "
              f"{err.max().item():.6g}, max err/bound "
              f"{(err / bound).max().item():.4g} (atol=rtol={KERNEL_TOL}); "
              f"mean err {mean_err:.3g}, rstd rel err {rstd_rel:.3g}")
        if not ok or mean_err > 1e-5 or rstd_rel > 1e-4:
            raise RuntimeError(f"film_block kernel disagrees with its plain "
                               f"version at B={bsz}")

        # plain, kernel, kernel, plain: compare inside one call, in turns
        fns = {"kernel": lambda: fb.film_block(*args),
               "plain": lambda: fb.film_block_reference(*args)}
        times = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain") * 3:
            fns[name]()
            times[name].append(cuda_ms(fns[name]))
        k_ms = statistics.median(times["kernel"])
        p_ms = statistics.median(times["plain"])
        print(f"[kernel] film_block ({bsz}, {N}, {C}): kernel {k_ms:.4f} ms,"
              f" plain fp32 {p_ms:.4f} ms (median of 6 x 10 launches)")
        out[bsz] = (err.max().item(), k_ms, p_ms)
        del h, y, y_ref, err, bound
        torch.cuda.empty_cache()
    return out


def backward_vs_plain(fb, torch):
    """Phase 6: the backward kernel against its plain version (fp32 math)
    at the training path's shapes. Returns {B: (max abs err, max err over
    the gradient's max, kernel ms, plain ms)}."""
    names = ("dh", "ds", "dt", "dgamma", "dbeta", "dW", "db")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    out = {}
    for bsz in (B, 2 * B):
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, device=DEVICE, generator=g) * scale
        h = rnd(bsz, N, C, scale=0.7).bfloat16()
        s, t = 1.0 + rnd(C, scale=0.1), rnd(C, scale=0.1)
        gamma = rnd(bsz, C, scale=0.2).bfloat16()
        beta = rnd(bsz, C, scale=0.2).bfloat16()
        w = rnd(C, C, scale=C ** -0.5)
        dy = rnd(bsz, N, C, scale=1e-3).bfloat16()
        _, mean, rstd = fb.film_block_forward(h, s, t, gamma, beta, w,
                                              rnd(C))
        args = (dy, h, s, t, gamma, beta, w, mean, rstd)

        got = fb.film_block_backward(*args)
        again = fb.film_block_backward(*args)
        torch.cuda.synchronize()
        want = fb.film_block_reference_backward(*args)
        worst, worst_abs = 0.0, 0.0
        for name, k, k2, p in zip(names, got, again, want):
            if k.shape != p.shape or k.dtype != p.dtype:
                raise RuntimeError(f"backward {name}: {k.shape} {k.dtype}, "
                                   f"plain {p.shape} {p.dtype}")
            if not torch.equal(k, k2):
                raise RuntimeError(f"backward {name} differs between two "
                                   f"launches on the same inputs")
            err = (k.float() - p.float()).abs().max().item()
            rel = err / max(p.float().abs().max().item(), 1e-30)
            print(f"[bwd] ({bsz}, {N}, {C}) {name}: max abs err {err:.4g}, "
                  f"/ max |plain| {rel:.4g} (bound {GRAD_REL_TOL})")
            if not torch.isfinite(k).all() or rel > GRAD_REL_TOL:
                raise RuntimeError(f"backward kernel {name} disagrees with "
                                   f"its plain version at B={bsz}")
            worst, worst_abs = max(worst, rel), max(worst_abs, err)
        print(f"[bwd] ({bsz}, {N}, {C}): all seven gradients bitwise equal "
              f"across two launches")

        fns = {"kernel": lambda: fb.film_block_backward(*args),
               "plain": lambda: fb.film_block_reference_backward(*args)}
        times = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain") * 2:
            fns[name]()
            times[name].append(cuda_ms(fns[name], reps=5))
        k_ms = statistics.median(times["kernel"])
        p_ms = statistics.median(times["plain"])
        print(f"[bwd] film_block backward ({bsz}, {N}, {C}) bf16: kernel "
              f"{k_ms:.4f} ms, plain fp32 {p_ms:.4f} ms (median of 4 x 5 "
              f"launches)")
        out[bsz] = (worst_abs, worst, k_ms, p_ms)
        del h, dy, got, again, want, args, fns
        torch.cuda.empty_cache()
    return out


def main_path(fb, torch, np):
    """Phase 3: the sampling CLI on a full-width checkpoint."""
    from pcfm_torch.sample import cli
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import ModelBundle

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    bundle = ModelBundle(bench_cfg(), DEVICE,
                         torch.Generator().manual_seed(SEED))
    path = checkpoint.save(RUN_DIR, 1, bundle)
    print(f"[main] wrote {os.path.relpath(path, ROOT)}")
    del bundle

    launches = {}
    for name, extra in (("heun50", []),
                        ("heun50_cfg0.25", ["--guidance_scale", "0.25"])):
        save_dir = os.path.join(RUN_DIR, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fb.launches = fb.bwd_launches = 0
        t0 = time.perf_counter()
        x = cli.main(["--out_dir", RUN_DIR, "--save_dir", save_dir,
                      "--num_samples", str(B), "--n_points", str(N),
                      "--seed", str(SEED), *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = fb.launches
        plys = sorted(os.listdir(save_dir))
        headers = {ply_vertices(os.path.join(save_dir, p)) for p in plys}
        print(f"[main] {name}: {launches[name]} film_block launches, "
              f"{len(plys)} PLYs, clouds {x.shape}, finite "
              f"{bool(np.isfinite(x).all())}, |x| max "
              f"{np.abs(x).max():.4g}, CLI wall {wall:.3f} s incl. load "
              f"and PLY writes, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if launches[name] != FILM_BLOCKS * NFE or fb.bwd_launches:
            raise RuntimeError(f"{name}: {launches[name]} kernel launches "
                               f"(expected {FILM_BLOCKS * NFE}) and "
                               f"{fb.bwd_launches} backward launches")
        rgb_ply = (N, ("x", "y", "z", "red", "green", "blue"))
        if (len(plys) != B or headers != {rgb_ply}
                or x.shape != (B, N, 6) or not np.isfinite(x).all()):
            raise RuntimeError(f"{name}: bad output")
    return launches["heun50"]


def sample_ms_per_shape(torch):
    """Phase 4: Heun x 50 ms/shape, kernel trunk vs plain trunk, in turns."""
    from pcfm_torch.sample.cli import load_run
    from pcfm_torch.train.evaluate import make_sample_fn

    fns = {}
    for trunk in ("on", "off"):
        _, bundle, _ = load_run(RUN_DIR, {"fused_trunk": trunk}, DEVICE)
        fns[trunk] = make_sample_fn(bundle)
    times = {"on": [], "off": []}
    for trunk in ("on", "off", "off", "on", "on", "off"):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[trunk](None, gen, B, N)
        torch.cuda.synchronize()
        times[trunk].append((time.perf_counter() - t0) * 1e3 / B)
    for trunk, ts in times.items():
        print(f"[sample] Heun x50 at {B} x {N}, fused_trunk={trunk}: "
              f"{' '.join(f'{t:.2f}' for t in ts)} ms/shape (first is "
              f"warm-up)")
    return {k: statistics.median(v[1:]) for k, v in times.items()}


def trunk_end_to_end(torch):
    """Phase 5: the same priors through a few Heun steps on three paths."""
    from pcfm_torch.sample.cli import load_run
    from pcfm_torch.sample.priors import make_latent_prior, make_pf_prior
    from pcfm_torch.train.evaluate import make_sample_fn

    over = {"sample_steps": 4}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    cfg, _, _ = load_run(RUN_DIR, over, DEVICE)
    z0 = make_latent_prior(gen, B, cfg.latent_dim)
    x0 = make_pf_prior(gen, (B, N, cfg.pf_point_dim))
    out = {}
    for name, extra in (("kernel_bf16", {"fused_trunk": "on"}),
                        ("plain_bf16", {"fused_trunk": "off"}),
                        ("plain_fp32", {"fused_trunk": "off",
                                        "amp": False})):
        _, bundle, _ = load_run(RUN_DIR, {**over, **extra}, DEVICE)
        out[name] = make_sample_fn(bundle)(None, None, B, N, z0=z0, x0=x0)
        del bundle
    ref = out["plain_fp32"]
    scale = ref.abs().max().item()
    rel = {}
    for name in ("kernel_bf16", "plain_bf16"):
        rel[name] = (out[name] - ref).abs().max().item() / scale
    diff = (out["kernel_bf16"] - out["plain_bf16"]).abs().max().item()
    print(f"[e2e] Heun x4 at {B} x {N}: max |kernel - plain| (bf16) "
          f"{diff:.4g}; vs fp32 plain (max |x| {scale:.4g}): kernel "
          f"{rel['kernel_bf16']:.4g}, plain bf16 {rel['plain_bf16']:.4g} "
          f"relative (bound {E2E_REL_TOL})")
    if not all(torch.isfinite(v).all() for v in out.values()) or \
            max(rel.values()) > E2E_REL_TOL:
        raise RuntimeError("kernel trunk and plain trunk disagree")
    return diff


def train_cli(fb, torch):
    """Phase 7: the training CLI at full width: one epoch of the synthetic
    set (8 steps), validation and a checkpoint, then a rerun that must
    find nothing to do. Returns (forward, backward launches, steps)."""
    from pcfm_torch.train import cli
    out_dir = os.path.join(RUN_DIR, "train")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--dataset_type", "synthetic", "--batch_size", str(B),
            "--tr_max_sample_points", str(N), "--te_max_sample_points",
            str(N), "--latent_dim", "128", "--fused_trunk", "on",
            "--epochs", "1", "--save_every", "1", "--warmup_steps", "0",
            "--sample_steps", str(TRAIN_SAMPLE_STEPS), "--num_workers", "2",
            "--out_dir", out_dir]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.launches = fb.bwd_launches = 0
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = fb.launches, fb.bwd_launches
    ckpt_path = os.path.join(out_dir, "ckpts", "hybrid_ep0001.pt")
    steps = torch.load(ckpt_path, map_location="cpu",
                       weights_only=True)["global_step"]
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    finite = all(math.isfinite(v) for r in rows for v in r.values())
    # validation: recon + sample, Heun x TRAIN_SAMPLE_STEPS (2 NFE a step)
    val_fwd = FILM_BLOCKS * 2 * 2 * TRAIN_SAMPLE_STEPS
    print(f"[train] CLI 1 epoch at {B} x {N}: {steps} steps, {bwd} backward "
          f"and {fwd} forward launches ({fwd - val_fwd} in the steps, "
          f"{val_fwd} in validation), losses {rows[-1]}, wall {wall:.2f} s "
          f"incl. data, validation and checkpoint, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if (steps != 8 or bwd != FILM_BLOCKS * steps
            or fwd - val_fwd != FILM_BLOCKS * steps or not finite
            or not os.path.isdir(os.path.join(out_dir, "samples_ep0001"))):
        raise RuntimeError("training CLI: wrong step or launch count, "
                           "non-finite loss or missing outputs")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        again = cli.main(argv)
    print(f"[train] rerun: {buf.getvalue().strip().splitlines()[-1]}")
    if again != {"epochs_run": 0} or "Nothing to do" not in buf.getvalue():
        raise RuntimeError("training CLI rerun did not resume as finished")
    return fwd, bwd, steps


def train_batch(torch):
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    return {"pts": torch.randn(B, N, 3, device=DEVICE, generator=g) * 0.5,
            "rgb": torch.rand(B, N, 3, device=DEVICE, generator=g),
            "cond": torch.rand(B, 1, device=DEVICE, generator=g)}


def train_state(torch, trunk: str):
    from pcfm_torch.train.state import init_state
    cfg = bench_cfg(fused_trunk=trunk)
    return init_state(cfg, DEVICE, STEPS_PER_EPOCH,
                      torch.Generator().manual_seed(SEED))


def kernel_share(prof_dir: str, torch, fn, steps: int) -> dict:
    """One torch.profiler run of ``steps`` calls of ``fn``: device time by
    kernel from the trace's kernel events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(prof_dir, exist_ok=True)
    path = os.path.join(prof_dir, "train_step_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy = sum(by_name.values())
    ours = sum(v for k, v in by_name.items() if "film_block" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_us / 1e3 / steps, "busy_ms": busy / 1e3 / steps,
            "film_block_ms": ours / 1e3 / steps,
            "film_block_share": ours / busy if busy else 0.0,
            "top": [(k[:90], v / 1e3 / steps) for k, v in top]}


def train_step_time(torch):
    """Phase 8: the train step at bench.py's workload, kernel trunk and
    plain trunk in turns, after warm-up; peak memory; profiler shares."""
    from pcfm_torch.train.step import train_step
    batch = train_batch(torch)
    out = {}
    runs = {}
    for trunk in ("on", "off"):
        state = train_state(torch, trunk)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        runs[trunk] = (state, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):                                      # warm-up
            train_step(state, batch, gen, 1.0, 0.1)
        torch.cuda.synchronize()
        out[f"peak_gib_{trunk}"] = torch.cuda.max_memory_allocated() / 2**30
    times = {"on": [], "off": []}
    for trunk in ("on", "off", "off", "on") * 2:
        state, gen = runs[trunk]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            m = train_step(state, batch, gen, 1.0, 0.1)
        torch.cuda.synchronize()
        times[trunk].append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
        if not math.isfinite(float(m["loss"])):
            raise RuntimeError(f"train step, trunk {trunk}: loss {m}")
    for trunk, ts in times.items():
        ms = statistics.median(ts)
        out[f"ms_{trunk}"] = ms
        print(f"[step] train step at {B} x {N} bf16, fused_trunk={trunk}: "
              f"{' '.join(f'{t:.3f}' for t in ts)} ms/step (median "
              f"{ms:.3f}; x {STEPS_PER_EPOCH} = "
              f"{ms * STEPS_PER_EPOCH / 1e3:.3f} s/epoch), peak device "
              f"memory {out[f'peak_gib_{trunk}']:.3f} GiB")
    state, gen = runs["on"]
    share = kernel_share(RUN_DIR, torch,
                         lambda: train_step(state, batch, gen, 1.0, 0.1), 3)
    print(f"[step] profiler, 3 kernel-trunk steps: {share['wall_ms']:.3f} ms"
          f"/step wall, {share['busy_ms']:.3f} ms device busy (idle share "
          f"{1 - share['busy_ms'] / share['wall_ms']:.3f}), film_block "
          f"kernels {share['film_block_ms']:.3f} ms = "
          f"{share['film_block_share']:.3f} of device time")
    for name, ms in share["top"]:
        print(f"[step]   {ms:9.3f} ms/step  {name}")
    out["share"] = share
    del runs
    torch.cuda.empty_cache()
    return out


def determinism(torch):
    """Phase 9: two 3-step runs from the same seed and batch with the
    kernel trunk give bitwise-equal losses and parameters."""
    from pcfm_torch.train.step import train_step
    batch = train_batch(torch)
    results = []
    for _ in range(2):
        state = train_state(torch, "on")
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        losses = [train_step(state, batch, gen, 1.0, 0.1)["loss"]
                  for _ in range(3)]
        params = [p.detach().clone() for m in state.bundle.modules().values()
                  for p in m.parameters()]
        results.append((torch.stack(losses), params))
        del state
    (l1, p1), (l2, p2) = results
    same = torch.equal(l1, l2) and all(torch.equal(a, b)
                                       for a, b in zip(p1, p2))
    print(f"[determinism] 2 x 3 kernel-trunk steps: losses "
          f"{l1.tolist()} / {l2.tolist()}; {len(p1)} parameter tensors "
          f"(live and EMA) bitwise equal: {same}")
    if not same:
        raise RuntimeError("train step is not bitwise reproducible")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs a CUDA device")
    sys.path.insert(0, ROOT)
    import numpy as np

    from pcfm_torch.ops import build
    from pcfm_torch.ops import film_block as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"))
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{sh(build.nvcc(), '--version').splitlines()[-1]}")

    info = build.build(force=True)
    print(f"[build] {len(build.sources())} source(s) -> "
          f"{os.path.relpath(info['path'], ROOT)} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    kv = kernel_vs_plain(fb, torch)
    launches = main_path(fb, torch, np)
    ms = sample_ms_per_shape(torch)
    trunk_end_to_end(torch)
    bw = backward_vs_plain(fb, torch)
    fwd_train, bwd_train, steps = train_cli(fb, torch)
    step = train_step_time(torch)
    determinism(torch)

    print(json.dumps({"kernels": [{
        "name": "film_block_fwd", "route": "cuda",
        "source": "pcfm_torch/csrc/film_block.cu",
        "replaces": "pcfm/ops/pallas/film_block.py:56",
        "launches": launches,
        "max_abs_err": max(v[0] for v in kv.values()),
        "ms": kv[B][1], "plain_ms": kv[B][2],
        "shape": [B, N, C],
        "ms_2b": kv[2 * B][1], "plain_ms_2b": kv[2 * B][2],
        "sample_heun50_ms_per_shape": ms["on"],
        "sample_heun50_plain_trunk_ms_per_shape": ms["off"],
        "launches_train_cli": fwd_train}, {
        "name": "film_block_bwd", "route": "cuda",
        "source": "pcfm_torch/csrc/film_block_bwd.cu",
        "replaces": "pcfm/ops/pallas/film_block.py:75",
        "launches": bwd_train, "train_steps": steps,
        "max_abs_err": max(v[0] for v in bw.values()),
        "max_err_over_grad_max": max(v[1] for v in bw.values()),
        "ms": bw[B][2], "plain_ms": bw[B][3], "shape": [B, N, C],
        "ms_2b": bw[2 * B][2], "plain_ms_2b": bw[2 * B][3],
        "train_ms_per_step": step["ms_on"],
        "train_plain_trunk_ms_per_step": step["ms_off"],
        "train_peak_gib": step["peak_gib_on"],
        "train_film_block_share": step["share"]["film_block_share"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
